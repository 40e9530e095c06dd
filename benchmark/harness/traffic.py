"""The one traffic generator: reads a mix's parameters and says which
input set each call of the window takes, and which calls' answers are
kept for the comparison. Every mix is a closed loop of one client: the
next call is sent when the last one has returned.

A mix (``benchmark/traffic/<name>.json``) has:

- ``input_sets``: how many input sets set-up makes (one resident X and,
  for a fit, that many label vectors); call ``i`` takes set
  ``i % input_sets``;
- ``checked``: how many answers of the window are kept, a uniform sample
  of all calls drawn from the seed, for the comparison after it.
"""

import random


class Schedule:
    def __init__(self, traffic):
        n = int(traffic["input_sets"])
        if n < 1:
            raise ValueError("input_sets must be at least 1")
        self.input_sets = n
        self.checked = int(traffic["checked"])

    def input_for(self, i):
        return i % self.input_sets


class Reservoir:
    """A uniform sample of ``k`` of the items offered, whatever their
    number (Algorithm R), drawn from ``seed``: the same seed and count
    keep the same positions on every rank."""

    def __init__(self, k, seed):
        self.k = k
        self._rng = random.Random(seed ^ 0x5EED)
        self._items = []
        self._seen = 0

    def wants(self):
        """Whether the next item offered would be kept (draws once)."""
        i = self._seen
        self._seen += 1
        if i < self.k:
            self._slot = i
            return True
        j = self._rng.randrange(i + 1)
        self._slot = j
        return j < self.k

    def keep(self, index, item):
        """Keep ``item`` in the slot the last ``wants`` chose."""
        if self._slot < len(self._items):
            self._items[self._slot] = (index, item)
        else:
            self._items.append((index, item))

    def items(self):
        return sorted(self._items, key=lambda t: t[0])
