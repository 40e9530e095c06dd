"""Spans, device intervals and their reduction.

In a traced run ``torch.profiler`` records the window. The benchmark's own
spans are ``record_function`` regions around its calls into the program
(``bench.enqueue``: the entry call until it returns; ``bench.sync``: the
wait for the device, and on the mesh the barrier), so they and the
device's operations share one clock. ``Trace`` keeps, in seconds on that
clock, each device operation (kernel, copy or set) and each span; the
reductions take the union of intervals, so operations that overlap on
two streams count once.
"""

import re
from dataclasses import dataclass, field

SPAN_PREFIX = "bench."
OUTSIDE = "bench.between"   # no span open: the harness between two calls


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_s, end_s)
    spans: list = field(default_factory=list)    # (name, start_s, end_s)

    def window(self):
        """(start, end) of the traced calls: the first span's start to the
        last span's end."""
        if not self.spans:
            return None
        return (min(s for _, s, _ in self.spans),
                max(e for _, _, e in self.spans))


def _ns(event, what):
    getter = getattr(event, f"{what}_ns", None)
    if getter is not None:
        return getter()
    return getattr(event, f"{what}_us")() * 1e3


def from_profiler(prof):
    """The ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    trace = Trace()
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        name = ev.name()
        if name.startswith(SPAN_PREFIX):
            # A span; its mirror on the device's timeline is no work.
            if ev.device_type() != DeviceType.CUDA:
                trace.spans.append((name, start, end))
        elif ev.device_type() == DeviceType.CUDA and not _is_annotation(ev):
            trace.device.append((name, start, end))
    return trace


def _is_annotation(ev):
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def merged(intervals, lo=float("-inf"), hi=float("inf")):
    """The union of (start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def union_seconds(intervals, lo=float("-inf"), hi=float("inf")):
    return sum(e - s for s, e in merged(intervals, lo, hi))


def busy_seconds(trace, match=None):
    """Seconds within the window in which a device operation (whose name
    ``match`` accepts, if given) ran."""
    win = trace.window()
    if win is None:
        return None
    ivs = [(s, e) for n, s, e in trace.device if match is None or match(n)]
    return union_seconds(ivs, *win)


def is_collective(name):
    return "nccl" in name.lower()


def short_name(name):
    """A kernel's name without its return type, template arguments and
    parameters: ``void gram_mma<128>(...)`` -> ``gram_mma``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^(void|__global__)\s+", "", name.strip())
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[-80:] or "?"


def top_device_ops(trace, k=10, key=short_name):
    """[[name, seconds], ...]: the ``k`` device operations (by ``key`` of
    their names) that ran longest in the window, their durations
    summed."""
    win = trace.window()
    if win is None:
        return []
    lo, hi = win
    total = {}
    for n, s, e in trace.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            total[key(n)] = total.get(key(n), 0.0) + d
    return [[n, t] for n, t in sorted(total.items(), key=lambda t: -t[1])[:k]]


def _partition(spans, lo, hi):
    """[lo, hi) cut into (start, end, span name) pieces, ``OUTSIDE``
    where no span is open."""
    parts, t = [], lo
    for n, a, b in sorted(spans, key=lambda sp: sp[1]):
        a, b = max(a, t), min(b, hi)
        if b <= a:
            continue
        if a > t:
            parts.append((t, a, OUTSIDE))
        parts.append((a, b, n))
        t = b
    if t < hi:
        parts.append((t, hi, OUTSIDE))
    return parts


def idle_gaps(trace):
    """Each interval of the window in which no device operation ran, cut
    where the span open on the host changes: [(span name, seconds)],
    longest first (``OUTSIDE`` where no span was open)."""
    win = trace.window()
    if win is None:
        return []
    lo, hi = win
    gaps, t = [], lo
    for s, e in merged([(s, e) for _, s, e in trace.device], lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    parts = _partition(trace.spans, lo, hi)
    out, j = [], 0
    for s, e in gaps:
        while j < len(parts) and parts[j][1] <= s:
            j += 1
        k = j
        while k < len(parts) and parts[k][0] < e:
            a, b = max(s, parts[k][0]), min(e, parts[k][1])
            if b > a:
                out.append((parts[k][2], b - a))
            k += 1
    return sorted(out, key=lambda g: -g[1])


def idle_breakdown(trace, k=10):
    """[[name, seconds], ...] for ``breakdown.idle_gaps``: the idle time
    summed by the span open (``total:<span>``), then the longest single
    gaps (``<span>``), ``k`` entries at most."""
    gaps = idle_gaps(trace)
    total = {}
    for label, sec in gaps:
        total[label] = total.get(label, 0.0) + sec
    out = [[f"total:{n}", t]
           for n, t in sorted(total.items(), key=lambda t: -t[1])]
    out += [[label, sec] for label, sec in gaps[:max(0, k - len(out))]]
    return out[:k]
