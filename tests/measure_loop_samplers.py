"""Time the serial ``poisson(50)`` and ``binomial(200, 0.4)`` draws of
nums_tpu_torch's random layer on a CUDA card, for one or more copies of
the package. Not a test (pytest does not collect it): run it by hand,

    python3 tests/measure_loop_samplers.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``nums_tpu_torch`` package (a
checkout, or an unpacked ``git archive`` of another commit). The roots
are timed in the order given, in one process on one card: give ``A B B A``
to compare two commits. For each root and sampler: the median of 5 draws
after one warm-up, CUDA events around each draw, 2^22 float32 elements,
the card's mode (64-bit types off). Prints the card's name and power limit
(``nvidia-smi``), then one JSON line a root and sampler, with whether the
draw equals the first root's bit for bit."""

import importlib
import json
import subprocess
import sys

SIZE = 1 << 22
SAMPLERS = (("poisson", (50.0,)), ("binomial", (200.0, 0.4)))
REPEATS = 5


def _load(root):
    for name in [m for m in sys.modules if m.startswith("nums_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return (importlib.import_module("nums_tpu_torch.core.ops.random_ops"),
                importlib.import_module("nums_tpu_torch.core.ops.threefry"))
    finally:
        sys.path.remove(root)


def main(roots):
    import torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    first = {}
    for root in roots:
        random_ops, threefry = _load(root)
        key = threefry.fold_in(threefry.seed_key(7, False), 1)
        for name, params in SAMPLERS:
            def draw():
                return random_ops.sample(name, key, (SIZE,), torch.float32,
                                         "cuda", False, *params)

            out = draw()
            times = []
            for _ in range(REPEATS):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                out = draw()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            first.setdefault(name, out)
            print(json.dumps({
                "root": root, "sampler": name, "params": params,
                "elements": SIZE, "ms_median": sorted(times)[REPEATS // 2],
                "ms": times, "same_as_first": bool(torch.equal(
                    out, first[name]))}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
