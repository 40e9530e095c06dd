"""The benchmark of nums_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout, on a machine with the cards the cell asks
for. The last line of standard output is the result, one JSON object;
with ``--trace 1`` its metrics are the cell's per-layer metrics, else its
end-to-end ones. The numbers compared with the plain reference, each
beside its limit, are the last lines of standard error and the last key
of the result. A run that finds no CUDA card, too few, no program beside
the benchmark, or a forbidden module loaded exits with another code than
0 and prints no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402 - the clock above starts the set-up time
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = "nums_tpu_torch"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = _args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"no {PROGRAM} package beside the benchmark in {ROOT}",
              file=sys.stderr)
        return 2
    from benchmark.harness import device, guard, mesh, session, spec

    cell = spec.load_cell(args.workload, ROOT)
    os.environ["NUMS_TPU_TORCH_MATMUL_PRECISION"] = cell.config["precision"]
    if cell.chips == 1:   # on the mesh each rank looks, not this process
        import torch

        problem = device.missing_cards(torch, 1)
        if problem:
            print(problem, file=sys.stderr)
            return 3
    job = session.Job(str(ROOT), cell.name, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    saved = os.dup(1)
    os.dup2(2, 1)   # whatever the program prints goes to standard error
    try:
        result = (session.run(job) if cell.chips == 1
                  else mesh.launch(job, cell.chips))
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    session.print_compared(result, sys.stderr)   # the last lines there
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
