"""A traced run of a cell read by the program's own spans and counters.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does: the same set-up, window,
comparison and result line, printed first. It keeps what that run drops,
the profiler and the program's counters (``nums_tpu_torch.core.trace``),
and prints one more JSON line, every time in ms a call, read on rank 0
(``harness/program_spans.py``):

- ``device_ms``: the device time (a union) of the operations launched in
  each span, the innermost program span first, else the ``bench.`` one;
  ``unattributed_share``: the share of the busy time whose launch was not
  found;
- ``idle_ms``: the window's idle time under each span, as above;
- ``device_ops`` and ``idle_gaps``: the breakdown under those labels;
- ``counters``: the program's, summed over the window;
- ``newton_useful_share``, ``entry_device_ms`` and, on the mesh,
  ``collective_wait_ms`` (every rank's all-reduce kernels, gathered).

Not part of a benchmark run.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402 - the clock above starts the set-up time
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _keeping(store):
    """``session.run`` with its profiler and the program's counters (read
    as the op log closes) kept in ``store``."""
    from benchmark.harness import session
    from nums_tpu_torch.core import trace as ptrace

    make, close = session._profiler, session._OpLog.__exit__

    def profiler(torch, dev):
        store["prof"] = make(torch, dev)
        return store["prof"]

    def exit_op_log(oplog, *exc):
        store["counters"] = ptrace.counters()
        return close(oplog, *exc)

    with mock.patch.object(session, "_profiler", profiler), \
            mock.patch.object(session._OpLog, "__exit__", exit_op_log):
        yield store


def _ms(seconds_by_label, calls):
    return {k: 1e3 * v / calls for k, v in
            sorted(seconds_by_label.items(), key=lambda kv: -kv[1])}


def view(pt, calls, counters, per_rank):
    """The JSON line's object for rank 0's ``ProgramTrace``; ``per_rank``:
    every rank's ``collective_durations``."""
    from benchmark.harness import program_spans as ps, tracing

    busy = tracing.busy_seconds(pt.trace) or 0.0
    by_label = ps.device_seconds_by_label(pt)
    idle = {}
    for label, sec in tracing.idle_gaps(ps.refined(pt)):
        idle[label] = idle.get(label, 0.0) + sec
    k = 25
    return {
        "calls": calls,
        "busy_ms": 1e3 * busy / calls,
        "device_ms": _ms(by_label, calls),
        "unattributed_share": (100.0 * by_label.get(ps.UNATTRIBUTED, 0.0)
                               / busy if busy else None),
        "idle_ms": _ms(idle, calls),
        "device_ops": [[n, 1e3 * s / calls]
                       for n, s in ps.top_device_ops(pt, k)],
        "idle_gaps": [[n, 1e3 * s / calls]
                      for n, s in ps.idle_breakdown(pt, k)],
        "program_spans_per_call": len(pt.program) / calls,
        "counters": counters,
        "newton_useful_share": ps.newton_useful_share(counters),
        "entry_device_ms": ps.entry_device_ms(pt, calls),
        "collective_wait_ms": ps.collective_wait_ms(per_rank, calls),
    }


def run_rank(job, rank, world):
    """One process's traced run; on rank 0 (result, view), else None."""
    from benchmark.harness import program_spans as ps, session

    store = {}
    with _keeping(store):
        result = session.run(job, rank, world)
    pt = ps.from_profiler(store["prof"])
    per_rank = session._gather(ps.collective_durations(pt), world)
    if rank != 0:
        return None
    return result, view(pt, result["attempted"], store["counters"],
                        per_rank)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import mesh, session, spec

    cell = spec.load_cell(args.workload, ROOT)
    os.environ["NUMS_TPU_TORCH_MATMUL_PRECISION"] = cell.config["precision"]
    job = session.Job(str(ROOT), cell.name, args.seed, args.seconds, True,
                      "cuda", T_START)
    saved = os.dup(1)
    os.dup2(2, 1)   # whatever the program prints goes to standard error
    try:
        result, seen = (run_rank(job, 0, 1) if cell.chips == 1
                        else mesh.launch(job, cell.chips, entry=run_rank))
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)
    print(json.dumps(result))
    print(json.dumps(seen), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
