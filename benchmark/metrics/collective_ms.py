"""Mesh layer: rank 0's device time in NCCL kernels per call (the union
of their intervals in the traced window), the wait for the other cards
included. Nothing where no collective ran."""

from benchmark.harness import tracing


def read(run):
    if run.trace is None or not run.calls:
        return None
    if not any(tracing.is_collective(n) for n, _, _ in run.trace.device):
        return None
    busy = tracing.busy_seconds(run.trace, tracing.is_collective)
    return 1e3 * busy / run.calls
