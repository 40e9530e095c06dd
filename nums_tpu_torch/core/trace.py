"""Tracing and profiling hooks.

Counterpart of ``nums_tpu/core/trace.py``:

- an op-event log at the BlockArray dispatch layer (each op with its name
  and operand shapes), on with ``NUMS_TPU_TORCH_TRACE=1`` or ``enable()``;
- ``profile(path)``: a ``torch.profiler`` run around the block, written to
  ``path`` as a Chrome trace (open it in Perfetto or ``chrome://tracing``);
- ``annotate(name)``: a named region on the profiler's timeline
  (``torch.profiler.record_function``).
"""

import contextlib
import logging
import os
import time

logger = logging.getLogger("nums_tpu_torch.ops")

_enabled = os.environ.get("NUMS_TPU_TORCH_TRACE", "0") not in (
    "0", "", "false")
_events = []
_record = False


def enable(record: bool = False):
    """Turn on op-event logging; ``record=True`` also buffers events."""
    global _enabled, _record
    _enabled = True
    _record = record
    if not logger.handlers and not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)


def disable():
    global _enabled, _record
    _enabled = False
    _record = False


def events():
    return list(_events)


def clear():
    _events.clear()


def log_op(op_name: str, *operands, out=None):
    """Called from the BlockArray dispatch layer on every op."""
    if not _enabled:
        return
    shapes = ",".join(str(getattr(o, "shape", o)) for o in operands)
    msg = f"{op_name}({shapes})" + (f" -> {out}" if out is not None else "")
    logger.info(msg)
    if _record:
        _events.append((time.time(), op_name, shapes, out))


def is_enabled():
    return _enabled


@contextlib.contextmanager
def profile(path: str):
    """Profile the block (host ops, and the card's kernels where there is
    one) and write a Chrome trace to ``path``; a directory ``path`` gets
    ``trace.json`` inside it."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "trace.json")
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region on the profiler's timeline."""
    import torch

    return torch.profiler.record_function(name)
