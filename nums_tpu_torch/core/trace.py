"""Tracing and profiling hooks.

Counterpart of ``nums_tpu/core/trace.py``:

- an op-event log at the BlockArray dispatch layer (each op with its name
  and operand shapes), on with ``NUMS_TPU_TORCH_TRACE=1`` or ``enable()``;
- spans: ``span(name)`` marks a region of the program, named
  ``nums.<layer>.<what>``, on the profiler's timeline
  (``torch.profiler.record_function``) while the trace is on or inside
  ``profile``; otherwise it is one shared no-op context, so a span costs
  a flag test;
- counters: ``count(name, n)`` adds to a counter while the trace is on; a
  device tensor ``n`` is added on its device, with no sync, and
  ``counters()`` reads it;
- ``profile(path)``: a ``torch.profiler`` run around the block, its spans
  on, written to ``path`` as a Chrome trace (open it in Perfetto or
  ``chrome://tracing``);
- ``annotate(name)``: a named region on the profiler's timeline
  (``torch.profiler.record_function``), whether the trace is on or not.
"""

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("nums_tpu_torch.ops")

_enabled = os.environ.get("NUMS_TPU_TORCH_TRACE", "0") not in (
    "0", "", "false")
_events = []
_record = False
_profiling = 0   # ``profile`` blocks open
_counts = {}     # name -> int, or an integer tensor on a device
_OFF = contextlib.nullcontext()


def enable(record: bool = False):
    """Turn on op-event logging, spans and counters; ``record=True`` also
    buffers events."""
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
    """Empty the op events and the counters."""
    _events.clear()
    _counts.clear()


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


def span(name: str):
    """A region of the program on the profiler's timeline while spans are
    on; else the shared no-op context (no allocation, no dispatcher
    call)."""
    if not (_enabled or _profiling):
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n=1):
    """Add ``n`` (a Python int, or an integer tensor added on its device
    without a sync) to the counter ``name`` while the trace is on."""
    if _enabled:
        _counts[name] = _counts.get(name, 0) + n


def counters():
    """{name: int} of every counter; each one held on a device is read
    once."""
    return {name: int(v) for name, v in _counts.items()}


@contextlib.contextmanager
def profile(path: str):
    """Profile the block (host ops, the program's spans, and the card's
    kernels where there is one) and write a Chrome trace to ``path``; a
    directory ``path`` gets ``trace.json`` inside it."""
    global _profiling
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _profiling += 1
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        _profiling -= 1
    if os.path.isdir(path) or not os.path.splitext(path)[1]:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "trace.json")
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named region on the profiler's timeline."""
    return torch.profiler.record_function(name)
