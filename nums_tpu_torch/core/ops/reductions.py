"""Reduction op vocabulary as plain torch calls.

Counterpart of ``nums_tpu/core/ops/reductions.py``. As there, ``dtype=``
of ``sum`` and ``mean`` is the ACCUMULATOR dtype (torch casts the input
before it reduces), while for ``min`` and ``max`` it casts the result.
"""

import torch

from nums_tpu_torch.core.ops.elementwise import inexact_dtype

_DTYPE_AWARE = {"sum", "mean"}
_FNS = {"sum": torch.sum, "mean": torch.mean, "min": torch.amin,
        "max": torch.amax}


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes)


def reduce(op_name: str, x, axis, keepdims: bool, dtype=None):
    """``op_name`` in sum|mean|min|max over ``axis`` (None = all)."""
    if op_name not in _FNS:
        raise NotImplementedError(f"reduction {op_name!r} is not ported")
    fn = _FNS[op_name]
    if op_name == "mean" and dtype is None:
        dtype = inexact_dtype(x.dtype)  # the mean of integers is a float
    if x.ndim == 0:
        out = x
    elif dtype is not None and op_name in _DTYPE_AWARE:
        out = fn(x, dim=_dims(axis, x.ndim), keepdim=keepdims, dtype=dtype)
    else:
        out = fn(x, dim=_dims(axis, x.ndim), keepdim=keepdims)
    return out.to(dtype) if dtype is not None else out
