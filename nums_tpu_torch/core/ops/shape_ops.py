"""Shape ops as plain torch calls.

Counterpart of ``nums_tpu/core/ops/shape_ops.py``: reshape, broadcast,
expand and squeeze, concatenate, where3 and the row gather. Its
``slice_to``/``slice_t`` strip the at-rest padding, which the port does
not keep: they have no counterpart.
"""

import torch


def concatenate(tensors, axis: int):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=axis)


def where3(condition, x, y):
    """Elementwise select; ``x`` and ``y`` are tensors or Python scalars
    of one dtype (the caller promotes them)."""
    return torch.where(condition.to(torch.bool), x, y)


def take_rows(x, idx):
    """``x[idx]`` along axis 0 for a 1-D integer index tensor (negative
    indices count from the end, as in NumPy)."""
    idx = idx.to(device=x.device, dtype=torch.int64)
    idx = torch.where(idx < 0, idx + x.shape[0], idx)
    return torch.index_select(x, 0, idx)


def reshape(x, shape: tuple):
    return x.reshape(tuple(shape))


def broadcast_to(x, shape: tuple):
    """``jnp.broadcast_to``, materialized (the reference's XLA program
    writes the broadcast array; a stride-0 view would reach the kernels,
    which take contiguous tensors)."""
    return torch.broadcast_to(x, tuple(shape)).contiguous()


def expand_dims(x, axis):
    """Insert size-1 axes at ``axis`` (an int or a tuple of ints, counted
    in the result, negative from its end), as ``jnp.expand_dims``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    ndim = x.ndim + len(axes)
    axes = sorted(a % ndim for a in axes)
    for a in axes:
        x = x.unsqueeze(a)
    return x


def squeeze(x):
    """Drop every size-1 axis."""
    return x.reshape(tuple(s for s in x.shape if s != 1))

