"""Shape ops as plain torch calls.

Counterpart of the concatenate, where3 and row-gather kernels of
``nums_tpu/core/ops/shape_ops.py`` (a reshape is ``Tensor.reshape``
itself).
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
