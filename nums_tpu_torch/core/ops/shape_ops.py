"""Shape ops as plain torch calls.

Counterpart of the concatenate kernel of ``nums_tpu/core/ops/shape_ops.py``
(a reshape is ``Tensor.reshape`` itself).
"""

import torch


def concatenate(tensors, axis: int):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.cat([t.to(dt) for t in tensors], dim=axis)
