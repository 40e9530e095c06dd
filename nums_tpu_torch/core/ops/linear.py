"""Contractions as plain torch calls.

Counterpart of ``nums_tpu/core/ops/linear.py``. A lazily transposed
operand arrives as a transposed view, which ``torch.matmul`` hands to the
BLAS as a transpose flag, so ``x.T @ y`` never copies ``x``. The gram
``x.T @ x`` in the bf16-MAC class goes to the gram kernel one level up
(``BlockArray._gram_fast``); float32 here runs with TF32 off
(``settings.configure_precision``).
"""

import torch


def maybe_t(x, transposed: bool):
    """Fold a lazy logical transpose into the consumer as a view."""
    return x.permute(*reversed(range(x.ndim))) if transposed else x


def tensordot(a, b, axes):
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if axes == 1 and a.ndim <= 2 and b.ndim <= 2 and a.ndim and b.ndim:
        return torch.matmul(a, b)
    if isinstance(axes, int):
        return torch.tensordot(a, b, dims=axes)
    return torch.tensordot(a, b, dims=[list(axes[0]), list(axes[1])])
