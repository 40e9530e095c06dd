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


def _compute_dtype(dt, device):
    """The dtype a contraction of ``dt`` operands runs in: bool counts in
    float32 (any positive count is True), and integers run in float64 on
    the card, whose matmul takes no integer operands (exact below 2^53)."""
    if dt == torch.bool:
        return torch.float32
    if device.type == "cuda" and not (dt.is_floating_point or dt.is_complex):
        return torch.float64
    return dt


def _contract(fn, a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    work = _compute_dtype(dt, a.device)
    out = fn(a.to(work), b.to(work))
    if dt == torch.bool:
        return out != 0
    return out.to(dt)


def tensordot(a, b, axes):
    if axes == 1 and a.ndim <= 2 and b.ndim <= 2 and a.ndim and b.ndim:
        return _contract(torch.matmul, a, b)
    if isinstance(axes, int):
        return _contract(lambda x, y: torch.tensordot(x, y, dims=axes), a, b)
    dims = [list(axes[0]), list(axes[1])]
    return _contract(lambda x, y: torch.tensordot(x, y, dims=dims), a, b)


def matmul(a, b):
    """``jnp.matmul`` with batch broadcasting (operands of more than two
    axes)."""
    if not torch.is_tensor(b):
        b = torch.as_tensor(b, device=a.device)
    return _contract(torch.matmul, a, b)
