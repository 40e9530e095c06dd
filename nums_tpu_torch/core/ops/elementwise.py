"""Elementwise op vocabulary (unary and binary) as plain torch calls.

Counterpart of ``nums_tpu/core/ops/elementwise.py``. Ops are named by
their NumPy ufunc names; the result dtypes follow the reference's (NumPy's
with JAX's weak Python scalars) rather than torch's own rules where the
two differ:

* two tensors promote by their dtypes alone (torch would let a 0-d tensor
  adopt the other operand's float width);
* a Python float with an integer or bool tensor gives the backend's
  default float (torch would give its global default, float32);
* integer true division, float-valued unary ops and means of integers or
  bools compute in ``inexact_dtype``: float64 for 64-bit integers,
  float32 below (JAX's rule; torch would always give float32).
"""

import numbers

import numpy as np
import torch

from nums_tpu_torch.core import settings

# NumPy names whose torch spelling differs.
_SPECIAL_UFUNCS = {
    "abs": torch.abs,
    "absolute": torch.abs,
    "negative": torch.neg,
    "positive": torch.positive,
    "invert": torch.bitwise_not,
    "bitwise_not": torch.bitwise_not,
    "conj": torch.conj_physical,
    "power": torch.pow,
    "mod": torch.remainder,
    "equal": torch.eq,
    "not_equal": torch.ne,
    "less": torch.lt,
    "less_equal": torch.le,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
    "xlogy": torch.xlogy,
}

# Unary ops that keep an integer dtype; every other unary op is
# float-valued and computes integer input in the default float.
_INT_PRESERVING = {
    "abs", "absolute", "negative", "positive", "invert", "bitwise_not",
    "sign", "square", "conj",
}


def resolve_ufunc(name: str):
    name = settings.np_ufunc_map.get(name, name)
    if name in _SPECIAL_UFUNCS:
        return _SPECIAL_UFUNCS[name]
    fn = getattr(torch, name, None)
    if fn is None:
        fn = getattr(torch.special, name, None)
    if fn is None:
        raise NotImplementedError(f"No torch op for ufunc {name!r}")
    return fn


def _is_inexact(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def inexact_dtype(dtype: torch.dtype) -> torch.dtype:
    """The float an integer or bool dtype computes in (floats: itself)."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype.itemsize == 8 else torch.float32


def uop(name: str, x):
    fn = resolve_ufunc(name)
    if name not in _INT_PRESERVING:
        x = x.to(inexact_dtype(x.dtype))
    return fn(x)


def _as_operand(v, device):
    """NumPy scalars are typed (not weak): they become 0-d tensors."""
    if isinstance(v, (np.generic, np.ndarray)):
        return torch.as_tensor(np.asarray(v), device=device)
    return v


def promote(a, b, default_float: torch.dtype):
    """Cast two operands (tensors or Python scalars) to the reference's
    result dtype. At least one operand is a tensor."""
    device = a.device if torch.is_tensor(a) else b.device
    a, b = _as_operand(a, device), _as_operand(b, device)
    if torch.is_tensor(a) and torch.is_tensor(b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)
    t, v = (a, b) if torch.is_tensor(a) else (b, a)
    if (
        isinstance(v, numbers.Real)
        and not isinstance(v, numbers.Integral)
        and not _is_inexact(t)
    ):
        t = t.to(default_float)
    return (t, v) if torch.is_tensor(a) else (v, t)


def bop(name: str, a, b, default_float: torch.dtype):
    """Binary elementwise op with NumPy broadcasting."""
    fn = resolve_ufunc(name)
    name = settings.np_ufunc_map.get(name, name)
    a, b = promote(a, b, default_float)
    if name == "true_divide":
        dt = inexact_dtype((a if torch.is_tensor(a) else b).dtype)
        a = a.to(dt) if torch.is_tensor(a) else a
        b = b.to(dt) if torch.is_tensor(b) else b
    if not torch.is_tensor(a):
        # torch ops take a Python scalar only as the second operand; a
        # 0-d tensor keeps the scalar's weak typing in torch's promotion.
        a = torch.as_tensor(a, device=b.device)
    return fn(a, b)
