"""Elementwise op vocabulary (unary and binary) as plain torch calls.

Counterpart of ``nums_tpu/core/ops/elementwise.py``. Ops are named by
their NumPy ufunc names; the result dtypes and values follow the
reference's ``jnp`` functions (jax's promotion rules, with weak Python
scalars) rather than torch's own rules where the two differ:

* two tensors promote by their dtypes alone (torch would let a 0-d tensor
  adopt the other operand's float width);
* a Python int with a bool tensor gives the backend's default int, and a
  Python float with an integer or bool tensor its default float (int64 and
  float64 on the CPU, int32 and float32 on the card: jax with x64 on and
  off);
* float-valued ops compute integer and bool operands in ``inexact_dtype``:
  float64 for 64-bit integers, float32 below (jax's rule; torch would
  always give float32);
* ``ceil``/``floor``/``trunc`` keep integer and bool input as it is, and
  ``rint`` gives the default float for it, as ``jnp`` does;
* the integer division family, the shifts and ``power`` compute bool in
  int32, and an integer divisor of 0 gives jax's values, not an error;
* an op that ``jnp`` refuses for a dtype raises the same exception type
  (``TypeError`` or ``ValueError``) before any torch call;
* complex numbers are ordered as ``jnp`` orders them, by real part and
  then by imaginary part (the comparisons, ``maximum`` and ``minimum``),
  and the complex ``sign`` is ``z/|z|`` (0 at 0);
* a float-to-integer ``astype`` saturates as XLA's conversion does
  (``float_to_int``), on every device.

The one exception is ``power`` of integers to a negative integer
exponent: the port keeps torch's truncated value (0 for a base of
magnitude above 1), where jax wraps around.
"""

import numbers

import numpy as np
import torch

from nums_tpu_torch.core import settings

# NumPy names whose torch spelling differs.
_SPECIAL_UFUNCS = {
    "abs": torch.abs,
    "absolute": torch.abs,
    "fabs": torch.abs,
    "negative": torch.neg,
    "positive": torch.positive,
    "invert": torch.bitwise_not,
    "bitwise_not": torch.bitwise_not,
    "conj": torch.conj_physical,
    "conjugate": torch.conj_physical,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "rint": torch.round,
    "power": torch.pow,
    "float_power": torch.pow,
    "divide": torch.true_divide,
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


def _cbrt(x):
    """Cube root: ``pow(|x|, 1/3)`` with the sign of x, then one Newton
    step (within 1 ulp of ``jnp.cbrt``); 0, ±inf and NaN pass as they
    are."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    ok = torch.isfinite(y) & (y != 0)
    y_safe = torch.where(ok, y, torch.ones_like(y))
    step = (y_safe - x / (y_safe * y_safe)) / 3.0
    return torch.where(ok, y - step, y)


def _spacing(x):
    """``jnp.spacing``: ``nextafter(x, ±inf) - x`` signed by x, and the
    smallest subnormal with x's sign where that is 0."""
    inf = torch.full_like(x, float("inf"))
    out = torch.nextafter(x, torch.copysign(inf, x)) - x
    tiny = torch.full_like(x, float(np.finfo(
        str(x.dtype).replace("torch.", "")).smallest_subnormal))
    return torch.where(out == 0, torch.copysign(tiny, x), out)


def _sign(x):
    """``jnp.sign``: NaN stays NaN (torch's sign gives 0); a complex x
    gives ``x/|x|``, its parts divided by the real magnitude, and 0 at
    0."""
    if x.is_complex():
        mag = torch.abs(x)
        zero = mag == 0
        safe = torch.where(zero, torch.ones_like(mag), mag)
        out = torch.complex(x.real / safe, x.imag / safe)
        return torch.where(zero, torch.zeros_like(x), out)
    out = torch.sign(x)
    if x.is_floating_point():
        out = torch.where(torch.isnan(x), x, out)
    return out


def _heaviside(a, b):
    """0 below 0, 1 above, ``b`` at 0 and at NaN (``jnp.heaviside``)."""
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.where(a < 0, zero, torch.where(a > 0, one, b))


def _ldexp(a, b):
    return a * torch.pow(torch.full_like(a, 2.0), b.to(a.dtype))


def float_divmod(a, b):
    """CPython's float divmod, as ``jnp``'s ``_float_divmod``: the
    truncated remainder (exact), moved to the divisor's sign; the quotient
    from the exact multiple, rounded half to even."""
    mod = torch.fmod(a, b)
    div = (a - mod) / b
    step = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    return (torch.round(torch.where(step, div - 1, div)),
            torch.where(step, mod + b, mod))


def _floor_divide(a, b):
    """``jnp.floor_divide``: floats by ``float_divmod``; integers divide
    toward 0, then step down where the signs differ and the remainder is
    not 0, and a divisor of 0 gives -1 before that step, as XLA's division
    does."""
    if a.is_floating_point():
        return float_divmod(a, b)[0]
    zero = b == 0
    safe = torch.where(zero, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    r = a - q * safe
    q = torch.where(zero, torch.full_like(q, -1), q)
    r = torch.where(zero, a, r)
    step = (torch.sign(a) != torch.sign(b)) & (r != 0)
    return torch.where(step, q - 1, q)


def _remainder(a, b):
    """``jnp.remainder``: the truncated remainder moved to the divisor's
    sign; an integer divisor of 0 is taken as 1 (0 out)."""
    if not a.is_floating_point():
        b = torch.where(b == 0, torch.ones_like(b), b)
    mod = torch.fmod(a, b)
    step = ((mod < 0) != (b < 0)) & (mod != 0)
    return torch.where(step, mod + b, mod)


def _fmod(a, b):
    """``jnp.fmod``: an integer divisor of 0 is taken as 1 (0 out)."""
    if not a.is_floating_point():
        b = torch.where(b == 0, torch.ones_like(b), b)
    return torch.fmod(a, b)


def lex_order(op, a, b):
    """``op`` (``torch.lt``/``le``/``gt``/``ge``) in jnp's order of
    complex numbers: on the imaginary parts where the real parts are
    equal, else on the real parts (``jnp``'s ``_complex_comparison``)."""
    return torch.where(a.real == b.real, op(a.imag, b.imag),
                       op(a.real, b.real))


def _maximum(a, b):
    if a.is_complex():
        return torch.where(lex_order(torch.gt, a, b), a, b)
    return torch.maximum(a, b)


def _minimum(a, b):
    if a.is_complex():
        return torch.where(lex_order(torch.lt, a, b), a, b)
    return torch.minimum(a, b)


def _ordered(op):
    def compare(a, b):
        return lex_order(op, a, b) if a.is_complex() else op(a, b)

    return compare


_CUSTOM = {
    "maximum": _maximum,
    "minimum": _minimum,
    "less": _ordered(torch.lt),
    "less_equal": _ordered(torch.le),
    "greater": _ordered(torch.gt),
    "greater_equal": _ordered(torch.ge),
    "sign": _sign,
    "cbrt": _cbrt,
    "spacing": _spacing,
    "heaviside": _heaviside,
    "ldexp": _ldexp,
    "floor_divide": _floor_divide,
    "mod": _remainder,
    "remainder": _remainder,
    "fmod": _fmod,
}

# Unary ops that keep an integer or bool dtype; every other unary op is
# float-valued and computes integer input in ``inexact_dtype``.
_INT_PRESERVING = {
    "abs", "absolute", "negative", "positive", "invert", "bitwise_not",
    "sign", "square", "conj", "conjugate", "isfinite", "isinf", "isnan",
    "signbit", "logical_not", "ceil", "floor", "trunc", "fix", "rint",
}
# Of those, the ops that are the identity on integer and bool input.
_INT_IDENTITY = {"ceil", "floor", "trunc", "fix"}
# Unary ops that refuse a dtype kind, and the exception jnp raises.
_UOP_REFUSES = {
    "negative": ("b", TypeError),
    "sign": ("b", TypeError),
    "invert": ("fc", TypeError),
    "bitwise_not": ("fc", TypeError),
}

# Binary ops with a float value: integer and bool operands compute in
# ``inexact_dtype`` of their promoted dtype.
_FLOAT_VALUED = {
    "true_divide", "divide", "arctan2", "copysign", "hypot", "logaddexp",
    "logaddexp2", "nextafter", "heaviside", "float_power", "ldexp",
}
# Binary ops that compute bool operands in int32.
_BOOL_AS_INT32 = {
    "floor_divide", "mod", "remainder", "fmod", "power", "left_shift",
    "right_shift",
}
# Binary ops that refuse a dtype kind ("b" bool, "f" float, "c" complex).
_BOP_REFUSES = {
    "bitwise_and": ("fc", TypeError),
    "bitwise_or": ("fc", TypeError),
    "bitwise_xor": ("fc", TypeError),
    "left_shift": ("fc", TypeError),
    "right_shift": ("fc", TypeError),
    "gcd": ("bfc", ValueError),
    "lcm": ("bfc", ValueError),
    "subtract": ("b", TypeError),
}


def resolve_ufunc(name: str):
    name = settings.np_ufunc_map.get(name, name)
    if name in _CUSTOM:
        return _CUSTOM[name]
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


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.bool:
        return "b"
    if dtype.is_complex:
        return "c"
    return "f" if dtype.is_floating_point else "i"


def _refuse(name, kinds_dtypes, table):
    if name in table:
        kinds, exc = table[name]
        for dt in kinds_dtypes:
            if _kind(dt) in kinds:
                raise exc(f"{name} is not defined for {dt}")


def inexact_dtype(dtype: torch.dtype) -> torch.dtype:
    """The float an integer or bool dtype computes in (floats: itself)."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    return torch.float64 if dtype.itemsize == 8 else torch.float32


def default_int(default_float: torch.dtype) -> torch.dtype:
    """The default int beside a default float: int64 where floats are
    64-bit (jax with x64 on), int32 otherwise."""
    return torch.int64 if default_float == torch.float64 else torch.int32


def uop(name: str, x, default_float: torch.dtype):
    name = settings.np_ufunc_map.get(name, name)
    fn = resolve_ufunc(name)
    _refuse(name, (x.dtype,), _UOP_REFUSES)
    kind = _kind(x.dtype)
    if name in _INT_PRESERVING:
        if kind in "ib":
            if name in _INT_IDENTITY:
                return x.clone()
            if name == "rint":
                return x.to(default_float)
        if kind == "b":
            if name in ("abs", "absolute", "positive", "conj",
                        "conjugate"):
                return x.clone()
            if name == "square":
                x = x.to(torch.int32)
        return fn(x)
    return fn(x.to(inexact_dtype(x.dtype)))


def _as_operand(v, device):
    """NumPy scalars are typed (not weak): they become 0-d tensors."""
    if isinstance(v, (np.generic, np.ndarray)):
        return torch.as_tensor(np.asarray(v), device=device)
    return v


def _weak_dtype(t: torch.dtype, v, default_float: torch.dtype):
    """The dtype of a tensor of dtype ``t`` combined with the Python
    scalar ``v`` under jax's weak typing."""
    kind = _kind(t)
    if isinstance(v, bool):
        return torch.promote_types(t, torch.bool)
    if isinstance(v, numbers.Integral):
        return default_int(default_float) if kind == "b" else t
    if isinstance(v, numbers.Real):
        return t if kind in "fc" else default_float
    # complex
    if kind == "c":
        return t
    if kind == "f":
        return torch.complex128 if t == torch.float64 else torch.complex64
    return (torch.complex128 if default_float == torch.float64
            else torch.complex64)


def result_dtype(a, b, default_float: torch.dtype) -> torch.dtype:
    """jax's result dtype of two operands (tensors or Python scalars, at
    least one a tensor)."""
    if torch.is_tensor(a) and torch.is_tensor(b):
        return torch.promote_types(a.dtype, b.dtype)
    t, v = (a, b) if torch.is_tensor(a) else (b, a)
    return _weak_dtype(t.dtype, v, default_float)


def promote(a, b, default_float: torch.dtype):
    """Cast two operands (tensors or Python scalars) to the reference's
    result dtype, both as tensors. At least one operand is a tensor."""
    device = a.device if torch.is_tensor(a) else b.device
    a, b = _as_operand(a, device), _as_operand(b, device)
    dt = result_dtype(a, b, default_float)
    return _to(a, dt, device), _to(b, dt, device)


def _alone(v, default_float, device):
    """An operand as a tensor by its own dtype: a Python scalar takes the
    default type of its kind."""
    if torch.is_tensor(v):
        return v
    if isinstance(v, bool):
        dt = torch.bool
    elif isinstance(v, numbers.Integral):
        dt = default_int(default_float)
    elif isinstance(v, numbers.Real):
        dt = default_float
    else:
        dt = (torch.complex128 if default_float == torch.float64
              else torch.complex64)
    return _to(v, dt, device)


def _to(v, dt, device):
    if torch.is_tensor(v):
        return v.to(dt)
    # A fill on the device: no host-to-device copy for a Python scalar.
    return torch.full((), v, dtype=dt, device=device)


def bop(name: str, a, b, default_float: torch.dtype):
    """Binary elementwise op with NumPy broadcasting."""
    fn = resolve_ufunc(name)
    name = settings.np_ufunc_map.get(name, name)
    device = a.device if torch.is_tensor(a) else b.device
    a, b = _as_operand(a, device), _as_operand(b, device)
    if name == "ldexp":
        # jnp.ldexp: x1 real, x2 integer; x1 computes in its inexact dtype
        a, b = _alone(a, default_float, device), _alone(b, default_float,
                                                       device)
        if a.is_complex() or _is_inexact(b):
            raise ValueError(
                f"ldexp not supported for input types {(a.dtype, b.dtype)}")
        return fn(a.to(inexact_dtype(a.dtype)), b)
    a, b = promote(a, b, default_float)
    _refuse(name, (a.dtype,), _BOP_REFUSES)
    if name in _FLOAT_VALUED:
        dt = inexact_dtype(a.dtype)
        a, b = a.to(dt), b.to(dt)
    elif name in _BOOL_AS_INT32 and a.dtype == torch.bool:
        if name == "fmod":
            # jnp.fmod keeps a bool divisor of 0: XLA's remainder by 0
            # is the dividend.
            return torch.where(b, 0, a.to(torch.int32)).to(torch.int32)
        a, b = a.to(torch.int32), b.to(torch.int32)
    return fn(a, b)


def float_to_int(x, dtype: torch.dtype):
    """XLA's float-to-integer conversion, which the reference's ``astype``
    makes: toward 0, NaN to 0, and values beyond the target's range (±inf
    too) clamped to its limits. A plain ``Tensor.to`` is undefined there
    and differs between the host and the card. The clamp stays below
    ``2^k`` in x's own dtype (2^31 - 1 would round up to 2^31 in
    float32), and what reaches ``2^k`` is set to the maximum after the
    conversion."""
    info = torch.iinfo(dtype)
    if x.dtype.itemsize < 4:
        x = x.float()  # a half float cannot hold the limits of every target
    t = torch.trunc(x)
    top = float(info.max) + 1.0          # 2^k: exact in float32 and float64
    below = top * (1.0 - torch.finfo(x.dtype).eps / 2)  # the float below it
    out = t.clamp(float(info.min), below).to(dtype)
    out.masked_fill_(t >= top, info.max)
    out.masked_fill_(torch.isnan(t), 0)
    return out


def astype(x, dtype: torch.dtype):
    """``jnp``'s ``astype``: a complex source casts its real part, and a
    float source to an integer dtype saturates (``float_to_int``)."""
    if x.is_complex() and not dtype.is_complex and dtype != torch.bool:
        x = x.real
    if x.is_floating_point() and not (dtype.is_floating_point
                                      or dtype.is_complex
                                      or dtype == torch.bool):
        return float_to_int(x, dtype)
    return x.to(dtype)


def const_bool(x, value: bool):
    """Shape-preserving bool constant (eq/ne against incomparable
    operands)."""
    return torch.full(tuple(x.shape), bool(value), dtype=torch.bool,
                      device=x.device)


def touch(x):
    """A copy of ``x`` in a new tensor (the reference's identity kernel
    makes a new buffer)."""
    return x.clone()


def allclose(a, b, rtol, atol, default_float: torch.dtype):
    """0-d bool tensor: ``|a - b| <= atol + rtol * |b|`` everywhere (NaNs
    unequal), integers compared in their inexact dtype."""
    a, b = promote(a, b, default_float)
    if not _is_inexact(a):
        dt = inexact_dtype(a.dtype)
        a, b = a.to(dt), b.to(dt)
    return torch.isclose(a, b, rtol=float(rtol), atol=float(atol)).all()
