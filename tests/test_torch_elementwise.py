"""The port's elementwise layer against nums_tpu, ufunc by ufunc.

Every unary and binary ufunc of the facade (``UOP_NAMES``/``BOP_NAMES``
of ``nums_tpu/numpy/api.py``) runs on the same numpy inputs through both
packages' ``numpy.api`` on the CPU (the serial application, x64 on, as
tests/conftest.py runs the reference), in float32, float64, int32, int64
and bool. The port must give the reference's dtype and shape, and its
values: integer and bool results exactly; float64 within 1e-12 relative
(plus 1e-12 of max|ref|), float32 within 2e-6 relative plus 1e-6 of
max|ref| (a few ulps: torch's and XLA's transcendental functions round
differently). Where the reference raises, the port raises the same
exception type. Float inputs hold 0, -0, ±1, ±inf and NaN beside random
values; the integer divisors hold 0.

The one case kept apart is ``power`` of integers to a negative integer
exponent: jax wraps around (2 ** -3 gives 2305843009213693952 in int64)
and NumPy raises; the port keeps torch's truncated value, pinned below.

The repairs of the facade's casts and complex order follow: a float to
integer ``astype`` saturates as XLA's conversion does (NaN to 0, ±inf and
out-of-range values to the target's limits), exactly equal to the
reference; complex numbers sort, reduce, compare and clip in jnp's order
(real part, then imaginary part), ``sign`` is z/|z| and ``round`` rounds
each part; uint16/32/64 raise a ``TypeError`` that names the type.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

from nums_tpu.numpy import api as japi
from nums_tpu_torch.numpy import api as tapi

DTYPES = ["float32", "float64", "int32", "int64", "bool"]
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 0.5])


def _input(dtype, seed, nonneg=False):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random((3, 8)) > 0.5
    if dtype.startswith("int"):
        low = 0 if nonneg else -5
        return rng.integers(low, 6, (3, 8)).astype(dtype)
    x = rng.standard_normal((3, 8)) * 3
    x[0] = SPECIAL
    return x.astype(dtype)


def _run(fn, app, *args):
    """(result as numpy, None) or (None, exception type)."""
    try:
        with np.errstate(all="ignore"):
            out = fn(*[app.array(a) if isinstance(a, np.ndarray) else a
                       for a in args])
        return np.asarray(out.get()), None
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return None, type(e)


ULP = {"float64": (1e-12, 1e-12), "float32": (2e-6, 1e-6)}


def assert_close(g, r, dtype_name):
    """NaN and ±inf where the reference has them; elsewhere within
    ``rtol·|ref| + atol·max|ref|`` (the largest finite magnitude)."""
    rtol, atol = ULP[dtype_name]
    g, r = g.astype(np.float64), r.astype(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(r))
    fin = np.isfinite(r)
    assert np.array_equal(g[~fin & ~np.isnan(r)], r[~fin & ~np.isnan(r)])
    if fin.any():
        scale = np.max(np.abs(r[fin]))
        assert np.all(np.abs(g[fin] - r[fin])
                      <= rtol * np.abs(r[fin]) + atol * scale), (g, r)


def assert_same(got, ref):
    (g, g_exc), (r, r_exc) = got, ref
    if r_exc is not None:
        assert g_exc is r_exc, (g_exc, r_exc)
        return
    assert g_exc is None, g_exc
    assert g.shape == r.shape and g.dtype == r.dtype, (
        g.shape, g.dtype, r.shape, r.dtype)
    if r.dtype.kind in "biu":
        assert np.array_equal(g, r)
    else:
        assert_close(g, r, r.dtype.name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", japi.UOP_NAMES)
def test_unary_ufunc(jax_app, torch_app, name, dtype):
    x = _input(dtype, 0)
    assert_same(_run(getattr(tapi, name), torch_app, x),
                _run(getattr(japi, name), jax_app, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", japi.BOP_NAMES)
def test_binary_ufunc(jax_app, torch_app, name, dtype):
    x = _input(dtype, 1)
    # Integer powers to a negative exponent are the documented exception.
    y = _input(dtype, 2, nonneg=name == "power")
    assert_same(_run(getattr(tapi, name), torch_app, x, y),
                _run(getattr(japi, name), jax_app, x, y))


# Each fault that the port had against the reference, as its own case,
# through the applications' ``map_uop``/``map_bop`` and the operators.
I64 = np.arange(-1, 3)
FAULTS = {
    "ceil_int32": ("ceil", np.arange(-3, 3, dtype=np.int32)),
    "trunc_int64": ("trunc", np.arange(-3, 3)),
    "floor_bool": ("floor", np.array([True, False])),
    "rint": ("rint", np.array([0.5, 1.5, 2.5, -0.5, -2.5])),
    "rint_int32": ("rint", np.arange(3, dtype=np.int32)),
    "cbrt": ("cbrt", np.array([-27.0, 8.0, 2.0, 0.0, 1e-300])),
    "spacing": ("spacing", np.array([0.0, 1.0, -3.5, 1e300])),
    "abs_bool": ("abs", np.array([True, False])),
    "sign_bool": ("sign", np.array([True, False])),
    "ldexp_int64": ("ldexp", I64, I64 + 1),
    "copysign_int64": ("copysign", I64, -I64),
    "arctan2_int64": ("arctan2", I64, I64 + 2),
    "heaviside_int64": ("heaviside", I64, np.full(4, 5)),
    "nextafter_int64": ("nextafter", I64, I64 + 1),
    "logaddexp2_int64": ("logaddexp2", I64, I64),
    "hypot_int64": ("hypot", I64, I64),
    "int_floor_divide_0": ("floor_divide", I64, np.zeros(4, int)),
    "bool_div_2": (lambda x: x / 2, np.array([True, False])),
    "gram_bool": (lambda x: x.T @ x,
                  np.array([[True, False], [True, True], [False, False]])),
    "gram_t_bool": (lambda x: x @ x.T,
                    np.array([[True, False], [True, True], [False, False]])),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_repaired_fault(jax_app, torch_app, case):
    op, *args = FAULTS[case]

    def run(app):
        def fn(*bas):
            if callable(op):
                return op(*bas)
            if len(bas) == 1:
                return app.map_uop(op, bas[0])
            return app.map_bop(op, *bas)
        return _run(fn, app, *args)

    assert_same(run(torch_app), run(jax_app))


WEAK = {
    "int32_times_float": (np.arange(4, dtype=np.int32), lambda x: x * 2.5),
    "int32_plus_int": (np.arange(4, dtype=np.int32), lambda x: x + 1),
    "bool_plus_int": (np.array([True, False]), lambda x: x + 1),
    "float32_plus_float": (np.ones(3, np.float32), lambda x: x + 1.5),
    "float32_times_np_float64": (np.ones(3, np.float32),
                                 lambda x: x * np.float64(2.0)),
    "int64_rtruediv": (np.arange(1, 4), lambda x: 3 / x),
    "int32_rfloordiv": (np.arange(1, 4, dtype=np.int32), lambda x: 7 // x),
    "float_mod": (np.array([5.3, -5.3, 2.0]), lambda x: x % 0.7),
    "bool_xor": (np.array([True, False]), lambda x: x ^ True),
    "int_lshift": (np.arange(4), lambda x: x << 2),
    "int_rshift": (np.arange(8, 12), lambda x: x >> 1),
    "rand": (np.arange(4), lambda x: 6 & x),
    "ror": (np.arange(4), lambda x: 8 | x),
    "rxor": (np.arange(4), lambda x: 5 ^ x),
    "float32_pow_int": (np.arange(4, dtype=np.float32), lambda x: x ** 2),
}


@pytest.mark.parametrize("case", sorted(WEAK))
def test_scalar_promotion(jax_app, torch_app, case):
    x, fn = WEAK[case]
    assert_same(_run(fn, torch_app, x), _run(fn, jax_app, x))


def test_negative_integer_power_is_torchs_truncation(torch_app):
    """jax wraps (2 ** -3 is 2305843009213693952 in int64), NumPy raises;
    the port gives the truncated value: 0 for a base of magnitude above
    1, 1 for 1, ±1 for -1."""
    base = torch_app.array(np.array([2, -2, 1, -1, 1, -1, 3]))
    exp = torch_app.array(np.array([-3, -3, -3, -3, -2, -2, -1]))
    assert (base ** exp).get().tolist() == [0, 0, 1, -1, 1, 1, 0]
    assert (2 ** torch_app.array(np.array([-1, -3]))).get().tolist() == [0, 0]


CAST_SOURCE = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 1e20, 2.7, -2.7,
                        300.5, -129.0])


@pytest.mark.parametrize("source", ["float64", "float32"])
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "int64",
                                   "uint8", "bool"])
def test_float_to_int_cast_saturates(apps, dtype, source):
    x = CAST_SOURCE.astype(source)

    def fn(nps, app):
        return [app.array(x).astype(dtype), nps.asarray(app.array(x),
                                                        dtype=dtype),
                nps.array(x).astype(np.dtype(dtype))]

    facade_parity(apps, fn, "exact")


def test_float_to_int_never_rounds_the_limit_up():
    """The clamp stays below 2^k in the source's own float: the largest
    float32 below 2^31 converts exactly, 2^31 itself to the maximum."""
    import torch
    from nums_tpu_torch.core.ops import elementwise

    x = torch.tensor([2147483520.0, 2147483648.0, -2147483648.0,
                      -2147483904.0], dtype=torch.float32)
    assert elementwise.float_to_int(x, torch.int32).tolist() == [
        2147483520, 2147483647, -2147483648, -2147483648]
    y = torch.tensor([2.0 ** 63 - 1024, 2.0 ** 63, -(2.0 ** 63)],
                     dtype=torch.float64)
    assert elementwise.float_to_int(y, torch.int64).tolist() == [
        2 ** 63 - 1024, 2 ** 63 - 1, -(2 ** 63)]
    h = torch.tensor([70000.0, -1.5, float("nan")]).to(torch.float16)
    assert elementwise.float_to_int(h, torch.int16).tolist() == [
        32767, -1, 0]


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_unsigned_wide_types_raise_naming_the_type(torch_app, dtype):
    """torch holds uint16/32/64 but has no arithmetic for them: the port
    refuses them with a TypeError that names the type (the reference
    computes in them)."""
    import nums_tpu_torch.numpy as tnps

    with pytest.raises(TypeError, match=dtype):
        torch_app.array(CAST_SOURCE).astype(dtype)
    with pytest.raises(TypeError, match=dtype):
        tnps.array(np.arange(3, dtype=dtype))
    with pytest.raises(TypeError, match=dtype):
        tnps.zeros(3, dtype=dtype)


NANC = complex(np.nan, 0)
CX = np.array([1 + 2j, 1 - 1j, NANC, complex(0, np.nan), -1 + 5j, 1 + 2j,
               2 + 0j, 0j, complex(np.nan, np.nan), complex(1, np.nan)])
CY = np.array([1 + 2j, 1 - 1j, -1 + 5j, 2 + 0j, 0j, 1 + 3j, -0.0 + 1j,
               2 - 1j])
COMPLEX_ORDER = {
    "sort": lambda n: [n.sort(n.array(CX)), n.sort(n.array(CY)),
                       n.sort(n.array(CY), descending=True)],
    "argsort": lambda n: [n.argsort(n.array(CX)), n.argsort(n.array(CY))],
    "sort_axis0": lambda n: n.sort(n.array(CY.reshape(2, 4)), axis=0),
    "unique": lambda n: n.unique(n.array(np.concatenate([CY, CY[::2]])),
                                 return_index=True, return_inverse=True,
                                 return_counts=True),
    "max_min": lambda n: [n.max(n.array(CY)), n.min(n.array(CY)),
                          n.max(n.array(CY.reshape(2, 4)), axis=0),
                          n.min(n.array(CY.reshape(2, 4)), axis=1),
                          n.array(CY).max()],
    "maximum_minimum": lambda n: [n.maximum(n.array(CX), n.array(CX[::-1])),
                                  n.minimum(n.array(CX), n.array(CX[::-1]))],
    "comparisons": lambda n: [n.array(CX) < n.array(CX[::-1]),
                              n.array(CX) <= n.array(CX[::-1]),
                              n.array(CX) > n.array(CX[::-1]),
                              n.array(CX) >= n.array(CX[::-1]),
                              n.less(n.array(CY), 1 + 0j),
                              n.greater_equal(n.array(CY), 1 + 2j)],
    "clip": lambda n: n.clip(n.array(CY), 0.5, 1.5),
    "clip_complex_bound": lambda n: n.clip(n.array(np.arange(3.0)),
                                           0.5 + 1j, 1.5),
    "searchsorted": lambda n: [
        n.searchsorted(n.sort(n.array(CY)), n.array(CX)),
        n.searchsorted(n.sort(n.array(CY)), n.array(CX), side="right")],
    "sign": lambda n: n.sign(n.array(np.concatenate([CX, [
        0j, -3 + 4j, complex(np.inf, 0), complex(np.inf, 1), -2.5 + 0j]]))),
    "round": lambda n: [n.round(n.array(np.array([1.5 + 2.5j, -0.5 - 1.5j,
                                                  2.567 + 1.234j])), 1),
                        n.around(n.array(np.array([1.5 + 2.5j,
                                                   -0.5 - 1.5j]))),
                        n.round(n.array(CY.astype(np.complex64)))],
}


@pytest.mark.parametrize("case", sorted(COMPLEX_ORDER))
def test_complex_order(apps, case):
    facade_parity(apps, lambda nps, app: COMPLEX_ORDER[case](nps))
