"""The port's array layer against nums_tpu, op by op.

Each op runs on the same numpy inputs through both packages' serial
applications on the CPU, in float64 and float32; results must agree in
shape, dtype and block shape, and in value to 1e-12 (float64) or 1e-6
(float32) relative to the largest magnitude: the same elementwise
arithmetic and reductions, in another summation order. Float32
contractions run under ``matmul_precision="highest"`` here (both sides
plain float32); the bf16-class gram route is tested below and in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import cuda_gram

TOL = {"float64": 1e-12, "float32": 1e-6}

OPS = {
    "add": lambda app, a, b: a + b,
    "sub_scalar": lambda app, a, b: a - 1.5,
    "rsub": lambda app, a, b: 2 - a,
    "mul": lambda app, a, b: a * b,
    "div": lambda app, a, b: a / (abs(b) + 1.0),
    "rdiv": lambda app, a, b: 3.0 / (abs(a) + 1),
    "pow": lambda app, a, b: abs(a) ** 2,
    "neg": lambda app, a, b: -a,
    "abs": lambda app, a, b: abs(a),
    "exp": lambda app, a, b: app.exp(a),
    "scalar_array": lambda app, a, b: a * app.scalar(2.0),
    "eq": lambda app, a, b: a == b,
    "ne": lambda app, a, b: a != b,
    "lt": lambda app, a, b: a < b,
    "le": lambda app, a, b: a <= b,
    "gt": lambda app, a, b: a > 0,
    "ge": lambda app, a, b: a >= b,
    "eq_none": lambda app, a, b: a == None,  # noqa: E711 - elementwise
    "ne_none": lambda app, a, b: a != None,  # noqa: E711 - elementwise
    "astype_int": lambda app, a, b: (a * 10).astype(np.int64),
    "int_exp": lambda app, a, b: app.exp((a * 3).astype(np.int64)),
    "int_div": lambda app, a, b: (a * 10).astype(np.int64) / 3,
    "int_plus_float": lambda app, a, b: (a * 10).astype(np.int32) + 1.5,
    "bool_plus_int": lambda app, a, b: (a > 0) + 1,
    "T": lambda app, a, b: a.T,
    "TT": lambda app, a, b: a.T.T,
    "T_add": lambda app, a, b: a.T + b.T,
    "T_exp": lambda app, a, b: app.exp(a.T),
    "T_sum0": lambda app, a, b: a.T.sum(axis=0),
    "sum": lambda app, a, b: a.sum(),
    "sum0": lambda app, a, b: a.sum(axis=0),
    "sum1_keep": lambda app, a, b: a.sum(axis=1, keepdims=True),
    "app_sum": lambda app, a, b: app.sum(a, axis=0),
    "sum_acc_dtype": lambda app, a, b: (a * 1e3).astype(np.int32).sum(
        dtype=np.int64),
    "mean": lambda app, a, b: a.mean(),
    "mean1": lambda app, a, b: a.mean(axis=1),
    "app_mean": lambda app, a, b: app.mean(a),
    "bool_mean": lambda app, a, b: (a > 0).mean(),
    "min0": lambda app, a, b: a.min(axis=0),
    "max": lambda app, a, b: a.max(),
    "getitem": lambda app, a, b: a[2:5, 1],
    "getitem_last": lambda app, a, b: a[-1],
    "getitem_head": lambda app, a, b: a[:-1],
    "vec_last": lambda app, a, b: a[0][-1],
    "vec_head": lambda app, a, b: a[0][:-1],
    "gram": lambda app, a, b: a.T @ a,
    "xty": lambda app, a, b: a.T @ b,
    "matvec": lambda app, a, b: a @ b[0],
    "vdot": lambda app, a, b: a[0] @ b[0],
    "tensordot": lambda app, a, b: a.tensordot(b.T, axes=1),
    "concat0": lambda app, a, b: app.concatenate([a, b], axis=0),
    "concat1": lambda app, a, b: app.concatenate(
        [a, b], axis=1, axis_block_size=3),
    "reshape": lambda app, a, b: a.reshape(84),
    "reshape_block": lambda app, a, b: a.reshape(
        (12, 7), block_shape=(6, 7)),
    "app_reduce_sum": lambda app, a, b: app.reduce("sum", a, axis=1),
    "app_reduce_max_keep": lambda app, a, b: app.reduce(
        "max", a, axis=0, keepdims=True),
    "app_reduce_acc_dtype": lambda app, a, b: app.reduce(
        "sum", (a * 1e3).astype(np.int32), dtype=np.int64),
    "app_min": lambda app, a, b: app.min(a, axis=1),
    "app_argmin": lambda app, a, b: app.argmin(a[:, 2]),
    "app_argmax": lambda app, a, b: app.argmax(a[3]),
    "app_argop": lambda app, a, b: app.argop("argmax", b[:, 0], axis=0),
    "app_matmul": lambda app, a, b: app.matmul(a, b.T),
    "app_matmul_gram": lambda app, a, b: app.matmul(a.T, a),
    "app_matvec": lambda app, a, b: app.matmul(a, b[0]),
    "app_tensordot1": lambda app, a, b: app.tensordot(a.T, b, axes=1),
    "app_tensordot2": lambda app, a, b: app.tensordot(a, b, axes=2),
    "app_tensordot0": lambda app, a, b: app.tensordot(a[0], b[1], axes=0),
    "app_allclose_true": lambda app, a, b: app.allclose(a, a + 1e-9),
    "app_allclose_false": lambda app, a, b: app.allclose(a, b),
    "app_allclose_tol": lambda app, a, b: app.allclose(
        a, a * 1.01, rtol=0.1, atol=0.0),
    "app_split0": lambda app, a, b: app.split(a, 3, axis=0)[1],
    "app_split1": lambda app, a, b: app.split(a, 7, axis=1)[6],
    "app_where1_rows": lambda app, a, b: app.where(a > 0)[0],
    "app_where1_cols": lambda app, a, b: app.where(a > 0)[1],
    "app_where1_vec": lambda app, a, b: app.where(a[0] > b[1])[0],
    "app_where1_none": lambda app, a, b: app.where(a > 1e9)[1],
    "app_where3": lambda app, a, b: app.where(a > 0, a, b),
}


def _inputs(dtype):
    rs = np.random.RandomState(11)
    a = rs.randn(12, 7).astype(dtype)
    b = rs.randn(12, 7).astype(dtype)
    b[:3] = a[:3]  # some equal entries for the comparisons
    return a, b


def _compare(got, ref, tol):
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert got.block_shape == ref.block_shape
    g, r = np.asarray(got.get()), np.asarray(ref.get())
    assert g.shape == r.shape and g.dtype == r.dtype
    if r.dtype.kind in "fc":
        assert rel_err(g, r) <= tol
    else:
        assert np.array_equal(g, r)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_nums_tpu(jax_app, torch_app, monkeypatch, op, dtype):
    monkeypatch.setattr(settings, "matmul_precision", "highest")
    a, b = _inputs(dtype)
    fn = OPS[op]
    ref = fn(jax_app, jax_app.array(a, block_shape=(4, 7)),
             jax_app.array(b, block_shape=(4, 7)))
    got = fn(torch_app, torch_app.array(a, block_shape=(4, 7)),
             torch_app.array(b, block_shape=(4, 7)))
    _compare(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", [None, "float32", "int64", "bool"])
def test_creation_matches_nums_tpu(jax_app, torch_app, dtype):
    for make in (
        lambda app: app.zeros((5, 3), (2, 3), dtype=dtype),
        lambda app: app.ones((5,), (2,), dtype=dtype),
        lambda app: app.full((4, 2), (4, 1), 1, dtype=dtype),
        lambda app: app.array(np.arange(6).reshape(2, 3).astype(
            dtype or "float64"), block_shape=(1, 3)),
        lambda app: app.scalar(np.asarray(1, dtype or "float64")[()]),
    ):
        _compare(make(torch_app), make(jax_app), 0.0)


@pytest.mark.parametrize("dtype", [None, "float32", "int64", "int32"])
def test_empty_arange_linspace_match_nums_tpu(jax_app, torch_app, dtype):
    makers = [
        lambda app: app.empty((5, 3), (2, 3), dtype=dtype),
        lambda app: app.arange((11,), (4,), dtype=dtype),
        lambda app: app.linspace(-1.0, 2.5, (9,), (4,), dtype=dtype),
        lambda app: app.linspace(0.0, 10.0, (5,), (5,), endpoint=False,
                                 dtype=dtype),
        lambda app: app.linspace(3.0, 4.0, (1,), (1,), dtype=dtype),
    ]
    for make in makers:
        _compare(make(torch_app), make(jax_app),
                 1e-6 if dtype == "float32" else 1e-15)
    assert not torch_app.empty((3,), (3,)).get().any()  # zeros, as there
    ends = torch_app.linspace(-1.0, 2.5, (9,), (4,)).get()
    assert ends[0] == -1.0 and ends[-1] == 2.5


def test_split_argop_and_where_contracts(jax_app, torch_app):
    a = torch_app.array(np.arange(24.0).reshape(6, 4), block_shape=(2, 4))
    parts = torch_app.split(a, 3)
    assert [p.shape for p in parts] == [(2, 4)] * 3
    assert np.array_equal(np.concatenate([p.get() for p in parts]), a.get())
    with pytest.raises(NotImplementedError):
        torch_app.split(a, [2, 4])
    with pytest.raises(AssertionError):
        torch_app.split(a, 4)
    for app in (torch_app, jax_app):
        with pytest.raises(NotImplementedError):
            app.argmin(app.array(np.zeros((2, 2)), block_shape=(2, 2)))
    ties = np.array([3.0, 1.0, 1.0, 7.0, 7.0])
    t = torch_app.array(ties, block_shape=(5,))
    assert int(torch_app.argmin(t)) == 1 and int(torch_app.argmax(t)) == 3
    assert torch_app.argmin(t).dtype == np.int64
    rows, cols = torch_app.where(a > 10.0)
    want = np.where(a.get() > 10.0)
    assert np.array_equal(rows.get(), want[0])
    assert np.array_equal(cols.get(), want[1])
    assert rows.dtype == cols.dtype == np.int64
    assert bool(torch_app.allclose(a, a)) is True
    assert torch_app.allclose(a, a).shape == ()


def test_app_matmul_of_the_gram_takes_the_kernel_route(torch_app, spy_calls):
    """``app.matmul(X.T, X)`` and ``app.tensordot(X.T, X, axes=1)`` at the
    default precision reach the gram kernel's wrapper (its plain version
    on a CPU tensor: the launch counter stays 0, only a CUDA launch
    counts); any other product is ``torch.matmul``."""
    calls = spy_calls(cuda_gram, "gram")
    before = dict(cuda_gram.LAUNCHES)
    x = np.random.RandomState(3).randn(256, 64).astype(np.float32)
    X = torch_app.array(x, block_shape=(128, 64))
    g = torch_app.matmul(X.T, X)
    assert len(calls) == 1
    g2 = torch_app.tensordot(X.T, X, axes=1)
    assert len(calls) == 2
    assert np.array_equal(g.get(), g2.get())
    assert rel_err(g.get(), x.astype(np.float64).T @ x) < GRAM_BF16_REL
    Y = torch_app.array(x.copy(), block_shape=(128, 64))
    torch_app.matmul(X.T, Y)
    torch_app.matmul(X, X.T)
    torch_app.tensordot(X, X, axes=2)
    assert len(calls) == 2
    assert dict(cuda_gram.LAUNCHES) == before


def test_app_get_touch_and_scalars(torch_app):
    a = torch_app.array(np.arange(6.0).reshape(2, 3), block_shape=(1, 3))
    assert torch_app.touch(a) is a
    x, y = torch_app.get(a, a.T)
    assert np.array_equal(x, np.arange(6.0).reshape(2, 3))
    assert np.array_equal(y, x.T)
    assert float(a.sum()) == 15.0 and int(a[1, 2]) == 5
    assert bool(torch_app.scalar(True)) and len(a) == 2
    assert np.array_equal(np.asarray(a), x)


@pytest.mark.parametrize(
    "shape,dtype",
    [((2_500_000, 1000), "float32"), ((10_000_000, 100), "float64"),
     ((1000,), "float64"), ((30_000, 30_000), "float32")],
)
def test_block_shape_policy_matches_nums_tpu(jax_app, torch_app, shape,
                                             dtype):
    assert torch_app.compute_block_shape(shape, dtype) == (
        jax_app.compute_block_shape(shape, dtype)
    )
    assert torch_app.get_block_shape(shape, dtype) == (
        jax_app.get_block_shape(shape, dtype)
    )


def test_float32_gram_takes_the_kernel_route(jax_app, torch_app,
                                             spy_calls, monkeypatch):
    """In the default precision class ``x.T @ x`` on float32 goes to the
    gram kernel (its plain version on the CPU) by dtype alone: no lane
    padding. Bf16 class against the reference's exact CPU product."""
    calls = spy_calls(cuda_gram, "gram")
    x = np.random.RandomState(2).randn(300, 100).astype(np.float32)
    bx = torch_app.array(x, block_shape=(100, 100))
    g = bx.T @ bx
    assert len(calls) == 1 and tuple(calls[0][0].shape) == (300, 100)
    ref = jax_app.array(x, block_shape=(100, 100))
    assert g.block_shape == (ref.T @ ref).block_shape
    assert rel_err(g.get(), (ref.T @ ref).get()) < GRAM_BF16_REL
    assert np.array_equal(g.get(), g.get().T)
    # Not a gram: another operand, float64, or precision "highest".
    by = torch_app.array(x.copy(), block_shape=(100, 100))
    bx.T @ by
    bx64 = torch_app.array(x.astype(np.float64), block_shape=(100, 100))
    bx64.T @ bx64
    monkeypatch.setattr(settings, "matmul_precision", "highest")
    bx.T @ bx
    assert len(calls) == 1
