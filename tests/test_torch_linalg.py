"""nums_tpu_torch's linalg layer against nums_tpu's, on the CPU: the ops of
``core/ops/linalg.py`` (Householder TSQR trees, CholeskyQR2 and its streamed
and R-only forms, the compensated gram, SVD, randomized SVD, least squares)
and the application's entry points on top of them (after
tests/core/array/test_linalg.py, tests/core/array/test_cholqr.py and
tests/core/ops/test_tsqr_kernels.py), with ``eye_k``, ``var`` and ``std``.

R is unique up to the sign of each row and (U, Vᵀ) up to the sign of each
pair, so the packages are compared on |R|, QR − X, QᵀQ − I, the singular
values, θ, and U, Vᵀ after the models' sign convention; never on raw Q or U.

Tolerances, relative to the largest magnitude of the reference's output:
float64 1e-10, float32 1e-4; the three forms of ``_gram`` in float32 within
1e-6 of a float64 gram; grids (``shape``, ``block_shape``) and dtypes equal.
``ridge_regression`` in float32 at the "default" precision against the
reference's Pallas gram in interpret mode: ``GRAM_BF16_REL``.

The trees take chunk = max(chunk, 2n) here (the reference's max(chunk, n)
never returns when chunk < 2n < m): the shapes on which the reference hangs
run under a deadline against numpy.
"""

import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu.core import settings as jsettings
from nums_tpu.core.ops import linalg as jlinalg
from nums_tpu_torch.core import settings as tsettings
from nums_tpu_torch.core.ops import cuda_gram
from nums_tpu_torch.core.ops import linalg as tlinalg

TOL = {"float64": 1e-10, "float32": 1e-4}
GRAM_F32_REL = 1e-6
DEADLINE_S = 120.0


def _within_deadline(fn, seconds=DEADLINE_S):
    """fn() on a daemon thread; a call that has not returned after
    ``seconds`` fails the test, and the suite goes on."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"no result after {seconds} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _flip(u, vt):
    """The models' sign convention (sklearn's u-based svd_flip) in numpy."""
    u, vt = np.array(u, dtype=np.float64), np.array(vt, dtype=np.float64)
    idx = np.argmax(np.abs(u), axis=0)
    signs = np.sign(u[idx, np.arange(u.shape[1])])
    signs[signs == 0] = 1.0
    return u * signs[None, :], vt * signs[:, None]


def _matrix(seed, m, n, dtype, cond=None):
    """A seeded (m, n) matrix; with ``cond``, singular values spaced
    geometrically from 1 down to 1 / cond."""
    rs = np.random.RandomState(seed)
    x = rs.randn(m, n)
    if cond is not None:
        u, _, vt = np.linalg.svd(x, full_matrices=False)
        x = (u * np.geomspace(1.0, 1.0 / cond, min(m, n))) @ vt
    return x.astype(dtype)


def _check_qr(q, r, x, tol):
    q, r, x = (np.asarray(a, dtype=np.float64) for a in (q, r, x))
    n = r.shape[1]
    assert np.array_equal(r, np.triu(r))
    assert np.max(np.abs(q @ r - x)) <= tol * np.max(np.abs(x))
    assert np.max(np.abs(q.T @ q - np.eye(q.shape[1]))) <= tol
    assert q.shape == (x.shape[0], min(x.shape)) and r.shape[1] == n


@pytest.fixture(params=["householder", "cholqr2"])
def method(request, monkeypatch):
    """``settings.tsqr_method`` set alike in both packages."""
    monkeypatch.setattr(jsettings, "tsqr_method", request.param)
    monkeypatch.setattr(tsettings, "tsqr_method", request.param)
    return request.param


# ----------------------------------------------------------------------
# The repair: shapes on which chunk < 2n < m
# ----------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(1500, 1000), (15, 10)])
def test_tsqr_r_ooc_returns_in_one_panel(torch_app, tmp_path, m, n):
    """[R; panel] is d + m rows at chunk min(m, max(d, 8192)) = m < 2d."""
    x = _matrix(m, m, n, np.float64)
    dX = torch_app.spill(torch_app.array(x, block_shape=(m, n)),
                         str(tmp_path / "one_panel"))
    assert dX.num_row_panels == 1
    R = _within_deadline(lambda: torch_app.tsqr_r_ooc(dX).get())
    ref = np.linalg.qr(x, mode="r")
    assert np.array_equal(R, np.triu(R))
    assert rel_err(np.abs(R), np.abs(ref)) <= 1e-10


@pytest.mark.parametrize("m,n,chunk", [(40, 20, 32), (300, 150, 200),
                                       (37, 20, 20)])
def test_trees_return_where_chunk_is_under_2n(m, n, chunk):
    """The arithmetic of m = 10000, n = 5000, chunk = 8192: k = 2 panels
    keep 2n = m rows for ever under max(chunk, n)."""
    x = _matrix(n, m, n, np.float64)
    t = torch.from_numpy(x)
    ref = np.linalg.qr(x, mode="r")
    R = _within_deadline(lambda: tlinalg._tsqr_r_impl(t, chunk)).numpy()
    assert rel_err(np.abs(R), np.abs(ref)) <= 1e-10
    q, r = _within_deadline(lambda: tlinalg._direct_tsqr_impl(t, chunk))
    q, r = q.numpy(), r.numpy()
    assert rel_err(np.abs(r), np.abs(ref)) <= 1e-10
    assert np.max(np.abs(q @ r - x)) <= 1e-12 * np.max(np.abs(x))
    assert np.max(np.abs(q.T @ q - np.eye(n))) <= 1e-12


# ----------------------------------------------------------------------
# core/ops/linalg.py against nums_tpu/core/ops/linalg.py
# ----------------------------------------------------------------------

OPS_SHAPES = [(2000, 16, 256), (1037, 7, 64), (20000, 64, 8192)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("m,n,chunk", OPS_SHAPES)
def test_direct_tsqr_and_svd_ops(m, n, chunk, dtype):
    tol = TOL[dtype]
    x = _matrix(m + n, m, n, dtype)
    t = torch.from_numpy(x)
    q, r = tlinalg.direct_tsqr(chunk, t)
    jq, jr = jlinalg.direct_tsqr(chunk)(x)
    assert q.dtype == t.dtype and r.dtype == t.dtype
    _check_qr(q.numpy(), r.numpy(), x, tol)
    _check_qr(jq, jr, x, tol)
    assert rel_err(np.abs(r.numpy()), np.abs(np.asarray(jr))) <= tol
    assert rel_err(np.abs(tlinalg.tsqr_r(chunk)(t).numpy()),
                   np.abs(np.asarray(jr))) <= tol
    u, s, vt = tlinalg.svd(chunk, t)
    ju, js, jvt = jlinalg.svd(chunk)(x)
    assert rel_err(s.numpy(), js) <= tol
    fu, fvt = _flip(u.numpy(), vt.numpy())
    rfu, rfvt = _flip(ju, jvt)
    assert rel_err(fu, rfu) <= tol * 10 and rel_err(fvt, rfvt) <= tol * 10
    assert rel_err((u * s) @ vt, x) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["cholqr2", "cholqr2_stream"])
@pytest.mark.parametrize("m,n", [(2000, 16), (5003, 33)])
def test_cholqr2_ops(name, m, n, dtype):
    """CholeskyQR2 and its streamed form (chunks of 1024 rows, a ragged
    last one), which overwrites its input with Q."""
    tol = TOL[dtype]
    x = _matrix(m, m, n, dtype, cond=50.0)
    t = torch.from_numpy(x.copy())
    if name == "cholqr2":
        q, r = tlinalg.cholqr2(t)
        jq, jr = jlinalg.cholqr2()(x)
        assert np.array_equal(t.numpy(), x)
    else:
        q, r = tlinalg.cholqr2_stream(1024, t)
        jq, jr = jlinalg.cholqr2_stream(1024)(jax.numpy.asarray(x))
        assert q.data_ptr() == t.data_ptr(), "Q is not X's own storage"
    _check_qr(q.numpy(), r.numpy(), x, tol)
    # A Cholesky factor has a positive diagonal: R itself is comparable.
    assert rel_err(r.numpy(), jr) <= tol
    assert rel_err(q.numpy(), jq) <= tol * 10


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["cholqr_r", "svd_cholqr", "lstsq",
                                  "lstsq_cholqr"])
def test_cholqr_family_ops(name, dtype):
    tol = TOL[dtype]
    m, n, chunk = 3001, 12, 512
    x = _matrix(5, m, n, dtype, cond=20.0)
    y = (x.astype(np.float64) @ np.linspace(-1, 1, n)
         + 0.01 * np.random.RandomState(6).randn(m)).astype(dtype)
    t, ty = torch.from_numpy(x), torch.from_numpy(y)
    if name == "cholqr_r":
        got, ref = tlinalg.cholqr_r(t), jlinalg.cholqr_r()(x)
        assert rel_err(got.numpy(), ref) <= tol
        assert rel_err(got.numpy().T @ got.numpy(),
                       x.astype(np.float64).T @ x.astype(np.float64)) <= tol
    elif name == "svd_cholqr":
        u, s, vt = tlinalg.svd_cholqr(t)
        ju, js, jvt = jlinalg.svd_cholqr()(x)
        assert rel_err(s.numpy(), js) <= tol
        assert rel_err(s.numpy(), np.linalg.svd(
            x.astype(np.float64), compute_uv=False)) <= tol
        fu, fvt = _flip(u.numpy(), vt.numpy())
        rfu, rfvt = _flip(ju, jvt)
        assert rel_err(fu, rfu) <= tol * 10
        assert rel_err(fvt, rfvt) <= tol * 10
    else:
        if name == "lstsq":
            got = tlinalg.lstsq(chunk, t, ty)
            ref = jlinalg.lstsq(chunk)(x, y)
        else:
            got = tlinalg.lstsq_cholqr(t, ty)
            ref = jlinalg.lstsq_cholqr()(x, y)
        want = np.linalg.lstsq(x.astype(np.float64), y.astype(np.float64),
                               rcond=None)[0]
        assert got.shape == (n,) and got.dtype == t.dtype
        assert rel_err(got.numpy(), ref) <= tol
        assert rel_err(got.numpy(), want) <= tol * 10


def test_lstsq_takes_a_matrix_of_right_hand_sides():
    x = _matrix(8, 500, 6, np.float64)
    y = _matrix(9, 500, 3, np.float64)
    want = np.linalg.lstsq(x, y, rcond=None)[0]
    for got in (tlinalg.lstsq(64, torch.from_numpy(x), torch.from_numpy(y)),
                tlinalg.lstsq_cholqr(torch.from_numpy(x),
                                     torch.from_numpy(y))):
        assert rel_err(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_randomized_svd_op_on_the_same_sketch(dtype):
    """The same omega, from numpy, through both packages."""
    tol = TOL[dtype]
    m, n, k, ell = 4000, 60, 5, 15
    x = _matrix(11, m, n, dtype, cond=1e4)
    omega = np.random.RandomState(12).randn(n, ell).astype(dtype)
    u, s, vt = tlinalg.randomized_svd(
        k, 2, 1024, torch.from_numpy(x), torch.from_numpy(omega))
    ju, js, jvt = jlinalg.randomized_svd(k, 2, 1024)(x, omega)
    assert u.shape == (m, k) and s.shape == (k,) and vt.shape == (k, n)
    assert rel_err(s.numpy(), js) <= tol
    # The sketch's own accuracy on this spectrum (two power iterations).
    assert rel_err(s.numpy(), np.linalg.svd(
        x.astype(np.float64), compute_uv=False)[:k]) <= max(tol * 10, 1e-5)
    fu, fvt = _flip(u.numpy(), vt.numpy())
    rfu, rfvt = _flip(ju, jvt)
    assert rel_err(fu, rfu) <= tol * 100 and rel_err(fvt, rfvt) <= tol * 100


@pytest.mark.parametrize("form", ["plain", "tree", "kahan"])
@pytest.mark.parametrize("m", [16384, 20000])
def test_gram_forms(monkeypatch, form, m):
    """``_gram``'s one product, its batched chunk-grams with the pairwise
    tree, and its Kahan loop (the stack ceiling lowered in both packages
    to reach it), with and without a ragged tail of rows, in float32
    against a float64 gram and against the reference's same form."""
    n = 24
    x = (_matrix(m, m, n, np.float32) + np.float32(0.5))
    if form == "kahan":
        monkeypatch.setattr(tlinalg, "_COMP_STACK_BYTES", 0)
        monkeypatch.setattr(jlinalg, "_COMP_STACK_BYTES", 0)
    comp = form != "plain"
    got = tlinalg._gram(torch.from_numpy(x), compensated=comp).numpy()
    ref = np.asarray(jlinalg._gram(x, jax.lax.Precision.HIGHEST,
                                   compensated=comp))
    x64 = x.astype(np.float64)
    assert got.dtype == np.float32
    assert rel_err(got, x64.T @ x64) <= GRAM_F32_REL
    assert rel_err(got, ref) <= GRAM_F32_REL


def test_gram_compensates_tall_float32_by_default(monkeypatch, spy_calls):
    """Auto: float32 inputs of at least ``_COMP_MIN_ROWS`` rows take the
    chunked form; float64 and short inputs the one product."""
    assert (tlinalg._COMP_CHUNK, tlinalg._COMP_MIN_ROWS,
            tlinalg._COMP_STACK_BYTES) == (
        jlinalg._COMP_CHUNK, jlinalg._COMP_MIN_ROWS,
        jlinalg._COMP_STACK_BYTES) == (4096, 1 << 20, 512 << 20)
    monkeypatch.setattr(tlinalg, "_COMP_MIN_ROWS", 10000)
    bmm = spy_calls(torch, "bmm")
    x = torch.from_numpy(_matrix(1, 12288, 8, np.float32))
    tlinalg._gram(x)
    assert len(bmm) == 1 and tuple(bmm[0][1].shape) == (3, 4096, 8)
    tlinalg._gram(x.double())
    tlinalg._gram(x[:9000])
    assert len(bmm) == 1


def test_rank_deficient_gives_nans_not_an_error():
    """A zero column: the Cholesky factor fails, and the result is NaN in
    both packages, with no exception and no host sync to raise one."""
    x = _matrix(2, 300, 5, np.float64)
    x[:, 2] = 0.0
    q, r = tlinalg.cholqr2(torch.from_numpy(x))
    jq, jr = jlinalg.cholqr2()(x)
    assert np.isnan(r.numpy()).any() and np.isnan(np.asarray(jr)).any()
    assert np.isnan(q.numpy()).any() and np.isnan(np.asarray(jq)).any()
    assert np.isnan(tlinalg.cholqr_r(torch.from_numpy(x)).numpy()).any()


# ----------------------------------------------------------------------
# ArrayApplication entry points
# ----------------------------------------------------------------------

APP_CASES = [("float64", (2000, 16), (500, 16)),
             ("float32", (1037, 7), (300, 7))]


def _both(jax_app, torch_app, x, block_shape):
    return (torch_app.array(x, block_shape=block_shape),
            jax_app.array(x, block_shape=block_shape))


def _same_grid(got, ref):
    assert got.shape == tuple(ref.shape), (got.shape, ref.shape)
    assert got.block_shape == tuple(ref.block_shape), (
        got.block_shape, ref.block_shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)


@pytest.fixture(params=APP_CASES, ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}")
def case(request, jax_app, torch_app):
    dtype, shape, block = request.param
    x = _matrix(shape[0], *shape, dtype, cond=30.0)
    y = (x.astype(np.float64) @ np.linspace(1, 2, shape[1])
         + 0.05 * np.random.RandomState(3).randn(shape[0])).astype(dtype)
    X, jX = _both(jax_app, torch_app, x, block)
    Y, jY = _both(jax_app, torch_app, y, block[:1])
    return dict(x=x, y=y, X=X, jX=jX, Y=Y, jY=jY, tol=TOL[dtype])


def test_indirect_tsr(jax_app, torch_app, method, case):
    R, jR = torch_app.indirect_tsr(case["X"]), jax_app.indirect_tsr(case["jX"])
    _same_grid(R, jR)
    assert rel_err(np.abs(R.get()), np.abs(np.asarray(jR.get()))) <= case["tol"]
    assert np.array_equal(R.get(), np.triu(R.get()))


@pytest.mark.parametrize("entry", ["indirect_tsqr", "qr", "direct_tsqr"])
def test_tsqr_entry_points(jax_app, torch_app, method, case, entry):
    Q, R = getattr(torch_app, entry)(case["X"])
    jQ, jR = getattr(jax_app, entry)(case["jX"])
    _same_grid(Q, jQ)
    _same_grid(R, jR)
    _check_qr(Q.get(), R.get(), case["x"], case["tol"])
    assert rel_err(np.abs(R.get()), np.abs(np.asarray(jR.get()))) <= case["tol"]
    assert np.array_equal(case["X"].get(), case["x"]), "X was overwritten"


def test_svd_entry_point(jax_app, torch_app, method, case):
    got, ref = torch_app.svd(case["X"]), jax_app.svd(case["jX"])
    for a, b in zip(got, ref):
        _same_grid(a, b)
    tol = case["tol"]
    u, s, vt = (a.get() for a in got)
    ju, js, jvt = (np.asarray(a.get()) for a in ref)
    assert rel_err(s, js) <= tol
    assert rel_err(s, np.linalg.svd(case["x"].astype(np.float64),
                                    compute_uv=False)) <= tol
    fu, fvt = _flip(u, vt)
    rfu, rfvt = _flip(ju, jvt)
    assert rel_err(fu, rfu) <= tol * 10 and rel_err(fvt, rfvt) <= tol * 10


@pytest.mark.parametrize("entry", ["linear_regression", "lstsq",
                                   "fast_linear_regression"])
def test_regression_entry_points(jax_app, torch_app, method, case, entry):
    got = getattr(torch_app, entry)(case["X"], case["Y"])
    ref = getattr(jax_app, entry)(case["jX"], case["jY"])
    _same_grid(got, ref)
    want = np.linalg.lstsq(case["x"].astype(np.float64),
                           case["y"].astype(np.float64), rcond=None)[0]
    assert rel_err(got.get(), ref.get()) <= case["tol"]
    assert rel_err(got.get(), want) <= case["tol"] * 10


@pytest.mark.parametrize("lamb", [0.0, 3.0])
def test_ridge_regression(jax_app, torch_app, method, case, lamb,
                          monkeypatch):
    """At "highest" both packages run plain ops (the gram kernel's gate
    follows the precision): the float64 and float32 tolerances hold."""
    monkeypatch.setattr(tsettings, "matmul_precision", "highest")
    got = torch_app.ridge_regression(case["X"], case["Y"], lamb)
    ref = jax_app.ridge_regression(case["jX"], case["jY"], lamb)
    _same_grid(got, ref)
    x, y = case["x"].astype(np.float64), case["y"].astype(np.float64)
    want = np.linalg.solve(x.T @ x + lamb * np.eye(x.shape[1]), x.T @ y)
    assert rel_err(got.get(), ref.get()) <= case["tol"] * 10
    assert rel_err(got.get(), want) <= case["tol"] * 10


@pytest.fixture
def pallas_gram_route(monkeypatch):
    """nums_tpu with its Pallas gram forced on (interpret mode on the CPU),
    jax's compiled traces dropped before and after."""
    monkeypatch.setenv("NUMS_TPU_PALLAS_GRAM", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_ridge_regression_gram_kernel_route(jax_app, torch_app, spy_calls,
                                            pallas_gram_route):
    """float32 at the "default" precision: ``R.T @ R`` goes to the gram
    kernel's wrapper once (its plain version on a CPU tensor), and to the
    reference's Pallas kernel, which takes a width that is a multiple of
    128 and at least 512 rows: R is 512 x 512."""
    from nums_tpu.core.ops import pallas_gram

    assert tsettings.matmul_precision == "default"
    m, n, lamb = 2048, 512, 1.0
    x = _matrix(21, m, n, np.float32)
    y = (x @ np.random.RandomState(22).randn(n).astype(np.float32)
         + np.float32(0.1) * np.random.RandomState(23).randn(m).astype(
             np.float32))
    X, jX = _both(jax_app, torch_app, x, (512, n))
    Y, jY = _both(jax_app, torch_app, y, (512,))
    grams = spy_calls(cuda_gram, "gram")
    pallas = spy_calls(pallas_gram, "gram_fn")
    got = torch_app.ridge_regression(X, Y, lamb)
    assert [tuple(a[0].shape) for a in grams] == [(n, n)]
    assert grams[0][0].dtype == torch.float32
    ref = jax_app.ridge_regression(jX, jY, lamb)
    assert pallas, "the reference did not take its Pallas route"
    _same_grid(got, ref)
    assert rel_err(got.get(), ref.get()) <= GRAM_BF16_REL
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = np.linalg.solve(x64.T @ x64 + lamb * np.eye(n), x64.T @ y64)
    assert rel_err(got.get(), want) <= 1e-2


@pytest.mark.parametrize("entry", ["indirect_tsr", "direct_tsqr", "svd"])
def test_wide_matrix_takes_householder(jax_app, torch_app, monkeypatch,
                                       spy_calls, entry):
    """m < n has no full column rank: the Householder route whatever the
    setting says."""
    monkeypatch.setattr(jsettings, "tsqr_method", "cholqr2")
    monkeypatch.setattr(tsettings, "tsqr_method", "cholqr2")
    x = _matrix(31, 5, 9, np.float64)
    X, jX = _both(jax_app, torch_app, x, (5, 9))
    chol = spy_calls(tlinalg, "cholesky")
    assert not torch_app._use_cholqr(X) and not jax_app._use_cholqr(jX)
    got = getattr(torch_app, entry)(X)
    ref = getattr(jax_app, entry)(jX)
    assert not chol
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):
        _same_grid(a, b)
    if entry == "indirect_tsr":
        assert rel_err(np.abs(got[0].get()), np.abs(ref[0].get())) <= 1e-10
    elif entry == "direct_tsqr":
        assert rel_err(got[0].get() @ got[1].get(), x) <= 1e-10
    else:
        assert rel_err(got[1].get(), ref[1].get()) <= 1e-10


def test_auto_route_follows_the_device(jax_app, torch_app, monkeypatch):
    """``auto``: CholeskyQR2 on a cuda backend, Householder on the CPU, as
    the reference on its CPU backend; no part of the rule asks jax."""
    monkeypatch.setattr(jsettings, "tsqr_method", "auto")
    monkeypatch.setattr(tsettings, "tsqr_method", "auto")
    X, jX = _both(jax_app, torch_app, _matrix(1, 50, 4, np.float64), (50, 4))
    assert torch_app.backend.device.type == "cpu"
    assert torch_app._use_cholqr(X) is jax_app._use_cholqr(jX) is False
    monkeypatch.setattr(torch_app.backend, "device", torch.device("cuda:0"))
    assert torch_app._use_cholqr(X) is True
    assert torch_app._use_cholqr() is True
    monkeypatch.setattr(tsettings, "tsqr_method", "householder")
    assert torch_app._use_cholqr(X) is False


@pytest.mark.parametrize("env,want", [({}, "auto"), (
    {"NUMS_TPU_TORCH_TSQR": "householder"}, "householder")])
def test_tsqr_setting_reads_the_environment(env, want):
    probe = ("from nums_tpu_torch.core import settings; "
             "print(settings.tsqr_method)")
    full = {k: v for k, v in os.environ.items()
            if k != "NUMS_TPU_TORCH_TSQR"}
    full.update(env)
    out = subprocess.run([sys.executable, "-c", probe], env=full,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == want, out.stderr


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_direct_tsqr_overwrite_x(jax_app, torch_app, dtype):
    """The streamed CholeskyQR2 writes Q into X's own tensor: X reads as Q
    afterwards, and no second (m, n) tensor is returned."""
    tol = TOL[dtype]
    x = _matrix(41, 3000, 10, dtype, cond=10.0)
    X, jX = _both(jax_app, torch_app, x.copy(), (1000, 10))
    ptr = X.data.data_ptr()
    Q, R = torch_app.direct_tsqr(X, overwrite_x=True)
    jQ, jR = jax_app.direct_tsqr(jX, overwrite_x=True)
    _same_grid(Q, jQ)
    _same_grid(R, jR)
    assert Q.data.data_ptr() == ptr and X.data.data_ptr() == ptr
    assert np.array_equal(X.get(), Q.get())
    _check_qr(Q.get(), R.get(), x, tol)
    assert rel_err(R.get(), jR.get()) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_randomized_svd_entry_point(jax_app, torch_app, dtype):
    """Both packages draw the sketch on threefry counters, so the same seed
    gives the same sketch and the results agree draw for draw: singular
    values, and U and Vᵀ after the sign flip, to 1e-9 in float64 and 2e-4
    in float32 (the sketch itself to the normal's tolerance). Each is also
    held to numpy's SVD on a planted decaying spectrum, to the method's
    accuracy there (1e-6 in float64, 1e-3 in float32); the grids to the
    reference's."""
    tol = {"float64": 1e-6, "float32": 1e-3}[dtype]
    same = {"float64": 1e-9, "float32": 2e-4}[dtype]
    m, n, k = 3000, 40, 6
    x = _matrix(51, m, n, dtype, cond=1e8)
    X, jX = _both(jax_app, torch_app, x, (1000, 20))
    got = torch_app.randomized_svd(X, k, n_oversamples=10, n_iter=2, seed=3)
    again = torch_app.randomized_svd(X, k, n_oversamples=10, n_iter=2, seed=3)
    ref = jax_app.randomized_svd(jX, k, n_oversamples=10, n_iter=2, seed=3)
    for a, b, c in zip(got, ref, again):
        _same_grid(a, b)
        assert np.array_equal(a.get(), c.get()), "not deterministic by seed"
    u64, s64, _ = np.linalg.svd(x.astype(np.float64), full_matrices=False)
    for u, s, _ in ((a.get() for a in got),
                    (np.asarray(a.get()) for a in ref)):
        assert rel_err(s, s64[:k]) <= tol
        u = np.asarray(u, dtype=np.float64)
        assert rel_err(u @ u.T @ x, u64[:, :k] @ u64[:, :k].T @ x) <= tol
    # the same sketch ...
    ell = k + 10
    omega = torch_app.random_state(3).normal(shape=(n, ell), dtype=x.dtype)
    jomega = jax_app.random_state(3).normal(shape=(n, ell), dtype=x.dtype)
    assert rel_err(omega.get(), np.asarray(jomega.get())) <= (
        1e-12 if dtype == "float64" else 2e-6)
    # ... so the same factors, up to the sign of each pair
    gu, gs, gvt = (np.asarray(a.get(), dtype=np.float64) for a in got)
    ru, rs_, rvt = (np.asarray(a.get(), dtype=np.float64) for a in ref)
    assert rel_err(gs, rs_) <= same
    sign = np.sign(np.sum(gvt * rvt, axis=1))
    assert rel_err(gvt * sign[:, None], rvt) <= same
    assert rel_err(gu * sign[None, :], ru) <= same


# ----------------------------------------------------------------------
# eye_k, var, std
# ----------------------------------------------------------------------


@pytest.mark.parametrize("shape,block,k", [((5, 5), (2, 2), 0),
                                           ((4, 7), (4, 3), 2),
                                           ((6, 3), (3, 3), -1),
                                           ((3, 3), (3, 3), 5)])
def test_eye_k(jax_app, torch_app, shape, block, k):
    got = torch_app.eye_k(shape, block, k=k, dtype=np.float32)
    ref = jax_app.eye_k(shape, block, k=k, dtype=np.float32)
    _same_grid(got, ref)
    assert np.array_equal(got.get(), np.eye(*shape, k=k, dtype=np.float32))
    assert np.array_equal(got.get(), ref.get())
    assert torch_app.eye(shape, block).dtype == np.float64


@pytest.mark.parametrize("op", ["var", "std"])
@pytest.mark.parametrize("axis,ddof,keepdims", [
    (None, 0, False), (0, 0, False), (0, 1, True), (1, 1, False),
    ((0, 1), 0, True),
])
def test_var_std(jax_app, torch_app, op, axis, ddof, keepdims):
    x = np.random.RandomState(61).randn(37, 5) * 3 + 1
    for arr in (x, x.astype(np.float32), (x * 10).astype(np.int32)):
        X, jX = _both(jax_app, torch_app, arr, (10, 5))
        got = getattr(torch_app, op)(X, axis=axis, ddof=ddof,
                                     keepdims=keepdims)
        ref = getattr(jax_app, op)(jX, axis=axis, ddof=ddof,
                                   keepdims=keepdims)
        _same_grid(got, ref)
        want = getattr(np, op)(arr.astype(np.float64), axis=axis, ddof=ddof,
                               keepdims=keepdims)
        tol = 1e-5 if arr.dtype == np.float32 else 1e-12
        assert rel_err(got.get(), ref.get()) <= tol
        assert rel_err(got.get(), want) <= tol


def test_var_std_methods_and_dtype(jax_app, torch_app):
    x = np.random.RandomState(62).randn(20, 3).astype(np.float32)
    X, jX = _both(jax_app, torch_app, x, (20, 3))
    for op in ("var", "std"):
        got = getattr(X.T, op)(axis=1, dtype=np.float64)
        ref = getattr(jX.T, op)(axis=1, dtype=np.float64)
        _same_grid(got, ref)
        assert rel_err(got.get(), ref.get()) <= 1e-12
        assert rel_err(got.get(), getattr(np, op)(
            x.astype(np.float64).T, axis=1)) <= 1e-12
