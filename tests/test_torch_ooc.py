"""nums_tpu_torch's out-of-core path against nums_tpu's, on the CPU:
DiskArray, the streamed ops of the application, the streaming steps,
``newton_fit_ooc`` and the GLMs' out-of-core fits and ``predict_ooc``
(after tests/core/array/test_diskarray.py).

Tolerances, relative to the largest magnitude of the reference's output:
* float64 (the kernels take fp32 only, so every step runs plain ops):
  ``gram``/``sum``/``min``/``max``/``mean``/``linear_regression`` ``_ooc``
  and the streaming steps within 1e-12 (the same sums in another order);
  integer reductions exact; ``tsqr_r_ooc``'s RᵀR against XᵀX and |R|
  against the reference's within 1e-10 (Householder R is unique up to the
  sign of each row); ``newton_fit_ooc`` within 1e-8 with the same
  iteration count; the out-of-core fit against the port's in-core fit
  within 1e-5 (the reference's own tolerance); Lasso and ElasticNet by
  ADMM within 1e-6 and the same zeros; ``predict_ooc`` files byte-equal.
* fp32 with the kernel gates on (their plain versions here), against
  nums_tpu's Pallas kernels in interpret mode: ``gram_ooc`` within
  ``GRAM_BF16_REL``; ``newton_fit_ooc`` within 1e-2 of max|β| (eta uses
  bf16(β), which pins β to about one bf16 ulp, 3.9e-3). Spies show the
  kernel wrappers called once per panel (and per iteration).
"""

import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, STATS_BF16_REL, jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.array import application as tapplication
from nums_tpu_torch.core.array.diskarray import DiskArray
from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
from nums_tpu_torch.core.ops import linalg as tlinalg
from nums_tpu_torch.core.ops import streaming as tstreaming
from nums_tpu_torch.models import fast_glm as tfast
from nums_tpu_torch.models import glms as tglms

F64_REL = 1e-12


def _spill_both(jax_app, torch_app, tmp_path, x, block_shape, name):
    """The same array spilled by each package: (port's, reference's)."""
    tdx = torch_app.spill(torch_app.array(x, block_shape=block_shape),
                          str(tmp_path / f"t_{name}"))
    jdx = jax_app.spill(jax_app.array(x, block_shape=block_shape),
                        str(tmp_path / f"j_{name}"))
    return tdx, jdx


@pytest.fixture
def disk_xy(jax_app, torch_app, tmp_path):
    """103 x 6 float64 over 25-row blocks (a ragged last panel), and a
    linear target; spilled by both packages."""
    rs = np.random.RandomState(0)
    n, d = 103, 6
    x = rs.randn(n, d)
    y = x @ np.linspace(-1, 1, d) + 0.1 * rs.randn(n)
    tdx, jdx = _spill_both(jax_app, torch_app, tmp_path, x, (25, d), "X")
    tdy, jdy = _spill_both(jax_app, torch_app, tmp_path, y, (25,), "y")
    return x, y, tdx, jdx, tdy, jdy


def test_spill_open_and_panels(torch_app, disk_xy):
    x, _, dX, jdX, _, _ = disk_xy
    assert isinstance(dX, DiskArray)
    assert dX.shape == x.shape and dX.ndim == 2 and dX.dtype == x.dtype
    assert dX.num_row_panels == 5 and dX.nbytes == x.nbytes
    assert np.array_equal(dX.to_block_array().get(), x)
    assert dX.to_block_array(block_shape=(50, 6)).block_shape == (50, 6)
    for prefetch in (False, True):
        got = list(dX.iter_row_panels(prefetch=prefetch))
        ref = list(jdX.iter_row_panels(prefetch=prefetch))
        assert [s for s, _ in got] == [s for s, _ in ref] == [
            0, 25, 50, 75, 100]
        for (_, a), (_, b) in zip(got, ref):
            assert np.array_equal(a, b)
        assert np.array_equal(np.concatenate([p for _, p in got]), x)
    back = torch_app.open_fs(dX.path)
    assert back.shape == dX.shape and "panels=5" in repr(back)
    assert np.array_equal(back.row_panel(4), x[100:])
    assert np.array_equal(back._mmap_block("block_1_0.npy"), x[25:50])


def test_diskarray_reads_fail_over_to_replicas(torch_app, tmp_path):
    """Panel reads share read_fs's resilience: a lost primary block fails
    over to its replica, and verify=True routes around a silent
    corruption."""
    rs = np.random.RandomState(10)
    x = rs.randn(60, 4)
    dX = torch_app.spill(torch_app.array(x, block_shape=(20, 4)),
                         str(tmp_path / "rep"), replicas=2)
    os.remove(os.path.join(dX.path, "block_1_0.npy"))
    assert np.array_equal(np.concatenate(
        [p for _, p in dX.iter_row_panels()]), x)
    assert np.array_equal(dX._mmap_block("block_1_0.npy"), x[20:40])
    np.save(os.path.join(dX.path, "block_0_0.npy"), rs.randn(20, 4))
    dv = torch_app.open_fs(str(tmp_path / "rep"), verify=True)
    assert np.array_equal(np.concatenate(
        [p for _, p in dv.iter_row_panels()]), x)


@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
def test_from_panels_reads_in_both(jax_app, torch_app, tmp_path, writer):
    from nums_tpu.core.array.diskarray import DiskArray as JDiskArray

    x = np.random.RandomState(4).randn(53, 3)
    p = str(tmp_path / "fp")

    def panels():
        yield x[:20]
        yield x[20:40]
        yield x[40:]

    if writer == "nums_tpu":
        JDiskArray.from_panels(p, jax_app.fs, panels(), x.shape, x.dtype, 10)
    else:
        # An earlier version at the path is replaced.
        DiskArray.from_panels(p, torch_app.fs, [x[:10] * 0], (10, 3),
                              x.dtype, 10)
        DiskArray.from_panels(p, torch_app.fs, panels(), x.shape, x.dtype,
                              10)
    for da in (DiskArray(p, torch_app.fs), JDiskArray(p, jax_app.fs)):
        assert da.num_row_panels == 6 and da.grid.block_shape == (10, 3)
        assert np.array_equal(
            np.concatenate([q for _, q in da.iter_row_panels()]), x)
    assert sorted(os.listdir(tmp_path)) == ["fp"]
    with pytest.raises(AssertionError, match="block_rows"):
        DiskArray.from_panels(str(tmp_path / "bad"), torch_app.fs,
                              [x[:15], x[15:]], x.shape, x.dtype, 10)


@pytest.mark.parametrize("op", ["gram", "sum", "min", "max", "mean"])
def test_reductions_ooc_match_nums_tpu(jax_app, torch_app, disk_xy, op):
    x, _, dX, jdX, _, _ = disk_xy
    got = getattr(torch_app, f"{op}_ooc")(dX).get()
    ref = np.asarray(getattr(jax_app, f"{op}_ooc")(jdX).get())
    oracle = x.T @ x if op == "gram" else getattr(x, op)(axis=0)
    assert rel_err(got, ref) <= F64_REL
    assert rel_err(got, oracle) <= F64_REL


@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("shape,block", [((13,), (5,)), ((13, 2), (5, 2))])
def test_integer_reductions_ooc_with_ragged_panels(
        jax_app, torch_app, tmp_path, op, shape, block):
    """Integer columns in ragged panels: the identities are the dtype's
    bounds (±inf would cast to INT_MIN, which absorbs min)."""
    vals = np.array([5, 9, 3, 7, 11, 2, 8, 6, 4, 10, 12, 1, 13] * 2,
                    dtype=np.int32)[:int(np.prod(shape))].reshape(shape)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, vals, block, op)
    got = np.asarray(getattr(torch_app, f"{op}_ooc")(dX).get())
    ref = np.asarray(getattr(jax_app, f"{op}_ooc")(jdX).get())
    assert np.array_equal(got, ref)
    assert np.array_equal(got, getattr(vals, op)(axis=0))


def test_tsqr_r_ooc(jax_app, torch_app, disk_xy):
    x, _, dX, jdX, _, _ = disk_xy
    R = torch_app.tsqr_r_ooc(dX).get()
    ref = np.asarray(jax_app.tsqr_r_ooc(jdX).get())
    assert np.array_equal(R, np.triu(R))
    assert rel_err(R.T @ R, x.T @ x) <= 1e-10
    assert rel_err(np.abs(R), np.abs(ref)) <= 1e-10


@pytest.mark.parametrize("m,chunk", [(103, 16), (1000, 64), (40, 8192)])
def test_tsqr_r_tree(m, chunk):
    """The batched panel-QR tree, its levels included, against nums_tpu's
    ``linalg.tsqr_r``, and ``choose_chunk`` against the reference's."""
    from nums_tpu.core.ops import linalg as jlinalg

    x = np.random.RandomState(m).randn(m, 6)
    R = tlinalg.tsqr_r(chunk)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlinalg.tsqr_r(chunk)(x))
    assert rel_err(R.T @ R, x.T @ x) <= 1e-10
    assert rel_err(np.abs(R), np.abs(ref)) <= 1e-10
    assert tlinalg.choose_chunk(m, 6) == jlinalg.choose_chunk(m, 6)
    assert tlinalg.choose_chunk(0, 6) == jlinalg.choose_chunk(0, 6)


@pytest.mark.parametrize("y_kind", ["host", "disk", "blockarray"])
@pytest.mark.parametrize("lamb", [0.0, 5.0])
def test_linear_regression_ooc(jax_app, torch_app, disk_xy, y_kind, lamb):
    x, y, dX, jdX, dy, jdy = disk_xy
    ty, jy = {"host": (y, y), "disk": (dy, jdy),
              "blockarray": (torch_app.array(y, block_shape=(25,)),
                             jax_app.array(y, block_shape=(25,)))}[y_kind]
    got = torch_app.linear_regression_ooc(dX, ty, lamb=lamb).get()
    ref = np.asarray(jax_app.linear_regression_ooc(jdX, jy, lamb=lamb).get())
    want = np.linalg.solve(x.T @ x + lamb * np.eye(6), x.T @ y)
    assert rel_err(got, ref) <= F64_REL
    assert rel_err(got, want) <= 1e-10


@pytest.mark.parametrize("extra", [3, -1])
def test_linear_regression_ooc_rejects_mismatched_y(jax_app, torch_app,
                                                    disk_xy, extra):
    _, y, dX, jdX, _, _ = disk_xy
    bad = np.concatenate([y, y[:extra]]) if extra > 0 else y[:extra]
    with pytest.raises(ValueError, match="rows"):
        jax_app.linear_regression_ooc(jdX, bad)
    with pytest.raises(ValueError, match="rows"):
        torch_app.linear_regression_ooc(dX, bad)


def test_ooc_put_augments_on_the_device(torch_app):
    panel = np.arange(12.0).reshape(4, 3)
    p, rows = tapplication.ooc_put(torch_app.backend, panel)
    assert rows == 4 and torch.equal(p, torch.from_numpy(panel))
    pa, rows = tapplication.ooc_put(torch_app.backend, panel,
                                    augment_ones=True)
    assert rows == 4 and pa.shape == (4, 4) and pa.dtype == torch.float64
    assert np.array_equal(pa.numpy(), np.hstack([panel, np.ones((4, 1))]))
    assert pa.device == torch_app.backend.device


# -- streaming steps ----------------------------------------------------


def _glm_panel(kind, rows=40, d=5, nv=None, seed=0):
    rs = np.random.RandomState(seed)
    p = rs.randn(rows, d)
    beta = 0.3 * rs.randn(d + 1)
    eta = np.hstack([p, np.ones((rows, 1))]) @ beta
    y = {"logistic": (rs.rand(rows) < 0.5).astype(float),
         "linear": eta + rs.randn(rows),
         "poisson": rs.poisson(np.exp(eta)).astype(float)}[kind]
    if nv is not None:  # zero-filled pad rows past nv
        p[nv:] = 0.0
        y[nv:] = 0.0
    return p, y, beta


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_glm_stats_forms_agree(kind):
    """The row-masked step (pad rows past nv vanish) and the step on the
    augmented panel give the same (g, H), in float64."""
    nv = 31
    p, y, beta = _glm_panel(kind, nv=nv)
    da = p.shape[1] + 1
    g1, H1 = torch.zeros(da, dtype=torch.float64), torch.zeros(
        da, da, dtype=torch.float64)
    tstreaming.glm_stats_update(kind, g1, H1, _t(p), _t(y), _t(beta), nv)
    pa = np.hstack([p[:nv], np.ones((nv, 1))])
    g2, H2 = torch.zeros_like(g1), torch.zeros_like(H1)
    tstreaming.glm_stats_update_aug(kind, g2, H2, _t(pa), _t(y[:nv]),
                                    _t(beta))
    assert rel_err(g1, g2.numpy()) <= F64_REL
    assert rel_err(H1, H2.numpy()) <= F64_REL


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_glm_stats_steps_match_nums_tpu(kind):
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming as jstreaming

    nv = 33
    p, y, beta = _glm_panel(kind, nv=nv, seed=1)
    da = p.shape[1] + 1
    for name in ("glm_stats_update", "glm_stats_update_aug"):
        if name == "glm_stats_update":
            args, targs = (p, y, beta, np.int32(nv)), (
                _t(p), _t(y), _t(beta), nv)
        else:
            pa = np.hstack([p, np.ones((p.shape[0], 1))])
            args, targs = (pa, y, beta), (_t(pa), _t(y), _t(beta))
        rg, rH = getattr(jstreaming, name)(kind)(
            jnp.zeros(da), jnp.zeros((da, da)), *args)
        g, H = torch.zeros(da, dtype=torch.float64), torch.zeros(
            da, da, dtype=torch.float64)
        getattr(tstreaming, name)(kind, g, H, *targs)
        assert rel_err(g, np.asarray(rg)) <= F64_REL, name
        assert rel_err(H, np.asarray(rH)) <= F64_REL, name


def test_streaming_steps_match_nums_tpu():
    import jax.numpy as jnp

    from nums_tpu.core.ops import streaming as jstreaming

    rs = np.random.RandomState(2)
    p, yp = rs.randn(30, 4), rs.randn(30)
    p[25:], yp[25:] = 0.0, 0.0
    z = np.zeros((4, 4))
    G, s = jstreaming.gram_and_sum_update()(jnp.asarray(z), jnp.zeros(4),
                                            p)
    tG, ts = tstreaming.gram_and_sum_update(_t(z), torch.zeros(
        4, dtype=torch.float64), _t(p))
    assert rel_err(tG, np.asarray(G)) <= F64_REL
    assert rel_err(ts, np.asarray(s)) <= F64_REL
    G, b = jstreaming.normal_eq_update()(jnp.asarray(z), jnp.zeros(4), p,
                                         yp)
    tG, tb = tstreaming.normal_eq_update(_t(z), torch.zeros(
        4, dtype=torch.float64), _t(p), _t(yp))
    assert rel_err(tG, np.asarray(G)) <= F64_REL
    assert rel_err(tb, np.asarray(b)) <= F64_REL
    G, q = jstreaming.normal_eq_aug_update()(
        jnp.zeros((5, 5)), jnp.zeros(5), p, yp, np.int32(25))
    tG, tq = tstreaming.normal_eq_aug_update(
        torch.zeros(5, 5, dtype=torch.float64),
        torch.zeros(5, dtype=torch.float64), _t(p), _t(yp), 25)
    assert rel_err(tG, np.asarray(G)) <= F64_REL
    assert rel_err(tq, np.asarray(q)) <= F64_REL
    for op in ("sum", "min", "max"):
        init = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
        ref = jstreaming.reduce0_update(op)(jnp.full(4, init), p)
        got = tstreaming.reduce0_update(op, torch.full(
            (4,), init, dtype=torch.float64), _t(p))
        assert rel_err(got, np.asarray(ref)) <= F64_REL, op
    with pytest.raises(ValueError):
        tstreaming.reduce0_update("prod", torch.zeros(4), _t(p))
    R = jstreaming.tsqr_r_update(8)(jnp.asarray(z), p)
    tR = tstreaming.tsqr_r_update(8, _t(z), _t(p))
    assert rel_err(tR.abs().numpy(), np.abs(np.asarray(R))) <= 1e-10
    H = p.T @ p + np.eye(4)
    g, beta, lv = rs.randn(4), rs.randn(4), np.full(4, 0.5)
    for penalized in (False, True):
        rb, rg = jstreaming.newton_update(penalized)(beta, g, H, lv)
        tb, tg = tstreaming.newton_update(penalized, _t(beta), _t(g), _t(H),
                                          _t(lv))
        assert rel_err(tb, np.asarray(rb)) <= F64_REL, penalized
        assert float(tg) == pytest.approx(float(rg), rel=F64_REL)


# -- newton_fit_ooc and the GLM fits ------------------------------------


def _glm_disk(jax_app, torch_app, tmp_path, kind, n=300, d=5, block=100,
              dtype=np.float64, seed=7):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(dtype)
    w = np.append(0.5 / np.sqrt(d) * rs.randn(d), 0.2)
    eta = x.astype(np.float64) @ w[:-1] + w[-1]
    y = {"logistic": (rs.rand(n) < 1.0 / (1.0 + np.exp(-eta))),
         "linear": eta + 0.1 * rs.randn(n),
         "poisson": rs.poisson(np.exp(eta))}[kind].astype(dtype)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, x, (block, d),
                          f"{kind}_{np.dtype(dtype).name}")
    return x, y, dX, jdX


@pytest.mark.parametrize("penalized", [False, True])
@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_newton_fit_ooc_matches_nums_tpu(jax_app, torch_app, tmp_path, kind,
                                         penalized):
    from nums_tpu.models import fast_glm as jfast

    _, y, dX, jdX = _glm_disk(jax_app, torch_app, tmp_path, kind)
    lv = np.full(dX.shape[1] + 1, 3.0) if penalized else None
    kw = dict(kind=kind, max_iter=20, penalized=penalized, lambda_vec=lv)
    beta, gmax, it = tfast.newton_fit_ooc(dX, y, 1e-9, **kw)
    rbeta, rgmax, rit = jfast.newton_fit_ooc(jdX, y, 1e-9, **kw)
    assert it == rit and 2 <= it < 20
    assert rel_err(beta, np.asarray(rbeta)) <= 1e-8
    assert float(gmax) <= 1e-9 and float(rgmax) <= 1e-9


# fp32 data in panels of 512 rows: the smallest panel that nums_tpu's
# Pallas kernels stream (at least 4 chunks of 128 rows).
FP32 = dict(n=1536, block=512, dtype=np.float32)


@pytest.fixture
def pallas_route(monkeypatch):
    """nums_tpu with its Pallas gram and Newton kernels forced on
    (interpret mode on the CPU), and jax's compiled traces dropped before
    and after, so no trace of another route is reused."""
    monkeypatch.setenv("NUMS_TPU_PALLAS_GRAM", "1")
    monkeypatch.setenv("NUMS_TPU_PALLAS_NEWTON", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_gram_ooc_kernel_route(jax_app, torch_app, tmp_path, pallas_route,
                               spy_calls):
    from nums_tpu.core.ops import pallas_gram

    assert settings.matmul_precision == "default"
    x, y, dX, jdX = _glm_disk(jax_app, torch_app, tmp_path, "linear",
                              **FP32)
    grams = spy_calls(cuda_gram, "gram")
    pallas = spy_calls(pallas_gram, "gram")
    G = torch_app.gram_ooc(dX).get()
    assert [tuple(a[0].shape) for a in grams] == [(512, 5)] * 3
    assert all(a[0].dtype == torch.float32 and len(a) == 1 for a in grams)
    ref = np.asarray(jax_app.gram_ooc(jdX).get())
    assert pallas, "the reference did not take its Pallas route"
    x64 = x.astype(np.float64)
    assert G.dtype == np.float32
    assert rel_err(G, ref) <= GRAM_BF16_REL
    assert rel_err(G, x64.T @ x64) <= GRAM_BF16_REL
    theta = torch_app.linear_regression_ooc(dX, y).get()
    assert len(grams) == 6
    want = np.linalg.solve(x64.T @ x64, x64.T @ y)
    assert rel_err(theta, want) <= 1e-2


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_newton_fit_ooc_kernel_route(jax_app, torch_app, tmp_path,
                                     pallas_route, spy_calls, kind):
    from nums_tpu.models import fast_glm as jfast

    from nums_tpu.core.ops import pallas_newton

    _, y, dX, jdX = _glm_disk(jax_app, torch_app, tmp_path, kind, **FP32)
    stats = spy_calls(cuda_newton, "stats")
    grams = spy_calls(cuda_gram, "gram")
    pallas = spy_calls(pallas_newton, "stats")
    beta, _, it = tfast.newton_fit_ooc(dX, y, 1e-8, kind=kind, max_iter=4)
    # K3 in its one-shot form on each (rows, d+1) panel, every iteration.
    assert it == 4 and len(stats) == 3 * it and not grams
    assert all(isinstance(a[0], torch.Tensor)
               and not isinstance(a[0], cuda_newton.Staged)
               and tuple(a[0].shape) == (512, 6)
               and a[0].dtype == torch.float32 for a in stats)
    assert beta.dtype == torch.float32
    ref, _, rit = jfast.newton_fit_ooc(jdX, y, 1e-8, kind=kind, max_iter=4)
    assert rit == it and pallas, "the reference took no Pallas route"
    assert rel_err(beta, np.asarray(ref)) <= 1e-2


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_newton_gate_off_takes_the_weighted_gram(
        jax_app, torch_app, tmp_path, monkeypatch, spy_calls, kind):
    """With the Newton gate off (NUMS_TPU_TORCH_NEWTON=0), H of every
    panel rides the gram kernel: K2 with the weight s, K1 for the linear
    kind; g in plain ops. The statistics agree with K3's at the bf16
    class of the reference's Newton kernel."""
    _, y, dX, _ = _glm_disk(jax_app, torch_app, tmp_path, kind, **FP32)
    beta0 = torch.from_numpy(
        0.1 * np.random.RandomState(3).randn(6).astype(np.float32))
    stats = spy_calls(cuda_newton, "stats")
    grams = spy_calls(cuda_gram, "gram")

    def one_pass():
        g, H = torch.zeros(6), torch.zeros(6, 6)
        for start, panel in tapplication.ooc_panels(dX):
            pa, _ = tapplication.ooc_put(torch_app.backend, panel,
                                         augment_ones=True)
            tstreaming.glm_stats_update_aug(kind, g, H, pa,
                                            torch.from_numpy(
                                                y[start:start + 512]), beta0)
        return g, H

    g3, H3 = one_pass()
    assert len(stats) == 3 and not grams
    monkeypatch.setattr(settings, "newton_kernel", "0")
    g2, H2 = one_pass()
    assert len(stats) == 3 and len(grams) == 3
    for args in grams:
        assert tuple(args[0].shape) == (512, 6)
        assert (args[1] is None) == (kind == "linear")
    assert rel_err(g2, g3) <= STATS_BF16_REL
    assert rel_err(H2, H3) <= STATS_BF16_REL


def test_glm_fit_ooc_matches_in_core(torch_app, tmp_path):
    from nums_tpu_torch.core.io.datasets import BimodalGaussian

    x, y = BimodalGaussian.get_dataset(600, 5)
    X = torch_app.array(x, block_shape=(150, 5))
    by = torch_app.array(y, block_shape=(150,))
    dX = torch_app.spill(X, str(tmp_path / "glmX"))
    dy = torch_app.spill(by, str(tmp_path / "glmy"))
    core = tglms.LogisticRegression(solver="newton", tol=1e-9, max_iter=10)
    core.fit(X, by)
    ooc = tglms.LogisticRegression(solver="newton", tol=1e-9, max_iter=10)
    ooc.fit(dX, dy)
    assert np.allclose(ooc.coef_.get(), core.coef_.get(), atol=1e-5)
    assert abs(float(ooc.intercept_.get()) - float(core.intercept_.get())
               ) <= 1e-5
    assert (ooc.predict(X).get() == y).mean() > 0.95
    # l2 linear regression with y on the host.
    w = np.arange(1.0, 6.0)
    yl = x @ w + 2.0
    kw = dict(penalty="l2", C=0.1, solver="newton", max_iter=10, tol=1e-10)
    core = tglms.LinearRegression(**kw).fit(
        X, torch_app.array(yl, block_shape=(150,)))
    ooc = tglms.LinearRegression(**kw).fit(dX, yl)
    assert np.allclose(ooc.coef_.get(), core.coef_.get(), atol=1e-6)
    assert ooc._lambda_vec.shape == (6,)


@pytest.mark.parametrize("cls", ["Lasso", "ElasticNet"])
def test_admm_ooc_matches_nums_tpu(jax_app, torch_app, tmp_path, cls):
    """Lasso and ElasticNet on a DiskArray: one streamed pass for the
    moments, the prox loop on (d+1)² state."""
    from nums_tpu.models import glms as jglms

    rs = np.random.RandomState(13)
    n, d = 600, 8
    theta = np.zeros(d)
    theta[[1, 4, 6]] = [2.0, -1.5, 3.0]
    x = rs.randn(n, d)
    y = x @ theta + 1.0 + 0.01 * rs.randn(n)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, x, (150, d), cls)
    kw = dict(alpha=0.02, tol=1e-7, max_iter=500)
    if cls == "ElasticNet":
        kw["l1_ratio"] = 0.7
    got = getattr(tglms, cls)(**kw).fit(dX, y)
    ref = getattr(jglms, cls)(**kw).fit(jdX, y)
    b = np.append(got.coef_.get(), float(got.intercept_.get()))
    rb = np.append(np.asarray(ref.coef_.get()), float(ref.intercept_.get()))
    assert rel_err(b, rb) <= 1e-6
    assert np.array_equal(b == 0, rb == 0)
    assert set(np.flatnonzero(np.abs(b[:-1]) > 1e-6)) == {1, 4, 6}


@pytest.mark.parametrize("make", [
    lambda g: g.LogisticRegression(solver="irls"),
    lambda g: g.LogisticRegression(solver="lbfgs"),
    lambda g: g.LogisticRegression(penalty="l1", solver="admm"),
    lambda g: g.PoissonRegression(solver="admm"),
    lambda g: g.LinearRegression(solver="gd"),
    lambda g: g.ExponentialRegression(solver="newton"),
], ids=["irls", "lbfgs", "l1-logistic-admm", "poisson-admm", "gd",
        "exponential"])
def test_ooc_fit_raises_as_nums_tpu(jax_app, torch_app, tmp_path, make):
    from nums_tpu.models import glms as jglms

    x = np.random.RandomState(1).randn(40, 3)
    y = (x[:, 0] > 0).astype(float)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, x, (10, 3), "e")
    with pytest.raises(NotImplementedError) as ref:
        make(jglms).fit(jdX, y)
    with pytest.raises(NotImplementedError) as got:
        make(tglms).fit(dX, y)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", ["LinearRegression", "LogisticRegression",
                                  "PoissonRegression"])
def test_predict_ooc_files_equal_nums_tpu(jax_app, torch_app, tmp_path,
                                          name):
    """The same coefficients (a model fitted by nums_tpu, saved and loaded
    by the port) give byte-equal prediction files."""
    from nums_tpu.models import glms as jglms

    kind = {"LinearRegression": "linear", "LogisticRegression": "logistic",
            "PoissonRegression": "poisson"}[name]
    x, y, dX, jdX = _glm_disk(jax_app, torch_app, tmp_path, kind, n=230,
                              block=50)
    ref = getattr(jglms, name)(solver="newton", tol=1e-9, max_iter=10).fit(
        jax_app.array(x, block_shape=(50, 5)),
        jax_app.array(y, block_shape=(50,)))
    ref.save(str(tmp_path / "model"))
    got = tglms.GLM.load(str(tmp_path / "model"))
    tp = got.predict_ooc(dX, out=str(tmp_path / "tpred"))
    jp = ref.predict_ooc(jdX, out=str(tmp_path / "jpred"))
    assert tp.shape == (230,) and tp.num_row_panels == 5
    assert tp.dtype == np.dtype(np.int64 if kind == "logistic"
                                else np.float64)
    files = [sorted(os.listdir(p.path)) for p in (tp, jp)]
    assert files[0] == files[1]
    for f in files[0]:
        with open(os.path.join(tp.path, f), "rb") as a, open(
                os.path.join(jp.path, f), "rb") as b:
            assert a.read() == b.read(), f
    in_core = np.asarray(got.predict(torch_app.array(x)).get())
    assert rel_err(tp.to_block_array().get(), in_core) <= F64_REL
    # The default output path sits beside X.
    assert got.predict_ooc(dX).path == dX.path + ".pred"
