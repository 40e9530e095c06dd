"""nums_tpu_torch's PCA, TruncatedSVD and scalers against nums_tpu's, on the
CPU (after tests/models/test_decomposition.py and
tests/models/test_preprocessing.py): in core through the application's SVD
under both TSQR methods, the randomized solver, out of core on a DiskArray
(three panels, the last ragged), ``save``/``load`` in both directions, and
the state carried across by ``from_reference_params``.

Tolerances, relative to the largest magnitude of the reference's output:
float64 1e-10 in core and out of core (1e-8 for quantities that divide by
the total variance or pass through the host eigendecomposition of a gram),
float32 1e-4; the randomized solver against the full one on a planted
decaying spectrum 1e-6; the out-of-core fit on the gram kernel's route
(float32, "default" precision) against a float64 fit ``GRAM_BF16_REL``
on the singular values (and a PCA's explained variances). Grids and dtypes equal the reference's.
"""

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu.core import settings as jsettings
from nums_tpu.models import decomposition as jdec
from nums_tpu.models import preprocessing as jpre
from nums_tpu_torch.core import settings as tsettings
from nums_tpu_torch.core.array.diskarray import DiskArray
from nums_tpu_torch.core.ops import cuda_gram
from nums_tpu_torch.models import decomposition as tdec
from nums_tpu_torch.models import preprocessing as tpre

TOL = {"float64": 1e-10, "float32": 1e-4}
ATTRS = ("components_", "singular_values_", "explained_variance_",
         "explained_variance_ratio_")
MODELS = {"PCA": (tdec.PCA, jdec.PCA),
          "TruncatedSVD": (tdec.TruncatedSVD, jdec.TruncatedSVD)}


def _data(seed, n, d, dtype, decay=0.7):
    """Correlated columns with a decaying spectrum and a mean offset."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d) * (decay ** np.arange(d)) @ rs.randn(d, d) + 2.0
    return x.astype(dtype)


def _both(jax_app, torch_app, x, block_shape):
    return (torch_app.array(x, block_shape=block_shape),
            jax_app.array(x, block_shape=block_shape))


def _same_grid(got, ref):
    assert got.shape == tuple(ref.shape), (got.shape, ref.shape)
    assert got.block_shape == tuple(ref.block_shape), (
        got.block_shape, ref.block_shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)


def _same_model(got, ref, tol):
    assert got.n_components_ == ref.n_components_
    assert got.n_samples_ == ref.n_samples_
    names = ATTRS + (("mean_", "noise_variance_")
                     if isinstance(got, tdec.PCA) else ())
    for name in names:
        a, b = getattr(got, name), getattr(ref, name)
        _same_grid(a, b)
        assert rel_err(a.get(), np.asarray(b.get())) <= tol, name


@pytest.fixture(params=["householder", "cholqr2"])
def method(request, monkeypatch):
    monkeypatch.setattr(jsettings, "tsqr_method", request.param)
    monkeypatch.setattr(tsettings, "tsqr_method", request.param)
    return request.param


# ----------------------------------------------------------------------
# In core
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("k", [3, None])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_matches_nums_tpu(jax_app, torch_app, method, name, k, dtype):
    tol = TOL[dtype] * (100 if dtype == "float64" else 10)
    tcls, jcls = MODELS[name]
    x = _data(1, 503, 8, dtype)
    X, jX = _both(jax_app, torch_app, x, (200, 8))
    got, ref = tcls(n_components=k).fit(X), jcls(n_components=k).fit(jX)
    _same_model(got, ref, tol)
    T, jT = got.transform(X), ref.transform(jX)
    _same_grid(T, jT)
    assert rel_err(T.get(), jT.get()) <= tol
    back, jback = got.inverse_transform(T), ref.inverse_transform(jT)
    _same_grid(back, jback)
    assert rel_err(back.get(), jback.get()) <= tol
    if k is None:
        assert rel_err(back.get(), x) <= tol
    # numpy's own SVD as the oracle of the leading attributes.
    xc = x.astype(np.float64)
    if name == "PCA":
        xc = xc - xc.mean(axis=0)
        s64 = np.linalg.svd(xc, compute_uv=False)
        kk = got.n_components_
        assert rel_err(got.explained_variance_.get(),
                       s64[:kk] ** 2 / (x.shape[0] - 1)) <= tol
    else:
        s64 = np.linalg.svd(xc, compute_uv=False)
    assert rel_err(got.singular_values_.get(),
                   s64[:got.n_components_]) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,kw", [("PCA", {}), ("PCA", {"whiten": True}),
                                     ("TruncatedSVD", {})])
def test_fit_transform_reuses_the_fit_svd(jax_app, torch_app, spy_calls,
                                          name, kw, dtype):
    """``fit_transform`` is u[:, :k]·s[:k] of the fit's own SVD: the
    application's ``svd`` runs once, and the result equals ``transform``."""
    tol = TOL[dtype] * 100
    tcls, jcls = MODELS[name]
    x = _data(2, 300, 6, dtype)
    X, jX = _both(jax_app, torch_app, x, (100, 6))
    svds = spy_calls(torch_app, "svd")
    model = tcls(n_components=2, **kw)
    Z = model.fit_transform(X)
    assert len(svds) == 1
    jmodel = jcls(n_components=2, **kw)
    jZ = jmodel.fit_transform(jX)
    _same_grid(Z, jZ)
    assert rel_err(Z.get(), jZ.get()) <= tol
    assert rel_err(Z.get(), model.transform(X).get()) <= tol
    assert len(svds) == 1
    if kw.get("whiten"):
        assert rel_err(Z.get().std(axis=0, ddof=1), np.ones(2)) <= tol
        back = model.inverse_transform(Z)
        jback = jmodel.inverse_transform(jZ)
        assert rel_err(back.get(), jback.get()) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_randomized_solver(jax_app, torch_app, spy_calls, name, dtype):
    """``svd_solver="randomized"``: the application's ``randomized_svd``
    runs (the sketch from this package's generator, not the reference's
    bits), and on a decaying spectrum it agrees with the full solver and
    with the reference's randomized fit to the sketch's accuracy."""
    tol = 1e-6 if dtype == "float64" else 1e-3
    tcls, jcls = MODELS[name]
    x = _data(3, 2000, 30, dtype, decay=0.5)
    X, jX = _both(jax_app, torch_app, x, (500, 30))
    calls = spy_calls(torch_app, "randomized_svd")
    got = tcls(n_components=4, svd_solver="randomized", seed=5).fit(X)
    assert len(calls) == 1
    full = tcls(n_components=4).fit(X)
    ref = jcls(n_components=4, svd_solver="randomized", seed=5).fit(jX)
    for name_ in ATTRS:
        a = getattr(got, name_)
        _same_grid(a, getattr(ref, name_))
        assert rel_err(a.get(), getattr(full, name_).get()) <= tol, name_
        assert rel_err(a.get(), getattr(ref, name_).get()) <= tol, name_
    # k == min(shape): the randomized solver falls back to the full SVD.
    tcls(n_components=30, svd_solver="randomized").fit(X)
    assert len(calls) == 1


def test_flip_convention():
    """Each left-singular column's entry of largest magnitude is positive,
    vt's rows flip with it, and an all-zero column keeps its sign."""
    u = torch.tensor([[0.1, -0.2, 0.0], [-0.9, 0.1, 0.0]], dtype=torch.float64)
    vt = torch.arange(9, dtype=torch.float64).reshape(3, 3) + 1
    ju, jvt = jdec._flip_kernel()(u.numpy(), vt.numpy())
    before = (u * torch.tensor([1.0, 2.0, 3.0])) @ vt
    tdec._flip(u, vt)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    assert np.array_equal(vt.numpy(), np.asarray(jvt))
    assert u[1, 0] > 0 and u[0, 1] > 0
    assert torch.equal((u * torch.tensor([1.0, 2.0, 3.0])) @ vt, before)


def test_unfitted_and_bad_arguments(torch_app):
    with pytest.raises(AssertionError, match="fit must be called"):
        tdec.PCA().transform(np.zeros((3, 2)))
    with pytest.raises(AssertionError, match="fit before save"):
        tdec.TruncatedSVD().save("nowhere")
    with pytest.raises(AssertionError):
        tdec.PCA(svd_solver="arpack")
    with pytest.raises(AssertionError):
        tdec.PCA(n_components=5).fit(np.zeros((10, 3)))


# ----------------------------------------------------------------------
# Out of core
# ----------------------------------------------------------------------


def _spill_both(jax_app, torch_app, tmp_path, x, rows):
    block = (rows, x.shape[1])
    tdx = torch_app.spill(torch_app.array(x, block_shape=block),
                          str(tmp_path / "t_X"))
    jdx = jax_app.spill(jax_app.array(x, block_shape=block),
                        str(tmp_path / "j_X"))
    return tdx, jdx


def _rows(disk):
    return np.concatenate([p for _, p in disk.iter_row_panels()])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,kw", [("PCA", {}), ("PCA", {"whiten": True}),
                                     ("TruncatedSVD", {})])
def test_ooc_fit_and_transform(jax_app, torch_app, tmp_path, monkeypatch,
                               name, kw, dtype):
    """Three panels, the last ragged (40 + 40 + 23 rows); plain ops in both
    packages ("highest": the gram kernels' gates follow the precision)."""
    monkeypatch.setattr(tsettings, "matmul_precision", "highest")
    monkeypatch.setattr(jsettings, "matmul_precision", "highest")
    tol = 1e-8 if dtype == "float64" else 1e-3
    tcls, jcls = MODELS[name]
    x = _data(4, 103, 6, dtype)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, x, 40)
    assert dX.num_row_panels == 3
    got = tcls(n_components=3, **kw).fit(dX)
    ref = jcls(n_components=3, **kw).fit(jdX)
    _same_model(got, ref, tol)
    out = got.transform(dX, out=str(tmp_path / "t_out"))
    jout = ref.transform(jdX, out=str(tmp_path / "j_out"))
    assert isinstance(out, DiskArray)
    assert out.shape == jout.shape == (103, 3) and out.dtype == jout.dtype
    assert out.grid.block_shape == jout.grid.block_shape == (40, 3)
    assert rel_err(_rows(out), _rows(jout)) <= tol
    X = torch_app.array(x, block_shape=(40, 6))
    assert rel_err(_rows(out), got.transform(X).get()) <= tol
    # The in-core fit is the accurate route; the gram route agrees with
    # it up to the components' signs (the two conventions differ).
    core = tcls(n_components=3, **kw).fit(X)
    assert rel_err(got.explained_variance_.get(),
                   core.explained_variance_.get()) <= tol
    assert rel_err(np.abs(got.components_.get()),
                   np.abs(core.components_.get())) <= tol * 100


def test_ooc_fit_transform_default_path(jax_app, torch_app, tmp_path):
    """``fit_transform`` on a DiskArray is the fit and one more streamed
    pass, written beside the input (whitening folded into the stream)."""
    x = _data(5, 90, 5, np.float64)
    dX, jdX = _spill_both(jax_app, torch_app, tmp_path, x, 30)
    model = tdec.PCA(n_components=2, whiten=True)
    out = model.fit_transform(dX)
    jout = jdec.PCA(n_components=2, whiten=True).fit_transform(jdX)
    assert out.path == dX.path + ".transformed"
    assert rel_err(_rows(out), _rows(jout)) <= 1e-8
    assert rel_err(_rows(out).std(axis=0, ddof=1), np.ones(2)) <= 1e-8


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ooc_moments_take_the_gram_kernel(jax_app, torch_app, tmp_path,
                                          spy_calls, name):
    """float32 at the "default" precision: each panel's gram goes through
    the gram kernel's wrapper once (its plain version on a CPU tensor),
    the transform through none; the variances stay in the bf16-MAC class
    of a float64 fit."""
    assert tsettings.matmul_precision == "default"
    tcls, _ = MODELS[name]
    x = _data(6, 103, 6, np.float32)
    dX, _ = _spill_both(jax_app, torch_app, tmp_path, x, 40)
    grams = spy_calls(cuda_gram, "gram")
    got = tcls(n_components=3).fit(dX)
    assert [tuple(a[0].shape) for a in grams] == [(40, 6), (40, 6), (23, 6)]
    assert all(a[0].dtype == torch.float32 and len(a) == 1 for a in grams)
    got.transform(dX, out=str(tmp_path / "out"))
    assert len(grams) == 3
    ref = tcls(n_components=3).fit(
        torch_app.array(x.astype(np.float64), block_shape=(103, 6)))
    assert rel_err(got.singular_values_.get(),
                   ref.singular_values_.get()) <= GRAM_BF16_REL
    if name == "PCA":
        # TruncatedSVD's s²/n − (μᵀv)² cancels on data with a mean offset,
        # which multiplies the gram's rounding: not held here.
        assert rel_err(got.explained_variance_.get(),
                       ref.explained_variance_.get()) <= GRAM_BF16_REL


# ----------------------------------------------------------------------
# State carried across
# ----------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["nums_tpu", "nums_tpu_torch"])
@pytest.mark.parametrize("name,kw", [("PCA", {"whiten": True}),
                                     ("PCA", {"svd_solver": "randomized",
                                              "n_oversamples": 4,
                                              "power_iters": 3, "seed": 9}),
                                     ("TruncatedSVD", {})])
def test_save_load_both_ways(jax_app, torch_app, tmp_path, name, kw, writer):
    """A model saved by either package loads in the other and transforms
    alike; the files are nums_tpu's ``model.json`` and ``arrays.npz``."""
    tcls, jcls = MODELS[name]
    x = _data(7, 200, 7, np.float64)
    X, jX = _both(jax_app, torch_app, x, (100, 7))
    path = str(tmp_path / "model")
    if writer == "nums_tpu":
        src = jcls(n_components=3, **kw).fit(jX)
        src.save(path)
        back = tcls.load(path)
        other = jcls.load(path)
        want = src.transform(jX).get()
    else:
        src = tcls(n_components=3, **kw).fit(X)
        src.save(path)
        back = jcls.load(path)
        other = tcls.load(path)
        want = src.transform(X).get()
    for m in (back, other):
        arg = X if isinstance(m, tdec._BaseSVDModel) else jX
        assert type(m).__name__ == name
        assert rel_err(m.transform(arg).get(), want) <= 1e-12
        assert m.n_components_ == 3 and m.n_samples_ == 200
        for key in ("svd_solver", "n_oversamples", "power_iters", "seed"):
            assert getattr(m, key) == getattr(src, key)
        for attr in ATTRS:
            assert np.array_equal(np.asarray(getattr(m, attr).get()),
                                  np.asarray(getattr(src, attr).get()))
        if name == "PCA":
            assert m.whiten == src.whiten
            assert float(m.noise_variance_.get()) == float(
                np.asarray(src.noise_variance_.get()))
    # The other class refuses the file (a PCA's ``whiten`` is no argument
    # of TruncatedSVD, as in the reference).
    with pytest.raises((AssertionError, TypeError)):
        MODELS["TruncatedSVD" if name == "PCA" else "PCA"][0].load(path)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_from_reference_params(jax_app, torch_app, name):
    """The reference's fitted state as numpy arrays, without a file."""
    tcls, jcls = MODELS[name]
    x = _data(8, 150, 5, np.float32)
    X, jX = _both(jax_app, torch_app, x, (150, 5))
    ref = jcls(n_components=2).fit(jX)
    meta = {"model": name, "n_components": ref.n_components_,
            "svd_solver": ref.svd_solver,
            "n_oversamples": ref.n_oversamples,
            "power_iters": ref.power_iters, "seed": ref.seed,
            "n_samples": ref.n_samples_}
    arrays = {a[:-1]: np.asarray(getattr(ref, a).get()) for a in ATTRS}
    if name == "PCA":
        meta["whiten"] = ref.whiten
        arrays["mean"] = np.asarray(ref.mean_.get())
        arrays["noise_variance"] = np.asarray(ref.noise_variance_.get())
    got = tcls.from_reference_params(meta, arrays)
    assert got.components_.dtype == np.float32
    assert rel_err(got.transform(X).get(), ref.transform(jX).get()) <= 1e-5
    assert rel_err(got.inverse_transform(got.transform(X)).get(),
                   ref.inverse_transform(ref.transform(jX)).get()) <= 1e-5


# ----------------------------------------------------------------------
# Scalers
# ----------------------------------------------------------------------


def _scaler_data(dtype):
    x = _data(9, 61, 5, np.float64)
    # A constant column scales by 1. In float32 the constant is 0: the
    # reference's float32 mean of 61 fours is one ulp off 4, which leaves
    # it a standard deviation of 2.4e-7 where the exact one is 0.
    x[:, 3] = 4.0 if np.dtype(dtype) == np.float64 else 0.0
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kw", [{}, {"with_mean": False},
                                {"with_std": False}])
def test_standard_scaler(jax_app, torch_app, kw, dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    x = _scaler_data(dtype)
    X, jX = _both(jax_app, torch_app, x, (25, 5))
    got, ref = tpre.StandardScaler(**kw).fit(X), jpre.StandardScaler(**kw).fit(jX)
    _same_grid(got.mean_, ref.mean_)
    assert rel_err(got.mean_.get(), ref.mean_.get()) <= tol
    if kw.get("with_std", True):
        _same_grid(got.scale_, ref.scale_)
        assert rel_err(got.scale_.get(), ref.scale_.get()) <= tol
        assert got.scale_.get()[3] == 1.0
    else:
        assert got.scale_ is None and ref.scale_ is None
    Z, jZ = got.transform(X), ref.transform(jX)
    _same_grid(Z, jZ)
    assert rel_err(Z.get(), jZ.get()) <= tol * 10
    F = tpre.StandardScaler(**kw).fit_transform(X)
    assert np.array_equal(F.get(), Z.get())
    back = got.inverse_transform(Z)
    _same_grid(back, ref.inverse_transform(jZ))
    assert rel_err(back.get(), x) <= tol * 10
    if not kw:
        z = Z.get().astype(np.float64)
        assert np.max(np.abs(z.mean(axis=0))) <= tol * 100
        assert rel_err(np.delete(z.std(axis=0), 3), np.ones(4)) <= tol * 100


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("feature_range", [(0.0, 1.0), (-2.0, 3.0)])
def test_minmax_scaler(jax_app, torch_app, feature_range, dtype):
    tol = 1e-12 if dtype == "float64" else 1e-5
    x = _scaler_data(dtype)
    X, jX = _both(jax_app, torch_app, x, (25, 5))
    got = tpre.MinMaxScaler(feature_range).fit(X)
    ref = jpre.MinMaxScaler(feature_range).fit(jX)
    for name in ("data_min_", "data_max_", "scale_", "min_"):
        _same_grid(getattr(got, name), getattr(ref, name))
        assert rel_err(getattr(got, name).get(),
                       getattr(ref, name).get()) <= tol, name
    Z, jZ = got.transform(X), ref.transform(jX)
    _same_grid(Z, jZ)
    assert rel_err(Z.get(), jZ.get()) <= tol * 10
    z = np.delete(Z.get(), 3, axis=1)
    assert abs(z.min() - feature_range[0]) <= tol * 10
    assert abs(z.max() - feature_range[1]) <= tol * 10
    assert rel_err(got.inverse_transform(Z).get(), x) <= tol * 10
    assert np.array_equal(
        tpre.MinMaxScaler(feature_range).fit_transform(X).get(), Z.get())
    with pytest.raises(AssertionError):
        tpre.MinMaxScaler((1.0, 1.0))


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_normalize(jax_app, torch_app, norm, axis):
    x = _scaler_data(np.float64)
    x[7] = 0.0  # a zero row stays zero
    X, jX = _both(jax_app, torch_app, x, (25, 5))
    got, ref = tpre.normalize(X, norm, axis), jpre.normalize(jX, norm, axis)
    _same_grid(got, ref)
    assert rel_err(got.get(), ref.get()) <= 1e-12
    order = {"l1": 1, "l2": 2, "max": np.inf}[norm]
    norms = np.linalg.norm(got.get(), ord=order, axis=axis)
    if axis == 1:
        assert not got.get()[7].any()
        norms = np.delete(norms, 7)
    assert rel_err(norms, np.ones_like(norms)) <= 1e-12
    with pytest.raises(AssertionError):
        tpre.normalize(X, "l3")


def test_scalers_from_reference_params(jax_app, torch_app):
    """A scaler fitted by the reference, carried across as numpy arrays,
    transforms alike; a scaler that was not fitted refuses to."""
    x = _scaler_data(np.float64)
    X, jX = _both(jax_app, torch_app, x, (25, 5))
    ref = jpre.StandardScaler(with_mean=False).fit(jX)
    got = tpre.StandardScaler.from_reference_params(
        {"with_mean": ref.with_mean, "with_std": ref.with_std},
        {"mean_": np.asarray(ref.mean_.get()),
         "scale_": np.asarray(ref.scale_.get())})
    assert got.with_mean is False and got.with_std is True
    assert rel_err(got.transform(X).get(), ref.transform(jX).get()) <= 1e-12
    ref = jpre.MinMaxScaler((-1.0, 1.0)).fit(jX)
    got = tpre.MinMaxScaler.from_reference_params(
        {"feature_range": list(ref.feature_range)},
        {n: np.asarray(getattr(ref, n).get())
         for n in ("data_min_", "data_max_", "scale_", "min_")})
    assert got.feature_range == (-1.0, 1.0)
    assert rel_err(got.transform(X).get(), ref.transform(jX).get()) <= 1e-12
    assert rel_err(got.inverse_transform(got.transform(X)).get(), x) <= 1e-12
    with pytest.raises(AssertionError, match="fit must be called"):
        tpre.StandardScaler().transform(X)
    with pytest.raises(AssertionError, match="fit must be called"):
        tpre.MinMaxScaler().inverse_transform(X)
