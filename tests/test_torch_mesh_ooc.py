"""Out of core on the port's mesh: 4 processes, each streaming its rows.

A 37x6 float64 DiskArray in 5-row panels (the last of 2 rows) is written by
nums_tpu in the test process; the port's 4 gloo processes of ``mesh_pool``
open it on a (4, 1) mesh, where each panel splits 2/2/1/0 rows (the last
1/1/0/0), and nums_tpu runs the same ops on its mesh over the 8 virtual
CPU devices (``jax_mesh``) on the same files, as section 6 of the worker of
tests/test_multihost.py does. Tolerances, relative to max|ref|:

* ``gram_ooc``, ``sum``/``min``/``max``/``mean_ooc``, ``tsqr_r_ooc`` (as
  RᵀR) and ``linear_regression_ooc``: 1e-10, float64 sums in another
  order (each rank's rows, then one all-reduce);
* the Newton logistic fit (y a 1-D DiskArray): the same iteration count,
  β within 1e-8 (a solve of the same normal equations); ``predict_ooc``
  labels equal;
* PCA's ``explained_variance_ratio_`` and transform: 1e-8;
* KMeans: the same iterations, centers within 1e-8 of the port's serial
  fit of the same file (float64 sums of float32 rows in another order,
  then float32: the same centers) and within 1e-5 of nums_tpu's, the
  serial parity tests' float32 class (tests/test_torch_cluster.py: the
  reference sums in float32).

Each rank reads only its rows (``PanelRef.load``'s byte count), and the
float32 fit calls K3's wrapper once per pass and panel where the rank has
rows. A world-1 mesh in this process (the chip run's default path) gives
the serial port's results.
"""

import os

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    jax_mesh, mesh_app, mesh_pool, rel_err, torch_app,
)

N, D, PANEL = 37, 6, 5
F64_REL = 1e-10
FIT_REL = 1e-8
F32_SUM_REL = 1e-5
KMEANS_REF_REL = 1e-5
FIT = dict(solver="newton", tol=1e-8, max_iter=10)
# Rows of each rank per pass: panels of 5 split 2/2/1/0, the last (2
# rows) 1/1/0/0.
RANK_ROWS = [15, 15, 7, 0]
PANELS_WITH_ROWS = [8, 8, 7, 0]


def _data(dtype=np.float64, seed=4):
    rs = np.random.RandomState(seed)
    X = rs.randn(N, D)
    w = 0.3 * rs.randn(D)
    y = (1.0 / (1.0 + np.exp(-(X @ w))) > rs.rand(N)).astype(np.float64)
    return X.astype(dtype), y.astype(dtype), w


def _gather(obj):
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _host(da):
    return np.concatenate([da.row_panel(i) for i in range(da.num_row_panels)])


# ---------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------


def _ops_case(xpath):
    from nums_tpu_torch.core.array import diskarray

    app = mesh_app()
    dX = app.open_fs(xpath)
    diskarray.PANEL_BYTES_READ["bytes"] = 0
    out = {"gram": app.gram_ooc(dX).get()}
    out["bytes"] = _gather(diskarray.PANEL_BYTES_READ["bytes"])
    for op in ("sum", "min", "max", "mean"):
        out[op] = getattr(app, f"{op}_ooc")(dX).get()
    out["R"] = app.tsqr_r_ooc(dX).get()
    X, _, w = _data()
    out["theta"] = app.linear_regression_ooc(dX, X @ w).get()
    return out


def _counting(module, name, record):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(out)
        return out

    setattr(module, name, counted)
    return fn


def _fit_case(xpath, ypath, out_dir):
    from nums_tpu_torch.core.ops import cuda_newton
    from nums_tpu_torch.models import fast_glm
    from nums_tpu_torch.models.cluster import KMeans
    from nums_tpu_torch.models.decomposition import PCA
    from nums_tpu_torch.models.glms import LogisticRegression

    app = mesh_app()
    dX, dy = app.open_fs(xpath), app.open_fs(ypath)
    fits, stats = [], []
    saved = [(fast_glm, "newton_fit_ooc",
              _counting(fast_glm, "newton_fit_ooc", fits)),
             (cuda_newton, "stats", _counting(cuda_newton, "stats", stats))]
    try:
        model = LogisticRegression(**FIT).fit(dX, dy)
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)
    out = {"beta": np.append(model._beta.get(), model._beta0.get()),
           "it": fits[0][2], "k3_calls": _gather(len(stats))}
    out["labels"] = _host(model.predict_ooc(
        dX, out=os.path.join(out_dir, "pred")))
    if dX.dtype != np.float64:
        return out
    pca = PCA(n_components=2).fit(dX)
    out["evr"] = np.asarray(pca.explained_variance_ratio_.get())
    out["transform"] = _host(pca.transform(
        dX, out=os.path.join(out_dir, "pcaT")))
    km = KMeans(n_clusters=2, max_iter=5, seed=3).fit(dX)
    out["centers"] = km.cluster_centers_.get()
    out["km_iter"] = km.n_iter_
    out["km_labels"] = _host(km.predict_ooc(
        dX, out=os.path.join(out_dir, "kmL")))
    return out


# ---------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------


@pytest.fixture()
def disk(jax_mesh, tmp_path):
    """X (37x6, 5-row panels) and y (5-row panels) written by nums_tpu."""
    X, y, _ = _data()
    xpath, ypath = str(tmp_path / "X"), str(tmp_path / "y")
    jax_mesh.spill(jax_mesh.array(X, block_shape=(PANEL, D)), xpath)
    jax_mesh.spill(jax_mesh.array(y, block_shape=(PANEL,)), ypath)
    return xpath, ypath


def test_streamed_ops_match_nums_tpu(mesh_pool, jax_mesh, disk):
    xpath, _ = disk
    got = mesh_pool.run(_ops_case, xpath)
    assert got["bytes"] == [r * D * 8 for r in RANK_ROWS]
    dX = jax_mesh.open_fs(xpath)
    X, _, w = _data()
    for op in ("sum", "min", "max", "mean"):
        ref = np.asarray(getattr(jax_mesh, f"{op}_ooc")(dX).get())
        assert rel_err(got[op], ref) <= F64_REL, op
    assert rel_err(got["gram"], np.asarray(jax_mesh.gram_ooc(dX).get())) \
        <= F64_REL
    R = np.asarray(jax_mesh.tsqr_r_ooc(dX).get())
    assert rel_err(got["R"].T @ got["R"], R.T @ R) <= F64_REL
    theta = np.asarray(jax_mesh.linear_regression_ooc(dX, X @ w).get())
    assert rel_err(got["theta"], theta) <= F64_REL
    assert rel_err(got["theta"], w) <= F64_REL


def _reference_fit(monkeypatch, app, glms, fast_glm, xpath, ypath):
    fits = []
    fn = fast_glm.newton_fit_ooc

    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        fits.append(out)
        return out

    monkeypatch.setattr(fast_glm, "newton_fit_ooc", counted)
    model = glms.LogisticRegression(**FIT).fit(app.open_fs(xpath),
                                               app.open_fs(ypath))
    monkeypatch.setattr(fast_glm, "newton_fit_ooc", fn)
    beta = np.append(np.asarray(model._beta.get()),
                     np.asarray(model._beta0.get()))
    return model, beta, int(fits[0][2])


def test_models_match_nums_tpu(mesh_pool, jax_mesh, torch_app, disk,
                               tmp_path, monkeypatch):
    from nums_tpu.models import cluster as jcluster
    from nums_tpu.models import decomposition as jdec
    from nums_tpu.models import fast_glm as jfast
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import cluster as tcluster

    xpath, ypath = disk
    out_dir = tmp_path / "port"
    out_dir.mkdir()
    got = mesh_pool.run(_fit_case, xpath, ypath, str(out_dir))
    model, beta, it = _reference_fit(monkeypatch, jax_mesh, jglms, jfast,
                                     xpath, ypath)
    assert got["it"] == it
    assert rel_err(got["beta"], beta) <= FIT_REL
    assert got["k3_calls"] == [0, 0, 0, 0]  # float64: no kernel route
    dX = jax_mesh.open_fs(xpath)
    labels = model.predict_ooc(dX, out=str(tmp_path / "ref_pred"))
    assert np.array_equal(got["labels"], _host(labels))
    pca = jdec.PCA(n_components=2).fit(dX)
    assert rel_err(got["evr"], np.asarray(
        pca.explained_variance_ratio_.get())) <= FIT_REL
    ref_t = _host(pca.transform(dX, out=str(tmp_path / "ref_pcaT")))
    assert rel_err(got["transform"], ref_t) <= FIT_REL
    km = jcluster.KMeans(n_clusters=2, max_iter=5, seed=3).fit(dX)
    assert got["km_iter"] == km.n_iter_
    assert rel_err(got["centers"], np.asarray(
        km.cluster_centers_.get())) <= KMEANS_REF_REL
    serial = tcluster.KMeans(n_clusters=2, max_iter=5, seed=3).fit(
        torch_app.open_fs(xpath))
    assert rel_err(got["centers"], serial.cluster_centers_.get()) \
        <= FIT_REL
    assert np.array_equal(got["km_labels"], _host(
        km.predict_ooc(dX, out=str(tmp_path / "ref_kmL"))))


def test_float32_fit_calls_k3_per_pass_and_panel(mesh_pool, jax_mesh,
                                                 torch_app, tmp_path):
    from nums_tpu_torch.models import glms as tglms

    X, y, _ = _data(np.float32)
    xpath, ypath = str(tmp_path / "X32"), str(tmp_path / "y32")
    jax_mesh.spill(jax_mesh.array(X, block_shape=(PANEL, D)), xpath)
    jax_mesh.spill(jax_mesh.array(y, block_shape=(PANEL,)), ypath)
    out_dir = tmp_path / "port"
    out_dir.mkdir()
    got = mesh_pool.run(_fit_case, xpath, ypath, str(out_dir))
    assert got["k3_calls"] == [got["it"] * p for p in PANELS_WITH_ROWS]
    serial = tglms.LogisticRegression(**FIT).fit(
        torch_app.open_fs(xpath), torch_app.open_fs(ypath))
    want = np.append(serial._beta.get(), serial._beta0.get())
    assert got["beta"].dtype == np.float32
    assert rel_err(got["beta"], want) <= F32_SUM_REL


def test_world_one_mesh_takes_the_mesh_branch(jax_mesh, torch_app, disk):
    """A mesh of this process alone: ``ooc_put`` returns a DTensor (the
    mesh branch), the folds reduce over nothing, and the results are the
    serial port's."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from nums_tpu_torch.core import application_manager
    from nums_tpu_torch.core.array import application
    from nums_tpu_torch.models.glms import LogisticRegression

    xpath, ypath = disk
    serial_G = torch_app.gram_ooc(torch_app.open_fs(xpath)).get()
    serial = LogisticRegression(**FIT).fit(torch_app.open_fs(xpath),
                                           torch_app.open_fs(ypath))
    puts = []
    put = application.ooc_put

    def spy(backend, panel, **kwargs):
        out = put(backend, panel, **kwargs)
        puts.append(isinstance(out[0], DTensor))
        return out

    app = application_manager.create(device="cpu", backend="mesh")
    try:
        application.ooc_put = spy
        G = app.gram_ooc(app.open_fs(xpath)).get()
        model = LogisticRegression(**FIT).fit(app.open_fs(xpath),
                                              app.open_fs(ypath))
        beta = np.append(model._beta.get(), model._beta0.get())
    finally:
        application.ooc_put = put
        app.backend.shutdown()
        application_manager.set_instance(torch_app)
    assert not dist.is_initialized()
    assert puts and all(puts)
    assert np.array_equal(G, serial_G)
    assert np.array_equal(beta, np.append(serial._beta.get(),
                                          serial._beta0.get()))
