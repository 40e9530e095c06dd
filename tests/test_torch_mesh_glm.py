"""The slice end to end on the port's mesh: X.T @ X and the logistic fit.

The port's mesh runs in the 4 gloo processes of ``mesh_pool`` on (4, 1)
and (2, 2) meshes, on a ragged row count (1003: the last process holds
fewer rows). Each result is held to the port's serial backend and to
nums_tpu's mesh on the 8 virtual CPU devices.

* ``X.T @ X`` of float32 takes the mesh gram route: the gram kernel's
  wrapper once on each process's rows (its plain version on the CPU: the
  kernel launches stay 0) and one all-reduce. Against the serial port
  (the same bf16 rounding) to 1e-5 of max|G|: float32 sums of the same
  products in another order, joined by an all-reduce. Against nums_tpu
  (float32 products on the CPU) to the bf16 class's 2e-3.
* The fused Newton fit (K3's wrapper on each process's rows, staged once,
  one all-reduce of g and H a step) and the eager one through DTensor
  ops: float64 β to 1e-10 of max|β| of the serial port's and of nums_tpu's
  mesh fit (the serial parity tests' tolerance; only the order of the
  sums differs), labels equal; float32 β (the K3 route) to the serial
  port's to 1e-5, as tests/test_torch_glm.py holds float32 fits.
* ``from_reference_params`` of nums_tpu's fitted β on a mesh application:
  parameters replicated, labels equal to the reference's.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, jax_mesh, mesh_app, mesh_pool, rel_err, torch_app,
)

N, D = 1003, 9
BLOCK = (-(-N // 4), D)
FIT = dict(solver="newton", tol=1e-8, max_iter=10)
F32_SUM_REL = 1e-5
F64_REL = 1e-10
CLUSTERS = [(4, 1), (2, 2)]


def _data(dtype, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(N, D).astype(dtype)
    w = 0.5 * rs.randn(D)
    p = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ w)))
    y = (p > rs.rand(N)).astype(dtype)
    return X, y


def _counting(module, name, calls):
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    return fn


def _gram_case(cluster):
    from nums_tpu_torch.core.ops import cuda_gram, summa

    app = mesh_app(cluster)
    X, _ = _data(np.float32)
    bx = app.array(X, block_shape=BLOCK)
    calls = {}
    originals = [(cuda_gram, "gram", _counting(cuda_gram, "gram", calls)),
                 (summa, "gram_all_reduce",
                  _counting(summa, "gram_all_reduce", calls))]
    try:
        G = (bx.T @ bx).get()
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)
    return G, calls, dict(cuda_gram.LAUNCHES)


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_gram_takes_the_mesh_route(mesh_pool, jax_mesh, torch_app, cluster):
    G, calls, launches = mesh_pool.run(_gram_case, cluster)
    assert calls == {"gram": 1, "gram_all_reduce": 1}
    assert set(launches.values()) == {0}
    X, _ = _data(np.float32)
    tbx = torch_app.array(X, block_shape=(N, D))
    assert G.dtype == np.float32
    assert rel_err(G, (tbx.T @ tbx).get()) <= F32_SUM_REL
    rbx = jax_mesh.array(X, block_shape=BLOCK)
    assert rel_err(G, np.asarray((rbx.T @ rbx).get())) <= GRAM_BF16_REL


def _fit_case(cluster, dtype, fuse):
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import cuda_newton
    from nums_tpu_torch.models.glms import LogisticRegression

    app = mesh_app(cluster)
    X, y = _data(dtype)
    bx = app.array(X, block_shape=BLOCK)
    by = app.array(y, block_shape=(BLOCK[0],))
    calls = {}
    originals = [(cuda_newton, name, _counting(cuda_newton, name, calls))
                 for name in ("prepare", "stats")]
    old = settings.glm_fuse
    settings.glm_fuse = fuse
    try:
        model = LogisticRegression(**FIT).fit(bx, by)
        labels = model.predict(bx).get()
    finally:
        settings.glm_fuse = old
        for module, name, fn in originals:
            setattr(module, name, fn)
    beta = np.append(model._beta.get(), model._beta0.get())
    return beta, labels, calls, str(model._beta.raw.placements)


def _serial_fit(app, glms, dtype):
    X, y = _data(dtype)
    bx = app.array(X, block_shape=BLOCK)
    by = app.array(y, block_shape=(BLOCK[0],))
    model = glms.LogisticRegression(**FIT).fit(bx, by)
    return np.append(model._beta.get(), model._beta0.get()), model.predict(
        bx).get()


@pytest.mark.parametrize("fuse", ["1", "0"])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_logistic_fit_float64(mesh_pool, jax_mesh, torch_app, monkeypatch,
                              cluster, fuse):
    from nums_tpu.core import settings as jsettings
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.models import glms as tglms

    beta, labels, calls, placements = mesh_pool.run(
        _fit_case, cluster, np.float64, fuse)
    assert calls == {}  # float64: no kernel route
    assert "Replicate" in placements and "Shard" not in placements
    monkeypatch.setattr(settings, "glm_fuse", fuse)
    monkeypatch.setattr(jsettings, "glm_fuse", fuse)
    serial, serial_labels = _serial_fit(torch_app, tglms, np.float64)
    ref, ref_labels = _serial_fit(jax_mesh, jglms, np.float64)
    assert rel_err(beta, serial) <= F64_REL
    assert rel_err(beta, ref) <= F64_REL
    assert np.array_equal(labels, serial_labels)
    assert np.array_equal(labels, np.asarray(ref_labels))


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_fused_fit_float32_takes_k3_per_process(mesh_pool, torch_app,
                                                cluster):
    from nums_tpu_torch.models import glms as tglms

    beta, labels, calls, _ = mesh_pool.run(_fit_case, cluster, np.float32,
                                           "1")
    # Staged once, the statistics once a step, on each process's rows.
    assert calls == {"prepare": 1, "stats": FIT["max_iter"]}
    serial, serial_labels = _serial_fit(torch_app, tglms, np.float32)
    assert beta.dtype == np.float32
    assert rel_err(beta, serial) <= F32_SUM_REL
    assert np.array_equal(labels, serial_labels)


def _loaded_case(cluster, meta, arrays):
    from nums_tpu_torch.models.glms import GLM

    app = mesh_app(cluster)
    model = GLM.from_reference_params(meta, arrays)
    X, _ = _data(np.float64, seed=5)
    bx = app.array(X, block_shape=BLOCK)
    return (model.predict(bx).get(), model.predict_proba(bx).get(),
            str(model._beta.raw.placements))


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_from_reference_params_on_the_mesh(mesh_pool, jax_mesh, cluster):
    from nums_tpu.models import glms as jglms

    X, y = _data(np.float64, seed=5)
    rbx = jax_mesh.array(X, block_shape=BLOCK)
    rby = jax_mesh.array(y, block_shape=(BLOCK[0],))
    ref = jglms.LogisticRegression(**FIT).fit(rbx, rby)
    meta = {"model": "LogisticRegression", "penalty": "none", "C": 1.0,
            "tol": FIT["tol"], "max_iter": FIT["max_iter"],
            "solver": FIT["solver"], "beta0": float(ref._beta0.get())}
    arrays = {"beta": np.asarray(ref._beta.get())}
    labels, proba, placements = mesh_pool.run(_loaded_case, cluster, meta,
                                              arrays)
    assert "Shard" not in placements  # the parameters are replicated
    assert np.array_equal(labels, np.asarray(ref.predict(rbx).get()))
    assert rel_err(proba, np.asarray(ref.predict_proba(rbx).get())) <= 1e-12
