"""The ``core`` table of tests/test_torch_mesh_core*.py: the in-core mesh
path that the reference's mesh runs, each entry an op on arrays made from a
seed with ragged rows, run through the port's mesh (4 gloo processes of
``mesh_pool``, the whole table in ONE call), nums_tpu's mesh (the 8
virtual CPU devices) and the port's serial backend.

Its entries are the faults that the re-anchor probe found on the port's
mesh (each entry's name starts with its id; ROADMAP Queue C), then what
the port refused on a sharded operand and now computes:

* C-M1: ``correlate``/``convolve`` of a sharded vector in the three modes,
  both argument orders, a kernel longer than a shard, a sharded kernel;
* C-M2: ``optimize.minimize`` with a parameter that leaves one process an
  empty shard (5 elements in 2-element blocks);
* C-M3: device index arrays, read and written (X 100×4 in 25-row blocks);
* C-M4: the in-core models that mixed a local tensor with a DTensor
  (KMeans, PCA, GBTClassifier, LogisticRegression by lbfgs and admm,
  Lasso);
* C-M5: quantiles, the scans, ``repeat`` and ``pad`` on rows that are not
  split evenly;
* the reference's ``test_inv_cholesky``, ``test_posdef_solve`` and
  ``test_regressions``' ridge, an inverse that needs a row swap across
  processes, and a ridge fit whose RᵀR is sharded; the CholeskyQR2 routes
  (``svd``, ``direct_tsqr``, ``indirect_tsr``, ``linear_regression``, the
  PCA and the ridge fit on them), which ``auto`` takes on the card;
* ``autodiff.grad`` and ``check_grad`` (tests/core/test_autodiff.py);
* each sampler whose jax algorithm is position-wise, sharded (held to the
  serial draw bit for bit; the reference's mesh is not asked, its draws
  differ from the port's within tests/test_torch_random.py's classes);
* a mask beside a device index array in one key, read and written.

``TOLS[name]`` is (tolerance against the reference's mesh, tolerance
against the serial port), as max|got − ref| / max|ref|; 0 means equal (an
integer, bool or index result is always held equal). The reference's mesh
is within 8.8e-7 of numpy on ``correlate``/``convolve`` (its XLA
convolution), hence 1e-6 there; each model keeps the tolerance of its
serial parity test (tests/test_torch_cluster.py, test_torch_trees.py,
test_torch_decomposition.py, test_torch_glm_families.py); the
factorizations the reference's own (atol 1e-8 at these magnitudes), as
1e-10 of max|ref|.
"""

import numpy as np

from torch_parity import (
    assert_gathers_allowed, jax_mesh_values, mesh_app, run_table,
)


def _rs(seed):
    return np.random.RandomState(seed)


V403 = _rs(20).randn(403)
K5 = _rs(21).randn(5)
K140 = _rs(22).randn(140)
X403 = _rs(23).randn(403, 5)
X13 = _rs(24).randn(13, 9)
N403 = X403.copy()
N403[::37, 1] = np.nan
X100 = _rs(25).randn(100, 4)
IDX = _rs(26).randint(-100, 100, size=37)
IDX_UNIQUE = _rs(27).permutation(100)[:37]
COLS = _rs(28).randint(0, 4, size=37)
MASK100 = X100[:, 0] > 0
KEPT = int(MASK100.sum())
CM_COLS = _rs(29).randint(0, 4, size=KEPT)
KM_X = np.concatenate([_rs(30).randn(130, 3) + c for c in
                       ([6.0, 0, 0], [0, 6.0, 0], [0, 0, 6.0])])
GBT_X = _rs(31).randn(1003, 2)
GBT_Y = (GBT_X[:, 0] + 0.5 * GBT_X[:, 1] > 0).astype(np.float64)
GLM_X = _rs(32).randn(403, 5)
GLM_Y = (GLM_X @ _rs(33).randn(5) + 0.3 * _rs(34).randn(403) > 0).astype(
    np.float64)
LASSO_Y = GLM_X @ np.arange(5.0) + 0.7 + 0.2 * _rs(35).randn(403)


def _spd(seed, n, shift):
    a = _rs(seed).randn(n, n)
    return a.T @ a + shift * np.eye(n)


SPD20 = _spd(3, 20, 20)           # tests/core/array/test_linalg.py:54
SPD12 = _spd(5, 12, 12)           # ... :89 (a @ a.T there; the same law)
B12 = _rs(5).randn(12)
SPD37 = _spd(36, 37, 37)
SWAP16 = np.eye(16)[::-1] * 3.0 + 0.01 * _rs(37).randn(16, 16)
RIDGE_X = _rs(4).randn(500, 6)
RIDGE_Y = RIDGE_X @ _rs(38).randn(6) + 1e-3 * _rs(39).randn(500)
WIDE_X = _rs(40).randn(400, 16)
WIDE_Y = WIDE_X @ _rs(41).randn(16) + 1e-2 * _rs(42).randn(400)


def _a(app, x, bs):
    return app.array(x, block_shape=bs)


def _written(app, x, bs, key, value):
    b = _a(app, x.copy(), bs)
    b[key(app) if callable(key) else key] = value(app) if callable(
        value) else value
    return b


def _minimize(app, nps):
    from_pkg = __import__(nps.__name__.split(".")[0] + ".optimize",
                          fromlist=["minimize"])
    x0 = _a(app, np.zeros(5), (2,))
    res = from_pkg.minimize(lambda x: ((x - 3.0) ** 2).sum(), x0,
                            method="adam", learning_rate=0.1, steps=300,
                            tol=1e-6)
    return res.x, res.fun


def _models(nps):
    return __import__(nps.__name__.split(".")[0] + ".models",
                      fromlist=["cluster", "decomposition", "trees",
                                "glms"])


def _kmeans(app, nps):
    m = _models(nps).cluster.KMeans(3, seed=1).fit(_a(app, KM_X, (50, 3)))
    return m.cluster_centers_, m.inertia_, m.labels_


def _pca(app, nps):
    m = _models(nps).decomposition.PCA(3).fit(_a(app, X403, (50, 5)))
    return m.components_, m.singular_values_, m.transform(
        _a(app, X403, (50, 5)))


def _gbt(app, nps):
    trees = _models(nps).trees
    X = _a(app, GBT_X, (126, 2))
    m = trees.GBTClassifier(n_estimators=4, max_depth=3, n_bins=16).fit(
        X, _a(app, GBT_Y, (126,)))
    return m.predict(X), m.predict_proba(X)


def _glm(app, nps, solver, **kw):
    glms = _models(nps).glms
    X, y = _a(app, GLM_X, (50, 5)), _a(app, GLM_Y, (50,))
    m = glms.LogisticRegression(solver=solver, **kw).fit(X, y)
    return m._beta, m._beta0


def _lasso(app, nps):
    glms = _models(nps).glms
    m = glms.Lasso(alpha=0.05, tol=1e-10, max_iter=400).fit(
        _a(app, GLM_X, (50, 5)), _a(app, LASSO_Y, (50,)))
    return m._beta, m._beta0


def _cholqr(fn):
    """``fn(app, nps)`` with CholeskyQR2 forced in the package of ``nps``
    (the route ``auto`` takes on the card: a gram summed over the mesh)."""
    def run(app, nps):
        settings = __import__(nps.__name__.split(".")[0] + ".core.settings",
                              fromlist=["tsqr_method"])
        old = settings.tsqr_method
        settings.tsqr_method = "cholqr2"
        try:
            return fn(app, nps)
        finally:
            settings.tsqr_method = old

    return run


def _qr_parts(app, nps):
    X = _a(app, X403, (50, 5))
    q, r = app.direct_tsqr(X)
    u, s, vt = app.svd(X)
    # signs of the factors are the routes' own: compare what they define
    # (read to the host after the entry)
    return (nps.abs(r), nps.abs(app.indirect_tsr(X)), s, q @ r,
            (u * s) @ vt)


def _autodiff(nps):
    return __import__(nps.__name__.split(".")[0] + ".autodiff",
                      fromlist=["grad"])


def _grad(app, nps):
    x = _a(app, np.linspace(-1.0, 1.0, 13), (4,))
    return _autodiff(nps).grad(lambda v: (v * v).sum())(x)


def _check_grad(app, nps):
    rs = _rs(2)
    b = _a(app, rs.randn(4), (2,))
    X = _a(app, rs.randn(8, 4), (4, 4))

    def f(v):
        r = X @ v
        return (r * r).sum()

    return float(_autodiff(nps).check_grad(f, (b,), atol=1e-4) < 1e-4)


# Position-wise samplers: name -> the RandomState method's parameters.
SAMPLERS = {
    "exponential": (2.0,), "gumbel": (1.0, 2.0), "laplace": (0.5, 1.5),
    "logistic": (0.0, 1.0), "lognormal": (0.0, 0.5), "pareto": (3.0,),
    "power": (2.0,), "rayleigh": (1.5,), "standard_cauchy": (),
    "triangular": (-1.0, 0.5, 2.0), "wald": (1.0, 2.0), "weibull": (1.5,),
    "geometric": (0.3,), "gamma": (2.0, 1.5), "chisquare": (3.0,),
    "beta": (2.0, 3.0), "f": (3.0, 5.0), "standard_t": (4.0,),
    "vonmises": (0.5, 2.0), "zipf": (2.0,), "logseries": (0.6,),
}


def core_table():
    t, tols, serial_only = [], {}, set()

    def add(name, fn, ref_tol=1e-12, serial_tol=1e-12, reference=True):
        t.append((name, fn))
        tols[name] = (ref_tol, serial_tol)
        if not reference:
            serial_only.add(name)

    # C-M1: correlate/convolve of a sharded vector (403 in 50-blocks:
    # 101/101/101/100 on (4, 1)); a kernel of 5, and one of 140 (longer
    # than a shard) in 40-blocks (itself sharded), both argument orders
    for op in ("correlate", "convolve"):
        for mode in ("valid", "same", "full"):
            for kname, k, kb in (("k5", K5, (5,)), ("k5s", K5, (2,)),
                                 ("k140", K140, (40,))):
                add(f"CM1_{op}_{mode}_{kname}", lambda app, nps, op=op,
                    mode=mode, k=k, kb=kb: getattr(nps, op)(
                        _a(app, V403, (50,)), _a(app, k, kb), mode=mode),
                    ref_tol=1e-6)
                add(f"CM1_{op}_{mode}_{kname}_swapped", lambda app, nps,
                    op=op, mode=mode, k=k, kb=kb: getattr(nps, op)(
                        _a(app, k, kb), _a(app, V403, (50,)), mode=mode),
                    ref_tol=1e-6)
    # C-M2: a parameter of 5 in 2-blocks leaves the last process none
    add("CM2_minimize_empty_shard", _minimize, ref_tol=1e-6)
    # C-M3: device index arrays, read and written
    add("CM3_read_rows", lambda app, nps: _a(app, X100, (25, 4))[
        _a(app, IDX, (10,))])
    add("CM3_read_rows_colon", lambda app, nps: _a(app, X100, (25, 4))[
        _a(app, IDX, (10,)), :])
    add("CM3_read_pairs", lambda app, nps: _a(app, X100, (25, 4))[
        _a(app, IDX, (10,)), _a(app, COLS, (10,))])
    add("CM3_read_rows_int", lambda app, nps: _a(app, X100, (25, 4))[
        _a(app, IDX, (10,)), 2])
    add("CM3_read_wide", lambda app, nps: _a(app, X13, (4, 3))[
        _a(app, np.array([12, 0, 5, 5, -1]), (2,))])
    add("CM3_write_scalar_duplicates", lambda app, nps: _written(
        app, X100, (25, 4), lambda app: _a(app, IDX, (10,)), 7.0))
    add("CM3_write_rows", lambda app, nps: _written(
        app, X100, (25, 4), lambda app: _a(app, IDX_UNIQUE, (10,)),
        lambda app: _a(app, np.arange(37 * 4.0).reshape(37, 4), (10, 4))))
    add("CM3_write_pairs", lambda app, nps: _written(
        app, X100, (25, 4), lambda app: (_a(app, IDX_UNIQUE, (10,)),
                                         _a(app, COLS, (10,))),
        lambda app: _a(app, np.arange(37.0), (10,))))
    add("CM3_write_wide", lambda app, nps: _written(
        app, X13, (4, 3), lambda app: _a(app, np.array([12, 0, 5]), (2,)),
        -1.0))
    # C-M4: the in-core models
    add("CM4_kmeans", _kmeans, 1e-5, 1e-5)
    add("CM4_pca", _pca, 1e-10, 1e-10)
    add("CM4_gbt_classifier", _gbt, 1e-5, 1e-5)
    add("CM4_lbfgs", lambda app, nps: _glm(
        app, nps, "lbfgs", penalty="l2", C=2.0, tol=1e-9, max_iter=200),
        1e-6, 1e-6)
    add("CM4_admm", lambda app, nps: _glm(
        app, nps, "admm", penalty="l1", C=2.0, tol=1e-10, max_iter=400),
        1e-8, 1e-8)
    add("CM4_lasso", _lasso, 1e-8, 1e-8)
    # C-M5: quantiles, scans, repeat and pad on ragged rows
    for name, fn in [
            ("median_none", lambda nps, b: nps.median(b)),
            ("median_rows", lambda nps, b: nps.median(b, axis=0)),
            ("median_cols", lambda nps, b: nps.median(b, axis=1)),
            ("quantile_rows", lambda nps, b: nps.quantile(
                b, [0.1, 0.5, 0.99], axis=0)),
            ("quantile_none", lambda nps, b: nps.quantile(b, 0.3)),
            ("percentile_rows", lambda nps, b: nps.percentile(
                b, [10.0, 90.0], axis=0)),
            ("cumsum_none", lambda nps, b: nps.cumsum(b)),
            ("cumsum_rows", lambda nps, b: nps.cumsum(b, axis=0)),
            ("cumsum_cols", lambda nps, b: nps.cumsum(b, axis=1)),
            ("cumprod_rows", lambda nps, b: nps.cumprod(
                b * 0.1 + 1.0, axis=0)),
            ("repeat_none", lambda nps, b: nps.repeat(b, 3)),
            ("repeat_rows", lambda nps, b: nps.repeat(b, 2, axis=0)),
            ("repeat_cols", lambda nps, b: nps.repeat(b, 2, axis=1)),
            ("pad_constant", lambda nps, b: nps.pad(b, ((3, 5), (1, 0)))),
            ("pad_values", lambda nps, b: nps.pad(
                b, ((3, 5), (1, 2)), constant_values=((1.0, 2.0),
                                                      (3.0, 4.0)))),
            ("pad_edge", lambda nps, b: nps.pad(b, ((2, 4), (1, 1)),
                                                mode="edge")),
            ("pad_reflect", lambda nps, b: nps.pad(b, ((2, 4), (0, 1)),
                                                   mode="reflect")),
            ("pad_wrap", lambda nps, b: nps.pad(b, 3, mode="wrap")),
            ("pad_symmetric", lambda nps, b: nps.pad(b, ((1, 6), (2, 0)),
                                                     mode="symmetric"))]:
        add("CM5_" + name, lambda app, nps, fn=fn: fn(nps, _a(
            app, X403, (50, 5))))
        if name.startswith(("median", "cumsum", "pad_wrap")):
            add("CM5_wide_" + name, lambda app, nps, fn=fn: fn(nps, _a(
                app, X13, (4, 3))))
    add("CM5_nanquantile_rows", lambda app, nps: nps.nanquantile(
        _a(app, N403, (50, 5)), [0.25, 0.75], axis=0))
    add("CM5_nanmedian_none", lambda app, nps: nps.nanmedian(
        _a(app, N403, (50, 5))))
    add("CM5_median_nan", lambda app, nps: nps.median(
        _a(app, N403, (50, 5)), axis=0))
    add("CM5_nancumsum_none", lambda app, nps: nps.nancumsum(
        _a(app, N403, (50, 5))))
    add("CM5_cumsum_bool", lambda app, nps: nps.cumsum(
        _a(app, X403 > 0, (50, 5)), axis=0))
    add("CM5_cumsum_vector", lambda app, nps: nps.cumsum(
        _a(app, V403, (50,))))
    # the factorizations of a sharded square operand
    add("inv_cholesky_inv", lambda app, nps: app.inv(
        _a(app, SPD20, (5, 10))), 1e-10, 1e-10)
    add("inv_cholesky_cholesky", lambda app, nps: app.cholesky(
        _a(app, SPD20, (5, 10))), 1e-10, 1e-10)
    add("posdef_solve", lambda app, nps: app.posdef_solve(
        _a(app, SPD12, (6, 6)), _a(app, B12, (6,))), 1e-10, 1e-10)
    add("posdef_solve_matrix", lambda app, nps: app.posdef_solve(
        _a(app, SPD12, (3, 6)), _a(app, np.stack([B12, B12 ** 2], 1),
                                   (3, 2))), 1e-10, 1e-10)
    add("inv_ragged", lambda app, nps: app.inv(_a(app, SPD37, (5, 5))),
        1e-10, 1e-10)
    add("cholesky_ragged", lambda app, nps: app.cholesky(
        _a(app, SPD37, (5, 5))), 1e-10, 1e-10)
    add("inv_row_swap", lambda app, nps: app.inv(
        _a(app, SWAP16, (4, 16))), 1e-10, 1e-10)
    add("ridge_regressions", lambda app, nps: (
        app.ridge_regression(_a(app, RIDGE_X, (100, 6)),
                             _a(app, RIDGE_Y, (100,)), 1e-8),
        app.ridge_regression(_a(app, RIDGE_X, (100, 6)),
                             _a(app, RIDGE_Y, (100,)), 1e3)), 1e-8, 1e-10)
    add("ridge_sharded_gram", lambda app, nps: app.ridge_regression(
        _a(app, WIDE_X, (100, 4)), _a(app, WIDE_Y, (100,)), 1.0),
        1e-8, 1e-10)
    # CholeskyQR2 on the mesh: the gram summed over the row group
    add("cholqr2_factors", _cholqr(_qr_parts), 1e-10, 1e-10)
    add("cholqr2_lstsq", _cholqr(lambda app, nps: app.linear_regression(
        _a(app, RIDGE_X, (100, 6)), _a(app, RIDGE_Y, (100,)))), 1e-10,
        1e-10)
    add("cholqr2_ridge_sharded_gram", _cholqr(
        lambda app, nps: app.ridge_regression(
            _a(app, WIDE_X, (100, 4)), _a(app, WIDE_Y, (100,)), 1.0)),
        1e-8, 1e-10)
    add("cholqr2_pca", _cholqr(_pca), 1e-10, 1e-10)
    # autodiff on the mesh
    add("grad_ragged", _grad)
    add("check_grad", _check_grad)
    # sharded draws of the position-wise samplers: the serial draw's box
    for name, params in SAMPLERS.items():
        add("draw_" + name, lambda app, nps, name=name, params=params:
            getattr(app.random_state(11), name)(
                *params, shape=(13, 9), block_shape=(4, 3)), 0.0, 0.0,
            reference=False)
    add("draw_integers", lambda app, nps: app.random_state(11).integers(
        -7, 1000, shape=(13, 9), block_shape=(4, 3)), 0.0, 0.0,
        reference=False)
    add("draw_integers_rows", lambda app, nps: app.random_state(12).integers(
        50, shape=(403,), block_shape=(50,)), 0.0, 0.0, reference=False)
    add("draw_dirichlet", lambda app, nps: app.random_state(13).dirichlet(
        np.array([0.5, 2.0, 3.0]), shape=(37,), block_shape=(5, 3)),
        0.0, 0.0, reference=False)
    # a mask beside a device index array
    add("mask_index_read", lambda app, nps: _a(app, X100, (25, 4))[
        _a(app, MASK100, (25,)), _a(app, CM_COLS, (10,))])
    add("mask_index_write", lambda app, nps: _written(
        app, X100, (25, 4), lambda app: (_a(app, MASK100, (25,)),
                                         _a(app, CM_COLS, (10,))), -1.0))
    add("index_mask_read", lambda app, nps: _a(app, X13, (4, 3))[
        _a(app, np.array([0, 12, 3, 3]), (2,)),
        _a(app, np.array([4, 1, 0, 8]), (2,))])
    return t, tols, serial_only


TABLE, TOLS, SERIAL_ONLY = core_table()


def names():
    return [name for name, _ in TABLE]


def port_values(cluster):
    """In a mesh worker: the table on the port's mesh of ``cluster``."""
    import nums_tpu_torch.numpy as nps

    return run_table(mesh_app(cluster), nps, TABLE, placed=True)


def reference_values(cluster):
    return jax_mesh_values(cluster, [e for e in TABLE
                                     if e[0] not in SERIAL_ONLY])


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    return [np.asarray(x)]


def assert_close(got, ref, tol):
    """One entry of two ``run_table``s: the same exception type, or
    leaves of equal shapes whose values agree (integers, bools and indices
    equal; floats within ``tol`` of max|ref|, NaN where ref has NaN)."""
    (g, g_exc), (r, r_exc) = got, ref
    if r_exc is not None:
        assert g_exc == r_exc, (g_exc, r_exc)
        return
    assert g_exc is None, g_exc
    gl, rl = _leaves(g), _leaves(r)
    assert len(gl) == len(rl), (len(gl), len(rl))
    for a, b in zip(gl, rl):
        assert a.shape == b.shape, (a.shape, b.shape)
        if b.dtype.kind in "biu" or a.dtype.kind in "biu" or tol == 0:
            assert np.array_equal(a, b, equal_nan=b.dtype.kind in "fc"), (
                a, b)
            continue
        a, b = a.astype(np.float64), b.astype(np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), (a, b)
        fin = np.isfinite(b)
        if fin.any():
            scale = max(float(np.max(np.abs(b[fin]))), 1e-300)
            err = float(np.max(np.abs(a[fin] - b[fin])))
            assert err <= tol * scale, (err / scale, tol)


def check(port_mesh, reference_mesh, port_serial, name):
    values, placed = port_mesh
    got = values[name]
    ref_tol, serial_tol = TOLS[name]
    if name not in SERIAL_ONLY:
        assert_close(got, reference_mesh[name], ref_tol)
    assert_close(got, port_serial[name], serial_tol)
    where, gathered = placed[name]
    assert where, "a result is not laid out as app.array lays it"
    assert_gathers_allowed(name, gathered)
