"""The GLM layer as a whole: every family and every solver of nums_tpu's
``models/glms.py``, against nums_tpu on the same numpy inputs.

(a) Every family x every solver the reference accepts, in float64 at
    ``matmul_precision="highest"``: beta, the predictions, ``objective``,
    ``grad_norm_sq``, ``deviance``/``deviance_sqr`` and ``score`` within
    1e-9 of the largest magnitude (for ``grad_norm_sq`` at least
    1e-12·‖[X, 1]ᵀy‖², as it is rounding noise at an optimum) (gd, sgd, block_sgd, eager newton,
    irls, fused newton), 1e-6 (lbfgs: the line search's trial steps may
    differ) and 1e-8 (admm). The options the reference rejects raise the
    same exception type.
(b) ``sgd`` visits the reference's exact row sequence for one seed.
(c) The fused-vs-eager sweep of tests/models/test_glms.py:157-199, inside
    the port, at the reference's tolerances.
(d) The kernel route of LinearRegression/Ridge/PoissonRegression in
    float32 at the default precision, against nums_tpu's Pallas route in
    interpret mode on a lane-padded buffer: beta within 1e-2 of max|beta|
    (bf16 MACs; eta uses bf16(beta)), with X staged once and
    ``cuda_newton.stats`` called on the staged copy with the family's kind.
(e) ``from_reference_params`` for all seven classes: the same predictions
    as the nums_tpu model that was fitted and saved.
(f) ``train_test_split``, ``KFold``, ``cross_val_score`` and the row
    gather against the reference's; metrics; the array and linalg ops the
    solvers use; ``BimodalGaussian`` bit for bit.
"""

import json

import numpy as np
import pytest

from test_torch_glm import padded_jax_app  # noqa: F401
from torch_parity import (  # noqa: F401
    jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import cuda_newton

N, D = 400, 5
BS = (100, D)  # four row blocks: block_sgd takes four steps per epoch


def _data(family, seed=0, n=N):
    rs = np.random.RandomState(seed)
    from nums_tpu_torch.core.io.datasets import BimodalGaussian

    if family == "logistic":
        return BimodalGaussian.get_dataset(n, D, p=0.5, seed=seed + 1)
    X = rs.randn(n, D)
    w = np.linspace(-0.4, 0.5, D)
    if family == "linear":
        y = X @ w + 0.7 + 0.2 * rs.randn(n)
    elif family == "poisson":
        y = rs.poisson(np.exp(0.6 * (X @ w) + 0.3)).astype(np.float64)
    else:  # exponential
        y = rs.exponential(scale=np.exp(0.6 * (X @ w) + 0.2))
    return X, y


FAMILIES = {
    "LinearRegression": "linear",
    "LogisticRegression": "logistic",
    "PoissonRegression": "poisson",
    "ExponentialRegression": "exponential",
    "Ridge": "linear",
    "Lasso": "linear",
    "ElasticNet": "linear",
}

# (class, constructor kwargs, tolerance): every solver each class takes.
GD = dict(lr=1e-4, tol=1e-8, max_iter=10, random_state=3)
CASES = []
for _cls in ("LinearRegression", "LogisticRegression", "PoissonRegression",
             "ExponentialRegression"):
    for _s in ("gd", "sgd", "block_sgd"):
        # BimodalGaussian's features are O(10): a smaller step.
        lr = 1e-6 if _cls == "LogisticRegression" else GD["lr"]
        CASES.append((_cls, dict(GD, solver=_s, lr=lr), 1e-9))
    CASES.append((_cls, dict(solver="newton", tol=1e-8, max_iter=12),
                  1e-9))
for _cls in ("LinearRegression", "LogisticRegression", "PoissonRegression"):
    CASES.append((_cls, dict(solver="newton", tol=1e-8, max_iter=12,
                             fuse="0"), 1e-9))
    CASES.append((_cls, dict(solver="lbfgs", tol=1e-9, max_iter=200,
                             penalty="l2", C=2.0), 1e-6))
    CASES.append((_cls, dict(solver="admm", tol=1e-10, max_iter=400,
                             penalty="l2", C=0.5), 1e-8))
CASES += [
    ("LogisticRegression", dict(solver="irls", tol=1e-8, max_iter=10), 1e-9),
    ("LogisticRegression", dict(solver="newton", tol=1e-8, max_iter=10,
                                penalty="l2", C=0.5), 1e-9),
    ("LogisticRegression", dict(solver="admm", tol=1e-10, max_iter=400,
                                penalty="l1", C=0.1), 1e-8),
    ("Ridge", dict(alpha=2.0), 1e-9),
    ("Ridge", dict(alpha=2.0, solver="newton", fuse="0"), 1e-9),
    ("Ridge", dict(alpha=2.0, solver="gd", lr=1e-4, max_iter=10), 1e-9),
    ("Ridge", dict(alpha=2.0, solver="lbfgs", tol=1e-9, max_iter=200), 1e-6),
    ("Lasso", dict(alpha=0.05, tol=1e-10, max_iter=400), 1e-8),
    ("ElasticNet", dict(alpha=0.05, l1_ratio=0.3, tol=1e-10,
                        max_iter=400), 1e-8),
    ("PoissonRegressor", dict(solver="newton", tol=1e-8, max_iter=12), 1e-9),
]


def _id(case):
    cls, kw, _ = case
    return "-".join([cls] + [f"{k}={v}" for k, v in kw.items()
                             if k in ("solver", "fuse", "penalty")])


def _fit(glms, app, cls, kw, X, y, jax_side):
    """Fit ``cls`` of ``glms`` with ``kw``; ``fuse`` sets glm_fuse."""
    from nums_tpu.core import settings as jsettings

    kw = dict(kw)
    fuse = kw.pop("fuse", "1")
    mod = jsettings if jax_side else settings
    prev, mod.glm_fuse = mod.glm_fuse, fuse
    try:
        bx = app.array(X, block_shape=BS)
        by = app.array(y, block_shape=(BS[0],))
        model = getattr(glms, cls)(**kw).fit(bx, by)
    finally:
        mod.glm_fuse = prev
    return model, bx, by


def _outputs(model, bx, by):
    """Every output the test holds, as numpy, keyed by name."""
    out = {
        "beta": np.append(model._beta.get(), model._beta0.get()),
        "predict": model.predict(bx).get(),
        "objective": model.objective(bx, by).get(),
        "grad_norm_sq": model.grad_norm_sq(bx, by).get(),
        "score": model.score(bx, by).get(),
    }
    if type(model).__name__ != "LogisticRegression":
        out["deviance"] = model.deviance(by, model.predict(bx)).get()
        out["deviance_sqr"] = model.deviance_sqr(bx, by).get()
    else:
        out["predict_proba"] = model.predict_proba(bx).get()
    return out


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_family_solver_matches_reference(jax_app, torch_app, monkeypatch,
                                         case):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    monkeypatch.setattr(settings, "matmul_precision", "highest")
    cls, kw, tol = case
    fam = FAMILIES.get(cls, "poisson")
    X, y = _data(fam)
    ref = _outputs(*_fit(jglms, jax_app, cls, kw, X, y, True))
    got = _outputs(*_fit(tglms, torch_app, cls, kw, X, y, False))
    assert got.keys() == ref.keys()
    # At an optimum ‖g‖² is rounding noise: it is held against the square
    # of the gradient at beta = 0 instead, ‖[X, 1]ᵀy‖², times 1e-12.
    xa = np.hstack([X, np.ones((len(y), 1))])
    floor = {"grad_norm_sq": 1e-12 * float(np.sum((xa.T @ y) ** 2))}
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        assert got[name].dtype == ref[name].dtype, (name, got[name].dtype)
        err = np.max(np.abs(got[name] - ref[name]))
        scale = max(np.max(np.abs(ref[name])), floor.get(name, 0.0))
        assert err <= tol * scale, (name, got[name], ref[name])
    assert np.all(np.isfinite(got["beta"]))


@pytest.mark.parametrize("cls,kw,exc", [
    ("LinearRegression", dict(solver="irls"), AssertionError),
    ("PoissonRegression", dict(solver="irls"), AssertionError),
    ("ExponentialRegression", dict(solver="lbfgs"), NotImplementedError),
    ("ExponentialRegression", dict(solver="admm"), NotImplementedError),
    ("LinearRegression", dict(solver="nope"), Exception),
])
def test_rejected_at_fit_as_reference(jax_app, torch_app, cls, kw, exc):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    X, y = _data("linear", n=40)
    errors = []
    for glms, app in ((jglms, jax_app), (tglms, torch_app)):
        bx = app.array(X, block_shape=(40, D))
        by = app.array(y, block_shape=(40,))
        with pytest.raises(exc) as err:
            getattr(glms, cls)(**kw).fit(bx, by)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


@pytest.mark.parametrize("kw,exc", [
    (dict(penalty="l1"), NotImplementedError),
    (dict(penalty="elasticnet", solver="lbfgs"), NotImplementedError),
    (dict(penalty="l3", solver="admm"), NotImplementedError),
    (dict(fit_intercept=False), NotImplementedError),
    (dict(normalize=True), NotImplementedError),
    (dict(random_state="seed"), Exception),
])
def test_rejected_at_construction_as_reference(jax_app, torch_app, kw, exc):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    errors = []
    for glms in (jglms, tglms):
        with pytest.raises(exc) as err:
            glms.LinearRegression(**kw)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


def test_module_entry_points_raise_as_reference(jax_app, torch_app):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    for name in ("lbfgs", "admm"):
        for glms in (jglms, tglms):
            with pytest.raises(NotImplementedError):
                getattr(glms, name)()
    assert sorted(tglms._MODEL_REGISTRY) == sorted(jglms._MODEL_REGISTRY)
    assert tglms.PoissonRegressor is tglms.PoissonRegression


def test_sgd_visits_the_reference_rows(jax_app, torch_app):
    """One generator for the whole run (tests/models/test_glms.py:273-301),
    drawing the reference's rows for the same seed."""
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    n, d = 32, 2
    seen = {}
    for name, glms, app in (("ref", jglms, jax_app),
                            ("got", tglms, torch_app)):
        rows = seen.setdefault(name, [])
        X = app.array(np.arange(n * d, dtype=float).reshape(n, d),
                      block_shape=(n, d))
        y = app.array(np.zeros(n), block_shape=(n,))

        class Probe:
            def __init__(self, app=app):
                self.rs = app.random_state(0)
                self.app = app

            def forward(self, Xs, beta):
                return Xs[:, 0]

            def gradient(self, Xs, ys, mu, beta=None, rows=rows):
                rows.append(float(Xs.get()[0, 0]))
                return self.app.zeros((d,), (d,))

        glms.sgd(Probe(), app.zeros((d,), (d,)), X, y, app.scalar(-1.0),
                 25, app.scalar(0.1))
    assert len(seen["got"]) == 25 and len(set(seen["got"])) > 5
    assert seen["got"] == seen["ref"]


def test_fused_vs_eager_newton(torch_app):
    """The fused Newton loop matches the eager per-op loop in every fused
    kind, with and without l2 (tests/models/test_glms.py:157-199)."""
    from nums_tpu_torch.core.io.datasets import BimodalGaussian
    from nums_tpu_torch.models.glms import (
        LinearRegression, LogisticRegression, PoissonRegression,
    )

    real_X, real_y = BimodalGaussian.get_dataset(400, 5)
    X = torch_app.array(real_X, block_shape=(100, 5))
    y = torch_app.array(real_y, block_shape=(100,))

    def fit(fuse, cls=LogisticRegression, **kw):
        prev = settings.glm_fuse
        settings.glm_fuse = fuse
        try:
            m = cls(solver="newton", tol=1e-8, max_iter=8, **kw)
            m.fit(X, y)
            return np.concatenate([m._beta.get(), [float(m._beta0.get())]])
        finally:
            settings.glm_fuse = prev

    assert np.allclose(fit("1"), fit("0"), atol=1e-9)
    assert np.allclose(fit("1", penalty="l2", C=0.5),
                       fit("0", penalty="l2", C=0.5), atol=1e-9)
    assert np.allclose(fit("1", cls=LinearRegression),
                       fit("0", cls=LinearRegression), atol=1e-8)
    assert np.allclose(fit("1", cls=LinearRegression, penalty="l2", C=0.5),
                       fit("0", cls=LinearRegression, penalty="l2", C=0.5),
                       atol=1e-8)
    assert np.allclose(fit("1", cls=PoissonRegression),
                       fit("0", cls=PoissonRegression), atol=1e-7)


def _kernel_data(family, seed=11, n=2048, d=96):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    w = 0.5 / np.sqrt(d) * rs.randn(d)
    eta = X.astype(np.float64) @ w + 0.2
    if family == "linear":
        y = eta + 0.1 * rs.randn(n)
    else:
        y = rs.poisson(np.exp(eta))
    return X, y.astype(np.float32)


@pytest.mark.parametrize("cls,kind", [
    ("LinearRegression", "linear"), ("Ridge", "linear"),
    ("PoissonRegression", "poisson"),
])
def test_kernel_route_matches_pallas_route(padded_jax_app, torch_app,
                                           spy_calls, cls, kind):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    assert settings.matmul_precision == "default"
    prepares = spy_calls(cuda_newton, "prepare")
    stats = spy_calls(cuda_newton, "stats")
    X, y = _kernel_data(kind)
    n, d = X.shape
    kw = dict(solver="newton", tol=1e-8, max_iter=6)
    if cls == "Ridge":
        kw = dict(alpha=1.0, tol=1e-8, max_iter=6)
    betas, models = [], []
    for glms, app in ((jglms, padded_jax_app), (tglms, torch_app)):
        bx = app.array(X, block_shape=(n, d))
        by = app.array(y, block_shape=(n,))
        m = getattr(glms, cls)(**kw).fit(bx, by)
        betas.append(np.append(m._beta.get(), m._beta0.get()))
        models.append((m, bx))
    assert tuple(models[0][1].raw.shape) == (n, 128)  # lane-padded
    assert len(prepares) == 1 and len(stats) == kw["max_iter"]
    assert all(isinstance(a[0], cuda_newton.Staged) for a in stats)
    assert all(tuple(a[0].shape) == (n, d + 1) and a[3] == kind
               for a in stats)
    assert rel_err(betas[1], betas[0]) < 1e-2
    preds = [m.predict(bx).get() for m, bx in models]
    assert rel_err(preds[1], preds[0]) < 1e-2
    if cls == "Ridge":
        assert models[1][0]._lambda_vec.get()[-1] == 0.0


@pytest.mark.parametrize("cls", sorted(FAMILIES))
def test_from_reference_params(jax_app, torch_app, tmp_path, cls):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    kw = {
        "LinearRegression": dict(solver="newton", penalty="l2", C=0.5),
        "LogisticRegression": dict(solver="lbfgs", penalty="l2", C=0.5),
        "PoissonRegression": dict(solver="newton"),
        "ExponentialRegression": dict(solver="newton", max_iter=20),
        "Ridge": dict(alpha=2.0, solver="lbfgs"),
        "Lasso": dict(alpha=0.05, max_iter=300),
        "ElasticNet": dict(alpha=0.05, l1_ratio=0.3, max_iter=300),
    }[cls]
    X, y = _data(FAMILIES[cls], seed=4)
    ref, rbx, _ = _fit(jglms, jax_app, cls, kw, X, y, True)
    ref.save(str(tmp_path / "model"))
    with open(tmp_path / "model" / "model.json") as f:
        meta = json.load(f)
    arrays = {"beta": ref._beta.get(), "beta0": ref._beta0.get()}
    if ref._lambda_vec is not None:
        arrays["lambda_vec"] = ref._lambda_vec.get()
    model = tglms.GLM.from_reference_params(meta, arrays)
    assert type(model).__name__ == cls
    for attr in ("_penalty", "_max_iter", "_opt"):
        assert getattr(model, attr) == getattr(ref, attr), attr
    for attr in ("_tol", "_lr", "_admm_rho", "_l1_ratio", "_lambda"):
        assert getattr(model, attr) == pytest.approx(getattr(ref, attr),
                                                     rel=1e-15), attr
    tbx = torch_app.array(X, block_shape=BS)
    got, want = model.predict(tbx).get(), ref.predict(rbx).get()
    if cls == "LogisticRegression":
        assert np.array_equal(got, want)
        got, want = model.predict_proba(tbx).get(), ref.predict_proba(rbx).get()
    assert rel_err(got, want) < 1e-12
    if ref._lambda_vec is not None:
        assert np.array_equal(model._lambda_vec.get(), ref._lambda_vec.get())


def test_splits_and_row_gather(jax_app, torch_app):
    from nums_tpu.models import model_selection as jms
    from nums_tpu_torch.models import model_selection as tms

    X, y = _data("linear", n=50)
    rX, ry = jax_app.array(X, block_shape=(20, D)), jax_app.array(y, (20,))
    tX, ty = torch_app.array(X, block_shape=(20, D)), torch_app.array(y, (20,))
    idx = np.array([4, 0, 49, -1, 7, 7])
    assert np.array_equal(tX[idx].get(), rX[idx].get())
    tidx = torch_app.array(idx, block_shape=(6,))
    assert np.array_equal(tX[tidx].get(), rX[idx].get())
    assert tX[idx].block_shape == rX[idx].block_shape
    with pytest.raises(IndexError):
        tX[np.array([50])]
    with pytest.raises(NotImplementedError):
        tX[np.array([True] * 50)]

    for kw in (dict(test_size=0.2), dict(train_size=30, test_size=10)):
        ref = jms.train_test_split(rX, ry, shuffle=False, **kw)
        got = tms.train_test_split(tX, ty, shuffle=False, **kw)
        for g, r in zip(got, ref):
            assert np.array_equal(g.get(), r.get())
    # Shuffled: one permutation shared by every array, the same for one
    # seed (the stream itself is torch's, not threefry's: ROADMAP A2).
    a = tms.train_test_split(tX, ty, test_size=0.2, random_state=5)
    b = tms.train_test_split(tX, ty, test_size=0.2, random_state=5)
    for g, h in zip(a, b):
        assert np.array_equal(g.get(), h.get())
    rows = np.concatenate([a[0].get(), a[1].get()])
    assert rows.shape == (50, D)
    assert np.array_equal(np.sort(rows[:, 0]), np.sort(X[:, 0]))
    col = torch_app.array(X[:, 0].copy(), (20,))
    c = tms.train_test_split(tX, col, test_size=0.2, random_state=5)
    assert np.array_equal(c[0].get()[:, 0], c[2].get())
    assert np.array_equal(c[1].get()[:, 0], c[3].get())
    for fold_g, fold_r in zip(tms.KFold(4).split(tX),
                              jms.KFold(4).split(rX)):
        for g, r in zip(fold_g, fold_r):
            assert np.array_equal(np.asarray(g), np.asarray(r))
    tests = [t.get() for _, t in tms.KFold(4, shuffle=True,
                                          random_state=2).split(tX)]
    assert np.array_equal(np.sort(np.concatenate(tests)), np.arange(50))


def test_cross_val_score_matches_reference(jax_app, torch_app):
    from nums_tpu.models import glms as jglms, model_selection as jms
    from nums_tpu_torch.models import glms as tglms, model_selection as tms

    for cls, fam in (("LogisticRegression", "logistic"),
                     ("LinearRegression", "linear")):
        X, y = _data(fam, n=120, seed=6)
        scores = []
        for glms, ms, app in ((jglms, jms, jax_app), (tglms, tms, torch_app)):
            model = getattr(glms, cls)(solver="newton", max_iter=10)
            bx = app.array(X, block_shape=(40, D))
            by = app.array(y, block_shape=(40,))
            scores.append(ms.cross_val_score(model, bx, by, cv=4))
            assert model._beta is None  # each fold fitted a copy
        assert scores[1].shape == (4,)
        assert rel_err(scores[1], scores[0]) < 1e-12


def test_metrics_match_reference(jax_app, torch_app):
    from nums_tpu.models import metrics as jm
    from nums_tpu_torch.models import metrics as tm

    rs = np.random.RandomState(9)
    yt = (rs.rand(30) > 0.5).astype(np.float64)
    p = rs.rand(30)
    for name, args in (("accuracy_score", (yt, (p > 0.5) * 1.0)),
                       ("mean_squared_error", (yt, p)),
                       ("mean_absolute_error", (yt, p)),
                       ("r2_score", (yt, p)),
                       ("r2_score", (np.ones(5), np.ones(5))),
                       ("r2_score", (np.ones(5), np.zeros(5))),
                       ("log_loss", (yt, p)),
                       ("log_loss", (yt, np.stack([1 - p, p], 1)))):
        ref = float(getattr(jm, name)(*args).get())
        got = float(getattr(tm, name)(*args).get())
        assert got == pytest.approx(ref, rel=1e-12, abs=1e-15), name


def test_application_ops_match_reference(jax_app, torch_app):
    rs = np.random.RandomState(10)
    a = rs.rand(6, 6) + 0.1
    spd = a @ a.T + 6 * np.eye(6)
    v, w = rs.rand(6) + 0.5, rs.rand(6)
    for name, args in (
        ("log", (v,)), ("abs", (v - 1,)), ("sqrt", (v,)), ("norm", (w,)),
        ("xlogy", (np.array([0.0, 1.0, 2.0, 0.0, 3.0, 4.0]), v)),
        ("min", (a,)), ("max", (a,)), ("diag", (v,)), ("diag", (a,)),
        ("inv", (spd,)), ("cholesky", (spd,)), ("posdef_solve", (spd, w)),
        ("sqrt", (np.arange(6),)),
    ):
        outs = []
        for app in (jax_app, torch_app):
            bas = [app.array(x, block_shape=x.shape) for x in args]
            outs.append(getattr(app, name)(*bas))
        got, ref = outs[1].get(), outs[0].get()
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        assert rel_err(got, ref) < 1e-12, name
        assert outs[1].block_shape == outs[0].block_shape, name
    for app_pair in ((jax_app, torch_app),):
        eyes = [app.eye((4, 6), (2, 3)) for app in app_pair]
        assert np.array_equal(eyes[1].get(), eyes[0].get())
        assert eyes[1].block_shape == eyes[0].block_shape
    c = a > 0.5
    for x, y in ((a, 1.0 - a), (a, 0.0), (2.0, a)):
        outs = []
        for app in (jax_app, torch_app):
            args = [app.array(x, block_shape=a.shape)
                    if isinstance(x, np.ndarray) else x
                    for x in (x, y)]
            outs.append(app.where(app.array(c, block_shape=c.shape), *args))
        assert np.array_equal(outs[1].get(), outs[0].get())
        assert outs[1].dtype == outs[0].dtype
    not_pd = torch_app.array(a + a.T - 20 * np.eye(6), block_shape=(6, 6))
    assert np.isnan(torch_app.cholesky(not_pd).get()).all()


def test_random_numpy_and_lazy_state(jax_app, torch_app):
    ref = jax_app.random_state(42).numpy().integers(1000, size=20)
    got = torch_app.random_state(42).numpy().integers(1000, size=20)
    assert np.array_equal(got, ref)
    assert torch_app.random is torch_app.random
    perm = torch_app.random_state(1).permutation(17).get()
    assert perm.dtype == np.int64
    assert np.array_equal(np.sort(perm), np.arange(17))


def test_bimodal_gaussian_is_the_reference():
    from nums_tpu.core.io.datasets import BimodalGaussian as J
    from nums_tpu_torch.core.io.datasets import BimodalGaussian as T

    for kw in (dict(), dict(p=0.5, seed=7), dict(theta=np.arange(4.0)),
               dict(dtype=np.float32)):
        for got, ref in zip(T.get_dataset(50, 4, **kw),
                            J.get_dataset(50, 4, **kw)):
            assert got.dtype == ref.dtype
            assert np.array_equal(got, ref)
