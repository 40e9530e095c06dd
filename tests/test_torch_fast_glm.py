"""nums_tpu_torch.models.fast_glm against nums_tpu.models.fast_glm, in
float64 on the CPU, on the same numpy inputs.

Tolerances, each relative to the largest magnitude of the reference's
output:
* ``admm_fit``/``admm_fit_gram``: z within 1e-8, the same iteration count
  and exactly the same zeros (the two loops run the same arithmetic; only
  the order of the sums and of the triangular solves differs);
* ``bfgs_fit`` on strictly convex problems: beta within 1e-6 (the line
  search's trial steps may differ, the optimum may not);
* ``newton_train``, ``fit_logistic``, ``_objective``, ``_soft_threshold``:
  within 1e-12;
* ``newton_fit`` on the Newton-stats kernel (float32, its plain version
  here) against the reference's Pallas fit in interpret mode: 1e-2, the
  bf16-MAC class of tests/test_torch_glm.py (eta uses bf16(beta), which
  pins beta to about one bf16 ulp, 3.9e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import rel_err, spy_calls  # noqa: F401

from nums_tpu.models import fast_glm as jfast
from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import cuda_newton
from nums_tpu_torch.models import fast_glm as tfast

N, D = 400, 6
W = np.array([0.8, -0.5, 0.0, 0.0, 0.3, 0.0, 0.2])  # last: intercept


def _problem(kind, seed=0, n=N):
    """Intercept-augmented X (n, D+1) and a target of the kind."""
    rs = np.random.RandomState(seed)
    X = np.hstack([rs.randn(n, D), np.ones((n, 1))])
    eta = X @ W
    if kind == "linear":
        y = eta + 0.3 * rs.randn(n)
    elif kind == "logistic":
        y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-eta))).astype(np.float64)
    else:
        y = rs.poisson(np.exp(0.5 * eta)).astype(np.float64)
    return X, y


def _lambda(kind, penalty):
    """Per-coordinate λ, the intercept unpenalized; large enough that l1
    zeroes the planted zeros."""
    lam = {"linear": 40.0, "logistic": 12.0, "poisson": 40.0}[kind]
    if penalty == "l2":
        lam = 5.0
    lv = np.full(D + 1, lam)
    lv[-1] = 0.0
    return lv


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("kind", ["linear", "logistic", "poisson"])
@pytest.mark.parametrize("penalty", ["l1", "l2", "elasticnet"])
def test_admm_fit(kind, penalty):
    X, y = _problem(kind, seed=1)
    lv = _lambda(kind, penalty)
    beta0 = np.zeros(D + 1)
    kw = dict(kind=kind, max_iter=500, rho=1.0, penalty=penalty,
              l1_ratio=0.7)
    rz, rres, rit = jfast.admm_fit(_j(X), _j(y), _j(beta0), 1e-9,
                                   lambda_vec=_j(lv), **kw)
    z, res, it = tfast.admm_fit(_t(X), _t(y), _t(beta0), 1e-9,
                                lambda_vec=_t(lv), **kw)
    rz = np.asarray(rz)
    assert int(it) == int(rit) < 500
    assert rel_err(z, rz) < 1e-8
    assert np.array_equal(z.numpy() == 0.0, rz == 0.0)
    if penalty == "l1":
        assert (rz[:-1] == 0.0).sum() >= 2
    assert float(res) <= 1e-9 and float(rres) <= 1e-9


@pytest.mark.parametrize("penalty", ["l1", "l2", "elasticnet", "none"])
def test_admm_fit_gram(penalty):
    X, y = _problem("linear", seed=2)
    G, q = X.T @ X, X.T @ y
    lv = _lambda("linear", penalty if penalty != "none" else "l2")
    beta0 = np.zeros(D + 1)
    kw = dict(max_iter=300, rho=2.0, penalty=penalty, l1_ratio=0.4)
    rz, rres, rit = jfast.admm_fit_gram(_j(G), _j(q), _j(beta0), 1e-10,
                                        lambda_vec=_j(lv), **kw)
    z, res, it = tfast.admm_fit_gram(_t(G), _t(q), _t(beta0), 1e-10,
                                     lambda_vec=_t(lv), **kw)
    rz = np.asarray(rz)
    assert int(it) == int(rit) < 300
    assert rel_err(z, rz) < 1e-8
    assert np.array_equal(z.numpy() == 0.0, rz == 0.0)
    assert float(res) == pytest.approx(float(rres), rel=1e-3, abs=1e-12)


def test_admm_stops_at_max_iter():
    """A loop cut by max_iter reports the same count and iterate."""
    X, y = _problem("linear", seed=3)
    lv = _lambda("linear", "l1")
    args = (0.0,)
    kw = dict(kind="linear", max_iter=7, penalty="l1")
    rz, _, rit = jfast.admm_fit(_j(X), _j(y), _j(np.zeros(D + 1)), *args,
                                lambda_vec=_j(lv), **kw)
    z, _, it = tfast.admm_fit(_t(X), _t(y), _t(np.zeros(D + 1)), *args,
                              lambda_vec=_t(lv), **kw)
    assert int(it) == int(rit) == 7
    assert rel_err(z, np.asarray(rz)) < 1e-10


@pytest.mark.parametrize("kind,penalized", [
    ("logistic", True), ("linear", False), ("linear", True),
    ("poisson", True),
])
def test_bfgs_fit(kind, penalized):
    X, y = _problem(kind, seed=4)
    lv = np.full(D + 1, 2.0) if penalized else None
    beta0 = np.zeros(D + 1)
    kw = dict(kind=kind, max_iter=200, penalized=penalized)
    ref = jfast.bfgs_fit(_j(X), _j(y), _j(beta0), 1e-9,
                         lambda_vec=None if lv is None else _j(lv), **kw)
    got = tfast.bfgs_fit(_t(X), _t(y), _t(beta0), 1e-9,
                         lambda_vec=None if lv is None else _t(lv), **kw)
    assert rel_err(got, np.asarray(ref)) < 1e-6
    # And the optimum it found is the Newton optimum.
    newton, _, _ = tfast.newton_fit(_t(X), _t(y), _t(beta0), 1e-12,
                                    kind=kind, max_iter=30,
                                    penalized=penalized,
                                    lambda_vec=None if lv is None
                                    else _t(lv))
    assert rel_err(got, newton) < 1e-6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bfgs_fit_at_scale(monkeypatch, dtype):
    """A sum over many rows makes the Hessian about n times the identity:
    with its initial inverse Hessian rescaled, bfgs_fit reaches the Newton
    optimum in a few iterations, in float32 too (from the bare identity,
    as jax starts, it needs about d)."""
    rs = np.random.RandomState(9)
    n, d = 40_000, 40
    X = np.hstack([rs.randn(n, d), np.ones((n, 1))])
    w = 0.4 * rs.randn(d + 1)
    y = (rs.rand(n) < 1.0 / (1.0 + np.exp(-(X @ w)))).astype(np.float64)
    lv = torch.ones(d + 1, dtype=dtype)
    searches = []
    search = tfast._line_search
    monkeypatch.setattr(tfast, "_line_search",
                        lambda *a, **k: searches.append(1) or search(*a, **k))
    got = tfast.bfgs_fit(_t(X).to(dtype), _t(y).to(dtype),
                         torch.zeros(d + 1, dtype=dtype),
                         1e-4 if dtype == torch.float64 else 1e-2,
                         kind="logistic", max_iter=100, penalized=True,
                         lambda_vec=lv)
    newton, _, _ = tfast.newton_fit(_t(X), _t(y), _t(np.zeros(d + 1)), 1e-12,
                                    kind="logistic", max_iter=20,
                                    penalized=True, lambda_vec=lv.double())
    assert len(searches) <= 30
    assert rel_err(got, newton) < (1e-6 if dtype == torch.float64 else 1e-4)


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_newton_train(kind):
    X, y = _problem(kind, seed=5)
    beta0 = np.zeros(D + 1)
    rb, rg = jfast.newton_train(_j(X), _j(y), _j(beta0), kind=kind,
                                num_iters=6)
    b, g = tfast.newton_train(_t(X), _t(y), _t(beta0), kind=kind,
                              num_iters=6)
    assert g.shape == (6,)
    assert rel_err(b, np.asarray(rb)) < 1e-12
    assert rel_err(g, np.asarray(rg)) < 1e-12


def test_fit_logistic_and_proba():
    X, y = _problem("logistic", seed=6)
    Xr = X[:, :-1]
    ref = np.asarray(jfast.fit_logistic(Xr, y, num_iters=8))
    got = tfast.fit_logistic(Xr, y, num_iters=8)
    assert rel_err(got, ref) < 1e-12
    assert rel_err(tfast.predict_proba_logistic(Xr, got),
                   np.asarray(jfast.predict_proba_logistic(Xr, _j(ref)))
                   ) < 1e-12


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
@pytest.mark.parametrize("penalized", [False, True])
def test_objective(kind, penalized):
    X, y = _problem(kind, seed=7)
    beta = 0.4 * np.random.RandomState(8).randn(D + 1)
    beta[0] = 12.0  # large |eta|: softplus in its linear range
    lv = np.linspace(0.5, 2.0, D + 1) if penalized else None
    ref = jfast._objective(kind, _j(X), _j(y), _j(beta),
                           None if lv is None else _j(lv))
    got = tfast._objective(kind, _t(X), _t(y), _t(beta),
                           None if lv is None else _t(lv))
    assert rel_err(got, np.asarray(ref)) < 1e-12


def test_objective_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tfast._objective("gamma", _t(np.ones((2, 2))), _t(np.ones(2)),
                         _t(np.ones(2)), None)


def test_soft_threshold():
    v = np.array([-3.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.5, 1e-20])
    k = np.array([1.0, 1.0, 1.0, 1.0, 0.5, 0.25, 3.0, 0.0])
    ref = np.asarray(jfast._soft_threshold(_j(v), _j(k)))
    got = tfast._soft_threshold(_t(v), _t(k)).numpy()
    assert rel_err(got, ref) < 1e-12
    assert np.array_equal(got == 0.0, ref == 0.0)


@pytest.mark.parametrize("kind", ["logistic", "linear", "poisson"])
def test_newton_fit_stages_x_once(monkeypatch, spy_calls, kind):
    """On the Newton-stats kernel a fit stages X once (``prepare``) and
    each of its ``max_iter`` iterations takes the staged copy. The result
    is the same bits as a fit whose iterations take X itself, and within
    the bf16 class of the reference's Pallas fit."""
    rs = np.random.RandomState(12)
    n, d = 1000, 256
    X = np.hstack([rs.randn(n, d - 1), np.ones((n, 1))]).astype(np.float32)
    eta = X.astype(np.float64) @ (0.5 / np.sqrt(d) * rs.randn(d))
    y = {"logistic": (rs.rand(n) < 1.0 / (1.0 + np.exp(-eta))),
         "linear": eta + 0.1 * rs.randn(n),
         "poisson": rs.poisson(np.exp(eta))}[kind].astype(np.float32)
    beta0 = np.zeros(d, np.float32)
    assert settings.matmul_precision == "default"
    prepares = spy_calls(cuda_newton, "prepare")
    stats = spy_calls(cuda_newton, "stats")
    got, _, _ = tfast.newton_fit(_t(X), _t(y), _t(beta0), 1e-8, kind=kind,
                                 max_iter=4, kernels=True)
    assert len(prepares) == 1 and len(stats) == 4
    assert all(isinstance(a[0], cuda_newton.Staged) and a[0].shape == (n, d)
               for a in stats)
    monkeypatch.setattr(cuda_newton, "prepare", lambda x: x)
    one_shot, _, _ = tfast.newton_fit(_t(X), _t(y), _t(beta0), 1e-8,
                                      kind=kind, max_iter=4, kernels=True)
    assert all(isinstance(a[0], torch.Tensor) for a in stats[4:])
    assert torch.equal(got, one_shot)
    monkeypatch.setenv("NUMS_TPU_PALLAS_NEWTON", "1")
    ref, _, _ = jfast.newton_fit(_j(X), _j(y), _j(beta0), 1e-8, kind=kind,
                                 max_iter=4, pallas=True)
    assert rel_err(got, np.asarray(ref)) < 1e-2
