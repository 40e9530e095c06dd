"""The plain references against NumPy float64 at a tiny size: the gram,
and Newton's method for the logistic fit written out again in NumPy, its
β after each step (the probes') and after the last."""

import numpy as np
import pytest
import torch

from benchmark.harness.session import Ctx
from benchmark.reference import gram as gram_ref
from benchmark.reference import logreg_newton as fit_ref


def _ctx(**config):
    return Ctx(torch, torch.device("cpu"), 1, 0, 1, config, 2)


def _data(n=3000, d=7, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    beta = rng.normal(0.0, 0.5, (d, 2))
    y = (1 / (1 + np.exp(-x.astype(np.float64) @ beta))
         > rng.random((n, 2))).T.astype(np.float32)
    return x, y


def _newton_numpy(x, y, iters):
    xa = np.hstack([x.astype(np.float64), np.ones((x.shape[0], 1))])
    b = np.zeros(xa.shape[1])
    for _ in range(iters):
        mu = 1 / (1 + np.exp(-xa @ b))
        g = xa.T @ (mu - y)
        h = (xa * (mu * (1 - mu))[:, None]).T @ xa
        b = b - np.linalg.solve(h, g)
    return b


def test_gram_reference_is_float64_numpy(monkeypatch):
    x, _ = _data()
    monkeypatch.setattr(gram_ref, "ROWS", 1000)   # several blocks
    got = gram_ref.solve(_ctx(), {"x": torch.from_numpy(x)}, 0, "float64")
    want = x.astype(np.float64).T @ x.astype(np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    assert gram_ref.gaps(torch.from_numpy(want), got)["gram_gap"] < 1e-12
    fp8 = gram_ref.solve(_ctx(), {"x": torch.from_numpy(x)}, 0, "fp8")
    assert 1e-4 < gram_ref.gaps(fp8, got)["gram_gap"] < 0.1


@pytest.mark.parametrize("k", [0, 1])
def test_fit_reference_is_float64_numpy_newton(monkeypatch, k):
    x, y = _data()
    monkeypatch.setattr(fit_ref, "ROWS", 1000)
    ctx = _ctx(fit={"max_iter": 8, "tol": 0.0})
    inputs = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    got = fit_ref.solve(ctx, inputs, k, "float64")
    assert len(got) == 8
    for m in (1, 2, 8):
        want = _newton_numpy(x, y[k].astype(np.float64), m)
        np.testing.assert_allclose(fit_ref.at(got, m).numpy(), want,
                                   rtol=1e-9, atol=1e-12)
        assert fit_ref.gaps(torch.from_numpy(want), got, m)[
            f"step{m}_gap"] < 1e-9
    assert fit_ref.gaps(torch.from_numpy(want), got)["beta_gap"] < 1e-9


def test_fit_reference_freezes_once_the_gradient_meets_tol():
    x, y = _data(n=500, d=3)
    inputs = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    one = fit_ref.solve(_ctx(fit={"max_iter": 1, "tol": 0.0}), inputs, 0,
                        "float64")
    frozen = fit_ref.solve(_ctx(fit={"max_iter": 30, "tol": 1e9}), inputs,
                           0, "float64")
    assert len(one) == len(frozen) == 1
    assert torch.equal(fit_ref.at(one), fit_ref.at(frozen, 2))
