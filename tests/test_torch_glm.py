"""The slice as a whole: X.T @ X and Newton logistic regression, against
nums_tpu, at n = 2048, d = 96.

(a) The kernel route. The port runs its default precision (the kernels'
    plain versions on the CPU); nums_tpu runs its Pallas kernels in
    interpret mode on a lane-padded buffer, as
    tests/core/array/test_lane_pad.py:85-116 does. Both are in the bf16-MAC
    class, where eta uses bf16(beta): each fit pins beta only to about one
    bf16 ulp (2^-8 = 3.9e-3 relative), so beta agrees to 1e-2 of max|beta|,
    the labels on all but points within that margin of the boundary
    (>= 98%), and X.T @ X to the reference's 2e-3.
(b) ``matmul_precision="highest"``: plain float32 on both sides (nums_tpu's
    default CPU path): beta and probabilities to 1e-5 of their largest
    magnitude, labels exactly; float64 to 1e-10.
(c) A model fitted by nums_tpu, loaded with ``from_reference_params``,
    predicts the same labels.
"""

import json

import jax
import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, jax_app, rel_err, spy_calls, torch_app,
)

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
from nums_tpu_torch.models.glms import GLM, LogisticRegression

N, D = 2048, 96
FIT = dict(solver="newton", tol=1e-8, max_iter=10)


def _data(dtype=np.float32, seed=3):
    rs = np.random.RandomState(seed)
    X = rs.randn(N, D).astype(dtype)
    w = 0.3 * rs.randn(D)
    p = 1.0 / (1.0 + np.exp(-(X.astype(np.float64) @ w)))
    y = (p > rs.rand(N)).astype(dtype)
    return X, y


def _beta(model):
    return np.append(model._beta.get(), model._beta0.get())


def _fit(glms, app, X, y, **kw):
    bx = app.array(X, block_shape=(N, D))
    by = app.array(y, block_shape=(N,))
    return glms.LogisticRegression(**{**FIT, **kw}).fit(bx, by), bx, by


@pytest.fixture()
def padded_jax_app(monkeypatch):
    """nums_tpu with at-rest lane padding and the Pallas gram forced on
    (interpret mode on the CPU): its kernel route."""
    from nums_tpu.core import application_manager, settings as jsettings

    monkeypatch.setattr(jsettings, "lane_pad", True)
    monkeypatch.setattr(jsettings, "lane_pad_min", 8)
    monkeypatch.setattr(jsettings, "backend_name", "serial")
    monkeypatch.setenv("NUMS_TPU_PALLAS_GRAM", "1")
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()
    # The reference's jitted fit is cached by shape: drop it, so that a
    # later test that spies on the trace (test_lane_pad.py) retraces.
    jax.clear_caches()


def test_kernel_route_matches_pallas_route(padded_jax_app, torch_app,
                                           spy_calls):
    from nums_tpu.core.ops import pallas_gram, pallas_newton
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    X, y = _data()
    assert settings.matmul_precision == "default"
    grams = spy_calls(cuda_gram, "gram")
    stats = spy_calls(cuda_newton, "stats")

    ref, rbx, _ = _fit(jglms, padded_jax_app, X, y)
    got, tbx, _ = _fit(tglms, torch_app, X, y)
    # The reference took its Pallas route: a lane-padded buffer and both
    # kernels on (glms.py:272-287, fast_glm.py:73-79).
    assert tuple(rbx.raw.shape) == (N, 128)
    assert pallas_gram.enabled() and pallas_newton.enabled()
    assert pallas_newton.supported((N, 128), np.float32)
    # The port went through its kernel functions: the Newton statistics
    # of every iteration (10, with tol unreachable in the bf16 class).
    assert len(stats) == FIT["max_iter"]
    assert all(tuple(a[0].shape) == (N, D + 1) and a[3] == "logistic"
               for a in stats)
    assert rel_err(_beta(got), _beta(ref)) < 1e-2
    agree = np.mean(got.predict(tbx).get() == ref.predict(rbx).get())
    assert agree >= 0.98, agree

    g, rg = tbx.T @ tbx, rbx.T @ rbx
    assert len(grams) == 1 and tuple(grams[0][0].shape) == (N, D)
    assert rel_err(g.get(), rg.get()) < GRAM_BF16_REL
    assert np.array_equal(g.get(), g.get().T)


@pytest.mark.parametrize(
    "dtype,tol,penalty",
    [(np.float32, 1e-5, "none"), (np.float32, 1e-5, "l2"),
     (np.float64, 1e-10, "none")],
)
def test_highest_matches_default_cpu_path(jax_app, torch_app, monkeypatch,
                                          spy_calls, dtype, tol, penalty):
    from nums_tpu.models import glms as jglms
    from nums_tpu_torch.models import glms as tglms

    monkeypatch.setattr(settings, "matmul_precision", "highest")
    grams = spy_calls(cuda_gram, "gram")
    stats = spy_calls(cuda_newton, "stats")
    X, y = _data(dtype)
    kw = dict(penalty=penalty, C=0.5)
    ref, rbx, rby = _fit(jglms, jax_app, X, y, **kw)
    got, tbx, tby = _fit(tglms, torch_app, X, y, **kw)
    assert not grams and not stats  # plain ops only
    assert got._beta.dtype == ref._beta.dtype == dtype
    assert rel_err(_beta(got), _beta(ref)) < tol
    assert np.array_equal(got.predict(tbx).get(), ref.predict(rbx).get())
    assert rel_err(got.predict_proba(tbx).get(),
                   ref.predict_proba(rbx).get()) < tol
    assert float(got.score(tbx, tby)) == pytest.approx(
        float(ref.score(rbx, rby)), abs=0.0)


@pytest.mark.parametrize("penalty", ["none", "l2"])
def test_from_reference_params(jax_app, torch_app, tmp_path, penalty):
    from nums_tpu.models import glms as jglms

    X, y = _data(np.float64, seed=5)
    ref, rbx, _ = _fit(jglms, jax_app, X, y, penalty=penalty, C=0.5)
    ref.save(str(tmp_path / "model"))
    with open(tmp_path / "model" / "model.json") as f:
        meta = json.load(f)
    arrays = {"beta": ref._beta.get(), "beta0": ref._beta0.get()}
    if ref._lambda_vec is not None:
        arrays["lambda_vec"] = ref._lambda_vec.get()
    model = GLM.from_reference_params(meta, arrays)
    assert isinstance(model, LogisticRegression)
    assert model._penalty == ref._penalty and model._tol == ref._tol
    assert (model._lambda_vec is None) == (penalty == "none")
    tbx = torch_app.array(X, block_shape=(N, D))
    assert np.array_equal(model.predict(tbx).get(), ref.predict(rbx).get())
    assert rel_err(model.predict_proba(tbx).get(),
                   ref.predict_proba(rbx).get()) < 1e-12


def test_unported_options_raise(torch_app):
    bx = torch_app.array(np.ones((4, 2)), block_shape=(4, 2))
    with pytest.raises(ValueError, match="fit must be called"):
        LogisticRegression().predict(bx)
    with pytest.raises(NotImplementedError):
        LogisticRegression(solver="lbfgs")
    with pytest.raises(NotImplementedError):
        LogisticRegression(penalty="l1")


def test_posdef_solve_matches_reference(jax_app):
    """A positive-definite system solves as the reference's; one that is
    not gives NaN there and here, with no host sync to raise."""
    import jax.numpy as jnp
    import torch

    from nums_tpu.models import fast_glm as jfast
    from nums_tpu_torch.models import fast_glm as tfast

    rs = np.random.RandomState(0)
    m = rs.randn(6, 6)
    b = rs.randn(6)
    pd, not_pd = m @ m.T + 6 * np.eye(6), m + m.T - 20 * np.eye(6)
    got = tfast._posdef_solve(torch.from_numpy(pd), torch.from_numpy(b))
    ref = jfast._posdef_solve(jnp.asarray(pd), jnp.asarray(b))
    assert rel_err(got, np.asarray(ref)) < 1e-12
    got = tfast._posdef_solve(torch.from_numpy(not_pd), torch.from_numpy(b))
    ref = jfast._posdef_solve(jnp.asarray(not_pd), jnp.asarray(b))
    assert np.isnan(np.asarray(ref)).all() and torch.isnan(got).all()
