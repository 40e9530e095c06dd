"""Fused Newton training for GLMs.

Counterpart of ``nums_tpu/models/fast_glm.py:23-196`` and
``glm_forward``/``logistic_predict_label`` (:487-498). The whole Newton
loop runs on the device with no host sync per iteration, as the
reference's ``lax.while_loop`` does: ``newton_fit`` always runs
``max_iter`` steps and freezes ``beta``, ``gmax`` and ``it`` with
``torch.where`` once ``gmax <= tol``. With ``kernels=True`` (the caller's
opt-in, as the reference's ``pallas=True``) the statistics ride the
Hopper kernels (``cuda_newton``, ``cuda_gram``).

The solve uses ``torch.linalg.cholesky_ex(check_errors=False)``, which
reports a matrix that is not positive definite on the device instead of
syncing with the host to raise; the factor is then set to NaN, as
``jnp.linalg.cholesky`` returns it.
"""

import torch

from nums_tpu_torch.core.ops import cuda_gram, cuda_newton


def _posdef_solve(a, b):
    chol, info = torch.linalg.cholesky_ex(a, check_errors=False)
    chol = torch.where(info == 0, chol, float("nan"))
    return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)


def _gram(X, s=None, kernels=False):
    """H = Xᵀ diag(s) X (or XᵀX when ``s`` is None); with ``kernels`` it
    rides the symmetric gram kernel, the weight fused into the kernel."""
    if kernels:
        return cuda_gram.gram(X, s)
    Xw = X if s is None else X * s[:, None]
    return Xw.T @ X


def _newton_stats(kind, X, y, beta, kernels):
    """(g, H) for one Newton iteration: the Newton-stats kernel when it is
    enabled, else the plain eta/g chain with the Hessian on the gram
    kernel (``kernels``) or plain ops."""
    if kernels and cuda_newton.enabled() and cuda_newton.supported(
        tuple(X.shape), X.dtype
    ):
        return cuda_newton.stats(X, y, beta, kind)
    if kind == "logistic":
        mu = torch.sigmoid(X @ beta)
        s = mu * (1.0 - mu)
    elif kind == "linear":
        mu = X @ beta
        s = None  # H = XᵀX
    elif kind == "poisson":
        mu = torch.exp(X @ beta)
        s = mu
    else:
        raise ValueError(kind)
    g = X.T @ (mu - y)
    return g, _gram(X, s, kernels=kernels)


def logistic_newton_step(X, y, beta, kernels=False):
    """One Newton step of logistic regression: mu = sigmoid(X beta);
    g = Xᵀ(mu - y); H = Xᵀ S X; beta' = beta - H⁻¹ g."""
    g, H = _newton_stats("logistic", X, y, beta, kernels)
    return beta - _posdef_solve(H, g), g


def linear_newton_step(X, y, beta, kernels=False):
    g, H = _newton_stats("linear", X, y, beta, kernels)
    return beta - _posdef_solve(H, g), g


def poisson_newton_step(X, y, beta, kernels=False):
    g, H = _newton_stats("poisson", X, y, beta, kernels)
    return beta - _posdef_solve(H, g), g


def _newton_step_penalized(kind, X, y, beta, lambda_vec, kernels=False):
    """One Newton step with l2 penalty: g += λ∘β; H += diag(λ)."""
    g, H = _newton_stats(kind, X, y, beta, kernels)
    if lambda_vec is not None:
        g = g + lambda_vec * beta
        H = H + torch.diag(lambda_vec)
    return beta - _posdef_solve(H, g), g


def newton_fit(X, y, beta0, tol, kind="logistic", max_iter=10,
               penalized=False, lambda_vec=None, kernels=False):
    """Newton training with on-device convergence, as the reference's
    ``lax.while_loop`` (max|g| <= tol after each update). No host sync:
    every one of ``max_iter`` steps runs, and each output is frozen by
    ``torch.where`` once converged. Returns ``(beta, gmax, it)``."""
    lv = lambda_vec if penalized else None
    dev = X.device
    beta = beta0
    gmax = torch.full((), float("inf"), dtype=X.dtype, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    tol = torch.as_tensor(tol, dtype=X.dtype, device=dev)
    for _ in range(int(max_iter)):
        active = gmax > tol
        new_beta, g = _newton_step_penalized(kind, X, y, beta, lv,
                                             kernels=kernels)
        beta = torch.where(active, new_beta, beta)
        gmax = torch.where(active, g.abs().max(), gmax)
        it = it + active.to(torch.int32)
    return beta, gmax, it


def glm_forward(X, beta, beta0, kind="logistic"):
    eta = X @ beta + beta0
    if kind == "logistic":
        return torch.sigmoid(eta)
    if kind == "poisson":
        return torch.exp(eta)
    return eta


def logistic_predict_label(X, beta, beta0):
    return (torch.sigmoid(X @ beta + beta0) > 0.5).to(torch.int32)
