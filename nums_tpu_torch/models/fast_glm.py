"""Fused GLM solvers: Newton, BFGS and ADMM.

Counterpart of ``nums_tpu/models/fast_glm.py``. Each function returns
what its reference returns.

* ``newton_fit`` runs the whole Newton loop on the device with no host
  sync per iteration, as the reference's ``lax.while_loop`` does: it
  always runs ``max_iter`` steps and freezes ``beta``, ``gmax`` and ``it``
  with ``torch.where`` once ``gmax <= tol``. With ``kernels=True`` (the
  caller's opt-in, as the reference's ``pallas=True``) the statistics ride
  the Hopper kernels (``cuda_newton``, ``cuda_gram``): X is staged once
  (``cuda_newton.prepare``), and every iteration reads the staged copy.
* ``bfgs_fit`` is the algorithm of ``jax.scipy.optimize.minimize(method=
  "BFGS")`` written in torch; ``admm_fit`` and ``admm_fit_gram`` are the
  reference's ADMM loops. These three test their loop conditions on the
  host (see each docstring): the vectors stay on the device, and only
  scalars cross.
* ``newton_fit_ooc`` trains on a DiskArray, streaming its row panels
  through the device once per iteration (K3 per panel on the card).
* ``newton_fit_mesh`` is ``newton_fit`` on the mesh backend: each process
  runs the statistics on its own rows and one all-reduce joins them.

The solves use ``core/ops/linalg.posdef_solve`` (``cholesky_ex``): NaN for
a matrix that is not positive definite, as ``jnp.linalg.cholesky``
returns it, and no host sync.
"""

import math

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess, trace
from nums_tpu_torch.core.ops import cuda_gram, cuda_newton, summa
from nums_tpu_torch.core.ops.linalg import posdef_solve as _posdef_solve


def _gram(X, s=None, kernels=False):
    """H = Xᵀ diag(s) X (or XᵀX when ``s`` is None); with ``kernels`` it
    rides the symmetric gram kernel, the weight fused into the kernel."""
    if kernels:
        return cuda_gram.gram(X, s)
    Xw = X if s is None else X * s[:, None]
    return Xw.T @ X


def _newton_kernel(X, kernels):
    """Whether the statistics take the Newton-stats kernel."""
    return kernels and cuda_newton.enabled() and cuda_newton.supported(
        tuple(X.shape), X.dtype
    )


def _newton_stats(kind, X, y, beta, kernels):
    """(g, H) for one Newton iteration: the Newton-stats kernel for a
    staged X (``cuda_newton.Staged``) or when it is enabled, else the
    plain eta/g chain with the Hessian on the gram kernel (``kernels``)
    or plain ops."""
    if isinstance(X, cuda_newton.Staged) or _newton_kernel(X, kernels):
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


_STEPS = {
    "logistic": logistic_newton_step,
    "linear": linear_newton_step,
    "poisson": poisson_newton_step,
}


def _newton_step_penalized(kind, X, y, beta, lambda_vec, kernels=False,
                           reduce=None):
    """One Newton step with l2 penalty: g += λ∘β; H += diag(λ). On the mesh
    ``reduce`` sums the (g, H) of each process's rows over the processes
    (one all-reduce) before the penalty and the solve."""
    g, H = _newton_stats(kind, X, y, beta, kernels)
    if reduce is not None:
        g, H = reduce(g, H)
    if lambda_vec is not None:
        g = g + lambda_vec * beta
        H = H + torch.diag(lambda_vec)
    with trace.span("nums.newton.solve"):
        return beta - _posdef_solve(H, g), g


def newton_fit(X, y, beta0, tol, kind="logistic", max_iter=10,
               penalized=False, lambda_vec=None, kernels=False, reduce=None):
    """Newton training with on-device convergence, as the reference's
    ``lax.while_loop`` (max|g| <= tol after each update). No host sync:
    every one of ``max_iter`` steps runs, and each output is frozen by
    ``torch.where`` once converged. On the Newton-stats kernel X is
    staged once, before the loop, and the staged copy is freed when the
    fit returns. With ``reduce`` (``newton_fit_mesh``) X and y are one
    process's rows and each step's statistics are summed over the
    processes. Returns ``(beta, gmax, it)``. Counts ``max_iter`` in the
    trace's ``newton.steps_run`` and ``it``, on the device, in
    ``newton.steps_useful``."""
    with trace.span("nums.newton.fit"):
        lv = lambda_vec if penalized else None
        dev = X.device
        beta = beta0
        gmax = torch.full((), float("inf"), dtype=X.dtype, device=dev)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        tol = torch.as_tensor(tol, dtype=X.dtype, device=dev)
        Xs = X
        if _newton_kernel(X, kernels):
            with trace.span("nums.newton.stage"):
                Xs = cuda_newton.prepare(X)
        for _ in range(int(max_iter)):
            with trace.span("nums.newton.step"):
                active = gmax > tol
                new_beta, g = _newton_step_penalized(
                    kind, Xs, y, beta, lv, kernels=kernels, reduce=reduce)
                beta = torch.where(active, new_beta, beta)
                gmax = torch.where(active, g.abs().max(), gmax)
                it = it + active.to(torch.int32)
        trace.count("newton.steps_run", int(max_iter))
        trace.count("newton.steps_useful", it)
    return beta, gmax, it


def newton_fit_mesh(X, y, beta0, tol, kind="logistic", max_iter=10,
                    penalized=False, lambda_vec=None, kernels=False):
    """``newton_fit`` on the mesh: X (n, d) and y (n,) are DTensors,
    ``beta0`` and ``lambda_vec`` replicated ones. Each process stages its
    own rows once and runs the statistics (K3 on the card) on them; one
    all-reduce (SUM) of g and H, packed in one buffer, over the mesh
    dimensions that shard the rows follows each call; the Newton solve is
    replicated, the same on every process (the reference keeps β, g and H
    replicated). Returns ``(beta, gmax, it)`` as whole tensors, the same on
    every process."""
    with trace.span("nums.newton.mesh_operands"):
        rows = summa.row_layout(X)
        Xl, yl = summa.local_part(X, rows), summa.local_part(y, rows)
        lv = lambda_vec.full_tensor() if lambda_vec is not None else None
        b0 = beta0.full_tensor()
    kernels = kernels and cuda_gram.supported(tuple(Xl.shape), Xl.dtype)
    return newton_fit(Xl, yl, b0, tol, kind=kind, max_iter=max_iter,
                      penalized=penalized, lambda_vec=lv, kernels=kernels,
                      reduce=mesh_reduce(X.device_mesh, rows))


def mesh_rows(X, y, beta0, lambda_vec):
    """A row-sharded fit's operands on this process: X's and y's rows (each
    process's rows, every column), β₀ and λ whole, and the sum over the
    processes that hold other rows (``summa.all_reduce_rows``)."""
    rows = summa.row_layout(X)
    lv = lambda_vec.full_tensor() if lambda_vec is not None else None
    b0 = beta0.full_tensor() if hasattr(beta0, "full_tensor") else beta0
    return (summa.local_part(X, rows), summa.local_part(y, rows), b0, lv,
            lambda t: summa.all_reduce_rows(X.device_mesh, rows, t))


def bfgs_fit_mesh(X, y, beta0, tol, **kwargs):
    """``bfgs_fit`` on the mesh: each process's rows, the objective and
    gradient summed over the processes (two all-reduces an evaluation);
    the carry is whole, the same on every process."""
    Xl, yl, b0, lv, reduce = mesh_rows(X, y, beta0,
                                       kwargs.pop("lambda_vec", None))
    return bfgs_fit(Xl, yl, b0, tol, lambda_vec=lv, reduce=reduce, **kwargs)


def admm_fit_mesh(X, y, beta0, tol, **kwargs):
    """``admm_fit`` on the mesh: each process's rows, XᵀX and Xᵀy (or each
    Newton step's g and H) summed over the processes; the carry is whole,
    the same on every process."""
    Xl, yl, b0, lv, reduce = mesh_rows(X, y, beta0,
                                       kwargs.pop("lambda_vec", None))
    return admm_fit(Xl, yl, b0, tol, lambda_vec=lv, reduce=reduce, **kwargs)


def mesh_reduce(mesh, rows):
    """(g, H) -> their sums over the processes that hold other rows
    (``rows``: ``summa.row_layout``'s placements): one all-reduce of g and
    H packed in one buffer."""

    def reduce(g, H):
        d = g.shape[0]
        packed = summa.all_reduce_rows(
            mesh, rows, torch.cat([g.reshape(-1), H.reshape(-1)]))
        return packed[:d], packed[d:].reshape(H.shape)

    return reduce


def newton_train(X, y, beta0, kind="logistic", num_iters=10):
    """Fixed-iteration Newton training; convergence is checked after.
    Returns ``(beta, gmax)`` with ``gmax`` of shape (num_iters,), max|g|
    of each step, as the reference's ``lax.scan``."""
    step = _STEPS[kind]
    beta, gmax = beta0, []
    for _ in range(int(num_iters)):
        beta, g = step(X, y, beta)
        gmax.append(g.abs().max())
    return beta, torch.stack(gmax)


def _objective(kind, X, y, beta, lambda_vec):
    eta = X @ beta
    if kind == "logistic":
        # Σ softplus(-(2y-1)·eta): numerically stable NLL.
        z = torch.where(y > 0.5, -eta, eta)
        obj = torch.sum(torch.logaddexp(z, z.new_zeros(())))
    elif kind == "linear":
        obj = 0.5 * torch.sum((y - eta) ** 2)
    elif kind == "poisson":
        obj = torch.sum(torch.exp(eta) - y * eta)
    else:
        raise ValueError(kind)
    if lambda_vec is not None:
        obj = obj + 0.5 * torch.sum(lambda_vec * beta * beta)
    return obj


# -- BFGS (the algorithm of jax/_src/scipy/optimize/bfgs.py and
#    line_search.py: Nocedal & Wright, Algorithms 6.1, 3.5 and 3.6) --------


def _value_and_grad(kind, X, y, lambda_vec,
                    reduce=multiprocess.one_process):
    """f(b) -> (objective, gradient) of ``_objective``, the gradient in
    closed form. The objective's sum accumulates in float64, so a float32
    objective over millions of rows keeps the digits that the line
    search's tests compare (the reference sums in X's dtype). With
    ``reduce`` (on the mesh: X and y are one process's rows) the row sums
    are summed over the processes before the penalty."""
    f64 = torch.float64

    def value_and_grad(b):
        eta = X @ b
        if kind == "logistic":
            pos = y > 0.5
            z = torch.where(pos, -eta, eta)
            phi = torch.logaddexp(z, z.new_zeros(())).sum(dtype=f64)
            deta = torch.where(pos, -torch.sigmoid(-eta), torch.sigmoid(eta))
        elif kind == "linear":
            deta = eta - y
            phi = 0.5 * (deta * deta).sum(dtype=f64)
        elif kind == "poisson":
            mu = torch.exp(eta)
            phi = (mu - y * eta).sum(dtype=f64)
            deta = mu - y
        else:
            raise ValueError(kind)
        g = X.T @ deta
        phi, g = reduce(phi.reshape(1))[0], reduce(g)
        if lambda_vec is not None:
            phi = phi + 0.5 * (lambda_vec * b * b).sum(dtype=f64)
            g = g + lambda_vec * b
        return phi, g

    return value_and_grad


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2 = (fb - fa - C * db, fc - fa - C * dc)
    A = (dc ** 2 * d2[0] - db ** 2 * d2[1]) / denom
    B = (-dc ** 3 * d2[0] + db ** 3 * d2[1]) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom(restricted, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi,
          phi_hi, dphi_hi, g_0):
    """Zoom of the strong-Wolfe line search (Nocedal & Wright, Alg. 3.6):
    cubic, quadratic or bisection trial steps, as line_search.py:84-225
    of jax. Returns (failed, a_star, phi_star, g_star)."""
    done = failed = False
    j = 0
    a_rec, phi_rec = (a_lo + a_hi) / 2.0, (phi_lo + phi_hi) / 2.0
    a_star, phi_star, g_star = np.float64(1.0), phi_lo, g_0
    while not done and not failed:
        dalpha = a_hi - a_lo
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        # |a_hi - a_lo|: jax tests a_hi - a_lo, which is negative for the
        # reversed bracket of the second zoom call, and so reports a
        # failure whenever that zoom runs.
        failed = bool(abs(dalpha) <= 1e-10)
        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec,
                              phi_rec)
        use_cubic = j > 0 and a + cchk < a_j_cubic < b - cchk
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi)
        use_quad = not use_cubic and a + qchk < a_j_quad < b - qchk
        if use_cubic:
            a_j = a_j_cubic
        elif use_quad:
            a_j = a_j_quad
        else:
            a_j = (a_lo + a_hi) / 2.0
        phi_j, dphi_j, g_j = restricted(a_j)
        hi_to_j = wolfe_one(a_j, phi_j) or phi_j >= phi_lo
        star_to_j = wolfe_two(dphi_j) and not hi_to_j
        hi_to_lo = (dphi_j * (a_hi - a_lo) >= 0.0 and not hi_to_j
                    and not star_to_j)
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_j, phi_j, dphi_j
        if star_to_j:
            done = True
            a_star, phi_star, g_star = a_j, phi_j, g_j
        if hi_to_lo:
            a_rec, phi_rec = a_hi, phi_hi
            a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
        elif lo_to_j:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return failed, a_star, phi_star, g_star


def _line_search(value_and_grad, xk, pk, old_fval, old_old_fval, gfk,
                 c1=1e-4, c2=0.9, maxiter=10):
    """Inexact line search under the strong Wolfe conditions (Nocedal &
    Wright, Alg. 3.5), as jax's line_search.py:268-438. Returns
    (failed, step, f at the step, gradient at the step).

    Its scalars (f, the directional derivative, the steps) are float64
    whatever X's dtype, so it takes jax's 64-bit constants: the zoom
    gives up below a bracket of 1e-10 and no step is floored. jax runs a
    float32 problem's search in float32, with a 1e-5 bracket floor; at
    millions of rows the first step, about 1/‖g‖, is far below it, and
    the search would fail at once."""

    def restricted(t):
        phi, g = value_and_grad(xk + float(t) * pk)
        phi, dphi = torch.stack([phi, (g @ pk).to(phi.dtype)]).tolist()
        return np.float64(phi), np.float64(dphi), g

    phi_0 = old_fval
    dphi_0 = np.float64((gfk @ pk).item())
    start = 1.01 * 2 * (phi_0 - old_old_fval) / dphi_0
    start = np.float64(1.0) if start > 1 else start

    def wolfe_one(a_i, phi_i):
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return abs(dphi_i) <= -c2 * dphi_0

    done = failed = False
    i = 1
    a_prev, phi_prev, dphi_prev = np.float64(0.0), phi_0, dphi_0
    a_star, phi_star, g_star = np.float64(0.0), phi_0, gfk
    while not done and i <= maxiter and not failed:
        a_i = start if i == 1 else a_prev * 2.0
        phi_i, dphi_i, g_i = restricted(a_i)
        if wolfe_one(a_i, phi_i) or (phi_i >= phi_prev and i > 1):
            done = True
            failed, a_star, phi_star, g_star = _zoom(
                restricted, wolfe_one, wolfe_two, a_prev, phi_prev,
                dphi_prev, a_i, phi_i, dphi_i, gfk)
        elif wolfe_two(dphi_i):
            done = True
            a_star, phi_star, g_star = a_i, phi_i, g_i
        elif dphi_i >= 0.0:
            done = True
            failed, a_star, phi_star, g_star = _zoom(
                restricted, wolfe_one, wolfe_two, a_i, phi_i, dphi_i,
                a_prev, phi_prev, dphi_prev, gfk)
        i += 1
        a_prev, phi_prev, dphi_prev = a_i, phi_i, dphi_i
    return failed or not done, a_star, phi_star, g_star


def bfgs_fit(X, y, beta0, tol, kind="logistic", max_iter=100,
             penalized=False, lambda_vec=None,
             reduce=multiprocess.one_process):
    """Quasi-Newton fit: the BFGS algorithm of the reference's
    ``jax.scipy.optimize.minimize(method="BFGS")`` (inverse-Hessian
    update, kept where 1/(yᵀs) is not finite; a zoom line search under
    the strong Wolfe conditions with at most 10 trials; stop on
    ‖g‖∞ < tol, a failed line search or ``max_iter`` iterations).

    One departure: the initial inverse Hessian, the identity, is rescaled
    by yᵀs/yᵀy before the first update. The GLM objectives sum over rows,
    so their Hessians are of the order of n; from the bare identity BFGS
    learns that scale one direction per iteration (about d iterations:
    340 for a 200k x 500 logistic problem in float64), and a float32 line
    search runs out of digits first. Rescaled, the same problem takes 9.
    The zoom's bracket test is repaired to match (see ``_zoom``): better
    scaled steps overshoot more often, and jax's test fails every search
    that overshoots on its first trial.

    Vectors and the inverse Hessian stay on X's device. The line search's
    tests run on the host: each objective evaluation syncs once (its value
    and directional derivative), and each iteration once more (its
    convergence test). Iterates need not match the reference's step for
    step (its sums run in another order); the optimum does."""
    lv = lambda_vec if penalized else None
    value_and_grad = _value_and_grad(kind, X, y, lv, reduce)
    d = beta0.shape[0]
    eye = torch.eye(d, dtype=beta0.dtype, device=beta0.device)
    x = beta0
    f, g = value_and_grad(x)
    f = np.float64(f.item())
    H = eye
    old_old_fval = f + torch.linalg.vector_norm(g).item() / 2
    converged = g.abs().max().item() < tol
    failed, k = False, 0
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        while not converged and not failed and k < max_iter:
            p = -(H @ g)
            failed, a_k, f_new, g_new = _line_search(
                value_and_grad, x, p, f, old_old_fval, g)
            s = float(a_k) * p
            y_k = g_new - g
            rho = torch.reciprocal(y_k @ s)
            if k == 0:
                # H0 = (yᵀs / yᵀy)·I before the first update (Nocedal &
                # Wright, eq. 6.20), which jax's BFGS leaves out.
                H = torch.where(torch.isfinite(rho),
                                (y_k @ s) / (y_k @ y_k) * eye, H)
            w = eye - rho * torch.outer(s, y_k)
            H_new = w @ H @ w.T + rho * torch.outer(s, s)
            H = torch.where(torch.isfinite(rho), H_new, H)
            converged = g_new.abs().max().item() < tol
            k += 1
            old_old_fval = f
            x, f, g = x + s, f_new, g_new
    return x


def _soft_threshold(v, k):
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - k, 0.0)


def _z_update(penalty, lv, l1_ratio):
    """The proximal operator of the penalty, as a function of (β + u, ρ)."""
    if penalty == "l1":
        return lambda bu, rho: _soft_threshold(bu, lv / rho)
    if penalty == "l2":
        return lambda bu, rho: rho * bu / (lv + rho)
    if penalty == "elasticnet":
        # prox of λ(α‖z‖₁ + (1−α)/2 ‖z‖²): soft-threshold then shrink
        # (sklearn l1_ratio convention, α = l1_ratio).
        a = float(l1_ratio)
        return lambda bu, rho: (_soft_threshold(bu, lv * a / rho)
                                / (1.0 + lv * (1.0 - a) / rho))
    return lambda bu, rho: bu


def _admm_loop(beta_update, z_update, beta0, tol, max_iter, rho):
    """The ADMM iteration of both entry points: β-update, prox z-update,
    scaled dual u, and residual balancing of ρ (×2 when the primal
    residual leads 10×, ÷2 when the dual does, u rescaled by ρ/ρ_new).
    The loop condition is tested on the host, once per iteration.
    Returns (β, z, residual, iterations)."""
    dt, dev = beta0.dtype, beta0.device
    rho = torch.as_tensor(rho, dtype=dt, device=dev)
    inf = torch.full((), math.inf, dtype=dt, device=dev)
    beta, z, u, r, s = beta0, beta0, torch.zeros_like(beta0), inf, inf
    it = 0
    while it < max_iter and bool(torch.maximum(r, s) > tol):
        beta = beta_update(beta, z - u, rho)
        z_new = z_update(beta + u, rho)
        u = u + beta - z_new
        r = torch.max(torch.abs(beta - z_new))
        s = torch.max(torch.abs(rho * (z_new - z)))
        rho_new = torch.where(
            r > 10.0 * s, rho * 2.0, torch.where(s > 10.0 * r, rho * 0.5, rho)
        )
        u = u * (rho / rho_new)
        z, rho = z_new, rho_new
        it += 1
    return beta, z, torch.maximum(r, s), torch.tensor(
        it, dtype=torch.int32, device=dev)


def admm_fit_gram(G, q0, beta0, tol, max_iter=100, rho=1.0,
                  penalty="l1", lambda_vec=None, l1_ratio=0.5):
    """Linear-kind ADMM from precomputed normal-equation moments
    (G = XᵀX, q0 = Xᵀy): the loop touches only (d, d) state. Same math as
    ``admm_fit(kind="linear")``, which hoists exactly these moments.
    Returns (z, residual, iterations)."""
    d = beta0.shape[0]
    lv = lambda_vec if lambda_vec is not None else torch.zeros_like(beta0)
    eye = torch.eye(d, dtype=G.dtype, device=G.device)

    def beta_update(beta, v, rho):
        del beta
        return _posdef_solve(G + rho * eye, q0 + rho * v)

    _, z, res, it = _admm_loop(beta_update, _z_update(penalty, lv, l1_ratio),
                               beta0, tol, max_iter, rho)
    return z, res, it


def admm_fit(X, y, beta0, tol, kind="linear", max_iter=100, rho=1.0,
             penalty="l1", lambda_vec=None, newton_steps=5, l1_ratio=0.5,
             reduce=multiprocess.one_process):
    """ADMM GLM fit (Boyd et al. 2011, §6.4/§8): split min f(β) + g(z)
    s.t. β = z; the β-update minimizes f(β) + ρ/2‖β − z + u‖², the
    z-update is the proximal operator of g (soft-threshold for l1,
    scaling for l2, both for elasticnet).

    For the linear kind XᵀX and Xᵀy are computed once, before the loop,
    and each iteration solves against the (d, d) augmented Gram. For
    logistic/poisson the β-update runs ``newton_steps`` undamped Newton
    steps on the ρ-augmented objective. The loop condition is tested on
    the host, once per iteration (the reference's ``while_loop`` tests
    it on the device).

    Returns (z, residual, iterations); z is the proximal iterate (exactly
    sparse under l1). ``lambda_vec`` is per-coordinate λ: coordinates with
    λ_j = 0 (the intercept under the sklearn aliases) pass the prox
    unpenalized. With ``reduce`` (on the mesh: X and y are one process's
    rows) every row sum (XᵀX and Xᵀy, each Newton step's g and H) is summed
    over the processes."""
    d = beta0.shape[0]
    lv = lambda_vec if lambda_vec is not None else torch.zeros_like(beta0)
    eye = torch.eye(d, dtype=X.dtype, device=X.device)

    if kind == "linear":
        G = reduce(X.T @ X)
        q0 = reduce(X.T @ y)

        def beta_update(beta, v, rho):
            del beta
            return _posdef_solve(G + rho * eye, q0 + rho * v)

    elif kind in ("logistic", "poisson"):

        def beta_update(beta, v, rho):
            b = beta
            for _ in range(int(newton_steps)):
                if kind == "logistic":
                    mu = torch.sigmoid(X @ b)
                    s = mu * (1.0 - mu)
                else:
                    mu = torch.exp(X @ b)
                    s = mu
                g = reduce(X.T @ (mu - y)) + rho * (b - v)
                H = reduce((X * s[:, None]).T @ X) + rho * eye
                b = b - _posdef_solve(H, g)
            return b

    else:
        raise ValueError(kind)

    _, z, res, it = _admm_loop(beta_update, _z_update(penalty, lv, l1_ratio),
                               beta0, tol, max_iter, rho)
    return z, res, it


def newton_fit_ooc(X_disk, y, tol, kind="logistic", max_iter=10,
                   penalized=False, lambda_vec=None, dtype=None):
    """Newton GLM training on an out-of-core design matrix (a DiskArray).

    Each iteration streams the row panels through the device: each panel
    moves as it is and is intercept-augmented there (``ooc_put``), and
    ``streaming.glm_stats_update_aug`` adds its g and H to in-place
    accumulators (K3 in its one-shot form where its gate is on; device
    memory: one panel and (d+1)² statistics); then one Newton step on the
    device. The convergence test is one host sync per pass,
    ``float(gmax) <= tol``, as the reference's, so the iteration counts
    agree. beta, g and H have width d + 1: the kernels pad inside their
    staging pass, and no lane padding is needed.

    On the mesh the carry (beta, λ, g, H) is replicated: each process
    augments its own rows of each panel on its device and adds their
    statistics (K3 one-shot on each card's rows), one all-reduce of g and
    H packed in one buffer ends each pass (as ``newton_fit_mesh`` does a
    step), and the Newton step is the same on every process.

    y: a host array, a BlockArray (fetched to the host once), or a 1-D
    DiskArray with X's row partitioning. Returns (beta with the intercept
    last, max|g|, iterations); the iterations count in the trace's
    ``newton.steps_run`` and ``newton.steps_useful`` alike (the loop stops
    at convergence)."""
    from nums_tpu_torch.core.array.application import (
        _device_dtype, _ooc_y_getter, ooc_accumulator, ooc_panels, ooc_put,
    )
    from nums_tpu_torch.core.ops import streaming

    assert X_disk.ndim == 2
    backend = X_disk.backend
    mesh = backend.mesh
    dt = _device_dtype(backend, dtype or X_disk.dtype)
    y_at = _ooc_y_getter(X_disk, y)
    da = X_disk.shape[1] + 1
    lv = ooc_accumulator(backend, torch.as_tensor(
        np.zeros(da) if lambda_vec is None else lambda_vec).to(dt))
    beta = ooc_accumulator(backend, torch.zeros((da,), dtype=dt))
    gmax = torch.tensor(float("inf"), dtype=dt)
    it = 0
    for it in range(1, int(max_iter) + 1):
        g = ooc_accumulator(backend, torch.zeros((da,), dtype=dt))
        H = ooc_accumulator(backend, torch.zeros((da, da), dtype=dt))
        for start, panel in ooc_panels(X_disk):
            yp, _ = ooc_put(backend, y_at(start, panel.shape[0]))
            if mesh is None:
                pa, _ = ooc_put(backend, panel, augment_ones=True)
            else:
                p, _ = ooc_put(backend, panel)
                x, yp = streaming.local_rows(p), streaming.local_rows(yp)
                if not x.shape[0]:
                    continue
                pa = streaming.augment_ones(x)
                del p, x
            streaming.glm_stats_update_aug(kind, g, H, pa.to(dt), yp.to(dt),
                                           beta)
        streaming.reduce_rows(mesh, [g, H])
        beta, gmax = streaming.newton_update(bool(penalized), beta, g, H,
                                             lv)
        if float(gmax) <= tol:  # one host sync per pass
            break
    trace.count("newton.steps_run", it)
    trace.count("newton.steps_useful", it)
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


def fit_logistic(X, y, num_iters=10):
    """Convenience: train from zeros. X: (n, d) numpy array or tensor
    (a numpy array trains on the CPU), y: (n,)."""
    X = torch.as_tensor(X)
    y = torch.as_tensor(y, device=X.device)
    ones = torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)
    Xa = torch.cat([X, ones], dim=1)
    beta0 = torch.zeros((Xa.shape[1],), dtype=Xa.dtype, device=X.device)
    beta, _ = newton_train(Xa, y, beta0, kind="logistic",
                           num_iters=num_iters)
    return beta


def predict_proba_logistic(X, beta):
    X = torch.as_tensor(X, device=beta.device)
    return torch.sigmoid(X @ beta[:-1] + beta[-1])
