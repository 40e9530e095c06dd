"""Dense linear algebra of the solvers as plain torch calls.

Counterpart of ``inv``, ``cholesky`` and ``posdef_solve`` in
``nums_tpu/core/ops/linalg.py:320-356``. As there, a matrix that is not
positive definite gives a NaN factor instead of an error:
``torch.linalg.cholesky_ex(check_errors=False)`` reports it on the device,
so no call here syncs with the host. The R factor of TSQR
(``nums_tpu/core/ops/linalg.py:24-58, 359-362``) is a batched
``torch.linalg.qr`` tree; the rest of TSQR, the SVDs and ``lstsq`` are a
later port.
"""

import functools

import torch

# Rows per leaf panel of the TSQR tree (the reference's DEFAULT_CHUNK).
DEFAULT_CHUNK = 8192


def _pad_rows(x, target_rows):
    m, n = x.shape
    if target_rows == m:
        return x
    return torch.cat([x, x.new_zeros((target_rows - m, n))], dim=0)


def _tsqr_r_impl(x, chunk):
    """R factor of a tall-skinny matrix by a tree of panel QRs: each level
    factors ``chunk``-row panels in one batched call and stacks their R
    factors. R is unique up to the sign of each row."""
    m, n = x.shape
    chunk = max(chunk, n)
    while m > chunk:
        k = -(-m // chunk)
        x = _pad_rows(x, k * chunk)
        rs = torch.linalg.qr(x.reshape(k, chunk, n), mode="r").R
        x = rs.reshape(k * n, n)
        m = k * n
    return torch.linalg.qr(x, mode="r").R


def tsqr_r(chunk: int = DEFAULT_CHUNK):
    """The R factor as a function of x, at a fixed leaf size."""
    return functools.partial(_tsqr_r_impl, chunk=chunk)


def choose_chunk(m: int, n: int) -> int:
    """Leaf panel rows: at least n and DEFAULT_CHUNK, at most m."""
    base = max(int(n), DEFAULT_CHUNK)
    return int(min(m, base)) if m > 0 else base


def cholesky(x):
    """Lower Cholesky factor; NaN where ``x`` is not positive definite, as
    ``jnp.linalg.cholesky`` returns it."""
    chol, info = torch.linalg.cholesky_ex(x, check_errors=False)
    return torch.where(info == 0, chol, float("nan"))


def inv(x):
    return torch.linalg.inv_ex(x, check_errors=False)[0]


def posdef_solve(a, b):
    """Solve a·x = b for a symmetric positive-definite ``a`` by Cholesky;
    ``b`` is a vector or a matrix of right-hand sides; mixed dtypes
    promote, as in ``jax.scipy.linalg.solve_triangular``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    vec = b.ndim == 1
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, cholesky(a))
    return x.squeeze(-1) if vec else x
