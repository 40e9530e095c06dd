"""Dense linear algebra of the solvers as plain torch calls.

Counterpart of ``inv``, ``cholesky`` and ``posdef_solve`` in
``nums_tpu/core/ops/linalg.py:320-356``. As there, a matrix that is not
positive definite gives a NaN factor instead of an error:
``torch.linalg.cholesky_ex(check_errors=False)`` reports it on the device,
so no call here syncs with the host. TSQR, the SVDs and ``lstsq`` are a
later port.
"""

import torch


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
