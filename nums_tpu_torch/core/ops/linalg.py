"""Dense linear algebra as plain torch calls: TSQR, CholeskyQR2, SVD,
randomized SVD, least squares, and the small solves of the GLM solvers.

Counterpart of ``nums_tpu/core/ops/linalg.py``, under the same names. Where
the reference builds a jitted function from static arguments (a chunk, a
rank), the function here takes those arguments first and the tensors after
them; ``tsqr_r(chunk)`` alone still returns the function of x.

* Householder route: ``_tsqr_r_impl`` and ``_direct_tsqr_impl`` are trees of
  batched panel QRs (``torch.linalg.qr``), stable at any conditioning.
* CholeskyQR2 route: ``cholqr2``, ``cholqr_r`` and ``cholqr2_stream`` are
  GEMMs, Cholesky factors of n×n matrices and triangular solves; orthogonal
  to about eps for cond(X) up to about 1/sqrt(eps). A matrix that is not of
  full column rank gives a NaN factor (``cholesky`` below), not an error,
  and no call here syncs with the host.

Precision. Every product in this module is plain torch matmul in the
tensors' own dtype, float32 with TF32 off
(``settings.configure_precision``), whatever ``settings.matmul_precision``
says: the reference asks ``Precision.HIGHEST`` for all of them. The gram of
CholeskyQR is ``_gram`` below and never the bf16 gram kernel
(``cuda_gram``): CholeskyQR squares the condition number and cannot afford
bf16 operands. Only the BlockArray-level products of the application
(``X @ R_inv``, ``R.T @ R``, ``X.T @ y``) follow the precision setting, and
of those only the same-tensor gram ``R.T @ R`` reaches a kernel.

Departure from the reference, recorded in ROADMAP.md (Queue C): the trees
take ``chunk = max(chunk, 2 * n)``, not ``max(chunk, n)``. With a chunk
under 2n a level keeps ceil(m / chunk)·n >= 2n > chunk rows, so the
reference's loop never ends (and its recursion never returns); with
chunk >= 2n every level at least halves the excess over n. Shapes on which
the reference returns are factored exactly as before.
"""

import functools

import torch

from nums_tpu_torch.core import multiprocess

# Rows per leaf panel of the TSQR tree (the reference's DEFAULT_CHUNK).
DEFAULT_CHUNK = 8192


def _cdiv(a, b):
    return -(-a // b)


def _pad_rows(x, target_rows):
    m, n = x.shape
    if target_rows == m:
        return x
    return torch.cat([x, x.new_zeros((target_rows - m, n))], dim=0)


def _tsqr_r_impl(x, chunk):
    """R factor of a tall-skinny matrix by a tree of panel QRs: each level
    factors ``chunk``-row panels in one batched call and stacks their R
    factors. R is unique up to the sign of each row; zero-row padding is
    exact."""
    m, n = x.shape
    chunk = max(chunk, 2 * n)
    while m > chunk:
        k = _cdiv(m, chunk)
        x = _pad_rows(x, k * chunk)
        rs = torch.linalg.qr(x.reshape(k, chunk, n), mode="r").R
        x = rs.reshape(k * n, n)
        m = k * n
    return torch.linalg.qr(x, mode="r").R


def tsqr_r(chunk: int = DEFAULT_CHUNK):
    """The R factor as a function of x, at a fixed leaf size."""
    return functools.partial(_tsqr_r_impl, chunk=chunk)


def _direct_tsqr_impl(x, chunk):
    """(Q, R) by recursive direct TSQR. Leaf: the reduced QR of each panel,
    batched. Combine: TSQR of the stacked R factors; each panel's Q is
    multiplied by its n×n slice of the combine's Q."""
    m, n = x.shape
    chunk = max(chunk, 2 * n)
    if m <= chunk:
        return torch.linalg.qr(x, mode="reduced")
    k = _cdiv(m, chunk)
    q1, r1 = torch.linalg.qr(
        _pad_rows(x, k * chunk).reshape(k, chunk, n), mode="reduced")
    q2, r = _direct_tsqr_impl(r1.reshape(k * n, n), chunk)
    q = torch.bmm(q1, q2.reshape(k, n, n)).reshape(k * chunk, n)
    return q[:m], r


def _small_svd(a):
    """Reduced SVD of a small matrix (an n×n R, an (ell, n) projection),
    computed in float64 and returned in ``a``'s dtype. In float32 on the
    card, torch's default routine (cuSOLVER's Jacobi gesvdj) stops at a
    tolerance that leaves the singular values several 1e-5 off (relative to
    the largest) and its gesvd several 1e-6; in float64 the result is as
    good as the float32 R it is given, and the matrix is small enough for
    the cost not to show."""
    u, s, vt = torch.linalg.svd(a.double(), full_matrices=False)
    return u.to(a.dtype), s.to(a.dtype), vt.to(a.dtype)


def direct_tsqr(chunk, x):
    """(Q, R) of x by the Householder tree at leaf size ``chunk``."""
    return _direct_tsqr_impl(x, chunk)


def svd(chunk, x):
    """Tall-skinny SVD through TSQR: (U, S, Vᵀ), reduced."""
    q, r = _direct_tsqr_impl(x, chunk)
    u_r, s, vt = _small_svd(r)
    return q @ u_r, s, vt


def randomized_svd(k, n_iter, chunk, x, omega):
    """Halko-Martinsson-Tropp randomized top-k SVD: the sketch x·omega,
    ``n_iter`` power iterations re-orthonormalized by TSQR, the SVD of the
    (ell, n) projection, and the back-projection. ``omega`` is the (n, ell)
    Gaussian test matrix; the caller draws it."""
    q, _ = _direct_tsqr_impl(x @ omega, chunk)
    for _ in range(n_iter):
        z, _ = _direct_tsqr_impl(x.T @ q, chunk)
        q, _ = _direct_tsqr_impl(x @ z, chunk)
    ub, s, vt = _small_svd(q.T @ x)
    return (q @ ub)[:, :k], s[:k], vt[:k]


_COMP_CHUNK = 4096
_COMP_MIN_ROWS = 1 << 20
# Ceiling of the chunk-gram stack for the batched form (see _gram).
_COMP_STACK_BYTES = 512 << 20


def _gram(x, compensated=None):
    """G = XᵀX with compensated accumulation on tall inputs.

    One float32 product over m rows accumulates an error of about
    sqrt(m)·eps, which at m = 2^24 is what CholeskyQR2's orthogonality is
    held to. Splitting the rows into 4096-row chunk-grams caps the depth of
    each product's sum at sqrt(4096)·eps, and every operation stays a GEMM.
    The sum over the c chunk-grams takes one of two forms, by the size of
    the (c, n, n) stack:

    - at most ``_COMP_STACK_BYTES`` (narrow n): ONE batched GEMM for all
      chunk-grams and a pairwise tree sum;
    - more (wide n): a loop with a Kahan (sum, compensation) pair, O(n²)
      extra memory and one read of X; it also bounds the error across
      chunks at O(eps), tighter than the tree's log2(c) ulps.

    On by default for float32 inputs of at least ``_COMP_MIN_ROWS`` rows.
    """
    m, n = x.shape
    if compensated is None:
        compensated = m >= _COMP_MIN_ROWS and x.dtype == torch.float32
    if not compensated or m <= _COMP_CHUNK:
        return x.T @ x
    c = m // _COMP_CHUNK
    head = x[:c * _COMP_CHUNK].reshape(c, _COMP_CHUNK, n)
    tail = x[c * _COMP_CHUNK:]
    if c * n * n * x.element_size() <= _COMP_STACK_BYTES:
        grams = torch.bmm(head.transpose(1, 2), head)  # (c, n, n)
        while grams.shape[0] > 1:
            k = grams.shape[0]
            if k % 2:
                odd = grams[k - 1]
                grams = grams[0:k - 1:2] + grams[1:k:2]
                grams[0] += odd
            else:
                grams = grams[0::2] + grams[1::2]
        s = grams[0]
        if tail.shape[0]:
            s = s + tail.T @ tail
        return s
    s = x.new_zeros((n, n))
    comp = x.new_zeros((n, n))
    for blk in head:
        y = blk.T @ blk - comp
        t = s + y
        comp = (t - s) - y
        s = t
    if tail.shape[0]:
        s = s + (tail.T @ tail - comp)
    return s


def cholesky(x):
    """Lower Cholesky factor; NaN where ``x`` is not positive definite, as
    ``jnp.linalg.cholesky`` returns it."""
    chol, info = torch.linalg.cholesky_ex(x, check_errors=False)
    return torch.where(info == 0, chol, float("nan"))


def _chol_upper(g):
    """R with RᵀR = g, upper triangular and contiguous."""
    return cholesky(g).T.contiguous()


# Rows of a right triangular solve at a time in ``_solve_rows_``.
_SOLVE_ROWS = 1 << 18


def _solve_rows_(r, x):
    """x <- x r⁻¹ for an upper-triangular r, written into x's own storage
    ``_SOLVE_ROWS`` rows at a time: beside x, device memory holds one
    chunk's solve."""
    for i in range(0, x.shape[0], _SOLVE_ROWS):
        x[i:i + _SOLVE_ROWS] = torch.linalg.solve_triangular(
            r, x[i:i + _SOLVE_ROWS], upper=True, left=False)
    return x


def _cholqr_once(x, reduce=multiprocess.one_process, overwrite=False):
    """One CholeskyQR pass: G = XᵀX, R = chol(G)ᵀ, Q = X R⁻¹, Q in a copy
    of X (in X itself with ``overwrite``). With ``reduce`` (on the mesh:
    ``x`` is one process's rows) G is summed over the processes first."""
    r = _chol_upper(reduce(_gram(x)))
    q = x if overwrite else x.clone(memory_format=torch.contiguous_format)
    return _solve_rows_(r, q), r


def cholqr2(x, reduce=multiprocess.one_process, overwrite=False):
    """CholeskyQR2, (Q, R): the second pass restores orthogonality to about
    eps for cond(X) up to about 1/sqrt(eps). The second pass overwrites the
    first's Q, so device memory holds X and Q; with ``overwrite`` Q is
    written into X (X is destroyed). ``reduce`` as ``_cholqr_once``'s: Q
    is then this process's rows of Q, R whole."""
    q1, r1 = _cholqr_once(x, reduce, overwrite)
    q, r2 = _cholqr_once(q1, reduce, overwrite=True)
    return q, r2 @ r1


def cholqr_r(x, reduce=multiprocess.one_process):
    """R alone by CholeskyQR with a second pass that never forms Q:
    B = R1⁻ᵀ G R1⁻¹ (which is Q1ᵀQ1), R = chol(B)ᵀ R1. Peak memory X and
    O(n²); accuracy limited by the gram, about eps·cond², as for any method
    on the normal equations."""
    g = reduce(_gram(x))
    r1 = _chol_upper(g)
    b = torch.linalg.solve_triangular(r1.T, g, upper=False, left=True)
    b = torch.linalg.solve_triangular(r1, b, upper=True, left=False)
    # The factor reads the lower triangle; the reference's symmetrizes.
    return _chol_upper(0.5 * (b + b.T)) @ r1


def _inplace_right_mul(buf, rinv, chunk_rows):
    """buf <- buf @ rinv, ``chunk_rows`` rows at a time and written back
    into ``buf``'s own storage: beside the one (m, n) tensor, device memory
    holds one chunk's product."""
    for i in range(0, buf.shape[0], chunk_rows):
        buf[i:i + chunk_rows] = buf[i:i + chunk_rows] @ rinv
    return buf


def cholqr2_stream(chunk_rows, x):
    """CholeskyQR2 that overwrites ``x`` with Q: (x, R), peak device memory
    about 1× X where ``cholqr2`` holds 2×. ``x`` is destroyed (it holds Q
    afterwards); the reference donates its buffer to the same effect, at
    ``chunk_rows`` = 2^20."""
    chunk_rows = max(1, min(chunk_rows, x.shape[0]))
    r1 = _chol_upper(_gram(x))
    q1 = _inplace_right_mul(x, inv(r1), chunk_rows)
    r2 = _chol_upper(_gram(q1))
    q = _inplace_right_mul(q1, inv(r2), chunk_rows)
    return q, r2 @ r1


def svd_cholqr(x, reduce=multiprocess.one_process, k=None,
               overwrite=False):
    """Tall-skinny SVD through CholeskyQR2: (U, S, Vᵀ), reduced (with
    ``reduce``, U is this process's rows of U). With ``k`` U holds only
    its first k columns; with ``overwrite`` Q is written into ``x``."""
    q, r = cholqr2(x, reduce, overwrite)
    u_r, s, vt = _small_svd(r)
    return q @ (u_r if k is None else u_r[:, :k]), s, vt


def inv(x):
    return torch.linalg.inv_ex(x, check_errors=False)[0]


def _solve_upper(r, b):
    """r⁻¹ b for an upper-triangular r and a vector or matrix b."""
    vec = b.ndim == 1
    x = torch.linalg.solve_triangular(
        r, b.unsqueeze(-1) if vec else b, upper=True)
    return x.squeeze(-1) if vec else x


def lstsq(chunk, x, y):
    """argmin |xθ − y| through the Householder tree: R⁻¹ Qᵀ y."""
    q, r = _direct_tsqr_impl(x, chunk)
    return _solve_upper(r, q.T @ y)


def lstsq_cholqr(x, y, reduce=multiprocess.one_process):
    """argmin |xθ − y| through CholeskyQR2."""
    q, r = cholqr2(x, reduce)
    return _solve_upper(r, reduce(q.T @ y))


def posdef_solve(a, b):
    """Solve a·x = b for a symmetric positive-definite ``a`` by Cholesky;
    ``b`` is a vector or a matrix of right-hand sides; mixed dtypes
    promote, as in ``jax.scipy.linalg.solve_triangular``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    vec = b.ndim == 1
    x = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, cholesky(a))
    return x.squeeze(-1) if vec else x


def choose_chunk(m: int, n: int) -> int:
    """Leaf panel rows: at least n and DEFAULT_CHUNK, at most m (the trees
    raise it to 2n where it is less)."""
    base = max(int(n), DEFAULT_CHUNK)
    return int(min(m, base)) if m > 0 else base
