"""nums_tpu_torch.numpy.linalg.

Counterpart of ``nums_tpu/numpy/linalg.py``, name for name. ``qr``,
``svd``, ``inv``, ``cholesky``, ``lstsq`` and ``norm`` are the
application's entry points (TSQR/CholeskyQR2 and the port's own
factorizations); the rest are ``torch.linalg`` calls on the array's
device, with ``jnp.linalg``'s conventions where torch's differ (``eigh``
symmetrizes its input). ``eig`` and ``eigvals`` run LAPACK on a host
copy, as the reference does (``linalg.py:188-251`` there: XLA has no
general eigensolver), and keep NumPy's dtype rule: real iff the input is
real and every eigenvalue (and eigenvector) is.
"""

import numpy as _np
import torch as _torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray as _BA


def qr(a, mode="reduced"):
    if mode != "reduced":
        raise NotImplementedError("Only reduced QR is supported.")
    return _instance().qr(a)


def svd(a, full_matrices=False, compute_uv=True):
    if full_matrices:
        raise NotImplementedError("Only reduced SVD is supported.")
    u, s, vt = _instance().svd(a)
    if compute_uv:
        return u, s, vt
    return s


def inv(a):
    return _instance().inv(a)


def cholesky(a):
    return _instance().cholesky(a)


def lstsq(a, b):
    return _instance().lstsq(a, b)


def norm(a):
    return _instance().norm(a)


def _wrap(a, out):
    if isinstance(out, tuple):
        return tuple(_BA.from_torch(o, backend=a.backend) for o in out)
    return _BA.from_torch(out, backend=a.backend)


def _symmetrized(x):
    return (x + x.transpose(-2, -1).conj()) / 2


def det(a):
    return _wrap(a, _torch.linalg.det(a.data))


def slogdet(a):
    return _wrap(a, tuple(_torch.linalg.slogdet(a.data)))


def eigh(a):
    return _wrap(a, tuple(_torch.linalg.eigh(_symmetrized(a.data))))


def eigvalsh(a):
    return _wrap(a, _torch.linalg.eigvalsh(_symmetrized(a.data)))


def pinv(a):
    x = a.data
    if type(x).__name__ == "DTensor":
        if a.ndim == 2 and a.shape[0] >= a.shape[1] and any(
                p.is_shard() and p.dim == 0 for p in x.placements):
            # through TSQR (the application's pinv): never the operand whole
            return _instance().pinv(a)
        if not any(p.is_shard() for p in x.placements):
            # a replicated value: each process's own copy (DTensor has no
            # strategy for pinv on every torch)
            from nums_tpu_torch.core.ops import mesh_ops

            out = _torch.linalg.pinv(x.to_local())
            return _wrap(a, mesh_ops.like(x, out, tuple(out.shape)))
    return _wrap(a, _torch.linalg.pinv(x))


def _svdvals(a):
    """The singular values of a 2-D array; of a tall sharded one on the
    mesh through ``svd`` (the TSQR routes: never the operand whole)."""
    x = a.data
    if (a.ndim == 2 and a.shape[0] >= a.shape[1]
            and type(x).__name__ == "DTensor"
            and any(p.is_shard() for p in x.placements)):
        return svd(a, compute_uv=False).data.to_local()
    return _torch.linalg.svdvals(x)


def matrix_rank(a):
    x = a.data
    s = _svdvals(a)
    tol = s.max(dim=-1, keepdim=True).values * max(x.shape[-2:]) * \
        _torch.finfo(s.dtype).eps
    return _wrap(a, (s > tol).sum(dim=-1))


def solve(a, b):
    return _wrap(a, _torch.linalg.solve(a.data, b.data))


def multi_dot(arrays):
    out = arrays[0]
    for a in arrays[1:]:
        out = out @ a
    return out


def cond(a, p=None):
    if p is not None:
        raise NotImplementedError("Only the 2-norm condition number.")
    s = _svdvals(a)
    return _wrap(a, s[..., 0] / s[..., -1])


def svdvals(a):
    return svd(a, compute_uv=False)


def matrix_power(a, n):
    return _wrap(a, _torch.linalg.matrix_power(a.data, int(n)))


def diagonal(a):
    from nums_tpu_torch.numpy import extra as _extra

    if a.ndim == 2:
        return _extra.diagonal(a)
    return _wrap(a, _torch.linalg.diagonal(a.data).clone())


def matmul(a, b):
    return a @ b


def tensordot(a, b, axes=2):
    return a.tensordot(b, axes=axes)


def outer(a, b):
    from nums_tpu_torch.numpy import extra as _extra

    return _extra.outer(a, b)


def trace(a):
    from nums_tpu_torch.numpy import extra as _extra

    return _extra.trace(a)


def vector_norm(a):
    return norm(a)


def cross(x1, x2, axis=-1):
    from nums_tpu_torch.numpy import extra as _extra

    return _extra.cross(x1, x2, axis=axis)


def vecdot(x1, x2, axis=-1):
    from nums_tpu_torch.numpy import extra3 as _extra3

    return _extra3.vecdot(x1, x2, axis=axis)


def tensorinv(a, ind=2):
    return _wrap(a, _torch.linalg.tensorinv(a.data, ind=int(ind)))


def tensorsolve(a, b):
    return _wrap(a, _torch.linalg.tensorsolve(a.data, b.data))


def _host_eig(a, values_only):
    """LAPACK's general eig on a host copy (the reference's host step),
    in ``result_type(a.dtype, complex64)``; real output iff the input is
    real and the result's imaginary parts are all zero."""
    cdt = _np.result_type(a.dtype, _np.complex64)
    host = a.get()
    outs = ((_np.linalg.eigvals(host),) if values_only
            else _np.linalg.eig(host))
    outs = [_np.asarray(o).astype(cdt) for o in outs]
    if not _np.issubdtype(a.dtype, _np.complexfloating) and all(
            bool(_np.all(o.imag == 0)) for o in outs):
        outs = [o.real for o in outs]
    app = _instance()
    return tuple(app.array(o, block_shape=o.shape) for o in outs)


def eig(a):
    return _host_eig(a, values_only=False)


def eigvals(a):
    return _host_eig(a, values_only=True)[0]


def matrix_norm(a, ord="fro"):  # noqa: A002
    if ord != "fro":
        raise NotImplementedError("Only the Frobenius norm.")
    return _instance().sqrt((a * a).sum())


def matrix_transpose(x):
    return x.transpose()
