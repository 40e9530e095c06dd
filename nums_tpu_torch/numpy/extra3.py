"""Further NumPy names (counterpart of ``nums_tpu/numpy/extra3.py``).

Only ``vecdot`` so far, which ``numpy.linalg.vecdot`` rides; the rest of
the reference's module is a later port and a stub until then.
"""

import torch

from nums_tpu_torch.numpy.extra import _promote_all, _to_ba, _wrap

__all__ = ["vecdot"]


def vecdot(x1, x2, axis=-1):
    """``jnp.vecdot``: ``Σ conj(x1)·x2`` along ``axis``, in the promoted
    dtype."""
    x1, x2 = _to_ba(x1), _to_ba(x2)
    a, b = _promote_all([x1.data, x2.data])
    return _wrap(x1, (a.conj() * b).sum(dim=axis, dtype=a.dtype))
