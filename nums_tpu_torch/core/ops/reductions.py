"""Reduction op vocabulary as plain torch calls.

Counterpart of ``nums_tpu/core/ops/reductions.py``. As there, ``dtype=``
of ``sum`` and ``mean`` is the ACCUMULATOR dtype (torch casts the input
before it reduces), while for ``min`` and ``max`` it casts the result;
``var`` and ``std`` compute in ``dtype`` (``jnp.var``'s rule).
"""

import torch

from nums_tpu_torch.core.ops.elementwise import inexact_dtype

_DTYPE_AWARE = {"sum", "mean", "prod"}


def _prod(x, dim, keepdim, dtype=None):
    """``torch.prod`` takes one axis: reduce the axes one at a time, the
    highest first."""
    if dtype is not None:
        x = x.to(dtype)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _extreme(fn, fill):
    """``amax``/``amin`` in jnp's order of complex numbers: the extreme
    real part, then the extreme imaginary part among the elements that
    hold it (without NaNs, the lexicographic maximum or minimum)."""

    def reduce_fn(x, dim, keepdim):
        if not x.is_complex():
            return fn(x, dim=dim, keepdim=keepdim)
        re = fn(x.real, dim=dim, keepdim=True)
        im = fn(torch.where(x.real == re, x.imag,
                            torch.full_like(x.imag, fill)),
                dim=dim, keepdim=keepdim)
        return torch.complex(re.reshape(im.shape), im)

    return reduce_fn


_FNS = {"sum": torch.sum, "mean": torch.mean,
        "min": _extreme(torch.amin, float("inf")),
        "max": _extreme(torch.amax, float("-inf")), "prod": _prod}


def _dims(axis, ndim):
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(a % ndim for a in axes)


def reduce(op_name: str, x, axis, keepdims: bool, dtype=None):
    """``op_name`` in sum|mean|prod|min|max over ``axis`` (None = all)."""
    if op_name not in _FNS:
        raise NotImplementedError(f"reduction {op_name!r} is not ported")
    fn = _FNS[op_name]
    if op_name == "mean" and dtype is None:
        dtype = inexact_dtype(x.dtype)  # the mean of integers is a float
    if x.ndim == 0:
        out = x
    elif op_name == "mean" and _sharded_along(x, _dims(axis, x.ndim)):
        # DTensor's mean of uneven shards gathers the operand whole: the
        # sum of each process's part (all-reduced) over the count
        dims = _dims(axis, x.ndim)
        count = 1
        for d in dims:
            count *= int(x.shape[d])
        out = torch.sum(x, dim=dims, keepdim=keepdims, dtype=dtype) / count
    elif dtype is not None and op_name in _DTYPE_AWARE:
        out = fn(x, dim=_dims(axis, x.ndim), keepdim=keepdims, dtype=dtype)
    else:
        out = fn(x, dim=_dims(axis, x.ndim), keepdim=keepdims)
    return out.to(dtype) if dtype is not None else out


def moment(op_name: str, x, axis, ddof: int, keepdims: bool, dtype=None):
    """``op_name`` in var|std over ``axis`` (None = all) with ``ddof``
    delta degrees of freedom, computed in ``dtype`` (default: the input's
    own inexact dtype)."""
    fn = {"var": torch.var, "std": torch.std}[op_name]
    x = x.to(dtype if dtype is not None else inexact_dtype(x.dtype))
    if x.ndim == 0:
        return fn(x.reshape(1), dim=(0,), correction=ddof, keepdim=False)
    dims = _dims(axis, x.ndim)
    if _sharded_along(x, dims) and not x.is_complex():
        # DTensor's var gathers the operand whole; these are sums of each
        # process's part (all-reduced) and one deviation the part's size
        count = 1
        for d in dims:
            count *= int(x.shape[d])
        dev = x - x.sum(dim=dims, keepdim=True) / count
        var = dev.square_().sum(dim=dims, keepdim=keepdims) / (count - ddof)
        return var if op_name == "var" else torch.sqrt(var)
    return fn(x, dim=dims, correction=ddof, keepdim=keepdims)


def _sharded_along(x, dims):
    """Whether the DTensor ``x`` is split over several processes along
    one of ``dims`` (False for a plain tensor)."""
    placements = getattr(x, "placements", ())
    return any(p.is_shard() and p.dim in dims and x.device_mesh.size(k) > 1
               for k, p in enumerate(placements))


def arg_op(op_name: str, x, axis):
    """``argmin``/``argmax`` over ``axis`` (None = the flattened array),
    int64, the first of equal extremes as NumPy's."""
    fn = {"argmin": torch.argmin, "argmax": torch.argmax}[op_name]
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return fn(x) if axis is None else fn(x, dim=int(axis))
