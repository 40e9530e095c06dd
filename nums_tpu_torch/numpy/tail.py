"""The last numpy callables: the module surface at 0 stubs.

Counterpart of ``nums_tpu/numpy/tail.py``, name for name. On the device:
``bitwise_count``, ``piecewise``, ``ix_``, ``apply_over_axes``, ``bmat``,
``from_dlpack`` and ``require``. Host round trips only where the
reference makes them, for domains with no device representation:
datetime/business-day calendars, ``np.matrix``, ``nditer`` and text and
binary file parsing.
"""

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.numpy.extra import _to_ba, _wrap, flatnonzero

__all__ = [
    "apply_over_axes", "asmatrix", "bitwise_count", "bmat",
    "busday_count", "busday_offset", "datetime_as_string",
    "datetime_data", "from_dlpack", "fromfile", "fromregex",
    "genfromtxt", "geterrcall", "is_busday", "isnat", "ix_",
    "nested_iters", "piecewise", "require", "savez_compressed",
    "seterrcall",
]


def _dehost(obj):
    """BlockArray -> host ndarray; anything else passes through."""
    return obj.get() if isinstance(obj, BlockArray) else obj


def _distribute(out):
    """Host ndarray -> BlockArray where the dtype is one the device holds
    (bool/int/float/complex); calendar, string and struct results stay on
    the host."""
    if isinstance(out, np.ndarray) and out.dtype.kind in "bifc":
        return _instance().array(out, block_shape=None)
    return out


# -- on the device ---------------------------------------------------------

# SWAR popcount masks: pairs, nibbles, bytes, and the byte-sum multiplier.
_POPCOUNT = {
    32: (0x55555555, 0x33333333, 0x0F0F0F0F, 0x01010101, 24),
    64: (0x5555555555555555, 0x3333333333333333, 0x0F0F0F0F0F0F0F0F,
         0x0101010101010101, 56),
}


def bitwise_count(x):
    """``jnp.bitwise_count``: the set bits of ``|x|`` (the magnitude's
    two's complement bits, as ``lax.population_count(abs(x))``), uint8;
    counted by shifts and masks (torch has no popcount). Narrow integers
    count in int32 with their own width masked."""
    x = _to_ba(x)
    d = x.data
    if d.is_floating_point() or d.is_complex():
        raise TypeError(f"bitwise_count is not defined for {x.dtype}")
    if d.dtype == torch.bool:
        return _wrap(x, d.to(torch.uint8), x.block_shape)
    width = d.dtype.itemsize * 8
    v = torch.abs(d)
    if width < 32:
        v = v.to(torch.int32) & ((1 << width) - 1)
    m1, m2, m4, h01, shift = _POPCOUNT[64 if width == 64 else 32]
    # in place on v, one temporary of its size
    t = (v >> 1).bitwise_and_(m1)
    v -= t
    torch.bitwise_right_shift(v, 2, out=t).bitwise_and_(m2)
    v.bitwise_and_(m2).add_(t)
    torch.bitwise_right_shift(v, 4, out=t)
    v.add_(t).bitwise_and_(m4)
    del t
    v.mul_(h01).bitwise_right_shift_(shift)
    return _wrap(x, v.to(torch.uint8), x.block_shape)


def from_dlpack(x):
    """``torch.from_dlpack``: zero copy where the producer is on the
    backend's device, else one copy there."""
    app = _instance()
    data = torch.from_dlpack(x).to(app.backend.device)
    return BlockArray.from_torch(data, backend=app.backend)


def require(a, dtype=None, requirements=None):
    """Memory-layout flags (C/F/ALIGNED/...) are torch's concern: asarray
    with a dtype."""
    del requirements
    from nums_tpu_torch.numpy import api as _api

    return _api.asarray(a, dtype=dtype)


def ix_(*args):
    """Open-mesh index vectors: each 1-D selector reshaped so that
    broadcasting forms the cross product; a boolean one becomes its True
    positions."""
    n = len(args)
    out = []
    for k, a in enumerate(args):
        if isinstance(a, BlockArray):
            ab = flatnonzero(a) if a.dtype == np.bool_ else a
        else:
            host = np.asarray(a)
            if host.size == 0 and host.dtype.kind == "f":
                host = host.astype(np.intp)
            if host.dtype.kind == "b":
                host = np.flatnonzero(host)
            ab = _to_ba(host)
        if ab.ndim != 1:
            raise ValueError("Cross index must be 1 dimensional")
        shape = [1] * n
        shape[k] = ab.shape[0]
        out.append(ab.reshape(tuple(shape)))
    return tuple(out)


def piecewise(x, condlist, funclist, *args, **kw):
    """``jnp.piecewise``: each element takes the piece of its LAST true
    condition (the default, ``funclist[-1]`` or 0, where none holds), cast
    to x's dtype. Each piece is called once on all of x (a torch tensor),
    where jnp vectorizes it over elements: elementwise pieces agree."""
    x = _to_ba(x)
    if not isinstance(condlist, (list, tuple)):
        condlist = [condlist]
    conds = [_to_ba(c).data.to(torch.bool) for c in condlist]
    funclist = list(funclist)
    nc, nf = len(conds), len(funclist)
    if nf == nc + 1:
        funclist = funclist[-1:] + funclist[:-1]
    elif nf == nc:
        funclist = [0] + funclist
    else:
        raise ValueError(f"with {nc} condition(s), either {nc} or {nc + 1} "
                         f"functions are expected; got {nf}")
    xd = x.data
    # the piece of each element, in the narrowest type that holds them
    which = torch.zeros(xd.shape, device=xd.device,
                        dtype=torch.int8 if nc < 127 else torch.int32)
    for i, c in enumerate(conds):
        which.masked_fill_(torch.broadcast_to(c, xd.shape), i + 1)
    out = torch.zeros_like(xd)
    for i, f in enumerate(funclist):
        piece = f(xd, *args, **kw) if callable(f) else f
        piece = torch.as_tensor(piece, device=xd.device).to(xd.dtype)
        torch.where(which == i, piece, out, out=out)
    return _wrap(x, out, x.block_shape)


def apply_over_axes(func, a, axes):
    """``func(a, axis)`` over each axis, a reduced axis expanded back
    (NumPy's rule); each step is an ordinary facade call."""
    from nums_tpu_torch.numpy import api as _api

    a = _to_ba(a)
    if np.isscalar(axes):
        axes = (axes,)
    res = a
    for axis in axes:
        axis = int(axis)
        r = _to_ba(func(res, axis))
        if r.ndim == res.ndim:
            res = r
        elif r.ndim == res.ndim - 1:
            res = _api.expand_dims(r, axis)
        else:
            raise ValueError(
                "function is not returning an array of the correct shape"
            )
    return res


def bmat(obj, ldict=None, gdict=None):
    """Block matrix from nested blocks: rows join on axis 1, then axis 0;
    NumPy's string syntax ('A B; C D') is resolved against ``ldict``/
    ``gdict`` or the caller's frame. Returns a BlockArray (not
    np.matrix)."""
    from nums_tpu_torch.numpy import api as _api
    from nums_tpu_torch.numpy.extra import atleast_2d

    if isinstance(obj, str):
        import sys

        frame = sys._getframe(1)
        gdict = frame.f_globals if gdict is None else gdict
        ldict = frame.f_locals if ldict is None else ldict
        rows = []
        for row in obj.split(";"):
            names = row.split()
            if not names:
                continue
            rows.append([ldict.get(n, gdict.get(n)) for n in names])
        obj = rows
    if isinstance(obj, (list, tuple)) and obj and isinstance(
        obj[0], (list, tuple)
    ):
        row_arrays = [
            _api.concatenate([atleast_2d(_to_ba(b)) for b in row], axis=1)
            for row in obj
        ]
        return _api.concatenate(row_arrays, axis=0)
    return atleast_2d(_to_ba(obj))


# -- host round trips (domains with no device representation) -------------


def _host_passthrough(np_name, doc, wrap_out=False):
    fn = getattr(np, np_name)

    def wrapped(*args, **kwargs):
        args = [_dehost(a) for a in args]
        kwargs = {k: _dehost(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        return _distribute(out) if wrap_out else out

    wrapped.__name__ = np_name
    wrapped.__doc__ = doc
    return wrapped


_CAL_DOC = (
    "Business-day/datetime calendars are a host-only domain (torch has no "
    "datetime64); numeric results are put back on the device."
)
busday_count = _host_passthrough("busday_count", _CAL_DOC, wrap_out=True)
busday_offset = _host_passthrough("busday_offset", _CAL_DOC)
is_busday = _host_passthrough("is_busday", _CAL_DOC)
datetime_as_string = _host_passthrough("datetime_as_string", _CAL_DOC)
datetime_data = _host_passthrough("datetime_data", _CAL_DOC)
isnat = _host_passthrough("isnat", _CAL_DOC, wrap_out=True)

geterrcall = np.geterrcall
seterrcall = np.seterrcall


def asmatrix(data, dtype=None):
    """np.matrix is a host-only legacy type; returns np.matrix."""
    return np.asmatrix(_dehost(data), dtype=dtype)


def nested_iters(op, axes, flags=None, op_flags=None, **kw):
    """nditer machinery is host-only; operands are fetched."""
    if isinstance(op, (list, tuple)):
        op = [_dehost(o) for o in op]
    else:
        op = _dehost(op)
    return np.nested_iters(op, axes, flags=flags, op_flags=op_flags, **kw)


def fromfile(file, dtype=float, count=-1, sep="", offset=0):
    out = np.fromfile(file, dtype=dtype, count=count, sep=sep, offset=offset)
    return _distribute(out)


def fromregex(file, regexp, dtype, encoding=None):
    return _distribute(np.fromregex(file, regexp, dtype, encoding=encoding))


def genfromtxt(fname, **kwargs):
    return _distribute(np.genfromtxt(fname, **kwargs))


def savez_compressed(file, *args, **kwds):
    args = [_dehost(a) for a in args]
    kwds = {k: _dehost(v) for k, v in kwds.items()}
    np.savez_compressed(file, *args, **kwds)
