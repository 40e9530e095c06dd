"""NumPy's in-place mutation family.

Counterpart of ``nums_tpu/numpy/extra4.py``. NumPy writes into the array
argument; here each function computes a new tensor on the device and
rebinds the BlockArray to it (``BlockArray._store``, as ``__setitem__``
does), so that no other array that shares the old tensor, a view among
them, sees the write. Values are cast to the array's dtype. ``place`` is
the reference's host step (its values cycle through the True positions
of the mask, a data-dependent assignment): a host copy, ``np.place``, and
back.
"""

import numpy as np
import torch

from nums_tpu_torch.numpy.extra import _to_ba, _wrap

__all__ = [
    "put", "put_along_axis", "place", "putmask", "copyto",
    "fill_diagonal", "apply_along_axis",
]


def _rebind(ba, data):
    ba._store(data.to(ba.data.dtype).contiguous())


def _positions(idx, n):
    """Positions along an axis of length ``n``: negative ones counted from
    the end, and those still out of range sent to ``n``."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx < 0) | (idx >= n), torch.full_like(idx, n), idx)


def _scatter_flat(x, flat, vals):
    """``x`` with ``vals`` written at the flat positions ``flat``: a copy
    one element longer, whose last slot takes the writes to position
    ``x.numel()`` (the dropped ones, as jnp's scatter drops them)."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out[:-1].copy_(x.reshape(-1))
    out[flat.reshape(-1)] = vals.reshape(-1)
    return out[:-1].view(x.shape)


def put(a, ind, v):
    """``np.put`` as the reference's ``.at[ind].set``: on the flattened
    array, ``v`` broadcast to the positions, out-of-range ones dropped."""
    a = _to_ba(a)
    x = a.data
    idx = _to_ba(ind).data.to(x.device).reshape(-1)
    vals = torch.broadcast_to(_to_ba(v).data.reshape(-1).to(x.dtype),
                              idx.shape)
    _rebind(a, _scatter_flat(x, _positions(idx, x.numel()), vals))


def put_along_axis(arr, indices, values, axis):
    """``jnp.put_along_axis``: ``values`` broadcast to ``indices``, which
    broadcast against the array off ``axis``; out-of-range positions are
    dropped. One copy of the array: the writes go to flat positions."""
    arr, indices, values = _to_ba(arr), _to_ba(indices), _to_ba(values)
    x = arr.data.contiguous()
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    idx = indices.data.to(x.device)
    shape = list(x.shape)
    shape[axis] = idx.shape[axis]
    pos = torch.broadcast_to(_positions(idx, n), shape)
    flat = pos * x.stride(axis)
    for d in range(x.ndim):
        if d != axis:
            view = [1] * x.ndim
            view[d] = shape[d]
            flat = flat + (torch.arange(shape[d], device=x.device)
                           * x.stride(d)).view(view)
    flat = torch.where(pos == n, x.numel(), flat)
    vals = torch.broadcast_to(values.data.to(x.dtype), shape)
    _rebind(arr, _scatter_flat(x, flat, vals))


def place(arr, mask, vals):
    """NumPy's rule (``vals`` cycled into the True positions of ``mask``)
    is a data-dependent assignment: a host round trip, as the
    reference."""
    arr = _to_ba(arr)
    host = arr.get().copy()
    np.place(host, np.asarray(_to_ba(mask).get(), dtype=bool),
             np.asarray(_to_ba(vals).get()))
    _rebind(arr, arr.backend.device_put(host))


def resize_tensor(v, shape):
    """``jnp.resize`` of a tensor: the values cycled to fill ``shape``
    (zeros where ``v`` is empty); a single value is broadcast, not
    copied."""
    flat = v.reshape(-1)
    size = int(np.prod(shape))
    if flat.numel() == 0:
        return torch.zeros(shape, dtype=v.dtype, device=v.device)
    if flat.numel() == 1:
        return flat.reshape(()).expand(shape)
    reps = -(-size // flat.numel())
    return flat.repeat(reps)[:size].reshape(shape)


def putmask(a, mask, values):
    """``np.putmask``: ``values`` cycled to the array's shape where
    ``mask`` holds."""
    a, mask, values = _to_ba(a), _to_ba(mask), _to_ba(values)
    x = a.data
    v = resize_tensor(values.data.to(x.dtype), tuple(x.shape))
    _rebind(a, torch.where(mask.data.to(torch.bool), v, x))


def copyto(dst, src):
    """``np.copyto``: ``src`` broadcast to ``dst`` and cast to its
    dtype."""
    dst, src = _to_ba(dst), _to_ba(src)
    x = dst.data
    _rebind(dst, torch.broadcast_to(src.data.to(x.dtype), x.shape).clone())


def fill_diagonal(a, val):
    """``jnp.fill_diagonal``: the first ``min(shape)`` diagonal positions
    (every axis of equal length beyond two), ``val`` cycled along them."""
    a = _to_ba(a)
    x = a.data
    if x.ndim < 2:
        raise ValueError("array must be at least 2-d")
    if x.ndim > 2 and any(s != x.shape[0] for s in x.shape[1:]):
        raise ValueError("All dimensions of input must be of equal length")
    n = min(x.shape)
    v = _to_ba(val).data.to(device=x.device, dtype=x.dtype)
    v = resize_tensor(v, (n,))
    i = torch.arange(n, device=x.device)
    out = x.clone()
    out[(i,) * x.ndim] = v
    _rebind(a, out)


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    """``jnp.apply_along_axis``: ``func1d`` vectorized over the other axes
    by ``torch.func.vmap``, nested as jnp nests ``jax.vmap``. ``func1d``
    receives torch tensors (the reference passes jnp arrays): a function
    of operators and tensor methods runs on both."""
    arr = _to_ba(arr)
    x = arr.data
    axis = int(axis) % x.ndim

    def func(t):
        return func1d(t, *args, **kwargs)

    for i in range(1, x.ndim - axis):
        func = torch.func.vmap(func, in_dims=i, out_dims=-1)
    for _ in range(axis):
        func = torch.func.vmap(func, in_dims=0, out_dims=0)
    return _wrap(arr, func(x))
