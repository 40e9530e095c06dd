"""The long tail of the numpy namespace: printing, dtype utilities, the
``*_from`` index variants, bit packing.

Counterpart of ``nums_tpu/numpy/compat.py``, name for name. Printing
(``array_repr``/``array_str``/``array2string``) reads a host copy, and
``mask_indices``, ``fromiter``, ``frombuffer`` and ``fromstring`` build
on the host, as the reference does; the rest computes on the device with
``jnp.<name>``'s dtypes.
"""

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import mesh_ops
from nums_tpu_torch.numpy.extra import (
    _default_int, _inexact, _mesh_target, _to_ba, _wrap,
)
from nums_tpu_torch.numpy.extra4 import resize_tensor

__all__ = [
    "asarray_chkfinite", "ascontiguousarray", "asfortranarray",
    "isfortran", "resize", "packbits", "unpackbits", "histogramdd",
    "mask_indices", "tril_indices_from", "triu_indices_from",
    "diag_indices_from", "array_repr", "array_str", "array2string",
    "base_repr", "binary_repr", "typename", "min_scalar_type",
    "mintypecode", "common_type", "einsum_path", "get_printoptions",
    "set_printoptions", "printoptions", "array_equiv",
    "format_float_positional", "format_float_scientific", "fromfunction",
    "fromiter", "frombuffer", "fromstring",
]

base_repr = np.base_repr
binary_repr = np.binary_repr
typename = np.typename
min_scalar_type = np.min_scalar_type
mintypecode = np.mintypecode
get_printoptions = np.get_printoptions
set_printoptions = np.set_printoptions
printoptions = np.printoptions
format_float_positional = np.format_float_positional
format_float_scientific = np.format_float_scientific

from nums_tpu_torch.numpy.extra3 import array_equiv  # noqa: E402,F401


def asarray_chkfinite(a, dtype=None):
    from nums_tpu_torch.numpy import api as _api

    out = _api.asarray(a, dtype=dtype)
    if not bool(out.ufunc("isfinite").all()):
        raise ValueError("array must not contain infs or NaNs")
    return out


def ascontiguousarray(a, dtype=None):
    # A tensor's layout is torch's concern: asarray.
    from nums_tpu_torch.numpy import api as _api

    return _api.asarray(a, dtype=dtype)


def asfortranarray(a, dtype=None):
    from nums_tpu_torch.numpy import api as _api

    return _api.asarray(a, dtype=dtype)


def isfortran(a):
    del a
    return False


def resize(a, new_shape):
    """``jnp.resize``: the flattened array repeated to the new size."""
    a = _to_ba(a)
    if isinstance(new_shape, (int, np.integer)):
        new_shape = (int(new_shape),)
    new_shape = tuple(int(s) for s in new_shape)
    if any(s < 0 for s in new_shape):
        raise ValueError("all elements of `new_shape` must be non-negative")
    if mesh_ops.is_dtensor(a.data):
        # each process pulls its run of the cycled flat order
        bs = (array_utils.default_block_shape_for(new_shape, a.block_shape)
              if len(new_shape) == a.ndim else a.mesh_block(new_shape))
        bs, want = _mesh_target(a, new_shape, bs)
        return _wrap(a, mesh_ops.flat_move(a.backend, a.data, new_shape,
                                           want, cyclic=True), bs)
    return _wrap(a, resize_tensor(a.data, new_shape).contiguous())


def _bits(bitorder, device):
    if bitorder not in ("little", "big"):
        raise ValueError("'order' must be either 'little' or 'big'")
    bits = torch.arange(8, dtype=torch.uint8, device=device)
    return torch.flip(bits, (0,)) if bitorder == "big" else bits


def packbits(a, axis=None, bitorder="big"):
    """``jnp.packbits``: each element set where it is nonzero, eight of
    them along ``axis`` (zero-padded at the end) to a uint8, the first the
    high bit unless ``bitorder="little"``."""
    a = _to_ba(a)
    x = a.data
    if x.is_floating_point() or x.is_complex():
        raise TypeError("Expected an input array of integer or boolean "
                        f"data type, got {a.dtype}")
    bits = _bits(bitorder, x.device)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    x = torch.movedim(x != 0, axis, -1)
    rem = x.shape[-1] % 8
    if rem:
        x = torch.nn.functional.pad(x, (0, 8 - rem))
    x = x.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // 8, 8))
    packed = torch.zeros(x.shape[:-1], dtype=torch.uint8, device=x.device)
    for i in range(8):
        packed |= x[..., i].to(torch.uint8) << int(bits[i])
    return _wrap(a, torch.movedim(packed, -1, axis))


def unpackbits(a, axis=None, bitorder="big"):
    """``jnp.unpackbits``: each uint8 to its eight bits along ``axis``
    (the flattened array for ``axis=None``), high bit first unless
    ``bitorder="little"``."""
    a = _to_ba(a)
    x = a.data
    if x.dtype != torch.uint8:
        raise TypeError("Expected an input array of unsigned byte data "
                        f"type, got {a.dtype}")
    bits = _bits(bitorder, x.device)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    x = torch.movedim(x, axis, -1)
    out = (x[..., None] >> bits) & 1
    out = out.reshape(tuple(x.shape[:-1]) + (x.shape[-1] * 8,))
    return _wrap(a, torch.movedim(out, -1, axis))


def histogramdd(sample, bins=10):
    """``jnp.histogramdd`` of an (N, D) sample (a 1-D sample raises
    ``ValueError``, as in jnp): ``extra2``'s counting, the counts in the
    default int."""
    from nums_tpu_torch.numpy.extra2 import histogramdd_counts

    sample = _to_ba(sample)
    x = _inexact(sample.data)
    if x.ndim != 2:
        raise ValueError(f"histogramdd: sample must be 2-D, got shape "
                         f"{tuple(x.shape)}")
    d = x.shape[1]
    b = [bins] * d if np.ndim(bins) == 0 else list(bins)
    if mesh_ops.is_dtensor(x):
        # whole rows on each process: its columns are local
        backend = sample.backend
        x = backend.rebox(x, mesh_ops.row_layout(x.placements, 2))
        pl = mesh_ops.rows_only(x.placements)
        cols = [backend.from_local(x.to_local()[:, i].contiguous(),
                                   (x.shape[0],), pl) for i in range(d)]
        counts, edges = histogramdd_counts(cols, b)
    else:
        counts, edges = histogramdd_counts([x[:, i] for i in range(d)], b)
    return (_wrap(sample, counts.to(_default_int(sample))),
            [_wrap(sample, e) for e in edges])


def mask_indices(n, mask_func, k=0):
    app = _instance()
    rows, cols = np.mask_indices(n, mask_func, k)
    return (
        app.array(rows, block_shape=rows.shape),
        app.array(cols, block_shape=cols.shape),
    )


def tril_indices_from(arr, k=0):
    from nums_tpu_torch.numpy.extra2 import tril_indices

    arr = _to_ba(arr)
    return tril_indices(arr.shape[0], k, arr.shape[1])


def triu_indices_from(arr, k=0):
    from nums_tpu_torch.numpy.extra2 import triu_indices

    arr = _to_ba(arr)
    return triu_indices(arr.shape[0], k, arr.shape[1])


def diag_indices_from(arr):
    from nums_tpu_torch.numpy.extra2 import diag_indices

    arr = _to_ba(arr)
    return diag_indices(arr.shape[0], arr.ndim)


def array_repr(arr, *args, **kwargs):
    return np.array_repr(_to_ba(arr).get(), *args, **kwargs)


def array_str(a, *args, **kwargs):
    return np.array_str(_to_ba(a).get(), *args, **kwargs)


def array2string(a, *args, **kwargs):
    return np.array2string(_to_ba(a).get(), *args, **kwargs)


def common_type(*arrays):
    return np.common_type(
        *[np.empty(0, dtype=_to_ba(a).dtype) for a in arrays]
    )


def fromfunction(function, shape, dtype=float):
    """``jnp.fromfunction``: ``function`` of the index grids (in
    ``dtype``, the default float for ``float``). It receives torch tensors
    of the full shape at once, where jnp vmaps it over 1-D index vectors:
    the results agree for every elementwise function."""
    app = _instance()
    dt = array_utils.to_torch_dtype(app.backend.device_dtype(
        array_utils.to_np_dtype(dtype)))
    grids = torch.meshgrid(
        *[torch.arange(int(s), device=app.backend.device).to(dt)
          for s in shape], indexing="ij")
    out = function(*grids)
    if not torch.is_tensor(out):
        out = torch.full(tuple(int(s) for s in shape), out, dtype=dt,
                         device=app.backend.device)
    return BlockArray.from_torch(out, backend=app.backend)


def fromiter(iterable, dtype, count=-1):
    out = np.fromiter(iterable, dtype, count)
    return _instance().array(out, block_shape=out.shape)


def frombuffer(buffer, dtype=float, count=-1, offset=0):
    out = np.frombuffer(buffer, dtype, count, offset)
    return _instance().array(out, block_shape=out.shape)


def fromstring(string, dtype=float, sep=" "):
    out = np.array(
        [np.dtype(dtype).type(v) for v in string.split(sep) if v],
        dtype=dtype,
    )
    return _instance().array(out, block_shape=out.shape)


def einsum_path(subscripts, *operands, optimize="greedy"):
    return np.einsum_path(
        subscripts,
        *[np.empty(_to_ba(o).shape) for o in operands],
        optimize=optimize,
    )
