"""Set operations, polynomial arithmetic, partitioning, block assembly.

Counterpart of ``nums_tpu/numpy/extra3.py``, name for name. Each is a
torch computation on the array's device with ``jnp.<name>``'s dtype and
values: ``partition``/``argpartition`` order as ``jnp``'s ``lax.top_k``
route does (the kth+1 smallest ascending, then the rest: values
descending, positions ascending), ``lexsort`` is successive stable sorts
(the last key the primary one), ``choose`` clips, and the ``poly*`` family promotes
as jnp's. The host steps are the reference's own: ``delete``/``insert``
at array-valued positions, ``roots`` (a general eigenproblem: host
LAPACK, one copy of the coefficients each way), ``poly`` of a square
matrix, the empty-array short cuts of the set operations, and one scalar
sync each where an output's shape or dtype depends on the data (the set
operations' counts, ``trim_zeros``' bounds, ``roots``' count,
``real_if_close``' and ``poly``'s dtype).
"""

import builtins

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import elementwise, masking, mesh_ops
from nums_tpu_torch.numpy.extra import (
    _conv, _default_int, _index_dtype, _inexact, _local, _mask_indices_1d,
    _mesh_conv, _mesh_flat, _mesh_target, _promote_all, _sharded, _to_ba,
    _wrap, append, mesh_unique, ravel, real, sort,
)
from nums_tpu_torch.numpy.extra2 import _inexact_pair, isin

__all__ = [
    "argpartition", "partition", "lexsort", "modf", "rot90", "rollaxis",
    "vecdot", "block", "choose", "delete", "insert", "array_equiv",
    "in1d", "intersect1d", "setdiff1d", "setxor1d", "union1d",
    "unique_all", "unique_counts", "unique_inverse", "unique_values",
    "trim_zeros", "sort_complex", "polyadd", "polysub", "polymul",
    "polydiv", "polyder", "polyint", "poly", "roots", "issubdtype",
    "isdtype", "iterable", "real_if_close",
]

issubdtype = np.issubdtype
isdtype = getattr(np, "isdtype", None) or np.issubdtype
iterable = np.iterable

def _axis_last(a, kth, axis, name):
    x = a.data
    if x.is_complex():
        raise NotImplementedError(
            f"jnp.{name} for complex dtype is not implemented.")
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    kth = int(kth)
    if not -n <= kth < n:
        raise ValueError(f"kth={kth} is out of bounds for axis of size {n}")
    x = torch.movedim(x, axis, -1)
    return x, kth % n, axis


def _mesh_select(a, x, kth, axis, part, positions):
    """``partition``/``argpartition`` of a DTensor whose last axis (the
    selected one, moved there) the mesh shards: a 1-D array by the
    distributed sort (``mesh_ops.partition``, in ``lax.top_k``'s order of
    floats, ties by position), an n-D one by ``part`` on each process's
    whole lines with the sharding moved to another axis
    (``mesh_ops.across``, in chunks of lines)."""
    n = int(x.shape[-1])
    dt = ((torch.int32 if n < 2**31 - 1 else torch.int64) if positions
          else x.dtype)
    if x.ndim == 1:
        bs, want = _mesh_target(a, tuple(x.shape))
        out = mesh_ops.partition(a.backend, x, kth, want, lambda locs: [
            _top_k_key(locs[0])], positions=positions)
        return _wrap(a, out.to(dt), bs)
    out = mesh_ops.across(a.backend, x, x.ndim - 1, lambda local, dim: (
        _by_rows(part, local, dt)), n, dt, mesh_ops.CHUNK_ELEMENTS)
    return _wrap(a, torch.movedim(out, -1, axis))


def _sharded_last(x):
    return mesh_ops.is_dtensor(x) and bool(mesh_ops.shard_dims(
        x.placements, (x.ndim - 1,)))


def _by_rows(fn, x, out_dtype):
    """``fn`` on row chunks of ``x`` (its last axis whole), into one
    output tensor: the sort's temporaries stay a chunk in size."""
    rows = x.reshape(-1, x.shape[-1])
    out = torch.empty(rows.shape, dtype=out_dtype, device=x.device)
    step = builtins.max(1, mesh_ops.CHUNK_ELEMENTS // builtins.max(
        rows.shape[1], 1))
    for i in range(0, rows.shape[0], step):
        out[i:i + step] = fn(rows[i:i + step])
    return out.reshape(x.shape)


def _top_k_key(x):
    """Integers in ``lax.top_k``'s order of ``x``: a float's bits read as
    a signed integer, the negative ones with their magnitude bits flipped
    (-NaN < -inf < -0 < 0 < inf < NaN); an integer as itself."""
    if not x.is_floating_point():
        return x
    bits = x.view(masking.INT_OF_WIDTH[x.dtype.itemsize])
    return bits ^ ((bits >> (8 * x.dtype.itemsize - 1))
                   & torch.iinfo(bits.dtype).max)


def _top_k_positions(rows, k):
    """Per row, the positions of ``lax.top_k(rows, k)``: the k largest in
    its order, ties by position."""
    return torch.argsort(_top_k_key(rows), dim=-1, stable=True,
                         descending=True)[:, :k]


def partition(a, kth, axis=-1):
    """``jnp.partition``: ``-top_k(-x, kth+1)`` (the kth+1 smallest,
    ascending), then ``top_k(x, n-kth-1)`` (the largest others,
    descending), in ``lax.top_k``'s order of floats."""
    a = _to_ba(a)
    x, kth, axis = _axis_last(a, kth, axis, "partition")

    n = x.shape[-1]

    def part(rows):
        bottom = _top_k_positions(-rows, kth + 1)
        top = _top_k_positions(rows, n - kth - 1)
        return torch.cat([torch.gather(rows, 1, bottom),
                          torch.gather(rows, 1, top)], dim=1)

    if _sharded_last(x):
        return _mesh_select(a, x, kth, axis, part, False)
    out = mesh_ops.like(x, _by_rows(part, _local(x), x.dtype))
    return _wrap(a, torch.movedim(out, -1, axis))


def argpartition(a, kth, axis=-1):
    """``jnp.argpartition``: the positions of ``top_k(-x, kth+1)``, then
    every other position in ascending order; int32, as ``lax.top_k``'s
    indices."""
    a = _to_ba(a)
    x, kth, axis = _axis_last(a, kth, axis, "argpartition")
    n = x.shape[-1]

    def part(rows):
        bottom = _top_k_positions(-rows, kth + 1)
        rest = torch.ones(rows.shape, dtype=torch.int8, device=rows.device)
        rest.scatter_(1, bottom, 0)
        top = torch.argsort(rest, dim=-1, stable=True,
                            descending=True)[:, :n - kth - 1]
        return torch.cat([bottom, top], dim=1).to(
            torch.int32 if n < 2**31 - 1 else torch.int64)

    if _sharded_last(x):
        return _mesh_select(a, x, kth, axis, part, True)
    out = mesh_ops.like(x, _by_rows(part, _local(x), torch.int32))
    return _wrap(a, torch.movedim(out, -1, axis))


def lexsort(keys, axis=-1):
    """``jnp.lexsort``: stable, the last key the primary one; successive
    stable argsorts from the first key to the last (torch has none)."""
    bas = [_to_ba(k) for k in keys]
    if not bas:
        raise TypeError("need sequence of keys with len > 0 in lexsort")
    ts = [b.data for b in bas]
    shape = np.broadcast_shapes(*[tuple(t.shape) for t in ts])
    if len(shape) == 1 and any(mesh_ops.is_dtensor(t) for t in ts) \
            and all(tuple(t.shape) == shape for t in ts):
        # on the mesh: the distributed sort by every key at once
        bs, want = _mesh_target(bas[0], shape)
        out = mesh_ops.lexsort(bas[0].backend, ts, want)
        return _wrap(bas[0], out.to(_index_dtype(bas[0], shape[0])), bs)
    ts = [torch.broadcast_to(t, shape) for t in ts]
    axis = int(axis) % len(shape)
    perm = None
    for t in ts:
        key = t if perm is None else torch.gather(t, axis, perm)
        step = masking.argsort(key, axis)
        perm = step if perm is None else torch.gather(perm, axis, step)
    return _wrap(bas[0], perm.to(_default_int(bas[0])))


def modf(x):
    """``jnp.modf``: (x - whole, whole), whole toward 0 (floor above 0,
    ceil below)."""
    x = _to_ba(x)
    d = _inexact(x.data)
    whole = torch.where(d >= 0, torch.floor(d), torch.ceil(d))
    return (_wrap(x, d - whole, x.block_shape),
            _wrap(x, whole, x.block_shape))


def rot90(m, k=1, axes=(0, 1)):
    m = _to_ba(m)
    return _wrap(m, torch.rot90(m.data, int(k), tuple(axes)))


def rollaxis(a, axis, start=0):
    a = _to_ba(a)
    axis = int(axis) % a.ndim
    start = int(start)
    if not -(a.ndim + 1) <= start <= a.ndim:
        raise ValueError(f"start={start} out of range")
    start %= a.ndim + 1
    if start > axis:
        start -= 1
    return _wrap(a, torch.movedim(a.data, axis, start))


def vecdot(x1, x2, axis=-1):
    """``jnp.vecdot``: ``Σ conj(x1)·x2`` along ``axis``, in the promoted
    dtype."""
    x1, x2 = _to_ba(x1), _to_ba(x2)
    a, b = _promote_all([x1.data, x2.data])
    return _wrap(x1, (a.conj() * b).sum(dim=axis, dtype=a.dtype))


def block(arrays):
    """``jnp.block``: the innermost lists joined along the last axis,
    each level out along the one before, every piece first raised to the
    rank of its level (leading axes of 1)."""

    def build(obj):
        if isinstance(obj, tuple):
            raise ValueError(f"jax.numpy.block does not allow tuples, got "
                             f"{obj}")
        if isinstance(obj, list):
            if not obj:
                raise ValueError("jax.numpy.block does not allow empty list "
                                 "arguments")
            parts = [build(o) for o in obj]
            depths = [d for _, d in parts]
            if builtins.any(d != depths[0] for d in depths):
                raise ValueError("Mismatched list depths in jax.numpy.block")
            ts = _promote_all([t for t, _ in parts])
            rank = builtins.max(depths[0], builtins.max(t.ndim for t in ts))
            ts = [t.reshape((1,) * (rank - t.ndim) + tuple(t.shape))
                  for t in ts]
            return torch.cat(ts, dim=-depths[0]), depths[0] + 1
        return _to_ba(obj).data, 1

    out, _ = build(arrays)
    return BlockArray.from_torch(out, backend=_instance().backend)


def choose(a, choices):
    """``jnp.choose(mode="clip")``: ``a`` clipped to the choices, all
    broadcast, the choices promoted."""
    a = _to_ba(a)
    idx = a.data
    if idx.is_floating_point() or idx.is_complex() or idx.dtype == torch.bool:
        raise ValueError("`a` array must be integer typed")
    ch = _promote_all([_to_ba(c).data for c in choices])
    shape = np.broadcast_shapes(tuple(idx.shape),
                                *[tuple(c.shape) for c in ch])
    idx = torch.broadcast_to(idx.clamp(0, len(ch) - 1).to(torch.int64), shape)
    stacked = torch.stack([torch.broadcast_to(c, shape) for c in ch])
    return _wrap(a, torch.gather(stacked, 0, idx[None])[0])


def _static_positions(obj, n):
    """An int or slice ``obj`` along an axis of length ``n`` as the host
    list of its positions (jnp's static cases)."""
    if isinstance(obj, slice):
        return list(range(*obj.indices(n)))
    obj = int(obj)
    if not -n <= obj < n:
        raise IndexError(f"index {obj} is out of bounds for axis with size "
                         f"{n}")
    return [obj % n]


def delete(arr, obj, axis=None):
    """``jnp.delete``: an int or slice ``obj`` on the device; positions in
    an array through ``np.delete`` on a host copy, as the reference."""
    arr = _to_ba(arr)
    if not isinstance(obj, (int, np.integer, slice)):
        out = np.delete(arr.get(), np.asarray(_to_ba(obj).get(), dtype=int),
                        axis=axis)
        return _instance().array(out, block_shape=None)
    x = arr.data
    if _sharded(x):
        # the kept rows pulled by position along the axis moved first
        bs = None
        if axis is None:
            x, bs = _mesh_flat(arr, x)
            axis = 0
        axis = int(axis) % x.ndim
        n = int(x.shape[axis])
        keep = np.ones(n, dtype=bool)
        keep[_static_positions(obj, n)] = False
        idx = np.nonzero(keep)[0]
        return _wrap(arr, mesh_ops.along(arr.backend, x, axis, lambda t: (
            mesh_ops.gather_rows(arr.backend, t, idx))), bs)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    n = x.shape[axis]
    keep = torch.ones(n, dtype=torch.bool)
    keep[_static_positions(obj, n)] = False
    idx = torch.nonzero(keep)[:, 0].to(x.device)
    return _wrap(arr, torch.index_select(x, axis, idx))


def insert(arr, obj, values, axis=None):
    """``jnp.insert`` (NumPy's rules): an int position inserts ``values``
    as one slab (its leading axis moved to ``axis``), a slice inserts one
    slot per position, on the device; positions in an array through
    ``np.insert`` on a host copy, as the reference."""
    arr = _to_ba(arr)
    if not isinstance(obj, (int, np.integer, slice)):
        out = np.insert(arr.get(), obj,
                        values.get() if hasattr(values, "get") else values,
                        axis=axis)
        return _instance().array(out, block_shape=None)
    x = arr.data if axis is not None else ravel(arr).data
    axis = 0 if axis is None else int(axis) % x.ndim
    n = x.shape[axis]
    v = _to_ba(values).data.to(x.dtype)
    slabs = _sharded_slabs(arr.backend, v, x, axis, obj)
    if slabs is not None:
        v = slabs
    elif mesh_ops.is_dtensor(v):
        # a value that broadcasts: smaller than the slots it fills
        v = arr.backend.rebox(v, arr.backend.replicated()).to_local()
    if slabs is None:
        v = v.reshape((1,) * (x.ndim - v.ndim) + tuple(v.shape))
    if isinstance(obj, slice):
        pos = np.asarray(list(range(*obj.indices(n))), dtype=np.int64)
    else:
        pos = int(obj)
        if not -n <= pos <= n:
            raise IndexError(f"index {pos} is out of bounds for axis {axis} "
                             f"with size {n}")
        pos = pos % n if pos < 0 else pos
        if slabs is None:
            v = torch.movedim(v, 0, axis)
        pos = np.full(v.shape[0 if slabs is not None else axis], pos,
                      dtype=np.int64)
    k = len(pos)
    pos = np.where(pos < 0, pos + n, pos)
    order = np.argsort(pos, kind="stable")
    new_pos = pos.copy()
    new_pos[order] += np.arange(k)
    slot_shape = list(x.shape)
    slot_shape[axis] = k
    if slabs is None:
        v = torch.broadcast_to(v, slot_shape)
    out_shape = list(x.shape)
    out_shape[axis] = n + k
    if mesh_ops.is_dtensor(x):
        return _wrap(arr, _mesh_insert(arr.backend, x, axis, new_pos, v,
                                       tuple(out_shape)))
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    old = np.ones(n + k, dtype=bool)
    old[new_pos] = False
    out.index_copy_(axis, torch.from_numpy(new_pos).to(x.device), v)
    out.index_copy_(axis, torch.from_numpy(np.nonzero(old)[0]).to(x.device),
                    x)
    return _wrap(arr, out)


def _sharded_slabs(backend, v, x, axis, obj):
    """A sharded value of ``insert`` on the mesh that fills the slots
    without broadcasting, as a DTensor with the slots first; else None."""
    if not (mesh_ops.is_dtensor(x) and mesh_ops.is_dtensor(v)
            and any(p.is_shard() for p in v.placements)
            and v.ndim == x.ndim):
        return None
    if isinstance(obj, slice):
        k = len(range(*obj.indices(x.shape[axis])))
        v = mesh_ops.move_axis(backend, v, axis, 0)
    else:
        k = int(v.shape[0])
    rest = tuple(x.shape[:axis]) + tuple(x.shape[axis + 1:])
    return v if tuple(v.shape) == (k,) + rest else None


def _mesh_insert(backend, x, axis, new_pos, v, out_shape):
    """``insert`` on the mesh: ``v`` (the slots' shape: whole, or a
    sharded DTensor with the slots first) at the new positions ``new_pos``
    of ``axis``. Along an axis that no mesh dimension shards each process
    inserts into its own box; along a sharded one the old slabs move to
    their new places by one all-to-all (``mesh_ops.gather_rows``). Each
    process fills the new slots it holds, pulling them from a sharded
    ``v`` (``mesh_ops.pull``)."""
    k = len(new_pos)
    n = out_shape[axis] - k
    src = np.full(n + k, -1, dtype=np.int64)
    old = np.ones(n + k, dtype=bool)
    old[new_pos] = False
    src[old] = np.arange(n)
    slot = np.full(n + k, -1, dtype=np.int64)
    slot[new_pos] = np.arange(k)
    xt = mesh_ops.move_axis(backend, x, axis, 0)
    if any(p.is_shard() and p.dim == 0 for p in xt.placements):
        out = mesh_ops.gather_rows(backend, xt, src)
        box = backend.region(tuple(out.shape), out.placements)
    else:
        local = xt.to_local()
        box = backend.region((n + k,) + tuple(xt.shape[1:]), xt.placements)
        rows = torch.empty((n + k,) + tuple(local.shape[1:]),
                           dtype=local.dtype, device=local.device)
        rows[torch.from_numpy(np.nonzero(old)[0]).to(local.device)] = local
        out = mesh_ops.like(xt, rows, (n + k,) + tuple(xt.shape[1:]))
    local = out.to_local()
    coords = backend.coords()

    def fills(r):  # the new slots that process r holds, by slot
        a, b = backend.region(tuple(out.shape), out.placements, coords[r])[0]
        return torch.from_numpy(slot[a:b][src[a:b] < 0]).reshape(-1, 1)

    a, b = box[0]
    fill = np.nonzero(src[a:b] < 0)[0]
    if mesh_ops.is_dtensor(v):
        vals = mesh_ops.pull(backend, backend.rebox(v, tuple(
            out.placements)), 1, fills(multiprocess.process_index()), fills)
    else:
        vt = torch.movedim(v, axis, 0)
        vals = vt[fills(multiprocess.process_index())[:, 0].to(vt.device)][
            (slice(None),) + tuple(slice(lo, hi) for lo, hi in box[1:])]
    if len(fill):
        local[torch.from_numpy(fill).to(local.device)] = vals.to(local.dtype)
    return mesh_ops.move_axis(backend, out, 0, axis)


def array_equiv(a1, a2):
    a1, a2 = _to_ba(a1), _to_ba(a2)
    try:
        np.broadcast_shapes(a1.shape, a2.shape)
    except ValueError:
        return _instance().scalar(False)
    return _wrap(a1, (a1 == a2).data.all())


# -- set operations (one scalar sync each for the count: masking) -------


def in1d(ar1, ar2):
    return isin(ravel(_to_ba(ar1)), _to_ba(ar2))


def _device_unique_1d(ba, equal_nan=True):
    """Sorted distinct values of a BlockArray as a 1-D BlockArray (the
    empty array through ``np.unique`` on the host, as the reference)."""
    ba = _to_ba(ba)
    if ba.size == 0:
        out = np.unique(ba.get())
        return _instance().array(out, block_shape=out.shape)
    if ba.backend.mesh is not None:
        return mesh_unique([ba], equal_nan=equal_nan)[0]
    _, (vals,) = masking.device_unique(ba, equal_nan=equal_nan)
    return BlockArray.from_torch(vals, backend=ba.backend)


def _compress_by(ba, mask_ba):
    if ba.backend.mesh is not None:
        return ba[mask_ba]
    return ba[_mask_indices_1d(mask_ba, ba.data.device)]


def intersect1d(ar1, ar2):
    ua, ub = _device_unique_1d(ar1), _device_unique_1d(ar2)
    if ua.size == 0 or ub.size == 0:
        return ua if ua.size == 0 else ub
    return _compress_by(ua, isin(ua, ub))


def setdiff1d(ar1, ar2):
    ua = _device_unique_1d(ar1)
    ub = _to_ba(ar2)
    if ua.size == 0 or ub.size == 0:
        return ua
    return _compress_by(ua, ~isin(ua, ub))


def setxor1d(ar1, ar2):
    da, db = setdiff1d(ar1, ar2), setdiff1d(ar2, ar1)
    if da.size == 0:
        return db
    if db.size == 0:
        return da
    if da.backend.mesh is not None:
        # disjoint sorted distinct values: their union is the sort
        return mesh_unique(_same_dtype(da, db))[0]
    return sort(append(da, db))


def union1d(ar1, ar2):
    a, b = _to_ba(ar1), _to_ba(ar2)
    if a.size == 0:
        return _device_unique_1d(b)
    if b.size == 0:
        return _device_unique_1d(a)
    if a.backend.mesh is not None:
        return mesh_unique(_same_dtype(a, b))[0]
    return _device_unique_1d(append(ravel(a), ravel(b)))


def _same_dtype(a, b):
    """[a, b] promoted to one dtype."""
    dt = np.promote_types(a.dtype, b.dtype)
    return [a if a.dtype == dt else a.astype(dt),
            b if b.dtype == dt else b.astype(dt)]


def _unique_result(x, want_index=False, want_inverse=False,
                   want_counts=False, np_probe=np.unique_counts):
    """The ``np.unique_*`` namedtuples: NaNs stay distinct
    (``equal_nan=False``), indices in the default int."""
    x = _to_ba(x)
    result_t = type(np_probe(np.zeros(1)))
    app = _instance()
    if x.size == 0:
        outs = np_probe(np.asarray(x.get()))
        return result_t(*[
            app.array(np.asarray(o), block_shape=np.asarray(o).shape)
            for o in outs
        ])
    if x.backend.mesh is not None:
        return result_t(*mesh_unique([x], want_index, want_inverse,
                                     want_counts, equal_nan=False))
    _, outs = masking.device_unique(
        x, want_index=want_index, want_inverse=want_inverse,
        want_counts=want_counts, equal_nan=False,
    )
    dint = _default_int(x)
    outs = [outs[0]] + [o.to(dint) for o in outs[1:]]
    return result_t(*[BlockArray.from_torch(o, backend=x.backend)
                      for o in outs])


def unique_values(x):
    return _device_unique_1d(x, equal_nan=False)


def unique_counts(x):
    return _unique_result(x, want_counts=True, np_probe=np.unique_counts)


def unique_inverse(x):
    return _unique_result(x, want_inverse=True, np_probe=np.unique_inverse)


def unique_all(x):
    return _unique_result(x, want_index=True, want_inverse=True,
                          want_counts=True, np_probe=np.unique_all)


def trim_zeros(filt, trim="fb"):
    """The first and last nonzero positions on the device, read in two
    scalar syncs, size the slice."""
    filt = _to_ba(filt)
    if filt.size == 0:
        out = np.trim_zeros(np.asarray(filt.get()), trim)
        return _instance().array(out, block_shape=out.shape)
    v = filt.data
    n = v.shape[0]
    lo, hi = 0, n
    if mesh_ops.is_dtensor(v):
        # each process's first and last nonzero rows, one all-reduce
        lo, hi = filt.backend.region(tuple(v.shape), v.placements)[0]
        v = v.to_local()
    nz = v != 0
    if nz.ndim > 1:
        nz = nz.reshape(nz.shape[0], -1).any(dim=1)
    idx = torch.arange(lo, hi, device=v.device)
    ends = torch.stack([torch.where(nz, idx, n).min() if hi > lo
                        else idx.new_tensor(n),
                        -(torch.where(nz, idx + 1, 0).max() if hi > lo
                          else idx.new_tensor(0))])
    if filt.backend.mesh is not None:
        multiprocess.all_reduce_(ends, "min")
    first, last = int(ends[0]), -int(ends[1])
    trim = trim.lower()
    start = first if "f" in trim else 0
    stop = last if "b" in trim else n
    return filt[start:builtins.max(start, stop)]


def _complex_dtype(dt):
    """jax's ``to_complex_dtype``: 64-bit types to complex128, the rest
    to complex64."""
    if dt.is_complex:
        return dt
    return torch.complex128 if dt.itemsize == 8 else torch.complex64


def sort_complex(a):
    """``jnp.sort_complex``: sorted along the last axis (in jnp's order),
    cast to a complex dtype."""
    a = _to_ba(a)
    x = a.data
    if mesh_ops.is_dtensor(x):
        out = sort(a, axis=-1).data
        return _wrap(a, out.to(_complex_dtype(x.dtype)), a.block_shape)
    return _wrap(a, masking.sort(x, -1)[0].to(_complex_dtype(x.dtype)))


# -- polynomials ---------------------------------------------------------


def polyadd(a1, a2):
    """``jnp.polyadd``: the shorter added into the tail of the longer, in
    the promoted dtype."""
    a1, a2 = _to_ba(a1), _to_ba(a2)
    x, y = _promote_all([a1.data, a2.data])
    if x.dtype == torch.bool:
        x, y = x.to(torch.int64), y.to(torch.int64)
    if y.shape[0] > x.shape[0]:
        x, y = y, x
    out = x.clone()
    out[out.shape[0] - y.shape[0]:] += y
    if a1.dtype == np.bool_ and a2.dtype == np.bool_:
        out = out != 0
    return _wrap(a1, out)


def polysub(a1, a2):
    a1, a2 = _to_ba(a1), _to_ba(a2)
    x, y = _promote_all([a1.data, a2.data])
    return polyadd(_wrap(a1, x), _wrap(a2, elementwise.uop(
        "negative", y, a1._default_float())))


def polymul(a1, a2):
    """``jnp.polymul``: the full convolution in the inexact promoted
    dtype."""
    a1, a2 = _to_ba(a1), _to_ba(a2)
    x, y = _inexact_pair(a1.data, a2.data, a1._default_float())
    if len(x) == 0:
        x = torch.zeros(1, dtype=y.dtype, device=y.device)
    if len(y) == 0:
        y = torch.zeros(1, dtype=x.dtype, device=x.device)
    if mesh_ops.is_dtensor(x) or mesh_ops.is_dtensor(y):
        return _mesh_conv(a1, x, y, "full", "convolve")
    return _wrap(a1, _conv(x, y, "full", "convolve"))


def polydiv(u, v):
    """``jnp.polydiv``: long division by ``v``'s leading coefficient."""
    u, v = _to_ba(u), _to_ba(v)
    ud, vd = _inexact_pair(u.data, v.data, u._default_float())
    m, n = len(ud) - 1, len(vd) - 1
    scale = 1.0 / vd[0]
    q = torch.zeros(builtins.max(m - n + 1, 1), dtype=ud.dtype,
                    device=ud.device)
    r = ud.clone()
    for k in range(0, m - n + 1):
        d = scale * r[k]
        q[k] = d
        r[k:k + n + 1] += -d * vd
    return _wrap(u, q), _wrap(u, r)


def polyder(p, m=1):
    """``jnp.polyder``: each coefficient times its falling factorial."""
    p = _to_ba(p)
    m = int(m)
    pd = _inexact(p.data) if not p.data.is_floating_point() else p.data
    if m < 0:
        raise ValueError("Order of derivative must be positive")
    if m == 0:
        return _wrap(p, pd)
    grid = (torch.arange(m, len(pd), device=pd.device).to(pd.dtype)[None]
            - torch.arange(m, device=pd.device).to(pd.dtype)[:, None])
    coeff = grid.prod(dim=0)
    return _wrap(p, pd[:-m] * torch.flip(coeff, (0,)))


def polyint(p, m=1):
    """``jnp.polyint`` with integration constants 0."""
    p = _to_ba(p)
    m = int(m)
    if m < 0:
        raise ValueError("Order of integral must be positive (see polyder)")
    pd = p.data
    if not (pd.is_floating_point() or pd.is_complex()):
        pd = pd.to(p._default_float())
    if m == 0:
        return _wrap(p, pd)
    k = torch.zeros(m, dtype=pd.dtype, device=pd.device)
    grid = (torch.arange(len(pd) + m, device=pd.device).to(pd.dtype)[None]
            - torch.arange(m, device=pd.device).to(pd.dtype)[:, None])
    coeff = torch.flip(torch.clamp(grid, min=1).prod(dim=0), (0,))
    return _wrap(p, torch.cat([pd, k]) / coeff)


def poly(seq_of_zeros):
    """``jnp.poly`` of 1-D roots (one convolution per root); complex
    roots in conjugate pairs give real coefficients (one boolean sync, as
    ``np.poly``). A square matrix's eigenvalues are a host step: ``np.poly``
    on a host copy, as the reference."""
    sz = _to_ba(seq_of_zeros)
    if sz.ndim == 2:
        out = np.poly(np.asarray(sz.get()))
        return _instance().array(out, block_shape=out.shape)
    z = sz.data.reshape(-1)
    if not (z.is_floating_point() or z.is_complex()):
        z = z.to(sz._default_float())
    if _sharded(z):
        return _mesh_poly(sz, z)
    z = _local(z)  # a replicated DTensor: this process's whole copy
    if len(z) == 0:
        return _wrap(sz, torch.ones((), dtype=z.dtype, device=z.device))
    a = torch.ones(1, dtype=z.dtype, device=z.device)
    one = torch.ones(1, dtype=z.dtype, device=z.device)
    for k in range(len(z)):
        a = _conv(a, torch.cat([one, -z[k:k + 1]]), "full", "convolve")
    coeffs = _wrap(sz, a)
    if z.is_complex() and bool((masking.sort(z)[0] == masking.sort(
            z.conj())[0]).all()):
        return real(coeffs)
    return coeffs


def _mesh_poly(sz, z):
    """``poly`` of sharded roots: each process multiplies out its own linear
    factors; the partial polynomials of a row group, each whole on one
    process, are laid out over the mesh (one all-to-all), then multiplied
    in ⌈log2 P⌉ rounds of the sharded ``polymul`` (``_mesh_conv``: the
    shorter operand on a ring). Complex roots in conjugate pairs (the mesh
    sort of z and of conj(z) equal, one all-reduced flag) give real
    coefficients. No process holds z or the result whole."""
    backend = sz.backend
    local = z.to_local()
    part = torch.ones(1, dtype=z.dtype, device=local.device)
    for root in local:
        part = torch.cat([part, part.new_zeros(1)]) - root * torch.cat(
            [part.new_zeros(1), part])
    polys = _laid_out(sz, z, part)
    while len(polys) > 1:
        polys = [_mesh_conv(sz, polys[i], polys[i + 1], "full",
                            "convolve").data if i + 1 < len(polys)
                 else polys[i] for i in range(0, len(polys), 2)]
    out = polys[0]
    if z.is_complex():
        pl = tuple(z.placements)
        conj = mesh_ops.like(z, local.conj().resolve_conj())
        same = (mesh_ops.sort(backend, z, pl).to_local()
                == mesh_ops.sort(backend, conj, pl).to_local()).all()
        if not multiprocess.any_everywhere(~same):
            out = mesh_ops.like(out, out.to_local().real.contiguous())
    return _wrap(sz, out)


def _laid_out(sz, z, part):
    """Each process of a row group of z (the processes that shard it)
    holds ``part``, the polynomial of its own roots; returns the row
    group's polynomials in order, each a DTensor laid out as ``_wrap``
    lays out its shape (one all-to-all: a process sends each other its
    box of its own polynomial)."""
    backend = sz.backend
    coords = backend.coords()
    world = len(coords)
    me = multiprocess.process_index()
    shard = [k for k, p in enumerate(z.placements) if p.is_shard()]

    def members(r):
        return [s for s in range(world) if all(
            coords[s][k] == coords[r][k] for k in range(len(coords[r]))
            if k not in shard)]

    mine = members(me)
    g = mine.index(me)
    sizes = [int(v) for v in multiprocess.all_gather_ints(
        [part.shape[0]])[:, 0]]
    layouts = [((sizes[s],), _mesh_target(sz, (sizes[s],))[1])
               for s in mine]
    send, recv, items = [0] * world, [0] * world, []
    shape, pl = layouts[g]
    for r in range(world):
        if members(r)[g] == me:
            lo, hi = backend.region(shape, pl, coords[r])[0]
            send[r] = hi - lo
            items.append(part[lo:hi])
    for i, s in enumerate(mine):
        shape, pl = layouts[i]
        lo, hi = backend.region(shape, pl)[0]
        recv[s] = hi - lo
    got = multiprocess.exchange(torch.cat(items), send, recv)
    out, at = [], 0
    for i, s in enumerate(mine):
        shape, pl = layouts[i]
        out.append(backend.from_local(got[at:at + recv[s]].contiguous(),
                                      shape, pl))
        at += recv[s]
    return out


def roots(p):
    """``np.roots`` (a general eigenproblem, which the card has no kernel
    for): the coefficients go to the host and the roots come back, as the
    reference's ``pure_callback``; complex unless every root of real
    coefficients is real, and complex64 for float32 coefficients."""
    ba = _to_ba(p)
    cdt = np.result_type(ba.dtype, np.complex64)
    r = np.roots(ba.data.cpu().numpy()).astype(cdt)
    if not np.issubdtype(ba.dtype, np.complexfloating) and np.all(
            r.imag == 0):
        r = r.real
    data = torch.from_numpy(np.ascontiguousarray(r)).to(ba.data.device)
    return BlockArray.from_torch(data, backend=ba.backend)


def real_if_close(a, tol=100):
    """One boolean sync decides the output dtype (it depends on the
    data); the real part is taken on the device."""
    a = _to_ba(a)
    if not np.issubdtype(a.dtype, np.complexfloating):
        return a
    if tol > 1:
        tol = float(tol) * np.finfo(np.dtype(a.dtype).char.lower()).eps
    if bool((torch.abs(a.data.imag) < tol).all()):
        return real(a)
    return a
