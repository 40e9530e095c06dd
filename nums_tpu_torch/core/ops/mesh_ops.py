"""The mesh branch of the data-dependent ops: masks, where/nonzero,
unique, the searches and counts, and host index arrays, on DTensors.

DTensor has no sharding strategy for an op whose output shape depends on
the data (``aten.nonzero``), nor for ``searchsorted``, ``bincount`` or an
index by a host array. Here each process works on its own box and the
processes meet in a few collectives of ``core/multiprocess.py``:

* a mask keeps each process's own rows, then ``MeshBackend.place_rows``
  re-places them (one all-gather of the counts, one all-to-all of the
  rows), so that the result lies as any array of its shape and blocks;
* ``unique`` partitions the values by range (splitters from a sample,
  one all-to-all), takes each range's distinct values where it lands, and
  re-places them; its inverse comes back by the reverse all-to-all;
* a search or a count sums each process's local answer (one all-reduce,
  or a ring where the searched values are sharded);
* a host index array is known to every process, so each works out on the
  host which rows (or elements) it sends where: one all-to-all;
* a slice, a reshape, a join, a flip or a roll moves runs of one global
  sequence of rows (``MeshBackend.move_pieces``): each process knows
  every process's runs, so one all-to-all places them; a stencil takes a
  halo of rows from its neighbours; a sort or an FFT along a sharded
  axis moves the sharding to another axis first (``across``); a sharded
  vector is sorted by a sample sort (``sorted_runs``).

A layout is DTensor's ``placements``; a box is ``MeshBackend.region``. No
function here gathers an operand whole onto a process.
"""

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import masking


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _shard(dim):
    from torch.distributed.tensor import Shard

    return Shard(dim)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def like(t, local, shape=None):
    """``local`` (this process's part) as a DTensor of ``shape`` (default:
    ``t``'s) laid out as ``t``; where ``t`` is a plain tensor, ``local``
    itself."""
    if not is_dtensor(t):
        return local
    from torch.distributed.tensor import DTensor

    shape = tuple(t.shape) if shape is None else tuple(shape)
    stride = tuple(int(np.prod(shape[i + 1:], dtype=np.int64))
                   for i in range(len(shape)))
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def move_axis(backend, t, src, dst):
    """``torch.movedim(t, src, dst)`` of a DTensor built from its local
    part (a contiguous copy) and its placements moved with the axis: no
    communication, and a layout that every process agrees on."""
    ndim = t.ndim
    order = list(range(ndim))
    order.insert(dst, order.pop(src))
    local = torch.movedim(t.to_local(), src, dst).contiguous()
    shape = tuple(int(t.shape[k]) for k in order)
    placements = tuple(_shard(order.index(p.dim)) if p.is_shard() else p
                       for p in t.placements)
    return backend.from_local(local, shape, placements)


def as_dtensor(backend, t, placements):
    """``t`` laid out by ``placements``: a DTensor by ``rebox``, a plain
    tensor (a whole value, the same on every process) cut to this
    process's box."""
    if is_dtensor(t):
        return backend.rebox(t, placements)
    return backend.scatter_full(t, tuple(placements))


def row_layout(placements, k):
    """The placements that hold whole slabs of the first ``k`` axes: a
    mesh dimension that shards axis 1..k-1 shards axis 0 instead (an
    all-to-all, not a gather), one that shards a later axis stays."""
    return tuple(_shard(0) if (p.is_shard() and p.dim < k) else p
                 for p in placements)


def rows_only(placements):
    """Shard(0) where ``placements`` shard axis 0, Replicate elsewhere."""
    return tuple(_shard(0) if (p.is_shard() and p.dim == 0)
                 else _replicate() for p in placements)


def _collapsed(placements, k):
    """``placements`` of an array whose first ``k`` axes became one."""
    return tuple(_shard(p.dim - k + 1) if (p.is_shard() and p.dim >= k)
                 else p for p in placements)


def local_where(mask):
    """``torch.nonzero`` of a local bool tensor as one int64 tensor per
    axis, in row-major order; above ``NONZERO_MAX_ELEMENTS`` a chunk at a
    time."""
    if mask.numel() <= masking.NONZERO_MAX_ELEMENTS:
        return torch.nonzero(mask, as_tuple=True)
    flat = masking._flat_nonzero(mask.reshape(-1))
    idx = []
    for size in reversed(mask.shape):
        idx.append(torch.remainder(flat, size))
        flat = torch.div(flat, size, rounding_mode="floor")
    return tuple(reversed(idx))


def _aligned(backend, data, mask):
    """``data`` and ``mask`` (over its first ``mask.ndim`` axes) laid out
    so that each process holds whole slabs of the masked axes, and the
    mask's rows are the data's."""
    k = mask.ndim
    xp = row_layout(data.placements, k)
    x = backend.rebox(data, xp)
    m = as_dtensor(backend, mask.to(torch.bool), rows_only(xp))
    return x, m, xp


def select(backend, data, mask):
    """``data[mask]`` for a bool mask over the first ``mask.ndim`` axes of
    ``data`` (a DTensor): each process keeps its own masked slabs, then
    ``place_rows``. Returns a DTensor of shape (count,) + the rest."""
    k = mask.ndim
    x, m, xp = _aligned(backend, data, mask)
    local = x.to_local()
    idx = local_where(m.to_local())
    n = int(idx[0].shape[0])
    if k == 1 and n and int(idx[0][-1]) - int(idx[0][0]) + 1 == n:
        # one run of kept rows (a filter by time, say): a view, no copy
        kept = local[int(idx[0][0]):int(idx[0][0]) + n]
    else:
        kept = local[idx]
    return backend.place_rows(kept, tuple(data.shape[k:]),
                              _collapsed(xp, k))


def where(backend, mask, stacked=False, flat=False):
    """``np.where(mask)`` of a DTensor: each process's nonzero of its own
    rows with its row offset added, then ``place_rows``. One int64 DTensor
    per axis (row-major order); with ``stacked`` one (count, ndim) DTensor
    (``argwhere``); with ``flat`` the flat positions (``flatnonzero``)."""
    shape = tuple(mask.shape)
    xp = rows_only(row_layout(mask.placements, len(shape)))
    m = backend.rebox(mask.to(torch.bool), xp)
    r0 = backend.region(shape, xp)[0][0]
    idx = list(local_where(m.to_local()))
    idx[0] = idx[0] + r0
    if flat:
        pos = torch.zeros_like(idx[0])
        for i, size in zip(idx, shape):
            pos = pos * int(size) + i
        return backend.place_rows(pos, (), xp)
    both = torch.stack(idx, dim=1) if idx else torch.zeros(
        (0, 0), dtype=torch.int64, device=m.to_local().device)
    out = backend.place_rows(both, (len(shape),), xp)
    if stacked:
        return out
    local = out.to_local()
    return tuple(backend.from_local(local[:, j].contiguous(),
                                    (int(out.shape[0]),), xp)
                 for j in range(len(shape)))


def assign(backend, data, mask, values):
    """``data[mask] = values`` packed (row-major order of the kept slabs):
    each process takes the part of ``values`` at its kept positions, by
    the prefix sum of the counts (the reverse of ``select``). ``values``
    is a host array or a DTensor that broadcasts to (count,) + the rest
    (``_value_rows``). Returns the new DTensor, laid out as ``data``."""
    k = mask.ndim
    x, m, xp = _aligned(backend, data, mask)
    ml = m.to_local()
    local = x.to_local().clone()
    counts = multiprocess.all_gather_ints([int(ml.sum())])[:, 0]
    vp = _collapsed(xp, k)
    group, _ = backend._row_groups(vp)
    starts, at = {}, 0
    for r in group:
        starts[r] = at
        at += int(counts[r])
    ranges = [(starts.get(r, 0), starts.get(r, 0) + int(counts[r]))
              for r in range(len(counts))]
    shape = (at,) + tuple(data.shape[k:])
    if is_dtensor(values):
        v = _value_rows(backend, values, shape, vp, ranges)
    else:
        lo, hi = ranges[multiprocess.process_index()]
        box = backend.region(shape, vp)
        v = _whole_value(values, shape, local.device)[
            (slice(lo, hi),) + tuple(slice(a, b) for a, b in box[1:])]
    local[local_where(ml)] = v.to(local.dtype)
    out = backend.from_local(local, tuple(data.shape), xp)
    return backend.rebox(out, tuple(data.placements))


def _value_rows(backend, values, shape, placements, ranges):
    """This process's rows ``ranges[me]`` of ``values`` (a DTensor that
    broadcasts to ``shape``) and its box of the other axes under
    ``placements``, broadcast. A value with every row of ``shape`` is
    first laid out as ``placements`` on the axes it does not broadcast,
    then its rows move by ``move_rows``; a value of one row (or none) is
    laid out with its rows whole (one row of the data, not an operand)."""
    d = len(shape) - values.ndim
    if d:
        local = values.to_local()
        values = backend.from_local(
            local.reshape((1,) * d + tuple(local.shape)),
            (1,) * d + tuple(values.shape),
            tuple(_shard(p.dim + d) if p.is_shard() else p
                  for p in values.placements))
    vshape = tuple(values.shape)
    if torch.broadcast_shapes(vshape, shape) != torch.Size(shape):
        raise ValueError(f"a value of shape {vshape} does not broadcast to "
                         f"the {shape} positions assigned")
    by_rows = vshape[0] == shape[0] > 1
    want = tuple(q if q.is_shard() and (vshape[q.dim] > 1 if q.dim
                                        else by_rows) else _replicate()
                 for q in placements)
    v = backend.rebox(values, want)
    rows = v.to_local()
    if by_rows:
        src = [backend.region(vshape, want, c)[0] for c in backend.coords()]
        rows = backend.move_rows(rows, src, ranges, want)
    lo, hi = ranges[multiprocess.process_index()]
    box = backend.region(shape, placements)
    return torch.broadcast_to(rows, (hi - lo,) + tuple(
        b - a for a, b in box[1:]))


# -- unique: a range partition by value ---------------------------------


def _pack(cols):
    """Columns of equal length (any dtypes) as one (n, bytes) uint8
    tensor, and how to unpack it."""
    parts, spec = [], []
    for c in cols:
        c = (c.reshape(c.shape[0], int(np.prod(c.shape[1:])))
             if c.dim() > 1 else c.reshape(-1, 1))
        b = multiprocess._as_bytes(c)
        parts.append(b)
        spec.append((c.dtype, int(c.shape[1]), int(b.shape[1])))
    return torch.cat(parts, dim=1), spec


def _unpack(packed, spec):
    out, at = [], 0
    for dtype, width, nbytes in spec:
        col = packed[:, at:at + nbytes].clone().reshape(-1).view(dtype)
        out.append(col.reshape(-1, width) if width > 1 else col)
        at += nbytes
    return out


def _partition_key(v):
    """int64 keys in the order of ``masking.sort`` (jnp's): floats by
    ``total_order_key``, complex numbers by their real part's; equal
    values get equal keys."""
    if v.is_complex():
        v = v.real
    if v.is_floating_point():
        return masking.total_order_key(v).to(torch.int64)
    return v.to(torch.int64)


def _splitters(keys, world):
    """world - 1 keys that cut the values into ranges of about equal
    size: each process offers world - 1 keys at even steps of its sorted
    keys, weighted by its count (one all-gather)."""
    n = int(keys.numel())
    ks = torch.sort(keys)[0]
    picks = [int(ks[min(n - 1, (i + 1) * n // world)]) if n else 0
             for i in range(world - 1)]
    table = multiprocess.all_gather_ints([n] + picks)
    counts, offers = table[:, 0], table[:, 1:]
    cand, weight = [], []
    for c, row in zip(counts, offers):
        if c:
            cand.extend(row.tolist())
            weight.extend([c / world] * (world - 1))
    if not cand:
        return np.zeros(world - 1, dtype=np.int64)
    order = np.argsort(cand, kind="stable")
    cand = np.asarray(cand, dtype=np.int64)[order]
    cum = np.cumsum(np.asarray(weight)[order])
    total = cum[-1]
    return np.array([cand[min(len(cand) - 1, int(np.searchsorted(
        cum, (j + 1) * total / world)))] for j in range(world - 1)],
        dtype=np.int64)


def _flat_positions(backend, data):
    """The global flat position of each element of this process's box."""
    shape = tuple(data.shape)
    box = backend.region(shape, data.placements)
    dev = data.to_local().device
    pos = torch.zeros((), dtype=torch.int64, device=dev)
    for (a, b), size in zip(box, shape):
        pos = pos.unsqueeze(-1) * int(size) + torch.arange(
            a, b, dtype=torch.int64, device=dev)
    return pos.reshape(-1)


def _replicas_from_first(backend, tensor, placements):
    """``tensor`` on every process of this box from the first that holds
    it (one broadcast along each mesh dimension it is replicated on)."""
    import torch.distributed as dist

    for k, p in enumerate(placements):
        if not p.is_shard() and backend.device_grid.mesh_shape[k] > 1:
            group = backend.mesh.get_group(k)
            src = dist.get_global_rank(group, 0)
            dist.broadcast(multiprocess.sent("broadcast", tensor, group),
                           src=src, group=group)
    return tensor


def unique(backend, datas, want_index=False, want_inverse=False,
           want_counts=False, equal_nan=True):
    """``np.unique`` of the elements of one or more DTensors (of one
    dtype), in ``masking.device_unique``'s order and conventions.

    Each process sends each of its elements (with its flat position) to
    the process that owns the element's range of values (``_splitters``);
    there equal values meet and the distinct ones, their first positions
    and counts are local; ``place_rows`` then lays them out in order. The
    inverse (of one operand) is each owner's run index plus the distinct
    values before it, sent back by the reverse all-to-all. Returns
    [values, index?, inverse?, counts?] as DTensors (the inverse laid out
    as the input)."""
    world = backend.device_grid.num_devices
    vals, pos, sizes = [], [], []
    for data in datas:
        here = backend.counts_here(data.placements)
        v = data.to_local().reshape(-1) if here else \
            data.to_local().reshape(-1)[:0]
        vals.append(v)
        pos.append(_flat_positions(backend, data)[:v.numel()])
        sizes.append(int(v.numel()))
    v = torch.cat(vals) if len(vals) > 1 else vals[0]
    p = torch.cat(pos) if len(pos) > 1 else pos[0]
    if v.is_complex():
        # jnp.unique takes every complex NaN as nan+0j
        v = torch.where(torch.isnan(v), v.new_tensor(complex(
            float("nan"), 0.0)), v)
    key = _partition_key(v)
    spl = torch.from_numpy(_splitters(key, world)).to(key.device)
    dest = torch.searchsorted(spl, key, right=True)
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=world).cpu().numpy()
    recv = multiprocess.all_gather_ints(send)[:, multiprocess.process_index()]
    packed, spec = _pack([v[order], p[order]])
    got_v, got_p = _unpack(multiprocess.exchange(packed, send, recv), spec)
    # Equal values in order of position, so that a run's first element is
    # its first occurrence (and the value NumPy reports for -0.0 and 0.0).
    by_pos = torch.argsort(got_p, stable=True)
    s, perm = masking.sort(got_v[by_pos])
    perm = by_pos[perm]
    starts = masking._distinct_starts(s, equal_nan)
    first = masking._flat_nonzero(starts)
    n_here = int(first.shape[0])
    cols = [s[first]]
    if want_index:
        cols.append(got_p[perm][first])
    if want_counts:
        ends = torch.cat([first[1:], first.new_tensor([s.numel()])])
        cols.append(ends - first)
    packed, spec = _pack(cols)
    placed = backend.place_rows(packed, (packed.shape[1],),
                                (_shard(0),) * len(backend.mesh.shape))
    local = _unpack(placed.to_local(), spec)
    total = int(placed.shape[0])
    outs = [backend.from_local(c.contiguous(), (total,), placed.placements)
            for c in local]
    if want_inverse:
        before = multiprocess.all_gather_ints([n_here])[:, 0]
        offset = int(before[:multiprocess.process_index()].sum())
        run = torch.cumsum(starts.to(torch.int64), 0) - 1 + offset
        inv = torch.empty_like(run)
        inv[perm] = run
        back = multiprocess.exchange(inv, recv, send)
        mine = torch.empty_like(back)
        mine[order] = back
        data = datas[0]
        local = data.to_local()
        out = torch.empty(tuple(local.shape), dtype=torch.int64,
                          device=local.device)
        if backend.counts_here(data.placements):
            out.copy_(mine[:sizes[0]].reshape(tuple(local.shape)))
        _replicas_from_first(backend, out, data.placements)
        outs.insert(2 if want_index else 1, backend.from_local(
            out, tuple(data.shape), tuple(data.placements)))
    return total, outs


# -- searches and counts --------------------------------------------------


def _local_count(seq_local, here, values, right):
    """How many of this process's elements of a sorted sequence lie below
    each value (``searchsorted``'s count); 0 where another process holds
    the same box."""
    if not here or seq_local.numel() == 0:
        return torch.zeros(tuple(values.shape), dtype=torch.int64,
                           device=values.device)
    return masking.searchsorted(seq_local, values.reshape(-1),
                                right=right).reshape(tuple(values.shape))


def summed_counts(backend, seq, values, count):
    """``count(seq_local, here, v)`` (int64, the shape of v) summed over
    every process's box of ``seq`` (a 1-D DTensor) for each value. For
    ``values`` whole on every process (a plain tensor, or a replicated
    DTensor): one all-reduce. For sharded ``values``: each process's
    values travel around the ring of processes with their running sum,
    P - 1 steps, and the sums go home in one more. Returns a tensor (or
    DTensor) laid out as ``values``."""
    here = backend.counts_here(seq.placements)
    seq_local = seq.to_local()
    if not is_dtensor(values) or all(not p.is_shard()
                                     for p in values.placements):
        local = values.to_local() if is_dtensor(values) else values
        acc = multiprocess.all_reduce_(count(seq_local, here, local))
        if is_dtensor(values):
            return backend.from_local(acc, tuple(values.shape),
                                      tuple(values.placements))
        return acc
    world = backend.device_grid.num_devices
    me = multiprocess.process_index()
    mine = values.to_local()
    sizes = multiprocess.all_gather_ints([mine.numel()])[:, 0]
    chunk = mine.reshape(-1)
    acc = count(seq_local, here, chunk)
    for step in range(1, world):
        packed, spec = _pack([chunk, acc])
        packed = multiprocess.ring_shift(packed,
                                         int(sizes[(me - step) % world]))
        chunk, acc = _unpack(packed, spec)
        acc = acc + count(seq_local, here, chunk)
    if world > 1:
        acc = multiprocess.ring_shift(acc, int(sizes[me]))
    return backend.from_local(acc.reshape(tuple(mine.shape)),
                              tuple(values.shape), tuple(values.placements))


def searchsorted(backend, seq, values, right=False):
    """``masking.searchsorted`` of a sharded sorted 1-D ``seq``: the
    sum over processes of each one's count below the value."""
    def count(local, here, v):
        return _local_count(local, here, v, right)

    return summed_counts(backend, seq, values, count)


def isin(backend, test, values):
    """For each value, whether it equals an element of ``test`` (a
    DTensor): each process's elements, sorted locally, counted at the
    value from both sides, summed (``summed_counts``); NaN is in
    nothing."""
    def count(local, here, v):
        return (_local_count(local, here, v, True)
                - _local_count(local, here, v, False))

    local = test.to_local().reshape(-1)
    if backend.counts_here(test.placements) and local.numel():
        local = masking.sort(local)[0]
    hits = summed_counts(backend, _Part(test.placements, local), values,
                         count)
    local = hits.to_local() if is_dtensor(hits) else hits
    vl = values.to_local() if is_dtensor(values) else values
    res = (local > 0) & ~torch.isnan(vl) if (vl.is_floating_point()
                                             or vl.is_complex()) \
        else local > 0
    if is_dtensor(hits):
        return backend.from_local(res, tuple(hits.shape),
                                  tuple(hits.placements))
    return res


class _Part:
    """A process's part of a sharded sequence, as ``summed_counts`` reads
    it: its placements (whether it counts) and its local elements."""

    def __init__(self, placements, local):
        self.placements = tuple(placements)
        self._local = local

    def to_local(self):
        return self._local


def global_min_max(data):
    """(min, max) of a DTensor's values over every process (an all-reduce
    MIN and one MAX); a process with an empty box offers the identities.
    Integers and bools are compared as int64, exactly."""
    local = data.to_local().reshape(-1)
    wide = local.dtype if local.is_floating_point() else torch.int64
    local = local.to(wide)
    if local.numel():
        lo, hi = local.min().reshape(1), local.max().reshape(1)
    else:
        info = (torch.finfo if wide.is_floating_point else torch.iinfo)(wide)
        lo = torch.full((1,), info.max, dtype=wide, device=local.device)
        hi = torch.full((1,), info.min, dtype=wide, device=local.device)
    multiprocess.all_reduce_(lo, "min")
    multiprocess.all_reduce_(hi, "max")
    return lo[0].to(data.dtype), hi[0].to(data.dtype)


def local_counted(data):
    """This process's elements of a DTensor, flattened, where its box
    counts in a sum over the mesh; none where another process holds the
    same box (it is replicated on a mesh dimension where this process's
    coordinate is not 0)."""
    local = data.to_local().reshape(-1).contiguous()
    coord = data.device_mesh.get_coordinate()
    here = all(p.is_shard() or c == 0
               for p, c in zip(data.placements, coord))
    return local if here else local[:0]


# -- moving items by position --------------------------------------------


def _inside(box, pos):
    """Whether each position ((n, k) int64 tensor) lies in the first k
    ranges of ``box``."""
    hit = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for j, (a, b) in enumerate(box[:pos.shape[1]]):
        hit &= (pos[:, j] >= a) & (pos[:, j] < b)
    return hit


def _senders(backend, data, k, pos, receiver):
    """For each position ((n, k) int64 tensor over the first ``k`` axes of
    the DTensor ``data``), the process that sends it to ``receiver``: the
    one that holds it and agrees with the receiver on every mesh dimension
    that shards none of those axes (a replica serves its own replicas, a
    column block its own column block)."""
    coords = backend.coords()
    pl = tuple(data.placements)
    routed = {m for m, p in enumerate(pl) if p.is_shard() and p.dim < k}
    out = torch.full((pos.shape[0],), -1, dtype=torch.int64,
                     device=pos.device)
    for s, c in enumerate(coords):
        if all(c[m] == coords[receiver][m] for m in range(len(c))
               if m not in routed):
            out[_inside(backend.region(tuple(data.shape), pl, c), pos)] = s
    return out


def pull(backend, data, k, wants, every=None):
    """The mesh's one move of items by position: ``data`` (a DTensor) at
    ``wants``, an (n, k) int64 tensor of this process's positions over its
    first ``k`` axes; returns the (n,) + local trailing shape items in
    that order, each from its sender (``_senders``). Where every process
    knows what every other wants (a host index array), ``every(r)`` gives
    process r's positions, each process works out what it sends, and one
    all-to-all moves the items; else the positions travel to the senders
    first (two all-to-alls). A write is a pull by the writers."""
    me = multiprocess.process_index()
    world = backend.device_grid.num_devices
    src = _senders(backend, data, k, wants, me)
    order = torch.argsort(src, stable=True)
    recv = torch.bincount(src, minlength=world).cpu().numpy()
    if every is None:
        send = multiprocess.all_gather_ints(recv)[:, me]
        asked = multiprocess.exchange(wants[order], recv, send)
    else:
        asked = []
        for r in range(world):
            w = wants if r == me else every(r)
            asked.append(w[_senders(backend, data, k, w, r) == me])
        send = [int(a.shape[0]) for a in asked]
        asked = torch.cat(asked)
    local = data.to_local()
    box = backend.region(tuple(data.shape), data.placements)
    asked = asked.to(local.device)
    items = local[tuple(asked[:, j] - box[j][0] for j in range(k))]
    del asked
    got = multiprocess.exchange(items, send, recv)
    del items  # a slab's worth of rows gone before the result's
    out = torch.empty_like(got)
    out[order.to(got.device)] = got
    return out


def _positions(flat, shape):
    """Flat positions (int64 tensor) as (n, len(shape)) coordinates."""
    return torch.stack(torch.unravel_index(flat, tuple(shape)), dim=1)


def gather_rows(backend, data, idx):
    """``data[idx]`` for a host int array ``idx`` of rows (negative: a
    hole, left unset), laid out as ``data``: each process pulls the rows
    of its box of the result (``pull``, one all-to-all)."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    shape = (int(idx.shape[0]),) + tuple(data.shape[1:])
    pl = tuple(data.placements)
    coords = backend.coords()

    def wants(r):
        a, b = backend.region(shape, pl, coords[r])[0]
        w = torch.from_numpy(idx[a:b])
        return w[w >= 0].reshape(-1, 1)

    a, b = backend.region(shape, pl)[0]
    got = pull(backend, data, 1, wants(multiprocess.process_index()),
               wants)
    out = got.new_empty((b - a,) + tuple(got.shape[1:]))
    out[torch.from_numpy(np.nonzero(idx[a:b] >= 0)[0]).to(
        out.device)] = got
    return backend.from_local(out, shape, pl)


def diagonal_matrix(backend, v, k, shape, placements):
    """The (N, N) matrix ``shape`` holding the elements of the DTensor
    ``v``, in its flat row-major order, on its k-th diagonal and zeros
    elsewhere, laid out by ``placements``: each process writes the
    diagonal entries of its own box, the elements of ``v`` that fall
    there pulled from their holders (``pull``, one all-to-all: every box
    is known everywhere). No process holds ``v`` or the matrix whole."""
    k = int(k)
    r0, c0 = max(0, -k), max(0, k)
    vshape = tuple(v.shape)
    total = int(np.prod(vshape, dtype=np.int64))
    coords = backend.coords()

    def span(coord):
        (a, b), (c, e) = backend.region(tuple(shape), placements, coord)
        lo = max(a - r0, c - c0, 0)
        return lo, max(lo, min(b - r0, e - c0, total))

    def wants(coord):
        return _positions(torch.arange(*span(coord), dtype=torch.int64),
                          vshape)

    got = pull(backend, v, len(vshape), wants(coords[
        multiprocess.process_index()]), lambda r: wants(coords[r]))
    (a, b), (c, e) = backend.region(tuple(shape), placements)
    local = got.new_zeros((b - a, e - c))
    i = torch.arange(*span(None), dtype=torch.int64, device=local.device)
    local[i + r0 - a, i + c0 - c] = got
    return backend.from_local(local, tuple(shape), tuple(placements))


def gather_elements(backend, data, coord, shape, placements):
    """``data`` at the element coordinates ``coord`` ((n, ndim) host
    ints, in the row-major order of a result of ``shape``), laid out by
    ``placements``: each process pulls the elements of its box of the
    result (one all-to-all)."""
    coord = torch.from_numpy(np.ascontiguousarray(coord))
    coords = backend.coords()

    def wants(r):
        box = backend.region(shape, placements, coords[r])
        at = torch.arange(coord.shape[0]).reshape(shape)[
            tuple(slice(a, b) for a, b in box)].reshape(-1)
        return coord[at]

    box = backend.region(shape, placements)
    got = pull(backend, data, data.ndim, wants(multiprocess.process_index()),
               wants)
    return backend.from_local(got.reshape(tuple(b - a for a, b in box)),
                              shape, tuple(placements))


def _whole_value(values, shape, device):
    """A host, plain-tensor or replicated value (never a sharded DTensor)
    broadcast to ``shape``, on this process's device."""
    if is_dtensor(values):
        values = values.to_local()
    if torch.is_tensor(values):
        return torch.broadcast_to(values.to(device), tuple(shape))
    return torch.as_tensor(np.broadcast_to(np.asarray(values), tuple(
        shape)).copy(), device=device)


def _is_sharded(values):
    return is_dtensor(values) and any(p.is_shard() for p in values.placements)


def _held(backend, data, pos):
    """For each process, the indices of the positions ((n, k) tensor) that
    its box of ``data`` holds."""
    coords = backend.coords()
    shape, pl = tuple(data.shape), tuple(data.placements)
    return lambda r: torch.nonzero(_inside(backend.region(
        shape, pl, coords[r]), pos))[:, 0]


def scatter_rows(backend, data, idx, values):
    """``data[idx] = values`` for a host int array of rows: each process
    writes the rows it holds (every holder of a replicated row). A host or
    whole ``values`` needs no communication; the holders pull a sharded
    DTensor of the indexed shape, laid out as ``data``, by one
    all-to-all. Returns the new DTensor, laid out as ``data``."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    shape = (int(idx.shape[0]),) + tuple(data.shape[1:])
    pl = tuple(data.placements)
    box = backend.region(tuple(data.shape), pl)
    local = data.to_local().clone()
    held = _held(backend, data, torch.from_numpy(idx).reshape(-1, 1))
    mine = held(multiprocess.process_index())
    if _is_sharded(values):
        if tuple(values.shape) != shape:
            raise NotImplementedError(
                "index assignment on the mesh: a sharded value must have "
                f"the indexed shape {shape}, not {tuple(values.shape)}")
        v = pull(backend, backend.rebox(values, pl), 1, mine.reshape(-1, 1),
                 lambda r: held(r).reshape(-1, 1))
    else:
        sub = tuple(slice(a, b) for a, b in box[1:])
        v = _whole_value(values, shape, local.device)[
            (mine.to(local.device),) + sub]
    rows = torch.from_numpy(idx).to(local.device)[mine.to(local.device)]
    local[rows - box[0][0]] = v.to(local.dtype)
    return backend.from_local(local, tuple(data.shape), pl)


def basic_positions(shape, key):
    """Per axis, the positions that a key of ints and slices (no
    ``None``) selects, and whether the axis stays in the result; None for
    any other key."""
    key = key if isinstance(key, tuple) else (key,)
    if any(k is None or isinstance(k, (np.ndarray, list)) for k in key):
        return None
    if sum(k is Ellipsis for k in key) > 1:
        return None
    if Ellipsis in key:
        at = key.index(Ellipsis)
        key = key[:at] + (slice(None),) * (len(shape) - len(key) + 1) \
            + key[at + 1:]
    key = key + (slice(None),) * (len(shape) - len(key))
    if len(key) != len(shape):
        raise IndexError(f"too many indices for an array of {len(shape)} "
                         "dimensions")
    out = []
    for k, n in zip(key, shape):
        if isinstance(k, slice):
            out.append((np.arange(n, dtype=np.int64)[k], True))
        elif isinstance(k, (int, np.integer)):
            if not -n <= int(k) < n:
                raise IndexError(f"index {int(k)} is out of bounds for an "
                                 f"axis of size {n}")
            out.append((np.array([int(k) % n], dtype=np.int64), False))
        else:
            return None
    return out


def scatter_basic(backend, data, positions, values):
    """``data[key] = values`` for a key of ints and slices
    (``basic_positions``) and a host or whole value: each process writes
    the part of the selection inside its box, with no communication and
    no coordinate array of the selection's size."""
    pl = tuple(data.placements)
    box = backend.region(tuple(data.shape), pl)
    local = data.to_local().clone(memory_format=torch.contiguous_format)
    shape = tuple(len(p) for p, kept in positions if kept)
    full = _whole_value(values, shape, local.device)
    mine, where, at = [], [], []
    for (pos, kept), (lo, hi) in zip(positions, box):
        t = np.nonzero((pos >= lo) & (pos < hi))[0]
        where.append(torch.from_numpy(pos[t] - lo).to(local.device))
        if kept:
            at.append(torch.from_numpy(t).to(local.device))
        mine.append(len(t))
    if all(mine):
        v = full[torch.meshgrid(*at, indexing="ij")] if at else full
        local[torch.meshgrid(*where, indexing="ij")] = v.reshape(
            mine).to(local.dtype)
    return backend.from_local(local, tuple(data.shape), pl)


def scatter_elements(backend, data, coord, shape, values):
    """``data`` with the elements at ``coord`` (in the row-major order of
    an index result of ``shape``) set from ``values``, broadcast to
    ``shape``: a host or whole value is written by every holder without
    communication; the holders pull a sharded DTensor value of ``shape``
    (one all-to-all). Returns the new DTensor."""
    dshape, dp = tuple(data.shape), tuple(data.placements)
    box = backend.region(dshape, dp)
    local = data.to_local().clone(memory_format=torch.contiguous_format)
    pos = torch.from_numpy(np.ascontiguousarray(coord))
    held = _held(backend, data, pos)
    t = held(multiprocess.process_index())
    if _is_sharded(values):
        if tuple(values.shape) != tuple(shape):
            raise NotImplementedError(
                "index assignment on the mesh: a sharded value must have "
                f"the indexed shape {tuple(shape)}")
        v = pull(backend, values, values.ndim, _positions(t, shape),
                 lambda r: _positions(held(r), shape))
    else:
        v = _whole_value(values, shape, local.device).reshape(-1)[
            t.to(local.device)]
    at = (pos[t] - torch.tensor([a for a, _ in box])).to(local.device)
    local[tuple(at.T)] = v.to(local.dtype)
    return backend.from_local(local, dshape, dp)


def take(backend, seq, idx):
    """``seq[idx]`` for a 1-D DTensor ``seq`` and this process's int64
    tensor ``idx`` (any shape; positions in [0, len(seq))): ``pull``, with
    the positions sent to their holders first, since every process may
    ask for different ones."""
    flat = idx.reshape(-1, 1).to(torch.int64)
    return pull(backend, seq, 1, flat).reshape(tuple(idx.shape))


# -- reductions along a sharded axis: order statistics and scans ---------


def shard_dims(placements, axes):
    """The mesh dimensions whose placement shards one of ``axes``."""
    return [k for k, p in enumerate(placements)
            if p.is_shard() and p.dim in tuple(axes)]


def group_reduce(backend, tensor, dims, op="sum"):
    """``tensor`` replaced in place by its ``op`` (sum, min, max) over the
    processes that differ from this one only on the mesh dimensions
    ``dims``: one all-reduce over each of them, in order."""
    import torch.distributed as dist

    if not multiprocess.is_multiprocess():
        return tensor
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    for k in dims:
        if backend.device_grid.mesh_shape[k] > 1:
            group = backend.mesh.get_group(k)
            dist.all_reduce(multiprocess.sent("all_reduce", tensor, group),
                            op=red, group=group)
    return tensor


def _key_bounds(backend, keys):
    """(min, max) of int64 keys over every process, as Python ints (an
    empty box offers the identities)."""
    info = torch.iinfo(torch.int64)
    flat = keys.reshape(-1)
    lo = flat.min().reshape(1) if flat.numel() else torch.full(
        (1,), info.max, dtype=torch.int64, device=keys.device)
    hi = flat.max().reshape(1) if flat.numel() else torch.full(
        (1,), info.min, dtype=torch.int64, device=keys.device)
    multiprocess.all_reduce_(lo, "min")
    multiprocess.all_reduce_(hi, "max")
    return int(lo[0]), int(hi[0])


def order_statistics(backend, keys, ranks, dims):
    """The keys of the given ranks (0-based, in increasing order) along
    the last axis of ``keys``, over the processes of the mesh dimensions
    ``dims``: ``keys`` is this process's (..., m) int64 part, ``ranks`` a
    (q, ...) int64 tensor; returns (q, ...) keys. A bisection on the key
    range, one all-reduce of the counts at or below the midpoint a step,
    as many steps as the range has bits: no value leaves its process."""
    lo0, hi0 = _key_bounds(backend, keys)
    if hi0 < lo0:  # nothing anywhere
        return torch.zeros(tuple(ranks.shape), dtype=torch.int64,
                           device=keys.device)
    lo = torch.full(tuple(ranks.shape), lo0, dtype=torch.int64,
                    device=keys.device)
    hi = torch.full_like(lo, hi0)
    want = ranks.to(device=keys.device, dtype=torch.int64) + 1
    for _ in range(max(1, (hi0 - lo0).bit_length() + 1)):
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        count = torch.stack([(keys <= m[..., None]).sum(dim=-1)
                             for m in mid])
        group_reduce(backend, count, dims)
        ok = count >= want
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid + 1)
    return lo


def key_values(keys, dtype):
    """The floats of ``masking.total_order_key``'s keys (int64 tensor):
    the key is its own inverse on the bits."""
    dt = masking.INT_OF_WIDTH[torch.empty((), dtype=dtype).element_size()]
    bits = keys.to(dt)
    width = 8 * bits.element_size()
    return (bits ^ ((bits >> (width - 1)) & torch.iinfo(dt).max)).view(dtype)


def select_ranks(backend, local, ranks, dims):
    """The values of the given ranks along the last axis of this process's
    float part ``local`` (jnp's sort order: NaN last), over the mesh
    dimensions ``dims`` (``order_statistics``)."""
    keys = masking.total_order_key(local).to(torch.int64)
    return key_values(order_statistics(backend, keys, ranks, dims),
                      local.dtype)


def _all_gather_var(tensor):
    """Every process's ``tensor`` (any dtype and shape; flattened), in
    rank order: one all-gather of the byte counts and one of the bytes,
    padded to the longest."""
    import torch.distributed as dist

    flat = tensor.reshape(-1).contiguous()
    if not multiprocess.is_multiprocess():
        return [flat]
    raw = flat.view(torch.uint8) if flat.numel() else flat.new_empty(
        (0,), dtype=torch.uint8)
    sizes = multiprocess.all_gather_ints([int(raw.numel())])[:, 0]
    pad = raw.new_zeros((max(1, int(sizes.max())),))
    pad[:raw.numel()] = raw
    parts = [torch.empty_like(pad) for _ in range(len(sizes))]
    dist.all_gather(parts, multiprocess.sent("all_gather", pad))
    return [p[:int(n)].view(tensor.dtype) for p, n in zip(parts, sizes)]


def scan(backend, data, axis, fn, combine):
    """``fn(local, dim=axis)`` (a cumulative sum or product) of the DTensor
    ``data`` along ``axis``: each process scans its own box, then adds (or
    multiplies by) the totals of the boxes before it along the axis, in
    order (one all-gather of each process's last slice). ``combine`` is
    ``"sum"`` or ``"prod"``."""
    pl = tuple(data.placements)
    shape = tuple(data.shape)
    local = fn(data.to_local(), dim=axis)
    dims = shard_dims(pl, (axis,))
    if not dims:
        return backend.from_local(local, shape, pl)
    n = int(local.shape[axis])
    if n:
        last = local.narrow(axis, n - 1, 1)
    else:
        box = list(local.shape)
        box[axis] = 1
        last = (torch.zeros if combine == "sum" else torch.ones)(
            box, dtype=local.dtype, device=local.device)
    moved = torch.movedim(last, axis, 0).contiguous()
    every = _all_gather_var(moved)
    coords = backend.coords()
    me = multiprocess.process_index()
    boxes = [backend.region(shape, pl, c) for c in coords]
    mine = boxes[me]
    before = sorted((boxes[r][axis][0], r) for r in range(len(coords))
                    if all(coords[r][k] == coords[me][k]
                           for k in range(len(coords[me])) if k not in dims)
                    and boxes[r][axis][0] < mine[axis][0]
                    and boxes[r][axis][1] > boxes[r][axis][0])
    if not before:
        return backend.from_local(local, shape, pl)
    off = None
    for _, r in before:
        t = every[r].reshape(moved.shape).to(local.device)
        off = t if off is None else (off + t if combine == "sum"
                                     else off * t)
    off = torch.movedim(off, 0, axis)
    out = local + off if combine == "sum" else local * off
    return backend.from_local(out, shape, pl)


# -- moving rows along an axis: repeat, pad ----------------------


def along_rows(backend, data, axis, length, local_fn):
    """A DTensor whose ``axis`` becomes ``length`` long: ``local_fn(rows)``
    maps this process's slab of rows ``[a, b)`` along the axis (the axis
    moved first) to the result's rows ``[r·a, r·b)`` for a fixed ratio r;
    the rows then move to the result's layout (one all-to-all within each
    row group). The other axes keep their boxes."""
    t = move_axis(backend, data, axis, 0)
    pl = tuple(t.placements)
    shape = (int(length),) + tuple(t.shape[1:])
    coords = backend.coords()
    ratio = int(length) // max(int(t.shape[0]), 1)
    src = [tuple(v * ratio for v in backend.region(tuple(t.shape), pl,
                                                    c)[0]) for c in coords]
    dst = [backend.region(shape, pl, c)[0] for c in coords]
    rows = backend.move_rows(local_fn(t.to_local()), src, dst, pl)
    out = backend.from_local(rows.contiguous(), shape, pl)
    return move_axis(backend, out, 0, axis)


def pad_axis(backend, data, axis, before, after, source, fill=None):
    """``data`` padded along a sharded ``axis`` by ``before`` and
    ``after``: ``source(i)`` gives, for output positions ``i`` (an int64
    tensor), the input position each copies, or -1 for ``fill`` (the
    constant mode). A run of copied rows moves by one all-to-all within
    the row group (``move_rows``: the constant mode); any other map
    (edge, wrap, reflect, symmetric) by one ``pull``."""
    t = move_axis(backend, data, axis, 0)
    pl = tuple(t.placements)
    n = int(t.shape[0])
    shape = (n + int(before) + int(after),) + tuple(t.shape[1:])
    coords = backend.coords()
    me = multiprocess.process_index()
    o0, o1 = backend.region(shape, pl)[0]
    local = t.to_local()
    if fill is not None:
        src = [backend.region(tuple(t.shape), pl, c)[0] for c in coords]

        def run(c):
            a, b = backend.region(shape, pl, c)[0]
            lo, hi = max(a - before, 0), min(b - before, n)
            return (lo, max(lo, hi))

        dst = [run(c) for c in coords]
        rows = backend.move_rows(local, src, dst, pl)
        out = torch.full((o1 - o0,) + tuple(local.shape[1:]), fill,
                         dtype=local.dtype, device=local.device)
        lo, hi = dst[me]
        at = lo + before - o0
        out[at:at + (hi - lo)] = rows
    else:
        def wants(r):
            a, b = backend.region(shape, pl, coords[r])[0]
            return source(torch.arange(a, b, dtype=torch.int64,
                                       device=local.device)).reshape(-1, 1)

        out = pull(backend, t, 1, wants(me), wants)
    res = backend.from_local(out.contiguous(), shape, pl)
    return move_axis(backend, res, 0, axis)


# -- device index arrays: reads and writes by position --------------------


def device_positions(backend, arrays, shape, n, placements):
    """The (m, k) int64 positions over the first k axes of an array of
    ``shape`` at this process's box of a 1-D key of length ``n`` laid out
    by ``placements``: ``arrays`` holds one entry per axis, a Python int
    or an int tensor (plain, whole on every process, or a DTensor) of
    length n or 1, broadcast. Negative positions count from the end, and
    every position is clamped into its axis, as jax's gather clamps."""
    a, b = backend.region((n,), placements)[0]
    dev = backend.device
    cols = []
    for arr, size in zip(arrays, shape):
        if isinstance(arr, (int, np.integer)):
            col = torch.full((b - a,), int(arr), dtype=torch.int64,
                             device=dev)
        elif int(arr.numel()) == 1 and n != 1:
            one = (multiprocess.sent_gather(arr).full_tensor()
                   if _is_sharded(arr) else
                   arr.to_local() if is_dtensor(arr) else arr)
            col = one.reshape(()).to(device=dev, dtype=torch.int64).expand(
                b - a)
        elif is_dtensor(arr):
            col = backend.rebox(arr, placements).to_local()
        else:
            col = arr.reshape(-1)[a:b]
        col = col.to(device=dev, dtype=torch.int64)
        col = torch.where(col < 0, col + int(size), col).clamp(
            0, max(int(size) - 1, 0))
        cols.append(col)
    return torch.stack(cols, dim=1) if cols else torch.zeros(
        (b - a, 0), dtype=torch.int64, device=dev)


def _key_layouts(data, k, rpl):
    """(placements of ``data`` for the move, of the 1-D key): a mesh
    dimension that shards an axis past the key's (the result's trailing
    axes, ``rpl``: the result's placements, or None for a write) shards
    the same axis of ``data``; one that shards the key's axes of ``data``
    routes; any other replicates. The key lies along the mesh dimensions
    that route (or, for a read, that shard the result's first axis)."""
    xpl, kpl = [], []
    for m, p in enumerate(data.placements):
        if rpl is not None and rpl[m].is_shard() and rpl[m].dim >= 1:
            xpl.append(_shard(rpl[m].dim - 1 + k))
        elif rpl is None and p.is_shard() and p.dim >= k:
            xpl.append(p)
        elif p.is_shard() and p.dim < k:
            xpl.append(p)
        else:
            xpl.append(_replicate())
        routed = p.is_shard() and p.dim < k
        lead = (rpl[m].is_shard() and rpl[m].dim == 0) if rpl is not None \
            else routed
        kpl.append(_shard(0) if lead else _replicate())
    return tuple(xpl), tuple(kpl)


def gather_device(backend, data, arrays, rpl):
    """``data[arrays...]`` for a key of index arrays over the first
    ``len(arrays)`` axes (device or host int arrays and ints, broadcast to
    one length n; masks already turned into positions): each process
    takes the positions of its box of the result, which ``rpl`` lays out
    (shape (n,) + the trailing axes), and pulls them (``pull``: the
    positions to their holders and the items back, two all-to-alls)."""
    k = len(arrays)
    n = _key_length(arrays)
    shape = (n,) + tuple(data.shape[k:])
    xpl, kpl = _key_layouts(data, k, rpl)
    x = backend.rebox(data, xpl)
    pos = device_positions(backend, arrays, tuple(data.shape), n, kpl)
    got = pull(backend, x, k, pos)
    return backend.from_local(got.contiguous(), shape, tuple(rpl))


def _key_length(arrays):
    """The length the key's arrays broadcast to."""
    lengths = {1}
    for arr in arrays:
        if not isinstance(arr, (int, np.integer)):
            lengths.add(int(arr.numel()))
    if len(lengths) > 2:
        raise IndexError("shape mismatch: indexing arrays could not be "
                         f"broadcast together with lengths {sorted(lengths)}")
    return max(lengths)


def scatter_device(backend, data, arrays, values):
    """``data[arrays...] = values`` for a key of index arrays over the
    first k axes (as ``gather_device``'s): each process takes its box of
    the key and of the value, sends each (position, value) to the process
    that holds the position and agrees with it on the mesh dimensions that
    route no key axis (one all-gather of the counts, one all-to-all), and
    each holder writes what it received. Where a position comes twice,
    the later one in the key wins, as a serial scatter writes them in
    order. Returns the new DTensor, laid out as ``data``."""
    k = len(arrays)
    n = _key_length(arrays)
    dshape, dpl = tuple(data.shape), tuple(data.placements)
    shape = (n,) + dshape[k:]
    _, kpl = _key_layouts(data, k, None)
    vpl = tuple(_shard(0) if (p.is_shard() and p.dim < k) else
                _shard(p.dim - k + 1) if p.is_shard() else _replicate()
                for p in dpl)
    pos = device_positions(backend, arrays, dshape, n, kpl)
    a, b = backend.region((n,), kpl)[0]
    box = backend.region(dshape, dpl)
    local = data.to_local().clone(memory_format=torch.contiguous_format)
    if _is_sharded(values):
        if tuple(values.shape) != shape:
            raise NotImplementedError(
                "index assignment on the mesh: a sharded value must have "
                f"the indexed shape {shape}, not {tuple(values.shape)}")
        v = backend.rebox(values, vpl).to_local()
    else:
        sub = (slice(a, b),) + tuple(slice(lo, hi) for lo, hi in box[k:])
        if not torch.is_tensor(values) and np.ndim(values) == 0:
            v = torch.full(tuple(s.stop - s.start for s in sub),
                           np.asarray(values).item(), dtype=local.dtype,
                           device=local.device)
        else:
            v = _whole_value(values, shape, local.device)[sub]
    v = v.to(local.dtype)
    me = multiprocess.process_index()
    world = backend.device_grid.num_devices
    coords = backend.coords()
    routed = {m for m, p in enumerate(dpl) if p.is_shard() and p.dim < k}
    dest = torch.full((pos.shape[0],), -1, dtype=torch.int64,
                      device=pos.device)
    for r, c in enumerate(coords):
        if all(c[m] == coords[me][m] for m in range(len(c))
               if m not in routed):
            dest[_inside(backend.region(dshape, dpl, c), pos)] = r
    order = torch.argsort(dest, stable=True)
    send = torch.bincount(dest, minlength=world).cpu().numpy()
    recv = multiprocess.all_gather_ints(send)[:, me]
    j = torch.arange(a, b, dtype=torch.int64, device=pos.device)
    packed, spec = _pack([j[order], pos[order], v[order.to(v.device)]])
    got_j, got_pos, got_v = _unpack(multiprocess.exchange(packed, send,
                                                          recv), spec)
    if got_pos.dim() == 1:
        got_pos = got_pos.reshape(-1, k)
    if got_j.numel():
        # the last of each position in key order
        flat = torch.zeros_like(got_j)
        for col, size in zip(got_pos.T, dshape[:k]):
            flat = flat * int(size) + col
        by_j = torch.argsort(got_j, stable=True)
        by_pos = by_j[torch.argsort(flat[by_j], stable=True)]
        f = flat[by_pos]
        last = torch.ones_like(f, dtype=torch.bool)
        last[:-1] = f[1:] != f[:-1]
        keep = by_pos[last]
        at = (got_pos[keep] - torch.tensor(
            [lo for lo, _ in box[:k]], device=got_pos.device)).to(
                local.device)
        local[tuple(at.T)] = got_v[keep.to(got_v.device)].reshape(
            (-1,) + tuple(local.shape[k:]))
    return backend.from_local(local, dshape, dpl)


# -- slices, shapes and order: the sequence moved in runs -----------------


def _moved_placements(placements, src, dst, ndim):
    """``placements`` of an array whose axis ``src`` moved to ``dst``."""
    order = list(range(ndim))
    order.insert(dst, order.pop(src))
    return tuple(_shard(order.index(p.dim)) if p.is_shard() else p
                 for p in placements)


def full_shard(backend):
    """The layout of a 1-D array split over every process of the mesh."""
    return (_shard(0),) * len(backend.device_grid.mesh_shape)


def _progression_run(lo, hi, start, step, count):
    """The j in [0, count) with ``start + j * step`` in [lo, hi), as one
    (first, stop) run (they are consecutive for any step)."""
    if step > 0:
        j0, j1 = -((start - lo) // step), -((start - hi) // step)
    else:
        s = -step
        j0, j1 = (start - hi) // s + 1, (start - lo) // s + 1
    j0, j1 = min(max(j0, 0), count), min(max(j1, 0), count)
    return (j0, max(j0, j1))


def select_rows(backend, t, start, step, count, whole=False):
    """Rows ``start + j·step`` (j in [0, count), any nonzero step) of the
    DTensor ``t`` along axis 0: each process takes the run of them that it
    holds (reversed for a negative step) and one ``move_rows`` lays them
    out as ``t`` is laid out, or, with ``whole``, whole on every process
    of each row group (the mesh dimensions that shard axis 0 then
    replicate). No process holds more than its rows and its share."""
    pl = tuple(t.placements)
    shape = tuple(t.shape)
    coords = backend.coords()
    out_shape = (int(count),) + shape[1:]
    boxes = [backend.region(shape, pl, c)[0] for c in coords]
    src = [_progression_run(lo, hi, start, step, count) for lo, hi in boxes]
    out_pl = tuple(_replicate() if whole and p.is_shard() and p.dim == 0
                   else p for p in pl)
    dst = [(0, int(count)) if whole else
           backend.region(out_shape, pl, c)[0] for c in coords]
    me = multiprocess.process_index()
    lo = boxes[me][0]
    j0, j1 = src[me]
    local = t.to_local()
    if j1 > j0:
        first = start + j0 * step - lo
        last = start + (j1 - 1) * step - lo
        rows = (local[first:last + 1:step] if step > 0
                else torch.flip(local[last:first + 1:-step], (0,)))
    else:
        rows = local[:0]
    got = backend.move_rows(rows, src, dst, pl)
    return backend.from_local(got.contiguous(), out_shape, out_pl)


def basic_slice(backend, data, entries, placements):
    """``data[key]`` for a key of ints and slices (``entries``: per axis
    (start, step, count, kept), every axis named), laid out by
    ``placements``: each axis that no mesh dimension shards is sliced in
    place; along each sharded axis the rows move by ``select_rows`` (an
    int there is one row, then whole on its row group); the dropped axes
    go, and one ``rebox`` lays the result out. No process gathers the
    array."""
    t = data
    local = t.to_local()
    pl = tuple(t.placements)
    key, shape = [], []
    for k, (start, step, count, _) in enumerate(entries):
        if shard_dims(pl, (k,)):
            key.append(slice(None))
            shape.append(int(t.shape[k]))
        elif count == 0:
            key.append(slice(0, 0))
            shape.append(0)
        elif step > 0:
            key.append(slice(start, start + (count - 1) * step + 1, step))
            shape.append(count)
        else:
            key.append(slice(start + (count - 1) * step, start + 1, -step))
            shape.append(count)
    flips = [k for k, (_, step, count, _) in enumerate(entries)
             if step < 0 and not shard_dims(pl, (k,))]
    if any(s != slice(None) for s in key) or flips:
        local = local[tuple(key)]
        if flips:
            local = torch.flip(local, flips)
        t = backend.from_local(local.contiguous(), tuple(shape), pl)
    for k, (start, step, count, kept) in enumerate(entries):
        if not shard_dims(pl, (k,)) or (step == 1 and start == 0 and kept
                                        and count == int(t.shape[k])):
            continue
        u = move_axis(backend, t, k, 0) if k else t
        u = select_rows(backend, u, start, step, count, whole=not kept)
        t = move_axis(backend, u, 0, k) if k else u
    drop = [k for k, e in enumerate(entries) if not e[3]]
    if drop:
        kept_axes = [k for k in range(len(entries)) if k not in drop]
        local = t.to_local().reshape(tuple(
            int(t.to_local().shape[k]) for k in kept_axes))
        pl = tuple(_shard(kept_axes.index(p.dim)) if p.is_shard() else p
                   for p in t.placements)
        t = backend.from_local(local, tuple(int(t.shape[k])
                                            for k in kept_axes), pl)
    return backend.rebox(t, tuple(placements))


def flat_move(backend, data, shape, placements, cyclic=False):
    """``data`` in the new ``shape`` by its row-major order (a reshape), or
    with ``cyclic`` its flat sequence repeated to fill ``shape`` (resize),
    laid out by ``placements``. Both arrays are first laid out by rows on
    the mesh dimensions that shard the result (``rebox``), so that each
    process's box is one run of the flat order; each process then pulls
    its new run from the holders (one all-to-all) and one ``rebox`` lays
    it out. No process gathers the array."""
    shape = tuple(int(s) for s in shape)
    placements = tuple(placements)
    old = tuple(data.shape)
    total = int(np.prod(shape, dtype=np.int64))
    size = int(np.prod(old, dtype=np.int64))
    if shape == old and not cyclic:
        return backend.rebox(data, placements)
    if not shape or not old:  # a scalar: one element, on every process
        flat = backend.rebox(data, backend.replicated()).to_local()
        full = torch.broadcast_to(flat.reshape(-1)[:1] if size else
                                  flat.new_zeros((1,)), (total,))
        return backend.rebox(backend.from_local(
            full.reshape(shape).contiguous(), shape, backend.replicated()),
            placements)
    rows = tuple(_shard(0) if p.is_shard() else _replicate()
                 for p in placements)
    x = backend.rebox(data, rows)
    coords = backend.coords()
    inner_old = int(np.prod(old[1:], dtype=np.int64))
    inner = int(np.prod(shape[1:], dtype=np.int64))
    src = [tuple(v * inner_old for v in backend.region(old, rows, c)[0])
           for c in coords]
    dst = [tuple(v * inner for v in backend.region(shape, rows, c)[0])
           for c in coords]
    local = x.to_local().reshape(-1)
    if cyclic and size:
        laps = -(-total // size)
        pieces = [[(a + i * size, min(b + i * size, total))
                   for i in range(laps) if a + i * size < total]
                  for a, b in src]
        me = multiprocess.process_index()
        parts = [local[:b - a] for a, b in pieces[me]] or [local[:0]]
        if not pieces[me]:
            pieces[me] = []
        flat = backend.move_pieces(parts, pieces, dst, rows)
    elif cyclic:
        a, b = dst[multiprocess.process_index()]
        flat = local.new_zeros((b - a,))
    else:
        flat = backend.move_rows(local, src, dst, rows)
    a, b = backend.region(shape, rows)[0]
    out = backend.from_local(flat.reshape((b - a,) + shape[1:]), shape,
                             rows)
    return backend.rebox(out, placements)


def concat(backend, tensors, axis, placements):
    """``torch.cat(tensors, axis)`` of DTensors (or whole tensors) laid
    out by ``placements``: each operand is laid out as the result but for
    its length along ``axis`` (``as_dtensor``); along an axis that no mesh
    dimension shards each process joins its own parts, else each
    operand's rows go to their place in the result by one all-to-all (the
    operands' runs together, ``move_pieces``)."""
    placements = tuple(placements)
    ts = [as_dtensor(backend, t, placements) for t in tensors]
    shape = list(ts[0].shape)
    shape[axis] = sum(int(t.shape[axis]) for t in ts)
    shape = tuple(shape)
    if not shard_dims(placements, (axis,)):
        local = torch.cat([t.to_local() for t in ts], dim=axis)
        return backend.from_local(local, shape, placements)
    moved = [move_axis(backend, t, axis, 0) if axis else t for t in ts]
    mpl = tuple(moved[0].placements)
    mshape = (shape[axis],) + tuple(moved[0].shape[1:])
    coords = backend.coords()
    offsets = np.cumsum([0] + [int(t.shape[0]) for t in moved])
    pieces = [[tuple(int(o) + v for v in backend.region(
        tuple(t.shape), mpl, c)[0]) for t, o in zip(moved, offsets)]
        for c in coords]
    dst = [backend.region(mshape, mpl, c)[0] for c in coords]
    rows = backend.move_pieces([t.to_local() for t in moved], pieces, dst,
                               mpl)
    out = backend.from_local(rows.contiguous(), mshape, mpl)
    return move_axis(backend, out, 0, axis) if axis else out


def reverse_rows(backend, t, shift=None):
    """``t`` (a DTensor) along axis 0 reversed, or with ``shift`` rolled by
    it: each process's rows are one run of the result (two where a roll
    wraps), placed by one all-to-all; laid out as ``t``."""
    pl = tuple(t.placements)
    shape = tuple(t.shape)
    n = shape[0]
    coords = backend.coords()
    boxes = [backend.region(shape, pl, c)[0] for c in coords]
    local = t.to_local()
    if shift is None:
        pieces = [[(n - b, n - a)] for a, b in boxes]
        parts = [torch.flip(local, (0,))]
    else:
        s = int(shift) % n if n else 0

        def runs(a, b):
            out = []
            if a + s < n and b > a:
                out.append((a + s, min(b + s, n)))
            if b + s > n and b > a:
                out.append((max(a + s, n) - n, b + s - n))
            return out or [(0, 0)]

        pieces = [runs(a, b) for a, b in boxes]
        me = multiprocess.process_index()
        a, b = boxes[me]
        cut = max(0, min(b, n - s) - a)
        parts = [local[:cut], local[cut:]] if len(pieces[me]) == 2 \
            else [local]
    rows = backend.move_pieces(parts, pieces, boxes, pl)
    return backend.from_local(rows.contiguous(), shape, pl)


def along(backend, t, axis, fn):
    """``fn`` of the DTensor ``t`` with ``axis`` moved first, moved back."""
    if not axis:
        return fn(t)
    return move_axis(backend, fn(move_axis(backend, t, axis, 0)), 0, axis)


def relayout(backend, local, box, shape, placements):
    """The DTensor of ``shape`` laid out by ``placements`` whose part here
    is ``local``, the box ``box`` (per axis (start, stop)) of the array,
    where the processes' boxes tile the array as ``placements`` would but
    for where the cuts fall along the sharded axes (a stencil's output
    rows): one all-gather of the boxes, then one move along each sharded
    axis whose cuts are not the layout's."""
    shape = tuple(int(s) for s in shape)
    placements = tuple(placements)
    ndim = len(shape)
    table = multiprocess.all_gather_ints([v for ab in box for v in ab])
    cur = [[(int(row[2 * k]), int(row[2 * k + 1])) for k in range(ndim)]
           for row in table]
    coords = backend.coords()
    canon = [backend.region(shape, placements, c) for c in coords]
    for k in sorted({p.dim for p in placements if p.is_shard()}):
        if all(cur[r][k] == canon[r][k] for r in range(len(coords))):
            continue
        mpl = _moved_placements(placements, k, 0, ndim)
        rows = backend.move_rows(torch.movedim(local, k, 0),
                                 [c[k] for c in cur],
                                 [c[k] for c in canon], mpl)
        local = torch.movedim(rows, 0, k)
        for r in range(len(coords)):
            cur[r][k] = canon[r][k]
    return backend.from_local(local.contiguous(), shape, placements)


def halo(backend, t, before, after):
    """The ``before`` rows before this process's box of the DTensor ``t``
    along axis 0 and the ``after`` rows after it (fewer at the array's
    ends, none for an empty box), from the processes that hold them: one
    pull of those rows alone."""
    pl = tuple(t.placements)
    shape = tuple(t.shape)
    n = shape[0]
    coords = backend.coords()
    me = multiprocess.process_index()

    def span(r):
        lo, hi = backend.region(shape, pl, coords[r])[0]
        if hi <= lo:
            return (lo, lo), (hi, hi)
        return (max(0, lo - before), lo), (hi, min(n, hi + after))

    def wants(r):
        (a, b), (c, d) = span(r)
        return torch.cat([torch.arange(a, b), torch.arange(c, d)]).to(
            torch.int64).reshape(-1, 1)

    got = pull(backend, t, 1, wants(me), wants)
    (a, b), _ = span(me)
    return got[:b - a], got[b - a:]


def across(backend, t, axis, fn, out_len, out_dtype, chunk_elements):
    """``fn(local, axis)`` of the DTensor ``t`` (of two axes or more)
    along an ``axis`` that the mesh shards (a sort, a selection, an FFT),
    into an array whose
    ``axis`` is ``out_len`` long, laid out as ``t``: the mesh dimensions
    that shard ``axis`` shard the longest other axis instead (one
    all-to-all, ``rebox``), ``fn`` runs on each process's whole lines, and
    the result goes back (one more). Where that other axis is whole on
    each process, it goes ``chunk_elements`` a process at a time, so that
    the temporaries (a sort's int64 positions) stay a chunk in size, the
    lines of a chunk a multiple of the processes that share ``axis`` (each
    then takes as many and sends (P − 1)/P of its part)."""
    pl = tuple(t.placements)
    shape = tuple(int(s) for s in t.shape)
    dims = shard_dims(pl, (axis,))
    others = [k for k in range(len(shape)) if k != axis]
    f = max(others, key=lambda k: shape[k])
    off = tuple(_shard(f) if m in dims else p for m, p in enumerate(pl))
    out_shape = tuple(int(out_len) if k == axis else s
                      for k, s in enumerate(shape))
    def lines(sub):
        moved = backend.rebox(sub, off)
        res = fn(moved.to_local(), axis).to(out_dtype)
        del moved
        res_shape = tuple(int(out_len) if k == axis else s
                          for k, s in enumerate(sub.shape))
        return backend.rebox(backend.from_local(res.contiguous(), res_shape,
                                                off), pl)

    mesh = backend.device_grid.mesh_shape
    share = int(np.prod([mesh[m] for m in dims]))
    box = backend.region(shape, pl)
    line = shape[axis] * int(np.prod([b - a for k, (a, b) in enumerate(box)
                                      if k not in (axis, f)]))
    step = max(share, int(chunk_elements) * share // max(line, 1))
    step -= step % share  # each process then takes as many lines
    if any(p.is_shard() and p.dim == f for p in pl) or step >= shape[f]:
        return lines(t)
    local = t.to_local()
    out_box = backend.region(out_shape, pl)
    out = torch.empty(tuple(b - a for a, b in out_box), dtype=out_dtype,
                      device=local.device)
    for c0 in range(0, shape[f], step):
        c1 = min(shape[f], c0 + step)
        sub_shape = tuple(c1 - c0 if k == f else s
                          for k, s in enumerate(shape))
        sub = backend.from_local(local.narrow(f, c0, c1 - c0).contiguous(),
                                 sub_shape, pl)
        out.narrow(f, c0, c1 - c0).copy_(lines(sub).to_local())
    return backend.from_local(out, out_shape, pl)


# -- the distributed sort: a sample sort of one sharded axis ---------------

# Splitter candidates each process offers, for each process of the mesh.
SORT_SAMPLES = 64
# Elements that the sample sort orders at a time on a process (an argsort's
# int64 positions and cub's buffers are several times a chunk's bytes).
SORT_CHUNK_ELEMENTS = 1 << 26
# Elements of a chunk of lines that a process orders or transforms at a
# time (``across``, and a partition's rows on each box): a sort's int64
# positions are twice float32 values.
CHUNK_ELEMENTS = 1 << 28


def sort_keys(t):
    """Integer keys (a list, the first the primary one) in jnp's sort
    order of ``t``: floats by ``masking.total_order_key`` (-0 as 0, every
    NaN one NaN above +inf), complex numbers by real part then imaginary
    part (``masking.argsort``'s order), bools as bytes."""
    if t.is_complex():
        return [masking.total_order_key(t.real),
                masking.total_order_key(t.imag)]
    if t.is_floating_point():
        return [masking.total_order_key(t)]
    if t.dtype == torch.bool:
        return [t.to(torch.uint8)]
    return [t]


def _lex_order(keys, n, device):
    """The stable order of n elements by ``keys`` (the first the primary
    one): successive stable sorts from the last key to the first."""
    perm = None
    for k in reversed(keys):
        step = torch.argsort(k if perm is None else k[perm], stable=True)
        perm = step if perm is None else perm[step]
    return perm if perm is not None else torch.arange(
        n, dtype=torch.int64, device=device)


def _keys_le(keys, lo, spl):
    """Whether each element's (keys..., global position) tuple is at most
    the tuple ``spl`` (Python ints, the position last), in lexicographic
    order; the positions (``lo`` + index) are read only where every key
    ties."""
    le = eq = None
    for k, v in zip(keys, spl[:-1]):
        lt, e = k < v, k == v
        le = lt if le is None else le | (eq & lt)
        eq = e if eq is None else eq & e
    tie = masking._flat_nonzero(eq)
    le[tie] = tie + lo <= spl[-1]
    return le


def _even(n, count, device):
    """``count`` indices at even steps of [0, n) (repeats where n is
    smaller)."""
    return torch.arange(count, device=device, dtype=torch.int64) * n // count


def _tuple_splitters(keys, lo, world):
    """world - 1 (keys..., position) tuples that cut the elements into
    ranges of about equal size: each process offers ``SORT_SAMPLES ·
    world`` tuples, the quantiles of an even sample of its own, weighted
    by its count (one all-gather). Positions make every tuple distinct,
    so equal keys split too."""
    n = int(keys[0].numel())
    s = SORT_SAMPLES * world
    if n:
        at = _even(n, s, keys[0].device)
        cols = [k[at].to(torch.int64) for k in keys] + [at + lo]
        picks = torch.stack(cols, dim=1)[_lex_order(cols, s, at.device)]
        picks = picks.cpu().numpy().reshape(-1)
    else:
        picks = np.zeros(s * (len(keys) + 1), dtype=np.int64)
    table = multiprocess.all_gather_ints(np.concatenate([[n], picks]))
    cand, weight = [], []
    for row in table:
        if row[0]:
            cand.append(row[1:].reshape(s, len(keys) + 1))
            weight.extend([row[0] / s] * s)
    if not cand:
        return [tuple([0] * (len(keys) + 1))] * (world - 1)
    cand = np.concatenate(cand)
    order = np.lexsort(cand.T[::-1])
    cum = np.cumsum(np.asarray(weight)[order])
    return [tuple(int(v) for v in cand[order[min(len(order) - 1, int(
        np.searchsorted(cum, (j + 1) * cum[-1] / world)))]])
        for j in range(world - 1)]


def _groups(groups, count):
    """For each group 0..count-1 in turn, the indices of its elements in
    increasing order (a stable partition, one group's indices at a
    time)."""
    for g in range(count):
        yield masking._flat_nonzero(groups == g)


def _ordered(keys, got, chunk):
    """``got`` (tensors of one length) in the stable order of ``keys``
    (the first the primary one), a range of the primary key at a time:
    each range (cut at the quantiles of an even sample) holds at most
    about ``chunk`` elements, so that the argsort's int64 positions and
    its buffers stay a chunk in size; equal primary keys share a range,
    and each range keeps the elements' order (``_groups``)."""
    m = int(got[0].shape[0])
    dev = got[0].device
    ranges = max(1, -(-m // int(chunk)))
    if ranges == 1:
        order = _lex_order(keys, m, dev)
        return [g[order] for g in got]
    sample = torch.sort(keys[0][_even(m, 64 * ranges, dev)])[0]
    cuts = sample[_even(int(sample.numel()), ranges, dev)[1:]]
    group = torch.zeros(m, dtype=torch.uint8, device=dev)
    for c in cuts:
        group += (keys[0] >= c).to(torch.uint8)
    outs = [torch.empty_like(g) for g in got]
    at = 0
    for idx in _groups(group, ranges):
        size = int(idx.numel())
        idx = idx[_lex_order([k[idx] for k in keys], size, dev)]
        for o, g in zip(outs, got):
            o[at:at + size] = g[idx]
        at += size
    return outs


def sorted_runs(backend, tensors, keys_fn, positions=False):
    """The elements of the 1-D DTensors ``tensors`` (one length), sorted
    stably by ``keys_fn(locals)`` over the whole mesh (a sample sort):
    each process finds the process of each of its (keys, position)
    tuples among ``_tuple_splitters``' ranges and sends them there in
    position order (a stable partition, one all-to-all a tensor); each
    process then orders what it received, which arrives in position order
    within equal keys (``_ordered``, a chunk of key ranges at a time).
    Returns (this process's sorted run of each tensor, or with
    ``positions`` of their global positions alone; the run's first global
    rank)."""
    fs = full_shard(backend)
    xs = [backend.rebox(t, fs) for t in tensors]
    world = backend.device_grid.num_devices
    me = multiprocess.process_index()
    lo = backend.region(tuple(xs[0].shape), fs)[0][0]
    locs = [x.to_local() for x in xs]
    n = int(locs[0].shape[0])
    dev = locs[0].device
    keys = keys_fn(locs)
    dest = torch.zeros(n, dtype=torch.uint8, device=dev)
    for spl in _tuple_splitters(keys, lo, world):
        dest += (~_keys_le(keys, lo, spl)).to(torch.uint8)
    del keys
    payload = [torch.empty_like(loc) for loc in locs]
    if positions:
        payload.append(torch.empty(n, dtype=torch.int64, device=dev))
    send, at = [], 0
    for idx in _groups(dest, world):
        size = int(idx.numel())
        for p, loc in zip(payload, locs):
            p[at:at + size] = loc[idx]
        if positions:
            payload[-1][at:at + size] = idx + lo
        send.append(size)
        at += size
    del dest
    recv = multiprocess.all_gather_ints(send)[:, me]
    got = []
    for i in range(len(payload)):  # each sent tensor goes once sent
        got.append(multiprocess.exchange(payload[i], send, recv))
        payload[i] = None
    keys = keys_fn(got[:len(tensors)])
    if positions:
        got = got[-1:]  # the positions alone are asked for
    got = _ordered(keys, got, SORT_CHUNK_ELEMENTS)
    counts = multiprocess.all_gather_ints([int(got[0].shape[0])])[:, 0]
    return got, int(counts[:me].sum())


def _runs_everywhere(start, length):
    """Every process's (start, length) run, by process (one all-gather)."""
    table = multiprocess.all_gather_ints([start, length])
    return [(int(a), int(a) + int(n)) for a, n in table]


def sort(backend, data, placements, want="values"):
    """``masking.sort`` of the 1-D DTensor ``data`` over the whole mesh
    (``sorted_runs``): the values (``want="values"``; bit for bit, signed
    zeros and NaN payloads in input order) or their global positions
    (``"positions"``, int64), laid out by ``placements``."""
    runs, _ = sorted_runs(backend, [data], lambda locs: sort_keys(locs[0]),
                          positions=want == "positions")
    return _placed(backend, runs[-1], placements)


def _placed(backend, run, placements):
    """This process's sorted run of a 1-D result (the runs in rank order
    are the result), laid out by ``placements`` (``place_rows``)."""
    out = backend.place_rows(run, (), full_shard(backend))
    return backend.rebox(out, tuple(placements))


def lexsort(backend, tensors, placements):
    """``jnp.lexsort`` of 1-D DTensors (or whole tensors) of one length:
    the global positions (int64) that sort them by the last, then by the
    one before it, ..., stably (``sorted_runs`` on every key at once),
    laid out by ``placements``."""
    fs = full_shard(backend)
    ts = [as_dtensor(backend, t, fs) for t in tensors]
    runs, _ = sorted_runs(backend, ts, lambda locs: [
        k for loc in reversed(locs) for k in sort_keys(loc)],
        positions=True)
    return _placed(backend, runs[-1], placements)


def partition(backend, data, kth, placements, keys_fn, positions=False):
    """``jnp.partition`` (or, with ``positions``, ``jnp.argpartition``) of
    the 1-D DTensor ``data``: the elements sorted by ``keys_fn`` and
    position (``sorted_runs``); the kth+1 smallest in that order first,
    then the values of the others in descending order (partition) or the
    positions of every other element in ascending order (argpartition, the
    positions of the first part sent back to their holders and struck
    out). One all-to-all places the two runs of each process."""
    total = int(data.shape[0])
    kth = int(kth)
    runs, r0 = sorted_runs(backend, [data], keys_fn, positions=positions)
    run = runs[-1] if positions else runs[0]
    m = int(run.shape[0])
    cut = max(0, min(m, kth + 1 - r0))
    head = run[:cut]
    if not positions:
        tail = torch.flip(run[cut:], (0,))
        a, b = r0 + cut, r0 + m
        tail_run = (total + kth - b + 1, total + kth - a + 1)
    else:
        tail = _other_positions(backend, data, head)
        before = multiprocess.all_gather_ints([int(tail.shape[0])])[:, 0]
        me = multiprocess.process_index()
        start = kth + 1 + int(before[:me].sum())
        tail_run = (start, start + int(tail.shape[0]))
    heads = _runs_everywhere(r0, cut)
    tails = _runs_everywhere(tail_run[0], tail_run[1] - tail_run[0])
    fs = full_shard(backend)
    dst = [backend.region((total,), fs, c)[0] for c in backend.coords()]
    rows = backend.move_pieces([head, tail], [[h, t] for h, t in zip(
        heads, tails)], dst, fs)
    out = backend.from_local(rows.contiguous(), (total,), fs)
    return backend.rebox(out, tuple(placements))


def _other_positions(backend, data, chosen):
    """The global positions of this process's box of the 1-D DTensor
    ``data`` (split over the whole mesh) that no process chose
    (``chosen``: positions, on whichever process), in ascending order:
    each chosen position goes to its holder (one all-to-all)."""
    fs = full_shard(backend)
    shape = tuple(data.shape)
    coords = backend.coords()
    dest = torch.zeros(chosen.shape, dtype=torch.uint8,
                       device=chosen.device)
    for c in coords[1:]:
        dest += (chosen >= backend.region(shape, fs, c)[0][0]).to(
            torch.uint8)
    buf = torch.empty_like(chosen)
    send, at = [], 0
    for idx in _groups(dest, len(coords)):
        buf[at:at + idx.numel()] = chosen[idx]
        send.append(int(idx.numel()))
        at += int(idx.numel())
    del dest
    recv = multiprocess.all_gather_ints(send)[
        :, multiprocess.process_index()]
    got = multiprocess.exchange(buf, send, recv)
    lo, hi = backend.region(shape, fs)[0]
    keep = torch.ones(hi - lo, dtype=torch.bool, device=chosen.device)
    keep[got - lo] = False
    return masking._flat_nonzero(keep) + lo
