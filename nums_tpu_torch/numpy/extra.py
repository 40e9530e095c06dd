"""The NumPy surface beyond the array API's core.

Counterpart of ``nums_tpu/numpy/extra.py``, name for name (its
``__all__``): manipulation (stack/tile/roll/flip/sort...), scans
(cumsum/cumprod), predicates (all/any/isclose), the nan-reductions,
statistics (median, quantiles, histogram, cov), contraction helpers
(dot/inner/outer/trace/einsum) and signal helpers. The reference runs each
as a cached ``jax.jit`` of ``jnp.<name>`` through its pad-and-mask adapter;
the port keeps no padding at rest, so each is a torch computation on
``BlockArray.data`` on the array's device, wrapped back. Results follow
``jnp``'s dtypes and values: its stable sort, its ``linear`` and
``midpoint`` quantiles, its closed last histogram bin, its integer and
bool promotions of the scans.

The host steps are the reference's own: the length of ``bincount`` (one
scalar sync), ``unique`` with ``axis=`` (``np.unique`` on a host copy, as
``extra.py:474-490`` there) and the index count of the mask functions
(one scalar sync, in ``masking.device_where``).
"""

import builtins

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.ops import (
    elementwise, linear, masking, mesh_ops, summa,
)


__all__ = [
    "prod", "all", "any", "cumsum", "cumprod", "nansum", "nanmean",
    "nanmax", "nanmin", "nanvar", "nanstd", "median", "nanmedian", "ptp",
    "count_nonzero", "average", "clip", "around", "round", "round_",
    "sort", "argsort", "searchsorted", "take", "stack", "vstack",
    "hstack", "dstack", "column_stack", "row_stack", "tile", "repeat",
    "roll", "flip", "fliplr", "flipud", "ravel", "swapaxes", "moveaxis",
    "atleast_1d", "atleast_2d", "broadcast_to", "triu", "tril", "dot",
    "inner", "outer", "trace", "vdot", "einsum", "kron",
    "matrix_transpose", "isclose", "array_equal", "real", "imag",
    "nan_to_num", "diff", "unique", "percentile", "quantile", "histogram",
    "cov", "corrcoef", "interp", "pad", "bincount", "argwhere",
    "flatnonzero", "nonzero", "meshgrid", "cross", "convolve", "correlate",
    "gradient", "trapezoid", "trapz", "sinc", "ediff1d", "vander", "tri",
    "full_like", "geomspace", "append", "array_split", "vsplit", "hsplit",
    "dsplit", "atleast_3d", "diagonal", "diagflat", "digitize", "angle",
    "fix", "divmod", "compress", "extract", "broadcast_arrays",
    "broadcast_shapes", "asanyarray", "astype", "acos", "acosh", "asin",
    "asinh", "atan", "atanh", "atan2", "bitwise_invert",
    "bitwise_left_shift", "bitwise_right_shift", "concat", "pow",
    "permute_dims",
]


def _to_ba(obj):
    app = _instance()
    if isinstance(obj, BlockArray):
        return obj
    if isinstance(obj, (bool, int, float, complex, np.generic)):
        return app.scalar(obj)
    return app.array(np.asarray(obj), block_shape=None)


def _wrap(a, data, block_shape=None):
    """``data`` as a BlockArray on ``a``'s backend, blocked like ``a``
    where the ranks agree."""
    shape = tuple(data.shape)
    if block_shape is None:
        block_shape = array_utils.default_block_shape_for(
            shape, a.block_shape)
    block_shape = tuple(min(b, s) for b, s in zip(tuple(block_shape), shape))
    grid = ArrayGrid(shape, block_shape,
                     array_utils.to_dtype_name(data.dtype))
    return BlockArray(data, grid, a.backend)


def _default_int(a):
    return elementwise.default_int(a._default_float())


def _sharded(t) -> bool:
    """Whether ``t`` is a DTensor that some mesh dimension shards."""
    return mesh_ops.is_dtensor(t) and builtins.any(
        p.is_shard() for p in t.placements)


def _local(t):
    """This process's part of a DTensor (a plain tensor is whole)."""
    return t.to_local() if mesh_ops.is_dtensor(t) else t


def _inexact(t):
    return t.to(elementwise.inexact_dtype(t.dtype))


def _dims(axis, ndim):
    """``axis`` (None, an int or a tuple) as a tuple of axes in [0, ndim)."""
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, (int, np.integer)) else tuple(axis)
    return tuple(int(a) % builtins.max(ndim, 1) for a in axes)


def _sum_dtype(dt, a):
    """``jnp.sum``'s accumulator: the default int for bool and the narrower
    integers, the input's own dtype otherwise."""
    if dt == torch.bool or (not (dt.is_floating_point or dt.is_complex)
                            and dt.itemsize < _default_int(a).itemsize):
        return _default_int(a)
    return dt


def _promote_all(tensors):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


# -- reductions / scans -------------------------------------------------


def _reduce_keep(out, x, dims, keepdims):
    if keepdims:
        shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
        out = out.reshape(shape)
    return out


def prod(a, axis=None, keepdims=False, dtype=None):
    a = _to_ba(a)
    x = a.data
    dt = (array_utils.to_torch_dtype(dtype) if dtype is not None
          else _sum_dtype(x.dtype, a))
    x = x.to(dt)
    dims = _dims(axis, x.ndim)
    for d in sorted(dims, reverse=True):
        x = torch.prod(x, dim=d, keepdim=True)
    out = x.reshape([s for i, s in enumerate(x.shape) if i not in dims])
    return _wrap(a, _reduce_keep(out, a.data, dims, keepdims))


def _all_any(fn):
    def reduce_fn(a, axis=None, keepdims=False):
        a = _to_ba(a)
        x = a.data.to(torch.bool)
        dims = _dims(axis, x.ndim)
        out = x
        for d in sorted(dims, reverse=True):
            out = fn(out, dim=d)
        return _wrap(a, _reduce_keep(out, x, dims, keepdims))

    return reduce_fn


all = _all_any(torch.all)  # noqa: A001 - numpy-compatible name
any = _all_any(torch.any)  # noqa: A001
all.__name__, any.__name__ = "all", "any"


def _scan(fn, name):
    def scan(a, axis=None, dtype=None):
        """``jnp.{name}``: the flattened array for ``axis=None``; bool
        accumulates in the default int, every other dtype in itself."""
        a = _to_ba(a)
        x = a.data
        if dtype is not None:
            dt = array_utils.to_torch_dtype(dtype)
        else:
            dt = _default_int(a) if x.dtype == torch.bool else x.dtype
        if mesh_ops.is_dtensor(x):
            return _mesh_scan(a, x.to(dt), axis, fn, name)
        if axis is None:
            x, axis = x.reshape(-1), 0
        return _wrap(a, fn(x.to(dt), dim=int(axis), dtype=dt))

    scan.__name__ = name
    scan.__doc__ = scan.__doc__.format(name=name)
    return scan


def _flat_block(a):
    """The block of ``a`` flattened on the mesh: its row blocks' elements,
    so that the result is split as ``a``'s rows are (one block, as the
    serial result's, would lay it whole on every process)."""
    return (builtins.max(1, a.block_shape[0] * int(np.prod(
        a.shape[1:], dtype=np.int64))) if a.ndim else 1,)


def _mesh_flat(a, x):
    """``x`` (a DTensor of ``a``'s shape) flattened in row-major order and
    laid out as a 1-D BlockArray of ``_flat_block(a)``
    (``mesh_ops.flat_move``); returns (tensor, block shape)."""
    bs = _flat_block(a)
    grid = ArrayGrid((int(a.size),), bs, array_utils.to_dtype_name(x.dtype))
    return mesh_ops.flat_move(a.backend, x, (int(a.size),),
                              a.backend.sharding_for_grid(grid)), bs


def _mesh_scan(a, x, axis, fn, name):
    """A scan of a DTensor (``mesh_ops.scan``): axis=None first
    flattens it by rows (``mesh_ops.flat_move``); the totals of the boxes
    before each box along the axis then join its own scan."""
    bs = None
    if axis is None:
        x, bs = _mesh_flat(a, x)
        axis = 0
    combine = "sum" if name == "cumsum" else "prod"
    out = mesh_ops.scan(a.backend, x, int(axis) % builtins.max(x.ndim, 1),
                        lambda t, dim: fn(t, dim=dim), combine)
    return _wrap(a, out, bs)


cumsum = _scan(torch.cumsum, "cumsum")
cumprod = _scan(torch.cumprod, "cumprod")


def nansum(a, axis=None, keepdims=False):
    a = _to_ba(a)
    x = a.data
    dims = _dims(axis, x.ndim)
    dt = _sum_dtype(x.dtype, a)
    if x.is_floating_point():
        out = torch.nansum(x, dim=dims, keepdim=keepdims)
    else:
        out = torch.sum(x.to(dt), dim=dims, keepdim=keepdims)
    return _wrap(a, out.to(dt))


def _nan_count_sum(x, dims, keepdims):
    valid = ~torch.isnan(x)
    n = valid.sum(dim=dims, keepdim=keepdims).to(x.dtype)
    s = torch.where(valid, x, torch.zeros_like(x)).sum(dim=dims,
                                                      keepdim=keepdims)
    return n, s


def nanmean(a, axis=None, keepdims=False):
    a = _to_ba(a)
    x = _inexact(a.data)
    dims = _dims(axis, x.ndim)
    n, s = _nan_count_sum(x, dims, keepdims)
    return _wrap(a, s / n)


def _nan_extreme(fn, fill):
    def reduce_fn(a, axis=None, keepdims=False):
        a = _to_ba(a)
        x = a.data
        dims = _dims(axis, x.ndim)
        if not x.is_floating_point():
            return _wrap(a, fn(x, dim=dims, keepdim=keepdims))
        nan = torch.isnan(x)
        out = fn(torch.where(nan, torch.full_like(x, fill), x), dim=dims,
                 keepdim=keepdims)
        all_nan = torch.all(nan.reshape(-1)) if x.ndim == 0 else nan
        for d in sorted(dims, reverse=True):
            all_nan = all_nan.all(dim=d, keepdim=keepdims)
        return _wrap(a, torch.where(all_nan, torch.full_like(out, np.nan),
                                    out))

    return reduce_fn


nanmax = _nan_extreme(torch.amax, -np.inf)
nanmin = _nan_extreme(torch.amin, np.inf)
nanmax.__name__, nanmin.__name__ = "nanmax", "nanmin"


def _nanvar(x, dims, ddof, keepdims):
    n, s = _nan_count_sum(x, dims, True)
    mean = s / n
    valid = ~torch.isnan(x)
    dev = torch.where(valid, x - mean, torch.zeros_like(x))
    sq = (dev * dev).sum(dim=dims, keepdim=keepdims)
    n = n if keepdims else n.reshape(sq.shape)
    return sq / torch.clamp(n - ddof, min=0)


def nanvar(a, axis=None, ddof=0, keepdims=False):
    a = _to_ba(a)
    x = _inexact(a.data)
    return _wrap(a, _nanvar(x, _dims(axis, x.ndim), ddof, keepdims))


def nanstd(a, axis=None, ddof=0, keepdims=False):
    a = _to_ba(a)
    x = _inexact(a.data)
    return _wrap(a, torch.sqrt(_nanvar(x, _dims(axis, x.ndim), ddof,
                                       keepdims)))


def _to_last(x, axis):
    """``x`` with the reduced axes flattened into the last one (``axis``
    None: the flattened array), and the shape kept for ``keepdims``."""
    if axis is None:
        return x.reshape(-1), [1] * x.ndim
    dims = _dims(axis, x.ndim)
    keep = [d for d in range(x.ndim) if d not in dims]
    moved = x.permute(*keep, *dims)
    kept_shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
    return moved.reshape([x.shape[d] for d in keep] + [-1]), kept_shape


def _quantile(a, q, axis, method, keepdims, squash_nans):
    """``jnp.quantile``'s ``linear`` and ``midpoint`` methods: the
    positions ``q·(n - 1)`` of the sorted values (NaN anywhere: NaN;
    ``squash_nans``: the NaNs dropped), then cast to the input's inexact
    dtype. Positions and weights are float64 on every device, as jax
    takes them with x64 on (with x64 off it takes them in float32, which
    at 2.5M rows rounds a position to a quarter)."""
    x = _inexact(a.data)
    if x.is_complex():
        raise ValueError("quantile does not support complex input")
    qd = torch.float64
    q_arr = torch.as_tensor(np.asarray(q, dtype=np.float64), dtype=qd,
                            device=x.device)
    if q_arr.ndim > 1:
        raise ValueError(f"q must be have rank <= 1, got shape "
                         f"{tuple(q_arr.shape)}")
    if mesh_ops.is_dtensor(x):
        return _mesh_quantile(a.backend, x, q_arr, axis, method, keepdims,
                              squash_nans)
    flat, kept_shape = _to_last(x, axis)
    nan = torch.isnan(flat)
    s, _ = torch.sort(flat, dim=-1, stable=True)
    n_last = flat.shape[-1]
    if squash_nans:
        counts = (~nan).sum(dim=-1, keepdim=True).to(qd)
    else:
        s = torch.where(nan.any(dim=-1, keepdim=True),
                        torch.full_like(s, np.nan), s)
        counts = torch.full(s.shape[:-1] + (1,), float(n_last), dtype=qd,
                            device=x.device)
    qv = q_arr.reshape((-1,) + (1,) * s.ndim)
    pos = qv * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lim = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, lim))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, lim))
    sb = s.expand(pos.shape[:1] + s.shape)
    low_v = torch.gather(sb, -1, low.to(torch.int64))
    high_v = torch.gather(sb, -1, high.to(torch.int64))
    if method == "linear":
        out = low_v.to(qd) * low_w + high_v.to(qd) * high_w
    else:  # midpoint
        out = (low_v + high_v) * 0.5
    out = out[..., 0].to(x.dtype)
    if keepdims:
        out = out.reshape(out.shape[:1] + tuple(kept_shape))
    if q_arr.ndim == 0:
        out = out[0]
    return out


def _mesh_quantile(backend, x, q_arr, axis, method, keepdims, squash_nans):
    """``_quantile`` of a DTensor: each process keeps its own box;
    the order statistics at the positions ``q·(n − 1)`` (and the counts of
    non-NaN values with ``squash_nans``) come from
    ``mesh_ops.select_ranks`` over the mesh dimensions that shard the
    reduced axes (a bisection of all-reduced counts: no value moves).
    Returns a DTensor laid out by the kept axes' boxes."""
    qd = torch.float64
    nd = x.ndim
    dims = _dims(axis, nd)
    keep = [d for d in range(nd) if d not in dims]
    pl = tuple(x.placements)
    red = mesh_ops.shard_dims(pl, dims)
    local = x.to_local().permute(*keep, *dims)
    kshape = tuple(local.shape[:len(keep)])
    local = local.reshape(kshape + (-1,))
    n_last = int(np.prod([x.shape[d] for d in dims], dtype=np.int64))
    nan = torch.isnan(local)
    if squash_nans:
        counts = (~nan).sum(dim=-1).to(torch.int64)
        mesh_ops.group_reduce(backend, counts, red)
        counts = counts.to(qd)
        any_nan = None
    else:
        counts = torch.full(kshape, float(n_last), dtype=qd,
                            device=x.device)
        any_nan = nan.any(dim=-1).to(torch.int64)
        mesh_ops.group_reduce(backend, any_nan, red, "max")
    qv = q_arr.reshape((-1,) + (1,) * len(kshape))
    pos = qv * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lim = counts - 1
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, lim))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, lim))
    nq = int(qv.shape[0])
    vals = mesh_ops.select_ranks(
        backend, local, torch.cat([low, high]).to(torch.int64), red)
    low_v, high_v = vals[:nq], vals[nq:]
    if method == "linear":
        out = low_v.to(qd) * low_w + high_v.to(qd) * high_w
    else:  # midpoint
        out = (low_v + high_v) * 0.5
    out = out.to(x.dtype)
    if any_nan is not None:
        out = torch.where(any_nan.to(torch.bool), torch.full_like(
            out, float("nan")), out)
    # the result's axes: q (if an array), then the kept ones (each
    # reduced axis as 1 with keepdims)
    lead = 0 if q_arr.ndim == 0 else 1
    if keepdims:
        at = {d: lead + d for d in range(nd)}
        shape, local_shape = [1] * nd, [1] * nd
        for i, d in enumerate(keep):
            shape[d], local_shape[d] = int(x.shape[d]), kshape[i]
    else:
        at = {d: lead + i for i, d in enumerate(keep)}
        shape = [int(x.shape[d]) for d in keep]
        local_shape = list(kshape)
    if lead:
        shape, local_shape = [nq] + shape, [nq] + local_shape
    out = out.reshape(local_shape)
    placements = tuple(
        mesh_ops._shard(at[p.dim]) if p.is_shard() and p.dim in keep
        else mesh_ops._replicate() for p in pl)
    return backend.from_local(out.contiguous(), tuple(shape), placements)


class _Scaled:
    """A q given as an array on the mesh, over ``divide`` (percentiles: 100),
    never read to the host."""

    def __init__(self, q, divide):
        self.q, self.divide = q, divide


def _q_arg(q, divide=1.0):
    """``q`` as float64 host values over ``divide``, or a DTensor q of one
    axis or more kept on the devices (``_Scaled``)."""
    if isinstance(q, BlockArray) and q.ndim and mesh_ops.is_dtensor(q.data):
        return _Scaled(q, divide)
    return np.asarray(q, dtype=np.float64) / divide


def _device_q(q):
    return isinstance(q, _Scaled)


def _mesh_quantile_at(a, q, axis, squash_nans):
    """``_quantile``'s linear method at a q that lies on the mesh
    (``_Scaled``, of k values): the reduced axis sorted once
    (``_mesh_order``: the sample sort of a vector, ``mesh_ops.across``
    along a sharded axis of an n-D array, NaN last), each line's count
    of values (without NaN, or -1 where ``squash_nans`` is off and it
    holds one) all-reduced over the processes of the line and pulled to
    the boxes of the result, then each process's 2·k/P (times its kept
    elements) order statistics pulled from the sorted array
    (``mesh_ops.pull``, two all-to-alls). The result
    (k,) + the kept axes takes q's blocks along its first axis and the
    operand's along the others; q is never read whole."""
    backend = a.backend
    x = _inexact(a.data)
    if x.is_complex():
        raise ValueError("quantile does not support complex input")
    qa, divide = q.q, q.divide
    if qa.ndim > 1:
        raise ValueError(f"q must be have rank <= 1, got shape "
                         f"{tuple(qa.shape)}")
    if axis is not None and not isinstance(axis, (int, np.integer)):
        if len(tuple(axis)) != 1:
            raise NotImplementedError(
                "quantile of several reduced axes at a q on the mesh is not "
                "ported")
        axis = tuple(axis)[0]
    s = _mesh_order(a, x, axis, "sort", False).data
    ax = 0 if axis is None else int(axis) % x.ndim
    kept = [d for d in range(s.ndim) if d != ax]
    kshape = tuple(int(s.shape[d]) for d in kept)
    n_last = int(s.shape[ax])
    spl = tuple(s.placements)
    nan = torch.isnan(s.to_local())
    if squash_nans:
        stat = (~nan).sum(dim=ax)
    else:
        stat = torch.where(nan.any(dim=ax), -1, n_last).to(torch.int64)
    mesh_ops.group_reduce(backend, stat, mesh_ops.shard_dims(spl, (ax,)),
                          "sum" if squash_nans else "min")
    k = int(qa.shape[0])
    out_shape = (k,) + kshape
    blocks = (qa.block_shape[0],) + (() if axis is None else tuple(
        b for d, b in enumerate(a.block_shape) if d != ax))
    bs, out_pl = _mesh_target(a, out_shape, blocks)
    box = backend.region(out_shape, out_pl)
    dev = stat.device
    q_pl = tuple(mesh_ops._shard(0) if p.is_shard() and p.dim == 0
                 else mesh_ops._replicate() for p in out_pl)
    qd = backend.rebox(qa.data, q_pl).to_local().to(
        device=dev, dtype=torch.float64) / divide
    if kept:
        grids = torch.meshgrid(*[torch.arange(lo, hi, device=dev)
                                 for lo, hi in box[1:]], indexing="ij")
        kpos = torch.stack([g.reshape(-1) for g in grids], dim=1)
        st_pl = tuple(mesh_ops._shard(kept.index(p.dim))
                      if p.is_shard() and p.dim != ax
                      else mesh_ops._replicate() for p in spl)
        cnt = mesh_ops.pull(backend, backend.from_local(
            stat.contiguous(), kshape, st_pl), len(kept), kpos)
    else:
        kpos = torch.zeros((1, 0), dtype=torch.int64, device=dev)
        cnt = stat.reshape(1)
    valid = cnt >= 0
    c = torch.where(valid, cnt, n_last).to(torch.float64)
    pos = qd[:, None] * (c[None, :] - 1)
    bad = torch.isnan(pos)
    pos = torch.where(bad, 0.0, pos)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    lim = c[None, :] - 1
    low = torch.clamp(torch.minimum(low, lim), min=0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, lim), min=0).to(torch.int64)

    def at(rank):
        cols = [rank.reshape(-1) if d == ax else kpos[:, kept.index(d)][
            None, :].expand(rank.shape).reshape(-1) for d in range(s.ndim)]
        return torch.stack(cols, dim=1)

    vals = mesh_ops.pull(backend, s, s.ndim, torch.cat([at(low), at(high)]))
    low_v, high_v = vals[:low.numel()].reshape(low.shape), \
        vals[low.numel():].reshape(low.shape)
    out = low_v.to(torch.float64) * low_w + high_v.to(torch.float64) \
        * high_w
    nan_out = bad | ~valid[None, :]
    out = torch.where(nan_out, torch.full_like(out, float("nan")), out)
    out = out.to(x.dtype).reshape(tuple(hi - lo for lo, hi in box))
    return _wrap(a, backend.from_local(out.contiguous(), out_shape, out_pl),
                 bs)


def median(a, axis=None, keepdims=False):
    a = _to_ba(a)
    return _wrap(a, _quantile(a, 0.5, axis, "midpoint", keepdims, False))


def nanmedian(a, axis=None, keepdims=False):
    a = _to_ba(a)
    return _wrap(a, _quantile(a, 0.5, axis, "midpoint", keepdims, True))


def ptp(a, axis=None, keepdims=False):
    a = _to_ba(a)
    x = a.data
    dims = _dims(axis, x.ndim)
    return _wrap(a, torch.amax(x, dim=dims, keepdim=keepdims)
                 - torch.amin(x, dim=dims, keepdim=keepdims))


def count_nonzero(a, axis=None, keepdims=False):
    a = _to_ba(a)
    x = a.data
    dims = _dims(axis, x.ndim)
    out = (x != 0).sum(dim=dims, keepdim=keepdims)
    return _wrap(a, out.to(_default_int(a)))


def average(a, axis=None, weights=None):
    a = _to_ba(a)
    if weights is None:
        return _instance().mean(a, axis=axis)
    w = _to_ba(weights)
    x, wd = elementwise.promote(a.data, w.data, a._default_float())
    x, wd = _inexact(x), _inexact(wd)
    if axis is not None and wd.ndim == 1 and x.ndim > 1:
        shape = [1] * x.ndim
        shape[int(axis) % x.ndim] = wd.shape[0]
        wd = wd.reshape(shape)
    dims = _dims(axis, x.ndim)
    wd = torch.broadcast_to(wd, x.shape)
    return _wrap(a, (x * wd).sum(dim=dims) / wd.sum(dim=dims))


# -- rounding / clipping ------------------------------------------------


def clip(a, a_min=None, a_max=None):
    """``jnp.clip``: ``maximum`` with ``a_min``, then ``minimum`` with
    ``a_max``, each promoting as its ufunc does; complex input or bounds
    raise ``ValueError``, as in jnp."""
    a = _to_ba(a)
    if builtins.any(b.dtype.kind == "c" if isinstance(b, BlockArray)
                    else np.iscomplexobj(b) for b in (a, a_min, a_max)
                    if b is not None):
        raise ValueError("Clip received a complex value either through the "
                         "input or the min/max keywords.")
    out = a
    app = _instance()
    if a_min is not None:
        out = app.map_bop("maximum", out, a_min)
    if a_max is not None:
        out = app.map_bop("minimum", out, a_max)
    if out is a:
        out = a.copy()
    return _wrap(a, out.data, a.block_shape)


def around(a, decimals=0):
    """``jnp.round``: half to even; with ``decimals``, the value scaled by
    ``10**decimals`` in its own dtype, rounded and scaled back. Integers
    are returned as they are."""
    a = _to_ba(a)
    x = a.data
    if not (x.is_floating_point() or x.is_complex()):
        if decimals < 0:
            raise NotImplementedError(
                "integer np.round not implemented for decimals < 0")
        return _wrap(a, x.clone(), a.block_shape)
    if x.is_complex():  # each part on its own
        out = torch.complex(_round_real(x.real, decimals),
                            _round_real(x.imag, decimals))
    else:
        out = _round_real(x, decimals)
    return _wrap(a, out, a.block_shape)


def _round_real(x, decimals):
    if decimals == 0:
        return torch.round(x)
    if decimals > np.log10(torch.finfo(x.dtype).max):
        return x.clone()
    factor = torch.full((), 10.0 ** decimals, dtype=x.dtype,
                        device=x.device)
    return torch.round(x * factor) / factor


round = around  # noqa: A001 - numpy alias
round_ = around


# -- sorting / searching ------------------------------------------------


def _sort_input(a, axis):
    x = a.data
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def sort(a, axis=-1, kind=None, order=None, stable=True, descending=False):
    """np.sort parity: default axis is -1 (None flattens); stable, as
    ``jnp.sort`` is (ties keep their order)."""
    del kind, stable
    if order is not None:
        raise NotImplementedError("'order' argument to sort is not supported.")
    a = _to_ba(a)
    if mesh_ops.is_dtensor(a.data):
        return _mesh_order(a, a.data, axis, "sort", bool(descending))
    x, axis = _sort_input(a, axis)
    return _wrap(a, masking.sort(x, axis, bool(descending))[0])


def argsort(a, axis=-1, kind=None, order=None, stable=True,
            descending=False):
    """np.argsort parity: default axis is -1; stable."""
    del kind, stable
    if order is not None:
        raise NotImplementedError(
            "'order' argument to argsort is not supported.")
    a = _to_ba(a)
    if mesh_ops.is_dtensor(a.data):
        return _mesh_order(a, a.data, axis, "argsort", bool(descending))
    x, axis = _sort_input(a, axis)
    out = masking.argsort(x, axis, bool(descending))
    return _wrap(a, out.to(_default_int(a)))


def _mesh_target(a, shape, block_shape=None):
    """(block shape, placements) of a result of ``shape`` that ``_wrap``
    lays out on ``a``'s mesh."""
    shape = tuple(int(v) for v in shape)
    if block_shape is None:
        block_shape = array_utils.default_block_shape_for(shape,
                                                          a.block_shape)
    bs = tuple(builtins.min(b, v) for b, v in zip(tuple(block_shape), shape))
    return bs, a.backend.sharding_for_grid(ArrayGrid(shape, bs, "float32"))


def _index_dtype(a, n):
    """The default int, or int64 where ``n`` positions overflow it."""
    return torch.int64 if n >= 2**31 - 1 else _default_int(a)


def _mesh_order(a, x, axis, what, descending):
    """``sort``/``argsort`` of a DTensor: axis=None flattens it by rows
    (``mesh_ops.flat_move``, the rows' blocks kept); along an axis that no
    mesh dimension shards each process orders its own lines; a sharded
    1-D array takes the distributed sort (``mesh_ops.sort``: bit for bit
    ``masking.sort``'s order, positions global), an n-D one the sharding
    moved to another axis (``mesh_ops.across``, in chunks of lines)."""
    bs = None
    if axis is None:
        x, bs = _mesh_flat(a, x)
        axis = 0
    axis = int(axis) % builtins.max(x.ndim, 1)
    n = int(x.shape[axis]) if x.ndim else 1
    dt = x.dtype if what == "sort" else _index_dtype(a, n)

    def lines(local, dim):
        if what == "sort":
            return masking.sort(local, dim, descending)[0]
        return masking.argsort(local, dim, descending).to(dt)

    pl = tuple(x.placements)
    if x.ndim == 0 or not mesh_ops.shard_dims(pl, (axis,)):
        return _wrap(a, a.backend.from_local(
            lines(x.to_local(), builtins.max(axis, 0) if x.ndim else -1),
            tuple(x.shape), pl), bs)
    if descending:
        raise NotImplementedError(
            f"{what}: descending along an axis that the mesh shards")
    if x.ndim == 1:
        bs, want = _mesh_target(a, tuple(x.shape), bs)
        out = mesh_ops.sort(a.backend, x, want, want="values"
                            if what == "sort" else "positions")
        return _wrap(a, out.to(dt), bs)
    return _wrap(a, mesh_ops.across(a.backend, x, axis, lines, n, dt,
                                    mesh_ops.CHUNK_ELEMENTS), bs)


def searchsorted(a, v, side="left"):
    if side not in ("left", "right"):
        raise ValueError(f"{side!r} is an invalid value for keyword 'side'")
    a, v = _to_ba(a), _to_ba(v)
    if a.ndim != 1:
        raise ValueError("a should be 1-dimensional")
    seq, vals = _promote_all([a.data, v.data])
    right = side == "right"
    dt = torch.int64 if a.shape[0] >= 2**31 - 1 else torch.int32
    if mesh_ops.is_dtensor(seq):
        # a sharded sequence: each process's count below each value,
        # summed; a whole one: a local search of each process's values
        out = (mesh_ops.searchsorted(a.backend, seq, vals, right)
               if _sharded(seq) else mesh_ops.like(vals, masking.searchsorted(
                   _local(seq), _local(vals), right=right)))
        return _wrap(v, out.to(dt), v.block_shape)
    out = masking.searchsorted(seq, vals, right=right)
    return _wrap(a, out.to(dt))


def _normalize_index(idx, n):
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx)


def take(a, indices, axis=None):
    a = _to_ba(a)
    indices = _to_ba(indices)
    x = a.data
    if _sharded(x):
        return _mesh_take(a, x, indices, axis)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.ndim
    idx = _normalize_index(indices.data.to(x.device), x.shape[axis])
    out = torch.index_select(x, axis, idx.reshape(-1))
    shape = x.shape[:axis] + tuple(idx.shape) + x.shape[axis + 1:]
    return _wrap(a, out.reshape(shape))


def _mesh_take(a, x, indices, axis):
    """``take`` of a sharded DTensor: axis=None flattens it by rows; the
    positions (a device or host int array, flattened) are pulled along
    the axis moved first (``mesh_ops.gather_device``: each process asks
    the holders of its box of the result), then the result takes the
    indices' shape (``mesh_ops.flat_move``) and the axis goes back."""
    bs = None
    if axis is None:
        x, bs = _mesh_flat(a, x)
        axis = 0
    axis = int(axis) % x.ndim
    n = int(x.shape[axis])
    backend = a.backend
    t = mesh_ops.move_axis(backend, x, axis, 0) if axis else x
    idx = indices.data
    if idx.ndim != 1:
        idx = (mesh_ops.flat_move(backend, idx, (int(idx.numel()),),
                                  backend.sharding_for_shape(
                                      (int(idx.numel()),)))
               if mesh_ops.is_dtensor(idx) else idx.reshape(-1))
    if not mesh_ops.is_dtensor(idx):
        local = idx.to(torch.int64)
        if local.numel() and (int(local.max()) >= n or int(local.min()) < -n):
            raise IndexError(f"index out of bounds for axis of size {n}")
    m = int(idx.numel())
    rest = tuple(int(v) for v in t.shape[1:])
    rpl = backend.sharding_for_shape((m,) + rest)
    out = mesh_ops.gather_device(backend, t, [idx], rpl)
    ishape = tuple(indices.shape)
    if ishape != (m,):
        out = mesh_ops.flat_move(backend, out, ishape + rest,
                                 backend.sharding_for_shape(ishape + rest))
    q = len(ishape)
    for k in range(q if axis else 0):
        out = mesh_ops.move_axis(backend, out, q - 1 - k, axis + q - 1 - k)
    return _wrap(a, out, bs)


# -- shape manipulation -------------------------------------------------


def _tensors(arrays):
    bas = [_to_ba(a) for a in arrays]
    return bas, _promote_all([b.data for b in bas])


def _cat(bas, ts, axis, shapes=None):
    """``torch.cat`` of ``ts`` along ``axis``, each first in its shape of
    ``shapes`` (a reshape that adds axes of one), wrapped like ``bas[0]``.
    On the mesh each operand keeps its rows in place (a DTensor reshaped
    by ``mesh_ops.flat_move``, the new axes added locally) and the result
    is laid out by ``mesh_ops.concat`` (one all-to-all along a sharded
    axis), never whole but where its grid is whole."""
    shapes = shapes or [tuple(t.shape) for t in ts]
    if not builtins.any(mesh_ops.is_dtensor(t) for t in ts):
        return _wrap(bas[0], torch.cat([t.reshape(s) for t, s in zip(
            ts, shapes)], dim=axis))
    backend = bas[0].backend
    ts = [_expanded(backend, t, s) for t, s in zip(ts, shapes)]
    shape = list(shapes[0])
    shape[axis] = builtins.sum(s[axis] for s in shapes)
    bs, want = _mesh_target(bas[0], shape)
    return _wrap(bas[0], mesh_ops.concat(backend, ts, axis, want), bs)


def _expanded(backend, t, shape):
    """A tensor in ``shape``, which adds axes of one to its own (a plain
    tensor reshaped; a DTensor's box reshaped with its placements moved
    to the axes they shard)."""
    shape = tuple(int(v) for v in shape)
    if tuple(t.shape) == shape:
        return t
    if not mesh_ops.is_dtensor(t):
        return t.reshape(shape)
    old = [int(v) for v in t.shape]
    at, k = [], 0
    for i, v in enumerate(shape):
        if k < len(old) and v == old[k]:
            at.append(i)
            k += 1
    if len(at) != len(old):
        return mesh_ops.flat_move(backend, t, shape,
                                  backend.sharding_for_shape(shape))
    local = t.to_local()
    lshape = [1] * len(shape)
    for i, j in enumerate(at):
        lshape[j] = int(local.shape[i])
    pl = tuple(mesh_ops._shard(at[p.dim]) if p.is_shard() else p
               for p in t.placements)
    return backend.from_local(local.reshape(lshape), shape, pl)


def stack(arrays, axis=0):
    bas, ts = _tensors(arrays)
    axis = int(axis) % (ts[0].ndim + 1)
    shape = tuple(ts[0].shape)
    one = shape[:axis] + (1,) + shape[axis:]
    return _cat(bas, ts, axis, [one] * len(ts))


def vstack(tup):
    bas, ts = _tensors(tup)
    return _cat(bas, ts, 0, [(1, int(t.numel())) if t.ndim <= 1 else
                             tuple(t.shape) for t in ts])


def hstack(tup):
    bas, ts = _tensors(tup)
    shapes = [(1,) if t.ndim == 0 else tuple(t.shape) for t in ts]
    return _cat(bas, ts, 0 if len(shapes[0]) == 1 else 1, shapes)


def _at_least_3d(t):
    if t.ndim == 0:
        return t.reshape(1, 1, 1)
    if t.ndim == 1:
        return t.reshape(1, -1, 1)
    if t.ndim == 2:
        return t.unsqueeze(-1)
    return t


def dstack(tup):
    bas, ts = _tensors(tup)
    return _cat(bas, ts, 2, [tuple(_at_least_3d(torch.empty(
        tuple(t.shape), device="meta")).shape) for t in ts])


def column_stack(tup):
    bas, ts = _tensors(tup)
    return _cat(bas, ts, 1, [(int(t.numel()), 1) if t.ndim < 2 else
                             tuple(t.shape) for t in ts])


def row_stack(tup):
    return vstack(tup)


def tile(a, reps):
    a = _to_ba(a)
    reps = tuple(reps) if isinstance(reps, (tuple, list)) else (int(reps),)
    if _sharded(a.data):
        return _mesh_tile(a, a.data, tuple(int(r) for r in reps))
    return _wrap(a, torch.tile(a.data, reps))


def _mesh_tile(a, x, reps):
    """``tile`` of a sharded DTensor: along an axis that no mesh dimension
    shards each process tiles its own box; along a sharded one its rows
    are ``reps`` runs of the result, placed by one all-to-all (the same
    tensor sent once a run)."""
    backend = a.backend
    nd = builtins.max(x.ndim, len(reps))
    reps = (1,) * (nd - len(reps)) + reps
    x = _expanded(backend, x, (1,) * (nd - x.ndim) + tuple(x.shape))
    pl = tuple(x.placements)
    local_reps = [1 if mesh_ops.shard_dims(pl, (k,)) else r
                  for k, r in enumerate(reps)]
    shape = tuple(int(v) * r for v, r in zip(x.shape, local_reps))
    t = backend.from_local(torch.tile(x.to_local(), tuple(local_reps)),
                           shape, pl)
    for k, r in enumerate(reps):
        if r == 1 or not mesh_ops.shard_dims(pl, (k,)):
            continue
        t = mesh_ops.along(backend, t, k, lambda u, r=r: _tiled_rows(
            backend, u, r))
    return _wrap(a, t)


def _tiled_rows(backend, t, r):
    """``t`` (a DTensor sharded along axis 0) ``r`` times along axis 0:
    each process's rows are ``r`` runs of the result, placed by one
    ``move_pieces``."""
    n = int(t.shape[0])
    pl = tuple(t.placements)
    shape = (n * r,) + tuple(t.shape[1:])
    coords = backend.coords()
    pieces = [[(i * n + a, i * n + b) for i in range(r)] for a, b in (
        backend.region(tuple(t.shape), pl, c)[0] for c in coords)]
    dst = [backend.region(shape, pl, c)[0] for c in coords]
    local = t.to_local()
    rows = backend.move_pieces([local] * r, pieces, dst, pl)
    return backend.from_local(rows.contiguous(), shape, pl)


def repeat(a, repeats, axis=None):
    a = _to_ba(a)
    x = a.data
    if mesh_ops.is_dtensor(x):
        return _mesh_repeat(a, x, int(repeats), axis)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return _wrap(a, torch.repeat_interleave(x, int(repeats), dim=int(axis)))


def _mesh_repeat(a, x, r, axis):
    """``repeat`` of a DTensor: axis=None flattens it by rows
    first (``mesh_ops.flat_move``); along a sharded axis each process repeats
    its own slab and the rows move to the result's layout
    (``mesh_ops.along_rows``); along any other axis each process repeats
    its own box."""
    bs = None
    if axis is None:
        x, bs = _mesh_flat(a, x)
        bs = (bs[0] * r,)
        axis = 0
    axis = int(axis) % x.ndim
    if not mesh_ops.shard_dims(x.placements, (axis,)):
        local = torch.repeat_interleave(x.to_local(), r, dim=axis)
        shape = list(x.shape)
        shape[axis] *= r
        return _wrap(a, a.backend.from_local(local, tuple(shape),
                                             tuple(x.placements)), bs)
    out = mesh_ops.along_rows(
        a.backend, x, axis, int(x.shape[axis]) * r,
        lambda rows: torch.repeat_interleave(rows, r, dim=0))
    return _wrap(a, out, bs)


def roll(a, shift, axis=None):
    a = _to_ba(a)
    x = a.data
    if mesh_ops.is_dtensor(x):
        return _mesh_roll(a, x, shift, axis)
    if axis is None:
        out = torch.roll(x.reshape(-1), shift).reshape(x.shape)
    else:
        out = torch.roll(x, shift, dims=axis)
    return _wrap(a, out, a.block_shape)


def _mesh_roll(a, x, shift, axis):
    """``roll`` of a DTensor: axis=None by the rows of its flat
    order (``mesh_ops.flat_move`` there and back); along a sharded axis
    each process's rows are one or two runs of the result
    (``mesh_ops.reverse_rows``, one all-to-all); along any other axis each
    process rolls its own box."""
    backend = a.backend
    if axis is None:
        flat, _ = _mesh_flat(a, x)
        out = mesh_ops.along(backend, flat, 0, lambda t: mesh_ops.reverse_rows(
            backend, t, int(shift)))
        return _wrap(a, mesh_ops.flat_move(backend, out, tuple(x.shape),
                                           tuple(x.placements)),
                     a.block_shape)
    shifts = (shift,) if isinstance(shift, (int, np.integer)) else shift
    axes = (axis,) if isinstance(axis, (int, np.integer)) else axis
    t = x
    for s, ax in zip(shifts, axes):
        ax = int(ax) % t.ndim
        if mesh_ops.shard_dims(t.placements, (ax,)):
            t = mesh_ops.along(backend, t, ax, lambda u, s=s: (
                mesh_ops.reverse_rows(backend, u, int(s))))
        else:
            t = mesh_ops.like(t, torch.roll(t.to_local(), int(s), dims=ax))
    return _wrap(a, t, a.block_shape)


def flip(a, axis=None):
    a = _to_ba(a)
    x = a.data
    if mesh_ops.is_dtensor(x):
        # along a sharded axis the rows move; along any other each
        # process flips its own box (a replicated array: its own copy)
        t = x
        for ax in _dims(axis, x.ndim):
            if mesh_ops.shard_dims(t.placements, (ax,)):
                t = mesh_ops.along(a.backend, t, ax,
                                   lambda u: mesh_ops.reverse_rows(
                                       a.backend, u))
            else:
                t = mesh_ops.like(t, torch.flip(t.to_local(), (ax,)))
        return _wrap(a, t, a.block_shape)
    return _wrap(a, torch.flip(x, dims=_dims(axis, x.ndim)), a.block_shape)


def fliplr(a):
    return flip(a, axis=1)


def flipud(a):
    return flip(a, axis=0)


def ravel(a):
    a = _to_ba(a)
    return a.reshape(a.size)


def swapaxes(a, axis1, axis2):
    a = _to_ba(a)
    perm = list(range(a.ndim))
    perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
    return a.transpose(*perm)


def moveaxis(a, source, destination):
    a = _to_ba(a)
    return _wrap(a, torch.movedim(a.data, source, destination))


def atleast_1d(a):
    a = _to_ba(a)
    return a if a.ndim >= 1 else a.reshape(1)


def atleast_2d(a):
    a = _to_ba(a)
    if a.ndim >= 2:
        return a
    if a.ndim == 1:
        return a.reshape(1, a.shape[0])
    return a.reshape(1, 1)


def broadcast_to(a, shape):
    a = _to_ba(a)
    return a.broadcast_to(tuple(shape))


def _triangle(fn, a, k):
    """``fn`` (``torch.tril``/``triu``) at diagonal ``k``; on the mesh each
    process's box at the diagonal its global offsets give (no
    communication)."""
    a = _to_ba(a)
    x = a.data
    if mesh_ops.is_dtensor(x) and x.ndim >= 2:
        box = a.backend.region(tuple(x.shape), x.placements)
        shift = box[-2][0] - box[-1][0]
        return _wrap(a, mesh_ops.like(x, fn(x.to_local(), diagonal=int(
            k) + shift)), a.block_shape)
    return _wrap(a, fn(x, diagonal=int(k)), a.block_shape)


def triu(a, k=0):
    return _triangle(torch.triu, a, k)


def tril(a, k=0):
    return _triangle(torch.tril, a, k)


# -- contractions -------------------------------------------------------


def dot(a, b):
    a, b = _to_ba(a), _to_ba(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim <= 2 and b.ndim <= 2:
        return a @ b
    # np.dot general case: contract last axis of a with 2nd-to-last of b.
    return a.tensordot(b, axes=((a.ndim - 1,), (builtins.max(0, b.ndim - 2),)))


def inner(a, b):
    a, b = _to_ba(a), _to_ba(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == b.ndim == 2 and (_sharded(a.data) or _sharded(b.data)):
        # A·Bᵀ by summa's ring: laid out by A's rows (the reference's
        # one block would hold the (m, n) result whole on every process)
        return _wrap(a, summa.ring_nt(a.backend, a.data, b.data),
                     (a.block_shape[0], int(b.shape[0])))
    return a.tensordot(b, axes=((a.ndim - 1,), (b.ndim - 1,)))


def outer(a, b):
    a, b = _to_ba(a), _to_ba(b)
    return ravel(a).tensordot(ravel(b), axes=0)


def trace(a, offset=0):
    a = _to_ba(a)
    d = _diagonal(a, int(offset))
    return _wrap(a, d.to(_sum_dtype(d.dtype, a)).sum(dim=-1))


def vdot(a, b):
    a, b = _to_ba(a), _to_ba(b)
    return ravel(a).tensordot(ravel(b), axes=1)


def einsum(subscripts, *operands):
    bas, ts = _tensors(operands)
    dt = ts[0].dtype
    work = linear._compute_dtype(dt, ts[0].device)
    out = torch.einsum(subscripts, *[t.to(work) for t in ts])
    out = out != 0 if dt == torch.bool else out.to(dt)
    return _wrap(bas[0], out)


def kron(a, b):
    a, b = _to_ba(a), _to_ba(b)
    x, y = _promote_all([a.data, b.data])
    if mesh_ops.is_dtensor(x) and x.ndim == y.ndim:
        # each process's box of a times the whole b is the box of the
        # result at b.shape times its offsets; the cuts then move
        backend = a.backend
        y = _whole_small(y)
        box = backend.region(tuple(x.shape), x.placements)
        shape = tuple(int(u) * int(v) for u, v in zip(x.shape, y.shape))
        out = torch.kron(x.to_local(), y.to(x.device))
        bs, want = _mesh_target(a, shape)
        out = mesh_ops.relayout(backend, out, [
            (lo * int(v), hi * int(v)) for (lo, hi), v in zip(box, y.shape)],
            shape, tuple(x.placements))
        return _wrap(a, backend.rebox(out, want), bs)
    return _wrap(a, torch.kron(x, y))


def matrix_transpose(a):
    return _to_ba(a).transpose()


# -- predicates ---------------------------------------------------------


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    a, b = _to_ba(a), _to_ba(b)
    x, y = elementwise.promote(a.data, b.data, a._default_float())
    if not (x.is_floating_point() or x.is_complex()):
        return _wrap(a, torch.eq(x, y))
    return _wrap(a, torch.isclose(x, y, rtol=float(rtol), atol=float(atol),
                                  equal_nan=bool(equal_nan)))


def array_equal(a, b):
    a, b = _to_ba(a), _to_ba(b)
    if a.shape != b.shape:
        return _instance().scalar(False)
    x, y = elementwise.promote(a.data, b.data, a._default_float())
    return _wrap(a, torch.eq(x, y).all())


def real(a):
    a = _to_ba(a)
    x = a.data
    return _wrap(a, torch.real(x).clone() if x.is_complex() else x.clone(),
                 a.block_shape)


def imag(a):
    a = _to_ba(a)
    x = a.data
    return _wrap(a, torch.imag(x).clone() if x.is_complex()
                 else torch.zeros_like(x), a.block_shape)


def nan_to_num(a, nan=0.0, posinf=None, neginf=None):
    a = _to_ba(a)
    x = a.data
    if not x.is_floating_point():
        return _wrap(a, x.clone(), a.block_shape)
    return _wrap(a, torch.nan_to_num(x, nan=nan, posinf=posinf,
                                     neginf=neginf), a.block_shape)


def diff(a, n=1, axis=-1):
    a = _to_ba(a)
    x = a.data
    if n == 0:
        return _wrap(a, x.clone())
    axis = int(axis) % x.ndim
    if not mesh_ops.is_dtensor(x):
        return _wrap(a, _diff_local(x, int(n), axis))
    if mesh_ops.shard_dims(x.placements, (axis,)):
        return _wrap(a, _mesh_diff(a.backend, x, int(n), axis))
    # along an axis that no mesh dimension shards: each process's own box
    out = _diff_local(x.to_local(), int(n), axis)
    shape = list(x.shape)
    shape[axis] = int(out.shape[axis])
    return _wrap(a, mesh_ops.like(x, out, tuple(shape)))


def _diff_local(x, n, axis):
    for _ in range(n):
        hi = x.narrow(axis, 1, x.shape[axis] - 1)
        lo = x.narrow(axis, 0, x.shape[axis] - 1)
        x = hi != lo if x.dtype == torch.bool else hi - lo
    return x


def _mesh_diff(backend, x, n, axis):
    """``diff`` along a sharded axis: each process differences its own
    rows and, for its last one, the first row of the next box (a halo of
    one row, ``mesh_ops.halo``); its output rows [lo, min(hi, n - 1)) are
    then placed (``mesh_ops.relayout``: nothing moves where the cuts
    agree). ``n`` times."""
    def once(t):
        m = int(t.shape[0])
        pl = tuple(t.placements)
        box = backend.region(tuple(t.shape), pl)
        lo, hi = box[0]
        _, post = mesh_ops.halo(backend, t, 0, 1)
        local = t.to_local()
        k = builtins.max(0, builtins.min(hi, m - 1) - lo)
        op = torch.ne if local.dtype == torch.bool else torch.sub
        out = torch.empty((k,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        inner = builtins.min(k, builtins.max(int(local.shape[0]) - 1, 0))
        op(local[1:inner + 1], local[:inner], out=out[:inner])
        if inner < k:
            op(post[:1], local[inner:inner + 1], out=out[inner:k])
        return mesh_ops.relayout(backend, out, ((lo, lo + k),) + box[1:],
                                 (m - 1,) + tuple(t.shape[1:]), pl)

    def run(t):
        for _ in range(n):
            t = once(t)
        return t

    return mesh_ops.along(backend, x, axis, run)


def unique(a, return_index=False, return_inverse=False,
           return_counts=False, axis=None, *, equal_nan=True):
    """``np.unique`` on the device: one host sync, for the distinct count
    (``masking.device_unique``). With ``axis``, ``np.unique`` of a host
    copy, as the reference does (``extra.py:474-490`` there)."""
    a = _to_ba(a)
    app = _instance()
    if axis is not None or a.size == 0:
        # The reference's host step: unique rows or columns, and the empty
        # array, go through np.unique on a host copy.
        outs = np.unique(
            a.get(), return_index=return_index,
            return_inverse=return_inverse, return_counts=return_counts,
            axis=axis, equal_nan=equal_nan,
        )
        if not isinstance(outs, tuple):
            return app.array(outs, block_shape=outs.shape)
        return tuple(app.array(o, block_shape=o.shape) for o in outs)
    if a.backend.mesh is not None:
        wrapped = mesh_unique([a], return_index, return_inverse,
                              return_counts, equal_nan)
        return wrapped if len(wrapped) > 1 else wrapped[0]
    _, outs = masking.device_unique(
        a, want_index=return_index, want_inverse=return_inverse,
        want_counts=return_counts, equal_nan=equal_nan,
    )
    dint = _default_int(a)
    outs = [outs[0]] + [o.to(dint) for o in outs[1:]]
    wrapped = tuple(
        BlockArray.from_torch(o, block_shape=tuple(o.shape),
                              backend=a.backend)
        for o in outs
    )
    return wrapped if len(wrapped) > 1 else wrapped[0]


def mesh_unique(arrays, want_index=False, want_inverse=False,
                want_counts=False, equal_nan=True):
    """``mesh_ops.unique`` of the elements of ``arrays`` (non-empty
    BlockArrays of one dtype) as BlockArrays: the distinct values, their
    first index and counts in as many blocks as the inputs had (a
    sharded input gives a sharded result), the inverse blocked as the
    first input; indices in the default int."""
    a = arrays[0]
    total, outs = mesh_ops.unique(
        a.backend, [x.data for x in arrays], want_index=want_index,
        want_inverse=want_inverse, want_counts=want_counts,
        equal_nan=equal_nan)
    dint = _default_int(a)
    rows = a.mesh_rows_block(total, builtins.sum(x.grid.num_blocks
                                             for x in arrays))
    inv_at = (2 if want_index else 1) if want_inverse else -1
    res = []
    for i, o in enumerate(outs):
        if i == inv_at:
            res.append(BlockArray(o.to(dint), ArrayGrid(
                a.shape, a.block_shape, array_utils.to_dtype_name(dint)),
                a.backend))
            continue
        res.append(BlockArray.from_torch(o.to(dint) if i else o, (rows,),
                                         a.backend))
    return tuple(res)


# -- statistics ----------------------------------------------------------


def percentile(a, q, axis=None):
    a = _to_ba(a)
    q = _q_arg(q, 100.0)
    if _device_q(q):
        return _mesh_quantile_at(a, q, axis, False)
    return _wrap(a, _quantile(a, q, axis, "linear", False, False))


def quantile(a, q, axis=None):
    a = _to_ba(a)
    q = _q_arg(q)
    if _device_q(q):
        return _mesh_quantile_at(a, q, axis, False)
    return _wrap(a, _quantile(a, q, axis, "linear", False, False))


def _linspace(start, stop, num, dtype, device):
    """``jnp.linspace(start, stop, num)`` of two 0-d tensors: the lerp
    that recovers both ends, the last point ``stop`` itself."""
    if num == 1:
        return start.reshape(1).to(dtype)
    div = num - 1
    t = torch.arange(div, dtype=dtype, device=device) / div
    out = start.to(dtype) * (1 - t) + stop.to(dtype) * t
    return torch.cat([out, stop.to(dtype).reshape(1)])


def hist_edges(x, bins, range):  # noqa: A002
    """``jnp.histogram_bin_edges`` of a 1-D inexact tensor: ``bins`` as
    given, or ``bins + 1`` points over ``range`` (the data's min and max,
    widened by 0.5 each way where they are equal). Of a DTensor the edges
    are whole on every process: its min and max by one all-reduce."""
    if not isinstance(bins, (int, np.integer)):
        return torch.as_tensor(np.asarray(bins), device=_local(x).device).to(
            x.dtype)
    if range is None and mesh_ops.is_dtensor(x):
        lo, hi = mesh_ops.global_min_max(x)
        x = x.to_local()
    elif range is None:
        lo, hi = x.min(), x.max()
    else:
        x = _local(x)
        lo = torch.tensor(range[0], dtype=x.dtype, device=x.device)
        hi = torch.tensor(range[1], dtype=x.dtype, device=x.device)
    same = hi == lo
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    return _linspace(lo, hi, int(bins) + 1, x.dtype, x.device)


def histogram(a, bins=10, range=None):  # noqa: A002
    """``jnp.histogram``: ``hist_edges``, counts by ``searchsorted(edges,
    x, side='right')`` with the last bin closed; counted on the device
    with ``bincount`` (``torch.histogram`` has no CUDA kernel)."""
    a = _to_ba(a)
    x = _inexact(a.data)
    if mesh_ops.is_dtensor(x):
        # the edges by one all-reduce, each process's counts, summed
        edges = hist_edges(x, bins, range)
        x = mesh_ops.local_counted(x)
    else:
        x = x.reshape(-1)
        edges = hist_edges(x, bins, range)
    nb = edges.shape[0]
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    counts = torch.bincount(idx, minlength=nb + 1)[1:nb]
    if a.backend.mesh is not None:
        multiprocess.all_reduce_(counts)
    return _wrap(a, counts.to(x.dtype)), _wrap(a, edges)


def _cov(x, rowvar, ddof):
    x = _inexact(x)
    X = x.reshape(1, -1) if x.ndim < 2 else x
    if not rowvar and x.ndim != 1:
        X = X.T
    if ddof is None:
        ddof = 1
    f = X.shape[1] - ddof
    X = X - X.mean(dim=1, keepdim=True)
    out = torch.matmul(X, X.T.conj()) / f
    return out.squeeze()


def _mesh_cov(m, x, rowvar, ddof):
    """``_cov`` of a DTensor whose observations axis the mesh shards:
    the variables first whole on each process, the means from each
    process's sums
    (one all-reduce), then each process's centred rows in the plain
    product that ``_cov`` takes, summed (one all-reduce of the d×d sum);
    no transposed copy of the operand. A sharded vector is one variable,
    the (1, n) matrix of its observations. None where the observations
    are not sharded."""
    backend = m.backend
    if x.ndim == 1 and mesh_ops.shard_dims(x.placements, (0,)):
        x = backend.from_local(x.to_local().reshape(1, -1),
                               (1, int(x.shape[0])),
                               tuple(mesh_ops._shard(1) if p.is_shard()
                                     else p for p in x.placements))
        rowvar = True
    obs = 1 if rowvar else 0
    if (x.ndim == 2 and rowvar and mesh_ops.shard_dims(x.placements, (0,))
            and not mesh_ops.shard_dims(x.placements, (1,))):
        # the variables sharded, each with its observations whole: each
        # row centred where it lies, then the (n, n) product by summa's
        # ring, laid out by the rows
        x = _inexact(x)
        local = x.to_local()
        centred = backend.from_local(
            local - local.mean(dim=1, keepdim=True), tuple(x.shape),
            tuple(x.placements))
        f = int(x.shape[1]) - (1 if ddof is None else ddof)
        return summa.ring_nt(backend, centred, centred, conj=True) / f
    if x.ndim != 2 or not mesh_ops.shard_dims(x.placements, (obs,)):
        return None
    # the variables whole on each process: the mesh dimensions that shard
    # them shard the observations too (an all-to-all)
    x = backend.rebox(x, tuple(mesh_ops._shard(obs) if p.is_shard() else p
                               for p in x.placements))
    x = _inexact(x)
    local = x.to_local()
    here = backend.counts_here(x.placements)
    n = int(x.shape[obs])
    ddof = 1 if ddof is None else ddof
    dims = mesh_ops.shard_dims(x.placements, (obs,))
    s = local.sum(dim=obs) if here else torch.zeros(
        int(x.shape[1 - obs]), dtype=local.dtype, device=local.device)
    mean = mesh_ops.group_reduce(backend, s, dims) / n
    centred = local - (mean[None, :] if obs == 0 else mean[:, None])
    xs = centred.T if obs == 0 else centred
    prod = torch.matmul(xs, xs.T.conj())
    if not here:
        prod = torch.zeros_like(prod)
    out = mesh_ops.group_reduce(backend, prod, dims) / (n - ddof)
    return backend.from_local(out.squeeze(), tuple(out.squeeze().shape),
                              backend.replicated())


def cov(m, rowvar=True, ddof=None):
    m = _to_ba(m)
    return _wrap(m, _cov_of(m, rowvar, ddof))


def corrcoef(m, rowvar=True):
    m = _to_ba(m)
    c = _cov_of(m, rowvar, None)
    if mesh_ops.is_dtensor(c):  # a Partial sum laid out by the rule first
        c = _wrap(m, c).data
    if _sharded(c):
        return _wrap(m, _mesh_corr(m.backend, c))
    if mesh_ops.is_dtensor(c):
        return _wrap(m, mesh_ops.like(c, _corr(c.to_local())))
    return _wrap(m, _corr(c))


def _mesh_corr(backend, c):
    """``_corr`` of a sharded (n, n) DTensor: the diagonal from the boxes
    that hold it (one all-reduce of n values within each group of boxes),
    then each box divided by its rows' and columns' deviations."""
    pl = tuple(c.placements)
    (r0, r1), (c0, c1) = backend.region(tuple(c.shape), pl)
    local = c.to_local()
    d = torch.zeros(int(c.shape[0]), dtype=local.dtype, device=local.device)
    lo, hi = max(r0, c0), min(r1, c1)
    if hi > lo:
        d[lo:hi] = torch.diagonal(local[lo - r0:hi - r0, lo - c0:hi - c0])
    d = mesh_ops.group_reduce(backend, d, mesh_ops.shard_dims(pl, (0, 1)))
    std = torch.sqrt(d.real).to(local.dtype)
    out = torch.clamp(local / std[r0:r1, None] / std[None, c0:c1], -1, 1)
    return backend.from_local(out.contiguous(), tuple(c.shape), pl)


def _cov_of(m, rowvar, ddof):
    """``_cov`` of m's tensor: on the mesh, by ``_mesh_cov`` where the
    observations are sharded, on each process's copy where nothing is."""
    x = m.data
    if _sharded(x):
        c = _mesh_cov(m, x, rowvar, ddof)
        if c is not None:
            return c
    elif mesh_ops.is_dtensor(x):
        c = _cov(x.to_local(), rowvar, ddof)
        return m.backend.from_local(c, tuple(c.shape),
                                    m.backend.replicated())
    return _cov(x, rowvar, ddof)


def _corr(c):
    if c.ndim == 0:
        return c / c
    std = torch.sqrt(torch.diagonal(c).real).to(c.dtype)
    c = c / std[:, None] / std[None, :]
    return torch.clamp(c, -1, 1)


def interp(x, xp, fp):
    """``jnp.interp``: linear between the two neighbours of
    ``searchsorted(xp, x, 'right')``, ``fp[0]`` left of ``xp[0]`` and
    ``fp[-1]`` right of ``xp[-1]``."""
    x, xp, fp = _to_ba(x), _to_ba(xp), _to_ba(fp)
    xd, xpd = elementwise.promote(x.data, xp.data, x._default_float())
    xd, xpd = _inexact(xd), _inexact(xpd)
    fpd = _inexact(fp.data)
    if x.backend.mesh is not None:
        f = _mesh_interp(x.backend, xd, xpd, fpd)
        return _wrap(x, mesh_ops.like(xd, f), x.block_shape)
    f = _interp(xd, xpd, fpd, torch.searchsorted(xpd, xd.contiguous(),
                                                 right=True),
                lambda t, i: t[i])
    return _wrap(x, f)


def _mesh_interp(backend, xd, xpd, fpd):
    """``interp`` on the mesh, on this process's part of ``x``: the
    position in a sharded ``xp`` as a summed count, and the neighbours'
    values asked of their holders (``mesh_ops.take``)."""
    if not (_sharded(xpd) or _sharded(fpd)):
        xp, fp = _local(xpd), _local(fpd)
        return _interp(_local(xd), xp, fp, torch.searchsorted(
            xp, _local(xd).contiguous(), right=True), lambda t, i: t[i])
    pos = _local(mesh_ops.searchsorted(backend, xpd, xd, True))

    def at(t, i):
        return (mesh_ops.take(backend, t, i) if _sharded(t)
                else _local(t)[i])

    return _interp(_local(xd), xpd, fpd, pos, at)


def _interp(xd, xpd, fpd, pos, at):
    """``jnp.interp``'s formula; ``at(t, i)`` reads ``t`` at positions
    ``i``."""
    n = int(xpd.shape[0])
    i = torch.clamp(pos, 1, n - 1)
    ends = torch.tensor([0, n - 1], dtype=torch.int64, device=xd.device)
    x0, xn = at(xpd, ends)
    f0, fn = at(fpd, ends)
    xi, xi1 = at(xpd, i), at(xpd, i - 1)
    fi, fi1 = at(fpd, i), at(fpd, i - 1)
    df = fi - fi1
    dx = xi - xi1
    delta = xd - xi1
    eps = np.spacing(np.finfo(
        str(xpd.dtype).replace("torch.", "")).eps)
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fi1,
                    fi1 + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(xd < x0, f0, f)
    return torch.where(xd > xn, fn, f)


def _pad_index(n, before, after, mode, device):
    """Source positions along one axis for ``np.pad``'s ``edge``,
    ``wrap``, ``reflect`` and ``symmetric`` modes, at any pad width."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        j = torch.remainder(i, 2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    # symmetric
    j = torch.remainder(i, 2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


_PAD_MODES = ("constant", "edge", "wrap", "reflect", "symmetric")


def pad(array, pad_width, mode="constant", constant_values=0):
    """``np.pad`` for the ``constant``, ``edge``, ``wrap``, ``reflect``
    and ``symmetric`` modes, one axis after the other (the corners take
    the later axes' values, as in NumPy and jnp)."""
    a = _to_ba(array)
    if mode not in _PAD_MODES:
        raise NotImplementedError(f"pad mode {mode!r} is not supported")
    if isinstance(pad_width, int):
        pw = ((pad_width, pad_width),) * a.ndim
    else:
        pw = tuple(
            (w, w) if isinstance(w, int) else tuple(w) for w in pad_width
        )
        if len(pw) == 1:
            pw = pw * a.ndim
    x = a.data
    if mode == "constant":
        values = np.broadcast_to(np.asarray(constant_values),
                                 (x.ndim, 2))
    if mesh_ops.is_dtensor(x):
        return _wrap(a, _mesh_pad(a.backend, x, pw, mode, values
                                  if mode == "constant" else None))
    for axis, (before, after) in enumerate(pw):
        before, after = int(before), int(after)
        if before == 0 and after == 0:
            continue
        if mode == "constant":
            parts = []
            for width, value in ((before, values[axis][0]),
                                 (after, values[axis][1])):
                shape = list(x.shape)
                shape[axis] = width
                parts.append(torch.full(shape, value.item(), dtype=x.dtype,
                                        device=x.device))
            x = torch.cat([parts[0], x, parts[1]], dim=axis)
        else:
            idx = _pad_index(x.shape[axis], before, after, mode, x.device)
            x = torch.index_select(x, axis, idx)
    return _wrap(a, x)


def _mesh_pad(backend, x, pw, mode, values):
    """``pad`` of a DTensor, one axis after the other: an axis
    that no mesh dimension shards is padded in each process's box; a
    sharded one by ``mesh_ops.pad_axis`` (its rows moved by position,
    never gathered)."""
    for axis, (before, after) in enumerate(pw):
        before, after = int(before), int(after)
        if before == 0 and after == 0:
            continue
        n = int(x.shape[axis])
        if mode == "constant":
            lo, hi = values[axis][0].item(), values[axis][1].item()
        if mesh_ops.shard_dims(x.placements, (axis,)):
            if mode == "constant" and lo == hi:
                x = mesh_ops.pad_axis(backend, x, axis, before, after, None,
                                      fill=lo)
                continue
            if mode == "constant":
                # two fills: the "after" side first, then the "before"
                x = mesh_ops.pad_axis(backend, x, axis, 0, after, None,
                                      fill=hi)
                x = mesh_ops.pad_axis(backend, x, axis, before, 0, None,
                                      fill=lo)
                continue
            x = mesh_ops.pad_axis(
                backend, x, axis, before, after,
                lambda i: _pad_index(n, before, after, mode, i.device)[i])
            continue
        local = x.to_local()
        if mode == "constant":
            parts = []
            for width, value in ((before, lo), (after, hi)):
                shape = list(local.shape)
                shape[axis] = width
                parts.append(torch.full(shape, value, dtype=local.dtype,
                                        device=local.device))
            local = torch.cat([parts[0], local, parts[1]], dim=axis)
        else:
            idx = _pad_index(n, before, after, mode, local.device)
            local = torch.index_select(local, axis, idx)
        shape = list(x.shape)
        shape[axis] = n + before + after
        x = backend.from_local(local.contiguous(), tuple(shape),
                               tuple(x.placements))
    return x


def bincount(x, minlength=0):
    """Output length is max(x)+1, data-dependent: one host sync sizes it,
    as in the reference; the counting runs on the device. A negative value
    raises ``ValueError``, as NumPy's (jnp counts it in bin 0; ROADMAP
    Queue C)."""
    x = _to_ba(x)
    if x.backend.mesh is not None and x.size:
        # the bounds by all-reduces (every process raises alike), each
        # process's counts, summed
        low, top = mesh_ops.global_min_max(x.data)
        _check_counted(int(low))
        length = builtins.max(int(minlength), int(top) + 1)
        out = torch.bincount(mesh_ops.local_counted(x.data).to(torch.int64),
                             minlength=length)
        multiprocess.all_reduce_(out)
        return _wrap(x, out.to(_default_int(x)), (length,))
    if x.size:
        _check_counted(int(x.min()))
    length = builtins.max(
        int(minlength), int(x.max()) + 1 if x.size else 0
    )
    out = torch.bincount(x.data.reshape(-1).to(torch.int64),
                         minlength=length)
    return _wrap(x, out.to(_default_int(x)))


def _check_counted(low):
    if low < 0:
        raise ValueError("bincount: the values must not be negative")


# -- remaining manipulation / misc ---------------------------------------


def full_like(a, fill_value, dtype=None, shape=None):
    a = _to_ba(a)
    app = _instance()
    shape = tuple(shape) if shape is not None else a.shape
    dtype = dtype if dtype is not None else a.dtype
    block_shape = app.get_block_shape(shape, dtype)
    return app.full(shape, block_shape, fill_value, dtype)


def geomspace(start, stop, num=50, endpoint=True, dtype=None):
    from nums_tpu_torch.numpy import api as _api

    return _api.logspace(
        float(np.log10(start)), float(np.log10(stop)), num=num,
        endpoint=endpoint, dtype=dtype,
    )


def append(arr, values, axis=None):
    arr, values = _to_ba(arr), _to_ba(values)
    x, v = _promote_all([arr.data, values.data])
    if mesh_ops.is_dtensor(x) or mesh_ops.is_dtensor(v):
        if axis is None:
            # each flattened by rows, the result in the rows' blocks
            parts = [_mesh_flat(b, t)[0] if mesh_ops.is_dtensor(t)
                     else t.reshape(-1) for b, t in ((arr, x), (values, v))]
            shape = (int(x.numel()) + int(v.numel()),)
            bs, want = _mesh_target(arr, shape, _flat_block(arr))
            return _wrap(arr, mesh_ops.concat(arr.backend, parts, 0, want),
                         bs)
        return _cat([arr, values], [x, v], int(axis) % x.ndim)
    if axis is None:
        return _wrap(arr, torch.cat([x.reshape(-1), v.reshape(-1)]))
    return _wrap(arr, torch.cat([x, v], dim=int(axis)))


def array_split(ary, indices_or_sections, axis=0):
    ary = _to_ba(ary)
    if isinstance(indices_or_sections, int):
        bounds = np.array_split(np.arange(ary.shape[axis]),
                                indices_or_sections)
        cuts = [(int(b[0]), int(b[-1]) + 1) for b in bounds if len(b)]
    else:
        idx = [0] + list(indices_or_sections) + [ary.shape[axis]]
        cuts = [(idx[i], idx[i + 1]) for i in range(len(idx) - 1)]
    out = []
    for lo, hi in cuts:
        sel = tuple(
            slice(lo, hi) if ax == axis else slice(None)
            for ax in range(ary.ndim)
        )
        out.append(ary[sel])
    return out


def vsplit(ary, n):
    return array_split(ary, n, axis=0)


def hsplit(ary, n):
    return array_split(ary, n, axis=1)


def dsplit(ary, n):
    return array_split(ary, n, axis=2)


def atleast_3d(a):
    a = _to_ba(a)
    if a.ndim >= 3:
        return a
    if a.ndim == 2:
        return a.reshape(a.shape[0], a.shape[1], 1)
    if a.ndim == 1:
        return a.reshape(1, a.shape[0], 1)
    return a.reshape(1, 1, 1)


def diagonal(a, offset=0):
    a = _to_ba(a)
    return _wrap(a, _diagonal(a, int(offset)).clone())


def _diagonal(a, offset):
    """``torch.diagonal`` of a 2-D array; of a sharded DTensor, each
    process's diagonal entries within its box, gathered with their
    positions (one all-gather of the diagonal's entries, no more), whole
    on every process."""
    x = a.data
    if not (_sharded(x) and x.ndim == 2):
        return torch.diagonal(x, offset=offset)
    backend = a.backend
    (r0, r1), (c0, c1) = backend.region(tuple(x.shape), x.placements)
    i0, i1 = builtins.max(r0, c0 - offset), builtins.min(r1, c1 - offset)
    first = builtins.max(0, -offset)
    m = int(torch.diagonal(torch.empty(tuple(x.shape), device="meta"),
                           offset=offset).shape[0])
    local = x.to_local()
    rows = torch.arange(builtins.max(i0, 0), builtins.max(i1, i0, 0),
                        device=local.device)
    if not backend.counts_here(x.placements):
        rows = rows[:0]
    vals = local[rows - r0, rows + offset - c0]
    out = local.new_empty((m,))
    for v, pos in zip(mesh_ops._all_gather_var(vals),
                      mesh_ops._all_gather_var(rows - first)):
        out[pos.to(out.device)] = v.to(out.device)
    return backend.from_local(out, (m,), backend.replicated())


def diagflat(v, k=0):
    v = _to_ba(v)
    if _sharded(v.data):
        # each process writes its own rows (the reference's one block
        # would hold the (N, N) result whole on every process)
        n = int(np.prod(v.shape, dtype=np.int64)) + builtins.abs(int(k))
        grid = ArrayGrid((n, n), (int(np.prod(v.block_shape)), n),
                         array_utils.to_dtype_name(v.data.dtype))
        return BlockArray(mesh_ops.diagonal_matrix(
            v.backend, v.data, k, (n, n), v.backend.sharding_for_grid(grid)),
            grid, v.backend)
    out = torch.diagflat(_local(v.data), offset=int(k))
    return _wrap(v, mesh_ops.like(v.data, out, tuple(out.shape)))


def digitize(x, bins, right=False):
    """``jnp.digitize``: ``searchsorted`` on increasing bins (side
    ``right`` unless ``right=True``), mirrored on decreasing ones."""
    x, bins = _to_ba(x), _to_ba(bins)
    if bins.ndim != 1:
        raise ValueError("digitize: bins must be a 1-dimensional array")
    b, xd = _promote_all([bins.data, x.data])
    if b.shape[0] == 0:
        return _wrap(x, torch.zeros_like(xd, dtype=torch.int32))
    dt = torch.int64 if b.shape[0] >= 2**31 - 1 else torch.int32
    if _sharded(b):
        # each process's count below each value, summed: the count of a
        # decreasing shard is its flip's
        n = int(b.shape[0])
        ends = mesh_ops.take(x.backend, b, torch.tensor(
            [0, n - 1], device=_local(b).device))
        rising = bool(ends[1] >= ends[0])

        def count(local, here, v):
            local = local if rising else torch.flip(local, (0,))
            return mesh_ops._local_count(local, here, v, not right)

        got = mesh_ops.summed_counts(x.backend, b, xd, count)
        return _wrap(x, (got if rising else n - got).to(dt), x.block_shape)
    b, xl = _local(b), _local(xd).contiguous()
    up = torch.searchsorted(b, xl, right=not right)
    down = b.shape[0] - torch.searchsorted(torch.flip(b, (0,)), xl,
                                           right=not right)
    out = torch.where(b[-1] >= b[0], up, down).to(dt)
    return _wrap(x, mesh_ops.like(xd, out),
                 x.block_shape if mesh_ops.is_dtensor(xd) else None)


def angle(z, deg=False):
    z = _to_ba(z)
    x = z.data
    if x.is_complex():
        out = torch.angle(x)
    else:
        x = _inexact(x)
        out = torch.atan2(torch.zeros_like(x), x)
    if deg:
        out = out * (180.0 / np.pi)
    return _wrap(z, out, z.block_shape)


def fix(x):
    x = _to_ba(x)
    return x.ufunc("trunc")


def divmod(x1, x2):  # noqa: A001
    """``jnp.divmod``: ``floor_divide`` and ``remainder`` for integers;
    for floats CPython's float divmod on the truncated remainder, the
    quotient rounded half to even."""
    x1 = _to_ba(x1)
    x2 = _to_ba(x2)
    a, b = elementwise.promote(x1.data, x2.data, x1._default_float())
    if a.dtype == torch.bool:
        a, b = a.to(torch.int32), b.to(torch.int32)
    if not a.is_floating_point():
        q = elementwise.bop("floor_divide", a, b, x1._default_float())
        r = elementwise.bop("remainder", a, b, x1._default_float())
        return _wrap(x1, q), _wrap(x1, r)
    q, r = elementwise.float_divmod(a, b)
    return _wrap(x1, q), _wrap(x1, r)


def _mask_indices_1d(condition, device):
    """The True positions of a flattened condition: a device-held mask on
    its device (``masking.device_where``, one scalar sync), a host mask by
    ``np.where``."""
    if isinstance(condition, BlockArray):
        flat = condition if condition.ndim == 1 else ravel(condition)
        _, idx = masking.device_where(flat != 0)
        return idx[0]
    return torch.from_numpy(
        np.where(np.ravel(np.asarray(condition)))[0]).to(device)


def _mesh_compress(condition, a, axis):
    """``compress`` on the mesh: the axis moved first (a view) and masked
    by ``mesh_ops.select``, then moved back. A condition of another
    length than the axis (shorter: the rest is False) is cut or padded
    (``_fitted_condition``)."""
    cond = _to_ba(condition if isinstance(condition, BlockArray)
                  else np.asarray(condition))
    if axis is None:
        a, axis = ravel(a), 0
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    mask = (cond != 0).data
    if tuple(mask.shape) != (n,):
        mask = _fitted_condition(a.backend, mask, n)
    out = mesh_ops.select(a.backend, mesh_ops.move_axis(
        a.backend, a.data, axis, 0), mask)
    block = list(a.block_shape)
    block.insert(0, block.pop(axis))
    block[0] = a.mesh_rows_block(out.shape[0], a.grid_shape[axis])
    block.insert(axis, block.pop(0))
    return _wrap(a, mesh_ops.move_axis(a.backend, out, 0, axis), block)


def _fitted_condition(backend, mask, n):
    """A 1-D bool condition of another length than the axis's ``n`` as
    ``n`` entries, the rest False; a True past the axis raises
    ``IndexError`` (on every process). A DTensor's first entries are
    pulled by position (``mesh_ops.gather_rows``), laid out as it is."""
    if not mesh_ops.is_dtensor(mask):
        mask = mask.reshape(-1)
        if mask[n:].any():
            raise IndexError("compress: a condition past the axis")
        return torch.cat([mask[:n], mask.new_zeros(
            builtins.max(0, n - mask.shape[0]))])
    m = int(mask.shape[0])
    a, _ = backend.region((m,), mask.placements)[0]
    past = mask.to_local()[builtins.max(0, n - a):].sum().reshape(1)
    if int(multiprocess.all_reduce_(past.to(torch.int64))[0]):
        raise IndexError("compress: a condition past the axis")
    pos = np.arange(n)
    out = mesh_ops.gather_rows(backend, mask, np.where(pos < m, pos, -1))
    lo, _ = backend.region((n,), out.placements)[0]
    out.to_local()[builtins.max(0, m - lo):] = False
    return out


def compress(condition, a, axis=None):
    """np.compress with device-resolved mask indices (one scalar sync)."""
    a = _to_ba(a)
    if a.backend.mesh is not None:
        return _mesh_compress(condition, a, axis)
    idx = _mask_indices_1d(condition, a.data.device)
    if axis is None:
        return ravel(a)[idx]
    sel = tuple(
        idx if ax == axis else slice(None) for ax in range(a.ndim)
    )
    return a[sel]


def extract(condition, arr):
    """np.extract with device-resolved mask indices (one scalar sync)."""
    arr = _to_ba(arr)
    if arr.backend.mesh is not None:
        cond = _to_ba(condition)
        if cond.shape == arr.shape and arr.ndim:
            return arr[cond != 0]  # packed in row-major order
        return _mesh_compress(ravel(cond), arr, None)
    return ravel(arr)[_mask_indices_1d(condition, arr.data.device)]


def broadcast_arrays(*args):
    bas = [_to_ba(a) for a in args]
    target = np.broadcast_shapes(*[b.shape for b in bas])
    return [b.broadcast_to(target) for b in bas]


broadcast_shapes = np.broadcast_shapes


def asanyarray(a, dtype=None):
    from nums_tpu_torch.numpy import api as _api

    return _api.asarray(a, dtype=dtype)


def astype(x, dtype):
    return _to_ba(x).astype(dtype)


# NumPy 2 operator aliases.
def _alias_of(target_name, module=None):
    def alias(*args, **kwargs):
        from nums_tpu_torch.numpy import api as _api

        mod = module if module is not None else _api
        return getattr(mod, target_name)(*args, **kwargs)

    alias.__name__ = target_name
    return alias


acos = _alias_of("arccos")
acosh = _alias_of("arccosh")
asin = _alias_of("arcsin")
asinh = _alias_of("arcsinh")
atan = _alias_of("arctan")
atanh = _alias_of("arctanh")
atan2 = _alias_of("arctan2")
bitwise_invert = _alias_of("invert")
bitwise_left_shift = _alias_of("left_shift")
bitwise_right_shift = _alias_of("right_shift")
concat = _alias_of("concatenate")
pow = _alias_of("power")  # noqa: A001
permute_dims = _alias_of("transpose")


# -- signal / misc -------------------------------------------------------


def meshgrid(*xi, indexing="xy"):
    """``np.meshgrid`` (``indexing="xy"`` by default, as in NumPy and
    jnp; torch's default is ``"ij"``): each output keeps its input's
    dtype."""
    if indexing not in ("xy", "ij"):
        raise ValueError("Valid values for `indexing` are 'xy' and 'ij'.")
    bas = [_to_ba(x) for x in xi]
    ts = [b.data.reshape(-1) for b in bas]
    shape = [t.shape[0] for t in ts]
    if indexing == "xy" and len(ts) > 1:
        shape[0], shape[1] = shape[1], shape[0]
    outs = []
    for i, t in enumerate(ts):
        pos = i
        if indexing == "xy" and len(ts) > 1 and i < 2:
            pos = 1 - i
        view = [1] * len(ts)
        view[pos] = -1
        outs.append(torch.broadcast_to(t.reshape(view), shape).contiguous())
    return [_wrap(bas[0], o) for o in outs]


def cross(a, b, axis=-1):
    """``np.cross`` of 2- and 3-vectors along ``axis``; two 2-vectors give
    the z component alone."""
    a, b = _to_ba(a), _to_ba(b)
    x, y = _promote_all([a.data, b.data])
    x, y = torch.movedim(x, axis, -1), torch.movedim(y, axis, -1)
    if x.shape[-1] not in (2, 3) or y.shape[-1] not in (2, 3):
        raise ValueError("incompatible dimensions for cross product")
    if x.shape[-1] == 2 and y.shape[-1] == 2:
        return _wrap(a, x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0])

    def parts(t):
        z = t[..., 2] if t.shape[-1] == 3 else torch.zeros_like(t[..., 0])
        return t[..., 0], t[..., 1], z

    a0, a1, a2 = parts(x)
    b0, b1, b2 = parts(y)
    out = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                       a0 * b1 - a1 * b0], dim=-1)
    return _wrap(a, torch.movedim(out, -1, axis))


def _conv(x, y, mode, op):
    """``jnp``'s 1-D ``convolve``/``correlate``: the longer operand
    slides, the kernel flipped for ``convolve``, the output reversed for a
    ``correlate`` whose operands were swapped; computed by ``conv1d`` in
    the operands' inexact dtype."""
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError(f"{op}() only support 1-dimensional inputs.")
    x, y = _promote_all([x, y])
    x, y = _inexact(x), _inexact(y)
    if len(x) == 0 or len(y) == 0:
        raise ValueError(f"{op}: inputs cannot be empty")
    reverse = False
    if op == "correlate":
        y = y.conj()
        if len(x) < len(y):
            x, y, reverse = y, x, True
    else:
        if len(x) < len(y):
            x, y = y, x
        y = torch.flip(y, (0,))
    m = y.shape[0]
    if mode == "valid":
        padding = (0, 0)
    elif mode == "same":
        padding = (m // 2, m - m // 2 - 1)
    elif mode == "full":
        padding = (m - 1, m - 1)
    else:
        raise ValueError("mode must be one of ['full', 'same', 'valid']")
    xp = torch.nn.functional.pad(x, padding)
    out = torch.nn.functional.conv1d(xp[None, None, :], y[None, None, :])
    out = out[0, 0]
    return torch.flip(out, (0,)) if reverse else out


def _whole_small(t):
    """A kernel operand whole on this process: a plain tensor, a
    replicated DTensor's own copy, or a sharded one gathered (a kernel is
    read whole by every output)."""
    if not mesh_ops.is_dtensor(t):
        return t
    if _sharded(t):
        return multiprocess.sent_gather(t).full_tensor()
    return t.to_local()


def _mesh_conv(a, x, y, mode, op):
    """``_conv`` on the mesh (an operand is a DTensor). The longer operand
    ``x`` stays where it is; each process computes the outputs of its own
    box of the result (laid out as ``_wrap`` lays it), for which it needs
    the positions of x from its box's start to m − 1 past its end: they
    come by one ``mesh_ops.pull`` (the halo from the next processes, and
    whatever the result's layout moves). A whole kernel is read by each
    process; a sharded one goes round its row group (``_ring_conv``), so
    that no process holds it whole."""
    backend = a.backend
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError(f"{op}() only support 1-dimensional inputs.")
    dt = _inexact(torch.empty((), dtype=torch.promote_types(x.dtype,
                                                            y.dtype))).dtype
    if x.shape[0] == 0 or y.shape[0] == 0:
        raise ValueError(f"{op}: inputs cannot be empty")
    # jnp's order: correlate conjugates v, then the longer operand slides
    # (swapped: the old v is the one conjugated, the output reversed); the
    # kernel is y flipped (convolve) or conjugated (correlate, unswapped)
    reverse = conj_x = False
    if op == "correlate":
        if x.shape[0] < y.shape[0]:
            x, y, reverse, conj_x = y, x, True, True
    elif x.shape[0] < y.shape[0]:
        x, y = y, x
    flip, conj_k = op == "convolve", op == "correlate" and not reverse
    n, m = int(x.shape[0]), int(y.shape[0])
    if mode == "valid":
        pad_lo, length = 0, n - m + 1
    elif mode == "same":
        pad_lo, length = m // 2, n
    elif mode == "full":
        pad_lo, length = m - 1, n + m - 1
    else:
        raise ValueError("mode must be one of ['full', 'same', 'valid']")
    bs = array_utils.default_block_shape_for((length,), a.block_shape)
    grid = ArrayGrid((length,), bs, array_utils.to_dtype_name(dt))
    pl = backend.sharding_for_grid(grid)
    coords = backend.coords()
    dev = _local(x).device

    def window(r):
        """The positions of x that process r's outputs read, in order."""
        o0, o1 = backend.region((length,), pl, coords[r])[0]
        if reverse:
            o0, o1 = length - o1, length - o0
        if o1 <= o0:
            return torch.zeros((0,), dtype=torch.int64, device=dev), 0
        start = o0 - pad_lo
        pos = torch.arange(start, o1 - 1 - pad_lo + m, dtype=torch.int64,
                           device=dev)
        return pos, start

    me = multiprocess.process_index()
    pos, start = window(me)
    if _sharded(x):
        def wants(r):
            p = window(r)[0]
            return p[(p >= 0) & (p < n)].reshape(-1, 1)

        got = mesh_ops.pull(backend, x, 1, wants(me), wants).to(dt)
    else:
        got = _local(x).to(device=dev, dtype=dt)[pos[(pos >= 0)
                                                      & (pos < n)]]
    xw = torch.zeros(pos.shape, dtype=dt, device=dev)
    xw[(pos >= 0) & (pos < n)] = got
    if conj_x:
        xw = xw.conj()
    outs = max(0, int(xw.shape[0]) - m + 1)

    def kernel(part):
        part = part.to(device=dev, dtype=dt)
        part = torch.flip(part, (0,)) if flip else part
        return part.conj() if conj_k else part

    if _sharded(y):
        out = _ring_conv(backend, xw, y, outs, flip, kernel)
    elif outs:
        out = torch.nn.functional.conv1d(
            xw[None, None, :], kernel(_local(y))[None, None, :])[0, 0]
    else:
        out = xw[:0]
    if reverse:
        out = torch.flip(out, (0,))
    return _wrap(a, backend.from_local(out.contiguous(), (length,), pl), bs)


def _ring_conv(backend, xw, y, outs, flip, kernel):
    """The ``outs`` outputs of ``conv1d(xw, kernel(y))`` for a sharded
    kernel operand y of m positions: its shards go round a ring of its row
    group (P − 1 steps of one all-to-all, each process sending the shard
    it holds to the next), and each process adds what the shard in hand
    contributes, the slice of its window ``xw`` that meets that part of
    the kernel (the shard [s0, s1) of y is the kernel's positions
    [m − s1, m − s0) flipped, else [s0, s1)). No process holds y whole."""
    pl = tuple(y.placements)
    m = int(y.shape[0])
    coords = backend.coords()
    group, g = backend._row_groups(pl)
    ring = len(group)
    boxes = [backend.region((m,), pl, coords[r])[0] for r in group]
    out = torch.zeros((outs,), dtype=xw.dtype, device=xw.device)
    held = y.to_local()
    for t in range(ring):
        s0, s1 = boxes[(g - t) % ring]
        if outs and s1 > s0:
            i0 = m - s1 if flip else s0
            out += torch.nn.functional.conv1d(
                xw[None, None, i0:i0 + outs + s1 - s0 - 1],
                kernel(held)[None, None, :])[0, 0]
        if t < ring - 1:
            send, recv = [0] * len(coords), [0] * len(coords)
            send[group[(g + 1) % ring]] = s1 - s0
            a, b = boxes[(g - t - 1) % ring]
            recv[group[(g - 1) % ring]] = b - a
            held = multiprocess.exchange(held, send, recv)
    return out


def convolve(a, v, mode="full"):
    a, v = _to_ba(a), _to_ba(v)
    if mesh_ops.is_dtensor(a.data) or mesh_ops.is_dtensor(v.data):
        return _mesh_conv(a, a.data, v.data, mode, "convolve")
    return _wrap(a, _conv(a.data, v.data, mode, "convolve"))


def correlate(a, v, mode="valid"):
    a, v = _to_ba(a), _to_ba(v)
    if mesh_ops.is_dtensor(a.data) or mesh_ops.is_dtensor(v.data):
        return _mesh_conv(a, a.data, v.data, mode, "correlate")
    return _wrap(a, _conv(a.data, v.data, mode, "correlate"))


def _gradient_along(x, axis):
    def sl(start, stop):
        stop = x.shape[axis] if stop is None else stop % x.shape[axis] \
            if stop < 0 else stop
        start = start % x.shape[axis] if start < 0 else start
        return x.narrow(axis, start, stop - start)

    upper = sl(1, 2) - sl(0, 1)
    lower = sl(-1, None) - sl(-2, -1)
    inner = (sl(2, None) - sl(0, -2)) * 0.5
    return torch.cat([upper, inner, lower], dim=axis)


def gradient(f, axis=None):
    """``jnp.gradient`` at unit spacing: central differences inside,
    one-sided at the edges; one array per axis (a list for several). On
    the mesh each process's box, along a sharded axis with a row of halo
    on each side (``_mesh_gradient``)."""
    f = _to_ba(f)
    x = _inexact(f.data)
    axes = _dims(axis, x.ndim)
    if builtins.min(x.shape[i] for i in axes) < 2:
        raise ValueError("Shape of array too small to calculate a numerical "
                         "gradient, at least 2 elements are required.")
    if mesh_ops.is_dtensor(x):
        grads = [_wrap(f, mesh_ops.along(f.backend, x, ax, lambda t: (
            _mesh_gradient(f.backend, t))) if mesh_ops.shard_dims(
                x.placements, (ax,)) else mesh_ops.like(
                    x, _gradient_along(x.to_local(), ax)), f.block_shape)
                 for ax in axes]
    else:
        grads = [_wrap(f, _gradient_along(x, ax)) for ax in axes]
    return grads[0] if len(axes) == 1 else grads


def _mesh_gradient(backend, t):
    """``_gradient_along`` axis 0 of a DTensor sharded there: each output
    row of this process's box from its own rows and one row of halo on
    each side (``mesh_ops.halo``), by the serial formulas (a difference,
    halved inside)."""
    n = int(t.shape[0])
    lo, hi = backend.region(tuple(t.shape), t.placements)[0]
    pre, post = mesh_ops.halo(backend, t, 1, 1)
    local = t.to_local()
    out = torch.empty_like(local)
    m = int(local.shape[0])
    if m > 2:
        torch.sub(local[2:], local[:-2], out=out[1:-1])
        out[1:-1].mul_(0.5)

    def row(i):
        """Row ``i`` of the array, from this box or its halo."""
        if i < lo:
            return pre[i - lo + pre.shape[0]:i - lo + pre.shape[0] + 1]
        if i >= hi:
            return post[i - hi:i - hi + 1]
        return local[i - lo:i - lo + 1]

    for i in sorted({lo, hi - 1}) if m else ():
        if i == 0:
            out[i - lo:i - lo + 1] = row(1) - row(0)
        elif i == n - 1:
            out[i - lo:i - lo + 1] = row(n - 1) - row(n - 2)
        else:
            out[i - lo:i - lo + 1] = (row(i + 1) - row(i - 1)) * 0.5
    return backend.from_local(out, tuple(t.shape), tuple(t.placements))


def trapezoid(y, x=None, dx=1.0, axis=-1):
    """``jnp.trapezoid``: ``0.5 · Σ dx · (y[1:] + y[:-1])`` along
    ``axis``; a scalar ``dx`` is weak, as a Python scalar in jax."""
    y = _to_ba(y)
    axis = int(axis) % builtins.max(y.ndim, 1)
    if _sharded(y.data) and mesh_ops.shard_dims(y.data.placements, (axis,)):
        return _mesh_trapezoid(y, x, float(dx), axis)
    if x is None:
        yd, d = _inexact(y.data), float(dx)
    else:
        x = _to_ba(x)
        yd, xd = elementwise.promote(y.data, x.data, y._default_float())
        yd, xd = _inexact(yd), _inexact(xd)
        if xd.ndim == 1:
            d = xd[1:] - xd[:-1]
        else:
            d = torch.movedim(torch.diff(xd, dim=axis), axis, -1)
    yd = torch.movedim(yd, axis, -1)
    return _wrap(y, 0.5 * (d * (yd[..., 1:] + yd[..., :-1])).sum(-1))


trapz = trapezoid


def _mesh_trapezoid(y, x, dx, axis):
    """``trapezoid`` along a sharded axis: each process sums the pairs that
    start in its box (the last with one row of halo), with the sample
    points' differences pulled for those pairs where ``x`` is a 1-D array
    (``mesh_ops.take``), then one all-reduce of the sums."""
    backend = y.backend
    yd = _inexact(y.data)
    t = mesh_ops.move_axis(backend, yd, axis, 0) if axis else yd
    n = int(t.shape[0])
    lo, hi = backend.region(tuple(t.shape), t.placements)[0]
    _, post = mesh_ops.halo(backend, t, 0, 1)
    local = t.to_local()
    k = builtins.max(0, builtins.min(hi, n - 1) - lo)
    ext = torch.cat([local, post]) if k > local.shape[0] - 1 else local
    pairs = ext[1:k + 1] + ext[:k]
    if x is None:
        d = dx
    else:
        x = _to_ba(x)
        if x.ndim != 1:
            raise NotImplementedError(
                "trapezoid: sample points of more than one axis along an "
                "axis that the mesh shards")
        xd = _inexact(x.data)
        pos = torch.arange(lo, lo + k + 1 if k else lo, dtype=torch.int64)
        xs = (mesh_ops.take(backend, xd, pos) if mesh_ops.is_dtensor(xd)
              else xd[pos.to(xd.device)]).to(pairs.dtype)
        d = (xs[1:] - xs[:-1]).reshape((-1,) + (1,) * (pairs.ndim - 1))
    here = backend.counts_here(t.placements)
    part = (d * pairs).sum(0) if here and k else torch.zeros(
        tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
    dims = mesh_ops.shard_dims(t.placements, (0,))
    total = 0.5 * mesh_ops.group_reduce(backend, part, dims)
    pl = tuple(mesh_ops._replicate() if p.is_shard() and p.dim == 0 else
               mesh_ops._shard(p.dim - 1) if p.is_shard() else p
               for p in t.placements)
    return _wrap(y, backend.from_local(total, tuple(t.shape[1:]), pl))


def sinc(x):
    """``jnp.sinc``: ``sin(πx)/(πx)``, 1 at 0."""
    x = _to_ba(x)
    t = _inexact(x.data)
    zero = t == 0
    pi_x = np.pi * t
    safe = torch.where(zero, torch.ones_like(t), pi_x)
    out = torch.where(zero, torch.ones_like(t), torch.sin(safe) / safe)
    return _wrap(x, out, x.block_shape)


def ediff1d(ary):
    ary = _to_ba(ary)
    if _sharded(ary.data):
        flat, bs = _mesh_flat(ary, ary.data)
        return _wrap(ary, _mesh_diff(ary.backend, flat, 1, 0), bs)
    flat = ary.data.reshape(-1)
    return _wrap(ary, flat[1:] - flat[:-1])


def vander(x, N=None, increasing=False):
    """``jnp.vander``: powers of x by an iota of x's own dtype,
    decreasing unless ``increasing``."""
    x = _to_ba(x)
    xd = x.data
    if xd.ndim != 1:
        raise ValueError("x must be a one-dimensional array")
    n = xd.shape[0] if N is None else int(N)
    iota = torch.arange(n, device=xd.device).to(xd.dtype)
    if not increasing:
        iota = (n - 1) - iota
    if mesh_ops.is_dtensor(xd):
        # each process's powers of its own x, laid out by its rows
        local = elementwise.bop("power", xd.to_local()[:, None],
                                iota[None, :], x._default_float())
        out = x.backend.from_local(local, (int(xd.shape[0]), n),
                                   tuple(xd.placements))
        bs = (x.block_shape[0], n)
        return _wrap(x, x.backend.rebox(out, _mesh_target(x, (
            int(xd.shape[0]), n), bs)[1]), bs)
    return _wrap(x, elementwise.bop("power", xd[:, None], iota[None, :],
                                    x._default_float()))


def tri(N, M=None, k=0, dtype=float):
    """Built on the device: ones on and below the k-th diagonal."""
    app = _instance()
    dt = array_utils.to_torch_dtype(app.backend.device_dtype(
        array_utils.to_np_dtype(dtype)))
    m = int(N) if M is None else int(M)
    data = torch.tril(torch.ones((int(N), m), device=app.backend.device),
                      diagonal=int(k)).to(dt)
    return BlockArray.from_torch(data, backend=app.backend)


def argwhere(a):
    """Device-resolved (one scalar sync); indices stay on the device."""
    a = _to_ba(a)
    if a.ndim == 0:
        out = np.argwhere(a.get())
        return _instance().array(out, block_shape=out.shape)
    if a.backend.mesh is not None:
        data = mesh_ops.where(a.backend, (a != 0).data, stacked=True)
        rows = a.mesh_rows_block(data.shape[0], a.grid.num_blocks)
        return BlockArray.from_torch(data, (rows, a.ndim), a.backend)
    _, idx = masking.device_where(a != 0)
    data = torch.stack(idx, dim=-1).to(torch.int64)
    return BlockArray.from_torch(data, block_shape=tuple(data.shape),
                                 backend=a.backend)


def flatnonzero(a):
    a = _to_ba(a)
    if a.ndim == 0:
        out = np.flatnonzero(a.get())
        return _instance().array(out, block_shape=out.shape)
    if a.backend.mesh is not None:
        data = mesh_ops.where(a.backend, (a != 0).data, flat=True)
        rows = a.mesh_rows_block(data.shape[0], a.grid.num_blocks)
        return BlockArray.from_torch(data, (rows,), a.backend)
    _, idx = masking.device_where(ravel(a) != 0)
    return BlockArray.from_torch(idx[0].to(torch.int64), backend=a.backend)


def nonzero(a):
    return _instance().where(_to_ba(a))
