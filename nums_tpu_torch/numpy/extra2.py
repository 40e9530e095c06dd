"""Predicates, nan-variants, windows, index utilities, polynomials.

Counterpart of ``nums_tpu/numpy/extra2.py``, name for name. Each is a
torch computation on the array's device that gives ``jnp.<name>``'s
dtype and values: ``take_along_axis`` fills an out-of-range position as
jnp's gather does (NaN, the integer minimum, True), ``nanargmax`` gives
-1 for an all-NaN slice, ``unravel_index`` clips out-of-range positions,
``ravel_multi_index`` wraps (mode ``"wrap"``, as the reference jits it),
``polyfit`` solves its scaled Vandermonde system by SVD as
``jnp.linalg.lstsq``, and the windows and index builders take the
backend's default float and int (float64/int64 on the CPU, float32/int32
on the card: jax with x64 on and off).
"""

import builtins
import math

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import elementwise, masking, mesh_ops
from nums_tpu_torch.numpy.extra import (
    _default_int, _device_q, _inexact, _local, _mesh_diff,
    _mesh_quantile_at, _promote_all, _q_arg, _quantile, _sharded, _to_ba,
    _whole_small, _wrap, cumprod, cumsum, hist_edges, prod,
)

__all__ = [
    "isin", "isreal", "iscomplex", "isneginf", "isposinf", "isrealobj",
    "iscomplexobj", "nanargmax", "nanargmin", "nancumsum", "nancumprod",
    "nanprod", "nanpercentile", "nanquantile", "take_along_axis", "select",
    "unravel_index", "ravel_multi_index", "tril_indices", "triu_indices",
    "diag_indices", "indices", "polyval", "polyfit", "unwrap", "hamming",
    "hanning", "blackman", "bartlett", "kaiser", "i0",
    "histogram_bin_edges", "histogram2d", "hypot", "heaviside",
    "float_power", "copysign", "frexp", "ldexp", "signbit", "spacing",
]

from nums_tpu_torch.numpy.api import (  # noqa: E402,F401
    hypot, heaviside, float_power, copysign, ldexp, signbit, spacing,
)


def _backend_ints():
    """The backend's default float and int as torch dtypes."""
    app = _instance()
    df = array_utils.to_torch_dtype(app.backend.default_float)
    return app, df, elementwise.default_int(df)


def _new(data):
    return BlockArray.from_torch(data, backend=_instance().backend)


def frexp(x):
    """(mantissa, exponent): the mantissa in x's inexact dtype, the
    exponent int32, as ``jnp.frexp``."""
    x = _to_ba(x)
    m, e = torch.frexp(_inexact(x.data))
    return _wrap(x, m, x.block_shape), _wrap(x, e.to(torch.int32),
                                             x.block_shape)


def isin(element, test_elements):
    """``jnp.isin``: each element against the distinct sorted test values
    (``searchsorted``, in jnp's order of complex numbers); NaN is in
    nothing."""
    element, test = _to_ba(element), _to_ba(test_elements)
    e, t = _promote_all([element.data, test.data])
    if element.backend.mesh is not None and test.size:
        if _sharded(t):
            # each process's test values, counted at each element
            hit = mesh_ops.isin(element.backend, t, e)
        else:
            hit = mesh_ops.like(e, _isin_local(_local(e), _local(t)))
        return _wrap(element, hit, element.block_shape)
    if t.numel():
        return _wrap(element, _isin_local(e, t), element.block_shape)
    return _wrap(element, torch.zeros(tuple(e.shape), dtype=torch.bool,
                                      device=e.device), element.block_shape)


def _isin_local(e, t):
    """``isin`` of a tensor in a non-empty whole test tensor."""
    t = masking.sort(t.reshape(-1))[0]
    flat = e.reshape(-1)
    pos = masking.searchsorted(t, flat).clamp(max=t.numel() - 1)
    return (t[pos] == flat).reshape(tuple(e.shape))


def isreal(x):
    x = _to_ba(x)
    d = x.data
    out = (d.imag == 0 if d.is_complex()
           else torch.ones(tuple(d.shape), dtype=torch.bool, device=d.device))
    return _wrap(x, out, x.block_shape)


def iscomplex(x):
    x = _to_ba(x)
    d = x.data
    out = (d.imag != 0 if d.is_complex()
           else torch.zeros(tuple(d.shape), dtype=torch.bool, device=d.device))
    return _wrap(x, out, x.block_shape)


def _isinf_signed(sign):
    def fn(x):
        x = _to_ba(x)
        d = x.data
        if d.is_complex():
            raise ValueError(f"jnp.{fn.__name__} is not well defined for "
                             "complex-valued inputs")
        if d.is_floating_point():
            out = d == sign * float("inf")
        else:
            out = torch.zeros(tuple(d.shape), dtype=torch.bool,
                              device=d.device)
        return _wrap(x, out, x.block_shape)

    fn.__name__ = "isposinf" if sign > 0 else "isneginf"
    return fn


isneginf = _isinf_signed(-1)
isposinf = _isinf_signed(1)


def i0(x):
    """``jnp.i0``: the modified Bessel function of order 0, in x's
    inexact dtype."""
    x = _to_ba(x)
    d = x.data
    if d.is_complex():
        raise ValueError("i0 does not support complex input")
    return _wrap(x, torch.special.i0(_inexact(d)), x.block_shape)


def isrealobj(x):
    return not np.issubdtype(_to_ba(x).dtype, np.complexfloating)


def iscomplexobj(x):
    return np.issubdtype(_to_ba(x).dtype, np.complexfloating)


def _nanarg(fn, fill):
    def arg(a, axis=None):
        a = _to_ba(a)
        x = a.data
        if axis is None:
            x, dim = x.reshape(-1), 0
        else:
            dim = int(axis) % builtins.max(x.ndim, 1)
        if not x.is_floating_point():
            out = fn(x.to(torch.uint8) if x.dtype == torch.bool else x,
                     dim=dim)
            return _wrap(a, out.to(_default_int(a)))
        nan = torch.isnan(x)
        out = fn(torch.where(nan, torch.full_like(x, fill), x), dim=dim)
        out = torch.where(nan.all(dim=dim), torch.full_like(out, -1), out)
        return _wrap(a, out.to(_default_int(a)))

    return arg


nanargmax = _nanarg(torch.argmax, -np.inf)
nanargmin = _nanarg(torch.argmin, np.inf)
nanargmax.__name__, nanargmin.__name__ = "nanargmax", "nanargmin"
nanargmax.__doc__ = nanargmin.__doc__ = (
    "``jnp``'s: NaN as the identity of the search, and -1 for a slice of "
    "NaNs only (NumPy raises).")


def _nan_filled(fn, fill, name):
    def reduce_fn(a, axis=None):
        a = _to_ba(a)
        x = a.data
        if x.is_floating_point() or x.is_complex():
            x = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
        return fn(_wrap(a, x, a.block_shape), axis=axis)

    reduce_fn.__name__ = name
    reduce_fn.__doc__ = f"``jnp.{name}``: NaN taken as {fill}."
    return reduce_fn


nancumsum = _nan_filled(cumsum, 0, "nancumsum")
nancumprod = _nan_filled(cumprod, 1, "nancumprod")
nanprod = _nan_filled(prod, 1, "nanprod")


def _nan_quantile(a, q, axis, divide=1.0):
    """``jnp.nanquantile`` on the port's ``_quantile`` (float64 positions
    on every device; a q on the mesh stays there)."""
    q = _q_arg(q, divide)
    if _device_q(q):
        return _mesh_quantile_at(a, q, axis, True)
    out = _quantile(a, np.atleast_1d(q), axis, "linear", False, True)
    return _wrap(a, out[0] if np.ndim(q) == 0 else out)


def nanpercentile(a, q, axis=None):
    a = _to_ba(a)
    return _nan_quantile(a, q, axis, 100.0)


def nanquantile(a, q, axis=None):
    a = _to_ba(a)
    return _nan_quantile(a, q, axis)


def _fill_value(dtype):
    """jnp's gather fill for an out-of-range position."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    return torch.iinfo(dtype).min if dtype != torch.uint8 else 255


def take_along_axis(arr, indices, axis):
    """``jnp.take_along_axis``: the non-axis dimensions broadcast,
    negative positions count from the end, and a position still out of
    range gives ``_fill_value`` (jnp's default ``mode="fill"``)."""
    arr, indices = _to_ba(arr), _to_ba(indices)
    a, idx = arr.data, indices.data
    if idx.is_floating_point() or idx.is_complex() or idx.dtype == torch.bool:
        raise TypeError("take_along_axis indices must be of integer type, "
                        f"got {indices.dtype}")
    if axis is None:
        if idx.ndim != 1:
            raise ValueError("take_along_axis indices must be 1D if "
                             f"axis=None, got shape {tuple(idx.shape)}")
        a, axis = a.reshape(-1), 0
    if a.ndim != idx.ndim:
        raise ValueError("indices and arr must have the same number of "
                         f"dimensions; {idx.ndim} vs. {a.ndim}")
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    arr_shape = list(a.shape)
    arr_shape[axis] = 1
    out_shape = list(np.broadcast_shapes(tuple(idx.shape), tuple(arr_shape)))
    if n == 0:
        return _wrap(arr, torch.zeros(out_shape, dtype=a.dtype,
                                      device=a.device))
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    bad = (idx < 0) | (idx >= n)
    idx = torch.broadcast_to(idx.clamp(0, n - 1), out_shape)
    src_shape = list(out_shape)
    src_shape[axis] = n
    out = torch.gather(torch.broadcast_to(a, src_shape), axis, idx)
    out = torch.where(torch.broadcast_to(bad, out_shape),
                      torch.full((), _fill_value(a.dtype), dtype=a.dtype,
                                 device=a.device), out)
    return _wrap(arr, out)


def select(condlist, choicelist, default=0):
    """``jnp.select``: the first true condition's choice, else
    ``default``; the choices and a weak ``default`` promote as jnp's."""
    conds = [_to_ba(c) for c in condlist]
    choices = [_to_ba(c) for c in choicelist]
    if len(conds) != len(choices):
        raise ValueError("list of cases must be same length as list of "
                         "conditions")
    if not conds:
        raise ValueError("need at least one condition")
    df = conds[0]._default_float()
    ts = [c.data for c in choices]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    if isinstance(default, BlockArray):
        default = default.data
    dt = elementwise.result_dtype(torch.empty((), dtype=dt), default, df)
    out = elementwise._to(default, dt, ts[0].device)
    for c, t in zip(reversed(conds), reversed(ts)):
        out = torch.where(c.data.to(torch.bool), t.to(dt), out)
    shape = np.broadcast_shapes(*[tuple(c.shape) for c in conds],
                                *[tuple(t.shape) for t in ts])
    return _wrap(conds[0], torch.broadcast_to(out, shape).contiguous())


def unravel_index(indices, shape):
    """``jnp.unravel_index``: floor divmod by each dimension from the
    last; a position past the end gives the last index of every axis, one
    below ``-size`` gives 0 (jnp clips where NumPy raises)."""
    indices = _to_ba(indices)
    rest = indices.data
    shape = [int(s) for s in (shape if np.iterable(shape) else [shape])]
    out = [None] * len(shape)
    for i in reversed(range(len(shape))):
        out[i] = torch.remainder(rest, shape[i])
        rest = torch.div(rest, shape[i], rounding_mode="floor")
    over, under = rest > 0, rest < -1
    return tuple(
        _wrap(indices, torch.where(over, torch.full_like(o, s - 1),
                                   torch.where(under, torch.zeros_like(o), o)))
        for s, o in zip(shape, out))


def ravel_multi_index(multi_index, dims):
    """``jnp.ravel_multi_index(..., mode="wrap")``: each index modulo its
    dimension, in the indices' promoted integer dtype."""
    bas = [_to_ba(m) for m in multi_index]
    ts = [b.data for b in bas]
    if builtins.any(t.is_floating_point() or t.is_complex()
                    or t.dtype == torch.bool for t in ts):
        raise TypeError("only int indices permitted")
    dims = tuple(int(d) for d in dims)
    strides = np.cumprod((1,) + dims[1:][::-1])[::-1]
    out = torch.zeros((), dtype=ts[0].dtype, device=ts[0].device)
    for t, d, s in zip(ts, dims, strides):
        out = out + torch.remainder(t, d) * int(s)
    return _wrap(bas[0], out)


def _index_pair(rows, cols):
    _, _, dint = _backend_ints()
    return _new(rows.to(dint)), _new(cols.to(dint))


def tril_indices(n, k=0, m=None):
    """Built on the device (``torch.tril_indices``), row-major."""
    app = _instance()
    m = int(n) if m is None else int(m)
    rc = torch.tril_indices(int(n), m, int(k), device=app.backend.device)
    return _index_pair(rc[0], rc[1])


def triu_indices(n, k=0, m=None):
    app = _instance()
    m = int(n) if m is None else int(m)
    rc = torch.triu_indices(int(n), m, int(k), device=app.backend.device)
    return _index_pair(rc[0], rc[1])


def diag_indices(n, ndim=2):
    app, _, dint = _backend_ints()
    idx = torch.arange(int(n), dtype=dint, device=app.backend.device)
    return tuple(_new(idx.clone()) for _ in range(int(ndim)))


def indices(dimensions, dtype=None):
    """``jnp.indices``: int64 unless ``dtype`` (int32 on the card, where
    jax has no 64-bit types)."""
    app, df, _ = _backend_ints()
    dt = array_utils.to_torch_dtype(np.dtype(dtype or np.int64))
    if df == torch.float32 and dt == torch.int64:
        dt = torch.int32
    dims = tuple(int(d) for d in dimensions)
    grids = torch.meshgrid(*[torch.arange(d, device=app.backend.device)
                             for d in dims], indexing="ij")
    data = (torch.stack(grids) if grids
            else torch.zeros((0,), device=app.backend.device))
    return _new(data.to(dt))


def _inexact_pair(a, b, df):
    """jnp's ``promote_dtypes_inexact`` of two tensors."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = df
    return a.to(dt), b.to(dt)


def polyval(p, x):
    """``jnp.polyval``: Horner's rule in the inexact promoted dtype."""
    p, x = _to_ba(p), _to_ba(x)
    pd, xd = _inexact_pair(p.data, x.data, x._default_float())
    if mesh_ops.is_dtensor(xd) and pd.ndim == 1:
        # the coefficients whole on each process, x's own box
        pd = _whole_small(pd)
        local = _local(xd)
        y = torch.zeros(tuple(local.shape), dtype=local.dtype,
                        device=local.device)
        for c in pd.to(local.device):
            y = y * local + c
        return _wrap(x, mesh_ops.like(xd, y), x.block_shape)
    if mesh_ops.is_dtensor(pd):
        pd = _whole_small(pd)
        xd = _local(xd)
    shape = np.broadcast_shapes(tuple(pd.shape[1:]), tuple(xd.shape))
    y = torch.zeros(shape, dtype=xd.dtype, device=xd.device)
    for c in pd:
        y = y * xd + c
    return _wrap(x, y)


def lstsq_svd(a, b, rcond):
    """``jnp.linalg.lstsq``'s solution: by the SVD, singular values below
    ``rcond`` times the largest dropped. A tall ``a`` is reduced by QR
    first (the SVD of its small R factor)."""
    q = None
    if a.shape[0] > 4 * a.shape[1]:
        q, a = torch.linalg.qr(a)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    if q is not None:
        u = q @ u
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    utb = u.conj().T @ b
    s_inv = s_inv[:, None] if utb.ndim == 2 else s_inv
    return vt.conj().T @ (s_inv * utb)


def polyfit(x, y, deg):
    """``jnp.polyfit``: the Vandermonde matrix of x with its columns
    scaled to unit norm, solved by ``lstsq_svd`` with ``rcond =
    len(x)·eps``, the coefficients scaled back."""
    x, y = _to_ba(x), _to_ba(y)
    deg = int(deg)
    if deg < 0:
        raise ValueError("expected deg >= 0")
    if x.ndim != 1:
        raise TypeError("expected 1D vector for x")
    if x.size == 0:
        raise TypeError("expected non-empty vector for x")
    if y.ndim < 1 or y.ndim > 2:
        raise TypeError("expected 1D or 2D array for y")
    if x.shape[0] != y.shape[0]:
        raise TypeError("expected x and y to have same length")
    xd, yd = _inexact_pair(x.data, y.data, x._default_float())
    rcond = len(xd) * float(torch.finfo(xd.dtype).eps)
    powers = torch.arange(deg, -1, -1, device=xd.device).to(xd.dtype)
    lhs = elementwise.bop("power", xd[:, None], powers[None, :],
                          x._default_float())
    scale = torch.sqrt((lhs * lhs).sum(dim=0))
    c = lstsq_svd(lhs / scale[None, :], yd, rcond)
    c = (c.T / scale[None, :]).T if c.ndim > 1 else c / scale
    return _wrap(x, c)


def unwrap(p, axis=-1):
    """``jnp.unwrap`` with period 2π: each step folded into [-π, π) (π
    itself where the step is positive), the corrections summed along
    ``axis``."""
    p = _to_ba(p)
    d = p.data
    if d.is_complex():
        raise ValueError("jnp.unwrap does not support complex inputs.")
    df = p._default_float()
    if not d.is_floating_point():
        d = d.to(df)
    axis = int(axis) % d.ndim
    if d.shape[axis] == 0:
        return _wrap(p, d.clone(), p.block_shape)
    if mesh_ops.is_dtensor(d) and mesh_ops.shard_dims(d.placements,
                                                      (axis,)):
        return _wrap(p, mesh_ops.along(p.backend, d, axis, lambda t: (
            _mesh_unwrap(p.backend, t))), p.block_shape)
    dd = torch.diff(d, dim=axis)
    correct = _corrections(dd)
    n = d.shape[axis]
    up = torch.cat([d.narrow(axis, 0, 1), d.narrow(axis, 1, n - 1)
                    + torch.cumsum(correct, dim=axis)], dim=axis)
    return _wrap(p, up, p.block_shape)


def _corrections(dd):
    """``unwrap``'s correction of each step ``dd``: folded into [-π, π)
    (π itself where the step is positive), 0 below π."""
    period = 2 * np.pi
    interval = period / 2
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0),
                        torch.full_like(ddmod, interval), ddmod)
    return torch.where(torch.abs(dd) < interval, torch.zeros_like(dd),
                       ddmod - dd)


def _mesh_unwrap(backend, t):
    """``unwrap`` along axis 0 of a DTensor sharded there: the steps by
    ``_mesh_diff`` (one row of halo), their corrections summed by
    ``mesh_ops.scan``, and the sums moved one row on (one all-to-all) to
    join each process's own rows."""
    n = int(t.shape[0])
    pl = tuple(t.placements)
    dd = _mesh_diff(backend, t, 1, 0)
    corr = backend.from_local(_corrections(dd.to_local()),
                              tuple(dd.shape), pl)
    cs = mesh_ops.scan(backend, corr, 0, lambda u, dim: torch.cumsum(
        u, dim=dim), "sum")
    coords = backend.coords()
    pieces = [[tuple(v + 1 for v in backend.region(tuple(cs.shape), pl,
                                                  c)[0])] for c in coords]
    boxes = [backend.region((n,) + tuple(t.shape[1:]), pl, c)[0]
             for c in coords]
    dst = [(max(lo, 1), max(hi, lo, 1)) for lo, hi in boxes]
    moved = backend.move_pieces([cs.to_local()], pieces, dst, pl)
    lo = boxes[multiprocess.process_index()][0]
    local = t.to_local()
    out = local.clone()
    at = max(lo, 1) - lo
    out[at:] = local[at:] + moved
    return backend.from_local(out, tuple(t.shape), pl)


def _iota(M):
    app, df, _ = _backend_ints()
    return torch.arange(int(M), device=app.backend.device).to(df), df


def _window(name, formula):
    def fn(M):
        M = int(M)
        n, df = _iota(M)
        if M <= 1:
            return _new(torch.ones(builtins.max(M, 0), dtype=df,
                                   device=n.device))
        return _new(formula(n, M))

    fn.__name__ = name
    fn.__doc__ = (f"``jnp.{name}``: the window computed on the device in "
                  "the default float.")
    return fn


hamming = _window(
    "hamming", lambda n, M: 0.54 - 0.46 * torch.cos(2 * np.pi * n / (M - 1)))
hanning = _window(
    "hanning", lambda n, M: 0.5 * (1 - torch.cos(2 * np.pi * n / (M - 1))))
blackman = _window(
    "blackman", lambda n, M: 0.42 - 0.5 * torch.cos(2 * np.pi * n / (M - 1))
    + 0.08 * torch.cos(4 * np.pi * n / (M - 1)))
bartlett = _window(
    "bartlett", lambda n, M: 1 - torch.abs(2 * n + 1 - M) / (M - 1))


def kaiser(M, beta):
    M = int(M)
    n, df = _iota(M)
    if M <= 1:
        return _new(torch.ones(builtins.max(M, 0), dtype=df,
                               device=n.device))
    alpha = 0.5 * (M - 1)
    b = torch.full((), float(beta), dtype=df, device=n.device)
    arg = b * torch.sqrt(1 - ((n - alpha) / alpha) ** 2)
    return _new(torch.special.i0(arg) / torch.special.i0(b))


def histogram_bin_edges(a, bins=10, range=None):  # noqa: A002
    a = _to_ba(a)
    x = _inexact(a.data)
    if mesh_ops.is_dtensor(x):
        return _wrap(a, hist_edges(x, bins, range))
    return _wrap(a, hist_edges(x.reshape(-1), bins, range))


def histogramdd_counts(columns, bins):
    """``jnp.histogramdd``'s counts and edges of D 1-D tensors (the
    columns of the sample): each column's ``histogram`` edges, its bin by
    ``searchsorted(side='right')`` with the last edge in the last bin, the
    bins raveled and counted by ``bincount``. Columns that are DTensors
    laid out alike: the edges from all-reduces, each process's counts,
    summed."""
    edges, idx, nbins = [], [], []
    mesh = mesh_ops.is_dtensor(columns[0])
    for x, b in zip(columns, bins):
        e = hist_edges(x, b, None)
        if mesh:
            x = mesh_ops.local_counted(x)
        i = torch.searchsorted(e, x.contiguous(), right=True)
        i = torch.where(x == e[-1], i - 1, i)
        edges.append(e)
        idx.append(i)
        nbins.append(e.shape[0] + 1)
    flat = torch.zeros_like(idx[0])
    for i, nb in zip(idx, nbins):
        flat = flat * nb + i.clamp(0, nb - 1)
    counts = torch.bincount(flat, minlength=math.prod(nbins))
    if mesh:
        multiprocess.all_reduce_(counts)
    counts = counts.reshape(nbins)[(slice(1, -1),) * len(nbins)]
    return counts, edges


def histogram2d(x, y, bins=10):
    """``jnp.histogram2d``: ``histogramdd`` of the pair; the counts in
    the default int (jnp's ``bincount``), unlike ``histogram``'s."""
    x, y = _to_ba(x), _to_ba(y)
    xd, yd = _promote_all([x.data.reshape(-1), y.data.reshape(-1)])
    xd, yd = _inexact(xd), _inexact(yd)
    if mesh_ops.is_dtensor(xd):
        yd = x.backend.rebox(yd, xd.placements)
    b = [bins, bins] if np.ndim(bins) == 0 else list(bins)
    counts, (ex, ey) = histogramdd_counts([xd, yd], b)
    return (_wrap(x, counts.to(_default_int(x))), _wrap(x, ex),
            _wrap(x, ey))

