"""nums_tpu_torch.numpy.fft: ``numpy.fft``'s surface on ``torch.fft``.

Counterpart of ``nums_tpu/numpy/fft.py``: one ``torch.fft`` call (cuFFT
on the card) per function, with numpy's ``n``/``s``/``axes``/``norm``
semantics. Integer and bool input computes in the backend's default float,
as ``jnp.fft`` does (float64 on the CPU, float32 on the card), so a
float32 array gives complex64. ``fftfreq``/``rfftfreq`` are built on the
device in float64 and then cast to the default float: the values of
NumPy's own, as the reference's host arrays put on the device.

On the mesh no transform copies a sharded operand whole: a sharded vector
takes the distributed 1-D DFT of ``core/ops/mesh_fft.py``, an n-D array is
transformed axis by axis (``_mesh_axis``), the shifts are the mesh's
``roll``; each result keeps its operand's blocks.
"""

import numpy as _np
import torch as _torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray as _BA
from nums_tpu_torch.core.array import utils as _utils

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft", "fftn", "ifftn",
    "rfftn", "irfftn", "fft2", "ifft2", "rfft2", "irfft2", "fftshift",
    "ifftshift", "fftfreq", "rfftfreq",
]


def _input(a):
    """The operand as a BlockArray and its tensor in an inexact dtype."""
    if not isinstance(a, _BA):
        a = _instance().array(_np.asarray(a), block_shape=None)
    x = a.data
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(a._default_float())
    return a, x


def _out(a, data):
    """A result as a BlockArray; torch may return a lazily conjugated
    view (``ihfft``, ``ifft`` of real input), which is made real here."""
    return _BA.from_torch(data.resolve_conj(), backend=a.backend)


def _placed(a, out):
    """A DTensor result as a BlockArray in the operand's blocks (the
    serial rule, one block, would lay it whole), reboxed to that grid's
    layout first."""
    from nums_tpu_torch.core.grid import ArrayGrid

    bs = tuple(min(b, int(s)) for b, s in zip(a.block_shape, out.shape))
    grid = ArrayGrid(tuple(out.shape), bs, _utils.to_dtype_name(out.dtype))
    out = a.backend.rebox(out, a.backend.sharding_for_grid(grid))
    return _BA(out, grid, a.backend)


def _mesh_axis(fname, a, x, n, axis, norm, owned=False):
    """The 1-D transform ``fname`` of the DTensor ``x`` along ``axis``:
    along an axis that no mesh dimension shards each process transforms
    its own lines (in place, a chunk of lines at a time, where ``x`` is a
    temporary of the caller's whose dtype and length stay); along a
    sharded one of an n-D array the sharding moves to another axis first
    (``mesh_ops.across``: one all-to-all there and one back, a chunk of
    lines at a time); a sharded vector takes the distributed transform
    (``mesh_fft.dft``: four-step or Bluestein), laid out in the operand's
    blocks. Returns a DTensor."""
    from nums_tpu_torch.core.grid import ArrayGrid
    from nums_tpu_torch.core.ops import mesh_fft, mesh_ops

    fn = getattr(_torch.fft, fname)
    axis = int(axis) % max(x.ndim, 1)
    length = mesh_fft.out_length(fname, mesh_fft.default_n(
        fname, int(x.shape[axis])) if n is None else int(n))
    dt = fn(_torch.zeros((4,), dtype=x.dtype, device="meta"), n=4).dtype
    if x.ndim == 1 and mesh_ops.shard_dims(x.placements, (0,)):
        bs = (max(1, min(a.block_shape[0], length)),)
        want = a.backend.sharding_for_grid(ArrayGrid(
            (length,), bs, _utils.to_dtype_name(dt)))
        cdt = _torch.promote_types(dt, _torch.complex64)
        return mesh_fft.dft(a.backend, fname, x, n, norm, want, cdt)

    def lines(local, dim):
        if not local.numel():  # an empty box (cuFFT and MKL refuse it)
            shape = list(local.shape)
            shape[dim] = length
            return local.new_empty(shape, dtype=dt)
        return fn(local, n=n, dim=dim, norm=norm).resolve_conj()

    if mesh_ops.shard_dims(x.placements, (axis,)):
        return mesh_ops.across(a.backend, x, axis, lines, length, dt,
                               mesh_fft.ACROSS_CHUNK_ELEMENTS)
    local = x.to_local()
    if owned and axis and dt == x.dtype and length == int(x.shape[axis]):
        step = max(1, mesh_fft.CHUNK_ELEMENTS // max(local[0].numel(), 1))
        for r0 in range(0, int(local.shape[0]), step):
            local[r0:r0 + step] = lines(local[r0:r0 + step], axis)
        return x
    local = lines(local, axis)
    shape = tuple(length if k == axis else int(s)
                  for k, s in enumerate(x.shape))
    return a.backend.from_local(local.contiguous(), shape,
                                tuple(x.placements))


def _make(fname):
    fn = getattr(_torch.fft, fname)

    def fft_fn(a, n=None, axis=-1, norm=None):
        a, x = _input(a)
        if type(x).__name__ == "DTensor":
            return _placed(a, _mesh_axis(fname, a, x, n, axis, norm))
        return _out(a, fn(x, n=n, dim=axis, norm=norm))

    fft_fn.__name__ = fname
    fft_fn.__doc__ = (f"numpy.fft.{fname} by one torch.fft.{fname}; on the "
                      "mesh ``_mesh_axis``.")
    return fft_fn


fft = _make("fft")
ifft = _make("ifft")
rfft = _make("rfft")
irfft = _make("irfft")
hfft = _make("hfft")
ihfft = _make("ihfft")


def _nd_steps(fname, shape, s, axes):
    """numpy's n-D transform as its 1-D steps, in numpy's order: (the 1-D
    transform, n, axis) each (``_cook_nd_args`` and ``_raw_fftnd``)."""
    ndim = len(shape)
    shapeless = s is None
    if s is None:
        s = list(shape) if axes is None else [shape[k] for k in axes]
    s = list(s)
    if axes is None:
        axes = list(range(-len(s), 0))
    axes = [int(k) % max(ndim, 1) for k in axes]
    if len(s) != len(axes):
        raise ValueError("Shape and axes have different lengths.")
    if fname.startswith("irfft") and shapeless:
        s[-1] = (shape[axes[-1]] - 1) * 2
    if fname.startswith("rfft"):
        return ([("rfft", s[-1], axes[-1])]
                + [("fft", s[i], axes[i]) for i in range(len(axes) - 2, -1,
                                                        -1)])
    if fname.startswith("irfft"):
        return ([("ifft", s[i], axes[i]) for i in range(len(axes) - 1)]
                + [("irfft", s[-1], axes[-1])])
    one = "ifft" if fname.startswith("i") else "fft"
    return [(one, s[i], axes[i]) for i in range(len(axes) - 1, -1, -1)]


def _mesh_nd(fname, a, x, s, axes, norm):
    """An n-D transform of a DTensor: where the mesh shards none of its
    axes, each process's one torch.fft call on its own box; else axis by
    axis (``_mesh_axis``), a complex transform's sharded axes first, the
    others then in place on that result."""
    from nums_tpu_torch.core.ops import mesh_ops

    steps = _nd_steps(fname, tuple(x.shape), s, axes)
    sharded = [bool(mesh_ops.shard_dims(x.placements, (axis,)))
               for _, _, axis in steps]
    if not any(sharded):
        local = getattr(_torch.fft, fname)(x.to_local(), s=s, dim=axes,
                                           norm=norm).resolve_conj()
        shape = list(x.shape)
        for _, _, axis in steps:
            shape[axis] = int(local.shape[axis])
        return a.backend.from_local(local.contiguous(), tuple(shape),
                                    tuple(x.placements))
    if fname in ("fftn", "ifftn", "fft2", "ifft2"):
        steps = [st for st, sh in zip(steps, sharded) if sh] + [
            st for st, sh in zip(steps, sharded) if not sh]
    for k, (one, n, axis) in enumerate(steps):
        x = _mesh_axis(one, a, x, n, axis, norm, owned=k > 0)
    return x


def _make_nd(fname, default_axes=None):
    fn = getattr(_torch.fft, fname)

    def fft_fn(a, s=None, axes=default_axes, norm=None):
        a, x = _input(a)
        s = tuple(s) if s is not None else None
        axes = tuple(axes) if axes is not None else None
        if type(x).__name__ == "DTensor":
            return _placed(a, _mesh_nd(fname, a, x, s, axes, norm))
        return _out(a, fn(x, s=s, dim=axes, norm=norm))

    fft_fn.__name__ = fname
    fft_fn.__doc__ = (f"numpy.fft.{fname} by one torch.fft.{fname}; on the "
                      "mesh axis by axis (``_mesh_axis``).")
    return fft_fn


fftn = _make_nd("fftn")
ifftn = _make_nd("ifftn")
rfftn = _make_nd("rfftn")
irfftn = _make_nd("irfftn")
fft2 = _make_nd("fft2", (-2, -1))
ifft2 = _make_nd("ifft2", (-2, -1))
rfft2 = _make_nd("rfft2", (-2, -1))
irfft2 = _make_nd("irfft2", (-2, -1))


def _shift(a, sign):
    """``fftshift``/``ifftshift`` of every axis: a roll by ∓(n // 2); on
    the mesh ``roll``'s (one all-to-all along each sharded axis)."""
    a = _input(a)[0]
    if type(a.data).__name__ == "DTensor":
        from nums_tpu_torch.numpy import extra

        shifts = [sign * (int(n) // 2) for n in a.shape]
        return extra.roll(a, shifts, tuple(range(a.ndim)))
    fn = _torch.fft.fftshift if sign > 0 else _torch.fft.ifftshift
    return _out(a, fn(a.data))


def fftshift(a):
    return _shift(a, 1)


def ifftshift(a):
    return _shift(a, -1)


def _freq(ints, n, d):
    app = _instance()
    out = ints.to(_torch.float64) * (1.0 / (n * d))
    dt = _utils.to_torch_dtype(app.backend.default_float)
    return _BA.from_torch(out.to(dt), backend=app.backend)


def fftfreq(n, d=1.0):
    """NumPy's sample frequencies: 0, 1, ..., then the negative ones, over
    ``n·d``."""
    n = int(n)
    device = _instance().backend.device
    pos = (n - 1) // 2 + 1
    ints = _torch.cat([_torch.arange(0, pos, device=device),
                       _torch.arange(-(n // 2), 0, device=device)])
    return _freq(ints, n, d)


def rfftfreq(n, d=1.0):
    n = int(n)
    device = _instance().backend.device
    return _freq(_torch.arange(0, n // 2 + 1, device=device), n, d)
