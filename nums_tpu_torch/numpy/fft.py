"""nums_tpu_torch.numpy.fft: ``numpy.fft``'s surface on ``torch.fft``.

Counterpart of ``nums_tpu/numpy/fft.py``: one ``torch.fft`` call (cuFFT
on the card) per function, with numpy's ``n``/``s``/``axes``/``norm``
semantics. Integer and bool input computes in the backend's default float,
as ``jnp.fft`` does (float64 on the CPU, float32 on the card), so a
float32 array gives complex64. ``fftfreq``/``rfftfreq`` are built on the
device in float64 and then cast to the default float: the values of
NumPy's own, as the reference's host arrays put on the device.
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


# The length of a transform's output axis, from its input length L and n.
_OUT_LEN = {"fft": lambda L, n: n or L, "ifft": lambda L, n: n or L,
            "rfft": lambda L, n: (n or L) // 2 + 1,
            "irfft": lambda L, n: n or 2 * (L - 1),
            "hfft": lambda L, n: n or 2 * (L - 1),
            "ihfft": lambda L, n: (n or L) // 2 + 1}


def _mesh_fft(fname, a, x, n, axis, norm):
    """A 1-D transform of a DTensor: along an axis that no mesh dimension
    shards, each process transforms its own lines; along a sharded one
    the sharding moves to another axis first (``mesh_ops.across``: one
    all-to-all there and one back). The result keeps the operand's row
    blocks (the serial rule, one block, would lay it whole). A sharded
    vector has no other axis: its transform is not ported (it raises)."""
    from nums_tpu_torch.core.ops import mesh_ops

    fn = getattr(_torch.fft, fname)
    if x.ndim == 1 and mesh_ops.shard_dims(x.placements, (0,)):
        raise NotImplementedError(
            f"fft.{fname} of a sharded vector on the mesh: a distributed "
            "1-D FFT is not ported")
    axis = int(axis) % x.ndim
    length = _OUT_LEN[fname](int(x.shape[axis]), n)
    dt = fn(_torch.zeros((4,), dtype=x.dtype, device="meta"),
            n=4).dtype
    if mesh_ops.shard_dims(x.placements, (axis,)):
        out = mesh_ops.across(a.backend, x, axis, lambda local, dim: fn(
            local, n=n, dim=dim, norm=norm).resolve_conj(), length, dt,
            mesh_ops.CHUNK_ELEMENTS)
    else:
        local = fn(x.to_local(), n=n, dim=axis, norm=norm).resolve_conj()
        shape = tuple(length if k == axis else int(s)
                      for k, s in enumerate(x.shape))
        out = a.backend.from_local(local.contiguous(), shape,
                                   tuple(x.placements))
    bs = tuple(min(b, s) for b, s in zip(a.block_shape, out.shape))
    return _BA.from_torch(out, block_shape=bs, backend=a.backend)


def _make(fname):
    fn = getattr(_torch.fft, fname)

    def fft_fn(a, n=None, axis=-1, norm=None):
        a, x = _input(a)
        if type(x).__name__ == "DTensor":
            return _mesh_fft(fname, a, x, n, axis, norm)
        return _out(a, fn(x, n=n, dim=axis, norm=norm))

    fft_fn.__name__ = fname
    fft_fn.__doc__ = f"numpy.fft.{fname} by one torch.fft.{fname}."
    return fft_fn


fft = _make("fft")
ifft = _make("ifft")
rfft = _make("rfft")
irfft = _make("irfft")
hfft = _make("hfft")
ihfft = _make("ihfft")


def _make_nd(fname, default_axes=None):
    fn = getattr(_torch.fft, fname)

    def fft_fn(a, s=None, axes=default_axes, norm=None):
        a, x = _input(a)
        s = tuple(s) if s is not None else None
        axes = tuple(axes) if axes is not None else None
        return _out(a, fn(x, s=s, dim=axes, norm=norm))

    fft_fn.__name__ = fname
    fft_fn.__doc__ = f"numpy.fft.{fname} by one torch.fft.{fname}."
    return fft_fn


fftn = _make_nd("fftn")
ifftn = _make_nd("ifftn")
rfftn = _make_nd("rfftn")
irfftn = _make_nd("irfftn")
fft2 = _make_nd("fft2", (-2, -1))
ifft2 = _make_nd("ifft2", (-2, -1))
rfft2 = _make_nd("rfft2", (-2, -1))
irfft2 = _make_nd("irfft2", (-2, -1))


def fftshift(a):
    a = _input(a)[0]
    return _out(a, _torch.fft.fftshift(a.data))


def ifftshift(a):
    a = _input(a)[0]
    return _out(a, _torch.fft.ifftshift(a.data))


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
