"""Symmetric gram kernel for Hopper:  G = XᵀX  and  G = Xᵀ·diag(s)·X.

Counterpart of ``nums_tpu/core/ops/pallas_gram.py``; the kernel is
``nums_tpu_torch/csrc/gram.cu`` and replaces the Pallas kernels
``pallas_gram._make_kernel`` / ``_gram_call`` (unscaled, K1) and
``_make_kernel(scaled=True)`` (weighted, K2). Both compute the upper
triangle with bf16-rounded operands and f32 accumulation, and mirror it,
so G is exactly symmetric.

The operands are rounded to bf16 by one of three modes:

* ``MODE_X`` (0): bf16(x), for K1 and the linear Newton kind;
* ``MODE_SCALE_F32`` (1): bf16(x·√s), scaled in f32, as K2 does
  (``pallas_gram.py:81-84``);
* ``MODE_SCALE_BF16`` (2): bf16(bf16(x)·bf16(√s)), as the TPU Newton
  kernel builds its Hessian (``pallas_newton.py:114``).

On the card a staging pass writes the rounded operands once, as a bf16
copy of Xᵀ padded with zeros to whole tiles, and a TMA + wgmma kernel
computes the upper tile pairs from it on the tensor cores (see the note
in gram.cu). ``stage`` and ``gram_staged`` launch the two steps apart:
the Newton statistics (``cuda_newton``) stage X once per fit and take the
gram of their own bf16 operand.

``gram`` launches the kernels for a CUDA tensor and takes the plain torch
version, ``gram_plain``, for a CPU tensor; any other device raises. The
plain version is the kernels' arithmetic in torch ops: the same bf16
rounding, an f32 matmul (TF32 off), and the same mirror.

Where autograd records (grad enabled and X requiring grad), ``gram`` of X
alone runs through ``GramFunction``: the same forward on either device,
and the backward ``Ḡ ↦ X·(Ḡ + Ḡᵀ)`` in X's dtype from the unrounded X.
The reference has no backward kernel for the gram (no ``custom_vjp``):
its gradient is XLA's plain product, so this one is ``torch.matmul``
(TF32 off), written in differentiable ops so that a second derivative
(``autodiff.hvp``) runs through it.
"""

import numpy as np
import torch

from nums_tpu_torch.core import settings, trace
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import _build

MODE_X, MODE_SCALE_F32, MODE_SCALE_BF16 = 0, 1, 2

# Launches of the CUDA kernels, by variant: "gram" for MODE_X, and
# "gram_weighted" for the weighted modes. Only ``gram`` adds to them.
LAUNCHES = {"gram": 0, "gram_weighted": 0}

# Row splits: enough (tile pair) x (split) blocks, one per SM at a time,
# to fill the 132 SMs several times over, bounded by the K tiles and the
# workspace size.
_BLOCKS_TARGET = 132 * 8
_MAX_WORKSPACE_BYTES = 256 << 20
# gram.cu's output tile (d is padded to it) and K tile (n is padded to
# it); its entry points refuse other sizes.
TILE, KTILE = 128, 64


def enabled() -> bool:
    """``settings.gram_kernel`` (auto|0|1); auto is on in the bf16-MAC
    precision class (``settings.matmul_precision == "default"``)."""
    return settings.kernel_enabled(settings.gram_kernel)


def supported(shape, dtype) -> bool:
    """Any non-empty 2-D float32 array: no cap on d, no alignment."""
    if len(shape) != 2 or min(int(v) for v in shape) < 1:
        return False
    return array_utils.to_np_dtype(dtype) == np.float32


def round_bf16(t):
    """Round float32 to the nearest bf16 value, kept in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def mirror_upper(u):
    """Keep the upper triangle (j >= i) and copy it to i > j."""
    return torch.triu(u) + torch.triu(u, 1).T


def _mode(s, mode):
    if mode is None:
        return MODE_X if s is None else MODE_SCALE_F32
    if mode not in (MODE_X, MODE_SCALE_F32, MODE_SCALE_BF16):
        raise ValueError(f"gram: unknown rounding mode {mode}")
    if (mode == MODE_X) != (s is None):
        raise ValueError("gram: the weighted modes take s, mode 0 does not")
    return mode


def stage_plain(x, s=None, mode=None):
    """The staging pass's rounding, in float32 and in X's layout."""
    mode = _mode(s, mode)
    if mode == MODE_X:
        return round_bf16(x)
    w = torch.sqrt(s.to(torch.float32))[:, None]
    if mode == MODE_SCALE_F32:
        return round_bf16(x * w)
    xb = round_bf16(x)
    xb *= round_bf16(w)  # exact: a product of two bf16 values
    return round_bf16(xb)


def gram_plain(x, s=None, mode=None):
    """The kernels' arithmetic in plain torch ops."""
    xb = stage_plain(x, s, mode)
    return mirror_upper(xb.T @ xb)


def _check(x):
    if not supported(tuple(x.shape), x.dtype):
        raise ValueError(
            f"gram kernel takes a non-empty 2-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("gram kernel takes a row-major contiguous tensor")


def _checked(x, s):
    """x and s as the kernels take them, or raise."""
    _check(x)
    n = int(x.shape[0])
    if s is None:
        return s
    if tuple(s.shape) != (n,) or s.device != x.device:
        raise ValueError(
            f"gram: s must be ({n},) on {x.device}, got "
            f"{tuple(s.shape)} on {s.device}"
        )
    return s.to(torch.float32).contiguous()


def padded_shape(n, d):
    """(d_pad, n_pad) of the staged copy of an (n, d) X: whole output
    tiles and whole K tiles."""
    return -(-d // TILE) * TILE, -(-n // KTILE) * KTILE


def stage(x, s=None, mode=None):
    """Launch the staging pass alone: the (d_pad, n_pad) bf16 copy of the
    rounded Xᵀ, zero in the pad. ``gram`` runs it and ``cuda_newton``
    stages X with it once per fit; it counts no launch."""
    mode = _mode(s, mode)
    if x.device.type != "cuda":
        raise ValueError(f"stage: no kernel for device {x.device}")
    s = _checked(x, s)
    n, d = (int(v) for v in x.shape)
    lib = _build.lib()
    d_pad, n_pad = padded_shape(n, d)
    xt = torch.empty((d_pad, n_pad), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.nums_gram_stage(
            x.data_ptr(), None if s is None else s.data_ptr(), xt.data_ptr(),
            n, d, n_pad, d_pad, mode,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(err, "nums_gram_stage")
    return xt


def _splits(k_tiles, npairs, tile):
    """Row splits: about ``_BLOCKS_TARGET`` blocks, every split at least
    one K tile, the workspace under its cap."""
    splits = max(1, min(
        -(-_BLOCKS_TARGET // npairs),
        k_tiles,
        _MAX_WORKSPACE_BYTES // (npairs * tile * tile * 4),
    ))
    per = -(-k_tiles // splits)
    return -(-k_tiles // per)


def gram_staged(xt, d, weighted):
    """G (d, d) from a staged bf16 copy ``xt`` (d_pad, n_pad) of Xᵀ (the
    operands already rounded, zero in the pad): ``gram_mma`` and
    ``gram_reduce``. Adds one to ``LAUNCHES["gram_weighted"]`` when the
    copy holds weighted operands, else to ``LAUNCHES["gram"]``."""
    if xt.device.type != "cuda":
        raise ValueError(f"gram_staged: no kernel for device {xt.device}")
    d_pad, n_pad = (int(v) for v in xt.shape)
    if (xt.dtype != torch.bfloat16 or not xt.is_contiguous()
            or (d_pad, n_pad) != padded_shape(n_pad, d)):
        raise ValueError(
            f"gram_staged: takes a contiguous bf16 copy padded to "
            f"{padded_shape(n_pad, d)}, got {xt.dtype} {(d_pad, n_pad)}"
        )
    lib = _build.lib()
    t = d_pad // TILE
    npairs = t * (t + 1) // 2
    splits = _splits(n_pad // KTILE, npairs, TILE)
    ws = torch.empty(splits * npairs * TILE * TILE, dtype=torch.float32,
                     device=xt.device)
    g = torch.empty((d, d), dtype=torch.float32, device=xt.device)
    with torch.cuda.device(xt.device):
        err = lib.nums_gram_staged(
            xt.data_ptr(), ws.data_ptr(), g.data_ptr(), d, n_pad, d_pad,
            splits, torch.cuda.current_stream().cuda_stream,
        )
        LAUNCHES["gram_weighted" if weighted else "gram"] += 1
    _build.check(err, "nums_gram_staged")
    return g


class GramFunction(torch.autograd.Function):
    """K1 under autograd: the forward of ``gram(x)`` (kernel or plain
    version, one launch counted as ever), the backward X·(Ḡ + Ḡᵀ)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gram(x, None, MODE_X)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.matmul(x, g + g.T)


def gram(x, s=None, mode=None):
    """G = XᵀX, or Xᵀ·diag(s)·X for ``s`` of shape (n,), s >= 0, with the
    bf16 rounding of ``mode`` (default: ``MODE_X`` without s,
    ``MODE_SCALE_F32`` with it). A gradient flows through X alone
    (``GramFunction``); the weighted modes take no gradient."""
    with trace.span("nums.kernel.gram"):
        mode = _mode(s, mode)
        if torch.is_grad_enabled() and x.requires_grad:
            if mode != MODE_X:
                raise NotImplementedError(
                    "gram: the weighted modes have no backward")
            return GramFunction.apply(x)
        return _gram(x, s, mode)


def _gram(x, s, mode):
    if x.device.type == "cpu":
        return gram_plain(x, s, mode)
    if x.device.type != "cuda":
        raise ValueError(f"gram: no kernel for device {x.device}")
    return gram_staged(stage(x, s, mode), int(x.shape[1]), mode != MODE_X)
