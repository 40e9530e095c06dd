"""Symmetric gram kernel for Hopper:  G = XᵀX  and  G = Xᵀ·diag(s)·X.

Counterpart of ``nums_tpu/core/ops/pallas_gram.py``; the kernel is
``nums_tpu_torch/csrc/gram.cu`` and replaces the Pallas kernels
``pallas_gram._make_kernel`` / ``_gram_call`` (unscaled, K1) and
``_make_kernel(scaled=True)`` (weighted, K2). Both compute the upper
triangle with bf16-rounded operands and f32 accumulation, and mirror it,
so G is exactly symmetric.

On this card the gram is bound by compute (about 2·n·d²/2 FLOP against
one read of X); the kernel is the simple SIMT version, and tensor cores
are a later step (see the note in gram.cu).

``gram`` launches the kernel for a CUDA tensor and takes the plain torch
version, ``gram_plain``, for a CPU tensor; any other device raises. The
plain version is the kernel's arithmetic in torch ops: the same bf16
rounding, an f32 matmul (TF32 off), and the same mirror.
"""

import numpy as np
import torch

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import _build

# Launches of the CUDA kernel, by variant. Only ``gram`` adds to them.
LAUNCHES = {"gram": 0, "gram_weighted": 0}

# Row splits: enough blocks to fill the 132 SMs several times over,
# bounded by the rows, the grid's y limit and the workspace size.
_BLOCKS_TARGET = 132 * 8
_MIN_ROWS_PER_SPLIT = 32
_MAX_SPLITS = 65535
_MAX_WORKSPACE_BYTES = 256 << 20


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


def gram_plain(x, s=None):
    """The kernel's arithmetic in plain torch ops."""
    if s is not None:
        x = x * torch.sqrt(s.to(torch.float32))[:, None]
    xb = round_bf16(x)
    return mirror_upper(xb.T @ xb)


def _check(x):
    if not supported(tuple(x.shape), x.dtype):
        raise ValueError(
            f"gram kernel takes a non-empty 2-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("gram kernel takes a row-major contiguous tensor")


def gram(x, s=None):
    """G = XᵀX, or Xᵀ·diag(s)·X for ``s`` of shape (n,), s >= 0."""
    if x.device.type == "cpu":
        return gram_plain(x, s)
    if x.device.type != "cuda":
        raise ValueError(f"gram: no kernel for device {x.device}")
    _check(x)
    n, d = (int(v) for v in x.shape)
    if s is not None:
        if tuple(s.shape) != (n,) or s.device != x.device:
            raise ValueError(
                f"gram: s must be ({n},) on {x.device}, got "
                f"{tuple(s.shape)} on {s.device}"
            )
        s = s.to(torch.float32).contiguous()
    lib = _build.lib()
    tile = lib.nums_gram_tile()
    t = -(-d // tile)
    npairs = t * (t + 1) // 2
    tile_bytes = npairs * tile * tile * 4
    splits = max(1, min(
        -(-_BLOCKS_TARGET // npairs),
        -(-n // _MIN_ROWS_PER_SPLIT),
        _MAX_SPLITS,
        _MAX_WORKSPACE_BYTES // tile_bytes,
    ))
    ws = torch.empty(splits * npairs * tile * tile, dtype=torch.float32,
                     device=x.device)
    g = torch.empty((d, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nums_gram(
            x.data_ptr(), None if s is None else s.data_ptr(),
            ws.data_ptr(), g.data_ptr(), n, d, splits, stream,
        )
        LAUNCHES["gram" if s is None else "gram_weighted"] += 1
    _build.check(err, "nums_gram")
    return g
