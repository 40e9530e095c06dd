"""GLM Newton statistics kernel for Hopper:  (g, H)  of one iteration.

Counterpart of ``nums_tpu/core/ops/pallas_newton.py``; the kernel is
``nums_tpu_torch/csrc/newton.cu`` and replaces the Pallas kernel
``pallas_newton._make_kernel`` / ``_stats_call`` (K3). For fp32 X (n, d),
y (n,) and beta (d,):

    eta = X·beta;  mu, s = link(eta);  r = mu - y
    g = Xᵀ·r;      H = Xᵀ·diag(s)·X   (XᵀX for the linear kind)

with bf16-rounded operands and f32 accumulation. newton.cu runs the row
pass (eta, link, r, s) and g; H is the weighted gram of ``cuda_gram``
(K2's kernel) with the TPU Newton kernel's rounding,
bf16(bf16(x)·bf16(√s)) (``pallas_newton.py:114``, ``MODE_SCALE_BF16``),
and XᵀX for the linear kind. The TPU kernel reads X once for all of it;
the port reads it three times (two memory-bound passes and the gram's
staging pass), and one read is a later step (see the note in newton.cu).

``stats`` launches the kernels for a CUDA tensor and takes the plain torch
version, ``stats_plain``, for a CPU tensor; any other device raises.
"""

import torch

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import _build, cuda_gram

KINDS = ("logistic", "linear", "poisson")

# Launches of newton.cu (row pass + gradient), one per ``stats`` call on
# the card. The Hessian's launches count in ``cuda_gram.LAUNCHES``.
LAUNCHES = {"newton_stats": 0}

_BLOCKS_TARGET = 132 * 16
_MIN_ROWS_PER_SPLIT = 64
_MAX_SPLITS = 65535
_COL_THREADS = 256  # columns per gradient block, as in newton.cu
_ETA_CHUNK = 1 << 18  # rows per float64 panel of the plain eta


def enabled() -> bool:
    """``settings.newton_kernel`` (auto|0|1); auto follows the precision
    setting, as ``pallas_newton.enabled`` follows ``pallas_gram``'s."""
    return settings.kernel_enabled(settings.newton_kernel)


def supported(shape, dtype) -> bool:
    return cuda_gram.supported(shape, dtype)


def _link(kind, eta):
    """(mu, s) from eta; ``s=None`` is the identity weight (H = XᵀX).
    Spelled as newton.cu spells it, so both round alike."""
    if kind == "logistic":
        mu = torch.reciprocal(1.0 + torch.exp(-eta))
        return mu, mu * (1.0 - mu)
    if kind == "linear":
        return eta, None
    if kind == "poisson":
        mu = torch.exp(eta)
        return mu, mu
    raise ValueError(kind)


def _hessian_mode(s):
    """The TPU Newton kernel's rounding of H's operands; the linear kind
    (no weight) is the plain gram."""
    return cuda_gram.MODE_X if s is None else cuda_gram.MODE_SCALE_BF16


def _eta_plain(xb, bb):
    """X·beta of bf16-rounded operands, summed in float64 and rounded to
    float32 as newton.cu does; in row panels, so no float64 copy of X."""
    eta = torch.empty(xb.shape[0], dtype=torch.float32, device=xb.device)
    b64 = bb.to(torch.float64)
    for i in range(0, xb.shape[0], _ETA_CHUNK):
        eta[i:i + _ETA_CHUNK] = (
            xb[i:i + _ETA_CHUNK].to(torch.float64) @ b64
        ).to(torch.float32)
    return eta


def stats_plain(x, y, beta, kind):
    """The kernels' arithmetic in plain torch ops."""
    if kind not in KINDS:
        raise ValueError(kind)
    xb = cuda_gram.round_bf16(x)
    eta = _eta_plain(xb, cuda_gram.round_bf16(beta.to(torch.float32)))
    mu, s = _link(kind, eta)
    r = mu - y.to(torch.float32)
    g = xb.T @ cuda_gram.round_bf16(r)
    del xb
    return g, cuda_gram.gram_plain(x, s, _hessian_mode(s))


def stats(x, y, beta, kind):
    """(g, H) for one GLM Newton iteration. x: fp32 (n, d); y: (n,);
    beta: (d,); kind in ``KINDS``."""
    if kind not in KINDS:
        raise ValueError(kind)
    if x.device.type == "cpu":
        return stats_plain(x, y, beta, kind)
    if x.device.type != "cuda":
        raise ValueError(f"stats: no kernel for device {x.device}")
    cuda_gram._check(x)
    n, d = (int(v) for v in x.shape)
    if tuple(y.shape) != (n,) or tuple(beta.shape) != (d,):
        raise ValueError(
            f"stats: y must be ({n},) and beta ({d},), got "
            f"{tuple(y.shape)} and {tuple(beta.shape)}"
        )
    if y.device != x.device or beta.device != x.device:
        raise ValueError("stats: x, y and beta must be on one device")
    y = y.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    lib = _build.lib()
    col_blocks = -(-d // _COL_THREADS)
    splits = max(1, min(
        -(-_BLOCKS_TARGET // col_blocks),
        -(-n // _MIN_ROWS_PER_SPLIT),
        _MAX_SPLITS,
    ))
    dev = x.device
    r = torch.empty(n, dtype=torch.float32, device=dev)
    s = None if kind == "linear" else torch.empty(
        n, dtype=torch.float32, device=dev
    )
    gws = torch.empty(splits * d, dtype=torch.float32, device=dev)
    g = torch.empty(d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.nums_newton_stats(
            x.data_ptr(), y.data_ptr(), beta.data_ptr(), r.data_ptr(),
            None if s is None else s.data_ptr(), gws.data_ptr(),
            g.data_ptr(), n, d, KINDS.index(kind), splits, stream,
        )
        LAUNCHES["newton_stats"] += 1
    _build.check(err, "nums_newton_stats")
    return g, cuda_gram.gram(x, s, _hessian_mode(s))
