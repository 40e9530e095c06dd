"""GLM Newton statistics kernel for Hopper:  (g, H)  of one iteration.

Counterpart of ``nums_tpu/core/ops/pallas_newton.py``; the kernels are
``nums_tpu_torch/csrc/newton.cu`` and replace the Pallas kernel
``pallas_newton._make_kernel`` / ``_stats_call`` (K3). For fp32 X (n, d),
y (n,) and beta (d,):

    eta = X·beta;  mu, s = link(eta);  r = mu - y
    g = Xᵀ·r;      H = Xᵀ·diag(s)·X   (XᵀX for the linear kind)

with bf16-rounded operands and f32 accumulation, as the TPU kernel
rounds them: H from bf16(bf16(x)·bf16(√s)) (``pallas_newton.py:114``).

Every use of X is bf16(x), and X does not change across a fit, so the
fp32 X is read once: ``prepare`` stages the bf16 copy of Xᵀ (gram.cu's
staging pass in mode 0, ``Staged``), and each ``stats`` call on it reads
only that copy: ``newton_eta`` (eta, the link, bf16(r) and bf16(√s)),
``newton_grad_scale`` (g, and the scaled bf16 operand of H) and the gram
(``cuda_gram.gram_staged``) of the scaled operand, or of the staged copy
itself for the linear kind. ``stats`` on a plain X stages it first.

``prepare`` and ``stats`` launch the kernels for a CUDA tensor and take
the plain torch versions, ``prepare_plain`` and ``stats_plain``, for a
CPU tensor; any other device raises. ``eta`` and ``grad_scale`` launch
one pass each, for checking and timing them apart.
"""

from dataclasses import dataclass

import torch

from nums_tpu_torch.core import settings, trace
from nums_tpu_torch.core.ops import _build, cuda_gram

KINDS = ("logistic", "linear", "poisson")

# "newton_stage": one per ``prepare`` on the card (``stats`` on a plain X
# prepares it); "newton_stats": one per ``stats`` call on the card. The
# Hessian's gram counts in ``cuda_gram.LAUNCHES``.
LAUNCHES = {"newton_stage": 0, "newton_stats": 0}

# Row splits of newton_grad_scale: about _BLOCKS_TARGET blocks of
# _GRAD_FEATURES features; a split is whole steps of _ROWS_PER_ITER rows.
# As in newton.cu: they set the number of blocks, not the result's
# correctness.
_BLOCKS_TARGET = 132 * 32
_GRAD_FEATURES = 16
_ROWS_PER_ITER = 256 * 8
_MAX_SPLITS = 65535
_ETA_CHUNK = 1 << 18  # rows per float64 panel of the plain eta


@dataclass(frozen=True, eq=False)
class Staged:
    """X staged for the Newton statistics: ``xt`` is the bf16 copy of Xᵀ,
    (d_pad, n_pad) as ``cuda_gram.padded_shape`` gives it, zero in the
    pad; X is (n, d)."""

    xt: torch.Tensor
    n: int
    d: int

    @property
    def shape(self):
        return (self.n, self.d)

    @property
    def device(self):
        return self.xt.device

    def rounded(self):
        """bf16(X) in float32, (n, d) with row-major strides, so that the
        plain versions take it as they take X."""
        xb = torch.empty((self.n, self.d), dtype=torch.float32,
                         device=self.device)
        return xb.copy_(self.xt[:self.d, :self.n].T)


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


def prepare_plain(x):
    """The staging pass in torch ops: ``Staged`` with the zero-padded bf16
    copy of Xᵀ."""
    n, d = (int(v) for v in x.shape)
    xt = torch.zeros(cuda_gram.padded_shape(n, d), dtype=torch.bfloat16,
                     device=x.device)
    xt[:d, :n] = x.T.to(torch.bfloat16)
    return Staged(xt, n, d)


def eta_plain(xb, y, beta, kind):
    """newton_eta's arithmetic: (bf16(r), bf16(√s)) in float32, (n,)
    each; the second is None for the linear kind. xb: bf16(X) in
    float32."""
    eta = _eta_plain(xb, cuda_gram.round_bf16(beta.to(torch.float32)))
    mu, s = _link(kind, eta)
    rb = cuda_gram.round_bf16(mu - y.to(torch.float32))
    return rb, None if s is None else cuda_gram.round_bf16(torch.sqrt(s))


def grad_scale_plain(xb, rb, wb):
    """newton_grad_scale's arithmetic: g = bf16(X)ᵀ·bf16(r), and the
    scaled operand bf16(bf16(x)·bf16(√s)) in X's layout (None without
    ``wb``)."""
    g = xb.T @ rb
    if wb is None:
        return g, None
    xs = xb * wb[:, None]  # exact: a product of two bf16 values
    return g, cuda_gram.round_bf16(xs)


def stats_plain(x, y, beta, kind):
    """The kernels' arithmetic in plain torch ops; ``x`` is X or its
    ``Staged`` copy, with the same result."""
    if kind not in KINDS:
        raise ValueError(kind)
    xb = x.rounded() if isinstance(x, Staged) else cuda_gram.round_bf16(x)
    rb, wb = eta_plain(xb, y, beta, kind)
    g, xs = grad_scale_plain(xb, rb, wb)
    if xs is None:
        xs = xb
    del xb
    return g, cuda_gram.mirror_upper(xs.T @ xs)


def prepare(x):
    """Stage X (fp32, (n, d)) for ``stats``: one read of X, one launch of
    gram.cu's staging pass in mode 0."""
    if x.device.type == "cpu":
        return prepare_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"prepare: no kernel for device {x.device}")
    xt = cuda_gram.stage(x)
    LAUNCHES["newton_stage"] += 1
    return Staged(xt, int(x.shape[0]), int(x.shape[1]))


def _check_cuda(staged, what):
    if not isinstance(staged, Staged):
        raise ValueError(f"{what}: takes a Staged X (prepare)")
    if staged.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {staged.device}")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def eta(staged, y, beta, kind):
    """Launch ``newton_eta`` on a staged X: (bf16(r), bf16(√s)), each
    (n_pad,) bf16 and zero past n; the second is None for the linear
    kind. Counts no launch."""
    _check_cuda(staged, "eta")
    n, d = staged.shape
    if tuple(y.shape) != (n,) or tuple(beta.shape) != (d,):
        raise ValueError(
            f"stats: y must be ({n},) and beta ({d},), got "
            f"{tuple(y.shape)} and {tuple(beta.shape)}"
        )
    if y.device != staged.device or beta.device != staged.device:
        raise ValueError("stats: x, y and beta must be on one device")
    y = y.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    n_pad = int(staged.xt.shape[1])
    rb = torch.empty(n_pad, dtype=torch.bfloat16, device=staged.device)
    wb = None if kind == "linear" else torch.empty_like(rb)
    with torch.cuda.device(staged.device):
        err = _build.lib().nums_newton_eta(
            staged.xt.data_ptr(), y.data_ptr(), beta.data_ptr(),
            rb.data_ptr(), None if wb is None else wb.data_ptr(), n, d,
            n_pad, KINDS.index(kind), _stream(),
        )
    _build.check(err, "nums_newton_eta")
    return rb, wb


def _splits(d, n_pad):
    groups = -(-d // _GRAD_FEATURES)
    iters = -(-n_pad // _ROWS_PER_ITER)
    return max(1, min(-(-_BLOCKS_TARGET // groups), iters, _MAX_SPLITS))


def grad_scale(staged, rb, wb):
    """Launch ``newton_grad_scale`` and the gradient's reduction on a
    staged X and ``eta``'s outputs: (g, xs), xs the scaled bf16 operand
    of H in the staged copy's layout and zero pad, or None without
    ``wb``. Counts no launch."""
    _check_cuda(staged, "grad_scale")
    d = staged.d
    d_pad, n_pad = (int(v) for v in staged.xt.shape)
    for v in (rb, wb):
        if v is not None and (v.dtype != torch.bfloat16
                              or tuple(v.shape) != (n_pad,)
                              or v.device != staged.device):
            raise ValueError(
                f"grad_scale: rb and wb are ({n_pad},) bf16 on "
                f"{staged.device}, as eta gives them"
            )
    splits = _splits(d, n_pad)
    dev = staged.device
    xs = None if wb is None else torch.empty_like(staged.xt)
    gws = torch.empty(splits * d, dtype=torch.float32, device=dev)
    g = torch.empty(d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().nums_newton_grad_scale(
            staged.xt.data_ptr(), rb.data_ptr(),
            None if wb is None else wb.data_ptr(),
            None if xs is None else xs.data_ptr(), gws.data_ptr(),
            g.data_ptr(), d, n_pad, d_pad, splits, _stream(),
        )
    _build.check(err, "nums_newton_grad_scale")
    return g, xs


def stats(x, y, beta, kind):
    """(g, H) for one GLM Newton iteration. x: fp32 (n, d), or its
    ``Staged`` copy from ``prepare`` (a fit stages X once and passes the
    copy to every iteration); y: (n,); beta: (d,); kind in ``KINDS``."""
    if kind not in KINDS:
        raise ValueError(kind)
    with trace.span("nums.kernel.newton_stats"):
        if x.device.type == "cpu":
            return stats_plain(x, y, beta, kind)
        if x.device.type != "cuda":
            raise ValueError(f"stats: no kernel for device {x.device}")
        staged = x if isinstance(x, Staged) else prepare(x)
        rb, wb = eta(staged, y, beta, kind)
        g, xs = grad_scale(staged, rb, wb)
        LAUNCHES["newton_stats"] += 1
        if xs is None:
            return g, cuda_gram.gram_staged(staged.xt, staged.d,
                                            weighted=False)
        return g, cuda_gram.gram_staged(xs, staged.d, weighted=True)
