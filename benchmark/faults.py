"""Faults planted in the program, to show that the comparison catches
them: ``planted(name)`` sets one for the ``with`` block and puts the
program back after it. ``control.py`` reads them on the card at a cell's
own size, the CPU tests at a small one. Not part of a benchmark run.

- ``step_unchanged``: a Newton step returns β unchanged;
- ``half_batch_fit``, ``half_batch_gram``: half of the rows left out, the
  sums doubled over the rest;
- ``answer_altered_fit``, ``answer_altered_gram``: the answer altered
  where it is produced;
- ``exchange_left_out``: each process keeps its own (g, H), no
  all-reduce;
- ``hessian_frozen``: every step of a fit reuses its first step's H;
- ``hessian_fp8``: H from the scaled operand rounded to float8_e4m3fn;
- ``hessian_half_rows``: H from half of the rows, doubled.

The three Hessian faults leave g as the program computes it.
"""

import contextlib

import torch

FAULTS = ("step_unchanged", "half_batch_fit", "half_batch_gram",
          "answer_altered_fit", "answer_altered_gram", "exchange_left_out",
          "hessian_frozen", "hessian_fp8", "hessian_half_rows")


def _scaled(x, y, beta, kind):
    """(g, xsT, d): g as the program computes it and the Hessian's scaled
    operand with one column a row (the staged layout on the card; in
    float32 on the CPU), by the program's kernels or their plain
    versions."""
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton as cn

    if x.device.type == "cuda":
        staged = x if isinstance(x, cn.Staged) else cn.prepare(x)
        rb, wb = cn.eta(staged, y, beta, kind)
        g, xs = cn.grad_scale(staged, rb, wb)
        return g, xs, staged.d
    xb = x.rounded() if isinstance(x, cn.Staged) else cuda_gram.round_bf16(x)
    rb, wb = cn.eta_plain(xb, y, beta, kind)
    g, xs = cn.grad_scale_plain(xb, rb, wb)
    return g, xs.T.contiguous(), xb.shape[1]


def _hessian(xs_t, d):
    from nums_tpu_torch.core.ops import cuda_gram

    if xs_t.device.type == "cuda":
        return cuda_gram.gram_staged(xs_t, d, weighted=True)
    return cuda_gram.mirror_upper(xs_t @ xs_t.T)


def _stats_hessian_fp8(x, y, beta, kind):
    g, xs_t, d = _scaled(x, y, beta, kind)
    return g, _hessian(xs_t.to(torch.float8_e4m3fn).to(xs_t.dtype), d)


def _stats_hessian_half_rows(x, y, beta, kind):
    g, xs_t, d = _scaled(x, y, beta, kind)
    xs_t[:, int(x.shape[0]) // 2:] = 0
    return g, 2.0 * _hessian(xs_t, d)


def _frozen(fast_glm, cuda_newton):
    """(newton_fit, stats) that keep each fit's first H for its steps."""
    fit, stats, first = fast_glm.newton_fit, cuda_newton.stats, []

    def newton_fit(*args, **kwargs):
        first.clear()
        return fit(*args, **kwargs)

    def frozen_stats(x, y, beta, kind):
        g, H = stats(x, y, beta, kind)
        if not first:
            first.append(H)
        return g, first[0]

    return newton_fit, frozen_stats


def _settings(name):
    """[(module, attribute, value)] that plant ``name``."""
    from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
    from nums_tpu_torch.models import fast_glm

    if name == "step_unchanged":
        def step(kind, X, y, beta, lambda_vec, kernels=False, reduce=None):
            return beta, torch.ones_like(beta)

        return [(fast_glm, "_newton_step_penalized", step)]
    if name == "half_batch_fit":
        def stats(x, y, beta, kind):
            xb = x.rounded() if isinstance(x, cuda_newton.Staged) else x
            h = xb.shape[0] // 2
            g, H = cuda_newton.stats_plain(xb[:h].contiguous(), y[:h],
                                           beta, kind)
            return 2.0 * g, 2.0 * H

        return [(cuda_newton, "stats", stats)]
    if name == "half_batch_gram":
        plain = cuda_gram.gram_plain

        def gram(x, s=None, mode=None):
            return 2.0 * plain(x[:x.shape[0] // 2])

        return [(cuda_gram, "gram", gram)]
    if name == "answer_altered_fit":
        fit = fast_glm.newton_fit

        def altered_fit(*args, **kwargs):
            beta, gmax, it = fit(*args, **kwargs)
            beta = beta.clone()
            beta[0] += 0.05 * beta.abs().max()
            return beta, gmax, it

        return [(fast_glm, "newton_fit", altered_fit)]
    if name == "answer_altered_gram":
        gram = cuda_gram.gram

        def altered_gram(x, s=None, mode=None):
            g = gram(x, s, mode).clone()
            g[0, 1] += 1e-3 * g.abs().max()
            return g

        return [(cuda_gram, "gram", altered_gram)]
    if name == "exchange_left_out":
        return [(fast_glm, "mesh_reduce",
                 lambda mesh, rows: (lambda g, H: (g, H)))]
    if name == "hessian_frozen":
        fit, stats = _frozen(fast_glm, cuda_newton)
        return [(fast_glm, "newton_fit", fit), (cuda_newton, "stats", stats)]
    if name == "hessian_fp8":
        return [(cuda_newton, "stats", _stats_hessian_fp8)]
    if name == "hessian_half_rows":
        return [(cuda_newton, "stats", _stats_hessian_half_rows)]
    raise ValueError(f"no fault {name!r} (have {FAULTS})")


@contextlib.contextmanager
def planted(name):
    """The program with ``name`` planted (nothing for None) inside the
    block, as it was after it."""
    settings = [] if name is None else _settings(name)
    saved = [(m, a, getattr(m, a)) for m, a, _ in settings]
    try:
        for m, a, v in settings:
            setattr(m, a, v)
        yield
    finally:
        for m, a, v in reversed(saved):
            setattr(m, a, v)
