"""Per-panel update steps of the out-of-core (DiskArray) folds.

Counterpart of ``nums_tpu/core/ops/streaming.py``. Each step takes one
row panel, a tensor on the device, and adds its contribution to the
fold's accumulators in place (``add_``), where the reference donates
them to a jitted update; an accumulator belongs to the fold that made it,
and no caller sees it before the fold ends. Device memory stays one panel
plus the accumulators, whatever the number of rows. The reference builds
each step with a cached factory of one static argument (an op, a chunk, a
GLM kind); here that argument is the step's first.

The hand-written kernels take the panels where the reference's Pallas
kernels take them: ``_sym_gram`` (every gram-shaped step) rides the gram
kernel (K1), and ``glm_stats_update_aug`` the Newton statistics kernel
(K3) on the intercept-augmented panel, or, with that gate off, the
weighted gram kernel (K2) for H. On a CPU tensor the kernel wrappers take
their plain versions; otherwise the plain ops run in the panel's dtype
(TF32 off).

On the mesh a panel is row-sharded over the whole mesh (``row_placements``)
and each step runs on this process's rows (``local_rows``), the kernels
on each card's share; the partial sums of a pass meet in one all-reduce
after it (``reduce_rows``), where the reference sums each panel's rows
across the mesh inside its jitted step. A process with no rows of a panel
(an uneven shard can be empty) adds nothing: no kernel is launched on 0
rows, and no min or max is taken of nothing.
"""

import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import cuda_gram, cuda_newton
from nums_tpu_torch.core.ops import linalg as _linalg
from nums_tpu_torch.core.ops import summa


def row_placements(mesh):
    """DTensor placements of a streamed panel on ``mesh``: its rows split
    over every mesh dimension in turn (the reference's panel spec, rows
    over the flattened mesh), every other axis whole."""
    from torch.distributed.tensor import Shard

    return (Shard(0),) * mesh.ndim


def local_rows(panel):
    """This process's rows of a panel (the tensor itself off the mesh)."""
    from torch.distributed.tensor import DTensor

    return panel.to_local() if isinstance(panel, DTensor) else panel


_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


def reduce_rows(mesh, tensors, op="sum"):
    """Combine a pass's partial results over the processes that hold other
    rows of its panels, in place: one all-reduce (``op`` in sum, min, max)
    of ``tensors`` packed in one buffer. Nothing off the mesh or on a mesh
    of one device."""
    import torch.distributed as dist

    if mesh is None or mesh.size() == 1:
        return tensors
    rows = row_placements(mesh)
    red = getattr(dist.ReduceOp, _OPS[op])
    if len(tensors) == 1:
        summa.all_reduce_rows(mesh, rows, tensors[0], red)
        return tensors
    packed = torch.cat([t.reshape(-1) for t in tensors])
    summa.all_reduce_rows(mesh, rows, packed, red)
    at = 0
    for t in tensors:
        t.copy_(packed[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tensors


def augment_ones(x):
    """[x, 1]: the intercept-augmented copy of this process's rows, built
    on their device."""
    out = x.new_empty((x.shape[0], x.shape[1] + 1))
    out[:, :-1] = x
    out[:, -1] = 1
    return out


def _sym_gram(panel):
    """panelᵀ·panel: the gram kernel where its gate is on and it takes the
    panel (any non-empty fp32 2-D tensor), else the plain product."""
    if cuda_gram.enabled() and cuda_gram.supported(tuple(panel.shape),
                                                   panel.dtype):
        return cuda_gram.gram(panel)
    return panel.T @ panel


def gram_update(G, panel):
    """G += panelᵀ panel."""
    return G.add_(_sym_gram(panel))


def gram_and_sum_update(G, s, panel):
    """(G, s) += (panelᵀ panel, panel.sum(0)): the moments of a PCA in one
    pass over the data."""
    G.add_(_sym_gram(panel))
    s.add_(panel.sum(dim=0))
    return G, s


def normal_eq_update(G, b, panel, y_panel):
    """(G, b) += (panelᵀ panel, panelᵀ y_panel): the normal equations."""
    G.add_(_sym_gram(panel))
    b.add_(panel.T @ y_panel)
    return G, b


def _augment_masked(panel, nv):
    """[panel, m] with m_i = 1 for the first ``nv`` rows and 0 for the
    rest: rows past ``nv`` are zero-filled pad rows, and the mask makes
    every contribution of theirs vanish."""
    rows = panel.shape[0]
    mask = torch.arange(rows, device=panel.device) < nv
    return torch.cat([panel, mask.to(panel.dtype)[:, None]], dim=1)


def normal_eq_aug_update(G, q, panel, y_panel, nv):
    """With pa = [panel, 1] (the first ``nv`` rows valid):
    (G, q) += (paᵀ pa, paᵀ y_panel), the moments of the linear ADMM."""
    pa = _augment_masked(panel, nv)
    G.add_(pa.T @ pa)
    q.add_(pa.T @ y_panel)
    return G, q


_REDUCE = {"sum", "min", "max"}


def reduce0_update(op, acc, panel):
    """acc = combine(acc, reduce(panel, axis=0)) for ``op`` in sum, min,
    max."""
    if op == "sum":
        return acc.add_(panel.sum(dim=0, dtype=acc.dtype))
    if op == "min":
        return torch.minimum(acc, panel.amin(dim=0), out=acc)
    if op == "max":
        return torch.maximum(acc, panel.amax(dim=0), out=acc)
    raise ValueError(f"reduce0_update: {op!r} not in {sorted(_REDUCE)}")


def tsqr_r_update(chunk, R, panel):
    """R of qr([R; panel]): the Householder combine, stable at any
    conditioning. Returns a new R."""
    return _linalg._tsqr_r_impl(torch.cat([R, panel], dim=0), chunk)


def tsqr_r_combine(mesh, chunk, R):
    """The R of the whole matrix from each process's R of its own rows:
    the R's of every process gathered, stacked in rank order and factored
    once, the same on every process. ``R`` itself off the mesh or on a
    mesh of one device."""
    import torch.distributed as dist

    if mesh is None or mesh.size() == 1:
        return R
    parts = [torch.empty_like(R) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, multiprocess.sent("all_gather", R.contiguous()))
    return _linalg._tsqr_r_impl(torch.cat(parts, dim=0), chunk)


def _mean_weight(kind, eta):
    """(mu, s) of a GLM kind at eta: the mean and the Hessian weight."""
    if kind == "logistic":
        mu = torch.sigmoid(eta)
        return mu, mu * (1.0 - mu)
    if kind == "linear":
        return eta, torch.ones_like(eta)
    if kind == "poisson":
        mu = torch.exp(eta)
        return mu, mu
    raise ValueError(kind)


def glm_stats_update(kind, g, H, panel, y_panel, beta, nv):
    """Newton statistics of one panel, intercept-augmented here with the
    row mask (the first ``nv`` rows valid):
    g += [p, 1]ᵀ(mu − y);  H += ([p, 1]·s)ᵀ[p, 1]; plain ops."""
    pa = _augment_masked(panel, nv)
    mu, s = _mean_weight(kind, pa @ beta)
    g.add_(pa.T @ (mu - y_panel))
    H.add_((pa * s[:, None]).T @ pa)
    return g, H


def glm_stats_update_aug(kind, g, H, pa, y_panel, beta):
    """``glm_stats_update`` for a panel that arrives intercept-augmented
    (``ooc_put(..., augment_ones=True)``; the serial backend has no pad
    rows). With the Newton gate on, K3 in its one-shot form,
    ``cuda_newton.stats(pa, …)``, which stages the panel; else g in plain
    ops and H on the gram kernel where its gate is on (K2 with the weight
    s, K1 for the linear kind, whose weight is 1); else plain ops."""
    shape = tuple(pa.shape)
    if cuda_newton.enabled() and cuda_newton.supported(shape, pa.dtype):
        pg, pH = cuda_newton.stats(pa, y_panel, beta, kind)
        g.add_(pg)
        H.add_(pH)
        return g, H
    mu, s = _mean_weight(kind, pa @ beta)
    g.add_(pa.T @ (mu - y_panel))
    if cuda_gram.enabled() and cuda_gram.supported(shape, pa.dtype):
        H.add_(cuda_gram.gram(pa, None if kind == "linear" else s))
    elif kind == "linear":
        H.add_(pa.T @ pa)
    else:
        H.add_((pa * s[:, None]).T @ pa)
    return g, H


def newton_update(penalized, beta, g, H, lambda_vec):
    """beta' = beta − (H + diag(λ))⁻¹(g + λ∘beta) when ``penalized``, else
    beta − H⁻¹g. Returns (beta', max|g|), g with its penalty term."""
    if penalized:
        g = g + lambda_vec * beta
        H = H + torch.diag(lambda_vec)
    return beta - _linalg.posdef_solve(H, g), g.abs().max()
