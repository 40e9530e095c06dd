"""Gradient-boosted trees (histogram GBDT, oblivious trees).

Counterpart of ``nums_tpu/models/trees.py``:

- **Oblivious (symmetric) trees**: every level applies ONE shared
  (feature, bin-threshold) split, so a depth-D tree is a decision table
  with 2^D leaves and a sample's leaf index is D vectorized comparisons.
- **Histogram splits**: per level, the (leaf × feature × bin) gradient
  and hessian histograms over the whole sample axis; the split gain is
  the closed-form cumsum scan (second-order gain with L2
  regularization), the split the first index of the largest gain summed
  over the level's leaves; Newton leaf values.
- **Binning**: quantile edges at the reference's float64 positions, then
  one batched ``torch.searchsorted`` (side left) over the transposed
  edges.

The reference compiles a whole fit into one XLA program; here a fit is
an eager loop over rounds and levels with no host sync. Its histogram is
one scatter-add of n·d (g, h) pairs per level; float atomics would make
it unrepeatable, and a one-ulp change flips near-tied gains. Here every
scatter-add is ``index_put_`` with ``accumulate=True`` under torch's
deterministic algorithms (``_segment_sum``): on the card it sorts the
keys (stably) and sums each cell in row order, as the CPU's serial loop
does, so a fit is bitwise repeatable and its histograms are the CPU
route's.

Objectives: squared error (regression) and logistic (binary
classification; multiclass by one-vs-rest in ``GBTClassifier``).
"""

import contextlib

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.grid import ArrayGrid

__all__ = ["GBTRegressor", "GBTClassifier", "GradientBoostedTrees"]


@contextlib.contextmanager
def _deterministic():
    """torch's deterministic algorithms for the enclosed calls only (the
    switch is process-wide: another thread's ops run under it meanwhile)."""
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn)


def _segment_sum(idx, vals, size):
    """(size, *vals.shape[1:]) sums of ``vals`` rows by ``idx``, each cell
    summed in row order (see the module docstring)."""
    out = torch.zeros((size,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    with _deterministic():
        out.index_put_((idx,), vals, accumulate=True)
    return out


def _rows(X):
    """(this process's rows of X as float32, the row dimensions to sum
    over, the backend) on the mesh (every column of each process's rows);
    (X's tensor, None, None) on one device."""
    from nums_tpu_torch.core.ops import mesh_ops, summa

    xd = X.data
    if not mesh_ops.is_dtensor(xd):
        return xd.to(torch.float32), None, None
    rows = summa.row_layout(xd)
    return (summa.local_part(xd, rows).to(torch.float32),
            mesh_ops.shard_dims(rows, (0,)), X.backend)


def _local_rows(y, like):
    """This process's part of the 1-D DTensor ``y`` on the rows that it
    holds of the 2-D ``like`` (the same length); ``y`` on one device."""
    from nums_tpu_torch.core.ops import mesh_ops, summa

    if not mesh_ops.is_dtensor(y):
        return y
    return summa.local_part(y, mesh_ops.rows_only(summa.row_layout(like)))


def _rows_out(backend, local, like):
    """A result of this process's rows (``local``, laid out as ``like``'s
    rows) as a DTensor of every row; ``local`` itself on one device."""
    from nums_tpu_torch.core.ops import mesh_ops, summa

    if backend is None:
        return local
    rows = mesh_ops.rows_only(summa.row_layout(like))
    shape = (int(like.shape[0]),) + tuple(local.shape[1:])
    return backend.from_local(local.contiguous(), shape, rows)


def _quantile_edges(x, n_bins, n=None, dims=None, backend=None):
    """(n_bins-1, d) per-feature bin edges from quantiles, in x's dtype:
    the reference's ``jnp.percentile(x, linspace(0, 100, n_bins + 1)[1:-1],
    axis=0)`` as XLA compiles it with x64 on, its positions
    ``q·(0.01·(n − 1))`` in float64 (it folds ``q / 100 · (n − 1)`` so),
    the linear interpolation in float64; a column holding a NaN gives NaN
    edges."""
    from nums_tpu_torch.numpy import extra

    ends = torch.tensor([0.0, 100.0], dtype=torch.float64)
    qs = extra._linspace(ends[0], ends[1], n_bins + 1, torch.float64,
                         "cpu")[1:-1].numpy()
    n = int(x.shape[0]) if n is None else int(n)
    pos = qs * (0.01 * (n - 1))
    low = np.clip(np.floor(pos), 0, n - 1)
    high = np.clip(np.ceil(pos), 0, n - 1)
    high_w = pos - np.floor(pos)
    low_w = 1 - high_w

    def col(v):
        return torch.as_tensor(v, device=x.device)[:, None]

    if backend is not None:
        # on the mesh: the order statistics of each column over the
        # processes' rows (``mesh_ops.select_ranks``); no row moves
        from nums_tpu_torch.core.ops import mesh_ops

        d = int(x.shape[1])
        ranks = torch.as_tensor(np.concatenate([low, high]).astype(
            np.int64), device=x.device)[:, None].expand(-1, d)
        vals = mesh_ops.select_ranks(backend, x.T.contiguous(), ranks,
                                     dims).to(torch.float64)
        nan = torch.isnan(x).any(dim=0).to(torch.int64)
        mesh_ops.group_reduce(backend, nan, dims, "max")
        k = len(low)
        out = (vals[:k] * col(low_w) + vals[k:] * col(high_w)).to(x.dtype)
        return torch.where(nan.to(torch.bool)[None, :],
                           torch.full_like(out, float("nan")), out)
    s = torch.sort(x, dim=0).values
    s = torch.where(torch.isnan(x).any(dim=0, keepdim=True),
                    torch.full_like(s, float("nan")), s)
    low_v = s[col(low.astype(np.int64))[:, 0]].to(torch.float64)
    high_v = s[col(high.astype(np.int64))[:, 0]].to(torch.float64)
    return (low_v * col(low_w) + high_v * col(high_w)).to(x.dtype)


def _bin_features(x, edges):
    """(n, d) int32 bin ids: per feature, the number of edges below the
    value (``searchsorted``, side left)."""
    e = edges.T.contiguous()
    xt = x.T.to(e.dtype).contiguous()
    return torch.searchsorted(e, xt).T.to(torch.int32).contiguous()


def _grad_hess(pred, y, objective):
    if objective == "logistic":
        p = torch.sigmoid(pred)
        return p - y, p * (1.0 - p)
    return pred - y, torch.ones_like(pred)  # squared error


def _level_gain(gh, lam):
    """(d·B,) gain of each (feature, bin) split of a level from its
    (L, d, B, 2) histograms: the cumsum scan's second-order gain, summed
    over the level's leaves (oblivious: one split shared by all)."""
    cum_g = torch.cumsum(gh[..., 0], dim=2)  # (L, d, B)
    cum_h = torch.cumsum(gh[..., 1], dim=2)
    tot_g = cum_g[..., -1:]
    tot_h = cum_h[..., -1:]
    gl, hl = cum_g, cum_h
    gr, hr = tot_g - cum_g, tot_h - cum_h
    gain = (gl * gl / (hl + lam) + gr * gr / (hr + lam)
            - tot_g * tot_g / (tot_h + lam))
    return gain.sum(dim=0).reshape(-1)


def _train(xb, y, base_score, n_estimators, max_depth, n_bins, objective,
           learning_rate, reg_lambda, reduce=multiprocess.one_process):
    """(feats, cuts, leaf_vals, pred) of a fit: (T, D) int32, (T, D)
    int32, (T, 2^D) float32 and the training predictions. With ``reduce``
    (on the mesh: ``xb`` and ``y`` are one process's rows) each level's
    histograms and each tree's leaf sums are summed over the processes, so
    every process takes the same splits."""
    n, d = (int(v) for v in xb.shape)
    dev = xb.device
    n_leaves = 1 << max_depth
    lr = float(learning_rate)
    lam = float(reg_lambda)
    xb64 = xb.to(torch.int64)
    cols = torch.arange(d, dtype=torch.int64, device=dev)
    pred = torch.full((n,), float(base_score), dtype=torch.float32,
                      device=dev)
    all_feats, all_cuts, all_vals = [], [], []
    for _ in range(n_estimators):
        g, h = _grad_hess(pred, y, objective)
        gh_rows = torch.stack([g, h], dim=1)  # (n, 2)
        leaf = torch.zeros(n, dtype=torch.int64, device=dev)
        feats, cuts = [], []
        for lvl in range(max_depth):
            width = 1 << lvl
            # Every (leaf, feature, bin) cell at once: index (n, d) ->
            # flat (leaf*d + j)*n_bins + bin.
            idx = ((leaf[:, None] * d + cols[None, :]) * n_bins
                   + xb64).reshape(-1)
            vals = gh_rows[:, None, :].expand(n, d, 2).reshape(-1, 2)
            gh = reduce(_segment_sum(idx, vals, width * d * n_bins))
            gain = _level_gain(gh.reshape(width, d, n_bins, 2), lam)
            best = torch.argmax(gain)
            j = best // n_bins
            b = best % n_bins
            feats.append(j)
            cuts.append(b)
            go_right = (xb64.index_select(1, j.reshape(1))[:, 0] > b)
            leaf = leaf * 2 + go_right.to(torch.int64)
        # Newton leaf values from per-leaf grad/hess sums.
        sums = reduce(_segment_sum(leaf, gh_rows, n_leaves))
        leaf_vals = -lr * sums[:, 0] / (sums[:, 1] + lam)
        pred = pred + leaf_vals[leaf]
        all_feats.append(torch.stack(feats))
        all_cuts.append(torch.stack(cuts))
        all_vals.append(leaf_vals)
    return (torch.stack(all_feats).to(torch.int32),
            torch.stack(all_cuts).to(torch.int32),
            torch.stack(all_vals), pred)


def _predict(xb, base_score, feats, cuts, leaf_vals):
    """Raw scores of the decision tables, the trees added in order."""
    n = int(xb.shape[0])
    t, depth = (int(v) for v in feats.shape)
    feats = feats.to(device=xb.device, dtype=torch.int64)
    cuts = cuts.to(device=xb.device, dtype=torch.int32)
    leaf_vals = leaf_vals.to(device=xb.device, dtype=torch.float32)
    go = (xb.index_select(1, feats.reshape(-1)).view(n, t, depth)
          > cuts[None]).to(torch.int64)
    weights = 1 << torch.arange(depth - 1, -1, -1, device=xb.device)
    leaf = (go * weights).sum(dim=2)  # (n, T)
    vals = torch.gather(leaf_vals.T, 0, leaf)  # (n, T): tree t's value
    pred = torch.full((n,), float(base_score), dtype=torch.float32,
                      device=xb.device)
    for i in range(t):
        pred = pred + vals[:, i]
    return pred


def _as_ba(x, app):
    return x if isinstance(x, BlockArray) else app.array(np.asarray(x))


class GradientBoostedTrees:
    """Histogram GBDT over BlockArrays; fit and predict run on the
    backend's device with no host sync."""

    def __init__(self, objective="squared", n_estimators=20, max_depth=4,
                 learning_rate=0.2, n_bins=64, reg_lambda=1.0):
        assert objective in ("squared", "logistic"), objective
        assert 1 <= max_depth <= 10
        self.objective = objective
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.learning_rate = float(learning_rate)
        self.n_bins = int(n_bins)
        self.reg_lambda = float(reg_lambda)
        self._edges = None
        self._trees = None
        self._base = 0.0

    def fit(self, X: BlockArray, y: BlockArray, _binned=None):
        """``_binned=(edges, xb)`` lets one-vs-rest ensembles share the
        y-independent quantile edges + int binning across members."""
        from nums_tpu_torch.core.ops import mesh_ops

        app = _instance()
        X, y = _as_ba(X, app), _as_ba(y, app)
        xd, dims, backend = _rows(X)
        yd = _local_rows(y.data, X.data).to(torch.float32)
        reduce = multiprocess.one_process if backend is None else (
            lambda t: mesh_ops.group_reduce(backend, t, dims))
        if self.objective == "logistic":
            self._base = 0.0
        elif backend is None:
            self._base = float(yd.mean())
        else:
            self._base = float(reduce(yd.sum().reshape(1))[0]) / X.shape[0]
        if _binned is not None:
            self._edges, xb = _binned
        else:
            self._edges = _quantile_edges(xd, self.n_bins, X.shape[0], dims,
                                          backend)
            xb = _bin_features(xd, self._edges)
        feats, cuts, leaf_vals, _ = _train(
            xb, yd, self._base, self.n_estimators, self.max_depth,
            self.n_bins, self.objective, self.learning_rate,
            self.reg_lambda, reduce,
        )
        self._trees = (feats, cuts, leaf_vals)
        return self

    def _raw_predict(self, X: BlockArray, _xb=None):
        assert self._trees is not None, "fit must be called before predict"
        if _xb is None:
            xd, _, _ = _rows(X)
            _xb = _bin_features(xd, self._edges.to(xd.device))
        return _predict(_xb, self._base, *self._trees)

    def _wrap(self, X, data):
        grid = ArrayGrid((X.shape[0],), (X.block_shape[0],),
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, X.backend)

    def predict(self, X: BlockArray) -> BlockArray:
        pred = self._raw_predict(X)
        if self.objective == "logistic":
            pred = (torch.sigmoid(pred) > 0.5).to(torch.int64)
        return self._wrap(X, _rows_out(_rows(X)[2], pred, X.data))

    def predict_proba(self, X: BlockArray) -> BlockArray:
        assert self.objective == "logistic"
        return self._wrap(X, _rows_out(_rows(X)[2], torch.sigmoid(
            self._raw_predict(X)), X.data))

    def _arrays(self, suffix=""):
        feats, cuts, leaf_vals = self._trees
        return {f"edges{suffix}": self._edges.cpu().numpy(),
                f"feats{suffix}": feats.cpu().numpy(),
                f"cuts{suffix}": cuts.cpu().numpy(),
                f"leaf_vals{suffix}": leaf_vals.cpu().numpy()}

    def _set_arrays(self, arrays, device, suffix=""):
        def t(name):
            return torch.as_tensor(arrays[name + suffix], device=device)

        self._edges = t("edges")
        self._trees = (t("feats"), t("cuts"), t("leaf_vals"))

    def save(self, path: str):
        from nums_tpu_torch.models._common import save_model_arrays

        assert self._trees is not None, "fit before save"
        save_model_arrays(
            path,
            {"model": type(self).__name__, "objective": self.objective,
             "n_estimators": self.n_estimators,
             "max_depth": self.max_depth,
             "learning_rate": self.learning_rate, "n_bins": self.n_bins,
             "reg_lambda": self.reg_lambda, "base": self._base},
            self._arrays(),
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu_torch.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        m = cls(objective=meta["objective"],
                n_estimators=meta["n_estimators"],
                max_depth=meta["max_depth"],
                learning_rate=meta["learning_rate"],
                n_bins=meta["n_bins"], reg_lambda=meta["reg_lambda"])
        m._base = meta["base"]
        m._set_arrays(arrays, _instance().backend.device)
        return m


class GBTRegressor(GradientBoostedTrees):
    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "squared")
        super().__init__(**kwargs)


class GBTClassifier(GradientBoostedTrees):
    """Binary natively; MULTICLASS via one-vs-rest (one booster per
    class, sigmoid scores normalized, argmax decision — sklearn's OvR
    semantics). ``classes_`` carries the original labels."""

    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "logistic")
        super().__init__(**kwargs)
        self.classes_ = None
        self._ovr = None

    def _params(self):
        return dict(
            objective="logistic", n_estimators=self.n_estimators,
            max_depth=self.max_depth, learning_rate=self.learning_rate,
            n_bins=self.n_bins, reg_lambda=self.reg_lambda,
        )

    def fit(self, X, y):
        app = _instance()
        X = _as_ba(X, app)
        bs = (X.block_shape[0],)
        if X.backend.mesh is not None:
            # the labels stay on the mesh: their distinct values by the
            # mesh's unique, each class's indicator elementwise
            import nums_tpu_torch.numpy as nps

            yb_all = _as_ba(y, app)
            self.classes_ = np.asarray(nps.unique(yb_all).get())

            def indicator(c):
                return (yb_all == c).astype(np.float64)
        else:
            y_host = np.asarray(y.get() if hasattr(y, "get") else y)
            self.classes_ = np.unique(y_host)

            def indicator(c):
                return app.array((y_host == c).astype(np.float64),
                                 block_shape=bs)
        if len(self.classes_) < 2:
            raise ValueError(
                "y contains a single class; classification needs >= 2."
            )
        if len(self.classes_) <= 2:
            self._ovr = None
            super().fit(X, indicator(self.classes_[-1]))
            return self
        # Edges + binning depend only on X: compute once and share
        # across the per-class members.
        xd, dims, backend = _rows(X)
        edges = _quantile_edges(xd, self.n_bins, X.shape[0], dims, backend)
        xb = _bin_features(xd, edges)
        self._ovr = []
        for c in self.classes_:
            m = GradientBoostedTrees(**self._params())
            m.fit(X, indicator(c), _binned=(edges, xb))
            self._ovr.append(m)
        return self

    def _ovr_scores(self, X):
        """(n, K) sigmoid scores of the members (binned once: they share
        edges)."""
        xd, _, _ = _rows(X)
        xb = _bin_features(xd, self._ovr[0]._edges.to(xd.device))
        return torch.stack(
            [torch.sigmoid(m._raw_predict(X, _xb=xb)) for m in self._ovr],
            dim=1)

    def predict(self, X):
        app = _instance()
        X = _as_ba(X, app)
        if self._ovr is None:
            idx = _local_rows(super().predict(X).data, X.data)
        else:
            idx = self._ovr_scores(X).argmax(dim=1)
        backend = _rows(X)[2]
        if backend is not None:
            # each process maps its own rows' indices to the labels
            classes = np.asarray(self.classes_)
            table = torch.as_tensor(classes.astype(backend.device_dtype(
                classes.dtype)), device=idx.device)
            return BlockArray(
                _rows_out(backend, table[idx.to(torch.int64)], X.data),
                ArrayGrid((X.shape[0],), (X.block_shape[0],),
                          array_utils.to_dtype_name(table.dtype)),
                X.backend)
        return app.array(
            self.classes_[idx.cpu().numpy()],
            block_shape=(X.block_shape[0],),
        )

    def predict_proba(self, X):
        app = _instance()
        X = _as_ba(X, app)
        if self._ovr is None:
            p1 = torch.sigmoid(self._raw_predict(X))
            out = torch.stack([1.0 - p1, p1], dim=1)
        else:
            scores = self._ovr_scores(X)
            out = scores / scores.sum(dim=1, keepdim=True)
        return BlockArray.from_torch(
            _rows_out(_rows(X)[2], out, X.data),
            block_shape=(X.block_shape[0], int(out.shape[1])),
            backend=X.backend)

    def save(self, path: str):
        from nums_tpu_torch.models._common import save_model_arrays

        if self._ovr is None:
            assert self._trees is not None, "fit before save"
            save_model_arrays(
                path,
                {**self._params(), "model": "GBTClassifier",
                 "classes": np.asarray(self.classes_).tolist(),
                 "base": self._base},
                self._arrays(),
            )
            return
        arrays = {}
        for i, m in enumerate(self._ovr):
            arrays.update(m._arrays(str(i)))
        save_model_arrays(
            path,
            {**self._params(), "model": "GBTClassifier",
             "classes": np.asarray(self.classes_).tolist(), "base": 0.0},
            arrays,
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu_torch.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        assert meta["model"] == "GBTClassifier", meta
        m = cls(n_estimators=meta["n_estimators"],
                max_depth=meta["max_depth"],
                learning_rate=meta["learning_rate"],
                n_bins=meta["n_bins"], reg_lambda=meta["reg_lambda"])
        m.classes_ = np.asarray(meta["classes"])
        device = _instance().backend.device
        if "edges" in arrays:  # binary
            m._base = meta["base"]
            m._set_arrays(arrays, device)
            m._ovr = None
            return m
        m._ovr = []
        for i in range(len(m.classes_)):
            sub = GradientBoostedTrees(**m._params())
            sub._base = 0.0
            sub._set_arrays(arrays, device, str(i))
            m._ovr.append(sub)
        return m
