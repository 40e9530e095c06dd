"""Clustering: KMeans (Lloyd's), in core and out of core.

Counterpart of ``nums_tpu/models/cluster.py``:

- The distance matrix is ||x||² − 2·X@Cᵀ + ||c||², the O(n·k·d) term one
  fp32 product per iteration (TF32 off); ||x||² is computed once per fit,
  a row chunk at a time (no n×d temporary).
- The center sums are the product of the one-hot assignment and X, in
  float64 a row chunk at a time, where the reference scatter-adds rows in
  fp32 (``.at[assign].add(x)``): on the card a scatter-add of n·d values
  into k·d addresses is that many float atomics, slow and not repeatable
  bit for bit. In float64 the sums do not depend on how the rows are
  split, so a fit streamed panel by panel moves its centers as the
  in-core fit does; in fp32 the two part by an ulp, and on data without
  clusters the next assignment flips near-tied rows. The counts are
  exact integer counts.
- The fit is an eager loop over Lloyd iterations with the reference's
  stop test (``it < max_iter`` and the largest center shift above tol)
  and its empty-cluster rule (keep the previous center); the shift is
  read on the host once per iteration, where the reference's
  ``while_loop`` syncs never.
- The inertia against the final centers sums ||x − c||² from the
  differences, where the reference sums the expansion's distances: on
  clusters far from the origin the expansion cancels, and its sum drifts
  from the float64 inertia by far more than fp32 rounding.
- k-means++ seeding draws on the port's threefry engine with the
  reference's keys (``jr.key(seed)``, ``fold_in``, ``randint``, the
  Gumbel-max trick), so that a seed picks the reference's centers.
"""

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import elementwise, random_ops, threefry

__all__ = ["KMeans"]

# Rows of X squared and summed at a time for ||x||².
_NORM_CHUNK_ROWS = 1 << 18


def _row_sq_norms(x):
    """(n, 1) ||x||², a row chunk at a time."""
    return torch.cat([(c * c).sum(dim=1, keepdim=True)
                      for c in torch.split(x, _NORM_CHUNK_ROWS)])


def _dists2(x, c, xx=None):
    """(n, k) squared distances, clamped at 0 (the reference's
    ``_dists2``)."""
    if xx is None:
        xx = _row_sq_norms(x)
    cc = (c * c).sum(dim=1)
    return torch.clamp_min(xx - 2.0 * (x @ c.T) + cc[None, :], 0.0)


def _x64(backend) -> bool:
    """Draw as the reference with x64 on (the CPU) or off (the card)."""
    return backend.default_float == np.float64


class _Rows:
    """Where a fit's rows lie: ``x`` holds rows ``[r0, r0 + len(x))`` of
    ``n``, and the hooks that join the processes that hold the others.
    Off the mesh (``backend`` None) every row is here and each hook is the
    serial step itself; on the mesh the sums, the argmax and a chosen row
    go over the processes of the row dimensions ``dims``."""

    def __init__(self, n, r0=0, backend=None, dims=()):
        self.n, self.r0, self.backend, self.dims = int(n), int(r0), \
            backend, tuple(dims)

    def reduce(self, t, op="sum"):
        """``t`` replaced in place by its ``op`` over the processes."""
        from nums_tpu_torch.core.ops import mesh_ops

        if self.backend is None:
            return t
        return mesh_ops.group_reduce(self.backend, t, self.dims, op)

    def argmax(self, score):
        """The row of the largest ``score`` (this process's rows), the
        first on ties, as ``argmax`` over every row: one all-reduce (MAX)
        of the value and one (MIN) of the rows that hold it."""
        if self.backend is None:
            return torch.argmax(score)
        big = torch.iinfo(torch.int64).max
        if score.numel():
            j = torch.argmax(score)
            v = score[j].reshape(1)
            row = (j + self.r0).reshape(1).to(torch.int64)
        else:
            v = torch.full((1,), float("-inf"), dtype=score.dtype,
                           device=score.device)
            row = torch.full((1,), big, dtype=torch.int64,
                             device=score.device)
        top = self.reduce(v.clone(), "max")
        row = torch.where(v == top, row, torch.full_like(row, big))
        return int(self.reduce(row, "min")[0])

    def row(self, x, i):
        """Row ``i`` (of all ``n``) on every process: its holder offers it,
        the others zeros, and one all-reduce (SUM) adds them (exactly)."""
        if self.backend is None:
            return x[i.to(torch.int64)]
        i = int(i)
        out = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        if self.r0 <= i < self.r0 + x.shape[0]:
            out[0] = x[i - self.r0]
        return self.reduce(out)[0]

    def flat_range(self, m):
        """This process's positions of a draw over every row (None: all)."""
        return None if m == self.n else (self.r0, self.r0 + m)


def _plusplus_init(k, seed, x, xx, x64, rows=None):
    """k-means++ on the reference's draws: the first center at
    ``randint(fold_in(key, 0), (), 0, n)``, center i at the argmax of
    log(d²) plus ``gumbel(fold_in(key, i), (n,))``. ``rows`` (``_Rows``)
    says which rows ``x`` holds; the centers are the same on every
    process."""
    rows = rows or _Rows(x.shape[0])
    n, m = rows.n, int(x.shape[0])
    key = threefry.seed_key(seed, x64)
    int_dtype = torch.int64 if x64 else torch.int32
    first = random_ops.jr_randint(threefry.fold_in(key, 0), (), 0, n,
                                  int_dtype, x.device, x64)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = rows.row(x, first)
    slots = torch.arange(k, device=x.device)
    for i in range(1, k):
        d2 = _dists2(x, centers, xx)
        # distance to the nearest ALREADY-CHOSEN center (j < i)
        d2 = torch.where((slots < i)[None, :], d2,
                         torch.full_like(d2, float("inf"))).amin(dim=1)
        logits = torch.log(torch.clamp_min(d2, 1e-30))
        gumbel = random_ops.jr_gumbel(threefry.fold_in(key, i), (n,),
                                      x.dtype, x.device,
                                      flat_range=rows.flat_range(m))
        centers[i] = rows.row(x, rows.argmax(logits + gumbel))
    return centers


def _inertia(x, centers, assign):
    """Σ ||x − c_assign||², from the differences a row chunk at a time:
    the expansion's ||x||² − 2x·c + ||c||² cancels where the centers lie
    far from the origin."""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for xc, ac in zip(torch.split(x, _NORM_CHUNK_ROWS),
                      torch.split(assign, _NORM_CHUNK_ROWS)):
        diff = xc - centers[ac]
        total = total + (diff * diff).sum()
    return total


def _assign_stats(x, centers, k, xx=None):
    """(assign, sums, counts) of one Lloyd step: the float64 sums as the
    one-hot product a row chunk at a time, the counts exact (float64)."""
    assign = torch.argmin(_dists2(x, centers, xx), dim=1)
    slots = torch.arange(k, device=x.device)[None, :]
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64,
                       device=x.device)
    for xc, ac in zip(torch.split(x, _NORM_CHUNK_ROWS),
                      torch.split(assign, _NORM_CHUNK_ROWS)):
        onehot = (ac[:, None] == slots).to(torch.float64)
        sums += onehot.T @ xc.to(torch.float64)
    counts = torch.bincount(assign, minlength=k).to(torch.float64)
    return assign, sums, counts


def _update(centers, sums, counts):
    """New centers in the centers' dtype (an empty cluster keeps its
    center) and the largest center shift."""
    means = (sums / torch.clamp_min(counts[:, None], 1.0)).to(centers.dtype)
    new = torch.where(counts[:, None] > 0, means, centers)
    shift = torch.sqrt(((new - centers) ** 2).sum(dim=1)).max()
    return new, shift


def _fit(x, k, max_iter, tol, seed, x64, rows=None):
    """(centers, assign, inertia, n_iter) of the in-core fit; ``rows``
    (``_Rows``) as ``_plusplus_init``'s, the Lloyd sums, counts and
    inertia summed over the processes."""
    rows = rows or _Rows(x.shape[0])
    xx = _row_sq_norms(x)
    centers = _plusplus_init(k, seed, x, xx, x64, rows)
    it = 0
    while it < max_iter:
        _, sums, counts = _assign_stats(x, centers, k, xx)
        centers, shift = _update(centers, rows.reduce(sums),
                                 rows.reduce(counts))
        it += 1
        if not bool(shift > tol):
            break
    assign = torch.argmin(_dists2(x, centers, xx), dim=1)
    inertia = rows.reduce(_inertia(x, centers, assign).reshape(1))[0]
    return centers, assign, inertia, it


def _labels(assign, backend):
    """Labels in the reference's dtype: its default int."""
    return assign.to(elementwise.default_int(
        array_utils.to_torch_dtype(backend.default_float)))


class KMeans:
    def __init__(self, n_clusters=8, max_iter=100, tol=1e-4, seed=0):
        self.n_clusters = int(n_clusters)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.cluster_centers_ = None
        self.inertia_ = None
        self.n_iter_ = None

    def fit(self, X: BlockArray):
        from nums_tpu_torch.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self._fit_ooc(X)
        app = _instance()
        X = X if isinstance(X, BlockArray) else app.array(np.asarray(X))
        xd = X.data.to(torch.float32)
        if X.backend.mesh is None:
            x, rows = xd, _Rows(X.shape[0])
        else:  # each process its own rows, every column
            from nums_tpu_torch.core.ops import mesh_ops, summa

            lay = summa.row_layout(xd)
            x = summa.local_part(xd, lay)
            rows = _Rows(X.shape[0],
                         X.backend.region(tuple(xd.shape), lay)[0][0],
                         X.backend, mesh_ops.shard_dims(lay, (0,)))
        centers, assign, inertia, it = _fit(
            x, self.n_clusters, self.max_iter, self.tol, self.seed,
            _x64(X.backend), rows)
        if X.backend.mesh is not None:
            assign = X.backend.from_local(assign, (X.shape[0],),
                                          mesh_ops.rows_only(lay))
        self.cluster_centers_ = BlockArray.from_torch(centers,
                                                      backend=X.backend)
        self.inertia_ = float(inertia)
        self.n_iter_ = int(it)
        self._labels_data = _labels(assign, X.backend)
        # labels_ only needs the row grid + backend — pinning X itself
        # would keep the full training tensor alive on the model object.
        self._fit_grid = (X.shape[0], X.block_shape[0], X.backend)
        return self

    def _fit_ooc(self, X):
        """Streamed Lloyd's on a DiskArray: each iteration runs one pass
        over the row panels, accumulating per-cluster sums and counts.
        Seeding is k-means++ on the FIRST panel; one scalar (shift) sync
        per pass, and one more pass for the final inertia. Labels come
        from ``predict_ooc``. On the mesh every process seeds from the
        whole first panel and takes process 0's centers (the carry is
        replicated, bit for bit); each pass adds each process's rows and
        ends in one all-reduce of the sums, counts and inertia."""
        from nums_tpu_torch.core import multiprocess
        from nums_tpu_torch.core.array.application import (
            _device_dtype, ooc_accumulator, ooc_panels, ooc_put,
        )
        from nums_tpu_torch.core.ops import streaming

        k = self.n_clusters
        backend = X.backend
        first = next(iter(X.iter_row_panels(prefetch=False)))[1]
        sample = torch.from_numpy(np.ascontiguousarray(first)).to(
            backend.device).to(_device_dtype(backend, first.dtype))
        del first
        sample = sample.to(torch.float32)
        assert sample.shape[0] >= k, "first panel smaller than n_clusters"
        centers = _plusplus_init(k, self.seed, sample,
                                 _row_sq_norms(sample), _x64(backend))
        del sample
        if backend.mesh is not None:
            multiprocess.broadcast_from_zero(centers)
        d = X.shape[1]

        def one_pass(centers, with_inertia=False):
            sums = ooc_accumulator(backend, np.zeros((k, d), np.float64))
            counts = ooc_accumulator(backend, np.zeros((k,), np.float64))
            inertia = ooc_accumulator(backend, np.zeros((), np.float32))
            for _, panel in ooc_panels(X):
                p, _ = ooc_put(backend, panel)
                p = streaming.local_rows(p).to(torch.float32)
                if not p.shape[0]:
                    continue
                assign, s, c = _assign_stats(p, centers, k)
                sums, counts = sums + s, counts + c
                if with_inertia:
                    inertia = inertia + _inertia(p, centers, assign)
            streaming.reduce_rows(backend.mesh, [sums, counts])
            streaming.reduce_rows(backend.mesh, [inertia])
            return sums, counts, inertia

        it = 0
        for it in range(1, self.max_iter + 1):
            sums, counts, _ = one_pass(centers)
            centers, shift = _update(centers, sums, counts)
            if float(shift) <= self.tol:
                break
        # Final inertia against the FINAL centers (sklearn semantics).
        _, _, inertia = one_pass(centers, with_inertia=True)
        self.cluster_centers_ = BlockArray.from_torch(centers,
                                                      backend=backend)
        self.inertia_ = float(inertia)
        self.n_iter_ = int(it)
        self._labels_data = None
        self._fit_grid = None
        return self

    def predict_ooc(self, X, out: str = None):
        """Labels for a DiskArray, written as a 1-D int32 DiskArray."""
        from nums_tpu_torch.core.array.application import (
            gather_rows, ooc_panels, ooc_put,
        )
        from nums_tpu_torch.core.array.diskarray import DiskArray
        from nums_tpu_torch.core.ops import streaming

        assert self.cluster_centers_ is not None, "fit first"
        backend = X.backend
        centers = self._centers_data().to(device=backend.device,
                                          dtype=torch.float32)
        out = out or X.path + ".labels"

        def panels():
            # On the mesh each process labels its own rows; the labels
            # are gathered for the collective from_panels.
            for _, panel in ooc_panels(X):
                p, rows = ooc_put(backend, panel)
                x = streaming.local_rows(p).to(torch.float32)
                lab = torch.argmin(_dists2(x, centers), dim=1)
                yield gather_rows(backend, lab.to(torch.int32), (rows,))

        return DiskArray.from_panels(
            out, X._fs, panels(), (X.shape[0],), np.int32,
            X.grid.block_shape[0],
        )

    def _centers_data(self):
        """The fitted centers as one plain tensor (whole on every process
        of a mesh)."""
        from torch.distributed.tensor import DTensor

        c = self.cluster_centers_.data
        return c.full_tensor() if isinstance(c, DTensor) else c

    @property
    def labels_(self):
        assert self._labels_data is not None, (
            "labels_ requires an in-core fit in this process; use "
            "predict(X) (in-core) or predict_ooc(X, out=...) instead."
        )
        n, block_rows, backend = self._fit_grid
        grid = ArrayGrid((n,), (block_rows,),
                         array_utils.to_dtype_name(self._labels_data.dtype))
        return BlockArray(self._labels_data, grid, backend)

    def predict(self, X: BlockArray) -> BlockArray:
        assert self.cluster_centers_ is not None, "fit first"
        xd = X.data.to(torch.float32)
        centers = self.cluster_centers_.data.to(torch.float32)
        out = _labels(torch.argmin(_dists2(xd, centers), dim=1), X.backend)
        grid = ArrayGrid((X.shape[0],), (X.block_shape[0],),
                         array_utils.to_dtype_name(out.dtype))
        return BlockArray(out, grid, X.backend)

    def fit_predict(self, X: BlockArray) -> BlockArray:
        from nums_tpu_torch.core.array.diskarray import DiskArray

        if isinstance(X, DiskArray):
            return self.fit(X).predict_ooc(X)  # labels DiskArray
        return self.fit(X).labels_

    def save(self, path: str):
        from nums_tpu_torch.models._common import save_model_arrays

        assert self.cluster_centers_ is not None, "fit before save"
        save_model_arrays(
            path,
            {"model": "KMeans", "n_clusters": self.n_clusters,
             "max_iter": self.max_iter, "tol": self.tol,
             "seed": self.seed, "inertia": self.inertia_,
             "n_iter": self.n_iter_},
            {"cluster_centers": self.cluster_centers_},
        )

    @classmethod
    def load(cls, path: str):
        from nums_tpu_torch.models._common import load_model_arrays

        meta, arrays = load_model_arrays(path)
        assert meta["model"] == "KMeans", meta
        m = cls(n_clusters=meta["n_clusters"], max_iter=meta["max_iter"],
                tol=meta["tol"], seed=meta["seed"])
        m.cluster_centers_ = _instance().array(arrays["cluster_centers"])
        m.inertia_ = meta["inertia"]
        m.n_iter_ = meta["n_iter"]
        m._labels_data = None
        m._fit_grid = None
        return m
