"""Dimensionality reduction: PCA and TruncatedSVD.

Counterpart of ``nums_tpu/models/decomposition.py``. Both models ride the
tall-skinny SVD of the application (``ArrayApplication.svd``: CholeskyQR2
or the Householder TSQR tree, then the SVD of the n×n R), or the
randomized SVD when both dimensions are large, so fitting an (n, d) matrix
with n ≫ d never forms an n×n matrix. Centering, projection and
reconstruction are BlockArray expressions.

On a ``DiskArray`` the fit is one streamed pass: each row panel adds its
gram (on the gram kernel where its gate is on) and its column sums to the
moments on the device, and the eigendecomposition of the (d, d) gram or
covariance runs on the host in float64. ``transform`` then streams the
panels through one projection each on the device and writes the result as
a new DiskArray. On the mesh each process adds the moments of its own
rows of each panel (one all-reduce ends the pass) and projects its own
rows, gathered for the collective ``DiskArray.from_panels``.

sklearn-compatible surface: fit / transform / fit_transform /
inverse_transform, components_, explained_variance_(ratio_),
singular_values_, mean_, whiten; ``save``/``load`` in nums_tpu's format,
so a model saved by either package loads in the other.
"""

import numpy as np
import torch

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.application import (
    _device_dtype, gather_rows, ooc_accumulator, ooc_panels, ooc_put,
)
from nums_tpu_torch.core.array.diskarray import DiskArray
from nums_tpu_torch.core.ops import streaming
from nums_tpu_torch.models._common import (
    _to_ba, load_model_arrays, save_model_arrays,
)


def _whole(t):
    """A model array's tensor as one plain tensor (whole on every process
    of a mesh)."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _project(p, comps, shift, scale):
    """(p - shift) @ compsᵀ / scale: one panel's projection."""
    return ((p - shift[None, :]) @ comps.T) / scale[None, :]


def _flip(u, vt):
    """Deterministic signs (sklearn's u-based ``svd_flip``), in place: the
    entry of largest magnitude in each left-singular column is made
    positive, and the rows of vt flip to match, so u·diag(s)·vt is
    unchanged. ``u`` and ``vt`` are the SVD's own outputs; writing the
    signs into them saves a second (n, d) tensor. Where ``u`` holds only
    the first k columns, vt's first k rows flip."""
    from nums_tpu_torch.core.ops import mesh_ops

    if mesh_ops.is_dtensor(u):
        signs = _mesh_signs(u)
        _scale_box(u, signs, 1)
        _scale_box(vt, _pad_ones(signs, vt.shape[0]), 0)
        return
    idx = u.abs().argmax(dim=0)
    signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    vt = vt[:signs.shape[0]]
    u.mul_(signs[None, :])
    vt.mul_(signs[:, None])


def _mesh_signs(u):
    """``_flip``'s signs of a row-sharded DTensor ``u``, whole on every
    process: each process's largest |entry| of each column and its row;
    one all-reduce (MAX) of the values, one (MIN) of the rows that reach
    it (argmax's first row), one (SUM) of the winners' signs."""
    from nums_tpu_torch.core.application_manager import instance
    from nums_tpu_torch.core.ops import mesh_ops, summa

    backend = instance().backend
    rows = summa.row_layout(u)
    ul = summa.local_part(u, rows)
    dims = mesh_ops.shard_dims(rows, (0,))
    r0 = backend.region(tuple(u.shape), rows)[0][0]
    k = int(u.shape[1])
    big = torch.iinfo(torch.int64).max
    if ul.shape[0]:
        idx = ul.abs().argmax(dim=0)
        val = ul[idx, torch.arange(k, device=ul.device)]
        top = val.abs()
        row = idx + r0
    else:
        val = torch.zeros((k,), dtype=ul.dtype, device=ul.device)
        top = torch.full((k,), -1.0, dtype=ul.dtype, device=ul.device)
        row = torch.full((k,), big, dtype=torch.int64, device=ul.device)
    best = mesh_ops.group_reduce(backend, top.clone(), dims, "max")
    row = torch.where(top == best, row, torch.full_like(row, big))
    win = mesh_ops.group_reduce(backend, row.clone(), dims, "min")
    signs = torch.where(row == win, torch.sign(val), torch.zeros_like(val))
    signs = mesh_ops.group_reduce(backend, signs, dims)
    return torch.where(signs == 0, torch.ones_like(signs), signs)


def _pad_ones(signs, n):
    """``signs`` followed by ones, ``n`` in all."""
    out = torch.ones((n,), dtype=signs.dtype, device=signs.device)
    out[:signs.shape[0]] = signs
    return out


def _scale_box(t, signs, dim):
    """``t`` (a DTensor) multiplied in place along ``dim`` by its box of
    ``signs``."""
    from nums_tpu_torch.core.application_manager import instance

    a, b = instance().backend.region(tuple(t.shape), t.placements)[dim]
    shape = [1, 1]
    shape[dim] = b - a
    t.to_local().mul_(signs[a:b].reshape(shape))


class _BaseSVDModel:
    def __init__(self, n_components=None, svd_solver="full",
                 n_oversamples=10, power_iters=2, seed=0):
        assert svd_solver in ("full", "randomized"), svd_solver
        self.n_components = n_components
        self.svd_solver = svd_solver
        self.n_oversamples = int(n_oversamples)
        self.power_iters = int(power_iters)
        self.seed = int(seed)
        self.components_ = None
        self.singular_values_ = None
        self.explained_variance_ = None
        self.explained_variance_ratio_ = None
        self.n_components_ = None
        self.n_samples_ = None

    def _svd(self, X, k, scratch=False):
        """The SVD of X with the deterministic sign fix, U of k columns:
        exact (TSQR) by default, or the randomized sketch
        (``svd_solver='randomized'``), which returns exactly k triplets,
        when k is below both dimensions. ``scratch``: X is the caller's
        temporary, and the exact route may overwrite it."""
        app = _instance()
        if self.svd_solver == "randomized" and k < min(X.shape):
            u, s, vt = app.randomized_svd(
                X, k, n_oversamples=self.n_oversamples,
                n_iter=self.power_iters, seed=self.seed,
            )
        else:
            u, s, vt = app.svd(X, k=k, overwrite_x=scratch)
        _flip(u.data, vt.data)
        return u, s, vt

    def _resolve_k(self, X):
        k = self.n_components
        if k is None:
            k = min(X.shape)
        k = int(k)
        assert 1 <= k <= min(X.shape), (k, X.shape)
        return k

    def fit(self, X):
        if isinstance(X, DiskArray):
            self._fit_ooc(X)
            return self
        self._fit(_to_ba(X))
        return self

    def fit_transform(self, X):
        if isinstance(X, DiskArray):
            self._fit_ooc(X)
            return self.transform(X)  # second streamed pass
        u, s = self._fit(_to_ba(X))
        # u[:, :k] * s[:k] comes from the fit's own SVD: one pass over X.
        k = self.n_components_
        return u[:, :k] * s[:k]

    def transform(self, X, out: str = None):
        """Project onto the components. A ``DiskArray`` streams its row
        panels, and the (n, k) result is written as a new DiskArray at
        ``out`` (default: ``<X.path>.transformed``)."""
        assert self.components_ is not None, "fit must be called first"
        if isinstance(X, DiskArray):
            return self._transform_ooc(X, out)
        return self._center(_to_ba(X)) @ self.components_.T

    def inverse_transform(self, X):
        assert self.components_ is not None, "fit must be called first"
        return self._uncenter(_to_ba(X) @ self.components_)

    # -- out-of-core paths (gram/covariance eigendecomposition) --------

    def _moments_ooc(self, X):
        """ONE streamed pass -> host float64 (XᵀX, column means): both
        moments accumulate in the same per-panel step, so the data is read
        from disk once."""
        backend = X.backend
        d = X.shape[1]
        dt = _device_dtype(backend, X.dtype)
        G = ooc_accumulator(backend, torch.zeros((d, d), dtype=dt))
        s = ooc_accumulator(backend, torch.zeros((d,), dtype=dt))
        for _, panel in ooc_panels(X):
            p, _ = ooc_put(backend, panel)
            x = streaming.local_rows(p)
            if x.shape[0]:
                streaming.gram_and_sum_update(G, s, x.to(dt))
        streaming.reduce_rows(backend.mesh, [G, s])
        G = backend.get(G).astype(np.float64)
        mu = backend.get(s).astype(np.float64) / X.shape[0]
        return G, mu

    @staticmethod
    def _top_eigh(M, k):
        """Top-k eigenpairs of a symmetric host matrix, descending, with a
        deterministic sign convention (the entry of largest magnitude
        positive)."""
        evals, evecs = np.linalg.eigh(M)
        order = np.argsort(evals)[::-1]
        evals = evals[order]
        evecs = evecs[:, order]
        comps = evecs[:, :k].T  # (k, d)
        idx = np.argmax(np.abs(comps), axis=1)
        signs = np.sign(comps[np.arange(k), idx])
        signs[signs == 0] = 1.0
        return evals, comps * signs[:, None]

    def _transform_ooc(self, X, out):
        """Streamed projection on the device: each panel moves to the
        device, is projected by one GEMM there and comes back as (rows, k);
        the result is written with ``DiskArray.from_panels``."""
        backend = X.backend
        dt = _device_dtype(backend, X.dtype)
        comps = _whole(self.components_.data).to(dt)
        k, d = comps.shape
        shift, scale = self._ooc_shift(), self._ooc_scale()
        shift = (torch.zeros((d,), dtype=dt, device=backend.device)
                 if shift is None else _whole(shift).to(dt))
        scale = (torch.ones((k,), dtype=dt, device=backend.device)
                 if scale is None else _whole(scale).to(dt))

        def panels():
            for _, panel in ooc_panels(X):
                p, rows = ooc_put(backend, panel)
                t = _project(streaming.local_rows(p).to(dt), comps, shift,
                             scale)
                yield gather_rows(backend, t, (rows, k))

        return DiskArray.from_panels(
            out or X.path + ".transformed", X._fs, panels(),
            (X.shape[0], k), X.dtype, X.grid.block_shape[0],
        )

    def _ooc_shift(self):
        return None

    def _ooc_scale(self):
        return None

    # -- persistence (model.json + arrays.npz, nums_tpu's format) -------

    _extra_meta = ()
    _extra_arrays = ()

    def save(self, path: str):
        assert self.components_ is not None, "fit before save"
        meta = {
            "model": type(self).__name__,
            "n_components": self.n_components_,
            "svd_solver": self.svd_solver,
            "n_oversamples": self.n_oversamples,
            "power_iters": self.power_iters,
            "seed": self.seed,
            "n_samples": self.n_samples_,
        }
        for k in self._extra_meta:
            meta[k] = getattr(self, k)
        arrays = {
            "components": self.components_,
            "singular_values": self.singular_values_,
            "explained_variance": self.explained_variance_,
            "explained_variance_ratio": self.explained_variance_ratio_,
        }
        for k in self._extra_arrays:
            arrays[k] = getattr(self, k + "_", None)
        save_model_arrays(path, meta, arrays)

    @classmethod
    def load(cls, path: str):
        return cls.from_reference_params(*load_model_arrays(path))

    @classmethod
    def from_reference_params(cls, meta: dict, arrays: dict):
        """A fitted model from nums_tpu model state: ``meta`` holds the
        ``model.json`` fields of ``save`` (decomposition.py:244-267 there),
        ``arrays`` the numpy arrays ``components``, ``singular_values``,
        ``explained_variance``, ``explained_variance_ratio`` and, for a
        PCA, ``mean`` and ``noise_variance``."""
        kw = {}
        if meta.get("whiten") is not None:
            kw["whiten"] = meta["whiten"]
        m = cls(
            n_components=meta["n_components"],
            svd_solver=meta["svd_solver"],
            n_oversamples=meta["n_oversamples"],
            power_iters=meta["power_iters"], seed=meta["seed"], **kw
        )
        assert meta["model"] == type(m).__name__, meta
        app = _instance()
        m.n_components_ = meta["n_components"]
        m.n_samples_ = meta["n_samples"]
        m.components_ = app.array(arrays["components"])
        m.singular_values_ = app.array(arrays["singular_values"])
        m.explained_variance_ = app.array(arrays["explained_variance"])
        m.explained_variance_ratio_ = app.array(
            arrays["explained_variance_ratio"]
        )
        if "mean" in arrays:
            m.mean_ = app.array(arrays["mean"])
        if "noise_variance" in arrays:
            m.noise_variance_ = app.scalar(float(arrays["noise_variance"]))
        return m

    # Centering hooks (identity for TruncatedSVD).
    def _center(self, X):
        return X

    def _uncenter(self, X):
        return X


class TruncatedSVD(_BaseSVDModel):
    """Truncated SVD (a.k.a. LSA): no centering; it works on the data
    matrix as it is."""

    def _fit(self, X):
        assert X.ndim == 2
        app = _instance()
        n = X.shape[0]
        k = self._resolve_k(X)
        u, s, vt = self._svd(X, k)
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = vt[:k]
        self.singular_values_ = s[:k]
        # sklearn's TruncatedSVD: explained_variance_ is the per-column
        # variance of the TRANSFORMED data (np.var, ddof=0), not s²/(n−1):
        # on a matrix that is not centered the two differ widely, because
        # the leading singular value absorbs the mean offset.
        self.explained_variance_ = app.var(u[:, :k] * s[:k], axis=0)
        total_var = app.sum(app.var(X, axis=0))
        self.explained_variance_ratio_ = self.explained_variance_ / total_var
        return u, s

    def _fit_ooc(self, X):
        """Out-of-core fit from ONE streamed pass: the eigendecomposition
        of the gram XᵀX (accuracy about eps·cond², as for any method on the
        normal equations; the in-core TSQR-SVD is the accurate route).
        sklearn's variances from gram identities:
        var(Xvᵢ) = sᵢ²/n − (μᵀvᵢ)²; Σvar(X col) = tr(G)/n − ‖μ‖²."""
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        G, mu = self._moments_ooc(X)
        evals, comps = self._top_eigh(G, k)
        s = np.sqrt(np.maximum(evals[:k], 0.0))
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = app.array(
            comps.astype(X.dtype), block_shape=(k, d)
        )
        self.singular_values_ = app.array(s.astype(X.dtype),
                                          block_shape=(k,))
        ev = s * s / n - (comps @ mu) ** 2
        total_var = np.trace(G) / n - float(mu @ mu)
        self.explained_variance_ = app.array(ev.astype(X.dtype),
                                             block_shape=(k,))
        self.explained_variance_ratio_ = app.array(
            (ev / total_var).astype(X.dtype), block_shape=(k,)
        )


class PCA(_BaseSVDModel):
    """Principal component analysis through the SVD of the centered data.

    ``whiten=True`` scales projections to unit component-wise variance.
    """

    _extra_meta = ("whiten",)
    _extra_arrays = ("mean", "noise_variance")

    def __init__(self, n_components=None, whiten=False, **solver_kwargs):
        super().__init__(n_components, **solver_kwargs)
        self.whiten = bool(whiten)
        self.mean_ = None
        self.noise_variance_ = None

    def _fit(self, X):
        assert X.ndim == 2
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        self.mean_ = app.mean(X, axis=0)
        # The centered copy is never named here: the SVD overwrites it
        # with Q, and it dies with the SVD.
        u, s, vt = self._svd(X - self.mean_, k, scratch=True)
        self.n_samples_ = n
        self.n_components_ = k
        self.components_ = vt[:k]
        self.singular_values_ = s[:k]
        ev_k = (s[:k] * s[:k]) / float(n - 1)
        # The total variance directly (the sum of ALL eigenvalues), whether
        # the solver returned all of them or only the top k.
        total_var = app.sum(app.var(X, axis=0, ddof=1))
        self.explained_variance_ = ev_k
        self.explained_variance_ratio_ = ev_k / total_var
        # Average variance in the dropped subspace (sklearn's
        # noise_variance_; 0 when k == min(n, d)).
        if k < min(n, d):
            self.noise_variance_ = (total_var - app.sum(ev_k)) / float(
                min(n, d) - k
            )
        else:
            self.noise_variance_ = app.scalar(0.0)
        return u, s

    def _fit_ooc(self, X):
        """Out-of-core PCA: streamed (XᵀX, μ) -> the covariance
        (G − n·μμᵀ)/(n−1), whose top eigenvalues ARE sklearn's
        explained_variance_."""
        app = _instance()
        n, d = X.shape
        k = self._resolve_k(X)
        G, mu = self._moments_ooc(X)
        cov = (G - n * np.outer(mu, mu)) / (n - 1)
        evals, comps = self._top_eigh(cov, k)
        evk = np.maximum(evals[:k], 0.0)
        self.n_samples_ = n
        self.n_components_ = k
        self.mean_ = app.array(mu.astype(X.dtype), block_shape=(d,))
        self.components_ = app.array(
            comps.astype(X.dtype), block_shape=(k, d)
        )
        self.singular_values_ = app.array(
            np.sqrt(evk * (n - 1)).astype(X.dtype), block_shape=(k,)
        )
        total_var = float(np.trace(cov))
        self.explained_variance_ = app.array(evk.astype(X.dtype),
                                             block_shape=(k,))
        self.explained_variance_ratio_ = app.array(
            (evk / total_var).astype(X.dtype), block_shape=(k,)
        )
        if k < min(n, d):
            self.noise_variance_ = app.scalar(
                (total_var - float(evk.sum())) / (min(n, d) - k)
            )
        else:
            self.noise_variance_ = app.scalar(0.0)

    def _whiten_scale(self):
        return self.singular_values_ / float(np.sqrt(self.n_samples_ - 1))

    def _ooc_shift(self):
        return self.mean_.data

    def _ooc_scale(self):
        return self._whiten_scale().data if self.whiten else None

    def _center(self, X):
        return X - self.mean_

    def _uncenter(self, X):
        return X + self.mean_

    def transform(self, X, out: str = None):
        if isinstance(X, DiskArray):
            # whiten is folded into the panel stream (_ooc_scale).
            return super().transform(X, out)
        res = super().transform(X)
        return res / self._whiten_scale() if self.whiten else res

    def fit_transform(self, X):
        res = super().fit_transform(X)
        if self.whiten and not isinstance(X, DiskArray):
            res = res / self._whiten_scale()
        return res

    def inverse_transform(self, X):
        if self.whiten:
            X = _to_ba(X) * self._whiten_scale()
        return super().inverse_transform(X)
