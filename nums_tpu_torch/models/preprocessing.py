"""Feature scaling over BlockArrays (sklearn-style surface).

Counterpart of ``nums_tpu/models/preprocessing.py``: ``StandardScaler``,
``MinMaxScaler`` and ``normalize``. The statistics are column reductions
and the transforms elementwise BlockArray expressions. A fitted scaler's
state moves between the packages as numpy arrays
(``from_reference_params``).
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.models._common import _to_ba

__all__ = ["StandardScaler", "MinMaxScaler", "normalize"]


def _restore(model, arrays, names):
    """Set the fitted attributes ``names`` of ``model`` from numpy
    arrays (a missing or None entry stays None)."""
    app = _instance()
    for name in names:
        value = arrays.get(name)
        if value is not None:
            value = np.asarray(value)
            setattr(model, name, app.array(value, block_shape=value.shape))
    return model


class StandardScaler:
    """Center to zero mean and scale to unit variance per feature."""

    def __init__(self, with_mean=True, with_std=True):
        self.with_mean = bool(with_mean)
        self.with_std = bool(with_std)
        self.mean_ = None
        self.scale_ = None

    @classmethod
    def from_reference_params(cls, meta: dict, arrays: dict):
        """A fitted scaler from nums_tpu's: ``meta`` holds ``with_mean``
        and ``with_std``, ``arrays`` the numpy values of ``mean_`` and
        ``scale_``."""
        model = cls(meta.get("with_mean", True), meta.get("with_std", True))
        return _restore(model, arrays, ("mean_", "scale_"))

    def fit(self, X):
        app = _instance()
        X = _to_ba(X)
        self.mean_ = app.mean(X, axis=0)
        if self.with_std:
            std = app.std(X, axis=0)
            # sklearn: zero-variance features scale by 1 (stay constant).
            self.scale_ = app.where(std == 0, 1.0, std)
        else:
            self.scale_ = None
        return self

    def transform(self, X):
        assert self.mean_ is not None, "fit must be called first"
        X = _to_ba(X)
        if self.with_mean:
            X = X - self.mean_
        if self.with_std:
            X = X / self.scale_
        return X

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        assert self.mean_ is not None, "fit must be called first"
        X = _to_ba(X)
        if self.with_std:
            X = X * self.scale_
        if self.with_mean:
            X = X + self.mean_
        return X


class MinMaxScaler:
    """Scale each feature to ``feature_range`` (default [0, 1])."""

    def __init__(self, feature_range=(0.0, 1.0)):
        lo, hi = feature_range
        assert lo < hi, feature_range
        self.feature_range = (float(lo), float(hi))
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    @classmethod
    def from_reference_params(cls, meta: dict, arrays: dict):
        """A fitted scaler from nums_tpu's: ``meta`` holds
        ``feature_range``, ``arrays`` the numpy values of ``data_min_``,
        ``data_max_``, ``scale_`` and ``min_``."""
        model = cls(tuple(meta.get("feature_range", (0.0, 1.0))))
        return _restore(model, arrays,
                        ("data_min_", "data_max_", "scale_", "min_"))

    def fit(self, X):
        app = _instance()
        X = _to_ba(X)
        lo, hi = self.feature_range
        self.data_min_ = app.min(X, axis=0)
        self.data_max_ = app.max(X, axis=0)
        rng = self.data_max_ - self.data_min_
        rng = app.where(rng == 0, 1.0, rng)
        self.scale_ = (hi - lo) / rng
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def transform(self, X):
        assert self.scale_ is not None, "fit must be called first"
        return _to_ba(X) * self.scale_ + self.min_

    def fit_transform(self, X):
        return self.fit(X).transform(X)

    def inverse_transform(self, X):
        assert self.scale_ is not None, "fit must be called first"
        return (_to_ba(X) - self.min_) / self.scale_


def normalize(X, norm="l2", axis=1):
    """Scale rows (axis=1) or columns (axis=0) to unit norm."""
    app = _instance()
    X = _to_ba(X)
    assert norm in ("l1", "l2", "max"), norm
    if norm == "l2":
        n = app.sqrt(app.sum(X * X, axis=axis, keepdims=True))
    elif norm == "l1":
        n = app.sum(abs(X), axis=axis, keepdims=True)
    else:
        n = app.max(abs(X), axis=axis, keepdims=True)
    n = app.where(n == 0, 1.0, n)
    return X / n
