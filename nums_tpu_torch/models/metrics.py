"""Evaluation metrics over BlockArrays (sklearn-style surface).

Counterpart of ``nums_tpu/models/metrics.py``. Every metric is a
BlockArray expression that returns a scalar BlockArray; ``float(score)``
brings it to the host.
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.models._common import _to_ba

__all__ = [
    "accuracy_score", "mean_squared_error", "mean_absolute_error",
    "r2_score", "log_loss",
]


def accuracy_score(y_true, y_pred):
    """Fraction of exact matches."""
    y_true, y_pred = _to_ba(y_true), _to_ba(y_pred)
    return (y_true == y_pred).astype(np.float64).mean()


def mean_squared_error(y_true, y_pred):
    y_true, y_pred = _to_ba(y_true), _to_ba(y_pred)
    d = y_true - y_pred
    return (d * d).mean()


def mean_absolute_error(y_true, y_pred):
    y_true, y_pred = _to_ba(y_true), _to_ba(y_pred)
    return abs(y_true - y_pred).mean()


def r2_score(y_true, y_pred):
    """1 − SS_res/SS_tot, with sklearn's convention for a constant y_true:
    1.0 for a perfect fit, else 0.0 (a plain division would give -inf or
    nan)."""
    app = _instance()
    y_true, y_pred = _to_ba(y_true), _to_ba(y_pred)
    d = y_true - y_pred
    ss_res = app.sum(d * d)
    c = y_true - y_true.mean()
    ss_tot = app.sum(c * c)
    one, zero = app.scalar(1.0), app.scalar(0.0)
    tot_zero = ss_tot == zero
    score = one - ss_res / app.where(tot_zero, one, ss_tot)
    return app.where(
        tot_zero, app.where(ss_res == zero, one, zero), score
    )


def log_loss(y_true, y_proba, eps=1e-15):
    """Binary cross-entropy. ``y_proba`` is P(class 1): a vector, or an
    (n, 2) matrix in sklearn column order (column 1 is P(1)), the layout
    of every ``predict_proba`` here."""
    app = _instance()
    y_true, y_proba = _to_ba(y_true), _to_ba(y_proba)
    if y_proba.ndim == 2:
        assert y_proba.shape[1] == 2, y_proba.shape
        y_proba = y_proba[:, 1]
    p = y_proba.clip(eps, 1.0 - eps)
    return -(y_true * app.log(p) + (1.0 - y_true) * app.log(1.0 - p)).mean()
