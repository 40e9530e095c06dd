"""Dataset splitting and cross-validation over BlockArrays.

Counterpart of ``nums_tpu/models/model_selection.py``: splits are row
gathers on the device over one permutation (``NumsRandomState.
permutation``), so no index set or data copy goes through the host. The
permutation is drawn on the reference's threefry counters: for a seed, a
shuffled split is the reference's split, row for row.
"""

import copy

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.models._common import _to_ba

__all__ = ["train_test_split", "KFold", "cross_val_score"]


def _resolve_sizes(n, test_size, train_size):
    if test_size is None and train_size is None:
        test_size = 0.25
    if test_size is None:
        test_size = (
            n - train_size if isinstance(train_size, (int, np.integer))
            else 1.0 - train_size
        )
    n_test = (
        int(test_size) if isinstance(test_size, (int, np.integer))
        else int(np.ceil(n * float(test_size)))
    )
    if train_size is None:
        n_train = n - n_test
    else:
        n_train = (
            int(train_size) if isinstance(train_size, (int, np.integer))
            else int(np.floor(n * float(train_size)))
        )
    assert 0 < n_test < n and 0 < n_train <= n - n_test, (
        n, n_train, n_test
    )
    return n_train, n_test


def train_test_split(*arrays, test_size=None, train_size=None,
                     shuffle=True, random_state=0):
    """Split each array along axis 0 into (train, test) pairs.

    Returns ``X0_train, X0_test, X1_train, X1_test, ...`` (sklearn's
    order). With ``shuffle=True`` the split is a row gather over one
    shared permutation; ``shuffle=False`` slices.
    """
    assert arrays, "need at least one array"
    arrays = [_to_ba(a) for a in arrays]
    n = arrays[0].shape[0]
    for a in arrays[1:]:
        assert a.shape[0] == n, "inconsistent first-axis lengths"
    n_train, n_test = _resolve_sizes(n, test_size, train_size)
    out = []
    if shuffle:
        perm = _instance().random_state(random_state).permutation(n)
        idx_train = perm[:n_train]
        idx_test = perm[n_train:n_train + n_test]
        for a in arrays:
            out.extend((a[idx_train], a[idx_test]))
    else:
        # sklearn's unshuffled split: the test rows follow the train rows
        # (a gap is left at the end when the sizes do not span n).
        for a in arrays:
            out.extend((a[:n_train], a[n_train:n_train + n_test]))
    return tuple(out)


class KFold:
    """K consecutive (or shuffled) folds; ``split`` yields index arrays
    for the row gather ``X[idx]``."""

    def __init__(self, n_splits=5, shuffle=False, random_state=0):
        assert n_splits >= 2
        self.n_splits = int(n_splits)
        self.shuffle = bool(shuffle)
        self.random_state = random_state

    def split(self, X, y=None):
        del y
        X = _to_ba(X)
        n = X.shape[0]
        assert self.n_splits <= n
        app = _instance()
        order = (app.random_state(self.random_state).permutation(n)
                 if self.shuffle else None)
        # sklearn's fold sizes: the first n % k folds get one extra row.
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        stop = 0
        for sz in sizes:
            start, stop = stop, stop + int(sz)
            if order is None:
                test = np.arange(start, stop)
                train = np.concatenate(
                    [np.arange(0, start), np.arange(stop, n)]
                )
                yield train, test
            else:
                yield (
                    app.concatenate(
                        [order[:start], order[stop:]], axis=0,
                        axis_block_size=order.block_shape[0],
                    ) if start > 0 else order[stop:],
                    order[start:stop],
                )


def cross_val_score(model, X, y, cv=5, scoring=None):
    """Fit a copy of ``model`` on each fold's train split and score it on
    the fold's test split; the caller's model is left untouched, as
    sklearn's clone per fold leaves it. ``cv`` is a fold count or a
    KFold; ``scoring`` is a callable ``(model, X_test, y_test) -> score``
    (default: ``model.score``). Returns the per-fold scores as a numpy
    array."""
    X, y = _to_ba(X), _to_ba(y)
    folds = KFold(cv) if isinstance(cv, (int, np.integer)) else cv
    scores = []
    for train_idx, test_idx in folds.split(X):
        # A shallow copy is enough: fit rebinds the fitted attributes and
        # mutates no shared state.
        fold_model = copy.copy(model)
        fold_model.fit(X[train_idx], y[train_idx])
        if scoring is None:
            s = fold_model.score(X[test_idx], y[test_idx])
        else:
            s = scoring(fold_model, X[test_idx], y[test_idx])
        scores.append(float(s.get() if hasattr(s, "get") else s))
    return np.array(scores)
