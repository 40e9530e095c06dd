"""Distributed XGBoost over BlockArrays — ONE booster, collective workers.

Counterpart of ``nums_tpu/experimental/nums_xgb.py``. Every row block
joins the SAME boosting run (gradient histograms are allreduced), so the
result is one model trained on all the data — not an ensemble of
per-block models.

xgboost's collective API carries it: a tracker is started in-process,
one worker (thread) per row block joins it inside a
``CommunicatorContext``, and ``xgb.train`` allreduces across workers.
xgboost releases the GIL during training, so thread workers run in
parallel on one host. Each worker gets its block as host numpy arrays.

If the collective API is unavailable (ancient xgboost), ``train`` falls
back to per-block bagging with a RuntimeWarning — the fallback is a
DIFFERENT model family and exists only to degrade gracefully.

xgboost is optional: the module imports without it and raises at use.
"""

import warnings

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray

try:  # pragma: no cover - exercised only where xgboost is installed
    import xgboost as _xgb

    _HAS_XGB = True
except Exception:  # pragma: no cover
    _xgb = None
    _HAS_XGB = False


def _require_xgb():
    if not _HAS_XGB:
        raise RuntimeError(
            "xgboost is not available in this environment; install it to "
            "use nums_tpu_torch.experimental.nums_xgb."
        )


def _collective_api():
    """(tracker_cls, communicator_ctx) or (None, None) when the modern
    collective API is missing."""
    try:
        from xgboost.tracker import RabitTracker
        from xgboost import collective

        return RabitTracker, collective.CommunicatorContext
    except Exception:  # pragma: no cover - old xgboost
        return None, None


def _start_tracker(tracker_cls, n_workers):
    """Start an in-process tracker; returns (tracker, worker_args dict)."""
    try:  # xgboost >= 2.0 signature
        tracker = tracker_cls(host_ip="127.0.0.1", n_workers=n_workers)
    except TypeError:  # 1.7.x signature
        tracker = tracker_cls(host_ip="127.0.0.1", nslave=n_workers)
    tracker.start()
    try:
        args = dict(tracker.worker_args())
    except AttributeError:  # 1.7.x spelled it slave_envs()
        args = dict(tracker.slave_envs())
    return tracker, args


class NumsDMatrix:
    """Pairs (X, y) BlockArrays for train()."""

    def __init__(self, X: BlockArray, y: BlockArray):
        self.X = X
        self.y = y

    def __iter__(self):
        yield self.X
        yield self.y


def _row_blocks(X: BlockArray, y: BlockArray):
    out = []
    for start, stop in X.grid.grid_slices[0]:
        out.append((X[start:stop].get(), y[start:stop].get()))
    return out


def train(params: dict, data, *args, evals=(), **kwargs):
    """Train ONE booster across all row-blocks via the collective.

    Accepts a NumsDMatrix (parity with the reference signature) or the
    (X, y) pair positionally. Returns the trained Booster.
    """
    _require_xgb()
    if isinstance(data, NumsDMatrix):
        X, y = data.X, data.y
    else:
        X, y = data, args[0]
        args = args[1:]
    assert X.ndim == 2 and X.shape[0] == y.shape[0]

    blocks = _row_blocks(X, y)
    n_workers = len(blocks)
    eval_np = [(eX.get(), ey.get(), name) for eX, ey, name in evals]

    tracker_cls, comm_ctx = _collective_api()
    if n_workers == 1:
        dtrain = _xgb.DMatrix(blocks[0][0], label=blocks[0][1])
        ev = [(_xgb.DMatrix(a, label=b), nm) for a, b, nm in eval_np]
        return _xgb.train(params, dtrain, *args, evals=ev, **kwargs)
    if tracker_cls is None:
        warnings.warn(
            "xgboost.collective unavailable: falling back to per-block "
            "bagging — a DIFFERENT model than distributed training.",
            RuntimeWarning,
        )
        boosters = [
            _xgb.train(params, _xgb.DMatrix(a, label=b), *args, **kwargs)
            for a, b in blocks
        ]
        return boosters[0]

    tracker, worker_args = _start_tracker(tracker_cls, n_workers)

    def worker(rank):
        X_np, y_np = blocks[rank]
        ctx_args = {
            **{k.lower(): v for k, v in worker_args.items()},
            "dmlc_task_id": f"nums_tpu_torch-{rank}",
        }
        with comm_ctx(**ctx_args):
            dtrain = _xgb.DMatrix(X_np, label=y_np)
            ev = [(_xgb.DMatrix(a, label=b), nm) for a, b, nm in eval_np]
            # Every worker allreduces into the same boosting run; the
            # returned model is identical on all ranks.
            return _xgb.train(params, dtrain, *args, evals=ev, **kwargs)

    # Daemon threads + first-error propagation: if one rank dies (OOM
    # building its DMatrix, a rank-local xgboost error), the surviving
    # ranks are blocked inside the collective allreduce forever — a
    # ThreadPoolExecutor would deadlock joining them on __exit__.
    # Daemon workers are abandoned instead and the error surfaces.
    import queue
    import threading

    results = queue.Queue()

    def run_rank(rank):
        try:
            results.put((rank, worker(rank), None))
        except BaseException as e:  # noqa: BLE001 - must reach the main thread
            results.put((rank, None, e))

    threads = [
        threading.Thread(target=run_rank, args=(r,), daemon=True)
        for r in range(n_workers)
    ]
    for t in threads:
        t.start()
    boosters = {}
    for _ in range(n_workers):
        rank, booster, err = results.get()
        if err is not None:
            # Don't wait_for the tracker: with a dead rank it would
            # block as long as the stuck ranks do. DO tear the tracker
            # down (best-effort) so the surviving ranks blocked in the
            # allreduce fail fast instead of lingering for the life of
            # the process and racing a later train() on the same ports.
            for stop in ("free", "stop", "close"):
                try:
                    getattr(tracker, stop)()
                    break
                except AttributeError:
                    continue
                except Exception:
                    break
            raise RuntimeError(
                f"collective worker rank {rank} failed"
            ) from err
        boosters[rank] = booster
    try:
        tracker.wait_for()
    except Exception:
        pass
    return boosters[0]


class XGBClassifier:
    """One collective booster over all row blocks."""

    def __init__(self, max_depth=3, learning_rate=0.1, n_estimators=100,
                 objective="binary:logistic", booster="gbtree", **kwargs):
        _require_xgb()
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.objective = objective
        self.booster = booster
        self.kwargs = kwargs
        self.model = None

    def fit(self, X: BlockArray, y: BlockArray):
        params = {
            "max_depth": self.max_depth,
            "eta": self.learning_rate,
            "objective": self.objective,
            "booster": self.booster,
            **self.kwargs,
        }
        self.model = train(params, NumsDMatrix(X, y),
                           num_boost_round=self.n_estimators)
        return self

    def predict(self, X: BlockArray) -> BlockArray:
        assert self.model is not None, "fit must be called before predict"
        app = _instance()
        proba = self.model.predict(_xgb.DMatrix(X.get()))
        labels = (proba > 0.5).astype(np.int64)
        return app.array(labels, block_shape=(X.block_shape[0],))
