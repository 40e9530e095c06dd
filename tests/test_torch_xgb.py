"""nums_tpu_torch.experimental.nums_xgb's collective orchestration on the
CPU, with a FAKE xgboost (a mini tracker and a barrier-based
communicator): the port's copy of
tests/experimental/test_xgb_fake_collective.py. xgboost is installed on
neither machine, so the module must import without it and raise at use
(``test_raises_without_xgboost``); with the fake, every row block joins
ONE collective run, a single block skips the collective, and a dead rank
surfaces its error promptly and tears the tracker down so that the
surviving ranks fail fast.
"""

import importlib
import sys
import threading
import time
import types

import numpy as np
import pytest

from torch_parity import torch_app  # noqa: F401


class _FakeState:
    def __init__(self):
        self.reset(0)

    def reset(self, n_workers):
        self.barrier = (
            threading.Barrier(n_workers) if n_workers else None
        )
        self.rows = []
        self.lock = threading.Lock()
        self.freed = False
        self.aborted_exits = 0


_STATE = _FakeState()


def _build_fake_xgboost():
    xgb = types.ModuleType("xgboost")
    tracker_mod = types.ModuleType("xgboost.tracker")
    collective_mod = types.ModuleType("xgboost.collective")

    class DMatrix:
        def __init__(self, data, label=None):
            data = np.asarray(data)
            if np.isnan(data).any():
                # Stands in for a rank-local failure (OOM, bad shard).
                raise ValueError("rank-local DMatrix failure")
            self.data = data
            self.label = np.asarray(label) if label is not None else None

    class FakeBooster:
        def __init__(self, total_rows, n_workers):
            self.total_rows = total_rows
            self.n_workers = n_workers

        def predict(self, dmat):
            return np.full(dmat.data.shape[0], 0.75)

    class RabitTracker:
        def __init__(self, host_ip=None, n_workers=None, nslave=None):
            self.n_workers = n_workers if n_workers is not None else nslave

        def start(self):
            _STATE.reset(self.n_workers)

        def worker_args(self):
            return {"DMLC_TRACKER_URI": "127.0.0.1",
                    "DMLC_TRACKER_PORT": "0"}

        def free(self):
            _STATE.freed = True
            if _STATE.barrier is not None:
                _STATE.barrier.abort()

        def wait_for(self):
            pass

    _in_collective = threading.local()

    class CommunicatorContext:
        def __init__(self, **kwargs):
            self.kwargs = kwargs

        def __enter__(self):
            _in_collective.active = True
            return self

        def __exit__(self, *exc):
            _in_collective.active = False
            return False

    def train(params, dtrain, *args, evals=(), **kwargs):
        if not getattr(_in_collective, "active", False):
            # Plain local training (the single-worker fast path).
            return FakeBooster(dtrain.data.shape[0], 1)
        # "Allreduce": publish the local row count, wait for every
        # rank at the barrier, return a model built from the GLOBAL
        # row count — identical on all ranks, like the real collective.
        with _STATE.lock:
            _STATE.rows.append(dtrain.data.shape[0])
        if _STATE.barrier is not None:
            try:
                _STATE.barrier.wait()
            except threading.BrokenBarrierError:
                # Tracker teardown aborted the collective: fail fast
                # (the behavior the round-2 fix relies on).
                with _STATE.lock:
                    _STATE.aborted_exits += 1
                raise RuntimeError("collective aborted")
        with _STATE.lock:
            total = sum(_STATE.rows)
            n = len(_STATE.rows)
        return FakeBooster(total, n)

    xgb.DMatrix = DMatrix
    xgb.Booster = FakeBooster
    xgb.train = train
    tracker_mod.RabitTracker = RabitTracker
    collective_mod.CommunicatorContext = CommunicatorContext
    xgb.tracker = tracker_mod
    xgb.collective = collective_mod
    return xgb, tracker_mod, collective_mod


@pytest.fixture
def fake_xgb(monkeypatch):
    xgb, tracker_mod, collective_mod = _build_fake_xgboost()
    monkeypatch.setitem(sys.modules, "xgboost", xgb)
    monkeypatch.setitem(sys.modules, "xgboost.tracker", tracker_mod)
    monkeypatch.setitem(sys.modules, "xgboost.collective", collective_mod)
    from nums_tpu_torch.experimental import nums_xgb

    importlib.reload(nums_xgb)
    assert nums_xgb._HAS_XGB
    yield nums_xgb
    # Restore the module to the image's real (xgboost-less) state.
    monkeypatch.delitem(sys.modules, "xgboost")
    monkeypatch.delitem(sys.modules, "xgboost.tracker")
    monkeypatch.delitem(sys.modules, "xgboost.collective")
    importlib.reload(nums_xgb)


def test_one_model_over_all_blocks(fake_xgb, torch_app):
    """Every row-block joins ONE collective run; the returned model is
    built from the global data (not a per-block bag)."""
    rs = np.random.RandomState(0)
    n, d = 120, 4
    X = torch_app.array(rs.randn(n, d), block_shape=(40, d))
    y = torch_app.array((rs.rand(n) > 0.5).astype(float),
                       block_shape=(40,))
    bst = fake_xgb.train({}, fake_xgb.NumsDMatrix(X, y))
    assert bst.total_rows == n
    assert bst.n_workers == 3


def test_single_block_skips_collective(fake_xgb, torch_app):
    rs = np.random.RandomState(1)
    X = torch_app.array(rs.randn(30, 3), block_shape=(30, 3))
    y = torch_app.array(np.zeros(30), block_shape=(30,))
    bst = fake_xgb.train({}, fake_xgb.NumsDMatrix(X, y))
    assert bst.total_rows == 30


def test_rank_failure_surfaces_and_frees_survivors(fake_xgb, torch_app):
    """The deadlock-fix contract: when one rank dies before the
    allreduce, train() must (a) raise promptly instead of joining
    workers blocked in the collective, and (b) tear the tracker down
    so the blocked survivors fail fast instead of lingering."""
    rs = np.random.RandomState(2)
    n, d = 90, 3
    X_np = rs.randn(n, d)
    X_np[35, 1] = np.nan  # block 1 (rows 30..59) fails DMatrix build
    X = torch_app.array(X_np, block_shape=(30, d))
    y = torch_app.array(np.zeros(n), block_shape=(30,))
    t0 = time.time()
    with pytest.raises(RuntimeError, match="collective worker rank"):
        fake_xgb.train({}, fake_xgb.NumsDMatrix(X, y))
    assert time.time() - t0 < 30, "error should surface promptly"
    assert _STATE.freed, "tracker must be torn down on rank failure"
    # The two surviving ranks were blocked at the barrier; teardown
    # must have aborted them (fail-fast, not process-lifetime zombies).
    deadline = time.time() + 10
    while time.time() < deadline:
        with _STATE.lock:
            if _STATE.aborted_exits == 2:
                break
        time.sleep(0.05)
    assert _STATE.aborted_exits == 2


def test_raises_without_xgboost(torch_app, monkeypatch):
    """No xgboost: the module imports, and use raises RuntimeError."""
    from nums_tpu_torch.experimental import nums_xgb

    monkeypatch.setitem(sys.modules, "xgboost", None)  # import fails
    importlib.reload(nums_xgb)
    assert not nums_xgb._HAS_XGB
    X = torch_app.array(np.zeros((4, 2)), block_shape=(2, 2))
    y = torch_app.array(np.zeros(4), block_shape=(2,))
    with pytest.raises(RuntimeError, match="xgboost is not available"):
        nums_xgb.train({}, nums_xgb.NumsDMatrix(X, y))
    with pytest.raises(RuntimeError, match="xgboost is not available"):
        nums_xgb.XGBClassifier()
    monkeypatch.delitem(sys.modules, "xgboost")
    importlib.reload(nums_xgb)


def test_classifier_fit_predict(fake_xgb, torch_app):
    """XGBClassifier over the collective: one booster, labels from its
    probabilities (0.75 > 0.5 in the fake), in X's row blocking."""
    rs = np.random.RandomState(3)
    X = torch_app.array(rs.randn(60, 3), block_shape=(20, 3))
    y = torch_app.array((rs.rand(60) > 0.5).astype(float),
                        block_shape=(20,))
    clf = fake_xgb.XGBClassifier(n_estimators=3).fit(X, y)
    assert clf.model.total_rows == 60 and clf.model.n_workers == 3
    pred = clf.predict(X)
    assert pred.block_shape == (20,)
    assert np.array_equal(pred.get(), np.ones(60, np.int64))
