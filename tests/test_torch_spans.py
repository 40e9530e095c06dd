"""The port's spans and counters (``core/trace.py``): a fit and ``X.T @ X``
show their ``nums.<layer>.<what>`` regions on the profiler's timeline,
nested as the program calls them; with the trace off nothing is recorded
and no counter moves; the Newton counters read the steps run and the
useful ones; on four gloo processes every rank shows one
``nums.mesh.all_reduce`` a step."""

import json
import os

import numpy as np
import pytest
import torch

from torch_parity import mesh_app, mesh_pool, torch_app  # noqa: F401

from nums_tpu_torch.core import trace
from nums_tpu_torch.models import fast_glm
from nums_tpu_torch.models.glms import LogisticRegression

N, D = 203, 5
MESH_N, MESH_D = 1003, 9


def _data(n, d, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    w = 0.5 * rs.randn(d)
    y = (1.0 / (1.0 + np.exp(-(X @ w))) > rs.rand(n)).astype(np.float32)
    return X, y


def _arrays(app):
    X, y = _data(N, D)
    return (app.array(X, block_shape=(N, D)), app.array(y, block_shape=(N,)))


def _spans(path):
    """[(name, start, end)] of the ``nums.`` regions in a Chrome trace,
    by start (µs)."""
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name", "").startswith("nums.")
                   and e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("max_iter", [1, 3])
def test_fit_spans_nest_as_the_program_calls(torch_app, tmp_path, max_iter):
    bx, by = _arrays(torch_app)
    with trace.profile(str(tmp_path)):
        LogisticRegression(solver="newton", tol=1e-8,
                           max_iter=max_iter).fit(bx, by)
    spans = _spans(tmp_path)
    (fit,) = _named(spans, "nums.glm.fit")
    (augment,) = _named(spans, "nums.glm.augment")
    (newton,) = _named(spans, "nums.newton.fit")
    (stage,) = _named(spans, "nums.newton.stage")
    steps = _named(spans, "nums.newton.step")
    assert len(steps) == max_iter
    assert _inside(augment, fit) and _inside(newton, fit)
    assert augment[2] <= newton[1]
    assert _inside(stage, newton) and stage[2] <= steps[0][1]
    for step in steps:
        assert _inside(step, newton)
        for name in ("nums.kernel.newton_stats", "nums.newton.solve"):
            assert len([s for s in _named(spans, name)
                        if _inside(s, step)]) == 1, name
    assert len(spans) == 4 + 3 * max_iter
    assert not trace.is_enabled() and trace.span("x") is trace.span("y")


def test_gram_spans(torch_app, tmp_path):
    bx, _ = _arrays(torch_app)
    with trace.profile(str(tmp_path)):
        bx.T @ bx
    spans = _spans(tmp_path)
    assert [s[0] for s in spans] == ["nums.array.tensordot",
                                    "nums.kernel.gram"]
    assert _inside(spans[1], spans[0])


def test_trace_off_records_no_span_and_counts_nothing(torch_app):
    bx, by = _arrays(torch_app)
    before = trace.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        LogisticRegression(solver="newton", tol=1e-8, max_iter=2).fit(bx, by)
        bx.T @ bx
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith("nums.") for n in names)
    assert trace.counters() == before
    trace.count("newton.steps_run", 5)
    assert trace.counters() == before
    assert trace.span("a") is trace.span("b")


@pytest.fixture()
def counting():
    trace.clear()
    trace.enable(record=True)
    yield
    trace.disable()
    trace.clear()


@pytest.mark.parametrize("tol,useful", [(0.0, 4), (1e30, 1)])
def test_newton_counters_read_the_useful_steps(torch_app, counting, tol,
                                               useful):
    bx, by = _arrays(torch_app)
    for _ in range(2):
        LogisticRegression(solver="newton", tol=tol, max_iter=4).fit(bx, by)
    assert trace.counters() == {"newton.steps_run": 8,
                                "newton.steps_useful": 2 * useful}
    trace.clear()
    assert trace.counters() == {}


def test_newton_fit_counts_its_it(counting):
    X, y = _data(N, D)
    X = np.hstack([X, np.ones((N, 1), np.float32)])
    beta0 = torch.zeros(D + 1)
    _, _, it = fast_glm.newton_fit(torch.from_numpy(X), torch.from_numpy(y),
                                   beta0, 1e-3, max_iter=20)
    assert 1 < int(it) < 20
    assert trace.counters() == {"newton.steps_run": 20,
                                "newton.steps_useful": int(it)}


def test_ooc_fit_counts_its_passes(torch_app, tmp_path, counting):
    X, y = _data(N, D)
    dX = torch_app.spill(torch_app.array(X.astype(np.float64),
                                         block_shape=(50, D)),
                         str(tmp_path / "X"))
    _, _, it = fast_glm.newton_fit_ooc(dX, y.astype(np.float64), 1e-6,
                                       max_iter=20)
    assert 1 < it < 20
    assert trace.counters() == {"newton.steps_run": it,
                                "newton.steps_useful": it}


def test_count_adds_device_tensors_on_their_device(counting):
    trace.count("c", torch.tensor(3, dtype=torch.int32))
    trace.count("c", torch.tensor(4, dtype=torch.int32))
    trace.count("c", 2)
    trace.count("d")
    assert trace.counters() == {"c": 9, "d": 1}


def _mesh_fit_case(cluster, max_iter, path):
    import torch.distributed as dist

    app = mesh_app(cluster)
    X, y = _data(MESH_N, MESH_D)
    rows = -(-MESH_N // 4)
    bx = app.array(X, block_shape=(rows, MESH_D))
    by = app.array(y, block_shape=(rows,))
    mine = os.path.join(path, f"rank{dist.get_rank()}")
    with trace.profile(mine):
        LogisticRegression(solver="newton", tol=1e-8,
                           max_iter=max_iter).fit(bx, by)
    spans = _spans(mine)
    counts = {name: len(_named(spans, name)) for name in (
        "nums.mesh.all_reduce", "nums.newton.mesh_operands",
        "nums.newton.step")}
    (newton,) = _named(spans, "nums.newton.fit")
    (operands,) = _named(spans, "nums.newton.mesh_operands")
    steps = _named(spans, "nums.newton.step")
    nested = (operands[2] <= newton[1] and all(
        any(_inside(r, s) for s in steps)
        for r in _named(spans, "nums.mesh.all_reduce")))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (counts, nested))
    return out


@pytest.mark.parametrize("cluster", [(4, 1), (2, 2)])
def test_mesh_fit_all_reduces_in_every_step_on_every_rank(mesh_pool,
                                                          tmp_path, cluster):
    ranks = mesh_pool.run(_mesh_fit_case, cluster, 3, str(tmp_path))
    assert len(ranks) == 4
    for counts, nested in ranks:
        assert counts == {"nums.mesh.all_reduce": 3,
                          "nums.newton.mesh_operands": 1,
                          "nums.newton.step": 3}
        assert nested
