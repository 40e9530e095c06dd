"""The reduction of a traced window and the per-layer readers, on a canned
trace: two calls, kernels that overlap on two streams (compute beside
NCCL), and idle gaps under each of the benchmark's spans."""

import pytest

from benchmark.harness import session, spec, tracing
from benchmark.harness.tracing import Trace

# Seconds on the profiler's clock. Call 1: enqueue [0, 2), sync [2, 5);
# call 2: enqueue [5.5, 6), sync [6, 10). Kernels: gram_mma [1, 3] and an
# NCCL all-reduce [2.5, 4] overlapping it on another stream; newton_eta
# [4.5, 4.8]; a copy after the window.
CANNED = Trace(
    device=[
        ("void gram_mma<128, 2>(CUtensorMap, float*)", 1.0, 3.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 2.5, 4.0),
        ("newton_eta(float const*, float*)", 4.5, 4.8),
        ("void gram_mma<128, 2>(CUtensorMap, float*)", 6.2, 9.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 8.5, 9.5),
        ("Memcpy DtoH (Device -> Pageable)", 20.0, 21.0),  # outside
    ],
    spans=[("bench.enqueue", 0.0, 2.0), ("bench.sync", 2.0, 5.0),
           ("bench.enqueue", 5.5, 6.0), ("bench.sync", 6.0, 10.0)])


def _run(**kw):
    base = dict(calls=2, window_s=10.0, latencies_s=[5.0, 4.5],
                enqueue_s=[2.0, 0.5], setup_s=3.0, peak_bytes=2 * 10**9,
                world=1, work={"bytes": 0.0, "tc_flops": 1.978e12,
                               "f32_flops": 0.0},
                least_s=1.0, op_events=6, trace=CANNED,
                busy_s=tracing.busy_seconds(CANNED), traced_window_s=10.0)
    base.update(kw)
    return session.Run(**base)


def _read(name, run):
    return spec.metric_reader(spec.load_cell("logreg.fit.10m.mesh4"),
                              name).read(run)


def test_union_counts_overlap_once():
    assert tracing.merged([(1, 3), (2.5, 4), (6, 7)]) == \
        [(1, 4), (6, 7)]
    assert tracing.union_seconds([(1, 3), (2.5, 4)]) == 3.0
    assert tracing.union_seconds([(1, 3), (2.5, 4)], 2.0, 3.5) == 1.5
    assert CANNED.window() == (0.0, 10.0)
    # [1, 4] + [4.5, 4.8] + [6.2, 9.5]; the copy lies outside the window.
    assert tracing.busy_seconds(CANNED) == pytest.approx(3.0 + 0.3 + 3.3)
    assert tracing.busy_seconds(CANNED, tracing.is_collective) == \
        pytest.approx(1.5 + 1.0)


def test_idle_gaps_are_named_by_the_open_span():
    gaps = tracing.idle_gaps(CANNED)
    assert sorted((n, round(s, 9)) for n, s in gaps) == sorted([
        ("bench.enqueue", 1.0), ("bench.sync", 0.5), ("bench.sync", 0.2),
        ("bench.between", 0.5), ("bench.enqueue", 0.5), ("bench.sync", 0.2),
        ("bench.sync", 0.5)])
    assert gaps[0] == ("bench.enqueue", 1.0)
    total = dict((n, s) for n, s in tracing.idle_breakdown(CANNED)
                 if n.startswith("total:"))
    # [0, 1) and [5.5, 6.0) under enqueue ([6, 6.2) lies under sync),
    # [4, 4.5) and [4.8, 5) and [9.5, 10) under sync, [5, 5.5) between.
    assert total["total:bench.enqueue"] == pytest.approx(1.0 + 0.5)
    assert total["total:bench.sync"] == pytest.approx(0.5 + 0.2 + 0.2 + 0.5)
    assert total["total:bench.between"] == pytest.approx(0.5)
    assert len(tracing.idle_breakdown(CANNED, k=4)) == 4


def test_top_device_ops_by_short_name():
    ops = dict(tracing.top_device_ops(CANNED))
    assert ops["gram_mma"] == pytest.approx(2.0 + 2.8)
    assert ops["ncclDevKernel_AllReduce_Sum_f32_RING_LL"] == \
        pytest.approx(2.5)
    assert ops["newton_eta"] == pytest.approx(0.3)
    assert "Memcpy DtoH" not in " ".join(ops)
    assert tracing.short_name("void a::b<int>(x)") == "a::b"


def test_per_layer_readers_on_the_canned_trace():
    run = _run()
    busy = 6.6
    assert _read("collective_ms", run) == pytest.approx(1e3 * 2.5 / 2)
    assert _read("device_idle_share", run) == pytest.approx(
        100 * (1 - busy / 10.0))
    assert _read("roofline_share", run) == pytest.approx(
        100 * 1.0 / (busy / 2))
    # 1.978e12 FLOPs a call in 5 s a call: 0.4 TFLOP/s of 989.
    assert _read("mfu", run) == pytest.approx(100 * 1.978e12 / 5 / 989e12)
    assert _read("mfu", _run(world=4)) == pytest.approx(
        100 * 1.978e12 / 5 / 989e12 / 4)
    assert _read("enqueue_ms", run) == pytest.approx(1250.0)
    assert _read("array_ops_per_call", run) == 3.0


def test_end_to_end_readers():
    run = _run(latencies_s=[0.1 * i for i in range(1, 101)], calls=100,
               window_s=12.5)
    assert _read("call_s", run) == 0.125
    assert _read("call_p95_s", run) == pytest.approx(9.5)
    assert _read("peak_device_gb", run) == 2.0
    assert _read("setup_s", run) == 3.0


def test_readers_without_a_device_read_nothing():
    run = _run(trace=Trace(spans=CANNED.spans), busy_s=None)
    for name in ("collective_ms", "roofline_share", "device_idle_share",
                 "mfu"):
        assert _read(name, run) is None, name


def test_from_profiler_keeps_the_spans_and_no_annotation_as_work():
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("bench.enqueue"):
                torch.ones(8).sum()
            with torch.profiler.record_function("bench.sync"):
                pass
    trace = tracing.from_profiler(prof)
    assert [n for n, _, _ in sorted(trace.spans, key=lambda s: s[1])] == \
        ["bench.enqueue", "bench.sync"] * 3
    assert trace.device == []
    lo, hi = trace.window()
    assert 0 < hi - lo < 10
