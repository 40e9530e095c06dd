"""The program's spans beside the benchmark's (``harness/program_spans.py``)
and ``spans.py``, which reads them from a traced run.

The canned trace of ``test_bench_trace.py`` is given again as kineto's
events would give it, with the program's spans, their mirrors on the
device's timeline and each operation's launch added: every reader the
benchmark had reads the same from it as from the canned trace, the
operations fall to the innermost span open at their launch, and the
breakdown's labels take the program's span names (and are what they were
where the program has none)."""

import pytest

from benchmark import spans
from benchmark.harness import mesh, program_spans as ps, session, spec, \
    tracing
from benchmark.tests._util import cpu_job
from benchmark.tests.test_bench_trace import CANNED, _run

# The program's spans (host side), in call 1's enqueue [0, 2) and call
# 2's [5.5, 6).
PROGRAM = [("nums.glm.fit", 0.1, 1.9), ("nums.glm.augment", 0.2, 0.5),
           ("nums.newton.fit", 0.6, 1.8), ("nums.newton.step", 0.7, 1.7),
           ("nums.kernel.newton_stats", 0.8, 1.0),
           ("nums.mesh.all_reduce", 1.2, 1.4), ("nums.glm.fit", 5.6, 5.95)]
# When the host launched each of CANNED.device, in its order: in
# newton_stats, in the all-reduce, in augment, in call 2's glm.fit, under
# bench.sync alone (the harness's barrier); the copy's launch is missing.
LAUNCH = [0.9, 1.3, 0.3, 5.7, 6.5, None]
LABELS = ["nums.kernel.newton_stats", "nums.mesh.all_reduce",
          "nums.glm.augment", "nums.glm.fit", "bench.sync",
          ps.UNATTRIBUTED]
EXISTING = ("collective_ms", "device_idle_share", "roofline_share", "mfu",
            "enqueue_ms", "array_ops_per_call")


class _Event:
    def __init__(self, name, start, end, cuda=False, corr=0, linked=0,
                 annotation=False):
        self._v = (name, start, end, cuda, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return int(round(self._v[1] * 1e9))

    def duration_ns(self):
        return int(round((self._v[2] - self._v[1]) * 1e9))

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


class _Profiler:
    """What ``from_profiler`` reads of a finished ``torch.profiler``."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: list(events)})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _events(program=True):
    evs = [_Event(n, s, e) for n, s, e in CANNED.spans]
    for i, ((name, s, e), t) in enumerate(zip(CANNED.device, LAUNCH)):
        corr = 100 + i
        evs.append(_Event(name, s, e, cuda=True, corr=corr))
        if t is not None and program:
            evs.append(_Event("cudaLaunchKernel", t, t + 0.01, corr=corr))
    if program:
        for n, s, e in PROGRAM:
            evs.append(_Event(n, s, e))
            # its mirror on the device's timeline is no work
            evs.append(_Event(n, s + 0.5, e + 0.5, cuda=True,
                              annotation=True))
    return evs


def _read(name, run):
    return spec.metric_reader(spec.load_cell("logreg.fit.10m.mesh4"),
                              name).read(run)


def _canned():
    return ps.from_profiler(_Profiler(_events()))


def _same(got, want):
    """Lists of (name, numbers...) alike, the numbers to 1e-9."""
    assert [g[0] for g in got] == [w[0] for w in want]
    assert [x for g in got for x in g[1:]] == pytest.approx(
        [x for w in want for x in w[1:]], abs=1e-9)


def test_the_program_spans_change_no_existing_reading():
    with_spans = tracing.from_profiler(_Profiler(_events()))
    without = tracing.from_profiler(_Profiler(_events(program=False)))
    for trace in (with_spans, without):
        _same(trace.device, CANNED.device)
        _same(trace.spans, CANNED.spans)
        run = _run(trace=trace, busy_s=tracing.busy_seconds(trace))
        for name in EXISTING:
            assert _read(name, run) == pytest.approx(_read(name, _run())), \
                name


def test_each_operation_falls_to_the_span_open_at_its_launch():
    pt = _canned()
    _same(pt.program, PROGRAM)
    assert pt.launch_s[-1] is None
    assert pt.launch_s[:-1] == pytest.approx(LAUNCH[:-1])
    assert ps.labels(pt) == LABELS
    by = ps.device_seconds_by_label(pt)
    assert by["nums.kernel.newton_stats"] == pytest.approx(2.0)
    assert by["nums.mesh.all_reduce"] == pytest.approx(1.5)
    assert by["bench.sync"] == pytest.approx(1.0)
    assert by[ps.UNATTRIBUTED] == 0.0   # the copy lies outside the window


def test_a_linked_host_op_stands_in_for_a_missing_launch():
    evs = [e for e in _events() if e.name() != "cudaLaunchKernel"
           or e.correlation_id() != 101]
    evs = [_Event(*e._v[:4], corr=101, linked=7)
           if e.correlation_id() == 101 else e for e in evs]
    evs.append(_Event("aten::fill_", 1.25, 1.35, corr=7))
    assert ps.labels(ps.from_profiler(_Profiler(evs)))[1] == \
        "nums.mesh.all_reduce"


def test_idle_gaps_take_the_innermost_span_name():
    pt = _canned()
    total = {n[len("total:"):]: s for n, s in ps.idle_breakdown(pt, k=20)
             if n.startswith("total:")}
    # [0, 1): enqueue [0, .1), glm.fit [.1, .2) and [.5, .6), augment
    # [.2, .5), newton.fit [.6, .7), step [.7, .8), newton_stats [.8, 1);
    # [5.5, 6): enqueue [5.5, 5.6) and [5.95, 6), glm.fit [5.6, 5.95).
    assert total == pytest.approx({
        "bench.enqueue": 0.25, "nums.glm.fit": 0.55,
        "nums.glm.augment": 0.3, "nums.newton.fit": 0.1,
        "nums.newton.step": 0.1, "nums.kernel.newton_stats": 0.2,
        "bench.sync": 1.4, "bench.between": 0.5})
    old = sum(s for n, s in tracing.idle_breakdown(CANNED, k=20)
              if n.startswith("total:"))
    assert sum(total.values()) == pytest.approx(old)


def test_device_ops_are_keyed_by_their_span():
    ops = dict(ps.top_device_ops(_canned()))
    assert ops == pytest.approx({
        "nums.kernel.newton_stats:gram_mma": 2.0,
        "nums.glm.fit:gram_mma": 2.8,
        "nums.mesh.all_reduce:ncclDevKernel_AllReduce_Sum_f32_RING_LL": 1.5,
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL": 1.0,
        "nums.glm.augment:newton_eta": 0.3})


def test_without_program_spans_every_label_is_as_before():
    pt = ps.from_profiler(_Profiler(_events(program=False)))
    _same(ps.idle_breakdown(pt, k=20), tracing.idle_breakdown(CANNED, k=20))
    assert dict(ps.top_device_ops(pt)) == pytest.approx(
        dict(tracing.top_device_ops(CANNED)))
    assert set(ps.labels(pt)) == {ps.UNATTRIBUTED}
    assert ps.entry_device_ms(pt, 2) is None


def test_readings_on_one_rank():
    pt = _canned()
    # augment's newton_eta [4.5, 4.8] and glm.fit's gram_mma [6.2, 9.0]
    assert ps.entry_device_ms(pt, 2) == pytest.approx(1e3 * 3.1 / 2)
    assert ps.collective_durations(pt) == pytest.approx([1.5])
    assert ps.collective_wait_ms([ps.collective_durations(pt)], 2) is None
    assert ps.newton_useful_share({ps.STEPS_RUN: 20,
                                   ps.STEPS_USEFUL: 15}) == 75.0


def test_collective_wait_on_four_ranks():
    per_rank = [[1.0, 2.0], [0.5, 2.5], [0.7, 2.0], [0.5, 2.0, 9.0]]
    # least [0.5, 2.0]; waits 0.5, 0.5, 0.2, 0 (a rank's extra kernel
    # has no match and is not read); mean 0.3 s over 2 calls.
    assert ps.collective_wait_ms(per_rank, 2) == pytest.approx(150.0)
    assert ps.collective_wait_ms([[1.0]] * 4, 2) == 0.0


def test_each_reading_reads_nothing_from_nothing():
    pt = ps.from_profiler(_Profiler([]))
    assert pt.trace.window() is None
    assert ps.entry_device_ms(pt, 0) is None
    assert ps.device_seconds_by_label(pt) == {}
    assert ps.idle_breakdown(pt) == [] and ps.top_device_ops(pt) == []
    assert ps.collective_durations(pt) == []
    assert ps.collective_wait_ms([[], [], [], []], 0) is None
    assert ps.newton_useful_share({}) is None
    assert ps.newton_useful_share(None) is None


@pytest.mark.parametrize("workload,spans_a_call", [
    ("logreg.fit.2p5m", 4 + 3 * 10), ("gram.xtx.2p5m", 2)])
def test_spans_reads_a_traced_cpu_run(tiny, workload, spans_a_call):
    job = cpu_job(tiny, workload, trace=True)
    result, seen = spans.run_rank(job, 0, 1)
    assert result["correct"] and "breakdown" in result
    calls = result["attempted"]
    assert seen["calls"] == calls
    assert seen["program_spans_per_call"] == spans_a_call
    if workload.startswith("logreg"):
        assert seen["counters"][ps.STEPS_RUN] == 10 * calls
        assert 0 < seen["newton_useful_share"] <= 100.0
    else:
        assert seen["counters"] == {} and seen["newton_useful_share"] is None
    assert seen["entry_device_ms"] is None   # no device on the CPU
    assert seen["collective_wait_ms"] is None


def test_spans_on_four_gloo_processes(tiny):
    job = cpu_job(tiny, "logreg.fit.10m.mesh4", seconds=0.05, trace=True)
    result, seen = mesh.launch(job, 4, entry=spans.run_rank,
                               deadline_s=240.0)
    assert result["correct"] and result["device"]["count"] == 4
    # mesh_operands, and an all-reduce in each step
    assert seen["program_spans_per_call"] == 5 + 4 * 10
    assert seen["newton_useful_share"] is not None


def test_keeping_puts_the_session_back():
    before = (session._profiler, session._OpLog.__exit__)
    with spans._keeping({}):
        assert session._profiler is not before[0]
    assert (session._profiler, session._OpLog.__exit__) == before
