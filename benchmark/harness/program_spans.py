"""The program's own spans in a traced run, beside the benchmark's.

While its trace is on, as it is in a traced window, the program marks its
layers with ``record_function`` regions named ``nums.<layer>.<what>``
(``nums_tpu_torch/core/trace.py``). They share the profiler's clock with
the benchmark's ``bench.`` spans and the device's operations. Here:

- ``from_profiler`` gives the ``tracing.Trace`` of the run, exactly as
  ``tracing.from_profiler`` gives it, the program's spans (host side),
  and for each device operation the time the host launched it: a kernel,
  copy or set and the runtime or driver call that launched it share a
  ``correlation_id`` in kineto's events (failing that, the operation's
  ``linked_correlation_id`` names the host op open at its launch). Where
  neither is found, the operation is unattributed.
- Each device operation belongs to the innermost program span open at its
  launch, else to the ``bench.`` span open then, else to ``OUTSIDE``.
- The breakdown's labels: an idle gap under an open program span takes
  the innermost one's name, else the ``bench.`` span's as today; a device
  operation launched in a program span is keyed ``<span>:<short name>``.
  With no program span every label is what ``tracing`` gives.
- Readings: ``newton_useful_share`` (the program's Newton counters),
  ``entry_device_ms`` (device time a call launched in ``nums.glm.*``
  spans: the fit's own work outside the Solver and the Array), and
  ``collective_wait_ms`` (each rank's wait in the program's all-reduces).

``run.py`` reads none of this; ``benchmark/spans.py`` runs a traced cell
and prints it.
"""

from dataclasses import dataclass, field

from benchmark.harness import tracing

PREFIX = "nums."
OUTSIDE = tracing.OUTSIDE
UNATTRIBUTED = "unattributed"
ENTRY_PREFIX = "nums.glm."
ALL_REDUCE = "nums.mesh.all_reduce"
STEPS_RUN, STEPS_USEFUL = "newton.steps_run", "newton.steps_useful"


@dataclass
class ProgramTrace:
    trace: tracing.Trace
    program: list = field(default_factory=list)   # (name, start_s, end_s)
    # per operation of trace.device: its launch's time (None where not
    # found) and the innermost program span open then (None where none)
    launch_s: list = field(default_factory=list)
    launched_in: list = field(default_factory=list)


def _is_launch(name):
    """A runtime or driver call that launches device work
    (``cudaLaunchKernel``, ``cuLaunchKernelEx``, ``cudaMemcpyAsync``...)."""
    return name.startswith("cu")


def from_profiler(prof):
    """The ``ProgramTrace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    trace = tracing.from_profiler(prof)
    program, device, launches, host_ops = [], [], {}, {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # tracing's rule for a device operation
            if (not name.startswith(tracing.SPAN_PREFIX)
                    and not tracing._is_annotation(ev)):
                device.append((ev.correlation_id(), _linked(ev)))
            continue
        start = tracing._ns(ev, "start") * 1e-9
        if _is_launch(name):
            launches[ev.correlation_id()] = start
            continue
        host_ops[ev.correlation_id()] = start
        if name.startswith(PREFIX):
            end = start + tracing._ns(ev, "duration") * 1e-9
            program.append((name, start, end))
    if len(device) != len(trace.device):
        raise ValueError(f"{len(device)} device operations here, "
                         f"{len(trace.device)} in tracing's trace")
    launch_s = [launches.get(c, host_ops.get(linked) if linked else None)
                for c, linked in device]
    return ProgramTrace(trace, program, launch_s,
                        innermost_at(program, launch_s))


def _linked(ev):
    getter = getattr(ev, "linked_correlation_id", None)
    return getter() if getter is not None else 0


def innermost_at(spans, times):
    """For each of ``times``, the name of the innermost of ``spans``
    ((name, start, end)) open at it: the latest started of those that hold
    it; None where none does."""
    marks = [(s, 0, i) for i, (_, s, _) in enumerate(spans)]
    marks += [(e, 2, i) for i, (_, _, e) in enumerate(spans)]
    marks += [(t, 1, j) for j, t in enumerate(times) if t is not None]
    out, open_ = [None] * len(times), []
    for _, kind, i in sorted(marks):
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        elif open_:
            out[i] = spans[open_[-1]][0]
    return out


def labels(pt):
    """Per device operation: the innermost program span open at its
    launch, else the ``bench.`` span, else ``OUTSIDE``; ``UNATTRIBUTED``
    where its launch was not found."""
    bench = innermost_at(pt.trace.spans, pt.launch_s)
    return [UNATTRIBUTED if t is None else p or b or OUTSIDE
            for t, p, b in zip(pt.launch_s, pt.launched_in, bench)]


def device_seconds_by_label(pt):
    """{label: seconds}: the union of the device operations of each label
    (``labels``) within the window."""
    win = pt.trace.window()
    if win is None:
        return {}
    groups = {}
    for (_, s, e), lab in zip(pt.trace.device, labels(pt)):
        groups.setdefault(lab, []).append((s, e))
    return {lab: tracing.union_seconds(ivs, *win)
            for lab, ivs in groups.items()}


def pieces(pt):
    """The window cut where the innermost open span (program or bench)
    changes: disjoint (name, start, end), touching pieces of one name
    joined; bench spans alone where the program has none."""
    spans = sorted(pt.trace.spans + pt.program, key=lambda sp: sp[1])
    bounds = sorted({t for _, s, e in spans for t in (s, e)})
    names = innermost_at(spans, [(a + b) / 2
                                 for a, b in zip(bounds, bounds[1:])])
    out = []
    for (a, b), n in zip(zip(bounds, bounds[1:]), names):
        if n is None:
            continue
        if out and out[-1][0] == n and out[-1][2] == a:
            out[-1] = (n, out[-1][1], b)
        else:
            out.append((n, a, b))
    return out


def refined(pt):
    """``tracing.Trace`` with the refined labels: its spans the
    ``pieces``, its device operations named ``<span>:<short name>`` where
    launched in a program span, else by short name."""
    device = [((f"{p}:{tracing.short_name(n)}" if p
                else tracing.short_name(n)), s, e)
              for (n, s, e), p in zip(pt.trace.device, pt.launched_in)]
    return tracing.Trace(device=device, spans=pieces(pt))


def idle_breakdown(pt, k=10):
    """``tracing.idle_breakdown`` under the refined labels."""
    return tracing.idle_breakdown(refined(pt), k)


def top_device_ops(pt, k=10):
    """``tracing.top_device_ops`` keyed by the refined names."""
    return tracing.top_device_ops(refined(pt), k, key=lambda n: n)


def newton_useful_share(counters):
    """100 × the useful Newton steps over the steps run, from the
    program's counters; None where no step ran."""
    run = (counters or {}).get(STEPS_RUN, 0)
    if not run:
        return None
    return 100.0 * counters.get(STEPS_USEFUL, 0) / run


def entry_device_ms(pt, calls):
    """Device time a call, as a union, of the operations launched in a
    ``nums.glm.*`` span (innermost); None where there are none."""
    win = pt.trace.window()
    ivs = [(s, e) for (_, s, e), p in zip(pt.trace.device, pt.launched_in)
           if p and p.startswith(ENTRY_PREFIX)]
    if win is None or not ivs or not calls:
        return None
    return 1e3 * tracing.union_seconds(ivs, *win) / calls


def collective_durations(pt):
    """Seconds of each collective kernel launched in the program's
    all-reduce span (innermost), in launch order."""
    found = [(t, e - s) for (n, s, e), p, t
             in zip(pt.trace.device, pt.launched_in, pt.launch_s)
             if p == ALL_REDUCE and tracing.is_collective(n)]
    return [d for _, d in sorted(found)]


def collective_wait_ms(per_rank, calls):
    """Each rank's wait in the program's all-reduces, ms a call, mean over
    the ranks: for the k-th collective kernel of every rank, its duration
    less the least over the ranks (the last to arrive waits least).
    ``per_rank``: ``collective_durations`` of each rank. None on one rank
    or where none ran."""
    k = min((len(d) for d in per_rank), default=0)
    if len(per_rank) < 2 or not k or not calls:
        return None
    least = [min(d[i] for d in per_rank) for i in range(k)]
    waits = [sum(d[i] - least[i] for i in range(k)) for d in per_rank]
    return 1e3 * sum(waits) / len(waits) / calls
