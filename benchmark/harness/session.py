"""One run of a cell in one process (one rank of the mesh): set-up, the
measured window, the comparison with the plain reference, the metrics.

Set-up makes the inputs from the seed on the device, hands them to the
program and warms the cell's one shape up; it ends at the first timed
call. The window is a closed loop of user calls, each ended by
``synchronize`` (on the mesh, by a one-element all-reduce that is the
barrier and carries rank 0's decision to go on). A sample of the
window's answers, drawn from the seed, is kept; once the window has
closed and the peak has been read, the call module's ``probe`` (where it
has one) takes further answers of the same entry on the same inputs, the
program's state is freed, and the reference works each answer out again
from the inputs.
"""

import contextlib
import gc
import json
import logging
import math
import sys
import time
from dataclasses import dataclass

from benchmark.harness import (device as device_facts, guard, program,
                               roofline, spec, tracing)
from benchmark.harness.traffic import Reservoir, Schedule

WARMUP_CALLS = 2


@dataclass
class Job:
    root: str
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str            # "cuda" or "cpu"
    t_start: float         # time.monotonic() when the run's process began


@dataclass
class Ctx:
    """What a call module and a reference see of the run."""
    torch: object
    device: object
    seed: int
    rank: int
    world: int
    config: dict
    input_sets: int
    app: object = None

    def reduce(self, t):
        """``t`` summed over the ranks, in place (the identity on one)."""
        if self.world > 1:
            import torch.distributed as dist

            dist.all_reduce(t)
        return t


@dataclass
class Run:
    """What the metric readers read."""
    calls: int
    window_s: float
    latencies_s: list
    enqueue_s: list
    setup_s: float
    peak_bytes: int
    world: int
    work: dict
    least_s: float
    op_events: int = None
    trace: tracing.Trace = None
    busy_s: float = None          # mean over the ranks, traced window
    traced_window_s: float = None


def _gather(obj, world):
    if world == 1:
        return [obj]
    import torch.distributed as dist

    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


class _OpLog:
    """The program's op-event log (one event per BlockArray dispatch),
    recorded in memory and printed nowhere."""

    def __enter__(self):
        from nums_tpu_torch.core import trace as ptrace

        lg = logging.getLogger("nums_tpu_torch.ops")
        lg.addHandler(logging.NullHandler())
        lg.propagate = False
        ptrace.clear()
        ptrace.enable(record=True)
        self._ptrace = ptrace
        return self

    def __exit__(self, *exc):
        self._ptrace.disable()
        self.events = self._ptrace.events()
        self._ptrace.clear()


def _profiler(torch, dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _window(torch, dev, call, state, sched, seconds, world, rank, keep,
            traced):
    """The measured loop: (latencies, enqueue times, window seconds)."""
    span = (torch.profiler.record_function if traced
            else (lambda name: contextlib.nullcontext()))
    flag = torch.zeros(1, dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        sync = torch.cuda.synchronize
    else:
        def sync():
            return None
    clock = time.monotonic
    lat, enq = [], []
    i, t_w = 0, clock()
    while True:
        t0 = clock()
        with span("bench.enqueue"):
            handle = call.call(state, sched.input_for(i))
        t1 = clock()
        with span("bench.sync"):
            sync()
            go = clock() - t_w < seconds
            if world > 1:
                import torch.distributed as dist

                flag.fill_(1.0 if (rank == 0 and go) else 0.0)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                go = bool(flag.item() > 0.0)
        t2 = clock()
        lat.append(t2 - t0)
        enq.append(t1 - t0)
        if keep.wants():
            keep.keep(i, handle)
        del handle
        i += 1
        if not go:
            return lat, enq, t2 - t_w


def open_cell(job, rank, world):
    """(cell, schedule, call module, ctx with the program's application)
    of this process, its device chosen and its peak reset."""
    import torch

    dev = (torch.device("cuda", rank) if job.device == "cuda"
           else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    cell = spec.load_cell(job.workload, job.root)
    if cell.chips != world:
        raise ValueError(f"{cell.name} asks for {cell.chips} chips, "
                         f"run on {world}")
    sched = Schedule(cell.traffic)
    ctx = Ctx(torch, dev, job.seed, rank, world, cell.config,
              sched.input_sets)
    ctx.app = program.application(dev, world, cell.config["cluster_shape"])
    return cell, sched, spec.call_module(cell), ctx


def run(job, rank=0, world=1):
    """One process's part of a run; the result object on rank 0, None
    elsewhere. Raises where the run cannot give a result."""
    stages = {"entered": time.monotonic() - job.t_start}
    cell, sched, call, ctx = open_cell(job, rank, world)
    torch, dev, cfg = ctx.torch, ctx.device, cell.config
    stages["application"] = time.monotonic() - job.t_start
    inputs = call.make_inputs(ctx)
    state = call.bind(ctx, inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    stages["inputs"] = time.monotonic() - job.t_start
    for j in range(WARMUP_CALLS):
        call.call(state, sched.input_for(j))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stages[f"warm_call_{j}"] = time.monotonic() - job.t_start
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
    setup_s = time.monotonic() - job.t_start
    if rank == 0:
        print(f"set-up stages, seconds from the process's start: {stages}",
              file=sys.stderr)

    keep = Reservoir(sched.checked, job.seed)
    launched = program.launches()
    with contextlib.ExitStack() as stack:
        oplog = stack.enter_context(_OpLog()) if job.trace else None
        prof = (stack.enter_context(_profiler(torch, dev)) if job.trace
                else None)
        lat, enq, window_s = _window(torch, dev, call, state, sched,
                                     job.seconds, world, rank, keep,
                                     job.trace)
    launched = {k: (v - launched.get(k, 0)) / len(lat)
                for k, v in program.launches().items()}
    peak = max(_gather(torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0, world))

    # The sampled answers as plain tensors, and the call's probes on the
    # first one's inputs; then the program's state freed.
    kept = [(i, sched.input_for(i), call.answer(state, h))
            for i, h in keep.items()]
    probe_k = kept[0][1] if kept else sched.input_for(0)
    probes = call.probe(state, probe_k) if hasattr(call, "probe") else {}
    del keep, state
    ctx.app = None
    program.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    compared, checked = _compare(cell, ctx, inputs, kept, probe_k, probes)
    del inputs
    work = call.work(cfg)
    record = Run(calls=len(lat), window_s=window_s, latencies_s=lat,
                 enqueue_s=enq, setup_s=setup_s, peak_bytes=peak,
                 world=world, work=work,
                 least_s=roofline.least_seconds(work, world)[0])
    breakdown = None
    if job.trace:
        record.op_events = len(oplog.events)
        record.trace = tracing.from_profiler(prof)
        busies = _gather(tracing.busy_seconds(record.trace), world)
        if dev.type == "cuda" and all(b is not None for b in busies):
            record.busy_s = sum(busies) / world
        win = record.trace.window()
        record.traced_window_s = None if win is None else win[1] - win[0]
        breakdown = {"device_ops": tracing.top_device_ops(record.trace),
                     "idle_gaps": tracing.idle_breakdown(record.trace)}
        if rank == 0:
            _print_trace_counts(oplog.events, record)
    found = sorted(set().union(*_gather(guard.forbidden_loaded(), world)))
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    if rank != 0:
        return None

    entries = cell.per_layer if job.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = spec.metric_reader(cell, m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_out = device_facts.describe(torch, dev, world, peak)
    if job.trace:
        dev_out["busy_s"] = record.busy_s
        dev_out["window_s"] = record.traced_window_s
    failed = sum(1 for _, v in checked if not v)
    correct = (len(lat) > 0 and len(checked) > 0 and failed == 0)
    out = {"correct": correct, "attempted": len(lat), "failed": failed,
           "metrics": metrics, "device": dev_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    _print_calls(launched, lat)
    return out


def print_compared(result, stream):
    """The numbers compared, each beside its limit, one a line."""
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=stream, flush=True)


def _compare(cell, ctx, inputs, kept, probe_k, probes):
    """({name: {value, limit}} of the worst sampled answer, [(index, ok)])
    against the reference worked out again from the inputs; each probe
    ({key: answer} on input set ``probe_k``) is one more answer, indexed
    by its key."""
    ref = spec.reference_module(cell)
    limits = cell.config["limits"]
    refs, worst, checked = {}, {}, []
    answers = ([(i, k, a, ()) for i, k, a in kept]
               + [(f"probe {key}", probe_k, a, (key,))
                  for key, a in probes.items()])
    for i, k, answer, key in answers:
        if k not in refs:
            refs[k] = ref.solve(ctx, inputs, k, "float64")
        gaps = ref.gaps(answer, refs[k], *key)
        ok = all(math.isfinite(v) and v <= limits[n] for n, v in gaps.items())
        checked.append((i, ok))
        for n, v in gaps.items():
            if n not in worst or not v <= worst[n]:   # NaN stays worst
                worst[n] = v
    return ({n: {"value": v, "limit": limits[n]}
             for n, v in sorted(worst.items())}, checked)


def _print_trace_counts(events, record):
    """The program's op events by name and the device's operations by
    name, per call and in the traced window, on standard error."""
    counts = {}
    for ev in events:
        counts[ev[1]] = counts.get(ev[1], 0) + 1
    per_call = {k: v / record.calls for k, v in sorted(counts.items())}
    print(f"array ops per call by name: {per_call}", file=sys.stderr)
    print("device ops by name, seconds in the traced window: "
          + json.dumps(tracing.top_device_ops(record.trace, 40,
                                              key=lambda n: n[:160])),
          file=sys.stderr)


def _print_calls(launched, lat):
    """The kernels launched per call (the program's counters: which route
    ran) and the latencies' extremes, on standard error."""
    print(f"kernel launches per call: {launched}", file=sys.stderr)
    slowest = sorted(range(len(lat)), key=lambda i: -lat[i])[:8]
    print("call latencies, s: " + json.dumps(
        {"calls": len(lat), "min": min(lat),
         "median": sorted(lat)[len(lat) // 2], "max": max(lat),
         "slowest": [[i, lat[i]] for i in slowest]}), file=sys.stderr)
