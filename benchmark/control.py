"""The readings that a cell's limits are set from: for each seed, the
numbers compared for the program's answers (one timed call, as the window
makes it, and the call's probes, as the run takes them after its window)
and for the control (the plain reference at the configuration's
precision one step down), each against the float64 reference; with
``--faults``, the program's again with each fault of ``faults.py``
planted. All seeds run in one process, one per card on the mesh.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        [--faults hessian_frozen,hessian_fp8]

Prints one JSON line a seed, then one line with the largest program
reading and the smallest control and fault readings of each number. Not
part of a benchmark run.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _answers(call, state, k):
    """{key: answer}: the call's under (), each probe's under (key,)."""
    out = {(): call.answer(state, call.call(state, k))}
    if hasattr(call, "probe"):
        out.update({(key,): a for key, a in call.probe(state, k).items()})
    return out


def _gaps(ref, answers, ref64):
    out = {}
    for key, a in answers.items():
        out.update(ref.gaps(a, ref64, *key))
    return out


def readings(job, rank, world, seeds, faults=()):
    """[{seed, program, control, faults}] of this process (rank 0's to
    report)."""
    from benchmark import faults as planted
    from benchmark.harness import session, spec

    cell, sched, call, ctx = session.open_cell(job, rank, world)
    ref = spec.reference_module(cell)
    torch, out = ctx.torch, []
    for seed in seeds:
        ctx.seed = seed
        inputs = call.make_inputs(ctx)
        state = call.bind(ctx, inputs)
        k = seed % ctx.input_sets
        program = _answers(call, state, k)
        faulty = {}
        for name in faults:
            with planted.planted(name):
                faulty[name] = _answers(call, state, k)
        del state
        gc.collect()
        ref64 = ref.solve(ctx, inputs, k, "float64")
        control = ref.solve(ctx, inputs, k, "fp8")
        out.append({"seed": seed, "input_set": k,
                    "program": _gaps(ref, program, ref64),
                    "control": _gaps(ref, {key: ref.at(control, *key)
                                           for key in program}, ref64),
                    "faults": {n: _gaps(ref, a, ref64)
                               for n, a in faulty.items()}})
        del inputs, ref64, control, program, faulty
        gc.collect()
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
    return out if rank == 0 else None


def summary(rows):
    names = sorted(rows[0]["program"])
    return {"program_max": {n: max(r["program"][n] for r in rows)
                            for n in names},
            "control_min": {n: min(r["control"][n] for r in rows)
                            for n in names},
            "fault_min": {f: {n: min(r["faults"][f][n] for r in rows)
                              for n in names}
                          for f in rows[0]["faults"]}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import mesh, session, spec

    cell = spec.load_cell(args.workload, ROOT)
    os.environ["NUMS_TPU_TORCH_MATMUL_PRECISION"] = cell.config["precision"]
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    job = session.Job(str(ROOT), cell.name, seeds[0], 0.0, False,
                      args.device, T_START)
    if cell.chips == 1:
        rows = readings(job, 0, 1, seeds, faults)
    else:
        rows = mesh.launch(job, cell.chips,
                           entry=functools.partial(readings, seeds=seeds,
                                                   faults=faults),
                           deadline_s=1800.0)
    for r in rows:
        print(json.dumps(r))
    print(json.dumps(summary(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
