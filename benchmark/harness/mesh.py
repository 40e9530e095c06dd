"""A run on several chips: one process per card, joined by a file://
rendezvous under the run's temporary directory, each running the
session on its own rows. Rank 0 hands the result to the launching
process, which prints it; no child writes to standard output."""

import os
import queue
import shutil
import tempfile
import time
import traceback

DEADLINE_S = 330.0


def rank_main(job, rank, world, init_file, results, entry=None):
    """One rank: join the group, run ``entry`` (the session's ``run``),
    and put rank 0's result (or any rank's error) on ``results``."""
    os.dup2(2, 1)   # the launcher alone writes to standard output
    os.environ.update({
        "LOCAL_RANK": str(rank), "NUMS_TPU_TORCH_INIT_FILE": init_file,
        "NUMS_TPU_TORCH_NUM_PROCESSES": str(world),
        "NUMS_TPU_TORCH_PROCESS_ID": str(rank)})
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # one host
    try:
        import torch
        import torch.distributed as dist

        from nums_tpu_torch.core import multiprocess

        if job.device == "cuda":
            from benchmark.harness.device import missing_cards

            problem = missing_cards(torch, world)
            if problem:
                raise RuntimeError(problem)
            torch.cuda.set_device(rank)
        # The ranks share one host: each takes a share of its cores for
        # torch's CPU threads. With all of them each, a fit's host path
        # took 40% longer on four H100s and the calls spread wider.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
        multiprocess.initialize(job.device)
        if entry is None:
            from benchmark.harness.session import run as entry
        out = entry(job, rank, world)
        dist.barrier()
        if rank == 0:
            results.put(("result", out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the launcher reads the error
        results.put(("error", rank, traceback.format_exc()))
        results.close()
        results.join_thread()
        os._exit(1)


def launch(job, world, entry=None, deadline_s=DEADLINE_S):
    """Run ``job`` on ``world`` processes; rank 0's result. Raises when a
    rank fails or the deadline passes; every process has ended on
    return."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="bench-rendezvous-")
    init_file = os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=rank_main,
                         args=(job, r, world, init_file, results, entry))
             for r in range(world)]
    got, errors = None, []
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        while got is None and not errors and time.monotonic() < end:
            try:
                msg = results.get(timeout=0.5)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            if msg[0] == "result":
                got = msg[1]
            else:
                errors.append(msg[1:])
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        while True:   # errors put after the loop ended
            try:
                msg = results.get_nowait()
            except queue.Empty:
                break
            if msg[0] == "error":
                errors.append(msg[1:])
        shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.exitcode for p in procs]
    if errors or got is None or any(c != 0 for c in codes):
        detail = "\n".join(f"rank {r}:\n{tb}" for r, tb in errors)
        raise RuntimeError(f"mesh run failed (exit codes {codes})\n{detail}")
    return got
