"""Multi-controller SPMD: one process per device under torch.distributed.

Counterpart of ``nums_tpu/core/multiprocess.py``. The reference's mesh is
one controller over many devices, and its multi-host form joins
``jax.distributed``; PyTorch has only the second model, so the port's mesh
is always one process per device. Every process runs the same program in
the same order; an operation documented as collective (``get``, any
computation on a sharded array) is called by every process.

``initialize`` joins the group from one of two sources:

* the triple ``NUMS_TPU_TORCH_COORDINATOR`` (``host:port`` or a URL),
  ``NUMS_TPU_TORCH_NUM_PROCESSES`` and ``NUMS_TPU_TORCH_PROCESS_ID``
  (nums_tpu's ``NUMS_TPU_COORDINATOR`` triple); ``NUMS_TPU_TORCH_INIT_FILE``
  may stand in for the coordinator (a ``file://`` rendezvous, no port);
* or torchrun's ``RANK`` / ``WORLD_SIZE`` (``env://``).

NCCL joins the processes on the card, gloo on the CPU. Each process takes
``cuda:<local rank>`` (``LOCAL_RANK``, else the process index: one host)
and raises where that card is missing; it never shares a card and never
drops to gloo.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if _up() else 1


def process_index() -> int:
    return dist.get_rank() if _up() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def _env_config():
    """(init method, world size, rank) from the environment, or None."""
    env = os.environ
    coord = env.get("NUMS_TPU_TORCH_COORDINATOR")
    init_file = env.get("NUMS_TPU_TORCH_INIT_FILE")
    if coord or init_file:
        if init_file:
            method = "file://" + os.path.abspath(init_file)
        else:
            method = coord if "://" in coord else "tcp://" + coord
        return (method, int(env["NUMS_TPU_TORCH_NUM_PROCESSES"]),
                int(env["NUMS_TPU_TORCH_PROCESS_ID"]))
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    return None


def local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if _up():
        return dist.get_rank()
    cfg = _env_config()
    return cfg[2] if cfg is not None else 0


def device_for(device=None) -> torch.device:
    """This process's device: ``device`` when the caller names one (the
    CPU runs only when asked for), else ``cuda:<local rank>``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nums_tpu_torch: no CUDA device (torch.cuda.is_available() is "
            "false); to run on the CPU, ask for it: "
            "nums_tpu_torch.init(device=\"cpu\")"
        )
    rank = local_rank()
    if rank >= torch.cuda.device_count():
        raise RuntimeError(
            f"nums_tpu_torch: local rank {rank} has no card of its own "
            f"({torch.cuda.device_count()} visible); one process per card"
        )
    return torch.device("cuda", rank)


def _backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize(device_type: str = "cuda") -> bool:
    """Join the process group named by the environment (idempotent).
    Returns whether a group is up."""
    if _up():
        return True
    cfg = _env_config()
    if cfg is None:
        return False
    method, world, rank = cfg
    dist.init_process_group(_backend_for(device_type), init_method=method,
                            world_size=world, rank=rank)
    return True


def initialize_single(device_type: str):
    """A group of this process alone (an in-memory store, no port): the
    mesh of one device."""
    dist.init_process_group(_backend_for(device_type), store=dist.HashStore(),
                            world_size=1, rank=0)


def _flag_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_to_host(tensor) -> np.ndarray:
    """The full value on EVERY process (collective for a DTensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tensor, DTensor):
        tensor = sent_gather(tensor).full_tensor()
    return tensor.detach().cpu().numpy()


def host_sum(array) -> np.ndarray:
    """The elementwise sum over every process of a small host array
    (collective; one all-reduce): where each process filled its own
    entries and left the others 0, every process gets them all."""
    array = np.asarray(array)
    if not is_multiprocess():
        return array.copy()
    t = torch.from_numpy(np.ascontiguousarray(array)).to(_flag_device())
    dist.all_reduce(sent("all_reduce", t))
    return t.cpu().numpy()


def all_gather_ints(values) -> np.ndarray:
    """(processes, len(values)) int64: every process's small vector of
    integers, on every process (collective; one all-gather)."""
    values = np.asarray(values, dtype=np.int64).reshape(-1)
    if not is_multiprocess():
        return values[None].copy()
    t = torch.from_numpy(values.copy()).to(_flag_device())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, sent("all_gather", t))
    return torch.stack(out).cpu().numpy()


def all_reduce_(tensor, op="sum"):
    """``tensor`` replaced in place by its elementwise ``op`` (sum, min
    or max) over every process (collective; one all-reduce)."""
    if is_multiprocess():
        dist.all_reduce(sent("all_reduce", tensor),
                        op={"sum": dist.ReduceOp.SUM,
                            "min": dist.ReduceOp.MIN,
                            "max": dist.ReduceOp.MAX}[op])
    return tensor


def any_everywhere(flag) -> bool:
    """Whether ``flag`` (a bool, or a one-element bool tensor on this
    process's device) holds on any process (collective; one all-reduce of
    one int32)."""
    t = torch.as_tensor(flag).reshape(1)
    if not is_multiprocess():
        return bool(t)
    t = t.to(device=_flag_device(), dtype=torch.int32)
    return bool(all_reduce_(t, "max"))


# The bytes that ``exchange`` sent from this process to other processes
# (what it keeps for itself is not counted).
EXCHANGED = {"bytes_sent": 0}

# The bytes this process sent through every collective that the port
# issues (``sent``; ``exchange``'s all-to-alls too), by the ring
# algorithms' count. A reduction that DTensor issues inside an operator
# (the sum of a row-sharded mean or of Xᵀy, a few numbers a row) is not
# counted.
SENT = {"bytes": 0}

# A process's bytes on the wire in a ring, for a buffer of B bytes (for an
# all-gather, its own part) over P processes.
_RING = {"all_reduce": lambda b, p: 2 * (p - 1) * b // p,
         "all_gather": lambda b, p: (p - 1) * b,
         "reduce_scatter": lambda b, p: (p - 1) * b // p,
         "broadcast": lambda b, p: (p - 1) * b // p,
         # one point-to-point send of the buffer
         "send": lambda b, p: b}


def one_process(t):
    """The sum over the processes of a value that one process holds
    whole: the value itself (the ``reduce`` of a computation off the
    mesh)."""
    return t


def sent(kind, tensor, group=None):
    """Count in ``SENT`` the bytes this process sends in one collective of
    ``kind`` (``_RING``'s keys) on ``tensor`` over ``group`` (None: every
    process); returns ``tensor``."""
    p = dist.get_world_size(group) if _up() else 1
    SENT["bytes"] += int(_RING[kind](tensor.numel() * tensor.element_size(),
                                     p))
    return tensor


def sent_gather(data):
    """Count in ``SENT`` what an all-gather of the DTensor ``data`` to
    every process sends from this one: its whole bytes less its own
    part's."""
    whole = int(np.prod(data.shape, dtype=np.int64))
    SENT["bytes"] += (whole - data.to_local().numel()) * data.element_size()
    return data


def sent_moved(before, after):
    """Count in ``SENT`` what DTensor's ``redistribute`` of ``before``
    into ``after`` sent from this process: what its part grew by (an
    all-gather), or its whole part where the size is kept (an
    all-to-all); nothing where the part shrank (a slice of its own).
    Returns ``after``."""
    b0 = before.to_local().numel() * before.element_size()
    b1 = after.to_local().numel() * after.element_size()
    SENT["bytes"] += b1 - b0 if b1 > b0 else b0 if b1 == b0 else 0
    return after


def _as_bytes(items):
    """(rows, bytes a row) uint8 view of a tensor's rows."""
    rows = int(items.shape[0])
    width = int(np.prod(items.shape[1:], dtype=np.int64)) \
        * items.element_size()
    if not items.numel():
        # an empty tensor may have stride 0, which no view of bytes takes
        return torch.empty((rows, width), dtype=torch.uint8,
                           device=items.device)
    return items.contiguous().reshape(-1).view(torch.uint8).reshape(
        rows, width)


def exchange(items, send_counts, recv_counts, out=None):
    """One all-to-all of whole rows: ``items`` (on this process's device)
    is cut in order into ``send_counts[r]`` rows for each process ``r``;
    returns the rows received, ``recv_counts[r]`` from each process ``r``,
    in process order (collective), in ``out`` where given (a contiguous
    tensor of those rows: a view of a larger result, so that nothing is
    copied after). Rows travel as bytes, so every dtype goes, bool and
    complex included."""
    send_counts = [int(c) for c in send_counts]
    recv_counts = [int(c) for c in recv_counts]
    assert sum(send_counts) == int(items.shape[0]), (send_counts,
                                                     items.shape)
    tail = tuple(items.shape[1:])
    src = _as_bytes(items)
    width = int(src.shape[1])
    result = out
    if out is not None:
        assert out.is_contiguous() and int(out.shape[0]) == sum(
            recv_counts) and out.dtype == items.dtype, (out.shape,
                                                        recv_counts)
        out = _as_bytes(out)  # a view of it (fresh where it is empty)
    else:
        out = torch.empty((sum(recv_counts), width), dtype=torch.uint8,
                          device=items.device)
    me = process_index()
    EXCHANGED["bytes_sent"] += width * (sum(send_counts)
                                        - send_counts[me])
    SENT["bytes"] += width * (sum(send_counts) - send_counts[me])
    if not is_multiprocess():
        out.copy_(src)
    else:  # every process joins, one with empty rows too
        dist.all_to_all_single(out.reshape(-1), src.reshape(-1),
                               [c * width for c in recv_counts],
                               [c * width for c in send_counts])
    if result is not None:
        return result
    return out.reshape(-1).view(items.dtype).reshape(
        (sum(recv_counts),) + tail)


def ring_shift(tensor, rows_from_left):
    """``tensor`` sent to the next process (rank + 1, around the ring) and
    the previous one's received, of ``rows_from_left`` rows (collective;
    one send and one receive a process)."""
    tail = tuple(tensor.shape[1:])
    src = _as_bytes(tensor)
    width = int(src.shape[1])
    world, me = process_count(), process_index()
    out = torch.empty((int(rows_from_left), width), dtype=torch.uint8,
                      device=tensor.device)
    SENT["bytes"] += src.numel()
    ops = [dist.P2POp(dist.isend, src.reshape(-1), (me + 1) % world),
           dist.P2POp(dist.irecv, out.reshape(-1), (me - 1) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.reshape(-1).view(tensor.dtype).reshape(
        (int(rows_from_left),) + tail)


def broadcast_from_zero(tensor):
    """``tensor`` replaced in place by process 0's (collective): a carry
    that every process must hold bit for bit."""
    if is_multiprocess():
        dist.broadcast(sent("broadcast", tensor), src=0)
    return tensor


def stage(name: str, what: str, fn, only0: bool = False):
    """One stage of a collective operation: ``fn()`` on every process (on
    process 0 alone with ``only0``), then a :func:`checked_barrier`, so a
    stage that failed anywhere fails everywhere and no process waits at
    the next collective. Returns ``fn()``'s value (None where it did not
    run)."""
    ok, err, out = True, None, None
    if not only0 or process_index() == 0:
        try:
            out = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            ok, err = False, e
    checked_barrier(name, ok, what)
    if err is not None:
        raise err
    return out


def barrier(name: str):
    """Block until every process reaches this point (collective)."""
    del name
    if not is_multiprocess():
        return
    flag = torch.zeros(1, dtype=torch.int32, device=_flag_device())
    dist.all_reduce(flag)
    flag.item()


def checked_barrier(name: str, ok: bool, what: str):
    """A barrier that also agrees on success: every process contributes
    its ``ok`` flag to one all-reduce; if any process failed, every OTHER
    process raises (the failing one re-raises its own exception at the
    call site), so no process waits at the next collective for a peer
    that left. Call pattern as nums_tpu's ``checked_barrier``."""
    if not is_multiprocess():
        return
    flag = torch.tensor([0 if ok else 1], dtype=torch.int32,
                        device=_flag_device())
    dist.all_reduce(flag)
    if int(flag.item()) != 0 and ok:
        raise RuntimeError(
            f"{what} failed on a peer process at stage {name!r} "
            "(see its traceback)"
        )


@contextlib.contextmanager
def publishing(tag: str, marker: str):
    """Process-0 side of the collective publish protocol (nums_tpu's
    ``publishing``): consume a stale failure marker, drop a new one on
    failure BEFORE the barrier releases the peers, and always run the
    barrier."""
    try:
        os.remove(marker)
    except OSError:
        pass
    try:
        yield
    except BaseException:
        try:
            open(marker, "w").close()
        except OSError:
            pass
        raise
    finally:
        barrier(tag)


def await_published(tag: str, marker: str, what: str):
    """Peer side of :func:`publishing`: wait for process 0's release
    barrier, then turn its failure marker into an error."""
    barrier(tag)
    if os.path.exists(marker):
        raise RuntimeError(f"{what} failed on process 0 "
                           "(see its traceback)")


def owned_regions(tensor):
    """(index, np.ndarray) for each distinct region of ``tensor`` that this
    process owns: a region held by several processes (a replicated one)
    is claimed by the lowest rank that holds it, so a writer never writes
    a block twice. Empty regions are nobody's."""
    from torch.distributed.tensor import DTensor

    from nums_tpu_torch.core.grid import shard_region

    shape = tuple(tensor.shape)
    if not isinstance(tensor, DTensor):
        if process_index() != 0:
            return []
        return [(tuple(slice(0, s) for s in shape),
                 tensor.detach().cpu().numpy())]
    mesh = tensor.device_mesh
    dims = [p.dim if p.is_shard() else None for p in tensor.placements]
    ranks = mesh.mesh.cpu().numpy()
    owner = {}
    for rank in sorted(int(r) for r in ranks.reshape(-1)):
        coord = [int(c) for c in np.argwhere(ranks == rank)[0]]
        region = shard_region(shape, dims, ranks.shape, coord)
        if all(b > a for a, b in region):
            owner.setdefault(region, rank)
    mine = shard_region(shape, dims, ranks.shape, mesh.get_coordinate())
    if owner.get(mine) != process_index():
        return []
    return [(tuple(slice(a, b) for a, b in mine),
             tensor.to_local().detach().cpu().numpy())]
