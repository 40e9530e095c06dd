"""The port's multi-controller layer (``core/multiprocess.py``) against
nums_tpu's (``nums_tpu/core/multiprocess.py``).

Single-process identities run in this process; the collective ones in the
4 gloo processes of ``mesh_pool``. ``owned_regions`` is held to the
reference's on nums_tpu's mesh over the 8 virtual CPU devices: each
region's values, and every element owned exactly once.
"""

import os

import numpy as np
import pytest

from torch_parity import mesh_app, mesh_pool  # noqa: F401


def test_single_process_identities(tmp_path):
    import torch

    from nums_tpu.core import multiprocess as jmp
    from nums_tpu_torch.core import multiprocess

    assert multiprocess.process_count() == jmp.process_count() == 1
    assert multiprocess.process_index() == jmp.process_index() == 0
    assert multiprocess.is_multiprocess() is jmp.is_multiprocess() is False
    multiprocess.barrier("alone")
    multiprocess.checked_barrier("alone", True, "nothing")
    x = torch.arange(6.0).reshape(2, 3)
    assert np.array_equal(multiprocess.allgather_to_host(x), x.numpy())
    regions = multiprocess.owned_regions(x)
    assert len(regions) == 1 and np.array_equal(regions[0][1], x.numpy())
    marker = str(tmp_path / "failed")
    with multiprocess.publishing("alone", marker):
        pass
    multiprocess.await_published("alone", marker, "nothing")
    assert not os.path.exists(marker)


def test_environment_names_the_group(monkeypatch):
    from nums_tpu_torch.core import multiprocess

    for name in ("NUMS_TPU_TORCH_COORDINATOR", "NUMS_TPU_TORCH_INIT_FILE",
                 "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multiprocess._env_config() is None
    monkeypatch.setenv("NUMS_TPU_TORCH_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("NUMS_TPU_TORCH_NUM_PROCESSES", "4")
    monkeypatch.setenv("NUMS_TPU_TORCH_PROCESS_ID", "2")
    assert multiprocess._env_config() == ("tcp://localhost:1234", 4, 2)
    assert multiprocess.local_rank() == 2
    monkeypatch.setenv("NUMS_TPU_TORCH_INIT_FILE", "/x/rendezvous")
    assert multiprocess._env_config() == ("file:///x/rendezvous", 4, 2)
    for name in ("NUMS_TPU_TORCH_COORDINATOR", "NUMS_TPU_TORCH_INIT_FILE"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multiprocess._env_config() == ("env://", 8, 3)
    assert multiprocess.local_rank() == 1


def _identities():
    from nums_tpu_torch.core import multiprocess

    return (multiprocess.process_count(), multiprocess.is_multiprocess(),
            [multiprocess.process_index()])


def _gathered(cluster):
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess

    app = mesh_app(cluster)
    x = np.arange(91.0).reshape(13, 7)
    bx = app.array(x, block_shape=(4, 3))
    full = multiprocess.allgather_to_host(bx.raw)
    ok = [None] * dist.get_world_size()
    dist.all_gather_object(ok, bool(np.array_equal(full, x)))
    return ok, multiprocess.process_index()


@pytest.mark.parametrize("cluster", [(4, 1), (2, 2)])
def test_allgather_to_host(mesh_pool, cluster):
    assert mesh_pool.run(_identities) == (4, True, [0])
    ok, rank = mesh_pool.run(_gathered, cluster)
    assert ok == [True] * 4 and rank == 0


def _checked(failing):
    """One rank fails its stage; every rank reports what it saw."""
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess

    me = multiprocess.process_index()
    ok, err = True, None
    try:
        if me == failing:
            raise OSError("disk full")
    except OSError as e:
        ok, err = False, e
    try:
        multiprocess.checked_barrier("write:blocks", ok, "write blocks")
        seen = "own error" if err is not None else "passed"
    except RuntimeError as e:
        seen = "peer failed" if "peer" in str(e) else repr(e)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, seen)
    return out


def test_checked_barrier_with_one_failing_rank(mesh_pool):
    """Rank 2 fails: it re-raises its own error at the call site, and
    every other rank raises at the barrier; none waits for the next
    collective."""
    got = mesh_pool.run(_checked, 2, timeout=30)
    assert got == ["peer failed", "peer failed", "own error", "peer failed"]
    got = mesh_pool.run(_checked, -1, timeout=30)
    assert got == ["passed"] * 4


def _published(root, fail):
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess

    marker = os.path.join(root, "publish.failed")
    me = multiprocess.process_index()
    try:
        if me == 0:
            with multiprocess.publishing("publish", marker):
                if fail:
                    raise OSError("torn write")
        else:
            multiprocess.await_published("publish", marker, "publish")
        seen = "ok"
    except (OSError, RuntimeError) as e:
        seen = type(e).__name__
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, seen)
    return out, os.path.exists(marker)


def test_publishing_and_await_published(mesh_pool, tmp_path):
    got, marker = mesh_pool.run(_published, str(tmp_path), True)
    assert got == ["OSError"] + ["RuntimeError"] * 3 and marker
    # A retry consumes the stale marker and succeeds everywhere.
    got, marker = mesh_pool.run(_published, str(tmp_path), False)
    assert got == ["ok"] * 4 and not marker


def _owned(cluster, shape, block):
    import torch.distributed as dist

    from nums_tpu_torch.core import multiprocess

    app = mesh_app(cluster)
    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    bx = app.array(x, block_shape=block)
    mine = [(tuple((s.start, s.stop) for s in index), value)
            for index, value in multiprocess.owned_regions(bx.raw)]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return [r for rank in out for r in rank]


@pytest.mark.parametrize("cluster", [(4, 1), (2, 2)])
@pytest.mark.parametrize("shape,block", [((16, 8), (4, 4)), ((13, 9), (4, 3)),
                                         ((12,), (3,)), ((5, 3), (5, 3))])
def test_owned_regions_cover_once(mesh_pool, cluster, shape, block):
    from nums_tpu.core import multiprocess as jmp
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.io.filesystem import FileSystem

    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    got = mesh_pool.run(_owned, cluster, shape, block)
    count = np.zeros(shape, dtype=int)
    for box, value in got:
        index = tuple(slice(a, b) for a, b in box)
        assert np.array_equal(value, x[index])
        count[index] += 1
    assert (count == 1).all()
    # The reference's regions (its padded shards, clipped to the logical
    # shape) are the port's wherever one mesh axis shards each array axis.
    backend = MeshBackend(cluster_shape=cluster).init()
    ref = ArrayApplication(backend, FileSystem(backend)).array(
        x, block_shape=block)
    want = set()
    for index, _ in jmp.owned_regions(ref.raw):
        box = tuple((min(s.start or 0, d), min(s.stop or d, d))
                    for s, d in zip(index, shape))
        if all(b > a for a, b in box):
            want.add(box)
    spec = backend.spec_for_shape(shape, ref.grid.grid_shape)
    if not any(isinstance(ax, tuple) for ax in spec):
        assert {box for box, _ in got} == want
