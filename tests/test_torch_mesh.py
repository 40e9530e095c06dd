"""The port's mesh backend against nums_tpu's (tests/core/test_backend.py,
tests/core/array/test_ragged.py).

nums_tpu's mesh runs here on the 8 virtual CPU devices of
tests/conftest.py; the port's runs in 4 gloo processes (``mesh_pool``),
each case a function of this module run on every rank. Placements are
compared entry for entry with the reference's ``spec_for_shape`` and
padded extents; values with the reference's mesh and with the port's
serial backend.

Tolerance: float64 results agree to 1e-12 of max|ref| (``REL``). The only
difference from a one-device run is the order of the sums that the
collectives join (an all-reduce of partial sums), a few ulp.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    jax_mesh, mesh_app, mesh_pool, rel_err, torch_app,
)

REL = 1e-12
RAGGED_SHAPES = [(13, 9), (1003, 7), (10, 3)]
CLUSTERS = [(4, 1), (2, 2)]
# (shape, grid shape hint) of tests/core/test_backend.py:18-60, and two
# ragged ones.
PLACED = [((8, 4), None), ((10, 4), None), ((8, 3), None), ((2, 4), None),
          ((16,), None), ((12,), None), ((7,), None), ((3,), None),
          ((8, 4), (1, 2)), ((1003, 7), (4, 1)), ((13, 9), (4, 3))]


def _port_backend(cluster_shape):
    """The port's MeshBackend with only its device grid: the placement rule
    is a function of the mesh's shape."""
    from nums_tpu_torch.core.backend import MeshBackend
    from nums_tpu_torch.core.grid import DeviceGrid

    b = MeshBackend()
    b.device_grid = DeviceGrid(cluster_shape)
    return b


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("cluster", [(4, 1), (2, 2), (4, 2)])
def test_spec_rules_match_reference(monkeypatch, cluster, pad):
    from torch.distributed.tensor import Replicate, Shard

    from nums_tpu.core import settings as jsettings
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu_torch.core import settings

    monkeypatch.setattr(jsettings, "pad_shard", pad)
    monkeypatch.setattr(settings, "pad_shard", pad)
    ref = MeshBackend(cluster_shape=cluster).init()
    got = _port_backend(cluster)
    for shape, hint in PLACED:
        spec = tuple(ref.spec_for_shape(shape, hint))
        assert got.spec_for_shape(shape, hint) == spec, (shape, hint)
        assert got.physical_shape(shape, hint) == tuple(
            ref.physical_shape(shape, hint)), (shape, hint)
        # One placement per mesh dimension: Shard(k) where axis k uses it.
        want = [Replicate()] * len(cluster)
        for k, ax in enumerate(spec):
            for name in (ax if isinstance(ax, tuple) else (ax,)):
                if name is not None:
                    want[int(name[1:])] = Shard(k)
        assert got.sharding_for_shape(shape, hint) == tuple(want)


def _grid_hint(shape, hint):
    """The grid shape a test places ``shape`` with: ``hint``, or two
    blocks an axis (a single-block axis stays replicated)."""
    return hint or tuple(min(s, 2) for s in shape)


def _placed_regions(cluster, shape, grid_shape):
    """Every rank's region of an array placed by the grid, whether it
    holds those values, and whether DTensor's own ``distribute_tensor``
    gives the same local part for the same placements."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from nums_tpu_torch.core.array.blockarray import BlockArray

    app = mesh_app(cluster)
    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    block = tuple(-(-s // g) for s, g in zip(shape, grid_shape))
    ba = BlockArray.from_np(x, block_shape=block, backend=app.backend)
    local = ba.raw.to_local().numpy()
    box = app.backend.region(shape, ba.raw.placements)
    own = distribute_tensor(torch.from_numpy(x), app.backend.mesh,
                            ba.raw.placements).to_local().numpy()
    ok = (np.array_equal(local, x[tuple(slice(a, b) for a, b in box)])
          and np.array_equal(own, local))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (box, ok, np.array_equal(ba.get(), x)))
    return out


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_each_rank_holds_the_reference_rows(mesh_pool, cluster):
    """Each rank's region is DTensor's own for its placements, and where
    one mesh dimension shards an axis, it is the logical part of the
    reference's padded shard on the device of the same index (an empty
    part where the reference's shard is all pad)."""
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.grid import ArrayGrid

    ref = MeshBackend(cluster_shape=cluster).init()
    for shape, hint in PLACED:
        grid_shape = _grid_hint(shape, hint)
        regions = mesh_pool.run(_placed_regions, cluster, shape, grid_shape)
        assert all(ok and whole for _, ok, whole in regions), (shape, hint)
        spec = ref.spec_for_shape(shape, grid_shape)
        if any(isinstance(ax, tuple) for ax in spec):
            continue  # 1-D over the whole mesh: DTensor's nested chunks
        block = tuple(-(-s // g) for s, g in zip(shape, grid_shape))
        grid = ArrayGrid(shape, block, "float64")
        pshape = ref.physical_shape(shape, grid.grid_shape)
        data = ref.device_put(np.zeros(pshape), grid)
        index = {s.device.id: s.index for s in data.addressable_shards}
        for rank, (box, _, _) in enumerate(regions):
            want = []
            for sl, dim, p in zip(index[rank], shape, pshape):
                a, b = min(sl.start or 0, dim), min(sl.stop or p, dim)
                want.append((a, b) if b > a else None)
            have = [(a, b) if b > a else None for a, b in box]
            assert have == want, (shape, hint, rank)


def _too_few(cluster):
    from nums_tpu_torch.core import application_manager

    try:
        application_manager.create(device="cpu", backend="mesh",
                                   cluster_shape=cluster)
    except ValueError as e:
        return str(e)
    return None


def test_mesh_shape_must_match_the_processes(mesh_pool):
    """The reference accepts a mesh smaller than the device count; the
    port needs one process per device and raises on any other product."""
    for cluster in [(8, 1), (2, 4), (3, 1), (2, 1)]:
        msg = mesh_pool.run(_too_few, cluster)
        assert msg is not None and "processes" in msg, cluster


def test_single_process_mesh_is_one_device():
    from nums_tpu_torch.core import application_manager

    with pytest.raises(ValueError, match="processes"):
        application_manager.create(device="cpu", backend="mesh",
                                   cluster_shape=(2, 1))
    app = application_manager.create(device="cpu", backend="mesh")
    try:
        assert app.backend.cluster_shape == (1, 1)
        x = np.arange(12.0).reshape(4, 3)
        bx = app.array(x, block_shape=(2, 3))
        assert np.array_equal((bx.T @ bx).get(), x.T @ x)
    finally:
        app.backend.shutdown()
    import torch.distributed as dist

    assert not dist.is_initialized()


def _ragged_ops(app, shape):
    """The ops of tests/core/array/test_ragged.py on one ragged shape, in
    the API both packages share; returns name -> host value."""
    rs = np.random.RandomState(3)
    x = rs.randn(*shape)
    y = np.random.RandomState(4).randn(*shape)
    bs = (max(1, shape[0] // 4), shape[1])
    bx, by = app.array(x, block_shape=bs), app.array(y, block_shape=bs)
    v = np.arange(shape[1], dtype=float) + 1.0
    bv = app.array(v, block_shape=(shape[1],))
    w = np.arange(shape[0], dtype=float)
    bw = app.array(w, block_shape=(max(1, shape[0] // 4),))
    col = app.array(x[:, 0], block_shape=(max(1, shape[0] // 4),))
    out = {
        "add": bx + by, "axpy": bx * 2.0 - by, "exp": app.exp(bx),
        "abs": app.abs(bx), "div_row": bx / bv, "gt": bx > 0,
        "sum": bx.sum(), "sum0": bx.sum(axis=0), "sum1": bx.sum(axis=1),
        "mean0": bx.mean(axis=0), "min0": bx.min(axis=0), "max": bx.max(),
        "var0": bx.var(axis=0, ddof=1), "std": bx.std(),
        "prod1": bx.prod(axis=1), "keep": bx.sum(axis=1, keepdims=True),
        "argmin": col.argmin(), "argmax": col.argmax(),
        "argmax0": bx.argmax(axis=0), "T": bx.T, "gram": bx.T @ bx,
        "outer": bx @ bx.T, "exp_T": app.exp(bx.T), "mv": bx @ bv,
        "tmv": bx.T @ bw, "ravel": bx.reshape(shape[0] * shape[1]),
        "ones": app.ones(shape, bs), "full": app.full(shape, bs, 2.5),
        "eye": app.eye((shape[0], shape[0]), (bs[0], bs[0])),
        "arange": app.arange((shape[0],), (bs[0],)),
        "linspace": app.linspace(2.0, 3.0, (shape[0],), (bs[0],)),
    }
    return {k: np.asarray(a.get()) for k, a in out.items()}


def _ragged_case(cluster, shape):
    return _ragged_ops(mesh_app(cluster), shape)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_ops_match_reference_and_serial(mesh_pool, torch_app,
                                               cluster, shape):
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.io.filesystem import FileSystem

    got = mesh_pool.run(_ragged_case, cluster, shape)
    backend = MeshBackend(cluster_shape=cluster).init()
    ref = _ragged_ops(ArrayApplication(backend, FileSystem(backend)), shape)
    serial = _ragged_ops(torch_app, shape)
    assert set(got) == set(ref) == set(serial)
    for name in got:
        for other, what in ((ref, "nums_tpu mesh"), (serial, "port serial")):
            assert got[name].shape == other[name].shape, (name, what)
            assert got[name].dtype == other[name].dtype, (name, what)
            if got[name].dtype.kind in "biu":
                assert np.array_equal(got[name], other[name]), (name, what)
            else:
                assert rel_err(got[name], other[name]) <= REL, (name, what)


def _draws(cluster, seed):
    app = mesh_app(cluster)
    a = app.random_state(seed).normal(shape=(1003, 5), block_shape=(126, 5))
    b = app.random_state(seed).normal(shape=(1003, 5),
                                      block_shape=(1003, 5))
    # Columns sharded on the (2, 2) mesh: the draw goes by rows, a block
    # of whole rows at a time, each process keeping its columns.
    c = app.random_state(seed).uniform(shape=(13, 9), block_shape=(4, 3))
    d = app.random_state(seed).random(shape=(1003,), block_shape=(126,))
    return {"a": a.get(), "b": b.get(), "c": c.get(), "d": d.get(),
            "c_local": tuple(c.raw.to_local().shape)}


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_seed_invariance(mesh_pool, torch_app, cluster):
    """Same seed, same values, whatever the blocks and the mesh: each
    process draws its own positions, and the array equals the one-device
    draw bit for bit."""
    got = mesh_pool.run(_draws, cluster, 42)
    assert np.array_equal(got["a"], got["b"])
    rs = torch_app.random_state(42)
    assert np.array_equal(got["a"], rs.normal(shape=(1003, 5)).get())
    rs = torch_app.random_state(42)
    assert np.array_equal(got["c"], rs.uniform(shape=(13, 9)).get())
    rs = torch_app.random_state(42)
    assert np.array_equal(got["d"], rs.random(shape=(1003,)).get())
    if cluster == (2, 2):
        assert got["c_local"] == (7, 5)


def _unstrategied(cluster):
    """The mask, where and searchsorted cases that once raised on the mesh
    (their values now), and a selection along a sharded axis, which once
    raised too."""
    import nums_tpu_torch.numpy as nps

    app = mesh_app(cluster)
    bx = app.array(np.arange(12.0).reshape(4, 3), block_shape=(1, 3))
    return {"mask": bx[bx > 5.0].get(),
            "where": [a.get() for a in app.where(bx > 5.0)],
            "searchsorted": nps.searchsorted(bx[:, 0], bx[:, 1]).get(),
            "partition": nps.partition(bx, 1, axis=0).get(),
            "argpartition": nps.argpartition(bx, 1, axis=0).get()}


def test_ops_without_a_strategy_raise(mesh_pool, torch_app, jax_mesh):
    """DTensor has no sharding strategy for an op whose output shape
    depends on the data (nonzero) or for searchsorted, nor for a selection
    along a sharded axis (partition, argpartition): the mesh's own branch
    (core/ops/mesh_ops.py) gives the values of nums_tpu's mesh and of the
    serial port, and nothing gathers quietly."""
    import nums_tpu.numpy as jnps
    import nums_tpu_torch.numpy as nps

    got = mesh_pool.run(_unstrategied, (4, 1))
    x = np.arange(12.0).reshape(4, 3)
    for app, numpy in ((jax_mesh, jnps), (torch_app, nps)):
        bx = app.array(x, block_shape=(1, 3))
        assert np.array_equal(got["mask"], bx[bx > 5.0].get())
        for g, r in zip(got["where"], app.where(bx > 5.0)):
            assert np.array_equal(g, r.get())
        assert np.array_equal(got["searchsorted"], numpy.searchsorted(
            bx[:, 0], bx[:, 1]).get())
        assert np.array_equal(got["partition"], numpy.partition(
            bx, 1, axis=0).get())
        assert np.array_equal(got["argpartition"], numpy.argpartition(
            bx, 1, axis=0).get())


def _spd(n):
    a = np.random.RandomState(5).randn(n, n)
    return a @ a.T + n * np.eye(n)


def _sharded_operands(cluster):
    """The small factorizations, a gamma draw and a Poisson draw at lam >=
    10 (Hörmann's rejection, which runs to the whole draw's round count)
    on sharded operands, with whole copies refused (tests/torch_parity.py's
    ``refusing_gathers``)."""
    from torch_parity import refusing_gathers

    app = mesh_app(cluster)
    a = app.array(_spd(8), block_shape=(2, 8))
    b = app.array(np.arange(8.0), block_shape=(2,))
    out = {"placements": str(a.raw.placements)}
    undo = refusing_gathers()
    try:
        res = {"inv": app.inv(a), "cholesky": app.cholesky(a),
               "posdef_solve": app.posdef_solve(a, b),
               "gamma": app.random_state(3).gamma(
                   2.0, 1.5, shape=(13, 9), block_shape=(4, 9)),
               "poisson": app.random_state(3).poisson(
                   12.0, shape=(13, 9), block_shape=(4, 9))}
    finally:
        undo()
    out.update({k: v.get() for k, v in res.items()})
    return out


def test_sharded_operands_raise_and_never_gather(mesh_pool, jax_mesh,
                                                 torch_app):
    """inv, cholesky and posdef_solve of a sharded square matrix compute
    (``core/ops/mesh_linalg.py``) and equal nums_tpu's mesh within the
    reference's tolerance, and a sharded gamma draw and a sharded Poisson
    draw at lam >= 10 (each process its own positions, the rejection
    loop's flag combined over the mesh once a round) equal the serial
    draws bit for bit, none gathering an operand whole."""
    got = mesh_pool.run(_sharded_operands, (4, 1))
    assert "Shard(dim=0)" in got["placements"]
    spd, b = _spd(8), np.arange(8.0)
    ja = jax_mesh.array(spd, block_shape=(2, 8))
    ref = {"inv": jax_mesh.inv(ja).get(),
           "cholesky": jax_mesh.cholesky(ja).get(),
           "posdef_solve": jax_mesh.posdef_solve(
               ja, jax_mesh.array(b, block_shape=(2,))).get()}
    for name, want in ref.items():
        assert rel_err(got[name], want) <= 1e-10, name
    serial = torch_app.random_state(3).gamma(2.0, 1.5, shape=(13, 9),
                                             block_shape=(4, 9)).get()
    assert np.array_equal(got["gamma"], serial)
    serial = torch_app.random_state(3).poisson(12.0, shape=(13, 9),
                                               block_shape=(4, 9)).get()
    assert got["poisson"].dtype == serial.dtype
    assert np.array_equal(got["poisson"].view(np.uint8),
                          serial.view(np.uint8))


def _replicated_small(app):
    """The small factorizations of a replicated square matrix, a draw that
    is not position-wise on a replicated grid, and a row-sharded array
    resharded to one block (``device_reshard``)."""
    from nums_tpu_torch.core.grid import ArrayGrid

    a = app.array(_spd(8), block_shape=(8, 8))
    b = app.array(np.arange(8.0), block_shape=(8,))
    out = {"inv": app.inv(a).get(), "cholesky": app.cholesky(a).get(),
           "solve": app.posdef_solve(a, b).get(),
           "gamma": app.random_state(3).gamma(
               2.0, 1.5, shape=(13, 9), block_shape=(13, 9)).get()}
    if app.backend.mesh is not None:
        bx = app.array(np.arange(40.0).reshape(10, 4), block_shape=(3, 4))
        whole = app.backend.device_reshard(
            bx.raw, ArrayGrid((10, 4), (10, 4), "float64"))
        out["resharded"] = whole.to_local().numpy()
        out["placements"] = str(whole.placements)
    return out


def _replicated_case(cluster):
    return _replicated_small(mesh_app(cluster))


def test_replicated_small_values_compute_on_each_copy(mesh_pool,
                                                      torch_app):
    """A replicated operand is factorized on each process's own copy and
    equals the serial backend's result; a draw that is not position-wise
    on a replicated grid equals the serial draw bit for bit;
    ``device_reshard`` to one block replicates the rows."""
    got = mesh_pool.run(_replicated_case, (4, 1))
    serial = _replicated_small(torch_app)
    for name in ("inv", "cholesky", "solve"):
        assert rel_err(got[name], serial[name]) <= REL, name
    assert np.array_equal(got["gamma"], serial["gamma"])
    assert np.array_equal(got["resharded"], np.arange(40.0).reshape(10, 4))
    assert "Shard" not in got["placements"]


@pytest.mark.parametrize("dist,params", [("random", ()),
                                         ("uniform", (-2.0, 3.0)),
                                         ("normal", (1.0, 2.0)),
                                         ("gamma", (2.0, 1.5)),
                                         ("beta", (2.0, 3.0)),
                                         ("standard_t", (4.0,)),
                                         ("vonmises", (0.5, 2.0)),
                                         ("weibull", (1.5,)),
                                         ("poisson", (12.0,)),
                                         ("binomial", (40.0, 0.5))])
@pytest.mark.parametrize("shape,box", [
    ((13, 9), ((4, 8), (0, 9))), ((13, 9), ((4, 8), (3, 6))),
    ((13, 9), ((0, 13), (5, 9))), ((5, 4, 6), ((1, 4), (0, 4), (2, 5))),
    ((5, 4, 6), ((1, 4), (1, 3), (0, 6))), ((17,), ((5, 11),)),
    ((13, 9), ((13, 13), (0, 9))), ((13, 9), ((0, 13), (0, 9)))])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sample_region_is_the_box_of_the_draw(dist, params, shape, box,
                                              dtype):
    """A process's box of a draw (whole rows: one flat range; a column
    shard: one range per row) equals that box of the whole draw, bit for
    bit; a sampler whose loop runs to the whole draw's round count
    (poisson at lam >= 10, binomial by BTRS) draws a smaller box only on
    the mesh (every process of a multi-process run drawing its own box),
    and outside one raises naming itself."""
    import torch

    from nums_tpu_torch.core.ops import random_ops, threefry

    key = threefry.fold_in(threefry.seed_key(7, True), 3)
    dt = getattr(torch, dtype)
    whole = random_ops.sample(dist, key, shape, dt, "cpu", True, *params)
    if dist not in random_ops._FLAT and tuple(b - a for a, b in box) != shape:
        # A box alone cannot know the whole draw's round count: without a
        # mesh it is not drawn, and the whole array is not drawn to keep
        # it.
        with pytest.raises(NotImplementedError, match=dist):
            random_ops.sample_region(dist, key, shape, box, dt, "cpu", True,
                                     *params)
        return
    got = random_ops.sample_region(dist, key, shape, box, dt, "cpu", True,
                                   *params)
    assert torch.equal(got, whole[tuple(slice(a, b) for a, b in box)])
