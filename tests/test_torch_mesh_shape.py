"""The ``shape`` table of tests/mesh_shape_tables.py (the faults C-M6..C-M9
of the port's mesh: basic slices, reshapes, joins, moves, stencils, sorts
and selections along a sharded axis) on the (4, 1) mesh: the port's mesh
against nums_tpu's mesh and the port's serial backend, one case an entry,
each under the gather guard (each entry's tolerances are the table's)."""

import numpy as np
import pytest

import mesh_shape_tables as shape
from torch_parity import jax_mesh, mesh_pool, torch_app  # noqa: F401

CLUSTER = (4, 1)


@pytest.fixture(scope="module")
def port_mesh(mesh_pool):
    return mesh_pool.run(shape.port_values, CLUSTER)


@pytest.fixture(scope="module")
def reference_mesh():
    return shape.reference_values(CLUSTER)


@pytest.fixture(scope="module")
def port_serial(torch_app):
    import nums_tpu_torch.numpy as nps

    from torch_parity import run_table

    return run_table(torch_app, nps, shape.TABLE)[0]


@pytest.mark.parametrize("name", shape.names())
def test_entry(port_mesh, reference_mesh, port_serial, name):
    shape.check(port_mesh, reference_mesh, port_serial, name)


@pytest.fixture(scope="module")
def sweep(mesh_pool):
    return mesh_pool.run(shape.sweep, CLUSTER, timeout=120)


def test_sweep_gathers_only_what_is_listed(sweep):
    shape.check_sweep(sweep, CLUSTER)


def test_layout_whole_is_the_references_layout(sweep, jax_mesh):
    shape.check_layout_whole(sweep, jax_mesh)


def _row_slice_traffic(cluster):
    """``X8[100:900]`` on the mesh under DTensor's ``CommDebugMode``: the
    collectives it issued, and the bytes each rank sent (``multiprocess
    .SENT``) beside the bytes of its rows that the result lays out on
    another rank."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from nums_tpu_torch.core import multiprocess
    from torch_parity import mesh_app

    app = mesh_app(cluster)
    x = app.array(shape.X8, block_shape=(250, 8))
    before = multiprocess.SENT["bytes"]
    mode = CommDebugMode()
    with mode:
        y = x[100:900]
    sent = multiprocess.SENT["bytes"] - before
    backend = app.backend
    lo, hi = backend.region(x.shape, x.raw.placements)[0]
    a, b = backend.region(y.shape, y.raw.placements)[0]
    # this rank's rows of the result's range, less those it keeps
    mine = set(range(max(lo, 100), min(hi, 900)))
    kept = mine & {r + 100 for r in range(a, b)}
    share = (len(mine) - len(kept)) * 8 * 8
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (sent, share))
    counts = {str(k): v for k, v in mode.get_comm_counts().items()}
    return counts, every, bool((y.get() == shape.X8[100:900]).all())


def test_row_slice_sends_its_share(mesh_pool):
    """A row slice on (4, 1) makes one all-to-all (no all-gather, DTensor's
    or the port's), and each rank sends no more than its rows that land
    on another rank."""
    counts, every, same = mesh_pool.run(_row_slice_traffic, (4, 1))
    assert same
    assert counts == {"c10d.alltoall_base_": 1}, counts
    for sent, share in every:
        assert sent <= share, (sent, share)


def _vector_ffts(cluster):
    """Each 1-D FFT of the sharded vector V (its NaNs as 0) under the
    gather guard: its value (None where it raised, with the message), and
    the gathers it made."""
    import nums_tpu_torch.numpy as nps
    from torch_parity import mesh_app, refusing_gathers

    app = mesh_app(cluster)
    out = {}
    for name in ("fft", "ifft", "rfft", "irfft", "hfft", "ihfft"):
        record = []
        undo = refusing_gathers(record)
        try:
            got = getattr(nps.fft, name)(app.array(
                np.nan_to_num(shape.V), block_shape=(126,)))
            undo()
            out[name] = (np.asarray(got.get()), None, record)
        except NotImplementedError as e:
            undo()
            out[name] = (None, str(e), record)
    return out


def test_fft_of_a_sharded_vector_answers(mesh_pool):
    """Every 1-D FFT of a sharded vector computes on the mesh (the
    distributed transform of ``core/ops/mesh_fft.py``), agrees with numpy
    and never gathers the vector."""
    v = np.nan_to_num(shape.V)
    for name, (got, said, gathered) in mesh_pool.run(_vector_ffts,
                                                     CLUSTER).items():
        assert said is None, (name, said)
        assert not gathered, (name, gathered)
        ref = getattr(np.fft, name)(v)
        assert got.shape == ref.shape and got.dtype == ref.dtype, name
        err = np.max(np.abs(got - ref))
        assert err <= 1e-12 * np.max(np.abs(ref)), (name, err)


def _beyond_the_chirp(cluster):
    """``fft`` of a sharded prime-length vector (1009: Bluestein) with the
    chirp's length limit (``mesh_fft.CHIRP_MAX_LENGTH``) set below it: the
    message of the error it raised on every rank, and the gathers made."""
    import torch.distributed as dist

    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core.ops import mesh_fft
    from torch_parity import mesh_app, refusing_gathers

    app = mesh_app(cluster)
    saved = mesh_fft.CHIRP_MAX_LENGTH
    mesh_fft.CHIRP_MAX_LENGTH = 1000
    record = []
    undo = refusing_gathers(record)
    said = None
    try:
        nps.fft.fft(app.array(np.arange(1009.0), block_shape=(126,)))
    except NotImplementedError as e:
        said = str(e)
    finally:
        undo()
        mesh_fft.CHIRP_MAX_LENGTH = saved
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (said, record))
    return every


def test_fft_of_a_sharded_vector_raises(mesh_pool):
    """A 1-D FFT of a sharded vector that the mesh cannot compute without a
    whole copy (here a length past the chirp's limit) raises
    NotImplementedError naming itself on every rank, and gathers
    nothing."""
    for said, gathered in mesh_pool.run(_beyond_the_chirp, CLUSTER):
        assert said is not None and "fft of length 1009" in said, said
        assert not gathered, gathered
