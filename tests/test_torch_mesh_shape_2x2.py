"""The ``shape`` table of tests/mesh_shape_tables.py (the faults C-M6..C-M9
of the port's mesh: basic slices, reshapes, joins, moves, stencils, sorts
and selections along a sharded axis) on the (2, 2) mesh (the columns of X8 in (250, 4) blocks sharded too): the port's mesh
against nums_tpu's mesh and the port's serial backend, one case an entry,
each under the gather guard (each entry's tolerances are the table's)."""

import pytest

import mesh_shape_tables as shape
from torch_parity import mesh_pool, torch_app  # noqa: F401

CLUSTER = (2, 2)


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
