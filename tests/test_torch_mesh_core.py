"""The ``core`` table of tests/mesh_core_tables.py (the faults C-M1..C-M5
of the port's mesh, the distributed factorizations, the sharded draws and
a mask beside a device index) on the (4, 1) mesh: the port's mesh against
nums_tpu's mesh and the port's serial backend, one case an entry (each
entry's tolerances are the table's)."""

import pytest

import mesh_core_tables as core
from torch_parity import mesh_pool, torch_app  # noqa: F401

CLUSTER = (4, 1)


@pytest.fixture(scope="module")
def port_mesh(mesh_pool):
    return mesh_pool.run(core.port_values, CLUSTER)


@pytest.fixture(scope="module")
def reference_mesh():
    return core.reference_values(CLUSTER)


@pytest.fixture(scope="module")
def port_serial(torch_app):
    import nums_tpu_torch.numpy as nps

    from torch_parity import run_table

    return run_table(torch_app, nps, core.TABLE)[0]


@pytest.mark.parametrize("name", core.names())
def test_entry(port_mesh, reference_mesh, port_serial, name):
    core.check(port_mesh, reference_mesh, port_serial, name)
