"""The ``signal`` table of tests/mesh_signal_tables.py on the (2, 2) mesh
(a vector split over both mesh dimensions, or over the first alone where
it is shorter than four; the columns of X8 in (250, 4) blocks sharded
too): the port's mesh against nums_tpu's mesh and the port's serial
backend, one case an entry, each under the gather guard (each entry's
tolerance is the table's)."""

import pytest

import mesh_signal_tables as tables
from torch_parity import mesh_pool, torch_app  # noqa: F401

CLUSTER = (2, 2)


@pytest.fixture(scope="module")
def port_mesh(mesh_pool):
    return mesh_pool.run(tables.port_values, CLUSTER, timeout=120)


@pytest.fixture(scope="module")
def reference_mesh():
    return tables.reference_values(CLUSTER)


@pytest.fixture(scope="module")
def port_serial(torch_app):
    import nums_tpu_torch.numpy as nps

    from torch_parity import run_table

    return run_table(torch_app, nps, tables.TABLE)[0]


@pytest.mark.parametrize("name", tables.names())
def test_entry(port_mesh, reference_mesh, port_serial, name):
    tables.check(port_mesh, reference_mesh, port_serial, name)
