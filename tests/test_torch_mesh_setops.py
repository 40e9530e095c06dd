"""The ``setops`` table of tests/mesh_tables.py (unique, the set ops, the searches and the histograms) on the
(4, 1) mesh: the port's mesh against nums_tpu's mesh and the port's
serial backend, one case an entry (the tolerances are the table's)."""

import pytest

from mesh_tables import check_entry, names, table_fixtures
from torch_parity import mesh_pool, torch_app  # noqa: F401

port_mesh, reference_mesh, port_serial = table_fixtures("setops", (4, 1))


@pytest.mark.parametrize("name", names("setops"))
def test_entry(port_mesh, reference_mesh, port_serial, name):
    check_entry(port_mesh, reference_mesh, port_serial, name)
