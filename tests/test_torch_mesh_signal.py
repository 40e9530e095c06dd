"""The ``signal`` table of tests/mesh_signal_tables.py (the distributed
1-D FFT of a sharded vector, the n-D transforms and the shifts without
whole copies, ``convolve``/``correlate``/``polymul`` of two sharded
operands on a ring, ``poly`` of sharded roots, quantiles at a sharded q)
on the (4, 1) mesh: the port's mesh against nums_tpu's mesh and the
port's serial backend, one case an entry, each under the gather guard
(each entry's tolerance is the table's), and the traffic of a transform
and of a ring."""

import numpy as np
import pytest

import mesh_signal_tables as tables
from torch_parity import mesh_pool, torch_app  # noqa: F401

CLUSTER = (4, 1)


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


def _traffic(cluster):
    """Under DTensor's ``CommDebugMode``: ``fft`` of the sharded complex
    vector of 1000 (four-step, 25×40) and ``convolve`` of the sharded V by
    the sharded W (W's shards on a ring); for each, the collectives it
    issued, the bytes this rank sent (``multiprocess.SENT``) and whether
    the value is numpy's, on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core import multiprocess
    from torch_parity import mesh_app

    app = mesh_app(cluster)
    x = app.array(tables.CPLX[1000], block_shape=(126,))
    v = app.array(tables.V, block_shape=(126,))
    w = app.array(tables.W, block_shape=(40,))
    out = {}
    for name, fn, ref in (
            ("fft", lambda: nps.fft.fft(x), np.fft.fft(tables.CPLX[1000])),
            ("convolve", lambda: nps.convolve(v, w),
             np.convolve(tables.V, tables.W))):
        sent = multiprocess.SENT["bytes"]
        mode = CommDebugMode()
        with mode:
            res = fn()
        sent = multiprocess.SENT["bytes"] - sent
        counts = {str(k): c for k, c in mode.get_comm_counts().items() if c}
        got = np.asarray(res.get())
        same = bool(np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref)))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, sent)
        out[name] = (counts, every, same)
    return out


def test_transform_and_ring_send_their_share(mesh_pool):
    """The four-step ``fft`` of a sharded complex vector of 1000 on (4, 1)
    makes four all-to-alls (the runs to whole rows of the 25×40 view, and
    three transposes) and each rank sends at most its 250-element shard
    of 16 bytes a move; ``convolve`` of two sharded vectors makes one
    all-to-all for the halo and P − 1 = 3 for the ring, each rank sending
    one shard of W (at most 76 elements) a step and at most its window
    of V (its 251 outputs and 300 more). No all-gather anywhere."""
    got = mesh_pool.run(_traffic, CLUSTER)
    counts, every, same = got["fft"]
    assert same
    assert counts == {"c10d.alltoall_base_": 4}, counts
    assert max(every) <= 4 * 250 * 16, every
    counts, every, same = got["convolve"]
    assert same
    assert counts == {"c10d.alltoall_base_": 4}, counts
    assert max(every) <= 3 * 76 * 8 + (251 + 300) * 8, every
