"""The ``random`` table of tests/mesh_random_tables.py (the faults C-M10
and C-M11 of the port's mesh, every sampler drawn shard by shard, the
permutation by the mesh's sample sort, and pinv, the (n, n) row products,
diag and diagflat without whole copies) on the (4, 1) mesh: the port's
mesh against nums_tpu's mesh and the port's serial backend, one case an
entry, each under the gather guard and the drawn-whole guard."""

import numpy as np
import pytest

import mesh_random_tables as tables
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


def _loop_traffic(cluster):
    """A sharded Poisson draw at lam = 50 (Hörmann's rejection) and one at
    lam = 4 (Knuth's product) under DTensor's ``CommDebugMode``: the
    collectives each issued, the rounds of the rejection loop
    (``random_ops.ROUNDS``) and the bytes this rank sent
    (``multiprocess.SENT``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from nums_tpu_torch.core import multiprocess
    from nums_tpu_torch.core.ops import random_ops
    from torch_parity import mesh_app

    app = mesh_app(cluster)
    out = {}
    for lam in (50.0, 4.0):
        rounds = random_ops.ROUNDS["rounds"]
        sent = multiprocess.SENT["bytes"]
        mode = CommDebugMode()
        with mode:
            app.random_state(3).poisson(lam, shape=(1003, 7),
                                        block_shape=(126, 7))
        out[lam] = ({str(k): v for k, v in mode.get_comm_counts().items()},
                    random_ops.ROUNDS["rounds"] - rounds,
                    multiprocess.SENT["bytes"] - sent)
    return out


def test_rejection_loop_makes_one_all_reduce_a_round(mesh_pool):
    """Hörmann's loop on a sharded grid makes one all-reduce a round (a
    flag of 4 bytes) and no other collective; Knuth's product, position-
    wise, makes none."""
    got = mesh_pool.run(_loop_traffic, CLUSTER)
    counts, rounds, sent = got[50.0]
    assert rounds > 1
    assert counts == {"c10d.allreduce_": rounds}, counts
    assert sent == rounds * (2 * 3 * 4 // 4), sent
    counts, rounds, sent = got[4.0]
    assert (counts, rounds, sent) == ({}, 0, 0)


def _ring_traffic(cluster):
    """``inner(X, X)`` of the 1003×7 operand under ``CommDebugMode``: the
    collectives, the bytes this rank sent, and the bytes of one padded row
    shard of X."""
    from torch.distributed.tensor.debug import CommDebugMode

    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.core import multiprocess
    from torch_parity import mesh_app

    app = mesh_app(cluster)
    x = app.array(tables.X7, block_shape=(126, 7))
    sent = multiprocess.SENT["bytes"]
    mode = CommDebugMode()
    with mode:
        y = nps.inner(x, x)
    sent = multiprocess.SENT["bytes"] - sent
    counts = {str(k): v for k, v in mode.get_comm_counts().items()}
    same = bool(np.allclose(y.get(), tables.X7 @ tables.X7.T, rtol=0,
                            atol=1e-12))
    return counts, sent, -(-1003 // 4) * 7 * 8, same


def test_ring_of_rows_sends_shards_and_gathers_nothing(mesh_pool):
    """The (n, n) product of the rows on (4, 1) is a ring of p − 1 hops:
    each rank sends p − 1 row shards of X and makes no all-gather."""
    counts, sent, shard, same = mesh_pool.run(_ring_traffic, CLUSTER)
    assert same
    assert not any("gather" in k for k in counts), counts
    assert sent == 3 * shard, (sent, shard)
