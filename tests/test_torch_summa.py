"""The port's hand-scheduled mesh GEMMs (``core/ops/summa.py``) against
nums_tpu's (tests/core/ops/test_summa.py).

``choose_schedule`` and the ``*_supported`` predicates are pure functions
of the mesh's shape and the reference's padded extents: they are compared
with the reference's in this process. The schedules run in the 4 gloo
processes of ``mesh_pool`` on (4, 1) and (2, 2) meshes, against numpy and
against nums_tpu's mesh (its shard_map kernels) on the 8 virtual CPU
devices under the same ``collective_matmul`` mode, with the schedule each
product dispatched to (``LAST_DISPATCH``).

Tolerance: float64 products agree to 1e-12 of max|ref| (``REL``): the
schedules sum the same products in another order (a reduce-scatter of
partial products, the ring's steps, SUMMA's panels).
"""

import itertools

import numpy as np
import pytest

from torch_parity import mesh_app, mesh_pool, rel_err  # noqa: F401

REL = 1e-12
CLUSTERS = [(4, 1), (2, 2)]
MODES = ["ring", "summa", "auto"]


def _port_backend(cluster_shape):
    """The port's MeshBackend with its device grid and a stand-in mesh:
    dispatch reads only the mesh's shape."""
    from nums_tpu_torch.core.backend import MeshBackend
    from nums_tpu_torch.core.grid import DeviceGrid

    b = MeshBackend()
    b.device_grid = DeviceGrid(cluster_shape)
    b._mesh = object()
    return b


DISPATCH_SHAPES = [
    (16, 8), (8, 16), (8, 6), (15, 8), (16, 7), (7, 6), (4096, 4096),
    (8192, 8192), (16384, 16384), (20000, 1000), (1000, 1000), (12, 1024),
    (1024, 40000), (40000, 1024), (10_000_000, 1000), (1000, 1024),
]


@pytest.mark.parametrize("cluster", [(4, 1), (2, 2), (4, 2), (8,)])
def test_choose_schedule_and_predicates_match_reference(cluster):
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.ops import summa as jsumma
    from nums_tpu_torch.core.ops import summa

    ref = MeshBackend(cluster_shape=cluster).init()
    got = _port_backend(cluster)
    for a, b in itertools.product(DISPATCH_SHAPES, repeat=2):
        for name in ("tn_supported", "nt_supported", "ring_supported",
                     "supported"):
            assert getattr(summa, name)(got, a, b) == getattr(
                jsumma, name)(ref, a, b), (name, a, b)
        for ta, tb in itertools.product((False, True), repeat=2):
            for itemsize in (4, 8):
                assert summa.choose_schedule(
                    got, ta, tb, a, b, itemsize) == jsumma.choose_schedule(
                    ref, ta, tb, a, b, itemsize), (ta, tb, a, b, itemsize)
    for name in ("AUTO_TN_MAX_PARTIAL_BYTES", "AUTO_NT_MAX_GATHER_BYTES",
                 "AUTO_NN_GATHER_BUDGET_BYTES", "AUTO_RING_MIN_K_PANEL"):
        assert getattr(summa, name) == getattr(jsumma, name)


def _explicit_and_serial_none():
    """Dispatch on the serial backend: no mesh, no schedule."""
    from nums_tpu_torch.core.backend import SerialBackend
    from nums_tpu_torch.core.ops import summa

    b = SerialBackend(device="cpu").init()
    return (summa.supported(b, (16, 8), (8, 6)),
            summa.choose_schedule(b, True, False, (16, 8), (16, 8)))


def test_serial_backend_takes_no_schedule():
    assert _explicit_and_serial_none() == (False, None)


def _operands(cluster):
    """The operands of tests/core/ops/test_summa.py:92-157 for a mesh of
    ``cluster``'s shape, with their block shapes."""
    ms = tuple(cluster) + (1,) * (2 - len(cluster))
    rs = np.random.RandomState(4)
    m, k, n = 4 * ms[0], 4 * ms[0] * ms[1], 6 * ms[1]
    ops = {
        "a": (rs.randn(m, k), (m // ms[0], k)),
        "b": (rs.randn(k, n), (k // ms[0], n)),
        "at": (rs.randn(k, m), (k // ms[0], m)),
        "bt": (rs.randn(n * ms[0], k), (n, k)),
        "ar": (rs.randn(m + 1, k), (-(-(m + 1) // ms[0]), k)),
        "x": (rs.randn(4 * m + 3, n), (-(-(4 * m + 3) // ms[0]), n)),
    }
    ops["ones"] = (np.ones((m + 1, 8)), (-(-(m + 1) // ms[0]), 8))
    return ops


def _products(app, cluster, summa_module):
    """name -> (value, the schedule it dispatched to)."""
    arrays = {name: app.array(v, block_shape=bs)
              for name, (v, bs) in _operands(cluster).items()}
    a, b, at, bt = (arrays[k] for k in ("a", "b", "at", "bt"))
    exprs = {
        "nn": lambda: a @ b, "tn": lambda: at.T @ b, "nt": lambda: a @ bt.T,
        "tt": lambda: at.T @ bt.T, "ragged": lambda: arrays["ar"] @ b,
        "gram": lambda: arrays["x"].T @ arrays["x"],
        "ones_gram": lambda: arrays["ones"].T @ arrays["ones"],
    }
    out = {}
    for name, expr in exprs.items():
        summa_module.LAST_DISPATCH = None
        value = expr()
        out[name] = (np.asarray(value.get()), summa_module.LAST_DISPATCH)
    return out


def _schedule_case(cluster, mode):
    from nums_tpu_torch.core import settings
    from nums_tpu_torch.core.ops import summa

    app = mesh_app(cluster)
    old = settings.collective_matmul
    settings.collective_matmul = mode
    try:
        return _products(app, cluster, summa)
    finally:
        settings.collective_matmul = old


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_schedules_match_numpy_and_reference(mesh_pool, monkeypatch,
                                             cluster, mode):
    from nums_tpu.core import settings as jsettings
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.io.filesystem import FileSystem
    from nums_tpu.core.ops import summa as jsumma

    got = mesh_pool.run(_schedule_case, cluster, mode)
    monkeypatch.setattr(jsettings, "collective_matmul", mode)
    backend = MeshBackend(cluster_shape=cluster).init()
    ref = _products(ArrayApplication(backend, FileSystem(backend)), cluster,
                    jsumma)
    ops = {k: v for k, (v, _) in _operands(cluster).items()}
    want = {"nn": ops["a"] @ ops["b"], "tn": ops["at"].T @ ops["b"],
            "nt": ops["a"] @ ops["bt"].T, "tt": ops["at"].T @ ops["bt"].T,
            "ragged": ops["ar"] @ ops["b"], "gram": ops["x"].T @ ops["x"],
            "ones_gram": ops["ones"].T @ ops["ones"]}
    for name, (value, dispatch) in got.items():
        assert rel_err(value, want[name]) <= REL, (name, dispatch)
        assert rel_err(value, ref[name][0]) <= REL, (name, dispatch)
        assert dispatch == ref[name][1], (name, dispatch, ref[name][1])
    # The transposed patterns take their own schedule in every mode here
    # (under auto their panels are far below the budgets).
    assert got["tn"][1] == "tn" and got["nt"][1] == "nt"
    if mode == "ring":
        assert got["nn"][1] == "ring"
    if mode == "summa" and cluster == (2, 2):
        assert got["nn"][1] == "summa"


def _default_route_case(cluster):
    from nums_tpu_torch.core.ops import summa

    app = mesh_app(cluster)
    summa.LAST_DISPATCH = None
    x = app.array(np.arange(24.0).reshape(8, 3), block_shape=(2, 3))
    g = (x.T @ x).get()
    return g, summa.LAST_DISPATCH


def test_default_route_leaves_dispatch_unset(mesh_pool):
    """With collective matmul off (``"0"``, the default) the reference
    returns before it records a dispatch: so does the port."""
    g, dispatch = mesh_pool.run(_default_route_case, (4, 1))
    x = np.arange(24.0).reshape(8, 3)
    assert dispatch is None and rel_err(g, x.T @ x) <= REL


def _pieces_case(cluster):
    """Each schedule called directly on DTensors laid out as its in_specs
    say, ragged operands included (rows that do not divide the mesh)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from nums_tpu_torch.core.ops import summa

    app = mesh_app(cluster)
    b = app.backend
    rs = np.random.RandomState(7)
    out = {}

    def put(x, *dims):
        return distribute_tensor(torch.from_numpy(x), b.mesh,
                                 summa._spec(b, *dims))

    a, w = rs.randn(10, 7), rs.randn(7, 5)
    out["ring"] = summa.ring_matmul(b, put(a, 0), put(w, 0)).full_tensor()
    out["nt"] = summa.nt_matmul(b, put(a, 0), put(rs.randn(6, 7), 0))
    out["tn"] = summa.tn_matmul(b, put(a, 0), put(rs.randn(10, 3), 0))
    out["tn_same"] = summa.tn_matmul(b, put(a, 0), None, same=True)
    if cluster[1] > 1:
        out["summa"] = summa.summa_matmul(b, put(a, 0, 1), put(w, 0, 1))
    return {k: v.full_tensor().numpy() if hasattr(v, "full_tensor")
            else v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_each_schedule_on_ragged_operands(mesh_pool, cluster):
    got = mesh_pool.run(_pieces_case, cluster)
    rs = np.random.RandomState(7)
    a, w = rs.randn(10, 7), rs.randn(7, 5)
    want = {"ring": a @ w, "nt": a @ rs.randn(6, 7).T,
            "tn": a.T @ rs.randn(10, 3), "tn_same": a.T @ a}
    if cluster[1] > 1:
        want["summa"] = a @ w
    assert set(got) == set(want)
    for name in want:
        assert rel_err(got[name], want[name]) <= REL, name
