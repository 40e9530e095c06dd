"""Indexing, assignment, masking, reshape and the ndarray methods of the
port's BlockArray against nums_tpu.

Each case runs the same numpy inputs through both packages' serial
applications on the CPU (x64 on) and compares shape, dtype and value:
exact for gathers, writes, masks and indices; within the elementwise
class of tests/torch_parity.py for the float methods. Where the reference
raises, the port raises the same exception type. The cases are those of
tests/core/array/test_access.py, test_reshape.py, test_ndarray_methods.py
and tests/core/ops/test_masking.py, at several block shapes (one ragged),
and the assignment aliasing case: a view taken before a write keeps its
values.
"""

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    assert_parity, jax_app, run_parity, torch_app,
)

import nums_tpu.numpy as jnps
import nums_tpu_torch.numpy as tnps
from nums_tpu.core.array.blockarray import BlockArray as JBA
from nums_tpu_torch.core.array.blockarray import BlockArray as TBA
from nums_tpu_torch.core.ops import masking

RS = np.random.RandomState(0)
X = RS.randn(21, 13)
BLOCKS = [(6, 5), (21, 13), (5, 4)]

SUBSCRIPTS = [
    (slice(None),), (slice(3, 17),), (slice(None), slice(2, 9)),
    (slice(1, 20, 3),), (slice(None, None, -1),),
    (slice(18, 2, -2), slice(None, None, -1)), (5,), (slice(None), 7),
    (3, 4), (-1, -2), (slice(-8, -2),), (Ellipsis, 0), (None, 2),
    (slice(None, None, -3),), (Ellipsis, None), (slice(2, 9), None, 3),
    (np.array([0, 5, 20]), np.array([12, 0, 4])),
    (np.array([[0], [5]]), np.array([[1, 2]])),
    (slice(2, 7), np.array([12, 0, 4])),
    (np.array([3, 3, 0, -1]),), (slice(None), [3, 1, 4]),
    (slice(None, None, -2), np.array([1, 3])),
    (np.array([2, 4]), slice(None, None, -1)),
    (X[:, 0] > 0,), (X > 0.5,), (X[:, 0] > 0, slice(1, 4)),
]


def both(jax_app, torch_app, fn, tol="elementwise"):
    """``fn(app, nps)`` in both packages, compared."""
    assert_parity(run_parity(lambda: fn(torch_app, tnps)),
                  run_parity(lambda: fn(jax_app, jnps)), tol)


@pytest.mark.parametrize("bs", BLOCKS)
@pytest.mark.parametrize("i", range(len(SUBSCRIPTS)))
def test_getitem(jax_app, torch_app, i, bs):
    ss = SUBSCRIPTS[i]
    both(jax_app, torch_app, lambda app, nps: app.array(X, bs)[ss])


@pytest.mark.parametrize("i", range(len(SUBSCRIPTS)))
def test_getitem_of_lazy_transpose(jax_app, torch_app, i):
    """The same subscripts on a lazily transposed array holding X."""
    ss = SUBSCRIPTS[i]
    both(jax_app, torch_app,
         lambda app, nps: app.array(X.T.copy(), (5, 6)).T[ss])


def test_device_mask_and_index_read(jax_app, torch_app):
    def fn(app, nps):
        bx = app.array(X, (6, 5))
        idx = app.array(np.array([20, 0, 7]), (3,))
        return (bx[bx > 0.3], bx[bx[:, 0] < 0], bx[idx], bx[:, idx],
                bx[idx, idx])

    both(jax_app, torch_app, fn)


def _setitem_sequence(app, nps, bs):
    rs = np.random.RandomState(1)
    x = rs.randn(12, 10)
    bx = app.array(x.copy(), bs)
    bx[2:5] = 0.0
    bx[6:9] = app.array(rs.randn(3, 10), (3, 5))
    bx[:, 0] = rs.randn(12)
    bx[::2, 1] = 7.0
    bx[::-3, 2] = -1.0
    bx[8:2:-2, 3:5] = np.arange(6.0).reshape(3, 2)
    bx[np.array([0, 5, 11]), np.array([9, 0, 4])] = 3.5
    bx[[1, 2], :] = rs.randn(2, 10)
    bx[Ellipsis, -1] = 2.0
    return bx


@pytest.mark.parametrize("bs", [(4, 5), (12, 10), (5, 3)])
def test_setitem(jax_app, torch_app, bs):
    both(jax_app, torch_app, lambda app, nps: _setitem_sequence(app, nps, bs))


def test_setitem_masks(jax_app, torch_app):
    def fn(app, nps):
        rs = np.random.RandomState(11)
        x = rs.randn(20, 4)
        bx = app.array(x.copy(), (5, 2))
        mask = x > 0
        bx[mask] = 0.0                          # host mask, scalar
        rowmask = x[:, 0] > 0
        bx[app.array(rowmask, (5,))] = 9.0      # device row mask, scalar
        m2 = np.tile(rowmask[:, None], (1, 4))
        bx[m2] = rs.randn(int(rowmask.sum()) * 4)   # packed, host
        dmask = bx < -0.5
        n = int(np.sum(bx.get() < -0.5))
        bx[dmask] = app.array(np.arange(n, dtype=float), (n,))  # packed
        bx[bx > 8] = np.array([5.0])            # scalar-like array
        return bx

    both(jax_app, torch_app, fn)


def test_setitem_packed_rows(jax_app, torch_app):
    def fn(app, nps):
        x = np.array([[1.0, 2.0], [3.0, 4.0]])
        bx = app.array(x.copy(), (1, 2))
        bx[np.array([[False, True], [True, False]])] = np.array([10.0, 20.0])
        x2 = np.arange(12, dtype=float).reshape(4, 3)
        rowmask = np.array([True, False, True, False])
        bx2 = app.array(x2.copy(), (2, 3))
        bx2[rowmask] = np.array([[100.0, 101.0, 102.0],
                                 [200.0, 201.0, 202.0]])
        bx3 = app.array(x2.copy(), (2, 3))
        bx3[rowmask] = np.array([5.0])
        return bx, bx2, bx3

    both(jax_app, torch_app, fn)


def test_setitem_casts_to_the_array_dtype(jax_app, torch_app):
    def fn(app, nps):
        bx = app.array(np.arange(6).reshape(2, 3), (2, 3))
        bx[0] = 2.7
        bx[bx > 3] = True
        return bx

    both(jax_app, torch_app, fn)


@pytest.mark.parametrize("bs", [(5, 9), (13, 9), (4, 3)])
def test_assignment_sweep(jax_app, torch_app, bs):
    subscripts = [
        (slice(None), slice(None)), (slice(2, 11), slice(1, 8)),
        (slice(0, 13, 2), slice(None)), (slice(None), slice(8, None, -2)),
        (slice(-4, None), slice(None, 4)), (5, slice(2, 7)),
        (slice(3, 4), slice(None)),
    ]

    def fn(app, nps):
        rs = np.random.RandomState(99)
        out = []
        for ss in subscripts:
            x = rs.randn(13, 9)
            target = np.empty((13, 9))[ss].shape
            v = rs.randn(*target)
            bx = app.array(x.copy(), bs)
            bx[ss] = app.array(v, target)
            bx2 = app.array(x.copy(), bs)
            bx2[ss] = v
            bx3 = app.array(x.copy(), bs)
            bx3[ss] = 1.5
            out += [bx, bx2, bx3]
        return out

    both(jax_app, torch_app, fn)


def test_assignment_leaves_views_alone(jax_app, torch_app):
    """A write builds a new tensor: a slice taken before it (a view of the
    old tensor in the port) keeps its values, and the written array does
    not share the old tensor's storage."""
    def fn(app, nps):
        bx = app.array(np.arange(10.0), (5,))
        y = bx[2:6]
        bx[0:4] = y
        y_before = y.get().copy()
        bx[2:6] = 99.0
        bx[bx > 50] = -1.0
        return bx, y, y_before

    both(jax_app, torch_app, fn)
    bx = torch_app.array(np.arange(10.0), (5,))
    y = bx[2:6]
    old = bx.data
    bx[2:6] = 99.0
    assert bx.data.untyped_storage().data_ptr() != \
        old.untyped_storage().data_ptr()
    assert y.get().tolist() == [2.0, 3.0, 4.0, 5.0]


def test_scalar_result_and_len(jax_app, torch_app):
    def fn(app, nps):
        bx = app.array(np.arange(12).reshape(3, 4).astype(float), (3, 2))
        return float(bx[1, 2]), len(bx), complex(bx[0, 1]), str(bx[0])

    both(jax_app, torch_app, fn)
    with pytest.raises(TypeError):
        len(torch_app.array(np.ones((2, 2)), (2, 2))[0, 0])


RESHAPES = {
    "simple": lambda b: [b.reshape(4, 6), b.reshape((2, 3, 4)),
                         b.reshape(-1, 8), b.reshape(24)],
    "reblock": lambda b: b.reshape(4, 6).reshape(block_shape=(2, 3)),
    "arbitrary": lambda b: b.reshape(4, 6).reshape(6, 4, block_shape=(4, 3)),
    "bad": lambda b: b.reshape(5, 5),
    "two_unknown": lambda b: b.reshape(-1, -1),
    "expand_squeeze": lambda b: b.reshape(4, 6).expand_dims(0).squeeze(),
    "expand_tuple": lambda b: b.reshape(4, 6).expand_dims((0, -1)),
    "broadcast_to": lambda b: b[:6].broadcast_to((3, 6)),
    "transpose_perm": lambda b: b.reshape(2, 3, 4).transpose(1, 2, 0),
    "transpose_tuple": lambda b: b.reshape(2, 3, 4).transpose((2, 0, 1)),
    "copy": lambda b: b.copy(),
    "prod": lambda b: (b + 1).reshape(4, 6).prod(axis=0),
}


@pytest.mark.parametrize("case", sorted(RESHAPES))
def test_reshape_and_structure(jax_app, torch_app, case):
    fn = RESHAPES[case]

    def run(app, nps):
        out = fn(app.array(np.arange(24).astype(float), (6,)))
        blocks = [o.block_shape for o in (out if isinstance(out, list)
                                          else [out])]
        return out, blocks

    both(jax_app, torch_app, run)


def test_reshape_size_zero(jax_app, torch_app):
    def fn(app, nps):
        b = app.array(np.zeros((0,)), (1,))
        return b.reshape((0, 4)), b.reshape((-1, 5))

    both(jax_app, torch_app, fn)
    with pytest.raises(ValueError, match="cannot reshape"):
        torch_app.array(np.zeros((0,)), (1,)).reshape((3, 4))


METHODS = {
    "all": lambda b, app: b.all(), "any": lambda b, app: (b > 0).any(),
    "all_axis": lambda b, app: (b > -1).all(axis=0),
    "clip": lambda b, app: b.clip(-1, 1), "round": lambda b, app: b.round(1),
    "cumsum": lambda b, app: b.cumsum(axis=0),
    "cumprod": lambda b, app: b.cumprod(axis=1),
    "cumsum_flat": lambda b, app: b.cumsum(),
    "take": lambda b, app: b.take(app.array(np.array([1, 3]), (2,)), axis=1),
    "repeat": lambda b, app: b.repeat(2, axis=0),
    "ravel": lambda b, app: b.ravel(), "flatten": lambda b, app: b.flatten(),
    "swapaxes": lambda b, app: b.swapaxes(0, 1),
    "argsort": lambda b, app: b.argsort(axis=1),
    "dot": lambda b, app: b.dot(app.array(np.ones((8, 3)), (4, 3))),
    "trace": lambda b, app: b.trace(), "trace1": lambda b, app: b.trace(1),
    "diagonal": lambda b, app: b.diagonal(),
    "diagonal_neg": lambda b, app: b.diagonal(-2),
    "nonzero": lambda b, app: (b[0, :3] > 100).nonzero(),
    "nonzero_some": lambda b, app: (b > 0.5).nonzero(),
    "item": lambda b, app: app.scalar(2.5).item(),
    "tolist": lambda b, app: b.tolist(),
    "prod": lambda b, app: b.prod(axis=1),
    "complex": lambda b, app: app.array(
        np.array([1 + 2j, 3 - 1j]), (2,)).conj(),
    "conjugate": lambda b, app: b.conjugate(),
    "real": lambda b, app: app.array(np.array([1 + 2j, 3 - 1j]), (2,)).real,
    "imag": lambda b, app: app.array(np.array([1 + 2j, 3 - 1j]), (2,)).imag,
    "real_of_real": lambda b, app: b.real, "imag_of_real": lambda b, app: b.imag,
    "str": lambda b, app: str(b[:2, :2]),
    "eq_none": lambda b, app: b == None,  # noqa: E711 - elementwise
    "ne_none": lambda b, app: b != None,  # noqa: E711
    "rmul_np_scalar": lambda b, app: np.float64(2.0) * b,
    "array_protocol": lambda b, app: np.asarray(b.T, dtype=np.float32),
    "floordiv": lambda b, app: b // 0.3, "rfloordiv": lambda b, app: 2 // b,
    "mod": lambda b, app: b % 0.7, "rmod": lambda b, app: 3.0 % b,
    "ipow": lambda b, app: b.__ipow__(2),
}


@pytest.mark.parametrize("case", sorted(METHODS))
def test_ndarray_methods(jax_app, torch_app, case):
    fn = METHODS[case]
    x = np.random.RandomState(0).randn(6, 8)
    both(jax_app, torch_app, lambda app, nps: fn(app.array(x, (3, 4)), app))


def test_sort_in_place(jax_app, torch_app):
    def fn(app, nps):
        s = app.array(np.array([3.0, 1.0, 2.0, 1.0]), (2,))
        assert s.sort() is None
        return s

    both(jax_app, torch_app, fn)


@pytest.mark.parametrize("shape", [(50,), (13, 9), (1003, 7)])
def test_where_matches_numpy(jax_app, torch_app, shape):
    x = np.random.RandomState(5).randn(*shape)
    bs = (max(1, shape[0] // 4),) + tuple(shape[1:])

    def fn(app, nps):
        bx = app.array(x, bs)
        return app.where(bx > 0), app.where(bx > 1e9)

    both(jax_app, torch_app, fn)


def test_where_indices_stay_on_device(torch_app):
    x = np.random.RandomState(6).randn(1003, 7)
    bx = torch_app.array(x, (126, 7))
    count, idx = masking.device_where(bx > 0)
    assert count == int((x > 0).sum())
    rows, cols = np.where(x > 0)
    for i, ref in zip(idx, (rows, cols)):
        assert torch.is_tensor(i) and i.shape == (count,)
        assert i.device == bx.data.device and i.dtype == torch.int64
        assert np.array_equal(i.numpy(), ref)
    count, idx = masking.device_where(bx.T > 0)
    assert [i.numpy().tolist() for i in idx] == [
        a.tolist() for a in np.where(x.T > 0)]


def test_device_unique(jax_app, torch_app):
    from nums_tpu.core.ops import masking as jmasking

    x = np.array([[3.0, np.nan, 1.0], [1.0, np.nan, 2.0], [3.0, 0.5, 3.0]])
    for equal_nan in (True, False):
        def fn(app, nps, m=None):
            m = masking if app is torch_app else jmasking
            count, outs = m.device_unique(app.array(x, (2, 2)).T, True, True,
                                          True, equal_nan=equal_nan)
            return count, [np.asarray(o) if not hasattr(o, "numpy")
                           else o.numpy() for o in outs]

        t = fn(torch_app, tnps)
        j = fn(jax_app, jnps)
        assert t[0] == j[0]
        for g, r in zip(t[1], j[1]):
            assert np.array_equal(g, r.astype(g.dtype), equal_nan=True)


def test_argwhere_flatnonzero(jax_app, torch_app):
    x = np.random.RandomState(8).randn(37, 4)

    def fn(app, nps):
        bx = nps.array(x)
        return nps.argwhere(bx > 0), nps.flatnonzero(bx > 0)

    both(jax_app, torch_app, fn)


def test_blockarray_has_the_reference_methods():
    """Every method and property of the reference's BlockArray, apart
    from its sharding and padding ones (``_reduce_call`` strips the
    at-rest padding around a reduction), exists on the port's; the
    reference's ``from_jax`` and ``_pallas_gram_fast`` are
    ``from_torch`` and ``_gram_fast`` here."""
    skip = {"expected_sharding", "check_sharding", "is_padded",
            "_raw_logical_shape", "_collective_matmul", "_explicit_choice",
            "flattened_oids", "blocks", "_reduce_call"}
    renamed = {"from_jax": "from_torch", "_pallas_gram_fast": "_gram_fast"}
    missing = [renamed.get(n, n) for n in vars(JBA)
               if n not in skip and not n.startswith("__")
               and not hasattr(TBA, renamed.get(n, n))]
    dunders = [n for n in vars(JBA) if n.startswith("__")
               and n not in ("__module__", "__dict__", "__weakref__",
                             "__doc__", "__qualname__", "__firstlineno__",
                             "__static_attributes__")
               and not hasattr(TBA, n)]
    assert not missing and not dunders, (missing, dunders)


def test_device_where_in_chunks(torch_app, monkeypatch):
    """A mask of more elements than ``torch.nonzero`` takes on the card
    (2^31 - 1) is resolved a chunk at a time, to the same indices."""
    x = np.random.RandomState(9).randn(37, 11)
    bx = torch_app.array(x, (10, 11))
    want = np.where(x > 0.2)
    monkeypatch.setattr(masking, "NONZERO_MAX_ELEMENTS", 50)
    count, idx = masking.device_where(bx > 0.2)
    assert count == want[0].shape[0]
    for i, w in zip(idx, want):
        assert np.array_equal(i.numpy(), w)
    assert np.array_equal(bx[bx > 0.2].get(), x[x > 0.2])
    vals, counts = tnps.unique(torch_app.array(np.round(x * 2), (37, 11)),
                               return_counts=True)
    uv, uc = np.unique(np.round(x * 2), return_counts=True)
    assert np.array_equal(vals.get(), uv) and np.array_equal(counts.get(), uc)
