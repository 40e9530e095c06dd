"""The tables of tests/test_torch_mesh_index*.py and
tests/test_torch_mesh_setops*.py: each entry an op on an array made from a
seed, run through the port's mesh (4 gloo processes of ``mesh_pool``, the
whole table in ONE call), nums_tpu's mesh (the 8 virtual CPU devices) and
the port's serial backend.

``index``: the cases of the reference's mesh-parametrised
tests/core/array/test_access.py, test_ragged.py's indexing case,
tests/core/ops/test_masking.py, and the mask and index cases of
tests/numpy/test_setops_device.py and test_device_builders.py; and more at
ragged shapes (13x9 with its columns sharded on the (2, 2) mesh, 37x6 in
5-row blocks, 1003x7) with int, bool and complex arrays: host index arrays
read and written, boolean masks by rows and by elements, packed
assignment, ``where``, ``nonzero``, ``argwhere``, ``flatnonzero``,
``compress``, ``extract``, ``trim_zeros`` and ``insert``.

``setops``: tests/numpy/test_setops_device.py's unique and set-op cases,
test_extra_ragged.py's histogram and partition, and ``unique`` (every
return, ``unique_*``), the set ops, ``searchsorted``, ``digitize``,
``interp``, ``bincount`` and the histograms at ragged shapes with NaN,
complex, bool and int inputs, sharded and whole.

Each entry must give the same values in the three (integers, bools,
indices and selected elements exactly; float64 arithmetic within 1e-12 of
max|ref|, the ``reduction`` class), or the same exception type; every
BlockArray result must lie on each process as ``app.array`` of its value
and blocks puts it (the placement rule of
tests/test_torch_mesh.py::test_each_rank_holds_the_reference_rows). Where
the port departs from the reference on purpose (``DEPARTS``, ROADMAP
Queue C: an index out of range raises ``IndexError`` as the serial port
does, where jax clamps; a negative value in ``bincount`` raises
``ValueError`` as NumPy's does, where jnp counts it in bin 0), the entry
is held to the serial port alone.
"""

import numpy as np
import pytest

from torch_parity import (
    assert_gathers_allowed, assert_table_entry, jax_mesh_values, mesh_app,
    run_table,
)


def _rs(seed):
    return np.random.RandomState(seed)


X30 = _rs(2).randn(30, 4)
PERM = _rs(2).permutation(30)
X20 = _rs(11).randn(20, 4)
X12 = _rs(123).randn(12, 9)
X13 = _rs(1).randn(13, 9)
X37 = _rs(2).randn(37, 6)
X1003 = _rs(3).randn(1003, 7)
X50 = _rs(5).randn(50)
I37 = _rs(4).randint(-5, 6, size=(37, 6))
C13 = _rs(6).randn(13, 9) + 1j * _rs(7).randn(13, 9)
B37 = X37 > 0.3
ROWS12, COLS12 = np.array([0, 5, 11]), np.array([8, 0, 4])


def _a(app, x, bs):
    return app.array(x, block_shape=bs)


def _written(app, x, bs, key, value):
    """``x`` as a BlockArray with ``key`` assigned ``value(app)``."""
    b = _a(app, x.copy(), bs)
    b[key(app) if callable(key) else key] = value(app) if callable(
        value) else value
    return b


def _chain(app, x, bs, steps):
    """``x`` with each (key, value) of ``steps`` assigned in turn; the
    array after each step (read to the host after the steps)."""
    b = _a(app, x.copy(), bs)
    out = []
    for key, value in steps:
        b[key(b) if callable(key) else key] = value
        out.append(b.copy())
    return out


def index_table():
    t = []

    def add(name, fn):
        t.append((name, fn))

    # tests/core/array/test_access.py
    add("gather_perm", lambda app, nps: _a(app, X30, (10, 2))[PERM])
    add("gather_device_perm", lambda app, nps: _a(app, X30, (10, 2))[
        _a(app, PERM, (10,))])
    add("gather_dup", lambda app, nps: _a(app, X30, (10, 2))[
        np.array([3, 3, 0, 29])])
    add("mask_elements", lambda app, nps: _a(app, X20, (5, 2))[X20 > 0])
    add("mask_rows_host", lambda app, nps: _a(app, X20, (5, 2))[
        X20[:, 0] > 0])
    add("mask_rows_device", lambda app, nps: _a(app, X20, (5, 2))[
        _a(app, X20[:, 0] > 0, (5,))])
    add("mask_write_scalar", lambda app, nps: _written(
        app, X20, (5, 2), X20 > 0, 0.0))
    rowmask20 = X20[:, 0] > 0
    add("mask_write_packed", lambda app, nps: _written(
        app, X20, (5, 2), np.tile(rowmask20[:, None], (1, 4)),
        _rs(11).randn(int(rowmask20.sum()) * 4)))
    add("pairs", lambda app, nps: _a(app, X12, (4, 3))[ROWS12, COLS12])
    add("outer_pairs", lambda app, nps: _a(app, X12, (4, 3))[
        ROWS12[:, None], COLS12[None, :]])
    add("slice_and_array", lambda app, nps: _a(app, X12, (4, 3))[
        2:7, COLS12])
    add("write_pairs", lambda app, nps: _written(
        app, X12, (4, 3), (ROWS12, COLS12), 0.0))
    add("packed_assignment", lambda app, nps: _chain(
        app, np.array([[1.0, 2.0], [3.0, 4.0]]), (1, 2),
        [(np.array([[False, True], [True, False]]),
          np.array([10.0, 20.0]))]))
    add("packed_rows", lambda app, nps: _chain(
        app, np.arange(12.0).reshape(4, 3), (2, 3),
        [(np.array([True, False, True, False]),
          np.array([[100.0, 101.0, 102.0], [200.0, 201.0, 202.0]])),
         (np.array([True, False, True, False]), np.array([5.0]))]))
    # tests/core/array/test_ragged.py::test_ragged_indexing_assignment
    add("ragged_slice", lambda app, nps: _a(app, X1003, (126, 7))[
        5:200, 2:5])
    add("ragged_last", lambda app, nps: _a(app, X1003, (126, 7))[-1])
    add("ragged_step", lambda app, nps: _a(app, X1003, (126, 7))[::7])
    add("ragged_index", lambda app, nps: _a(app, X1003, (126, 7))[
        np.array([0, 1002, 500, 3])])
    add("ragged_chain", lambda app, nps: _chain(
        app, X1003, (126, 7),
        [((slice(3, 7), 0), 99.0), (lambda b: b > 2.0, 0.0)]))
    add("ragged_mask", lambda app, nps: _a(app, X1003, (126, 7))[
        X1003[:, 0] > 0])
    # host integer index arrays at ragged shapes, reads and writes
    for name, key in [("idx", np.array([0, 36, 5])), ("list", [0, 36, 5]),
                      ("neg", np.array([-1, -37, 4])),
                      ("ij", (np.array([0, 36]), np.array([1, 2]))),
                      ("cols", (slice(None), np.array([0, 3]))),
                      ("cols_step", (slice(None, None, -3), [5, 0])),
                      ("int_and_array", (7, np.array([5, 0, 5]))),
                      ("ellipsis", (Ellipsis, np.array([1, 1]))),
                      ("newaxis", (np.array([2, 3]), None)),
                      ("bool_cols", (slice(None), X37[0] > 0)),
                      ("out_of_range", np.array([0, 37])),
                      ("empty", np.array([], dtype=np.int64))]:
        add("read_" + name, lambda app, nps, key=key: _a(
            app, X37, (5, 6))[key])
    for name, key in [("idx", np.array([0, 36, 5, 36])),
                      ("ij", (np.array([0, 36]), np.array([1, 2]))),
                      ("cols", (slice(None), np.array([0, 3])))]:
        add("write_scalar_" + name, lambda app, nps, key=key: _written(
            app, X37, (5, 6), key, 1.0))
    add("write_host_rows", lambda app, nps: _written(
        app, X37, (5, 6), np.array([0, 36, 5]), np.arange(18.0).reshape(
            3, 6)))
    add("write_array_rows", lambda app, nps: _written(
        app, X37, (5, 6), np.arange(0, 37, 3), lambda app: _a(
            app, np.arange(13 * 6.0).reshape(13, 6), (4, 6))))
    add("write_array_pairs", lambda app, nps: _written(
        app, X13, (4, 3), (np.arange(13), np.arange(13) % 9),
        lambda app: _a(app, np.arange(13.0), (4,))))
    for name, key, value in [
            ("write_slice_int", (slice(3, 7), 0), 99.0),
            ("write_steps", (slice(None, None, -2), slice(1, 8, 3)), -1.0),
            ("write_row", 5, np.arange(9.0)),
            ("write_ellipsis", (Ellipsis, 2), np.arange(13.0)),
            ("write_block", (slice(2, 11), slice(None)),
             np.arange(81.0).reshape(9, 9))]:
        add(name, lambda app, nps, key=key, value=value: _written(
            app, X13, (4, 3), key, value))
    add("write_out_of_range", lambda app, nps: _written(
        app, X37, (5, 6), np.array([37]), 1.0))
    for name, key in [("rows", np.array([12, 0, 6])),
                      ("cols", (slice(None), [0, 8, 3])),
                      ("pairs", ([1, 12], [8, 0]))]:
        add("wide_" + name, lambda app, nps, key=key: _a(
            app, X13, (4, 3))[key])
        add("wide_write_" + name, lambda app, nps, key=key: _written(
            app, X13, (4, 3), key, -1.0))
    # boolean masks by rows and by elements, at ragged shapes and dtypes
    add("wide_mask_elements", lambda app, nps: (lambda b: b[b > 0])(
        _a(app, X13, (4, 3))))
    add("wide_mask_rows", lambda app, nps: (lambda b: b[b[:, 0] > 0])(
        _a(app, X13, (4, 3))))
    add("transposed_mask", lambda app, nps: (lambda b: b.T[b.T > 0])(
        _a(app, X13, (4, 3))))
    add("mask_int", lambda app, nps: (lambda b: b[b > 0])(
        _a(app, I37, (5, 6))))
    add("mask_complex", lambda app, nps: (lambda b: b[b.real > 0])(
        _a(app, C13, (4, 3))))
    add("mask_bool", lambda app, nps: _a(app, B37, (5, 6))[
        X37[:, 1] > 0])
    add("mask_all", lambda app, nps: _a(app, X37, (5, 6))[
        np.ones(37, dtype=bool)])
    add("mask_none", lambda app, nps: _a(app, X37, (5, 6))[
        np.zeros(37, dtype=bool)])
    add("mask_last_rows", lambda app, nps: _a(app, X37, (5, 6))[
        np.arange(37) >= 30])
    add("mask_packed_device", lambda app, nps: (lambda b: _written(
        app, X13, (4, 3), lambda app: b > 0, lambda app: _a(
            app, np.arange(float((X13 > 0).sum())), (9,))))(
                _a(app, X13, (4, 3))))
    add("mask_rows_packed_device", lambda app, nps: _written(
        app, X37, (5, 6), lambda app: _a(app, X37[:, 0] > 0, (5,)),
        lambda app: _a(app, np.arange(float((X37[:, 0] > 0).sum() * 6))
                       .reshape(-1, 6), (4, 6))))
    # packed assignment of a sharded value that broadcasts: a column of
    # the kept rows' count, a row, one row
    kept37 = int((X37[:, 0] > 0).sum())
    for name, value, bs in [
            ("column", np.arange(float(kept37))[:, None], (4, 1)),
            ("row", np.arange(6.0), (3,)),
            ("one_row", np.arange(6.0)[None], (1, 3))]:
        add("mask_rows_broadcast_" + name, lambda app, nps, value=value,
            bs=bs: _written(app, X37, (5, 6), lambda app: _a(
                app, X37[:, 0] > 0, (5,)), lambda app: _a(app, value, bs)))
    # tests/core/ops/test_masking.py and the where family
    for name, x, bs in [("50", X50, (12,)), ("13x9", X13, (3, 9)),
                        ("wide", X13, (4, 3)), ("1003x7", X1003, (251, 7))]:
        add("where_" + name, lambda app, nps, x=x, bs=bs: app.where(
            _a(app, x, bs) > 0))
        add("where_empty_" + name, lambda app, nps, x=x, bs=bs: app.where(
            _a(app, x, bs) > 1e9))
        add("nonzero_" + name, lambda app, nps, x=x, bs=bs: nps.nonzero(
            _a(app, x, bs) > 0.5))
        add("argwhere_" + name, lambda app, nps, x=x, bs=bs: nps.argwhere(
            _a(app, x, bs) > 0))
        add("flatnonzero_" + name, lambda app, nps, x=x, bs=bs:
            nps.flatnonzero(_a(app, x, bs) > 0))
    add("bool_read", lambda app, nps: (lambda b: (b[b > 0.3],
                                                 b[b[:, 0] < 0]))(
        _a(app, _rs(7).randn(200, 5), (50, 5))))
    data = _rs(7).randint(0, 9, size=(5, 7)).astype(np.float64)
    data[1, 2] = np.nan
    cond = np.array([True, False, True, False, True])
    add("compress_rows", lambda app, nps: nps.compress(
        _a(app, cond, (2,)), _a(app, data, (2, 7)), axis=0))
    add("compress_cols", lambda app, nps: nps.compress(
        _a(app, data[0] > 3, (7,)), _a(app, data, (2, 7)), axis=1))
    add("compress_flat", lambda app, nps: nps.compress(
        _a(app, cond, (2,)), _a(app, data, (2, 7))))
    add("compress_host", lambda app, nps: nps.compress(
        cond, _a(app, data, (2, 7)), axis=0))
    add("compress_ragged", lambda app, nps: nps.compress(
        _a(app, X1003[:, 3] > 0, (126,)), _a(app, X1003, (126, 7)),
        axis=0))
    add("extract", lambda app, nps: nps.extract(
        _a(app, data > 4, (2, 7)), _a(app, data, (2, 7))))
    add("extract_wide", lambda app, nps: nps.extract(
        _a(app, X13 > 0, (4, 3)), _a(app, X13, (4, 3))))
    for i, arr in enumerate([np.array([0.0, 0.0, 1.0, 2.0, 0.0]),
                             np.array([1.0, 0.0, 2.0]), np.zeros(4),
                             np.array([0, 3, 0, 0], dtype=np.int64),
                             np.r_[np.zeros(11), np.arange(1.0, 10),
                                   np.zeros(17)]]):
        for trim in ("fb", "f", "b"):
            add(f"trim_zeros_{i}_{trim}", lambda app, nps, arr=arr,
                trim=trim: nps.trim_zeros(_a(app, arr, (2,)), trim))
    a34 = np.arange(12.0).reshape(3, 4)
    add("insert_row", lambda app, nps: nps.insert(
        _a(app, a34, (1, 4)), 1, 99.0, axis=0))
    add("insert_slice", lambda app, nps: nps.insert(
        _a(app, a34, (1, 4)), slice(1, 3), 7.0, axis=1))
    add("insert_positions", lambda app, nps: nps.insert(
        _a(app, a34, (1, 4)), [1, 3], 5.0, axis=1))
    add("insert_flat", lambda app, nps: nps.insert(
        _a(app, a34, (1, 4)), 2, 1.5))
    add("insert_ragged_rows", lambda app, nps: nps.insert(
        _a(app, X37, (5, 6)), slice(1, 30, 7), 7.0, axis=0))
    add("insert_ragged_slab", lambda app, nps: nps.insert(
        _a(app, X37, (5, 6)), 36, _a(app, np.arange(12.0).reshape(2, 6),
                                     (2, 6)), axis=0))
    add("insert_wide_cols", lambda app, nps: nps.insert(
        _a(app, X13, (4, 3)), 4, -2.0, axis=1))
    # tests/numpy/test_device_builders.py: index builders used as indices
    add("tril_indices_as_index", lambda app, nps: (lambda rc: _a(
        app, np.arange(25.0).reshape(5, 5), (5, 5))[rc[0], rc[1]])(
            nps.tril_indices(5)))
    return t


D57 = np.random.default_rng(7).integers(0, 9, size=(5, 7)).astype(
    np.float64)
D57[1, 2] = np.nan
D57[4, 0] = np.nan
C1003 = _rs(8).randint(0, 50, size=1003)
S1003 = np.sort(_rs(9).randn(1003))
F1003 = X1003[:, 1].copy()
F1003[::97] = np.nan
Z = np.array([1 + 2j, np.nan + 1j, 1 + 2j, 3 - 1j, 1 + np.nan * 1j,
              -0.0 + 0j, 0j, 3 - 1j, 2 + 0j, 1 + 1j, 1 + 2j, 5j])
SIGNED_ZEROS = np.array([0.0, -0.0, 1.0, -0.0, 2.0, 0.0, -1.0, -0.0, 1.0])


def _reconstructed(res):
    """(values, values[inverse]) of a unique with an inverse: with
    equal_nan=False the NaN slots are interchangeable, the reconstruction
    is not."""
    vals, inv = np.asarray(res[0].get()), np.asarray(res[-1].get())
    return vals, vals[inv]


def setops_table():
    t = []

    def add(name, fn):
        t.append((name, fn))

    kwargs_list = [{}, dict(return_index=True), dict(return_inverse=True),
                   dict(return_counts=True),
                   dict(return_index=True, return_counts=True),
                   dict(return_index=True, return_inverse=True,
                        return_counts=True)]
    # tests/numpy/test_setops_device.py
    for i, kw in enumerate(kwargs_list):
        add(f"unique_kwargs_{i}", lambda app, nps, kw=kw: nps.unique(
            nps.array(D57), **kw))
        add(f"unique_kwargs_sharded_{i}", lambda app, nps, kw=kw:
            nps.unique(_a(app, D57, (2, 3)), **kw))
        if i in (0, 5):
            add(f"unique_kwargs_no_equal_nan_{i}", lambda app, nps, kw=kw:
                nps.unique(_a(app, D57, (2, 3)), equal_nan=False, **kw))
    for i, arr in enumerate([np.array([3, 1, 3, 2, 1, 3]),
                             np.array([True, False, True]), np.array([5]),
                             np.array([], dtype=np.int64)]):
        add(f"unique_small_{i}", lambda app, nps, arr=arr: nps.unique(
            _a(app, arr, (2,))))
    add("unique_axis", lambda app, nps: nps.unique(nps.array(
        np.array([[1, 2], [1, 2], [3, 4]])), axis=0))
    flat = D57.ravel()
    add("unique_values", lambda app, nps: nps.unique_values(
        _a(app, flat, (9,))))
    add("unique_counts", lambda app, nps: nps.unique_counts(
        _a(app, flat, (9,))))
    add("unique_inverse", lambda app, nps: _reconstructed(
        nps.unique_inverse(_a(app, flat, (9,)))))
    add("unique_all", lambda app, nps: (lambda r: (
        r.values, r.indices, r.counts, _reconstructed(r)))(
            nps.unique_all(_a(app, flat, (9,)))))
    pairs = [(np.array([1, 3, 4, 3, 9, 2]), np.array([3, 4, 5, 7])),
             (np.array([1.5, 2.5]), np.array([9.0, 10.0])),
             (np.array([2, 2, 2]), np.array([2])),
             (np.array([], dtype=np.int64), np.array([1, 2])),
             (np.array([1, 2]), np.array([], dtype=np.int64))]
    for i, (a, b) in enumerate(pairs):
        for op in ("intersect1d", "setdiff1d", "setxor1d", "union1d"):
            add(f"{op}_{i}", lambda app, nps, a=a, b=b, op=op: getattr(
                nps, op)(_a(app, a, (max(1, a.size // 4 + 1),)),
                         _a(app, b, (max(1, b.size // 4 + 1),))))
    x53 = np.random.default_rng(11).integers(0, 5, size=(5, 3)).astype(
        np.float64)
    add("unique_transposed", lambda app, nps: nps.unique(
        _a(app, x53, (2, 2)).T))
    add("intersect_transposed", lambda app, nps: nps.intersect1d(
        _a(app, x53, (2, 2)).T, nps.array(np.array([0.0, 2.0, 99.0]))))
    x23 = np.array([[1.0, 2.0, 2.0], [3.0, 1.0, 3.0]])
    add("unique_inverse_transposed", lambda app, nps: nps.unique(
        _a(app, x23, (2, 3)).T, return_inverse=True))
    # unique at ragged shapes: floats, ints, complex, bool, signed zeros
    add("unique_floats_all", lambda app, nps: nps.unique(
        _a(app, X1003, (126, 7)), return_index=True, return_inverse=True,
        return_counts=True))
    add("unique_wide", lambda app, nps: nps.unique(
        _a(app, np.round(X13, 1), (4, 3)), return_index=True,
        return_inverse=True, return_counts=True))
    add("unique_ints", lambda app, nps: nps.unique(
        _a(app, C1003, (126,)), return_index=True, return_inverse=True,
        return_counts=True))
    add("unique_nan_column", lambda app, nps: nps.unique(
        _a(app, np.round(F1003, 1), (126,)), return_counts=True))
    add("unique_values_nan", lambda app, nps: nps.unique_values(
        _a(app, np.round(F1003, 1), (126,))))
    add("unique_complex", lambda app, nps: nps.unique(
        _a(app, Z, (3,)), return_index=True, return_inverse=True,
        return_counts=True))
    add("unique_bool", lambda app, nps: nps.unique(
        _a(app, X1003[:, 2] > 0, (126,)), return_counts=True))
    add("unique_signed_zeros", lambda app, nps: nps.unique(
        _a(app, SIGNED_ZEROS, (2,)), return_index=True))
    # the set ops on sharded operands
    add("isin_whole", lambda app, nps: nps.isin(
        _a(app, C1003, (126,)), nps.array(np.array([1, 3, 5, 49]))))
    add("isin_sharded", lambda app, nps: nps.isin(
        _a(app, C1003, (126,)), _a(app, C1003[::3] + 7, (40,))))
    add("isin_nan", lambda app, nps: nps.isin(
        _a(app, np.round(F1003, 1), (126,)),
        _a(app, np.round(F1003[::2], 1), (126,))))
    add("isin_wide", lambda app, nps: nps.isin(
        _a(app, np.round(X13, 1), (4, 3)), _a(app, np.round(
            X1003[:, 0], 1), (126,))))
    add("isin_complex", lambda app, nps: nps.isin(
        _a(app, Z, (3,)), _a(app, Z[::3], (2,))))
    add("in1d", lambda app, nps: nps.in1d(
        _a(app, C1003, (126,)), _a(app, C1003[::5] * 2, (60,))))
    for op in ("intersect1d", "setdiff1d", "setxor1d", "union1d"):
        add(f"{op}_ragged", lambda app, nps, op=op: getattr(nps, op)(
            _a(app, C1003, (126,)), _a(app, C1003[::3] + 20, (40,))))
        if op in ("setdiff1d", "union1d"):
            add(f"{op}_floats", lambda app, nps, op=op: getattr(nps, op)(
                _a(app, np.round(X1003[:, 0], 1), (126,)),
                _a(app, np.round(X1003[:, 1], 1), (126,))))
    # searchsorted, digitize, interp
    v_small = np.array([-1.0, 0.0, 0.5, 5.0, -5.0])
    for side in ("left", "right"):
        add(f"searchsorted_whole_v_{side}", lambda app, nps, side=side:
            nps.searchsorted(_a(app, S1003, (126,)), nps.array(v_small),
                             side=side))
        add(f"searchsorted_sharded_v_{side}", lambda app, nps, side=side:
            nps.searchsorted(_a(app, S1003, (126,)), _a(
                app, X1003[:, 1], (126,)), side=side))
        add(f"searchsorted_ints_{side}", lambda app, nps, side=side:
            nps.searchsorted(_a(app, np.sort(C1003), (126,)),
                             _a(app, C1003, (126,)), side=side))
        add(f"searchsorted_whole_seq_{side}", lambda app, nps, side=side:
            nps.searchsorted(nps.array(S1003[::50]), _a(
                app, X1003[:, 1], (126,)), side=side))
    add("searchsorted_wide_v", lambda app, nps: nps.searchsorted(
        _a(app, S1003, (126,)), _a(app, X13, (4, 3))))
    add("searchsorted_complex", lambda app, nps: nps.searchsorted(
        _a(app, np.sort_complex(Z[[0, 3, 5, 8, 9, 11]]), (2,)),
        _a(app, Z[[0, 3, 8, 9]], (1,))))
    edges = np.linspace(-2, 2, 9)
    for right in (False, True):
        add(f"digitize_whole_{right}", lambda app, nps, right=right:
            nps.digitize(_a(app, X1003[:, 1], (126,)), nps.array(edges),
                         right=right))
        add(f"digitize_falling_{right}", lambda app, nps, right=right:
            nps.digitize(_a(app, X1003[:, 1], (126,)), nps.array(
                edges[::-1]), right=right))
        add(f"digitize_sharded_{right}", lambda app, nps, right=right:
            nps.digitize(_a(app, X1003[:, 1], (126,)), _a(
                app, S1003, (126,)), right=right))
        add(f"digitize_sharded_falling_{right}", lambda app, nps,
            right=right: nps.digitize(_a(app, X1003[:, 1], (126,)), _a(
                app, S1003[::-1].copy(), (126,)), right=right))
    add("digitize_wide", lambda app, nps: nps.digitize(
        _a(app, X13, (4, 3)), nps.array(edges)))
    add("interp_sharded", lambda app, nps: nps.interp(
        _a(app, X1003[:, 2], (126,)), _a(app, S1003, (126,)),
        _a(app, np.sin(S1003), (126,))))
    add("interp_whole", lambda app, nps: nps.interp(
        _a(app, X1003[:, 2], (126,)), nps.array(edges), nps.array(
            edges ** 2)))
    add("interp_small_x", lambda app, nps: nps.interp(
        nps.array(v_small), _a(app, S1003, (126,)),
        _a(app, np.cos(S1003), (126,))))
    # bincount and the histograms
    add("bincount", lambda app, nps: nps.bincount(_a(app, C1003, (126,))))
    add("bincount_minlength", lambda app, nps: nps.bincount(
        _a(app, C1003 % 7, (126,)), minlength=60))
    add("bincount_whole", lambda app, nps: nps.bincount(nps.array(
        np.array([0, 1, 1, 3]))))
    # a rank with no elements (5 elements: 2/2/1/0 on (4, 1)), ints and
    # bools; a filter that leaves one rank empty; a negative value
    five = np.array([3, 0, 1, 3, 2])
    add("bincount_empty_rank", lambda app, nps: nps.bincount(
        _a(app, five, (2,))))
    add("bincount_bool_empty_rank", lambda app, nps: nps.bincount(
        _a(app, five > 1, (2,))))
    add("bincount_filtered", lambda app, nps: nps.bincount(
        _a(app, C1003 % 5, (126,))[np.isin(np.arange(1003),
                                           [0, 300, 600, 900, 1002])]))
    add("bincount_negative", lambda app, nps: nps.bincount(
        _a(app, np.array([3, -1, 2, 0, 5]), (2,))))
    add("histogram_empty_rank", lambda app, nps: nps.histogram(
        _a(app, five, (2,)), 4))
    add("histogram", lambda app, nps: nps.histogram(
        _a(app, X1003[:, 3], (126,)), 16))
    add("histogram_wide", lambda app, nps: nps.histogram(
        _a(app, X13, (4, 9)), bins=5))
    add("histogram_cols", lambda app, nps: nps.histogram(
        _a(app, X13, (4, 3)), bins=7))
    add("histogram_range", lambda app, nps: nps.histogram(
        _a(app, X1003[:, 3], (126,)), 10, range=(-1.0, 1.0)))
    add("histogram_ints", lambda app, nps: nps.histogram(
        _a(app, C1003, (126,)), 12))
    add("histogram_bin_edges", lambda app, nps: nps.histogram_bin_edges(
        _a(app, X1003[:, 4], (126,)), 9))
    add("histogram2d", lambda app, nps: nps.histogram2d(
        _a(app, X1003[:, 0], (126,)), _a(app, X1003[:, 1], (126,)), 8))
    add("histogram2d_layouts", lambda app, nps: nps.histogram2d(
        _a(app, X1003[:, 0], (126,)), _a(app, X1003[:, 1], (1003,)), 6))
    add("histogramdd", lambda app, nps: nps.histogramdd(
        _a(app, X1003[:, :3], (126, 3)), 4))
    add("histogramdd_wide", lambda app, nps: nps.histogramdd(
        _a(app, X13[:, :4], (4, 2)), 3))
    # tests/numpy/test_extra_ragged.py: partition along an unsharded axis
    add("partition_rows", lambda app, nps: nps.partition(
        _a(app, X13, (4, 9)), 4, axis=1)[:, 4])
    add("partition", lambda app, nps: nps.partition(
        _a(app, X37, (5, 6)), 2, axis=1))
    add("argpartition", lambda app, nps: nps.argpartition(
        _a(app, X37, (5, 6)), 3, axis=-1))
    return t


TABLES = {"index": index_table(), "setops": setops_table()}
# entry -> the exception the port raises where the reference does not
DEPARTS = {"read_out_of_range": "IndexError",
           "write_out_of_range": "IndexError",
           "bincount_negative": "ValueError"}


def names(table):
    return [name for name, _ in TABLES[table]]


def port_values(table, cluster):
    """In a mesh worker: the table on the port's mesh of ``cluster``."""
    import nums_tpu_torch.numpy as nps

    return run_table(mesh_app(cluster), nps, TABLES[table], placed=True)


def table_fixtures(table, cluster):
    """The module-scoped fixtures of a table's test module: its entries on
    the port's mesh (one call of the pool), on nums_tpu's mesh and on the
    port's serial backend."""

    @pytest.fixture(scope="module")
    def port_mesh(mesh_pool):
        return mesh_pool.run(port_values, table, cluster)

    @pytest.fixture(scope="module")
    def reference_mesh():
        return jax_mesh_values(cluster, [
            e for e in TABLES[table] if e[0] not in DEPARTS])

    @pytest.fixture(scope="module")
    def port_serial(torch_app):
        import nums_tpu_torch.numpy as nps

        return run_table(torch_app, nps, TABLES[table])[0]

    return port_mesh, reference_mesh, port_serial


def check_entry(port_mesh, reference_mesh, port_serial, name):
    values, placed = port_mesh
    got = values[name]
    if name in DEPARTS:
        assert got[1] == DEPARTS[name], got
    else:
        assert_table_entry(got, reference_mesh[name], "reduction")
    assert_table_entry(got, port_serial[name], "reduction")
    where, gathered = placed[name]
    assert where, "a result is not laid out as app.array lays it"
    assert_gathers_allowed(name, gathered)
