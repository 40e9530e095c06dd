"""``nums_tpu_torch.numpy.compat`` and ``.tail`` against the reference's,
name by name: every name of each ``__all__`` has at least one case, with
the places where jnp and NumPy differ (``packbits`` of nonzero values,
``bitwise_count`` of the magnitude, ``histogramdd``'s counts in the
default int, ``resize`` by repetition, ``piecewise`` taking the last
true condition).

Same numpy inputs through both packages on the CPU (x64 on); shape,
dtype and value compared (tests/torch_parity.py): exact for integer,
bool, index and bit results and for what a host passthrough returns
(strings, tuples, NumPy objects); elementwise float64 within 1e-12
relative plus 1e-12 of max|ref|. User functions (``fromfunction``,
``piecewise``, ``apply_over_axes``) are built from operators and methods
that jnp arrays and torch tensors both take: the port passes torch
tensors where the reference passes jnp arrays. The file-reading and
file-writing names run on one file written for both packages.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

from nums_tpu.numpy import compat as jcompat, tail as jtail

RS = np.random.RandomState(4)
M = RS.randn(9, 7)
M32 = RS.randn(6, 5).astype(np.float32)
V = RS.randn(20)
INTS = np.array([0, 1, -1, 3, 5, 127, -128, 7, 255, -2**31, 2**40, 6])
BITS = RS.rand(5, 13) > 0.5
T3 = RS.randn(3, 4, 5)
DAYS = np.array(["2026-01-01", "2026-03-15", "2026-06-30"],
                dtype="datetime64[D]")


def _a(nps, x):
    return nps.array(x)


def _square(n):
    return n.array(M[:4, :4])


CASES = {
    "asarray_chkfinite": [
        ("e", lambda n: n.asarray_chkfinite(_a(n, M))),
        ("e", lambda n: n.asarray_chkfinite(_a(n, np.array([1.0, np.inf])))),
        ("e", lambda n: n.asarray_chkfinite(M32, dtype=np.float64))],
    "ascontiguousarray": [("e", lambda n: n.ascontiguousarray(M.T)),
                          ("e", lambda n: n.ascontiguousarray(
                              _a(n, INTS), dtype=np.float32))],
    "asfortranarray": [("e", lambda n: n.asfortranarray(M))],
    "isfortran": [("e", lambda n: n.isfortran(_a(n, M)))],
    "resize": [("e", lambda n: [n.resize(_a(n, M), (4, 20)),
                                n.resize(_a(n, V), 7),
                                n.resize(_a(n, INTS), (2, 3, 5)),
                                n.resize(_a(n, M), (0,))])],
    "packbits": [("e", lambda n: n.packbits(_a(n, BITS))),
                 ("e", lambda n: n.packbits(_a(n, BITS), axis=1)),
                 ("e", lambda n: n.packbits(_a(n, BITS), axis=0,
                                            bitorder="little")),
                 ("e", lambda n: n.packbits(_a(n, INTS))),
                 ("e", lambda n: n.packbits(_a(n, M)))],
    "unpackbits": [
        ("e", lambda n: n.unpackbits(_a(n, np.arange(250, 256,
                                                     dtype=np.uint8)))),
        ("e", lambda n: n.unpackbits(_a(n, np.packbits(BITS, axis=1)),
                                     axis=1)),
        ("e", lambda n: n.unpackbits(_a(n, np.packbits(BITS, axis=0)),
                                     axis=0, bitorder="little")),
        ("e", lambda n: n.unpackbits(_a(n, INTS)))],
    "histogramdd": [("r", lambda n: n.histogramdd(_a(n, M[:, :3]), bins=4)),
                    ("r", lambda n: n.histogramdd(_a(n, M[:, :2]),
                                                  bins=(3, 5))),
                    ("r", lambda n: n.histogramdd(_a(n, V)))],
    "mask_indices": [("e", lambda n: [n.mask_indices(4, np.triu),
                                      n.mask_indices(5, np.tril, -1)])],
    "tril_indices_from": [("e", lambda n: [
        n.tril_indices_from(_a(n, M)), n.tril_indices_from(_a(n, M), 2)])],
    "triu_indices_from": [("e", lambda n: [
        n.triu_indices_from(_a(n, M)), n.triu_indices_from(_a(n, M), -1)])],
    "diag_indices_from": [("e", lambda n: n.diag_indices_from(_square(n)))],
    "array_repr": [("e", lambda n: n.array_repr(_a(n, M[:2])))],
    "array_str": [("e", lambda n: n.array_str(_a(n, M[:2]), precision=3))],
    "array2string": [("e", lambda n: n.array2string(_a(n, INTS),
                                                    separator=","))],
    "base_repr": [("e", lambda n: n.base_repr(255, 16))],
    "binary_repr": [("e", lambda n: n.binary_repr(-5, width=8))],
    "typename": [("e", lambda n: n.typename("d"))],
    "min_scalar_type": [("e", lambda n: n.min_scalar_type(300))],
    "mintypecode": [("e", lambda n: n.mintypecode(["d", "f"]))],
    "common_type": [("e", lambda n: [n.common_type(_a(n, M), _a(n, M32)),
                                     n.common_type(_a(n, INTS))])],
    "einsum_path": [("e", lambda n: n.einsum_path(
        "ij,jk,kl->il", _a(n, M), _a(n, M.T), _a(n, M), optimize="greedy"))],
    "get_printoptions": [("e", lambda n: n.get_printoptions())],
    "set_printoptions": [("e", lambda n: n.set_printoptions())],
    "printoptions": [("e", lambda n: type(n.printoptions()).__name__)],
    "array_equiv": [("e", lambda n: n.array_equiv(_a(n, M[:1]), _a(n, M)))],
    "format_float_positional": [
        ("e", lambda n: n.format_float_positional(np.float64(1.25)))],
    "format_float_scientific": [
        ("e", lambda n: n.format_float_scientific(np.float64(1.25e-7)))],
    "fromfunction": [
        ("e", lambda n: n.fromfunction(lambda i, j: i * 10 + j, (3, 4))),
        ("e", lambda n: n.fromfunction(lambda i, j, k: (i - j) * k + 0.5,
                                       (2, 3, 4), dtype=np.float32)),
        ("e", lambda n: n.fromfunction(lambda i: i * i, (5,), dtype=int))],
    "fromiter": [("e", lambda n: n.fromiter(range(6), np.int32)),
                 ("e", lambda n: n.fromiter((x / 2 for x in range(5)),
                                            float))],
    "frombuffer": [("e", lambda n: n.frombuffer(V.tobytes(), np.float64,
                                                count=5, offset=16))],
    "fromstring": [("e", lambda n: n.fromstring("1 2.5 -3", float)),
                   ("e", lambda n: n.fromstring("4,5,6", int, sep=","))],
    # -- tail ---------------------------------------------------------------
    "apply_over_axes": [
        ("r", lambda n: n.apply_over_axes(n.sum, _a(n, M), [0, 1])),
        ("r", lambda n: n.apply_over_axes(n.cumsum, _a(n, M), 1)),
        ("r", lambda n: n.apply_over_axes(
            lambda a, ax: n.max(a, axis=ax, keepdims=True),
            _a(n, T3), (0, 2)))],
    "asmatrix": [("e", lambda n: [type(n.asmatrix(_a(n, M[:2]))).__name__,
                                  np.asarray(n.asmatrix(_a(n, M[:2])))])],
    "bitwise_count": [
        ("e", lambda n: n.bitwise_count(_a(n, INTS))),
        ("e", lambda n: n.bitwise_count(_a(n, INTS.astype(np.int32)))),
        ("e", lambda n: n.bitwise_count(_a(n, INTS.astype(np.int16)))),
        ("e", lambda n: n.bitwise_count(_a(n, INTS.astype(np.int8)))),
        ("e", lambda n: n.bitwise_count(_a(n, INTS.astype(np.uint8)))),
        ("e", lambda n: n.bitwise_count(_a(n, BITS))),
        ("e", lambda n: n.bitwise_count(_a(n, M)))],
    "bmat": [("e", lambda n: n.bmat([[_a(n, M[:2, :2]), _a(n, M[:2, 2:5])],
                                     [_a(n, M[2:3, :3]), _a(n, M[2:3, 3:5])]])),
             ("e", lambda n: n.bmat(_a(n, V[:4]))),
             ("e", lambda n: n.bmat("A B; B A",
                                    ldict={"A": _a(n, M[:2, :2]),
                                           "B": _a(n, M[2:4, :2])}))],
    "busday_count": [("e", lambda n: n.busday_count(DAYS[:-1], DAYS[1:]))],
    "busday_offset": [("e", lambda n: n.busday_offset(DAYS, 3,
                                                      roll="forward"))],
    "datetime_as_string": [("e", lambda n: n.datetime_as_string(DAYS))],
    "datetime_data": [("e", lambda n: n.datetime_data(DAYS.dtype))],
    "from_dlpack": [("e", lambda n: n.from_dlpack(M)),
                    ("e", lambda n: n.from_dlpack(INTS.astype(np.int32)))],
    "geterrcall": [("e", lambda n: n.geterrcall())],
    "is_busday": [("e", lambda n: n.is_busday(DAYS))],
    "isnat": [("e", lambda n: n.isnat(np.array(["NaT", "2026-01-01"],
                                               dtype="datetime64[D]")))],
    "ix_": [("e", lambda n: n.ix_(_a(n, np.array([0, 2])),
                                  _a(n, np.array([1, 3, 4])))),
            ("e", lambda n: n.ix_([0, 2], np.array([True, False, True]))),
            ("e", lambda n: n.ix_(_a(n, np.array([True, False, True])),
                                  []))],
    "nested_iters": [("e", lambda n: [
        [list(map(int, inner)) for _ in outer for inner in [innerit]]
        for outer, innerit in [n.nested_iters(_a(n, INTS.reshape(3, 4)),
                                              [[0], [1]])]])],
    "piecewise": [
        ("e", lambda n: n.piecewise(_a(n, V), [_a(n, V < 0), _a(n, V > 1)],
                                    [lambda v: -v, lambda v: v * 10, 0.5])),
        ("e", lambda n: n.piecewise(_a(n, V), [_a(n, V < 0)],
                                    [lambda v: v * v])),
        ("e", lambda n: n.piecewise(_a(n, INTS), [_a(n, INTS > 3),
                                                  _a(n, INTS > 100)],
                                    [1, lambda v: v // 2])),
        ("e", lambda n: n.piecewise(_a(n, V), _a(n, V > 0),
                                    [lambda v, k: v + k, 0.0], 3.0))],
    "require": [("e", lambda n: n.require(M, np.float32, ["C"])),
                ("e", lambda n: n.require(_a(n, INTS)))],
    "seterrcall": [("e", lambda n: n.seterrcall(None))],
}

# names with a case of their own below (files)
FILE_NAMES = {"fromfile", "fromregex", "genfromtxt", "savez_compressed"}

TOL = {"e": "elementwise", "r": "reduction"}
PARAMS = [(name, i) for name in sorted(CASES)
          for i in range(len(CASES[name]))]


def test_every_name_has_a_case():
    names = sorted(set(CASES) | FILE_NAMES)
    assert names == sorted(set(jcompat.__all__) | set(jtail.__all__))


@pytest.mark.parametrize("name,i", PARAMS)
def test_compat_tail(apps, name, i):
    cls, fn = CASES[name][i]
    facade_parity(apps, lambda nps, app: fn(nps), TOL[cls])


def test_files(apps, tmp_path):
    """``fromfile``, ``fromregex`` and ``genfromtxt`` read one file into
    both packages; ``savez_compressed`` of each package's array writes the
    same arrays."""
    raw = tmp_path / "v.bin"
    V.tofile(raw)
    text = tmp_path / "t.txt"
    text.write_text("1,2.5\n3,-4\n5,6e3\n")
    cases = {
        "fromfile": lambda n: n.fromfile(str(raw), dtype=np.float64,
                                         count=7, offset=8),
        "fromregex": lambda n: n.fromregex(str(text), r"(\d+),",
                                           [("a", np.int64)]),
        "genfromtxt": lambda n: n.genfromtxt(str(text), delimiter=","),
    }
    for name, fn in cases.items():
        facade_parity(apps, lambda nps, app: fn(nps))

    def save(nps, app):
        path = tmp_path / f"{nps.__name__}.npz"
        assert nps.savez_compressed(str(path), m=app.array(M),
                                    i=app.array(INTS)) is None
        with np.load(path) as f:
            return [f["m"], f["i"]]

    facade_parity(apps, save)


def test_packbits_round_trip(apps):
    """``unpackbits(packbits(b))`` is ``b`` padded to whole bytes."""
    def fn(nps, app):
        return nps.unpackbits(nps.packbits(app.array(BITS), axis=1), axis=1)

    facade_parity(apps, fn)
