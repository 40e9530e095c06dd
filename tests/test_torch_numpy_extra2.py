"""``nums_tpu_torch.numpy.extra2`` against ``nums_tpu.numpy.extra2``, name
by name: every name of its ``__all__`` has at least one case, with the
places where jnp and NumPy differ (``nanargmax`` of an all-NaN slice,
``take_along_axis`` out of range, ``unravel_index`` clipping,
``ravel_multi_index`` wrapping, ``i0`` and the windows in the default
float, ``histogram2d``'s float counts).

Same numpy inputs through both packages on the CPU (x64 on); shape,
dtype and value compared (tests/torch_parity.py): exact for integer,
bool, index and set results; elementwise, window, ``i0`` and ``frexp``
float64 within 1e-12 relative plus 1e-12 of max|ref|; reductions, scans
and quantiles within 1e-12 of max|ref| (float32: 1e-5); ``polyfit``
within 1e-8 of max|ref|. A second test runs cases on arrays split into
ragged blocks, as tests/numpy/test_extra_ragged.py does.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

from nums_tpu.numpy import extra2 as jextra2

RS = np.random.RandomState(2)
M = RS.randn(9, 7)
M32 = RS.randn(16, 12).astype(np.float32)
V = RS.randn(40)
NAN = M.copy()
NAN[0, 0] = NAN[3, 2] = NAN[5, :] = np.nan
NAN[:, 4] = np.nan
INTS = np.array([0, 1, 1, 3, 5, 5, 5, -2, 7])
SPECIAL = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 0.5,
                    3.75, -1e-300, 1e300, 6.0])
C = np.array([1 + 2j, 3 - 1j, -2 + 0.5j, 4.0 + 0j, 0j])


def _a(nps, x):
    return nps.array(x)


# name -> [(class, fn(nps))]; class: "e" elementwise, "r" reduction, "p"
# polynomial fit
CASES = {
    "isin": [("e", lambda n: n.isin(_a(n, INTS), _a(n, np.array([1, 5, 9])))),
             ("e", lambda n: n.isin(_a(n, M.round()), _a(n, np.array(
                 [0.0, 1.0, -1.0])))),
             ("e", lambda n: n.isin(_a(n, SPECIAL), _a(n, SPECIAL[:8]))),
             ("e", lambda n: n.isin(_a(n, INTS), _a(n, np.array([1.0, 5.5])))),
             ("e", lambda n: n.isin(_a(n, C), _a(n, C[::2])))],
    "isreal": [("e", lambda n: [n.isreal(_a(n, C)), n.isreal(_a(n, M))])],
    "iscomplex": [("e", lambda n: [n.iscomplex(_a(n, C)),
                                   n.iscomplex(_a(n, INTS))])],
    "isneginf": [("e", lambda n: [n.isneginf(_a(n, SPECIAL)),
                                  n.isneginf(_a(n, INTS))])],
    "isposinf": [("e", lambda n: [n.isposinf(_a(n, SPECIAL)),
                                  n.isposinf(_a(n, SPECIAL.astype(
                                      np.float32)))])],
    "isrealobj": [("e", lambda n: [n.isrealobj(_a(n, C)),
                                   n.isrealobj(_a(n, M))])],
    "iscomplexobj": [("e", lambda n: [n.iscomplexobj(_a(n, C)),
                                      n.iscomplexobj(_a(n, INTS))])],
    "nanargmax": [("e", lambda n: [n.nanargmax(_a(n, NAN)),
                                   n.nanargmax(_a(n, NAN), axis=0),
                                   n.nanargmax(_a(n, NAN), axis=1)]),
                  ("e", lambda n: n.nanargmax(_a(n, INTS)))],
    "nanargmin": [("e", lambda n: [n.nanargmin(_a(n, NAN)),
                                   n.nanargmin(_a(n, NAN), axis=0),
                                   n.nanargmin(_a(n, NAN), axis=-1)])],
    "nancumsum": [("r", lambda n: [n.nancumsum(_a(n, NAN)),
                                   n.nancumsum(_a(n, NAN), axis=0)]),
                  ("e", lambda n: n.nancumsum(_a(n, INTS))),
                  ("e", lambda n: n.nancumsum(_a(n, M > 0), axis=1))],
    "nancumprod": [("r", lambda n: n.nancumprod(_a(n, NAN / 2), axis=1))],
    "nanprod": [("r", lambda n: [n.nanprod(_a(n, NAN / 2)),
                                 n.nanprod(_a(n, NAN / 2), axis=0)]),
                ("e", lambda n: n.nanprod(_a(n, INTS[1:5])))],
    "nanpercentile": [("r", lambda n: [
        n.nanpercentile(_a(n, NAN), 30), n.nanpercentile(_a(n, NAN), 50,
                                                         axis=0),
        n.nanpercentile(_a(n, NAN), [5, 95], axis=1)]),
        ("r", lambda n: n.nanpercentile(_a(n, M32), [10, 50], axis=0))],
    "nanquantile": [("r", lambda n: [
        n.nanquantile(_a(n, NAN), 0.3), n.nanquantile(_a(n, NAN), [0.25, 1.0],
                                                      axis=0)])],
    "take_along_axis": [
        ("e", lambda n: n.take_along_axis(_a(n, M), n.argsort(_a(n, M),
                                                              axis=0), 0)),
        ("e", lambda n: n.take_along_axis(_a(n, M), _a(n, np.array(
            [[0, -1, 6, 7, -8, 2, 100]])), 1)),
        ("e", lambda n: n.take_along_axis(_a(n, INTS.reshape(3, 3)), _a(n,
            np.array([[5], [-4], [1]])), 1)),
        ("e", lambda n: n.take_along_axis(_a(n, M[:, :1]), _a(n, np.array(
            [[0, 3, 8]])), 0)),
        ("e", lambda n: n.take_along_axis(_a(n, M), _a(n, np.array(
            [3, 1, -2])), None))],
    "select": [("e", lambda n: n.select([_a(n, M > 0.5), _a(n, M < -0.5)],
                                        [_a(n, M), _a(n, -M)])),
               ("e", lambda n: n.select([_a(n, INTS > 2), _a(n, INTS < 1)],
                                        [_a(n, INTS), _a(n, INTS * 10)],
                                        default=-7)),
               ("e", lambda n: n.select([_a(n, INTS > 2)], [_a(n, INTS)],
                                        default=0.5))],
    "unravel_index": [("e", lambda n: n.unravel_index(
        _a(n, np.array([0, 5, 11, 12, 40, -1, -2, -12, -13, -50])), (3, 4))),
        ("e", lambda n: n.unravel_index(_a(n, np.array([7, 22], dtype=np.int32)),
                                        (2, 3, 4)))],
    "ravel_multi_index": [("e", lambda n: n.ravel_multi_index(
        (_a(n, np.array([0, 1, 2, 5, -1])), _a(n, np.array([3, 0, 1, 2, 9]))),
        (3, 4))),
        ("e", lambda n: n.ravel_multi_index(
            (_a(n, np.array([1], dtype=np.int32)),
             _a(n, np.array([2], dtype=np.int32)),
             _a(n, np.array([3], dtype=np.int32))), (2, 3, 4))),
        ("e", lambda n: n.ravel_multi_index((_a(n, np.array([0.0])),
                                             _a(n, np.array([1.0]))), (2, 2)))],
    "tril_indices": [("e", lambda n: [n.tril_indices(4), n.tril_indices(
        4, 1, 6), n.tril_indices(5, -2)])],
    "triu_indices": [("e", lambda n: [n.triu_indices(4), n.triu_indices(
        3, -1, 5), n.triu_indices(5, 2)])],
    "diag_indices": [("e", lambda n: [n.diag_indices(4),
                                      n.diag_indices(3, 3)])],
    "indices": [("e", lambda n: [n.indices((2, 3)), n.indices((3,)),
                                 n.indices((2, 2, 3), dtype=np.int32)])],
    "polyval": [("e", lambda n: n.polyval(_a(n, np.array([1.5, -2.0, 0.5])),
                                          _a(n, V))),
                ("e", lambda n: n.polyval(_a(n, np.array([3, 0, 1])),
                                          _a(n, INTS))),
                ("e", lambda n: n.polyval(_a(n, np.array([1.0, 2.0])),
                                          _a(n, M32)))],
    "polyfit": [("p", lambda n: n.polyfit(_a(n, np.linspace(-2, 2, 50)),
                                          _a(n, np.polyval([0.5, -1, 2, 3],
                                                           np.linspace(-2, 2,
                                                                       50))
                                             + 0.01 * V[:1].sum()), 3)),
                ("p", lambda n: n.polyfit(_a(n, V), _a(n, 2 * V - 1 + np.sin(
                    V)), 2)),
                ("p", lambda n: n.polyfit(_a(n, np.arange(9.0)),
                                          _a(n, M), 1))],
    "unwrap": [("e", lambda n: n.unwrap(_a(n, np.cumsum(V)))),
               ("e", lambda n: n.unwrap(_a(n, M * 4), axis=0)),
               ("e", lambda n: n.unwrap(_a(n, np.array([0.0, np.pi, 0.0,
                                                        -np.pi, 2 * np.pi]))))],
    "hamming": [("e", lambda n: [n.hamming(9), n.hamming(1), n.hamming(0)])],
    "hanning": [("e", lambda n: [n.hanning(10), n.hanning(1)])],
    "blackman": [("e", lambda n: [n.blackman(12), n.blackman(1)])],
    "bartlett": [("e", lambda n: [n.bartlett(7), n.bartlett(8)])],
    "kaiser": [("e", lambda n: [n.kaiser(12, 14.0), n.kaiser(5, 0.5),
                                n.kaiser(1, 3.0)])],
    "i0": [("e", lambda n: [n.i0(_a(n, V)), n.i0(_a(n, M32)),
                            n.i0(_a(n, INTS))])],
    "histogram_bin_edges": [("e", lambda n: [
        n.histogram_bin_edges(_a(n, V)), n.histogram_bin_edges(
            _a(n, V), bins=5, range=(-1, 1)),
        n.histogram_bin_edges(_a(n, M), bins=3, range=(2.0, 2.0))])],
    "histogram2d": [("e", lambda n: n.histogram2d(_a(n, V[:30]),
                                                  _a(n, V[10:]), bins=4)),
                    ("e", lambda n: n.histogram2d(_a(n, M[:, 0]),
                                                  _a(n, M[:, 1]),
                                                  bins=(3, 5)))],
    "hypot": [("e", lambda n: n.hypot(_a(n, M), _a(n, M[:1])))],
    "heaviside": [("e", lambda n: n.heaviside(_a(n, SPECIAL), 0.5))],
    "float_power": [("e", lambda n: n.float_power(_a(n, np.abs(V)), 1.5))],
    "copysign": [("e", lambda n: n.copysign(_a(n, V), _a(n, -V)))],
    "frexp": [("e", lambda n: n.frexp(_a(n, SPECIAL))),
              ("e", lambda n: n.frexp(_a(n, M32))),
              ("e", lambda n: n.frexp(_a(n, INTS)))],
    "ldexp": [("e", lambda n: n.ldexp(_a(n, V[:9]), _a(n, INTS)))],
    "signbit": [("e", lambda n: n.signbit(_a(n, SPECIAL)))],
    "spacing": [("e", lambda n: n.spacing(_a(n, V)))],
}

TOL = {"e": "elementwise", "r": "reduction", "p": "poly"}
PARAMS = [(name, i) for name in sorted(CASES)
          for i in range(len(CASES[name]))]


def test_every_name_has_a_case():
    assert sorted(CASES) == sorted(jextra2.__all__)


@pytest.mark.parametrize("name,i", PARAMS)
def test_extra2(apps, name, i):
    cls, fn = CASES[name][i]
    facade_parity(apps, lambda nps, app: fn(nps), TOL[cls])


RAGGED = {
    "isin": lambda n, a: n.isin(a, a[:2]),
    "nanargmax": lambda n, a: n.nanargmax(a, axis=1),
    "nancumsum": lambda n, a: n.nancumsum(a, axis=0),
    "nanpercentile": lambda n, a: n.nanpercentile(a, [10, 90], axis=0),
    "take_along_axis": lambda n, a: n.take_along_axis(
        a, n.argsort(a, axis=1), 1),
    "unwrap": lambda n, a: n.unwrap(a * 5, axis=0),
    "i0": lambda n, a: n.i0(a),
}


@pytest.mark.parametrize("name", sorted(RAGGED))
@pytest.mark.parametrize("block_shape", [(4, 3), (9, 2), (2, 7)])
def test_ragged_blocks(apps, name, block_shape):
    """Arrays split into blocks that do not divide their shape."""
    def fn(nps, app):
        return RAGGED[name](nps, app.array(NAN, block_shape=block_shape))

    facade_parity(apps, fn, "reduction")


def test_histogram_bin_edges_of_given_edges(torch_app):
    """Edges given as a sequence (the reference takes an int only) come
    back as NumPy's."""
    import nums_tpu_torch.numpy as tnps

    for bins in ((-1.0, 0.0, 2.0), [0.0, 1.0, 5.0]):
        got = tnps.histogram_bin_edges(torch_app.array(M), bins=bins).get()
        ref = np.histogram_bin_edges(M, bins=bins)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
