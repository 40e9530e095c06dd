"""``nums_tpu_torch.numpy.extra`` against ``nums_tpu.numpy.extra``, name
by name: every name of its ``__all__`` has at least one case, with the
cases of tests/numpy/test_extra.py and the places where torch and jnp
differ (sort stability, the median's two middles, quantiles by sort,
``histogram``'s closed last bin, ``meshgrid``'s "xy", ``vander``'s order,
``digitize(right=)``, the ``pad`` modes, ``convolve``/``correlate``,
``unique``'s first index, ``round`` half to even, the scans' integer
promotion, integer division signs, ``diagonal``/``trace`` offsets,
``take`` with ``axis=None``).

Same numpy inputs through both packages on the CPU (x64 on); shape,
dtype and value compared (tests/torch_parity.py): exact for integer,
bool, sort, index, set and shape results; elementwise float64 within
1e-12 relative, float32 2e-6 relative plus 1e-6 of max|ref|; reductions,
scans and statistics within 1e-12 (float64) and 1e-5 (float32) of
max|ref|. Inputs up to 64×48, float64 and float32.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

from nums_tpu.numpy import extra as jextra

RS = np.random.RandomState(0)
M = RS.randn(8, 6)
M32 = RS.randn(64, 48).astype(np.float32)
V = RS.randn(50)
TIES = np.array([3.0, 1.0, 2.0, 1.0, 3.0, 0.0, 1.0, 2.0])
NAN = M.copy()
NAN[0, 0] = NAN[3, 2] = np.nan
INTS = np.array([0, 1, 1, 3, 5, 5, 5])
C = np.array([1 + 2j, 3 - 1j, -2 + 0.5j])


def _a(nps, x):
    return nps.array(x)


# name -> [(class, fn(nps))]; class: "e" elementwise, "r" reduction/scan
CASES = {
    "prod": [("r", lambda n: n.prod(_a(n, M), axis=0)),
             ("r", lambda n: n.prod(_a(n, INTS[1:4]))),
             ("r", lambda n: n.prod(_a(n, M > 0), axis=1))],
    "all": [("e", lambda n: [n.all(_a(n, M) < 100), n.all(_a(n, M) > 0),
                             n.all(_a(n, M) > -1, axis=0)])],
    "any": [("e", lambda n: [n.any(_a(n, M) > 0),
                             n.any(_a(n, M) > 2, axis=1)])],
    "cumsum": [("r", lambda n: n.cumsum(_a(n, M), axis=1)),
               ("r", lambda n: n.cumsum(_a(n, M))),
               ("e", lambda n: n.cumsum(_a(n, M > 0), axis=0)),
               ("e", lambda n: n.cumsum(_a(n, INTS.astype(np.int8)))),
               ("e", lambda n: n.cumsum(_a(n, INTS.astype(np.int32)))),
               ("r", lambda n: n.cumsum(_a(n, M32), axis=0))],
    "cumprod": [("r", lambda n: n.cumprod(_a(n, M), axis=0)),
                ("e", lambda n: n.cumprod(_a(n, M[0] > 0)))],
    "nansum": [("r", lambda n: [n.nansum(_a(n, NAN)),
                                n.nansum(_a(n, NAN), axis=0)]),
               ("e", lambda n: n.nansum(_a(n, INTS)))],
    "nanmean": [("r", lambda n: n.nanmean(_a(n, NAN), axis=0))],
    "nanmax": [("r", lambda n: [n.nanmax(_a(n, NAN)),
                                n.nanmax(_a(n, NAN), axis=1)])],
    "nanmin": [("r", lambda n: n.nanmin(_a(n, NAN), axis=0))],
    "nanvar": [("r", lambda n: n.nanvar(_a(n, NAN), axis=0))],
    "nanstd": [("r", lambda n: n.nanstd(_a(n, NAN)))],
    "median": [("r", lambda n: [n.median(_a(n, M)), n.median(_a(n, M),
                                                             axis=0)]),
               ("r", lambda n: n.median(_a(n, TIES[:6]))),
               ("r", lambda n: n.median(_a(n, NAN), axis=0)),
               ("r", lambda n: n.median(_a(n, M32), axis=1))],
    "nanmedian": [("r", lambda n: n.nanmedian(_a(n, NAN), axis=0))],
    "ptp": [("r", lambda n: [n.ptp(_a(n, M)), n.ptp(_a(n, M), axis=1)])],
    "count_nonzero": [("e", lambda n: [n.count_nonzero(_a(n, M > 0)),
                                       n.count_nonzero(_a(n, M > 0),
                                                       axis=0)])],
    "average": [("r", lambda n: n.average(_a(n, M), axis=0,
                                          weights=_a(n, np.abs(M[:, 0])))),
                ("r", lambda n: n.average(_a(n, M), axis=1))],
    "clip": [("e", lambda n: n.clip(_a(n, V), -1, 1)),
             ("e", lambda n: n.clip(_a(n, V), None, 0.5)),
             ("e", lambda n: n.clip(_a(n, INTS), 1, 3)),
             ("e", lambda n: n.clip(_a(n, INTS), 0.5, 3.5))],
    "around": [("e", lambda n: n.around(_a(n, np.array(
        [-2.5, -0.5, 0.5, 1.5, 2.5, 0.49, 1.51])))),
               ("e", lambda n: n.around(_a(n, V), 2)),
               ("e", lambda n: n.around(_a(n, V * 100), -1)),
               ("e", lambda n: n.around(_a(n, INTS), 1))],
    "round": [("e", lambda n: n.round(_a(n, V), 1))],
    "round_": [("e", lambda n: n.round_(_a(n, V)))],
    "sort": [("e", lambda n: n.sort(_a(n, M))),
             ("e", lambda n: n.sort(_a(n, M), axis=0)),
             ("e", lambda n: n.sort(_a(n, M), axis=None)),
             ("e", lambda n: n.sort(_a(n, NAN), axis=0))],
    "argsort": [("e", lambda n: n.argsort(_a(n, TIES))),
                ("e", lambda n: n.argsort(_a(n, np.tile(TIES, (3, 1))),
                                          axis=0)),
                ("e", lambda n: n.argsort(_a(n, M), axis=None))],
    "searchsorted": [("e", lambda n: n.searchsorted(
        n.sort(_a(n, V)), _a(n, np.array([-0.5, 0.0, 0.5])))),
        ("e", lambda n: n.searchsorted(_a(n, np.sort(TIES)), _a(n, TIES),
                                       side="right"))],
    "take": [("e", lambda n: n.take(_a(n, M), _a(n, np.array([4, 2, 0])))),
             ("e", lambda n: n.take(_a(n, M), _a(n, np.array([[1, -1]])),
                                    axis=1))],
    "stack": [("e", lambda n: [n.stack([_a(n, M), _a(n, M)]),
                               n.stack([_a(n, M), _a(n, M)], axis=2)])],
    "vstack": [("e", lambda n: n.vstack([_a(n, M), _a(n, M[0])]))],
    "hstack": [("e", lambda n: [n.hstack([_a(n, M), _a(n, M)]),
                                n.hstack([_a(n, V), _a(n, V[:3])])])],
    "dstack": [("e", lambda n: n.dstack([_a(n, M), _a(n, M)]))],
    "column_stack": [("e", lambda n: n.column_stack([_a(n, M[:, 0]),
                                                     _a(n, M)]))],
    "row_stack": [("e", lambda n: n.row_stack([_a(n, M[0]),
                                               _a(n, M[1])]))],
    "tile": [("e", lambda n: [n.tile(_a(n, M), (2, 1)),
                              n.tile(_a(n, V[:3]), 2)])],
    "repeat": [("e", lambda n: [n.repeat(_a(n, M), 3, axis=0),
                                n.repeat(_a(n, M), 2)])],
    "roll": [("e", lambda n: [n.roll(_a(n, M), 1, axis=1),
                              n.roll(_a(n, M), -3)])],
    "flip": [("e", lambda n: [n.flip(_a(n, M)), n.flip(_a(n, M), 0)])],
    "fliplr": [("e", lambda n: n.fliplr(_a(n, M)))],
    "flipud": [("e", lambda n: n.flipud(_a(n, M)))],
    "ravel": [("e", lambda n: n.ravel(_a(n, M).T))],
    "swapaxes": [("e", lambda n: n.swapaxes(_a(n, M.reshape(2, 4, 6)), 0,
                                            2))],
    "moveaxis": [("e", lambda n: n.moveaxis(_a(n, M.reshape(2, 4, 6)), 0,
                                            -1))],
    "atleast_1d": [("e", lambda n: n.atleast_1d(3.0))],
    "atleast_2d": [("e", lambda n: n.atleast_2d(_a(n, np.arange(3))))],
    "broadcast_to": [("e", lambda n: n.broadcast_to(_a(n, M[0]), (5, 6)))],
    "triu": [("e", lambda n: [n.triu(_a(n, M)), n.triu(_a(n, M), 2)])],
    "tril": [("e", lambda n: n.tril(_a(n, M), -1))],
    "dot": [("r", lambda n: [n.dot(_a(n, M), _a(n, M.T)),
                             n.dot(_a(n, M), _a(n, M[0])),
                             n.dot(_a(n, M), 2.0),
                             n.dot(_a(n, M.reshape(2, 4, 6)),
                                   _a(n, M.T))])],
    "inner": [("r", lambda n: [n.inner(_a(n, M), _a(n, M)),
                               n.inner(_a(n, V), 2.0)])],
    "outer": [("e", lambda n: n.outer(_a(n, V[:5]), _a(n, V[5:9])))],
    "trace": [("r", lambda n: [n.trace(_a(n, M)), n.trace(_a(n, M), 2),
                               n.trace(_a(n, M), -1),
                               n.trace(_a(n, INTS.astype(np.int32)[:4]
                                          .reshape(2, 2)))])],
    "vdot": [("r", lambda n: n.vdot(_a(n, V), _a(n, V)))],
    "einsum": [("r", lambda n: [n.einsum("ij,jk->ik", _a(n, M),
                                         _a(n, M.T)),
                                n.einsum("ii->i", _a(n, M[:6])),
                                n.einsum("ij->", _a(n, M))])],
    "kron": [("e", lambda n: n.kron(_a(n, V[:4]), _a(n, V[:3])))],
    "matrix_transpose": [("e", lambda n: n.matrix_transpose(_a(n, M)))],
    "isclose": [("e", lambda n: [n.isclose(_a(n, V), _a(n, V) + 1e-9),
                                 n.isclose(_a(n, NAN), _a(n, NAN),
                                           equal_nan=True),
                                 n.isclose(_a(n, INTS), _a(n, INTS))])],
    "array_equal": [("e", lambda n: [n.array_equal(_a(n, V), _a(n, V)),
                                     n.array_equal(_a(n, V), _a(n, V) + 1),
                                     n.array_equal(_a(n, V), _a(n, M))])],
    "real": [("e", lambda n: [n.real(_a(n, V)), n.real(_a(n, C))])],
    "imag": [("e", lambda n: [n.imag(_a(n, V)), n.imag(_a(n, C))])],
    "nan_to_num": [("e", lambda n: n.nan_to_num(_a(n, np.array(
        [np.nan, np.inf, -np.inf, 1.0])))),
        ("e", lambda n: n.nan_to_num(_a(n, NAN), nan=-1.0))],
    "diff": [("e", lambda n: [n.diff(_a(n, V)), n.diff(_a(n, M), n=2,
                                                       axis=0),
                              n.diff(_a(n, V > 0))])],
    "unique": [("e", lambda n: n.unique(_a(n, np.array([3, 1, 3, 2, 1])))),
               ("e", lambda n: n.unique(_a(n, TIES), return_index=True,
                                        return_inverse=True,
                                        return_counts=True)),
               ("e", lambda n: n.unique(_a(n, NAN.ravel()))),
               ("e", lambda n: n.unique(_a(n, np.array([[1, 2], [1, 2],
                                                        [0, 3]])),
                                        axis=0)),
               ("e", lambda n: n.unique(_a(n, np.array([]))))],
    "percentile": [("r", lambda n: [n.percentile(_a(n, V), 50),
                                    n.percentile(_a(n, V), [25, 75]),
                                    n.percentile(_a(n, M32), [1, 50, 99],
                                                 axis=0)])],
    "quantile": [("r", lambda n: [n.quantile(_a(n, V), 0.9),
                                  n.quantile(_a(n, M), [0.1, 0.5],
                                             axis=1)])],
    "histogram": [("r", lambda n: n.histogram(_a(n, V), bins=10)),
                  ("r", lambda n: n.histogram(_a(n, M32), bins=64)),
                  ("r", lambda n: n.histogram(_a(n, V), bins=4,
                                              range=(-1.0, 1.0))),
                  ("r", lambda n: n.histogram(_a(n, np.ones(5)))),
                  ("r", lambda n: n.histogram(_a(n, V), bins=[-2.0, 0.0,
                                                              0.5, 2.0]))],
    "cov": [("r", lambda n: [n.cov(_a(n, M.T)), n.cov(_a(n, M),
                                                      rowvar=False),
                             n.cov(_a(n, V), ddof=0)])],
    "corrcoef": [("r", lambda n: n.corrcoef(_a(n, M.T)))],
    "interp": [("e", lambda n: n.interp(
        _a(n, np.array([-1.0, 0.5, 3.3, 9.9, 12.0])),
        _a(n, np.linspace(0, 10, 11)), _a(n, np.linspace(0, 10, 11) ** 2)))],
    "pad": [("e", lambda n: [n.pad(_a(n, M[:2, :3]), 1),
                             n.pad(_a(n, M[:2, :3]), ((1, 0), (0, 2))),
                             n.pad(_a(n, M[:3, :4]), 2, mode="edge"),
                             n.pad(_a(n, M[:3, :4]), ((2, 3), (1, 5)),
                                   mode="reflect"),
                             n.pad(_a(n, M[:3, :4]), ((4, 1), (2, 3)),
                                   mode="symmetric"),
                             n.pad(_a(n, M[:3, :4]), ((5, 1), (2, 9)),
                                   mode="wrap"),
                             n.pad(_a(n, M[:2, :3]), 1,
                                   constant_values=7.0)])],
    "bincount": [("e", lambda n: [n.bincount(_a(n, INTS)),
                                  n.bincount(_a(n, INTS), minlength=10)])],
    "argwhere": [("e", lambda n: n.argwhere(_a(n, M > 0)))],
    "flatnonzero": [("e", lambda n: n.flatnonzero(_a(n, M > 0)))],
    "nonzero": [("e", lambda n: n.nonzero(_a(n, M > 0)))],
    "meshgrid": [("e", lambda n: n.meshgrid(_a(n, np.arange(3.0)),
                                            _a(n, np.arange(4)))),
                 ("e", lambda n: n.meshgrid(_a(n, np.arange(3.0)),
                                            _a(n, np.arange(4.0)),
                                            _a(n, np.arange(2.0)),
                                            indexing="ij")),
                 ("e", lambda n: n.meshgrid(_a(n, np.arange(3.0)),
                                            _a(n, np.arange(4.0)),
                                            _a(n, np.arange(2.0))))],
    "cross": [("e", lambda n: [n.cross(_a(n, M[:, :3]), _a(n, M[:, 3:])),
                               n.cross(_a(n, M[:, :2]), _a(n, M[:, 2:4])),
                               n.cross(_a(n, M[:3]), _a(n, M[3:6]),
                                       axis=0)])],
    "convolve": [("r", lambda n: [n.convolve(_a(n, V[:20]), _a(n, V[:5])),
                                  n.convolve(_a(n, V[:5]), _a(n, V[:20]),
                                             mode="same"),
                                  n.convolve(_a(n, V[:20]), _a(n, V[:6]),
                                             mode="valid")])],
    "correlate": [("r", lambda n: [n.correlate(_a(n, V[:20]), _a(n, V[:5])),
                                   n.correlate(_a(n, V[:5]), _a(n, V[:20]),
                                               mode="full"),
                                   n.correlate(_a(n, V[:20]), _a(n, V[:4]),
                                               mode="same")])],
    "gradient": [("e", lambda n: [n.gradient(_a(n, V)),
                                  n.gradient(_a(n, M)),
                                  n.gradient(_a(n, M), axis=1)])],
    "trapezoid": [("r", lambda n: [n.trapezoid(_a(n, V)),
                                   n.trapezoid(_a(n, M), dx=0.5, axis=0),
                                   n.trapezoid(_a(n, V[:6]),
                                               _a(n, np.sort(V[6:12])))])],
    "trapz": [("r", lambda n: n.trapz(_a(n, M)))],
    "sinc": [("e", lambda n: n.sinc(_a(n, np.concatenate([V, [0.0]]))))],
    "ediff1d": [("e", lambda n: n.ediff1d(_a(n, M)))],
    "vander": [("e", lambda n: [n.vander(_a(n, np.arange(1.0, 4.0))),
                                n.vander(_a(n, V[:4]), 3,
                                         increasing=True)])],
    "tri": [("e", lambda n: [n.tri(4, 5, 1), n.tri(3)])],
    "full_like": [("e", lambda n: [n.full_like(_a(n, M), 3.5),
                                   n.full_like(_a(n, INTS), 2.7)])],
    "geomspace": [("e", lambda n: n.geomspace(1, 1000, 4))],
    "append": [("e", lambda n: [n.append(_a(n, M), _a(n, M), axis=0),
                                n.append(_a(n, V[:3]), _a(n, M[:2]))])],
    "array_split": [("e", lambda n: n.array_split(_a(n, M), 3, axis=0)),
                    ("e", lambda n: n.array_split(_a(n, M), [1, 4],
                                                  axis=1))],
    "vsplit": [("e", lambda n: n.vsplit(_a(n, M), 4))],
    "hsplit": [("e", lambda n: n.hsplit(_a(n, M), 2))],
    "dsplit": [("e", lambda n: n.dsplit(_a(n, M.reshape(2, 2, 12)), 3))],
    "atleast_3d": [("e", lambda n: [n.atleast_3d(_a(n, np.arange(3))),
                                    n.atleast_3d(_a(n, M))])],
    "diagonal": [("e", lambda n: [n.diagonal(_a(n, M)),
                                  n.diagonal(_a(n, M), 2),
                                  n.diagonal(_a(n, M), -3)])],
    "diagflat": [("e", lambda n: [n.diagflat(_a(n, np.arange(4.0))),
                                  n.diagflat(_a(n, M[:2, :2]), -1)])],
    "digitize": [("e", lambda n: [
        n.digitize(_a(n, M), _a(n, np.array([-1.0, 0.0, 1.0]))),
        n.digitize(_a(n, np.array([0.0, 1.0, 2.5])),
                   _a(n, np.array([0.0, 1.0, 2.0])), right=True),
        n.digitize(_a(n, np.array([0.0, 1.0, 2.5])),
                   _a(n, np.array([2.0, 1.0, 0.0])))])],
    "angle": [("e", lambda n: [n.angle(_a(n, C)), n.angle(_a(n, C),
                                                          deg=True),
                               n.angle(_a(n, V))])],
    "fix": [("e", lambda n: [n.fix(_a(n, M)), n.fix(_a(n, INTS))])],
    "divmod": [("e", lambda n: n.divmod(_a(n, np.arange(1.0, 10.0)), 4.0)),
               ("e", lambda n: n.divmod(_a(n, np.arange(-5, 6)),
                                        _a(n, np.array([3, -3] * 5 + [2])))),
               ("e", lambda n: n.divmod(_a(n, V), -0.7))],
    "compress": [("e", lambda n: n.compress(_a(n, np.array([True, False,
                                                            True])),
                                            _a(n, M)[:3], axis=0)),
                 ("e", lambda n: n.compress(np.array([False, True]),
                                            _a(n, M[:2])))],
    "extract": [("e", lambda n: n.extract(_a(n, M > 0), _a(n, M)))],
    "broadcast_arrays": [("e", lambda n: n.broadcast_arrays(_a(n, M[:1]),
                                                            _a(n, M)))],
    "broadcast_shapes": [("e", lambda n: n.broadcast_shapes((3, 1),
                                                            (1, 4)))],
    "asanyarray": [("e", lambda n: n.asanyarray(np.arange(3),
                                                dtype=np.float32))],
    "astype": [("e", lambda n: n.astype(_a(n, M), np.float32))],
    "acos": [("e", lambda n: n.acos(_a(n, np.array([0.5, -0.2]))))],
    "acosh": [("e", lambda n: n.acosh(_a(n, np.array([1.5, 3.0]))))],
    "asin": [("e", lambda n: n.asin(_a(n, np.array([0.5, -0.2]))))],
    "asinh": [("e", lambda n: n.asinh(_a(n, V)))],
    "atan": [("e", lambda n: n.atan(_a(n, V)))],
    "atanh": [("e", lambda n: n.atanh(_a(n, np.array([0.5, -0.2]))))],
    "atan2": [("e", lambda n: n.atan2(_a(n, M), _a(n, M) + 3.0))],
    "bitwise_invert": [("e", lambda n: n.bitwise_invert(_a(n, INTS)))],
    "bitwise_left_shift": [("e", lambda n: n.bitwise_left_shift(
        _a(n, INTS), 2))],
    "bitwise_right_shift": [("e", lambda n: n.bitwise_right_shift(
        _a(n, INTS), 1))],
    "concat": [("e", lambda n: n.concat([_a(n, M), _a(n, M)]))],
    "pow": [("e", lambda n: n.pow(n.abs(_a(n, M)), 2.0))],
    "permute_dims": [("e", lambda n: n.permute_dims(_a(n, M)))],
}

TOL = {"e": "elementwise", "r": "reduction"}
PARAMS = [(name, i) for name in sorted(CASES)
          for i in range(len(CASES[name]))]


def test_every_name_has_a_case():
    assert sorted(CASES) == sorted(jextra.__all__)


@pytest.mark.parametrize("name,i", PARAMS)
def test_extra(apps, name, i):
    cls, fn = CASES[name][i]
    facade_parity(apps, lambda nps, app: fn(nps), TOL[cls])


def test_float32_statistics_at_20m_elements_path(apps):
    """``percentile``, ``median`` and ``sort`` take a sort on the device,
    not ``torch.quantile`` (which refuses inputs above 2^24 elements):
    checked here at 64×48 float32 with ties."""
    x = np.round(M32 * 4) / 4

    def fn(nps, app):
        a = nps.array(x)
        return (nps.percentile(a, [1, 50, 99], axis=0), nps.median(a),
                nps.sort(a, axis=0), nps.argsort(a, axis=0))

    facade_parity(apps, fn, "reduction")
