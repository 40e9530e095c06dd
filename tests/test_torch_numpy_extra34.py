"""``nums_tpu_torch.numpy.extra3`` and ``.extra4`` against the reference's,
name by name: every name of each ``__all__`` has at least one case, with
the places where jnp and NumPy differ (``partition``/``argpartition`` in
``lax.top_k``'s order, ``lexsort`` by successive stable sorts, ``choose``
clipping, the ``poly*`` family's promotion, ``roots`` of real and complex
coefficients, ``unique_*`` keeping NaNs apart).

Same numpy inputs through both packages on the CPU (x64 on); shape,
dtype and value compared (tests/torch_parity.py): exact for integer,
bool, index, sort and set results; elementwise float64 within 1e-12
relative plus 1e-12 of max|ref|; ``polyfit``-class results (``polydiv``,
``poly``, ``roots``, compared after ``sort_complex``) within 1e-8 of
max|ref|. The mutators of ``extra4`` return None in both packages: the
mutated array is compared. A third test runs cases on arrays split into
ragged blocks, as tests/numpy/test_extra_ragged.py does.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

from nums_tpu.numpy import extra3 as jextra3, extra4 as jextra4

RS = np.random.RandomState(3)
M = RS.randn(9, 7)
M32 = RS.randn(12, 10).astype(np.float32)
V = RS.randn(30)
T3 = RS.randn(3, 4, 5)
TIES = np.array([3.0, 1.0, 2.0, 1.0, 3.0, 0.0, 1.0, 2.0, np.nan, -1.0])
INTS = np.array([0, 1, 1, 3, 5, 5, 5, -2, 7, 3, 3, 0])
C = np.array([1 + 2j, 3 - 1j, -2 + 0.5j, 1 - 1j, 4.0 + 0j, 1 + 2j])
NAN = np.array([1.0, np.nan, 2.0, np.nan, 1.0, 0.5])


def _a(nps, x):
    return nps.array(x)


def _mut(fn_name, x, *args, **kwargs):
    """A mutator's call, then the mutated array (the call returns None)."""
    def run(n):
        a = _a(n, x)
        assert getattr(n, fn_name)(a, *args(n), **kwargs) is None
        return a

    return run


def _roots(n, p):
    return n.sort_complex(n.roots(_a(n, np.asarray(p))))


# name -> [(class, fn(nps))]; class: "e" elementwise/exact, "p" polynomial
CASES = {
    "argpartition": [
        ("e", lambda n: n.argpartition(_a(n, M), 3)),
        ("e", lambda n: n.argpartition(_a(n, M), 2, axis=0)),
        ("e", lambda n: n.argpartition(_a(n, TIES), 4)),
        ("e", lambda n: n.argpartition(_a(n, INTS), -3)),
        ("e", lambda n: n.argpartition(_a(n, T3), 1, axis=1))],
    "partition": [
        ("e", lambda n: n.partition(_a(n, M), 3)),
        ("e", lambda n: n.partition(_a(n, M32), 0, axis=0)),
        ("e", lambda n: n.partition(_a(n, TIES), 5)),
        ("e", lambda n: n.partition(_a(n, INTS), 11)),
        ("e", lambda n: n.partition(_a(n, C), 2))],
    "lexsort": [
        ("e", lambda n: n.lexsort([_a(n, INTS), _a(n, INTS % 3)])),
        ("e", lambda n: n.lexsort((_a(n, M[:, 0]), _a(n, M[:, 1] > 0),
                                   _a(n, (M[:, 2] * 2).round())))),
        ("e", lambda n: n.lexsort([_a(n, M.round()), _a(n, M.round() % 2)],
                                  axis=0)),
        ("e", lambda n: n.lexsort([_a(n, TIES)]))],
    "modf": [("e", lambda n: n.modf(_a(n, np.concatenate([V * 3, TIES, [
        np.inf, -np.inf, -0.0, -2.5]])))),
             ("e", lambda n: n.modf(_a(n, M32))),
             ("e", lambda n: n.modf(_a(n, INTS)))],
    "rot90": [("e", lambda n: [n.rot90(_a(n, M)), n.rot90(_a(n, M), 2),
                               n.rot90(_a(n, M), -1),
                               n.rot90(_a(n, T3), 3, axes=(2, 0))])],
    "rollaxis": [("e", lambda n: [n.rollaxis(_a(n, T3), 2),
                                  n.rollaxis(_a(n, T3), 0, 3),
                                  n.rollaxis(_a(n, T3), -1, 1),
                                  n.rollaxis(_a(n, T3), 1, 1)])],
    "vecdot": [("e", lambda n: n.vecdot(_a(n, M), _a(n, M))),
               ("e", lambda n: n.vecdot(_a(n, C), _a(n, C[::-1])))],
    "block": [("e", lambda n: n.block([[_a(n, M[:3, :2]), _a(n, M[:3, 2:])],
                                       [_a(n, M[3:, :5]), _a(n, M[3:, 5:])]])),
              ("e", lambda n: n.block([_a(n, V[:3]), _a(n, INTS[:2]),
                                       _a(n, V[5:9])])),
              ("e", lambda n: n.block([[_a(n, V[:3])], [_a(n, V[3:6])]])),
              ("e", lambda n: n.block([[_a(n, T3)], [_a(n, T3)]]))],
    "choose": [("e", lambda n: n.choose(_a(n, np.array([0, 2, 1, 3, -1, 5])),
                                        [_a(n, V[:6]), _a(n, V[6:12]),
                                         _a(n, INTS[:6])])),
               ("e", lambda n: n.choose(_a(n, (M > 0).astype(np.int64)),
                                        [_a(n, M), _a(n, -M[:1])]))],
    "delete": [("e", lambda n: [n.delete(_a(n, M), 2, axis=0),
                                n.delete(_a(n, M), -1, axis=1),
                                n.delete(_a(n, M), slice(1, 6, 2), axis=1),
                                n.delete(_a(n, V), 4)]),
               ("e", lambda n: n.delete(_a(n, M), _a(n, np.array([0, 3, 4])),
                                        axis=0)),
               ("e", lambda n: n.delete(_a(n, M), slice(None, None, -3)))],
    "insert": [("e", lambda n: [n.insert(_a(n, V[:8]), 3, 9.5),
                                n.insert(_a(n, M), 2, _a(n, V[:7]), axis=0),
                                n.insert(_a(n, M), -1, 0.0, axis=1),
                                n.insert(_a(n, M), 9, _a(n, V[:7]), axis=0),
                                n.insert(_a(n, V[:8]), slice(1, 6, 2),
                                         _a(n, V[:3]))]),
               ("e", lambda n: n.insert(_a(n, INTS), [1, 4], 99)),
               ("e", lambda n: n.insert(_a(n, M), 1, _a(n, M[:, :2].T),
                                        axis=1))],
    "array_equiv": [("e", lambda n: [n.array_equiv(_a(n, M[:1]), _a(n, M[:1])),
                                     n.array_equiv(_a(n, M[:1]), _a(n, M)),
                                     n.array_equiv(_a(n, np.ones((3, 2))),
                                                   _a(n, np.ones(2))),
                                     n.array_equiv(_a(n, M), _a(n, V))])],
    "in1d": [("e", lambda n: n.in1d(_a(n, INTS.reshape(3, 4)),
                                    _a(n, np.array([1, 3, 8])))),
             ("e", lambda n: n.in1d(_a(n, TIES), _a(n, TIES[:4]))),
             ("e", lambda n: n.in1d(_a(n, C), _a(n, C[::2])))],
    "intersect1d": [("e", lambda n: n.intersect1d(_a(n, INTS),
                                                  _a(n, np.array([5, 3, 9, 3])))),
                    ("e", lambda n: n.intersect1d(_a(n, M.round()),
                                                  _a(n, M[:3].round()))),
                    ("e", lambda n: n.intersect1d(_a(n, C), _a(n, C[:3]))),
                    ("e", lambda n: n.intersect1d(_a(n, INTS),
                                                  _a(n, np.zeros(0))))],
    "setdiff1d": [("e", lambda n: n.setdiff1d(_a(n, INTS),
                                              _a(n, np.array([5, 3, 9])))),
                  ("e", lambda n: n.setdiff1d(_a(n, M.round()),
                                              _a(n, np.array([0.0, 1.0])))),
                  ("e", lambda n: n.setdiff1d(_a(n, INTS),
                                              _a(n, INTS)))],
    "setxor1d": [("e", lambda n: n.setxor1d(_a(n, INTS),
                                            _a(n, np.array([5, 3, 9, 11])))),
                 ("e", lambda n: n.setxor1d(_a(n, M[0].round()),
                                            _a(n, M[1].round())))],
    "union1d": [("e", lambda n: n.union1d(_a(n, INTS),
                                          _a(n, np.array([5, 30, 9, -4])))),
                ("e", lambda n: n.union1d(_a(n, M[:2].round()),
                                          _a(n, V.round()))),
                ("e", lambda n: n.union1d(_a(n, np.zeros(0)), _a(n, INTS)))],
    "unique_all": [("e", lambda n: n.unique_all(_a(n, INTS.reshape(3, 4)))),
                   ("e", lambda n: n.unique_all(_a(n, NAN)))],
    "unique_counts": [("e", lambda n: n.unique_counts(_a(n, INTS))),
                      ("e", lambda n: n.unique_counts(_a(n, NAN))),
                      ("e", lambda n: n.unique_counts(_a(n, C)))],
    "unique_inverse": [("e", lambda n: n.unique_inverse(_a(n, M.round()))),
                       ("e", lambda n: n.unique_inverse(_a(n, NAN)))],
    "unique_values": [("e", lambda n: n.unique_values(_a(n, INTS))),
                      ("e", lambda n: n.unique_values(_a(n, NAN))),
                      ("e", lambda n: n.unique_values(_a(n, np.zeros(0))))],
    "trim_zeros": [("e", lambda n: [
        n.trim_zeros(_a(n, np.array([0, 0, 3, 0, 5, 0]))),
        n.trim_zeros(_a(n, np.array([0, 0, 3, 0, 5, 0])), "f"),
        n.trim_zeros(_a(n, np.array([0.0, 0.0, 3.0, 0.0, 5.0, 0.0])), "B"),
        n.trim_zeros(_a(n, np.zeros(4))), n.trim_zeros(_a(n, np.zeros(0)))])],
    "sort_complex": [("e", lambda n: n.sort_complex(_a(n, C))),
                     ("e", lambda n: n.sort_complex(_a(n, M))),
                     ("e", lambda n: n.sort_complex(_a(n, M32))),
                     ("e", lambda n: n.sort_complex(_a(n, INTS)))],
    "polyadd": [("e", lambda n: [n.polyadd(_a(n, V[:3]), _a(n, V[:5])),
                                 n.polyadd(_a(n, INTS[:4]), _a(n, INTS[:2])),
                                 n.polyadd(_a(n, C[:2]), _a(n, V[:4]))])],
    "polysub": [("e", lambda n: [n.polysub(_a(n, V[:3]), _a(n, V[:5])),
                                 n.polysub(_a(n, INTS[:4]), _a(n, INTS[:6]))])],
    "polymul": [("e", lambda n: [n.polymul(_a(n, V[:3]), _a(n, V[:5])),
                                 n.polymul(_a(n, INTS[:4]), _a(n, INTS[2:5])),
                                 n.polymul(_a(n, C[:2]), _a(n, V[:3]))])],
    "polydiv": [("p", lambda n: n.polydiv(_a(n, V[:7]), _a(n, V[:3]))),
                ("p", lambda n: n.polydiv(_a(n, np.array([1.0, -3, 2])),
                                          _a(n, np.array([1.0, -1])))),
                ("p", lambda n: n.polydiv(_a(n, INTS[2:6]), _a(n, INTS[3:5])))],
    "polyder": [("e", lambda n: [n.polyder(_a(n, V[:6])),
                                 n.polyder(_a(n, V[:6]), 3),
                                 n.polyder(_a(n, V[:6]), 0),
                                 n.polyder(_a(n, INTS[:5]), 2)])],
    "polyint": [("e", lambda n: [n.polyint(_a(n, V[:4])),
                                 n.polyint(_a(n, V[:4]), 3),
                                 n.polyint(_a(n, INTS[:5]))])],
    "poly": [("p", lambda n: n.poly(_a(n, V[:5]))),
             ("p", lambda n: n.poly(_a(n, np.array([1 + 2j, 1 - 2j, 3.0])))),
             ("p", lambda n: n.poly(_a(n, C[:3]))),
             ("p", lambda n: n.poly(_a(n, np.array([2, -1, 3])))),
             ("p", lambda n: n.poly(_a(n, M[:4, :4])))],
    "roots": [("p", lambda n: _roots(n, [1.0, -6.0, 11.0, -6.0])),
              ("p", lambda n: _roots(n, [1.0, 0.0, 1.0])),
              ("p", lambda n: _roots(n, [0.0, 0.0, 2.0, -3.0, 1.0])),
              ("p", lambda n: _roots(n, V[:7])),
              ("p", lambda n: _roots(n, C[:4])),
              ("p", lambda n: _roots(n, np.array([2, 0, -8])))],
    "issubdtype": [("e", lambda n: [n.issubdtype(np.float32, np.floating),
                                     n.issubdtype(np.int8, np.floating)])],
    "isdtype": [("e", lambda n: [n.isdtype(np.float64, "real floating"),
                                  n.isdtype(np.int32, "integral")])],
    "iterable": [("e", lambda n: [n.iterable([1, 2]), n.iterable(3)])],
    "real_if_close": [("e", lambda n: n.real_if_close(_a(n, V + 1e-15j))),
                      ("e", lambda n: n.real_if_close(_a(n, C))),
                      ("e", lambda n: n.real_if_close(_a(n, V + 1e-9j),
                                                      tol=1e-8)),
                      ("e", lambda n: n.real_if_close(_a(n, M)))],
    # -- extra4: the mutated array ------------------------------------------
    "put": [("e", _mut("put", M, lambda n: (_a(n, np.array([0, 5, 62, -1])),
                                            _a(n, np.array([1.5, -2.0]))))),
            ("e", _mut("put", INTS, lambda n: (_a(n, np.array([2, 40, 3])),
                                               _a(n, np.array([7.9]))))),
            ("e", _mut("put", M, lambda n: (_a(n, np.array([[1, 2], [3, 4]])),
                                            _a(n, V[:4]))))],
    "put_along_axis": [
        ("e", _mut("put_along_axis", M,
                   lambda n: (n.argsort(_a(n, M), axis=1)[:, :2],
                              _a(n, np.array([-9.0, 9.0]))), axis=1)),
        ("e", _mut("put_along_axis", M,
                   lambda n: (_a(n, np.array([[0, 8, -1, 3, 2, 1, 4]])),
                              _a(n, V[:7])), axis=0)),
        ("e", _mut("put_along_axis", INTS.reshape(3, 4),
                   lambda n: (_a(n, np.array([[0], [3], [1]])),
                              _a(n, np.array([[-5], [6], [7]]))), axis=1))],
    "place": [("e", _mut("place", M, lambda n: (_a(n, M > 0.5),
                                                _a(n, np.array([7.0, 8.0]))))),
              ("e", _mut("place", INTS, lambda n: (_a(n, INTS > 2),
                                                   _a(n, np.array([-1])))))],
    "putmask": [("e", _mut("putmask", M, lambda n: (_a(n, M > 1.0), 1.0))),
                ("e", _mut("putmask", M, lambda n: (_a(n, M < 0),
                                                    _a(n, V[:5])))),
                ("e", _mut("putmask", INTS, lambda n: (_a(n, INTS == 5),
                                                       _a(n, np.array([2.7])))))],
    "copyto": [("e", _mut("copyto", M, lambda n: (_a(n, V[:7]),))),
               ("e", _mut("copyto", INTS, lambda n: (_a(n, V[:12] * 10),))),
               ("e", _mut("copyto", M, lambda n: (2.5,)))],
    "fill_diagonal": [("e", _mut("fill_diagonal", M, lambda n: (7.0,))),
                      ("e", _mut("fill_diagonal", M.T,
                                 lambda n: (_a(n, np.array([1.0, 2.0])),))),
                      ("e", _mut("fill_diagonal", np.zeros((3, 3, 3)),
                                 lambda n: (_a(n, V[:3]),))),
                      ("e", _mut("fill_diagonal", INTS.reshape(3, 4),
                                 lambda n: (9,)))],
    "apply_along_axis": [
        ("e", lambda n: n.apply_along_axis(lambda v: (v * v).sum(), 0,
                                           _a(n, M))),
        ("e", lambda n: n.apply_along_axis(lambda v: v * 2.0 - v.mean(), 1,
                                           _a(n, M))),
        ("e", lambda n: n.apply_along_axis(lambda v: v.max() - v.min(), 1,
                                           _a(n, T3))),
        ("e", lambda n: n.apply_along_axis(lambda v, k: v[:k] + 1, 0,
                                           _a(n, T3), 2))],
}

TOL = {"e": "elementwise", "p": "poly"}
PARAMS = [(name, i) for name in sorted(CASES)
          for i in range(len(CASES[name]))]


def test_every_name_has_a_case():
    assert sorted(CASES) == sorted(jextra3.__all__ + jextra4.__all__)


@pytest.mark.parametrize("name,i", PARAMS)
def test_extra34(apps, name, i):
    cls, fn = CASES[name][i]
    facade_parity(apps, lambda nps, app: fn(nps), TOL[cls])


RAGGED = {
    "argpartition": lambda n, a: n.argpartition(a, 2, axis=1),
    "partition": lambda n, a: n.partition(a, 4, axis=0),
    "lexsort": lambda n, a: n.lexsort([a.round(), a > 0], axis=0),
    "modf": lambda n, a: n.modf(a * 3),
    "rot90": lambda n, a: n.rot90(a),
    "delete": lambda n, a: n.delete(a, 3, axis=1),
    "insert": lambda n, a: n.insert(a, 2, 0.5, axis=0),
    "unique_counts": lambda n, a: n.unique_counts(a.round()),
    "setdiff1d": lambda n, a: n.setdiff1d(a.round(), a[:2].round()),
    "put_along_axis": lambda n, a: (n.put_along_axis(
        a, n.argsort(a, axis=0)[:1], 0.0, axis=0), a)[1],
    "putmask": lambda n, a: (n.putmask(a, a > 0, -a), a)[1],
    "apply_along_axis": lambda n, a: n.apply_along_axis(
        lambda v: v.sum() * 2, 1, a),
}


@pytest.mark.parametrize("name", sorted(RAGGED))
@pytest.mark.parametrize("block_shape", [(4, 3), (2, 5)])
def test_ragged_blocks(apps, name, block_shape):
    """Arrays split into blocks that do not divide their shape."""
    def fn(nps, app):
        return RAGGED[name](nps, app.array(M, block_shape=block_shape))

    facade_parity(apps, fn, "elementwise")


def test_mutators_leave_views_alone(torch_app):
    """Each mutator rebinds its array to a new tensor: a view taken
    before the call keeps the old values."""
    import nums_tpu_torch.numpy as tnps

    calls = {
        "put": lambda a: tnps.put(a, torch_app.array(np.array([0, 1])), 9.0),
        "put_along_axis": lambda a: tnps.put_along_axis(
            a, torch_app.array(np.zeros((1, 7), dtype=np.int64)), 9.0, 0),
        "place": lambda a: tnps.place(a, a > -100, 9.0),
        "putmask": lambda a: tnps.putmask(a, a > -100, 9.0),
        "copyto": lambda a: tnps.copyto(a, 9.0),
        "fill_diagonal": lambda a: tnps.fill_diagonal(a, 9.0),
    }
    for name, call in calls.items():
        a = torch_app.array(M)
        view = a.data[:2]
        before = view.clone()
        call(a)
        assert (a.get() == 9.0).any(), name
        assert view.equal(before), name


def test_unique_of_complex_nan_counts_as_numpy(torch_app):
    """The reference's ``unique`` of complex input with NaNs returns
    trailing garbage (8 values for 6 distinct); the port gives NumPy's
    distinct values, every complex NaN as one nan+0j, last."""
    import nums_tpu_torch.numpy as tnps

    c = np.array([1 + 2j, 1 - 1j, complex(np.nan, 0), complex(0, np.nan),
                  -1 + 5j, 1 + 2j, 2 + 0j, 0j, complex(np.nan, np.nan)])
    got = tnps.unique(torch_app.array(c)).get()
    ref = np.unique(c)
    assert got.shape == ref.shape
    assert np.array_equal(got[:-1], ref[:-1])
    assert np.isnan(got[-1].real) and got[-1].imag == 0
