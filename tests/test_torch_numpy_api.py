"""``nums_tpu_torch.numpy``'s core (``numpy/api.py``) against
``nums_tpu.numpy``, and the facade's surface.

Each case runs ``fn(nps, app)`` with the same numpy inputs through both
packages on the CPU (serial applications, x64 on) and compares shape,
dtype and value (tests/torch_parity.py): exact for integer, bool, index
and shape results; elementwise float64 within 1e-12 relative and float32
within 2e-6 relative plus 1e-6 of max|ref|; reductions within 1e-12
(float64) and 1e-5 (float32) of max|ref|. Where the reference raises, the
port raises the same exception type. The cases are those of
tests/numpy/test_api.py, test_api_guards.py, test_creation_manipulation.py,
test_np_reduction.py and test_np_utils.py.

The surface test holds every public name of the reference's modules
(``api``, ``extra``, ``extra2``, ``extra3``, ``extra4``, ``compat``,
``tail``, ``linalg`` and ``fft``) to a real function in the port, and
every callable that ``nums_tpu.numpy`` and ``nums_tpu.numpy.fft``
implement (not stub) to one that is not a stub.
"""

import itertools

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, facade_parity, jax_app, torch_app,
)

import nums_tpu.numpy as jnps
import nums_tpu_torch.numpy as tnps
from nums_tpu.numpy import (
    api as japi, compat as jcompat, extra as jextra, extra2 as jextra2,
    extra3 as jextra3, extra4 as jextra4, fft as jfft, linalg as jlinalg,
    tail as jtail,
)
from nums_tpu_torch.core.grid import ArrayGrid

RS = np.random.RandomState(0)
X = RS.randn(10, 8)
V = X[:, 0].copy()


def test_constants_and_dtypes():
    for name in ("pi", "e", "euler_gamma", "inf", "NINF", "newaxis",
                 "float64", "bool_", "int32", "complex64", "uint8"):
        assert getattr(tnps, name) is getattr(jnps, name) or (
            getattr(tnps, name) == getattr(jnps, name)), name
    assert np.isnan(tnps.nan)
    assert tnps.result_type is np.result_type and tnps.dtype is np.dtype


CREATION = {
    "zeros": lambda nps, app: nps.zeros((5, 3)),
    "ones_int": lambda nps, app: nps.ones(7, dtype=np.int64),
    "empty": lambda nps, app: nps.empty((2, 2)),
    "array": lambda nps, app: nps.array([[1.0, 2.0], [3.0, 4.0]]),
    "array_int": lambda nps, app: nps.array([1, 2, 3]),
    "array_bool": lambda nps, app: nps.array([True, False]),
    "array_dtype": lambda nps, app: nps.array([1.5, 2.5], dtype=np.float32),
    "array_copy": lambda nps, app: nps.array(nps.array([1.0, 2.0])),
    "array_astype": lambda nps, app: nps.array(nps.array([1.0, 2.0]),
                                               dtype=np.int64),
    "array_order": lambda nps, app: nps.array([1.0], order="C"),
    "array_ndmin": lambda nps, app: nps.array([1.0], ndmin=2),
    "array_subok": lambda nps, app: nps.array([1.0], subok=True),
    "asarray": lambda nps, app: nps.asarray(np.arange(3.0)),
    "zeros_like": lambda nps, app: nps.zeros_like(nps.array(X)),
    "ones_like_int": lambda nps, app: nps.ones_like(nps.array(X),
                                                    dtype=np.int64),
    "empty_like": lambda nps, app: nps.empty_like(nps.array(X)),
    "like_shape": lambda nps, app: nps.zeros_like(nps.array(X),
                                                  dtype=np.int32,
                                                  shape=(4, 20)),
    "like_order": lambda nps, app: nps.ones_like(nps.array(X), order="F"),
    "identity": lambda nps, app: nps.identity(4),
    "eye": lambda nps, app: [nps.eye(n, m, k=k) for n, m, k in
                             [(4, 4, 0), (3, 5, 0), (5, 3, 0), (4, 4, 1),
                              (4, 6, -2)]],
    "full": lambda nps, app: nps.full((3, 2), 7.5),
    "full_int": lambda nps, app: nps.full(4, 3),
    "diag": lambda nps, app: [nps.diag(nps.array(np.arange(4.0))),
                              nps.diag(nps.array(X[:4, :4]))],
    "diag_k": lambda nps, app: nps.diag(nps.array(np.arange(4.0)), k=1),
    "arange": lambda nps, app: [nps.arange(10), nps.arange(3, 10),
                                nps.arange(5, dtype=np.float64),
                                nps.arange(0.0, 4.0)],
    "arange_step": lambda nps, app: nps.arange(0, 10, 2),
    "linspace": lambda nps, app: [nps.linspace(2, 3, 11),
                                  nps.linspace(0, 1, 5, endpoint=False)],
    "logspace": lambda nps, app: nps.logspace(0, 2, 5),
    "logspace_dtype": lambda nps, app: nps.logspace(0, 2, 5,
                                                    dtype=np.float32),
    "isscalar": lambda nps, app: [nps.isscalar(1.0), nps.isscalar(X)],
    "shape_size_ndim": lambda nps, app: [nps.shape(X), nps.size(X),
                                         nps.ndim(nps.array(X))],
}


@pytest.mark.parametrize("case", sorted(CREATION))
def test_creation(apps, case):
    facade_parity(apps, CREATION[case])


@pytest.mark.parametrize(
    "shape,dtype,name",
    list(itertools.product([(7,), (3, 4), (2, 3, 2)],
                           [np.float64, np.float32, np.int64, np.int32,
                            bool], ["zeros", "ones"])))
def test_creation_dtypes(apps, shape, dtype, name):
    facade_parity(apps, lambda nps, app: getattr(nps, name)(shape,
                                                            dtype=dtype))


MANIPULATION = {
    "reshape": lambda nps, a: nps.reshape(a, (6, 4)),
    "reshape_neg": lambda nps, a: nps.reshape(a, (-1, 2)),
    "reshape_3d": lambda nps, a: nps.reshape(a, (2, 3, 4)),
    "expand_dims": lambda nps, a: nps.expand_dims(a, 0),
    "squeeze": lambda nps, a: nps.squeeze(nps.expand_dims(a, 0)),
    "transpose": lambda nps, a: nps.transpose(a),
    "transpose_axes": lambda nps, a: nps.transpose(a, axes=(1, 0)),
    "concatenate": lambda nps, a: nps.concatenate([a, a], axis=0),
    "concatenate_mixed": lambda nps, a: nps.concatenate(
        [a, np.ones((1, 6))], axis=0),
    "concatenate_out": lambda nps, a: nps.concatenate([a, a], out=a),
    "split": lambda nps, a: nps.split(a, 2, axis=0),
    "copy": lambda nps, a: nps.copy(a),
    "tensordot": lambda nps, a: nps.tensordot(a, a.T, axes=1),
    "tensordot2": lambda nps, a: nps.tensordot(a, a, axes=2),
    "matmul": lambda nps, a: nps.matmul(a, a.T),
    "matmul_3d": lambda nps, a: nps.matmul(nps.reshape(a, (2, 3, 4)),
                                          nps.reshape(a, (2, 4, 3))),
}


@pytest.mark.parametrize("case", sorted(MANIPULATION))
def test_manipulation(apps, case):
    x = np.arange(24).reshape(4, 6).astype(float)
    facade_parity(apps, lambda nps, app: MANIPULATION[case](nps,
                                                            nps.array(x)))


def test_reshape_block_shape(apps):
    def fn(nps, app):
        x = nps.array(np.arange(24.0))
        z = x.reshape(4, 6, block_shape=(2, 3))
        return ([nps.reshape(x, s) for s in [(24,), (4, 6), (6, 4)]],
                z.block_shape, z.grid.grid_shape,
                nps.reshape(x, (-1, 2)).block_shape)

    facade_parity(apps, fn)


@pytest.mark.parametrize("block_shape", [(1, 1), (1, 2), (1, 4), (2, 1),
                                         (2, 4)])
@pytest.mark.parametrize("op", ["amin", "min", "amax", "max", "sum", "mean",
                                "var", "std"])
def test_reductions_sweep(apps, op, block_shape):
    x = np.array([[5.0, -2.0, 4.0, 8.0], [3.0, 6.0, 1.0, 7.0]])

    def fn(nps, app):
        ba = nps.array(x).reshape(block_shape=block_shape)
        return [getattr(nps, op)(ba, axis=axis, keepdims=keep)
                for axis, keep in itertools.product([None, 0, 1],
                                                    [True, False])]

    facade_parity(apps, fn, "reduction")


REDUCTIONS = {
    "sum_dtype": lambda nps, a: nps.sum(a.astype(np.int32), dtype=np.int64),
    "sum_int32": lambda nps, a: nps.sum((a * 10).astype(np.int32), axis=0),
    "sum_bool": lambda nps, a: nps.sum(a > 0),
    "mean_int": lambda nps, a: nps.mean((a * 10).astype(np.int32), axis=1),
    "mean_keep": lambda nps, a: nps.mean(a, axis=1, keepdims=True),
    "var_ddof": lambda nps, a: nps.var(a, ddof=1),
    "std_axis": lambda nps, a: nps.std(a, axis=0, ddof=1),
    "var_f32": lambda nps, a: nps.var(a.astype(np.float32), axis=0),
    "max_bool": lambda nps, a: nps.max(a > 0, axis=1),
    "argmax": lambda nps, a: nps.argmax(a[:, 0]),
    "argmin": lambda nps, a: nps.argmin(a[:, 0]),
    "argmin_2d": lambda nps, a: nps.argmin(a),
    "sum_scalar": lambda nps, a: nps.sum(3.5),
    "where": lambda nps, a: nps.where(a[:, 0] > 0),
    "where_3": lambda nps, a: nps.where(a > 0, a, -a),
    "where_scalars": lambda nps, a: nps.where(a > 0, 1.0, 0),
    "where_int": lambda nps, a: nps.where(a > 0, 1, 0),
    "allclose": lambda nps, a: [nps.allclose(a, a + 1e-12),
                                nps.allclose(a, a + 1.0)],
    "allclose_nan": lambda nps, a: nps.allclose(a, a, equal_nan=True),
}


@pytest.mark.parametrize("case", sorted(REDUCTIONS))
def test_reductions(apps, case):
    facade_parity(apps, lambda nps, app: REDUCTIONS[case](nps, nps.array(X)),
                  "reduction")


@pytest.mark.parametrize("vals", [[5.0, -2.0, 4.0, 8.0], [1.0, 2.0, 3.0, 4.0],
                                  [3.0, 2.0, 1.0, 0.0],
                                  [-1.0, -2.0, -3.0, -0.0]])
def test_argops_sweep(apps, vals):
    def fn(nps, app):
        out = []
        for bs in [(1,), (2,), (3,), (4,)]:
            ba = nps.array(vals).reshape(block_shape=bs)
            out += [getattr(nps, op)(ba, axis=axis)
                    for op in ("argmin", "argmax") for axis in (None, 0)]
        return out

    facade_parity(apps, fn)


GUARDS = {
    "min_out": lambda nps, a: nps.min(a, out=np.empty(3)),
    "max_where": lambda nps, a: nps.max(a, where=np.ones((2, 3), bool)),
    "sum_initial": lambda nps, a: nps.sum(a, initial=0.0),
    "mean_out": lambda nps, a: nps.mean(a, out=np.empty(3)),
    "var_out": lambda nps, a: nps.var(a, out=np.empty(3)),
    "std_out": lambda nps, a: nps.std(a, out=np.empty(3)),
    "argmin_out": lambda nps, a: nps.argmin(a, out=np.empty(3)),
    "argmax_out": lambda nps, a: nps.argmax(a, out=np.empty(3)),
    "ufunc_out": lambda nps, a: nps.exp(a, out=a),
    "ufunc_where": lambda nps, a: nps.add(a, a, where=False),
    "empty_like_order": lambda nps, a: nps.empty_like(a, order="C"),
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_guards(apps, case):
    facade_parity(apps, lambda nps, app: GUARDS[case](
        nps, nps.array(np.arange(6.0).reshape(2, 3))))


UFUNC_FORMS = {
    "sqrt": lambda nps, x, y: nps.sqrt(x),
    "scalar_first": lambda nps, x, y: nps.add(1.5, y),
    "np_first": lambda nps, x, y: nps.subtract(np.ones(6), y),
    "hypot": lambda nps, x, y: nps.hypot(x, y),
    "greater": lambda nps, x, y: nps.greater(x, y),
    "maximum_scalar": lambda nps, x, y: nps.maximum(x, 1.0),
    "exp_list": lambda nps, x, y: nps.exp([0.0, 1.0]),
    "log_scalar": lambda nps, x, y: nps.log(2.0),
    "power_int": lambda nps, x, y: nps.power(nps.array([2, 3]), 2),
    "true_divide_int": lambda nps, x, y: nps.true_divide(nps.array([1, 2]),
                                                         2),
}


@pytest.mark.parametrize("case", sorted(UFUNC_FORMS))
def test_ufunc_call_forms(apps, case):
    x_np = np.abs(RS.randn(6, 6)) + 0.5
    y_np = RS.randn(6, 6)
    facade_parity(apps, lambda nps, app: UFUNC_FORMS[case](
        nps, nps.array(x_np), nps.array(y_np)))


def test_loadtxt(apps, tmp_path):
    path = str(tmp_path / "t.txt")
    np.savetxt(path, np.random.RandomState(5).randn(50, 4))
    facade_parity(apps, lambda nps, app: nps.loadtxt(path))


def test_block_shape_planner(torch_app):
    cases = [((10**9, 250), (1, 1), 64, (64, 1)),
             ((10**9, 250), (16, 1), 1024, (1024, 1)),
             ((250, 10**9), (1, 16), 1024, (1, 1024)),
             ((10**4, 10**4), (1, 1), 64, (8, 8)),
             ((10**4, 10**4 // 8 - 1), (1, 1), 64, (1, 1))]
    for shape, cluster, cores, grid in cases:
        bs = torch_app.compute_block_shape(shape, np.float64,
                                           cluster_shape=cluster,
                                           num_cores=cores)
        assert ArrayGrid(shape, bs, "float64").grid_shape == grid
    bs = torch_app.compute_block_shape((10**4, 10**4 // 8), np.float64,
                                       cluster_shape=(1, 1), num_cores=64)
    assert ArrayGrid((10**4, 10**4 // 8), bs, "float64").grid_shape != (1, 1)
    torch_app._block_shape_map.clear()
    bs1 = torch_app.get_block_shape((10**6, 100), np.float64)
    bs2 = torch_app.get_block_shape((100, 10**6), np.float64)
    assert bs1[0] == bs2[1] and bs1[1] == bs2[0]


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")
                 and not isinstance(vars(mod)[n], type(np))]
    return names


def _is_stub(obj):
    return getattr(obj, "_nums_tpu_stub", False)


def test_surface():
    """Every public name of the reference's facade modules is in the port
    and is not a stub, and so is every callable that ``nums_tpu.numpy``
    and ``nums_tpu.numpy.fft`` implement: the port stubs nothing the
    reference implements."""
    for jmod, tmod in ((japi, tnps), (jextra, tnps), (jextra2, tnps),
                       (jextra3, tnps), (jextra4, tnps), (jcompat, tnps),
                       (jtail, tnps), (jlinalg, tnps.linalg),
                       (jfft, tnps.fft)):
        for name in _public(jmod):
            if name in ("np", "BlockArray") or not callable(
                    getattr(jmod, name)):
                continue
            assert hasattr(tmod, name), (jmod.__name__, name)
            assert not _is_stub(getattr(tmod, name)), (jmod.__name__, name)
    for jmod, tmod in ((jnps, tnps), (jnps.fft, tnps.fft)):
        names = [n for n in sorted(vars(jmod)) if not n.startswith("_")
                 and callable(getattr(jmod, n))
                 and not isinstance(getattr(jmod, n), type)
                 and not _is_stub(getattr(jmod, n))]
        assert len(names) >= (18 if jmod is jnps.fft else 360)
        for name in names:
            got = getattr(tmod, name, None)
            assert got is not None, (jmod.__name__, name)
            assert not _is_stub(got), (jmod.__name__, name)
    assert not _is_stub(tnps.fft.fft2)
    assert int(tnps.busday_count("2026-01-01", "2026-02-01")) == 22


# The facade's host steps, each the reference's own: ``unique`` with
# ``axis=`` or of an empty array (nums_tpu/numpy/extra.py:474-494),
# ``eig``/``eigvals`` through LAPACK (nums_tpu/numpy/linalg.py:188-251),
# ``argwhere``/``flatnonzero`` of a 0-d array (extra.py:930-945).
# Those of the later modules: ``delete``/``insert`` at array-valued
# positions, ``poly`` of a square matrix, ``roots`` (extra3.py:398-443),
# the set operations' and ``trim_zeros``' empty-array short cuts, ``place``
# (extra4.py:62-72), printing, and tail.py's passthroughs (its
# ``_dehost``).
HOST_STEPS = {"extra.unique", "linalg._host_eig", "extra.argwhere",
              "extra.flatnonzero", "extra3.delete", "extra3.insert",
              "extra3.poly", "extra3.roots", "extra3._device_unique_1d",
              "extra3._unique_result", "extra3.trim_zeros", "extra4.place",
              "compat.array_repr", "compat.array_str",
              "compat.array2string", "tail._dehost"}


def test_no_facade_function_moves_an_operand_to_the_host():
    """No function of the facade's modules calls ``.get()``, ``.cpu()``,
    ``.numpy()`` or ``.tolist()`` outside the reference's own host steps
    (the scalar syncs of ``bincount`` and of the mask counts read one
    number, not an operand)."""
    import ast
    import pathlib

    root = pathlib.Path(tnps.__file__).parent
    found = set()
    for mod in ("api", "extra", "extra2", "extra3", "extra4", "compat",
                "tail", "fft", "linalg"):
        tree = ast.parse((root / f"{mod}.py").read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("get", "cpu", "numpy",
                                               "tolist")
                        and not node.args):
                    found.add(f"{mod}.{fn.name}")
    assert found == HOST_STEPS, sorted(found ^ HOST_STEPS)
