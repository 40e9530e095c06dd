"""NumPy-compatible public API.

Counterpart of ``nums_tpu/numpy/api.py``, name for name: constants and
dtypes, creation, manipulation, reductions, tensordot/matmul, where,
allclose, and the 47 unary and 39 binary ufuncs, emitted at import by
``_register_ufuncs`` over the application's ``map_uop``/``map_bop``. Every
function delegates to the application singleton, with the reference's
argument guards (``NotImplementedError`` for ``order != "K"``, ``out=``,
``where=`` and the like).
"""

import numpy as np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray

############################################
# Constants & dtypes 
############################################

pi = np.pi
e = np.e
euler_gamma = np.euler_gamma
inf = infty = Inf = Infinity = PINF = np.inf
NINF = -np.inf
nan = NAN = NaN = np.nan
newaxis = None

bool_ = np.bool_
uint = np.uint
uint8 = np.uint8
uint16 = np.uint16
uint32 = np.uint32
uint64 = np.uint64
int8 = np.int8
int16 = np.int16
int32 = np.int32
int64 = np.int64
float16 = np.float16
float32 = np.float32
float64 = np.float64
complex64 = np.complex64
complex128 = np.complex128


def _not_implemented(fun):
    """A numpy name the port does not implement: calling it raises."""

    def wrapped(*args, **kwargs):
        raise NotImplementedError(
            f"nums_tpu_torch does not yet implement numpy.{fun.__name__}. "
        )

    wrapped.__name__ = getattr(fun, "__name__", str(fun))
    wrapped._nums_tpu_stub = True
    return wrapped


def _to_ba(obj) -> BlockArray:
    app = _instance()
    if isinstance(obj, BlockArray):
        return obj
    if isinstance(obj, (bool, int, float, complex, np.generic)):
        return app.scalar(obj)
    return app.array(np.asarray(obj), block_shape=None)


############################################
# Creation & I/O 
############################################


def loadtxt(
    fname, dtype=float, comments="# ", delimiter=" ", converters=None,
    skiprows=0, usecols=None, unpack=False, ndmin=0, encoding="bytes",
    max_rows=None,
) -> BlockArray:
    return _instance().loadtxt(
        fname, dtype=dtype, comments=comments, delimiter=delimiter,
        converters=converters, skiprows=skiprows, usecols=usecols,
        unpack=unpack, ndmin=ndmin, encoding=encoding, max_rows=max_rows,
    )


def array(
    object, dtype=None, copy=True, order="K", ndmin=0, subok=False
) -> BlockArray:
    if order is not None and order != "K":
        raise NotImplementedError("Only order='K' is supported.")
    if ndmin != 0:
        raise NotImplementedError("Only ndmin=0 is currently supported.")
    if subok:
        raise ValueError("subok must be False.")
    if isinstance(object, BlockArray):
        if copy:
            object = object.copy()
        if dtype is not None and np.dtype(dtype) != object.dtype:
            object = object.astype(dtype)
        return object
    result = np.array(object, dtype=dtype, copy=copy, order=order)
    dtype = np.bool_ if result.dtype == np.bool_ else result.dtype
    app = _instance()
    block_shape = app.get_block_shape(result.shape, dtype)
    return app.array(result.astype(dtype), block_shape)


def empty(shape, dtype=float):
    app = _instance()
    if isinstance(shape, int):
        shape = (shape,)
    block_shape = app.get_block_shape(shape, dtype)
    return app.empty(shape=shape, block_shape=block_shape, dtype=dtype)


def zeros(shape, dtype=float):
    app = _instance()
    if isinstance(shape, int):
        shape = (shape,)
    block_shape = app.get_block_shape(shape, dtype)
    return app.zeros(shape=shape, block_shape=block_shape, dtype=dtype)


def ones(shape, dtype=float):
    app = _instance()
    if isinstance(shape, int):
        shape = (shape,)
    block_shape = app.get_block_shape(shape, dtype)
    return app.ones(shape=shape, block_shape=block_shape, dtype=dtype)


def _like(fn, prototype, dtype, shape):
    if shape is None:
        shape = prototype.shape
    if dtype is None:
        dtype = prototype.dtype
    return fn(shape, dtype)


def empty_like(prototype: BlockArray, dtype=None, order="K", shape=None):
    if order is not None and order != "K":
        raise NotImplementedError("Only order='K' is supported.")
    return _like(empty, prototype, dtype, shape)


def zeros_like(prototype, dtype=None, order="K", shape=None):
    if order is not None and order != "K":
        raise NotImplementedError("Only order='K' is supported.")
    return _like(zeros, prototype, dtype, shape)


def ones_like(prototype, dtype=None, order="K", shape=None):
    if order is not None and order != "K":
        raise NotImplementedError("Only order='K' is supported.")
    return _like(ones, prototype, dtype, shape)


def full(shape, fill_value, dtype=None):
    app = _instance()
    if isinstance(shape, int):
        shape = (shape,)
    if dtype is None:
        dtype = np.asarray(fill_value).dtype
    block_shape = app.get_block_shape(shape, dtype)
    return app.full(shape, block_shape, fill_value, dtype)


def concatenate(arrays, axis=0, out=None):
    if out is not None:
        raise NotImplementedError("out is currently not supported.")
    return _instance().concatenate([_to_ba(a) for a in arrays], axis=axis)


def split(ary: BlockArray, indices_or_sections, axis=0):
    return _instance().split(ary, indices_or_sections, axis=axis)


def identity(n: int, dtype=float) -> BlockArray:
    return eye(n, n, dtype=dtype)


def eye(N, M=None, k=0, dtype=float):
    app = _instance()
    if M is None:
        M = N
    shape = (N, M)
    block_shape = app.get_block_shape(shape, dtype)
    return app.eye_k(shape, block_shape, k=k, dtype=dtype)


def diag(v: BlockArray, k=0) -> BlockArray:
    if k != 0:
        raise NotImplementedError("Only k==0 is currently supported.")
    return _instance().diag(v)


def arange(start=None, stop=None, step=1, dtype=None) -> BlockArray:
    if stop is None:
        stop = start
        start = 0
    if step != 1:
        raise NotImplementedError("Only step size of 1 is currently supported.")
    if dtype is None:
        dtype = np.__getattribute__(str(np.result_type(start, stop)))
    shape = (int(np.ceil(stop - start)),)
    app = _instance()
    block_shape = app.get_block_shape(shape, dtype)
    arr = app.arange(shape, block_shape, step=step, dtype=np.int64)
    if start != 0:
        arr = arr + start
    if np.dtype(dtype) != arr.dtype:
        arr = arr.astype(dtype)
    return arr


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0):
    app = _instance()
    shape = (num,)
    block_shape = app.get_block_shape(shape, np.float64)
    return app.linspace(start, stop, shape, block_shape, endpoint, retstep,
                        dtype, axis)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0):
    ba: BlockArray = linspace(start, stop, num, endpoint, dtype=None,
                              axis=axis)
    ba = power(_instance().scalar(base), ba)
    if dtype is not None and np.dtype(dtype) != ba.dtype:
        ba = ba.astype(dtype)
    return ba


############################################
# Contractions & manipulation 
############################################


def asarray(a, dtype=None):
    return array(a, dtype=dtype, copy=False)


def shape(a):
    return _to_ba(a).shape


def size(a):
    return _to_ba(a).size


def isscalar(element):
    return np.isscalar(element)


# Metadata-only dtype helpers: numpy's own (no device work).
result_type = np.result_type
can_cast = np.can_cast
promote_types = np.promote_types
dtype = np.dtype


def tensordot(x1, x2, axes=2) -> BlockArray:
    return _instance().tensordot(_to_ba(x1), _to_ba(x2), axes)


def matmul(x1, x2) -> BlockArray:
    return _instance().matmul(_to_ba(x1), _to_ba(x2))


def ndim(x):
    return _to_ba(x).ndim


def reshape(x: BlockArray, shape):
    from nums_tpu_torch.core.array import blockarray as _blockarray

    # Resolve any -1 before the block-shape policy sees the spec: an
    # unresolved -1 would flow into ArrayGrid as a negative block dim.
    shape = _blockarray.compute_shape(x.size, shape)
    block_shape = _instance().compute_block_shape(shape, x.dtype)
    return x.reshape(shape, block_shape=block_shape)


def expand_dims(x: BlockArray, axis):
    return x.expand_dims(axis)


def squeeze(x: BlockArray):
    return x.squeeze()


def transpose(x: BlockArray, axes=None):
    if axes is not None:
        raise NotImplementedError("The axes argument is not currently supported.")
    return x.transpose()


def copy(a: BlockArray):
    return a.copy()


############################################
# Reductions 
############################################


def min(a: BlockArray, axis=None, out=None, keepdims=False, initial=None,
        where=None) -> BlockArray:
    if out is not None or initial is not None or where is not None:
        raise NotImplementedError(
            "'out', 'initial', and 'where' are not supported."
        )
    return _instance().min(_to_ba(a), axis=axis, keepdims=keepdims)


amin = min


def max(a: BlockArray, axis=None, out=None, keepdims=False, initial=None,
        where=None) -> BlockArray:
    if out is not None or initial is not None or where is not None:
        raise NotImplementedError(
            "'out', 'initial', and 'where' are not supported."
        )
    return _instance().max(_to_ba(a), axis=axis, keepdims=keepdims)


amax = max


def argmin(a: BlockArray, axis=None, out=None):
    if out is not None:
        raise NotImplementedError("'out' is not supported.")
    return _instance().argop("argmin", _to_ba(a), axis=axis)


def argmax(a, axis=None, out=None):
    if out is not None:
        raise NotImplementedError("'out' is not supported.")
    return _instance().argop("argmax", _to_ba(a), axis=axis)


def sum(a: BlockArray, axis=None, dtype=None, out=None, keepdims=False,
        initial=None, where=None) -> BlockArray:
    if out is not None or initial is not None or where is not None:
        raise NotImplementedError(
            "'out', 'initial', and 'where' are not supported."
        )
    return _instance().sum(_to_ba(a), axis=axis, dtype=dtype,
                           keepdims=keepdims)


def mean(a: BlockArray, axis=None, dtype=None, out=None, keepdims=False):
    if out is not None:
        raise NotImplementedError("'out' is not supported.")
    return _instance().mean(_to_ba(a), axis=axis, dtype=dtype,
                            keepdims=keepdims)


def var(a: BlockArray, axis=None, dtype=None, out=None, ddof=0,
        keepdims=False):
    if out is not None:
        raise NotImplementedError("'out' is not supported.")
    return _instance().var(_to_ba(a), axis=axis, ddof=ddof, dtype=dtype,
                           keepdims=keepdims)


def std(a: BlockArray, axis=None, dtype=None, out=None, ddof=0,
        keepdims=False):
    if out is not None:
        raise NotImplementedError("'out' is not supported.")
    return _instance().std(_to_ba(a), axis=axis, ddof=ddof, dtype=dtype,
                           keepdims=keepdims)


def where(condition, x=None, y=None):
    return _instance().where(_to_ba(condition), x, y)


def allclose(a, b, rtol=1.0e-5, atol=1.0e-8, equal_nan=False) -> BlockArray:
    if equal_nan is not False:
        raise NotImplementedError("equal_nan is not supported.")
    return _instance().allclose(_to_ba(a), _to_ba(b), rtol, atol)


############################################
# Generated ufunc surface 
############################################

# 47 unary ops.
UOP_NAMES = [
    "abs", "absolute", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
    "arctanh", "bitwise_not", "cbrt", "ceil", "conj", "conjugate", "cos",
    "cosh", "deg2rad", "degrees", "exp", "exp2", "expm1", "fabs", "floor",
    "invert", "isfinite", "isinf", "isnan", "log", "log10", "log1p", "log2",
    "logical_not", "negative", "positive", "rad2deg", "radians",
    "reciprocal", "rint", "sign", "signbit", "sin", "sinh", "spacing",
    "sqrt", "square", "tan", "tanh", "trunc",
]

# 39 binary ops.
BOP_NAMES = [
    "add", "arctan2", "bitwise_and", "bitwise_or", "bitwise_xor",
    "copysign", "divide", "equal", "float_power", "floor_divide", "fmax",
    "fmin", "fmod", "gcd", "greater", "greater_equal", "heaviside",
    "hypot", "lcm", "ldexp", "left_shift", "less", "less_equal",
    "logaddexp", "logaddexp2", "logical_and", "logical_or", "logical_xor",
    "maximum", "minimum", "mod", "multiply", "nextafter", "not_equal",
    "power", "remainder", "right_shift", "subtract", "true_divide",
]


def _make_uop(name):
    def uop_fn(x, out=None, where=True, **kwargs):
        return _instance().map_uop(name, _to_ba(x), out=out, where=where,
                                   kwargs=kwargs)

    uop_fn.__name__ = name
    uop_fn.__doc__ = f"Elementwise {name}."
    return uop_fn


def _make_bop(name):
    def bop_fn(x1, x2, out=None, where=True, **kwargs):
        app = _instance()
        a1 = x1 if isinstance(x1, BlockArray) else _to_ba(x1)
        return app.map_bop(name, a1, x2, out=out, where=where, kwargs=kwargs)

    bop_fn.__name__ = name
    bop_fn.__doc__ = f"Elementwise {name}."
    return bop_fn


def _register_ufuncs(namespace):
    from nums_tpu_torch.core.ops import elementwise as _ew

    for _name in UOP_NAMES:
        try:
            _ew.resolve_ufunc(_name)
            namespace[_name] = _make_uop(_name)
        except NotImplementedError:
            namespace[_name] = _not_implemented(getattr(np, _name, _name))
    for _name in BOP_NAMES:
        try:
            _ew.resolve_ufunc(_name)
            namespace[_name] = _make_bop(_name)
        except NotImplementedError:
            namespace[_name] = _not_implemented(getattr(np, _name, _name))


_register_ufuncs(globals())
