"""BlockArray: a grid-partitioned array held in one torch tensor.

Counterpart of ``nums_tpu/core/array/blockarray.py`` for the GLM layer:
construction, elementwise and comparison operators, ``astype``, ``T`` as
metadata, ``sum``/``mean``/``var``/``std``/``min``/``max``/``clip``, basic
indexing and
the row gather, ``reshape``, ``get``/``touch`` and ``tensordot``. A
BlockArray is ONE ``torch.Tensor`` on the backend's device plus
``ArrayGrid`` metadata; ops run eagerly (the reference's lazy batching,
``core/lazy.py``, has no counterpart here).

``x.T @ x`` on float32 goes to the gram kernel (``ops/cuda_gram.py``) in
the bf16-MAC precision class, as the reference's ``_pallas_gram_fast``
goes to its Pallas kernel.
"""

import numpy as np
import torch

from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import (
    cuda_gram, elementwise, linear, reductions, shape_ops,
)


def _normalize_shape(shape_args):
    if len(shape_args) == 1 and isinstance(shape_args[0], (tuple, list)):
        return tuple(int(s) for s in shape_args[0])
    return tuple(int(s) for s in shape_args)


def _norm_axis(axis):
    if axis is None or isinstance(axis, int):
        return axis
    return tuple(int(a) for a in axis)


def compute_shape(size: int, shape) -> tuple:
    """Resolve a reshape spec with at most one -1."""
    shape = tuple(shape)
    unknown = [i for i, s in enumerate(shape) if s == -1]
    if not unknown:
        if int(np.prod(shape)) != size:
            raise ValueError(f"cannot reshape array of size {size} into {shape}")
        return shape
    if len(unknown) > 1:
        raise ValueError("can only specify one unknown dimension")
    known = int(np.prod([s for s in shape if s != -1]))
    if known == 0 or size % known != 0:
        raise ValueError(f"cannot reshape array of size {size} into {shape}")
    return tuple(size // known if s == -1 else s for s in shape)


class BlockArray:
    # Defer all numpy-operator dispatch to our reflected operators.
    __array_ufunc__ = None
    __array_priority__ = 100.0

    def __init__(self, data, grid: ArrayGrid, backend, transposed=False):
        # ``transposed`` marks a lazy logical transpose: ``grid`` describes
        # the logical (transposed) shape while ``data`` holds the original
        # tensor, which consumers read through a transposed view.
        raw_logical = (
            tuple(reversed(grid.shape)) if transposed else tuple(grid.shape)
        )
        if tuple(data.shape) != raw_logical:
            raise ValueError(
                f"tensor shape {tuple(data.shape)} does not match grid "
                f"{grid.shape} (transposed={transposed})"
            )
        name = array_utils.to_dtype_name(data.dtype)
        if name != grid.dtype:
            grid = ArrayGrid(grid.shape, grid.block_shape, name)
        self._data = data
        self._transposed = transposed
        self.grid = grid
        self.backend = backend

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_np(cls, arr, block_shape=None, copy=False, backend=None):
        del copy  # device_put always copies
        arr = np.asarray(arr)
        block_shape = (
            tuple(block_shape) if block_shape is not None else arr.shape
        )
        grid = ArrayGrid(arr.shape, block_shape, arr.dtype.name)
        return cls(backend.device_put(arr, grid), grid, backend)

    @classmethod
    def from_scalar(cls, value, backend):
        arr = np.array(value)
        assert arr.ndim == 0
        return cls.from_np(arr, block_shape=(), backend=backend)

    @classmethod
    def from_torch(cls, data, block_shape=None, backend=None):
        block_shape = (
            tuple(block_shape) if block_shape is not None
            else tuple(data.shape)
        )
        grid = ArrayGrid(
            tuple(data.shape), block_shape,
            array_utils.to_dtype_name(data.dtype),
        )
        return cls(data, grid, backend)

    def _new(self, data, block_shape=None):
        """Wrap a derived tensor, deriving block metadata from self."""
        shape = tuple(data.shape)
        if block_shape is None:
            block_shape = array_utils.default_block_shape_for(
                shape, self.block_shape
            )
        grid = ArrayGrid(shape, block_shape,
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend)

    def _store(self, data, transposed=False):
        """Rebind the tensor in place (an in-place op of the array API:
        ``shuffle``); the grid stays."""
        raw_logical = (
            tuple(reversed(self.grid.shape)) if transposed
            else tuple(self.grid.shape)
        )
        assert tuple(data.shape) == raw_logical, (data.shape, raw_logical)
        assert data.dtype == self._data.dtype, (data.dtype, self._data.dtype)
        self._data = data
        self._transposed = transposed

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------

    @property
    def data(self):
        """The tensor in logical layout (a transposed view when lazily
        transposed; torch views cost no copy)."""
        return linear.maybe_t(self._data, self._transposed)

    @property
    def raw(self):
        """Underlying tensor, possibly in transposed layout."""
        return self._data

    @property
    def is_transposed(self):
        return self._transposed

    @property
    def shape(self):
        return self.grid.shape

    @property
    def block_shape(self):
        return self.grid.block_shape

    @property
    def grid_shape(self):
        return self.grid.grid_shape

    @property
    def dtype(self):
        return np.dtype(self.grid.dtype)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self):
        return self.dtype.itemsize * self.size

    @property
    def T(self):
        return self.transpose()

    def _default_float(self):
        return array_utils.to_torch_dtype(self.backend.default_float)

    # ------------------------------------------------------------------
    # Materialization
    # ------------------------------------------------------------------

    def get(self) -> np.ndarray:
        arr = self.backend.get(self._data)
        return arr.transpose() if self._transposed else arr

    def touch(self):
        """Block until the tensor's pending work is done (the reference's
        ``block_until_ready``)."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def astype(self, dtype):
        data = self._data.to(array_utils.to_torch_dtype(dtype))
        grid = ArrayGrid(self.shape, self.block_shape,
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def transpose(self):
        """Zero-copy lazy transpose (reversed axes)."""
        if self.ndim <= 1:
            return self
        shape = tuple(reversed(self.shape))
        block_shape = tuple(reversed(self.block_shape))
        grid = ArrayGrid(shape, block_shape, self.grid.dtype)
        return BlockArray(self._data, grid, self.backend,
                          transposed=not self._transposed)

    def reshape(self, *shape, **kwargs):
        block_shape = kwargs.pop("block_shape", None)
        assert not kwargs, f"unexpected kwargs {kwargs}"
        if shape:
            new_shape = compute_shape(self.size, _normalize_shape(shape))
        else:
            new_shape = self.shape
        if new_shape == self.shape and block_shape is None:
            return self
        data = self.data.reshape(new_shape)
        if block_shape is None:
            block_shape = array_utils.default_block_shape_for(new_shape)
        grid = ArrayGrid(new_shape, tuple(block_shape),
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend)

    # ------------------------------------------------------------------
    # Elementwise / reductions
    # ------------------------------------------------------------------

    def ufunc(self, op_name):
        # Elementwise ops commute with the lazy transpose.
        data = elementwise.uop(op_name, self._data)
        grid = ArrayGrid(self.shape, self.block_shape,
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def reduce_axis(self, op_name, axis, keepdims=False, dtype=None):
        axis = _norm_axis(axis)
        dt = None if dtype is None else array_utils.to_torch_dtype(dtype)
        data = reductions.reduce(op_name, self.data, axis, bool(keepdims),
                                 dt)
        bs = array_utils.reduced_block_shape(self.block_shape, axis,
                                             keepdims)
        return self._new(data, bs)

    def sum(self, axis=None, keepdims=False, dtype=None):
        return self.reduce_axis("sum", axis, keepdims, dtype)

    def mean(self, axis=None, keepdims=False, dtype=None):
        return self.reduce_axis("mean", axis, keepdims, dtype)

    def min(self, axis=None, keepdims=False):
        return self.reduce_axis("min", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self.reduce_axis("max", axis, keepdims)

    def _arg_op(self, op_name, axis):
        data = reductions.arg_op(op_name, self.data, axis)
        return self._new(data, array_utils.reduced_block_shape(
            self.block_shape, axis, False))

    def argmin(self, axis=None):
        return self._arg_op("argmin", axis)

    def argmax(self, axis=None):
        return self._arg_op("argmax", axis)

    def _moment(self, op_name, axis, ddof, keepdims, dtype):
        axis = _norm_axis(axis)
        dt = None if dtype is None else array_utils.to_torch_dtype(dtype)
        data = reductions.moment(op_name, self.data, axis, int(ddof),
                                 bool(keepdims), dt)
        bs = array_utils.reduced_block_shape(self.block_shape, axis,
                                             keepdims)
        return self._new(data, bs)

    def var(self, axis=None, ddof=0, keepdims=False, dtype=None):
        return self._moment("var", axis, ddof, keepdims, dtype)

    def std(self, axis=None, ddof=0, keepdims=False, dtype=None):
        return self._moment("std", axis, ddof, keepdims, dtype)

    def clip(self, a_min=None, a_max=None):
        data = torch.clamp(self.data, a_min, a_max)
        return self._new(data, self.block_shape)

    # ------------------------------------------------------------------
    # Binary ops
    # ------------------------------------------------------------------

    def check_or_convert_other(self, other):
        """Python scalars stay raw (weak typing); arrays become
        BlockArrays on this backend."""
        if isinstance(other, BlockArray):
            return other
        if array_utils.is_scalar_like(other):
            return other
        if isinstance(other, (np.ndarray, list, tuple)):
            return BlockArray.from_np(np.asarray(other), backend=self.backend)
        if torch.is_tensor(other):
            return BlockArray.from_torch(other, backend=self.backend)
        raise ValueError(f"Cannot operate on {type(other)}")

    def _bop(self, op_name, other, reverse=False):
        other = self.check_or_convert_other(other)
        if isinstance(other, BlockArray):
            o_data, o_shape, o_bs = other.data, other.shape, other.block_shape
        else:
            o_data, o_shape, o_bs = other, (), ()
        a, b = (o_data, self.data) if reverse else (self.data, o_data)
        data = elementwise.bop(op_name, a, b, self._default_float())
        bs = array_utils.broadcast_block_shape(
            tuple(data.shape), self.shape, self.block_shape, o_shape, o_bs
        )
        return self._new(data, bs)

    def __add__(self, other):
        return self._bop("add", other)

    def __radd__(self, other):
        return self._bop("add", other, reverse=True)

    def __sub__(self, other):
        return self._bop("subtract", other)

    def __rsub__(self, other):
        return self._bop("subtract", other, reverse=True)

    def __mul__(self, other):
        return self._bop("multiply", other)

    def __rmul__(self, other):
        return self._bop("multiply", other, reverse=True)

    def __truediv__(self, other):
        return self._bop("true_divide", other)

    def __rtruediv__(self, other):
        return self._bop("true_divide", other, reverse=True)

    def __pow__(self, other):
        return self._bop("power", other)

    def __rpow__(self, other):
        return self._bop("power", other, reverse=True)

    # In-place aliases are functional, as in the reference.
    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__

    def _const_bool(self, value: bool):
        """Full-shape bool constant: NumPy's result for equality against
        an incomparable operand like None."""
        data = torch.full(tuple(self.shape), value, dtype=torch.bool,
                          device=self._data.device)
        return self._new(data, self.block_shape)

    def __eq__(self, other):
        if other is None:  # np.ndarray == None -> elementwise False
            return self._const_bool(False)
        return self._bop("equal", other)

    def __ne__(self, other):
        if other is None:  # np.ndarray != None -> elementwise True
            return self._const_bool(True)
        return self._bop("not_equal", other)

    def __lt__(self, other):
        return self._bop("less", other)

    def __le__(self, other):
        return self._bop("less_equal", other)

    def __gt__(self, other):
        return self._bop("greater", other)

    def __ge__(self, other):
        return self._bop("greater_equal", other)

    __hash__ = None

    def __and__(self, other):
        return self._bop("bitwise_and", other)

    def __or__(self, other):
        return self._bop("bitwise_or", other)

    def __neg__(self):
        return self.ufunc("negative")

    def __pos__(self):
        return self.ufunc("positive")

    def __abs__(self):
        return self.ufunc("abs")

    def __invert__(self):
        return self.ufunc("invert")

    # ------------------------------------------------------------------
    # Contractions
    # ------------------------------------------------------------------

    def tensordot(self, other, axes=2):
        other = self.check_or_convert_other(other)
        if not isinstance(other, BlockArray):
            other = BlockArray.from_scalar(other, self.backend)
        if isinstance(axes, int):
            static_axes = int(axes)
        else:
            static_axes = tuple(tuple(a) for a in axes)
        if other._data is self._data:
            fast = self._gram_fast(other, static_axes)
            if fast is not None:
                return fast
        data = linear.tensordot(self.data, other.data, static_axes)
        if isinstance(static_axes, int):
            bs = array_utils.tensordot_block_shape(
                self.block_shape, other.block_shape, static_axes
            )
        else:
            bs = array_utils.default_block_shape_for(tuple(data.shape))
        return self._new(data, bs)

    def _gram_fast(self, other, static_axes):
        """x.T @ x through the symmetric gram kernel, or None.

        Routes on the pattern (same tensor, one contracted axis, left
        operand lazily transposed), the dtype and the precision setting
        alone (the reference also needs a lane-padded buffer,
        blockarray.py:749-780; nothing here needs one)."""
        if (
            static_axes != 1
            or self.ndim != 2
            or not self._transposed
            or other._transposed
            or not cuda_gram.enabled()
            or not cuda_gram.supported(tuple(self._data.shape),
                                       self._data.dtype)
        ):
            return None
        data = cuda_gram.gram(self._data)
        bs = array_utils.tensordot_block_shape(
            self.block_shape, other.block_shape, 1
        )
        return self._new(data, bs)

    def __matmul__(self, other):
        return self.tensordot(other, axes=1)

    def __rmatmul__(self, other):
        other = self.check_or_convert_other(other)
        if not isinstance(other, BlockArray):
            raise ValueError("matmul requires array operands")
        return other.__matmul__(self)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------

    def _row_index(self, item):
        """The index tensor of a row gather ``x[idx]`` (a 1-D integer numpy
        array or BlockArray), or None for any other subscript."""
        if isinstance(item, np.ndarray):
            if item.ndim != 1 or item.dtype.kind not in "iu":
                return None
            n = self.shape[0]
            if item.size and (item.max() >= n or item.min() < -n):
                raise IndexError(f"row index out of bounds for axis 0 of "
                                 f"size {n}")
            return torch.from_numpy(item.astype(np.int64))
        if (isinstance(item, BlockArray) and item.ndim == 1
                and item.dtype.kind in "iu"):
            return item.data
        return None

    def __getitem__(self, item):
        """Basic indexing (integers, slices with a positive step, None and
        Ellipsis) and the row gather ``x[idx]`` by a 1-D integer array.
        Boolean masks and the other advanced forms are a later port."""
        if self.ndim >= 1:
            rows = self._row_index(item)
            if rows is not None:
                return self._new(shape_ops.take_rows(self.data, rows))
        key = item if isinstance(item, tuple) else (item,)
        for k in key:
            if not (
                isinstance(k, (int, np.integer, type(None), type(Ellipsis)))
                or (isinstance(k, slice) and (k.step or 1) > 0)
            ):
                raise NotImplementedError(
                    f"index {k!r}: only basic indexing is ported"
                )
        return self._new(self.data[key])

    # ------------------------------------------------------------------
    # Scalar conversions
    # ------------------------------------------------------------------

    def _scalar_value(self):
        if self.size != 1:
            raise ValueError(
                "The truth value of an array with more than one element is "
                "ambiguous."
            )
        return self.get().reshape(())[()]

    def __bool__(self):
        # Size-1 bool arrays evaluate their value; everything else is
        # truthy (so ``if beta:`` on a parameter vector means "present").
        if self.dtype == np.bool_ and all(s == 1 for s in self.shape):
            return bool(self._scalar_value())
        return True

    def __float__(self):
        return float(self._scalar_value())

    def __int__(self):
        return int(self._scalar_value())

    def item(self):
        return self._scalar_value()

    def __array__(self, dtype=None, copy=None):
        del copy
        out = self.get()
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"BlockArray({self.get()})"

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]
