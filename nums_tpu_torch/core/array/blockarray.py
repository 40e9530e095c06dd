"""BlockArray: a grid-partitioned array held in one torch tensor.

Counterpart of ``nums_tpu/core/array/blockarray.py``: construction, the
operators, ``astype``/``copy``, the lazy transpose and ``transpose(*axes)``,
``reshape``/``broadcast_to``/``expand_dims``/``squeeze``, the reductions,
``tensordot``/``matmul``, NumPy indexing and assignment, and the ndarray
methods, which delegate to the facade (``nums_tpu_torch.numpy.extra``) as
the reference's do. A BlockArray is ONE ``torch.Tensor`` on the backend's
device plus ``ArrayGrid`` metadata; ops run eagerly (the reference's lazy
batching, ``core/lazy.py``, has no counterpart here), and none of them
writes into a tensor that another array may hold: an assignment builds a
new tensor and rebinds it, as the reference's ``_store`` does.

``x.T @ x`` on float32 goes to the gram kernel (``ops/cuda_gram.py``) in
the bf16-MAC precision class, as the reference's ``_pallas_gram_fast``
goes to its Pallas kernel. On the mesh backend the tensor is a DTensor,
placed by the grid when the BlockArray takes it (``MeshBackend.place``),
and most ops are DTensor's own; ``x.T @ x`` runs the kernel on each
process's rows and one all-reduce, and ``settings.collective_matmul``
sends 2-D products through the hand-scheduled schedules of
``ops/summa.py``. A boolean mask, a host index array, a key of ints and
slices of a sharded array, a reshape of one, and an assignment through
any of them take the mesh's own branch (``ops/mesh_ops.py``: each
process's rows, moved by one all-to-all). An op that DTensor has no
sharding strategy for raises ``NotImplementedError`` naming it.
"""

import numpy as np
import torch

from nums_tpu_torch.core import trace
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.ops import (
    cuda_gram, elementwise, linear, masking, reductions, shape_ops, summa,
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
        if backend is not None and tuple(data.shape) == raw_logical:
            # On the mesh: a DTensor redistributed to the grid's placement,
            # a plain tensor (the whole value) cut to this process's region.
            data = backend.place(data, grid, transposed)
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
        if self.backend is not None:
            data = self.backend.place(data, self.grid, transposed)
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

    def copy(self):
        return BlockArray(elementwise.touch(self._data), self.grid.copy(),
                          self.backend, transposed=self._transposed)

    def is_single_block(self):
        return self.grid.num_blocks == 1

    # ------------------------------------------------------------------
    # Structure ops
    # ------------------------------------------------------------------

    def astype(self, dtype):
        data = elementwise.astype(self._data,
                                  array_utils.to_torch_dtype(dtype))
        grid = ArrayGrid(self.shape, self.block_shape,
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def transpose(self, *axes):
        """The reversed axes as a zero-copy lazy transpose; any other
        permutation as a permuted view."""
        if axes and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        perm = (tuple(int(a) % self.ndim for a in axes) if axes
                else tuple(reversed(range(self.ndim))))
        block_shape = tuple(self.block_shape[p] for p in perm)
        if perm == tuple(reversed(range(self.ndim))):
            if self.ndim <= 1:
                return self
            shape = tuple(self.shape[p] for p in perm)
            grid = ArrayGrid(shape, block_shape, self.grid.dtype)
            return BlockArray(self._data, grid, self.backend,
                              transposed=not self._transposed)
        return self._new(self.data.permute(*perm), block_shape)

    def reshape(self, *shape, **kwargs):
        block_shape = kwargs.pop("block_shape", None)
        assert not kwargs, f"unexpected kwargs {kwargs}"
        if shape:
            new_shape = compute_shape(self.size, _normalize_shape(shape))
        else:
            new_shape = self.shape
        if new_shape == self.shape and block_shape is None:
            return self
        if block_shape is None:
            block_shape = self.mesh_block(new_shape)
            if not self.keeps_blocks(new_shape, block_shape):
                block_shape = array_utils.default_block_shape_for(new_shape)
        grid = ArrayGrid(new_shape, tuple(block_shape), self.grid.dtype)
        return BlockArray(self._reshaped(grid), grid, self.backend)

    def keeps_blocks(self, shape, block_shape):
        """Whether a result of ``shape`` that holds this array's elements
        rearranged (a slice, a reshape) takes ``block_shape``, this array's
        block counts carried over, rather than the serial rule's blocks:
        on the mesh, where this array is sharded and that layout gives
        every process a block of its own along each axis it shards.
        Otherwise the serial rule lays the result out, as the reference
        does (a row, a model's coefficients, a replicated array's
        slice)."""
        from nums_tpu_torch.core.ops import mesh_ops

        if not (mesh_ops.is_dtensor(self.data)
                and any(p.is_shard() for p in self.data.placements)):
            return False
        grid = ArrayGrid(shape, block_shape, self.grid.dtype).grid_shape
        want = self.backend.sharding_for_shape(shape, grid)
        mesh = self.backend.device_grid.mesh_shape
        axes = {p.dim for p in want if p.is_shard()}
        return bool(axes) and all(grid[k] >= int(np.prod(
            [mesh[m] for m in mesh_ops.shard_dims(want, (k,))]))
            for k in axes)

    def mesh_block(self, shape):
        """The blocks of a result of ``shape`` that holds this array's
        elements in a new arrangement (a reshape, a flattening) on the
        mesh (``keeps_blocks``): as many
        blocks along each leading axis as this array has there (a 1-D
        result: as many as it has in all), so that a sharded array's
        result is sharded too, where the serial rule (one block) would lay
        it whole on every process."""
        shape = tuple(int(s) for s in shape)
        if len(shape) == 1:
            counts = (int(np.prod(self.grid_shape)),)
        else:
            counts = tuple(self.grid_shape[:len(shape)])
        return tuple(max(1, -(-s // c)) for s, c in zip(shape, counts)) \
            + shape[len(counts):]

    def _reshaped(self, grid):
        """The tensor in ``grid``'s shape. On the mesh, a reshape that
        keeps axis 0 of an array sharded on axis 0 alone, into the same
        layout, reshapes each process's rows in place; any other moves
        each process's run of the flat order to its place
        (``mesh_ops.flat_move``: never a whole copy)."""
        from nums_tpu_torch.core.ops import mesh_ops

        data, new_shape = self.data, grid.shape
        if self.backend.mesh is None:
            return shape_ops.reshape(data, new_shape)
        want = self.backend.sharding_for_grid(grid)
        if (new_shape[:1] == self.shape[:1] and self.ndim >= 1
                and tuple(data.placements) == tuple(want)
                and all(not p.is_shard() or p.dim == 0
                        for p in data.placements)):
            local = shape_ops.reshape(
                data.to_local(), (-1,) + tuple(new_shape[1:]))
            return self.backend.from_local(local, new_shape, data.placements)
        return mesh_ops.flat_move(self.backend, data, new_shape, want)

    def broadcast_to(self, shape):
        return self._new(shape_ops.broadcast_to(self.data, tuple(shape)))

    def expand_dims(self, axis):
        return self._new(shape_ops.expand_dims(self.data, axis))

    def squeeze(self):
        data = shape_ops.squeeze(self.data)
        bs = tuple(b for b, s in zip(self.block_shape, self.shape) if s != 1)
        return self._new(data, bs)

    # ------------------------------------------------------------------
    # Elementwise / reductions
    # ------------------------------------------------------------------

    def ufunc(self, op_name):
        # Elementwise ops commute with the lazy transpose.
        trace.log_op(op_name, self)
        data = elementwise.uop(op_name, self._data, self._default_float())
        grid = ArrayGrid(self.shape, self.block_shape,
                         array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

    def reduce_axis(self, op_name, axis, keepdims=False, dtype=None):
        trace.log_op(op_name, self)
        axis = _norm_axis(axis)
        dt = None if dtype is None else array_utils.to_torch_dtype(dtype)
        x = self.data
        if self.backend.mesh is not None and op_name in ("min", "max"):
            x = self.backend.without_empty_shards(x)
        data = reductions.reduce(op_name, x, axis, bool(keepdims), dt)
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

    def prod(self, axis=None, keepdims=False):
        return self.reduce_axis("prod", axis, keepdims)

    def _arg_op(self, op_name, axis):
        data = reductions.arg_op(op_name, self.data, axis)
        return self._new(data, array_utils.reduced_block_shape(
            self.block_shape, axis, False))

    def argmin(self, axis=None):
        return self._arg_op("argmin", axis)

    def argmax(self, axis=None):
        return self._arg_op("argmax", axis)

    def _moment(self, op_name, axis, ddof, keepdims, dtype):
        trace.log_op(op_name, self)
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

    # ------------------------------------------------------------------
    # Binary ops
    # ------------------------------------------------------------------

    def check_or_convert_other(self, other, compute_block_shape=False):
        """Python scalars stay raw (weak typing); arrays become
        BlockArrays on this backend."""
        del compute_block_shape
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
        trace.log_op(op_name, self, other)
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

    def __floordiv__(self, other):
        return self._bop("floor_divide", other)

    def __rfloordiv__(self, other):
        return self._bop("floor_divide", other, reverse=True)

    def __mod__(self, other):
        return self._bop("mod", other)

    def __rmod__(self, other):
        return self._bop("mod", other, reverse=True)

    def __pow__(self, other):
        return self._bop("power", other)

    def __rpow__(self, other):
        return self._bop("power", other, reverse=True)

    # In-place aliases are functional, as in the reference.
    __iadd__ = __add__
    __isub__ = __sub__
    __imul__ = __mul__
    __itruediv__ = __truediv__
    __ipow__ = __pow__

    def _const_bool(self, value: bool):
        """Full-shape bool constant: NumPy's result for equality against
        an incomparable operand like None."""
        data = elementwise.const_bool(self._data, value)
        grid = ArrayGrid(self.shape, self.block_shape, "bool")
        return BlockArray(data, grid, self.backend,
                          transposed=self._transposed)

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

    # Bitwise / logical (NumPy semantics: & | ^ are bitwise; on bools they
    # coincide with the logical ops).
    def __and__(self, other):
        return self._bop("bitwise_and", other)

    def __rand__(self, other):
        return self._bop("bitwise_and", other, reverse=True)

    def __or__(self, other):
        return self._bop("bitwise_or", other)

    def __ror__(self, other):
        return self._bop("bitwise_or", other, reverse=True)

    def __xor__(self, other):
        return self._bop("bitwise_xor", other)

    def __rxor__(self, other):
        return self._bop("bitwise_xor", other, reverse=True)

    def __lshift__(self, other):
        return self._bop("left_shift", other)

    def __rshift__(self, other):
        return self._bop("right_shift", other)

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
        trace.log_op("tensordot", self, other)
        with trace.span("nums.array.tensordot"):
            collective = self._collective_matmul(other, static_axes)
            if collective is not None:
                return collective
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
        blockarray.py:749-780; nothing here needs one). A strided view
        (a column slice, say) is made contiguous for the kernel."""
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
        if self.backend.mesh is not None:
            # Each process's rows through the kernel, one all-reduce.
            data = summa.gram_all_reduce(self.backend, self._data)
        else:
            data = cuda_gram.gram(self._data.contiguous())
        bs = array_utils.tensordot_block_shape(
            self.block_shape, other.block_shape, 1
        )
        return self._new(data, bs)

    def _raw_physical(self):
        """The reference's padded at-rest shape of the raw tensor: the
        schedules dispatch on it."""
        shape, gshape = self.shape, self.grid_shape
        if self._transposed:
            shape, gshape = tuple(reversed(shape)), tuple(reversed(gshape))
        return tuple(self.backend.physical_shape(shape, gshape))

    @staticmethod
    def _explicit_choice(backend, mode, ta, tb, a_phys, b_phys):
        """Schedule for an explicit mode (ring|summa): the transposed
        patterns take their own schedule; NN (and TT, NN on the swapped
        raws) takes the NAMED one where the shapes divide the mesh, else
        None (the default route). As blockarray.py:783-804 of the
        reference."""
        if ta != tb:
            name, ok = (("tn", summa.tn_supported) if ta
                        else ("nt", summa.nt_supported))
            return name if ok(backend, a_phys, b_phys) else None
        if ta and tb:
            a_phys, b_phys = b_phys, a_phys
        if mode == "ring" and summa.ring_supported(backend, a_phys, b_phys):
            return "ring"
        if mode == "summa" and summa.supported(backend, a_phys, b_phys):
            return "summa"
        return None

    def _collective_matmul(self, other, static_axes):
        """A hand-scheduled mesh GEMM (``settings.collective_matmul`` ring|
        summa|auto; ``core/ops/summa.py``), or None for the default route.
        All four transpose patterns: TN is the local product (the gram
        kernel for x.T @ x) and one reduce-scatter; NT all-gathers B's
        panel; NN rides the ring or SUMMA; TT runs NN on the swapped raws
        and marks the result transposed. The dispatched schedule ("xla"
        for none) is recorded in ``summa.LAST_DISPATCH``, as the
        reference's (blockarray.py:806-872)."""
        from nums_tpu_torch.core import settings

        mode = settings.collective_matmul
        if mode not in ("ring", "summa", "auto"):
            return None
        if (static_axes != 1 or self.ndim != 2 or other.ndim != 2
                or self.backend.mesh is None):
            return None
        ta, tb = self._transposed, other._transposed
        a_phys, b_phys = self._raw_physical(), other._raw_physical()
        if mode == "auto":
            choice = summa.choose_schedule(
                self.backend, ta, tb, a_phys, b_phys,
                np.dtype(self.dtype).itemsize)
        else:
            choice = self._explicit_choice(self.backend, mode, ta, tb,
                                           a_phys, b_phys)
        summa.LAST_DISPATCH = choice or "xla"
        if choice is None:
            return None
        run = summa.SCHEDULES[choice]
        lshape = (self.shape[0], other.shape[1])
        bs = array_utils.tensordot_block_shape(
            self.block_shape, other.block_shape, 1)
        if ta and tb:
            # C = Aᵀ·Bᵀ = (Braw @ Araw)ᵀ
            data = run(self.backend, other._data, self._data)
            grid = ArrayGrid(lshape, bs, array_utils.to_dtype_name(data.dtype))
            return BlockArray(data, grid, self.backend, transposed=True)
        if choice == "tn":
            data = run(self.backend, self._data, other._data,
                       same=other._data is self._data)
        else:
            data = run(self.backend, self._data, other._data)
        return self._new(data, bs)

    def __matmul__(self, other):
        other = self.check_or_convert_other(other)
        if self.ndim > 2 or (isinstance(other, BlockArray) and other.ndim > 2):
            o = other.data if isinstance(other, BlockArray) else other
            return self._new(linear.matmul(self.data, o))
        return self.tensordot(other, axes=1)

    def __rmatmul__(self, other):
        other = self.check_or_convert_other(other)
        if not isinstance(other, BlockArray):
            raise ValueError("matmul requires array operands")
        return other.__matmul__(self)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------

    @staticmethod
    def _is_bool_mask(s):
        return (
            isinstance(s, BlockArray) and s.dtype == np.bool_
        ) or (isinstance(s, np.ndarray) and s.dtype == np.bool_)

    def _index_tensor(self, arr, dim_len):
        """A host integer index array as an int64 tensor on the device,
        negative entries counted from the end; out of range raises
        IndexError (the check is on the host: no device sync)."""
        arr = np.asarray(arr)
        if arr.size and (arr.max() >= dim_len or arr.min() < -dim_len):
            raise IndexError(f"index out of bounds for axis of size "
                             f"{dim_len}")
        arr = np.where(arr < 0, arr + dim_len, arr).astype(np.int64)
        return torch.from_numpy(arr).to(self._data.device)

    def _normalize_subscript(self, item):
        """The subscript as a tuple torch can index with, and the axis each
        entry consumes (None for ``None`` and ``Ellipsis``).

        A boolean mask becomes one index tensor per axis it covers: a
        BlockArray mask on its device by ``masking.device_where`` (one
        host sync, for the count), a host mask by ``np.where``. Integer
        index arrays become int64 tensors on the device; those already on
        the device are wrapped to ``[0, n)`` (negative from the end) and
        clamped into it, as jax's gather clamps. Slices keep their steps
        (negative ones included)."""
        if not isinstance(item, tuple):
            item = (item,)
        entries = []
        for s in item:
            if self._is_bool_mask(s):
                if isinstance(s, BlockArray):
                    _, idx = masking.device_where(s)
                    entries.extend(("mask", i) for i in idx)
                else:
                    entries.extend(("host", i) for i in np.where(s))
            elif isinstance(s, BlockArray):
                entries.append(("device", s.data))
            elif torch.is_tensor(s):
                entries.append(("device", s))
            elif isinstance(s, (np.ndarray, list)):
                entries.append(("host", np.asarray(s)))
            else:
                entries.append(("basic", s))
        consumed = sum(1 for kind, s in entries
                       if not (kind == "basic" and (s is None
                                                    or s is Ellipsis)))
        key, axes, axis = [], [], 0
        for kind, s in entries:
            if kind == "basic" and s is Ellipsis:
                key.append(s)
                axes.append(None)
                axis += self.ndim - consumed
                continue
            if kind == "basic" and s is None:
                key.append(s)
                axes.append(None)
                continue
            n = self.shape[axis]
            if kind == "host":
                s = self._index_tensor(s, n)
            elif kind == "device":
                s = s.to(device=self._data.device, dtype=torch.int64)
                s = torch.where(s < 0, s + n, s).clamp(0, max(n - 1, 0))
            elif isinstance(s, (int, np.integer)):
                s = int(s)
                if not -n <= s < n:
                    raise IndexError(f"index {s} is out of bounds for "
                                     f"axis {axis} with size {n}")
            key.append(s)
            axes.append(axis)
            axis += 1
        return tuple(key), tuple(axes)

    @staticmethod
    def _positive_step(s, n):
        """(slice with a positive step, flip) selecting ``range(n)[s]``:
        a negative step becomes the same elements in increasing order and
        ``flip`` says to reverse them."""
        start, stop, step = s.indices(n)
        if step > 0:
            return slice(start, stop, step), False
        count = len(range(start, stop, step))
        if count == 0:
            return slice(0, 0, 1), False
        last = start + (count - 1) * step
        return slice(last, start + 1, -step), True

    def _index(self, data, key, axes):
        """``data[key]`` with NumPy's semantics, negative steps included:
        those slices are taken forward and reversed first, every other
        entry of the key left for the second step."""
        if not any(isinstance(k, slice) and (k.step or 1) < 0 for k in key):
            return data[key]
        first = [slice(None)] * data.ndim
        flips = []
        for k, a in zip(key, axes):
            if isinstance(k, slice) and a is not None:
                first[a], flip = self._positive_step(k, data.shape[a])
                if flip:
                    flips.append(a)
        data = data[tuple(first)]
        if flips:
            data = torch.flip(data, flips)
        second = tuple(slice(None) if isinstance(k, slice) else k
                       for k in key)
        return data[second]

    def __getitem__(self, item):
        if self.backend.mesh is not None:
            out = self._mesh_getitem(item)
            if out is not None:
                return out
        key, axes = self._normalize_subscript(item)
        return self._new(self._index(self.data, key, axes))

    # -- the mesh's data-dependent keys (core/ops/mesh_ops.py) -----------

    def mesh_rows_block(self, count, blocks):
        """The block rows of a data-dependent result of ``count`` rows on
        the mesh: as many blocks as ``blocks`` (the input's), so that a
        result of a sharded input is sharded as any array of its shape and
        blocks, and one of a replicated input replicated."""
        return max(1, -(-int(count) // max(int(blocks), 1)))

    def _mesh_mask(self, item):
        """A lone bool mask as a tensor, or None."""
        if isinstance(item, tuple) or not self._is_bool_mask(item):
            return None
        if isinstance(item, BlockArray):
            mask = item.data
        else:
            mask = torch.from_numpy(np.asarray(item)).to(self.backend.device)
        if (mask.ndim > self.ndim
                or tuple(mask.shape) != tuple(self.shape[:mask.ndim])):
            raise IndexError(f"boolean index of shape {tuple(mask.shape)} "
                             f"does not match the array's {self.shape}")
        return mask

    def _host_key(self, item, basic=False):
        """The key with every BlockArray bool mask inside a tuple read to
        the host (a mask of a later axis is short), or None where the key
        holds a device index array (DTensor's gather), or no host index
        array (DTensor slices it) unless ``basic`` (DTensor has no
        strategy for a write into a slice)."""
        items = item if isinstance(item, tuple) else (item,)
        out, host = [], basic
        for s in items:
            if isinstance(s, BlockArray) and s.dtype == np.bool_:
                s, host = np.asarray(s.get()), True
            elif isinstance(s, BlockArray) or torch.is_tensor(s):
                return None
            elif isinstance(s, (np.ndarray, list)):
                host = True
            out.append(s)
        return tuple(out) if host else None

    def _row_index(self, key):
        """The 1-D int array of a key that indexes rows alone, or None."""
        if (len(key) >= 1 and isinstance(key[0], (np.ndarray, list))
                and all(isinstance(s, slice) and s == slice(None)
                        for s in key[1:]) and len(key) <= self.ndim):
            idx = np.asarray(key[0])
            if idx.ndim == 1 and idx.dtype.kind in "iu" and self.ndim >= 1:
                n = self.shape[0]
                if idx.size and (idx.max() >= n or idx.min() < -n):
                    raise IndexError(f"index out of bounds for axis of size "
                                     f"{n}")
                return np.where(idx < 0, idx + n, idx).astype(np.int64)
        return None

    def _element_coords(self, key):
        """(coordinates, result shape) of a host key: NumPy's own indexing
        of each axis's positions, broadcast to the array's shape without
        a copy, so the result has NumPy's shape and order (and its
        IndexError)."""
        coords = []
        for a, n in enumerate(self.shape):
            pos = np.arange(n, dtype=np.int64).reshape(
                [-1 if i == a else 1 for i in range(self.ndim)])
            coords.append(np.broadcast_to(pos, self.shape)[key])
        shape = tuple(coords[0].shape) if coords else ()
        return np.stack([c.reshape(-1) for c in coords], axis=1), shape

    @staticmethod
    def _is_device_ints(s):
        if isinstance(s, BlockArray):
            return s.dtype != np.bool_
        return torch.is_tensor(s) and s.dtype != torch.bool

    def _device_key(self, item):
        """A key of index arrays on the leading axes (device int arrays,
        at least one; device or host masks, as their positions; host int
        arrays; ints), each of one dimension and broadcast to one length,
        then ``:`` only, on the mesh: the list of index arrays
        (``mesh_ops.gather_device``), else None."""
        from nums_tpu_torch.core.ops import mesh_ops

        items = item if isinstance(item, tuple) else (item,)
        if (not any(self._is_device_ints(s) for s in items)
                or not mesh_ops.is_dtensor(self.data)):
            return None
        arrays, rest = [], False
        for s in items:
            if rest or (isinstance(s, slice) and s == slice(None)):
                if not (isinstance(s, slice) and s == slice(None)):
                    return None
                rest = True
            elif self._is_bool_mask(s) or (torch.is_tensor(s)
                                           and s.dtype == torch.bool):
                if isinstance(s, BlockArray) or torch.is_tensor(s):
                    m = s.data if isinstance(s, BlockArray) else s
                    if not mesh_ops.is_dtensor(m):
                        m = self.backend.scatter_full(
                            m.to(self.backend.device),
                            self.backend.sharding_for_shape(tuple(m.shape)))
                    arrays.extend(mesh_ops.where(self.backend, m))
                else:
                    arrays.extend(torch.from_numpy(i) for i in np.where(s))
            elif isinstance(s, BlockArray) or torch.is_tensor(s):
                t = s.data if isinstance(s, BlockArray) else s
                if t.ndim > 1:
                    return None
                arrays.append(t)
            elif isinstance(s, (np.ndarray, list)):
                a = np.asarray(s)
                if a.ndim > 1 or a.dtype.kind not in "iu":
                    return None
                arrays.append(torch.from_numpy(a.astype(np.int64)))
            elif isinstance(s, (int, np.integer)) and not isinstance(
                    s, bool):
                n = self.shape[len(arrays)] if len(arrays) < self.ndim else 0
                if not -n <= int(s) < n:
                    raise IndexError(f"index {int(s)} is out of bounds for "
                                     f"axis {len(arrays)} with size {n}")
                arrays.append(int(s))
            else:
                return None
        if len(arrays) > self.ndim:
            raise IndexError(f"too many indices for an array of "
                             f"{self.ndim} dimensions")
        return arrays

    def _mesh_getitem(self, item):
        from nums_tpu_torch.core.ops import mesh_ops

        mask = self._mesh_mask(item)
        if mask is not None:
            k = mask.ndim
            out = mesh_ops.select(self.backend, self.data, mask)
            rows = self.mesh_rows_block(out.shape[0],
                                        np.prod(self.grid_shape[:k]))
            return self._new(out, (rows,) + tuple(self.block_shape[k:]))
        arrays = self._device_key(item)
        if arrays is not None:
            k = len(arrays)
            shape = (mesh_ops._key_length(arrays),) + tuple(self.shape[k:])
            bs = (self.mesh_rows_block(shape[0], np.prod(
                self.grid_shape[:k])),) + tuple(self.block_shape[k:])
            grid = ArrayGrid(shape, bs, self.grid.dtype)
            out = mesh_ops.gather_device(self.backend, self.data, arrays,
                                         self.backend.sharding_for_grid(grid))
            return self._new(out, grid.block_shape)
        key = self._host_key(item)
        if key is None:
            return self._mesh_basic(item)
        idx = self._row_index(key)
        if idx is not None:
            out = mesh_ops.gather_rows(self.backend, self.data, idx)
            return self._new(out)
        coord, shape = self._element_coords(key)
        grid = ArrayGrid(shape, array_utils.default_block_shape_for(
            shape, self.block_shape), self.grid.dtype)
        out = mesh_ops.gather_elements(
            self.backend, self.data, coord, shape,
            self.backend.sharding_for_grid(grid))
        return self._new(out, grid.block_shape)

    def _mesh_basic(self, item):
        """A key of ints, slices, ``None`` and ``Ellipsis`` of an array on
        the mesh (``mesh_ops.basic_slice``: each process slices its own
        box and the rows move to the result's layout; ``None`` axes are
        added in place; a replicated array is sliced in place, on every
        process's copy), or None for any other key. The result
        has as many blocks along each kept axis as this array where
        ``keeps_blocks`` says so (the serial rule, one block where the
        slice fits in one, would lay a slice of a sharded array whole on
        every process)."""
        from nums_tpu_torch.core.ops import mesh_ops

        items = item if isinstance(item, tuple) else (item,)
        if not (mesh_ops.is_dtensor(self.data)
                and all(s is None or s is Ellipsis or isinstance(s, slice)
                        or (isinstance(s, (int, np.integer))
                            and not isinstance(s, bool)) for s in items)):
            return None
        if sum(s is Ellipsis for s in items) > 1:
            raise IndexError("an index can only have a single ellipsis "
                             "('...')")
        named = sum(1 for s in items if s is not None and s is not Ellipsis)
        if named > self.ndim:
            raise IndexError(f"too many indices for array: array is "
                             f"{self.ndim}-dimensional, but {named} were "
                             "indexed")
        fill = (slice(None),) * (self.ndim - named)
        if Ellipsis in items:
            at = items.index(Ellipsis)
            items = items[:at] + fill + items[at + 1:]
        else:
            items = items + fill
        entries, nones, axis = [], [], 0
        for s in items:
            if s is None:
                nones.append(sum(1 for e in entries if e[3]) + len(nones))
                continue
            n = self.shape[axis]
            if isinstance(s, slice):
                start, stop, step = s.indices(n)
                entries.append((start, step, len(range(start, stop, step)),
                                True))
            else:
                if not -n <= int(s) < n:
                    raise IndexError(f"index {int(s)} is out of bounds for "
                                     f"axis {axis} with size {n}")
                entries.append((int(s) % n, 1, 1, False))
            axis += 1
        shape = tuple(e[2] for e in entries if e[3])
        full = list(shape)
        for at in nones:
            full.insert(at, 1)
        full = tuple(full)
        # each kept axis in as many blocks as this array has along it
        # (fewer rows a block: a slice within one block stays sharded)
        bs = [min(b, max(1, -(-e[2] // g))) for e, b, g in zip(
            entries, self.block_shape, self.grid_shape) if e[3]]
        for at in nones:
            bs.insert(at, 1)
        bs = tuple(bs)
        if not self.keeps_blocks(full, bs):
            bs = array_utils.default_block_shape_for(full, self.block_shape)
        want = self.backend.sharding_for_shape(
            full, ArrayGrid(full, bs, self.grid.dtype).grid_shape)
        inner = tuple(mesh_ops._shard([k for k in range(len(full))
                                       if k not in nones].index(p.dim))
                      if p.is_shard() else p for p in want)
        out = mesh_ops.basic_slice(self.backend, self.data, entries, inner)
        if nones:
            local = out.to_local()
            lshape = list(local.shape)
            for at in nones:
                lshape.insert(at, 1)
            out = self.backend.from_local(local.reshape(lshape), full, want)
        return self._new(out, bs)

    def _mesh_setitem(self, item, value):
        """True where the mesh's own assignment took the key."""
        from torch.distributed.tensor import Replicate

        from nums_tpu_torch.core.ops import mesh_ops

        mask = self._mesh_mask(item)
        if isinstance(value, BlockArray):
            value = value.data
        if mask is not None:
            if int(np.prod(np.shape(value))) != 1:
                self._store(mesh_ops.assign(self.backend, self.data, mask,
                                            value))
                return True
            if mesh_ops.is_dtensor(mask):
                return False  # one torch.where: no count, no movement
            # a host mask: each process keeps its own box of it
            pl = tuple(p if (p.is_shard() and p.dim < mask.ndim)
                       else Replicate() for p in self.data.placements)
            m = mesh_ops.as_dtensor(self.backend, mask, pl)
            m = m.reshape(tuple(m.shape) + (1,) * (self.ndim - m.ndim))
            v = self._value_tensor(value).reshape(())
            self._store(torch.where(m, v, self.data))
            return True
        arrays = self._device_key(item)
        if arrays is not None:
            self._store(mesh_ops.scatter_device(self.backend, self.data,
                                                arrays, value))
            return True
        key = self._host_key(item, basic=True)
        if key is None:
            return False
        idx = self._row_index(key)
        basic = mesh_ops.basic_positions(self.shape, key)
        sharded = mesh_ops.is_dtensor(value) and any(
            p.is_shard() for p in value.placements)
        if idx is not None:
            out = mesh_ops.scatter_rows(self.backend, self.data, idx, value)
        elif basic is not None and not sharded:
            out = mesh_ops.scatter_basic(self.backend, self.data, basic,
                                         value)
        else:
            coord, shape = self._element_coords(key)
            out = mesh_ops.scatter_elements(self.backend, self.data, coord,
                                            shape, value)
        self._store(out)
        return True

    def _value_tensor(self, value):
        """An assigned value as a tensor of this array's dtype on its
        device (jax's ``.at[].set`` casts the same way)."""
        if isinstance(value, BlockArray):
            v = value.data
        elif torch.is_tensor(value):
            v = value
        else:
            v = torch.as_tensor(np.asarray(value), device=self._data.device)
        return v.to(device=self._data.device, dtype=self._data.dtype)

    def __setitem__(self, item, value):
        """NumPy assignment, by a new tensor: the old one is never written,
        so a view another array took of it keeps its values.

        A boolean mask with a value of one element is one ``torch.where``
        on the device, with no host sync; any other value is written
        packed, in row-major order of the True positions, at the index
        tensors of ``masking.device_where`` (one host sync). Every other
        key goes through slice assignment or ``index_put_`` on a copy. On
        the mesh, a packed mask and host index arrays take
        ``core/ops/mesh_ops.py``."""
        if self.backend.mesh is not None and self._mesh_setitem(item,
                                                                 value):
            return
        v = self._value_tensor(value)
        if not isinstance(item, tuple) and self._is_bool_mask(item):
            if v.numel() == 1:
                mask = (item.data if isinstance(item, BlockArray)
                        else torch.from_numpy(np.asarray(item)).to(
                            self._data.device))
                mask = mask.reshape(tuple(mask.shape)
                                    + (1,) * (self.ndim - mask.ndim))
                self._store(torch.where(mask, v.reshape(()), self.data))
                return
        key, axes = self._normalize_subscript(item)
        out = self.data.clone()
        if any(isinstance(k, slice) and (k.step or 1) < 0 for k in key):
            # torch slices take no negative step: write through the flat
            # positions that the key selects.
            pos = self._index(
                torch.arange(out.numel(), device=out.device).reshape(
                    out.shape), key, axes)
            flat = out.reshape(-1)
            flat[pos.reshape(-1)] = torch.broadcast_to(
                v, tuple(pos.shape)).reshape(-1)
            out = flat.reshape(out.shape)
        else:
            out[key] = v
        self._store(out)

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

    def __complex__(self):
        return complex(self._scalar_value())

    # ------------------------------------------------------------------
    # ndarray methods (delegate to the facade, as the reference's do)
    # ------------------------------------------------------------------

    def all(self, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.all(self, axis=axis)

    def any(self, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.any(self, axis=axis)

    def clip(self, a_min=None, a_max=None):
        from nums_tpu_torch.numpy import extra

        return extra.clip(self, a_min, a_max)

    def round(self, decimals=0):
        from nums_tpu_torch.numpy import extra

        return extra.around(self, decimals)

    def cumsum(self, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.cumsum(self, axis=axis)

    def cumprod(self, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.cumprod(self, axis=axis)

    def take(self, indices, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.take(self, indices, axis=axis)

    def repeat(self, repeats, axis=None):
        from nums_tpu_torch.numpy import extra

        return extra.repeat(self, repeats, axis=axis)

    def ravel(self):
        return self.reshape(self.size)

    def flatten(self):
        return self.reshape(self.size)

    def swapaxes(self, axis1, axis2):
        from nums_tpu_torch.numpy import extra

        return extra.swapaxes(self, axis1, axis2)

    def sort(self, axis=-1):
        # NumPy sorts in place; rebind the tensor (as __setitem__ does).
        from nums_tpu_torch.numpy import extra

        out = extra.sort(self, axis=axis)
        self._store(out.data)

    def argsort(self, axis=-1):
        from nums_tpu_torch.numpy import extra

        return extra.argsort(self, axis=axis)

    def nonzero(self):
        from nums_tpu_torch.numpy import extra

        return extra.nonzero(self)

    def conj(self):
        return self.ufunc("conj")

    conjugate = conj

    @property
    def real(self):
        from nums_tpu_torch.numpy import extra

        return extra.real(self)

    @property
    def imag(self):
        from nums_tpu_torch.numpy import extra

        return extra.imag(self)

    def dot(self, other):
        from nums_tpu_torch.numpy import extra

        return extra.dot(self, other)

    def trace(self, offset=0):
        from nums_tpu_torch.numpy import extra

        return extra.trace(self, offset=offset)

    def diagonal(self, offset=0):
        from nums_tpu_torch.numpy import extra

        return extra.diagonal(self, offset=offset)

    def item(self):
        return self._scalar_value()

    def tolist(self):
        return self.get().tolist()

    def __array__(self, dtype=None, copy=None):
        del copy
        out = self.get()
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"BlockArray({self.get()})"

    def __str__(self):
        return str(self.get())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]
