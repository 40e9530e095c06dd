"""ArrayApplication: constructors, block-shape policy and array ops.

Counterpart of the subset of ``nums_tpu/core/array/application.py`` that
the main path uses: the block-shape policy, ``scalar``/``array``/
``zeros``/``ones``/``full``/``concatenate``, ``sum``/``mean``/``exp``,
``get``/``touch`` and the random state. The filesystem is not ported and
stays ``None``.
"""

import numpy as np

from nums_tpu_torch.core.backend import Backend
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.array.random import NumsRandomState
from nums_tpu_torch.core.ops import creation, shape_ops


class ArrayApplication:
    def __init__(self, backend: Backend, filesystem=None):
        assert filesystem is None, "the filesystem is not ported yet"
        self.backend = backend
        # `system` alias preserves the reference attribute name.
        self.system = backend
        self._block_shape_map = {}
        self.one_half = self.scalar(0.5)
        self.two = self.scalar(2.0)
        self.one = self.scalar(1.0)
        self.zero = self.scalar(0.0)

    def num_cores_total(self):
        return self.backend.num_cores_total

    # ------------------------------------------------------------------
    # Block-shape policy (nums_tpu application.py:253-310)
    # ------------------------------------------------------------------

    def compute_block_shape(self, shape: tuple, dtype, cluster_shape=None,
                            num_cores=None):
        """Small arrays (< 100 MB) get a single block; otherwise the grid
        is sized to about the device count, weighted toward long axes."""
        dtype = array_utils.to_np_dtype(dtype)
        size = int(np.prod(shape)) * dtype.itemsize if len(shape) else (
            dtype.itemsize
        )
        if size < 10**8:
            return tuple(shape)
        if num_cores is None:
            num_cores = self.num_cores_total()
        if cluster_shape is None:
            cluster_shape = (1, 1)
        if len(shape) < len(cluster_shape):
            cluster_shape = cluster_shape[: len(shape)]
        elif len(shape) > len(cluster_shape):
            cluster_shape = tuple(cluster_shape) + (1,) * (
                len(shape) - len(cluster_shape)
            )
        shape_np = np.array(shape, dtype=np.int64)
        cluster_weights = np.exp(np.array(cluster_shape)) / np.sum(
            np.exp(cluster_shape)
        )
        shape_fracs = shape_np / np.sum(shape_np)
        weighted = cluster_weights * shape_fracs
        weighted = weighted / np.sum(weighted)
        grid_shape_frac = num_cores**weighted
        grid_shape = np.floor(grid_shape_frac)
        remaining = np.sum(grid_shape_frac - grid_shape)
        grid_shape[np.argmax(shape_np)] += remaining
        grid_shape = np.ceil(grid_shape).astype(np.int64)
        return tuple(
            int(x) for x in (shape_np + grid_shape - 1) // grid_shape
        )

    def get_block_shape(self, shape, dtype):
        """Memoized per-dimension block sizes."""
        block_shape = self.compute_block_shape(shape, dtype)
        final = []
        for axis in range(len(shape)):
            dim = shape[axis]
            if dim not in self._block_shape_map:
                self._block_shape_map[dim] = block_shape[axis]
            final.append(self._block_shape_map[dim])
        return tuple(final)

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------

    def scalar(self, value):
        return BlockArray.from_scalar(value, self.backend)

    def array(self, array, block_shape: tuple = None):
        array = np.asarray(array)
        if block_shape is None:
            block_shape = self.get_block_shape(array.shape, array.dtype)
        assert len(array.shape) == len(block_shape)
        return BlockArray.from_np(array, block_shape=block_shape,
                                  backend=self.backend)

    def _new_array(self, op_name, shape, block_shape, dtype=None):
        if dtype is None:
            dtype = self.backend.default_float
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        data = creation.new_array(
            op_name, grid.shape, array_utils.to_torch_dtype(dtype),
            self.backend.device,
        )
        return BlockArray(data, grid, self.backend)

    def zeros(self, shape, block_shape, dtype=None):
        return self._new_array("zeros", shape, block_shape, dtype)

    def ones(self, shape, block_shape, dtype=None):
        return self._new_array("ones", shape, block_shape, dtype)

    def full(self, shape, block_shape, fill_value, dtype=None):
        if dtype is None:
            dtype = np.asarray(fill_value).dtype
        grid = ArrayGrid(tuple(shape), tuple(block_shape),
                         array_utils.to_dtype_name(dtype))
        data = creation.full(grid.shape, fill_value,
                             array_utils.to_torch_dtype(dtype),
                             self.backend.device)
        return BlockArray(data, grid, self.backend)

    def concatenate(self, arrays, axis, axis_block_size=None):
        if len(arrays) == 1:
            return arrays[0]
        first = arrays[0]
        for a in arrays:
            assert a.ndim == first.ndim, "Unequal num axes."
        data = shape_ops.concatenate([a.data for a in arrays], int(axis))
        result_block_shape = list(first.block_shape)
        result_block_shape[axis] = (
            axis_block_size if axis_block_size is not None
            else first.block_shape[axis]
        )
        lshape = tuple(data.shape)
        result_block_shape = tuple(
            min(b, s) for b, s in zip(result_block_shape, lshape)
        )
        return BlockArray(
            data, ArrayGrid(lshape, result_block_shape,
                            array_utils.to_dtype_name(data.dtype)),
            self.backend,
        )

    # ------------------------------------------------------------------
    # Elementwise / reductions
    # ------------------------------------------------------------------

    def exp(self, X):
        return X.ufunc("exp")

    def sum(self, X, axis=None, keepdims=False, dtype=None):
        # dtype is the accumulator dtype (see ops/reductions.py).
        return X.sum(axis=axis, keepdims=keepdims, dtype=dtype)

    def mean(self, X, axis=None, keepdims=False, dtype=None):
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(self.backend.default_float)
        return X.mean(axis=axis, keepdims=keepdims, dtype=dtype)

    def get(self, *arrs):
        if len(arrs) == 1:
            a = arrs[0]
            return a.get() if isinstance(a, BlockArray) else a
        return [a.get() if isinstance(a, BlockArray) else a for a in arrs]

    def touch(self, *arrs):
        for a in arrs:
            a.touch()
        return arrs[0] if len(arrs) == 1 else arrs

    # ------------------------------------------------------------------
    # Random
    # ------------------------------------------------------------------

    def random_state(self, seed=None):
        return NumsRandomState(self.backend, seed)
