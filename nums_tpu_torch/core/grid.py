"""Array partitioning metadata.

Counterpart of ``nums_tpu/core/grid.py`` (``ArrayGrid``, which has no jax
in it): a logical shape is partitioned into a grid of blocks of
``block_shape`` with ragged final blocks allowed. The grid is pure
metadata — the data lives in one ``torch.Tensor`` — but it still drives
the block-shape policy and the block shapes of derived arrays.
``DeviceGrid`` names the mesh backend's device arrangement.
"""

import itertools

import numpy as np


def cdiv(a, b):
    return -(-a // b)


def array_split_partitions(dim, block_dim):
    """Partition points of one axis: list of (start, stop) pairs; every
    block is ``block_dim`` long except possibly the last (ragged edge)."""
    if dim == 0:
        return [(0, 0)]
    return [(i, min(i + block_dim, dim)) for i in range(0, dim, block_dim)]


def shard_region(shape, dims, mesh_shape, coord):
    """The box ((start, stop) per axis) that the mesh coordinate ``coord``
    holds of an array of ``shape``, where mesh dimension j shards array
    axis ``dims[j]`` (None: replicated). DTensor's rule: each sharding
    mesh dimension, in order, splits its axis's current extent into
    chunks of ceil(extent / size), the last ones short or empty — for one
    mesh dimension, the rows the reference's padded layout gives each
    device."""
    box = [(0, int(s)) for s in shape]
    for j, axis in enumerate(dims):
        if axis is None:
            continue
        a, b = box[axis]
        chunk = cdiv(b - a, int(mesh_shape[j]))
        lo = min(a + chunk * int(coord[j]), b)
        box[axis] = (lo, min(lo + chunk, b))
    return tuple(box)


class ArrayGrid:
    """Grid partitioning of a logical array shape."""

    def __init__(self, shape: tuple, block_shape: tuple, dtype: str):
        assert len(shape) == len(block_shape), (shape, block_shape)
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(
            min(int(b), int(s)) for s, b in zip(shape, block_shape)
        )
        assert isinstance(dtype, str), "dtype must be a string name"
        self.dtype = dtype
        for s, b in zip(self.shape, self.block_shape):
            assert s >= 0, f"negative dim in shape {self.shape}"
            assert b > 0 or s == 0, (
                f"non-positive block dim {b} for axis of size {s} "
                f"(unresolved -1 in a reshape spec?)"
            )
        self.grid_shape = tuple(
            cdiv(s, b) if s > 0 else 1
            for s, b in zip(self.shape, self.block_shape)
        ) if len(self.shape) > 0 else ()
        self.grid_slices = [
            array_split_partitions(s, b)
            for s, b in zip(self.shape, self.block_shape)
        ]

    @classmethod
    def from_meta(cls, d: dict):
        return cls(tuple(d["shape"]), tuple(d["block_shape"]), d["dtype"])

    def to_meta(self) -> dict:
        return {
            "shape": self.shape,
            "block_shape": self.block_shape,
            "dtype": self.dtype,
        }

    def copy(self):
        return self.from_meta(self.to_meta())

    @property
    def num_blocks(self):
        return int(np.prod(self.grid_shape)) if self.grid_shape else 1

    def get_entry_iterator(self):
        if len(self.shape) == 0:
            return [()]
        return itertools.product(*(range(g) for g in self.grid_shape))

    def get_slice_tuples(self, grid_entry: tuple):
        """(start, stop) per axis for the given grid entry."""
        return tuple(
            self.grid_slices[ax][i] for ax, i in enumerate(grid_entry)
        )

    def get_slice(self, grid_entry: tuple):
        """Tuple of python ``slice`` objects selecting this block."""
        return tuple(
            slice(start, stop)
            for start, stop in self.get_slice_tuples(grid_entry)
        )

    def get_block_shape(self, grid_entry: tuple):
        return tuple(
            stop - start for start, stop in self.get_slice_tuples(grid_entry)
        )

    def nbytes(self):
        dtype = np.dtype(self.dtype)
        if not self.shape:
            return dtype.itemsize
        return dtype.itemsize * int(np.prod(self.shape))

    def __repr__(self):
        return (
            f"ArrayGrid(shape={self.shape}, block_shape={self.block_shape}, "
            f"grid_shape={self.grid_shape}, dtype={self.dtype})"
        )


class DeviceGrid:
    """Logical device grid of the mesh backend (``nums_tpu/core/grid.py``
    ``DeviceGrid``): a k-D arrangement of devices, its axes named
    ``m0, m1, ...``, onto which array axes map."""

    AXIS_PREFIX = "m"

    def __init__(self, mesh_shape: tuple):
        self.mesh_shape = tuple(int(m) for m in mesh_shape)
        self.axis_names = tuple(
            f"{self.AXIS_PREFIX}{i}" for i in range(len(self.mesh_shape))
        )

    @property
    def num_devices(self):
        return int(np.prod(self.mesh_shape))
