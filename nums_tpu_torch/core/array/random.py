"""NumsRandomState: the stateful RNG facade over torch generators.

Counterpart of ``nums_tpu/core/array/random.py`` for ``random``,
``normal``, ``uniform`` and ``integers``. The reference derives one
threefry key per call from (seed, stream counter); here each call seeds a
fresh ``torch.Generator`` on the backend's device from the same pair, so
the stream is reproducible from (seed, counter) alone and one call's draw
never depends on the block shape.
"""

import numpy as np
import torch

from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.ops import random_ops


class NumsRandomState:
    def __init__(self, backend, seed=None):
        self._backend = backend
        self.seed(seed)

    def seed(self, seed=None):
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        self._seed = int(seed)
        self._counter = 0

    def _next_generator(self) -> torch.Generator:
        self._counter += 1
        (word,) = np.random.SeedSequence(
            (self._seed, self._counter)
        ).generate_state(1, np.uint64)
        gen = torch.Generator(device=self._backend.device)
        gen.manual_seed(int(word) & (2**63 - 1))
        return gen

    def _grid(self, shape, block_shape, dtype_name):
        shape = tuple(shape) if shape is not None else ()
        if block_shape is None:
            block_shape = shape
        return ArrayGrid(shape, tuple(block_shape), dtype_name)

    def _sample_basic(self, rfunc_name, shape, block_shape, dtype,
                      rfunc_args) -> BlockArray:
        if dtype is None:
            dtype = self._backend.default_float
        grid = self._grid(shape, block_shape, array_utils.to_dtype_name(dtype))
        data = random_ops.sample(
            rfunc_name, grid.shape, array_utils.to_torch_dtype(dtype),
            self._backend.device, self._next_generator(),
            *[float(a) for a in rfunc_args],
        )
        return BlockArray(data, grid, self._backend)

    def random(self, shape=None, block_shape=None, dtype=None):
        if dtype is not None:
            assert np.dtype(dtype).kind == "f", "random() requires float dtype"
        return self._sample_basic("random", shape, block_shape, dtype, ())

    def integers(self, low, high=None, shape=None, block_shape=None,
                 dtype=None, endpoint=False):
        if high is None:
            low, high = 0, low
        if dtype is None:
            dtype = np.int64
        grid = self._grid(shape, block_shape, array_utils.to_dtype_name(dtype))
        data = random_ops.integers(
            grid.shape, array_utils.to_torch_dtype(dtype),
            self._backend.device, self._next_generator(), int(low),
            int(high), bool(endpoint),
        )
        return BlockArray(data, grid, self._backend)

    def uniform(self, low=0.0, high=1.0, shape=None, block_shape=None,
                dtype=None):
        return self._sample_basic(
            "uniform", shape, block_shape, dtype, (low, high)
        )

    def normal(self, loc=0.0, scale=1.0, shape=None, block_shape=None,
               dtype=None):
        return self._sample_basic(
            "normal", shape, block_shape, dtype, (loc, scale)
        )
