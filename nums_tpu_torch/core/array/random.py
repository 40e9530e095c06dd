"""NumsRandomState: the stateful RNG facade over counter-based sampling.

Counterpart of ``nums_tpu/core/array/random.py``, with the same surface
(seed management, the full distribution set, the ``numpy()`` escape hatch,
``choice``/``shuffle``/``permutation``) on the same engine: the key is
``seed_key(seed)``, each call draws under ``fold_in(key, ++counter)``
(``core/ops/threefry.py``), and a sample is one whole array at the logical
shape. So the same (seed, call number) draws the reference's values, on
any device and under any block shape, and a state saved by either package
(``get_state``) resumes the stream in the other. On the mesh each process
draws only the positions it holds (``random_ops.sample_region``), so a
sharded draw equals the one-device draw bit for bit.

Dtypes. The reference runs in one of two modes, and a backend reproduces
the one its device implies. A CPU backend (default float float64) draws as
jax with 64-bit types on: a float64 request draws 64-bit floats, an int64
request goes through the 64-bit integer path, and the seed's high word
enters the key. A CUDA backend (default float float32) draws as the
reference on an accelerator, 64-bit types off: a float64 request draws
float32 values and the array IS float32 (``Backend.device_dtype``); an
int64 request draws through the 32-bit path and the array is int64 with
those values; only the seed's low 32 bits enter the key.
``permutation`` is int64 on both (the reference's is int32 in the second
mode; the values are equal, and int64 is what the row gather takes).
"""

import numpy as np
import torch

from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.ops import random_ops, threefry


# Distributions sampled on the host with a deterministically-derived NumPy
# generator, then moved to the device.
_HOST_DISTS = {
    "hypergeometric": lambda rng, args, shape: rng.hypergeometric(
        *args, size=shape
    ),
}


class NumsRandomState:
    def __init__(self, backend, seed=None):
        self._backend = backend
        # Which of the reference's two modes this backend reproduces.
        self._x64 = backend.default_float == np.float64
        self.seed(seed)

    def seed(self, seed=None):
        if seed is None:
            seed = np.random.SeedSequence().entropy % (2**63)
        self._seed = int(seed)
        self._key = threefry.seed_key(self._seed, self._x64)
        self._counter = 0

    def numpy(self):
        """Host-side NumPy generator, seeded as the reference's
        (``nums_tpu/core/array/random.py:41-43``): the same seed draws the
        same numbers in both packages."""
        return np.random.default_rng(self._seed)

    def get_state(self):
        """Engine state as a dict. The engine is counter-based threefry
        (not MT19937), so the state is (seed, stream counter): enough to
        reproduce or resume the stream exactly, in this package or in the
        reference."""
        return {
            "bit_generator": "threefry2x32",
            "seed": self._seed,
            "counter": self._counter,
        }

    def set_state(self, state):
        assert state.get("bit_generator") == "threefry2x32", state
        self._seed = int(state["seed"])
        self._key = threefry.seed_key(self._seed, self._x64)
        self._counter = int(state["counter"])

    def _next_key(self):
        self._counter += 1
        return threefry.fold_in(self._key, self._counter)

    @property
    def _device(self):
        return self._backend.device

    def _grid(self, shape, block_shape, dtype_name):
        shape = tuple(shape) if shape is not None else ()
        if block_shape is None:
            block_shape = shape
        return ArrayGrid(shape, tuple(block_shape), dtype_name)

    def _float_dtype(self, dtype):
        """The float dtype a request draws at and the array then has."""
        if dtype is None:
            dtype = np.float64
        return self._backend.device_dtype(array_utils.to_np_dtype(dtype))

    def _tensor(self, value, dtype=None):
        """A host array-like on the backend's device, floats at the
        device's width."""
        arr = np.asarray(value)
        if dtype is not None:
            arr = arr.astype(dtype)
        arr = arr.astype(self._backend.device_dtype(arr.dtype), copy=False)
        return torch.from_numpy(np.array(arr, order="C")).to(self._device)

    def _wrap(self, data, block_shape):
        grid = self._grid(tuple(data.shape), block_shape,
                          array_utils.to_dtype_name(data.dtype))
        return BlockArray(data, grid, self._backend)

    def _sample_basic(self, rfunc_name, shape, block_shape, dtype,
                      rfunc_args) -> BlockArray:
        dtype = self._float_dtype(dtype)
        grid = self._grid(shape, block_shape, array_utils.to_dtype_name(dtype))
        box = self._backend.local_region(grid)
        if random_ops.supported(rfunc_name) and box is not None:
            # A mesh process draws its own positions only: the array equals
            # the one-device draw bit for bit.
            local = random_ops.sample_region(
                rfunc_name, self._next_key(), grid.shape, box,
                array_utils.to_torch_dtype(dtype), self._device, self._x64,
                *[float(a) for a in rfunc_args],
            )
            data = self._backend.from_local(
                local, grid.shape, self._backend.sharding_for_grid(grid))
        elif random_ops.supported(rfunc_name):
            data = random_ops.sample(
                rfunc_name, self._next_key(), grid.shape,
                array_utils.to_torch_dtype(dtype), self._device, self._x64,
                *[float(a) for a in rfunc_args],
            )
        elif rfunc_name in _HOST_DISTS:
            # The host route bumps the counter without folding a key.
            self._counter += 1
            rng = np.random.default_rng((self._seed, self._counter))
            arr = _HOST_DISTS[rfunc_name](rng, rfunc_args, grid.shape)
            arr = np.asarray(arr, dtype=np.dtype(grid.dtype))
            data = self._backend.device_put(arr, grid)
        else:
            raise NotImplementedError(f"Unknown distribution {rfunc_name}")
        return BlockArray(data, grid, self._backend)

    # -- core samplers ---------------------------------------------------

    def random(self, shape=None, block_shape=None, dtype=None):
        if dtype is None:
            dtype = np.float64
        assert np.dtype(dtype).kind == "f", "random() requires float dtype"
        return self._sample_basic("random", shape, block_shape, dtype, ())

    def integers(self, low, high=None, shape=None, block_shape=None,
                 dtype=None, endpoint=False):
        if high is None:
            low, high = 0, low
        if dtype is None:
            dtype = np.int64
        grid = self._grid(shape, block_shape, array_utils.to_dtype_name(dtype))
        box = self._backend.local_region(grid)
        data = random_ops.integers(
            self._next_key(), grid.shape, array_utils.to_torch_dtype(dtype),
            self._device, self._x64, int(low), int(high), bool(endpoint),
            region=box,
        )
        if box is not None:
            # a mesh process draws its own positions only
            data = self._backend.from_local(
                data, grid.shape, self._backend.sharding_for_grid(grid))
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

    # -- distribution zoo ------------------------------------------------

    def beta(self, a, b, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("beta", shape, block_shape, dtype, (a, b))

    def binomial(self, n, p, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("binomial", shape, block_shape, dtype, (n, p))

    def chisquare(self, df, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("chisquare", shape, block_shape, dtype, (df,))

    def exponential(self, scale=1.0, shape=None, block_shape=None, dtype=None):
        return self._sample_basic(
            "exponential", shape, block_shape, dtype, (scale,)
        )

    def f(self, dfnum, dfden, shape=None, block_shape=None, dtype=None):
        return self._sample_basic(
            "f", shape, block_shape, dtype, (dfnum, dfden)
        )

    def gamma(self, k, theta, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("gamma", shape, block_shape, dtype, (k, theta))

    def geometric(self, p, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("geometric", shape, block_shape, dtype, (p,))

    def gumbel(self, loc=0.0, scale=1.0, shape=None, block_shape=None,
               dtype=None):
        return self._sample_basic(
            "gumbel", shape, block_shape, dtype, (loc, scale)
        )

    def hypergeometric(self, ngood, nbad, nsample, shape=None,
                       block_shape=None, dtype=None):
        nsample = int(nsample)
        if ngood < 0 or nbad < 0 or nsample < 0:
            raise ValueError("ngood, nbad, nsample must be non-negative")
        if int(ngood) + int(nbad) < nsample:
            # numpy raises here; the device chain would silently drive
            # the urn counts negative and return garbage.
            raise ValueError("ngood + nbad < nsample")
        if dtype is None:
            # Both routes default to int64 (numpy returns integers).
            dtype = np.int64
        if int(ngood) >= 10**9 or int(nbad) >= 10**9:
            # numpy's own cap (Generator.hypergeometric). It also keeps
            # every legal population total under 2e9, inside the device
            # urn's exact int32 range.
            raise ValueError(
                "both ngood and nbad must be less than 1000000000"
            )
        if nsample <= random_ops.HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE:
            dtype = self._backend.device_dtype(array_utils.to_np_dtype(dtype))
            grid = self._grid(shape, block_shape,
                              array_utils.to_dtype_name(dtype))
            data = random_ops.hypergeometric(
                self._next_key(), grid.shape,
                array_utils.to_torch_dtype(dtype), self._device, nsample,
                ngood, nbad,
            )
            return BlockArray(data, grid, self._backend)
        # Huge nsample: the O(nsample) device chain loses to the host
        # generator.
        return self._sample_basic(
            "hypergeometric", shape, block_shape, dtype, (ngood, nbad, nsample)
        )

    def laplace(self, loc=0.0, scale=1.0, shape=None, block_shape=None,
                dtype=None):
        return self._sample_basic(
            "laplace", shape, block_shape, dtype, (loc, scale)
        )

    def logistic(self, loc=0.0, scale=1.0, shape=None, block_shape=None,
                 dtype=None):
        return self._sample_basic(
            "logistic", shape, block_shape, dtype, (loc, scale)
        )

    def lognormal(self, mean=0.0, sigma=1.0, shape=None, block_shape=None,
                  dtype=None):
        return self._sample_basic(
            "lognormal", shape, block_shape, dtype, (mean, sigma)
        )

    def logseries(self, p, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("logseries", shape, block_shape, dtype, (p,))

    def negative_binomial(self, n, p, shape=None, block_shape=None,
                          dtype=None):
        return self._sample_basic(
            "negative_binomial", shape, block_shape, dtype, (n, p)
        )

    def noncentral_chisquare(self, df, nonc, shape=None, block_shape=None,
                             dtype=None):
        return self._sample_basic(
            "noncentral_chisquare", shape, block_shape, dtype, (df, nonc)
        )

    def noncentral_f(self, dfnum, dfden, nonc, shape=None, block_shape=None,
                     dtype=None):
        return self._sample_basic(
            "noncentral_f", shape, block_shape, dtype, (dfnum, dfden, nonc)
        )

    def pareto(self, a, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("pareto", shape, block_shape, dtype, (a,))

    def poisson(self, lam=1.0, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("poisson", shape, block_shape, dtype, (lam,))

    def power(self, a, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("power", shape, block_shape, dtype, (a,))

    def rayleigh(self, scale=1.0, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("rayleigh", shape, block_shape, dtype, (scale,))

    def standard_cauchy(self, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("standard_cauchy", shape, block_shape, dtype, ())

    def standard_t(self, df, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("standard_t", shape, block_shape, dtype, (df,))

    def triangular(self, left, mode, right, shape=None, block_shape=None,
                   dtype=None):
        return self._sample_basic(
            "triangular", shape, block_shape, dtype, (left, mode, right)
        )

    def vonmises(self, mu, kappa, shape=None, block_shape=None, dtype=None):
        return self._sample_basic(
            "vonmises", shape, block_shape, dtype, (mu, kappa)
        )

    def wald(self, mean, scale, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("wald", shape, block_shape, dtype, (mean, scale))

    def weibull(self, a, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("weibull", shape, block_shape, dtype, (a,))

    def zipf(self, a, shape=None, block_shape=None, dtype=None):
        return self._sample_basic("zipf", shape, block_shape, dtype, (a,))

    # -- numpy Generator-style extras ------------------------------------

    def standard_normal(self, shape=None, block_shape=None, dtype=None):
        return self.normal(0.0, 1.0, shape, block_shape, dtype)

    def standard_exponential(self, shape=None, block_shape=None, dtype=None):
        return self.exponential(1.0, shape, block_shape, dtype)

    def standard_gamma(self, k, shape=None, block_shape=None, dtype=None):
        return self.gamma(k, 1.0, shape, block_shape, dtype)

    def multivariate_normal(self, mean, cov, shape=None, block_shape=None,
                            dtype=None):
        dtype = self._float_dtype(dtype)
        mean = self._tensor(mean)
        cov = self._tensor(cov)
        if not mean.is_floating_point():
            mean = mean.to(random_ops._wide(self._x64))
        shape = tuple(shape) if shape is not None else ()
        data = random_ops.jr_multivariate_normal(
            self._next_key(), mean, cov.to(mean.dtype), shape,
            array_utils.to_torch_dtype(dtype), self._device,
        )
        return self._wrap(data, block_shape)

    def dirichlet(self, alpha, shape=None, block_shape=None, dtype=None):
        dtype = self._float_dtype(dtype)
        alpha = self._tensor(alpha, np.float64)
        shape = tuple(shape) if shape is not None else ()
        full = shape + tuple(alpha.shape[-1:])
        grid = self._grid(full, block_shape, array_utils.to_dtype_name(dtype))
        box = self._backend.local_region(grid)
        # Drawn at the wide float (the reference passes no dtype), cast
        # to the request afterwards; a mesh process draws its own rows.
        data = random_ops.jr_dirichlet(
            self._next_key(), shape, alpha.dtype, self._device, alpha,
            region=box).to(array_utils.to_torch_dtype(dtype))
        if box is not None:
            data = self._backend.from_local(
                data, grid.shape, self._backend.sharding_for_grid(grid))
        return BlockArray(data, grid, self._backend)

    def multinomial(self, n, pvals, shape=None, block_shape=None, dtype=None):
        """One binomial per category on the trials that remain, under the
        call's counter-derived key: same-seed determinism under any block
        shape, like every other distribution here.

        NumPy's Generator semantics, validated on the host: each pval must
        lie in [0, 1] (no NaNs) and the LAST category's probability is the
        implicit remainder 1 - sum(pvals[:-1])."""
        pv = np.asarray(pvals, dtype=np.float64)
        if (
            np.isnan(pv).any() or (pv < 0).any() or (pv > 1).any()
            or (pv[..., :-1].sum(axis=-1) > 1.0 + 1e-12)
        ):
            raise ValueError(
                "pvals < 0, pvals > 1 or pvals contains NaNs"
            )
        pv = pv.copy()
        pv[..., -1] = 1.0 - pv[..., :-1].sum(axis=-1)
        n_arr = np.asarray(n)
        shape = tuple(shape) if shape is not None else tuple(n_arr.shape)
        out_dtype = array_utils.to_torch_dtype(dtype or np.int64)
        full = (shape + pv.shape[-1:]) if (shape or n_arr.shape) else None
        data = random_ops.jr_multinomial(
            self._next_key(), self._tensor(n_arr, np.float64),
            self._tensor(pv), full, self._device,
        ).to(out_dtype)
        if data.ndim == 0:
            data = data.reshape(1)
        return self._wrap(data, block_shape)

    def choice(self, a, shape=None, block_shape=None, replace=True, p=None):
        shape = tuple(shape) if shape is not None else ()
        if isinstance(a, BlockArray):
            pool = a.data
        elif isinstance(a, (int, np.integer)):
            pool = int(a)
        else:
            pool = self._tensor(a)
        pt = self._tensor(p) if p is not None else None
        data = random_ops.jr_choice(
            self._next_key(), pool, shape, replace, pt, self._device,
            self._x64)
        return self._wrap(data, block_shape)

    def shuffle(self, x: BlockArray) -> None:
        """IN PLACE along axis 0 (numpy Generator.shuffle contract).
        Rows are permuted whole: the index order is that of
        ``permutation(len(x))`` under the same key."""
        order = random_ops.permutation(self._next_key(), x.shape[0],
                                       self._device)
        x._store(x.data[order])

    def permutation(self, size, block_size=None):
        """A random permutation of ``range(size)`` as int64."""
        grid = self._grid((size,), (block_size or size,), "int64")
        data = random_ops.permutation(self._next_key(), int(size),
                                      self._device)
        return BlockArray(data, grid, self._backend)
