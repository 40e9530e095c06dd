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

from nums_tpu_torch.core import multiprocess
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

    def _placed(self, data, grid, box):
        """A draw as a BlockArray of ``grid``: on the mesh ``data`` is this
        process's ``box`` of it."""
        if box is not None:
            data = self._backend.from_local(
                data, grid.shape, self._backend.sharding_for_grid(grid))
        return BlockArray(data, grid, self._backend)

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
            box = self._backend.local_region(grid)
            data = random_ops.hypergeometric(
                self._next_key(), grid.shape,
                array_utils.to_torch_dtype(dtype), self._device, nsample,
                ngood, nbad, region=box,
            )
            return self._placed(data, grid, box)
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
        cov = cov.to(mean.dtype)
        shape = tuple(shape) if shape is not None else ()
        tdt = array_utils.to_torch_dtype(dtype)
        n = int(mean.shape[-1])
        full = tuple(torch.broadcast_shapes(
            tuple(mean.shape), tuple(cov.shape[:-1]), shape + (n,)))
        if self._backend.mesh is None or full != shape + (n,):
            # (a batch of means or covariances beyond ``shape`` broadcasts
            # one draw of ``shape``: drawn whole, each process keeps its
            # box)
            data = random_ops.jr_multivariate_normal(
                self._next_key(), mean, cov, shape, tdt, self._device)
            return self._wrap(data, block_shape)
        grid = self._grid(full, block_shape, array_utils.to_dtype_name(
            torch.promote_types(mean.dtype, tdt)))
        box = self._backend.local_region(grid)
        data = random_ops.jr_multivariate_normal(
            self._next_key(), mean, cov, shape, tdt, self._device,
            region=box)
        return self._placed(data, grid, box)

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
        return self._placed(data, grid, box)

    def multinomial(self, n, pvals, shape=None, block_shape=None, dtype=None):
        """One binomial per category on the trials that remain, under the
        call's counter-derived key: same-seed determinism under any block
        shape, like every other distribution here. On the mesh each
        process draws its own rows (over every category).

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
        full = (shape + pv.shape[-1:]) if (shape or n_arr.shape) \
            else tuple(pv.shape)
        grid = self._grid(full, block_shape,
                          array_utils.to_dtype_name(out_dtype))
        box = self._backend.local_region(grid)
        data = random_ops.jr_multinomial(
            self._next_key(), self._tensor(n_arr, np.float64),
            self._tensor(pv), full, self._device,
            region=box).to(out_dtype)
        return self._placed(data, grid, box)

    def choice(self, a, shape=None, block_shape=None, replace=True, p=None):
        """``jax.random.choice`` along axis 0; on the mesh, where the pool
        or the result is sharded, drawn by the result's shards
        (``_mesh_choice``)."""
        from nums_tpu_torch.core.ops import mesh_ops

        shape = tuple(shape) if shape is not None else ()
        if isinstance(a, BlockArray):
            pool = a.data
        elif isinstance(a, (int, np.integer)):
            pool = int(a)
        else:
            pool = self._tensor(a)
        pt = self._tensor(p) if p is not None else None
        if self._backend.mesh is not None and random_ops._size(shape):
            tail = () if isinstance(pool, int) else tuple(pool.shape[1:])
            dtype = random_ops._default_int(self._x64) \
                if isinstance(pool, int) else pool.dtype
            grid = self._grid(shape + tail, block_shape,
                              array_utils.to_dtype_name(dtype))
            if mesh_ops._is_sharded(pool) or any(
                    q.is_shard()
                    for q in self._backend.sharding_for_grid(grid)):
                return self._mesh_choice(self._next_key(), pool, shape,
                                         grid, replace, pt)
        if mesh_ops.is_dtensor(pool):
            pool = pool.to_local()
        data = random_ops.jr_choice(
            self._next_key(), pool, shape, replace, pt, self._device,
            self._x64)
        return self._wrap(data, block_shape)

    def _mesh_choice(self, key, pool, shape, grid, replace, p):
        """``choice`` on the mesh into ``grid``, of a sharded pool or into
        a sharded result: each process draws the positions of its own
        rows of the result as ``jr_choice`` does (a ``randint``, the ``p``
        route's ``searchsorted``, or its part of the sharded permutation
        or Gumbel top k), then pulls those rows of a sharded pool from
        their holders (``mesh_ops.pull``). Bit for bit the serial draw."""
        from nums_tpu_torch.core.ops import mesh_ops

        backend = self._backend
        lead = len(shape)
        sharded_pool = mesh_ops._is_sharded(pool)
        n_inputs = pool if isinstance(pool, int) else int(pool.shape[0])
        n_draws = random_ops._size(shape)
        full = grid.shape
        int_dtype = random_ops._default_int(self._x64)
        want = backend.sharding_for_grid(grid)
        if p is not None and not p.is_floating_point():
            p = p.to(random_ops._wide(self._x64))
        random_ops.choice_checks(n_inputs, n_draws, replace, p)
        # the layout the rows are pulled in: the pool's on its columns,
        # the result's on the draws' axes
        if sharded_pool:
            layout = tuple(
                mesh_ops._shard(q.dim + lead - 1) if q.is_shard() and q.dim
                else w if w.is_shard() and w.dim < lead
                else mesh_ops._replicate()
                for q, w in zip(pool.placements, want))
        else:
            layout = want
        coords = backend.coords()

        def where_of(coord):
            box = backend.region(full, layout, coord)[:lead]
            if 0 in tuple(b - a for a, b in box):
                return None
            return random_ops.region_where(shape, box, self._device)

        where = where_of(None)
        box = backend.region(full, layout)
        ind = None if where is None else random_ops.choice_positions(
            key, n_inputs, shape, replace, p, self._device, self._x64,
            where)
        if not replace:
            fs = mesh_ops.full_shard(backend)
            if p is None:
                source = random_ops.mesh_permutation(backend, key, n_inputs)
            else:
                lo, hi = backend.region((n_inputs,), fs)[0]
                g = random_ops.choice_gumbel(key, n_inputs, p, self._device,
                                             (lo, hi))
                source = random_ops.mesh_top_k(
                    backend, backend.from_local(g, (n_inputs,), fs), n_draws)

            def wants(coord):
                w = where_of(coord)
                if w is None:
                    return torch.empty((0, 1), dtype=torch.int64)
                return random_ops._region_positions(w, "cpu").reshape(-1, 1)

            ind = mesh_ops.pull(backend, source, 1, wants(
                coords[multiprocess.process_index()]),
                lambda r: wants(coords[r])).reshape(-1)
        if ind is None:
            ind = torch.empty(0, dtype=torch.int64, device=self._device)
        lead_shape = tuple(b - a for a, b in box[:lead])
        if isinstance(pool, int):
            local = ind.to(int_dtype).reshape(lead_shape)
        elif sharded_pool:
            local = mesh_ops.pull(backend, pool, 1, ind.reshape(-1, 1))
            local = local.reshape(lead_shape + tuple(local.shape[1:]))
        else:
            local = pool[ind][(Ellipsis,) + tuple(
                slice(a, b) for a, b in box[lead:])]
        data = backend.from_local(local.contiguous(), full, layout)
        return BlockArray(backend.rebox(data, want), grid, backend)

    def shuffle(self, x: BlockArray) -> None:
        """IN PLACE along axis 0 (numpy Generator.shuffle contract).
        Rows are permuted whole: the index order is that of
        ``permutation(len(x))`` under the same key. On the mesh, of an
        array whose rows are sharded, the order is the sharded permutation
        and each process pulls its rows from their holders (one
        ``mesh_ops.pull``): x keeps its layout (the reference's leaves
        the result replicated)."""
        from nums_tpu_torch.core.ops import mesh_ops

        key = self._next_key()
        data = x.data
        if mesh_ops.is_dtensor(data) and mesh_ops.shard_dims(
                data.placements, (0,)):
            backend = self._backend
            n = int(x.shape[0])
            perm = random_ops.mesh_permutation(backend, key, n)
            shape, pl = tuple(data.shape), tuple(data.placements)
            coords = backend.coords()

            def rows(coord):
                a, b = backend.region(shape, pl, coord)[0]
                return torch.arange(a, b, dtype=torch.int64).reshape(-1, 1)

            order = mesh_ops.pull(backend, perm, 1, rows(
                coords[multiprocess.process_index()]),
                lambda r: rows(coords[r]))
            del perm
            local = mesh_ops.pull(backend, data, 1, order.reshape(-1, 1))
            x._store(backend.from_local(local, shape, pl))
            return
        order = random_ops.permutation(key, x.shape[0], self._device)
        if mesh_ops.is_dtensor(data):
            # the rows whole on each process (a column shard at most)
            x._store(mesh_ops.like(data, data.to_local()[order]))
            return
        x._store(data[order])

    def permutation(self, size, block_size=None):
        """A random permutation of ``range(size)`` as int64; on the mesh,
        of a sharded grid, sorted by the mesh's sample sort
        (``random_ops.mesh_permutation``)."""
        grid = self._grid((size,), (block_size or size,), "int64")
        key = self._next_key()
        box = self._backend.local_region(grid)
        if box is not None and box != ((0, int(size)),):
            data = random_ops.mesh_permutation(self._backend, key, int(size))
            data = self._backend.rebox(
                data, self._backend.sharding_for_grid(grid))
            return BlockArray(data, grid, self._backend)
        data = random_ops.permutation(key, int(size), self._device)
        return BlockArray(data, grid, self._backend)
