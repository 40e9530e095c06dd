"""np.random-compatible surface.

Counterpart of ``nums_tpu/numpy/random.py``, name for name: the module
functions draw from one default ``RandomState``, which binds to the
current application's ``NumsRandomState`` (threefry2x32 counters,
``core/ops/threefry.py``) and rebinds when the application is recreated.
The same seed and call order draw the reference's values.
"""

import numpy as _np

from nums_tpu_torch.core.application_manager import instance as _instance
from nums_tpu_torch.core.array.blockarray import BlockArray


class RandomState:
    def __init__(self, seed=None):
        self._seed = seed
        self._rs = None

    def rs(self):
        app = _instance()
        # Rebind if the application (and its backend) was recreated.
        if self._rs is None or self._rs._backend is not app.backend:
            self._rs = app.random_state(self._seed)
        return self._rs

    def seed(self, _seed):
        self._seed = _seed
        self._rs = None

    def _get_shapes(self, size=None, dtype=None):
        if dtype is None:
            dtype = _np.float64
        if size is None:
            size = ()
        if not isinstance(size, tuple):
            assert isinstance(size, (int, _np.integer))
            shape = (size,)
        else:
            shape = size
        block_shape = _instance().get_block_shape(shape, dtype)
        return shape, block_shape

    def random_sample(self, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().random(shape=shape, block_shape=block_shape)

    random = random_sample

    def rand(self, *shape):
        shape, block_shape = self._get_shapes(shape, _np.float64)
        return self.rs().random(shape=shape, block_shape=block_shape)

    def randn(self, *shape):
        shape, block_shape = self._get_shapes(shape, _np.float64)
        return self.rs().normal(shape=shape, block_shape=block_shape)

    def randint(self, low, high=None, size=None, dtype=None):
        if high is None:
            high = low
            low = 0
        shape, block_shape = self._get_shapes(size, dtype)
        return self.rs().integers(
            low, high, shape=shape, block_shape=block_shape
        )

    def uniform(self, low=0.0, high=1.0, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().uniform(
            low, high, shape=shape, block_shape=block_shape
        )

    def normal(self, loc=0.0, scale=1.0, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().normal(
            loc, scale, shape=shape, block_shape=block_shape
        )

    def standard_normal(self, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().standard_normal(shape=shape, block_shape=block_shape)

    def standard_exponential(self, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().standard_exponential(
            shape=shape, block_shape=block_shape
        )

    def standard_gamma(self, k, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return self.rs().standard_gamma(
            k, shape=shape, block_shape=block_shape
        )

    def multivariate_normal(self, mean, cov, size=None):
        shape = (size,) if isinstance(size, (int, _np.integer)) else size
        return self.rs().multivariate_normal(mean, cov, shape=shape)

    def dirichlet(self, alpha, size=None):
        shape = (size,) if isinstance(size, (int, _np.integer)) else size
        return self.rs().dirichlet(alpha, shape=shape)

    def multinomial(self, n, pvals, size=None):
        shape = (size,) if isinstance(size, (int, _np.integer)) else size
        return self.rs().multinomial(n, pvals, shape=shape)

    def choice(self, a, size=None, replace=True, p=None):
        shape = (size,) if isinstance(size, (int, _np.integer)) else size
        return self.rs().choice(a, shape=shape, replace=replace, p=p)

    def shuffle(self, x):
        # In place along axis 0, like np.random.shuffle.
        self.rs().shuffle(x)

    def permutation(self, x):
        app = _instance()
        if isinstance(x, (int, _np.integer)):
            shape = (x,)
            block_shape = app.compute_block_shape(shape, _np.int64)
            return self.rs().permutation(shape[0], block_shape[0])
        assert isinstance(x, BlockArray)
        # The integer row gather takes the index array on the device.
        return x[self.rs().permutation(x.shape[0], x.block_shape[0])]


# The full distribution zoo, surfaced module-style like np.random.*
# (backed by the NumsRandomState distribution set,
# nums_tpu_torch/core/array/random.py).
_DIST_NAMES = [
    "beta", "binomial", "chisquare", "exponential", "f", "gamma",
    "geometric", "gumbel", "hypergeometric", "laplace", "logistic",
    "lognormal", "logseries", "negative_binomial", "noncentral_chisquare",
    "noncentral_f", "pareto", "poisson", "power", "rayleigh",
    "standard_cauchy", "standard_t", "triangular", "vonmises", "wald",
    "weibull", "zipf",
]


def _make_dist_method(name):
    def method(self, *args, size=None):
        shape, block_shape = self._get_shapes(size, _np.float64)
        return getattr(self.rs(), name)(
            *args, shape=shape, block_shape=block_shape
        )

    method.__name__ = name
    method.__doc__ = f"Sample from the {name} distribution (np.random API)."
    return method


for _name in _DIST_NAMES:
    setattr(RandomState, _name, _make_dist_method(_name))


_default_random = RandomState()
seed = _default_random.seed
random_sample = _default_random.random_sample
# Legacy np.random aliases.
sample = _default_random.random_sample
ranf = _default_random.random_sample


def random_integers(low, high=None, size=None):
    # Legacy inclusive-range API: randint over [low, high].
    if high is None:
        low, high = 1, low
    return _default_random.randint(low, high + 1, size=size)


# Generator-style API: RandomState implements the overlapping surface;
# `integers` is the Generator spelling of randint.
RandomState.integers = RandomState.randint
Generator = RandomState


def default_rng(seed=None):
    return RandomState(seed)


def bytes(length):  # noqa: A001 - numpy-compatible name
    """Random bytes (host-side; parity with np.random.bytes)."""
    return _default_random.rs().numpy().bytes(length)


class ThreeFryBitGenerator:
    """BitGenerator-shaped handle for the counter-based threefry engine.

    The engine is not MT19937, so np's legacy state tuple doesn't apply;
    ``state`` is the (seed, counter) pair that reproduces the stream
    exactly on any backend and under any block shape.
    """

    def __init__(self, state):
        self.state = dict(state)


def _rs_get_state(self, legacy=True):
    del legacy
    return self.rs().get_state()


def _rs_set_state(self, state):
    if isinstance(state, ThreeFryBitGenerator):
        state = state.state
    self.rs().set_state(state)
    self._seed = state["seed"]


def _rs_get_bit_generator(self):
    return ThreeFryBitGenerator(self.rs().get_state())


def _rs_set_bit_generator(self, bitgen):
    self._rs_set_state_impl(bitgen)


RandomState.get_state = _rs_get_state
RandomState.set_state = _rs_set_state
RandomState._rs_set_state_impl = _rs_set_state
RandomState.get_bit_generator = _rs_get_bit_generator
RandomState.set_bit_generator = _rs_set_bit_generator

get_state = _default_random.get_state
set_state = _default_random.set_state
get_bit_generator = _default_random.get_bit_generator
set_bit_generator = _default_random.set_bit_generator
random = _default_random.random
rand = _default_random.rand
randn = _default_random.randn
randint = _default_random.randint
uniform = _default_random.uniform
normal = _default_random.normal
permutation = _default_random.permutation

for _name in _DIST_NAMES + [
    "standard_normal", "standard_exponential", "standard_gamma",
    "multivariate_normal", "dirichlet", "multinomial", "choice", "shuffle",
]:
    globals()[_name] = getattr(_default_random, _name)
del _name
