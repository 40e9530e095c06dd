"""``nums_tpu_torch.numpy.random`` against ``nums_tpu.numpy.random``: every
name the reference exports exists in the port, and after the same
``seed`` the same calls draw the same values (exact for ``random``,
``randint``, ``permutation``, ``choice``, ``shuffle`` and the integer
routes; otherwise within the tolerances of tests/test_torch_random.py,
whose classes these cases name). The ``np.random`` coverage count (53
names in the reference) is taken by a test of the port's own.
"""

import inspect

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    assert_draw_class as _assert_class, jax_app, torch_app,
)

import nums_tpu.numpy.random as jnr
import nums_tpu_torch.numpy as tnps
import nums_tpu_torch.numpy.random as tnr

PUBLIC = sorted(n for n in dir(jnr) if not n.startswith("_"))


@pytest.mark.parametrize("name", PUBLIC)
def test_every_exported_name_exists(name):
    assert hasattr(tnr, name), name
    ref, got = getattr(jnr, name), getattr(tnr, name)
    assert callable(got) == callable(ref)
    assert inspect.isclass(got) == inspect.isclass(ref)


def test_numpy_random_coverage_floor():
    """The count ``nums_tpu/cmds/api_coverage.py`` takes for numpy.random:
    public callables of ``np.random`` that are not classes, ``test``
    aside."""
    names = [
        n for n in sorted(dir(np.random))
        if not n.startswith("_") and n != "test"
        and callable(getattr(np.random, n))
        and not inspect.isclass(getattr(np.random, n))
    ]
    have = [n for n in names if getattr(tnr, n, None) is not None]
    assert len(names) == 53, len(names)
    assert have == names
    assert tnps.random is tnr


# (function, args, kwargs, class)
CALLS = [
    ("random", (), {"size": (40, 3)}, "exact"),
    ("random_sample", (), {"size": 25}, "exact"),
    ("sample", (), {"size": 5}, "exact"),
    ("ranf", (), {"size": 5}, "exact"),
    ("rand", (6, 4), {}, "exact"),
    ("randn", (50, 2), {}, "ulp"),
    ("randint", (3, 90), {"size": (30,)}, "exact"),
    ("randint", (7,), {"size": 12}, "exact"),
    ("random_integers", (1, 6), {"size": 30}, "exact"),
    ("uniform", (-1.0, 4.0), {"size": (30,)}, "ulp"),
    ("normal", (2.0, 0.5), {"size": (30,)}, "ulp"),
    ("standard_normal", (), {"size": 20}, "ulp"),
    ("standard_exponential", (), {"size": 20}, "ulp"),
    ("standard_gamma", (3.0,), {"size": 200}, "looped"),
    ("permutation", (40,), {}, "exact"),
    ("choice", (30,), {"size": 8, "replace": False}, "exact"),
    ("choice", (5,), {"size": 8, "p": [0.1, 0.2, 0.3, 0.2, 0.2]}, "exact"),
    ("multivariate_normal", ([0.0, 1.0], [[1.0, 0.2], [0.2, 2.0]]),
     {"size": 50}, "looped"),
    ("dirichlet", ([1.0, 2.0, 3.0],), {"size": 50}, "looped"),
    ("multinomial", (30, [0.2, 0.5, 0.3]), {"size": 40}, "looped"),
    ("beta", (2.0, 3.0), {"size": 200}, "looped"),
    ("binomial", (20, 0.3), {"size": 200}, "looped"),
    ("chisquare", (3.0,), {"size": 200}, "looped"),
    ("exponential", (2.0,), {"size": 50}, "ulp"),
    ("f", (5.0, 7.0), {"size": 200}, "looped"),
    ("gamma", (2.0, 2.0), {"size": 200}, "looped"),
    ("geometric", (0.3,), {"size": 200}, "looped"),
    ("gumbel", (0.0, 1.0), {"size": 50}, "ulp"),
    ("hypergeometric", (20, 10, 10), {"size": 50}, "exact"),
    ("laplace", (0.0, 1.0), {"size": 50}, "ulp"),
    ("logistic", (0.0, 1.0), {"size": 50}, "ulp"),
    ("lognormal", (0.0, 0.5), {"size": 50}, "ulp"),
    ("logseries", (0.5,), {"size": 200}, "looped"),
    ("negative_binomial", (5, 0.4), {"size": 3000}, "negative_binomial"),
    ("noncentral_chisquare", (4.0, 2.0), {"size": 200}, "looped"),
    ("noncentral_f", (5.0, 7.0, 2.0), {"size": 200}, "looped"),
    ("pareto", (3.0,), {"size": 50}, "ulp"),
    ("poisson", (3.0,), {"size": 200}, "looped"),
    ("power", (3.0,), {"size": 50}, "ulp"),
    ("rayleigh", (1.0,), {"size": 50}, "ulp"),
    ("standard_cauchy", (), {"size": 50}, "ulp"),
    ("standard_t", (5.0,), {"size": 200}, "looped"),
    ("triangular", (0.0, 0.5, 1.0), {"size": 50}, "ulp"),
    ("vonmises", (0.5, 1.0), {"size": 200}, "angle"),
    ("wald", (1.0, 1.0), {"size": 200}, "looped"),
    ("weibull", (2.0,), {"size": 50}, "ulp"),
    ("zipf", (3.0,), {"size": 200}, "looped"),
]


@pytest.mark.parametrize(
    "name,args,kwargs,cls", CALLS,
    ids=[f"{c[0]}-{i}" for i, c in enumerate(CALLS)])
def test_module_function_draws_the_reference_values(jax_app, torch_app, name,
                                                    args, kwargs, cls):
    jnr.seed(99)
    tnr.seed(99)
    jnr.random(size=3)
    tnr.random(size=3)
    ref = getattr(jnr, name)(*args, **kwargs)
    got = getattr(tnr, name)(*args, **kwargs)
    assert got.shape == ref.shape and got.block_shape == ref.block_shape
    _assert_class(cls, got.get(), np.asarray(ref.get()), "float64")
    assert jnr.get_state() == tnr.get_state()


def test_every_sampling_name_is_exercised():
    skipped = {"BlockArray", "Generator", "RandomState",
               "ThreeFryBitGenerator", "bytes", "default_rng",
               "get_bit_generator", "get_state", "seed", "set_bit_generator",
               "set_state", "shuffle"}
    assert set(PUBLIC) - skipped == {c[0] for c in CALLS}


def test_shuffle_and_permutation_of_an_array(jax_app, torch_app):
    x = np.arange(36, dtype=np.float64).reshape(12, 3)
    jx = jax_app.array(x, block_shape=(4, 3))
    tx = torch_app.array(x, block_shape=(4, 3))
    jnr.seed(5)
    tnr.seed(5)
    ref, got = jnr.permutation(jx), tnr.permutation(tx)
    assert got.block_shape == ref.block_shape
    assert np.array_equal(got.get(), np.asarray(ref.get()))
    assert np.array_equal(tx.get(), x)  # a new array: x is untouched
    assert tnr.shuffle(tx) is None and jnr.shuffle(jx) is None
    assert np.array_equal(tx.get(), np.asarray(jx.get()))
    assert not np.array_equal(tx.get(), x)


def test_generator_style_surface(jax_app, torch_app):
    jg, tg = jnr.default_rng(31), tnr.default_rng(31)
    assert isinstance(tg, tnr.Generator) and tnr.Generator is tnr.RandomState
    assert np.array_equal(tg.integers(0, 50, size=(20,)).get(),
                          np.asarray(jg.integers(0, 50, size=(20,)).get()))
    assert np.array_equal(tg.random(size=7).get(),
                          np.asarray(jg.random(size=7).get()))
    # state: dict and BitGenerator-shaped handle, both ways
    state = jg.get_state()
    assert state == tg.get_state()
    bitgen = tg.get_bit_generator()
    assert isinstance(bitgen, tnr.ThreeFryBitGenerator)
    assert bitgen.state == state
    other = tnr.RandomState(1)
    other.set_bit_generator(bitgen)
    assert np.array_equal(other.random(size=9).get(),
                          np.asarray(jg.random(size=9).get()))
    third = tnr.RandomState(2)
    third.set_state(jnr.ThreeFryBitGenerator(state).state)
    assert np.array_equal(third.random(size=9).get(),
                          tg.random(size=9).get())
    jnr.seed(8)
    tnr.seed(8)
    assert tnr.bytes(16) == jnr.bytes(16)


def test_random_state_rebinds_to_a_new_application(torch_app):
    from nums_tpu_torch.core import application_manager

    rs = tnr.RandomState(4)
    first = rs.random(size=5).get()
    bound = rs.rs()
    fresh = application_manager.create(device="cpu")
    application_manager.set_instance(fresh)
    try:
        assert rs.rs() is not bound and rs.rs()._backend is fresh.backend
        assert np.array_equal(rs.random(size=5).get(), first)  # reseeded
    finally:
        application_manager.set_instance(torch_app)
