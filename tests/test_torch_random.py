"""The port's random layer against nums_tpu: same seed, same call order,
same values.

Both packages draw on threefry2x32 counters (the port's engine is
``nums_tpu_torch/core/ops/threefry.py``), so every comparison here is on
VALUES, in three classes:

* exact (``np.array_equal``): the engine against ``jax._src.prng``, raw
  bits, ``random``, ``integers``, ``permutation``, ``shuffle``,
  ``choice`` without weights, both ``hypergeometric`` routes;
* one transcendental on an exact uniform (``uniform``, ``normal``,
  ``exponential``, ...): ``|got - ref| <= rtol*|ref| + atol*max|ref|``
  with rtol = atol = 1e-12 in float64 and 2e-6 / 1e-6 in float32 (torch's
  ``erfinv``/``log`` are not XLA's polynomials: a few ulp), on every
  element;
* the looped and rejection samplers (``gamma`` and what rides on it,
  ``poisson``, ``binomial``, ``zipf``, ...) and those with a ``floor`` on a
  rounded value (``geometric``, ``logseries``): rtol = atol = 1e-5, and at
  most 1e-3 of the elements may differ by more (an accept test or a floor
  that sits on a rounded value can flip). ``vonmises`` is held so on the
  cosine of its angle: ``arccos`` near 1 magnifies one ulp of its argument
  without bound, so the angle itself is held to 1e-3;
* ``negative_binomial`` to its law and, step by step, to the reference:
  its gamma rates agree, but its Poisson step runs both of jax's branches
  over the whole array, the Knuth elements with a placeholder rate of 1e5
  whose float32 accept test (``k log(lam) - lgamma(k+1)`` near 1e6, one
  ulp is 0.06) flips on a one-ulp difference in ``log``; one flip changes
  the number of rounds, and a later accept overwrites an earlier one, so
  every element of the rejection branch can change with it.

nums_tpu runs on the CPU with 64-bit types on (tests/conftest.py), which a
CPU backend of the port reproduces; the reference's accelerator mode
(64-bit types off) is reproduced by a CUDA backend, and is held here at
the op level with ``x64=False`` against jax under ``enable_x64(False)``.
Moment tolerances are 6 standard errors of the estimate at the sample size
used.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from jax._src import prng

from torch_parity import (  # noqa: F401
    assert_draw_class as _assert_class, draw_mismatch as _mismatch, jax_app,
    torch_app,
)

from nums_tpu.core.ops import random_ops as jrandom_ops
from nums_tpu_torch.core.ops import random_ops, threefry

REPO = pathlib.Path(__file__).resolve().parents[1]


def _u32(t):
    return t.numpy().view(np.uint32)


# ----------------------------------------------------------------------
# The engine against jax._src.prng
# ----------------------------------------------------------------------

RANDOM123 = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,want", RANDOM123)
def test_threefry_random123_vectors(key, ctr, want):
    assert threefry.threefry2x32_ints(*key, *ctr) == want
    c = [torch.tensor([threefry._signed(w)], dtype=torch.int32) for w in ctr]
    w0, w1 = threefry.threefry2x32(key[0], key[1], c[0], c[1])
    assert (int(_u32(w0)[0]), int(_u32(w1)[0])) == want
    # ... and as jax's primitive computes them
    ref = prng.threefry2x32_p.bind(*(jnp.uint32(w) for w in key + ctr))
    assert tuple(int(r) for r in ref) == want
    # tensor keys (the batched path) give the same words
    k = [torch.tensor([threefry._signed(w)], dtype=torch.int32) for w in key]
    b0, b1 = threefry.threefry2x32(k[0], k[1], c[0], c[1])
    assert (int(_u32(b0)[0]), int(_u32(b1)[0])) == want


@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 + 5, 2**62, 2**63 - 1,
                                  -1, -5])
@pytest.mark.parametrize("x64", [True, False])
def test_seed_key_matches_jax(seed, x64):
    with jax.enable_x64(x64):
        ref = tuple(int(w) for w in jr.key_data(jr.key(seed)))
    assert threefry.seed_key(seed, x64) == ref
    if not x64:
        assert ref[0] == 0  # only the low word enters the key


@pytest.mark.parametrize("seed", [2**63, 2**64 + 1, -(2**63) - 1])
def test_seed_key_out_of_range_raises_like_jax(seed):
    with pytest.raises(OverflowError):
        jr.key(seed)
    with pytest.raises(OverflowError):
        threefry.seed_key(seed, True)


def test_fold_in_and_split_match_jax():
    key = threefry.seed_key(7, True)
    assert threefry.fold_in(key, 1) == (195045567, 4062205631)
    jkey = jr.key(7)
    for n in (0, 1, 2**31, 2**32 - 1):
        assert threefry.fold_in(key, n) == tuple(
            int(w) for w in jr.key_data(jr.fold_in(jkey, n)))
    ref = np.asarray(jr.key_data(jr.split(jkey, 5)))
    assert threefry.split(key, 5) == [tuple(int(w) for w in r) for r in ref]
    # the batched forms: split over a shape, then each element's own split
    k0, k1 = threefry.split_keys(key, 5, "cpu")
    assert np.array_equal(_u32(k0), ref[:, 0])
    assert np.array_equal(_u32(k1), ref[:, 1])
    sub = threefry.split_batched((k0, k1), 3)
    ref2 = np.asarray(jr.key_data(
        jax.vmap(lambda q: jr.split(q, 3))(jr.split(jkey, 5))))
    for i in range(3):
        assert np.array_equal(_u32(sub[i][0]), ref2[:, i, 0])
        assert np.array_equal(_u32(sub[i][1]), ref2[:, i, 1])
    bits = threefry.bits_batched((k0, k1), 64).numpy().view(np.uint64)
    assert np.array_equal(bits, np.asarray(
        jax.vmap(lambda q: jr.bits(q, (), "uint64"))(jr.split(jkey, 5))))


@pytest.mark.parametrize("width,dtype", [(8, "uint8"), (16, "uint16"),
                                         (32, "uint32"), (64, "uint64")])
def test_random_bits_match_jax_whatever_the_chunk(width, dtype):
    seed = 2**32 + 5
    key, jkey = threefry.seed_key(seed, True), jr.key(seed)
    ref = np.asarray(jr.bits(jkey, (7, 13), dtype))
    for chunk in (None, 1, 5, 64):
        got = threefry.random_bits(key, (7, 13), width, chunk=chunk)
        assert np.array_equal(got.numpy().view(ref.dtype), ref)
    part = threefry.random_bits(key, (7, 13), width, start=17, stop=40)
    assert np.array_equal(part.numpy().view(ref.dtype), ref.reshape(-1)[17:40])
    with pytest.raises(TypeError):
        threefry.random_bits(key, (3,), 12)


@pytest.mark.parametrize("start", [2**31 - 3, 2**32 - 3, 2**32 + 12345,
                                   9_999_999_990])
def test_high_counter_word(start):
    """Positions around and beyond 2**32 of a virtual 10M x 1000 draw
    against ``threefry2x32_p`` at the counters (i >> 32, i & 0xffffffff):
    the 10 GB array is never made."""
    seed = 11
    key = threefry.seed_key(seed, True)
    k0, k1 = jr.key_data(jr.key(seed))
    got = threefry.random_bits(key, (10_000_000, 1000), 32, start=start,
                               stop=start + 8, chunk=3)
    idx = np.arange(start, start + 8, dtype=np.uint64)
    b0, b1 = prng.threefry2x32_p.bind(
        k0, k1, jnp.asarray((idx >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)))
    assert np.array_equal(_u32(got), np.asarray(b0 ^ b1))
    if start >= 2**32:
        assert int((idx >> np.uint64(32))[0]) >= 1


# ----------------------------------------------------------------------
# NumsRandomState against nums_tpu's, method by method
# ----------------------------------------------------------------------

N = (3000,)

# (method, args, class)
DISTS = [
    ("random", (), "exact"),
    ("uniform", (-2.0, 3.5), "ulp"),
    ("normal", (1.0, 2.0), "ulp"),
    ("standard_normal", (), "ulp"),
    ("exponential", (2.0,), "ulp"),
    ("standard_exponential", (), "ulp"),
    ("gumbel", (0.5, 2.0), "ulp"),
    ("laplace", (0.5, 2.0), "ulp"),
    ("logistic", (0.5, 2.0), "ulp"),
    ("lognormal", (0.1, 0.5), "ulp"),
    ("pareto", (3.0,), "ulp"),
    ("power", (2.5,), "ulp"),
    ("weibull", (1.5,), "ulp"),
    ("rayleigh", (2.0,), "ulp"),
    ("standard_cauchy", (), "ulp"),
    ("triangular", (-1.0, 0.5, 2.0), "ulp"),
    ("geometric", (0.3,), "looped"),
    ("logseries", (0.6,), "looped"),
    ("vonmises", (0.5, 2.0), "angle"),
    ("zipf", (2.5,), "looped"),
    ("gamma", (2.5, 1.5), "looped"),
    ("gamma", (0.3, 1.0), "looped"),
    ("standard_gamma", (4.0,), "looped"),
    ("chisquare", (3.0,), "looped"),
    ("chisquare", (0.5,), "looped"),
    ("beta", (2.0, 3.0), "looped"),
    ("f", (5.0, 7.0), "looped"),
    ("standard_t", (5.0,), "looped"),
    ("wald", (1.5, 2.0), "looped"),
    ("negative_binomial", (5.0, 0.4), "negative_binomial"),
    ("poisson", (4.0,), "looped"),
    ("poisson", (50.0,), "looped"),
    ("binomial", (20, 0.3), "looped"),
    ("binomial", (200, 0.4), "looped"),
    ("binomial", (50, 0.8), "looped"),
    ("noncentral_chisquare", (3.0, 2.0), "looped"),
    ("noncentral_chisquare", (0.5, 2.0), "looped"),
    ("noncentral_f", (5.0, 7.0, 2.0), "looped"),
    ("hypergeometric", (20, 10, 10), "exact"),
]
_IDS = [f"{d[0]}-{'-'.join(str(a) for a in d[1])}" for d in DISTS]


@pytest.mark.parametrize("dtype", [None, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name,args,cls", DISTS, ids=_IDS)
def test_distribution_draws_the_reference_values(jax_app, torch_app, name,
                                                 args, cls, dtype):
    """Second call of a stream (so the counter and ``fold_in`` are in the
    comparison), odd block shape on the port's side."""
    jrs, trs = jax_app.random_state(11), torch_app.random_state(11)
    jrs.random(shape=(3,))
    trs.random(shape=(3,))
    kw = {} if name == "hypergeometric" and dtype is not None else {
        "dtype": dtype}
    ref = getattr(jrs, name)(*args, shape=N, **kw)
    got = getattr(trs, name)(*args, shape=N, block_shape=(700,), **kw)
    assert got.block_shape == (700,) and got.shape == ref.shape
    dtype_name = np.dtype(dtype or np.float64).name
    _assert_class(cls, got.get(), np.asarray(ref.get()), dtype_name)
    assert jrs.get_state() == trs.get_state()


ACCEL = [d for d in DISTS if d[0] in jrandom_ops._DISTS]


@pytest.mark.parametrize("name,args,cls", ACCEL,
                         ids=[i for d, i in zip(DISTS, _IDS) if d in ACCEL])
def test_accelerator_mode_draws_the_reference_values(name, args, cls):
    """``x64=False``, float32: what a CUDA backend draws, against the
    reference's own table under jax with 64-bit types off. The seed's high
    word must not enter the key there."""
    seed = 2**32 + 5
    key = threefry.fold_in(threefry.seed_key(seed, False), 1)
    with jax.enable_x64(False):
        jkey = jr.fold_in(jr.key(seed), 1)
        # jitted as the reference's ``sample`` does: the parameters are
        # traced scalars, so their arithmetic happens at float32.
        ref = np.asarray(jax.jit(
            lambda k, *a: jrandom_ops._DISTS[name](k, N, jnp.float32, *a)
        )(jkey, *[float(a) for a in args]))
    got = random_ops.sample(name, key, N, torch.float32, "cpu", False,
                            *[float(a) for a in args]).numpy()
    _assert_class(cls, got, ref, "float32")


@pytest.mark.parametrize("low,high,dtype,endpoint", [
    (0, 1000, None, False),
    (5, 15, np.int64, True),
    (-7, 9, np.int32, False),
    (3, 9, np.int32, True),
    (0, 3_000_000_000, np.int64, False),
    (0, 2**62 + 12345, np.int64, False),
    (-(2**63), 2**63 - 1, np.int64, False),
    (0, 2**63 - 1, np.int64, True),
    (np.iinfo(np.int32).max - 2, np.iinfo(np.int32).max, np.int32, True),
    (0, 2**31 - 1, np.int32, True),
    (9, 3, np.int64, False),
    (4, 4, np.int32, False),
    (0, 200, np.int8, False),
    (0, 100, np.int16, True),
])
def test_integers_equal_the_reference(jax_app, torch_app, low, high, dtype,
                                      endpoint):
    jrs, trs = jax_app.random_state(6), torch_app.random_state(6)
    ref = jrs.integers(low, high, shape=(2000,), dtype=dtype,
                       endpoint=endpoint).get()
    got = trs.integers(low, high, shape=(2000,), block_shape=(300,),
                       dtype=dtype, endpoint=endpoint).get()
    assert got.dtype == ref.dtype
    assert np.array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("low,high,endpoint", [
    (0, 1000, False), (-5, 17, True), (0, 2**31 - 1, True), (9, 3, False),
    (-(2**31), 2**31 - 1, False),
])
def test_integers_accelerator_mode(low, high, endpoint):
    """An int64 request on a 32-bit backend draws through the 32-bit path
    and widens; a bound outside int32 raises."""
    key = threefry.fold_in(threefry.seed_key(3, False), 1)
    with jax.enable_x64(False):
        jkey = jr.fold_in(jr.key(3), 1)
        if endpoint:
            ref = np.asarray(jr.randint(jkey, (2000,), low - 1, high) + 1)
        else:
            ref = np.asarray(jr.randint(jkey, (2000,), low, high))
    assert ref.dtype == np.int32
    got = random_ops.integers(key, (2000,), torch.int64, "cpu", False, low,
                              high, endpoint)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    with pytest.raises(OverflowError):
        random_ops.integers(key, (4,), torch.int64, "cpu", False, 0, 2**40,
                            False)


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 70_000])
def test_permutation_equals_the_reference(jax_app, torch_app, n):
    ref = jax_app.random_state(5).permutation(n).get()
    got = torch_app.random_state(5).permutation(n, block_size=max(1, n // 3))
    assert got.dtype == np.int64
    assert np.array_equal(got.get(), np.asarray(ref))
    assert np.array_equal(np.sort(got.get()), np.arange(n))
    with jax.enable_x64(False):
        ref32 = np.asarray(jr.permutation(jr.fold_in(jr.key(5), 1), n))
    got32 = random_ops.permutation(
        threefry.fold_in(threefry.seed_key(5, False), 1), n, "cpu")
    assert np.array_equal(got32.numpy(), ref32)


@pytest.mark.parametrize("shape", [(12,), (9, 4), (5, 3, 2)])
def test_shuffle_equals_the_reference(jax_app, torch_app, shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    jx = jax_app.array(x, block_shape=shape)
    tx = torch_app.array(x, block_shape=shape)
    assert torch_app.random_state(11).shuffle(tx) is None
    jax_app.random_state(11).shuffle(jx)
    assert np.array_equal(tx.get(), np.asarray(jx.get()))
    assert sorted(map(tuple, tx.get().reshape(shape[0], -1))) == sorted(
        map(tuple, x.reshape(shape[0], -1)))


P4 = [0.1, 0.2, 0.3, 0.4]


@pytest.mark.parametrize("a,shape,replace,p,cls", [
    (10, (6,), True, None, "exact"),
    (10, (2, 3), True, None, "exact"),
    (10, (4,), False, None, "exact"),
    (1000, (1000,), False, None, "exact"),
    (4, (50,), True, P4, "exact"),
    (4, (3,), False, P4, "exact"),
    ([3.5, 1.5, 9.0, 2.0], (5,), True, None, "exact"),
    ([3.5, 1.5, 9.0, 2.0], (2,), False, P4, "exact"),
    ("block", (3,), False, None, "exact"),
    (10, (), True, None, "exact"),
])
def test_choice_equals_the_reference(jax_app, torch_app, a, shape, replace,
                                     p, cls):
    ja = ta = a
    if a == "block":
        x = np.arange(24, dtype=np.float64).reshape(8, 3)
        ja = jax_app.array(x, block_shape=(8, 3))
        ta = torch_app.array(x, block_shape=(8, 3))
    ref = jax_app.random_state(9).choice(ja, shape=shape, replace=replace,
                                         p=p).get()
    got = torch_app.random_state(9).choice(ta, shape=shape, replace=replace,
                                           p=p).get()
    _assert_class(cls, got, np.asarray(ref), "float64")


def test_choice_validation(torch_app):
    rs = torch_app.random_state(0)
    with pytest.raises(ValueError, match="larger sample"):
        rs.choice(3, shape=(5,), replace=False)
    with pytest.raises(ValueError, match="greater than 0"):
        rs.choice(0, shape=(5,))
    with pytest.raises(ValueError, match="same size"):
        rs.choice(3, shape=(2,), p=[0.5, 0.5])
    assert rs.choice(5, shape=(0,)).shape == (0,)


def test_multivariate_normal_dirichlet_multinomial(jax_app, torch_app):
    mean = [1.0, -2.0, 0.5]
    cov = [[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 0.5]]
    alpha = [0.5, 2.0, 3.0, 0.2]
    pvals = [0.2, 0.3, 0.1, 0.4]
    for dtype in (None, np.float32):
        jrs, trs = jax_app.random_state(21), torch_app.random_state(21)
        ref = jrs.multivariate_normal(mean, cov, shape=(500,), dtype=dtype)
        got = trs.multivariate_normal(mean, cov, shape=(500,), dtype=dtype)
        assert got.shape == ref.shape == (500, 3)
        _assert_class("looped", got.get(), np.asarray(ref.get()), "float64")
        ref = jrs.dirichlet(alpha, shape=(400,), dtype=dtype)
        got = trs.dirichlet(alpha, shape=(400,), dtype=dtype)
        assert got.shape == ref.shape == (400, 4)
        _assert_class("looped", got.get(), np.asarray(ref.get()), "float64")
        assert np.allclose(got.get().sum(axis=-1), 1.0, atol=1e-5)
    jrs, trs = jax_app.random_state(22), torch_app.random_state(22)
    for n, shape in ((20, None), (50, (300,)), (np.array([5, 500]), None)):
        ref = jrs.multinomial(n, pvals, shape=shape).get()
        got = trs.multinomial(n, pvals, shape=shape).get()
        _assert_class("looped", got, np.asarray(ref), "float64")
        assert (got.sum(axis=-1) == np.broadcast_to(
            n, got.shape[:-1])).all()
    assert jrs.get_state() == trs.get_state()


def test_multinomial_numpy_semantics(torch_app):
    """pvals validated on the host; the last category is the remainder."""
    rs = torch_app.random_state(1)
    for bad in ([0.5, 0.6, 0.1], [-0.1, 0.5, 0.6], [np.nan, 0.5, 0.5],
                [1.5, 0.0]):
        with pytest.raises(ValueError, match="pvals"):
            rs.multinomial(10, bad)
    counts = rs.multinomial(10_000, [0.2, 0.3, 0.0], shape=(4,)).get()
    assert counts.dtype == np.int64 and counts.shape == (4, 3)
    assert (counts.sum(axis=-1) == 10_000).all()
    assert abs(counts[:, 2].mean() - 5000) < 300  # 1 - 0.2 - 0.3


def test_negative_binomial_step_by_step():
    """Its two steps against jax's, each where it is robust: the gamma
    rates under the first sub-key, and the Poisson draw under the second
    on rates that all take one branch."""
    key, jkey = threefry.seed_key(4, True), jr.key(4)
    (t1, t2), (k1, k2) = threefry.split(key), jr.split(jkey)
    lam = jr.gamma(k1, 5.0, N, jnp.float32) * 1.5
    tlam = random_ops.jr_gamma(t1, N, torch.float32, "cpu", 5.0).mul_(1.5)
    assert _mismatch(tlam.numpy(), np.asarray(lam), 1e-5, 1e-5) == 0.0
    for scale in (0.4, 4.0):  # all below 10 (Knuth), all above (rejection)
        rates = np.clip(np.asarray(lam) * scale, None, 9.5) if scale < 1 \
            else np.asarray(lam) * scale + 10.0
        ref = np.asarray(jr.poisson(k2, jnp.asarray(rates), N))
        got = random_ops.jr_poisson(t2, N, "cpu", True,
                                    torch.from_numpy(np.array(rates)))
        assert got.dtype == torch.int64 and ref.dtype == np.int64
        assert _mismatch(got.numpy(), ref, 0.0, 0.0) <= 1e-3


def test_hypergeometric_both_routes(jax_app, torch_app):
    """The device chain (nsample <= 4096) and the host route beyond, which
    is numpy's generator on (seed, counter) in both packages: bitwise."""
    jrs, trs = jax_app.random_state(8), torch_app.random_state(8)
    g = b = 2**29  # above float32's exact integers, below numpy's 1e9 cap
    ref = jrs.hypergeometric(g, b, 64, shape=(500,))
    got = trs.hypergeometric(g, b, 64, shape=(500,), block_shape=(100,))
    assert got.dtype == np.int64 == ref.dtype
    assert np.array_equal(got.get(), np.asarray(ref.get()))
    assert abs(got.get().mean() - 32.0) < 1.0
    big = 5000
    assert big > random_ops.HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE
    ref = jrs.hypergeometric(9000, 4000, big, shape=(200,))
    got = trs.hypergeometric(9000, 4000, big, shape=(200,))
    assert got.dtype == np.int64 == ref.dtype
    assert np.array_equal(got.get(), np.asarray(ref.get()))
    assert jrs.get_state() == trs.get_state()


def test_hypergeometric_validation(torch_app):
    rs = torch_app.random_state(8)
    with pytest.raises(ValueError, match="non-negative"):
        rs.hypergeometric(-1, 5, 2, shape=(3,))
    with pytest.raises(ValueError, match="ngood \\+ nbad < nsample"):
        rs.hypergeometric(3, 4, 9, shape=(3,))
    with pytest.raises(ValueError, match="1000000000"):
        rs.hypergeometric(10**9, 10, 5, shape=(3,))


def test_call_sequence_holds_the_counter(jax_app, torch_app):
    """A stream of mixed calls, the host-route hypergeometric in the
    middle (it bumps the counter without folding a key): every draw and
    the final state agree."""
    jrs, trs = jax_app.random_state(2**32 + 5), torch_app.random_state(
        2**32 + 5)
    steps = [
        ("normal", dict(shape=(50, 3)), "ulp"),
        ("integers", dict(low=0, high=1000, shape=(64,)), "exact"),
        ("hypergeometric", dict(ngood=9000, nbad=4000, nsample=5000,
                                shape=(32,)), "exact"),
        ("uniform", dict(low=-1.0, high=1.0, shape=(40,)), "ulp"),
        ("permutation", dict(size=100), "exact"),
        ("gamma", dict(k=2.0, theta=2.0, shape=(300,)), "looped"),
        ("choice", dict(a=50, shape=(10,), replace=False), "exact"),
        ("random", dict(shape=(7,)), "exact"),
    ]
    for i, (name, kw, cls) in enumerate(steps):
        ref = getattr(jrs, name)(**kw).get()
        got = getattr(trs, name)(**kw).get()
        _assert_class(cls, got, np.asarray(ref), "float64")
        assert trs.get_state()["counter"] == i + 1
        assert jrs.get_state() == trs.get_state()


def test_state_round_trip_between_the_packages(jax_app, torch_app):
    jrs, trs = jax_app.random_state(77), torch_app.random_state(1)
    jrs.normal(shape=(5,))
    jrs.random(shape=(5,))
    state = jrs.get_state()
    assert state == {"bit_generator": "threefry2x32", "seed": 77,
                     "counter": 2}
    trs.set_state(state)
    assert np.array_equal(trs.random(shape=(20,)).get(),
                          np.asarray(jrs.random(shape=(20,)).get()))
    trs.integers(0, 10, shape=(3,))
    # ... and back
    jrs2 = jax_app.random_state(5)
    jrs2.set_state(trs.get_state())
    assert np.array_equal(np.asarray(jrs2.random(shape=(20,)).get()),
                          trs.random(shape=(20,)).get())
    # a saved state resumes this package's own stream bitwise
    saved = trs.get_state()
    a = trs.normal(shape=(30,)).get()
    trs.set_state(saved)
    assert np.array_equal(a, trs.normal(shape=(30,)).get())
    with pytest.raises(AssertionError):
        trs.set_state({"bit_generator": "MT19937", "seed": 1, "counter": 0})


def test_numpy_escape_hatch(jax_app, torch_app):
    a = torch_app.random_state(5).numpy().random(4)
    b = jax_app.random_state(5).numpy().random(4)
    assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# The distribution repairs the reference's own tests guard
# (tests/core/array/test_random.py), on the port
# ----------------------------------------------------------------------


def test_wald_matches_inverse_gaussian_moments(torch_app):
    n = 100_000
    w = torch_app.random_state(3).wald(3.0, 2.0, shape=(n,)).get()
    assert abs(w.mean() - 3.0) < 0.1
    assert abs(w.var() - 13.5) < 0.8


def test_noncentral_chisquare_small_df(torch_app):
    n = 100_000
    s = torch_app.random_state(4).noncentral_chisquare(
        0.5, 1.0, shape=(n,)).get()
    assert np.isfinite(s).all() and (s >= 0).all()
    assert abs(s.mean() - 1.5) < 0.1  # E = df + nonc


def test_noncentral_f_mean(torch_app):
    n = 200_000
    f = torch_app.random_state(5).noncentral_f(
        5.0, 20.0, 3.0, shape=(n,)).get()
    want = 20.0 / 18.0 * (5.0 + 3.0) / 5.0
    assert abs(f.mean() - want) < 0.05


def test_integers_endpoint_at_dtype_max(torch_app):
    hi = np.iinfo(np.int32).max
    v = torch_app.random_state(6).integers(
        hi - 2, hi, shape=(2000,), dtype=np.int32, endpoint=True).get()
    assert v.min() >= hi - 2 and v.max() == hi
    assert set(np.unique(v)) == {hi - 2, hi - 1, hi}


def test_hypergeometric_large_population_exact_urn(torch_app):
    rs = torch_app.random_state(8)
    g = b = 2**29
    h = rs.hypergeometric(g, b, 64, shape=(500,), block_shape=(500,))
    assert h.dtype == np.int64
    v = h.get()
    assert (0 <= v).all() and (v <= 64).all()
    assert abs(v.mean() - 32.0) < 1.0


LAWS = [
    ("beta", (2.0, 3.0), lambda s: ((0 < s) & (s < 1)).all()),
    ("exponential", (2.0,), lambda s: (s >= 0).all()
     and abs(s.mean() - 2.0) < 0.3),
    ("gamma", (2.0, 2.0), lambda s: (s > 0).all()
     and abs(s.mean() - 4.0) < 0.5),
    ("poisson", (3.0,), lambda s: (s >= 0).all()
     and abs(s.mean() - 3.0) < 0.3),
    ("chisquare", (4.0,), lambda s: (s > 0).all()
     and abs(s.mean() - 4.0) < 0.5),
    ("gumbel", (0.0, 1.0), lambda s: np.isfinite(s).all()),
    ("laplace", (0.0, 1.0), lambda s: abs(s.mean()) < 0.2),
    ("logistic", (0.0, 1.0), lambda s: abs(s.mean()) < 0.3),
    ("lognormal", (0.0, 0.5), lambda s: (s > 0).all()),
    ("pareto", (3.0,), lambda s: (s >= 0).all()),
    ("power", (3.0,), lambda s: ((0 <= s) & (s <= 1)).all()),
    ("rayleigh", (1.0,), lambda s: (s >= 0).all()),
    ("standard_cauchy", (), lambda s: np.isfinite(s).all()),
    ("standard_t", (5.0,), lambda s: abs(np.median(s)) < 0.3),
    ("triangular", (0.0, 0.5, 1.0), lambda s: ((0 <= s) & (s <= 1)).all()),
    ("wald", (1.0, 1.0), lambda s: (s > 0).all()),
    ("weibull", (2.0,), lambda s: (s >= 0).all()),
    ("binomial", (10, 0.5), lambda s: ((0 <= s) & (s <= 10)).all()),
    ("geometric", (0.5,), lambda s: (s >= 1).all()),
    ("f", (5.0, 7.0), lambda s: (s > 0).all()),
    ("negative_binomial", (5, 0.5), lambda s: (s >= 0).all()),
    ("noncentral_chisquare", (4.0, 2.0), lambda s: (s > 0).all()),
    ("vonmises", (0.0, 1.0), lambda s: ((-np.pi <= s) & (s <= np.pi)).all()),
    ("zipf", (3.0,), lambda s: (s >= 1).all()),
    ("logseries", (0.5,), lambda s: (s >= 1).all()),
    ("hypergeometric", (20, 10, 10), lambda s: ((0 <= s) & (s <= 10)).all()),
]


@pytest.mark.parametrize("name,args,check", LAWS, ids=[d[0] for d in LAWS])
def test_distribution_zoo_laws(torch_app, name, args, check):
    """The range and moment checks of the reference's own zoo test."""
    ba = getattr(torch_app.random_state(123), name)(
        *args, shape=(500,), block_shape=(125,))
    s = ba.get()
    assert s.shape == (500,) and ba.block_shape == (125,)
    assert check(s), name


def test_every_reference_method_exists(jax_app, torch_app):
    jrs, trs = jax_app.random_state(0), torch_app.random_state(0)
    names = [n for n in dir(jrs) if not n.startswith("_")
             and callable(getattr(jrs, n))]
    assert len(names) >= 40
    missing = [n for n in names if not callable(getattr(trs, n, None))]
    assert not missing, missing
    assert set(random_ops._DISTS) == set(jrandom_ops._DISTS)
    for name in ("supported", "sample", "integers", "permutation",
                 "hypergeometric", "HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE",
                 "_rejection_sample", "_vonmises", "_zipf", "_logseries",
                 "_negative_binomial", "_noncentral_chisquare",
                 "_noncentral_f", "_u"):
        assert hasattr(random_ops, name), name
    assert (random_ops.HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE
            == jrandom_ops.HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE)


# ----------------------------------------------------------------------
# Structure: block shapes, chunks, slices, devices
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", ["normal", "uniform", "random"])
def test_same_seed_same_array_across_block_shapes(torch_app, method):
    arrays = []
    for block_shape in [(1000, 30), (100, 7), (1, 1)]:
        rs = torch_app.random_state(1337)
        arr = getattr(rs, method)(shape=(1000, 30), block_shape=block_shape)
        assert arr.block_shape == block_shape
        arrays.append(arr.get())
    for other in arrays[1:]:
        assert np.array_equal(arrays[0], other)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_draws_do_not_depend_on_the_chunk_and_slices_agree(dtype):
    key = threefry.fold_in(threefry.seed_key(9, True), 4)
    shape = (37, 11)
    for fn, args in ((random_ops.jr_uniform, (-1.0, 2.0)),
                     (random_ops.jr_normal, ())):
        whole = fn(key, shape, dtype, "cpu", *args)
        for chunk in (1, 7, 100):
            assert torch.equal(whole, fn(key, shape, dtype, "cpu", *args,
                                         chunk=chunk))
        part = fn(key, shape, dtype, "cpu", *args, flat_range=(30, 200))
        assert torch.equal(part, whole.reshape(-1)[30:200])
    ints = random_ops.jr_randint(key, shape, -3, 1000, torch.int32, "cpu",
                                 True)
    assert torch.equal(ints, random_ops.jr_randint(
        key, shape, -3, 1000, torch.int32, "cpu", True, chunk=5))
    assert torch.equal(
        ints.reshape(-1)[100:150],
        random_ops.jr_randint(key, shape, -3, 1000, torch.int32, "cpu",
                              True, flat_range=(100, 150)))


def test_integers_across_block_shapes_and_range(torch_app):
    a = torch_app.random_state(5).integers(3, 9, shape=(500,),
                                           block_shape=(500,)).get()
    b = torch_app.random_state(5).integers(3, 9, shape=(500,),
                                           block_shape=(7,)).get()
    assert np.array_equal(a, b) and a.dtype == np.int64
    assert a.min() >= 3 and a.max() <= 8
    c = torch_app.random_state(5).integers(
        3, 9, shape=(4000,), endpoint=True
    ).get()
    assert c.max() == 9 and c.min() == 3
    d = torch_app.random_state(5).integers(4, shape=(100,), dtype=np.int32)
    assert d.dtype == np.int32 and d.get().max() <= 3


def test_stream_advances_and_seeds_differ(torch_app):
    rs = torch_app.random_state(7)
    first, second = rs.normal(shape=(50,)).get(), rs.normal(shape=(50,)).get()
    assert not np.array_equal(first, second)
    again = torch_app.random_state(7).normal(shape=(50,)).get()
    assert np.array_equal(first, again)
    other = torch_app.random_state(8).normal(shape=(50,)).get()
    assert not np.array_equal(first, other)


@pytest.mark.parametrize("dtype", [None, np.float32])
def test_moments(torch_app, dtype):
    n = 200_000
    rs = torch_app.random_state(3)
    z = rs.normal(loc=2.0, scale=3.0, shape=(n,), dtype=dtype).get()
    u = rs.uniform(-1.0, 5.0, shape=(n,), dtype=dtype).get()
    r = rs.random(shape=(n,), dtype=dtype).get()
    expect = np.float64 if dtype is None else dtype
    assert z.dtype == u.dtype == r.dtype == expect
    se = 6 / np.sqrt(n)
    assert abs(z.mean() - 2.0) < 3.0 * se
    assert abs(z.std() - 3.0) < 3.0 * se * np.sqrt(2)
    assert abs(u.mean() - 2.0) < (6 / np.sqrt(12)) * se
    assert u.min() >= -1.0 and u.max() < 5.0
    assert abs(r.var() - 1 / 12) < se / 5
    assert r.min() >= 0.0 and r.max() < 1.0


def test_generator_lives_on_the_backend_device(torch_app):
    """Every draw is made on the backend's device: the bits, a float draw,
    an integer draw, a permutation and a looped sampler's output."""
    rs = torch_app.random_state(0)
    device = torch_app.backend.device
    key = rs._next_key()
    assert isinstance(key, tuple) and all(isinstance(w, int) for w in key)
    assert threefry.random_bits(key, (4,), 32, device).device == device
    for arr in (rs.normal(shape=(3, 3)), rs.integers(0, 5, shape=(4,)),
                rs.permutation(9), rs.gamma(2.0, 1.0, shape=(5,)),
                rs.choice(7, shape=(3,))):
        assert arr.raw.device == device


def test_no_torch_generator_in_the_port():
    """The port draws from threefry counters alone."""
    banned = ("torch.Generator", "manual_seed", "torch.randint",
              "torch.randperm", "normal_(", "uniform_(")
    for path in (REPO / "nums_tpu_torch").rglob("*.py"):
        text = path.read_text()
        for word in banned:
            assert word not in text, (path.name, word)


# ----------------------------------------------------------------------
# The known answers that chip_smoke.py holds the card to
# ----------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_known_answers(seed, counter, positions):
    """What jax draws, in the reference's accelerator mode (64-bit types
    off), under ``fold_in(key(seed), counter)`` at the given flat
    positions of a float32 / int32 draw: the raw bits, ``random``,
    ``normal`` and ``integers(0, 1000)``, computed through
    ``threefry2x32_p`` at the counters ``(i >> 32, i & 0xffffffff)`` and
    jax's own transforms, never by making the array; and
    ``permutation(1000)`` whole."""
    idx = np.asarray(positions, dtype=np.uint64)
    hi = jnp.asarray((idx >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    with jax.enable_x64(False):
        key = jr.fold_in(jr.key(seed), counter)

        def bits_at(k):
            k0, k1 = jr.key_data(k)
            b0, b1 = prng.threefry2x32_p.bind(k0, k1, hi, lo)
            return b0 ^ b1

        bits = bits_at(key)
        float_bits = (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000)
        unit = jax.lax.bitcast_convert_type(float_bits, jnp.float32) - 1.0
        low = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u = jnp.maximum(low, unit * (np.float32(1.0) - low) + low)
        normal = np.float32(np.sqrt(2)) * jax.lax.erf_inv(u)
        k1, k2 = jr.split(key)
        span = jnp.uint32(1000)
        mult = jnp.uint32(2**16) % span
        mult = (mult * mult) % span
        ints = ((bits_at(k1) % span) * mult + bits_at(k2) % span) % span
        perm = jr.permutation(key, 1000)
        return {
            "bits": [int(b) for b in np.asarray(bits)],
            "random": [float(v) for v in np.asarray(unit)],
            "normal": [float(v) for v in np.asarray(normal)],
            "integers": [int(v) for v in np.asarray(ints)],
            "permutation": [int(v) for v in np.asarray(perm)],
        }


def test_chip_smoke_known_answers_are_the_reference_values():
    """The literals in chip_smoke.py equal what jax gives, so they cannot
    rot; and the port's CPU route reproduces them at those positions."""
    smoke = _chip_smoke()
    known = smoke.RANDOM_KNOWN
    positions = known["positions"] + known["positions_beyond_2_32"]
    assert len(known["positions"]) == 16
    assert len(known["positions_beyond_2_32"]) == 4
    assert all(p >= 2**32 for p in known["positions_beyond_2_32"])
    assert max(known["positions"]) == 2_500_000 * 1000 - 1
    ref = reference_known_answers(known["seed"], known["counter"], positions)
    assert ref["bits"] == known["bits"]
    assert ref["random"] == known["random"]
    assert ref["integers"] == known["integers"]
    assert ref["permutation"] == known["permutation"]
    assert np.array_equal(np.float32(ref["normal"]),
                          np.float32(known["normal"]))
    got = smoke.random_known_answers("cpu")
    assert got["bits"] == known["bits"]
    assert got["random"] == known["random"]
    assert got["integers"] == known["integers"]
    assert got["permutation"] == known["permutation"]
    assert np.allclose(got["normal"], known["normal"], rtol=2e-6, atol=1e-6)
