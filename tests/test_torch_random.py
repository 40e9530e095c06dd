"""The port's random state: determinism, block-shape independence and
moments.

Torch's generators do not reproduce nums_tpu's threefry bits, so nothing
here compares values with nums_tpu; the contract checked is the
reference's: one seed gives one array whatever the block shape, and the
draws follow their distributions. Moment tolerances are 6 standard errors
of the estimate at the sample size used.
"""

import numpy as np
import pytest
import torch

from torch_parity import torch_app  # noqa: F401


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
    rs = torch_app.random_state(0)
    gen = rs._next_generator()
    assert isinstance(gen, torch.Generator)
    assert gen.device == torch_app.backend.device
    arr = rs.normal(shape=(3, 3))
    assert arr.raw.device == torch_app.backend.device
