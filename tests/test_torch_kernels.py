"""The port's kernel modules against the reference's Pallas kernels.

On the CPU ``cuda_gram.gram`` and ``cuda_newton.stats`` take their plain
versions; the Pallas kernels run in interpret mode, as
tests/core/ops/test_pallas_gram.py and test_pallas_newton.py run them.

Tolerances, relative to max|reference|:
* gram: both sides round the same float32 inputs (scaled by sqrt(s) in
  f32 when weighted) to bf16 and accumulate exactly representable
  products in f32, so they differ only in summation order: 1e-5.
* stats: eta accumulates in f64 here and in f32 there, and the Hessian
  rows are scaled before the bf16 rounding here and after it there
  (nums_tpu_torch/csrc/newton.cu): bf16 class, the reference's 4e-3.
* port-only shapes against the float64 numpy oracle: the reference's
  own bf16-class 2e-3 (gram) and 4e-3 (stats).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (
    GRAM_BF16_REL, STATS_BF16_REL, jax_app, rel_err,  # noqa: F401
)

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.ops import _build, cuda_gram, cuda_newton

ORDER_REL = 1e-5


def _stats_oracle(kind, x, y, beta):
    eta = x.astype(np.float64) @ beta.astype(np.float64)
    if kind == "logistic":
        mu = 1.0 / (1.0 + np.exp(-eta))
        s = mu * (1.0 - mu)
    elif kind == "linear":
        mu, s = eta, np.ones_like(eta)
    else:
        mu = np.exp(eta)
        s = mu
    x64 = x.astype(np.float64)
    return x64.T @ (mu - y), (x64 * s[:, None]).T @ x64


def _stats_inputs(rs, n, d):
    x = rs.randn(n, d).astype(np.float32) * 0.1
    y = (rs.rand(n) > 0.5).astype(np.float32)
    beta = rs.randn(d).astype(np.float32) * 0.05
    return x, y, beta


@pytest.mark.parametrize(
    "shape", [(1024, 128), (1000, 128), (4099, 256), (2048, 512)]
)
def test_gram_matches_pallas(jax_app, shape):
    from nums_tpu.core.ops import pallas_gram

    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = cuda_gram.gram(torch.from_numpy(x))
    ref = np.asarray(pallas_gram.gram(jnp.asarray(x)))
    assert got.shape == (shape[1], shape[1]) and got.dtype == torch.float32
    assert rel_err(got, ref) < ORDER_REL
    assert rel_err(got, x.T.astype(np.float64) @ x) < GRAM_BF16_REL
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("shape", [(1024, 128), (1000, 256)])
def test_weighted_gram_matches_pallas(jax_app, shape):
    from nums_tpu.core.ops import pallas_gram

    rs = np.random.RandomState(3)
    x = rs.randn(*shape).astype(np.float32)
    s = rs.rand(shape[0]).astype(np.float32)
    got = cuda_gram.gram(torch.from_numpy(x), torch.from_numpy(s))
    ref = np.asarray(pallas_gram.gram(jnp.asarray(x), jnp.asarray(s)))
    assert rel_err(got, ref) < ORDER_REL
    oracle = (x.astype(np.float64) * s[:, None]).T @ x
    assert rel_err(got, oracle) < GRAM_BF16_REL
    assert torch.equal(got, got.T)


@pytest.mark.parametrize(
    "kind,n,d",
    [("logistic", 1024, 128), ("linear", 1024, 128), ("poisson", 1024, 128),
     ("logistic", 1000, 256), ("logistic", 4099, 256)],
)
def test_stats_matches_pallas(jax_app, kind, n, d):
    from nums_tpu.core.ops import pallas_newton

    x, y, beta = _stats_inputs(np.random.RandomState(0), n, d)
    g, h = cuda_newton.stats(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(beta), kind)
    rg, rh = pallas_newton.stats(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(beta), kind)
    assert rel_err(g, rg) < STATS_BF16_REL
    assert rel_err(h, rh) < STATS_BF16_REL
    og, oh = _stats_oracle(kind, x, y, beta)
    assert rel_err(g, og) < STATS_BF16_REL
    assert rel_err(h, oh) < STATS_BF16_REL
    assert torch.equal(h, h.T)


@pytest.mark.parametrize("n,d", [(100, 1), (100, 97), (100, 1001)])
def test_port_only_shapes_against_oracle(n, d):
    """No 128-lane rule and no cap on d: any width, and fewer rows than
    the reference kernel's 128-row tile. With so few rows the rounding
    errors average out less, so the stats take
    positive inputs (y = 0, hence r > 0 for every kind): g is then a sum
    without cancellation, and its relative error measures the bf16
    rounding rather than the conditioning of a short sum."""
    rs = np.random.RandomState(n + d)
    x = rs.randn(n, d).astype(np.float32)
    s = rs.rand(n).astype(np.float32)
    tx = torch.from_numpy(x)
    g = cuda_gram.gram(tx)
    assert rel_err(g, x.T.astype(np.float64) @ x) < GRAM_BF16_REL
    gw = cuda_gram.gram(tx, torch.from_numpy(s))
    oracle = (x.astype(np.float64) * s[:, None]).T @ x
    assert rel_err(gw, oracle) < GRAM_BF16_REL
    assert torch.equal(g, g.T) and torch.equal(gw, gw.T)
    x = (0.1 * rs.randn(n, d) + 0.2).astype(np.float32)
    y = np.zeros(n, np.float32)
    beta = (0.05 * np.abs(rs.randn(d))).astype(np.float32)
    for kind in cuda_newton.KINDS:
        sg, sh = cuda_newton.stats(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(beta), kind)
        og, oh = _stats_oracle(kind, x, y, beta)
        assert rel_err(sg, og) < STATS_BF16_REL, kind
        assert rel_err(sh, oh) < STATS_BF16_REL, kind
        assert torch.equal(sh, sh.T), kind


def test_plain_versions_are_the_cpu_route():
    """A CPU tensor takes the plain version, and only a CPU tensor: any
    other device raises instead of falling back."""
    x = torch.randn(40, 9)
    s, y, beta = torch.rand(40), torch.rand(40), torch.randn(9)
    assert torch.equal(cuda_gram.gram(x), cuda_gram.gram_plain(x))
    assert torch.equal(cuda_gram.gram(x, s), cuda_gram.gram_plain(x, s))
    for got, ref in zip(cuda_newton.stats(x, y, beta, "poisson"),
                        cuda_newton.stats_plain(x, y, beta, "poisson")):
        assert torch.equal(got, ref)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_gram.gram(meta)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_newton.stats(meta, y.to("meta"), beta.to("meta"), "logistic")
    with pytest.raises(ValueError):
        cuda_newton.stats(x, y, beta, "gamma")
    assert cuda_gram.LAUNCHES == {"gram": 0, "gram_weighted": 0}
    assert cuda_newton.LAUNCHES == {"newton_stats": 0}


def test_supported_shapes_and_dtypes():
    assert cuda_gram.supported((2_500_000, 1000), np.float32)
    assert cuda_gram.supported((3, 1), torch.float32)
    assert cuda_newton.supported((10, 4097), "float32")
    assert not cuda_gram.supported((10, 4), np.float64)
    assert not cuda_gram.supported((10,), np.float32)
    assert not cuda_gram.supported((0, 4), np.float32)


@pytest.mark.parametrize(
    "precision,gate,expect",
    [("default", "auto", True), ("highest", "auto", False),
     ("float32", "auto", False), ("highest", "1", True),
     ("default", "0", False)],
)
def test_kernel_gates_follow_precision(monkeypatch, precision, gate, expect):
    monkeypatch.setattr(settings, "matmul_precision", precision)
    monkeypatch.setattr(settings, "gram_kernel", gate)
    monkeypatch.setattr(settings, "newton_kernel", gate)
    assert cuda_gram.enabled() is expect
    assert cuda_newton.enabled() is expect


def test_build_needs_no_nvcc_to_import(monkeypatch, tmp_path):
    """Importing the kernel modules builds nothing; a missing nvcc is
    reported when a build is asked for."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert _build._lib is None


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """An edited source gets a new library name, so it is rebuilt."""
    for name in _build.SOURCES:
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR
    with open(tmp_path / _build.SOURCES[0], "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before
