"""The port's kernel modules against the reference's Pallas kernels.

On the CPU ``cuda_gram.gram`` and ``cuda_newton.stats`` take their plain
versions; the Pallas kernels run in interpret mode, as
tests/core/ops/test_pallas_gram.py and test_pallas_newton.py run them.

Tolerances, relative to max|reference|:
* gram: both sides round the same float32 inputs (scaled by sqrt(s) in
  f32 when weighted) to bf16 and accumulate exactly representable
  products in f32, so they differ only in summation order: 1e-5.
* stats' H: both sides build it from bf16(bf16(x)·bf16(sqrt(s)))
  (pallas_newton.py:114), so they differ only in summation order: 1e-5.
  eta accumulates in f64 here and in f32 there; that moves no bf16
  rounding of sqrt(s) at these shapes.
* stats at d = 128: XLA on the CPU keeps the product bf16(x)·bf16(sqrt(s))
  in f32 instead of rounding it (its default excess precision), so the
  reference's interpret-mode H is not its TPU kernel's rounding there
  (ROADMAP Queue C). Those cases keep the reference's bf16-class 4e-3;
  with excess precision off they hold 1e-5 (a test below).
* port-only shapes against the float64 numpy oracle: the reference's
  own bf16-class 2e-3 (gram) and 4e-3 (stats).
"""

import json
import os
import subprocess
import sys


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


def _entry(form, x):
    """The operand ``stats`` takes: X itself, or its staged copy."""
    return x if form == "x" else cuda_newton.prepare(x)


@pytest.mark.parametrize("form", ["x", "staged"])
@pytest.mark.parametrize(
    "kind,n,d",
    [("logistic", 1024, 128), ("linear", 1024, 128), ("poisson", 1024, 128),
     ("logistic", 1000, 256), ("logistic", 4099, 256)],
)
def test_stats_matches_pallas(jax_app, kind, n, d, form):
    """bf16 class at every shape; the d = 128 cases stay at this bound
    because of the reference's excess precision there (ROADMAP Queue C).
    Both entry forms: X, and X staged once by ``prepare``."""
    from nums_tpu.core.ops import pallas_newton

    x, y, beta = _stats_inputs(np.random.RandomState(0), n, d)
    g, h = cuda_newton.stats(_entry(form, torch.from_numpy(x)),
                             torch.from_numpy(y), torch.from_numpy(beta),
                             kind)
    rg, rh = pallas_newton.stats(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(beta), kind)
    assert rel_err(g, rg) < STATS_BF16_REL
    assert rel_err(h, rh) < STATS_BF16_REL
    og, oh = _stats_oracle(kind, x, y, beta)
    assert rel_err(g, og) < STATS_BF16_REL
    assert rel_err(h, oh) < STATS_BF16_REL
    assert torch.equal(h, h.T)


@pytest.mark.parametrize("kind", cuda_newton.KINDS)
@pytest.mark.parametrize("n,d", [(37, 1), (100, 97), (130, 129),
                                 (65, 1001)])
def test_staged_and_one_shot_stats_are_bitwise_equal(kind, n, d):
    """``prepare`` gives the staging pass's operand: bf16(X)ᵀ zero-padded
    to whole tiles (d to 128, n to 64); ``stats`` on it and on X give the
    same bits, at ragged shapes and n < 64."""
    rs = np.random.RandomState(n * d)
    x, y, beta = _stats_inputs(rs, n, d)
    tx = torch.from_numpy(x)
    staged = cuda_newton.prepare(tx)
    d_pad, n_pad = -(-d // 128) * 128, -(-n // 64) * 64
    assert staged.shape == (n, d) and staged.xt.shape == (d_pad, n_pad)
    assert staged.xt.dtype == torch.bfloat16
    assert torch.equal(staged.xt[:d, :n].T.float(), cuda_gram.round_bf16(tx))
    assert not staged.xt[d:].any() and not staged.xt[:, n:].any()
    ty, tb = torch.from_numpy(y), torch.from_numpy(beta)
    g, h = cuda_newton.stats(staged, ty, tb, kind)
    g1, h1 = cuda_newton.stats(tx, ty, tb, kind)
    assert torch.equal(g, g1) and torch.equal(h, h1)
    og, oh = _stats_oracle(kind, x, y, beta)
    assert rel_err(h, oh) < STATS_BF16_REL


@pytest.mark.parametrize("kind", ["logistic", "poisson"])
@pytest.mark.parametrize("n,d", [(1000, 256), (4099, 256)])
def test_stats_hessian_has_the_pallas_rounding(jax_app, kind, n, d):
    """H is built from bf16(bf16(x)·bf16(sqrt(s))), as the TPU Newton
    kernel builds it (pallas_newton.py:114): the two agree to summation
    order. Scaling in f32 before one rounding (the weighted gram's rule)
    is 4e-4 to 9e-4 away at these shapes."""
    from nums_tpu.core.ops import pallas_newton

    x, y, beta = _stats_inputs(np.random.RandomState(0), n, d)
    g, h = cuda_newton.stats(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(beta), kind)
    rg, rh = pallas_newton.stats(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(beta), kind)
    assert rel_err(g, rg) < ORDER_REL
    assert rel_err(h, rh) < ORDER_REL
    assert torch.equal(h, h.T)


@pytest.mark.parametrize("kind", ["logistic", "poisson"])
def test_bf16_scale_gram_is_the_pallas_newton_hessian(jax_app, kind):
    """The plain mode-2 gram on the port's own weights is the Pallas
    Newton kernel's H; mode 1 (the weighted gram's rule) is not."""
    from nums_tpu.core.ops import pallas_newton

    x, y, beta = _stats_inputs(np.random.RandomState(2), 1000, 256)
    _, rh = pallas_newton.stats(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(beta), kind)
    tx = torch.from_numpy(x)
    eta = cuda_newton._eta_plain(cuda_gram.round_bf16(tx),
                                 cuda_gram.round_bf16(torch.from_numpy(beta)))
    _, s = cuda_newton._link(kind, eta)
    h = cuda_gram.gram_plain(tx, s, cuda_gram.MODE_SCALE_BF16)
    assert rel_err(h, rh) < ORDER_REL
    assert rel_err(cuda_gram.gram_plain(tx, s), rh) > 10 * ORDER_REL


_NO_EXCESS_PRECISION = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, torch, jax.numpy as jnp
sys.path.insert(0, "tests")
from torch_parity import rel_err
from test_torch_kernels import _stats_inputs
from nums_tpu.core.ops import pallas_newton
from nums_tpu_torch.core.ops import cuda_newton
torch.set_num_threads(1)
out = {}
for kind in ("logistic", "poisson"):
    x, y, beta = _stats_inputs(np.random.RandomState(0), 1024, 128)
    _, h = cuda_newton.stats(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(beta), kind)
    _, rh = pallas_newton.stats(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(beta), kind)
    out[kind] = rel_err(h, rh)
print(json.dumps(out))
"""


def test_stats_at_d128_hold_without_excess_precision():
    """The d = 128 gap of test_stats_matches_pallas is the reference's:
    in a process where XLA rounds every bf16 value it is asked to
    (--xla_allow_excess_precision=false), the interpret-mode Pallas H
    agrees with the port's to summation order (ROADMAP Queue C)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", _NO_EXCESS_PRECISION],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    errs = json.loads(proc.stdout.strip().splitlines()[-1])
    assert errs["logistic"] < ORDER_REL and errs["poisson"] < ORDER_REL, errs


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
    with pytest.raises(ValueError, match="no kernel"):
        cuda_newton.prepare(meta)
    with pytest.raises(ValueError):
        cuda_newton.stats(x, y, beta, "gamma")
    staged = cuda_newton.prepare(x)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_newton.eta(staged, y, beta, "poisson")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_gram.gram_staged(staged.xt, 9, weighted=False)
    assert cuda_gram.LAUNCHES == {"gram": 0, "gram_weighted": 0}
    assert cuda_newton.LAUNCHES == {"newton_stage": 0, "newton_stats": 0}


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


@pytest.mark.parametrize("edited", ["source", "header"])
def test_library_name_follows_the_sources(monkeypatch, tmp_path, edited):
    """An edited source or header gets a new library name, so it is
    rebuilt."""
    assert "hopper.cuh" in _build.headers()
    for name in _build.SOURCES + _build.headers():
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR
    name = _build.SOURCES[0] if edited == "source" else _build.headers()[0]
    with open(tmp_path / name, "a") as f:
        f.write("// edited\n")
    assert _build.library_path() != before


@pytest.mark.parametrize(
    "mode",
    [cuda_gram.MODE_X, cuda_gram.MODE_SCALE_F32, cuda_gram.MODE_SCALE_BF16],
)
def test_gram_modes_on_the_cpu_route(mode):
    """Each rounding mode: bf16 operands as its rule says, the plain
    gram of them, exactly symmetric, and bf16-class close to float64."""
    rs = np.random.RandomState(4)
    x = rs.randn(67, 13).astype(np.float32)
    s = rs.rand(67).astype(np.float32)
    tx, ts = torch.from_numpy(x), torch.from_numpy(s)
    w = None if mode == cuda_gram.MODE_X else ts
    xb = cuda_gram.stage_plain(tx, w, mode)
    assert torch.equal(xb, cuda_gram.round_bf16(xb))
    rb = cuda_gram.round_bf16
    sq = torch.sqrt(ts)[:, None]
    rule = {cuda_gram.MODE_X: lambda: rb(tx),
            cuda_gram.MODE_SCALE_F32: lambda: rb(tx * sq),
            cuda_gram.MODE_SCALE_BF16: lambda: rb(rb(tx) * rb(sq))}[mode]
    assert torch.equal(xb, rule())
    g = cuda_gram.gram(tx, w, mode)
    assert torch.equal(g, cuda_gram.gram_plain(tx, w, mode))
    assert torch.equal(g, g.T)
    x64 = x.astype(np.float64)
    oracle = x64.T @ x64 if w is None else (x64 * s[:, None]).T @ x64
    assert rel_err(g, oracle) < GRAM_BF16_REL


def test_gram_mode_needs_its_weight():
    x, s = torch.randn(8, 3), torch.rand(8)
    with pytest.raises(ValueError, match="take s"):
        cuda_gram.gram(x, None, cuda_gram.MODE_SCALE_BF16)
    with pytest.raises(ValueError, match="take s"):
        cuda_gram.gram(x, s, cuda_gram.MODE_X)
    with pytest.raises(ValueError, match="unknown rounding mode"):
        cuda_gram.gram(x, s, 3)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_gram.stage(x)


@pytest.mark.parametrize(
    "k_tiles,npairs",
    [(1, 1), (5, 1), (10, 36), (39063, 36), (39063, 561), (3, 100000)],
)
def test_row_splits_cover_every_k_tile(k_tiles, npairs):
    """Every split of the tensor-core gram gets at least one K tile (the
    kernel splits them as ceil(k_tiles / splits)), and the workspace
    stays under its cap unless one split already exceeds it."""
    tile = 128
    splits = cuda_gram._splits(k_tiles, npairs, tile)
    per = -(-k_tiles // splits)
    assert 1 <= splits <= k_tiles
    assert (splits - 1) * per < k_tiles <= splits * per
    ws = splits * npairs * tile * tile * 4
    assert splits == 1 or ws <= cuda_gram._MAX_WORKSPACE_BYTES
