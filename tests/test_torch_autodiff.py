"""nums_tpu_torch.autodiff against nums_tpu.autodiff on the CPU: every
test of tests/core/test_autodiff.py with the same numpy inputs through
both packages, the K1 backward and the purity guard.

Tolerances: float64 gradients, values and Hessian-vector products within
1e-10 of the reference's, relative to the largest magnitude of the
reference's output (the same float64 ops in another order);
``check_grad`` within the reference's own atol. The gram's gradient
(float32, through K1's plain version) within 1e-6 relative of float64
X(W+Wᵀ); its forward stays in the bf16-MAC class (``GRAM_BF16_REL``).
"""

import threading

import numpy as np
import pytest
import torch

from torch_parity import (  # noqa: F401
    GRAM_BF16_REL, apps, jax_app, rel_err, spy_calls, torch_app,
)

import nums_tpu.autodiff as jad
import nums_tpu_torch.autodiff as tad
from nums_tpu_torch.core import backend as tbackend
from nums_tpu_torch.core.ops import cuda_gram

REL = 1e-10
GRAM_GRAD_REL = 1e-6


def both(apps, fn):
    """``fn(autodiff, app)`` through each package, as numpy (the
    reference's result second)."""
    jax_app, torch_app = apps
    out = []
    for ad, app in ((tad, torch_app), (jad, jax_app)):
        res = fn(ad, app)
        res = res if isinstance(res, tuple) else (res,)
        out.append(tuple(np.asarray(r.get() if hasattr(r, "get") else r)
                         for r in res))
    return out


def assert_close(got, ref, tol=REL):
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        assert rel_err(g, r) <= tol, rel_err(g, r)


def test_grad_elementwise_chain(apps):
    x_np = np.linspace(-1.0, 2.0, 12)

    def run(ad, app):
        x = app.array(x_np, block_shape=(4,))
        g = ad.grad(lambda v: ((v * v) * 3.0 + v).sum())(x)
        assert g.shape == x.shape and g.block_shape == x.block_shape
        return g

    got, ref = both(apps, run)
    assert_close(got, ref)
    assert np.allclose(got[0], 6.0 * x_np + 1.0)


def test_value_and_grad_least_squares(apps):
    rs = np.random.RandomState(0)
    X_np, y_np, beta_np = rs.randn(24, 5), rs.randn(24), rs.randn(5)

    def run(ad, app):
        X = app.array(X_np, block_shape=(8, 5))
        y = app.array(y_np, block_shape=(8,))
        beta = app.array(beta_np, block_shape=(5,))

        def loss(b):
            r = X @ b - y
            return (r * r).sum()

        return ad.value_and_grad(loss)(beta)

    got, ref = both(apps, run)
    assert_close(got, ref)
    assert np.isclose(float(got[0]),
                      float(((X_np @ beta_np - y_np) ** 2).sum()))


def test_grad_multiple_argnums(apps):
    rs = np.random.RandomState(1)
    a_np, b_np = rs.randn(6), rs.randn(6)

    def run(ad, app):
        a = app.array(a_np, block_shape=(3,))
        b = app.array(b_np, block_shape=(3,))
        return ad.grad(lambda u, v: (u * v).sum() + (u * u).sum(),
                       argnums=(0, 1))(a, b)

    got, ref = both(apps, run)
    assert_close(got, ref)
    assert np.allclose(got[0], b_np + 2 * a_np)


def test_grad_through_facade_ops(apps):
    import nums_tpu.numpy as jnps
    import nums_tpu_torch.numpy as tnps

    x_np = np.linspace(0.1, 2.0, 10)

    def run(ad, app):
        nps = tnps if ad is tad else jnps
        x = nps.array(x_np)
        return ad.grad(
            lambda v: nps.sum(nps.exp(v) + nps.log(v) * 0.5))(x)

    got, ref = both(apps, run)
    assert_close(got, ref)


def test_grad_ragged(apps):
    """A length that no block divides (the reference's ragged-mesh
    case)."""
    x_np = np.linspace(-1.0, 1.0, 13)

    def run(ad, app):
        x = app.array(x_np, block_shape=(4,))
        return ad.grad(lambda v: (v * v).sum())(x)

    got, ref = both(apps, run)
    assert_close(got, ref)


def test_check_grad_utility(apps):
    rs = np.random.RandomState(2)
    b_np, X_np = rs.randn(4), rs.randn(8, 4)

    def run(ad, app):
        b = app.array(b_np, block_shape=(2,))
        X = app.array(X_np, block_shape=(4, 4))

        def f(v):
            r = X @ v
            return (r * r).sum()

        return ad.check_grad(f, (b,), atol=1e-4)

    got, ref = both(apps, run)
    assert float(got[0]) < 1e-4 and float(ref[0]) < 1e-4


@pytest.mark.parametrize("case", ["non_scalar", "unreachable",
                                  "shared_buffer"])
def test_grad_errors(apps, case):
    def run(ad, app):
        x = app.array(np.arange(4.0), block_shape=(2,))
        y = app.array(np.arange(4.0), block_shape=(2,))
        if case == "non_scalar":
            return ad.grad(lambda v: v * 2.0)(x)
        if case == "unreachable":
            return ad.grad(lambda v: (y * y).sum())(x)
        return ad.grad(lambda u, w: (u * w).sum(), argnums=(0, 1))(x, x.T)

    errors = []
    for ad, app in ((tad, apps[1]), (jad, apps[0])):
        with pytest.raises(Exception) as info:
            run(ad, app)
        errors.append(info)
    t_err, j_err = errors
    assert t_err.type is j_err.type, (t_err.type, j_err.type)
    if case == "unreachable":
        assert "not reachable" in str(t_err.value)


def test_grad_repeat_calls_equal(apps):
    """The reference caches one executor per structure
    (test_grad_program_cache_hits); the port has no program cache: two
    calls give equal results, equal to the reference's."""

    def run(ad, app):
        x = app.array(np.arange(6.0) + 1.0, block_shape=(3,))
        f = ad.grad(lambda v: (v * v).sum())
        return f(x), f(x)

    got, ref = both(apps, run)
    assert np.array_equal(got[0], got[1])
    assert_close(got, ref)


def test_grad_rejects_interior_materialization(apps):
    """A host sync inside f raises in both packages (the port counts the
    transfers to the host in ``Backend.get``)."""

    def f(v):
        a = (v * v).sum()
        float(a.get())  # a sync inside the traced function
        return a + v.sum()

    for ad, app in ((tad, apps[1]), (jad, apps[0])):
        x = app.array(np.arange(1.0, 5.0), block_shape=(2,))
        with pytest.raises(RuntimeError, match="INSIDE the traced function"):
            ad.grad(f)(x)


@pytest.mark.parametrize("sync", ["get", "float", "bool", "item", "print"])
def test_purity_guard_counts_every_host_path(torch_app, sync, capsys):
    x = torch_app.array(np.arange(1.0, 5.0), block_shape=(2,))

    def f(v):
        a = (v * v).sum()
        if sync == "get":
            a.get()
        elif sync == "float":
            float(a)
        elif sync == "bool":
            bool(a > 0.0)
        elif sync == "item":
            a.item()
        else:
            print(a)
        return a

    before = tbackend.host_sync_count()
    with pytest.raises(RuntimeError, match="INSIDE the traced function"):
        tad.grad(f)(x)
    assert tbackend.host_sync_count() > before


def test_purity_guard_is_thread_scoped(apps):
    """A concurrent thread syncing UNRELATED arrays during a traced call
    does not trip the guard (the count is thread-local)."""
    x_np = np.arange(1.0, 9.0)
    for ad, app in ((tad, apps[1]), (jad, apps[0])):
        x = app.array(x_np, block_shape=(4,))
        release, side_done, errors = (threading.Event(), threading.Event(),
                                      [])

        def side_thread():
            try:
                release.wait(timeout=30)
                y = app.array(np.arange(16.0), block_shape=(8,))
                for _ in range(3):
                    y = y * 2.0
                    y.get()
            except Exception as e:  # pragma: no cover
                errors.append(e)
            finally:
                side_done.set()

        t = threading.Thread(target=side_thread, daemon=True)
        t.start()

        def f(v):
            release.set()
            assert side_done.wait(timeout=30)
            return (v * v).sum()

        g = ad.grad(f)(x)
        t.join(timeout=30)
        assert not errors
        assert np.allclose(g.get(), 2.0 * x_np)


def test_hvp_reblocks_mismatched_tangent(apps):
    rs = np.random.RandomState(4)
    A_np, x_np, v_np = rs.randn(4, 4), rs.randn(4), rs.randn(4)

    def run(ad, app):
        A = app.array(A_np, block_shape=(4, 4))
        x = app.array(x_np, block_shape=(2,))
        v = app.array(v_np, block_shape=(4,))  # different blocking
        return ad.hvp(lambda u: (u @ (A @ u)).sum())(x, v)

    got, ref = both(apps, run)
    assert_close(got, ref)
    assert np.allclose(got[0], (A_np + A_np.T) @ v_np, atol=1e-6)


def test_hvp_transposed_argument(apps):
    """A lazily transposed argument: the gradient keeps its layout (equal
    to the reference's), and so does the Hessian-vector product, held to
    its closed form (the reference's jvp refuses a transposed primal)."""
    rs = np.random.RandomState(5)
    W_np, v_np = rs.randn(3, 5), rs.randn(5, 3)

    def f(u):
        return ((u * u) * (u * 0.5 + 1.0)).sum()

    def run(ad, app):
        return ad.grad(f)(app.array(W_np, block_shape=(3, 5)).T)

    got, ref = both(apps, run)
    assert_close(got, ref)
    torch_app = apps[1]
    W = torch_app.array(W_np, block_shape=(3, 5)).T
    v = torch_app.array(v_np, block_shape=(5, 3))
    hv = tad.hvp(f)(W, v)
    assert hv.is_transposed and hv.shape == (5, 3)
    assert rel_err(hv.get(), (3.0 * W_np.T + 2.0) * v_np) <= REL


def test_logistic_loss_value_grad_and_hvp(apps):
    """The objective of the card's phase: the mean logistic loss in nps
    ops, its gradient Xᵀ(σ(Xβ) − y)/n and its Hessian-vector product
    Xᵀdiag(s)X·v/n, against float64 formulas and the reference."""
    import nums_tpu.numpy as jnps
    import nums_tpu_torch.numpy as tnps

    rs = np.random.RandomState(6)
    n, d = 400, 7
    X_np = rs.randn(n, d)
    y_np = (rs.rand(n) < 0.5).astype(np.float64)
    b_np, v_np = rs.randn(d) * 0.3, rs.randn(d)

    def run(ad, app):
        nps = tnps if ad is tad else jnps
        X = app.array(X_np, block_shape=(100, d))
        y = app.array(y_np, block_shape=(100,))

        def loss(b):
            eta = X @ b
            return nps.mean(nps.logaddexp(0.0, eta) - y * eta)

        b = app.array(b_np, block_shape=(d,))
        v = app.array(v_np, block_shape=(d,))
        val, g = ad.value_and_grad(loss)(b)
        return val, g, ad.hvp(loss)(b, v)

    got, ref = both(apps, run)
    assert_close(got, ref)
    p = 1.0 / (1.0 + np.exp(-(X_np @ b_np)))
    assert rel_err(got[1], X_np.T @ (p - y_np) / n) <= REL
    assert rel_err(got[2], X_np.T @ ((p * (1 - p)) * (X_np @ v_np)) / n) \
        <= REL


def test_autodiff_fuzz_random_chains(apps):
    """Random differentiable op chains: the port's gradient equals the
    reference's, and both pass central finite differences."""
    rs = np.random.RandomState(7)
    for trial in range(6):
        n, d = 8, 3
        X_np = rs.randn(n, d)
        w_np = rs.randn(d) * 0.5
        ops = tuple(rs.choice(5, size=4))

        def run(ad, app, ops=ops):
            X = app.array(X_np, block_shape=(4, d))
            w = app.array(w_np, block_shape=(d,))

            def f(v):
                t = X @ v
                for o in ops:
                    if o == 0:
                        t = t * t * 0.5
                    elif o == 1:
                        t = abs(t) + 0.1
                    elif o == 2:
                        t = t + (X @ v) * 0.3
                    elif o == 3:
                        t = t * 0.7 - 1.0
                    else:
                        t = t / 2.0 + t * t * 0.1
                return (t * t).sum()

            worst = ad.check_grad(f, (w,), atol=5e-3, eps=1e-5)
            assert worst < 5e-3, (trial, ops, worst)
            return ad.grad(f)(w)

        got, ref = both(apps, run)
        assert_close(got, ref)


# ---------------------------------------------------------------------
# K1's backward (the gram under autograd)
# ---------------------------------------------------------------------


def _gram_problem(n=256, d=128, seed=8):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, d).astype(np.float32)
    W = rs.randn(d, d).astype(np.float32)
    want = X.astype(np.float64) @ (W + W.T).astype(np.float64)
    return X, W, want


@pytest.mark.parametrize("form", ["matmul", "dot", "tensordot", "T.dot"])
def test_gram_gradient_is_fp32(torch_app, form, spy_calls):
    """grad of sum(W ∘ (XᵀX)) through ``_gram_fast`` (K1's plain version
    on the CPU) equals float64 X(W+Wᵀ) within 1e-6: the forward goes
    through the kernel wrapper once, the backward is fp32. Without
    ``GramFunction`` the gradient was rounded to bf16 (about 2e-3 off)."""
    import nums_tpu_torch.numpy as nps

    X_np, W_np, want = _gram_problem()
    X = torch_app.array(X_np, block_shape=X_np.shape)
    W = torch_app.array(W_np, block_shape=W_np.shape)
    forward = spy_calls(cuda_gram, "_gram")
    gram = {"matmul": lambda x: x.T @ x,
            "dot": lambda x: nps.dot(x.T, x),
            "tensordot": lambda x: nps.tensordot(x.T, x, axes=1),
            "T.dot": lambda x: x.T.dot(x)}[form]
    val, g = tad.value_and_grad(lambda x: (W * gram(x)).sum())(X)
    assert len(forward) == 1
    assert rel_err(g.get(), want) <= GRAM_GRAD_REL
    g64 = X_np.astype(np.float64).T @ X_np.astype(np.float64)
    assert abs(float(val.get()) - float((W_np * g64).sum())) <= (
        GRAM_BF16_REL * float(np.abs(W_np * g64).sum()))


def test_gram_gradient_matches_reference(apps):
    """The same gradient through the reference (XLA's fp32 product on the
    CPU: its Pallas kernel has no backward)."""
    X_np, W_np, want = _gram_problem(n=128, d=32)

    def run(ad, app):
        X = app.array(X_np, block_shape=X_np.shape)
        W = app.array(W_np, block_shape=W_np.shape)
        return ad.grad(lambda x: (W * (x.T @ x)).sum())(X)

    got, ref = both(apps, run)
    assert rel_err(got[0], ref[0]) <= GRAM_GRAD_REL
    assert rel_err(got[0], want) <= GRAM_GRAD_REL


def test_gram_hvp_second_derivative(torch_app):
    """The backward is written in differentiable ops: hvp through the
    gram is V(W+Wᵀ)."""
    X_np, W_np, _ = _gram_problem(n=64, d=16)
    V_np = np.random.RandomState(9).randn(64, 16).astype(np.float32)
    X = torch_app.array(X_np, block_shape=X_np.shape)
    W = torch_app.array(W_np, block_shape=W_np.shape)
    V = torch_app.array(V_np, block_shape=V_np.shape)
    got = tad.hvp(lambda x: (W * (x.T @ x)).sum())(X, V).get()
    want = V_np.astype(np.float64) @ (W_np + W_np.T).astype(np.float64)
    assert rel_err(got, want) <= GRAM_GRAD_REL


def test_gram_without_grad_skips_the_function(torch_app, spy_calls):
    """Outside autograd (every model fit) the gram does not enter
    ``GramFunction``."""
    X_np, _, _ = _gram_problem(n=64, d=16)
    X = torch_app.array(X_np, block_shape=X_np.shape)
    applied = spy_calls(cuda_gram.GramFunction, "apply")
    G = X.T @ X
    assert not applied and not G.data.requires_grad
    with pytest.raises(NotImplementedError):
        cuda_gram.gram(torch.ones(4, 2, requires_grad=True),
                       torch.ones(4))


def test_no_lazy_batching_requirement(apps):
    """The reference needs lazy batching (``NUMS_TPU_LAZY=1``) and raises
    without it; the port runs eagerly and has no such switch: a gradient
    needs no setting."""
    from nums_tpu_torch.core import settings as tsettings

    assert not hasattr(tsettings, "lazy_batch")
    x = apps[1].array(np.arange(3.0), block_shape=(3,))
    assert np.array_equal(tad.grad(lambda v: (v * v).sum())(x).get(),
                          2.0 * np.arange(3.0))
