"""nums_tpu_torch.optimize against nums_tpu.optimize on the CPU: every
test of tests/core/test_optimize.py with the same numpy inputs through
both packages, and each optax rule step for step against optax.

Tolerances: each rule's parameters after 25 steps within 1e-12 of
optax's in float64 (elementwise arithmetic in the same order); in float32
within 4 ulp (``rsqrt`` is XLA's in optax, torch's here). ``minimize``
in float64: the same ``n_iter`` and ``converged`` as the reference, and
x, fun and grad_max within 1e-8 of the reference's, relative to their
largest magnitude (hundreds of steps compound the 1e-16 differences of
the gradients' sums; adam divides by √v near convergence).
"""

import numpy as np
import optax
import pytest
import torch

from torch_parity import apps, jax_app, rel_err, torch_app  # noqa: F401

import jax.numpy as jnp
import nums_tpu.optimize as jopt
import nums_tpu_torch.autodiff as tad
import nums_tpu_torch.optimize as topt
import nums_tpu.autodiff as jad

RULE_REL = 1e-12
FIT_REL = 1e-8


def _host(x):
    if isinstance(x, tuple):
        return tuple(np.asarray(v.get()) for v in x)
    return (np.asarray(x.get()),)


def both_minimize(apps, make, **kw):
    """``minimize`` of ``make(app) -> (f, x0)`` in each package: (port,
    reference) results."""
    jax_app, torch_app = apps
    out = []
    for opt, app in ((topt, torch_app), (jopt, jax_app)):
        f, x0 = make(app)
        out.append(opt.minimize(f, x0, **kw))
    return out


def assert_same_fit(got, ref, check_iters=True):
    if check_iters:
        assert got.n_iter == ref.n_iter, (got.n_iter, ref.n_iter)
    assert got.converged == ref.converged
    for g, r in zip(_host(got.x), _host(ref.x)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert rel_err(g, r) <= FIT_REL, rel_err(g, r)
    assert abs(got.fun - ref.fun) <= FIT_REL * max(abs(ref.fun), 1e-12)
    assert abs(got.grad_max - ref.grad_max) <= FIT_REL * max(
        abs(ref.grad_max), 1e-12) + 1e-12


RULES = [
    ("sgd", {}), ("momentum", {}),
    ("sgd", {"momentum": 0.5, "nesterov": True}),
    ("adam", {}), ("adam", {"b1": 0.8, "eps_root": 1e-3, "nesterov": True}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1}),
    ("rmsprop", {}),
    ("rmsprop", {"momentum": 0.9, "bias_correction": True}),
    ("rmsprop", {"eps_in_sqrt": False, "initial_scale": 0.5}),
    ("adagrad", {}), ("adagrad", {"initial_accumulator_value": 0.0}),
]


@pytest.mark.parametrize("method,kw", RULES)
def test_rule_step_for_step_against_optax(method, kw):
    rs = np.random.RandomState(0)
    params = (rs.randn(5), rs.randn(3).astype(np.float32))
    jkw = {"momentum": 0.9, **kw} if method == "momentum" else kw
    ref_opt = getattr(optax, "sgd" if method == "momentum" else method)(
        0.1, **jkw)
    jp = tuple(jnp.asarray(p) for p in params)
    js = ref_opt.init(jp)
    init, update = topt._optimizer(method, 0.1, **kw)
    tp = tuple(torch.from_numpy(p.copy()) for p in params)
    ts = init(tp)
    for _ in range(25):
        g = (rs.randn(5), rs.randn(3).astype(np.float32))
        ups, js = ref_opt.update(tuple(jnp.asarray(v) for v in g), js, jp)
        jp = optax.apply_updates(jp, ups)
        tu, ts = update(tuple(torch.from_numpy(v.copy()) for v in g), ts, tp)
        tp = topt._apply_updates(tp, tu)
    got64, got32 = (p.numpy() for p in tp)
    ref64, ref32 = (np.asarray(p) for p in jp)
    assert got64.dtype == ref64.dtype and got32.dtype == ref32.dtype
    assert rel_err(got64, ref64) <= RULE_REL
    ulp = np.spacing(np.abs(ref32).astype(np.float32))
    assert np.all(np.abs(got32 - ref32) <= 4 * ulp), (got32, ref32)


def test_minimize_quadratic_converges(apps):
    target = np.random.RandomState(0).randn(6)

    def make(app):
        t = app.array(target, block_shape=(3,))

        def f(x):
            d = x - t
            return (d * d).sum()

        return f, app.array(np.zeros(6), block_shape=(3,))

    got, ref = both_minimize(apps, make, method="momentum",
                             learning_rate=0.1, steps=500, tol=1e-8)
    assert_same_fit(got, ref)
    assert got.converged and got.fun < 1e-8
    assert np.allclose(got.x.get(), target, atol=1e-4)


def test_minimize_least_squares_matches_closed_form(apps):
    rs = np.random.RandomState(1)
    X_np = rs.randn(60, 4)
    y_np = X_np @ np.array([1.0, -2.0, 0.5, 3.0]) + 0.01 * rs.randn(60)
    seen = {topt: [], jopt: []}

    def make(app):
        X = app.array(X_np, block_shape=(20, 4))
        y = app.array(y_np, block_shape=(20,))

        def loss(b):
            r = X @ b - y
            return (r * r).sum() * (1.0 / 60.0)

        return loss, app.array(np.zeros(4), block_shape=(4,))

    results = []
    for opt, app in ((topt, apps[1]), (jopt, apps[0])):
        f, b0 = make(app)
        results.append(opt.minimize(
            f, b0, method="adam", learning_rate=0.2, steps=800, tol=1e-7,
            callback=lambda it, v, g, opt=opt: seen[opt].append((it, v, g))))
    got, ref = results
    assert_same_fit(got, ref)
    want = np.linalg.lstsq(X_np, y_np, rcond=None)[0]
    assert np.allclose(got.x.get(), want, atol=1e-3)
    assert len(seen[topt]) == len(seen[jopt]) > 3
    assert [s[0] for s in seen[topt]] == [s[0] for s in seen[jopt]]
    assert rel_err([s[1] for s in seen[topt]],
                   [s[1] for s in seen[jopt]]) <= FIT_REL
    assert seen[topt][-1][1] < seen[topt][0][1] * 1e-3


def test_minimize_unknown_method(apps):
    for opt, app in ((topt, apps[1]), (jopt, apps[0])):
        x0 = app.array(np.zeros(2), block_shape=(2,))
        with pytest.raises(ValueError, match="unknown method"):
            opt.minimize(lambda v: (v * v).sum(), x0, method="nope")


def test_hvp_quadratic(apps):
    """H·v for f = x'Ax is (A + A')v."""
    rs = np.random.RandomState(2)
    A_np, x_np, v_np = rs.randn(5, 5), rs.randn(5), rs.randn(5)
    out = []
    for ad, app in ((tad, apps[1]), (jad, apps[0])):
        A = app.array(A_np, block_shape=(5, 5))
        x = app.array(x_np, block_shape=(5,))
        v = app.array(v_np, block_shape=(5,))
        out.append(ad.hvp(lambda u: (u @ (A @ u)).sum())(x, v).get())
    assert rel_err(out[0], out[1]) <= 1e-10
    assert np.allclose(out[0], (A_np + A_np.T) @ v_np, atol=1e-6)


def _lsq_problem(app, seed=3, n=40, w=(2.0, -1.0, 0.5)):
    rs = np.random.RandomState(seed)
    X_np = rs.randn(n, len(w))
    y_np = X_np @ np.array(w)
    X = app.array(X_np, block_shape=(20, len(w)))
    y = app.array(y_np, block_shape=(20,))

    def loss(b):
        r = X @ b - y
        return (r * r).sum() * (1.0 / n)

    return loss, app.array(np.zeros(len(w)), block_shape=(len(w),))


@pytest.mark.parametrize("method", ["momentum", "adam", "sgd", "adagrad"])
def test_minimize_fused_matches_reference_fused(apps, method):
    """fused=True: the reference's while_loop results (n_iter counts the
    step on which max|g| <= tol was seen), and equal to the port's eager
    loop within the reference's own tolerance."""
    kw = dict(method=method, learning_rate=0.2, steps=300, tol=1e-9,
              fused=True)
    got, ref = both_minimize(apps, _lsq_problem, **kw)
    assert_same_fit(got, ref)
    eager = topt.minimize(*_lsq_problem(apps[1]), **{**kw, "fused": False})
    assert fused_vs_eager_ok(got, eager)
    again = topt.minimize(*_lsq_problem(apps[1]), **kw)
    assert np.array_equal(again.x.get(), got.x.get())


def fused_vs_eager_ok(fused, eager):
    return (fused.converged == eager.converged
            and np.allclose(fused.x.get(), eager.x.get(), atol=1e-6)
            and abs(fused.fun - eager.fun) < 1e-8)


@pytest.mark.parametrize("steps", [5, 31, 32, 33, 64, 70])
def test_minimize_fused_mask_freezes_between_syncs(apps, steps):
    """The device-side flag stops the parameters and the count between
    the host's reads: converging at any step, or running out of steps at
    any offset from a read, gives the reference's n_iter and x."""
    for tol in (1e-3, 0.0):
        kw = dict(method="momentum", learning_rate=0.2, steps=steps,
                  tol=tol, fused=True)
        got, ref = both_minimize(apps, _lsq_problem, **kw)
        assert_same_fit(got, ref)


def test_minimize_fused_matches_eager(apps):
    """The reference's own test: fused and eager agree."""
    kw = dict(method="momentum", learning_rate=0.2, steps=300, tol=1e-9)
    eager, ref_eager = both_minimize(apps, _lsq_problem, **kw)
    fused, _ = both_minimize(apps, _lsq_problem, fused=True, **kw)
    assert_same_fit(eager, ref_eager)
    assert fused_vs_eager_ok(fused, eager)


@pytest.mark.parametrize("fused", [False, True])
def test_minimize_multi_parameter(apps, fused):
    rs = np.random.RandomState(4)
    X_np = rs.randn(50, 3)
    y_np = X_np @ np.array([1.0, -0.5, 2.0]) + 0.7

    def make(app):
        X = app.array(X_np, block_shape=(25, 3))
        y = app.array(y_np, block_shape=(25,))

        def loss(w, b):
            r = X @ w + b.sum() - y
            return (r * r).sum() * (1.0 / 50.0)

        return loss, (app.array(np.zeros(3), block_shape=(3,)),
                      app.array(np.zeros(1), block_shape=(1,)))

    got, ref = both_minimize(apps, make, method="adam", learning_rate=0.1,
                             steps=1200, tol=1e-8, fused=fused)
    assert_same_fit(got, ref)
    w_fit, b_fit = got.x
    assert np.allclose(w_fit.get(), [1.0, -0.5, 2.0], atol=1e-3)
    assert np.isclose(float(b_fit.get()[0]), 0.7, atol=1e-3)
    assert got.fun < 1e-6


@pytest.mark.parametrize("fused", [False, True])
def test_minimize_mixed_dtype_params(apps, fused):
    """float32 weights and a float64 bias on both paths."""
    rs = np.random.RandomState(5)
    X_np = rs.randn(30, 2).astype(np.float32)
    y_np = (X_np @ np.array([1.0, -1.0], np.float32)) + 0.3

    def make(app):
        X = app.array(X_np, block_shape=(15, 2))
        y = app.array(y_np, block_shape=(15,))

        def loss(w, b):
            r = X @ w + b.sum() - y
            return (r * r).sum()

        return loss, (app.array(np.zeros(2, np.float32), block_shape=(2,)),
                      app.array(np.zeros(1), block_shape=(1,)))

    got, ref = both_minimize(apps, make, method="momentum",
                             learning_rate=0.01, steps=400, tol=1e-6,
                             fused=fused)
    w_fit, b_fit = got.x
    assert w_fit.dtype == np.float32 and b_fit.dtype == np.float64
    assert np.allclose(w_fit.get(), [1.0, -1.0], atol=1e-2)
    assert np.isclose(float(b_fit.get()[0]), 0.3, atol=1e-2)
    for g, r in zip(_host(got.x), _host(ref.x)):
        assert g.dtype == r.dtype
        assert rel_err(g, r) <= 1e-5  # float32 sums in another order


@pytest.mark.parametrize("fused", [False, True])
def test_minimize_rejects_shared_buffers(apps, fused):
    for opt, app in ((topt, apps[1]), (jopt, apps[0])):
        x = app.array(np.ones(3), block_shape=(3,))
        with pytest.raises(ValueError, match="share the same underlying"):
            opt.minimize(lambda a, b: (a * b).sum(), (x, x), fused=fused,
                         steps=2)


def test_minimize_fused_rejects_a_host_sync(torch_app):
    """The purity guard holds inside minimize too."""
    x0 = torch_app.array(np.ones(3), block_shape=(3,))

    def f(v):
        s = (v * v).sum()
        s.get()
        return s

    with pytest.raises(RuntimeError, match="INSIDE the traced function"):
        topt.minimize(f, x0, fused=True, steps=3)


@pytest.mark.parametrize("method,kw", [
    ("adam", {"mu_dtype": "bfloat16"}),
    ("sgd", {"accumulator_dtype": "bfloat16"}),
    ("adamw", {"mask": None}),
    ("rmsprop", {"centered": True}),
])
def test_untaken_optax_options_raise(torch_app, method, kw):
    x0 = torch_app.array(np.ones(2), block_shape=(2,))
    with pytest.raises(TypeError):
        topt.minimize(lambda v: (v * v).sum(), x0, method=method, steps=1,
                      **kw)
