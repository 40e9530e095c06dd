"""Generic first-order optimization over BlockArray objectives.

Counterpart of ``nums_tpu/optimize.py``. ``minimize`` drives any scalar
function written against the public array API: gradients come from
:mod:`nums_tpu_torch.autodiff`, parameter updates from the optax rules
that the reference uses (sgd, momentum, adam, adamw, rmsprop, adagrad),
written here in torch on the parameter tensors with optax 0.2.6's
arithmetic and defaults.

    from nums_tpu_torch import optimize

    def loss(beta):
        r = X @ beta - y
        return (r * r).sum() / len(y_np)

    result = optimize.minimize(loss, beta0, method="adam",
                               learning_rate=0.1, steps=200)
    result.x, result.fun, result.n_iter

``fused=True`` returns what the reference's on-device ``while_loop``
returns (the same ``n_iter``, ``x``, ``fun`` and ``grad_max``): the port
keeps a "still running" flag on the device that freezes the parameters,
the optimizer state and the step count once max|g| <= tol, and reads it
on the host every ``FUSED_SYNC_EVERY`` steps, where the reference syncs
never.
"""

import dataclasses

import torch

from nums_tpu_torch import autodiff
from nums_tpu_torch.core.array.blockarray import BlockArray

__all__ = ["minimize", "OptimizeResult"]

# Steps between the fused loop's host reads of its "still running" flag.
FUSED_SYNC_EVERY = 32


@dataclasses.dataclass
class OptimizeResult:
    x: "BlockArray | tuple"  # final parameters (tuple iff x0 was one)
    fun: float             # final objective value
    grad_max: float        # max|g| at the final iterate
    n_iter: int
    converged: bool


# ---------------------------------------------------------------------
# The optax rules. A rule is (init, update): ``init(params)`` gives the
# state, a dict of tuples of tensors (one per parameter) and 0-d tensors;
# ``update(grads, state, params)`` gives (updates, new state). Python
# floats act as jax's weak scalars: each parameter keeps its dtype.
# ---------------------------------------------------------------------


def _count_inc(count):
    """``optax.safe_increment`` of an int32 count."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1,
                       count)


def _bias_correction(moments, decay, count):
    """``optax.tree.bias_correction``: ``t / (1 - decay**count)``, the
    correction in float64 and cast to each moment's dtype."""
    bc = 1.0 - torch.pow(torch.tensor(decay, dtype=torch.float64,
                                      device=count.device),
                         count.to(torch.float64))
    return tuple(t / bc.to(t.dtype) for t in moments)


def _moment(grads, moments, decay, order):
    """``optax.tree.update_moment``: (1 - decay)·g^order + decay·t."""
    return tuple((1 - decay) * (g if order == 1 else g * g) + decay * t
                 for g, t in zip(grads, moments))


def _scale_by_lr(lr):
    step = -1 * lr

    def apply(updates):
        return tuple(step * u for u in updates)

    return apply


def _trace(decay, nesterov):
    """``optax.trace`` (sgd's momentum)."""

    def init(params):
        return {"trace": tuple(torch.zeros_like(p) for p in params)}

    def update(grads, state):
        new = tuple(g + decay * t for g, t in zip(grads, state["trace"]))
        ups = (tuple(g + decay * t for g, t in zip(grads, new))
               if nesterov else new)
        return ups, {"trace": new}

    return init, update


def _sgd(learning_rate, momentum=None, nesterov=False):
    lr = _scale_by_lr(learning_rate)
    if momentum is None:
        return (lambda params: {},
                lambda grads, state, params: (lr(grads), state))
    t_init, t_update = _trace(momentum, nesterov)

    def update(grads, state, params):
        ups, state = t_update(grads, state)
        return lr(ups), state

    return t_init, update


def _adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
          nesterov=False, weight_decay=None):
    """``optax.adam``, and ``optax.adamw`` with ``weight_decay``."""
    lr = _scale_by_lr(learning_rate)

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=params[0].device),
                "mu": tuple(torch.zeros_like(p) for p in params),
                "nu": tuple(torch.zeros_like(p) for p in params)}

    def update(grads, state, params):
        mu = _moment(grads, state["mu"], b1, 1)
        nu = _moment(grads, state["nu"], b2, 2)
        count = _count_inc(state["count"])
        if nesterov:
            mu_hat = tuple(
                b1 * m + (1 - b1) * g for m, g in zip(
                    _bias_correction(mu, b1, _count_inc(count)),
                    _bias_correction(grads, b1, count)))
        else:
            mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        ups = tuple(m / (torch.sqrt(v + eps_root) + eps)
                    for m, v in zip(mu_hat, nu_hat))
        if weight_decay is not None:
            ups = tuple(u + weight_decay * p for u, p in zip(ups, params))
        return lr(ups), {"count": count, "mu": mu, "nu": nu}

    return init, update


def _adamw(learning_rate, weight_decay=1e-4, **kw):
    return _adam(learning_rate, weight_decay=weight_decay, **kw)


def _rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0,
             eps_in_sqrt=True, momentum=None, nesterov=False,
             bias_correction=False):
    """``optax.rmsprop`` (not centered)."""
    lr = _scale_by_lr(learning_rate)
    t_init, t_update = (_trace(momentum, nesterov) if momentum is not None
                        else (None, None))

    def init(params):
        state = {"nu": tuple(torch.full_like(p, initial_scale)
                             for p in params),
                 "count": torch.zeros((), dtype=torch.int32,
                                      device=params[0].device)}
        if t_init is not None:
            state.update(t_init(params))
        return state

    def update(grads, state, params):
        nu = _moment(grads, state["nu"], decay, 2)
        count = state["count"]
        nu_hat = nu
        if bias_correction:
            count = _count_inc(count)
            nu_hat = _bias_correction(nu, decay, count)
        if eps_in_sqrt:
            scaling = tuple(torch.rsqrt(n + eps) for n in nu_hat)
        else:
            scaling = tuple(1 / (torch.sqrt(n) + eps) for n in nu_hat)
        ups = lr(tuple(s * g for s, g in zip(scaling, grads)))
        new = {"nu": nu, "count": count}
        if t_update is not None:
            ups, tr = t_update(ups, state)
            new.update(tr)
        return ups, new

    return init, update


def _adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    lr = _scale_by_lr(learning_rate)

    def init(params):
        return {"sum_of_squares": tuple(
            torch.full_like(p, initial_accumulator_value) for p in params)}

    def update(grads, state, params):
        sos = tuple(g * g + t for g, t in zip(grads,
                                               state["sum_of_squares"]))
        inv = tuple(torch.where(t > 0, torch.rsqrt(t + eps),
                                torch.zeros_like(t)) for t in sos)
        return (lr(tuple(s * g for s, g in zip(inv, grads))),
                {"sum_of_squares": sos})

    return init, update


_TABLE = {
    "sgd": _sgd,
    "momentum": lambda lr, **kw: _sgd(lr, **{"momentum": 0.9, **kw}),
    "adam": _adam,
    "adamw": _adamw,
    "rmsprop": _rmsprop,
    "adagrad": _adagrad,
}


def _optimizer(method, learning_rate, **kw):
    """(init, update) of ``method``, with optax's defaults."""
    if method not in _TABLE:
        raise ValueError(f"unknown method {method!r}; one of {list(_TABLE)}")
    return _TABLE[method](learning_rate, **kw)


def _apply_updates(params, updates):
    """``optax.apply_updates``: p + u in p's dtype."""
    return tuple((p + u).to(p.dtype) for p, u in zip(params, updates))


def _state_where(cond, new, old):
    """The state (or a tuple of tensors) ``new`` where ``cond``, else
    ``old``."""
    if isinstance(new, dict):
        return {k: _state_where(cond, new[k], old[k]) for k in new}
    if isinstance(new, tuple):
        return tuple(_state_where(cond, a, b) for a, b in zip(new, old))
    return torch.where(cond, new, old)


def _absmax(g):
    """max|g| of one parameter in float32. On the mesh each process takes
    its own box (0 where the box is empty: a parameter shorter than the
    mesh leaves some process none) and one all-reduce (MAX) joins them, so
    every process makes the same collective."""
    from nums_tpu_torch.core import multiprocess
    from nums_tpu_torch.core.ops import mesh_ops

    if not mesh_ops.is_dtensor(g):
        return g.abs().max().to(torch.float32)
    local = g.to_local().reshape(-1)
    m = (local.abs().max().to(torch.float32) if local.numel()
         else torch.zeros((), dtype=torch.float32, device=local.device))
    return multiprocess.all_reduce_(m.reshape(1), "max")[0]


def _gmax(grads):
    """max|g| over every parameter, in float32 (the reference's carry)."""
    return torch.stack([_absmax(g) for g in grads]).max()


# ---------------------------------------------------------------------
# minimize
# ---------------------------------------------------------------------


def minimize(f, x0: BlockArray, method: str = "adam",
             learning_rate: float = 0.1, steps: int = 200,
             tol: float = 1e-6, callback=None, fused: bool = False,
             **optimizer_kwargs):
    """Minimize scalar ``f(x)`` starting from BlockArray ``x0``.

    Each step runs ``f`` and its gradient (``autodiff.value_and_grad``)
    and one optimizer update on the parameter tensors; the convergence
    test max|g| <= tol costs one scalar sync per step, as the reference's
    eager loop does. ``callback(step, value, grad_max)`` observes
    progress.

    ``x0`` may be a single BlockArray or a TUPLE of BlockArrays
    (multi-parameter models — ``f`` then takes one argument per
    parameter and ``result.x`` is a tuple).

    ``fused=True`` returns what the reference's fused ``while_loop``
    returns, with one host sync every ``FUSED_SYNC_EVERY`` steps (see the
    module docstring; no callback).
    """
    multi = isinstance(x0, (tuple, list))
    xs = tuple(x0) if multi else (x0,)
    for x in xs:
        assert isinstance(x, BlockArray), type(x)
    if len({id(x.raw) for x in xs}) != len(xs):
        raise ValueError(
            "parameters share the same underlying buffer (the same "
            "array, or views like x and x.T); pass distinct arrays."
        )
    init, update = _optimizer(method, learning_rate, **optimizer_kwargs)
    vag = autodiff.value_and_grad(f, argnums=tuple(range(len(xs))))
    if fused:
        assert callback is None, "fused=True runs on-device (no callback)"
        return _minimize_fused(vag, xs, multi, init, update, int(steps),
                               float(tol))
    with torch.no_grad():
        opt_state = init(tuple(x.raw for x in xs))

    # Invariant: fun and grad_max in the result are evaluated AT the
    # returned x (both exit paths), so res.fun == f(res.x).
    def result(xs, val_ba, gmax, it):
        return OptimizeResult(
            x=xs if multi else xs[0], fun=float(val_ba.get()),
            grad_max=gmax, n_iter=it, converged=gmax <= tol,
        )

    it = 0
    for it in range(1, int(steps) + 1):
        val_ba, gs = vag(*xs)
        gmax = float(_gmax([g.raw for g in gs]))
        if callback is not None:
            callback(it, float(val_ba.get()), gmax)
        if gmax <= tol:
            return result(xs, val_ba, gmax, it)
        with torch.no_grad():
            raws = tuple(x.raw for x in xs)
            updates, opt_state = update(tuple(g.raw for g in gs),
                                        opt_state, raws)
            new_raws = _apply_updates(raws, updates)
        xs = tuple(autodiff._rebuild(r, t) for r, t in zip(new_raws, xs))
    val_ba, gs = vag(*xs)  # evaluate at the final (returned) iterate
    gmax = float(_gmax([g.raw for g in gs]))
    return result(xs, val_ba, gmax, it)


def _minimize_fused(vag, xs, multi, init, update, steps, tol):
    """The reference's ``lax.while_loop`` as a masked loop: a step runs
    while ``it < steps`` and the previous step's max|g| > tol; a stopped
    loop keeps computing gradients at frozen parameters until its next
    host read of the flag."""
    params = tuple(x.raw.detach() for x in xs)
    device = params[0].device
    with torch.no_grad():
        state = init(params)
    it = torch.zeros((), dtype=torch.int32, device=device)
    gmax = torch.tensor(float("inf"), dtype=torch.float32, device=device)
    running = torch.ones((), dtype=torch.bool, device=device)

    def wrap(raws):
        return tuple(autodiff._rebuild(r, t) for r, t in zip(raws, xs))

    for step in range(steps):
        if step and step % FUSED_SYNC_EVERY == 0 and not bool(running):
            break
        _, gs = vag(*wrap(params))
        with torch.no_grad():
            gs = tuple(g.raw for g in gs)
            ups, new_state = update(gs, state, params)
            new_params = _apply_updates(params, ups)
            params = _state_where(running, new_params, params)
            state = _state_where(running, new_state, state)
            it = it + running.to(torch.int32)
            gmax = torch.where(running, _gmax(gs), gmax)
            running = running & (it < steps) & (gmax > tol)
    outs = wrap(params)
    val, g_final = vag(*outs)  # value AND gradient at the returned params
    gmax_f = float(_gmax([g.raw for g in g_final]))
    return OptimizeResult(
        x=outs if multi else outs[0], fun=float(val.get()),
        grad_max=gmax_f, n_iter=int(it), converged=gmax_f <= tol,
    )
