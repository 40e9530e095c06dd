"""Automatic differentiation through the distributed NumPy API.

Counterpart of ``nums_tpu/autodiff.py``. A user function written against
the public API (facade ops, operators, reductions, linalg) is
differentiable end to end:

    import nums_tpu_torch
    from nums_tpu_torch import autodiff

    def loss(beta):                      # plain nums_tpu_torch code
        r = X @ beta - y
        return (r * r).sum()

    g = autodiff.grad(loss)(beta)        # BlockArray gradient
    val, g = autodiff.value_and_grad(loss)(beta)

The reference transposes its lazy op DAG into one XLA program; here every
op runs eagerly on torch tensors, so the gradient is ``torch.autograd``'s:
each differentiated argument is rebuilt as a BlockArray over a detached
leaf tensor (``requires_grad=True``, the same grid and layout), ``f`` runs
on the rebuilt arguments, and ``torch.autograd.grad`` is taken of its
scalar output. ``x.T @ x`` reaches the gram kernel with its own backward
(``cuda_gram.GramFunction``). ``torch.func`` would trace ``f`` instead,
and cannot see the kernels, which are ctypes calls.

A host sync inside ``f`` (``.get``, ``float()``, boolean tests, ``print``)
raises ``RuntimeError``, as in the reference, where it would sever the
recorded graph: the port counts the thread's transfers to the host
(``backend.host_sync_count``). There is no program cache (each call runs
``f`` again) and no lazy-batching requirement.
"""

import numpy as np
import torch

from nums_tpu_torch.core import backend as _backend
from nums_tpu_torch.core.array.blockarray import BlockArray

__all__ = ["grad", "value_and_grad", "hvp", "check_grad"]


def _normalize_argnums(argnums):
    if isinstance(argnums, int):
        return (argnums,), True
    return tuple(argnums), False


def _rebuild(raw, template: BlockArray) -> BlockArray:
    """New BlockArray with ``template``'s grid/backend/transpose over a
    same-layout raw tensor (gradient/update results)."""
    return BlockArray(raw, template.grid.copy(), template.backend,
                      transposed=template.is_transposed)


def _leaf(a: BlockArray):
    """(leaf tensor, BlockArray over it): ``a``'s raw tensor detached and
    requiring grad, in ``a``'s layout."""
    leaf = a.raw.detach().requires_grad_(True)
    return leaf, _rebuild(leaf, a)


def _trace_pure(f, args, kwargs):
    """Run ``f`` under autograd, verifying that no host sync fired inside
    it: the reference raises there, since a sync severs its recorded
    graph and a gradient would treat the synced values as constants."""
    before = _backend.host_sync_count()
    with torch.enable_grad():
        out = f(*args, **kwargs)
    if _backend.host_sync_count() != before:
        raise RuntimeError(
            "a host sync (get/float/bool/print/...) fired INSIDE the "
            "traced function: the synced subexpressions were materialized "
            "and a gradient would silently treat them as constants. "
            "Remove syncs from the traced function."
        )
    return out


def _check_distinct(arrays, what):
    if len({id(a.raw) for a in arrays}) != len(arrays):
        raise ValueError(
            f"two {what} share the same underlying buffer (the same "
            "array, or views like x and x.T); pass distinct arrays or "
            "differentiate one argument."
        )


def _scalar_out(out):
    assert isinstance(out, BlockArray) and out.shape == (), (
        "f must return a SCALAR BlockArray (shape ()); got "
        f"{getattr(out, 'shape', type(out))}"
    )
    return out.data


def _grads(root, leaves, nums, create_graph=False):
    """d root / d leaf for each leaf; an argument that ``root`` does not
    depend on raises, as in the reference."""
    if not root.requires_grad:
        gs = [None] * len(leaves)
    else:
        with torch.enable_grad():
            gs = torch.autograd.grad(root, leaves, allow_unused=True,
                                     create_graph=create_graph)
    for i, g in zip(nums, gs):
        if g is None:
            raise RuntimeError(
                f"argument {i} is not reachable in f's recorded op "
                "graph — the output does not depend on it."
            )
    return gs


def _rebuilt_args(args, nums):
    """The arguments with each differentiated one rebuilt over a leaf."""
    args = list(args)
    wrt, leaves = [], []
    for i in nums:
        a = args[i]
        assert isinstance(a, BlockArray), (
            f"argnums={i} must be a BlockArray, got {type(a)}"
        )
        wrt.append(a)
    _check_distinct(wrt, "differentiated arguments")
    for i, a in zip(nums, wrt):
        leaf, args[i] = _leaf(a)
        leaves.append(leaf)
    return args, wrt, leaves


def value_and_grad(f, argnums=0):
    """``wrapped(*args) -> (value, grads)`` for a scalar-valued ``f``
    written against the BlockArray/facade API.

    ``argnums`` selects which positional BlockArray arguments to
    differentiate with respect to (int or tuple). The value is a scalar
    BlockArray; each gradient is a BlockArray with the argument's grid.
    """
    nums, single = _normalize_argnums(argnums)

    def wrapped(*args, **kwargs):
        args, wrt, leaves = _rebuilt_args(args, nums)
        out = _trace_pure(f, args, kwargs)
        root = _scalar_out(out)
        gs = _grads(root, leaves, nums)
        val_ba = BlockArray.from_torch(root.detach(), backend=wrt[0].backend)
        grad_bas = tuple(_rebuild(g, a) for g, a in zip(gs, wrt))
        return val_ba, (grad_bas[0] if single else grad_bas)

    return wrapped


def grad(f, argnums=0):
    """Gradient-only variant of :func:`value_and_grad`."""
    vag = value_and_grad(f, argnums=argnums)

    def wrapped(*args, **kwargs):
        return vag(*args, **kwargs)[1]

    return wrapped


def hvp(f, argnums=0):
    """Hessian-vector product: ``wrapped(*args, v) -> BlockArray``
    computing ∂²f · v for a single differentiated argument, reverse over
    reverse (the gradient of ``g·v`` with the first gradient's graph
    kept), the value of the reference's forward over reverse."""
    nums, single = _normalize_argnums(argnums)
    assert single, "hvp supports a single argnum"
    (i,) = nums

    def wrapped(*args_and_v, **kwargs):
        *args, v = args_and_v
        a = args[i]
        assert isinstance(a, BlockArray) and isinstance(v, BlockArray)
        assert v.shape == a.shape, (v.shape, a.shape)
        if v.block_shape != a.block_shape:
            # The reference reblocks a tangent of another layout to the
            # primal's; here blocking is metadata, kept for parity.
            v = v.reshape(a.shape, block_shape=a.block_shape)
        args, _, (leaf,) = _rebuilt_args(args, nums)
        out = _trace_pure(f, args, kwargs)
        root = _scalar_out(out)
        (g,) = _grads(root, [leaf], nums, create_graph=True)
        # The tangent in the leaf's (raw) layout.
        tangent = v.data.T if a.is_transposed else v.data
        tangent = tangent.to(g.dtype)
        with torch.enable_grad():
            gv = (g * tangent).sum()
        if gv.requires_grad:
            (res,) = torch.autograd.grad(gv, [leaf], allow_unused=True)
        else:
            res = None
        if res is None:  # f is linear in the argument
            res = torch.zeros_like(leaf)
        return _rebuild(res.detach(), a)

    return wrapped


def check_grad(f, args, argnums=0, eps=1e-5, atol=1e-3):
    """Finite-difference check (testing utility): max abs deviation
    between autodiff and central differences on the LOGICAL entries."""
    from nums_tpu_torch.core.application_manager import instance

    nums, single = _normalize_argnums(argnums)
    _, grads = value_and_grad(f, argnums=argnums)(*args)
    if single:
        grads = (grads,)
    app = instance()
    worst = 0.0
    for i, g in zip(nums, grads):
        a = args[i]
        host = np.asarray(a.get(), dtype=np.float64)
        g_host = np.asarray(g.get(), dtype=np.float64)
        it = np.nditer(host, flags=["multi_index"])
        for _ in it:
            ix = it.multi_index
            hp = host.copy()
            hp[ix] += eps
            hm = host.copy()
            hm[ix] -= eps
            app_args = list(args)
            app_args[i] = app.array(hp, block_shape=a.block_shape)
            fp = float(f(*app_args).get())
            app_args[i] = app.array(hm, block_shape=a.block_shape)
            fm = float(f(*app_args).get())
            fd = (fp - fm) / (2 * eps)
            worst = max(worst, abs(fd - g_host[ix]))
    assert worst <= atol, f"max grad deviation {worst} > {atol}"
    return worst
