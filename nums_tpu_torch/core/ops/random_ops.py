"""Random sampling on threefry2x32 counters.

Counterpart of ``nums_tpu/core/ops/random_ops.py`` and of the
``jax.random`` functions it calls (the ``jr_*`` functions below, each
following jax's algorithm draw for draw: which key is split, which sub-key
feeds which draw, which width the bits have). The bits come from
``core/ops/threefry.py``; a sample is ONE whole array at the logical
shape, deterministic in (key, shape) and independent of the block shape,
and for the same key it is the array the reference draws: bit for bit for
raw bits, ``random``, ``integers``, ``permutation``, ``shuffle``,
``choice`` and the ``hypergeometric`` chain, and to the rounding of one
transcendental (torch's ``erfinv``, ``log``, ... are not XLA's
polynomials) for the continuous distributions. Where a ``floor`` or an
accept test sits on such a rounded value, a rare element may take the
other branch.

Every sampler is a plain function ``fn(key, shape, dtype, device, x64,
*params)``: nothing is compiled or cached, and the serial backend has no
pad. ``dtype`` is a torch dtype. ``x64`` says which of the reference's two
modes is reproduced: with it (a CPU backend, whose default float is
float64) Python scalars are float64 and the default integer is int64, as
in jax with 64-bit types on; without it (a CUDA backend) they are float32
and int32, as in the reference on an accelerator. The one-key
elementwise draws (``jr_uniform`` and what is built on it in place) are
made in chunks, so a 10 GB normal needs its output and a bounded scratch.

On the mesh each process draws its own box of a sample
(``sample_region``), the box of the whole draw bit for bit: a
position-wise sampler from its positions' bits alone; the looped ones
(Poisson, binomial and what is built on them, whose rejection loops keep
each element's last accepted proposal until no element of the whole draw
is left) with the loop's flag combined over the mesh once a round; a
permutation by the mesh's sample sort (``mesh_permutation``).
"""

import math

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import threefry

_NP_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def _np_float(dtype):
    if dtype not in _NP_FLOAT:
        raise TypeError(f"sampling needs float32 or float64, got {dtype}")
    return _NP_FLOAT[dtype]


def _wide(x64: bool) -> torch.dtype:
    """The dtype a Python float takes in the reference's mode."""
    return torch.float64 if x64 else torch.float32


def _default_int(x64: bool) -> torch.dtype:
    return torch.int64 if x64 else torch.int32


def _size(shape) -> int:
    return int(math.prod(shape))


def _draw_shape(shape, where):
    """The shape a draw takes: ``shape``, or with a region's ``where``
    (``flat_range=(start, stop)`` or ``runs=(starts, length)``) the
    region's flat range or its rows of runs."""
    if not where:
        return tuple(shape)
    if where.get("flat_range") is not None:
        start, stop = where["flat_range"]
        return (int(stop) - int(start),)
    starts, length = where["runs"]
    return (int(starts.numel()), int(length))


def _region_positions(where, device, a=0, b=None):
    """The flat positions of a region (``_draw_shape``'s), in its order;
    of its elements ``[a, b)`` alone where given."""
    if where.get("flat_range") is not None:
        start, stop = where["flat_range"]
        b = int(stop) - int(start) if b is None else b
        return torch.arange(int(start) + a, int(start) + b,
                            dtype=torch.int64, device=device)
    starts, length = where["runs"]
    b = int(starts.numel()) * int(length) if b is None else b
    i = torch.arange(a, b, dtype=torch.int64, device=device)
    return starts.to(device)[torch.div(i, int(length),
                                       rounding_mode="floor")] \
        + torch.remainder(i, int(length))


# ---------------------------------------------------------------------
# jax.random's samplers
# ---------------------------------------------------------------------


def _bits_to_unit(bits, dtype):
    """Raw bits -> floats in [0, 1), in place: the mantissa bits under the
    exponent of 1.0, bitcast, minus 1."""
    if dtype == torch.float32:
        bits.bitwise_right_shift_(9).bitwise_and_(0x007FFFFF)
        bits.bitwise_or_(0x3F800000)
    else:
        bits.bitwise_right_shift_(12).bitwise_and_((1 << 52) - 1)
        bits.bitwise_or_(0x3FF0000000000000)
    return bits.view(dtype).sub_(1.0)


def _scale_unit(floats, dtype, minval, maxval):
    """[0, 1) floats -> [minval, maxval), in place, as jax's ``_uniform``:
    ``max(minval, floats * (maxval - minval) + minval)`` with the bounds
    rounded to ``dtype`` first."""
    npdt = _np_float(dtype)
    lo, hi = npdt(minval), npdt(maxval)
    if lo == 0 and hi == 1:
        return floats
    return floats.mul_(float(hi - lo)).add_(float(lo)).clamp_(min=float(lo))


def _flat_draw(key, shape, dtype, device, width, transform, flat_range,
               chunk, runs=None):
    """A new tensor of ``shape`` (or, with ``flat_range=(start, stop)``,
    that 1-d range of its row-major positions; or, with ``runs=(starts,
    length)``, one row of ``length`` positions from each start) filled
    chunk by chunk with ``transform(bits)``."""
    shape = tuple(int(s) for s in shape)
    if runs is not None:
        starts, length = runs
        out = torch.empty((int(starts.numel()), int(length)), dtype=dtype,
                          device=device)
        return threefry.fill_runs(key, out, width, starts, transform, chunk)
    if flat_range is None:
        out = torch.empty(shape, dtype=dtype, device=device)
        threefry.fill_bits(key, out.view(-1), width, 0, transform, chunk)
        return out
    start, stop = flat_range
    assert 0 <= start <= stop <= _size(shape), (flat_range, shape)
    out = torch.empty(stop - start, dtype=dtype, device=device)
    return threefry.fill_bits(key, out, width, start, transform, chunk)


def jr_uniform(key, shape, dtype, device, minval=0.0, maxval=1.0,
               flat_range=None, chunk=None, runs=None):
    """``jax.random.uniform``: 32 bits per float32, 64 per float64."""
    _np_float(dtype)
    width = 32 if dtype == torch.float32 else 64
    return _flat_draw(
        key, shape, dtype, device, width,
        lambda bits: _scale_unit(_bits_to_unit(bits, dtype), dtype,
                                 minval, maxval),
        flat_range, chunk, runs)


# Giles' single-precision erfinv (the polynomial XLA evaluates for a
# float32 ``erf_inv``): coefficients in w - 2.5 for w < 5, in sqrt(w) - 3
# above, w = -log1p(-x*x).
_ERFINV32_CENTRAL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_TAIL = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _horner(w, coefficients):
    p = torch.full_like(w, coefficients[0])
    for c in coefficients[1:]:
        p.mul_(w).add_(c)
    return p


def _erfinv32(x):
    """erfinv of a float32 tensor, in place, by the polynomial the
    reference's compiler uses: up to 90 ulp from the true value in the
    tails (relative 6e-6), which is why ``torch.erfinv``, good to 2 ulp,
    cannot stand in for it when the values must be the reference's. The
    tail polynomial runs only on the elements that need it (|x| above
    0.9966, one in 300)."""
    w = (x * x).neg_().log1p_().neg_()
    tail = torch.nonzero(w >= 5.0).reshape(-1)
    p = _horner(w.sub_(2.5), _ERFINV32_CENTRAL)
    if tail.numel():
        wt = w[tail].add_(2.5).sqrt_().sub_(3.0)
        p[tail] = _horner(wt, _ERFINV32_TAIL)
    edge = x.abs() == 1.0
    x.mul_(p)
    if bool(edge.any()):
        x[edge] = torch.sign(x[edge]) * float("inf")
    return x


def _normal_of_uniform(u):
    """sqrt(2)·erfinv(u) in place, u uniform on (-1, 1). float32 takes the
    reference's polynomial; float64 ``torch.erfinv`` (both it and the
    reference's rational form are good to 1e-12 there)."""
    npdt = _np_float(u.dtype)
    if u.dtype == torch.float32:
        flat = u.reshape(-1)
        _erfinv32(flat)
    else:
        torch.erfinv(u, out=u)
    return u.mul_(float(npdt(np.sqrt(2))))


def _normal_bounds(dtype):
    npdt = _np_float(dtype)
    return float(np.nextafter(npdt(-1.0), npdt(0.0), dtype=npdt)), 1.0


def jr_normal(key, shape, dtype, device, flat_range=None, chunk=None,
              runs=None):
    """``jax.random.normal``: a uniform on (nextafter(-1, 0), 1) through
    sqrt(2)·erfinv, chunk by chunk."""
    lo, hi = _normal_bounds(dtype)
    width = 32 if dtype == torch.float32 else 64
    return _flat_draw(
        key, shape, dtype, device, width,
        lambda bits: _normal_of_uniform(_scale_unit(
            _bits_to_unit(bits, dtype), dtype, lo, hi)),
        flat_range, chunk, runs)


def _wrap_signed(x, nbits):
    """int64 values reduced to the signed ``nbits``-bit range."""
    if nbits == 64:
        return x
    half = 1 << (nbits - 1)
    return x.add_(half).bitwise_and_((1 << nbits) - 1).sub_(half)


def _urem64(x, span: int):
    """Unsigned 64-bit remainder of bit patterns held in int64, by a
    Python int ``span`` in [0, 2**64). A zero span leaves x (XLA's rem)."""
    if span == 0:
        return x
    if span >= 1 << 63:
        # x mod span is x or x - span; compare unsigned by flipping the
        # sign bit.
        s = span - (1 << 64)
        flip = -(1 << 63)
        return torch.where((x ^ flip) >= (s ^ flip), x - s, x)
    pos = torch.remainder(x, span)
    # For a negative pattern u = x + 2**64: u = 2·(u >> 1) + (u & 1).
    half = torch.remainder(
        x.bitwise_right_shift(1).bitwise_and_((1 << 63) - 1), span)
    bit = x.bitwise_and(1)
    room = (span - half) - bit
    neg = torch.where(half >= room, half - room, half + half + bit)
    return torch.where(x >= 0, pos, neg)


def jr_randint(key, shape, minval: int, maxval: int, dtype, device, x64,
               flat_range=None, chunk=None, runs=None):
    """``jax.random.randint``: twice the dtype's bits per value, folded by
    ``(hi % span) * (2**nbits % span) + lo % span`` in wrapping unsigned
    arithmetic, bias, ``span == 0`` wrap and ``maxval <= minval`` included.
    Dtypes under 32 bits sample at int32."""
    info = torch.iinfo(dtype)
    minval, maxval = int(minval), int(maxval)
    sample_dtype = dtype
    if info.bits < 32:
        sample_dtype = torch.int32
        minval = min(max(minval, info.min), info.max)
        maxval = min(max(maxval, info.min), info.max + 1)
    sinfo = torch.iinfo(sample_dtype)
    nbits = sinfo.bits
    full = 1 << nbits
    out_of_range = maxval > sinfo.max
    minval = min(max(minval, sinfo.min), sinfo.max)
    maxval = min(max(maxval, sinfo.min), sinfo.max)
    span = (maxval - minval) % full
    if maxval <= minval:
        span = 1
    if out_of_range and maxval > minval:
        span = (span + 1) % full
    half_pow = 1 << (nbits // 2)
    mult = half_pow % span if span else half_pow
    mult = (mult * mult) % full
    mult = mult % span if span else mult
    k1, k2 = threefry.split(key)

    def fold(bits):
        higher, lower = bits
        if nbits == 32:
            higher = higher.to(torch.int64).bitwise_and_(threefry.MASK32)
            lower = lower.to(torch.int64).bitwise_and_(threefry.MASK32)
            if span:
                higher.remainder_(span)
                lower.remainder_(span)
            off = higher.mul_(mult).bitwise_and_(threefry.MASK32)
            off.add_(lower).bitwise_and_(threefry.MASK32)
            if span:
                off.remainder_(span)
        else:
            # int64 products and sums wrap to the same low 64 bits as the
            # unsigned ones.
            off = _urem64(higher, span).mul_(mult - full if mult >= full // 2
                                             else mult)
            off = _urem64(off.add_(_urem64(lower, span)), span)
        return _wrap_signed(off.add_(minval), nbits).to(dtype)

    return _flat_draw([k1, k2], shape, dtype, device, nbits, fold,
                      flat_range, chunk, runs)


def _unsigned_order(bits):
    """int32 bit patterns -> int32 values that sort as the unsigned ones."""
    return bits.bitwise_xor_(-(1 << 31))


def permutation_rounds(n: int) -> int:
    """jax's round count of a permutation of n items: ceil(3 ln n /
    ln(2**32 - 1))."""
    return int(np.ceil(3 * np.log(max(1, int(n))) / np.log(threefry.MASK32)))


def jr_permutation_indices(key, n: int, device):
    """The index order of ``jax.random.permutation(key, n)`` (and of a
    shuffle of n items along an axis), int64: ``permutation_rounds(n)``
    rounds, each a split and a stable sort by fresh 32-bit keys."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(permutation_rounds(n)):
        key, subkey = threefry.split(key)
        sort_keys = _unsigned_order(
            threefry.random_bits(subkey, (n,), 32, device))
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def mesh_permutation(backend, key, n: int):
    """``jr_permutation_indices`` on the mesh, as a 1-D DTensor split over
    every process (``mesh_ops.full_shard``), no process holding it whole:
    each round, the fresh 32-bit keys at each process's own positions and
    a stable sample sort of (key, value) by key (``mesh_ops.sorted_runs``,
    equal keys in position order as the serial stable sort leaves them),
    its runs placed back in order. Bit for bit the serial order."""
    from nums_tpu_torch.core.ops import mesh_ops

    n = int(n)
    fs = mesh_ops.full_shard(backend)
    device = backend.device
    lo, hi = backend.region((n,), fs)[0]
    values = backend.from_local(torch.arange(lo, hi, dtype=torch.int64,
                                             device=device), (n,), fs)
    for _ in range(permutation_rounds(n)):
        key, subkey = threefry.split(key)
        keys = backend.from_local(_unsigned_order(_flat_draw(
            subkey, (n,), torch.int32, device, 32, None, (lo, hi), None)),
            (n,), fs)
        runs, _ = mesh_ops.sorted_runs(backend, [keys, values],
                                       lambda locs: [locs[0]])
        del keys, values
        values = backend.place_rows(runs[1], (), fs)
        del runs
    return values


def mesh_top_k(backend, g, k: int):
    """The positions of the k largest values of the 1-D DTensor ``g``
    (split over every process), largest first and equal values in
    position order, as a 1-D DTensor of length k split over every process:
    a stable sample sort by the values descending (``mesh_ops.sorted_runs``
    on the positions), each process's run cut at rank k."""
    from nums_tpu_torch.core.ops import mesh_ops

    fs = mesh_ops.full_shard(backend)
    runs, r0 = mesh_ops.sorted_runs(
        backend, [g], lambda locs: [~mesh_ops.sort_keys(locs[0])[0]],
        positions=True)
    run = runs[-1]
    cut = max(0, min(int(run.shape[0]), int(k) - r0))
    return backend.place_rows(run[:cut].contiguous(), (), fs)


def jr_gumbel(key, shape, dtype, device, **where):
    """``jax.random.gumbel`` (its default low-range mode)."""
    tiny = float(np.finfo(_np_float(dtype)).tiny)
    u = jr_uniform(key, shape, dtype, device, tiny, 1.0, **where)
    return u.log_().neg_().log_().neg_()


def choice_checks(n_inputs: int, n_draws: int, replace: bool, p):
    """``jax.random.choice``'s checks of its arguments (ValueError)."""
    if n_draws == 0:
        return
    if n_inputs <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if not replace and n_draws > n_inputs:
        raise ValueError(
            f"Cannot take a larger sample (size {n_draws}) than "
            f"population (size {n_inputs}) when 'replace=False'")
    if p is not None and tuple(p.shape) != (n_inputs,):
        raise ValueError(
            "p must be None or a 1D vector with the same size as "
            f"a.shape[axis]. p has shape {tuple(p.shape)} and "
            f"a.shape[axis] is {n_inputs}.")


def choice_positions(key, n_inputs, shape, replace, p, device, x64,
                     where=None):
    """The positions (int64, flat) that ``jax.random.choice`` picks for
    the draws of ``shape`` where it draws them by position: with
    replacement a ``randint``, or with ``p`` the ``cumsum``/
    ``searchsorted`` of a uniform; with ``where`` (a region of ``shape``)
    those of the region alone. None for a choice without replacement (a
    permutation's, or the top k of a Gumbel draw)."""
    where = where or {}
    if not replace:
        return None
    if p is None:
        return jr_randint(key, shape, 0, n_inputs, _default_int(x64), device,
                          x64, **where).reshape(-1).to(torch.int64)
    # the running sum on the host: CUDA's scan may add in another order
    # from call to call, and every process's draws must be the serial
    # draw's
    p_cuml = torch.cumsum(p.cpu(), 0).to(p.device)
    u = jr_uniform(key, shape, p.dtype, device, **where)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml, r.reshape(-1))


def choice_gumbel(key, n_inputs, p, device, flat_range=None):
    """The Gumbel scores of a choice with ``p`` without replacement (the
    ``flat_range`` of them alone)."""
    g = jr_gumbel(key, (n_inputs,), p.dtype, device,
                  **({} if flat_range is None else {"flat_range":
                                                    flat_range}))
    lo = 0 if flat_range is None else int(flat_range[0])
    return g + torch.log(p[lo:lo + int(g.shape[0])])


def jr_choice(key, a, shape, replace, p, device, x64):
    """``jax.random.choice`` along axis 0. ``a`` is an int (the range) or a
    tensor; ``p`` a 1-d tensor or None."""
    shape = tuple(int(s) for s in shape)
    pool = None if isinstance(a, int) else a
    n_inputs = a if pool is None else int(pool.shape[0])
    n_draws = _size(shape)
    int_dtype = _default_int(x64)
    if n_draws == 0:
        return torch.zeros(shape, dtype=int_dtype if pool is None
                           else pool.dtype, device=device)
    if p is not None and not p.is_floating_point():
        p = p.to(_wide(x64))
    choice_checks(n_inputs, n_draws, replace, p)
    ind = choice_positions(key, n_inputs, shape, replace, p, device, x64)
    if ind is None and p is None:
        ind = jr_permutation_indices(key, n_inputs, device)[:n_draws]
    elif ind is None:
        ind = torch.topk(choice_gumbel(key, n_inputs, p, device),
                         n_draws).indices
    if pool is None:
        return ind.to(int_dtype).reshape(shape)
    flat = pool[ind.reshape(-1).to(torch.int64)]
    return flat.reshape(shape + tuple(pool.shape[1:]))


def jr_exponential(key, shape, dtype, device, **where):
    return jr_uniform(key, shape, dtype, device, **where).neg_().log1p_(
    ).neg_()


def jr_laplace(key, shape, dtype, device, **where):
    epsneg = float(np.finfo(_np_float(dtype)).epsneg)
    u = jr_uniform(key, shape, dtype, device, -1.0 + epsneg, 1.0, **where)
    return torch.sign(u).mul_(u.abs_().neg_().log1p_())


def jr_logistic(key, shape, dtype, device, **where):
    tiny = float(np.finfo(_np_float(dtype)).tiny)
    x = jr_uniform(key, shape, dtype, device, tiny, 1.0, **where)
    return torch.log(x).sub_(x.neg_().log1p_())


def jr_cauchy(key, shape, dtype, device, **where):
    npdt = _np_float(dtype)
    u = jr_uniform(key, shape, dtype, device, float(np.finfo(npdt).eps), 1.0,
                   **where)
    return u.sub_(0.5).mul_(float(npdt(np.pi))).tan_()


def jr_pareto(key, shape, dtype, device, b, **where):
    b = float(_np_float(dtype)(b))
    return jr_exponential(key, shape, dtype, device, **where).div_(b).exp_()


def jr_rayleigh(key, shape, dtype, device, scale, **where):
    scale = float(_np_float(dtype)(scale))
    u = jr_uniform(key, shape, dtype, device, **where)
    return u.log_().mul_(-2.0).sqrt_().mul_(scale)


def jr_triangular(key, shape, dtype, device, x64, left, mode, right,
                  **where):
    # left, mode and right are Python scalars in the reference: their
    # differences are taken at the wide width, then meet the draw's dtype.
    w = _np_float(_wide(x64))
    left, mode, right = w(left), w(mode), w(right)
    fc = float((mode - left) / (right - left))
    u = jr_uniform(key, shape, dtype, device, **where)
    out1 = (u * float(right - left)).mul_(float(mode - left)).sqrt_()
    out1.add_(float(left))
    out2 = ((1 - u).mul_(float(right - left)).mul_(float(right - mode))
            .sqrt_().neg_().add_(float(right)))
    return torch.where(u < fc, out1, out2)


def jr_geometric(key, shape, device, x64, p, **where):
    """int32 draws: ``floor(log(u) / log1p(-p)) + 1`` on a uniform of the
    wide float."""
    wide = _wide(x64)
    u = jr_uniform(key, shape, wide, device, **where)
    log_one_minus_p = float(np.log1p(-_np_float(wide)(p)))
    g = u.log_().div_(log_one_minus_p).floor_().add_(1)
    # A uniform of exactly 0 gives +inf: the reference's conversion
    # saturates at the int32 maximum (a plain cast would wrap or is
    # undefined, and differs between devices).
    top = torch.iinfo(torch.int32).max
    return g.clamp_(max=float(1 << 31)).to(torch.int64).clamp_(max=top).to(
        torch.int32)


def _uniform_batched(keys, dtype, minval=0.0, maxval=1.0):
    bits = threefry.bits_batched(keys, 32 if dtype == torch.float32 else 64)
    return _scale_unit(_bits_to_unit(bits, dtype), dtype, minval, maxval)


def _normal_batched(keys, dtype):
    return _normal_of_uniform(
        _uniform_batched(keys, dtype, *_normal_bounds(dtype)))


def _take_keys(keys, idx):
    return keys[0][idx], keys[1][idx]


def _gamma_batched(keys, alpha, log_space):
    """jax's ``_gamma_one`` for every element at once: Marsaglia-Tsang
    with one key per element. Its two nested ``while_loop``s become masked
    loops over the elements still running; each element splits its own key
    each turn exactly as it would alone, so the values do not depend on
    what the other elements do."""
    dtype = alpha.dtype
    npdt = _np_float(dtype)
    third = float(npdt(1.0 / 3.0))
    squeeze = float(npdt(0.0331))
    boost_mask = alpha >= 1
    alpha_orig = alpha
    alpha = torch.where(boost_mask, alpha, alpha + 1)
    d = alpha - third
    c = third / torch.sqrt(d)
    key, subkey = threefry.split_batched(keys)
    key = (key[0].clone(), key[1].clone())
    V = torch.ones_like(alpha)
    # The first test (X=0, V=1, U=2) holds everywhere: all start running.
    running = torch.arange(alpha.numel(), device=alpha.device)
    while running.numel():
        new_key, x_key, u_key = threefry.split_batched(
            _take_keys(key, running), 3)
        key[0][running] = new_key[0]
        key[1][running] = new_key[1]
        c_run = c[running]
        x = torch.zeros_like(c_run)
        v = torch.full_like(c_run, -1.0)
        pending = torch.arange(running.numel(), device=alpha.device)
        while pending.numel():
            next_key, sub = threefry.split_batched(_take_keys(x_key, pending))
            x_key[0][pending] = next_key[0]
            x_key[1][pending] = next_key[1]
            x_new = _normal_batched(sub, dtype)
            v_new = 1 + x_new * c_run[pending]
            x[pending] = x_new
            v[pending] = v_new
            pending = pending[v_new <= 0]
        X = x * x
        Vr = v * v * v
        U = _uniform_batched(u_key, dtype)
        V[running] = Vr
        again = (U >= 1 - squeeze * (X * X)) & (
            torch.log(U) >= X * 0.5 + d[running] * ((1 - Vr) + torch.log(Vr)))
        running = running[again]
    u = _uniform_batched(subkey, dtype)
    if log_space:
        log_samples = u.neg_().log1p_()
        log_boost = torch.where(
            boost_mask | (log_samples == 0), torch.zeros_like(alpha),
            log_samples * (1 / alpha_orig))
        return (torch.log(d) + torch.log(V)) + log_boost
    boost = torch.where(boost_mask, torch.ones_like(alpha),
                        torch.pow(1 - u, 1 / alpha_orig))
    return (d * V) * boost


def _as_param(value, shape, dtype, device):
    """A scalar or tensor parameter as a ``dtype`` tensor of ``shape``."""
    t = torch.as_tensor(value, device=device).to(dtype)
    return t.broadcast_to(tuple(shape))


# Elements of a gamma draw made at a time: each has its own key and its
# own rejection loop, so a draw a chunk at a time is the same draw, with
# its scratch (keys and loop state, some 40 bytes an element) bounded.
GAMMA_CHUNK = 1 << 24


def jr_gamma(key, shape, dtype, device, a, log_space=False, **where):
    """``jax.random.gamma`` / ``loggamma``: one key per element from a
    split over the row-major shape, ``GAMMA_CHUNK`` elements at a time.
    With ``where`` (a region's ``flat_range`` or ``runs``) only the keys
    of the region's positions are made, and each element's loop runs on
    its own key: the region of the whole draw, bit for bit."""
    shape = tuple(int(s) for s in shape)
    out = _draw_shape(shape, where)
    alpha = _as_param(a, out, dtype, device).reshape(-1)
    n = int(alpha.numel())
    res = torch.empty(n, dtype=dtype, device=device)
    for a0 in range(0, n, GAMMA_CHUNK):
        a1 = min(n, a0 + GAMMA_CHUNK)
        keys = threefry.keys_at(key, _region_positions(
            where, device, a0, a1) if where else torch.arange(
                a0, a1, dtype=torch.int64, device=device))
        res[a0:a1] = _gamma_batched(keys, alpha[a0:a1].contiguous(),
                                    log_space)
    return res.reshape(out)


def jr_chisquare(key, shape, dtype, device, df, **where):
    half_df = _as_param(df, _draw_shape(shape, where), dtype, device) / 2
    return jr_gamma(key, shape, dtype, device, half_df, True,
                    **where).exp_().mul_(2)


def jr_beta(key, shape, dtype, device, a, b, **where):
    key_a, key_b = threefry.split(key)
    lg_a = jr_gamma(key_a, shape, dtype, device, a, True, **where)
    lg_b = jr_gamma(key_b, shape, dtype, device, b, True, **where)
    log_max = torch.maximum(lg_a, lg_b)
    ga = (lg_a - log_max).exp_()
    gb = (lg_b - log_max).exp_()
    return ga / (ga + gb)


def jr_f(key, shape, dtype, device, dfnum, dfden, **where):
    key_dfd, key_dfn = threefry.split(key)
    out = _draw_shape(shape, where)
    dfnum = _as_param(dfnum, out, dtype, device)
    dfden = _as_param(dfden, out, dtype, device)
    chi2_dfn = jr_chisquare(key_dfn, shape, dtype, device, dfnum, **where)
    chi2_dfd = jr_chisquare(key_dfd, shape, dtype, device, dfden, **where)
    return (chi2_dfn / dfnum) / (chi2_dfd / dfden)


def jr_t(key, shape, dtype, device, df, **where):
    key_n, key_g = threefry.split(key)
    n = jr_normal(key_n, shape, dtype, device, **where)
    half_df = _as_param(df, _draw_shape(shape, where), dtype, device) / 2
    g = jr_gamma(key_g, shape, dtype, device, half_df, **where)
    return n * torch.sqrt(half_df / g)


def jr_dirichlet(key, shape, dtype, device, alpha, region=None):
    """``alpha`` is a (..., n) tensor; the result ``shape + (n,)``. With
    ``region`` (a box of the result) only the box's rows are drawn, each
    whole (a row is normalized over its n gammas), and the box is cut from
    them: bit for bit the box of the whole draw."""
    alpha = alpha.to(dtype)
    full = tuple(shape) + tuple(alpha.shape[-1:])
    if region is None:
        log_g = jr_gamma(key, full, dtype, device, alpha, True)
    else:
        rows = tuple((int(a), int(b)) for a, b in region[:-1]) + (
            (0, full[-1]),)
        box = tuple(b - a for a, b in rows)
        if 0 in box:
            return torch.empty(tuple(b - a for a, b in region), dtype=dtype,
                               device=device)
        where = region_where(full, rows, device)
        a_box = alpha.broadcast_to(full)[tuple(slice(a, b) for a, b in rows)]
        log_g = jr_gamma(key, full, dtype, device, a_box.reshape(
            _draw_shape(full, where)), True, **where).reshape(box)
    un = (log_g - log_g.max(dim=-1, keepdim=True).values).exp_()
    out = un / un.sum(dim=-1, keepdim=True)
    if region is not None:
        out = out[..., int(region[-1][0]):int(region[-1][1])]
    return out


def jr_wald(key, shape, dtype, device, mean, **where):
    npdt = _np_float(dtype)
    k1, k2 = threefry.split(key)
    mean = npdt(mean)
    mean_sq = mean * mean
    v = jr_normal(k1, shape, dtype, device, **where)
    z = jr_uniform(k2, shape, dtype, device, **where)
    y = v * v
    y_sq = y * y
    sqrt_term = torch.sqrt(float(npdt(4) * mean) * y + float(mean_sq) * y_sq)
    x = (float(mean) + float(mean_sq) * y / 2
         - float(mean / npdt(2)) * sqrt_term)
    return torch.where(z <= float(mean) / (float(mean) + x), x,
                       float(mean_sq) / x)


# Elements of a looped draw (Poisson, binomial) that a process works on at
# a time: its state is the output and one bool an element, and each piece
# of the region brings its own temporaries (some 20 floats an element).
LOOP_CHUNK = 1 << 24

# The rounds run by the rejection loops whose round count is the whole
# draw's (Hörmann's Poisson, BTRS): one flag is combined over the mesh
# after each.
ROUNDS = {"rounds": 0}


def _pieces(shape, where, chunk):
    """(offset, count, where) of each piece of a draw's region (the whole
    shape where no region is given) in the region's order, at most about
    ``chunk`` elements each: a flat range cut into ranges, runs cut into
    whole runs."""
    if not where:
        where = {"flat_range": (0, _size(shape))}
    if where.get("flat_range") is not None:
        start, stop = (int(v) for v in where["flat_range"])
        return [(a - start, min(stop, a + chunk) - a,
                 {"flat_range": (a, min(stop, a + chunk))})
                for a in range(start, stop, chunk)]
    starts, length = where["runs"]
    rows, length = int(starts.numel()), int(length)
    step = max(1, chunk // max(length, 1))
    return [(a * length, (min(rows, a + step) - a) * length,
             {"runs": (starts[a:a + step], length)})
            for a in range(0, rows, step)]


def _by_piece(values, draw_shape, dtype, device, terms):
    """``terms(*params)`` of a looped draw's parameters ``values`` at a
    piece, as ``at(off, cnt)``, and whether every parameter is one value.
    A Python scalar or a 0-d tensor is one value (a 0-d ``dtype`` tensor,
    which every round's arithmetic broadcasts); a tensor with dimensions
    is one value an element of the draw (of the region's shape), and each
    piece takes its own elements. Where every parameter is one value the
    terms are computed once; else for each piece's elements as it comes."""
    ones = [not torch.is_tensor(v) or v.dim() == 0 for v in values]
    flats = [_as_param(v, (), dtype, device) if one
             else v.to(device).broadcast_to(tuple(draw_shape)).reshape(-1)
             for v, one in zip(values, ones)]
    if all(ones):
        fixed = terms(*flats)
        return (lambda off, cnt: fixed), True
    return (lambda off, cnt: terms(*[
        f if one else f[off:off + cnt].to(dtype)
        for f, one in zip(flats, ones)])), False


def _left(flag, where):
    """Whether an element of the whole draw is left: this process's flag
    (a bool tensor or bool), combined over every process of the mesh (one
    all-reduce) where the draw is a region (``where``): each process of a
    mesh draws its own region of the same draw in the same call."""
    if where:
        return multiprocess.any_everywhere(flag)
    return bool(flag)


def _uniform_at(key, shape, dtype, device, where):
    """``jr_uniform`` at a piece's positions, flattened."""
    return jr_uniform(key, shape, dtype, device, **where).reshape(-1)


def _poisson_knuth(key, lam, cnt, shape, where, device):
    """Knuth's product for one piece of ``cnt`` elements (``lam`` float32,
    its rates or one rate), as a float32 count: an element's count stops
    with its own product, so the piece's loop ends when its own elements
    are done."""
    k = torch.zeros((cnt,), dtype=torch.float32, device=device)
    log_prod = torch.zeros_like(k)
    neg_lam = -lam
    while bool((log_prod > neg_lam).any()):
        key, subkey = threefry.split(key)
        k = torch.where(log_prod > neg_lam, k + 1, k)
        u = _uniform_at(subkey, shape, torch.float32, device, where)
        log_prod = log_prod + u.log_()
    return k - 1


def _poisson_terms(lam):
    """jax's branch of each rate (Knuth's below 10) and Hörmann's
    constants of the rates that take his rejection (the others at 1e5)."""
    knuth = torch.isnan(lam) | (lam < 10)
    rej = torch.where(knuth, torch.full_like(lam, 1e5), lam)
    b = 0.931 + 2.53 * torch.sqrt(rej)
    return {"lam": lam, "knuth": knuth, "rej": rej, "log_lam": torch.log(rej),
            "b": b, "a": -0.059 + 0.02483 * b,
            "inv_alpha": 1.1239 + 1.1328 / (b - 3.4),
            "v_r": 0.9277 - 3.6224 / (b - 2)}


def _poisson_proposal(u, v, c):
    """Hörmann's proposal k of one round and whether it is accepted (``c``
    the rates' ``_poisson_terms``)."""
    lam, a, b = c["rej"], c["a"], c["b"]
    u = u - 0.5
    u_shifted = 0.5 - u.abs()
    k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
    s = torch.log(v * c["inv_alpha"] / (a / (u_shifted * u_shifted) + b))
    t = -lam + k * c["log_lam"] - torch.lgamma(k + 1)
    accept1 = (u_shifted >= 0.07) & (v <= c["v_r"])
    reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
    return k, accept1 | (~reject & (s <= t))


def _last_accepted(key, shape, pieces, buf, dtype, device, where, propose):
    """jax's rejection loop that keeps each element's LAST accepted
    proposal and runs until no element of the whole draw is left (so an
    element's value depends on the whole draw's round count): each round
    splits the key in three, proposes at every position of the region, a
    piece at a time (``propose(u, v, off, cnt) -> (k, accept, keep)``:
    ``keep`` marks the elements of another branch, whose values stay),
    and ends with one flag, combined over the mesh for a region
    (``where``). Every piece is carried through every round, never
    redrawn."""
    accepted = torch.zeros(buf.shape, dtype=torch.bool, device=device)
    while True:
        ROUNDS["rounds"] += 1
        key, subkey_0, subkey_1 = threefry.split(key, 3)
        for off, cnt, w in pieces:
            u = _uniform_at(subkey_0, shape, dtype, device, w)
            v = _uniform_at(subkey_1, shape, dtype, device, w)
            k, accept, keep = propose(u, v, off, cnt)
            part = buf[off:off + cnt]
            part.copy_(torch.where(accept & ~keep, k, part))
            accepted[off:off + cnt] |= accept
        if not _left((~accepted).any(), where):
            return


def jr_poisson(key, shape, device, x64, lam, dtype=None, where=None):
    """``jax.random.poisson``: Knuth's product below lam = 10, Hörmann's
    transformed rejection above, both on float32, each a loop over split
    keys until no element is left. Both run on the same key and are
    selected by element, as jax's; a branch no element takes is skipped.
    With ``where`` (a region's ``flat_range`` or ``runs``) only its
    positions are drawn, a ``LOOP_CHUNK`` piece at a time: Knuth's counts
    are position-wise (each piece loops alone), Hörmann's keep the last
    accepted proposal, so its rounds run to the whole draw's count, the
    flag combined over the mesh once a round (every process of the mesh
    draws its region in the same call), and the region is that region of
    the whole draw bit for bit. ``lam`` is one rate (a Python scalar or a
    0-d tensor) or a tensor of the draw's (region's) shape. The counts are
    returned in ``dtype`` (default: the integer of the mode)."""
    shape = tuple(int(s) for s in shape)
    dtype = dtype or _default_int(x64)
    where = where or {}
    out = torch.empty(_draw_shape(shape, where), dtype=dtype, device=device)
    flat = out.view(-1)
    at, one = _by_piece((lam,), out.shape, torch.float32, device,
                        _poisson_terms)
    pieces = _pieces(shape, where, LOOP_CHUNK)
    buf = flat if dtype == torch.float32 else torch.empty(
        flat.shape, dtype=torch.float32, device=device)

    rejection = False
    for off, cnt, w in pieces:
        c = at(off, cnt)
        knuth = c["knuth"]
        k = torch.full((cnt,), -1.0, dtype=torch.float32, device=device)
        if bool(knuth.any()):
            k = torch.where(knuth, _poisson_knuth(
                key, torch.where(knuth, c["lam"], torch.zeros_like(c["lam"])),
                cnt, shape, w, device), k)
        buf[off:off + cnt] = k
        rejection = rejection or not bool(knuth.all())
    if one:
        # one rate: the branch is known on every process
        rejection = _size(shape) > 0 and not bool(at(0, 0)["knuth"])
    else:
        # whether any element of the whole draw takes Hörmann's branch
        rejection = _left(rejection, where)
    if rejection:
        def propose(u, v, off, cnt):
            c = at(off, cnt)
            k, accept = _poisson_proposal(u, v, c)
            return k, accept, c["knuth"]

        _last_accepted(key, shape, pieces, buf, torch.float32, device, where,
                       propose)
    for off, cnt, _ in pieces:
        lam_c = at(off, cnt)["lam"]
        k = buf[off:off + cnt]
        flat[off:off + cnt] = torch.where(lam_c == 0, torch.zeros_like(k),
                                          k).to(dtype)
    return out


_STIRLING_TAIL = (
    0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
    0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
    0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
    0.00833056343336287,
)


def _stirling_approx_tail(k):
    # As jax's: the series is evaluated on k clamped to [0, 9] too.
    table = torch.tensor(_STIRLING_TAIL, dtype=k.dtype, device=k.device)
    use_tail_values = k <= 9
    k = k.clamp(0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    return torch.where(use_tail_values, table[torch.floor(k).to(torch.int64)],
                       approx)


def _binomial_inversion(key, count, prob, cnt, shape, where, device):
    """The geometric inversion for one piece of ``cnt`` elements:
    position-wise, as Knuth's product is."""
    log1minusprob = torch.log1p(-prob)
    num_geom = torch.zeros((cnt,), dtype=prob.dtype, device=device)
    geom_sum = torch.zeros_like(num_geom)
    while bool((geom_sum <= count).any()):
        subkey, key = threefry.split(key)
        num_geom = torch.where(geom_sum <= count, num_geom + 1, num_geom)
        u = _uniform_at(subkey, shape, prob.dtype, device, where)
        geom_sum = geom_sum + torch.ceil(u.log_() / log1minusprob)
    return num_geom - 1


def _binomial_terms(count, prob):
    """jax's preparation of a binomial's parameters (trials ``count`` and
    probability ``prob`` in one float): the trials (floored) and
    q = min(p, 1 - p), the branch of each element and the masks of its
    special cases; and the BTRS constants of the elements that take it
    (the others at 1e4 trials, q = 0.5)."""
    t = {"p_lt_half": prob < 0.5}
    q = torch.where(t["p_lt_half"], prob, 1.0 - prob)
    t["count_nan_or_neg"] = torch.isnan(count) | (count < 0.0)
    t["count_inf"] = torch.isinf(count)
    t["q_is_nan"] = torch.isnan(q)
    t["q_l_0"] = q < 0.0
    t["q"] = torch.where(t["q_is_nan"] | t["q_l_0"], torch.full_like(q, 0.01),
                         q)
    inv = t["use_inversion"] = t["count_nan_or_neg"] | (count * t["q"] <= 10.0)
    t["count"] = torch.floor(count)
    count = torch.where(inv, torch.full_like(t["count"], 1e4), t["count"])
    prob = torch.where(inv, torch.full_like(t["q"], 0.5), t["q"])
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    r = prob / (1 - prob)
    m = torch.floor((count + 1) * prob)
    t["btrs"] = {
        "count": count, "b": b, "a": -0.0873 + 0.0248 * b + 0.01 * prob,
        "c": count * prob + 0.5, "v_r": 0.92 - 4.2 / b, "r": r,
        "alpha": (2.83 + 5.1 / b) * stddev,
        "count_1": count + 1, "count_m_1": count - m + 1,
        "ub_m": (m + 0.5) * torch.log((m + 1) / (r * (count - m + 1))),
        "m_tail": _stirling_approx_tail(m),
        "count_m_tail": _stirling_approx_tail(count - m)}
    return t


def _btrs_proposal(u, v, c):
    """The BTRS proposal k of one round and whether it is accepted (``c``
    the ``btrs`` constants of ``_binomial_terms``)."""
    count, a, b = c["count"], c["a"], c["b"]
    u = u - 0.5
    us = 0.5 - u.abs()
    accept1 = (us >= 0.07) & (v <= c["v_r"])
    k = torch.floor((2 * a / us + b) * u + c["c"])
    reject = (k < 0) | (k > count)
    v = torch.log(v * c["alpha"] / (a / (us * us) + b))
    ub = (
        c["ub_m"]
        + c["count_1"] * torch.log(c["count_m_1"] / (count - k + 1))
        + (k + 0.5) * torch.log(c["r"] * (count - k + 1) / (k + 1))
        + c["m_tail"]
        + c["count_m_tail"]
        - _stirling_approx_tail(k)
        - _stirling_approx_tail(count - k)
    )
    return k, accept1 | (~reject & (v <= ub))


def _binomial_finish(samples, t, dtype):
    samples = samples.to(dtype)
    invalid = t["q_l_0"] | t["q_is_nan"] | t["count_nan_or_neg"]
    samples = torch.where(invalid, torch.full_like(samples, np.nan), samples)
    samples = torch.where(t["count_inf"] & ~invalid,
                          torch.full_like(samples, np.inf), samples)
    return torch.where(
        t["p_lt_half"] | t["count_nan_or_neg"] | t["q_is_nan"]
        | t["count_inf"], samples, t["count"].to(dtype) - samples)


def jr_binomial(key, shape, dtype, device, x64, n, p, where=None):
    """``jax.random.binomial``: geometric inversion where n·min(p, 1-p) <=
    10, the BTRS rejection above, both in the width of ``p`` (a Python
    float is the wide float) and cast to ``dtype`` at the end. With
    ``where`` the region alone, a piece at a time, as ``jr_poisson``: the
    inversion is position-wise, BTRS keeps the last accepted proposal and
    runs to the whole draw's round count (its flag combined over the mesh
    once a round). ``n`` and ``p`` are each one value (a Python scalar or a
    0-d tensor) or a tensor of the draw's (region's) shape."""
    shape = tuple(int(s) for s in shape)
    pdt = p.dtype if torch.is_tensor(p) and p.is_floating_point() \
        else _wide(x64)
    where = where or {}
    out = torch.empty(_draw_shape(shape, where), dtype=dtype, device=device)
    flat = out.view(-1)
    at, one = _by_piece((n, p), out.shape, pdt, device, _binomial_terms)
    pieces = _pieces(shape, where, LOOP_CHUNK)
    buf = flat if dtype == pdt else torch.empty(flat.shape, dtype=pdt,
                                                device=device)

    btrs = False
    for off, cnt, w in pieces:
        t = at(off, cnt)
        inv = t["use_inversion"]
        s = torch.full((cnt,), -1.0, dtype=pdt, device=device)
        if bool(inv.any()):
            count_inv = torch.where(inv, t["count"],
                                    torch.zeros_like(t["count"]))
            s = torch.where(inv, _binomial_inversion(
                key, count_inv, t["q"], cnt, shape, w, device), s)
        buf[off:off + cnt] = s
        btrs = btrs or not bool(inv.all())
    if one:
        # one n and one p: the branch is known on every process
        btrs = _size(shape) > 0 and not bool(at(0, 0)["use_inversion"])
    else:
        btrs = _left(btrs, where)
    if btrs:
        def propose(u, v, off, cnt):
            t = at(off, cnt)
            k, accept = _btrs_proposal(u, v, t["btrs"])
            return k, accept, t["use_inversion"]

        _last_accepted(key, shape, pieces, buf, pdt, device, where, propose)
    for off, cnt, _ in pieces:
        flat[off:off + cnt] = _binomial_finish(buf[off:off + cnt],
                                               at(off, cnt), dtype)
    return out


def jr_multinomial(key, n, p, shape, device, region=None):
    """``jax.random.multinomial``: ``p`` (..., K) and ``n`` float tensors;
    ``shape`` the FULL output shape (batch and category axes) or None.
    One binomial per category on the trials that remain, keys from one
    split over the categories. With ``region`` (a box of the result) only
    the box's rows are drawn, each over all K categories (a row's counts
    take its remainders in turn), and the box is cut from them: each
    category's binomial is the region of the whole draw
    (``jr_binomial``'s ``where``, its loops' flags combined over the
    mesh): every process of the mesh draws its own box in the same call,
    and without a mesh a box smaller than the array raises
    ``NotImplementedError``."""
    if shape is None:
        shape = tuple(p.shape)
    shape = tuple(int(s) for s in shape)
    batch = shape[:-1]
    n = n.broadcast_to(batch)
    p = p.broadcast_to(shape)
    where = {}
    if region is not None:
        rows = tuple((int(a), int(b)) for a, b in region[:-1])
        if rows != tuple((0, s) for s in batch):
            # (an empty box too: its process joins the loops' flags)
            _on_the_mesh("multinomial")
            where = region_where(batch, rows, device)
            n = n[tuple(slice(a, b) for a, b in rows)].reshape(
                _draw_shape(batch, where))
            p = p[tuple(slice(a, b) for a, b in rows)].reshape(
                _draw_shape(batch, where) + shape[-1:])
    p = torch.movedim(p, -1, 0)
    remaining = torch.flip(torch.cumsum(torch.flip(p, (0,)), 0), (0,))
    ratios = p / torch.where(remaining == 0, torch.ones_like(remaining),
                             remaining)
    keys = threefry.split(key, int(ratios.shape[0]))
    remainder = n
    counts = []
    for ratio, sub in zip(ratios, keys):
        count = jr_binomial(sub, batch, remainder.dtype, device, False,
                            remainder, ratio.clamp(0, 1), where)
        remainder = remainder - count
        counts.append(count)
    out = torch.movedim(torch.stack(counts, 0), 0, -1)
    if region is None:
        return out
    box = tuple(b - a for a, b in region[:-1])
    return out.reshape(box + shape[-1:])[
        ..., int(region[-1][0]):int(region[-1][1])]


def jr_multivariate_normal(key, mean, cov, shape, dtype, device,
                           region=None):
    """``jax.random.multivariate_normal`` with its default Cholesky
    factor; ``shape`` the batch shape or None. With ``region`` (a box of
    the result) only the box's rows are drawn, each over its n normals,
    times the factor, and the box is cut from them."""
    n = int(mean.shape[-1])
    if tuple(cov.shape[-2:]) != (n, n):
        raise ValueError(
            "multivariate_normal requires cov.shape == (..., n, n) for "
            f"n={n}, but got cov.shape == {tuple(cov.shape)}.")
    if shape is None:
        shape = torch.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    factor = torch.linalg.cholesky(cov)
    full = tuple(int(s) for s in shape) + (n,)
    if region is None:
        z = jr_normal(key, full, dtype, device)
        return mean + _factor_times(factor.to(z.dtype), z)
    rows = tuple((int(a), int(b)) for a, b in region[:-1])
    box = tuple(b - a for a, b in rows) + (n,)
    if 0 in box or 0 in tuple(b - a for a, b in region):
        return torch.empty(tuple(b - a for a, b in region), dtype=dtype,
                           device=device)
    z = jr_normal(key, full, dtype, device, **region_where(
        full, rows + ((0, n),), device)).reshape(box)
    cut = tuple(slice(a, b) for a, b in rows)
    mean = mean.broadcast_to(full)[cut]
    factor = factor.broadcast_to(full[:-1] + (n, n))[cut]
    out = mean + _factor_times(factor.to(z.dtype), z)
    return out[..., int(region[-1][0]):int(region[-1][1])]


def _factor_times(factor, z):
    """``factor @ z`` along the last axis, a column of the factor at a
    time: each element's sum runs over j in order, whatever the batch
    shape (a matmul's blocking, and so its rounding, depends on it, and a
    process's rows would not be those rows of the whole draw)."""
    out = factor[..., :, 0] * z[..., :1]
    for j in range(1, int(z.shape[-1])):
        out = out + factor[..., :, j] * z[..., j:j + 1]
    return out


# ---------------------------------------------------------------------
# The distribution table (nums_tpu/core/ops/random_ops.py:24-232)
# ---------------------------------------------------------------------


def _u(key, shape, dtype, device, **where):
    # Uniform in (0, 1): avoids log(0) in inversion transforms.
    tiny = float(np.finfo(_np_float(dtype)).tiny)
    return jr_uniform(key, shape, dtype, device, tiny, 1.0, **where)


def _root(x, x64, a):
    """x^(1/a) in place, as exp(log(x)/a): torch's CPU ``pow`` rounds the
    tail of a tensor apart from its vectorized body, so a region of a draw
    would not be that region of the whole draw bit for bit."""
    return x.log_().mul_(float(1.0 / _scalar(x64, a))).exp_()


def _affine(x, loc, scale):
    """loc + scale * x, in place."""
    return x.mul_(scale).add_(loc)




def _scalar(x64, value):
    """A Python scalar parameter at the reference's width: arithmetic
    between parameters happens there before it meets the draw's dtype."""
    return _np_float(_wide(x64))(value)


_REJECTION_ROUNDS = 32  # per-element failure prob < 1e-9 for our samplers


def _rejection_sample(key, shape, dtype, device, propose_accept, fallback,
                      where=None):
    """Fixed-round rejection sampling: ``propose_accept(subkey) ->
    (proposal, accepted_mask)``; an element keeps its FIRST accepted
    proposal, and after ``_REJECTION_ROUNDS`` rounds any still-unaccepted
    element (probability ~1e-9) takes ``fallback``. Round i's key is
    ``fold_in(key, i)``. Each element's rounds are its own, so a region
    (``where``) draws as that region of the whole."""
    out = torch.full(_draw_shape(shape, where), fallback, dtype=dtype,
                     device=device)
    done = torch.zeros(out.shape, dtype=torch.bool, device=device)
    for i in range(_REJECTION_ROUNDS):
        proposal, accept = propose_accept(threefry.fold_in(key, i))
        out = torch.where(accept & ~done, proposal, out)
        done |= accept
    return out


def _vonmises(key, shape, dtype, device, mu, kappa, **where):
    """Best–Fisher (1979) rejection sampler for the von Mises circle."""
    npdt = _np_float(dtype)
    kappa = max(npdt(kappa), npdt(1e-8))
    tau = npdt(1.0) + np.sqrt(npdt(1.0) + npdt(4.0) * kappa * kappa)
    rho = (tau - np.sqrt(npdt(2.0) * tau)) / (npdt(2.0) * kappa)
    r = float((npdt(1.0) + rho * rho) / (npdt(2.0) * rho))
    kappa = float(kappa)
    pi = float(npdt(np.pi))

    def propose(sub):
        k1, k2, k3 = threefry.split(sub, 3)
        u1 = jr_uniform(k1, shape, dtype, device, 1e-7, 1.0, **where)
        u2 = jr_uniform(k2, shape, dtype, device, 1e-7, 1.0, **where)
        u3 = jr_uniform(k3, shape, dtype, device, **where)
        z = torch.cos(pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = (c * (2.0 - c) - u2 > 0.0) | (
            torch.log(c / u2) + 1.0 - c >= 0.0)
        acos_f = torch.acos(f)
        theta = torch.where(u3 < 0.5, -acos_f, acos_f)
        return mu + theta, accept

    raw = _rejection_sample(key, shape, dtype, device, propose, 0.0,
                            where)
    # wrap to [-pi, pi) like np.random.vonmises
    return torch.remainder(raw + pi, float(npdt(2.0) * npdt(np.pi))) - pi


def _zipf(key, shape, dtype, device, x64, a, **where):
    """Devroye's rejection sampler for the Zipf(a) distribution."""
    am1 = _scalar(x64, a) - 1.0
    b = 2.0 ** am1
    exponent = float(-1.0 / am1)
    am1_f, b_f, bm1_f = float(am1), float(b), float(b - 1.0)

    def propose(sub):
        k1, k2 = threefry.split(sub)
        u = jr_uniform(k1, shape, torch.float32, device, 1e-7, 1.0, **where)
        v = jr_uniform(k2, shape, torch.float32, device, **where)
        # cap x to avoid overflow; tail mass beyond 1e9 is negligible
        x = torch.floor(torch.clamp(u.pow_(exponent), max=1e9))
        t = (1.0 + 1.0 / x).pow_(am1_f)
        accept = v * x * (t - 1.0) / bm1_f <= t / b_f
        return x.to(dtype), accept

    return _rejection_sample(key, shape, dtype, device, propose, 1.0,
                             where)


def _logseries(key, shape, dtype, device, x64, p, **where):
    """Kemp's inversion sampler for the log-series distribution."""
    k1, k2 = threefry.split(key)
    p = _scalar(x64, p)
    r = float(np.log1p(-p))
    p = float(p)
    v = jr_uniform(k1, shape, torch.float32, device, 1e-7, 1.0, **where)
    u = jr_uniform(k2, shape, torch.float32, device, 1e-7, 1.0, **where)
    q = u.mul_(r).expm1_().neg_()
    # Kemp's branch order: V>=p -> 1; V<=q^2 -> floor(1+lnV/lnq);
    # V>=q -> 1; else -> 2.
    one = torch.ones_like(v)
    x = torch.where(
        v >= p, one,
        torch.where(
            v <= q * q,
            torch.floor(1.0 + torch.log(v) / torch.log(q)),
            torch.where(v >= q, one, 2.0 * one),
        ),
    )
    return x.to(dtype)


def _poisson(key, shape, dtype, device, x64, where, lam):
    return jr_poisson(key, shape, device, x64, lam, dtype, where)


def _binomial(key, shape, dtype, device, x64, where, n, p):
    return jr_binomial(key, shape, dtype, device, x64, n, p, where)


def _negative_binomial(key, shape, dtype, device, x64, where, n, p):
    # negative_binomial(n, p) == Poisson(Gamma(n, (1-p)/p)).
    k1, k2 = threefry.split(key)
    p = _scalar(x64, p)
    lam = jr_gamma(k1, shape, torch.float32, device, n, **where).mul_(
        float((1.0 - p) / p))
    return jr_poisson(k2, shape, device, x64, lam, dtype, where)


def _noncentral_chisquare(key, shape, dtype, device, x64, where, df, nonc):
    """numpy's two-regime construction: chi2(df-1) + (Z+sqrt(nonc))^2 for
    df > 1, the Poisson mixture chi2(df + 2*Poisson(nonc/2)) for df <= 1.
    The reference samples both regimes and selects (its df is traced);
    here df is a Python float, so only the selected regime is drawn, on
    the same sub-keys of the one four-way split."""
    k1, k2, k3, k4 = threefry.split(key, 4)
    npdt = _np_float(dtype)
    dfa = npdt(df)
    if dfa > 1.0:
        central = jr_chisquare(k1, shape, dtype, device,
                               float(max(dfa - npdt(1.0), npdt(1e-6))),
                               **where)
        sqrt_nonc = float(np.sqrt(_scalar(x64, nonc)))
        shifted = jr_normal(k2, shape, dtype, device, **where).add_(
            sqrt_nonc)
        return central.add_(shifted.mul_(shifted))
    i = jr_poisson(k3, shape, device, x64,
                   float(np.float32(nonc) / np.float32(2.0)), None, where)
    return jr_chisquare(k4, shape, dtype, device,
                        float(dfa) + 2.0 * i.to(dtype), **where)


def _noncentral_f(key, shape, dtype, device, x64, where, dfnum, dfden, nonc):
    # Independent keys via ONE split: mixing fold_in(key, i) with
    # split(key) collides (threefry split == fold_in over indices).
    k_num, k_den = threefry.split(key)
    num = _noncentral_chisquare(k_num, shape, dtype, device, x64, where,
                                dfnum, nonc).div_(dfnum)
    den = jr_chisquare(k_den, shape, dtype, device, dfden,
                       **where).div_(dfden)
    return num.div_(den)


def supported(name: str) -> bool:
    return name in _DISTS


# Device path is O(nsample) sequential draws per element; beyond this,
# the host generator is faster than the chain.
HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE = 4096


def hypergeometric(key, shape, dtype, device, nsample: int, ngood, nbad,
                   region=None):
    """Exact sequential without-replacement sampler.

    k = Σ_{t<nsample} Bernoulli(good_t / (good_t + bad_t)) with the urn
    updated each draw: the chain-rule factorization of the hypergeometric
    pmf, vectorized over the output shape. Draw t's key is
    ``fold_in(key, t)`` and its uniform float32. The urn counts are int32:
    exact updates for populations up to 2^31 (float32 counts stop
    depleting above 2^24); the float32 cast in the accept test only
    perturbs the ratio in its 7th digit. With ``region`` (a box, as
    ``sample_region``'s) only its positions are drawn: each element's
    chain is its own."""
    shape = tuple(int(s) for s in shape)
    where = {}
    out = shape
    if region is not None:
        region = tuple((int(a), int(b)) for a, b in region)
        out = tuple(b - a for a, b in region)
        if 0 in out:
            return torch.empty(out, dtype=dtype, device=device)
        where = region_where(shape, region, device)
    draw = _draw_shape(shape, where)
    good = torch.full(draw, int(ngood), dtype=torch.int32, device=device)
    bad = torch.full(draw, int(nbad), dtype=torch.int32, device=device)
    k = torch.zeros(draw, dtype=torch.int32, device=device)
    for t in range(int(nsample)):
        u = jr_uniform(threefry.fold_in(key, t), shape, torch.float32,
                       device, **where)
        goodf = good.to(torch.float32)
        take = (u * (goodf + bad.to(torch.float32)) < goodf).to(torch.int32)
        good -= take
        bad -= 1 - take
        k += take
    return k.to(dtype).reshape(out)


def sample(dist_name: str, key, shape: tuple, dtype: torch.dtype, device,
           x64: bool, *params):
    """Draw ``dist_name`` at the logical ``shape``."""
    return _DISTS[dist_name](key, tuple(int(s) for s in shape), dtype,
                             device, x64, *params)


# The samplers whose value at a flat position depends on that position
# alone (its bits, its key of a split, its own rounds of a fixed-round
# rejection): a region of the array is drawn by itself (``where``: the
# ``flat_range`` or ``runs`` keyword of the draw), bit for bit that region
# of the whole draw. Each entry: fn(key, shape, dtype, device, x64, where,
# *params).
_FLAT = {
    "random": lambda key, shape, dtype, device, x64, where: jr_uniform(
        key, shape, dtype, device, **where),
    "uniform": lambda key, shape, dtype, device, x64, where, low, high:
        jr_uniform(key, shape, dtype, device, low, high, **where),
    "normal": lambda key, shape, dtype, device, x64, where, loc, scale:
        _affine(jr_normal(key, shape, dtype, device, **where), loc, scale),
    "exponential": lambda key, shape, dtype, device, x64, where, scale:
        jr_exponential(key, shape, dtype, device, **where).mul_(scale),
    "gumbel": lambda key, shape, dtype, device, x64, where, loc, scale:
        _affine(jr_gumbel(key, shape, dtype, device, **where), loc, scale),
    "laplace": lambda key, shape, dtype, device, x64, where, loc, scale:
        _affine(jr_laplace(key, shape, dtype, device, **where), loc, scale),
    "logistic": lambda key, shape, dtype, device, x64, where, loc, scale:
        _affine(jr_logistic(key, shape, dtype, device, **where), loc,
                scale),
    "lognormal": lambda key, shape, dtype, device, x64, where, mean, sigma:
        _affine(jr_normal(key, shape, dtype, device, **where), mean,
                sigma).exp_(),
    # NumPy's pareto is the Lomax (Pareto-II minus 1).
    "pareto": lambda key, shape, dtype, device, x64, where, a: jr_pareto(
        key, shape, dtype, device, a, **where).sub_(1.0),
    # power(a): density a·x^(a-1) on [0,1] == U^(1/a).
    "power": lambda key, shape, dtype, device, x64, where, a: _root(_u(
        key, shape, dtype, device, **where), x64, a),
    "rayleigh": lambda key, shape, dtype, device, x64, where, scale:
        jr_rayleigh(key, shape, dtype, device, scale, **where),
    "standard_cauchy": lambda key, shape, dtype, device, x64, where:
        jr_cauchy(key, shape, dtype, device, **where),
    "triangular": lambda key, shape, dtype, device, x64, where, left, mode,
        right: jr_triangular(key, shape, dtype, device, x64, left, mode,
                             right, **where),
    # jr_wald(mean) is IG(mean, lambda=1); c*IG(mu, 1) = IG(c*mu, c), so
    # numpy's IG(mean, scale) is scale * IG(mean/scale, 1).
    "wald": lambda key, shape, dtype, device, x64, where, mean, scale:
        jr_wald(key, shape, dtype, device,
                _scalar(x64, mean) / _scalar(x64, scale), **where).mul_(
                    scale),
    # NumPy weibull(a): scale-1 Weibull == (-ln U)^(1/a).
    "weibull": lambda key, shape, dtype, device, x64, where, a: _root(_u(
        key, shape, dtype, device, **where).log_().neg_(), x64, a),
    "geometric": lambda key, shape, dtype, device, x64, where, p:
        jr_geometric(key, shape, device, x64, p, **where).to(dtype),
    "gamma": lambda key, shape, dtype, device, x64, where, k, theta:
        jr_gamma(key, shape, dtype, device, k, **where).mul_(theta),
    "chisquare": lambda key, shape, dtype, device, x64, where, df:
        jr_chisquare(key, shape, dtype, device, df, **where),
    "beta": lambda key, shape, dtype, device, x64, where, a, b: jr_beta(
        key, shape, dtype, device, a, b, **where),
    "f": lambda key, shape, dtype, device, x64, where, dfnum, dfden: jr_f(
        key, shape, dtype, device, dfnum, dfden, **where),
    "standard_t": lambda key, shape, dtype, device, x64, where, df: jr_t(
        key, shape, dtype, device, df, **where),
    # Fixed-round rejection and inversion samplers.
    "vonmises": lambda key, shape, dtype, device, x64, where, mu, kappa:
        _vonmises(key, shape, dtype, device, mu, kappa, **where),
    "zipf": lambda key, shape, dtype, device, x64, where, a: _zipf(
        key, shape, dtype, device, x64, a, **where),
    "logseries": lambda key, shape, dtype, device, x64, where, p:
        _logseries(key, shape, dtype, device, x64, p, **where),
}

# The samplers whose rejection loops run until no element of the WHOLE
# draw is left (Hörmann's Poisson, BTRS, and what is built on them): an
# element's value depends on the whole draw's round count. A region is
# drawn alone only on the mesh, with the loops' flags combined over its
# processes once a round. Each entry: fn(key, shape, dtype, device, x64,
# where, *params).
_LOOPED = {
    "poisson": _poisson,
    "binomial": _binomial,
    "negative_binomial": _negative_binomial,
    "noncentral_chisquare": _noncentral_chisquare,
    "noncentral_f": _noncentral_f,
}


def _whole(fn):
    return lambda key, shape, dtype, device, x64, *params: fn(
        key, shape, dtype, device, x64, {}, *params)


# Each impl: fn(key, shape, dtype, device, x64, *params) -> tensor of
# `shape`/`dtype` on `device` (its ``_FLAT`` or ``_LOOPED`` entry drawing
# everywhere).
_DISTS = {name: _whole(fn) for name, fn in {**_FLAT, **_LOOPED}.items()}


def _on_the_mesh(dist_name):
    """Raise ``NotImplementedError`` naming a looped sampler asked for a
    box smaller than its array outside a multi-process run: a box alone
    cannot know the whole draw's round count."""
    if not multiprocess.is_multiprocess():
        raise NotImplementedError(
            f"{dist_name}: a box of this draw is drawn only on the mesh, "
            "every process drawing its own (its rejection loop keeps each "
            "element's last accepted proposal until no element of the "
            "whole draw is left)")


def sample_region(dist_name: str, key, shape: tuple, region, dtype, device,
                  x64: bool, *params):
    """The box ``region`` ((start, stop) per axis) of the draw
    ``sample(dist_name, key, shape, ...)``, equal to that box of the whole
    draw: a mesh process draws only its own positions. The box is one
    range of C-order positions per combination of its leading indices, up
    to its last axis that is not whole: one range for whole rows, one per
    row for a column shard. A looped sampler (``_LOOPED``) draws a box
    smaller than the array only on the mesh: every process draws its own
    box of the same draw in the same call, and the loops' flags are
    combined over them once a round; outside a multi-process run such a
    box raises ``NotImplementedError`` naming the sampler."""
    shape = tuple(int(s) for s in shape)
    region = tuple((int(a), int(b)) for a, b in region)
    out_shape = tuple(b - a for a, b in region)
    if out_shape == shape:
        return sample(dist_name, key, shape, dtype, device, x64, *params)
    if dist_name in _LOOPED:
        _on_the_mesh(dist_name)
        fn = _LOOPED[dist_name]
    else:
        fn = _FLAT[dist_name]
    if 0 in out_shape:
        if dist_name in _LOOPED:
            # the loops' flags are collective: a process with no elements
            # joins them all the same
            fn(key, shape, dtype, device, x64, {"flat_range": (0, 0)},
               *params)
        return torch.empty(out_shape, dtype=dtype, device=device)
    return fn(key, shape, dtype, device, x64, region_where(
        shape, region, device), *params).reshape(out_shape)


def region_where(shape, region, device):
    """The ``where`` keyword of a draw of the box ``region`` of ``shape``:
    one ``flat_range`` for whole rows, else ``runs`` (one range per
    combination of the leading indices, up to the last axis that is not
    whole)."""
    partial = [k for k, ((a, b), s) in enumerate(zip(region, shape))
               if b - a != s]
    last = partial[-1] if partial else 0
    stride = [_size(shape[k + 1:]) for k in range(len(shape))]
    if last == 0:
        start = region[0][0] * stride[0] if shape else 0
        return {"flat_range": (start, start + _size(
            [b - a for a, b in region]))}
    starts = torch.zeros((), dtype=torch.int64, device=device)
    for k in range(last):
        idx = torch.arange(*region[k], dtype=torch.int64, device=device)
        starts = (starts[..., None] + idx * stride[k]).reshape(-1)
    starts = starts + region[last][0] * stride[last]
    length = (region[last][1] - region[last][0]) * stride[last]
    return {"runs": (starts.reshape(-1), length)}


def integers(key, shape: tuple, dtype: torch.dtype, device, x64: bool,
             low: int, high: int, endpoint: bool, region=None):
    """Integers in [low, high), or [low, high] with ``endpoint``.

    Without ``x64`` an int64 request draws through the 32-bit path (the
    reference's int64 is int32 there) and the values are widened to int64
    afterwards; a bound outside int32 then raises ``OverflowError``, as
    the reference's does. With ``region`` (a box, as ``sample_region``'s)
    only that box is drawn, bit for bit the box of the whole draw."""
    draw_dtype = dtype
    if not x64 and dtype == torch.int64:
        draw_dtype = torch.int32
        for bound in (low, high):
            if not -(1 << 31) <= bound < (1 << 31):
                raise OverflowError(
                    f"integer bound {bound} does not fit the 32-bit integers "
                    "of this backend")
    where = {}
    if region is not None:
        region = tuple((int(a), int(b)) for a, b in region)
        out_shape = tuple(b - a for a, b in region)
        if 0 in out_shape:
            return torch.empty(out_shape, dtype=dtype, device=device)
        where = region_where(tuple(shape), region, device)
    if endpoint:
        # Draw on [low-1, high) and add 1: high+1 would overflow to the
        # dtype minimum when high is the dtype max, inverting the range.
        draws = jr_randint(key, shape, low - 1, high, draw_dtype, device, x64,
                           **where)
        draws = _wrap_signed(draws.to(torch.int64).add_(1),
                             torch.iinfo(draw_dtype).bits)
        return _as_box(draws.to(dtype), region)
    return _as_box(jr_randint(key, shape, low, high, draw_dtype, device, x64,
                              **where).to(dtype), region)


def _as_box(t, region):
    """A region draw in the box's shape (a whole draw as it is)."""
    return t if region is None else t.reshape(tuple(b - a for a, b in
                                                    region))


def permutation(key, n: int, device):
    """A random permutation of ``range(n)``, int64 (the reference's is
    int32 where 64-bit types are off: the values are the same, and int64
    is what torch's row gather takes without a cast); on the mesh,
    ``mesh_permutation``."""
    return jr_permutation_indices(key, n, device)
