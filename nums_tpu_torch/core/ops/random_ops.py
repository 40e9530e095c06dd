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
"""

import math

import numpy as np
import torch

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


def jr_permutation_indices(key, n: int, device):
    """The index order of ``jax.random.permutation(key, n)`` (and of a
    shuffle of n items along an axis), int64: ``ceil(3 ln n / ln(2**32 -
    1))`` rounds, each a split and a stable sort by fresh 32-bit keys."""
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(threefry.MASK32)))
    for _ in range(rounds):
        key, subkey = threefry.split(key)
        sort_keys = _unsigned_order(
            threefry.random_bits(subkey, (n,), 32, device))
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


def jr_gumbel(key, shape, dtype, device, **where):
    """``jax.random.gumbel`` (its default low-range mode)."""
    tiny = float(np.finfo(_np_float(dtype)).tiny)
    u = jr_uniform(key, shape, dtype, device, tiny, 1.0, **where)
    return u.log_().neg_().log_().neg_()


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
    if n_inputs <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if not replace and n_draws > n_inputs:
        raise ValueError(
            f"Cannot take a larger sample (size {n_draws}) than "
            f"population (size {n_inputs}) when 'replace=False'")
    if p is None:
        if replace:
            ind = jr_randint(key, shape, 0, n_inputs, int_dtype, device, x64)
        else:
            ind = jr_permutation_indices(key, n_inputs, device)[:n_draws]
    else:
        if tuple(p.shape) != (n_inputs,):
            raise ValueError(
                "p must be None or a 1D vector with the same size as "
                f"a.shape[axis]. p has shape {tuple(p.shape)} and "
                f"a.shape[axis] is {n_inputs}.")
        if not p.is_floating_point():
            p = p.to(_wide(x64))
        if replace:
            p_cuml = torch.cumsum(p, 0)
            u = jr_uniform(key, shape, p.dtype, device)
            r = p_cuml[-1] * (1 - u)
            ind = torch.searchsorted(p_cuml, r.reshape(-1)).reshape(shape)
        else:
            g = jr_gumbel(key, (n_inputs,), p.dtype, device) + torch.log(p)
            ind = torch.topk(g, n_draws).indices
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


def _poisson_knuth(key, lam, shape, dtype, device):
    k = torch.zeros(shape, dtype=dtype, device=device)
    log_prod = torch.zeros(shape, dtype=torch.float32, device=device)
    neg_lam = -lam
    while bool((log_prod > neg_lam).any()):
        key, subkey = threefry.split(key)
        k = torch.where(log_prod > neg_lam, k + 1, k)
        u = jr_uniform(subkey, shape, torch.float32, device)
        log_prod = log_prod + u.log_()
    return k - 1


def _poisson_rejection(key, lam, shape, dtype, device):
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, dtype=lam.dtype, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(accepted.all()):
        key, subkey_0, subkey_1 = threefry.split(key, 3)
        u = jr_uniform(subkey_0, shape, lam.dtype, device) - 0.5
        v = jr_uniform(subkey_1, shape, lam.dtype, device)
        u_shifted = 0.5 - u.abs()
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out.to(dtype)


def jr_poisson(key, shape, device, x64, lam, dtype=None):
    """``jax.random.poisson``: Knuth's product below lam = 10, Hörmann's
    transformed rejection above, both on float32, each a whole-array loop
    over split keys until no element is left. Both run on the same key and
    are selected by element, as jax's; a branch no element takes is
    skipped (it does not touch the other's values)."""
    shape = tuple(int(s) for s in shape)
    dtype = dtype or _default_int(x64)
    lam = _as_param(lam, shape, torch.float32, device)
    use_knuth = torch.isnan(lam) | (lam < 10)
    result = torch.zeros(shape, dtype=dtype, device=device)
    if bool(use_knuth.any()):
        lam_knuth = torch.where(use_knuth, lam, torch.zeros_like(lam))
        result = torch.where(
            use_knuth, _poisson_knuth(key, lam_knuth, shape, dtype, device),
            result)
    if not bool(use_knuth.all()):
        lam_rej = torch.where(use_knuth, torch.full_like(lam, 1e5), lam)
        result = torch.where(
            use_knuth, result,
            _poisson_rejection(key, lam_rej, shape, dtype, device))
    return torch.where(lam == 0, torch.zeros_like(result), result)


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


def _binomial_inversion(key, count, prob, shape, device):
    log1minusprob = torch.log1p(-prob)
    num_geom = torch.zeros(shape, dtype=prob.dtype, device=device)
    geom_sum = torch.zeros(shape, dtype=prob.dtype, device=device)
    while bool((geom_sum <= count).any()):
        subkey, key = threefry.split(key)
        num_geom = torch.where(geom_sum <= count, num_geom + 1, num_geom)
        u = jr_uniform(subkey, shape, prob.dtype, device)
        geom_sum = geom_sum + torch.ceil(u.log_() / log1minusprob)
    return num_geom - 1


def _btrs(key, count, prob, shape, device):
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - 4.2 / b
    r = prob / (1 - prob)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full(shape, -1.0, dtype=prob.dtype, device=device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=device)
    while not bool(accepted.all()):
        key, subkey_0, subkey_1 = threefry.split(key, 3)
        u = jr_uniform(subkey_0, shape, prob.dtype, device)
        v = jr_uniform(subkey_1, shape, prob.dtype, device)
        u = u - 0.5
        us = 0.5 - u.abs()
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = (
            (m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
            + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
            + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
            + _stirling_approx_tail(m)
            + _stirling_approx_tail(count - m)
            - _stirling_approx_tail(k)
            - _stirling_approx_tail(count - k)
        )
        accept = accept1 | (~reject & (v <= ub))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out


def jr_binomial(key, shape, dtype, device, x64, n, p):
    """``jax.random.binomial``: geometric inversion where n·min(p, 1-p) <=
    10, the BTRS rejection above, both in the width of ``p`` (a Python
    float is the wide float) and cast to ``dtype`` at the end."""
    shape = tuple(int(s) for s in shape)
    pdt = p.dtype if torch.is_tensor(p) and p.is_floating_point() \
        else _wide(x64)
    prob = _as_param(p, shape, pdt, device)
    count = _as_param(n, shape, pdt, device)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    samples = torch.zeros(shape, dtype=pdt, device=device)
    if bool(use_inversion.any()):
        count_inv = torch.where(use_inversion, count,
                                torch.zeros_like(count))
        samples = torch.where(
            use_inversion,
            _binomial_inversion(key, count_inv, q, shape, device), samples)
    if not bool(use_inversion.all()):
        count_btrs = torch.where(use_inversion, torch.full_like(count, 1e4),
                                 count)
        q_btrs = torch.where(use_inversion, torch.full_like(q, 0.5), q)
        samples = torch.where(
            use_inversion, samples,
            _btrs(key, count_btrs, q_btrs, shape, device))
    samples = samples.to(dtype)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, torch.full_like(samples, np.nan), samples)
    samples = torch.where(count_inf & ~invalid,
                          torch.full_like(samples, np.inf), samples)
    return torch.where(
        p_lt_half | count_nan_or_neg | q_is_nan | count_inf, samples,
        count.to(dtype) - samples)


def jr_multinomial(key, n, p, shape, device):
    """``jax.random.multinomial``: ``p`` (..., K) and ``n`` float tensors;
    ``shape`` the FULL output shape (batch and category axes) or None.
    One binomial per category on the trials that remain, keys from one
    split over the categories."""
    if shape is None:
        shape = tuple(p.shape)
    shape = tuple(int(s) for s in shape)
    n = n.broadcast_to(shape[:-1])
    p = torch.movedim(p.broadcast_to(shape), -1, 0)
    remaining = torch.flip(torch.cumsum(torch.flip(p, (0,)), 0), (0,))
    ratios = p / torch.where(remaining == 0, torch.ones_like(remaining),
                             remaining)
    keys = threefry.split(key, int(ratios.shape[0]))
    remainder = n
    counts = []
    for ratio, sub in zip(ratios, keys):
        count = jr_binomial(sub, shape[:-1], remainder.dtype, device, False,
                            remainder, ratio.clamp(0, 1))
        remainder = remainder - count
        counts.append(count)
    return torch.movedim(torch.stack(counts, 0), 0, -1)


def jr_multivariate_normal(key, mean, cov, shape, dtype, device):
    """``jax.random.multivariate_normal`` with its default Cholesky
    factor; ``shape`` the batch shape or None."""
    n = int(mean.shape[-1])
    if tuple(cov.shape[-2:]) != (n, n):
        raise ValueError(
            "multivariate_normal requires cov.shape == (..., n, n) for "
            f"n={n}, but got cov.shape == {tuple(cov.shape)}.")
    if shape is None:
        shape = torch.broadcast_shapes(mean.shape[:-1], cov.shape[:-2])
    factor = torch.linalg.cholesky(cov)
    z = jr_normal(key, tuple(shape) + (n,), dtype, device)
    return mean + torch.einsum("...ij,...j->...i", factor.to(z.dtype), z)


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


def _negative_binomial(key, shape, dtype, device, x64, n, p):
    k1, k2 = threefry.split(key)
    p = _scalar(x64, p)
    lam = jr_gamma(k1, shape, torch.float32, device, n).mul_(
        float((1.0 - p) / p))
    return jr_poisson(k2, shape, device, x64, lam).to(dtype)


def _noncentral_chisquare(key, shape, dtype, device, x64, df, nonc):
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
                               float(max(dfa - npdt(1.0), npdt(1e-6))))
        sqrt_nonc = float(np.sqrt(_scalar(x64, nonc)))
        shifted = jr_normal(k2, shape, dtype, device).add_(sqrt_nonc)
        return central.add_(shifted.mul_(shifted))
    i = jr_poisson(k3, shape, device, x64,
                   float(np.float32(nonc) / np.float32(2.0)))
    return jr_chisquare(k4, shape, dtype, device,
                        float(dfa) + 2.0 * i.to(dtype))


def _noncentral_f(key, shape, dtype, device, x64, dfnum, dfden, nonc):
    # Independent keys via ONE split: mixing fold_in(key, i) with
    # split(key) collides (threefry split == fold_in over indices).
    k_num, k_den = threefry.split(key)
    num = _noncentral_chisquare(k_num, shape, dtype, device, x64, dfnum,
                                nonc).div_(dfnum)
    den = jr_chisquare(k_den, shape, dtype, device, dfden).div_(dfden)
    return num.div_(den)


def supported(name: str) -> bool:
    return name in _DISTS


# Device path is O(nsample) sequential draws per element; beyond this,
# the host generator is faster than the chain.
HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE = 4096


def hypergeometric(key, shape, dtype, device, nsample: int, ngood, nbad):
    """Exact sequential without-replacement sampler.

    k = Σ_{t<nsample} Bernoulli(good_t / (good_t + bad_t)) with the urn
    updated each draw: the chain-rule factorization of the hypergeometric
    pmf, vectorized over the output shape. Draw t's key is
    ``fold_in(key, t)`` and its uniform float32. The urn counts are int32:
    exact updates for populations up to 2^31 (float32 counts stop
    depleting above 2^24); the float32 cast in the accept test only
    perturbs the ratio in its 7th digit."""
    shape = tuple(int(s) for s in shape)
    good = torch.full(shape, int(ngood), dtype=torch.int32, device=device)
    bad = torch.full(shape, int(nbad), dtype=torch.int32, device=device)
    k = torch.zeros(shape, dtype=torch.int32, device=device)
    for t in range(int(nsample)):
        u = jr_uniform(threefry.fold_in(key, t), shape, torch.float32,
                       device)
        goodf = good.to(torch.float32)
        take = (u * (goodf + bad.to(torch.float32)) < goodf).to(torch.int32)
        good -= take
        bad -= 1 - take
        k += take
    return k.to(dtype)


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

# The samplers that are not position-wise, each with the reason from
# jax's algorithm: a sharded draw of them raises ``NotImplementedError``
# naming the sampler (a process never draws the whole array to keep a
# shard of it).
NOT_POSITION_WISE = {
    "poisson": "Hörmann's rejection (lam >= 10) loops over the whole array "
               "until every element is accepted and keeps each element's "
               "LAST accepted proposal, so an element's value depends on "
               "how many rounds the slowest element of the array needs",
    "binomial": "the BTRS rejection (n·min(p, 1-p) > 10) keeps the last "
                "accepted proposal of a loop over the whole array, as "
                "Poisson's does",
    "negative_binomial": "a Poisson draw whose rate is a gamma draw: the "
                         "rates of 10 and more take Poisson's whole-array "
                         "rejection loop",
    "noncentral_chisquare": "its df <= 1 regime is a Poisson mixture "
                            "(Poisson's whole-array rejection loop)",
    "noncentral_f": "built on noncentral_chisquare",
}


def _whole(fn):
    return lambda key, shape, dtype, device, x64, *params: fn(
        key, shape, dtype, device, x64, {}, *params)


# Each impl: fn(key, shape, dtype, device, x64, *params) -> tensor of
# `shape`/`dtype` on `device` (a position-wise sampler: its ``_FLAT``
# entry drawing everywhere).
_DISTS = {name: _whole(fn) for name, fn in _FLAT.items()}
_DISTS.update({
    "binomial": lambda key, shape, dtype, device, x64, n, p: jr_binomial(
        key, shape, dtype, device, x64, n, p),
    "poisson": lambda key, shape, dtype, device, x64, lam: jr_poisson(
        key, shape, device, x64, lam).to(dtype),
    # negative_binomial(n, p) == Poisson(Gamma(n, (1-p)/p)).
    "negative_binomial": lambda key, shape, dtype, device, x64, n, p:
        _negative_binomial(key, shape, dtype, device, x64, n, p),
    "noncentral_chisquare": lambda key, shape, dtype, device, x64, df, nonc:
        _noncentral_chisquare(key, shape, dtype, device, x64, df, nonc),
    "noncentral_f": lambda key, shape, dtype, device, x64, dfnum, dfden, nonc:
        _noncentral_f(key, shape, dtype, device, x64, dfnum, dfden, nonc),
})


def sample_region(dist_name: str, key, shape: tuple, region, dtype, device,
                  x64: bool, *params):
    """The box ``region`` ((start, stop) per axis) of the draw
    ``sample(dist_name, key, shape, ...)``, equal to that box of the whole
    draw: a mesh process draws only its own positions. The box is one
    range of C-order positions per combination of its leading indices, up
    to its last axis that is not whole: one range for whole rows, one per
    row for a column shard. A sampler that is not position-wise (not in
    ``_FLAT``) draws only a box that is the whole array, and raises
    ``NotImplementedError`` naming itself for a smaller one: a process
    never draws the whole array to keep a shard of it."""
    shape = tuple(int(s) for s in shape)
    region = tuple((int(a), int(b)) for a, b in region)
    out_shape = tuple(b - a for a, b in region)
    if dist_name not in _FLAT:
        if out_shape == shape:
            return sample(dist_name, key, shape, dtype, device, x64,
                          *params)
        why = NOT_POSITION_WISE.get(dist_name, "not position-wise")
        raise NotImplementedError(
            f"{dist_name}: a shard of this draw is not drawn alone (jax's "
            f"algorithm is not position-wise: {why})")
    fn = _FLAT[dist_name]
    if 0 in out_shape:
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
    is what torch's row gather takes without a cast)."""
    return jr_permutation_indices(key, n, device)
