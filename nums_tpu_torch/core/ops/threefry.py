"""The threefry2x32 counter-based generator, in torch integer ops.

Counterpart of what ``nums_tpu`` gets from jax's default PRNG
(``threefry2x32`` in its *partitionable* form): a key is two 32-bit words,
and the 32 random bits at flat (row-major) position ``i`` of a draw are
``w0 ^ w1`` of ``threefry2x32(key, (i >> 32, i & 0xffffffff))``. A 64-bit
draw keeps both words (``w0 << 32 | w1``); an 8- or 16-bit draw truncates
``w0 ^ w1``. Every position is a function of (key, position) alone, so any
flat range of any array can be drawn on its own: a draw is made in chunks
of ``CHUNK`` positions written straight into the output, and is bitwise
independent of the chunk size and of the array's block shape.

Torch has no unsigned 32-bit arithmetic. The words are held in ``int32``
tensors as bit patterns: two's-complement addition wraps exactly as the
unsigned one does, and a rotation is a left shift OR-ed with an arithmetic
right shift whose sign-extended high bits are masked off. (``int64`` with a
mask after each add gives the same bits at twice the memory traffic; the
pure-Python version below, on unbounded ints, is the host path for scalar
keys and the oracle the tensor version is tested against.)

A *key* is a pair of Python ints in ``[0, 2**32)``; ``fold_in`` and
``split`` of such a key run on the host in pure Python (no device work, no
synchronisation). A *batched key* is a pair of ``int32`` tensors of one
shape, one key per element: the per-element streams of the gamma sampler.
"""

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# Positions drawn at a time. A chunk holds three int32 words of scratch per
# position (128 MiB each) and what its transform makes of them, whatever
# the size of the draw.
CHUNK = 1 << 25


def _signed(word: int) -> int:
    """A 32-bit pattern as the int32 value that holds it."""
    word &= MASK32
    return word - (1 << 32) if word >= (1 << 31) else word


# ---------------------------------------------------------------------
# Host path: scalar keys, pure Python
# ---------------------------------------------------------------------


def threefry2x32_ints(k0: int, k1: int, c0: int, c1: int):
    """threefry2x32 of one counter pair on Python ints; returns (w0, w1)."""
    ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ _PARITY) & MASK32)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def seed_key(seed: int, x64: bool):
    """The key of an integer seed: the two 32-bit halves of its 64-bit
    two's-complement pattern. Without ``x64`` (the reference on an
    accelerator, where 64-bit types are off) the seed is first truncated
    to 32 bits, so the high word is 0. A seed outside the int64 range
    raises ``OverflowError``, as the reference's does."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    seed &= (1 << 64) - 1
    return ((seed >> 32) & MASK32 if x64 else 0, seed & MASK32)


def fold_in(key, data: int):
    """A new key from ``key`` and a 32-bit integer."""
    return threefry2x32_ints(key[0], key[1], 0, int(data) & MASK32)


def split(key, num: int = 2):
    """``num`` new keys: both output words at the counters ``(0, i)``."""
    return [threefry2x32_ints(key[0], key[1], 0, i) for i in range(num)]


# ---------------------------------------------------------------------
# Tensor path
# ---------------------------------------------------------------------


def _key_word(word):
    return word if torch.is_tensor(word) else _signed(word)


def _add_const(x, value):
    """x += value, in place, for an int (bit pattern) or a tensor."""
    return x.add_(value if torch.is_tensor(value) else _signed(value))


def _threefry_inplace(k0, k1, x0, x1):
    """threefry2x32 of the counter words ``x0``, ``x1`` (int32 tensors of
    one shape), overwriting them with the two output words. ``k0``/``k1``
    are Python ints or int32 tensors that broadcast against the counters."""
    if torch.is_tensor(k0) or torch.is_tensor(k1):
        k0 = torch.as_tensor(_key_word(k0), dtype=torch.int32,
                             device=x0.device)
        k1 = torch.as_tensor(_key_word(k1), dtype=torch.int32,
                             device=x0.device)
        ks = (k0, k1, (k0 ^ k1) ^ _signed(_PARITY))
        inject = [(ks[(i + 1) % 3], ks[(i + 2) % 3] + (i + 1))
                  for i in range(5)]
    else:
        ks = (k0 & MASK32, k1 & MASK32, (k0 ^ k1 ^ _PARITY) & MASK32)
        inject = [(ks[(i + 1) % 3], ks[(i + 2) % 3] + i + 1)
                  for i in range(5)]
    tmp = torch.empty_like(x1)
    _add_const(x0, ks[0])
    _add_const(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1)
            # rotate x1 left by r: the arithmetic right shift drags the
            # sign bit in, so its high bits are masked off.
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            tmp.bitwise_and_((1 << r) - 1)
            x1.bitwise_left_shift_(r)
            x1.bitwise_or_(tmp)
            x1.bitwise_xor_(x0)
        _add_const(x0, inject[i][0])
        _add_const(x1, inject[i][1])
    return x0, x1


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 on tensors: ``c0``/``c1`` are int32 counter words (bit
    patterns), ``k0``/``k1`` Python ints or int32 tensors. Returns the two
    output words as new int32 tensors."""
    c0, c1 = torch.broadcast_tensors(c0, c1)
    return _threefry_inplace(k0, k1, c0.clone(), c1.clone())


def _counter_runs(start: int, stop: int, chunk: int):
    """[start, stop) cut into runs of at most ``chunk`` positions, none of
    which crosses a multiple of 2**31: inside a run the high counter word
    is constant and the low word, as an int32, does not wrap."""
    pos = start
    while pos < stop:
        end = min(stop, pos + chunk, ((pos >> 31) + 1) << 31)
        yield pos, end
        pos = end


def _run_words(key, a: int, b: int, device):
    """The two output words for the flat positions [a, b) of one run."""
    lo = _signed(a & MASK32)
    x1 = torch.arange(lo, lo + (b - a), dtype=torch.int32, device=device)
    x0 = torch.full_like(x1, _signed(a >> 32))
    return _threefry_inplace(key[0], key[1], x0, x1)


def _pack(w0, w1, width: int):
    if width == 64:
        hi = w0.to(torch.int64).bitwise_left_shift_(32)
        return hi.bitwise_or_(w1.to(torch.int64).bitwise_and_(MASK32))
    bits = w0.bitwise_xor_(w1)
    if width == 32:
        return bits
    if width == 16:
        return bits.to(torch.int16)
    return bits.bitwise_and_(0xFF).to(torch.uint8)


_BITS_DTYPE = {8: torch.uint8, 16: torch.int16, 32: torch.int32,
               64: torch.int64}


def fill_bits(key, out_flat, width: int, start: int, transform=None,
              chunk: int = None):
    """Write the draw's flat positions ``[start, start + len(out_flat))``
    into the 1-d tensor ``out_flat``, a chunk at a time. ``transform`` maps
    a chunk of raw bits (``_BITS_DTYPE[width]``) to ``out_flat``'s dtype;
    without it the bits themselves are written. With a *list* of keys the
    transform gets the list of their bits at the same positions."""
    stop = start + out_flat.numel()
    if stop > 1 << 64:
        raise NotImplementedError("random bits array of size exceeding 2**64")
    several = isinstance(key, list)
    for a, b in _counter_runs(start, stop, chunk or CHUNK):
        bits = [_pack(*_run_words(k, a, b, out_flat.device), width)
                for k in (key if several else [key])]
        if transform is None:
            out_flat[a - start:b - start] = bits[0]
        else:
            out_flat[a - start:b - start] = transform(
                bits if several else bits[0])
    return out_flat


def fill_runs(key, out, width: int, starts, transform=None,
              chunk: int = None):
    """Row ``r`` of the 2-d tensor ``out`` gets the draw's flat positions
    ``[starts[r], starts[r] + out.shape[1])`` (``starts``: an int64 tensor
    on ``out``'s device), a block of rows at a time: one range per row, as
    a column shard of a mesh holds them. ``transform`` as in
    ``fill_bits``."""
    rows, length = out.shape
    several = isinstance(key, list)
    step = max(1, (chunk or CHUNK) // max(length, 1))
    cols = torch.arange(length, dtype=torch.int64, device=out.device)
    for a in range(0, rows, step):
        b = min(a + step, rows)
        pos = (starts[a:b, None] + cols[None, :]).reshape(-1)
        # The low word as its int32 bit pattern (int64 -> int32 keeps the
        # low 32 bits), the high word as it is; a list of keys gives the
        # transform the list of their bits, as ``fill_bits``.
        bits = [_pack(*_threefry_inplace(k[0], k[1],
                                         (pos >> 32).to(torch.int32),
                                         pos.to(torch.int32)), width)
                for k in (key if several else [key])]
        out[a:b] = (bits[0] if transform is None else transform(
            bits if several else bits[0])).reshape(b - a, length)
    return out


def random_bits(key, shape, width: int = 32, device="cpu", start: int = 0,
                stop: int = None, chunk: int = None):
    """Uniform random bits of the row-major array ``shape`` under ``key``.

    Returns the whole array, or with ``start``/``stop`` the 1-d flat range
    ``[start, stop)`` of it (so a slice of an array too large to hold can
    be drawn alone). Bits are bit patterns in the signed dtype of their
    width (uint8 for 8): ``int32`` for 32, ``int64`` for 64."""
    if width not in _BITS_DTYPE:
        raise TypeError("requires 8-, 16-, 32- or 64-bit field width.")
    shape = tuple(int(s) for s in shape)
    size = 1
    for s in shape:
        size *= s
    whole = start == 0 and stop is None
    stop = size if stop is None else stop
    assert 0 <= start <= stop <= size, (start, stop, size)
    out = torch.empty(stop - start, dtype=_BITS_DTYPE[width], device=device)
    fill_bits(key, out, width, start, chunk=chunk)
    return out.reshape(shape) if whole else out


# ---------------------------------------------------------------------
# Batched keys: one key per element
# ---------------------------------------------------------------------


def split_keys(key, n: int, device):
    """``split(key, n)`` as a batched key: two int32 tensors of shape (n,),
    drawn in chunks like any other bits."""
    k0 = torch.empty(n, dtype=torch.int32, device=device)
    k1 = torch.empty(n, dtype=torch.int32, device=device)
    for a, b in _counter_runs(0, n, CHUNK):
        w0, w1 = _run_words(key, a, b, device)
        k0[a:b] = w0
        k1[a:b] = w1
    return k0, k1


def keys_at(key, positions):
    """The keys ``split(key, n)[i]`` at the given flat positions (an int64
    tensor, any n beyond them) as a batched key: a region of a split."""
    pos = positions.reshape(-1)
    return _threefry_inplace(key[0], key[1], (pos >> 32).to(torch.int32),
                             pos.to(torch.int32))


def split_batched(keys, num: int = 2):
    """Each element's key split into ``num``: a list of batched keys."""
    k0, k1 = keys
    out = []
    for i in range(num):
        out.append(_threefry_inplace(
            k0, k1, torch.zeros_like(k0), torch.full_like(k0, i)))
    return out


def bits_batched(keys, width: int = 32):
    """One scalar draw (shape ``()``: the counter (0, 0)) under each
    element's key."""
    k0, k1 = keys
    w0, w1 = _threefry_inplace(k0, k1, torch.zeros_like(k0),
                               torch.zeros_like(k0))
    return _pack(w0, w1, width)
