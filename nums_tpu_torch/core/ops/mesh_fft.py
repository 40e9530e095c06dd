"""The distributed 1-D DFT of a sharded vector, in both directions.

The reference leaves its FFTs to XLA (``jnp.fft`` on a sharded vector is
one program over the mesh), so no module of ``nums_tpu`` matches this one,
as none matches ``mesh_linalg.py``. A vector of length L on the P
processes that shard it (a row group; the other mesh dimensions hold
replicas, each transformed alike):

* four-step, where L = n1·n2 with n1, n2 ≥ P: the sequence laid out as the
  rows of the n1×n2 matrix A[j1, j2] = x[n2·j1 + j2] (its runs moved to
  whole rows, one all-to-all, none where the cuts agree); A transposed
  (one all-to-all) so that its columns are local rows; the length-n1
  transforms of them, each times its twiddle W_L^(j2·k1); transposed
  back (one all-to-all) and the length-n2 transforms of the rows; one
  last transpose (one all-to-all): the rows of Z[k2, k1] = X[k1 + n1·k2]
  are runs of the output, which one move lays out as the result;
* Bluestein, for every other L (primes among them): X[k] = w[k]·Σ_j
  (x[j]·w[j])·w̄[k − j], w[m] = exp(±πi·(m² mod 2L)/L), the convolution by
  three four-step transforms of the power of two M ≥ max(2L − 1, P²).

Twiddles and chirps come from exact integers (int64 products and
remainders), their angles in float64, rounded to the transform's complex
dtype last. The local transforms are cuFFT's through ``torch.fft`` on each
process's own tensors (the reference's ``jnp.fft`` is XLA's own FFT, not a
Pallas kernel), a chunk of lines at a time. No process holds more than its
share of the vector and of the padded sequence; every process makes the
same collectives whatever its box holds (an empty one too).
"""

import math

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess

# Elements of a chunk of lines transformed (and twiddled) at a time: the
# twiddles take some 40 bytes an element in their exact integer and
# float64 steps.
CHUNK_ELEMENTS = 1 << 24
# Elements a process moves and transforms at a time along a sharded axis
# of an n-D array (``mesh_ops.across``): 512 MB of complex64.
ACROSS_CHUNK_ELEMENTS = 1 << 26
# j² of the chirp stays below 2^63 up to this length.
CHIRP_MAX_LENGTH = 3_037_000_499

_FORWARD = {"backward": lambda n: 1.0, "ortho": lambda n: 1 / math.sqrt(n),
            "forward": lambda n: 1.0 / n}
_INVERSE = {"backward": lambda n: 1.0 / n,
            "ortho": lambda n: 1 / math.sqrt(n), "forward": lambda n: 1.0}

# numpy's 1-D transforms: (the input sequence: "plain" the operand cut or
# zero-padded to n, "hermitian" its Hermitian extension to n; the sign of
# the exponent; the scale's direction; the output: "all" n bins, "half"
# n // 2 + 1, "real" the real part of n)
FORMS = {"fft": ("plain", -1, _FORWARD, "all"),
         "ifft": ("plain", 1, _INVERSE, "all"),
         "rfft": ("plain", -1, _FORWARD, "half"),
         "ihfft": ("plain", 1, _INVERSE, "half"),
         "irfft": ("hermitian", 1, _INVERSE, "real"),
         "hfft": ("hermitian", -1, _FORWARD, "real")}


def default_n(fname, length):
    """numpy's n of a transform of an operand of ``length``."""
    return 2 * (length - 1) if FORMS[fname][0] == "hermitian" else length


def out_length(fname, n):
    return n // 2 + 1 if FORMS[fname][3] == "half" else n


def factor(length, procs):
    """(n1, n2) with n1·n2 = ``length``, both at least ``procs``, n1 the
    largest such divisor up to √length; None where there is none."""
    for d in range(math.isqrt(length), procs - 1, -1):
        if length % d == 0 and length // d >= procs:
            return d, length // d
    return None


def bluestein_length(length, procs):
    """The power of two M ≥ max(2·length − 1, procs²)."""
    return 1 << max(2 * length - 2, procs * procs - 1, 1).bit_length()


def _dims(placements):
    return [k for k, p in enumerate(placements) if p.is_shard()]


def _layout(backend, dims):
    """Axis 0 split over the mesh dimensions ``dims``, replicated on the
    others."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if k in dims else Replicate()
                 for k in range(len(backend.device_grid.mesh_shape)))


def _rows(backend, shape, pl):
    """Every process's (start, stop) rows of an array of ``shape``."""
    return [backend.region(tuple(shape), pl, c)[0] for c in backend.coords()]


def _transform(t, dim, sign):
    """The unscaled DFT of ``t`` along ``dim`` (exponent of ``sign``)."""
    if sign < 0:
        return torch.fft.fft(t, dim=dim)
    return torch.fft.ifft(t, dim=dim, norm="forward")


def _unit(turns, parts, sign, scale, dtype):
    """scale·exp(sign·2πi·turns/parts) for int64 ``turns`` in [0, parts):
    the angle in float64, rounded to ``dtype`` last."""
    angle = turns.to(torch.float64) * (sign * 2.0 * math.pi / parts)
    return torch.polar(torch.full_like(angle, scale), angle).to(dtype)


def _lines(rows, sign, twiddle=None):
    """The transforms of ``rows`` (a local (r, m) tensor) along its rows, in
    place, a chunk at a time; with ``twiddle(r0, r1)``, rows [r0, r1) times
    it after."""
    step = max(1, CHUNK_ELEMENTS // max(int(rows.shape[1]), 1))
    for r0 in range(0, int(rows.shape[0]), step):
        r1 = min(int(rows.shape[0]), r0 + step)
        out = _transform(rows[r0:r1], 1, sign)
        if twiddle is not None:
            out *= twiddle(r0, r1)
        rows[r0:r1] = out
    return rows


def transpose(backend, local, shape, dims):
    """This process's rows of the transpose of the (R, C) matrix ``shape``
    whose rows [a, b) it holds in ``local``, both laid out by rows over the
    mesh dimensions ``dims``: each process sends every other of its row
    group the columns that process will hold, transposed (one all-to-all
    of its part, copied once into the buffer sent)."""
    R, C = (int(s) for s in shape)
    pl = _layout(backend, dims)
    src = _rows(backend, (R, C), pl)
    dst = _rows(backend, (C, R), pl)
    group, _ = backend._row_groups(pl)
    me = multiprocess.process_index()
    world = len(src)
    (a, b), (c, d) = src[me], dst[me]
    send, recv = [0] * world, [0] * world
    for r in group:
        send[r] = (b - a) * (dst[r][1] - dst[r][0])
        recv[r] = (src[r][1] - src[r][0]) * (d - c)
    flat = local.new_empty((sum(send),))
    at = 0
    for r in group:
        c_r, d_r = dst[r]
        flat[at:at + send[r]].view(d_r - c_r, b - a).copy_(
            local[:, c_r:d_r].T)
        at += send[r]
    got = multiprocess.exchange(flat, send, recv)
    del flat
    out = local.new_empty((d - c, R))
    at = 0
    for r in group:
        a_r, b_r = src[r]
        out[:, a_r:b_r] = got[at:at + recv[r]].view(d - c, b_r - a_r)
        at += recv[r]
    return out


def four_step(backend, rows, n1, n2, dims, sign, scale=1.0):
    """The DFT (exponent of ``sign``, times ``scale``) of the sequence whose
    n1×n2 matrix A[j1, j2] = x[n2·j1 + j2] has this process's rows
    ``rows`` (complex, laid out by rows over ``dims``); returns this
    process's rows of Z[k2, k1] = X[k1 + n1·k2], the (n2, n1) matrix laid
    out the same way: runs of the output in order. Three transposes."""
    length = n1 * n2
    cols = transpose(backend, rows, (n1, n2), dims)
    del rows
    j0 = _rows(backend, (n2, n1), _layout(backend, dims))[
        multiprocess.process_index()][0]
    k1 = torch.arange(n1, dtype=torch.int64, device=cols.device)

    def twiddle(r0, r1):
        j2 = torch.arange(j0 + r0, j0 + r1, dtype=torch.int64,
                          device=cols.device)
        return _unit((j2[:, None] * k1[None, :]) % length, length, sign,
                     scale, cols.dtype)

    _lines(cols, sign, twiddle)
    rows = transpose(backend, cols, (n2, n1), dims)
    del cols
    _lines(rows, sign)
    return transpose(backend, rows, (n1, n2), dims)


def _pieces(backend, x, form, n):
    """(this process's parts, every process's runs of the input sequence
    that its parts are, the length of the prefix of the sequence they
    cover): ``form`` "plain" is the operand's first min(n, L) elements;
    "hermitian" is S[p] = x[p] for p < h = n // 2 + 1 and S[n − t] =
    conj(x[t]) for t in [1, n − h], the operand at least h long."""
    shape, pl = (int(x.shape[0]),), tuple(x.placements)
    boxes = _rows(backend, shape, pl)
    me = multiprocess.process_index()
    local = x.to_local()
    if form == "plain":
        cover = min(n, shape[0])
        runs = [[(lo, min(hi, cover))] if min(hi, cover) > lo else []
                for lo, hi in boxes]
        lo, hi = boxes[me]
        return [local[:max(0, min(hi, cover) - lo)]], runs, cover
    h = n // 2 + 1
    runs, parts = [], []
    for r, (lo, hi) in enumerate(boxes):
        mine = []
        if min(hi, h) > lo:
            mine.append((lo, min(hi, h)))
            if r == me:
                parts.append(local[:min(hi, h) - lo])
        u, v = max(lo, 1), min(hi, n - h + 1)
        if v > u:  # x[u:v] reversed lands on S[n − v + 1 : n − u + 1]
            mine.append((n - v + 1, n - u + 1))
            if r == me:
                parts.append(torch.flip(local[u - lo:v - lo], (0,))
                             .conj().resolve_conj())
        runs.append(mine)
    return parts, runs, n


def place_rows(backend, x, form, n, shape, dims, dtype):
    """This process's rows of the ``shape`` matrix (n1, n2) of the input
    sequence of ``form`` (``_pieces``), zero after the prefix that the
    operand covers, in ``dtype``: the runs moved by one all-to-all within
    each row group (``MeshBackend.move_pieces``)."""
    n1, n2 = shape
    pl = _layout(backend, dims)
    parts, runs, cover = _pieces(backend, x, form, n)
    dst = [(min(a * n2, cover), min(b * n2, cover))
           for a, b in _rows(backend, (n1, n2), pl)]
    got = backend.move_pieces(parts or [x.to_local()[:0]], runs, dst, pl)
    a, b = _rows(backend, (n1, n2), pl)[multiprocess.process_index()]
    out = torch.zeros(((b - a) * n2,), dtype=dtype, device=got.device)
    out[:got.shape[0]] = got
    return out.view(b - a, n2)


def to_vector(backend, rows, shape, dims, out_len, placements):
    """The first ``out_len`` of the sequence whose (R, C) matrix ``shape``
    has this process's rows ``rows`` (laid out by rows over ``dims``), as
    a DTensor vector laid out by ``placements``: one move within each row
    group, then ``rebox`` where the result shards other mesh dimensions."""
    R, C = shape
    pl = _layout(backend, dims)
    src = [(min(a * C, out_len), min(b * C, out_len))
           for a, b in _rows(backend, (R, C), pl)]
    lo, hi = src[multiprocess.process_index()]
    dst = _rows(backend, (out_len,), pl)
    flat = backend.move_rows(rows.reshape(-1)[:hi - lo], src, dst, pl)
    out = backend.from_local(flat.contiguous(), (out_len,), pl)
    return backend.rebox(out, tuple(placements))


def _chirp(flat, p0, lo, hi, length, sign, scale=1.0, mirror=None,
           put=False):
    """``flat[i]`` (the position p0 + i) for the positions [lo, hi), a chunk
    at a time, times (with ``put``: set to) scale·w[p], w[p] =
    exp(sign·πi·(p² mod 2·length)/length), or w[mirror − p]: the squares of
    exact positions below ``length`` in int64."""
    for c0 in range(lo, hi, CHUNK_ELEMENTS):
        c1 = min(hi, c0 + CHUNK_ELEMENTS)
        p = torch.arange(c0, c1, dtype=torch.int64, device=flat.device)
        if mirror is not None:
            p = mirror - p
        w = _unit((p * p) % (2 * length), 2 * length, sign, scale,
                  flat.dtype)
        seg = flat[c0 - p0:c1 - p0]
        if put:
            seg.copy_(w)
        else:
            seg *= w


def _bluestein(backend, x, form, n, dims, procs, sign, scale, dtype):
    """This process's rows of the (m1, m2) matrix of the DFT of the length-n
    input sequence (its first n positions; the rest is not the DFT), by
    Bluestein's convolution over M = m1·m2."""
    if n > CHIRP_MAX_LENGTH:
        raise NotImplementedError(
            f"fft of length {n} on the mesh: Bluestein's chirp (p² mod 2n "
            "in int64) is not ported beyond length "
            f"{CHIRP_MAX_LENGTH}; give an n that is the product of two "
            "factors each at least the number of processes")
    M = bluestein_length(n, procs)
    m1 = 1 << (M.bit_length() - 1) // 2
    m2 = M // m1
    pl = _layout(backend, dims)
    a0, a1 = _rows(backend, (m1, m2), pl)[multiprocess.process_index()]
    p0, p1 = a0 * m2, a1 * m2
    a = place_rows(backend, x, form, n, (m1, m2), dims, dtype)
    _chirp(a.view(-1), p0, p0, min(p1, n), n, sign)
    fa = four_step(backend, a, m1, m2, dims, -1)
    del a
    # b[p] = w̄[p] for p < n, w̄[M − p] for p > M − n, zero between
    b = torch.zeros((a1 - a0, m2), dtype=dtype, device=fa.device)
    _chirp(b.view(-1), p0, p0, min(p1, n), n, -sign, put=True)
    _chirp(b.view(-1), p0, max(p0, M - n + 1), p1, n, -sign, mirror=M,
           put=True)
    fb = four_step(backend, b, m1, m2, dims, -1)
    del b
    fa *= fb
    del fb
    # the inverse over (m2, m1): its input rows are fa's, its output rows
    # those of the (m1, m2) matrix, the sequence in order
    conv = four_step(backend, fa, m2, m1, dims, 1, 1.0 / M)
    del fa
    _chirp(conv.view(-1), p0, p0, min(p1, n), n, sign, scale)
    return conv, (m1, m2)


def dft(backend, fname, x, n, norm, placements, complex_dtype):
    """numpy's 1-D transform ``fname`` (``FORMS``) of the DTensor vector
    ``x`` with numpy's ``n`` and ``norm``, as a DTensor laid out by
    ``placements``. ``x`` is sharded by some mesh dimensions (a replicated
    vector is each process's own: its transform is local, its result cut
    to this process's box); ``complex_dtype`` is the transform's."""
    form, sign, scales, out = FORMS[fname]
    norm = norm or "backward"
    if norm not in _FORWARD:
        raise ValueError(f'Invalid norm value {norm}; should be "backward",'
                         '"ortho" or "forward".')
    length = int(x.shape[0])
    if n is None:
        n = default_n(fname, length)
    n = int(n)
    if n < 1:
        raise ValueError(f"Invalid number of FFT data points ({n}) "
                         "specified.")
    dims = _dims(x.placements)
    procs = int(np.prod([backend.device_grid.mesh_shape[k] for k in dims]))
    out_len = out_length(fname, n)
    if procs == 1:  # a whole vector on each process: its own transform
        local = getattr(torch.fft, fname)(x.to_local(), n=n, norm=norm)
        return backend.scatter_full(local.resolve_conj().contiguous(),
                                    tuple(placements))
    if form == "hermitian" and length < n // 2 + 1:
        from nums_tpu_torch.core.ops import mesh_ops

        x = mesh_ops.pad_axis(backend, x, 0, 0, n // 2 + 1 - length, None,
                              fill=0)
    scale = scales[norm](n)
    shape = factor(n, procs)
    if shape is None:
        rows, shape = _bluestein(backend, x, form, n, dims, procs, sign,
                                 scale, complex_dtype)
    else:
        a = place_rows(backend, x, form, n, shape, dims, complex_dtype)
        rows = four_step(backend, a, shape[0], shape[1], dims, sign, scale)
        shape = shape[::-1]
    if out == "real":
        rows = rows.real.contiguous()
    return to_vector(backend, rows, shape, dims, out_len, placements)
