"""The ``signal`` table of tests/test_torch_mesh_signal*.py: the signal ops
of the port's mesh, each entry an op on arrays made from a seed, run
through the port's mesh (4 gloo processes of ``mesh_pool``, the whole
table in ONE call, every entry under the gather guard
``torch_parity.refusing_gathers``), nums_tpu's mesh (the 8 virtual CPU
devices) and the port's serial backend:

* the six 1-D transforms of a sharded vector (``core/ops/mesh_fft.py``:
  four-step where the length is n1·n2 with both factors at least the
  processes, Bluestein otherwise) at lengths 1000, 1003 = 17·59 (uneven
  boxes), 1009 (prime), 1024, and 3 and 5 (a box empty, or the vector
  whole on each process), with numpy's ``n`` shorter and longer, the
  three norms, complex, real, integer and float32 input, and nonzero
  imaginary parts at the edge bins that ``irfft``/``hfft`` ignore;
* the n-D transforms and the shifts of X8/X7 (axis by axis, a sharded
  axis through ``mesh_ops.across``) and of a vector;
* ``convolve``/``correlate``/``polymul`` of two sharded vectors (the
  shorter one on a ring) in the three modes, swapped operands and
  complex ones;
* ``poly`` of 1003 sharded roots (real ones, and complex ones in
  conjugate pairs) and of 301 complex ones;
* the four quantile forms at a sharded q of 1001 values, with NaNs, of a
  vector and along the rows of a matrix.

``TOLS[name]`` is the tolerance as max|got − ref| / max|ref| against the
reference's mesh (``reference_names``) and the serial port: float64
(complex128) results within ``ARITH``, float32 (complex64) within
``F32``; 0 means equal. Values, shapes and dtypes are compared, complex
ones as complex numbers.
"""

import numpy as np

from torch_parity import (
    assert_gathers_allowed, jax_mesh_values, mesh_app, run_table,
)

# float64 arithmetic in another order (XLA's FFT, pocketfft, cuFFT;
# partial sums of a ring)
ARITH = 1e-12
# float32 transforms of a thousand points: 5·2^-24·log2(N) is 3e-6
F32 = 1e-5


def _rs(seed):
    return np.random.RandomState(seed)


LENGTHS = (1000, 1003, 1009, 1024, 3, 5)
CPLX = {n: _rs(50 + i).randn(n) + 1j * _rs(60 + i).randn(n)
        for i, n in enumerate(LENGTHS)}
REAL = {n: _rs(70 + i).randn(n) for i, n in enumerate(LENGTHS)}
INTS = _rs(80).randint(-50, 50, size=1003)
X8 = _rs(81).randn(1000, 8)
X7 = _rs(82).randn(1003, 7)
C8 = X8 + 1j * _rs(83).randn(1000, 8)
V = _rs(84).randn(1003)
VN = V.copy()
VN[5::97] = np.nan
W = _rs(85).randn(301)
VC = V + 1j * _rs(86).randn(1003)
WC = W + 1j * _rs(87).randn(301)
Q = np.linspace(0.0, 1.0, 1001)
XN = X8.copy()
XN[3::50, 2] = np.nan
ROOTS = _rs(88).uniform(-0.9, 0.9, 1003)
_half = 0.2 * (_rs(89).uniform(-1, 1, 500)
               + 1j * _rs(90).uniform(-1, 1, 500))
PAIRS = np.concatenate([_half, _half.conj(), [0.25, -0.2, 0.1]])[
    _rs(91).permutation(1003)]


def _block(n):
    return (126,) if n >= 1000 else (1,)


def _a(app, x, bs):
    return app.array(x, block_shape=bs)


def signal_table():
    t, tols = [], {}

    def add(name, fn, tol=ARITH):
        t.append((name, fn))
        tols[name] = tol

    def vec(data):
        return lambda app, data=data: _a(app, data, _block(len(data)))

    # the six 1-D transforms at every length
    for n in LENGTHS:
        c, r = vec(CPLX[n]), vec(REAL[n])
        for fname, op in (("fft", c), ("ifft", c), ("rfft", r), ("irfft", c),
                          ("hfft", c), ("ihfft", r)):
            if fname in ("irfft", "hfft") and n < 2:
                continue
            add(f"fft_{fname}_{n}", lambda app, nps, f=fname, op=op: getattr(
                nps.fft, f)(op(app)))
    # numpy's n: shorter, longer (the odd lengths of irfft/hfft too)
    for n, ns in ((1003, (900, 1100, 1999)), (1009, (1008, 2017))):
        c, r = vec(CPLX[n]), vec(REAL[n])
        for fname, op in (("fft", c), ("ifft", c), ("rfft", r), ("irfft", c),
                          ("hfft", c), ("ihfft", r)):
            for m in ns:
                add(f"fft_{fname}_{n}_n{m}", lambda app, nps, f=fname, op=op,
                    m=m: getattr(nps.fft, f)(op(app), n=m))
    # the norms (Bluestein's and the four-step's scales)
    for n, forms in ((1009, "fft ifft irfft hfft rfft ihfft"),
                     (1000, "fft irfft")):
        c, r = vec(CPLX[n]), vec(REAL[n])
        for fname, op in (("fft", c), ("ifft", c), ("irfft", c),
                          ("hfft", c), ("rfft", r), ("ihfft", r)):
            if fname not in forms.split():
                continue
            for norm in ("ortho", "forward"):
                add(f"fft_{fname}_{n}_{norm}", lambda app, nps, f=fname, op=op,
                    norm=norm: getattr(nps.fft, f)(op(app), norm=norm))
    # integer input (the default float), float32 and complex64
    add("fft_fft_ints", lambda app, nps: nps.fft.fft(_a(app, INTS, (126,))))
    add("fft_rfft_ints", lambda app, nps: nps.fft.rfft(_a(app, INTS,
                                                          (126,))))
    for n in (1003, 1009):
        f32 = REAL[n].astype(np.float32)
        c64 = CPLX[n].astype(np.complex64)
        add(f"fft_fft_f32_{n}", lambda app, nps, x=f32: nps.fft.fft(
            _a(app, x, (126,))), F32)
        add(f"fft_rfft_f32_{n}", lambda app, nps, x=f32: nps.fft.rfft(
            _a(app, x, (126,))), F32)
        add(f"fft_irfft_c64_{n}", lambda app, nps, x=c64: nps.fft.irfft(
            _a(app, x, (126,))), F32)
        add(f"fft_ifft_c64_{n}", lambda app, nps, x=c64: nps.fft.ifft(
            _a(app, x, (126,))), F32)
    # the n-D transforms and the shifts
    for tag, x, bs in (("X8", X8, (250, 8)), ("X7", X7, (126, 7)),
                       ("X8cols", X8, (250, 4)), ("C8", C8, (250, 8))):
        A = (lambda app, x=x, bs=bs: _a(app, x, bs))
        for fname in ("fft2", "ifft2", "fftn", "ifftn", "rfft2", "irfft2",
                      "rfftn", "irfftn"):
            if tag == "C8" and fname.startswith("r"):
                continue
            add(f"nd_{fname}_{tag}", lambda app, nps, f=fname, A=A: getattr(
                nps.fft, f)(A(app)))
        add(f"nd_fft2_s_{tag}", lambda app, nps, A=A: nps.fft.fft2(
            A(app), s=(900, 6)))
        add(f"nd_irfftn_axes_{tag}", lambda app, nps, A=A: nps.fft.irfftn(
            A(app), axes=(0,)))
        add(f"nd_fftshift_{tag}", lambda app, nps, A=A: nps.fft.fftshift(
            A(app)), 0.0)
        add(f"nd_ifftshift_{tag}", lambda app, nps, A=A: nps.fft.ifftshift(
            A(app)), 0.0)
    add("nd_fftn_vector", lambda app, nps: nps.fft.fftn(_a(app, VC, (126,)),
                                                        s=(1100,)))
    add("nd_fftshift_vector", lambda app, nps: nps.fft.fftshift(
        _a(app, VC, (126,))), 0.0)
    add("nd_ifftshift_vector", lambda app, nps: nps.fft.ifftshift(
        _a(app, V, (126,))), 0.0)
    # two sharded operands: the shorter on a ring
    pairs = (("VW", V, (126,), W, (40,)), ("WV", W, (40,), V, (126,)),
             ("complex", VC, (126,), WC, (40,)))
    for op in ("convolve", "correlate"):
        for tag, x, xb, y, yb in pairs:
            for mode in ("full", "same", "valid"):
                add(f"conv_{op}_{tag}_{mode}", lambda app, nps, op=op, x=x,
                    xb=xb, y=y, yb=yb, mode=mode: getattr(nps, op)(
                        _a(app, x, xb), _a(app, y, yb), mode=mode))
    for tag, x, xb, y, yb in pairs:
        add(f"conv_polymul_{tag}", lambda app, nps, x=x, xb=xb, y=y, yb=yb:
            nps.polymul(_a(app, x, xb), _a(app, y, yb)))
    add("poly_real", lambda app, nps: nps.poly(_a(app, ROOTS, (126,))))
    add("poly_pairs", lambda app, nps: nps.poly(_a(app, PAIRS, (126,))))
    add("poly_complex", lambda app, nps: nps.poly(_a(
        app, PAIRS[:301] + 0.01j, (40,))))
    # quantiles at a sharded q
    for fname, scale in (("quantile", 1.0), ("nanquantile", 1.0),
                         ("percentile", 100.0), ("nanpercentile", 100.0)):
        for tag, x, bs, axis in (("V", V, (126,), None),
                                 ("VN", VN, (126,), None),
                                 ("XN", XN, (250, 8), 0),
                                 ("X7", X7, (126, 7), 0),
                                 ("X8cols", XN, (250, 4), 0)):
            add(f"q_{fname}_{tag}", lambda app, nps, f=fname, x=x, bs=bs,
                axis=axis, s=scale: getattr(nps, f)(
                    _a(app, x, bs), _a(app, Q * s, (126,)), axis=axis))
    return t, tols


TABLE, TOLS = signal_table()


def names():
    return [name for name, _ in TABLE]


def port_values(cluster):
    """In a mesh worker: the table on the port's mesh of ``cluster``."""
    import nums_tpu_torch.numpy as nps

    return run_table(mesh_app(cluster), nps, TABLE, placed=True)


# The entries held to the reference's mesh on one mesh alone: its poly of
# 1003 roots compiles 1003 convolutions, some 20-50 s on a CPU.
REFERENCE_ON = {"poly_real": (4, 1), "poly_pairs": (2, 2)}


def reference_names(cluster):
    """The entries held to the reference's mesh of ``cluster``: every
    entry on both meshes but those of ``REFERENCE_ON`` (each on its own
    mesh); every entry is held to the serial port on both."""
    return [n for n in names()
            if REFERENCE_ON.get(n, tuple(cluster)) == tuple(cluster)]


def reference_values(cluster):
    keep = set(reference_names(cluster))
    return jax_mesh_values(cluster, [e for e in TABLE if e[0] in keep])


def assert_close(got, ref, tol):
    """The same exception type, or arrays of equal shape and dtype whose
    values agree: NaN where ref has NaN, the rest within ``tol`` of
    max|ref| (complex numbers by the modulus of their difference)."""
    (g, g_exc), (r, r_exc) = got, ref
    if r_exc is not None:
        assert g_exc == r_exc, (g_exc, r_exc)
        return
    assert g_exc is None, g_exc
    g, r = np.asarray(g), np.asarray(r)
    assert g.shape == r.shape and g.dtype == r.dtype, (g.shape, g.dtype,
                                                        r.shape, r.dtype)
    assert np.array_equal(np.isnan(g), np.isnan(r)), "NaN positions"
    fin = np.isfinite(r)
    if tol == 0:
        assert np.array_equal(g, r, equal_nan=r.dtype.kind in "fc")
    elif fin.any():
        gf = g[fin].astype(np.complex128)
        rf = r[fin].astype(np.complex128)
        scale = max(float(np.max(np.abs(rf))), 1e-300)
        err = float(np.max(np.abs(gf - rf)))
        assert err <= tol * scale, (err / scale, tol)


def check(port_mesh, reference_mesh, port_serial, name):
    values, placed = port_mesh
    got, tol = values[name], TOLS[name]
    if name in reference_mesh:
        assert_close(got, reference_mesh[name], tol)
    assert_close(got, port_serial[name], tol)
    where, gathered = placed[name]
    assert where, "a result is not laid out as app.array lays it"
    assert_gathers_allowed(name, gathered)
