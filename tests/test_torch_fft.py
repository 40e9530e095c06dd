"""``nums_tpu_torch.numpy.fft`` against ``nums_tpu.numpy.fft``: all 18
names, with numpy's ``n``/``s``/``axes``/``norm`` semantics, and the
dtypes of the card's mode (jax with x64 off).

Same numpy inputs through both packages on the CPU (x64 on); shape and
dtype equal; float64 and complex128 results within 1e-12 of max|ref|
(torch's pocketfft against XLA's FFT), float32 and complex64 within
1e-5 of max|ref|. The card-mode test runs the port with float32 as its
default float (the default on a CUDA device) against ``jnp`` under
``jax.enable_x64(False)``: the dtypes equal, the values within 2e-6
relative plus 1e-6 of max|ref|.
"""

import numpy as np
import pytest

from torch_parity import (  # noqa: F401
    apps, assert_values, facade_parity, jax_app, torch_app,
)

import nums_tpu.numpy as jnps

RS = np.random.RandomState(5)
V = RS.randn(16)
ODD = RS.randn(15)
M = RS.randn(6, 8)
M32 = RS.randn(8, 10).astype(np.float32)
T3 = RS.randn(4, 5, 6)
CV = RS.randn(12) + 1j * RS.randn(12)
CM = RS.randn(6, 8) + 1j * RS.randn(6, 8)
INTS = np.arange(10)


def _a(nps, x):
    return nps.array(x)


CASES = {
    "fft": [lambda f, n: [f.fft(_a(n, V)), f.fft(_a(n, V), n=10),
                          f.fft(_a(n, V), n=20, norm="ortho")],
            lambda f, n: [f.fft(_a(n, M), axis=0), f.fft(_a(n, CM)),
                          f.fft(_a(n, M32), norm="forward")],
            lambda f, n: f.fft(_a(n, INTS))],
    "ifft": [lambda f, n: [f.ifft(_a(n, CV)), f.ifft(_a(n, CM), axis=0,
                                                      norm="ortho"),
                           f.ifft(_a(n, V), n=7)]],
    "rfft": [lambda f, n: [f.rfft(_a(n, V)), f.rfft(_a(n, ODD)),
                           f.rfft(_a(n, M), axis=0, n=5),
                           f.rfft(_a(n, M32), norm="forward")]],
    "irfft": [lambda f, n: [f.irfft(_a(n, np.fft.rfft(V))),
                            f.irfft(_a(n, np.fft.rfft(ODD)), n=15),
                            f.irfft(_a(n, CM), axis=0, norm="ortho")]],
    "hfft": [lambda f, n: [f.hfft(_a(n, CV)), f.hfft(_a(n, CV), n=9),
                           f.hfft(_a(n, CM), axis=0, norm="ortho")]],
    "ihfft": [lambda f, n: [f.ihfft(_a(n, V)), f.ihfft(_a(n, ODD), n=10),
                            f.ihfft(_a(n, M), axis=0)]],
    "fftn": [lambda f, n: [f.fftn(_a(n, T3)), f.fftn(_a(n, T3), axes=(0, 2)),
                           f.fftn(_a(n, M), s=(4, 10), norm="ortho")]],
    "ifftn": [lambda f, n: [f.ifftn(_a(n, CM)), f.ifftn(_a(n, T3),
                                                         s=(3, 3), axes=(1, 2))]],
    "rfftn": [lambda f, n: [f.rfftn(_a(n, T3)), f.rfftn(_a(n, M), s=(6, 7)),
                            f.rfftn(_a(n, T3), axes=(0,))]],
    "irfftn": [lambda f, n: [f.irfftn(_a(n, np.fft.rfftn(T3)), s=T3.shape),
                             f.irfftn(_a(n, CM)),
                             f.irfftn(_a(n, CM), s=(6, 9), norm="forward")]],
    "fft2": [lambda f, n: [f.fft2(_a(n, M)), f.fft2(_a(n, T3), axes=(0, 1)),
                           f.fft2(_a(n, M32), s=(4, 4))]],
    "ifft2": [lambda f, n: [f.ifft2(_a(n, CM)), f.ifft2(_a(n, T3),
                                                         norm="ortho")]],
    "rfft2": [lambda f, n: [f.rfft2(_a(n, M)), f.rfft2(_a(n, T3), s=(4, 4))]],
    "irfft2": [lambda f, n: [f.irfft2(_a(n, CM)), f.irfft2(
        _a(n, np.fft.rfft2(M)), s=M.shape)]],
    "fftshift": [lambda f, n: [f.fftshift(_a(n, V)), f.fftshift(_a(n, M)),
                               f.fftshift(_a(n, INTS[:9]))]],
    "ifftshift": [lambda f, n: [f.ifftshift(_a(n, ODD)),
                                f.ifftshift(_a(n, T3))]],
    "fftfreq": [lambda f, n: [f.fftfreq(8), f.fftfreq(9, d=0.1),
                              f.fftfreq(1)]],
    "rfftfreq": [lambda f, n: [f.rfftfreq(8), f.rfftfreq(9, d=2.5)]],
}

PARAMS = [(name, i) for name in sorted(CASES)
          for i in range(len(CASES[name]))]


def test_every_name_has_a_case():
    ref = sorted(n for n in vars(jnps.fft) if not n.startswith("_")
                 and callable(getattr(jnps.fft, n))
                 and getattr(jnps.fft, n).__module__ == jnps.fft.__name__)
    assert sorted(CASES) == ref


@pytest.mark.parametrize("name,i", PARAMS)
def test_fft(apps, name, i):
    fn = CASES[name][i]
    facade_parity(apps, lambda nps, app: fn(nps.fft, nps), "reduction")


@pytest.mark.parametrize("block_shape", [(4, 3), (5, 8)])
def test_ragged_blocks(apps, block_shape):
    """Arrays split into blocks that do not divide their shape."""
    def fn(nps, app):
        x = app.array(M, block_shape=block_shape)
        return [nps.fft.rfft(x, axis=0), nps.fft.fft2(x),
                nps.fft.fftshift(x)]

    facade_parity(apps, fn, "reduction")


@pytest.fixture()
def float32_app(monkeypatch):
    """The port's CPU application with float32 as its default float, as
    a CUDA device has it."""
    from nums_tpu_torch.core import application_manager, settings

    monkeypatch.setattr(settings, "default_float_for",
                        lambda device: np.dtype(np.float32))
    application_manager.destroy()
    app = application_manager.create(device="cpu")
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


def test_card_dtypes(float32_app):
    """The port in the card's mode gives jnp's x64-off dtypes: fft of an
    integer or float32 array complex64, the windows and frequencies
    float32, the index builders int32."""
    import jax
    import jax.numpy as jnp
    import nums_tpu_torch.numpy as tnps

    x32 = V.astype(np.float32)
    cases = [
        (lambda: tnps.fft.fft(float32_app.array(INTS)),
         lambda: jnp.fft.fft(jnp.asarray(INTS))),
        (lambda: tnps.fft.rfft(float32_app.array(x32)),
         lambda: jnp.fft.rfft(jnp.asarray(x32))),
        (lambda: tnps.fft.irfft(tnps.fft.rfft(float32_app.array(x32))),
         lambda: jnp.fft.irfft(jnp.fft.rfft(jnp.asarray(x32)))),
        (lambda: tnps.fft.fftfreq(9, 0.1), lambda: jnp.fft.fftfreq(9, 0.1)),
        (lambda: tnps.fft.rfftfreq(8), lambda: jnp.fft.rfftfreq(8)),
        (lambda: tnps.hamming(9), lambda: jnp.hamming(9)),
        (lambda: tnps.kaiser(7, 2.5), lambda: jnp.kaiser(7, 2.5)),
        (lambda: tnps.tril_indices(4), lambda: jnp.tril_indices(4)),
        (lambda: tnps.diag_indices(3), lambda: jnp.diag_indices(3)),
        (lambda: tnps.indices((2, 3)), lambda: jnp.indices((2, 3))),
    ]
    with jax.enable_x64(False):
        for port, ref in cases:
            got, want = port(), ref()
            got = [g.get() for g in got] if isinstance(got, tuple) \
                else got.get()
            want = [np.asarray(w) for w in want] if isinstance(want, tuple) \
                else np.asarray(want)
            assert_values(got, want, "elementwise")
