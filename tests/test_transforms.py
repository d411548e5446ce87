"""DFT family / ISTFT / enframe tests vs numpy FFT gold."""

import numpy as np
import jax.numpy as jnp

from sed_jax.config import AUDIO_16K
from sed_jax.dsp import transforms as tr
from sed_jax.dsp.frontend import stft
from sed_jax.dsp.filters import stft_matrices


def test_dft_matches_numpy_fft():
    rng = np.random.RandomState(0)
    n = 64
    xr = rng.randn(n).astype(np.float32)
    xi = rng.randn(n).astype(np.float32)
    zr, zi = tr.dft(jnp.asarray(xr), jnp.asarray(xi))
    want = np.fft.fft(xr + 1j * xi)
    np.testing.assert_allclose(np.asarray(zr), want.real, atol=1e-3)
    np.testing.assert_allclose(np.asarray(zi), want.imag, atol=1e-3)


def test_idft_roundtrip():
    rng = np.random.RandomState(1)
    n = 32
    xr, xi = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    for norm in (None, 'ortho'):
        zr, zi = tr.dft(jnp.asarray(xr), jnp.asarray(xi), norm)
        br, bi = tr.idft(zr, zi, norm)
        np.testing.assert_allclose(np.asarray(br), xr, atol=1e-4)
        np.testing.assert_allclose(np.asarray(bi), xi, atol=1e-4)


def test_rdft_irdft_roundtrip():
    rng = np.random.RandomState(2)
    n = 64
    x = rng.randn(n).astype(np.float32)
    zr, zi = tr.rdft(jnp.asarray(x))
    want = np.fft.rfft(x)
    np.testing.assert_allclose(np.asarray(zr), want.real, atol=1e-3)
    np.testing.assert_allclose(np.asarray(zi), want.imag, atol=1e-3)
    back = tr.irdft(zr, zi)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-4)


def test_magphase():
    mag, cos, sin = tr.magphase(jnp.asarray([3.0]), jnp.asarray([4.0]))
    assert np.isclose(float(mag[0]), 5.0)
    assert np.isclose(float(cos[0]), 0.6)
    assert np.isclose(float(sin[0]), 0.8)


def test_istft_reconstructs_signal():
    cfg = AUDIO_16K
    rng = np.random.RandomState(3)
    x = rng.uniform(-0.5, 0.5, (2, cfg.sample_rate)).astype(np.float32)
    mat = jnp.asarray(stft_matrices(cfg.window_size))
    re, im = stft(jnp.asarray(x), mat, cfg.hop_size)
    back = tr.istft(re, im, cfg.window_size, cfg.hop_size,
                    length=x.shape[1])
    np.testing.assert_allclose(np.asarray(back), x, atol=2e-3)


def test_enframe_matches_manual():
    x = jnp.asarray(np.arange(64, dtype=np.float32))[None]
    out = np.asarray(tr.enframe(x, 16, 8))
    assert out.shape == (1, 16, 7)
    np.testing.assert_array_equal(out[0, :, 0], np.arange(16))
    np.testing.assert_array_equal(out[0, :, 2], np.arange(16, 32))


def test_scalar_normalize():
    x = jnp.asarray([[1.0, 2.0], [3.0, 4.0]])
    out = np.asarray(tr.scalar_normalize(x, [1.0, 2.0], [2.0, 2.0]))
    np.testing.assert_allclose(out, [[0, 0], [1, 1]])
