"""Auxiliary DSP transforms: DFT family, ISTFT, magphase, enframe, scalar.

Completes the reference DSP API surface (``pytorch/stft.py``):

* ``dft/idft/rdft/irdft`` — matmul DFTs with None|'ortho' norm
  (``stft.py:34-154``; including the reference's idft quirk of scaling
  only the real part under norm=None, ``stft.py:92-96`` — fixed here to
  scale both, see ``idft``'s docstring);
* ``magphase`` (``stft.py:250-266``);
* ``istft`` — inverse STFT via windowed overlap-add with window-sum
  normalization, librosa semantics (``stft.py:269-633``);
* ``enframe`` (``stft.py:868-907``), ``scalar_normalize``
  (``stft.py:910-922``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax.dsp import filters
from sed_jax.dsp.frontend import frame_signal


def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    angle = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(angle), np.sin(angle)


def dft(x_real: jnp.ndarray, x_imag: jnp.ndarray, norm: Optional[str] = None):
    """Complex DFT along the last axis via matmul."""
    n = x_real.shape[-1]
    wr, wi = _dft_mats(n)
    wr, wi = jnp.asarray(wr, x_real.dtype), jnp.asarray(wi, x_real.dtype)
    z_real = x_real @ wr - x_imag @ wi
    z_imag = x_imag @ wr + x_real @ wi
    if norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def idft(x_real: jnp.ndarray, x_imag: jnp.ndarray,
         norm: Optional[str] = None):
    """Inverse DFT.  NB: the reference divides only the real part by n
    under norm=None (``stft.py:92-96``, a bug); both parts are scaled
    here so that idft(dft(x)) == x."""
    n = x_real.shape[-1]
    wr, wi = _dft_mats(n)
    wr, wi = jnp.asarray(wr, x_real.dtype), -jnp.asarray(wi, x_real.dtype)
    z_real = x_real @ wr - x_imag @ wi
    z_imag = x_imag @ wr + x_real @ wi
    if norm is None:
        z_real, z_imag = z_real / n, z_imag / n
    elif norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def rdft(x_real: jnp.ndarray, norm: Optional[str] = None):
    """Real-input DFT: returns the first n//2+1 bins."""
    n = x_real.shape[-1]
    n_rfft = n // 2 + 1
    wr, wi = _dft_mats(n)
    z_real = x_real @ jnp.asarray(wr[:, :n_rfft], x_real.dtype)
    z_imag = x_real @ jnp.asarray(wi[:, :n_rfft], x_real.dtype)
    if norm == 'ortho':
        z_real, z_imag = z_real / np.sqrt(n), z_imag / np.sqrt(n)
    return z_real, z_imag


def irdft(x_real: jnp.ndarray, x_imag: jnp.ndarray,
          norm: Optional[str] = None):
    """Inverse of rdft: reconstructs the full spectrum by conjugate
    symmetry then inverse-transforms (``stft.py:120-154``)."""
    n_rfft = x_real.shape[-1]
    n = (n_rfft - 1) * 2
    full_real = jnp.concatenate(
        [x_real, x_real[..., -2:0:-1]], axis=-1)
    full_imag = jnp.concatenate(
        [x_imag, -x_imag[..., -2:0:-1]], axis=-1)
    z_real, _ = idft(full_real, full_imag, norm)
    return z_real


def magphase(real: jnp.ndarray, imag: jnp.ndarray):
    """(mag, cos, sin) from re/im (``stft.py:250-266``)."""
    mag = jnp.sqrt(real ** 2 + imag ** 2)
    denom = jnp.maximum(mag, 1e-10)
    return mag, real / denom, imag / denom


def istft(real: jnp.ndarray, imag: jnp.ndarray, n_fft: int, hop_length: int,
          length: Optional[int] = None, window: str = 'hann',
          center: bool = True) -> jnp.ndarray:
    """Inverse STFT via windowed overlap-add (librosa.istft semantics).

    Args:
      real, imag: (..., T, n_fft // 2 + 1) one-sided STFT.
    Returns:
      (..., samples) reconstructed signal.
    """
    n_bins = n_fft // 2 + 1
    assert real.shape[-1] == n_bins
    t = real.shape[-2]

    # inverse rFFT per frame as a matmul: frames = [re|im] @ S
    k = np.arange(n_fft)
    b = np.arange(n_bins)
    angle = 2.0 * np.pi * np.outer(b, k) / n_fft
    # conjugate-symmetric expansion weights: bins 1..n/2-1 count twice
    scale = np.ones(n_bins)
    scale[1:-1] = 2.0
    s_real = (np.cos(angle) * scale[:, None]) / n_fft
    s_imag = (-np.sin(angle) * scale[:, None]) / n_fft
    frames = (real @ jnp.asarray(s_real, real.dtype)
              + imag @ jnp.asarray(s_imag, real.dtype))

    win = filters.pad_center(filters.periodic_hann(n_fft), n_fft)
    win = jnp.asarray(win, real.dtype)
    frames = frames * win

    out_len = n_fft + hop_length * (t - 1)
    batch_shape = frames.shape[:-2]
    flat = frames.reshape((-1, t, n_fft))

    idx = (np.arange(t)[:, None] * hop_length
           + np.arange(n_fft)[None, :]).reshape(-1)
    idx = jnp.asarray(idx)

    def ola(fr):
        return jnp.zeros(out_len, fr.dtype).at[idx].add(fr.reshape(-1))

    sig = jax.vmap(ola)(flat)
    win_sq = np.zeros(out_len)
    w2 = np.asarray(win) ** 2
    for i in range(t):
        win_sq[i * hop_length:i * hop_length + n_fft] += w2
    sig = sig / jnp.asarray(np.maximum(win_sq, 1e-11), sig.dtype)

    if center:
        sig = sig[:, n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        sig = sig[:, :length]
        if sig.shape[-1] < length:
            sig = jnp.pad(sig, ((0, 0), (0, length - sig.shape[-1])))
    return sig.reshape(batch_shape + sig.shape[-1:])


def enframe(x: jnp.ndarray, frame_length: int = 2048,
            hop_length: int = 512) -> jnp.ndarray:
    """librosa.util.frame equivalent: (B, samples) ->
    (B, frame_length, frames) (``stft.py:868-907``)."""
    frames = frame_signal(x, frame_length, hop_length, center=False)
    return frames.swapaxes(-1, -2)


def scalar_normalize(x: jnp.ndarray, mean, std) -> jnp.ndarray:
    """(x - mean) / std (``stft.py:910-922``)."""
    return (x - jnp.asarray(mean, x.dtype)) / jnp.asarray(std, x.dtype)
