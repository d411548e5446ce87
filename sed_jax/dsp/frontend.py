"""Log-mel DSP frontend as two matmuls.

The reference computes the STFT as two ``nn.Conv1d`` layers whose weights
are windowed DFT rows (``pytorch/stft.py:157-247``), followed by a power
spectrogram (``pytorch/stft.py:636-670``) and a mel matmul + log
(``pytorch/stft.py:673-734``).  Here:

    frames (B, T, n_fft) @ W (n_fft, 2*bins)   -> [re | im]   (one matmul)
    re^2 + im^2                                 -> power spec
    spec (B, T, bins) @ melW (bins, n_mels)     -> mel        (one matmul)
    10*log10(clamp(mel, amin))                  -> log-mel

Framing uses a hop-block restack (pure slicing, no gather): all three audio
qualities share n_fft/hop = 3.2, so every frame spans ceil(3.2) = 4 hop
blocks.

Numerics match ``librosa.stft`` semantics bit-closely: center reflect
padding, periodic Hann, power=2.0, amin=1e-10, ref=1.0, top_db=None.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax.config import AudioConfig
from sed_jax.dsp import filters


def _reflect_pad_last(x: jnp.ndarray, pad: int) -> jnp.ndarray:
    """Reflect-pad the last axis by ``pad`` on both sides (librosa 'reflect')."""
    npad = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
    return jnp.pad(x, npad, mode='reflect')


def frame_signal(x: jnp.ndarray, frame_length: int, hop_length: int,
                 center: bool = True, pad_mode: str = 'reflect') -> jnp.ndarray:
    """Slice a signal into overlapped frames.

    Args:
      x: (..., samples)
      frame_length, hop_length: ints with hop_length <= frame_length.
      center: reflect-pad frame_length//2 on both sides first, matching
        ``pytorch/stft.py:238`` / librosa center=True.

    Returns:
      (..., n_frames, frame_length) where, with center=True and
      hop | samples, n_frames = samples // hop + 1.
    """
    if center:
        if pad_mode == 'reflect':
            x = _reflect_pad_last(x, frame_length // 2)
        elif pad_mode == 'constant':
            npad = [(0, 0)] * (x.ndim - 1) + [(frame_length // 2,) * 2]
            x = jnp.pad(x, npad)
        else:
            raise ValueError(f'unsupported pad_mode: {pad_mode}')

    length = x.shape[-1]
    n_frames = 1 + (length - frame_length) // hop_length
    nb = -(-frame_length // hop_length)  # ceil: hop blocks per frame

    # Zero-pad so every frame's hop blocks exist, then restack shifted
    # block views.  Pure slicing — no gather, XLA lowers this to copies.
    padded_len = (n_frames - 1 + nb) * hop_length
    npad = [(0, 0)] * (x.ndim - 1) + [(0, padded_len - length)]
    x = jnp.pad(x, npad)
    blocks = x.reshape(x.shape[:-1] + (-1, hop_length))
    views = [
        jax.lax.slice_in_dim(blocks, j, j + n_frames, axis=x.ndim - 1)
        for j in range(nb)
    ]
    wide = jnp.concatenate(views, axis=-1)        # (..., n_frames, nb*hop)
    return wide[..., :frame_length]


# Precision of the frontend's two float32 matmuls.  On the GPU the
# default lets XLA run them in TF32 (~3 decimal digits in the inputs),
# and the log10 that follows turns that into dB errors on quiet bins;
# HIGHEST keeps full float32.  Chosen from the on-card error and time
# of both settings (PERF.md, "Frontend precision").
PRECISION = jax.lax.Precision.HIGHEST


def stft(x: jnp.ndarray, stft_mat: jnp.ndarray, hop_length: int,
         center: bool = True, pad_mode: str = 'reflect',
         precision=PRECISION):
    """STFT via one matmul.  Returns (real, imag), each (..., T, bins)."""
    n_fft = stft_mat.shape[0]
    frames = frame_signal(x, n_fft, hop_length, center, pad_mode)
    re_im = jnp.matmul(frames, stft_mat.astype(frames.dtype),
                       precision=precision)
    n_bins = n_fft // 2 + 1
    return re_im[..., :n_bins], re_im[..., n_bins:]


def spectrogram(x: jnp.ndarray, stft_mat: jnp.ndarray, hop_length: int,
                power: float = 2.0, center: bool = True,
                pad_mode: str = 'reflect',
                precision=PRECISION) -> jnp.ndarray:
    """Power spectrogram |STFT|^power, shape (..., T, n_fft // 2 + 1)."""
    re, im = stft(x, stft_mat, hop_length, center, pad_mode, precision)
    spec = re * re + im * im
    if power != 2.0:
        spec = spec ** (power / 2.0)
    return spec


def power_to_db(x: jnp.ndarray, ref: float = 1.0, amin: float = 1e-10,
                top_db: float | None = None) -> jnp.ndarray:
    """librosa.power_to_db semantics (``pytorch/stft.py:721-734``)."""
    log_spec = 10.0 * jnp.log10(jnp.maximum(x, amin))
    log_spec = log_spec - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        if top_db < 0:
            raise ValueError('top_db must be non-negative')
        log_spec = jnp.maximum(log_spec, jnp.max(log_spec) - top_db)
    return log_spec


def logmel(wav: jnp.ndarray, cfg: AudioConfig,
           precision=PRECISION) -> jnp.ndarray:
    """(B, samples) waveform -> (B, T, mel_bins) log-mel spectrogram,
    T = samples // hop + 1 (center padding)."""
    stft_mat, mel_mat = filters.frontend_arrays(cfg)
    spec = spectrogram(wav, jnp.asarray(stft_mat), cfg.hop_size,
                       center=cfg.center, pad_mode=cfg.pad_mode,
                       precision=precision)
    mel = jnp.matmul(spec, jnp.asarray(mel_mat), precision=precision)
    return power_to_db(mel, ref=cfg.ref, amin=cfg.amin, top_db=cfg.top_db)


def logmel_reference(wav: np.ndarray, cfg: AudioConfig):
    """Float64 numpy log-mel from the same matrices, the reference the
    device frontend is checked against.  Returns (mel power, log-mel
    dB), each (B, T, mel_bins); supports center reflect padding and
    top_db=None, which every AudioConfig uses."""
    stft_mat, mel_mat = (m.astype(np.float64)
                         for m in filters.frontend_arrays(cfg))
    n_fft, hop = cfg.window_size, cfg.hop_size
    x = np.pad(np.asarray(wav, np.float64),
               ((0, 0), (n_fft // 2, n_fft // 2)), mode='reflect')
    n_frames = 1 + (x.shape[1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    re_im = x[:, idx] @ stft_mat
    bins = n_fft // 2 + 1
    mel = (re_im[..., :bins] ** 2 + re_im[..., bins:] ** 2) @ mel_mat
    db = 10.0 * np.log10(np.maximum(mel, cfg.amin))
    return mel, db - 10.0 * np.log10(max(cfg.amin, cfg.ref))


class LogmelFrontend:
    """Waveform -> log-mel spectrogram, precomputed matrices.

    Replaces the reference's ``Spectrogram`` + ``LogmelFilterBank`` module
    pair embedded in every model (e.g. ``pytorch/models.py:580-588``).

    Call: ``(B, samples) -> (B, T, mel_bins)`` with T = samples//hop + 1,
    the same computation as ``logmel``.
    """

    def __init__(self, cfg: AudioConfig):
        self.cfg = cfg
        stft_mat, mel_mat = filters.frontend_arrays(cfg)
        self.stft_mat = jnp.asarray(stft_mat)
        self.mel_mat = jnp.asarray(mel_mat)

    def spectrogram(self, wav: jnp.ndarray) -> jnp.ndarray:
        return spectrogram(wav.astype(jnp.float32), self.stft_mat,
                           self.cfg.hop_size, power=2.0,
                           center=self.cfg.center, pad_mode=self.cfg.pad_mode)

    def __call__(self, wav: jnp.ndarray) -> jnp.ndarray:
        return logmel(wav.astype(jnp.float32), self.cfg)
