"""CQT frontend and silence-trim tests."""

import numpy as np
import jax.numpy as jnp

from sed_jax.config import AUDIO_16K
from sed_jax.data.audio_io import trim_silent
from sed_jax.dsp.cqt import CQTFrontend, cqt_filterbank, cqt_frequencies


def test_cqt_frequencies_log_spaced():
    f = cqt_frequencies(24, 55.0, 12)
    np.testing.assert_allclose(f[12] / f[0], 2.0, rtol=1e-9)  # one octave
    assert np.all(np.diff(np.log(f)) > 0)


def test_cqt_filterbank_peaks_at_centers():
    sr, n_fft = 16000, 512
    w = cqt_filterbank(sr, n_fft, n_bins=48, fmin=100.0)
    assert w.shape == (257, 48)
    freqs = np.linspace(0, sr / 2, 257)
    centers = cqt_frequencies(48, 100.0)
    for k in (5, 20, 40):
        peak = freqs[np.argmax(w[:, k])]
        assert abs(peak - centers[k]) < max(40.0, 0.06 * centers[k])


def test_cqt_frontend_tone_peak():
    cfg = AUDIO_16K
    t = np.arange(cfg.sample_rate) / cfg.sample_rate
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    fe = CQTFrontend(cfg, n_bins=60, fmin=55.0)
    out = np.asarray(fe(jnp.asarray(x)[None]))[0]
    assert out.shape[0] == cfg.frames_per_second + 1
    centers = cqt_frequencies(60, 55.0)
    peak = centers[out.mean(axis=0).argmax()]
    assert 350 < peak < 550


def test_trim_silent():
    sr = 16000
    x = np.zeros(sr * 3, np.float32)
    x[sr:2 * sr] = np.sin(2 * np.pi * 440 * np.arange(sr) / sr) * 0.5
    intervals, audio = trim_silent(x, sr, top_db=18)
    assert len(intervals) == 1
    s, e = intervals[0]
    assert abs(s - sr) < 4096 and abs(e - 2 * sr) < 4096
    assert len(audio) == e - s
