"""Gammatone frontend tests: ERB math, FFT gold, jnp/numpy agreement."""

import numpy as np
import jax.numpy as jnp
import pytest

from sed_jax.config import AUDIO_8K, AUDIO_16K, AUDIO_32K
from sed_jax.dsp import gammatone as gt


def test_erb_space_endpoints():
    f = gt.erb_space(50.0, 8000.0, 64)
    assert np.isclose(f[-1], 50.0)          # fraction 1 -> low freq
    assert f[0] < 8000.0 and f[0] > f[1]    # descending
    assert np.all(np.diff(f) < 0)


def test_erb_filter_gain_normalization():
    """At the centre frequency each cascaded filter should have ~unit
    gain after the gain normalization."""
    fs = 16000
    cfs = gt.centre_freqs(fs, 32, 50.0)
    w, _ = gt.fft_weights(1024, fs, 32, 1, 50.0, fs / 2, 513)
    freqs = np.linspace(0, fs / 2, 513)
    for i in [0, 10, 20, 31]:
        peak_freq = freqs[np.argmax(w[i])]
        cf = gt.erb_space(50.0, fs / 2, 32)[::-1][i]
        assert abs(peak_freq - cf) < max(50.0, 0.1 * cf)


def test_specgram_matches_fft_gold():
    rng = np.random.RandomState(0)
    fs = 16000
    x = rng.randn(fs).astype(np.float64)
    wt, ht = 512 / fs, 160 / fs
    got = gt.fft_gtgram(x, fs, wt, ht, 64, 25.0)

    # independent gold: loop-FFT specgram then weight matmul
    nfft, nwin, nhop = gt._fft_gtgram_geometry(fs, wt, ht)
    win = gt.specgram_window(nfft, nwin)
    frames = []
    b = 0
    while b < len(x) - nfft:
        frames.append(np.fft.fft(win * x[b:b + nfft])[:nfft // 2 + 1])
        b += nhop
    mag = np.abs(np.stack(frames, axis=1))
    weights, _ = gt.fft_weights(nfft, fs, 64, 1, 25.0, fs / 2,
                                nfft / 2 + 1)
    want = weights @ mag / nfft
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)


def test_fft_gtgram_batch_matches_numpy():
    rng = np.random.RandomState(1)
    fs = 16000
    x = rng.uniform(-0.5, 0.5, (3, fs * 2)).astype(np.float32)
    wt, ht = 512 / fs, 160 / fs
    batch = np.asarray(gt.fft_gtgram_batch(jnp.asarray(x), fs, wt, ht,
                                           64, 25.0))
    for i in range(3):
        single = gt.fft_gtgram(x[i].astype(np.float64), fs, wt, ht, 64,
                               25.0)
        np.testing.assert_allclose(batch[i], single, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                         ids=['8k', '16k', '32k'])
def test_packed_gamma_shape_is_994(cfg):
    assert gt.gtgram_frames(cfg, cfg.audio_samples) == 994
    x = np.zeros(cfg.audio_samples)
    feat = gt.fft_gtgram_db(x, cfg)
    assert feat.shape == (64, 994)


def test_time_domain_gtgram_runs():
    fs = 8000
    t = np.arange(fs) / fs
    x = np.sin(2 * np.pi * 1000 * t)
    y = gt.gtgram(x, fs, 0.04, 0.02, 16, 50.0)
    assert y.shape[0] == 16 and y.shape[1] > 0
    assert np.all(y >= 0)
    # energy concentrated near the 1 kHz channel
    cfs = gt.centre_freqs(fs, 16, 50.0)[::-1]
    peak_cf = cfs[np.argmax(y.mean(axis=1))]
    assert 600 < peak_cf < 1800


def test_gamma_model_forward():
    import jax
    from sed_jax.models.registry import get_model
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K,
                      feature_type='gamma')
    feat = jnp.zeros((2, 64, 994), jnp.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, feat,
                           train=False)
    out = model.apply(variables, feat, train=False)
    # 994 frames -> pooled 124 -> x8 = 992 -> padded to roundup 1000
    assert out['framewise_output'].shape == (2, 1000, 25)


def test_plot_cli_renders_gammatonegram_png(tmp_path):
    """The plot CLI (parity with the reference's runnable ERB-axis
    renderer, ``utils/gammatone/plot.py:148``) must render a wav to an
    image file headlessly, honoring --duration; --accurate switches to
    the full filterbank."""
    import matplotlib
    matplotlib.use('Agg')
    from sed_jax.data import audio_io
    from sed_jax.dsp import plot as plot_cli

    sr = 16000
    t = np.arange(sr * 2) / sr
    wave = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    wav = tmp_path / 'tone.wav'
    audio_io.save_wav(str(wav), wave, sr)

    out = tmp_path / 'gtg.png'
    plot_cli.main([str(wav), '-d', '1', '-o', str(out)])
    assert out.exists() and out.stat().st_size > 1000
    with open(out, 'rb') as f:
        assert f.read(8) == b'\x89PNG\r\n\x1a\n'

    out2 = tmp_path / 'gtg_acc.png'
    plot_cli.main([str(wav), '-d', '1', '-a', '-o', str(out2)])
    assert out2.exists() and out2.stat().st_size > 1000
