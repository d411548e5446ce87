"""Parity tests for the DSP frontend.

This is the rebuilt, automated version of the reference's de-facto test
suite (``pytorch/stft.py:925-1244`` ``debug()``), which compares the
conv-based STFT/logmel against numpy/librosa gold.  Here the gold is an
independent numpy implementation built directly on ``np.fft.rfft``.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from sed_jax.config import AUDIO_8K, AUDIO_16K, AUDIO_32K
from sed_jax.dsp import filters, frontend


def gold_stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Independent STFT gold: reflect pad, periodic hann, rfft."""
    w = filters.periodic_hann(n_fft)
    x = np.pad(x, n_fft // 2, mode='reflect')
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.stack([x[i * hop:i * hop + n_fft] for i in range(n_frames)])
    return np.fft.rfft(frames * w, axis=-1)


def gold_logmel(x, cfg):
    S = np.abs(gold_stft(x, cfg.window_size, cfg.hop_size)) ** 2
    mel = S @ filters.mel_filterbank(cfg.sample_rate, cfg.window_size,
                                     cfg.mel_bins, cfg.fmin, cfg.fmax)
    return 10.0 * np.log10(np.maximum(mel, 1e-10))


@pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                         ids=['8k', '16k', '32k'])
def test_spectrogram_matches_fft_gold(cfg):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, cfg.sample_rate).astype(np.float32)  # 1 s
    fe = frontend.LogmelFrontend(cfg)
    spec = np.asarray(fe.spectrogram(jnp.asarray(x)[None]))[0]
    gold = np.abs(gold_stft(x.astype(np.float64), cfg.window_size,
                            cfg.hop_size)) ** 2
    assert spec.shape == gold.shape
    assert spec.shape[0] == cfg.frames_per_second + 1  # 100 fps contract
    np.testing.assert_allclose(spec, gold, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                         ids=['8k', '16k', '32k'])
def test_logmel_matches_fft_gold(cfg):
    rng = np.random.RandomState(1)
    x = rng.uniform(-0.5, 0.5, cfg.sample_rate * 2).astype(np.float32)
    fe = frontend.LogmelFrontend(cfg)
    out = np.asarray(fe(jnp.asarray(x)[None]))[0]
    gold = gold_logmel(x.astype(np.float64), cfg)
    assert out.shape == (2 * cfg.frames_per_second + 1, cfg.mel_bins)
    np.testing.assert_allclose(out, gold, rtol=1e-3, atol=2e-3)


def test_clip_frame_count_contract():
    """All qualities give 1001 frames per 10 s clip (SURVEY §1)."""
    for cfg in (AUDIO_8K, AUDIO_16K, AUDIO_32K):
        x = jnp.zeros((1, cfg.audio_samples))
        out = frontend.LogmelFrontend(cfg)(x)
        assert out.shape == (1, 1001, 64)
        assert cfg.clip_frames == 1001


def test_frame_signal_no_center():
    x = jnp.arange(32, dtype=jnp.float32)
    f = frontend.frame_signal(x, 8, 4, center=False)
    assert f.shape == (7, 8)
    np.testing.assert_array_equal(np.asarray(f[0]), np.arange(8))
    np.testing.assert_array_equal(np.asarray(f[3]), np.arange(12, 20))


def test_mel_filterbank_properties():
    melW = filters.mel_filterbank(32000, 1024, 64, 50, 14000)
    assert melW.shape == (513, 64)
    assert np.all(melW >= 0)
    # every filter has support
    assert np.all(melW.sum(axis=0) > 0)
    # Slaney norm: filter area ~ 2/bandwidth -> peak * bandwidth/2 ~ const-ish.
    mel_f = filters.mel_frequencies(66, 50, 14000)
    enorm = 2.0 / (mel_f[2:] - mel_f[:-2])
    peaks = melW.max(axis=0)
    # peak <= enorm (triangle apex may fall between fft bins)
    assert np.all(peaks <= enorm * (1 + 1e-12))


def test_mel_scale_roundtrip():
    f = np.array([0.0, 50.0, 999.0, 1000.0, 5000.0, 14000.0])
    np.testing.assert_allclose(filters.mel_to_hz(filters.hz_to_mel(f)), f,
                               rtol=1e-12)
    np.testing.assert_allclose(
        filters.mel_to_hz(filters.hz_to_mel(f, htk=True), htk=True), f,
        rtol=1e-12)


def test_sine_peak_lands_on_expected_mel_bin():
    cfg = AUDIO_32K
    t = np.arange(cfg.sample_rate) / cfg.sample_rate
    x = np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    fe = frontend.LogmelFrontend(cfg)
    out = np.asarray(fe(jnp.asarray(x)[None]))[0]
    peak_bin = out.mean(axis=0).argmax()
    mel_centers = filters.mel_frequencies(66, cfg.fmin, cfg.fmax)[1:-1]
    assert abs(mel_centers[peak_bin] - 1000.0) < 150.0


def test_power_to_db_top_db():
    x = jnp.asarray([1.0, 1e-3, 1e-20])
    db = np.asarray(frontend.power_to_db(x, top_db=40.0))
    assert db[0] == 0.0  # ref=1.0 -> zero shift
    assert db.min() >= db.max() - 40.0


def test_mel_filterbank_vs_independent_construction():
    """Cross-check ``filters.mel_filterbank`` against an independently
    coded construction (librosa itself is not installable here; this
    oracle shares no code path: piecewise-coded Slaney scale constants,
    per-filter ``np.interp`` triangles, per-filter normalization).
    Matches must hold to 1e-12 for all three quality triads."""
    def hz2mel(f):
        f = float(f)
        if f < 1000.0:
            return 3.0 * f / 200.0
        return 15.0 + math.log(f / 1000.0) * (27.0 / math.log(6.4))

    def mel2hz(m):
        m = float(m)
        if m < 15.0:
            return 200.0 * m / 3.0
        return 1000.0 * math.exp(math.log(6.4) / 27.0 * (m - 15.0))

    for cfg in (AUDIO_8K, AUDIO_16K, AUDIO_32K):
        sr, n_fft = cfg.sample_rate, cfg.window_size
        n_mels, fmin, fmax = cfg.mel_bins, cfg.fmin, cfg.fmax
        bins = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
        lo_m, hi_m = hz2mel(fmin), hz2mel(fmax)
        corners = [mel2hz(lo_m + (hi_m - lo_m) * i / (n_mels + 1))
                   for i in range(n_mels + 2)]
        want = np.zeros((len(bins), n_mels))
        for m in range(n_mels):
            left, center, right = corners[m], corners[m + 1], corners[m + 2]
            tri = np.interp(bins, [left, center, right], [0.0, 1.0, 0.0],
                            left=0.0, right=0.0)
            # interp leaves boundary values at the exact corner points;
            # zero outside the open support like the ramp construction
            tri[(bins <= left) | (bins >= right)] = 0.0
            want[:, m] = tri * (2.0 / (right - left))
        got = filters.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=cfg.name)


# ---------------------------------------------------------------------------
# librosa value fixture (vendored test-only oracle)
# ---------------------------------------------------------------------------

def _librosa_mel_oracle(sr, n_fft, n_mels, fmin, fmax, htk=False,
                        norm='slaney', dtype=np.float64):
    """Faithful test-only transcription of ``librosa.filters.mel``
    (librosa 0.9.x, ``librosa/filters.py``, ISC license; the function the
    reference embeds at ``pytorch/stft.py:688-692``).  Kept verbatim in
    structure — np.fft.rfftfreq bins, subtract.outer ramps, Slaney area
    norm — so the repo's from-first-principles construction
    (``sed_jax/dsp/filters.py``) is pinned to librosa's exact values, not
    just to the same paper."""
    if fmax is None:
        fmax = float(sr) / 2
    weights = np.zeros((n_mels, int(1 + n_fft // 2)), dtype=dtype)

    # center freqs of each FFT bin: librosa.fft_frequencies
    fftfreqs = np.fft.rfftfreq(n=n_fft, d=1.0 / sr)

    # center freqs of mel bands: librosa.mel_frequencies
    # (hz_to_mel / mel_to_hz inlined, Slaney break at 1 kHz)
    def hz_to_mel(frequencies):
        frequencies = np.asanyarray(frequencies)
        f_min, f_sp = 0.0, 200.0 / 3
        mels = (frequencies - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        if htk:
            return 2595.0 * np.log10(1.0 + frequencies / 700.0)
        if mels.ndim:
            log_t = frequencies >= min_log_hz
            mels[log_t] = min_log_mel + \
                np.log(frequencies[log_t] / min_log_hz) / logstep
        elif frequencies >= min_log_hz:
            mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
        return mels

    def mel_to_hz(mels):
        mels = np.asanyarray(mels)
        if htk:
            return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
        f_min, f_sp = 0.0, 200.0 / 3
        freqs = f_min + f_sp * mels
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = np.log(6.4) / 27.0
        if mels.ndim:
            log_t = mels >= min_log_mel
            freqs[log_t] = min_log_hz * \
                np.exp(logstep * (mels[log_t] - min_log_mel))
        elif mels >= min_log_mel:
            freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
        return freqs

    min_mel = hz_to_mel(fmin)
    max_mel = hz_to_mel(fmax)
    mels = np.linspace(min_mel, max_mel, n_mels + 2)
    mel_f = mel_to_hz(mels)

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    for i in range(n_mels):
        # lower and upper slopes for all bins
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        # .. then intersect them with each other and zero
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    if norm == 'slaney':
        # Slaney-style mel is scaled to be approx constant energy per
        # channel
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]
    return weights


def test_mel_filterbank_matches_librosa_oracle():
    """The frontend's mel filterbank must equal librosa.filters.mel's
    values (vendored above) to <=1e-12 for all three audio-quality
    triads plus HTK/no-norm variants — the exact matrices the reference
    bakes into LogmelFilterBank (``pytorch/stft.py:688-692``)."""
    triads = [(8000, 256, 64, 12, 3500), (16000, 512, 64, 25, 7000),
              (32000, 1024, 64, 50, 14000)]
    for sr, n_fft, n_mels, fmin, fmax in triads:
        ours = filters.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
        gold = _librosa_mel_oracle(sr, n_fft, n_mels, fmin, fmax).T
        assert ours.shape == gold.shape == (n_fft // 2 + 1, n_mels)
        np.testing.assert_allclose(ours, gold, rtol=0, atol=1e-12)
        # float32 cast (what both the reference conv weights and our
        # frontend constants actually use) is elementwise identical
        np.testing.assert_array_equal(ours.astype(np.float32),
                                      gold.astype(np.float32))
    # variants: htk scale, no normalization, fmax=None default
    for kw in ({'htk': True}, {'norm': None}, {}):
        ours = filters.mel_filterbank(22050, 2048, 128, 0.0, None, **kw)
        gold = _librosa_mel_oracle(22050, 2048, 128, 0.0, None, **kw).T
        np.testing.assert_allclose(ours, gold, rtol=0, atol=1e-12)


@pytest.mark.parametrize('cfg', [AUDIO_8K, AUDIO_16K, AUDIO_32K],
                         ids=['8k', '16k', '32k'])
def test_model_logmel_matches_float64_reference(cfg):
    """The models' frontend (``frontend.logmel``) against the float64
    reference on loud, quiet and near-silent clips; the reference itself
    against the independent rfft gold."""
    rng = np.random.RandomState(2)
    levels = np.array([[1.0], [0.05], [1e-3]])
    x = (rng.uniform(-0.5, 0.5, (3, cfg.sample_rate + 37)) * levels
         ).astype(np.float32)
    mel, ref_db = frontend.logmel_reference(x, cfg)
    got = np.asarray(frontend.logmel(jnp.asarray(x), cfg))
    frames = (cfg.sample_rate + 37) // cfg.hop_size + 1
    assert got.shape == ref_db.shape == (3, frames, cfg.mel_bins)
    # float32 loses a few hundredths of a dB on the quietest bins only
    err = np.abs(got - ref_db)[mel > cfg.amin]
    assert err.max() < 0.25
    assert np.percentile(err, 99) < 0.01
    np.testing.assert_allclose(
        ref_db[0], gold_logmel(x[0].astype(np.float64), cfg), atol=1e-6)
