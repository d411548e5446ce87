"""Compressed train-wire tests: device dequant parity + train-step use.

A 24+8-clip joint step ships 10.24 MB of int16 from host to device.
``--train_wire mulaw8/q6``
ships the loader batches compressed and dequantizes on device via the
SAME ``ops/wire.dequant_wire`` the serving engine uses.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax import losses
from sed_jax.config import AUDIO_16K, CLASSES_NUM
from sed_jax.data import audio_io
from sed_jax.data.dataset import AudiosetDataset
from sed_jax.data.hdf5_pack import int16_to_float32
from sed_jax.models.registry import get_model
from sed_jax.ops import wire
from sed_jax.train.state import create_train_state
from sed_jax.train.step import make_train_step
import pytest

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow


def test_dequant_wire_matches_host_decoders():
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (4, 1280)).astype(np.float32)
    for bits in audio_io.QN_BITS:
        buf = audio_io.qn_encode(x, bits)
        ref = audio_io.qn_decode_np(buf, 1280, bits)
        got = np.asarray(wire.dequant_wire(jnp.asarray(buf), 1280))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    i16 = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    np.testing.assert_allclose(
        np.asarray(wire.dequant_wire(jnp.asarray(i16))),
        i16.astype(np.float32) / 32767.0, rtol=1e-6)
    mu = audio_io.mulaw_encode(x)
    np.testing.assert_allclose(
        np.asarray(wire.dequant_wire(jnp.asarray(mu), 1280)),
        audio_io.mulaw_decode_table()[mu], atol=1e-7)
    # float32 passthrough
    np.testing.assert_array_equal(
        np.asarray(wire.dequant_wire(jnp.asarray(x))), x)


def test_dataset_wire_encode_roundtrip():
    ds = AudiosetDataset(wire='q6')
    rng = np.random.RandomState(1)
    w = (rng.uniform(-1, 1, (3, 1280)) * 32767).astype(np.int16)
    enc = ds._encode_wire(w)
    np.testing.assert_array_equal(enc, audio_io.qn_encode(w, 6))
    # 1-D convenience path used by __getitem__
    np.testing.assert_array_equal(ds._encode_wire(w[0]), enc[0])
    # 'int16' is an alias for the packed storage format (no re-encode)
    ds16 = AudiosetDataset(wire='int16')
    assert ds16.wire is None and ds16.dequantize is False
    mu = AudiosetDataset(wire='mulaw8')._encode_wire(w)
    assert mu.dtype == np.uint8 and mu.shape == w.shape


def test_train_step_q6_wire_close_to_int16():
    """One jitted step on q6-wire batches runs, stays finite, and the
    loss lands near the exact-int16 step's (q6 block-scaled audio is a
    small perturbation of the waveform, not a different pipeline)."""
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_FrameAvg', cfg)
    rng = np.random.RandomState(0)
    n = cfg.sample_rate            # 1 s clips: 16000 % 128 == 0
    wav16 = (rng.uniform(-0.5, 0.5, (2, n)) * 32767).astype(np.int16)
    target = (rng.rand(2, CLASSES_NUM) > 0.8).astype(np.float32)
    strong_t = (rng.rand(2, 100, CLASSES_NUM) > 0.9).astype(np.float32)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(int16_to_float32(wav16)))
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=False, timeshift=False,
                           spec_augment=False, donate=False,
                           wire_samples=n)
    key = jax.random.PRNGKey(1)
    _, m16 = step(state, {'waveform': wav16, 'target': target},
                  [{'waveform': wav16.copy(), 'strong_target': strong_t}],
                  key)
    q6 = audio_io.qn_encode(wav16, 6)
    _, mq = step(state, {'waveform': q6, 'target': target},
                 [{'waveform': q6.copy(), 'strong_target': strong_t}],
                 key)
    l16, lq = float(m16['loss']), float(mq['loss'])
    assert np.isfinite(lq)
    assert abs(lq - l16) < 0.02 * max(1.0, abs(l16)), (l16, lq)


def test_train_wire_cli_flag_parses():
    from sed_jax.cli.main_strong import get_parser
    args = get_parser().parse_args(
        ['train', '--dataset_dir', 'd', '--workspace', 'w',
         '--model_type', 'Cnn_9layers_FrameAvg', '--train_wire', 'q6'])
    assert args.train_wire == 'q6'


def test_train_wire_rejected_for_gamma_features():
    import pytest
    from sed_jax.cli import main_strong
    with pytest.raises(SystemExit, match='gamma'):
        main_strong.main(
            ['train', '--dataset_dir', 'd', '--workspace', 'w',
             '--model_type', 'Cnn_9layers_FrameAvg',
             '--feature_type', 'gamma', '--train_wire', 'q6'])


def test_narrow_wire_event_match_trained():
    """Event-match levels per qN wire on the TRAINED bench checkpoint.

    Measured levels (16 bench clips, 0.05 s onset tolerance): q6 1.00,
    q5 0.73, q4 0.67, adpcm4 0.40, q3 0.13, q2 0.07 — the narrow q3/q2
    wires DEGRADE detection (q3 found 6 of 15 events), so they are not
    admitted (tools/wire_admission.json); q6 is the exact-parity
    wire.  This test pins loose floors of those levels (backend numerics
    shift them slightly) plus the ordering claim: more mantissa bits,
    better event match.
    """
    import os as _os
    import sys as _sys

    import pytest

    _sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools'))
    from bench_corpus import make_clips as make_test_clips
    from sed_jax.serve.engine import SedInferenceEngine
    from sed_jax.utils.npz_ckpt import load_variables_npz

    ckpt = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools', 'bench_checkpoint.npz')
    if not _os.path.exists(ckpt):
        pytest.skip('bench checkpoint not present')
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    engine = SedInferenceEngine(model, load_variables_npz(ckpt), cfg,
                                sample_duration=5, overlap=True,
                                batch_size=8)
    clips = make_test_clips(8, cfg.sample_rate, seconds=5, seed=5)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)

    def flat(per_clip):
        return {(i, e['event_label'], round(e['onset'], 2),
                 round(e['offset'], 2))
                for i, evs in enumerate(per_clip) for e in evs}

    def match(a, b):
        def hits(src, dst):
            return sum(
                1 for (i, lb, on, off) in src
                if any(i == j and lb == lb2 and abs(on - on2) <= 0.05
                       and abs(off - off2) <= 0.05
                       for (j, lb2, on2, off2) in dst))
        total = max(len(a), len(b), 1)
        return (hits(a, b) + hits(b, a)) / (2 * total)

    base = flat(engine.predict_clips(pcm)[0])
    assert len(base) > 0                    # trained model finds events
    scores = {}
    for bits in audio_io.QN_BITS:
        got = flat(engine.predict_clips(audio_io.qn_encode(pcm, bits))[0])
        scores[bits] = match(base, got)
        # every width must still produce decodable, well-formed events
        for (_, lb, on, off) in got:
            assert isinstance(lb, str) and 0.0 <= on <= off <= 5.01
    assert scores[6] >= 0.9                 # exact-parity serving wire
    # NOTE: no floors are pinned for the lossy widths — headline
    # eligibility is decided EXCLUSIVELY by the measured segment-based
    # ER/F1 admission gate (tools/wire_admission.json, enforced by
    # bench.resolve_auto_wires and pinned in
    # tests/test_wire_admission.py), not by this 0.05 s-tolerance
    # event-match ladder.  The ladder remains as the strictest fidelity
    # ordering check: more mantissa bits, better event match.
    assert scores[6] >= scores[4] >= scores[2]
    assert scores[6] >= scores[5] >= scores[3]
