"""v6 lossless wire tests: codec exactness vs the q6 container, device
pool decode parity, and size guarantees.

v6 is the exact rung below q6 the round-4 verdict asked for: a
variable-rate LOSSLESS re-pack of the q6 symbol stream (per-block
best-of-four predictors, 32-sample sub-group bit widths — see
``audio_io.v6_encode_clip``).  Decode equality to the q6 wire is the
whole contract: every event-parity property already pinned for q6
(tests/test_wire.py) transfers to v6 by bit-identity, and the wire
admission gate measures it like any other wire
(tools/wire_admission.py).
"""

import sys
import os

import numpy as np
import jax.numpy as jnp
import pytest

from sed_jax.data import audio_io
from sed_jax.ops import wire

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), 'tools'))


def _corpus_clips(n, seconds=5, seed=11, sr=16000):
    from bench_corpus import make_clips
    return make_clips(n, sr, seconds=seconds, seed=seed)


def test_v6_roundtrip_bit_exact_vs_q6():
    sr = 16000
    s = sr * 5
    clips = _corpus_clips(12)
    ref = audio_io.qn_decode_np(audio_io.qn_encode(clips, 6), s, 6)
    for i in range(clips.shape[0]):
        buf = audio_io.v6_encode_clip(clips[i])
        assert len(buf) % 16 == 0
        assert len(buf) <= audio_io.v6_max_bytes(s)
        dec = audio_io.v6_decode_np(buf, s)
        np.testing.assert_array_equal(dec, ref[i])


def test_v6_edge_inputs():
    sr = 16000
    s = sr * 5
    t = np.arange(s) / sr
    cases = [
        np.zeros(s, np.float32),                      # silence
        np.ones(s, np.float32),                       # DC saturation
        (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
        (0.9 * np.sin(2 * np.pi * 7900 * t)).astype(np.float32),
        np.random.RandomState(3).uniform(-1, 1, s).astype(np.float32),
        (np.random.RandomState(4).uniform(-1, 1, s) * 32767).astype(
            np.int16),                                # int16 input path
    ]
    for x in cases:
        ref = audio_io.qn_decode_np(audio_io.qn_encode(x[None], 6),
                                    s, 6)[0]
        got = audio_io.v6_decode_np(audio_io.v6_encode_clip(x), s)
        np.testing.assert_array_equal(got, ref)
    # a pure tone compresses far below the q6 width; full-scale white
    # noise stays within the worst-case bound
    tone = audio_io.v6_encode_clip(cases[2])
    noise = audio_io.v6_encode_clip(cases[4])
    assert len(tone) < 0.6 * audio_io.qn_bytes(s, 6)
    assert len(noise) <= audio_io.v6_max_bytes(s)


def test_v6_container_roundtrip(tmp_path):
    sr = 16000
    clip = _corpus_clips(1)[0]
    p = str(tmp_path / 'clip.v6')
    audio_io.save_v6(p, clip, sr)
    buf, sr2, samples = audio_io.read_v6(p)
    assert (sr2, samples) == (sr, clip.shape[0])
    assert audio_io.v6_payload_bytes(p) == len(buf)
    np.testing.assert_array_equal(
        audio_io.v6_decode_np(buf, samples),
        audio_io.qn_decode_np(audio_io.qn_encode(clip[None], 6),
                              samples, 6)[0])


@pytest.mark.slow
def test_v6_ragged_resident_matches_q6(tmp_path):
    """The ragged resident path (flat true-bytes pool + offsets) must
    produce the exact events/XML of the fixed-width q6 resident path —
    v6 decode is bit-identical to q6's, so any divergence is plumbing."""
    import jax
    from sed_jax.config import AUDIO_16K, PREDICT_SED_PARAMS
    from sed_jax.models.registry import get_model
    from sed_jax.serve.engine import SedInferenceEngine

    cfg = AUDIO_16K
    sr = cfg.sample_rate
    clips = _corpus_clips(10, seed=21)
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    variables = model.init({'params': jax.random.PRNGKey(0)},
                           np.zeros((1, sr * 5), np.float32),
                           train=False)
    eng = SedInferenceEngine(model, variables, cfg, sample_duration=5,
                             overlap=True,
                             sed_params=PREDICT_SED_PARAMS, batch_size=4)
    names = [f'clip{i}.wav' for i in range(10)]
    ev_q6, xml_q6 = eng.predict_clips_resident(
        audio_io.qn_encode(clips, 6), names=names, upload_threads=2)
    paths = []
    for i in range(10):
        p = str(tmp_path / f'c{i}.v6')
        audio_io.save_v6(p, clips[i], sr)
        paths.append(p)

    def reader(p):
        return audio_io.read_v6(p)[0]

    tel: dict = {}
    ev_v6, xml_v6 = eng.predict_files_resident_ragged(
        paths, reader, names=names, upload_threads=3, telemetry=tel)
    assert ev_v6 == ev_q6 and xml_v6 == xml_q6
    # the pool ships fewer bytes than even the unpadded q6 buffer
    assert tel['bytes_h2d'] < 10 * audio_io.qn_bytes(sr * 5, 6)
    # warmup from payload sizes alone hits the same compiled program
    nprog = len(eng._resident_cache)
    eng.warmup_resident_ragged(
        [audio_io.v6_payload_bytes(p) for p in paths], 3)
    assert len(eng._resident_cache) == nprog
    # in-memory rows API (wire admission tool)
    ev_r, _ = eng.predict_rows_resident([reader(p) for p in paths],
                                        names=names)
    assert ev_r == ev_q6


@pytest.mark.slow
def test_v6_device_pool_decode_bit_exact():
    sr = 16000
    s = sr * 5
    clips = _corpus_clips(6, seed=13)
    bufs = [audio_io.v6_encode_clip(clips[i]) for i in range(6)]
    ref = np.stack([audio_io.v6_decode_np(b, s) for b in bufs])
    offs = (np.cumsum([0] + [len(b) for b in bufs])[:-1] // 4).astype(
        np.int32)
    pool_b = np.concatenate(bufs + [np.zeros(8192, np.uint8)])
    pool = jnp.asarray(pool_b.view(np.int32))
    got = np.asarray(wire.dequant_v6_pool(pool, jnp.asarray(offs), s))
    np.testing.assert_array_equal(got, ref)
    # a padding row whose offset points into the zero tail is silent
    off2 = jnp.asarray(np.concatenate(
        [offs, [len(pool_b) // 4 - 1024]]).astype(np.int32))
    got2 = np.asarray(wire.dequant_v6_pool(pool, off2, s))
    np.testing.assert_array_equal(got2[:6], ref)
    assert np.all(got2[6] == 0.0)
