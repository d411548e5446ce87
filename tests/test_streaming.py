"""StreamingSed: incremental serving must equal the offline pipeline.

The stream result (all feed() emissions + flush()) must match
``SedInferenceEngine.predict_waveform`` on the concatenated audio
EXACTLY, for any chunking of the input; mid-stream emissions must be a
subset of the final result and must actually happen before the end for
long streams (incrementality).
"""

import os
import sys

import numpy as np
import pytest

import jax

from sed_jax.config import AUDIO_16K
from sed_jax.models.registry import get_model
from sed_jax.serve.engine import SedInferenceEngine
from sed_jax.serve.streaming import StreamingSed
from sed_jax.utils.npz_ckpt import load_variables_npz

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))
from bench_corpus import make_clips as make_test_clips  # noqa: E402

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools', 'bench_checkpoint.npz')


@pytest.fixture(scope='module')
def engine():
    if not os.path.exists(CKPT):
        pytest.skip('bench checkpoint not present')
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    variables = load_variables_npz(CKPT)
    return SedInferenceEngine(model, variables, cfg, sample_duration=5,
                              overlap=True, batch_size=8)


@pytest.fixture(scope='module')
def audio(engine):
    """~23.7 s with tone bursts the trained checkpoint detects."""
    sr = AUDIO_16K.sample_rate
    clips = make_test_clips(5, sr, seconds=5, seed=9)
    long = np.concatenate([c for c in clips])[:int(23.7 * sr)]
    return np.ascontiguousarray(long, np.float32)


def _key(e):
    return (e['event_label'], round(e['onset'], 4), round(e['offset'], 4))


def _offline(engine, audio):
    return sorted(_key(e)
                  for e in engine.predict_waveform(audio, 'stream'))


@pytest.mark.parametrize('pattern', ['tiny', 'medium', 'one_shot',
                                     'random'])
def test_stream_equals_offline(engine, audio, pattern):
    sr = AUDIO_16K.sample_rate
    want = _offline(engine, audio)
    assert want, 'trained checkpoint must produce events on this audio'

    rng = np.random.RandomState(0)
    if pattern == 'tiny':
        sizes = [int(0.37 * sr)] * (len(audio) // int(0.37 * sr) + 1)
    elif pattern == 'medium':
        sizes = [int(2.3 * sr)] * (len(audio) // int(2.3 * sr) + 1)
    elif pattern == 'one_shot':
        sizes = [len(audio)]
    else:
        sizes = []
        while sum(sizes) < len(audio):
            sizes.append(int(rng.uniform(0.05, 3.0) * sr))

    sess = StreamingSed(engine, audio_name='stream')
    got = []
    early = []
    pos = 0
    for s in sizes:
        chunk = audio[pos:pos + s]
        pos += s
        evs = sess.feed(chunk)
        got.extend(evs)
        early.extend(evs)
        if pos >= len(audio):
            break
    got.extend(sess.flush())

    assert sorted(_key(e) for e in got) == want
    # mid-stream emissions are a subset of the final result
    assert set(_key(e) for e in early) <= set(want)
    if pattern in ('tiny', 'medium', 'random'):
        # incrementality: something must come out before flush on a
        # 23.7 s stream full of events
        assert early, 'no events finalized before flush'


def test_stream_shorter_than_one_window(engine):
    """A 2 s stream: the offline grid still runs one padded window
    (window_starts always includes 0.0); flush must reproduce it."""
    sr = AUDIO_16K.sample_rate
    clips = make_test_clips(1, sr, seconds=5, seed=10)
    short = clips[0][:2 * sr]
    want = _offline(engine, short)
    sess = StreamingSed(engine, audio_name='stream')
    got = list(sess.feed(short))
    assert got == []                 # nothing can finalize mid-stream
    got.extend(sess.flush())
    assert sorted(_key(e) for e in got) == want


def test_stream_rejects_double_flush(engine):
    sess = StreamingSed(engine, audio_name='stream')
    sess.flush()
    with pytest.raises(AssertionError):
        sess.feed(np.zeros(100, np.float32))
    with pytest.raises(AssertionError):
        sess.flush()


def test_stream_drops_consumed_audio(engine, audio):
    sr = AUDIO_16K.sample_rate
    sess = StreamingSed(engine, audio_name='stream')
    for i in range(0, len(audio), sr):
        sess.feed(audio[i:i + sr])
    retained = sum(len(c) for c in sess._chunks)
    # only the current window span (+ partial chunk slack) stays resident
    assert retained <= (engine.sample_duration + 2) * sr
    sess.flush()
