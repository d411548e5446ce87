"""Native decoder parity vs the numpy mask decoder, on random tracks."""

import numpy as np
import pytest

from sed_jax.native.vad_native import native_available, decode_packed_tracks
from sed_jax.post import vad

pytestmark = [pytest.mark.slow,
              pytest.mark.skipif(not native_available(),
                                 reason='g++ unavailable')]


def _pack(mask):
    return np.packbits(mask, axis=-1)


@pytest.mark.parametrize('seed', range(15))
def test_native_matches_numpy_decoder(seed):
    rng = np.random.RandomState(seed)
    k, t = 32, 500
    x = np.clip(rng.uniform(-0.2, 1.1, (k, t // 10)), 0, 1).repeat(10,
                                                                   axis=1)
    x += rng.uniform(-0.05, 0.05, (k, t))
    high = x > 0.5
    low = x >= 0.2
    n_smooth = np.full(k, 10, np.int32)
    n_salt = np.full(k, 10, np.int32)

    got = decode_packed_tracks(_pack(high), _pack(low), t, n_smooth,
                               n_salt)
    for i in range(k):
        want = vad.activity_detection_masks(high[i], low[i], 10, 10)
        assert [list(p) for p in got[i]] == want


def test_native_cap_overflow_matches_numpy():
    """Tracks with more events than the default 256-entry buffer must
    grow the buffer and return the full set (not silently truncate)."""
    t = 1600
    # ~400 isolated 2-frame events with n_salt=1 -> >256 survive
    high = np.zeros((1, t), bool)
    high[0, ::4] = True
    high[0, 1::4] = True
    n_smooth = np.zeros(1, np.int32)
    n_salt = np.zeros(1, np.int32)
    got = decode_packed_tracks(_pack(high), None, t, n_smooth, n_salt)
    want = vad.activity_detection_masks(high[0], None, 0, 0)
    assert len(got[0]) == len(want) > 256
    assert [list(p) for p in got[0]] == want


def test_native_no_low_mask():
    rng = np.random.RandomState(99)
    x = rng.uniform(0, 1, (8, 300))
    high = x > 0.6
    got = decode_packed_tracks(_pack(high), None, 300,
                               np.full(8, 3, np.int32),
                               np.full(8, 2, np.int32))
    for i in range(8):
        want = vad.activity_detection_masks(high[i], None, 3, 2)
        assert [list(p) for p in got[i]] == want


def test_native_edge_cases():
    t = 64
    cases = [
        np.zeros((1, t), bool),              # silent
        np.ones((1, t), bool),               # saturated
    ]
    one = np.zeros((1, t), bool)
    one[0, -1] = True                        # single frame at the end
    cases.append(one)
    for high in cases:
        low = high.copy()
        got = decode_packed_tracks(_pack(high), _pack(low), t,
                                   np.full(1, 10, np.int32),
                                   np.full(1, 10, np.int32))
        want = vad.activity_detection_masks(high[0], low[0], 10, 10)
        assert [list(p) for p in got[0]] == want
