"""Event-decoder parity tests.

``reference_activity_detection`` below is an independent straight-line
simulation of the decoding rules documented in sed_jax.post.vad (derived
from the behavior of ``utils/vad.py``); the package's run-length
implementation must match it on randomized tracks.
"""

import numpy as np
import pytest

from sed_jax.post import vad
from sed_jax.post.merge import merge as merge_step, avg_merge, \
    overlap_add_windows
from sed_jax.post.events import decode_batch, write_submission
from sed_jax.config import SedParams


# --- independent simulation of the reference decoding rules ---------------

def sim_pairs_from_indices(locts):
    if len(locts) == 0:
        return []
    pairs = []
    run_start = locts[0]
    prev = locts[0]
    first = True
    for t in list(locts[1:]) + [None]:
        if t is None or t - prev > 1:
            bgn = run_start if first else run_start + 1
            fin = prev + 1 if t is not None else prev
            pairs.append([bgn, fin])
            first = False
            run_start = t
        prev = t if t is not None else prev
    return pairs


def sim_low_extend(x, pairs, low):
    out = []
    for bgn, fin in pairs:
        b = bgn
        if b >= len(x):
            # the reference would index out of bounds here (bgn can be T via
            # the +1 run-start shift); the package keeps b as-is and the
            # pair dies in the salt filter
            b -= 1  # so that b + 1 below reproduces "b stays"
        else:
            while b != -1:
                if x[b] < low:
                    break
                b -= 1
        f = fin
        while f != len(x):
            if x[f] < low:
                break
            f += 1
        out.append([b + 1, f])
    return sim_smooth(out, 1)


def sim_smooth(pairs, n_smooth):
    if not pairs:
        return []
    out = []
    mem_bgn = pairs[0][0]
    for n in range(1, len(pairs)):
        pre_bgn, pre_fin = pairs[n - 1]
        bgn, fin = pairs[n]
        if bgn - pre_fin > n_smooth:
            out.append([mem_bgn, pre_fin])
            mem_bgn = bgn
    out.append([mem_bgn, pairs[-1][1]])
    return out


def sim_activity_detection(x, thres, low_thres, n_smooth, n_salt):
    locts = np.where(x > thres)[0]
    pairs = sim_pairs_from_indices(list(locts))
    if low_thres is not None:
        pairs = sim_low_extend(x, pairs, low_thres)
    pairs = sim_smooth(pairs, n_smooth)
    return [[b, f] for b, f in pairs if f - b > n_salt]


# ---------------------------------------------------------------------------

@pytest.mark.parametrize('seed', range(20))
def test_activity_detection_matches_simulation(seed):
    rng = np.random.RandomState(seed)
    T = 200
    # smooth-ish probability track with plateaus
    x = np.clip(rng.uniform(-0.2, 1.1, T // 10), 0, 1).repeat(10)
    x = x + rng.uniform(-0.05, 0.05, T)
    high, low = 0.5, 0.2
    n_smooth, n_salt = 10, 10
    got = vad.activity_detection(x, high, low, n_smooth, n_salt)
    want = sim_activity_detection(x, high, low, n_smooth, n_salt)
    assert got == want


@pytest.mark.parametrize('seed', range(10))
def test_activity_detection_no_low_threshold(seed):
    rng = np.random.RandomState(100 + seed)
    x = rng.uniform(0, 1, 150)
    got = vad.activity_detection(x, 0.6, None, 3, 2)
    want = sim_activity_detection(x, 0.6, None, 3, 2)
    assert got == want


def test_activity_detection_empty_and_full():
    assert vad.activity_detection(np.zeros(50), 0.5, 0.2, 10, 10) == []
    out = vad.activity_detection(np.ones(50), 0.5, 0.2, 10, 10)
    assert out == [[0, 50]]


def test_decode_batch_gating_matches_per_track():
    rng = np.random.RandomState(7)
    framewise = rng.uniform(0, 1, (4, 120, 25)) ** 3  # mostly silent
    params = SedParams(0.5, 0.5, 0.2, 10, 10)
    events = decode_batch(framewise, [f'a{i}.wav' for i in range(4)],
                          params, 100)
    # cross-check every (clip, class) against direct decode
    want = []
    for n in range(4):
        for k in range(25):
            pairs = sim_activity_detection(framewise[n, :, k], 0.5, 0.2,
                                           10, 10)
            for b, f in pairs:
                want.append((f'a{n}.wav', b / 100.0, f / 100.0))
    got = [(e['filename'], e['onset'], e['offset']) for e in events]
    assert sorted(got) == sorted(want)


def test_overlap_add_matches_incremental_merge():
    rng = np.random.RandomState(3)
    sample_duration, overlap_value = 5, 1
    windows = rng.uniform(0, 1, (7, 500, 25)).astype(np.float32)
    # incremental reference-style fold
    merged = windows[0:1].copy()
    for i in range(1, 7):
        merged = merge_step(merged, windows[i:i + 1], sample_duration,
                            i + 1, overlap_value)
    merged = avg_merge(merged.astype(np.float64), sample_duration,
                       overlap_value)
    oneshot = overlap_add_windows(windows.astype(np.float64),
                                  sample_duration, overlap_value)
    np.testing.assert_allclose(oneshot, merged, rtol=1e-6, atol=1e-6)


def test_events_to_xml_escapes_attributes():
    """ASR transcripts / file names with XML metacharacters must yield
    well-formed XML (the reference concatenates raw strings)."""
    import xml.etree.ElementTree as ET
    from sed_jax.post.xml_writer import events_to_xml
    events = [{'onset': 0.5, 'offset': 1.5, 'event_label': 'Speech',
               'text': 'he said "stop" & <ran>'}]
    xml = events_to_xml(events, 'a&b<c>.wav')
    root = ET.fromstring(xml)              # parses => well-formed
    assert root.attrib['name'] == 'a&b<c>.wav'
    seg = root.find('.//SoundSegment')
    assert seg.attrib['text'] == 'he said "stop" & <ran>'
    # plain label path stays byte-identical to the reference format
    plain = events_to_xml([{'onset': 0, 'offset': 1,
                            'event_label': 'Siren'}], 'x.wav')
    assert '<SoundSegment stime="0" dur="1" event="Siren">Siren' in plain


def test_write_submission(tmp_path):
    events = [{'filename': 'x.wav', 'onset': 0.5, 'offset': 1.25,
               'event_label': 'Siren'}]
    p = tmp_path / 'sub.tsv'
    write_submission(events, str(p))
    assert p.read_text() == 'x.wav\t0.5\t1.25\tSiren\n'
