"""Golden-XML layout regression vs the reference's SHIPPED prediction
artifact (``/root/reference/predict_results/IGFZfTxCc5I.xml``).

The artifact was produced by ``pytorch/predict.py``'s XML assembly; the
repo's writer must reproduce its element/attribute layout.  One known
delta, asserted explicitly: the shipped file predates the reference's
CURRENT code — ``predict.py:368`` (active) adds an ``event=`` attribute
that the commented-out ``:367`` variant (which produced the artifact)
lacked.  The writer follows the current code, so segments carry
``{stime, dur, event}``; everything else (document structure, tab
layout, stime/dur float rendering, label text content, ordering) must
match the artifact.
"""

import os
import xml.etree.ElementTree as ET

import pytest

from sed_jax.post import xml_writer

GOLDEN = '/root/reference/predict_results/IGFZfTxCc5I.xml'

pytestmark = pytest.mark.skipif(not os.path.isfile(GOLDEN),
                                reason='reference artifact not present')


def _parse(text):
    root = ET.fromstring(text)
    segs = root.findall('./SoundCaptionList/SoundSegment')
    return root, segs


def test_golden_xml_layout_round_trip():
    golden_text = open(GOLDEN).read()
    g_root, g_segs = _parse(golden_text)
    assert g_root.tag == 'AudioDoc'
    assert g_root.get('name') == 'IGFZfTxCc5I.wav'
    assert len(g_segs) > 100          # a real, dense prediction

    events = [{'onset': float(s.get('stime')),
               'offset': float(s.get('stime')) + float(s.get('dur')),
               'event_label': s.text} for s in g_segs]
    ours = xml_writer.events_to_xml(events, g_root.get('name'))
    o_root, o_segs = _parse(ours)

    assert o_root.tag == 'AudioDoc'
    assert o_root.get('name') == g_root.get('name')
    assert len(o_segs) == len(g_segs)
    # the artifact also predates the current code's global onset sort
    # (predict.py:354) — compare as multisets, then assert OUR order is
    # the current code's onset order
    def key(seg):
        return (round(float(seg.get('stime')), 9),
                round(float(seg.get('dur')), 9), seg.text)
    assert sorted(map(key, o_segs)) == sorted(map(key, g_segs))
    onsets = [float(s2.get('stime')) for s2 in o_segs]
    assert onsets == sorted(onsets)
    for o in o_segs:
        # current-code layout: the event attribute names the label
        assert o.get('event') == o.text
        assert set(o.keys()) == {'stime', 'dur', 'event'}

    # byte-level layout: same header/footer and per-line indentation
    g_lines = golden_text.splitlines()
    o_lines = ours.splitlines()
    assert o_lines[0] == g_lines[0]                   # <AudioDoc name=..>
    assert o_lines[1] == g_lines[1]                   # \t<SoundCaptionList>
    assert o_lines[-2] == g_lines[-2]
    assert o_lines[-1] == g_lines[-1]
    assert all(ln.startswith('\t\t<SoundSegment stime="')
               for ln in o_lines[2:-2])


def test_golden_xml_stime_dur_string_rendering():
    """The artifact renders stime/dur with Python float repr (e.g.
    ``dur="2.3200000000000003"``); the writer must reproduce that
    formatting when given the same floats."""
    events = [{'onset': 25.92, 'offset': 25.92 + 2.3200000000000003,
               'event_label': 'Male_speech_man_speaking'}]
    out = xml_writer.events_to_xml(events, 'x.wav')
    assert 'stime="25.92"' in out
    assert 'dur="2.3200000000000003"' in out
