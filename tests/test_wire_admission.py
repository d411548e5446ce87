"""Invariants of the wire-admission table.

A compressed wire is admitted only if its segment-based ER/F1 delta vs
the int16 decode is <= 0.5% (the BASELINE.json contract) on >= 256
hardened-corpus clips, measured against the trained bench checkpoint
by tools/wire_admission.py and committed as tools/wire_admission.json.
"""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE = os.path.join(ROOT, 'tools', 'wire_admission.json')


def test_admission_table_exists_and_coherent():
    with open(TABLE) as f:
        t = json.load(f)
    meta = t['meta']
    # the contract: >= 256 clips, 0.5% tolerance, segment-based metric
    assert meta['clips'] >= 256
    assert meta['tolerance'] == 0.005
    assert 'segment-based' in meta['metric']
    # int16 is the parity baseline by definition
    assert t['int16']['admitted'] is True
    for w, r in t['wires'].items():
        # every admitted flag must agree with its own recorded deltas
        expect = r['d_er'] <= meta['tolerance'] + 1e-9 \
            and r['d_f1'] <= meta['tolerance'] + 1e-9
        assert r['admitted'] == expect, (w, r)
        assert r['bytes_per_clip'] > 0
    # the exact-parity rungs must pass their own gate: q6 decodes are
    # event-identical on the bench distribution, v6 is bit-identical
    # to q6 by construction
    assert t['wires']['q6']['admitted'] is True
    if 'v6' in t['wires']:
        assert t['wires']['v6']['admitted'] is True
        assert t['wires']['v6']['er'] == t['wires']['q6']['er']
        assert t['wires']['v6']['f1'] == t['wires']['q6']['f1']
