"""Randomized cross-validation of the segment metric engine.

``sed_eval`` (the package that DEFINES the reference's headline ER/F1,
``utils/utilities.py:294-340``) is not installable in this environment, so
the strongest available oracle is a from-first-principles brute-force
reimplementation that shares NO formulation with
``sed_jax/eval/segment_metrics.py``:

  * activity is decided by open-interval overlap (``seg < offset and
    seg+1 > onset``) instead of floor/ceil roll indexing — provably
    equivalent for the Mesaros 2016 definition, so any indexing bug in
    either side breaks agreement;
  * counts use per-segment python sets and integer arithmetic instead of
    boolean matrices;
  * result assembly is written independently.

1,200 randomized corpora (overlapping events, zero-length events,
duplicate labels, events outside the reference file set, empty estimated
lists) must agree on every field of the results dict.
"""

import math
import os

import numpy as np
import pytest

from sed_jax.eval.segment_metrics import (SegmentBasedMetrics,
                                          official_evaluate)

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow


# ---------------------------------------------------------------------------
# brute-force oracle (different formulation, see module docstring)
# ---------------------------------------------------------------------------

def _brute_force_file(ref_events, est_events, labels):
    """Per-segment counts for one file via interval-overlap activity."""
    length = 0.0
    for e in list(ref_events) + list(est_events):
        length = max(length, float(e['offset']))
    n_seg = int(math.ceil(length))

    def active(events, seg):
        out = set()
        for e in events:
            if e['event_label'] not in labels:
                continue
            on, off = float(e['onset']), float(e['offset'])
            if on == off:
                # zero-length event: active in its floor segment
                if math.floor(on) == seg and math.ceil(off) > seg:
                    out.add(e['event_label'])
                continue
            if seg < off and seg + 1 > on:
                out.add(e['event_label'])
        return out

    totals = {'Ntp': 0, 'Ntn': 0, 'Nfp': 0, 'Nfn': 0, 'Nref': 0,
              'Nsys': 0, 'S': 0, 'D': 0, 'I': 0}
    per_class = {lb: {'Ntp': 0, 'Ntn': 0, 'Nfp': 0, 'Nfn': 0,
                      'Nref': 0, 'Nsys': 0} for lb in labels}
    for seg in range(n_seg):
        r = active(ref_events, seg)
        s = active(est_events, seg)
        ntp = len(r & s)
        totals['Ntp'] += ntp
        totals['Ntn'] += len(labels) - len(r | s)
        totals['Nfp'] += len(s - r)
        totals['Nfn'] += len(r - s)
        totals['Nref'] += len(r)
        totals['Nsys'] += len(s)
        totals['S'] += min(len(r), len(s)) - ntp
        totals['D'] += max(0, len(r) - len(s))
        totals['I'] += max(0, len(s) - len(r))
        for lb in labels:
            c = per_class[lb]
            c['Ntp'] += int(lb in r and lb in s)
            c['Ntn'] += int(lb not in r and lb not in s)
            c['Nfp'] += int(lb in s and lb not in r)
            c['Nfn'] += int(lb in r and lb not in s)
            c['Nref'] += int(lb in r)
            c['Nsys'] += int(lb in s)
    return totals, per_class


def _brute_force_results(file_pairs, labels):
    ov = {'Ntp': 0, 'Ntn': 0, 'Nfp': 0, 'Nfn': 0, 'Nref': 0, 'Nsys': 0,
          'S': 0, 'D': 0, 'I': 0}
    cw = {lb: {'Ntp': 0, 'Ntn': 0, 'Nfp': 0, 'Nfn': 0, 'Nref': 0,
               'Nsys': 0} for lb in labels}
    for ref_events, est_events in file_pairs:
        t, pc = _brute_force_file(ref_events, est_events, labels)
        for k in ov:
            ov[k] += t[k]
        for lb in labels:
            for k in cw[lb]:
                cw[lb][k] += pc[lb][k]
    return ov, cw


def _check_against_brute_force(metrics_results, ov, cw, labels):
    got_ov = metrics_results['overall']
    nref = ov['Nref'] if ov['Nref'] else 1
    nsys = ov['Nsys']
    prec = ov['Ntp'] / nsys if nsys else 0.0
    rec = ov['Ntp'] / ov['Nref'] if ov['Nref'] else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    assert abs(got_ov['f_measure']['precision'] - prec) < 1e-12
    assert abs(got_ov['f_measure']['recall'] - rec) < 1e-12
    assert abs(got_ov['f_measure']['f_measure'] - f1) < 1e-12
    er = got_ov['error_rate']
    assert abs(er['error_rate']
               - (ov['S'] + ov['D'] + ov['I']) / nref) < 1e-12
    assert abs(er['substitution_rate'] - ov['S'] / nref) < 1e-12
    assert abs(er['deletion_rate'] - ov['D'] / nref) < 1e-12
    assert abs(er['insertion_rate'] - ov['I'] / nref) < 1e-12
    total = ov['Ntp'] + ov['Ntn'] + ov['Nfp'] + ov['Nfn']
    if total:
        assert abs(got_ov['accuracy']['accuracy']
                   - (ov['Ntp'] + ov['Ntn']) / total) < 1e-12

    f1s, ers = [], []
    for lb in labels:
        c = cw[lb]
        got_c = metrics_results['class_wise'][lb]
        assert got_c['count']['Nref'] == c['Nref'], lb
        assert got_c['count']['Nsys'] == c['Nsys'], lb
        nref_c = c['Nref'] if c['Nref'] else 1
        prec_c = c['Ntp'] / c['Nsys'] if c['Nsys'] else 0.0
        rec_c = c['Ntp'] / c['Nref'] if c['Nref'] else 0.0
        f1_c = (2 * prec_c * rec_c / (prec_c + rec_c)
                if prec_c + rec_c else 0.0)
        er_c = (c['Nfn'] + c['Nfp']) / nref_c
        assert abs(got_c['f_measure']['f_measure'] - f1_c) < 1e-12, lb
        assert abs(got_c['error_rate']['error_rate'] - er_c) < 1e-12, lb
        assert abs(got_c['error_rate']['deletion_rate']
                   - c['Nfn'] / nref_c) < 1e-12, lb
        assert abs(got_c['error_rate']['insertion_rate']
                   - c['Nfp'] / nref_c) < 1e-12, lb
        if c['Nref'] > 0:
            f1s.append(f1_c)
            ers.append(er_c)
    avg = metrics_results['class_wise_average']
    want_f1 = float(np.mean(f1s)) if f1s else 0.0
    want_er = float(np.mean(ers)) if ers else 0.0
    assert abs(avg['f_measure']['f_measure'] - want_f1) < 1e-12
    assert abs(avg['error_rate']['error_rate'] - want_er) < 1e-12


def _random_events(rng, labels, n, max_t=12.0, zero_len_p=0.05):
    events = []
    for _ in range(n):
        a, b = sorted(rng.uniform(0, max_t, 2))
        if rng.rand() < zero_len_p:
            b = a
        events.append({'filename': 'f',
                       'onset': round(float(a), 3),
                       'offset': round(float(b), 3),
                       'event_label': labels[rng.randint(len(labels))]})
    return events


def test_fuzz_1200_corpora_against_brute_force():
    rng = np.random.RandomState(0)
    all_labels = ['a', 'b', 'c', 'd', 'e', 'f1', 'g', 'h']
    for corpus in range(1200):
        n_labels = int(rng.randint(2, len(all_labels) + 1))
        labels = all_labels[:n_labels]
        n_files = int(rng.randint(1, 9))
        metrics = SegmentBasedMetrics(event_label_list=labels,
                                      time_resolution=1.0)
        file_pairs = []
        for _ in range(n_files):
            ref = _random_events(rng, labels, int(rng.randint(1, 9)))
            # estimated list may be empty, may use labels outside the
            # evaluated set (ignored by both implementations)
            est = _random_events(rng, all_labels, int(rng.randint(0, 9)))
            metrics.evaluate(reference_event_list=ref,
                             estimated_event_list=est)
            file_pairs.append((ref, est))
        ov, cw = _brute_force_results(file_pairs, labels)
        _check_against_brute_force(metrics.results(), ov, cw, labels)


def test_official_evaluate_csv_path_matches_brute_force(tmp_path):
    """End-to-end through the CSV loaders and per-file grouping,
    including estimated events for files absent from the reference
    (ignored, as in ``utils/utilities.py:311-336``)."""
    from sed_jax import config as cfg
    rng = np.random.RandomState(7)
    labels = list(cfg.LABELS)
    files = [f'clip{i}.wav' for i in range(6)]
    ref_rows, est_rows, file_pairs = [], [], []
    for fn in files:
        ref = _random_events(rng, labels, int(rng.randint(1, 6)))
        est = _random_events(rng, labels, int(rng.randint(0, 6)))
        for e in ref:
            ref_rows.append(f"{fn},{e['onset']},{e['offset']},"
                            f"{e['event_label']}\n")
        for e in est:
            est_rows.append(f"{fn}\t{e['onset']}\t{e['offset']}\t"
                            f"{e['event_label']}\n")
        file_pairs.append((ref, est))
    # an estimated-only file: must not contribute
    est_rows.append(f"ghost.wav\t0.0\t5.0\t{labels[0]}\n")

    ref_csv = os.path.join(str(tmp_path), 'ref.csv')
    est_csv = os.path.join(str(tmp_path), 'est.tsv')
    with open(ref_csv, 'w') as f:
        f.writelines(ref_rows)
    with open(est_csv, 'w') as f:
        f.writelines(est_rows)

    results = official_evaluate(ref_csv, est_csv)
    ov, cw = _brute_force_results(file_pairs, labels)
    _check_against_brute_force(results, ov, cw, labels)
