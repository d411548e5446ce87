"""Hand-computed cases for the segment-based ER/F1 engine."""

import numpy as np

from sed_jax.eval.segment_metrics import (SegmentBasedMetrics,
                                          official_evaluate)

LABELS = ('A', 'B', 'C')


def ev(fname, onset, offset, label):
    return {'filename': fname, 'onset': onset, 'offset': offset,
            'event_label': label}


def test_perfect_match():
    m = SegmentBasedMetrics(LABELS, 1.0)
    ref = [ev('f', 0.0, 3.0, 'A'), ev('f', 1.0, 2.0, 'B')]
    m.evaluate(ref, list(ref))
    r = m.results()
    assert r['overall']['f_measure']['f_measure'] == 1.0
    assert r['overall']['error_rate']['error_rate'] == 0.0


def test_hand_computed_mixed_case():
    # timeline 0..4s, 4 segments
    ref = [ev('f', 0.0, 2.0, 'A'),   # segs 0,1
           ev('f', 2.0, 4.0, 'B')]   # segs 2,3
    est = [ev('f', 0.0, 1.0, 'A'),   # seg 0   -> TP
           ev('f', 1.0, 2.0, 'C'),   # seg 1   -> sub (ref A, est C)
           ev('f', 2.0, 3.0, 'B')]   # seg 2   -> TP; seg 3 deletion
    m = SegmentBasedMetrics(LABELS, 1.0).evaluate(ref, est)
    r = m.results()
    # Ntp=2, Nfp=1, Nfn=2, Nref=4, Nsys=3
    # S: seg1 min(1,1)-0=1; D: seg3 1; I: 0 -> ER=(1+1+0)/4=0.5
    assert np.isclose(r['overall']['error_rate']['error_rate'], 0.5)
    assert np.isclose(r['overall']['error_rate']['substitution_rate'], 0.25)
    assert np.isclose(r['overall']['error_rate']['deletion_rate'], 0.25)
    assert np.isclose(r['overall']['error_rate']['insertion_rate'], 0.0)
    p, q = 2 / 3, 2 / 4
    assert np.isclose(r['overall']['f_measure']['precision'], p)
    assert np.isclose(r['overall']['f_measure']['recall'], q)
    assert np.isclose(r['overall']['f_measure']['f_measure'],
                      2 * p * q / (p + q))


def test_segment_boundaries_floor_ceil():
    # onset 0.4 -> segment 0; offset 1.2 -> ceil -> covers segment 1 too
    ref = [ev('f', 0.4, 1.2, 'A')]
    est = [ev('f', 0.0, 2.0, 'A')]
    m = SegmentBasedMetrics(LABELS, 1.0).evaluate(ref, est)
    r = m.results()
    # ref active segs {0,1}; est {0,1} -> perfect
    assert r['overall']['f_measure']['f_measure'] == 1.0


def test_insertion_only():
    ref = [ev('f', 0.0, 1.0, 'A')]
    est = [ev('f', 0.0, 1.0, 'A'), ev('f', 0.0, 1.0, 'B')]
    r = SegmentBasedMetrics(LABELS, 1.0).evaluate(ref, est).results()
    assert np.isclose(r['overall']['error_rate']['insertion_rate'], 1.0)
    assert np.isclose(r['overall']['error_rate']['error_rate'], 1.0)


def test_multi_file_accumulation_matches_single():
    rng = np.random.RandomState(0)
    m1 = SegmentBasedMetrics(LABELS, 1.0)
    agg_ref, agg_est = [], []
    for f in range(5):
        ref = [ev(f'f{f}', float(rng.randint(0, 5)),
                  float(rng.randint(5, 10)), LABELS[rng.randint(3)])
               for _ in range(3)]
        est = [ev(f'f{f}', float(rng.randint(0, 5)),
                  float(rng.randint(5, 10)), LABELS[rng.randint(3)])
               for _ in range(3)]
        m1.evaluate(ref, est)
        agg_ref.append(ref)
        agg_est.append(est)
    # evaluating per file must equal re-running on a fresh accumulator
    m2 = SegmentBasedMetrics(LABELS, 1.0)
    for ref, est in zip(agg_ref, agg_est):
        m2.evaluate(ref, est)
    assert m1.results() == m2.results()


def test_official_evaluate_csv_roundtrip(tmp_path):
    refp = tmp_path / 'ref.csv'
    refp.write_text('x.wav,0.0,2.0,Applause\nx.wav,1.0,3.0,Siren\n')
    subp = tmp_path / 'sub.tsv'
    subp.write_text('x.wav\t0.0\t2.0\tApplause\nx.wav\t1.0\t3.0\tSiren\n')
    r = official_evaluate(str(refp), str(subp))
    assert r['overall']['f_measure']['f_measure'] == 1.0
    assert r['overall']['error_rate']['error_rate'] == 0.0
    assert r['class_wise']['Applause']['f_measure']['f_measure'] == 1.0
