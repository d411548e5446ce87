"""Measure per-wire segment-based ER/F1 vs the int16 decode and write
the wire admission table (tools/wire_admission.json).

The contract (BASELINE.json) couples throughput to "ER/F1 within 0.5% of
the reference", where the reference metric is SEGMENT-BASED ER/F1 at
1.0 s resolution (the reference's ``utils/utilities.py:294-340`` via
sed_eval; reimplemented in sed_jax/eval/segment_metrics.py).  This tool
measures that metric per wire, on >= 256 hardened-corpus clips against
ground truth, and admits a wire only when BOTH |delta ER| and |delta
F1| vs the int16 decode are <= 0.005.

The corpus seed differs from the other checks' (same distribution,
different draw) so admission is a property of the wire on the
distribution, not of one specific corpus instance.

Usage:
  python tools/wire_admission.py [--clips 256] [--wires q6,q5,...]
                                 [--out tools/wire_admission.json]

Runs on whatever backend jax selects (the device decode paths are
backend-agnostic) and records it.  Writes the JSON table and prints one
line per wire.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TOOLS = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(TOOLS, 'wire_admission.json')
CKPT = os.path.join(TOOLS, 'bench_checkpoint.npz')

# |delta| bound vs the int16 decode, both ER and F1 (the BASELINE.json
# "within 0.5%" contract, read as absolute rate points)
TOLERANCE = 0.005

# the corpus draw used for admission: the bench corpus distribution
# (bench_corpus.make_clips) at a seed no other check uses
SEED = 20260820

DEFAULT_WIRES = 'q6,v6,q5,q4,q3,q2,adpcm4,adpcm3,adpcm2,mulaw8'


def evaluate_events(truth, predicted, labels):
    """Segment-based overall ER and F1 of predicted vs truth
    (per-clip event lists)."""
    from sed_jax.eval.segment_metrics import SegmentBasedMetrics
    m = SegmentBasedMetrics(event_label_list=labels, time_resolution=1.0)
    for ref, est in zip(truth, predicted):
        m.evaluate(ref, est)
    r = m.results()
    return (float(r['overall']['error_rate']['error_rate']),
            float(r['overall']['f_measure']['f_measure']))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--clips', type=int, default=256)
    ap.add_argument('--wires', default=DEFAULT_WIRES)
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--ckpt', default=CKPT)
    ap.add_argument('--batch_size', type=int, default=64)
    ap.add_argument('--seed', type=int, default=SEED)
    ap.add_argument('--merge', action='store_true',
                    help='update only the measured wires in an existing '
                         'table (same corpus seed/clips required) '
                         'instead of rewriting it — lets a new wire be '
                         'admitted without re-running every old one')
    args = ap.parse_args(argv)

    import jax
    from sed_jax.utils import compile_cache
    compile_cache.enable()

    from bench_corpus import make_clips
    from sed_jax.config import AUDIO_16K, LABELS, PREDICT_SED_PARAMS
    from sed_jax.data import audio_io
    from sed_jax.models.registry import get_model
    from sed_jax.serve.engine import SedInferenceEngine
    from sed_jax.utils.npz_ckpt import load_variables_npz

    cfg = AUDIO_16K
    sr = cfg.sample_rate
    if not os.path.isfile(args.ckpt):
        sys.exit(f'missing trained checkpoint {args.ckpt} — run '
                 'tools/make_bench_checkpoint.py first')

    clips, truth = make_clips(args.clips, sr, seconds=5, seed=args.seed,
                              return_events=True)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)

    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    engine = SedInferenceEngine(model, load_variables_npz(args.ckpt),
                                cfg, sample_duration=5, overlap=True,
                                sed_params=PREDICT_SED_PARAMS,
                                batch_size=args.batch_size)

    def predict(buf):
        return engine.predict_clips(buf)[0]

    def encode(wire):
        """-> (engine payload, bytes/clip).  v6 is ragged: a per-clip
        payload list for predict_rows_resident."""
        if wire == 'v6':
            rows = [audio_io.v6_encode_clip(pcm[i])
                    for i in range(pcm.shape[0])]
            return rows, float(np.mean([r.nbytes for r in rows]))
        if wire.startswith('q') and wire[1:].isdigit():
            buf = audio_io.qn_encode(pcm, int(wire[1:]))
        elif wire == 'adpcm4':
            buf = audio_io.adpcm_encode(pcm)
        elif wire in ('adpcm3', 'adpcm2'):
            buf = audio_io.adpcm_n_encode(pcm, int(wire[5]))
        elif wire == 'mulaw8':
            buf = audio_io.mulaw_encode(pcm)
        else:
            raise SystemExit(f'unknown wire {wire}')
        return buf, float(buf.shape[1])

    base_events = predict(pcm)
    er0, f10 = evaluate_events(truth, base_events, LABELS)
    print(f'int16: ER {er0:.4f}  F1 {f10:.4f}  '
          f'({sum(len(e) for e in base_events)} events, '
          f'{sum(len(t) for t in truth)} true)', flush=True)

    table = {}
    for wire in [w for w in args.wires.split(',') if w]:
        payload, bpc = encode(wire)
        if wire == 'v6':
            events = engine.predict_rows_resident(payload)[0]
        else:
            events = predict(payload)
        er, f1 = evaluate_events(truth, events, LABELS)
        d_er, d_f1 = abs(er - er0), abs(f1 - f10)
        admitted = bool(d_er <= TOLERANCE and d_f1 <= TOLERANCE)
        table[wire] = {'er': round(er, 4), 'f1': round(f1, 4),
                       'd_er': round(d_er, 4), 'd_f1': round(d_f1, 4),
                       'bytes_per_clip': round(bpc, 1),
                       'admitted': admitted}
        print(f'{wire}: ER {er:.4f} (d {d_er:+.4f})  F1 {f1:.4f} '
              f'(d {d_f1:+.4f})  {bpc:.0f} B/clip  admitted={admitted}',
              flush=True)

    if args.merge and os.path.isfile(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        assert prev['meta']['clips'] == args.clips \
            and prev['meta']['seed'] == args.seed, (
                'merge requires the same corpus (clips/seed) as the '
                'existing table', prev['meta'])
        merged = dict(prev['wires'])
        merged.update(table)
        table = merged

    out = {
        'meta': {'clips': args.clips, 'seed': args.seed,
                 'tolerance': TOLERANCE, 'ckpt': os.path.basename(
                     args.ckpt),
                 'metric': 'segment-based overall ER/F1 @1.0s '
                           '(sed_jax.eval.segment_metrics) vs ground '
                           'truth; deltas vs the int16 decode',
                 'backend': jax.devices()[0].platform},
        'int16': {'er': round(er0, 4), 'f1': round(f10, 4),
                  'admitted': True},
        'wires': table,
    }
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write('\n')
    print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
