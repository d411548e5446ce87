"""Threshold-optimization CLI (``utils/optimize_thresholds.py:290-551``).

``optimize_sed_thresholds``: run validation inference once, cache the
prediction pickle, then optimize the 75-dim threshold vector against the
official segment-based F1 and dump ``best_{feat}_{quality}.sed.valid.pkl``.
"""

from __future__ import annotations

import argparse
import os
import pickle

from sed_jax.utils import compile_cache
from sed_jax.cli import common
from sed_jax.config import CLASSES_NUM, EVAL_SED_PARAMS
from sed_jax.data.dataset import AudiosetDataset, DataLoader, TestSampler
from sed_jax.eval.evaluator import Evaluator
from sed_jax.thresholds.optimizer import (HyperParamsOptimizer,
                                          SoundEventDetectionScoreCalculator)


def optimize_sed_thresholds(args):
    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    model, variables = common.build_model_and_variables(args, cfg, ws)

    pred_path = ws.predictions_path(
        f'valid_predictions_{args.feature_type}_{cfg.name}.pkl',
        create=True)
    submission = ws.submission_path(create=True)

    if not os.path.isfile(pred_path) or args.refresh_predictions:
        dataset = AudiosetDataset()
        valid_loader = DataLoader(
            dataset,
            TestSampler(common.hdf5_path(args, cfg, 'strong_validation'),
                        args.batch_size))
        evaluator = Evaluator(model, EVAL_SED_PARAMS,
                              batch_size=args.batch_size)
        _, output_dict = evaluator.evaluate(
            variables['params'], variables.get('batch_stats'),
            valid_loader, refs['valid'], submission,
            cfg.frames_per_second)
        with open(pred_path, 'wb') as f:
            pickle.dump(output_dict, f)
        print('cached validation predictions to', pred_path)

    score_calculator = SoundEventDetectionScoreCalculator(
        prediction_path=pred_path, reference_csv_path=refs['valid'],
        submission_path=submission, classes_num=CLASSES_NUM,
        frames_per_second=cfg.frames_per_second)

    # init {tag .5, high .3, low .1} (``optimize_thresholds.py:483-486``)
    init_params = ([0.5] * CLASSES_NUM + [0.3] * CLASSES_NUM
                   + [0.1] * CLASSES_NUM)
    opt = HyperParamsOptimizer(score_calculator,
                               learning_rate=args.learning_rate,
                               epochs=args.epochs, step=0.02, max_search=5)
    score, params, record = opt.do_optimize(init_params)

    out_path = ws.sed_thresholds_path(args.feature_type, cfg.name,
                                      create=True)
    with open(out_path, 'wb') as f:
        pickle.dump(score_calculator.params_list_to_params_dict(params), f)
    with open(out_path + '.record', 'wb') as f:
        pickle.dump(record, f)
    print('Saved optimized thresholds (F1 {:.4f}) to {}'.format(
        score, out_path))
    return score, params


def optimize_at_thresholds(args):
    """Audio-tagging (clipwise) threshold optimization
    (``utils/optimize_thresholds.py:210-287``): optimize 25 clipwise
    thresholds against micro F1 of the cached test predictions."""
    from sed_jax.thresholds.optimizer import AudioTaggingScoreCalculator

    cfg, ws = common.resolve(args)
    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl')
    if not os.path.isfile(pred_path):
        raise SystemExit(
            f'no cached predictions at {pred_path}; run '
            'main_strong inference_prob first')
    score_calculator = AudioTaggingScoreCalculator(pred_path)
    opt = HyperParamsOptimizer(score_calculator,
                               learning_rate=args.learning_rate,
                               epochs=args.epochs, step=0.02, max_search=5)
    score, params, record = opt.do_optimize([0.3] * CLASSES_NUM)
    out_path = os.path.join(
        ws.dir('opt_thresholds', create=True),
        f'best_{args.feature_type}_{cfg.name}.at.pkl')
    with open(out_path, 'wb') as f:
        pickle.dump({'audio_tagging_threshold': list(params)}, f)
    print('Saved optimized AT thresholds (F1 {:.4f}) to {}'.format(
        score, out_path))
    return score, params


def get_parser():
    parser = argparse.ArgumentParser(description='sed_jax threshold opt')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    for mode in ('optimize_sed_thresholds', 'optimize_at_thresholds'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub)
        sub.add_argument('--learning_rate', type=float, default=1e-2)
        sub.add_argument('--epochs', type=int, default=70)
        sub.add_argument('--refresh_predictions', action='store_true',
                         default=False)
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    compile_cache.enable()
    if args.mode == 'optimize_sed_thresholds':
        optimize_sed_thresholds(args)
    else:
        optimize_at_thresholds(args)


if __name__ == '__main__':
    main()
