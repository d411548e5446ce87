"""Weakly-supervised training CLI (``pytorch/main.py:30-278``).

The reference's weak-only path is bit-rotted (it imports a dataset class
that no longer exists, ``main.py:25``); this driver is the working
equivalent: a single weak stream, clip-BCE loss, eval every 1000
iterations on the testing split, best checkpoint by clipwise mAP.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np

from sed_jax.utils import compile_cache
from sed_jax import losses as losses_lib
from sed_jax.cli import common
from sed_jax.config import EVAL_SED_PARAMS
from sed_jax.data.dataset import (AudiosetDataset, DataLoader, TestSampler,
                                  TrainSampler, cycle_iteration)
from sed_jax.eval.evaluator import Evaluator
from sed_jax.utils.logging_utils import create_logging
from sed_jax.utils.statistics import StatisticsContainer


def train(args):
    import jax
    import jax.numpy as jnp
    from sed_jax.augment.functional import MixupGenerator
    from sed_jax.models.registry import get_model
    from sed_jax.train.checkpoint import save_best_checkpoint
    from sed_jax.train.state import create_train_state
    from sed_jax.augment import functional as aug

    cfg, ws = common.resolve(args)
    mixup = 'mixup' in args.augmentation
    timeshift = 'timeshift' in args.augmentation
    spec_augment = 'specaugment' in args.augmentation
    create_logging(ws.logs_dir(create=True))
    logging.info(args)

    refs = common.reference_csv_paths(args)
    train_h5 = common.hdf5_path(args, cfg, 'training')
    test_h5 = common.hdf5_path(args, cfg, 'testing')
    dataset = AudiosetDataset()
    train_bs = args.batch_size * 2 if mixup else args.batch_size
    train_iter = cycle_iteration(
        DataLoader(dataset, TrainSampler(train_h5, train_bs)))
    test_loader = DataLoader(dataset, TestSampler(test_h5,
                                                  args.batch_size))

    model = get_model(args.model_type, cfg, feature_type=args.feature_type)
    state = create_train_state(
        model, jax.random.PRNGKey(0),
        jnp.asarray(common.init_example(args, cfg)),
        learning_rate=args.learning_rate)

    loss_func = losses_lib.get_loss_func(args.loss_type)

    def loss_fn(params, batch_stats, batch, rng):
        variables = {'params': params}
        if batch_stats is not None:
            variables['batch_stats'] = batch_stats
        k1, k2 = jax.random.split(rng)
        lam = batch.get('mixup_lambda')
        out, mutated = model.apply(
            variables, batch['waveform'], train=True, mixup_lambda=lam,
            timeshift=timeshift, spec_augment=spec_augment,
            rngs={'dropout': k1, 'augment': k2}, mutable=['batch_stats'])
        target = batch['target']
        if lam is not None:
            target = aug.do_mixup(target, lam)
        return loss_func(out, {'target': target}), \
            mutated.get('batch_stats')

    @jax.jit
    def step_fn(state, batch, rng):
        (loss, batch_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, state.batch_stats, batch,
                                   rng)
        state = state.apply_gradients(grads=grads)
        return state.replace(batch_stats=batch_stats), loss

    evaluator = Evaluator(model, EVAL_SED_PARAMS,
                          batch_size=args.batch_size)
    statistics_container = StatisticsContainer(
        ws.statistics_path(args.feature_type, cfg.name, create=True))
    submission = ws.submission_path(create=True)
    ckpt_dir = ws.checkpoint_path(args.feature_type, cfg.name, create=True)
    mixup_gen = MixupGenerator(mixup_alpha=1.0)

    best_map, iteration = 0.0, 0
    rng = jax.random.PRNGKey(1234)
    while iteration != args.stop_iteration:
        if iteration % args.eval_interval == 0 and iteration > 0:
            logging.info('Iteration: %d', iteration)
            statistics, _ = evaluator.evaluate(
                state.params, state.batch_stats, test_loader,
                refs['test'], submission, cfg.frames_per_second)
            cmap = np.nanmean(statistics['clipwise_ap'])
            logging.info('    Clipwise mAP: %.3f', cmap)
            statistics_container.append('test', iteration, statistics)
            statistics_container.dump()
            if cmap >= best_map:
                best_map = cmap
                saved = save_best_checkpoint(ckpt_dir, state)
                logging.info('Model saved to %s', saved)

        batch = next(train_iter)
        batch.pop('audio_name', None)
        batch.pop('strong_target', None)
        if mixup:
            batch['mixup_lambda'] = mixup_gen.get_lambda(
                len(batch['waveform'])).astype(np.float32)
        rng, step_rng = jax.random.split(rng)
        state, loss = step_fn(state, batch, step_rng)
        if iteration % 100 == 0:
            logging.info('%d iteration - loss: %.4f', iteration,
                         float(loss))
        iteration += 1


def inference_prob(args):
    """Test-set inference + metrics + prediction-pickle dump for the
    weak driver (``pytorch/main.py:281-380``): evaluate the saved best
    checkpoint on the testing split and cache the output dict."""
    import pickle
    from sed_jax.cli import common as c
    from sed_jax.eval.calculate_metrics import get_metric

    cfg, ws = c.resolve(args)
    refs = c.reference_csv_paths(args)
    model, variables = c.build_model_and_variables(args, cfg, ws)
    dataset = AudiosetDataset()
    test_loader = DataLoader(
        dataset, TestSampler(c.hdf5_path(args, cfg, 'testing'),
                             args.batch_size))
    evaluator = Evaluator(model, EVAL_SED_PARAMS,
                          batch_size=args.batch_size)
    submission = ws.submission_path(create=True)
    t0 = time.time()
    statistics, output_dict = evaluator.evaluate(
        variables['params'], variables.get('batch_stats'), test_loader,
        refs['test'], submission, cfg.frames_per_second)
    results = statistics['sed_metrics']
    print('Processing time: {} s\n'.format(time.time() - t0))
    print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
    print('Micro ER: {:.3f}'.format(get_metric(results, 'er')))
    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl',
        create=True)
    with open(pred_path, 'wb') as f:
        pickle.dump(output_dict, f)
    print('Write out to {}'.format(pred_path))
    return statistics


def get_parser():
    parser = argparse.ArgumentParser(description='sed_jax main (weak)')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    sub = subparsers.add_parser('train')
    common.add_common_args(sub)
    sub.add_argument('--learning_rate', type=float, default=1e-3)
    sub.add_argument('--stop_iteration', type=int, default=50000)
    # the reference evaluates every 1000 iterations (``main.py:208``);
    # configurable here so smoke tests can exercise the eval path
    sub.add_argument('--eval_interval', type=int, default=1000)
    sub_ip = subparsers.add_parser('inference_prob')
    common.add_common_args(sub_ip)
    sub_ip.add_argument('--iteration', type=int, default=None,
                        help='reference-compat no-op: the weak driver '
                             'saves a single best checkpoint')
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    compile_cache.enable()
    if args.mode == 'inference_prob':
        return inference_prob(args)
    train(args)


if __name__ == '__main__':
    main()
