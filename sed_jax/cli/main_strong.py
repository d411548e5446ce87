"""Joint weak+strong training and inference CLI.

Command-line parity with the reference driver
(``pytorch/main_strong.py:1314-1408``): subcommands ``train``,
``inference_prob``, ``inference_prob_overlap``, ``inference_prob_vote``.

The train loop is the reference's (``main_strong.py:40-413``) rebuilt
around one jitted train step that does both forwards + augmentation +
AMSGrad update on device; evaluation every 1000 iterations on the strong
validation and test splits; best checkpoint by validation framewise mAP
and error rate.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time

import numpy as np

from sed_jax.utils import compile_cache
from sed_jax import losses as losses_lib
from sed_jax.cli import common
from sed_jax.data import audio_io
from sed_jax.config import CLASSES_NUM, EVAL_SED_PARAMS, SedParams
from sed_jax.data.dataset import (AudiosetDataset, DataLoader, TestSampler,
                                  TrainSampler, cycle_iteration)
from sed_jax.eval.calculate_metrics import get_metric
from sed_jax.eval.evaluator import Evaluator
from sed_jax.eval import segment_metrics
import sed_jax.post.events as post_events
import sed_jax.post.merge as post_merge
from sed_jax.utils.logging_utils import count_parameters, create_logging
from sed_jax.utils.statistics import StatisticsContainer


def train(args):
    from sed_jax.parallel import distributed
    distributed.maybe_initialize()   # multi-host (DCN) when env asks

    import jax
    import jax.numpy as jnp
    from sed_jax.augment.functional import MixupGenerator
    from sed_jax.models.registry import get_model
    from sed_jax.parallel import mesh as mesh_lib
    from sed_jax.train.checkpoint import (restore_checkpoint,
                                          resume_checkpoint_path,
                                          save_best_checkpoint)
    from sed_jax.train.prefetch import device_prefetch
    from sed_jax.train.state import create_train_state
    from sed_jax.train.step import init_loss_scale, make_train_step

    train_wire = getattr(args, 'train_wire', 'int16')
    if train_wire != 'int16' and args.feature_type == 'gamma':
        # validate BEFORE creating any workspace directories
        raise SystemExit(
            "--train_wire: mu-law/qN wires compress raw AUDIO; "
            "feature_type='gamma' packs precomputed gammatone features "
            "as 'waveform' (data/hdf5_pack.py) — use the default int16")

    cfg, ws = common.resolve(args)
    mixup = 'mixup' in args.augmentation
    timeshift = 'timeshift' in args.augmentation
    spec_augment = 'specaugment' in args.augmentation

    create_logging(ws.logs_dir(create=True))
    logging.info(args)

    refs = common.reference_csv_paths(args)
    weak_h5 = common.hdf5_path(args, cfg, 'weak_training')
    strong_h5 = common.hdf5_path(args, cfg, 'strong_training')
    valid_h5 = common.hdf5_path(args, cfg, 'strong_validation')
    test_h5 = common.hdf5_path(args, cfg, 'testing')

    # train streams ship int16 waveforms (dequantized on device by the
    # jitted step — half the host->device bytes) and fetch with a worker
    # pool; --train_wire mulaw8/q6 compresses further (up to ~5.2x fewer
    # h2d bytes/step) at a small recorded accuracy cost; eval loaders
    # keep the float path
    train_dataset = AudiosetDataset(dequantize=False, wire=train_wire)
    dataset = AudiosetDataset()
    workers = getattr(args, 'num_workers', 2)
    # batch-size scheme, reproducing the reference expression INCLUDING
    # its conditional precedence (``main_strong.py:229-236``): with
    # mixup the weak stream draws (bs*3)*2; withOUT mixup the x3 weak
    # multiplier is dropped too (the reference's `(bs * 3) * 2 if
    # 'mixup' in augmentation else bs` parses that way)
    weak_bs = (args.batch_size * 3) * 2 if mixup else args.batch_size
    strong_bs = args.batch_size * 2 if mixup else args.batch_size
    # every process draws the same seeded global stream and loads only
    # its slice (no-op single-process)
    def _train_loader(h5, bs):
        sampler = distributed.HostShardedSampler(TrainSampler(h5, bs),
                                                 even_shares=mixup)
        return DataLoader(train_dataset, sampler, num_workers=workers)

    weak_iter = cycle_iteration(_train_loader(weak_h5, weak_bs))
    strong_iter = cycle_iteration(_train_loader(strong_h5, strong_bs))
    strong_iters = [strong_iter]
    if getattr(args, 'fsd50k', False):
        fsd_h5 = common.hdf5_path(args, cfg, 'strong_fsd50k')
        strong_iters.append(cycle_iteration(
            _train_loader(fsd_h5, strong_bs)))
    valid_loader = DataLoader(dataset, TestSampler(valid_h5,
                                                   args.batch_size))
    test_loader = DataLoader(dataset, TestSampler(test_h5, args.batch_size))

    compute_dtype = (jnp.bfloat16
                     if getattr(args, 'compute_dtype', 'f32') == 'bf16'
                     else None)
    model = get_model(args.model_type, cfg, feature_type=args.feature_type,
                      compute_dtype=compute_dtype)
    # data-parallel width: the largest device count dividing every batch
    # stream (batch axes must split evenly over the mesh)
    import math
    g = math.gcd(weak_bs, strong_bs)
    n_mesh = min(jax.device_count(), g)
    while n_mesh > 1 and g % n_mesh:
        n_mesh -= 1
    mesh = mesh_lib.make_mesh(n_mesh) if n_mesh > 1 else None
    if mesh is not None:
        logging.info('data-parallel mesh over %d devices', n_mesh)

    example = common.init_example(args, cfg)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(example),
                               learning_rate=args.learning_rate)
    count_parameters(state.params)   # utilities.py:17-27 table
    ckpt_dir = ws.checkpoint_path(args.feature_type, cfg.name, create=True)
    iteration = 0
    if args.resume_iteration > 0:
        # restore the checkpoint saved at exactly this iteration
        # (``pytorch/main_strong.py:205-213``)
        resume_path = resume_checkpoint_path(ckpt_dir,
                                             args.resume_iteration)
        state = restore_checkpoint(resume_path, state)
        iteration = int(state.step)
        logging.info('resumed from %s at iteration %d', resume_path,
                     iteration)
    if mesh is not None:
        state = jax.device_put(state, mesh_lib.replicated_sharding(mesh))

    # bf16 training gets dynamic loss scaling with nonfinite-step skip
    # (Cnn_9layers_Transformer_FrameAtt has diverged within 30 plain
    # bf16 steps, tests/test_train_extra.py)
    use_loss_scale = compute_dtype is not None
    step_fn = make_train_step(
        model, losses_lib.get_loss_func(args.loss_type),
        losses_lib.get_loss_func('frame_bce'),
        mixup=mixup, timeshift=timeshift, spec_augment=spec_augment,
        mesh=mesh, loss_scale='dynamic' if use_loss_scale else None,
        wire_samples=cfg.audio_samples)
    scale_state = init_loss_scale() if use_loss_scale else None

    evaluator = Evaluator(model, EVAL_SED_PARAMS,
                          batch_size=args.batch_size)
    statistics_container = StatisticsContainer(
        ws.statistics_path(args.feature_type, cfg.name, create=True))
    if args.resume_iteration > 0 and os.path.isfile(
            statistics_container.statistics_path):
        # drop eval statistics recorded past the resume point
        # (``utils/utilities.py:358-371``)
        statistics_container.load_state_dict(args.resume_iteration)
    submission = ws.submission_path(create=True)
    mixup_gen = MixupGenerator(mixup_alpha=1.0)

    def _assemble_batches():
        # runs in the prefetch thread: draw, pair mixup lambdas, strip
        # host-only fields — order matters for the lambda RNG stream
        while True:
            weak_batch = next(weak_iter)
            strong_batches = [next(it) for it in strong_iters]
            if mixup:
                # every process draws the same GLOBAL lambda stream and
                # keeps its slice, so mixup pairing is consistent across
                # hosts
                pc, pi = jax.process_count(), jax.process_index()

                def _local_lambda(n_local):
                    lam = mixup_gen.get_lambda(
                        n_local * pc).astype(np.float32)
                    return lam[pi * n_local:(pi + 1) * n_local]

                weak_batch['mixup_lambda'] = _local_lambda(
                    len(weak_batch['waveform']))
                for b in strong_batches:
                    b['mixup_lambda'] = _local_lambda(len(b['waveform']))
            for b in (weak_batch, *strong_batches):
                b.pop('audio_name', None)
            weak_batch.pop('strong_target', None)
            yield weak_batch, strong_batches

    if mesh is not None:
        _put = lambda t: (  # noqa: E731
            mesh_lib.shard_batch(t[0], mesh),
            [mesh_lib.shard_batch(b, mesh) for b in t[1]])
    else:
        _put = jax.device_put
    # upload batch k+1 while the jitted step runs batch k (device_put
    # may block its thread but releases the GIL)
    batch_iter = device_prefetch(_assemble_batches(), size=2, put=_put)

    best_er, best_map, best_iteration = 10000.0, 0.0, 0
    rng = jax.random.PRNGKey(1234)
    train_bgn_time = time.time()

    while iteration != args.stop_iteration:
        if (iteration % args.eval_interval == 0
                and iteration > args.resume_iteration):
            logging.info('------------------------------------')
            logging.info('Iteration: %d', iteration)
            train_fin_time = time.time()
            params, batch_stats = state.params, state.batch_stats
            if jax.process_count() > 1:
                # params are replicated, so every host holds full copies;
                # evaluate host-locally (identical results everywhere)
                params = jax.tree.map(np.asarray, params)
                batch_stats = jax.tree.map(np.asarray, batch_stats)
            for data_type, loader, ref_csv in [
                    ('valid', valid_loader, refs['valid']),
                    ('test', test_loader, refs['test'])]:
                statistics, _ = evaluator.evaluate(
                    params, batch_stats, loader, ref_csv, submission,
                    cfg.frames_per_second)
                logging.info('%s statistics:', data_type)
                logging.info('    Clipwise mAP: %.3f',
                             np.nanmean(statistics['clipwise_ap']))
                logging.info('    Framewise mAP: %.3f',
                             np.nanmean(statistics['framewise_ap']))
                logging.info(
                    '    %s',
                    statistics['sed_metrics']['overall']['error_rate'])
                statistics_container.append(data_type, iteration,
                                            statistics)
                if data_type == 'valid':
                    fmap = np.nanmean(statistics['framewise_ap'])
                    er = statistics['sed_metrics']['overall'][
                        'error_rate']['error_rate']
                    if fmap >= best_map and er < best_er:
                        best_map, best_er, best_iteration = \
                            fmap, er, iteration
                        saved = save_best_checkpoint(ckpt_dir, state)
                        logging.info('Model saved to %s for iteration %d',
                                     saved, iteration)
            statistics_container.dump()
            logging.info('Train time: %.3f s, validate time: %.3f s',
                         train_fin_time - train_bgn_time,
                         time.time() - train_fin_time)
            train_bgn_time = time.time()

        weak_batch, strong_batches = next(batch_iter)

        rng, step_rng = jax.random.split(rng)
        if use_loss_scale:
            state, metrics, scale_state = step_fn(
                state, weak_batch, strong_batches, step_rng, scale_state)
        else:
            state, metrics = step_fn(state, weak_batch, strong_batches,
                                     step_rng)
        if iteration % 100 == 0:
            logging.info(
                '%d iteration - weak: %.4f, strong: %.4f, total: %.4f%s',
                iteration, float(metrics['weak_loss']),
                float(metrics['strong_loss']), float(metrics['loss']),
                ('' if not use_loss_scale else
                 ' (scale %.0f, finite %s)' % (
                     float(metrics['loss_scale']),
                     bool(metrics['grads_finite']))))

        iteration += 1
        if iteration == args.stop_iteration:
            logging.info('    Best iteration: %d', best_iteration)
            break


def inference_prob(args):
    """Batch test-set inference + metrics (``main_strong.py:416-593``)."""
    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    model, variables = common.build_model_and_variables(args, cfg, ws)
    sed_params = common.load_sed_params(args, cfg, ws, EVAL_SED_PARAMS)

    dataset = AudiosetDataset()
    test_loader = DataLoader(
        dataset, TestSampler(common.hdf5_path(args, cfg, 'testing'),
                             args.batch_size))
    evaluator = Evaluator(model, sed_params, batch_size=args.batch_size)
    submission = ws.submission_path(create=True)

    t0 = time.time()
    statistics, output_dict = evaluator.evaluate(
        variables['params'], variables.get('batch_stats'), test_loader,
        refs['test'], submission, cfg.frames_per_second)
    results = statistics['sed_metrics']
    print('Processing time: {} s\n'.format(time.time() - t0))
    print('Micro precision: {:.3f}'.format(get_metric(results, 'precision')))
    print('Micro recall: {:.3f}'.format(get_metric(results, 'recall')))
    print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
    print('Micro ER: {:.3f}'.format(get_metric(results, 'er')))

    # cache predictions for offline threshold optimization
    # (``main_strong.py:571-577``)
    pred_path = ws.predictions_path(
        f'test_predictions_{args.feature_type}_{cfg.name}.pkl', create=True)
    with open(pred_path, 'wb') as f:
        pickle.dump(output_dict, f)
    return statistics


PARAM_COMBINATIONS = [[0.5, 6], [0.5, 7], [1, 5], [1, 6], [1, 7]]


def _overlap_engine(args, cfg, model, variables, sed_params,
                    overlap_value, sample_duration):
    from sed_jax.serve.engine import SedInferenceEngine
    return SedInferenceEngine(
        model, variables, cfg, sample_duration=sample_duration,
        overlap=True, overlap_value=overlap_value, sed_params=sed_params,
        batch_size=args.batch_size)


def _test_clip_waveforms(args, cfg):
    """Yield (audio_name, 10 s waveform) for every test clip from the
    packed HDF5 (the reference re-decodes wavs from disk,
    ``main_strong.py:787-790``; the packed waveforms are identical)."""
    import h5py
    from sed_jax.data.hdf5_pack import int16_to_float32
    with h5py.File(common.hdf5_path(args, cfg, 'testing'), 'r') as hf:
        for i in range(len(hf['audio_name'])):
            yield (hf['audio_name'][i].decode(),
                   int16_to_float32(hf['waveform'][i]))


def inference_prob_overlap(args):
    """Sliding-window inference with framewise averaging over the
    [overlap_value, window] grid (``main_strong.py:596-857``)."""
    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    model, variables = common.build_model_and_variables(args, cfg, ws)
    sed_params = common.load_sed_params(args, cfg, ws, EVAL_SED_PARAMS)
    submission = ws.submission_path(create=True)

    all_results = {}
    for overlap_value, sample_duration in PARAM_COMBINATIONS:
        engine = _overlap_engine(args, cfg, model, variables, sed_params,
                                 overlap_value, sample_duration)
        t0 = time.time()
        pairs = list(_test_clip_waveforms(args, cfg))
        names = [n for n, _ in pairs]
        wavs = audio_io.stack_rows(a for _, a in pairs)
        # fully on-device: window slicing, forward, overlap-add merge,
        # coverage normalization, packed-mask gathers
        per_clip = engine.predict_clips_windowed(
            wavs, names, duration=10.0, step=overlap_value)
        full_event_list = [e for evs in per_clip for e in evs]
        print('Processing time for {}: {} s'.format(
            [overlap_value, sample_duration], time.time() - t0))
        post_events.write_submission(full_event_list, submission)
        results = segment_metrics.official_evaluate(refs['test'],
                                                    submission)
        print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
        print('Micro ER: {:.3f} \n'.format(get_metric(results, 'er')))
        all_results[(overlap_value, sample_duration)] = results
    return all_results


def inference_prob_vote(args):
    """Sliding-window inference with per-window binarization + voting
    (``main_strong.py:885-1122``)."""
    cfg, ws = common.resolve(args)
    refs = common.reference_csv_paths(args)
    model, variables = common.build_model_and_variables(args, cfg, ws)
    sed_params = common.load_sed_params(args, cfg, ws, EVAL_SED_PARAMS)
    p = (sed_params.per_class(CLASSES_NUM)
         if isinstance(sed_params, SedParams) else sed_params)
    submission = ws.submission_path(create=True)

    all_results = {}
    for overlap_value, sample_duration in PARAM_COMBINATIONS:
        engine = _overlap_engine(args, cfg, model, variables, sed_params,
                                 overlap_value, sample_duration)
        t0 = time.time()
        full_event_list = []
        thr = np.asarray(p['sed_high_threshold'])
        for audio_name, audio in _test_clip_waveforms(args, cfg):
            duration = 10.0
            from sed_jax.serve.engine import window_starts
            starts = window_starts(duration, sample_duration, True,
                                   overlap_value)
            sr = cfg.sample_rate
            from sed_jax.data.audio_io import pad_truncate
            windows = np.stack([
                pad_truncate(
                    audio[int(s * sr):int(s * sr) + engine.window_samples],
                    engine.window_samples)
                for s in starts])
            framewise, _ = engine.infer_framewise(windows)
            # binarize each window against the high threshold then
            # overlap-add vote counts (``main_strong.py:870-883``)
            binary = (framewise > thr[None, None, :]).astype(np.float64)
            votes = post_merge.overlap_add_windows(
                binary, sample_duration, overlap_value, normalize=False)
            full_event_list.extend(
                post_events.frame_binary_prediction_to_event_prediction(
                    votes, overlap_value, sample_duration, audio_name,
                    sed_params, cfg.frames_per_second))
        print('Processing time for {}: {} s'.format(
            [overlap_value, sample_duration], time.time() - t0))
        post_events.write_submission(full_event_list, submission)
        results = segment_metrics.official_evaluate(refs['test'],
                                                    submission)
        print('Micro F1: {:.3f}'.format(get_metric(results, 'f1')))
        print('Micro ER: {:.3f} \n'.format(get_metric(results, 'er')))
        all_results[(overlap_value, sample_duration)] = results
    return all_results


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='sed_jax main_strong')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    for mode in ('train', 'inference_prob', 'inference_prob_overlap',
                 'inference_prob_vote'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub)
        if mode == 'train':
            sub.add_argument('--learning_rate', type=float, default=1e-3)
            sub.add_argument('--stop_iteration', type=int, default=50000)
            sub.add_argument('--resume_iteration', type=int, default=0)
            sub.add_argument('--eval_interval', type=int, default=1000)
            sub.add_argument('--fsd50k', action='store_true',
                             default=False)
            sub.add_argument('--compute_dtype', type=str, default='f32',
                             choices=['f32', 'bf16'],
                             help='conv-stack computation dtype; bf16 '
                                  'enables dynamic loss scaling with '
                                  'nonfinite-step skipping')
            sub.add_argument('--num_workers', type=int, default=2,
                             help='data-loader fetch threads (the '
                                  'reference uses 8 torch workers)')
            sub.add_argument('--train_wire', type=str, default='int16',
                             choices=['int16', 'mulaw8', 'q6', 'q5',
                                      'q4', 'adpcm4'],
                             help='waveform wire format for train '
                                  'batches, dequantized on device: '
                                  'int16 (exact, default), mulaw8 '
                                  '(2x fewer h2d bytes), q6/q5/q4 '
                                  'block-scaled (~5.2-7.8x fewer), '
                                  'adpcm4 IMA ADPCM (~3.9x fewer, '
                                  'q4-grade on noisy/tonal audio)')
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    compile_cache.enable()
    if args.mode == 'train':
        train(args)
    elif args.mode == 'inference_prob':
        inference_prob(args)
    elif args.mode == 'inference_prob_overlap':
        inference_prob_overlap(args)
    elif args.mode == 'inference_prob_vote':
        inference_prob_vote(args)


if __name__ == '__main__':
    main()
