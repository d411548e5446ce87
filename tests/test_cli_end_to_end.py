"""End-to-end CLI integration: pack -> train -> eval -> thresholds ->
predict, on a tiny synthetic dataset (the ``--mini_data`` smoke path of
the reference, done properly as an automated test)."""

import json
import os
import pickle

import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, LABELS
from sed_jax.data import audio_io
from sed_jax.cli import features as features_cli
from sed_jax.cli import main_strong as main_strong_cli
from sed_jax.cli import optimize_thresholds as opt_cli
from sed_jax.cli import predict as predict_cli

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

CFG = AUDIO_16K
N = 6


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    """Synthetic AudioSet-like dataset with weak + strong labels."""
    root = tmp_path_factory.mktemp('dataset')
    rng = np.random.RandomState(0)
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)

    weak_rows = {s: [] for s in ('weak_training', 'strong_training',
                                 'strong_validation')}
    test_rows = []
    strong_rows = {s: [] for s in ('strong_training', 'strong_validation')}
    test_strong_rows = []

    for split in ('weak_training', 'strong_training', 'strong_validation',
                  'testing'):
        d = root / split
        d.mkdir()
        for i in range(N):
            ytid = f'{split}{i}'
            name = f'{ytid}_0.wav'
            label = LABELS[i % 4]
            audio = rng.uniform(-0.3, 0.3, CFG.sample_rate * 10)
            audio_io.save_wav(str(d / name), audio, CFG.sample_rate)
            if split == 'testing':
                test_rows.append(f'{ytid},0.000,10.000,{label},/m/x\n')
                test_strong_rows.append(f'{name},1.0,4.0,{label}\n')
            else:
                weak_rows[split].append(
                    f'{ytid},0.000,10.000,{label},/m/x\n')
                if split in strong_rows:
                    strong_rows[split].append(f'{name},1.0,4.0,{label}\n')

    for split, rows in weak_rows.items():
        (meta / 'strong' / f'{split}_set.csv').write_text(''.join(rows))
    (meta / 'testing_set.csv').write_text(''.join(test_rows))
    (meta / 'groundtruth_strong_label_testing_set.csv').write_text(
        ''.join(test_strong_rows))
    for split, rows in strong_rows.items():
        (meta / 'strong' /
         f'groundtruth_strong_label_{split}_set.csv').write_text(
            ''.join(rows))
    return str(root)


@pytest.fixture(scope='module')
def workspace(tmp_path_factory):
    return str(tmp_path_factory.mktemp('workspace'))


COMMON = ['--holdout_fold', '1', '--model_type', 'Cnn_9layers_FrameAvg',
          '--loss_type', 'clip_bce', '--augmentation',
          'specaugment_timeshift_mixup', '--batch_size', '2',
          '--feature_type', 'logmel', '--audio_16k']


def test_01_pack_all_splits(dataset_dir, workspace):
    for split in ('weak_training', 'strong_training', 'strong_validation',
                  'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', dataset_dir,
                           '--workspace', workspace,
                           '--data_type', split, '--audio_16k'])
    h5s = os.listdir(os.path.join(workspace, 'hdf5s'))
    assert sorted(h5s) == sorted([
        'weak_training_logmel_16k.h5', 'strong_training_logmel_16k.h5',
        'strong_validation_logmel_16k.h5', 'testing_logmel_16k.h5'])


def test_02_train_saves_best_checkpoint(dataset_dir, workspace):
    main_strong_cli.main(['train', '--dataset_dir', dataset_dir,
                          '--workspace', workspace, *COMMON,
                          '--learning_rate', '1e-3',
                          '--stop_iteration', '3',
                          '--eval_interval', '2'])
    ckpt = os.path.join(
        workspace, 'checkpoints', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=specaugment_timeshift_mixup', 'batch_size=2',
        'best_logmel_16k')
    assert os.path.isdir(ckpt), 'best checkpoint not saved'


def test_02b_resume_at_iteration(dataset_dir, workspace):
    """Resume training from the checkpoint saved at exactly iteration 2
    (``pytorch/main_strong.py:205-213``) and extend the lineage."""
    ckpt_dir = os.path.join(
        workspace, 'checkpoints', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=specaugment_timeshift_mixup', 'batch_size=2',
        'best_logmel_16k')
    assert os.path.isfile(os.path.join(ckpt_dir, 'iter_2.npz'))
    main_strong_cli.main(['train', '--dataset_dir', dataset_dir,
                          '--workspace', workspace, *COMMON,
                          '--learning_rate', '1e-3',
                          '--resume_iteration', '2',
                          '--stop_iteration', '5',
                          '--eval_interval', '2'])
    assert os.path.isfile(os.path.join(ckpt_dir, 'iter_4.npz')), \
        'resumed run did not save a step-tagged best checkpoint'


def test_03_inference_prob(dataset_dir, workspace):
    stats = main_strong_cli.inference_prob(
        main_strong_cli.get_parser().parse_args(
            ['inference_prob', '--dataset_dir', dataset_dir,
             '--workspace', workspace, *COMMON]))
    er = stats['sed_metrics']['overall']['error_rate']['error_rate']
    assert np.isfinite(er)
    # cached predictions for the threshold optimizer
    pred = os.path.join(
        workspace, 'predictions', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=specaugment_timeshift_mixup', 'batch_size=2',
        'test_predictions_logmel_16k.pkl')
    assert os.path.isfile(pred)


def test_04_optimize_thresholds(dataset_dir, workspace):
    score, params = opt_cli.optimize_sed_thresholds(
        opt_cli.get_parser().parse_args(
            ['optimize_sed_thresholds', '--dataset_dir', dataset_dir,
             '--workspace', workspace, *COMMON,
             '--epochs', '1']))
    assert len(params) == 75
    out = os.path.join(
        workspace, 'opt_thresholds', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=specaugment_timeshift_mixup', 'batch_size=2',
        'best_logmel_16k.sed.valid.pkl')
    assert os.path.isfile(out)
    with open(out, 'rb') as f:
        d = pickle.load(f)
    assert set(d) == {'audio_tagging_threshold', 'sed_high_threshold',
                      'sed_low_threshold', 'n_smooth', 'n_salt'}


def test_05_predict_cli(dataset_dir, workspace):
    input_dir = os.path.join(dataset_dir, 'testing')
    predict_cli.main(['predict', '--input_dir', input_dir,
                      '--workspace', workspace, *COMMON,
                      '--overlap', '--sample_duration', '5'])
    out_dir = os.path.join(workspace, 'predict_results')
    xmls = [f for f in os.listdir(out_dir) if f.endswith('.xml')]
    assert len(xmls) == N
    content = open(os.path.join(out_dir, xmls[0])).read()
    assert content.startswith('<AudioDoc') and content.endswith(
        '</AudioDoc>')


def test_05b_predict_cli_bulk_matches_per_file(dataset_dir, workspace):
    """--bulk batches the windows of many files into shared forwards;
    the emitted XMLs must be byte-identical to the per-file loop's."""
    import shutil
    input_dir = os.path.join(dataset_dir, 'testing')
    out_dir = os.path.join(workspace, 'predict_results')
    baseline = {f: open(os.path.join(out_dir, f)).read()
                for f in os.listdir(out_dir) if f.endswith('.xml')}
    assert baseline                      # test_05 ran the per-file loop
    shutil.rmtree(out_dir)
    predict_cli.main(['predict', '--input_dir', input_dir,
                      '--workspace', workspace, *COMMON,
                      '--overlap', '--sample_duration', '5',
                      '--bulk', '3'])
    bulk = {f: open(os.path.join(out_dir, f)).read()
            for f in os.listdir(out_dir) if f.endswith('.xml')}
    assert bulk == baseline


def test_05c_predict_cli_resident_uniform_corpus(dataset_dir, workspace):
    """--resident serves a uniform fixed-length clip corpus via the
    minimum-RPC bulk path.  The CLI's XMLs must equal a direct
    engine-level predict_files_resident call on the same wire, and
    --max_pass_clips chunking must not change them."""
    import shutil
    input_dir = os.path.join(dataset_dir, 'testing')
    out_dir = os.path.join(workspace, 'predict_results')

    # library-level oracle on the same int16 wire (10 s files = one
    # resident clip each at --sample_duration 10)
    from sed_jax.cli import common as cli_common
    from sed_jax.serve.engine import SedInferenceEngine
    from sed_jax.config import AUDIO_16K, PREDICT_SED_PARAMS
    ns = predict_cli.get_parser().parse_args(
        ['predict', '--input_dir', input_dir, '--workspace', workspace,
         *COMMON, '--sample_duration', '10', '--resident'])
    cfg, ws = cli_common.resolve(ns)
    model, variables = cli_common.build_model_and_variables(
        ns, cfg, ws, checkpoint=None)
    sed_params = cli_common.load_sed_params(ns, cfg, ws,
                                            PREDICT_SED_PARAMS)
    eng = SedInferenceEngine(model, variables, cfg, sample_duration=10,
                             overlap=False, sed_params=sed_params,
                             batch_size=ns.batch_size)
    paths = sorted(os.path.join(input_dir, f)
                   for f in os.listdir(input_dir)
                   if not f.startswith('.'))
    from sed_jax.data import audio_io as aio
    reader = aio.wire_reader_for(paths[0])
    names = [os.path.basename(p) for p in paths]
    _, want_xmls = eng.predict_files_resident(paths, reader, names=names)
    want = {os.path.splitext(n)[0] + '.xml': x
            for n, x in zip(names, want_xmls)}

    shutil.rmtree(out_dir, ignore_errors=True)
    predict_cli.main(['predict', '--input_dir', input_dir,
                      '--workspace', workspace, *COMMON,
                      '--sample_duration', '10', '--resident'])
    got = {f: open(os.path.join(out_dir, f)).read()
           for f in os.listdir(out_dir) if f.endswith('.xml')}
    assert got == want

    shutil.rmtree(out_dir)
    predict_cli.main(['predict', '--input_dir', input_dir,
                      '--workspace', workspace, *COMMON,
                      '--sample_duration', '10', '--resident',
                      '--max_pass_clips', '3'])
    chunked = {f: open(os.path.join(out_dir, f)).read()
               for f in os.listdir(out_dir) if f.endswith('.xml')}
    assert chunked == got


def test_06_inference_prob_overlap_single_param(dataset_dir, workspace,
                                                monkeypatch):
    monkeypatch.setattr(main_strong_cli, 'PARAM_COMBINATIONS', [[1, 5]])
    results = main_strong_cli.inference_prob_overlap(
        main_strong_cli.get_parser().parse_args(
            ['inference_prob_overlap', '--dataset_dir', dataset_dir,
             '--workspace', workspace, *COMMON]))
    assert (1, 5) in results


def test_07_inference_prob_vote_single_param(dataset_dir, workspace,
                                             monkeypatch):
    monkeypatch.setattr(main_strong_cli, 'PARAM_COMBINATIONS', [[1, 5]])
    results = main_strong_cli.inference_prob_vote(
        main_strong_cli.get_parser().parse_args(
            ['inference_prob_vote', '--dataset_dir', dataset_dir,
             '--workspace', workspace, *COMMON]))
    assert (1, 5) in results
