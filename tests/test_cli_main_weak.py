"""End-to-end smoke test for the WEAK-ONLY training driver
(``sed_jax/cli/main.py``, reference ``pytorch/main.py:30-278``).

This is a distinct code path from ``main_strong`` — its own loss/step
functions and a single weak stream — so it gets its own CPU drive:
pack weak 'training' + 'testing' splits, train a few iterations with
mixup/timeshift/specaugment, and hit the eval/statistics/best-checkpoint
branch (``--eval_interval`` exposes the reference's hardcoded
1000-iteration cadence for testability).
"""

import os
import pickle

import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, LABELS
from sed_jax.data import audio_io
from sed_jax.cli import features as features_cli
from sed_jax.cli import main as main_cli

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

CFG = AUDIO_16K
N = 4


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    """Weak-only AudioSet-like dataset: 'training' + 'testing' splits
    with metadata at the WEAK layout (``metadata/training_set.csv``,
    reference ``utils/features.py:20-36``)."""
    root = tmp_path_factory.mktemp('weak_dataset')
    rng = np.random.RandomState(0)
    meta = root / 'metadata'
    meta.mkdir()
    rows = {'training': [], 'testing': []}
    strong_rows = []
    for split in ('training', 'testing'):
        d = root / split
        d.mkdir()
        for i in range(N):
            ytid = f'{split}{i}'
            label = LABELS[i % 4]
            audio = rng.uniform(-0.3, 0.3, CFG.sample_rate * 10)
            audio_io.save_wav(str(d / f'{ytid}_0.wav'), audio,
                              CFG.sample_rate)
            rows[split].append(f'{ytid},0.000,10.000,{label},/m/x\n')
            if split == 'testing':
                strong_rows.append(f'{ytid}_0.wav,1.0,4.0,{label}\n')
    for split in rows:
        (meta / f'{split}_set.csv').write_text(''.join(rows[split]))
    (meta / 'groundtruth_strong_label_testing_set.csv').write_text(
        ''.join(strong_rows))
    return str(root)


def test_weak_train_e2e_eval_and_best_checkpoint(dataset_dir,
                                                 tmp_path_factory):
    workspace = str(tmp_path_factory.mktemp('weak_ws'))
    for split in ('training', 'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', dataset_dir,
                           '--workspace', workspace,
                           '--data_type', split, '--audio_16k'])
    main_cli.main(['train', '--dataset_dir', dataset_dir,
                   '--workspace', workspace,
                   '--filename', 'main',
                   '--model_type', 'Cnn_9layers_FrameAvg',
                   '--loss_type', 'clip_bce',
                   '--augmentation', 'specaugment_timeshift_mixup',
                   '--batch_size', '2', '--audio_16k',
                   '--stop_iteration', '3', '--eval_interval', '2'])
    # eval branch ran: statistics pickle with a 'test' entry at iter 2
    stats_files = []
    for base, _dirs, fns in os.walk(os.path.join(workspace, 'statistics')):
        stats_files += [os.path.join(base, f) for f in fns
                        if f == 'statistics_logmel_16k.pkl']
    assert len(stats_files) == 1, stats_files
    with open(stats_files[0], 'rb') as f:
        stats = pickle.load(f)
    assert [s['iteration'] for s in stats['test']] == [2]
    assert np.isfinite(np.nanmean(stats['test'][0]['clipwise_ap']))
    # best checkpoint saved by clipwise mAP (an iter_N.npz lineage at
    # the reference's best_{feat}_{quality} stem)
    ckpts = []
    for base, _dirs, fns in os.walk(os.path.join(workspace,
                                                 'checkpoints')):
        if 'BEST' in fns and any(f.endswith('.npz') for f in fns):
            ckpts.append(base)
    assert ckpts and any('best_logmel_16k' in c for c in ckpts), ckpts
    # submission csv written by the evaluator
    subs = []
    for base, _dirs, fns in os.walk(workspace):
        subs += [f for f in fns if f.endswith('_submission.csv')]
    assert subs, 'evaluator wrote no submission file'


def test_weak_inference_prob_dumps_predictions(dataset_dir,
                                               tmp_path_factory):
    """``cli.main inference_prob`` (reference ``main.py:281-380``):
    evaluate the weak driver's saved checkpoint on the testing split
    and cache the prediction pickle."""
    workspace = str(tmp_path_factory.mktemp('weak_ws_ip'))
    for split in ('training', 'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', dataset_dir,
                           '--workspace', workspace,
                           '--data_type', split, '--audio_16k'])
    common = ['--dataset_dir', dataset_dir, '--workspace', workspace,
              '--filename', 'main',
              '--model_type', 'Cnn_9layers_FrameAvg',
              '--loss_type', 'clip_bce',
              '--augmentation', 'specaugment_timeshift_mixup',
              '--batch_size', '2', '--audio_16k']
    main_cli.main(['train'] + common + ['--stop_iteration', '3',
                                        '--eval_interval', '2'])
    main_cli.main(['inference_prob'] + common)
    preds = []
    for base, _dirs, fns in os.walk(os.path.join(workspace,
                                                 'predictions')):
        preds += [os.path.join(base, f) for f in fns
                  if f.endswith('.pkl')]
    assert len(preds) == 1
    with open(preds[0], 'rb') as f:
        out = pickle.load(f)
    assert 'clipwise_output' in out and 'target' in out
    assert out['clipwise_output'].shape == out['target'].shape
