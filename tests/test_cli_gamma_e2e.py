"""End-to-end CLI integration for the gammatone feature path: pack
``feature_type='gamma'`` HDF5s, train on them, run ``inference_prob`` —
the reference's first-class gamma mode (``utils/features.py:361-370``,
``pytorch/models.py:630-640``) exercised through the real CLIs (the
logmel e2e lives in test_cli_end_to_end.py)."""

import os

import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, LABELS
from sed_jax.data import audio_io
from sed_jax.cli import features as features_cli
from sed_jax.cli import main_strong as main_strong_cli

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

CFG = AUDIO_16K
N = 4

COMMON = ['--holdout_fold', '1', '--model_type', 'Cnn_9layers_FrameAvg',
          '--loss_type', 'clip_bce', '--augmentation', 'mixup',
          '--batch_size', '2', '--feature_type', 'gamma', '--audio_16k']


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
    """Synthetic AudioSet-like dataset (tone bursts so gamma bands carry
    signal) with weak + strong labels."""
    root = tmp_path_factory.mktemp('gamma_dataset')
    rng = np.random.RandomState(7)
    meta = root / 'metadata'
    (meta / 'strong').mkdir(parents=True)

    weak_rows = {s: [] for s in ('weak_training', 'strong_training',
                                 'strong_validation')}
    test_rows = []
    strong_rows = {s: [] for s in ('strong_training', 'strong_validation')}
    test_strong_rows = []
    t = np.arange(CFG.sample_rate * 10) / CFG.sample_rate

    for split in ('weak_training', 'strong_training', 'strong_validation',
                  'testing'):
        d = root / split
        d.mkdir()
        for i in range(N):
            ytid = f'{split}{i}'
            name = f'{ytid}_0.wav'
            label = LABELS[i % 4]
            f0 = 300.0 * (i % 4 + 1)
            audio = (rng.uniform(-0.1, 0.1, CFG.sample_rate * 10)
                     + 0.4 * np.sin(2 * np.pi * f0 * t)
                     * ((t >= 1.0) & (t < 4.0)))
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
    return str(tmp_path_factory.mktemp('gamma_workspace'))


def test_01_pack_gamma_all_splits(dataset_dir, workspace):
    """Pack every split with feature_type='gamma': HDF5s hold int16
    (N, mel_bins, gamma_frames) precomputed gammatonegrams instead of
    waveforms (``utils/features.py:318-322,361-370``)."""
    import h5py
    from sed_jax.dsp import gammatone
    for split in ('weak_training', 'strong_training', 'strong_validation',
                  'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', dataset_dir,
                           '--workspace', workspace,
                           '--data_type', split, '--audio_16k',
                           '--feature_type', 'gamma'])
    h5s = sorted(os.listdir(os.path.join(workspace, 'hdf5s')))
    assert h5s == sorted([
        'weak_training_gamma_16k.h5', 'strong_training_gamma_16k.h5',
        'strong_validation_gamma_16k.h5', 'testing_gamma_16k.h5'])
    frames = gammatone.gtgram_frames(CFG, CFG.sample_rate * 10)
    with h5py.File(os.path.join(workspace, 'hdf5s',
                                'testing_gamma_16k.h5'), 'r') as hf:
        assert hf['waveform'].shape == (N, CFG.mel_bins, frames)
        assert hf['waveform'].dtype == np.int16
        # precomputed features carry real (non-constant) band energy
        feats = hf['waveform'][:]
        assert feats.std() > 0


def test_02_train_gamma(dataset_dir, workspace):
    main_strong_cli.main(['train', '--dataset_dir', dataset_dir,
                          '--workspace', workspace, *COMMON,
                          '--learning_rate', '1e-3',
                          '--stop_iteration', '3',
                          '--eval_interval', '2'])
    ckpt = os.path.join(
        workspace, 'checkpoints', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=mixup', 'batch_size=2', 'best_gamma_16k')
    assert os.path.isdir(ckpt), 'best gamma checkpoint not saved'


def test_03_inference_prob_gamma(dataset_dir, workspace):
    stats = main_strong_cli.inference_prob(
        main_strong_cli.get_parser().parse_args(
            ['inference_prob', '--dataset_dir', dataset_dir,
             '--workspace', workspace, *COMMON]))
    er = stats['sed_metrics']['overall']['error_rate']['error_rate']
    assert np.isfinite(er)
    pred = os.path.join(
        workspace, 'predictions', 'main_strong', 'holdout_fold=1',
        'model_type=Cnn_9layers_FrameAvg', 'loss_type=clip_bce',
        'augmentation=mixup', 'batch_size=2',
        'test_predictions_gamma_16k.pkl')
    assert os.path.isfile(pred)
