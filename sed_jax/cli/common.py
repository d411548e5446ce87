"""Shared CLI plumbing: quality flags, workspace paths, model loading."""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

from sed_jax.config import AudioConfig, get_audio_config
from sed_jax.utils.paths import Workspace


def add_common_args(parser: argparse.ArgumentParser,
                    require_dataset: bool = True):
    parser.add_argument('--dataset_dir', type=str,
                        required=require_dataset,
                        help='Directory of the dataset.')
    parser.add_argument('--workspace', type=str, required=True,
                        help='Directory of your workspace.')
    parser.add_argument('--filename', type=str, default='main_strong')
    parser.add_argument('--holdout_fold', type=str, default='1',
                        choices=['1'])
    parser.add_argument('--model_type', type=str,
                        default='Cnn_9layers_Gru_FrameAtt')
    parser.add_argument('--loss_type', type=str, default='clip_bce')
    # reference quirk preserved: the choice list (README.md's
    # augmentation list) spells the standalone option 'spec_augment'
    # with an underscore, but dispatch tests `'specaugment' in
    # augmentation` (``main_strong.py:278``) — so 'spec_augment' trains
    # with NO augmentation in the reference and here alike; use a
    # 'specaugment_*' combo for SpecAugment
    parser.add_argument('--augmentation', type=str, default='none',
                        choices=['none', 'spec_augment', 'timeshift',
                                 'mixup', 'timeshift_mixup',
                                 'specaugment_timeshift_mixup',
                                 'specaugment_mixup',
                                 'specaugment_timeshift'])
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--feature_type', type=str, default='logmel')
    parser.add_argument('--audio_8k', action='store_true', default=False)
    parser.add_argument('--audio_16k', action='store_true', default=False)
    parser.add_argument('--mini_data', action='store_true', default=False)
    parser.add_argument('--sed_thresholds', action='store_true',
                        default=False)
    # accepted for reference-CLI compatibility; devices come from JAX
    parser.add_argument('--cuda', action='store_true', default=False)


def resolve(args) -> Tuple[AudioConfig, Workspace]:
    cfg = get_audio_config(audio_8k=args.audio_8k, audio_16k=args.audio_16k)
    ws = Workspace(root=args.workspace, filename=args.filename,
                   holdout_fold=args.holdout_fold,
                   model_type=args.model_type, loss_type=args.loss_type,
                   augmentation=args.augmentation,
                   batch_size=args.batch_size)
    return cfg, ws


def hdf5_path(args, cfg: AudioConfig, data_type: str) -> str:
    prefix = 'minidata_' if args.mini_data else ''
    return os.path.join(
        args.workspace, 'hdf5s',
        f'{prefix}{data_type}_{args.feature_type}_{cfg.name}.h5')


def reference_csv_paths(args) -> dict:
    """Ground-truth csv layout (``pytorch/main_strong.py:141-146``)."""
    return {
        'valid': os.path.join(
            args.dataset_dir, 'metadata', 'strong',
            'groundtruth_strong_label_strong_validation_set.csv'),
        'test': os.path.join(
            args.dataset_dir, 'metadata',
            'groundtruth_strong_label_testing_set.csv'),
    }


def load_sed_params(args, cfg: AudioConfig, ws: Workspace,
                    default):
    """Optimized thresholds pickle or defaults
    (``pytorch/predict.py:244-257``)."""
    from sed_jax.config import SedParams
    if args.sed_thresholds:
        import pickle
        with open(ws.sed_thresholds_path(args.feature_type, cfg.name),
                  'rb') as f:
            return SedParams.from_dict(pickle.load(f))
    return default


def init_example(args, cfg: AudioConfig):
    """Zero input of the shape the model's __call__ expects: a waveform
    for 'logmel', a precomputed (1, mel_bins, frames) gammatonegram for
    'gamma' (``pytorch/models.py:630-640``)."""
    import numpy as np
    if getattr(args, 'feature_type', 'logmel') == 'gamma':
        from sed_jax.dsp import gammatone
        frames = gammatone.gtgram_frames(cfg, cfg.audio_samples)
        return np.zeros((1, cfg.mel_bins, frames), np.float32)
    return np.zeros((1, cfg.audio_samples), np.float32)


def build_model_and_variables(args, cfg: AudioConfig, ws: Workspace,
                              checkpoint: Optional[str] = None):
    """Model from the registry + variables from a checkpoint (train
    ``.npz`` or reference ``.pth``) or fresh init."""
    import jax
    import numpy as np
    from sed_jax.models.registry import get_model
    model = get_model(args.model_type, cfg, feature_type=args.feature_type)
    path = checkpoint
    if path is None:
        from sed_jax.train.checkpoint import best_checkpoint_path
        lineage = ws.checkpoint_path(args.feature_type, cfg.name)
        pth = ws.torch_checkpoint_path(args.feature_type, cfg.name)
        path = best_checkpoint_path(lineage) or (
            pth if os.path.isfile(pth) else None)
    if path is not None:
        from sed_jax.train.checkpoint import load_variables
        variables = load_variables(path)
    else:
        variables = model.init({'params': jax.random.PRNGKey(0)},
                               init_example(args, cfg), train=False)
    return model, variables
