"""Shared SED model scaffolding: frontend + bn0 + augmentation.

Every reference model embeds the same preamble in its forward pass
(e.g. ``pytorch/models.py:630-661``): waveform -> spectrogram -> logmel,
a BatchNorm over mel bins, then train-time SpecAugment / mixup /
timeshift.  ``SedFeatureBase`` factors that out; subclasses implement
``backbone_head()``.

API parity: ``__call__(input, train, mixup_lambda, timeshift,
spec_augment)`` returns ``{'framewise_output', 'clipwise_output',
'embedding'}`` like the reference forward
(``pytorch/models.py:625-688``).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from sed_jax.config import AudioConfig
from sed_jax.augment import functional as aug
from sed_jax.dsp import frontend as fe
from sed_jax.models import nn


class SedFeatureBase(nn.Module):
    """Base: log-mel (or precomputed gammatone) features + augmentation.

    Attributes:
      cfg: audio quality config (frozen, hashable).
      classes_num: number of classes.
      feature_type: 'logmel' computes features from the waveform;
        'gamma' expects precomputed (B, mel_bins, T) input
        (``pytorch/models.py:630-640``).
      bn_axis_name: mesh axis for cross-replica BatchNorm stats.
    """

    cfg: AudioConfig
    classes_num: int = 25
    feature_type: str = 'logmel'
    bn_axis_name: Optional[str] = None
    # conv-stack computation dtype, e.g. jnp.bfloat16 (frontend, BN
    # stats, temporal modules and heads stay float32)
    compute_dtype: Optional[object] = None

    def compute_features(self, x: jnp.ndarray, train: bool,
                         mixup_lambda: Optional[jnp.ndarray],
                         timeshift: bool, spec_augment: bool,
                         skip_bn0: bool = False) -> jnp.ndarray:
        """waveform (B, samples) or gamma (B, F, T) -> (B, T, F, 1).

        ``skip_bn0`` omits the mel-bin BatchNorm for models whose
        reference comments it out (VGGish, ``models.py:2304-2311``)."""
        if self.feature_type == 'logmel':
            x = fe.logmel(x, self.cfg)[..., None]  # (B, T, F, 1)
        elif self.feature_type == 'gamma':
            x = x.transpose(0, 2, 1)[..., None]   # (B, T, F, 1)
        else:
            raise ValueError(f'unsupported feature_type: {self.feature_type}')

        # BatchNorm over mel bins (reference bn0, ``models.py:642-644``).
        if not skip_bn0:
            x = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, axis=2,
                             axis_name=self.bn_axis_name, name='bn0')(x)

        if train and spec_augment:
            x = aug.spec_augment(self.make_rng('augment'), x,
                                 time_drop_width=64, time_stripes_num=2,
                                 freq_drop_width=8, freq_stripes_num=2)
        if train and mixup_lambda is not None:
            if timeshift:
                x = aug.do_mixup_timeshift(self.make_rng('augment'), x,
                                           mixup_lambda, axis=1)
            else:
                x = aug.do_mixup(x, mixup_lambda)
        elif train and timeshift:
            x = aug.do_timeshift(self.make_rng('augment'), x, axis=1)
        return x
