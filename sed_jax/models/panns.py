"""PANNs CNN14 with decision-level attention
(``pytorch/models.py:2685-2783``).

6 ConvBlocks (x32 time pooling) with dropout 0.2 between blocks, a
3-wide max+avg temporal smoothing, fc 2048->2048 + ReLU with dropout
0.5, attention pooling head, x32 interpolation, padded to
``frames_in - 1`` (= 1000 for 10 s clips).
"""

from __future__ import annotations

from typing import Optional

from sed_jax.models import nn
import jax.numpy as jnp

from sed_jax.models import blocks
from sed_jax.models.base import SedFeatureBase


def _pool1d_same(x: jnp.ndarray, kind: str) -> jnp.ndarray:
    """k=3, stride 1, pad 1 pooling over the time axis of (B, T, C)."""
    x4 = x[:, :, None, :]
    if kind == 'max':
        return nn.max_pool(x4, (3, 1), strides=(1, 1),
                           padding=[(1, 1), (0, 0)])[:, :, 0, :]
    return nn.avg_pool(x4, (3, 1), strides=(1, 1),
                       padding=[(1, 1), (0, 0)])[:, :, 0, :]


class Cnn14DecisionLevelAtt(SedFeatureBase):

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 mixup_lambda: Optional[jnp.ndarray] = None,
                 timeshift: bool = False, spec_augment: bool = True) -> dict:
        frames_num = (x.shape[-1] // self.cfg.hop_size + 1 - 1
                      if self.feature_type == 'logmel' else x.shape[-1] - 1)
        x = self.compute_features(x, train, mixup_lambda, timeshift,
                                  spec_augment)
        for i, ch in enumerate((64, 128, 256, 512, 1024, 2048)):
            last = i == 5
            x = blocks.ConvBlock(ch, bn_axis_name=self.bn_axis_name,
                                 name=f'conv_block{i + 1}')(
                x, train, pool_size=(1, 1) if last else (2, 2),
                pool_type='avg')
            x = nn.Dropout(0.2, deterministic=not train)(x)
        x = jnp.mean(x, axis=2)                          # (B, T', 2048)

        x = _pool1d_same(x, 'max') + _pool1d_same(x, 'avg')
        x = nn.Dropout(0.5, deterministic=not train)(x)
        x = nn.relu(nn.Dense(2048, kernel_init=blocks.xavier_uniform,
                             name='fc1')(x))
        x = nn.Dropout(0.5, deterministic=not train)(x)

        clipwise, _, segmentwise = blocks.AttBlock(
            self.classes_num, activation='sigmoid', name='att_block')(x)
        framewise = blocks.interpolate(segmentwise, 32)
        if framewise.shape[1] < frames_num:
            framewise = blocks.pad_framewise_output(framewise, frames_num)
        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': segmentwise}
