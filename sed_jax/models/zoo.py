"""Primary SED model zoo: CNN backbones with max/avg/attention heads and
GRU / single-block-Transformer temporal modules.

One configurable module covers the reference's nine CNN-family model
classes (``pytorch/models.py:213-791,880-1184``), which differ only in
conv depth, temporal module, head, and the pad-to-roundup quirk.  The
registry (``sed_jax/models/registry.py``) instantiates each reference
``model_type`` string with the right settings, replacing the reference's
``Model = eval(model_type)`` (``pytorch/main_strong.py:198``).

All models: ``__call__(input, train, mixup_lambda, timeshift,
spec_augment) -> {'framewise_output' (B, T', C), 'clipwise_output'
(B, C), 'embedding'}`` at 100 frames/second output.
"""

from __future__ import annotations

from typing import Optional, Tuple

from sed_jax.models import nn
import jax
import jax.numpy as jnp

from sed_jax.models import blocks
from sed_jax.models.base import SedFeatureBase


class CnnSed(SedFeatureBase):
    """CNN [+ BiGRU | + MultiHead] + {max, avg, att} head.

    Reference mapping (ratio = 2^(#pooled blocks); last block pools (1,1)):
      conv_channels=(64,128,256,512), temporal='none',  head='max'  ->
        Cnn_9layers_FrameMax (``models.py:213-295``)
      ... head='avg' -> Cnn_9layers_FrameAvg (``models.py:298-380``)
      ... head='att' -> Cnn_9layers_FrameAtt (``models.py:383-461``)
      temporal='gru', gru_hidden=256, head='avg' ->
        Cnn_9layers_Gru_FrameAvg (``models.py:466-561``)
      temporal='gru', head='att', pad_to_roundup=True ->
        Cnn_9layers_Gru_FrameAtt (``models.py:564-688``, primary model)
      conv_channels=(...2048), gru_hidden=1024 ->
        Cnn_14layers_Gru_FrameAtt (``models.py:691-791``)
      temporal='multihead' -> Cnn_9layers_Transformer_*
        (``models.py:880-1077``), Cnn_14layers_* (``models.py:1080-1184``)
    """

    conv_channels: Tuple[int, ...] = (64, 128, 256, 512)
    temporal: str = 'none'             # 'none' | 'gru' | 'multihead'
    head: str = 'att'                  # 'max' | 'avg' | 'att'
    gru_hidden: int = 256
    pad_to_roundup: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 mixup_lambda: Optional[jnp.ndarray] = None,
                 timeshift: bool = False, spec_augment: bool = True) -> dict:
        interpolate_ratio = 2 ** (len(self.conv_channels) - 1)

        x = self.compute_features(x, train, mixup_lambda, timeshift,
                                  spec_augment)                # (B,T,F,1)

        for i, ch in enumerate(self.conv_channels):
            last = i == len(self.conv_channels) - 1
            x = blocks.ConvBlock(ch, bn_axis_name=self.bn_axis_name,
                                 dtype=self.compute_dtype,
                                 name=f'conv_block{i + 1}')(
                x, train, pool_size=(1, 1) if last else (2, 2),
                pool_type='avg')
        x = x.astype(jnp.float32)

        x = jnp.mean(x, axis=2)                                # (B,T',C)

        if self.temporal == 'gru':
            x = blocks.BiGRU(self.gru_hidden, name='gru')(x)
        elif self.temporal == 'multihead':
            x = blocks.MultiHead(name='multihead')(x, train)
        elif self.temporal != 'none':
            raise ValueError(f'unknown temporal module: {self.temporal}')

        if self.head == 'att':
            clipwise, norm_att, cla = blocks.AttBlock(
                self.classes_num, activation='sigmoid', name='att_block')(x)
            framewise = blocks.interpolate(cla, interpolate_ratio)
            embedding = cla
        else:
            framewise = jax.nn.sigmoid(
                nn.Dense(self.classes_num, kernel_init=blocks.xavier_uniform,
                         name='fc')(x))
            framewise = blocks.interpolate(framewise, interpolate_ratio)
            if self.head == 'avg':
                clipwise = jnp.mean(framewise, axis=1)
            elif self.head == 'max':
                clipwise = jnp.max(framewise, axis=1)
            else:
                raise ValueError(f'unknown head: {self.head}')
            embedding = x

        if self.pad_to_roundup and framewise.shape[1] != 1000:
            framewise = blocks.pad_framewise_output(
                framewise, blocks.roundup(framewise.shape[1]))

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}
