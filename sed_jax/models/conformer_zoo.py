"""Conformer-family SED models + SEDModel-style token/attention pooling.

Reference mapping:
  Cnn_9layers_Conformer_FrameAtt  (``pytorch/models.py:1189-1376``):
    4x ConvBlock -> ConformerEncoder(512->144, 3 layers, 4 heads, k=7)
    -> AttBlock(144->25), pad-to-roundup; encoder_type switchable to the
    ESPnet Transformer encoder (conv2d-subsampling input).
  Cnn_9layers_Conformer_FrameAvg  (``pytorch/models.py:1412-1626``):
    same encoder, fc+sigmoid head, pad before clipwise mean.
  Cnn_14layers_Conformer_FrameAtt (``pytorch/models.py:1627-1828``):
    6x ConvBlock, dynamic interpolate ratio 1000 // T'.
  Cnn_7layers_Conformer / Cnn_9layers_Conformer
    (``pytorch/models.py:1829-2218``): DCASE baseline CNN (or ConvBlock
    stack) + learned tag token prepended + encoder; weak = token logits,
    strong = remaining frame logits (x8 interpolation for the 7-layer
    variant only).  The 9-layer variant FLATTENS time x freq into the
    token sequence (``models.py:2156``; 10 s -> 125*8 = 1000 tokens) and
    ships framewise logits uninterpolated — verified head-to-head
    against the actual reference code (test_reference_model_oracle).
    The 7-layer forward is dead code upstream (every call raises
    TypeError: it passes ``spec_augment=`` to a preprocess lacking the
    kwarg, ``models.py:1934,1960``); the rebuild implements the intended
    semantics, verified against the reference with preprocess patched.
"""

from __future__ import annotations

from typing import Optional, Tuple

from sed_jax.models import nn
import jax
import jax.numpy as jnp

from sed_jax.models import blocks
from sed_jax.models import encoders
from sed_jax.models.base import SedFeatureBase

CONFORMER_KW = dict(adim=144, aheads=4, dropout_rate=0.1, elayers=3,
                    eunits=576, kernel_size=7)
TRANSFORMER_KW = dict(adim=144, aheads=4, dropout_rate=0.1, elayers=3,
                      eunits=576, transformer_input_layer='conv2d',
                      transformer_attn_dropout_rate=0.0, after_conv=False)


class ConformerSed(SedFeatureBase):
    """ConvBlock stack + Conformer/Transformer encoder + att/avg head."""

    conv_channels: Tuple[int, ...] = (64, 128, 256, 512)
    encoder_type: str = 'Conformer'
    head: str = 'att'

    def _encoder(self, x, train):
        input_dim = self.conv_channels[-1]
        if self.encoder_type == 'Conformer':
            x, _ = encoders.ConformerEncoder(
                idim=input_dim, bn_axis_name=self.bn_axis_name,
                name='encoder', **CONFORMER_KW)(x, None, train)
        elif self.encoder_type == 'Transformer':
            x, _ = encoders.TransformerEncoder(
                idim=input_dim, name='encoder', **TRANSFORMER_KW)(
                x, None, train)
        else:
            raise ValueError(f'unknown encoder_type: {self.encoder_type}')
        return x

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 mixup_lambda: Optional[jnp.ndarray] = None,
                 timeshift: bool = False, spec_augment: bool = True) -> dict:
        x = self.compute_features(x, train, mixup_lambda, timeshift,
                                  spec_augment)
        for i, ch in enumerate(self.conv_channels):
            last = i == len(self.conv_channels) - 1
            x = blocks.ConvBlock(ch, bn_axis_name=self.bn_axis_name,
                                 name=f'conv_block{i + 1}')(
                x, train, pool_size=(1, 1) if last else (2, 2),
                pool_type='avg')
        x = jnp.mean(x, axis=2)
        x = self._encoder(x, train)
        t = x.shape[1]
        # 9-layer uses a fixed x8 ratio; the 14-layer variant computes
        # 1000 // T' dynamically (``models.py:1796``)
        ratio = 8 if len(self.conv_channels) == 4 else max(1, 1000 // t)

        if self.head == 'att':
            clipwise, _, cla = blocks.AttBlock(
                self.classes_num, activation='sigmoid',
                name='att_block')(x)
            framewise = blocks.interpolate(cla, ratio)
            if framewise.shape[1] != 1000:
                framewise = blocks.pad_framewise_output(
                    framewise, blocks.roundup(framewise.shape[1]))
            embedding = cla
        else:
            framewise = jax.nn.sigmoid(
                nn.Dense(self.classes_num,
                         kernel_init=blocks.xavier_uniform,
                         name='fc')(x))
            framewise = blocks.interpolate(framewise, ratio)
            if framewise.shape[1] != 1000:
                framewise = blocks.pad_framewise_output(
                    framewise, blocks.roundup(framewise.shape[1]))
            clipwise = jnp.mean(framewise, axis=1)
            embedding = x

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}


class TokenPoolingConformer(SedFeatureBase):
    """SEDModel-style token pooling: a learned tag token is prepended to
    the frame sequence; the encoder's token output is the clipwise logit
    vector, the rest are frame logits (``models_2020/model.py:289-441``,
    ``pytorch/models.py:1829-2218``).  Outputs are LOGITS (for the
    *_logits losses), unlike the sigmoid-head models."""

    backbone: str = 'baseline'          # 'baseline' (7-layer) | 'convblocks'
    encoder_type: str = 'Conformer'
    interpolate_ratio: int = 8          # 0 = no interpolation

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 mixup_lambda: Optional[jnp.ndarray] = None,
                 timeshift: bool = False, spec_augment: bool = True) -> dict:
        x = self.compute_features(x, train, mixup_lambda, timeshift,
                                  spec_augment)
        if self.backbone == 'baseline':
            # DCASE baseline CNN (``models.py:1850-1858``): time /8,
            # freq pooled to 1
            x = encoders.BaselineCNN(
                activation='Relu', conv_dropout=0.1,
                kernel_size=(3,) * 7, padding=(1,) * 7, stride=(1,) * 7,
                nb_filters=(16, 32, 64, 128, 128, 128, 128),
                pooling=((2, 2), (2, 2), (2, 2), (1, 2), (1, 2), (1, 2),
                         (1, 1)),
                bn_axis_name=self.bn_axis_name, name='cnn')(x, train)
            x = jnp.mean(x, axis=2)                     # (B, T/8, 128)
            input_dim = 128
        else:
            for i, ch in enumerate((64, 128, 256, 512)):
                last = i == 3
                x = blocks.ConvBlock(ch, bn_axis_name=self.bn_axis_name,
                                     name=f'conv_block{i + 1}')(
                    x, train, pool_size=(1, 1) if last else (2, 2),
                    pool_type='avg')
            # the reference FLATTENS time x freq into the token sequence
            # (``models.py:2156``: reshape (B,C,T,F)->(B,C,T*F) then
            # permute) — NOT a mean over freq — so a 10 s clip yields
            # 125*8 = 1000 frame tokens at the encoder; time-major,
            # freq-minor ordering matches torch's reshape
            b, t, f, c = x.shape
            x = x.reshape(b, t * f, c)
            input_dim = 512

        tag = nn.Dense(input_dim, name='linear_emb')(
            jnp.ones((x.shape[0], 1, 1), x.dtype))
        x = jnp.concatenate([tag, x], axis=1)

        if self.encoder_type == 'Conformer':
            x, _ = encoders.ConformerEncoder(
                idim=input_dim, bn_axis_name=self.bn_axis_name,
                name='encoder', **CONFORMER_KW)(x, None, train)
        else:
            kw = dict(TRANSFORMER_KW, transformer_input_layer='linear')
            x, _ = encoders.TransformerEncoder(
                idim=input_dim, name='encoder', **kw)(x, None, train)

        x = nn.Dense(self.classes_num, name='classifier')(x)
        weak = x[:, 0, :]
        strong = x[:, 1:, :]
        if self.interpolate_ratio > 1:
            strong = blocks.interpolate(strong, self.interpolate_ratio)
        return {'framewise_output': strong,
                'clipwise_output': weak,
                'embedding': strong}
