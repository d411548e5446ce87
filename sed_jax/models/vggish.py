"""VGGish transfer-learning backbone + SED heads.

Reference: a torch-vggish port (``pytorch/models.py:2219-2267``) whose fc
stack is stripped at load time, feeding att/GRU/avg heads
(``pytorch/models.py:2284-2592``).  The pretrained ``pytorch_vggish.pth``
(``models.py:2329-2336``) can be mapped in through
``sed_jax.compat.torch_loader``; random init otherwise.

Head notes (matching the reference forwards):
* all VGGish heads skip the bn0 mel BatchNorm (commented out upstream,
  ``models.py:2347-2349``);
* FrameAtt: interpolate x12 then pad to 1000 (``models.py:2374-2376``);
* Gru_FrameAtt: BiGRU(512 -> 256x2) before the att block;
* FrameAvg: dynamic ratio 1000 // T' (``models.py:2578``).
"""

from __future__ import annotations

from typing import Optional

from sed_jax.models import nn
import jax
import jax.numpy as jnp

from sed_jax.augment import functional as aug
from sed_jax.models import blocks
from sed_jax.models.base import SedFeatureBase


class VGGishFeatures(nn.Module):
    """The VGGish conv stack: [64] pool [128] pool [256x2] pool [512x2]
    pool, 3x3 convs with bias + ReLU, 2x2 max pools."""

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        plan = [(64,), (128,), (256, 256), (512, 512)]
        idx = 0
        for stage in plan:
            for ch in stage:
                x = nn.relu(nn.Conv(ch, (3, 3), padding='SAME',
                                    name=f'conv{idx}')(x))
                idx += 1
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        return x


class VGGishSed(SedFeatureBase):
    """VGGish features + {att, gru_att, avg} head."""

    head: str = 'att'                  # 'att' | 'gru_att' | 'avg'
    gru_hidden: int = 256

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 mixup_lambda: Optional[jnp.ndarray] = None,
                 timeshift: bool = False, spec_augment: bool = True) -> dict:
        # shared frontend WITHOUT bn0 (the reference comments it out,
        # ``models.py:2304-2311``)
        x = self.compute_features(x, train, mixup_lambda, timeshift,
                                  spec_augment, skip_bn0=True)

        x = VGGishFeatures(name='vggish')(x)
        x = jnp.mean(x, axis=2)                         # (B, T', 512)

        if self.head == 'gru_att':
            x = blocks.BiGRU(self.gru_hidden, name='gru')(x)

        if self.head in ('att', 'gru_att'):
            clipwise, _, cla = blocks.AttBlock(
                self.classes_num, activation='sigmoid',
                name='att_block')(x)
            framewise = blocks.interpolate(cla, 12)
            if framewise.shape[1] < 1000:
                framewise = blocks.pad_framewise_output(framewise, 1000)
            embedding = cla
        else:
            framewise = jax.nn.sigmoid(
                nn.Dense(self.classes_num,
                         kernel_init=blocks.xavier_uniform,
                         name='fc')(x))
            ratio = max(1, 1000 // framewise.shape[1])
            framewise = blocks.interpolate(framewise, ratio)
            if framewise.shape[1] < 1000:
                framewise = blocks.pad_framewise_output(framewise, 1000)
            clipwise = jnp.mean(framewise, axis=1)
            embedding = x

        return {'framewise_output': framewise,
                'clipwise_output': clipwise,
                'embedding': embedding}
