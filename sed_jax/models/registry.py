"""Model registry: reference ``model_type`` strings -> constructors.

Replaces the reference's ``Model = eval(model_type)``
(``pytorch/main_strong.py:198``, ``pytorch/predict.py:229``) with an
explicit table.
"""

from __future__ import annotations

from typing import Callable, Dict

from sed_jax.config import AudioConfig
from sed_jax.models.zoo import CnnSed

MODEL_REGISTRY: Dict[str, Callable] = {}


def register(name: str, **kwargs):
    def ctor(cfg: AudioConfig, classes_num: int = 25,
             feature_type: str = 'logmel', bn_axis_name=None, **extra):
        merged = dict(kwargs)
        merged.update(extra)
        return merged.pop('cls', CnnSed)(
            cfg=cfg, classes_num=classes_num, feature_type=feature_type,
            bn_axis_name=bn_axis_name, **merged)
    MODEL_REGISTRY[name] = ctor
    return ctor


# 9-layer CNN family (pytorch/models.py:213-461)
register('Cnn_9layers_FrameMax', temporal='none', head='max')
register('Cnn_9layers_FrameAvg', temporal='none', head='avg')
register('Cnn_9layers_FrameAtt', temporal='none', head='att')

# CNN + BiGRU family (pytorch/models.py:466-791)
register('Cnn_9layers_Gru_FrameAvg', temporal='gru', head='avg',
         gru_hidden=256)
register('Cnn_9layers_Gru_FrameAtt', temporal='gru', head='att',
         gru_hidden=256, pad_to_roundup=True)
register('Cnn_14layers_Gru_FrameAtt', temporal='gru', head='att',
         conv_channels=(64, 128, 256, 512, 1024, 2048), gru_hidden=1024,
         pad_to_roundup=True)
# regression-experiment clone of Gru_FrameAtt (pytorch/models.py:2788-2889);
# unlike FrameAtt its pad_framewise_output is commented out upstream
# (models.py:2883) so short clips keep the raw interpolated length
register('Cnn_9layers_Gru_Reg', temporal='gru', head='att',
         gru_hidden=256, pad_to_roundup=False)

# CNN + single-block Transformer family (pytorch/models.py:880-1184)
register('Cnn_9layers_Transformer_FrameAvg', temporal='multihead',
         head='avg')
register('Cnn_9layers_Transformer_FrameAtt', temporal='multihead',
         head='att')
register('Cnn_14layers_Transformer_FrameAtt', temporal='multihead',
         head='att', conv_channels=(64, 128, 256, 512, 1024, 2048),
         pad_to_roundup=True)


from sed_jax.models.conformer_zoo import ConformerSed as _ConformerSed, \
    TokenPoolingConformer as _TokenPool
from sed_jax.models.vggish import VGGishSed as _VGGishSed
from sed_jax.models.panns import Cnn14DecisionLevelAtt as _Cnn14

# CNN + Conformer family (pytorch/models.py:1189-2218)
register('Cnn_9layers_Conformer_FrameAtt', cls=_ConformerSed, head='att',
         encoder_type='Conformer')
register('Cnn_9layers_Conformer_FrameAvg', cls=_ConformerSed, head='avg',
         encoder_type='Conformer')
register('Cnn_14layers_Conformer_FrameAtt', cls=_ConformerSed, head='att',
         encoder_type='Conformer',
         conv_channels=(64, 128, 256, 512, 1024, 2048))
register('Cnn_7layers_Conformer', cls=_TokenPool, backbone='baseline',
         encoder_type='Conformer', interpolate_ratio=8)
register('Cnn_9layers_Conformer', cls=_TokenPool, backbone='convblocks',
         encoder_type='Conformer', interpolate_ratio=0)

# VGGish transfer-learning family (pytorch/models.py:2284-2592)
register('VGGish_FrameAtt', cls=_VGGishSed, head='att')
register('VGGish_Gru_FrameAtt', cls=_VGGishSed, head='gru_att')
register('VGGish_FrameAvg', cls=_VGGishSed, head='avg')

# PANNs CNN14 (pytorch/models.py:2685-2783)
register('Cnn14_DecisionLevelAtt', cls=_Cnn14)


def get_model(model_type: str, cfg: AudioConfig, classes_num: int = 25,
              feature_type: str = 'logmel', bn_axis_name=None, **kwargs):
    """Instantiate a model by its reference name."""
    if model_type not in MODEL_REGISTRY:
        raise KeyError(
            f'unknown model_type {model_type!r}; available: '
            f'{sorted(MODEL_REGISTRY)}')
    return MODEL_REGISTRY[model_type](
        cfg, classes_num=classes_num, feature_type=feature_type,
        bn_axis_name=bn_axis_name, **kwargs)
