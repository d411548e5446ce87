"""Golden-fixture tests against artifacts shipped with the reference repo
(the optimized-threshold pickles, SURVEY §6) — run only when the
reference checkout is present."""

import os
import pickle

import numpy as np
import pytest

from sed_jax.config import CLASSES_NUM, SedParams
from sed_jax.post.events import decode_batch

REF = '/root/reference'
PKL = os.path.join(
    REF, 'opt_thresholds', 'main_strong', 'holdout_fold=1',
    'model_type=Cnn_9layers_Gru_FrameAtt', 'loss_type=clip_bce',
    'augmentation=specaugment_mixup', 'batch_size=32',
    'best_logmel_16k.sed.valid.pkl')

pytestmark = pytest.mark.skipif(not os.path.isfile(PKL),
                                reason='reference artifacts not present')


def test_shipped_threshold_pickle_loads_into_sed_params():
    with open(PKL, 'rb') as f:
        d = pickle.load(f)
    params = SedParams.from_dict(d)
    per_class = params.per_class(CLASSES_NUM)
    assert len(per_class['sed_high_threshold']) == CLASSES_NUM
    assert len(per_class['sed_low_threshold']) == CLASSES_NUM
    assert per_class['n_smooth'][0] == 10
    assert per_class['n_salt'][0] == 10
    # optimized thresholds are probabilities
    assert all(0.0 <= t <= 1.5 for t in per_class['sed_high_threshold'])


def test_decode_with_shipped_thresholds():
    with open(PKL, 'rb') as f:
        params = SedParams.from_dict(pickle.load(f))
    rng = np.random.RandomState(0)
    framewise = np.clip(
        rng.uniform(-0.3, 1.2, (3, 100, CLASSES_NUM)), 0, 1)
    events = decode_batch(framewise, ['a', 'b', 'c'], params, 100)
    for e in events:
        assert 0 <= e['onset'] < e['offset'] <= 1.01
