"""Unit tests for the threshold-optimizer score calculators
(``sed_jax/thresholds/optimizer.py``, reference
``pytorch/optimize_thresholds.py:143-207``)."""

import pickle

import numpy as np

from sed_jax.thresholds.optimizer import AudioTaggingScoreCalculator


def test_audio_tagging_score_calculator(tmp_path):
    """Clipwise micro-F1 from a cached prediction pickle: thresholds
    binarize clipwise_output per class; known targets give a known F1,
    and moving a threshold across a score flips the reading
    (reference ``optimize_thresholds.py:143-157``)."""
    target = np.array([[1, 0, 1],
                       [0, 1, 0],
                       [1, 1, 0],
                       [0, 0, 1]], np.float32)
    clipwise = np.array([[0.9, 0.1, 0.8],
                         [0.2, 0.7, 0.1],
                         [0.6, 0.9, 0.2],
                         [0.1, 0.3, 0.7]], np.float32)
    p = tmp_path / 'pred.pkl'
    with open(p, 'wb') as f:
        pickle.dump({'target': target, 'clipwise_output': clipwise}, f)
    calc = AudioTaggingScoreCalculator(str(p))
    # thresholds at 0.5: binarized == target exactly -> micro F1 = 1.0
    assert calc([0.5, 0.5, 0.5]) == 1.0
    # raise class-0 threshold past the 0.6 score: one TP becomes FN
    # micro: TP=5, FN=1, FP=0 -> P=1, R=5/6, F1=10/11
    np.testing.assert_allclose(calc([0.75, 0.5, 0.5]), 10 / 11)
    # absurd thresholds: nothing predicted -> F1 = 0 (no div-by-zero)
    assert calc([1.1, 1.1, 1.1]) == 0.0
