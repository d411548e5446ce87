"""Average-precision metrics.

Mirrors ``pytorch/evaluate.py:11-29`` (framewise mAP on flattened
(N*T, C)) and the clipwise AP at ``pytorch/evaluate.py:76-77``, which
call ``sklearn.metrics.average_precision_score``; this is a numpy
implementation of the same definition (step-wise area under the
precision-recall curve, one point per distinct score).
"""

from __future__ import annotations

import numpy as np


def binary_average_precision(y_true: np.ndarray,
                             y_score: np.ndarray) -> float:
    """AP of one binary problem.  With no positives the recall is taken
    as 1 at every threshold, as scikit-learn does, which gives 0."""
    order = np.argsort(y_score, kind='mergesort')[::-1]
    y_score = np.asarray(y_score)[order]
    y_true = np.asarray(y_true)[order]
    # last index of each run of equal scores: one curve point per score
    ends = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[ends]
    fps = 1 + ends - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def average_precision(y_true: np.ndarray, y_score: np.ndarray,
                      average=None):
    """Per-class AP of (N, C) targets and scores (``average=None``),
    their mean (``'macro'``), or the AP of all pairs pooled
    (``'micro'``)."""
    if average == 'micro':
        return binary_average_precision(y_true.ravel(), y_score.ravel())
    per_class = np.array([binary_average_precision(y_true[:, k],
                                                   y_score[:, k])
                          for k in range(y_true.shape[1])])
    if average is None:
        return per_class
    if average == 'macro':
        return float(np.mean(per_class))
    raise ValueError(f'unsupported average: {average!r}')


def clipwise_average_precision(target: np.ndarray, clipwise_output: np.ndarray,
                               average=None):
    return average_precision(target, clipwise_output, average=average)


def sed_average_precision(strong_target: np.ndarray,
                          framewise_output: np.ndarray, average=None):
    """Framewise SED AP: flatten time into the sample axis."""
    assert strong_target.shape == framewise_output.shape
    (n, time_steps, classes_num) = strong_target.shape
    return average_precision(
        strong_target.reshape((n * time_steps, classes_num)),
        framewise_output.reshape((n * time_steps, classes_num)),
        average=average)
