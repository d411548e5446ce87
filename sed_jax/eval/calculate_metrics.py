"""Micro P/R/F1 with per-class thresholds + results-dict extraction
(``utils/calculate_metrics.py:18-49``)."""

from __future__ import annotations

import numpy as np


def _ratio(num: float, den: float) -> float:
    """num / den, or 0.0 when den is 0 (scikit-learn's zero_division
    default for precision and recall)."""
    return float(num / den) if den > 0 else 0.0


def calculate_precision_recall_f1(y_true: np.ndarray, output: np.ndarray,
                                  thresholds, average: str = 'micro'):
    if y_true.ndim == 3:
        (n, t, f) = y_true.shape
        y_true = y_true.reshape((n * t, f))
        output = output.reshape((n * t, f))
    classes_num = y_true.shape[-1]
    binarized = np.zeros_like(output)
    for k in range(classes_num):
        binarized[:, k] = (np.sign(output[:, k] - thresholds[k]) + 1) // 2
    if average != 'micro':
        raise ValueError('Incorrect average argument!')
    truth, pred = y_true.ravel() == 1, binarized.ravel() == 1
    tp = np.count_nonzero(truth & pred)
    precision = _ratio(tp, np.count_nonzero(pred))
    recall = _ratio(tp, np.count_nonzero(truth))
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return precision, recall, f1


def get_metric(results: dict, metric_type: str):
    if metric_type == 'f1':
        return results['overall']['f_measure']['f_measure']
    if metric_type == 'er':
        return results['overall']['error_rate']['error_rate']
    if metric_type == 'precision':
        return results['overall']['f_measure']['precision']
    if metric_type == 'recall':
        return results['overall']['f_measure']['recall']
    raise ValueError(f'unknown metric_type: {metric_type}')
