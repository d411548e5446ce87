"""Evaluator: model forward over a split + AP + segment-based metrics.

Mirrors ``pytorch/evaluate.py:32-95`` and the batch-accumulating forward
of ``pytorch/pytorch_utils.py:25-78``.  The forward is one jitted
fixed-shape step; the final ragged batch is padded so the jit cache stays
at a single entry.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax.config import EVAL_SED_PARAMS, SedParams
from sed_jax.eval import ap as ap_metrics
from sed_jax.eval import segment_metrics
import sed_jax.post.events as post_events
from sed_jax.train.step import make_eval_step


def forward_all(eval_step, params, batch_stats, loader,
                batch_size: Optional[int] = None,
                return_target: bool = True) -> dict:
    """Accumulate model outputs over a data loader into numpy arrays
    (the ``pytorch_utils.forward`` equivalent)."""
    out: dict = {}

    def _append(key, value):
        out.setdefault(key, []).append(value)

    for batch in loader:
        wav = batch['waveform']
        n = wav.shape[0]
        if batch_size is not None and n < batch_size:
            wav = np.concatenate(
                [wav, np.zeros((batch_size - n,) + wav.shape[1:],
                               wav.dtype)])
        res = eval_step(params, batch_stats, jnp.asarray(wav))
        _append('audio_name', np.asarray(batch['audio_name']))
        _append('clipwise_output', np.asarray(res['clipwise_output'])[:n])
        _append('framewise_output', np.asarray(res['framewise_output'])[:n])
        if return_target and 'target' in batch:
            _append('target', batch['target'])
        if return_target and 'strong_target' in batch:
            _append('strong_target', batch['strong_target'])
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


class Evaluator:
    """AT + SED evaluation for a model (``pytorch/evaluate.py:32-95``)."""

    def __init__(self, model, sed_params: SedParams = EVAL_SED_PARAMS,
                 batch_size: Optional[int] = None):
        self.model = model
        self.sed_params = sed_params
        self.batch_size = batch_size
        self._eval_step = make_eval_step(model)

    def evaluate(self, params, batch_stats, data_loader,
                 reference_csv_path: str, submission_path: str,
                 frames_per_second: int):
        """Returns (statistics, output_dict): clipwise AP, framewise AP,
        and sed_eval-style segment metrics from decoded events."""
        output_dict = forward_all(self._eval_step, params, batch_stats,
                                  data_loader, self.batch_size)
        statistics = {}
        statistics['clipwise_ap'] = ap_metrics.clipwise_average_precision(
            output_dict['target'], output_dict['clipwise_output'],
            average=None)
        if 'strong_target' in output_dict:
            n = min(output_dict['strong_target'].shape[1],
                    output_dict['framewise_output'].shape[1])
            statistics['framewise_ap'] = ap_metrics.sed_average_precision(
                output_dict['strong_target'][:, :n],
                output_dict['framewise_output'][:, :n], average=None)

        predict_event_list = post_events.frame_prediction_to_event_prediction(
            output_dict, self.sed_params, frames_per_second)
        post_events.write_submission(predict_event_list, submission_path)
        statistics['sed_metrics'] = segment_metrics.official_evaluate(
            reference_csv_path, submission_path)
        return statistics, output_dict
