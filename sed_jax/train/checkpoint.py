"""Checkpoints of {step, params, batch_stats, opt_state} as .npz files.

Replaces the reference's ``torch.save({'iteration', 'model',
'optimizer'})`` best-checkpoint scheme (``pytorch/main_strong.py:326-334``)
with one float32 ``.npz`` per saved iteration, keyed by pytree path
(``sed_jax.utils.npz_ckpt``).  Reference ``.pth`` files remain loadable
through ``sed_jax.compat.torch_loader``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sed_jax.utils import npz_ckpt


def _iter_name(step: int) -> str:
    return f'iter_{step}.npz'


def _saved_iterations(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[len('iter_'):-len('.npz')])
                  for f in os.listdir(ckpt_dir)
                  if f.startswith('iter_') and f.endswith('.npz')
                  and f[len('iter_'):-len('.npz')].isdigit())


def _payload(state) -> dict:
    return {'step': state.step, 'params': state.params,
            'batch_stats': state.batch_stats, 'opt_state': state.opt_state}


def save_checkpoint(path: str, state) -> None:
    """Save a SedTrainState to the file ``path``; in a multi-process run
    only process 0 writes (the state is replicated)."""
    import jax
    flat = npz_ckpt.flatten(_payload(state))
    if jax.process_index() == 0:
        npz_ckpt.save_npz(path, flat)


def save_best_checkpoint(ckpt_dir: str, state) -> str:
    """Save a step-tagged best checkpoint (``ckpt_dir/iter_<step>.npz``)
    and update the ``BEST`` marker.

    The reference overwrites one fixed-name ``.pth`` per run
    (``pytorch/main_strong.py:326-334``); keeping the lineage step-tagged
    lets ``--resume_iteration N`` restore the checkpoint *at* N instead of
    whatever was best last.
    """
    import jax
    step = int(state.step)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir), _iter_name(step))
    save_checkpoint(path, state)
    if jax.process_index() == 0:
        with open(os.path.join(ckpt_dir, 'BEST'), 'w') as f:
            f.write(str(step))
    return path


def best_checkpoint_path(ckpt_dir: str) -> Optional[str]:
    """Resolve the best checkpoint inside a lineage directory: the
    ``BEST`` marker, else the highest saved iteration, else None."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    marker = os.path.join(ckpt_dir, 'BEST')
    if os.path.isfile(marker):
        with open(marker) as f:
            return os.path.join(ckpt_dir, _iter_name(int(f.read().strip())))
    iters = _saved_iterations(ckpt_dir)
    return os.path.join(ckpt_dir, _iter_name(iters[-1])) if iters else None


def resume_checkpoint_path(ckpt_dir: str, iteration: int) -> str:
    """Path of the checkpoint saved at exactly ``iteration`` — the
    ``--resume_iteration N`` contract (``pytorch/main_strong.py:205-213``).
    Raises with the available iterations when N was never saved."""
    path = os.path.join(os.path.abspath(ckpt_dir), _iter_name(iteration))
    if os.path.isfile(path):
        return path
    raise FileNotFoundError(
        f'no checkpoint at iteration {iteration} in {ckpt_dir}; '
        f'saved iterations: {_saved_iterations(ckpt_dir)}')


def restore_checkpoint(path: str, state):
    """Restore a SedTrainState saved by ``save_checkpoint`` into the
    structure, dtypes and shardings of ``state``; raises ValueError when
    the file's leaves differ from the template's in path or shape."""
    import jax
    leaves, treedef = npz_ckpt.named_leaves(_payload(state))
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    keys = [key for key, _ in leaves]
    if set(keys) != set(saved):
        raise ValueError(
            f'{path} does not match the train state: missing '
            f'{sorted(set(keys) - set(saved))[:5]}, unexpected '
            f'{sorted(set(saved) - set(keys))[:5]}')
    restored = []
    for key, like in leaves:
        value = saved[key]
        if np.shape(value) != np.shape(like):
            raise ValueError(f'{path}: {key} has shape {np.shape(value)}, '
                             f'the train state {np.shape(like)}')
        value = value.astype(np.result_type(like))
        sharding = getattr(like, 'sharding', None)
        restored.append(jax.device_put(value, sharding)
                        if sharding is not None else value)
    return state.replace(**jax.tree_util.tree_unflatten(treedef, restored))


def load_variables(path: str) -> dict:
    """Inference variables ({'params'[, 'batch_stats']}) from a train
    checkpoint or variables ``.npz``, or a reference ``.pth``."""
    if path.endswith('.pth'):
        from sed_jax.compat.torch_loader import load_checkpoint_variables
        variables, _ = load_checkpoint_variables(path)
        return variables
    tree = npz_ckpt.load_variables_npz(path)
    out = {'params': tree['params']}
    if tree.get('batch_stats') is not None:
        out['batch_stats'] = tree['batch_stats']
    return out
