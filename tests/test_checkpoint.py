"""npz checkpoint save/restore round trip + lineage + structure check."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from sed_jax.config import AUDIO_16K
from sed_jax.models.registry import get_model
import pytest

from sed_jax.train.checkpoint import (best_checkpoint_path, load_variables,
                                      restore_checkpoint,
                                      resume_checkpoint_path,
                                      save_best_checkpoint, save_checkpoint)
from sed_jax.train.state import create_train_state


def test_save_restore_roundtrip(tmp_path):
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    wav = jnp.zeros((1, AUDIO_16K.sample_rate), jnp.float32)
    state = create_train_state(model, jax.random.PRNGKey(0), wav)
    # take a step so opt_state is non-trivial
    grads = jax.tree.map(jnp.ones_like, state.params)
    state = state.apply_gradients(grads=grads)

    path = str(tmp_path / 'ckpt.npz')
    save_checkpoint(path, state)

    fresh = create_train_state(model, jax.random.PRNGKey(1), wav)
    restored = restore_checkpoint(path, fresh)
    assert int(restored.step) == 1
    for a, b in zip(jax.tree.leaves(restored.params),
                    jax.tree.leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(restored.opt_state),
                    jax.tree.leaves(state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # inference-path loader reads the same file
    variables = load_variables(path)
    assert 'params' in variables and 'batch_stats' in variables
    out = model.apply(variables, wav, train=False)
    assert out['clipwise_output'].shape == (1, 25)


def test_step_tagged_lineage_and_resume_at_iteration(tmp_path):
    """``--resume_iteration N`` restores the checkpoint saved AT N
    (``pytorch/main_strong.py:205-213``), not whatever best came later."""
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    wav = jnp.zeros((1, AUDIO_16K.sample_rate), jnp.float32)
    state = create_train_state(model, jax.random.PRNGKey(0), wav)
    grads = jax.tree.map(jnp.ones_like, state.params)

    ckpt_dir = str(tmp_path / 'best_logmel_16k')
    state = state.apply_gradients(grads=grads)          # step 1
    save_best_checkpoint(ckpt_dir, state)
    params_at_1 = jax.tree.leaves(state.params)
    for _ in range(2):
        state = state.apply_gradients(grads=grads)      # step 3
    save_best_checkpoint(ckpt_dir, state)

    # BEST marker points at the latest save
    assert best_checkpoint_path(ckpt_dir).endswith('iter_3.npz')
    # exact-iteration resume
    fresh = create_train_state(model, jax.random.PRNGKey(1), wav)
    restored = restore_checkpoint(resume_checkpoint_path(ckpt_dir, 1),
                                  fresh)
    assert int(restored.step) == 1
    for a, b in zip(jax.tree.leaves(restored.params), params_at_1):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a never-saved iteration raises, listing what exists
    with pytest.raises(FileNotFoundError, match=r'\[1, 3\]'):
        resume_checkpoint_path(ckpt_dir, 2)
    # without the marker the highest saved iteration is the best
    os.remove(os.path.join(ckpt_dir, 'BEST'))
    assert best_checkpoint_path(ckpt_dir).endswith('iter_3.npz')
    # a checkpoint of another model fails the structure check
    other = create_train_state(get_model('Cnn_9layers_FrameAtt', AUDIO_16K),
                               jax.random.PRNGKey(2), wav)
    with pytest.raises(ValueError, match='does not match'):
        restore_checkpoint(resume_checkpoint_path(ckpt_dir, 3), other)


def test_resume_rejects_non_checkpoint_directory(tmp_path):
    """A typo'd or junk-filled --resume path must raise the clear
    FileNotFoundError listing the saved iterations."""
    junk = tmp_path / 'not_a_checkpoint'
    junk.mkdir()
    (junk / 'notes.txt').write_text('hello')
    with pytest.raises(FileNotFoundError, match='no checkpoint'):
        resume_checkpoint_path(str(junk), 5)
    assert best_checkpoint_path(str(junk)) is None
