"""Extra training coverage: conformer train step, weak-only CLI driver."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax import losses
from sed_jax.config import AUDIO_16K, CLASSES_NUM, LABELS
from sed_jax.models.registry import get_model
from sed_jax.train.state import create_train_state
from sed_jax.train.step import make_train_step
import pytest

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow


def test_conformer_train_step():
    """Conformer blocks carry BatchNorm + dropout; one joint step must
    run and update finite params."""
    rng = np.random.RandomState(0)
    sr = AUDIO_16K.sample_rate
    model = get_model('Cnn_9layers_Conformer_FrameAtt', AUDIO_16K)
    weak = {
        'waveform': rng.uniform(-0.1, 0.1, (2, sr)).astype(np.float32),
        'target': (rng.rand(2, CLASSES_NUM) > 0.8).astype(np.float32),
    }
    strong = {
        'waveform': rng.uniform(-0.1, 0.1, (2, sr)).astype(np.float32),
        'strong_target': (rng.rand(2, 100, CLASSES_NUM) > 0.9)
        .astype(np.float32),
    }
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform']))
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=False, timeshift=False, spec_augment=True,
                           donate=False)
    state, metrics = step(state, weak, strong, jax.random.PRNGKey(1))
    assert np.isfinite(float(metrics['loss']))
    assert all(np.isfinite(np.asarray(p)).all()
               for p in jax.tree.leaves(state.params))


def test_weak_only_cli_driver(tmp_path):
    from sed_jax.cli import features as features_cli
    from sed_jax.cli import main as main_cli
    from sed_jax.data import audio_io

    cfg = AUDIO_16K
    rng = np.random.RandomState(1)
    dataset = tmp_path / 'dataset'
    ws = tmp_path / 'ws'
    meta = dataset / 'metadata'
    meta.mkdir(parents=True)
    for split in ('training', 'testing'):
        d = dataset / split
        d.mkdir()
        rows = []
        for i in range(4):
            name = f'{split}{i}_0.wav'
            audio_io.save_wav(str(d / name),
                              rng.uniform(-0.3, 0.3, cfg.sample_rate * 10),
                              cfg.sample_rate)
            rows.append(f'{split}{i},0.000,10.000,{LABELS[i % 3]},/m/x\n')
        (meta / f'{split}_set.csv').write_text(''.join(rows))
    (meta / 'groundtruth_strong_label_testing_set.csv').write_text(
        ''.join(f'testing{i}_0.wav,1.0,4.0,{LABELS[i % 3]}\n'
                for i in range(4)))

    for split in ('training', 'testing'):
        features_cli.main(['pack_audio_files_to_hdf5',
                           '--dataset_dir', str(dataset),
                           '--workspace', str(ws),
                           '--data_type', split, '--audio_16k'])

    main_cli.main(['train', '--dataset_dir', str(dataset),
                   '--workspace', str(ws),
                   '--model_type', 'Cnn_9layers_FrameAvg',
                   '--loss_type', 'clip_bce', '--augmentation', 'mixup',
                   '--batch_size', '2', '--feature_type', 'logmel',
                   '--audio_16k', '--stop_iteration', '2'])
    # two iterations, no eval checkpoint expected — just a clean exit and
    # a statistics dir
    assert os.path.isdir(os.path.join(str(ws), 'statistics'))


# ---------------------------------------------------------------------------
# dynamic loss scaling (bf16 training path)
# ---------------------------------------------------------------------------

def _scale_batches(rng, n=2, seconds=1):
    sr = AUDIO_16K.sample_rate
    weak = {
        'waveform': rng.uniform(-0.1, 0.1, (n, sr * seconds))
        .astype(np.float32),
        'target': (rng.rand(n, CLASSES_NUM) > 0.8).astype(np.float32),
    }
    strong = {
        'waveform': rng.uniform(-0.1, 0.1, (n, sr * seconds))
        .astype(np.float32),
        'strong_target': (rng.rand(n, 100 * seconds, CLASSES_NUM) > 0.9)
        .astype(np.float32),
    }
    return weak, strong


def test_loss_scaled_step_matches_unscaled_in_f32():
    """Power-of-two loss scaling is exact per-multiplication; the two
    programs still compile to different HLO fusions, so params match to
    float32 reassociation noise (~1e-7), not bitwise."""
    from sed_jax.train.step import init_loss_scale

    rng = np.random.RandomState(3)
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    weak, strong = _scale_batches(rng)
    kw = dict(mixup=False, timeshift=False, spec_augment=False,
              donate=False)
    plain = make_train_step(model, losses.clip_bce, losses.frame_bce,
                            **kw)
    scaled = make_train_step(model, losses.clip_bce, losses.frame_bce,
                             loss_scale='dynamic', **kw)
    s0 = create_train_state(model, jax.random.PRNGKey(0),
                            jnp.asarray(weak['waveform']))
    s1 = create_train_state(model, jax.random.PRNGKey(0),
                            jnp.asarray(weak['waveform']))
    ss = init_loss_scale()
    key = jax.random.PRNGKey(7)
    for i in range(3):
        k = jax.random.fold_in(key, i)
        s0, m0 = plain(s0, weak, strong, k)
        s1, m1, ss = scaled(s1, weak, strong, k, ss)
        assert bool(m1['grads_finite'])
        np.testing.assert_allclose(float(m0['loss']), float(m1['loss']),
                                   rtol=1e-6)
    # Adam's first-step update is ~±lr·sign(g): for near-zero gradients,
    # float32 reassociation noise between the two compiled programs can
    # flip the sign and move a handful of elements by up to ~2·lr.
    # The invariant is: losses identical (above), the overwhelming mass
    # of params identical to float noise, outliers bounded by lr quanta.
    for a, b in zip(jax.tree.leaves(s0.params), jax.tree.leaves(s1.params)):
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert d.mean() < 1e-6
        assert d.max() < 5e-3                  # a few lr=1e-3 quanta
        assert (d > 1e-5).mean() < 1e-3        # <0.1% of elements


def test_loss_scale_skips_nonfinite_step_and_backs_off():
    """A batch that produces nonfinite gradients must leave params,
    opt_state, step count AND batch_stats untouched, halve the scale,
    and reset the growth counter; training then continues finitely."""
    from sed_jax.train.step import init_loss_scale

    rng = np.random.RandomState(5)
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    weak, strong = _scale_batches(rng)
    scaled = make_train_step(model, losses.clip_bce, losses.frame_bce,
                             mixup=False, timeshift=False,
                             spec_augment=False, donate=False,
                             loss_scale='dynamic')
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform']))
    ss = init_loss_scale()
    key = jax.random.PRNGKey(11)
    state, m, ss = scaled(state, weak, strong, key, ss)
    assert bool(m['grads_finite']) and int(state.step) == 1
    scale_before = float(ss.scale)
    good_before = int(ss.good_steps)
    assert good_before == 1

    params_before = jax.tree.map(np.asarray, state.params)
    bs_before = jax.tree.map(np.asarray, state.batch_stats)
    poisoned = dict(weak)
    poisoned['waveform'] = weak['waveform'].copy()
    poisoned['waveform'][0, 0] = np.nan
    state, m, ss = scaled(state, poisoned, strong, key, ss)
    assert not bool(m['grads_finite'])
    assert int(state.step) == 1                      # step skipped
    assert float(ss.scale) == scale_before * 0.5     # backoff
    assert int(ss.good_steps) == 0                   # counter reset
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(params_before)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(jax.tree.leaves(state.batch_stats),
                    jax.tree.leaves(bs_before)):
        np.testing.assert_array_equal(np.asarray(a), b)

    # recovery: the next clean step applies normally
    state, m, ss = scaled(state, weak, strong, key, ss)
    assert bool(m['grads_finite']) and int(state.step) == 2


def test_loss_scale_grows_after_interval():
    from sed_jax.train.step import (LossScaleState, _GROWTH_INTERVAL,
                                    init_loss_scale, make_train_step)

    rng = np.random.RandomState(6)
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    weak, strong = _scale_batches(rng)
    scaled = make_train_step(model, losses.clip_bce, losses.frame_bce,
                             mixup=False, timeshift=False,
                             spec_augment=False, donate=False,
                             loss_scale='dynamic')
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform']))
    ss = init_loss_scale(1024.0)
    ss = LossScaleState(scale=ss.scale,
                        good_steps=jnp.int32(_GROWTH_INTERVAL - 1))
    state, m, ss = scaled(state, weak, strong, jax.random.PRNGKey(1), ss)
    assert float(ss.scale) == 2048.0
    assert int(ss.good_steps) == 0


def test_bf16_transformer_trains_finite_with_dynamic_scale():
    """The round-2 failure case: Cnn_9layers_Transformer_FrameAtt in
    bf16.  With dynamic loss scaling + nonfinite-step skip the params
    must stay finite (this is the fast CPU regression)."""
    from sed_jax.train.step import init_loss_scale

    rng = np.random.RandomState(9)
    model = get_model('Cnn_9layers_Transformer_FrameAtt', AUDIO_16K,
                      compute_dtype=jnp.bfloat16)
    weak, strong = _scale_batches(rng)
    scaled = make_train_step(model, losses.clip_bce, losses.frame_bce,
                             mixup=False, timeshift=False,
                             spec_augment=True, donate=False,
                             loss_scale='dynamic')
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform']),
                               learning_rate=1e-3)
    ss = init_loss_scale()
    key = jax.random.PRNGKey(21)
    for i in range(6):
        state, m, ss = scaled(state, weak, strong,
                              jax.random.fold_in(key, i), ss)
        assert np.isfinite(float(m['loss'])) or not bool(m['grads_finite'])
    assert all(np.isfinite(np.asarray(p)).all()
               for p in jax.tree.leaves(state.params))
    assert int(state.step) >= 1
