"""Losses (torch-oracle) and joint train-step tests, incl. 8-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sed_jax import losses
from sed_jax.config import AUDIO_16K, CLASSES_NUM
from sed_jax.models.registry import get_model
from sed_jax.parallel import mesh as mesh_lib
from sed_jax.train.state import create_train_state
from sed_jax.train.step import make_train_step, make_eval_step

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow


def test_bce_losses_match_torch():
    torch = pytest.importorskip('torch')
    rng = np.random.RandomState(0)
    p = rng.uniform(0.01, 0.99, (4, CLASSES_NUM)).astype(np.float32)
    t = (rng.rand(4, CLASSES_NUM) > 0.5).astype(np.float32)
    got = float(losses.clip_bce({'clipwise_output': jnp.asarray(p)},
                                {'target': jnp.asarray(t)}))
    want = float(torch.nn.functional.binary_cross_entropy(
        torch.from_numpy(p), torch.from_numpy(t)))
    assert abs(got - want) < 1e-6

    logits = rng.randn(4, CLASSES_NUM).astype(np.float32)
    got = float(losses.clip_bce_logits(
        {'clipwise_output': jnp.asarray(logits)}, {'target': jnp.asarray(t)}))
    want = float(torch.nn.functional.binary_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(t)))
    assert abs(got - want) < 1e-6


def test_bce_grad_finite_at_saturation():
    """Regression: saturated sigmoid outputs (exact 0.0/1.0 in f32) must
    give finite gradients matching torch's clamped backward."""
    torch = pytest.importorskip('torch')
    p = np.asarray([[1.0, 0.0, 0.5, 1.0]], np.float32)
    t = np.asarray([[0.0, 1.0, 1.0, 1.0]], np.float32)

    def loss(p_):
        return losses.clip_bce({'clipwise_output': p_},
                               {'target': jnp.asarray(t)})

    g = jax.grad(loss)(jnp.asarray(p))
    assert np.isfinite(np.asarray(g)).all()

    tp = torch.from_numpy(p).requires_grad_(True)
    tl = torch.nn.functional.binary_cross_entropy(tp, torch.from_numpy(t))
    tl.backward()
    np.testing.assert_allclose(np.asarray(g), tp.grad.numpy(), rtol=1e-5)


def test_frame_bce_truncates_to_min_frames():
    rng = np.random.RandomState(1)
    out = jnp.asarray(rng.uniform(0.01, 0.99, (2, 96, 5)).astype(np.float32))
    tgt = jnp.asarray((rng.rand(2, 100, 5) > 0.5).astype(np.float32))
    v = losses.frame_bce({'framewise_output': out}, {'strong_target': tgt})
    v2 = losses.frame_bce({'framewise_output': out},
                          {'strong_target': tgt[:, :96]})
    assert np.isclose(float(v), float(v2))


def _tiny_batches(rng, n_weak=4, n_strong=2, seconds=1):
    sr = AUDIO_16K.sample_rate
    weak = {
        'waveform': rng.uniform(-0.1, 0.1,
                                (n_weak, sr * seconds)).astype(np.float32),
        'target': (rng.rand(n_weak, CLASSES_NUM) > 0.8).astype(np.float32),
        'mixup_lambda': np.repeat(rng.rand(n_weak // 2), 2)
        .astype(np.float32),
    }
    strong = {
        'waveform': rng.uniform(-0.1, 0.1,
                                (n_strong, sr * seconds)).astype(np.float32),
        'strong_target': (rng.rand(n_strong, 100 * seconds, CLASSES_NUM)
                          > 0.9).astype(np.float32),
        'mixup_lambda': np.repeat(rng.rand(n_strong // 2), 2)
        .astype(np.float32),
    }
    return weak, strong


def test_joint_train_step_reduces_loss():
    rng = np.random.RandomState(0)
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    weak, strong = _tiny_batches(rng)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform']),
                               learning_rate=1e-3)
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=True, timeshift=True, spec_augment=True,
                           donate=False)
    key = jax.random.PRNGKey(42)
    state, m0 = step(state, weak, strong, key)
    losses_seen = [float(m0['loss'])]
    for i in range(4):
        state, m = step(state, weak, strong, jax.random.fold_in(key, i))
        losses_seen.append(float(m['loss']))
    assert np.isfinite(losses_seen).all()
    assert losses_seen[-1] < losses_seen[0]
    assert int(state.step) == 5


def test_train_step_on_8_device_mesh():
    assert jax.device_count() >= 8, 'conftest must provide 8 CPU devices'
    mesh = mesh_lib.make_mesh(8)
    rng = np.random.RandomState(1)
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    weak, strong = _tiny_batches(rng, n_weak=16, n_strong=8)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform'][:1]))
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=True, timeshift=False, spec_augment=True,
                           mesh=mesh, donate=False)
    state = jax.device_put(state, mesh_lib.replicated_sharding(mesh))
    weak = mesh_lib.shard_batch(weak, mesh)
    strong = mesh_lib.shard_batch(strong, mesh)
    state, metrics = step(state, weak, strong, jax.random.PRNGKey(7))
    assert np.isfinite(float(metrics['loss']))
    # params remain replicated
    p = jax.tree.leaves(state.params)[0]
    assert p.sharding.is_fully_replicated


def test_fsdp_hybrid_mesh_train_step():
    """Hybrid data x model mesh: batch sharded over 'data', large params
    FSDP-sharded over 'model'; one jitted step must run and keep the
    parameter shardings."""
    assert jax.device_count() >= 8
    mesh = mesh_lib.make_mesh(8, axis_names=('data', 'model'),
                              shape=(2, 4))
    rng = np.random.RandomState(2)
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    weak, strong = _tiny_batches(rng, n_weak=4, n_strong=2)
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(weak['waveform'][:1]))
    state_sharding = mesh_lib.fsdp_shardings(state, mesh, axis='model',
                                             min_size=4096)
    state = jax.device_put(state, state_sharding)
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=True, timeshift=False, spec_augment=True,
                           mesh=mesh, donate=False,
                           state_sharding=state_sharding)
    weak = mesh_lib.shard_batch(weak, mesh)
    strong = mesh_lib.shard_batch(strong, mesh)
    state, metrics = step(state, weak, strong, jax.random.PRNGKey(3))
    assert np.isfinite(float(metrics['loss']))
    # a large conv kernel must actually be sharded over 'model'
    k = state.params['conv_block4']['conv2']['kernel']
    assert not k.sharding.is_fully_replicated


def test_eval_step_matches_direct_apply():
    model = get_model('Cnn_9layers_FrameAvg', AUDIO_16K)
    wav = jnp.zeros((2, AUDIO_16K.sample_rate), jnp.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, wav,
                           train=False)
    es = make_eval_step(model)
    out = es(variables['params'], variables.get('batch_stats'), wav)
    direct = model.apply(variables, wav, train=False)
    np.testing.assert_allclose(np.asarray(out['clipwise_output']),
                               np.asarray(direct['clipwise_output']),
                               rtol=1e-6)


def test_device_prefetch_order_and_errors():
    """device_prefetch must yield items in order (as device arrays) and
    re-raise producer exceptions at the consuming next()."""
    from sed_jax.train.prefetch import device_prefetch

    items = [{'a': np.full((4,), i, np.float32)} for i in range(10)]
    out = list(device_prefetch(iter(items), size=2))
    assert len(out) == 10
    for i, o in enumerate(out):
        assert isinstance(o['a'], jax.Array)
        np.testing.assert_array_equal(np.asarray(o['a']), items[i]['a'])

    def bad():
        yield items[0]
        raise ValueError('boom')

    it = device_prefetch(bad(), size=2)
    next(it)
    with pytest.raises(ValueError, match='boom'):
        next(it)
        next(it)


def test_device_prefetch_stops_when_abandoned():
    """Closing/abandoning the prefetch generator must stop the producer
    thread instead of letting it draw from the source pipeline for the
    rest of the process (train loops break at stop_iteration)."""
    import time
    from sed_jax.train.prefetch import device_prefetch

    drawn = [0]

    def src():
        while True:
            drawn[0] += 1
            yield {'a': np.zeros((2,), np.float32)}

    it = device_prefetch(src(), size=2)
    next(it)
    next(it)
    it.close()                     # what a returning train loop does
    time.sleep(0.6)                # let a parked producer notice
    n = drawn[0]
    time.sleep(0.6)
    assert drawn[0] == n           # no further draws after close
