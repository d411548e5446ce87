"""The in-repo module system (``sed_jax.models.nn``).

* Every registry model initialises exactly the variable tree (paths and
  shapes of ``params`` and ``batch_stats``) the flax.linen models had;
  ``fixtures_variable_trees.json`` was recorded from those models, so
  checkpoints and the ``.pth`` mapping keep their paths.
* Each layer matches ``flax.linen`` on the same variables, where flax is
  installed (it is only a test oracle here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sed_jax.config import AUDIO_16K
from sed_jax.models import nn
from sed_jax.models.registry import MODEL_REGISTRY, get_model

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'fixtures_variable_trees.json')


def _paths_and_shapes(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {'/'.join(k.key for k in path): list(leaf.shape)
            for path, leaf in leaves}


@pytest.mark.parametrize('name', sorted(MODEL_REGISTRY))
def test_variable_tree_matches_flax_fixture(name):
    with open(FIXTURE) as f:
        want = json.load(f)[name]
    model = get_model(name, AUDIO_16K)
    wav = jax.ShapeDtypeStruct((1, AUDIO_16K.audio_samples), jnp.float32)
    variables = jax.eval_shape(
        lambda w: model.init({'params': jax.random.PRNGKey(0)}, w,
                             train=False), wav)
    got = {col: _paths_and_shapes(tree) for col, tree in variables.items()}
    assert got == want


# ---------------------------------------------------------------------------
# layer parity with flax.linen
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(0)
X4 = jnp.asarray(RNG.randn(2, 9, 7, 3).astype(np.float32))   # (B, T, F, C)
X3 = jnp.asarray(RNG.randn(2, 11, 6).astype(np.float32))     # (B, T, D)


def _layer_cases(flax_nn):
    """(ours, flax's, input) pairs built with the same settings."""
    return {
        'dense': (nn.Dense(5), flax_nn.Dense(5), X3),
        'conv_same': (nn.Conv(4, (3, 3), use_bias=False, padding='SAME'),
                      flax_nn.Conv(4, (3, 3), use_bias=False,
                                   padding='SAME'), X4),
        'conv_strided_valid': (
            nn.Conv(4, (3, 3), strides=(2, 2), padding='VALID'),
            flax_nn.Conv(4, (3, 3), strides=(2, 2), padding='VALID'), X4),
        'conv_depthwise_1d': (
            nn.Conv(6, (5,), padding=[(2, 2)], feature_group_count=6),
            flax_nn.Conv(6, (5,), padding=[(2, 2)],
                         feature_group_count=6), X3),
        'layer_norm': (nn.LayerNorm(epsilon=1e-5),
                       flax_nn.LayerNorm(epsilon=1e-5), X3),
    }


@pytest.mark.parametrize('case', ['dense', 'conv_same', 'conv_strided_valid',
                                  'conv_depthwise_1d', 'layer_norm'])
def test_layer_matches_flax(case):
    flax_nn = pytest.importorskip('flax.linen')
    ours, theirs, x = _layer_cases(flax_nn)[case]
    variables = theirs.init(jax.random.PRNGKey(1), x)
    # random (not init-valued) parameters so every term is exercised
    variables = jax.tree.map(
        lambda v: jnp.asarray(RNG.randn(*v.shape).astype(np.float32)),
        variables)
    assert jax.tree.structure(ours.init(jax.random.PRNGKey(1), x)) == \
        jax.tree.structure(variables)
    np.testing.assert_allclose(np.asarray(ours.apply(variables, x)),
                               np.asarray(theirs.apply(variables, x)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_batch_norm_matches_flax(train):
    """Running statistics in eval; batch statistics and the running
    update (momentum 0.9, over the mel axis as bn0 uses it) in train."""
    flax_nn = pytest.importorskip('flax.linen')
    kw = dict(use_running_average=not train, momentum=0.9, epsilon=1e-5,
              axis=2)
    ours, theirs = nn.BatchNorm(**kw), flax_nn.BatchNorm(**kw)
    variables = {
        'params': {'scale': jnp.asarray(RNG.rand(7) + 0.5, jnp.float32),
                   'bias': jnp.asarray(RNG.randn(7), jnp.float32)},
        'batch_stats': {'mean': jnp.asarray(RNG.randn(7), jnp.float32),
                        'var': jnp.asarray(RNG.rand(7) + 0.5,
                                           jnp.float32)}}
    if train:
        got, got_vars = ours.apply(variables, X4, mutable=['batch_stats'])
        want, want_vars = theirs.apply(variables, X4,
                                       mutable=['batch_stats'])
        for a, b in zip(jax.tree.leaves(got_vars),
                        jax.tree.leaves(dict(want_vars))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
    else:
        got, want = ours.apply(variables, X4), theirs.apply(variables, X4)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kind', ['avg', 'max'])
def test_pooling_matches_flax(kind):
    flax_nn = pytest.importorskip('flax.linen')
    ours = getattr(nn, f'{kind}_pool')
    theirs = getattr(flax_nn, f'{kind}_pool')
    for window, strides, padding in (((2, 2), (2, 2), 'VALID'),
                                     ((3, 1), (1, 1), [(1, 1), (0, 0)])):
        np.testing.assert_allclose(
            np.asarray(ours(X4, window, strides=strides, padding=padding)),
            np.asarray(theirs(X4, window, strides=strides,
                              padding=padding)), rtol=1e-6, atol=1e-6)


def test_dropout_and_rng_streams():
    """Dropout draws from the 'dropout' stream (same key, same mask) and
    is the identity when deterministic; a missing stream is an error."""
    class Block(nn.Module):
        @nn.compact
        def __call__(self, x, train):
            return nn.Dropout(0.5, deterministic=not train)(x)

    x = jnp.ones((4, 64))
    block = Block()
    assert block.init({}, x, False) == {}
    a = block.apply({}, x, True, rngs={'dropout': jax.random.PRNGKey(0)})
    b = block.apply({}, x, True, rngs={'dropout': jax.random.PRNGKey(0)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(np.unique(np.asarray(a))) == {0.0, 2.0}
    np.testing.assert_array_equal(np.asarray(block.apply({}, x, False)), x)
    with pytest.raises(ValueError, match='dropout'):
        block.apply({}, x, True)


def test_automatic_names_and_missing_variables():
    """Unnamed submodules are named ``Class_<n>`` in construction order
    per parent call, as in flax (the outer Dense below is built first);
    apply with a variable missing raises naming its path."""
    class Two(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(3)(nn.Dense(4)(x))

    x = jnp.ones((2, 5))
    variables = Two().init(jax.random.PRNGKey(0), x)
    assert _paths_and_shapes(variables['params']) == {
        'Dense_0/bias': [3], 'Dense_0/kernel': [4, 3],
        'Dense_1/bias': [4], 'Dense_1/kernel': [5, 4]}
    del variables['params']['Dense_1']['bias']
    with pytest.raises(KeyError, match='params/Dense_1/bias'):
        Two().apply(variables, x)
