"""Model zoo tests: shapes, param counts vs thesis, torch-oracle parity.

torch (CPU) is used only as a numerical oracle for layer semantics
(``torch.nn.GRU`` gate order, conv layout); no reference code is involved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, CLASSES_NUM
from sed_jax.models import blocks
from sed_jax.models.registry import get_model, MODEL_REGISTRY

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

RNGS = {'params': jax.random.PRNGKey(0)}
TRAIN_RNGS = {'params': jax.random.PRNGKey(0),
              'dropout': jax.random.PRNGKey(1),
              'augment': jax.random.PRNGKey(2)}


def _param_count(params):
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))


# models whose outputs are logits rather than probabilities (the
# token-pooling SEDModel family trains with *_logits losses), and models
# whose framewise length differs from the 1000-frame contract
LOGIT_MODELS = {'Cnn_7layers_Conformer', 'Cnn_9layers_Conformer'}
# Cnn_9layers_Conformer: no interpolation, but the reference's T x F
# flatten (models.py:2156) makes 10 s clips emit 125*8 = 1000 frame
# tokens anyway, so no override is needed.
FRAMES_OVERRIDE = {}


@pytest.mark.parametrize('name', sorted(MODEL_REGISTRY))
def test_model_shapes_10s_clip(name):
    model = get_model(name, AUDIO_16K)
    wav = jnp.zeros((2, AUDIO_16K.audio_samples), jnp.float32)
    variables = model.init(RNGS, wav, train=False)
    out = model.apply(variables, wav, train=False)
    frames = FRAMES_OVERRIDE.get(name, 1000)
    assert out['clipwise_output'].shape == (2, CLASSES_NUM)
    assert out['framewise_output'].shape == (2, frames, CLASSES_NUM)
    fw = np.asarray(out['framewise_output'])
    cw = np.asarray(out['clipwise_output'])
    assert np.isfinite(fw).all() and np.isfinite(cw).all()
    if name not in LOGIT_MODELS:
        eps = 1e-5  # attention pooling can overshoot 1.0 by float error
        assert np.all((fw >= 0) & (fw <= 1 + eps))
        assert np.all((cw >= 0) & (cw <= 1 + eps))


def test_param_counts_match_thesis():
    """Thesis table (Results_and_Discussion.tex:109): GRU-Att 5,894,692 and
    Transformer-Att 5,763,620.  Ours differ only by the reference's dead
    parameters: AttBlock.bn_att (50) and MultiHead.layer_norm (1024),
    which exist in torch but are never used in forward
    (``pytorch/models.py:154,842``)."""
    wav = jnp.zeros((1, AUDIO_16K.audio_samples), jnp.float32)

    gru = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    v = gru.init(RNGS, wav, train=False)
    assert _param_count(v['params']) == 5_894_692 - 50

    tr = get_model('Cnn_9layers_Transformer_FrameAtt', AUDIO_16K)
    v = tr.init(RNGS, wav, train=False)
    assert _param_count(v['params']) == 5_763_620 - 50 - 1024


def test_gru_matches_torch_oracle():
    torch = pytest.importorskip('torch')
    B, T, D, H = 3, 17, 8, 16
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, D).astype(np.float32)

    t_gru = torch.nn.GRU(D, H, num_layers=1, bias=True, batch_first=True,
                         bidirectional=True)
    sd = t_gru.state_dict()

    model = blocks.BiGRU(H)
    params = {
        'fw': {'w_ih': jnp.asarray(sd['weight_ih_l0'].numpy()),
               'w_hh': jnp.asarray(sd['weight_hh_l0'].numpy()),
               'b_ih': jnp.asarray(sd['bias_ih_l0'].numpy()),
               'b_hh': jnp.asarray(sd['bias_hh_l0'].numpy())},
        'bw': {'w_ih': jnp.asarray(sd['weight_ih_l0_reverse'].numpy()),
               'w_hh': jnp.asarray(sd['weight_hh_l0_reverse'].numpy()),
               'b_ih': jnp.asarray(sd['bias_ih_l0_reverse'].numpy()),
               'b_hh': jnp.asarray(sd['bias_hh_l0_reverse'].numpy())},
    }
    got = np.asarray(model.apply({'params': params}, jnp.asarray(x)))
    with torch.no_grad():
        want, _ = t_gru(torch.from_numpy(x))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5)


def test_convblock_matches_torch_oracle():
    torch = pytest.importorskip('torch')
    rng = np.random.RandomState(1)
    B, T, F_, CIN, COUT = 2, 16, 8, 3, 4
    x = rng.randn(B, T, F_, CIN).astype(np.float32)

    conv1 = torch.nn.Conv2d(CIN, COUT, 3, padding=1, bias=False)
    conv2 = torch.nn.Conv2d(COUT, COUT, 3, padding=1, bias=False)
    bn1 = torch.nn.BatchNorm2d(COUT).eval()
    bn2 = torch.nn.BatchNorm2d(COUT).eval()
    for bn in (bn1, bn2):
        bn.running_mean.copy_(torch.from_numpy(
            rng.randn(COUT).astype(np.float32) * 0.1))
        bn.running_var.copy_(torch.from_numpy(
            rng.rand(COUT).astype(np.float32) + 0.5))
        bn.weight.data.copy_(torch.from_numpy(
            rng.rand(COUT).astype(np.float32) + 0.5))
        bn.bias.data.copy_(torch.from_numpy(
            rng.randn(COUT).astype(np.float32) * 0.1))

    with torch.no_grad():
        t = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW
        t = torch.relu(bn1(conv1(t)))
        t = torch.relu(bn2(conv2(t)))
        t = torch.nn.functional.avg_pool2d(t, 2)
        want = t.permute(0, 2, 3, 1).numpy()

    def k(c):  # torch OIHW -> flax HWIO
        return jnp.asarray(c.weight.detach().numpy().transpose(2, 3, 1, 0))

    variables = {
        'params': {
            'conv1': {'kernel': k(conv1)},
            'conv2': {'kernel': k(conv2)},
            'bn1': {'scale': jnp.asarray(bn1.weight.detach().numpy()),
                    'bias': jnp.asarray(bn1.bias.detach().numpy())},
            'bn2': {'scale': jnp.asarray(bn2.weight.detach().numpy()),
                    'bias': jnp.asarray(bn2.bias.detach().numpy())},
        },
        'batch_stats': {
            'bn1': {'mean': jnp.asarray(bn1.running_mean.numpy()),
                    'var': jnp.asarray(bn1.running_var.numpy())},
            'bn2': {'mean': jnp.asarray(bn2.running_mean.numpy()),
                    'var': jnp.asarray(bn2.running_var.numpy())},
        },
    }
    got = np.asarray(blocks.ConvBlock(COUT).apply(
        variables, jnp.asarray(x), False, (2, 2), 'avg'))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_train_mode_with_mixup_halves_batch():
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    wav = jnp.zeros((4, AUDIO_16K.audio_samples), jnp.float32)
    variables = model.init(TRAIN_RNGS, wav, train=False)
    lam = jnp.asarray([0.3, 0.7, 0.9, 0.1])
    out, _ = model.apply(
        variables, wav, train=True, mixup_lambda=lam, timeshift=False,
        spec_augment=True, rngs={'dropout': jax.random.PRNGKey(3),
                                 'augment': jax.random.PRNGKey(4)},
        mutable=['batch_stats'])
    assert out['clipwise_output'].shape == (2, CLASSES_NUM)


def test_shorter_window_pads_to_roundup():
    """5 s windows: 501 frames -> 62 pooled -> 496 -> padded to 500
    (``pytorch/models.py:680-681``)."""
    model = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    wav = jnp.zeros((1, AUDIO_16K.sample_rate * 5), jnp.float32)
    variables = model.init(RNGS, wav, train=False)
    out = model.apply(variables, wav, train=False)
    assert out['framewise_output'].shape == (1, 500, CLASSES_NUM)


def test_bf16_compute_dtype_close_to_f32():
    """Opt-in bfloat16 conv compute stays close to the f32 reference."""
    wav = jnp.asarray(np.random.RandomState(0).uniform(
        -0.3, 0.3, (1, AUDIO_16K.sample_rate * 2)).astype(np.float32))
    f32 = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K)
    variables = f32.init(RNGS, wav, train=False)
    bf16 = get_model('Cnn_9layers_Gru_FrameAtt', AUDIO_16K,
                     compute_dtype=jnp.bfloat16)
    out32 = f32.apply(variables, wav, train=False)
    out16 = bf16.apply(variables, wav, train=False)
    assert out16['framewise_output'].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(out16['clipwise_output']),
                               np.asarray(out32['clipwise_output']),
                               atol=0.05)


def test_interpolate_and_pad_helpers():
    x = jnp.asarray(np.arange(6, dtype=np.float32).reshape(1, 3, 2))
    up = blocks.interpolate(x, 2)
    assert up.shape == (1, 6, 2)
    np.testing.assert_array_equal(np.asarray(up[0, :2, 0]), [0, 0])
    padded = blocks.pad_framewise_output(x, 5)
    assert padded.shape == (1, 5, 2)
    np.testing.assert_array_equal(np.asarray(padded[0, -1]),
                                  np.asarray(x[0, -1]))
    assert blocks.roundup(496) == 500 and blocks.roundup(1000) == 1000


def test_parameter_counts_vs_thesis_table():
    """Pin trainable-parameter totals against the thesis table
    (``Results_and_Discussion.tex:109``: 5,894,692 / 5,763,620 /
    6,280,493; BASELINE.md).  The rebuild counts slightly less because
    the reference's totals include modules that are INITIALIZED BUT
    NEVER CALLED in forward() — verified head-to-head against the
    actual ``pytorch/models.py``:

      * ``AttBlock.bn_att`` (50 params @17 classes, 2 x n_out when
        n_out=25): built in ``models.py:153`` and absent from
        ``AttBlock.forward`` (``models.py:161-169``);
      * the transformer head's ``multihead.layer_norm`` (1,024);
      * the conformer head's ``classifier`` (2,465) and ``linear_emb``
        (1,024) — and the thesis's conformer figure itself disagrees
        with the current reference code (6,279,333) by a further 1,160,
        i.e. the thesis used an earlier revision.

    Full-forward output parity with the actual reference models is
    pinned separately (test_reference_model_oracle.py), which is what
    proves these omitted modules are dead code."""
    import jax
    from sed_jax.config import AUDIO_16K
    from sed_jax.models.registry import get_model

    expect = {
        # ours = thesis - (dead modules)
        'Cnn_9layers_Gru_FrameAtt': (5894692, 50),
        'Cnn_9layers_Transformer_FrameAtt': (5763620, 50 + 1024),
        # conformer: vs the reference CODE (see docstring)
        'Cnn_9layers_Conformer_FrameAtt': (6279333, 50 + 2465 + 1024),
    }
    for name, (ref_total, dead) in expect.items():
        model = get_model(name, AUDIO_16K)
        v = model.init({'params': jax.random.PRNGKey(0)},
                       np.zeros((1, 80000), np.float32), train=False)
        n = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(v['params']))
        assert n == ref_total - dead, (name, n, ref_total, dead)
