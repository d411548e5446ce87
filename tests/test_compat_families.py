"""``.pth`` checkpoint compatibility for every non-GRU model family.

Each test builds a torch oracle with the reference's EXACT state-dict key
names (including Sequential indices, registered buffers like ``pe`` /
``inv_freq``, and unused-parameter quirks), saves it with ``torch.save``,
loads it through the pure-python reader + key mapper, and asserts
full-forward parity with the corresponding registry model.

Oracles mirror:
  * ``pytorch/models.py:823-877``   MultiHead (Transformer family)
  * ``pytorch/models_2020/conformer/*``  ConformerEncoder
  * ``pytorch/models_2020/baseline_model.py``  DCASE baseline CNN
  * ``pytorch/models.py:2219-2384`` VGGish(+FrameAtt)
  * ``pytorch/models.py:2685-2783`` Cnn14_DecisionLevelAtt
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from sed_jax.config import AUDIO_16K  # noqa: E402
from sed_jax.compat.torch_loader import load_checkpoint_variables  # noqa: E402
from sed_jax.dsp.frontend import LogmelFrontend  # noqa: E402
from sed_jax.models.registry import get_model  # noqa: E402

from test_compat import (_TorchAttBlock, _TorchConvBlock,  # noqa: E402
                          _randomize_bn_stats)

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow

CFG = AUDIO_16K


def _interpolate(x, ratio):
    """upsample by frame repetition (``utils/utilities.py`` interpolate)."""
    return x.repeat_interleave(ratio, dim=1)


def _pad_framewise(x, frames_num):
    pad = x[:, -1:, :].repeat(1, frames_num - x.shape[1], 1)
    return torch.cat([x, pad], dim=1)


def _roundtrip(oracle, model_type, wav, tol=1e-4):
    """save -> pure-python load -> flax forward -> compare with torch."""
    import tempfile
    import os
    feat = np.asarray(LogmelFrontend(CFG)(jnp.asarray(wav)))
    with torch.no_grad():
        want_frame, want_clip = oracle(torch.from_numpy(feat))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'ckpt.pth')
        torch.save({'iteration': 7, 'model': oracle.state_dict()}, path)
        variables, it = load_checkpoint_variables(path)
    assert it == 7
    model = get_model(model_type, CFG)
    out = model.apply(variables, jnp.asarray(wav), train=False)
    np.testing.assert_allclose(np.asarray(out['clipwise_output']),
                               want_clip.numpy(), rtol=1e-3, atol=tol)
    np.testing.assert_allclose(np.asarray(out['framewise_output']),
                               want_frame.numpy(), rtol=1e-3, atol=tol)


# ---------------------------------------------------------------------------
# Transformer family (single-block MultiHead, models.py:823-877)
# ---------------------------------------------------------------------------

class _TorchMultiHead(torch.nn.Module):
    def __init__(self, n_head=8, d_model=512, d_k=64, d_v=64):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = torch.nn.Linear(d_model, n_head * d_k)
        self.w_ks = torch.nn.Linear(d_model, n_head * d_k)
        self.w_vs = torch.nn.Linear(d_model, n_head * d_v)
        self.layer_norm = torch.nn.LayerNorm(d_model)   # dead, like the ref
        self.fc = torch.nn.Linear(n_head * d_v, d_model)

    def forward(self, x):
        b, t, _ = x.shape
        h, dk, dv = self.n_head, self.d_k, self.d_v
        q = self.w_qs(x).view(b, t, h, dk).permute(2, 0, 1, 3) \
            .reshape(-1, t, dk)
        k = self.w_ks(x).view(b, t, h, dk).permute(2, 0, 1, 3) \
            .reshape(-1, t, dk)
        v = self.w_vs(x).view(b, t, h, dv).permute(2, 0, 1, 3) \
            .reshape(-1, t, dv)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2))
                             / math.sqrt(dk), dim=2)
        out = torch.bmm(attn, v).view(h, b, t, dv)
        out = out.permute(1, 2, 0, 3).reshape(b, t, -1)
        return torch.relu(self.fc(out))


class _TorchTransformerAttOracle(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(64)
        self.conv_block1 = _TorchConvBlock(1, 64)
        self.conv_block2 = _TorchConvBlock(64, 128)
        self.conv_block3 = _TorchConvBlock(128, 256)
        self.conv_block4 = _TorchConvBlock(256, 512)
        self.multihead = _TorchMultiHead()
        self.att_block = _TorchAttBlock(512, 25)

    def forward(self, feat):
        x = feat[:, None, :, :]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        x = self.conv_block1(x, (2, 2))
        x = self.conv_block2(x, (2, 2))
        x = self.conv_block3(x, (2, 2))
        x = self.conv_block4(x, (1, 1))
        x = torch.mean(x, dim=3).transpose(1, 2)
        x = self.multihead(x).transpose(1, 2)
        clipwise, cla = self.att_block(x)
        return _interpolate(cla.transpose(1, 2), 8), clipwise


def test_transformer_family_pth_parity():
    torch.manual_seed(1)
    rng = np.random.RandomState(1)
    oracle = _TorchTransformerAttOracle().eval()
    _randomize_bn_stats(oracle, rng)
    wav = rng.uniform(-0.5, 0.5, (2, CFG.sample_rate * 5)).astype(np.float32)
    _roundtrip(oracle, 'Cnn_9layers_Transformer_FrameAtt', wav)


# ---------------------------------------------------------------------------
# Conformer encoder (models_2020/conformer/*)
# ---------------------------------------------------------------------------

class _Swish(torch.nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class _GLU(torch.nn.Module):
    def forward(self, x):
        return torch.nn.functional.glu(x)


class _Permute(torch.nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(*self.dims)


class _PointWise(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = torch.nn.Conv1d(cin, cout, 1, 1, 0)

    def forward(self, x):
        return self.conv(x.permute(0, 2, 1)).permute(0, 2, 1)


class _DepthWise(torch.nn.Module):
    def __init__(self, ch, k):
        super().__init__()
        self.conv = torch.nn.Conv1d(ch, ch, k, 1, k // 2, groups=ch)

    def forward(self, x):
        return self.conv(x.permute(0, 2, 1)).permute(0, 2, 1)


class _TorchPositionalEncoding(torch.nn.Module):
    """transformer/embedding.py:8-33, with the ``pe`` buffer."""

    def __init__(self, d_model, max_len=5000):
        super().__init__()
        pe = torch.zeros(max_len, d_model)
        position = torch.arange(0, max_len, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                        * -(math.log(10000.0) / d_model))
        pe[:, 0::2] = torch.sin(position * div)
        pe[:, 1::2] = torch.cos(position * div)
        self.register_buffer('pe', pe[None])
        self.xscale = math.sqrt(d_model)

    def forward(self, x):
        return x * self.xscale + self.pe[:, :x.size(1)]


class _TorchPosEmb(torch.nn.Module):
    """conformer/attention.py:125-142, with the ``inv_freq`` buffer."""

    def __init__(self, demb):
        super().__init__()
        inv_freq = 1 / (10000 ** (torch.arange(0.0, demb, 2.0) / demb))
        self.register_buffer('inv_freq', inv_freq)

    def forward(self, pos_seq):
        sinusoid = torch.ger(pos_seq, self.inv_freq)
        return torch.cat([sinusoid.sin(), sinusoid.cos()], dim=-1)[:, None]


class _TorchRelMHSA(torch.nn.Module):
    """conformer/attention.py:145-293 (pre_lnorm=True path)."""

    def __init__(self, n_head, d_model):
        super().__init__()
        self.n_head = n_head
        self.d_head = d_model // n_head
        self.qkv_net = torch.nn.Linear(d_model, 3 * d_model, bias=False)
        self.o_net = torch.nn.Linear(d_model, d_model, bias=False)
        self.layer_norm = torch.nn.LayerNorm(d_model)
        self.pos_emb = _TorchPosEmb(d_model)
        self.r_w_bias = torch.nn.Parameter(
            torch.zeros(n_head, self.d_head))
        self.r_r_bias = torch.nn.Parameter(
            torch.zeros(n_head, self.d_head))
        self.r_net = torch.nn.Linear(d_model, d_model, bias=False)
        self.scale = 1 / (self.d_head ** 0.5)

    @staticmethod
    def _rel_shift(x):
        zero_pad = torch.zeros((x.size(0), 1, *x.size()[2:]),
                               dtype=x.dtype)
        x_padded = torch.cat([zero_pad, x], dim=1)
        x_padded = x_padded.view(x.size(1) + 1, x.size(0), *x.size()[2:])
        return x_padded[1:].view_as(x)

    def forward(self, w):                      # w: (T, B, D)
        pos_seq = torch.arange(w.size(0) - 1, -1, -1.0, dtype=w.dtype)
        r = self.pos_emb(pos_seq)
        qlen, bsz = w.size(0), w.size(1)
        w_heads = self.qkv_net(self.layer_norm(w))
        r_head_k = self.r_net(r)
        q, k, v = torch.chunk(w_heads, 3, dim=-1)
        q = q.view(qlen, bsz, self.n_head, self.d_head)
        k = k.view(qlen, bsz, self.n_head, self.d_head)
        v = v.view(qlen, bsz, self.n_head, self.d_head)
        r_head_k = r_head_k.view(qlen, self.n_head, self.d_head)
        ac = torch.einsum('ibnd,jbnd->ijbn', q + self.r_w_bias, k)
        bd = torch.einsum('ibnd,jnd->ijbn', q + self.r_r_bias, r_head_k)
        bd = self._rel_shift(bd)
        score = (ac + bd) * self.scale
        attn = torch.softmax(score, dim=1)
        vec = torch.einsum('ijbn,jbnd->ibnd', attn, v)
        vec = vec.contiguous().view(qlen, bsz,
                                    self.n_head * self.d_head)
        return w + self.o_net(vec)


class _TorchMacaronFFN(torch.nn.Module):
    def __init__(self, d_model, d_ff):
        super().__init__()
        self.feed_forward_module = torch.nn.Sequential(
            torch.nn.LayerNorm(d_model), torch.nn.Linear(d_model, d_ff),
            _Swish(), torch.nn.Dropout(0.0),
            torch.nn.Linear(d_ff, d_model), torch.nn.Dropout(0.0))

    def forward(self, x):
        return self.feed_forward_module(x)


class _TorchConvModule(torch.nn.Module):
    def __init__(self, d_model, k):
        super().__init__()
        self.conv = torch.nn.Sequential(
            torch.nn.LayerNorm(d_model),
            _PointWise(d_model, 2 * d_model), _GLU(),
            _DepthWise(d_model, k), _Permute((0, 2, 1)),
            torch.nn.BatchNorm1d(d_model), _Permute((0, 2, 1)),
            _Swish(), _PointWise(d_model, d_model), torch.nn.Dropout(0.0))

    def forward(self, x):
        return self.conv(x)


class _TorchConformerBlock(torch.nn.Module):
    def __init__(self, d_model, d_ff, n_head, k):
        super().__init__()
        self.ffn1 = _TorchMacaronFFN(d_model, d_ff)
        self.mhsa = _TorchRelMHSA(n_head, d_model)
        self.conv = _TorchConvModule(d_model, k)
        self.ffn2 = _TorchMacaronFFN(d_model, d_ff)
        self.norm = torch.nn.LayerNorm(d_model)

    def forward(self, x):
        x = 0.5 * self.ffn1(x) + x
        x = self.mhsa(x.permute(1, 0, 2)).permute(1, 0, 2)
        x = self.conv(x) + x
        x = 0.5 * self.ffn2(x) + x
        return self.norm(x)


class _MultiSequential(torch.nn.Sequential):
    def forward(self, x):
        for m in self:
            x = m(x)
        return x


class _TorchConformerEncoder(torch.nn.Module):
    def __init__(self, idim, adim=144, elayers=3, eunits=576, aheads=4,
                 k=7):
        super().__init__()
        self.input_layer = torch.nn.Sequential(
            torch.nn.Linear(idim, adim), torch.nn.LayerNorm(adim),
            torch.nn.Dropout(0.0), torch.nn.ReLU(),
            _TorchPositionalEncoding(adim))
        self.conformer_blocks = _MultiSequential(
            *[_TorchConformerBlock(adim, eunits, aheads, k)
              for _ in range(elayers)])

    def forward(self, x):
        return self.conformer_blocks(self.input_layer(x))


class _TorchConformerAttOracle(torch.nn.Module):
    """Cnn_9layers_Conformer_FrameAtt (models.py:1189-1376), incl. its
    unused ``classifier``/``linear_emb`` parameters."""

    def __init__(self):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(64)
        self.conv_block1 = _TorchConvBlock(1, 64)
        self.conv_block2 = _TorchConvBlock(64, 128)
        self.conv_block3 = _TorchConvBlock(128, 256)
        self.conv_block4 = _TorchConvBlock(256, 512)
        self.encoder = _TorchConformerEncoder(512)
        self.att_block = _TorchAttBlock(144, 25)
        self.classifier = torch.nn.Linear(144, 25)      # unused in forward
        self.linear_emb = torch.nn.Linear(1, 512)       # unused in forward

    def forward(self, feat):
        x = feat[:, None, :, :]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        x = self.conv_block1(x, (2, 2))
        x = self.conv_block2(x, (2, 2))
        x = self.conv_block3(x, (2, 2))
        x = self.conv_block4(x, (1, 1))
        x = torch.mean(x, dim=3).transpose(1, 2)
        x = self.encoder(x).transpose(1, 2)
        clipwise, cla = self.att_block(x)
        framewise = _interpolate(cla.transpose(1, 2), 8)
        # pad to roundup = next multiple of 100 (models.py:62-63,1360-1362)
        t = framewise.shape[1]
        if t != 1000 and t % 100:
            framewise = _pad_framewise(framewise,
                                       t + 100 - t % 100)
        return framewise, clipwise


def test_conformer_family_pth_parity():
    torch.manual_seed(2)
    rng = np.random.RandomState(2)
    oracle = _TorchConformerAttOracle().eval()
    _randomize_bn_stats(oracle, rng)
    wav = rng.uniform(-0.5, 0.5, (2, CFG.sample_rate * 5)).astype(np.float32)
    _roundtrip(oracle, 'Cnn_9layers_Conformer_FrameAtt', wav)


# ---------------------------------------------------------------------------
# Token-pooling conformer (Cnn_7layers_Conformer, models.py:1829-2018)
# ---------------------------------------------------------------------------

class _TorchBaselineCNN(torch.nn.Module):
    """baseline_model.py:35-93 with its nested ``cnn.cnn.*`` key names."""

    def __init__(self):
        super().__init__()
        nb_filters = [16, 32, 64, 128, 128, 128, 128]
        pooling = [(2, 2), (2, 2), (2, 2), (1, 2), (1, 2), (1, 2), (1, 1)]
        cnn = torch.nn.Sequential()
        for i, ch in enumerate(nb_filters):
            cin = 1 if i == 0 else nb_filters[i - 1]
            cnn.add_module(f'conv{i}', torch.nn.Conv2d(cin, ch, 3, 1, 1))
            cnn.add_module(f'batchnorm{i}',
                           torch.nn.BatchNorm2d(ch, eps=0.001,
                                                momentum=0.99))
            cnn.add_module(f'relu{i}', torch.nn.ReLU())
            cnn.add_module(f'dropout{i}', torch.nn.Dropout(0.0))
            cnn.add_module(f'pooling{i}', torch.nn.AvgPool2d(pooling[i]))
        self.cnn = cnn

    def forward(self, x):
        return self.cnn(x)


class _TorchTokenPoolOracle(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(64)
        self.cnn = _TorchBaselineCNN()
        self.encoder = _TorchConformerEncoder(128)
        self.classifier = torch.nn.Linear(144, 25)
        self.linear_emb = torch.nn.Linear(1, 128)

    def forward(self, feat):
        x = feat[:, None, :, :]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        x = self.cnn(x)
        x = x.squeeze(-1).permute(0, 2, 1)          # (B, T/8, 128)
        tag = self.linear_emb(torch.ones(x.size(0), 1, 1))
        x = torch.cat([tag, x], dim=1)
        x = self.encoder(x)
        x = self.classifier(x)
        weak = x[:, 0, :]
        strong = _interpolate(x[:, 1:, :], 8)
        return strong, weak


def test_token_pooling_conformer_pth_parity():
    torch.manual_seed(3)
    rng = np.random.RandomState(3)
    oracle = _TorchTokenPoolOracle().eval()
    _randomize_bn_stats(oracle, rng)
    wav = rng.uniform(-0.5, 0.5, (2, CFG.sample_rate * 5)).astype(np.float32)
    _roundtrip(oracle, 'Cnn_7layers_Conformer', wav)


# ---------------------------------------------------------------------------
# VGGish family (models.py:2219-2384)
# ---------------------------------------------------------------------------

class _TorchVggishAttOracle(torch.nn.Module):
    def __init__(self):
        super().__init__()
        features = torch.nn.Sequential(
            torch.nn.Conv2d(1, 64, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.MaxPool2d(2, 2),
            torch.nn.Conv2d(64, 128, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.MaxPool2d(2, 2),
            torch.nn.Conv2d(128, 256, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.Conv2d(256, 256, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.MaxPool2d(2, 2),
            torch.nn.Conv2d(256, 512, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.Conv2d(512, 512, 3, 1, 1), torch.nn.ReLU(),
            torch.nn.MaxPool2d(2, 2))
        # post-strip layout: Sequential(features) -> keys vggish.0.N.*
        # (models.py:2330-2332)
        self.vggish = torch.nn.Sequential(features)
        self.bn0 = torch.nn.BatchNorm2d(64)             # unused (commented
        self.att_block = _TorchAttBlock(512, 25)        # out upstream)

    def forward(self, feat):
        x = feat[:, None, :, :]                         # no bn0
        x = self.vggish(x)
        x = torch.mean(x, dim=3)
        clipwise, cla = self.att_block(x)
        framewise = _interpolate(cla.transpose(1, 2), 12)
        if framewise.shape[1] < 1000:
            framewise = _pad_framewise(framewise, 1000)
        return framewise, clipwise


def test_vggish_family_pth_parity():
    torch.manual_seed(4)
    rng = np.random.RandomState(4)
    oracle = _TorchVggishAttOracle().eval()
    _randomize_bn_stats(oracle, rng)
    wav = rng.uniform(-0.5, 0.5, (2, CFG.sample_rate * 5)).astype(np.float32)
    _roundtrip(oracle, 'VGGish_FrameAtt', wav)


# ---------------------------------------------------------------------------
# PANNs Cnn14_DecisionLevelAtt (models.py:2685-2783)
# ---------------------------------------------------------------------------

class _TorchCnn14Oracle(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(64)
        chans = [64, 128, 256, 512, 1024, 2048]
        for i, ch in enumerate(chans):
            cin = 1 if i == 0 else chans[i - 1]
            setattr(self, f'conv_block{i + 1}', _TorchConvBlock(cin, ch))
        self.fc1 = torch.nn.Linear(2048, 2048)
        self.att_block = _TorchAttBlock(2048, 25)

    def forward(self, feat):
        frames_num = feat.shape[1] - 1
        x = feat[:, None, :, :]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        for i in range(6):
            pool = (1, 1) if i == 5 else (2, 2)
            x = getattr(self, f'conv_block{i + 1}')(x, pool)
        x = torch.mean(x, dim=3)
        x1 = torch.nn.functional.max_pool1d(x, 3, 1, 1)
        x2 = torch.nn.functional.avg_pool1d(x, 3, 1, 1)
        x = (x1 + x2).transpose(1, 2)
        x = torch.relu(self.fc1(x)).transpose(1, 2)
        clipwise, cla = self.att_block(x)
        framewise = _interpolate(cla.transpose(1, 2), 32)
        if framewise.shape[1] < frames_num:
            framewise = _pad_framewise(framewise, frames_num)
        return framewise, clipwise


def test_cnn14_pth_parity():
    torch.manual_seed(5)
    rng = np.random.RandomState(5)
    oracle = _TorchCnn14Oracle().eval()
    _randomize_bn_stats(oracle, rng)
    wav = rng.uniform(-0.5, 0.5, (2, CFG.sample_rate * 5)).astype(np.float32)
    _roundtrip(oracle, 'Cnn14_DecisionLevelAtt', wav)


# ---------------------------------------------------------------------------
# Conv2d subsampling input layer (transformer/subsampling.py:7-72) —
# validates the torch channel-major flatten order of the Dense input
# ---------------------------------------------------------------------------

class _TorchConv2dSubsampling(torch.nn.Module):
    def __init__(self, idim=64, odim=144):
        super().__init__()
        self.conv = torch.nn.Sequential(
            torch.nn.Conv2d(1, odim, 3, 2), torch.nn.ReLU(),
            torch.nn.Conv2d(odim, odim, 3, 2), torch.nn.ReLU())
        self.out = torch.nn.Sequential(
            torch.nn.Linear(odim * (((idim - 1) // 2 - 1) // 2), odim),
            _TorchPositionalEncoding(odim))

    def forward(self, x):
        x = x.unsqueeze(1)
        x = self.conv(x)
        b, c, t, f = x.size()
        return self.out(x.transpose(1, 2).contiguous().view(b, t, c * f))


def test_conv2d_subsampling_flatten_order_matches_torch():
    """The flax Conv2dSubsampling must flatten conv output channel-major
    like torch's transpose(1,2).view(b,t,c*f), so reference Dense
    weights transfer with a plain transpose."""
    import jax
    from sed_jax.models.encoders import Conv2dSubsampling

    torch.manual_seed(11)
    oracle = _TorchConv2dSubsampling().eval()
    mod = Conv2dSubsampling(idim=64, odim=144)
    x = np.random.RandomState(11).uniform(
        -1, 1, (2, 101, 64)).astype(np.float32)
    variables = mod.init({'params': jax.random.PRNGKey(0)},
                         jnp.asarray(x))
    p = jax.tree_util.tree_map(lambda a: a, variables)['params']
    sd = oracle.state_dict()
    p['conv1']['kernel'] = jnp.asarray(
        sd['conv.0.weight'].permute(2, 3, 1, 0).numpy())
    p['conv1']['bias'] = jnp.asarray(sd['conv.0.bias'].numpy())
    p['conv2']['kernel'] = jnp.asarray(
        sd['conv.2.weight'].permute(2, 3, 1, 0).numpy())
    p['conv2']['bias'] = jnp.asarray(sd['conv.2.bias'].numpy())
    p['out']['kernel'] = jnp.asarray(sd['out.0.weight'].numpy().T)
    p['out']['bias'] = jnp.asarray(sd['out.0.bias'].numpy())
    got = mod.apply({'params': p}, jnp.asarray(x))
    with torch.no_grad():
        want = oracle(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4)
