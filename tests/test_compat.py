"""End-to-end ``.pth`` checkpoint compatibility test.

A torch oracle with the reference's exact state-dict key names (bn0,
conv_blockN.{conv,bn}{1,2}, gru, att_block.{att,cla}) is built from torch
primitives, saved with ``torch.save``, loaded through the pure-python
reader, and mapped onto the flax model.  Outputs must agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

from sed_jax.config import AUDIO_16K  # noqa: E402
from sed_jax.compat.torch_loader import (  # noqa: E402
    read_torch_pickle, load_checkpoint_variables)
from sed_jax.dsp.frontend import LogmelFrontend  # noqa: E402
from sed_jax.models.registry import get_model  # noqa: E402


class _TorchConvBlock(torch.nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = torch.nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(cout)
        self.bn2 = torch.nn.BatchNorm2d(cout)

    def forward(self, x, pool):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        if pool != (1, 1):
            x = torch.nn.functional.avg_pool2d(x, pool)
        return x


class _TorchAttBlock(torch.nn.Module):
    def __init__(self, n_in, n_out):
        super().__init__()
        self.att = torch.nn.Conv1d(n_in, n_out, 1, bias=True)
        self.cla = torch.nn.Conv1d(n_in, n_out, 1, bias=True)
        self.bn_att = torch.nn.BatchNorm1d(n_out)  # vestigial, like the ref

    def forward(self, x):
        att = torch.clamp(self.att(x), -10, 10)
        att = torch.exp(att) + 1e-6
        norm_att = att / torch.sum(att, dim=2)[:, :, None]
        cla = torch.sigmoid(self.cla(x))
        return torch.sum(norm_att * cla, dim=2), cla


class _TorchGruAttOracle(torch.nn.Module):
    """Reference-shaped GRU-Att stack operating on precomputed log-mel."""

    def __init__(self):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(64)
        self.conv_block1 = _TorchConvBlock(1, 64)
        self.conv_block2 = _TorchConvBlock(64, 128)
        self.conv_block3 = _TorchConvBlock(128, 256)
        self.conv_block4 = _TorchConvBlock(256, 512)
        self.gru = torch.nn.GRU(512, 256, num_layers=1, bias=True,
                                batch_first=True, bidirectional=True)
        self.att_block = _TorchAttBlock(512, 25)

    def forward(self, feat):           # feat: (B, T, 64)
        x = feat[:, None, :, :]        # (B, 1, T, F)
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        x = self.conv_block1(x, (2, 2))
        x = self.conv_block2(x, (2, 2))
        x = self.conv_block3(x, (2, 2))
        x = self.conv_block4(x, (1, 1))
        x = torch.mean(x, dim=3)       # (B, C, T')
        x = x.transpose(1, 2)
        x, _ = self.gru(x)
        x = x.transpose(1, 2)
        clipwise, cla = self.att_block(x)
        framewise = cla.transpose(1, 2).repeat_interleave(8, dim=1)
        return framewise, clipwise


def _randomize_bn_stats(module, rng):
    for m in module.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.copy_(torch.from_numpy(
                rng.randn(m.num_features).astype(np.float32) * 0.5))
            m.running_var.copy_(torch.from_numpy(
                rng.rand(m.num_features).astype(np.float32) + 0.5))
            m.weight.data.copy_(torch.from_numpy(
                rng.rand(m.num_features).astype(np.float32) + 0.5))
            m.bias.data.copy_(torch.from_numpy(
                rng.randn(m.num_features).astype(np.float32) * 0.1))


def test_pth_roundtrip_and_full_forward_parity(tmp_path):
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    oracle = _TorchGruAttOracle().eval()
    _randomize_bn_stats(oracle, rng)

    path = str(tmp_path / 'ckpt.pth')
    torch.save({'iteration': 123, 'model': oracle.state_dict()}, path)

    variables, iteration = load_checkpoint_variables(path)
    assert iteration == 123

    cfg = AUDIO_16K
    wav = rng.uniform(-0.5, 0.5, (2, cfg.audio_samples)).astype(np.float32)
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    out = model.apply(variables, jnp.asarray(wav), train=False)

    feat = np.asarray(LogmelFrontend(cfg)(jnp.asarray(wav)))
    with torch.no_grad():
        want_frame, want_clip = oracle(torch.from_numpy(feat))

    np.testing.assert_allclose(np.asarray(out['clipwise_output']),
                               want_clip.numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out['framewise_output']),
                               want_frame.numpy(), rtol=1e-3, atol=1e-4)


def test_read_torch_pickle_tensor_exactness(tmp_path):
    rng = np.random.RandomState(1)
    obj = {
        'a': torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
        'b': torch.from_numpy(rng.randint(0, 10, (4,)).astype(np.int64)),
        'nested': {'c': torch.from_numpy(rng.randn(2, 2, 2)
                                         .astype(np.float32))},
        'scalar': 7,
        'text': 'hello',
    }
    path = str(tmp_path / 'obj.pth')
    torch.save(obj, path)
    got = read_torch_pickle(path)
    np.testing.assert_array_equal(got['a'], obj['a'].numpy())
    np.testing.assert_array_equal(got['b'], obj['b'].numpy())
    np.testing.assert_array_equal(got['nested']['c'],
                                  obj['nested']['c'].numpy())
    assert got['scalar'] == 7 and got['text'] == 'hello'


def test_noncontiguous_tensor_roundtrip(tmp_path):
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6).t()  # strided
    path = str(tmp_path / 't.pth')
    torch.save({'x': x}, path)
    got = read_torch_pickle(path)
    np.testing.assert_array_equal(got['x'], x.numpy())
