"""Shared model building blocks (``sed_jax.models.nn``, NHWC layout).

Re-designs of the reference blocks (``pytorch/models.py:20-209``,
``pytorch/models.py:799-877``):

* feature maps are (B, T, F, C) channels-last;
* the BiGRU hoists the input projection out of the recurrence — one big
  (B*T, D) x (D, 3H) matmul — so the ``lax.scan`` body is a single
  (B, H) x (H, 3H) matmul per step;
* GRU parameters are stored in the torch gate layout (r, z, n stacked) so
  reference ``.pth`` checkpoints map 1:1.

Initialization parity: Xavier-uniform convs/denses with zero bias
(``models.py:20-27``), per-gate uniform / orthogonal GRU init
(``models.py:35-60``).
"""

from __future__ import annotations

from typing import Optional, Tuple

from sed_jax.models import nn
import jax
import jax.numpy as jnp
import numpy as np

xavier_uniform = nn.initializers.xavier_uniform()
xavier_normal = nn.initializers.xavier_normal()


def roundup(x: int) -> int:
    """Next multiple of 100 (``models.py:62-63``)."""
    return x if x % 100 == 0 else x + 100 - x % 100


def interpolate(x: jnp.ndarray, ratio: int) -> jnp.ndarray:
    """Nearest-repeat upsample along time: (B, T, C) -> (B, T*ratio, C),
    undoing the CNN time pooling (``models.py:84-95``)."""
    return jnp.repeat(x, ratio, axis=1)


def pad_framewise_output(x: jnp.ndarray, frames_num: int) -> jnp.ndarray:
    """Pad (B, T, C) to frames_num by repeating the last frame
    (``models.py:65-81``)."""
    pad = jnp.repeat(x[:, -1:, :], frames_num - x.shape[1], axis=1)
    return jnp.concatenate([x, pad], axis=1)


class ConvBlock(nn.Module):
    """[Conv3x3 -> BN -> ReLU] x2 + avg/max/avg+max pool
    (``models.py:98-141``).

    ``dtype`` sets the conv computation dtype (e.g. bfloat16);
    parameters and BatchNorm statistics stay float32.
    """

    out_channels: int
    bn_axis_name: Optional[str] = None
    dtype: Optional[jnp.dtype] = None

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False,
                 pool_size: Tuple[int, int] = (2, 2),
                 pool_type: str = 'avg') -> jnp.ndarray:
        for name in ('conv1', 'conv2'):
            x = nn.Conv(self.out_channels, (3, 3), use_bias=False,
                        padding='SAME', kernel_init=xavier_uniform,
                        dtype=self.dtype, name=name)(x)
            x = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, axis_name=self.bn_axis_name,
                             dtype=jnp.float32,
                             name='bn' + name[-1])(x)
            x = nn.relu(x)
        if pool_size == (1, 1):
            return x
        if pool_type == 'avg':
            return nn.avg_pool(x, pool_size, strides=pool_size)
        if pool_type == 'max':
            return nn.max_pool(x, pool_size, strides=pool_size)
        if pool_type == 'avg+max':
            return (nn.avg_pool(x, pool_size, strides=pool_size)
                    + nn.max_pool(x, pool_size, strides=pool_size))
        raise ValueError(f'Incorrect pool_type: {pool_type}')


class AttBlock(nn.Module):
    """Attention pooling head (``models.py:144-175``).

    Operates on (B, T, C_in) channels-last (the reference uses 1x1 conv1d
    on (B, C, T); a Dense over the last axis is the same linear map).
    Returns (clipwise (B, n_out), norm_att (B, T, n_out), cla (B, T, n_out)).
    """

    n_out: int
    activation: str = 'linear'
    temperature: float = 1.0

    @nn.compact
    def __call__(self, x: jnp.ndarray):
        att = nn.Dense(self.n_out, kernel_init=xavier_uniform, name='att')(x)
        att = jnp.clip(att, -10.0, 10.0)
        att = jnp.exp(att / self.temperature) + 1e-6
        norm_att = att / jnp.sum(att, axis=1, keepdims=True)
        cla = nn.Dense(self.n_out, kernel_init=xavier_uniform, name='cla')(x)
        if self.activation == 'sigmoid':
            cla = jax.nn.sigmoid(cla)
        clipwise = jnp.sum(norm_att * cla, axis=1)
        return clipwise, norm_att, cla


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


def _gru_ih_init(key, shape, dtype=jnp.float32):
    """Per-gate uniform(-sqrt(3/fan_in), +) over the stacked (3H, D) weight
    (``models.py:49-53``); fan_in = D for each (H, D) gate block."""
    d = shape[1]
    bound = np.sqrt(3.0 / d)
    return jax.random.uniform(key, shape, dtype, -bound, bound)


def _gru_hh_init(key, shape, dtype=jnp.float32):
    """r, z gates uniform; n gate orthogonal (``models.py:55-59``)."""
    h = shape[1]
    assert shape[0] == 3 * h
    k1, k2 = jax.random.split(key)
    bound = np.sqrt(3.0 / h)
    rz = jax.random.uniform(k1, (2 * h, h), dtype, -bound, bound)
    n = nn.initializers.orthogonal()(k2, (h, h), dtype)
    return jnp.concatenate([rz, n], axis=0)


class GRUCellScan(nn.Module):
    """One direction of a GRU over (B, T, D) -> (B, T, H).

    torch gate order (r, z, n); input projection hoisted out of the scan.
    """

    hidden_size: int

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        h = self.hidden_size
        d = x.shape[-1]
        w_ih = self.param('w_ih', _gru_ih_init, (3 * h, d))
        w_hh = self.param('w_hh', _gru_hh_init, (3 * h, h))
        b_ih = self.param('b_ih', nn.initializers.zeros, (3 * h,))
        b_hh = self.param('b_hh', nn.initializers.zeros, (3 * h,))

        # (B, T, 3H) in one matmul
        xp = jnp.einsum('btd,gd->btg', x, w_ih) + b_ih

        def step(carry, xp_t):
            hp = jnp.dot(carry, w_hh.T) + b_hh
            r = jax.nn.sigmoid(xp_t[:, :h] + hp[:, :h])
            z = jax.nn.sigmoid(xp_t[:, h:2 * h] + hp[:, h:2 * h])
            n = jnp.tanh(xp_t[:, 2 * h:] + r * hp[:, 2 * h:])
            new_h = (1.0 - z) * n + z * carry
            return new_h, new_h

        h0 = jnp.zeros((x.shape[0], h), x.dtype)
        _, hs = jax.lax.scan(step, h0, xp.transpose(1, 0, 2))
        return hs.transpose(1, 0, 2)


class _GRUDirParams(nn.Module):
    """Parameter container for one GRU direction.

    Exists so ``BiGRU`` can run BOTH directions in one fused scan while
    keeping the exact parameter tree of the original two-``GRUCellScan``
    layout (``gru/{fw,bw}/{w_ih,w_hh,b_ih,b_hh}``) — every existing
    checkpoint and the torch loader depend on those paths."""

    hidden_size: int
    input_size: int

    @nn.compact
    def __call__(self):
        h, d = self.hidden_size, self.input_size
        return (self.param('w_ih', _gru_ih_init, (3 * h, d)),
                self.param('w_hh', _gru_hh_init, (3 * h, h)),
                self.param('b_ih', nn.initializers.zeros, (3 * h,)),
                self.param('b_hh', nn.initializers.zeros, (3 * h,)))


class BiGRU(nn.Module):
    """Bidirectional single-layer GRU, output (B, T, 2H)
    (torch ``nn.GRU(bidirectional=True)`` semantics, ``models.py:615``).

    Both directions run in ONE ``lax.scan`` over stacked (2, B) lanes
    (the backward direction scans the time-reversed input), halving the
    sequential depth vs two consecutive scans.  ``unroll`` fuses that many
    recurrence steps per loop iteration (exact; amortizes per-iteration
    overhead).  Math per step is identical to ``GRUCellScan``."""

    hidden_size: int
    unroll: int = 8

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        h = self.hidden_size
        b, t, d = x.shape
        fw = _GRUDirParams(h, d, name='fw')()
        bw = _GRUDirParams(h, d, name='bw')()
        w_ih = jnp.stack([fw[0], bw[0]])              # (2, 3H, D)
        w_hh = jnp.stack([fw[1], bw[1]])              # (2, 3H, H)
        b_ih = jnp.stack([fw[2], bw[2]])              # (2, 3H)
        b_hh = jnp.stack([fw[3], bw[3]])

        xx = jnp.stack([x, x[:, ::-1]], axis=0)       # (2, B, T, D)
        # both directions' input projections in one batched matmul,
        # emitted time-major for the scan
        xp = (jnp.einsum('gbtd,gkd->tgbk', xx, w_ih)
              + b_ih[None, :, None, :])               # (T, 2, B, 3H)

        def step(carry, xp_t):
            hp = (jnp.einsum('gbh,gkh->gbk', carry, w_hh)
                  + b_hh[:, None, :])                 # (2, B, 3H)
            r = jax.nn.sigmoid(xp_t[..., :h] + hp[..., :h])
            z = jax.nn.sigmoid(xp_t[..., h:2 * h] + hp[..., h:2 * h])
            n = jnp.tanh(xp_t[..., 2 * h:] + r * hp[..., 2 * h:])
            new_h = (1.0 - z) * n + z * carry
            return new_h, new_h

        h0 = jnp.zeros((2, b, h), x.dtype)
        _, hs = jax.lax.scan(step, h0, xp, unroll=self.unroll)
        out_fw = hs[:, 0].swapaxes(0, 1)              # (B, T, H)
        out_bw = hs[::-1, 1].swapaxes(0, 1)
        return jnp.concatenate([out_fw, out_bw], axis=-1)


# ---------------------------------------------------------------------------
# Single-block multi-head self-attention (``models.py:799-877``)
# ---------------------------------------------------------------------------


class MultiHead(nn.Module):
    """The reference's one-off transformer block: QKV projections, scaled
    dot-product attention with dropout, output projection, dropout, ReLU.
    Notably there is NO residual connection or layer norm in the reference
    forward (``models.py:852-877``: ``residual``/``layer_norm`` are dead).
    """

    n_head: int = 8
    d_k: int = 64
    d_v: int = 64
    dropout_rate: float = 0.2
    attn_dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        b, t, d_model = x.shape
        nh, dk, dv = self.n_head, self.d_k, self.d_v

        def _qkv_init(dd):
            std = np.sqrt(2.0 / (d_model + dd))
            return nn.initializers.normal(stddev=std)

        q = nn.Dense(nh * dk, kernel_init=_qkv_init(dk), name='w_qs')(x)
        k = nn.Dense(nh * dk, kernel_init=_qkv_init(dk), name='w_ks')(x)
        v = nn.Dense(nh * dv, kernel_init=_qkv_init(dv), name='w_vs')(x)

        q = q.reshape(b, t, nh, dk).transpose(0, 2, 1, 3)
        k = k.reshape(b, t, nh, dk).transpose(0, 2, 1, 3)
        v = v.reshape(b, t, nh, dv).transpose(0, 2, 1, 3)

        attn = jnp.einsum('bhqd,bhkd->bhqk', q, k) / np.sqrt(dk)
        attn = jax.nn.softmax(attn, axis=-1)
        attn = nn.Dropout(self.attn_dropout_rate,
                          deterministic=not train)(attn)
        out = jnp.einsum('bhqk,bhkd->bhqd', attn, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, t, nh * dv)
        out = nn.Dense(d_model, kernel_init=xavier_normal, name='fc')(out)
        out = nn.Dropout(self.dropout_rate, deterministic=not train)(out)
        return nn.relu(out)
