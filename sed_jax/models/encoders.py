"""Encoder library: ESPnet-style Transformer and Conformer blocks.

Re-designs of the reference's DCASE-2020 encoder package
(``pytorch/models_2020/``):

* sinusoidal ``PositionalEncoding`` with sqrt(d) input scaling
  (``transformer/embedding.py:8-33``);
* ``MultiHeadedAttention`` / ``PositionwiseFeedForward`` /
  pre-LN ``EncoderLayer`` with optional time max-pool
  (``transformer/attention.py:12-65``, ``encoder_layer.py:11-50``);
* ``Conv2dSubsampling`` (x1/4 time) / ``Conv2dNoSubsampling``
  (``transformer/subsampling.py:7-72``);
* ``TransformerEncoder`` with linear/conv2d input layers + final LN
  (``transformer/encoder.py:13-89``, LN eps 1e-12 per
  ``layer_norm.py:13``);
* Transformer-XL relative-position attention with r_w/r_r biases and the
  rel-shift trick (``conformer/attention.py:145-293``);
* macaron ``ConformerBlock`` (half-FFN, RelMHSA, conv module, half-FFN,
  LN) and ``ConformerEncoder`` (``conformer/conformer_block.py:7-24``,
  ``conformer_encoder.py:7-34``).

All modules are (B, T, D) channels-last; attention runs as batched
einsums.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from sed_jax.models import nn
import jax
import jax.numpy as jnp
import numpy as np

MIN_VALUE = float(np.finfo(np.float32).min)


def subsequent_mask(size: int) -> np.ndarray:
    """Lower-triangular causal mask (``models_2020/transformer/mask.py``)."""
    return np.tril(np.ones((size, size), dtype=bool))


def make_non_pad_mask(lengths: np.ndarray, max_len: int) -> np.ndarray:
    """(B, T) True where t < lengths[b] — attention padding mask."""
    return np.arange(max_len)[None, :] < np.asarray(lengths)[:, None]


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """Interleaved sin/cos table (``transformer/embedding.py:20-27``)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class PositionalEncoding(nn.Module):
    """x * sqrt(d) + PE, then dropout."""

    d_model: int
    dropout_rate: float = 0.1
    max_len: int = 5000

    @nn.compact
    def __call__(self, x: jnp.ndarray, train: bool = False) -> jnp.ndarray:
        pe = jnp.asarray(sinusoidal_table(self.max_len, self.d_model))
        x = x * np.sqrt(self.d_model) + pe[None, :x.shape[1]]
        return nn.Dropout(self.dropout_rate, deterministic=not train)(x)


class MultiHeadedAttention(nn.Module):
    """Standard MHA with biasful projections (ESPnet layout)."""

    n_head: int
    n_feat: int
    dropout_rate: float = 0.0

    @nn.compact
    def __call__(self, query, key, value, mask=None, train: bool = False):
        b, t, _ = query.shape
        h = self.n_head
        d_k = self.n_feat // h
        q = nn.Dense(self.n_feat, name='linear_q')(query)
        k = nn.Dense(self.n_feat, name='linear_k')(key)
        v = nn.Dense(self.n_feat, name='linear_v')(value)
        q = q.reshape(b, -1, h, d_k).transpose(0, 2, 1, 3)
        k = k.reshape(b, -1, h, d_k).transpose(0, 2, 1, 3)
        v = v.reshape(b, -1, h, d_k).transpose(0, 2, 1, 3)
        scores = jnp.einsum('bhqd,bhkd->bhqk', q, k) / np.sqrt(d_k)
        if mask is not None:
            scores = jnp.where(mask[:, None], scores, MIN_VALUE)
        attn = jax.nn.softmax(scores, axis=-1)
        attn = nn.Dropout(self.dropout_rate, deterministic=not train)(attn)
        out = jnp.einsum('bhqk,bhkd->bhqd', attn, v)
        out = out.transpose(0, 2, 1, 3).reshape(b, -1, self.n_feat)
        return nn.Dense(self.n_feat, name='linear_out')(out)


class PositionwiseFeedForward(nn.Module):
    d_ff: int
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, train: bool = False):
        d_model = x.shape[-1]
        x = nn.relu(nn.Dense(self.d_ff, name='w_1')(x))
        x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        return nn.Dense(d_model, name='w_2')(x)


class TransformerEncoderLayer(nn.Module):
    """Pre-LN self-attention + FFN (+ optional time max-pool)
    (``transformer/encoder_layer.py:11-50``)."""

    adim: int
    aheads: int
    eunits: int
    dropout_rate: float = 0.1
    attn_dropout_rate: float = 0.0
    after_conv: bool = False

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        nx = nn.LayerNorm(epsilon=1e-12, name='norm1')(x)
        attn = MultiHeadedAttention(self.aheads, self.adim,
                                    self.attn_dropout_rate,
                                    name='self_attn')(nx, nx, nx, mask,
                                                      train)
        x = x + nn.Dropout(self.dropout_rate,
                           deterministic=not train)(attn)
        nx = nn.LayerNorm(epsilon=1e-12, name='norm2')(x)
        ff = PositionwiseFeedForward(self.eunits, self.dropout_rate,
                                     name='feed_forward')(nx, train)
        out = x + nn.Dropout(self.dropout_rate,
                             deterministic=not train)(ff)
        if self.after_conv:
            out = nn.max_pool(out[..., None], (2, 1), strides=(2, 1)
                              )[..., 0]
            if mask is not None:
                mask = mask[:, ::2, ::2]
        return out, mask


class Conv2dSubsampling(nn.Module):
    """Two stride-2 3x3 convs -> x1/4 time + linear + PE
    (``transformer/subsampling.py:7-44``)."""

    idim: int
    odim: int
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, train: bool = False):
        # (B, T, F) -> (B, T, F, 1) NHWC; torch uses VALID padding here
        h = x[..., None]
        h = nn.relu(nn.Conv(self.odim, (3, 3), strides=(2, 2),
                            padding='VALID', name='conv1')(h))
        h = nn.relu(nn.Conv(self.odim, (3, 3), strides=(2, 2),
                            padding='VALID', name='conv2')(h))
        b, t, f, c = h.shape
        # torch flattens (b, c, t, f) as transpose(1,2).view(b, t, c*f)
        # -- channel-major -- so .pth Dense weights map without reorder
        # (``transformer/subsampling.py:36``)
        h = jnp.swapaxes(h, 2, 3).reshape(b, t, c * f)
        h = nn.Dense(self.odim, name='out')(h)
        return PositionalEncoding(self.odim, self.dropout_rate,
                                  name='pos_enc')(h, train)


class Conv2dNoSubsampling(nn.Module):
    """Two stride-1 3x3 convs (``transformer/subsampling.py:47-72``)."""

    odim: int
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, train: bool = False):
        h = x[..., None]
        h = nn.relu(nn.Conv(self.odim, (3, 3), padding='SAME',
                            name='conv1')(h))
        h = nn.relu(nn.Conv(self.odim, (3, 3), padding='SAME',
                            name='conv2')(h))
        b, t, f, c = h.shape
        # channel-major flatten, matching torch (subsampling.py:70)
        h = jnp.swapaxes(h, 2, 3).reshape(b, t, c * f)
        h = nn.Dense(self.odim, name='out')(h)
        return PositionalEncoding(self.odim, self.dropout_rate,
                                  name='pos_enc')(h, train)


class LinearInputLayer(nn.Module):
    """Linear -> LN -> Dropout -> ReLU -> PE
    (``transformer/encoder.py:34-41``, ``conformer_encoder.py:22-28``)."""

    adim: int
    dropout_rate: float = 0.1
    pos_enc: bool = True

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Dense(self.adim, name='linear')(x)
        x = nn.LayerNorm(epsilon=1e-5, name='norm')(x)
        x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        x = nn.relu(x)
        if self.pos_enc:
            x = PositionalEncoding(self.adim, self.dropout_rate,
                                   name='pos_enc')(x, train)
        return x


class TransformerEncoder(nn.Module):
    """ESPnet-style encoder (``transformer/encoder.py:13-89``)."""

    idim: int
    adim: int = 144
    dropout_rate: float = 0.1
    elayers: int = 3
    eunits: int = 576
    aheads: int = 4
    transformer_input_layer: str = 'conv2d'
    transformer_attn_dropout_rate: float = 0.0
    after_conv: bool = False

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        if self.transformer_input_layer == 'linear':
            x = LinearInputLayer(self.adim, self.dropout_rate,
                                 name='input_layer')(x, train)
        elif self.transformer_input_layer == 'conv2d':
            x = Conv2dSubsampling(self.idim, self.adim, self.dropout_rate,
                                  name='input_layer')(x, train)
            # the reference hardcodes x_mask = None before its (dead)
            # mask-subsampling line (``subsampling.py:35-39``) -- parity
            mask = None
        elif self.transformer_input_layer == 'conv2d_no':
            x = Conv2dNoSubsampling(self.adim, self.dropout_rate,
                                    name='input_layer')(x, train)
            mask = None
        else:
            raise ValueError(
                f'unknown input_layer: {self.transformer_input_layer}')
        for i in range(self.elayers):
            x, mask = TransformerEncoderLayer(
                self.adim, self.aheads, self.eunits, self.dropout_rate,
                self.transformer_attn_dropout_rate, self.after_conv,
                name=f'layer{i}')(x, mask, train)
        return nn.LayerNorm(epsilon=1e-12, name='norm')(x), mask


# ---------------------------------------------------------------------------
# Conformer
# ---------------------------------------------------------------------------


def rel_shift(x: jnp.ndarray) -> jnp.ndarray:
    """Transformer-XL relative shift on (B, H, q, k) scores
    (``conformer/attention.py:202-214``)."""
    b, h, q, k = x.shape
    x = jnp.pad(x, ((0, 0), (0, 0), (0, 0), (1, 0)))
    x = x.reshape(b, h, k + 1, q)
    return x[:, :, 1:].reshape(b, h, q, k)


class RelMultiHeadAttn(nn.Module):
    """Pre-LN relative-position MHA with shared QKV projection, r_w/r_r
    biases and sinusoidal relative embeddings
    (``conformer/attention.py:145-293``).  Residual included."""

    n_head: int
    d_model: int
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        b, t, _ = x.shape
        h = self.n_head
        d_head = self.d_model // h

        w = nn.LayerNorm(epsilon=1e-5, name='layer_norm')(x)
        qkv = nn.Dense(3 * h * d_head, use_bias=False, name='qkv_net')(w)
        q, k, v = jnp.split(qkv, 3, axis=-1)

        # relative position embeddings for pos_seq = T-1 .. 0
        pos_seq = jnp.arange(t - 1, -1, -1, dtype=jnp.float32)
        inv_freq = 1.0 / (10000.0 ** (np.arange(0, self.d_model, 2)
                                      / self.d_model))
        sinusoid = pos_seq[:, None] * jnp.asarray(inv_freq)[None]
        r = jnp.concatenate([jnp.sin(sinusoid), jnp.cos(sinusoid)],
                            axis=-1)                       # (T, d_model)
        r_k = nn.Dense(h * d_head, use_bias=False, name='r_net')(r)

        r_w_bias = self.param('r_w_bias', nn.initializers.zeros,
                              (h, d_head))
        r_r_bias = self.param('r_r_bias', nn.initializers.zeros,
                              (h, d_head))

        q = q.reshape(b, t, h, d_head)
        k = k.reshape(b, t, h, d_head)
        v = v.reshape(b, t, h, d_head)
        r_k = r_k.reshape(t, h, d_head)

        ac = jnp.einsum('bqhd,bkhd->bhqk', q + r_w_bias[None, None], k)
        bd = jnp.einsum('bqhd,khd->bhqk', q + r_r_bias[None, None], r_k)
        bd = rel_shift(bd)
        scores = (ac + bd) / np.sqrt(d_head)
        if mask is not None:
            scores = jnp.where(mask[:, None], scores, -jnp.inf)
        attn = jax.nn.softmax(scores, axis=-1)
        attn = nn.Dropout(self.dropout_rate, deterministic=not train)(attn)
        out = jnp.einsum('bhqk,bkhd->bqhd', attn, v).reshape(b, t,
                                                             h * d_head)
        out = nn.Dense(self.d_model, use_bias=False, name='o_net')(out)
        out = nn.Dropout(self.dropout_rate, deterministic=not train)(out)
        return x + out


class ConvolutionModule(nn.Module):
    """LN -> pointwise x2ch -> GLU -> depthwise k -> BN -> Swish ->
    pointwise -> dropout (``conformer/convolution.py:38-55``)."""

    d_model: int
    dropout_rate: float = 0.1
    kernel_size: int = 7
    bn_axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x, train: bool = False):
        h = nn.LayerNorm(epsilon=1e-5, name='norm')(x)
        h = nn.Dense(2 * self.d_model, name='pw1')(h)
        a, g = jnp.split(h, 2, axis=-1)
        h = a * jax.nn.sigmoid(g)                 # GLU
        h = nn.Conv(self.d_model, (self.kernel_size,),
                    padding=[(self.kernel_size // 2,) * 2],
                    feature_group_count=self.d_model, name='dw')(h)
        h = nn.BatchNorm(use_running_average=not train, momentum=0.9,
                         epsilon=1e-5, axis_name=self.bn_axis_name,
                         name='bn')(h)
        h = h * jax.nn.sigmoid(h)                  # Swish
        h = nn.Dense(self.d_model, name='pw2')(h)
        return nn.Dropout(self.dropout_rate, deterministic=not train)(h)


class MacaronFeedForward(nn.Module):
    """LN -> Linear -> Swish -> Dropout -> Linear -> Dropout
    (``conformer/macaron_feed_forward.py:5-19``)."""

    d_model: int
    d_ff: int
    dropout_rate: float = 0.1

    @nn.compact
    def __call__(self, x, train: bool = False):
        h = nn.LayerNorm(epsilon=1e-5, name='norm')(x)
        h = nn.Dense(self.d_ff, name='w_1')(h)
        h = h * jax.nn.sigmoid(h)
        h = nn.Dropout(self.dropout_rate, deterministic=not train)(h)
        h = nn.Dense(self.d_model, name='w_2')(h)
        return nn.Dropout(self.dropout_rate, deterministic=not train)(h)


class ConformerBlock(nn.Module):
    """Macaron block (``conformer/conformer_block.py:7-24``)."""

    d_model: int
    d_ff: int
    n_head: int
    dropout_rate: float = 0.1
    kernel_size: int = 7
    bn_axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        x = 0.5 * MacaronFeedForward(self.d_model, self.d_ff,
                                     self.dropout_rate,
                                     name='ffn1')(x, train) + x
        x = RelMultiHeadAttn(self.n_head, self.d_model, self.dropout_rate,
                             name='mhsa')(x, mask, train)
        x = ConvolutionModule(self.d_model, self.dropout_rate,
                              self.kernel_size, self.bn_axis_name,
                              name='conv')(x, train) + x
        x = 0.5 * MacaronFeedForward(self.d_model, self.d_ff,
                                     self.dropout_rate,
                                     name='ffn2')(x, train) + x
        return nn.LayerNorm(epsilon=1e-5, name='norm')(x)


class ConformerEncoder(nn.Module):
    """Linear input layer + N conformer blocks
    (``conformer/conformer_encoder.py:7-34``)."""

    idim: int
    adim: int = 144
    dropout_rate: float = 0.1
    elayers: int = 3
    eunits: int = 576
    aheads: int = 4
    kernel_size: int = 7
    bn_axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x, mask=None, train: bool = False):
        x = LinearInputLayer(self.adim, self.dropout_rate,
                             name='input_layer')(x, train)
        for i in range(self.elayers):
            x = ConformerBlock(self.adim, self.eunits, self.aheads,
                               self.dropout_rate, self.kernel_size,
                               self.bn_axis_name,
                               name=f'block{i}')(x, mask, train)
        return x, mask


# ---------------------------------------------------------------------------
# DCASE baseline CNN (``models_2020/baseline_model.py``)
# ---------------------------------------------------------------------------


class GLUConv(nn.Module):
    """Linear gate on channels times sigmoid of input
    (``baseline_model.py:7-18``)."""

    @nn.compact
    def __call__(self, x):
        lin = nn.Dense(x.shape[-1], name='linear')(x)
        return lin * jax.nn.sigmoid(x)


class ContextGating(nn.Module):
    """x times sigmoid(linear(x)) (``baseline_model.py:21-32``)."""

    @nn.compact
    def __call__(self, x):
        return x * jax.nn.sigmoid(
            nn.Dense(x.shape[-1], name='linear')(x))


class BaselineCNN(nn.Module):
    """Configurable conv stack: conv -> BN(eps 1e-3) -> activation ->
    dropout -> avg pool, per stage (``baseline_model.py:35-94``).
    Input/output (B, T, F, C)."""

    activation: str = 'Relu'
    conv_dropout: float = 0.0
    kernel_size: Sequence[int] = (3, 3, 3)
    padding: Sequence[int] = (1, 1, 1)
    stride: Sequence[int] = (1, 1, 1)
    nb_filters: Sequence[int] = (64, 64, 64)
    pooling: Sequence[Tuple[int, int]] = ((1, 4), (1, 4), (1, 4))
    bn_axis_name: Optional[str] = None

    @nn.compact
    def __call__(self, x, train: bool = False):
        for i, ch in enumerate(self.nb_filters):
            k, p, s = (self.kernel_size[i], self.padding[i],
                       self.stride[i])
            x = nn.Conv(ch, (k, k), strides=(s, s), padding=[(p, p)] * 2,
                        name=f'conv{i}')(x)
            # torch BatchNorm2d(momentum=0.99) means running = 0.01*run
            # + 0.99*batch; nn.BatchNorm's momentum is the complement
            # -> 0.01
            # (``models_2020/baseline_model.py:56``)
            x = nn.BatchNorm(use_running_average=not train, momentum=0.01,
                             epsilon=1e-3, axis_name=self.bn_axis_name,
                             name=f'bn{i}')(x)
            act = self.activation.lower()
            if act == 'relu':
                x = nn.relu(x)
            elif act == 'leakyrelu':
                x = nn.leaky_relu(x, 0.2)
            elif act == 'glu':
                x = GLUConv(name=f'glu{i}')(x)
            elif act == 'cg':
                x = ContextGating(name=f'cg{i}')(x)
            if self.conv_dropout:
                x = nn.Dropout(self.conv_dropout,
                               deterministic=not train)(x)
            pool = tuple(self.pooling[i])
            if pool != (1, 1):
                x = nn.avg_pool(x, pool, strides=pool)
        return x
