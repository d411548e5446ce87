"""Device-side dequantization of compressed audio wire formats.

Serving and training both move raw audio from host to device (a
24+8-clip joint step ships 10.24 MB of int16 PCM).  Shipping a narrower
wire and dequantizing on device trades a few elementwise device ops
(the decode fuses into the frontend matmuls) for a proportional cut in
host->device bytes.

Wire formats, recognized from dtype + buffer width:

* float32 — passthrough.
* int16 PCM — exact `x / 32767` dequant (2 bytes/sample, the training
  default; `utils/utilities.py` int16_to_float32 parity).
* uint8 G.711 mu-law — 256-entry table gather (1 byte/sample, lossy
  telephony codec).
* uint8 qN block-scaled (N in QN_BITS) — N-bit mantissas per
  128-sample block with float16 scales packed into the same buffer
  (`audio_io.qn_encode`); q6 is ~2.6x narrower than float32.  The
  decode is PURE ELEMENTWISE (static slices per bit-phase group): a
  gather-based decode measured ~150 ms per 256-clip batch of device
  time, this formulation is free.
* uint8 IMA ADPCM (`audio_io.adpcm_encode`, standard wav tag 0x11 at
  ~4.06 bits/sample — half of mu-law's bytes; SNR-beats q4 on natural
  broadband audio, q4-grade on noise/near-Nyquist tones — see
  tests/test_adpcm.py) — one lax.scan over the 505-sample block
  recursion, vectorized across every (clip, block) lane.

This is the single implementation used by the serving engine
(`serve/engine.py`) and the train step (`train/step.py`).
"""

import math

import jax
import jax.numpy as jnp

from sed_jax.data import audio_io

__all__ = ['dequant_wire', 'wire_widths', 'dequant_v6_pool']


def wire_widths(samples: int) -> dict:
    """Map uint8 wire width -> decode tag for a clip of `samples`:
    a qN bit count (int) or the string ``'adpcm4'`` (IMA ADPCM at the
    default block align).  The ADPCM wire width is odd by construction
    (``audio_io.adpcm_bytes`` trailing pad byte) while every qN and
    mu-law width is even, so the width-keyed dispatch is collision-free
    — asserted here, not assumed."""
    widths: dict = {}
    if samples % audio_io.Q4_BLOCK == 0:
        widths = {audio_io.qn_bytes(samples, n): n
                  for n in audio_io.QN_BITS}
    aw = audio_io.adpcm_bytes(samples)
    assert aw % 2 == 1 and aw not in widths and aw != samples, (
        samples, aw)
    widths[aw] = 'adpcm4'
    for n in (2, 3):
        w = audio_io.adpcm_n_bytes(samples, n)
        assert w % 2 == 1 and w not in widths and w != samples, (
            samples, n, w)
        widths[w] = f'adpcm{n}'
    return widths


def dequant_wire(wav, samples: int = None):
    """Dequantize a (B, W) wire buffer to (B, samples) float32.

    `samples` is the decoded clip length; defaults to ``wav.shape[-1]``
    for float32/int16 (where width == samples) and is REQUIRED for
    uint8 buffers — a qN buffer whose width happened to be taken as
    `samples` would silently mis-decode through the mu-law table.
    uint8 buffers are decoded as qN when their width matches
    ``qn_bytes(samples, N)`` for some supported N, as mu-law when
    width == samples, and rejected loudly otherwise.
    """
    if wav.dtype == jnp.uint8 and samples is None:
        raise ValueError(
            'dequant_wire: uint8 wire buffers need an explicit '
            '`samples` (decoded clip length) — the buffer width alone '
            'cannot distinguish mu-law from the narrower qN wires')
    if samples is None:
        samples = wav.shape[-1]
    width_bits = wire_widths(samples)
    if wav.dtype == jnp.int16:
        return wav.astype(jnp.float32) / 32767.0
    tag = width_bits.get(wav.shape[-1]) if wav.dtype == jnp.uint8 else None
    if isinstance(tag, str) and tag.startswith('adpcm'):
        return _adpcm_decode(wav, samples, bits=int(tag[5:]))
    if wav.dtype == jnp.uint8 and wav.shape[-1] in width_bits:
        bits = width_bits[wav.shape[-1]]
        b = wav.shape[0]
        nb = samples * bits // 8
        top = (1 << (bits - 1)) - 1
        scale = jax.lax.bitcast_convert_type(
            wav[:, nb:].reshape(b, -1, 2),
            jnp.float16).astype(jnp.float32)           # (B, S/128)
        # big-endian bitstream: sample i = bits [i*bits, ..).  Groups
        # repeat every lcm(8, bits) bits, so each sample's byte offsets
        # within a group are STATIC slices.
        gbytes = bits // math.gcd(8, bits)
        gsamples = gbytes * 8 // bits
        codes = wav[:, :nb].astype(jnp.int32).reshape(
            b, nb // gbytes, gbytes)
        parts = []
        for k in range(gsamples):
            j = (k * bits) >> 3
            sh = 16 - bits - ((k * bits) & 7)
            hi = codes[:, :, j]
            lo = codes[:, :, min(j + 1, gbytes - 1)]
            parts.append((((hi << 8) | lo) >> sh) & ((1 << bits) - 1))
        q = jnp.stack(parts, axis=-1).reshape(b, samples)
        x = (q - top - 1).astype(jnp.float32)
        x = x.reshape(b, samples // audio_io.Q4_BLOCK,
                      audio_io.Q4_BLOCK) * scale[:, :, None]
        return x.reshape(b, samples)
    if wav.dtype == jnp.uint8:
        if wav.shape[-1] != samples:
            raise ValueError(
                f'dequant_wire: uint8 buffer width {wav.shape[-1]} is '
                f'neither a qN wire width for {samples} samples '
                f'({sorted(width_bits)}) nor the mu-law width '
                f'(== samples)')
        table = jnp.asarray(audio_io.mulaw_decode_table())
        return jnp.take(table, wav.astype(jnp.int32))
    return wav


def _adpcm_split_dev(wav, bits: int = 4):
    """(B, wire) uint8 -> per-(clip, block) lane arrays: initial
    predictor, initial step index, and the (lanes, spb-1) code stream.
    bits=4 is standard IMA nibble packing (low nibble first); the
    narrow adpcm3/adpcm2 wires pack codes as a big-endian bitstream
    (``audio_io`` narrow-ADPCM section), unpacked here with the qN
    static-slice formulation (code bit offsets repeat every
    lcm(8, bits) bits)."""
    ba = audio_io.ADPCM_BLOCK_ALIGN
    spb = audio_io.adpcm_n_samples_per_block(bits, ba)
    pad = audio_io.ADPCM_N_PAD[bits]
    b = wav.shape[0]
    nbl = (wav.shape[-1] - pad) // ba        # trailing pad bytes dropped
    blocks = jax.lax.slice_in_dim(wav, 0, nbl * ba, axis=1).reshape(
        b * nbl, ba).astype(jnp.int32)
    pred0 = blocks[:, 0] | (blocks[:, 1] << 8)
    pred0 = jnp.where(pred0 >= 32768, pred0 - 65536, pred0)
    idx0 = jnp.clip(blocks[:, 2], 0, 88)
    data = blocks[:, 4:]
    if bits == 4:
        nib = jnp.stack([data & 0xF, data >> 4], axis=-1).reshape(
            b * nbl, spb - 1)
    else:
        gbytes = bits // math.gcd(8, bits)
        gsamples = gbytes * 8 // bits
        groups = data.reshape(b * nbl, (ba - 4) // gbytes, gbytes)
        parts = []
        for k in range(gsamples):
            j = (k * bits) >> 3
            sh = 16 - bits - ((k * bits) & 7)
            hi = groups[:, :, j]
            lo = groups[:, :, min(j + 1, gbytes - 1)]
            parts.append((((hi << 8) | lo) >> sh) & ((1 << bits) - 1))
        nib = jnp.stack(parts, axis=-1).reshape(b * nbl, spb - 1)
    return pred0, idx0, nib, b, nbl, spb


def _clamp_add_compose(lhs, rhs):
    """Compose two saturating-add transforms, lhs applied FIRST.

    A transform ``T = (a, l, u)`` is the function
    ``x -> clip(x + a, l, u)`` (with ``l <= u``).  These are closed
    under composition — ``rhs(lhs(x)) = clip(x + a', l', u')`` with
    ``a' = a1 + a2``, ``l' = clip(l1 + a2, l2, u2)``,
    ``u' = clip(u1 + a2, l2, u2)`` — which makes BOTH of IMA ADPCM's
    sequential recursions (step-index and predictor: each step is a
    clamped add) reducible by ``lax.associative_scan`` in log2 depth
    instead of a 504-step serial scan."""
    a1, l1, u1 = lhs
    a2, l2, u2 = rhs
    return (a1 + a2,
            jnp.clip(l1 + a2, l2, u2),
            jnp.clip(u1 + a2, l2, u2))


def _adpcm_decode_assoc(wav, samples: int):
    """IMA ADPCM device decode, bit-exact to ``audio_io.adpcm_decode_np``.

    Both recurrences are chains of saturating adds
    ``x -> clip(x + a, lo, hi)``, a function family closed under
    composition, so each resolves with one ``lax.associative_scan``
    (log2(504) ~ 9 levels of elementwise int32 ops) instead of a
    504-step ``lax.scan`` — sequential depth ~18
    total, fully vectorized over every (clip, block) lane:

      1. step-index chain: ``idx_t = clip(idx_{t-1} + itab[n_t], 0, 88)``
         depends only on the nibbles — prefix-compose the transforms,
         apply to ``idx0``.
      2. predictor chain: with ``idx_{t-1}`` known, each step's signed
         ``diff`` is elementwise; ``pred_t = clip(pred_{t-1} +/- diff,
         -32768, 32767)`` is another clamp-add prefix.

    int32 ranges: accumulated ``a`` is bounded by 504 * max|diff|
    (~31M) — no overflow."""
    pred0, idx0, nib, b, nbl, spb = _adpcm_split_dev(wav)
    steps = jnp.asarray(audio_io.IMA_STEP_TABLE)
    itab = jnp.asarray(audio_io.IMA_INDEX_TABLE)

    # time-major layout (T, lanes): associative_scan slices odd/even
    # elements along the scan axis every level — on the MAJOR axis those
    # are contiguous lane-width blocks; scanning the minor axis instead
    # forces strided relayouts per level
    nib_t = nib.T                                      # (T, L)

    # 1. resolve the step-index recursion (prefix of clamp-adds)
    ia = jnp.take(itab, nib_t)
    A, L, U = jax.lax.associative_scan(
        _clamp_add_compose,
        (ia, jnp.zeros_like(ia), jnp.full_like(ia, 88)), axis=0)
    idx_t = jnp.clip(idx0[None, :] + A, L, U)          # idx AFTER nib t
    idx_prev = jnp.concatenate([idx0[None, :], idx_t[:-1]], axis=0)

    # 2. per-step signed diff is now elementwise; resolve the predictor
    step = jnp.take(steps, idx_prev)
    diff = ((step >> 3)
            + jnp.where((nib_t & 4) != 0, step, 0)
            + jnp.where((nib_t & 2) != 0, step >> 1, 0)
            + jnp.where((nib_t & 1) != 0, step >> 2, 0))
    pa = jnp.where((nib_t & 8) != 0, -diff, diff)
    A2, L2, U2 = jax.lax.associative_scan(
        _clamp_add_compose,
        (pa, jnp.full_like(pa, -32768), jnp.full_like(pa, 32767)),
        axis=0)
    preds = jnp.clip(pred0[None, :] + A2, L2, U2)
    out = jnp.concatenate([pred0[None, :], preds], axis=0)  # (spb, L)
    out = out.T.reshape(b, nbl * spb)[:, :samples]
    return out.astype(jnp.float32) / 32768.0


def _adpcm_decode_scan(wav, samples: int, unroll: int = 1):
    """Sequential formulation: one ``lax.scan`` over the 505-sample
    block recursion.  ``unroll=K`` fuses K recursion steps into each
    while-loop iteration — the per-iteration overhead (~80 us on the
    measured chip), not the elementwise work, dominates this scan, so
    unrolling cuts decode device time nearly linearly in K."""
    pred0, idx0, nib, b, nbl, spb = _adpcm_split_dev(wav)
    steps = jnp.asarray(audio_io.IMA_STEP_TABLE)
    itab = jnp.asarray(audio_io.IMA_INDEX_TABLE)

    def step_fn(carry, n):
        pred, idx = carry
        step = jnp.take(steps, idx)
        diff = ((step >> 3)
                + jnp.where((n & 4) != 0, step, 0)
                + jnp.where((n & 2) != 0, step >> 1, 0)
                + jnp.where((n & 1) != 0, step >> 2, 0))
        pred = jnp.clip(jnp.where((n & 8) != 0, pred - diff, pred + diff),
                        -32768, 32767)
        idx = jnp.clip(idx + jnp.take(itab, n), 0, 88)
        return (pred, idx), pred

    _, ys = jax.lax.scan(step_fn, (pred0, idx0), nib.T, unroll=unroll)
    out = jnp.concatenate([pred0[None], ys], axis=0)      # (spb, lanes)
    out = out.T.reshape(b, nbl * spb)[:, :samples]
    return out.astype(jnp.float32) / 32768.0


def _resolve_clamp_add_chain(a, l, u, x0, group: int):
    """Resolve ``x_t = clip(x_{t-1} + a_t, l_t, u_t)`` for every t in
    O(sqrt T) fused steps; lane-major: ``a/l/u`` are (L, T), ``x0`` is
    (L,), returns the (L, T) array of states AFTER each step.

    Blocked two-level prefix over the clamp-add transform monoid
    (``_clamp_add_compose``): T is split into NG groups of ``group``
    samples; (1) inclusive prefixes WITHIN each group are built by
    ``group - 1`` sequential composes, each vectorized over all NG
    groups and L lanes; (2) an unrolled NG-step carry walks the state
    across group boundaries on (L,)-sized arrays; (3) one elementwise
    application maps group-start states through the within-group
    prefixes.  Everything stays in the buffer's natural lane-major
    layout — no transposes, no ``associative_scan`` odd/even
    interleave."""
    lanes, t_len = a.shape
    ng = t_len // group
    assert ng * group == t_len, (t_len, group)
    ta = a.reshape(lanes, ng, group)
    tl = l.reshape(lanes, ng, group)
    tu = u.reshape(lanes, ng, group)
    # (1) within-group inclusive prefix transforms, sequential in j but
    # vectorized over (lanes, ng)
    pa = [ta[..., 0]]
    pl = [tl[..., 0]]
    pu = [tu[..., 0]]
    for j in range(1, group):
        na, nl, nu = _clamp_add_compose(
            (pa[-1], pl[-1], pu[-1]),
            (ta[..., j], tl[..., j], tu[..., j]))
        pa.append(na)
        pl.append(nl)
        pu.append(nu)
    pa = jnp.stack(pa, axis=-1)          # (lanes, ng, group)
    pl = jnp.stack(pl, axis=-1)
    pu = jnp.stack(pu, axis=-1)
    # (2) carry the state across groups: unrolled walk on (L,) arrays
    xs = [x0]
    for k in range(ng - 1):
        xs.append(jnp.clip(xs[-1] + pa[:, k, -1], pl[:, k, -1],
                           pu[:, k, -1]))
    x_start = jnp.stack(xs, axis=-1)     # (lanes, ng)
    # (3) apply within-group prefixes to each group's start state
    x_all = jnp.clip(x_start[:, :, None] + pa, pl, pu)
    return x_all.reshape(lanes, t_len)


def _take_small(table, idx, chunk: int = 16):
    """Exact int gather from a small table via ``chunk``-entry takes +
    a select chain, so each take indexes a table of at most ``chunk``
    entries (the 89-entry IMA step table is gathered ~40M times per
    256-clip batch)."""
    n = (table.shape[0] + chunk - 1) // chunk
    padded = jnp.pad(table, (0, n * chunk - table.shape[0]))
    assert chunk & (chunk - 1) == 0, chunk
    shift = chunk.bit_length() - 1
    r = idx & (chunk - 1)
    q = idx >> shift
    out = jnp.take(padded[0:chunk], r)
    for k in range(1, n):
        out = jnp.where(q == k,
                        jnp.take(padded[k * chunk:(k + 1) * chunk], r),
                        out)
    return out


def _adpcm_decode(wav, samples: int, group: int = 24, bits: int = 4):
    """Default ADPCM device decode, bit-exact to
    ``audio_io.adpcm_decode_np`` (bits=4) / ``adpcm_n_decode_np``
    (the narrow adpcm3/adpcm2 wires — same recurrences at ``bits-1``
    magnitude bits, so the whole formulation below is width-generic).

    Both of the codec's recurrences are chains of saturating adds
    ``x -> clip(x + a, lo, hi)`` — closed under composition — so each
    resolves with the blocked two-level prefix
    (``_resolve_clamp_add_chain``) in ~2*sqrt(T) fused steps instead of
    a 504-step serial scan (41 ms per 64-clip batch measured) or an
    ``associative_scan`` (lowers poorly here).  The step-index chain
    depends only on the nibbles; once resolved, the per-sample signed
    ``diff`` is elementwise (one big table gather instead of 504 small
    ones) and the predictor chain is a second blocked prefix."""
    pred0, idx0, nib, b, nbl, spb = _adpcm_split_dev(wav, bits)
    steps = jnp.asarray(audio_io.IMA_STEP_TABLE)
    itab = jnp.asarray(audio_io.adpcm_index_table(bits))
    # lane-major (L, T) throughout — no transposes
    ia = jnp.take(itab, nib)
    idx_after = _resolve_clamp_add_chain(
        ia, jnp.zeros_like(ia), jnp.full_like(ia, 88), idx0, group)
    idx_prev = jnp.concatenate([idx0[:, None], idx_after[:, :-1]],
                               axis=1)

    step = _take_small(steps, idx_prev)
    diff = step >> (bits - 1)
    for k in range(bits - 2, -1, -1):
        diff = diff + jnp.where((nib & (1 << k)) != 0,
                                step >> (bits - 2 - k), 0)
    pa = jnp.where((nib & (1 << (bits - 1))) != 0, -diff, diff)
    preds = _resolve_clamp_add_chain(
        pa, jnp.full_like(pa, -32768), jnp.full_like(pa, 32767),
        pred0, group)
    out = jnp.concatenate([pred0[:, None], preds], axis=1)  # (L, spb)
    out = out.reshape(b, nbl * spb)[:, :samples]
    return out.astype(jnp.float32) / 32768.0


# ---------------------------------------------------------------------------
# v6 ragged wire: device decode of the lossless variable-rate q6 re-pack
# (`audio_io.v6_encode_clip` format doc).  Unlike the fixed-width wires
# above, v6 clips have DIFFERENT byte lengths, so a batch arrives as one
# flat little-endian word pool plus per-clip word offsets (the ragged
# resident path uploads only the true bytes; the fixed-shape gather to
# the worst-case width happens on device, off the wire).
# ---------------------------------------------------------------------------


def _words_to_bytes(w):
    """int32 words (..., W) -> little-endian int32 bytes (..., 4W)."""
    by = jnp.stack([w & 0xFF, (w >> 8) & 0xFF,
                    (w >> 16) & 0xFF, (w >> 24) & 0xFF], axis=-1)
    return by.reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def _unpack_subgroup(data, w):
    """(..., G, 4w) uint8-valued int32 -> (..., G, 32) codes at width w
    (big-endian bitstream; the qN static-slice formulation at sub-group
    granularity: sample bit offsets repeat every lcm(8, w) bits)."""
    gbytes = w // math.gcd(8, w)
    gsamples = gbytes * 8 // w
    lead = data.shape[:-1]
    groups = data.reshape(lead + (4 * w // gbytes, gbytes))
    parts = []
    for k in range(gsamples):
        j = (k * w) >> 3
        sh = 16 - w - ((k * w) & 7)
        hi = groups[..., j]
        lo = groups[..., min(j + 1, gbytes - 1)]
        parts.append((((hi << 8) | lo) >> sh) & ((1 << w) - 1))
    return jnp.stack(parts, axis=-1).reshape(lead + (32,))


def dequant_v6_pool(pool, offsets, samples: int):
    """Decode a batch of v6 clips from a flat word pool.

    ``pool``: (P,) int32 — concatenated per-clip v6 payloads (each a
    multiple of 16 bytes, little-endian), plus >= v6_header_bytes of
    zero tail so padding clips (offset pointing at the tail) decode to
    silence.  ``offsets``: (B,) int32 WORD offset of each clip's
    payload.  Returns (B, samples) float32, bit-identical to
    ``audio_io.v6_decode_np`` per clip (which is bit-identical to the
    q6 wire's decode).

    All device work is fixed-shape: one header gather, one worst-case
    data-word gather at cumsum(width) offsets, six static-slice
    sub-group unpacks, and a 128-step unified-predictor ``lax.scan``
    vectorized over every (clip, block) lane (order-3's rounding shift
    makes the recurrence non-associative, so the prefix tricks used for
    ADPCM above do not apply; the scan is short and lane-parallel).
    """
    from sed_jax.data import audio_io
    nb = samples // audio_io.Q4_BLOCK
    nsub = nb * 4
    hw = audio_io.v6_header_bytes(nb) // 4
    b = offsets.shape[0]
    pmax = pool.shape[0] - 1

    # header: one contiguous gather, then byte fields
    hidx = jnp.clip(offsets[:, None] + jnp.arange(hw)[None, :], 0, pmax)
    hby = _words_to_bytes(jnp.take(pool, hidx))          # (B, hw*4)
    scale_u16 = (hby[:, 0:2 * nb:2]
                 | (hby[:, 1:2 * nb:2] << 8)).astype(jnp.uint16)
    scale = jax.lax.bitcast_convert_type(
        scale_u16, jnp.float16).astype(jnp.float32)      # (B, nb)
    mode = (hby[:, 2 * nb:4 * nb:2]
            | (hby[:, 2 * nb + 1:4 * nb:2] << 8))        # (B, nb)
    order = mode & 3

    def _i8(v):
        return ((v + 128) & 255) - 128

    init1 = _i8(hby[:, 4 * nb:5 * nb])
    init2 = _i8(hby[:, 5 * nb:6 * nb])
    coef = _i8(hby[:, 6 * nb:7 * nb])

    widths = jnp.stack([(mode >> (2 + 3 * g)) & 7 for g in range(4)],
                       axis=-1).reshape(b, nsub)          # (B, nsub)
    # sub-group data = width words each; offsets by exclusive prefix
    doff = (offsets[:, None] + hw
            + jnp.cumsum(widths, axis=1) - widths)        # (B, nsub)
    didx = jnp.clip(doff[:, :, None] + jnp.arange(6)[None, None, :],
                    0, pmax)
    dby = _words_to_bytes(jnp.take(pool, didx))           # (B, nsub, 24)

    r = jnp.zeros((b, nsub, 32), jnp.int32)
    for w in range(1, 7):
        codes = _unpack_subgroup(dby[:, :, :4 * w], w)
        r = jnp.where((widths == w)[:, :, None],
                      codes - (1 << (w - 1)), r)
    r = r.reshape(b, nb, audio_io.Q4_BLOCK)

    # unified predictor recurrence, one scan over the 128 in-block
    # steps, vectorized over (clip, block) lanes
    lanes = b * nb
    rT = r.reshape(lanes, audio_io.Q4_BLOCK).T            # (T, L)
    orderL = order.reshape(lanes)
    coefL = coef.reshape(lanes)

    def step(carry, rt):
        qp, qp2 = carry
        pred = jnp.select(
            [orderL == 1, orderL == 2, orderL == 3],
            [qp, 2 * qp - qp2, ((coefL * qp + 16) >> 5) - qp2], 0)
        q = rt + pred
        return (q, qp), q

    _, qT = jax.lax.scan(step,
                         (init1.reshape(lanes), init2.reshape(lanes)),
                         rT, unroll=8)
    q = qT.T.reshape(b, nb, audio_io.Q4_BLOCK)
    return (q.astype(jnp.float32) * scale[:, :, None]).reshape(
        b, samples)
