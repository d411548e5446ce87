"""Batched SED serving engine: wav -> events -> XML.

The reference serving loop runs batch-size-1, one window at a time, with a
full host<->device round trip per window (``pytorch/predict.py:297-339``)
— the main inefficiency this engine removes.  Here, all overlapped
windows of a file (and windows of many files) are batched into a single
jitted forward; only event decoding and XML stay host-side.

Window schedule parity (``pytorch/predict.py:296-338``): windows advance
1 s when ``--overlap`` else ``sample_duration`` s; window n >= 1 runs only
while ``start + sample_duration <= duration``; short files still get one
zero-padded window.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sed_jax import config as sed_config
from sed_jax.config import AudioConfig, SedParams, PREDICT_SED_PARAMS
from sed_jax.data import audio_io
import sed_jax.post.events as post_events
import sed_jax.post.merge as post_merge
import sed_jax.post.vad as vad
from sed_jax.post import xml_writer
from sed_jax.ops import wire as wire_ops


class LinkCollapseError(RuntimeError):
    """Raised mid-pass when the host->device upload or the result pull
    misses the caller's ``upload_deadline_s``.

    The partial pass is abandoned cheaply: the upload threads are
    daemonic and left to drain in the background (a ``device_put`` in
    flight cannot be cancelled), the orchestrating thread returns
    immediately, and the engine stays fully usable — a retry re-uploads
    from the host buffers."""


def window_starts(duration: float, sample_duration: int,
                  overlap: bool, step: Optional[float] = None
                  ) -> List[float]:
    """Start offsets (seconds) of the reference's sliding-window loop.

    ``predict.py`` advances 1 s when ``--overlap`` else a full window
    (``predict.py:334-338``); ``inference_prob_overlap`` advances
    ``overlap_value`` s (``main_strong.py:829-831``) — pass ``step`` for
    that case.
    """
    if step is None:
        step = 1 if overlap else sample_duration
    starts = [0.0]
    start = step
    while start + sample_duration <= duration:
        starts.append(float(start))
        start += step
    return starts


class SedInferenceEngine:
    """Batched jitted inference over fixed-shape window batches.

    Args:
      model: a model from the registry.
      variables: its variables ({'params', 'batch_stats'}).
      cfg: audio quality config.
      sample_duration: window length in seconds (reference ``--sample_duration``).
      overlap: 1 s hop when True else non-overlapped windows.
      overlap_value: merge hop in seconds (reference ``--overlap_value``).
      sed_params: event-decoding thresholds.
      batch_size: device batch for the jitted forward (windows are padded
        up to a multiple of this, so exactly one compilation happens).
      mesh: optional jax.sharding.Mesh for data-parallel serving — the
        window batch is sharded over the ``data`` axis and parameters are
        replicated.
      launch_group: predict_clips_stream fuses this many full batches
        into one device launch via lax.map (single-device only), so the
        per-launch cost is paid once per group.
      pull_format: what the stream pulls off-device per batch group.
        'topk' (default): packed masks of the top-k threshold-margin
        tracks (~136 B/clip) with an on-device all-tracks fallback for
        saturation, the fewest device->host bytes; 'full': packed hi|lo
        crossing masks for every track in one fixed-shape pull
        (~3.2 KB/clip, fewest device ops); 'tracks': per-track maxima +
        gathers of the active tracks (default when
        gather_format='float').  All three are exact and
        interchangeable (tests/test_serve.py).
    """

    def __init__(self, model, variables, cfg: AudioConfig,
                 sample_duration: int = 5, overlap: bool = True,
                 overlap_value: float = 1.0,
                 sed_params: SedParams = PREDICT_SED_PARAMS,
                 batch_size: int = 32,
                 labels: Sequence[str] = sed_config.LABELS,
                 mesh=None, gather_format: str = 'packed',
                 launch_group: int = 2,
                 pull_format: Optional[str] = None):
        self.model = model
        self.variables = variables
        self.cfg = cfg
        self.sample_duration = sample_duration
        self.overlap = overlap
        self.overlap_value = overlap_value
        self.sed_params = sed_params
        self.batch_size = batch_size
        self.labels = labels
        self.window_samples = cfg.sample_rate * sample_duration
        assert gather_format in ('packed', 'float')
        self.gather_format = gather_format
        # default to the fewest pulled bytes ('topk' pulls ~136 B/clip
        # vs 'full''s 3.2 KB/clip; exactness is preserved by the
        # all-tracks fallback on saturation); 'float' gathers need the
        # per-track pull path
        if pull_format is None:
            pull_format = 'tracks' if gather_format == 'float' else 'topk'
        # 'full'/'topk' pulls are packed uint8 hi|lo masks; the float
        # decode branch would misread those bytes as probabilities
        assert not (pull_format in ('full', 'topk')
                    and gather_format == 'float'), (
            "pull_format='full'/'topk' ships packed crossing masks and "
            "requires gather_format='packed'")
        # bulk APIs dispatch at most this many forward batches before
        # pulling results (bounds live device buffers on huge inputs)
        self.dispatch_ahead_batches = 64
        # predict_clips_stream fuses this many FULL batches into one
        # device launch (lax.map), paying the per-launch cost once per
        # group; single-device only
        self.launch_group = max(1, launch_group)
        # 'tracks': pull per-track maxima then gather-launch the active
        # tracks (least bytes off-device).  'full': the forward itself
        # returns packed hi|lo masks for every track — one launch + one
        # fixed-shape pull per batch group (fewest launches and pulls;
        # ~64 B x 2 x classes per clip off-device)
        assert pull_format in ('tracks', 'full', 'topk')
        self.pull_format = pull_format
        # top-k capacity per BATCH for pull_format='topk' (x group for
        # grouped launches); 2 active tracks per clip covers the bench
        # distribution ~3x over.  Overflow (all pulled margins > 0) is
        # detected host-side and falls back to the all-tracks pull.
        self._topk_capacity = 2 * batch_size

        def _prep(wav, samples=None):
            # quantized wire formats are dequantized on device: int16 PCM
            # (exact, halves host->device traffic vs float32), uint8 G.711
            # mu-law (lossy telephony codec, quarters it; one 256-entry
            # table gather), and N-bit block-scaled qN wires (q6 ~2.6x,
            # q5 ~3.1x, q4 ~3.9x less than float32) — recognized by
            # their narrower wire width.  Shared with the train step:
            # sed_jax/ops/wire.py.
            return wire_ops.dequant_wire(
                wav, samples if samples is not None
                else self.window_samples)
        self._prep = _prep

        self.mesh = mesh
        if mesh is not None:
            from sed_jax.parallel import mesh as mesh_lib
            assert batch_size % mesh.devices.size == 0, (
                'batch_size must divide evenly over the mesh')
            self._replicated = mesh_lib.replicated_sharding(mesh)
            self._sharded = mesh_lib.batch_sharding(mesh)
            self.variables = jax.device_put(variables, self._replicated)
            jit_kw = dict(in_shardings=(self._replicated, self._sharded))
        else:
            self._replicated = self._sharded = None
            jit_kw = {}

        def _forward(variables, wav):
            out = model.apply(variables, _prep(wav), train=False)
            return out['framewise_output'], out['clipwise_output']

        self._forward = jax.jit(_forward, **jit_kw)

        # -- low-transfer clip path ----------------------------------------
        # Framewise probabilities stay on device; the host pulls back
        # only the per-track maxima and then gathers the few
        # threshold-active tracks.
        coverage = post_merge.coverage_counts(
            self._clip_out_frames(), sample_duration, overlap_value)

        def _forward_scan(variables, wav):
            out = model.apply(variables, _prep(wav), train=False)
            framewise = out['framewise_output']
            framewise = framewise / jnp.asarray(coverage,
                                                framewise.dtype)[None, :,
                                                                 None]
            track_max = jnp.max(framewise, axis=1)          # (B, C)
            return framewise, track_max

        def _gather_tracks(framewise, idx_n, idx_c):
            # (B, T, C)[idx_n, :, idx_c] -> (K, T)
            return framewise[idx_n, :, idx_c]

        def _forward_scan_group(variables, wavs):
            # (G, B, wire) -> one device launch for G*B clips.  lax.map
            # keeps per-step activations B-sized (a G*B-wide batch can
            # exhaust device memory) while paying the per-launch cost
            # once instead of G times.
            fw, tm = jax.lax.map(
                lambda w: _forward_scan(variables, w), wavs)
            return (fw.reshape((-1,) + fw.shape[2:]),
                    tm.reshape((-1,) + tm.shape[2:]))

        t_frames = len(coverage)

        def _packed_from_fw(fw):
            # (B, T, C) framewise -> (B, C, 2*tb) uint8 packed high|low
            # crossing masks, contracting over time with a weight matrix
            # (einsum btc,tk->bck) instead of a transpose + bit pack
            tb_ = self._track_bytes
            pack_w = jnp.asarray(self._pack_w)          # (tb*8, tb)
            hi = (fw > self._high_dev[None, None, :]).astype(jnp.float32)
            lo = (fw >= self._low_dev[None, None, :]).astype(jnp.float32)
            hi = jnp.pad(hi, ((0, 0), (0, tb_ * 8 - fw.shape[1]), (0, 0)))
            lo = jnp.pad(lo, ((0, 0), (0, tb_ * 8 - fw.shape[1]), (0, 0)))
            hi_p = jnp.einsum('btc,tk->bck', hi, pack_w).astype(jnp.uint8)
            lo_p = jnp.einsum('btc,tk->bck', lo, pack_w).astype(jnp.uint8)
            return jnp.concatenate([hi_p, lo_p], axis=2)   # (B, C, 2tb)

        def _forward_packed_all(variables, wav):
            # one launch -> (B, C, 2*tb) uint8: packed high|low crossing
            # masks for EVERY (clip, class) track.  This replaces
            # [forward, track-max pull, K gather launches, K pulls] with
            # [forward, one pull]; the host derives the active set from
            # the hi masks (any bit set <=> max > high).
            fw, _tm = _forward_scan(variables, wav)
            return _packed_from_fw(fw)

        def _forward_packed_all_group(variables, wavs):
            out = jax.lax.map(
                lambda w: _forward_packed_all(variables, w), wavs)
            return out.reshape((-1,) + out.shape[2:])

        def _forward_packed_topk(variables, wav):
            # one launch -> (K, 2tb+8) uint8: packed hi|lo masks of the
            # K tracks with the largest (max - high_threshold) margin,
            # plus their flat index (int32) and margin (f32) bitcast
            # into the same buffer.  Active tracks (margin > 0) are a
            # prefix of the top-k order, so the host pulls ~140 KB once
            # instead of the 3.2 KB/clip all-tracks buffer.
            fw, tm = _forward_scan(variables, wav)
            packed = _packed_from_fw(fw)                   # (B, C, 2tb)
            margin = (tm - self._high_dev[None, :]).reshape(-1)
            k = min(self._topk_capacity, margin.shape[0])
            vals, idx = jax.lax.top_k(margin, k)
            rows = packed.reshape((-1, packed.shape[-1]))[idx]
            idx_b = jax.lax.bitcast_convert_type(
                idx.astype(jnp.int32), jnp.uint8)          # (K, 4)
            val_b = jax.lax.bitcast_convert_type(
                vals.astype(jnp.float32), jnp.uint8)       # (K, 4)
            tk = jnp.concatenate([rows, idx_b, val_b], axis=1)
            # the all-tracks buffer stays ON DEVICE as the saturation
            # fallback (pulled only when every top-k margin is > 0)
            return tk, packed

        def _forward_packed_topk_group(variables, wavs):
            # grouped variant: top-k is taken over the WHOLE group
            def one(w):
                fw, tm = _forward_scan(variables, w)
                return _packed_from_fw(fw), tm
            packed, tm = jax.lax.map(one, wavs)
            packed = packed.reshape((-1,) + packed.shape[2:])
            tm = tm.reshape((-1, tm.shape[-1]))
            margin = (tm - self._high_dev[None, :]).reshape(-1)
            k = min(self._topk_capacity * wavs.shape[0], margin.shape[0])
            vals, idx = jax.lax.top_k(margin, k)
            rows = packed.reshape((-1, packed.shape[-1]))[idx]
            idx_b = jax.lax.bitcast_convert_type(
                idx.astype(jnp.int32), jnp.uint8)
            val_b = jax.lax.bitcast_convert_type(
                vals.astype(jnp.float32), jnp.uint8)
            tk = jnp.concatenate([rows, idx_b, val_b], axis=1)
            return tk, packed

        # unjitted closures, reused by the resident-buffer pipeline
        # (predict_clips_resident jits one program per batch count)
        self._forward_scan_fn = _forward_scan
        self._packed_from_fw_fn = _packed_from_fw
        self._resident_cache: dict = {}

        self._forward_scan = jax.jit(_forward_scan, **jit_kw)
        self._forward_scan_group = jax.jit(_forward_scan_group) \
            if mesh is None else None
        self._forward_packed_all = jax.jit(_forward_packed_all, **jit_kw)
        self._forward_packed_all_group = \
            jax.jit(_forward_packed_all_group) if mesh is None else None
        self._forward_packed_topk = jax.jit(_forward_packed_topk,
                                            **jit_kw)
        self._forward_packed_topk_group = \
            jax.jit(_forward_packed_topk_group) if mesh is None else None
        self._gather_tracks = jax.jit(_gather_tracks)
        self._gather_packed, self._track_bytes = \
            self._make_packed_gather(t_frames)
        self._out_frames = t_frames

    def _make_packed_gather(self, t_frames: int):
        """Build a jitted packed gather for tracks of ``t_frames``.

        Threshold-compares and bit-packs the K gathered tracks on device,
        shipping 128 B/track instead of a 2 KB float track (numerically
        exact — the decoder only consumes the two crossing masks).  The
        pack matmul runs on the small (2K, T) gathered block.
        """
        tb = max(64, -(-(-(-t_frames // 8)) // 64) * 64)
        pack_w = np.zeros((tb * 8, tb), np.float32)
        for t_ in range(t_frames):
            pack_w[t_, t_ // 8] = float(1 << (7 - (t_ & 7)))
        pcls = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') \
            else dict(self.sed_params)
        high_dev = jnp.asarray(
            np.asarray(pcls['sed_high_threshold'], np.float32))
        low_dev = jnp.asarray(
            np.asarray(pcls['sed_low_threshold'], np.float32))
        # shared with the all-tracks packed forward (_forward_packed_all)
        self._pack_w = pack_w
        self._high_dev = high_dev
        self._low_dev = low_dev

        def _gather_packed(framewise, idx_n, idx_c):
            tracks = framewise[idx_n, :, idx_c]            # (K, T) f32
            hi = (tracks > jnp.take(high_dev, idx_c)[:, None])
            lo = (tracks >= jnp.take(low_dev, idx_c)[:, None])
            both = jnp.concatenate([hi, lo], axis=0).astype(jnp.float32)
            both = jnp.pad(both,
                           ((0, 0), (0, tb * 8 - tracks.shape[1])))
            packed = jnp.matmul(both, jnp.asarray(pack_w)
                                ).astype(jnp.uint8)        # (2K, TB)
            k = tracks.shape[0]
            return jnp.concatenate([packed[:k], packed[k:]], axis=1)

        return jax.jit(_gather_packed), tb

    def measure_forward_ms(self, iters: int = 8) -> float:
        """Device ms per batched forward, via in-jit chained iterations.

        Runs two jitted programs (1-iter and ``iters``-iter chains of
        the model forward with a data dependency between iterations),
        pulls a scalar from each, and differences the wall times so
        dispatch and transfer latency cancel.  Programs are
        persistent-cache-friendly (fixed shapes).
        """
        model = self.model
        variables = self.variables
        wav0 = jnp.zeros((self.batch_size, self.window_samples),
                         jnp.float32)

        def chained(w, k):
            def body(i, carry):
                out = model.apply(variables, carry, train=False)
                return w + out['clipwise_output'].mean() * 1e-6
            return jax.lax.fori_loop(0, k, body, w).sum()

        f1 = jax.jit(lambda w: chained(w, 1))
        fk = jax.jit(lambda w: chained(w, iters))
        dev = jax.device_put(wav0)
        times = []
        for fn, k in ((f1, 1), (fk, iters)):
            best = None
            for _ in range(2):
                t0 = time.time()
                float(np.asarray(fn(dev)))      # forces real completion
                dt = time.time() - t0
                best = dt if best is None else min(best, dt)
            times.append(best)
        return max(0.0, (times[1] - times[0]) / (iters - 1)) * 1e3

    def _clip_out_frames(self) -> int:
        """Framewise output length for one sample_duration window,
        derived from the model itself (no FLOPs spent)."""
        out = jax.eval_shape(
            lambda v, w: self.model.apply(v, w, train=False)
            ['framewise_output'],
            self.variables,
            jax.ShapeDtypeStruct((1, self.window_samples), jnp.float32))
        return out.shape[1]

    # ------------------------------------------------------------------
    # core batched forward
    # ------------------------------------------------------------------

    def infer_framewise(self, wavs: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """(N, window_samples) float32 -> (framewise (N, T, C), clipwise).

        Pads N up to a multiple of batch_size so the jit cache holds a
        single entry.
        """
        n = wavs.shape[0]
        bs = self.batch_size
        handles = []
        for i in range(0, n, bs):
            chunk = wavs[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:],
                                     chunk.dtype)], axis=0)
            # async dispatch: batch i+1's transfer/compute overlaps
            # batch i's pull
            handles.append(self._forward(self.variables,
                                         jnp.asarray(chunk)))
        frames = [np.asarray(f) for f, _ in handles]
        clips = [np.asarray(c) for _, c in handles]
        framewise = np.concatenate(frames, axis=0)[:n]
        clipwise = np.concatenate(clips, axis=0)[:n]
        return framewise, clipwise

    # ------------------------------------------------------------------
    # file / waveform prediction
    # ------------------------------------------------------------------

    def predict_waveform(self, audio: np.ndarray,
                         audio_name: str = 'audio',
                         duration: Optional[float] = None,
                         step: Optional[float] = None) -> List[dict]:
        """Full waveform (already at cfg.sample_rate) -> event list.

        ``duration`` may be passed separately (the reference schedules
        windows by the original file duration even after pad/truncate,
        ``main_strong.py:778-791``); ``step`` overrides the window hop.

        Reference quirk preserved: the overlap-add merge always places
        windows at ``overlap_value``-second offsets even when the window
        hop is ``sample_duration`` (``overlap=False``) — the reference
        calls ``merge(..., overlap_value)`` unconditionally
        (``predict.py:324-338``), so non-overlapped windows are merged
        as if they overlapped.  Exact-parity behavior; pass
        ``overlap=True`` (the reference's documented serving config) for
        sensible output on long files.
        """
        if duration is None:
            duration = len(audio) / float(self.cfg.sample_rate)
        starts = window_starts(duration, self.sample_duration, self.overlap,
                               step)
        sr = self.cfg.sample_rate
        windows = np.stack([
            audio_io.pad_truncate(
                audio[int(s * sr):int(s * sr) + self.window_samples],
                self.window_samples)
            for s in starts])
        framewise, _ = self.infer_framewise(windows)
        merged = post_merge.overlap_add_windows(
            framewise, self.sample_duration, self.overlap_value)
        return post_events.frame_prediction_to_event_prediction_v2(
            merged, audio_name, self.sed_params,
            self.cfg.frames_per_second, self.labels)

    def predict_waveforms(self, waveforms, names,
                          duration: Optional[float] = None,
                          step: Optional[float] = None) -> List[dict]:
        """Many full waveforms -> one event list, batching the windows of
        ALL files into shared fixed-shape forwards (the reference's
        per-clip serial loop, ``main_strong.py:769-835``, made one
        batched pass)."""
        sr = self.cfg.sample_rate
        all_windows = []
        spans = []      # (name, start_index, n_windows)
        for audio, name in zip(waveforms, names):
            dur = duration if duration is not None else \
                len(audio) / float(sr)
            starts = window_starts(dur, self.sample_duration,
                                   self.overlap, step)
            spans.append((name, len(all_windows), len(starts)))
            for s in starts:
                all_windows.append(audio_io.pad_truncate(
                    audio[int(s * sr):int(s * sr) + self.window_samples],
                    self.window_samples))
        framewise, _ = self.infer_framewise(
            audio_io.stack_rows(all_windows))
        events: List[dict] = []
        for name, i0, n_win in spans:
            merged = post_merge.overlap_add_windows(
                framewise[i0:i0 + n_win], self.sample_duration,
                self.overlap_value)
            events.extend(
                post_events.frame_prediction_to_event_prediction_v2(
                    merged, name, self.sed_params,
                    self.cfg.frames_per_second, self.labels))
        return events

    def _windowed_pipeline(self, clip_samples: int, duration: float,
                           step: float):
        """Device pipeline for uniform-length clips with overlapped
        windows: slice windows, forward, overlap-add merge
        (``utilities.py:405-446`` math), coverage-normalize and reduce —
        everything on device; cached per (clip_samples, duration, step)."""
        key = (clip_samples, float(duration), float(step))
        cache = getattr(self, '_windowed_cache', None)
        if cache is None:
            cache = self._windowed_cache = {}
        if key in cache:
            return cache[key]

        starts = window_starts(duration, self.sample_duration,
                               True, step)
        w_count = len(starts)
        sr = self.cfg.sample_rate
        offs = [int(s * sr) for s in starts]
        interval = int(100 * step)
        t_win = self._out_frames
        total = t_win + (w_count - 1) * interval
        coverage = post_merge.coverage_counts(total, self.sample_duration,
                                              step)
        model = self.model

        def fn(variables, wavs):                   # (Nc, clip wire width)
            wavs = self._prep(wavs, clip_samples)
            wins = jnp.stack(
                [jax.lax.slice_in_dim(wavs, o, o + self.window_samples,
                                      axis=1) for o in offs],
                axis=1)                            # (Nc, W, win_samples)
            nc = wins.shape[0]
            out = model.apply(variables,
                              wins.reshape(nc * w_count, -1),
                              train=False)['framewise_output']
            fw = out.reshape(nc, w_count, t_win, -1)
            merged = jnp.zeros((nc, total, fw.shape[-1]), fw.dtype)
            for w in range(w_count):     # static offsets: W scatter-adds
                merged = merged.at[:, w * interval:
                                   w * interval + t_win].add(fw[:, w])
            merged = merged / jnp.asarray(coverage,
                                          merged.dtype)[None, :, None]
            return merged, jnp.max(merged, axis=1)

        gather_fn, tb = self._make_packed_gather(total)
        entry = (jax.jit(fn), gather_fn, tb, total, w_count)
        cache[key] = entry
        return entry

    def predict_clips_windowed(self, wavs: np.ndarray, names: List[str],
                               duration: float, step: float,
                               clip_samples: Optional[int] = None
                               ) -> List[List[dict]]:
        """Uniform-length clips -> per-clip events with overlapped
        windows merged on device (the batched
        ``inference_prob_overlap`` path, ``main_strong.py:769-835``).
        ``clip_samples`` names the true sample count when ``wavs`` is a
        q4 wire buffer (whose width is narrower)."""
        from sed_jax.native.vad_native import (native_available,
                                               decode_packed_tracks)
        n, width = wavs.shape
        if clip_samples is None:
            clip_samples = width
        # bound live device buffers like predict_clips: chunk big inputs
        limit = self.dispatch_ahead_batches * self.batch_size
        if n > limit:
            out: List[List[dict]] = []
            for i in range(0, n, limit):
                out.extend(self.predict_clips_windowed(
                    wavs[i:i + limit], names[i:i + limit], duration,
                    step, clip_samples))
            return out
        fn, gather_fn, tb, total, w_count = self._windowed_pipeline(
            clip_samples, duration, step)
        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') \
            else dict(self.sed_params)
        high = np.asarray(p['sed_high_threshold'], np.float64)
        n_smooth_arr = np.asarray(p['n_smooth'], np.int32)
        n_salt_arr = np.asarray(p['n_salt'], np.int32)
        fps = float(self.cfg.frames_per_second)
        use_native = native_available()

        nc = max(1, self.batch_size // w_count)
        handles = []
        for i0 in range(0, n, nc):
            chunk = wavs[i0:i0 + nc]
            pad = nc - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:],
                                     chunk.dtype)])
            merged_dev, tm_dev = fn(self.variables, jnp.asarray(chunk))
            handles.append((i0, nc - pad, merged_dev, tm_dev))

        per_clip: List[List[dict]] = [[] for _ in range(n)]
        G = self._gather_chunk
        gathers = []
        tm_all = np.asarray(jnp.concatenate([h[3] for h in handles]))
        for bi, (i0, valid, merged_dev, _tm) in enumerate(handles):
            track_max = tm_all[bi * nc:bi * nc + valid]
            act_n, act_c = np.nonzero(track_max > high[None, :])
            for j0 in range(0, act_n.size, G):
                sub_n = act_n[j0:j0 + G]
                sub_c = act_c[j0:j0 + G]
                idx_n = np.zeros(G, np.int32)
                idx_c = np.zeros(G, np.int32)
                idx_n[:sub_n.size] = sub_n
                idx_c[:sub_n.size] = sub_c
                gathers.append((i0, sub_n, sub_c,
                                gather_fn(merged_dev, jnp.asarray(idx_n),
                                          jnp.asarray(idx_c))))
        if gathers:
            flat = np.asarray(jnp.concatenate([g[3] for g in gathers]))
            gathers = [(i0, sn, sc, flat[k * G:(k + 1) * G])
                       for k, (i0, sn, sc, _d) in enumerate(gathers)]
        for i0, act_n, act_c, packed in gathers:
            packed = packed[:act_n.size]
            if use_native:
                all_pairs = decode_packed_tracks(
                    np.ascontiguousarray(packed[:, :tb]),
                    np.ascontiguousarray(packed[:, tb:]), total,
                    n_smooth_arr[act_c], n_salt_arr[act_c])
            else:
                hi = np.unpackbits(packed[:, :tb],
                                   axis=1)[:, :total].astype(bool)
                lo = np.unpackbits(packed[:, tb:],
                                   axis=1)[:, :total].astype(bool)
                all_pairs = [
                    vad.activity_detection_masks(
                        hi[j], lo[j],
                        n_smooth=p['n_smooth'][int(act_c[j])],
                        n_salt=p['n_salt'][int(act_c[j])])
                    for j in range(act_n.size)
                ]
            for j, pairs in enumerate(all_pairs):
                c = int(act_c[j])
                clip_i = i0 + int(act_n[j])
                for bgn, fin in pairs:
                    per_clip[clip_i].append({
                        'filename': names[clip_i],
                        'onset': bgn / fps,
                        'offset': fin / fps,
                        'event_label': self.labels[c]})
        return per_clip

    def predict_file(self, path: str) -> Tuple[List[dict], str]:
        """Audio file -> (event list sorted by onset, XML string).

        Reference quirk preserved: the fallback "Others" span uses the
        post-loop window ``start``, so files shorter than one hop past
        the first window emit ``stime > duration`` with negative ``dur``
        exactly like ``predict.py:352-399`` does."""
        audio, _ = audio_io.load_audio(path, sr=self.cfg.sample_rate)
        duration = len(audio) / float(self.cfg.sample_rate)
        name = os.path.basename(path)
        events = sorted(self.predict_waveform(audio, name),
                        key=lambda e: e['onset'])
        starts = window_starts(duration, self.sample_duration, self.overlap)
        # the reference's fallback span: [last start, min(duration, end)]
        last_start = starts[-1] + (1 if self.overlap
                                   else self.sample_duration)
        end = min(duration, last_start + self.sample_duration)
        xml = xml_writer.events_to_xml(events, name,
                                       fallback_span=(last_start, end))
        return events, xml

    # ------------------------------------------------------------------
    # bulk clip API (the 1000 clips/s path)
    # ------------------------------------------------------------------

    @property
    def _gather_chunk(self) -> int:
        """Fixed gather size: exactly one compiled gather program and one
        device->host transfer shape, no matter the event density."""
        return max(64, self.batch_size)

    def warmup(self, example: Optional[np.ndarray] = None) -> None:
        """Compile the exact programs the configured stream path uses
        (forward variant for this pull_format, grouped variant when
        launch_group > 1) so the first timed/served batch does not pay
        for compilation.  Pass an ``example`` batch in the
        wire format you will serve (dtype/width select the device decode
        program); defaults to float32 PCM.
        """
        z = example if example is not None else np.zeros(
            (self.batch_size, self.window_samples), np.float32)
        assert z.shape[0] == self.batch_size, (z.shape, self.batch_size)
        dev = jnp.asarray(z)
        if self.pull_format == 'topk':
            fns = [self._forward_packed_topk,
                   self._forward_packed_topk_group]
        elif self.pull_format == 'full':
            fns = [self._forward_packed_all,
                   self._forward_packed_all_group]
        else:
            fns = [self._forward_scan, self._forward_scan_group]
        jax.block_until_ready(fns[0](self.variables, dev))
        if self.launch_group > 1 and fns[1] is not None:
            g = jnp.asarray(np.stack([z] * self.launch_group))
            jax.block_until_ready(fns[1](self.variables, g))

    def _decode_tracks_into(self, per_clip: List[List[dict]],
                            names: Optional[List[str]], p: dict,
                            tracks: np.ndarray, act_n: np.ndarray,
                            act_c: np.ndarray, i0: int) -> None:
        """Decode gathered probability tracks into per-clip event dicts.

        Shared by ``predict_clips`` and ``predict_clips_stream``:
        ``tracks`` holds one row per active (clip, class) pair — packed
        threshold-crossing bitmasks when ``gather_format='packed'``,
        float probabilities otherwise; ``act_n``/``act_c`` index the pair
        within the batch starting at global clip ``i0``.
        """
        from sed_jax.native.vad_native import (native_available,
                                               decode_packed_tracks)
        t_frames = self._out_frames
        tb = self._track_bytes
        fps = float(self.cfg.frames_per_second)
        if self.gather_format == 'packed':
            high_packed = np.ascontiguousarray(tracks[:, :tb])
            low_packed = np.ascontiguousarray(tracks[:, tb:])
        else:                                              # float tracks
            high_arr = np.asarray(p['sed_high_threshold'], np.float64)
            low_arr = np.asarray(p['sed_low_threshold'], np.float64)
            high_packed = np.packbits(
                tracks > high_arr[act_c][:, None], axis=1)
            low_packed = np.packbits(
                tracks >= low_arr[act_c][:, None], axis=1)
        if native_available():
            all_pairs = decode_packed_tracks(
                high_packed, low_packed, t_frames,
                np.asarray(p['n_smooth'], np.int32)[act_c],
                np.asarray(p['n_salt'], np.int32)[act_c])
        else:
            high_bits = np.unpackbits(
                high_packed, axis=1)[:, :t_frames].astype(bool)
            low_bits = np.unpackbits(
                low_packed, axis=1)[:, :t_frames].astype(bool)
            all_pairs = [
                vad.activity_detection_masks(
                    high_bits[j], low_bits[j],
                    n_smooth=p['n_smooth'][int(act_c[j])],
                    n_salt=p['n_salt'][int(act_c[j])])
                for j in range(act_n.size)
            ]
        for j, pairs in enumerate(all_pairs):
            c = int(act_c[j])
            clip_i = i0 + int(act_n[j])
            name = (names[clip_i] if names is not None
                    else f'clip{clip_i}.wav')
            for bgn, fin in pairs:
                per_clip[clip_i].append({
                    'filename': name,
                    'onset': bgn / fps,
                    'offset': fin / fps,
                    'event_label': self.labels[c]})

    def _decode_topk_into(self, per_clip: List[List[dict]],
                          names: Optional[List[str]], p: dict,
                          buf: np.ndarray, all_dev, i0: int,
                          valid: int) -> None:
        """Decode a pulled top-k buffer (rows ``[packed 2tb | idx i32 |
        margin f32]``) into per-clip events; pulls the on-device
        all-tracks fallback only when capacity saturated."""
        tb = self._track_bytes
        tb2 = 2 * tb
        idx = np.ascontiguousarray(
            buf[:, tb2:tb2 + 4]).view(np.int32).ravel()
        vals = np.ascontiguousarray(
            buf[:, tb2 + 4:tb2 + 8]).view(np.float32).ravel()
        nC = len(self.labels)
        act = vals > 0.0
        # saturation must be judged against the LAUNCH's total track
        # count (pads included): zero-pad clips' tracks compete in
        # lax.top_k, so a final short chunk with k >= valid*nC can still
        # have real active tracks displaced by pad tracks when k < B*nC
        n_launched = all_dev.shape[0]
        if act.all() and buf.shape[0] < n_launched * nC:
            # capacity saturated — decode everything from the on-device
            # all-tracks fallback buffer
            fb = np.asarray(all_dev)[:valid]
            act_n, act_c = np.nonzero(fb[:, :, :tb].any(axis=2))
            self._decode_tracks_into(per_clip, names, p, fb[act_n, act_c],
                                     act_n, act_c, i0)
        else:
            sel = np.nonzero(act & (idx < valid * nC))[0]
            # row-major track order, like the other paths
            sel = sel[np.argsort(idx[sel], kind='stable')]
            self._decode_tracks_into(per_clip, names, p, buf[sel, :tb2],
                                     idx[sel] // nC, idx[sel] % nC, i0)

    # ------------------------------------------------------------------
    # resident-buffer path: fewest host<->device round trips per pass
    # ------------------------------------------------------------------

    def _resident_pipeline(self, n_batches: int, wire_width: int,
                           dtype, chunk_rows: Tuple[int, ...]):
        """One jitted program per (batch count, wire, upload split):
        concatenate the uploaded chunks, reshape into forward batches,
        lax.map the packed forward over ALL of them — a single device
        launch for the whole pass."""
        key = (n_batches, wire_width, np.dtype(dtype).str, chunk_rows,
               self.pull_format == 'topk')
        if key in self._resident_cache:
            return self._resident_cache[key]
        bs = self.batch_size
        topk = self.pull_format == 'topk'
        forward = self._forward_scan_fn
        packed_from_fw = self._packed_from_fw_fn
        mesh = self.mesh

        def fn(variables, chunks):
            buf = (jnp.concatenate(chunks, axis=0)
                   if len(chunks) > 1 else chunks[0])
            wavs = buf.reshape(n_batches, bs, wire_width)
            if mesh is not None:
                # mesh-sharded resident serving (SURVEY §2.12: the data
                # mesh replaces torch.nn.DataParallel for the paths
                # people actually run): every lax.map step's batch is
                # split over the 'data' axis, so the whole resident
                # pass runs data-parallel across the mesh — XLA inserts
                # the one reshard here and the top-k gather below
                from jax.sharding import PartitionSpec as P
                wavs = jax.lax.with_sharding_constraint(
                    wavs, jax.sharding.NamedSharding(
                        mesh, P(None, 'data', None)))

            def one(w):
                fw, tm = forward(variables, w)
                return packed_from_fw(fw), tm

            packed, tm = jax.lax.map(one, wavs)
            packed = packed.reshape((-1,) + packed.shape[2:])
            if not topk:
                return packed
            tm = tm.reshape((-1, tm.shape[-1]))
            margin = (tm - self._high_dev[None, :]).reshape(-1)
            k = min(self._topk_capacity_resident(n_batches * bs),
                    margin.shape[0])
            vals, idx = jax.lax.top_k(margin, k)
            rows = packed.reshape((-1, packed.shape[-1]))[idx]
            idx_b = jax.lax.bitcast_convert_type(
                idx.astype(jnp.int32), jnp.uint8)
            val_b = jax.lax.bitcast_convert_type(
                vals.astype(jnp.float32), jnp.uint8)
            tk = jnp.concatenate([rows, idx_b, val_b], axis=1)
            return tk, packed

        entry = jax.jit(fn)
        self._resident_cache[key] = entry
        return entry

    def _topk_capacity_resident(self, n_clips: int) -> int:
        """Top-k capacity for a resident pass: 2 active tracks per clip
        covers the bench distribution ~3x over (same policy as the
        per-batch stream capacity)."""
        return 2 * n_clips

    def _chunk_batches(self, n_batches: int, m: int) -> List[int]:
        """Split ``n_batches`` forward batches into ``m`` contiguous
        launch chunks, as equal as possible (equal chunks share ONE
        compiled program; at most two programs exist per pass shape)."""
        m = max(1, min(int(m), n_batches))
        base, extra = divmod(n_batches, m)
        return [base + (1 if i < extra else 0) for i in range(m)]

    def _upload_sizes(self, rows: int, n_clips: int,
                      upload_threads: int) -> Tuple[int, ...]:
        """Split ``rows`` padded rows into near-equal upload chunks.
        On a mesh every chunk is a multiple of the device count so the
        row-sharded ``device_put`` divides evenly."""
        unit = self.mesh.devices.size if self.mesh is not None else 1
        g = rows // unit
        k = max(1, min(int(upload_threads), n_clips, g))
        base, extra = divmod(g, k)
        return tuple((base + (1 if i < extra else 0)) * unit
                     for i in range(k))

    def _put_rows(self, x):
        """``device_put`` a rows-leading host buffer — sharded over the
        'data' axis in mesh mode, plain single-device otherwise."""
        if self.mesh is not None:
            return jax.device_put(x, self._sharded)
        return jax.device_put(x)

    def warmup_resident(self, n_clips: int, width: int, dtype,
                        upload_threads: int = 2,
                        launch_chunks: int = 1) -> None:
        """Compile + execute the resident program for this pass shape
        WITHOUT uploading a corpus.

        The input chunks are created ON DEVICE (``jnp.zeros``), so
        warming costs one compile (persistent-cached across processes),
        one launch, and one small pull — instead of the full
        ``bytes_h2d`` upload a real warm pass would ship.  Must use the same
        ``n_clips``/``width``/``dtype``/``upload_threads`` as the timed
        pass (the program cache is keyed on them).
        """
        bs = self.batch_size
        n_batches = -(-n_clips // bs)
        if launch_chunks > 1:
            # the chunked path runs one single-chunk program per launch
            # chunk — warm each DISTINCT chunk shape (at most two)
            for nb in sorted(set(self._chunk_batches(n_batches,
                                                     launch_chunks))):
                fn = self._resident_pipeline(nb, width, np.dtype(dtype),
                                             (nb * bs,))
                out = fn(self.variables,
                         (jnp.zeros((nb * bs, width), np.dtype(dtype)),))
                np.asarray(out[0] if isinstance(out, tuple) else out)
            return
        rows = n_batches * bs
        sizes = self._upload_sizes(rows, n_clips, upload_threads)
        fn = self._resident_pipeline(n_batches, width, np.dtype(dtype),
                                     sizes)
        chunks = tuple(self._put_rows(np.zeros((s, width),
                                               np.dtype(dtype)))
                       for s in sizes)
        out = fn(self.variables, chunks)
        # warm the d2h pull path too (packed masks / topk buffer)
        np.asarray(out[0] if isinstance(out, tuple) else out)

    def predict_clips_resident(self, wavs: np.ndarray,
                               names: Optional[List[str]] = None,
                               upload_threads: int = 2,
                               telemetry: Optional[dict] = None,
                               launch_chunks: int = 1
                               ) -> Tuple[List[List[dict]], List[str]]:
        """N fixed-length clips -> per-clip (events, XML) in the minimum
        number of host<->device round trips.

        The streaming path pays ~8 transfers and launches per 2048-clip
        pass (4 uploads + 2 grouped launches + 2 pulls).  This path
        collapses that to ~``upload_threads`` + 2:

          1. the WHOLE wire buffer is put on device once, split into
             ``upload_threads`` concurrent ``jax.device_put`` calls
             (PJRT releases the GIL during the transfer, so the chunks
             overlap);
          2. ONE jitted launch lax.maps the packed forward over every
             batch of the resident buffer;
          3. ONE fixed-shape pull brings back the packed crossing masks
             (all tracks, or the top-k subset with an on-device
             all-tracks fallback when ``pull_format='topk'``).

        Results are identical to ``predict_clips`` (tests/test_serve.py).
        ``telemetry``, when given a dict, is filled with phase wall times
        and transfer byte counts (upload_s/launch_s/pull_s/decode_s,
        bytes_h2d/bytes_d2h, rpcs).  Single-device only (the mesh path
        shards per batch; use ``predict_clips`` there).

        ``launch_chunks=m > 1`` splits the pass into ``m`` contiguous
        launch chunks, each its own upload + single-chunk program +
        pull, dispatched concurrently: chunk i's device compute (and
        host decode) overlaps chunk i+1's transfer.  Dispatches are
        async, so the extra launches add no blocking round trips; the
        most it can save is ~min(upload, compute) of wall time.  Equal
        chunks share one compiled program (at most two
        programs per pass shape).  Exact — same events as m=1.
        """
        if self.mesh is not None and launch_chunks > 1:
            launch_chunks = 1      # chunked launches are single-device
            # only; the mesh path uses one launch
        if launch_chunks > 1:
            return self._predict_clips_resident_chunked(
                wavs, names, launch_chunks, telemetry)
        n, width = wavs.shape
        if names is None:
            names = [f'clip{i}.wav' for i in range(n)]
        bs = self.batch_size
        n_batches = -(-n // bs)
        rows = n_batches * bs
        if rows > n:
            wavs = np.concatenate(
                [wavs, np.zeros((rows - n, width), wavs.dtype)], axis=0)
        # clamp by the UNPADDED clip count — the same convention as
        # predict_files_resident and warmup_resident, so identical
        # (n, width, dtype, threads) always hits one cached program
        sizes = self._upload_sizes(rows, n, upload_threads)
        k = len(sizes)
        fn = self._resident_pipeline(n_batches, width, wavs.dtype, sizes)

        t0 = time.time()
        chunks: List[Optional[jax.Array]] = [None] * k
        bounds = np.cumsum((0,) + sizes)

        def _upload(i):
            chunks[i] = self._put_rows(wavs[bounds[i]:bounds[i + 1]])

        if k == 1:
            _upload(0)
        else:
            ths = [threading.Thread(target=_upload, args=(i,))
                   for i in range(k)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
        t1 = time.time()

        topk = self.pull_format == 'topk'
        out = fn(self.variables, tuple(chunks))
        target = out[0] if topk else out
        try:
            target.copy_to_host_async()
        except Exception:
            pass
        t2 = time.time()

        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        per_clip: List[List[dict]] = [[] for _ in range(n)]
        buf = np.asarray(target)
        pulled_bytes = buf.nbytes
        t3 = time.time()
        if topk:
            self._decode_topk_into(per_clip, names, p, buf, out[1], 0, n)
        else:
            tb = self._track_bytes
            buf = buf[:n]
            act_n, act_c = np.nonzero(buf[:, :, :tb].any(axis=2))
            self._decode_tracks_into(per_clip, names, p, buf[act_n, act_c],
                                     act_n, act_c, 0)
        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        t4 = time.time()
        if telemetry is not None:
            telemetry.update(
                upload_s=round(t1 - t0, 4),
                launch_s=round(t2 - t1, 4),
                pull_s=round(t3 - t2, 4),
                decode_s=round(t4 - t3, 4),
                bytes_h2d=int(rows) * int(width) * wavs.dtype.itemsize,
                bytes_d2h=int(pulled_bytes),
                rpcs=k + 2, n_batches=n_batches)
        return per_clip, xmls

    def _predict_clips_resident_chunked(self, wavs: np.ndarray,
                                        names: Optional[List[str]],
                                        m: int,
                                        telemetry: Optional[dict]
                                        ) -> Tuple[List[List[dict]],
                                                   List[str]]:
        """Chunked-launch resident pass (see ``predict_clips_resident``
        ``launch_chunks``): one upload + one single-chunk program + one
        async pull per chunk, all dispatched from concurrent threads so
        transfers, device compute, and host decode pipeline against
        each other."""
        n, width = wavs.shape
        bs = self.batch_size
        n_batches = -(-n // bs)
        rows = n_batches * bs
        if rows > n:
            wavs = np.concatenate(
                [wavs, np.zeros((rows - n, width), wavs.dtype)], axis=0)

        def seg(lo, hi):
            return wavs[lo:hi]

        return self._resident_chunked_core(seg, n, width, wavs.dtype,
                                           names, m, telemetry)

    def _resident_chunked_core(self, get_rows, n: int, width: int,
                               dtype, names: Optional[List[str]],
                               m: int, telemetry: Optional[dict]
                               ) -> Tuple[List[List[dict]], List[str]]:
        """Shared chunked-launch resident engine: ``get_rows(lo, hi)``
        returns the host wire buffer for padded rows ``[lo, hi)`` (rows
        ``>= n`` are zero pads).  Each chunk thread builds its buffer,
        uploads it, dispatches its single-chunk program, and starts the
        async pull; the main thread then materializes and decodes the
        chunks in order, so transfer / compute / host decode pipeline.
        Telemetry phases: ``upload_s`` is dispatch wall (everything is
        async), ``pull_s`` spans transfer+compute+pull+decode
        interleaved per chunk, ``decode_s`` is XML assembly."""
        if names is None:
            names = [f'clip{i}.wav' for i in range(n)]
        bs = self.batch_size
        n_batches = -(-n // bs)
        nbs = self._chunk_batches(n_batches, m)
        m = len(nbs)
        starts = np.cumsum([0] + [nb * bs for nb in nbs])
        # build (don't yet compile) the per-chunk programs on the main
        # thread so the cache dict isn't mutated concurrently
        fns = {nb: self._resident_pipeline(nb, width, np.dtype(dtype),
                                           (nb * bs,))
               for nb in set(nbs)}
        topk = self.pull_format == 'topk'
        outs: List[Optional[tuple]] = [None] * m
        errs: List[BaseException] = []

        t0 = time.time()

        def _run(i):
            try:
                buf = get_rows(int(starts[i]), int(starts[i + 1]))
                out = fns[nbs[i]](self.variables, (jax.device_put(buf),))
                tgt = out[0] if topk else out
                try:
                    tgt.copy_to_host_async()
                except Exception:
                    pass
                outs[i] = out
            except BaseException as e:
                errs.append(e)

        if m == 1:
            _run(0)
        else:
            ths = [threading.Thread(target=_run, args=(i,))
                   for i in range(m)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
        if errs:
            raise errs[0]
        t1 = time.time()

        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        per_clip: List[List[dict]] = [[] for _ in range(n)]
        pulled_bytes = 0
        tb = self._track_bytes
        for i in range(m):
            out = outs[i]
            tgt = out[0] if topk else out
            buf = np.asarray(tgt)
            pulled_bytes += buf.nbytes
            i0 = int(starts[i])
            valid = min(n - i0, nbs[i] * bs)
            if topk:
                self._decode_topk_into(per_clip, names, p, buf, out[1],
                                       i0, valid)
            else:
                b = buf[:valid]
                act_n, act_c = np.nonzero(b[:, :, :tb].any(axis=2))
                self._decode_tracks_into(per_clip, names, p,
                                         b[act_n, act_c], act_n, act_c,
                                         i0)
        t2 = time.time()
        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        t3 = time.time()
        if telemetry is not None:
            telemetry.update(
                upload_s=round(t1 - t0, 4), launch_s=0.0,
                pull_s=round(t2 - t1, 4), decode_s=round(t3 - t2, 4),
                bytes_h2d=(int(n_batches) * bs * int(width)
                           * np.dtype(dtype).itemsize),
                bytes_d2h=int(pulled_bytes),
                rpcs=3 * m, n_batches=n_batches, launch_chunks=m)
        return per_clip, xmls

    @staticmethod
    def _materialize_with_deadline(dev, deadline: float, budget_s: float,
                                   telemetry: Optional[dict],
                                   t0: float) -> np.ndarray:
        """``np.asarray(dev)`` bounded by an absolute ``deadline``: the
        pull runs in a daemon thread; missing the deadline raises
        ``LinkCollapseError`` (the orphaned pull drains in background,
        its buffer released when the thread finishes)."""
        out: list = []
        err: list = []

        def pull():
            try:
                out.append(np.asarray(dev))
            except BaseException as e:
                err.append(e)

        th = threading.Thread(target=pull, daemon=True)
        th.start()
        th.join(max(0.0, deadline - time.time()))
        if err:
            raise err[0]
        if not out:
            if telemetry is not None:
                telemetry.update(aborted=1,
                                 upload_s=round(time.time() - t0, 4))
            raise LinkCollapseError(
                f'result pull missed the {budget_s:.1f}s pass deadline '
                f'— pass abandoned')
        return out[0]

    def predict_files_resident(self, paths: Sequence[str], reader,
                               names: Optional[List[str]] = None,
                               upload_threads: int = 4,
                               telemetry: Optional[dict] = None,
                               max_pass_clips: Optional[int] = None,
                               launch_chunks: int = 1,
                               upload_deadline_s: Optional[float] = None
                               ) -> Tuple[List[List[dict]], List[str]]:
        """File-list variant of ``predict_clips_resident`` that PIPELINES
        file decode with the uploads: each upload thread reads its slice
        of files into a host buffer and ``device_put``s it, so chunk
        i+1's (CPU-bound) file decode overlaps chunk i's transfer
        instead of serializing ahead of it.

        ``reader(path)`` returns the 1-D wire array of one clip (any
        format ``predict_clips`` accepts); all files must decode to the
        same width/dtype.  Results identical to reading everything first
        and calling ``predict_clips_resident``.

        ``max_pass_clips`` bounds device memory for corpora larger than
        it: the file list is served in resident passes of at most that
        many clips (full-size passes reuse ONE compiled program; only a
        smaller final remainder compiles a second).  Results are
        identical to a single pass; telemetry accumulates across passes.

        ``launch_chunks=m > 1`` (see ``predict_clips_resident``): each
        chunk thread reads its files, uploads, and dispatches its own
        single-chunk program — file decode, transfer, device compute,
        and host event decode all pipeline.  Exact — same events.

        ``upload_deadline_s``: abandon the pass with
        ``LinkCollapseError`` if it has not reached the decode stage
        within this many seconds.  The budget spans upload dispatch
        THROUGH the result pull, because ``device_put`` may return
        before the bytes are on the device (the wait then surfaces in
        the blocking pull).  In-flight transfers and the orphaned pull
        drain in daemon threads; the engine stays usable and a retry
        re-reads from the files.
        """
        assert len(paths) > 0, 'predict_files_resident: empty file list'
        if self.mesh is not None and launch_chunks > 1:
            launch_chunks = 1      # see predict_clips_resident
        n = len(paths)
        if names is None:
            names = [os.path.basename(p) for p in paths]
        if max_pass_clips is not None and n > int(max_pass_clips):
            step = int(max_pass_clips)
            if step < 1:
                raise ValueError(
                    f'max_pass_clips must be >= 1, got {step}')
            all_events: List[List[dict]] = []
            all_xmls: List[str] = []
            acc: dict = {}
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                tel = {} if telemetry is not None else None
                ev, xs = self.predict_files_resident(
                    paths[lo:hi], reader, names=names[lo:hi],
                    upload_threads=upload_threads, telemetry=tel,
                    launch_chunks=launch_chunks,
                    upload_deadline_s=upload_deadline_s)
                all_events.extend(ev)
                all_xmls.extend(xs)
                if tel is not None:
                    for k, v in tel.items():
                        acc[k] = acc.get(k, 0) + v
            if telemetry is not None:
                acc['passes'] = -(-n // step)
                telemetry.update(acc)
            return all_events, all_xmls
        first = reader(paths[0])
        width = first.shape[0]
        bs = self.batch_size
        if launch_chunks > 1:
            def get_rows(lo, hi):
                buf = np.zeros((hi - lo, width), first.dtype)
                for j in range(lo, min(hi, n)):
                    buf[j - lo] = first if j == 0 else reader(paths[j])
                return buf

            out = self._resident_chunked_core(
                get_rows, n, width, first.dtype, names, launch_chunks,
                telemetry)
            if telemetry is not None:
                telemetry.setdefault('read_s', 0.0)   # reads pipelined
            return out
        n_batches = -(-n // bs)
        rows = n_batches * bs
        sizes = self._upload_sizes(rows, n, upload_threads)
        k = len(sizes)
        fn = self._resident_pipeline(n_batches, width, first.dtype, sizes)
        bounds = np.cumsum((0,) + sizes)

        t0 = time.time()
        chunks: List[Optional[jax.Array]] = [None] * k
        errs: List[BaseException] = []

        def _read_upload(i):
            try:
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                buf = np.zeros((hi - lo, width), first.dtype)
                if i == 0:
                    buf[0] = first
                    start = 1
                else:
                    start = 0
                for j in range(start, hi - lo):
                    if lo + j < n:
                        buf[j] = reader(paths[lo + j])
                chunks[i] = self._put_rows(buf)
            except BaseException as e:
                errs.append(e)

        deadline = (t0 + upload_deadline_s
                    if upload_deadline_s is not None else None)
        if k == 1 and deadline is None:
            _read_upload(0)
        else:
            ths = [threading.Thread(target=_read_upload, args=(i,),
                                    daemon=True)
                   for i in range(k)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=None if deadline is None
                       else max(0.0, deadline - time.time()))
            stuck = [t for t in ths if t.is_alive()]
            if stuck:
                # deadline missed: abandon the pass now; the in-flight
                # device_puts drain in the daemon threads
                if telemetry is not None:
                    telemetry.update(aborted=1, upload_s=round(
                        time.time() - t0, 4))
                raise LinkCollapseError(
                    f'{len(stuck)}/{k} upload threads missed the '
                    f'{upload_deadline_s:.1f}s pass deadline — pass '
                    f'abandoned')
        if errs:
            raise errs[0]
        t1 = time.time()

        topk = self.pull_format == 'topk'
        out = fn(self.variables, tuple(chunks))
        target = out[0] if topk else out
        try:
            target.copy_to_host_async()
        except Exception:
            pass
        t2 = time.time()

        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        per_clip: List[List[dict]] = [[] for _ in range(n)]
        # the pull blocks until transfer+compute+d2h all complete;
        # device_put can return early, so the SAME pass deadline must
        # also bound the pull
        if deadline is None:
            buf = np.asarray(target)
        else:
            buf = self._materialize_with_deadline(
                target, deadline, upload_deadline_s, telemetry, t0)
        pulled_bytes = buf.nbytes
        t3 = time.time()
        if topk:
            self._decode_topk_into(per_clip, names, p, buf, out[1], 0, n)
        else:
            tb = self._track_bytes
            buf = buf[:n]
            act_n, act_c = np.nonzero(buf[:, :, :tb].any(axis=2))
            self._decode_tracks_into(per_clip, names, p, buf[act_n, act_c],
                                     act_n, act_c, 0)
        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        t4 = time.time()
        if telemetry is not None:
            telemetry.update(
                upload_s=round(t1 - t0, 4),   # includes pipelined reads
                launch_s=round(t2 - t1, 4),
                pull_s=round(t3 - t2, 4),
                decode_s=round(t4 - t3, 4),
                read_s=0.0,                   # overlapped into upload_s
                bytes_h2d=int(rows) * int(width) * first.dtype.itemsize,
                bytes_d2h=int(pulled_bytes),
                rpcs=k + 2, n_batches=n_batches)
        return per_clip, xmls

    # ------------------------------------------------------------------
    # ragged resident path: variable-rate wires (v6)
    # ------------------------------------------------------------------
    #
    # The v6 wire (audio_io.v6_encode_clip) is LOSSLESS vs the q6
    # container but variable-rate — clips have different byte lengths,
    # so the fixed-width (N, W) resident buffer would have to pad every
    # clip to the corpus maximum, forfeiting the compression of the
    # host->device transfer.  Instead the pass ships ONE
    # flat byte pool holding exactly the true payloads plus a (rows,)
    # int32 offset vector; the fixed-shape gather to the worst-case
    # width happens ON DEVICE (ops/wire.dequant_v6_pool), off the wire.
    # Everything downstream (packed forward, top-k pull, host decode)
    # is shared with the fixed-width resident path.

    _RAGGED_POOL_BUCKET = 1 << 20    # words (4 MiB): jit programs are
    # keyed on the padded pool size, so distinct corpora of similar
    # size share one compiled program; the padding is device-side zeros
    # (jnp.zeros), never uploaded
    _RAGGED_TAIL_WORDS = 2048        # zero tail: pad-clip offsets point
    # here (decodes to silence) and bound the header/data gather overrun

    def _ragged_plan(self, payload_bytes: Sequence[int], n_threads: int):
        """Plan a ragged pass: per-row word offsets (pad rows -> zero
        tail), thread chunks balanced by BYTES (upload time is
        byte-bound, not row-bound), and the padded static pool size."""
        bs = self.batch_size
        n = len(payload_bytes)
        n_batches = -(-n // bs)
        rows = n_batches * bs
        pb = np.asarray(payload_bytes, np.int64)
        assert (pb % 16 == 0).all(), 'v6 payloads are 16-byte padded'
        bounds_b = np.concatenate([[0], np.cumsum(pb)])
        total_words = int(bounds_b[-1]) // 4
        offsets = np.empty(rows, np.int32)
        offsets[:n] = bounds_b[:-1] // 4
        offsets[n:] = total_words                # zero-tail -> silence
        k = max(1, min(int(n_threads), n))
        # byte-balanced chunk boundaries (row-aligned)
        cuts = [int(np.searchsorted(bounds_b, bounds_b[-1] * i / k))
                for i in range(k + 1)]
        cuts[0], cuts[-1] = 0, n
        cuts = sorted(set(cuts))
        chunk_rows = list(zip(cuts[:-1], cuts[1:]))
        chunk_words = tuple(int(bounds_b[hi] - bounds_b[lo]) // 4
                            for lo, hi in chunk_rows)
        need = total_words + self._RAGGED_TAIL_WORDS
        bkt = self._RAGGED_POOL_BUCKET
        pool_words = -(-need // bkt) * bkt
        return (n_batches, rows, offsets, chunk_rows, chunk_words,
                total_words, pool_words)

    def _resident_pipeline_ragged(self, n_batches: int, pool_words: int,
                                  chunk_words: Tuple[int, ...]):
        """One jitted program per (batch count, padded pool size, upload
        split): concatenate the uploaded pool chunks + device-side zero
        padding, then lax.map the v6 decode + packed forward over every
        batch of offsets — a single device launch for the whole pass."""
        key = ('ragged', n_batches, pool_words, chunk_words,
               self.pull_format == 'topk')
        if key in self._resident_cache:
            return self._resident_cache[key]
        bs = self.batch_size
        topk = self.pull_format == 'topk'
        forward = self._forward_scan_fn
        packed_from_fw = self._packed_from_fw_fn
        samples = self.window_samples
        pad_words = pool_words - sum(chunk_words)
        assert pad_words >= self._RAGGED_TAIL_WORDS

        def fn(variables, chunks, offsets):
            parts = list(chunks) + [jnp.zeros(pad_words, jnp.int32)]
            pool = jnp.concatenate(parts)
            offs = offsets.reshape(n_batches, bs)

            def one(off):
                x = wire_ops.dequant_v6_pool(pool, off, samples)
                fw, tm = forward(variables, x)
                return packed_from_fw(fw), tm

            packed, tm = jax.lax.map(one, offs)
            packed = packed.reshape((-1,) + packed.shape[2:])
            if not topk:
                return packed
            tm = tm.reshape((-1, tm.shape[-1]))
            margin = (tm - self._high_dev[None, :]).reshape(-1)
            k = min(self._topk_capacity_resident(n_batches * bs),
                    margin.shape[0])
            vals, idx = jax.lax.top_k(margin, k)
            rows = packed.reshape((-1, packed.shape[-1]))[idx]
            idx_b = jax.lax.bitcast_convert_type(
                idx.astype(jnp.int32), jnp.uint8)
            val_b = jax.lax.bitcast_convert_type(
                vals.astype(jnp.float32), jnp.uint8)
            tk = jnp.concatenate([rows, idx_b, val_b], axis=1)
            return tk, packed

        entry = jax.jit(fn)
        self._resident_cache[key] = entry
        return entry

    def warmup_resident_ragged(self, payload_bytes: Sequence[int],
                               upload_threads: int = 2) -> None:
        """Compile + execute the ragged resident program for this
        corpus's pass shape without shipping it: the plan is derived
        from the per-clip payload SIZES alone (knowable from file
        sizes, ``audio_io.v6_payload_bytes``), the chunks are
        device-side zeros.  Must see the same sizes/threads as the
        timed pass (the program cache is keyed on the derived plan)."""
        assert self.mesh is None, 'resident paths are single-device'
        (n_batches, rows, offsets, _chunk_rows, chunk_words,
         total_words, pool_words) = self._ragged_plan(
            payload_bytes, upload_threads)
        fn = self._resident_pipeline_ragged(n_batches, pool_words,
                                            chunk_words)
        chunks = tuple(jnp.zeros(w, jnp.int32) for w in chunk_words)
        out = fn(self.variables, chunks, jnp.asarray(offsets))
        np.asarray(out[0] if isinstance(out, tuple) else out)

    def predict_files_resident_ragged(
            self, paths: Sequence[str], reader,
            names: Optional[List[str]] = None,
            upload_threads: int = 4,
            telemetry: Optional[dict] = None,
            upload_deadline_s: Optional[float] = None,
            payload_bytes: Optional[Sequence[int]] = None
            ) -> Tuple[List[List[dict]], List[str]]:
        """Ragged-wire variant of ``predict_files_resident``:
        ``reader(path)`` returns each clip's VARIABLE-LENGTH uint8 v6
        payload; the pass uploads one flat pool of exactly the true
        bytes (+ a (rows,) offset vector) and decodes on device.  File
        reads pipeline into the upload threads; results are identical
        to the q6 wire's (v6 decode is bit-identical).  ``payload_bytes``
        skips the size stat when the caller already knows the sizes."""
        assert self.mesh is None, (
            'predict_files_resident_ragged is single-device')
        assert len(paths) > 0, 'empty file list'
        from sed_jax.data import audio_io
        n = len(paths)
        if names is None:
            names = [os.path.basename(p) for p in paths]
        if payload_bytes is None:
            payload_bytes = [audio_io.v6_payload_bytes(p) for p in paths]
        (n_batches, rows, offsets, chunk_rows, chunk_words,
         total_words, pool_words) = self._ragged_plan(
            payload_bytes, upload_threads)
        fn = self._resident_pipeline_ragged(n_batches, pool_words,
                                            chunk_words)
        bounds_b = np.concatenate(
            [[0], np.cumsum(np.asarray(payload_bytes, np.int64))])

        t0 = time.time()
        k = len(chunk_rows)
        chunks: List[Optional[jax.Array]] = [None] * k
        errs: List[BaseException] = []

        def _read_upload(i):
            try:
                lo, hi = chunk_rows[i]
                base = bounds_b[lo]
                buf = np.empty(int(bounds_b[hi] - base), np.uint8)
                for j in range(lo, hi):
                    row = reader(paths[j])
                    o = int(bounds_b[j] - base)
                    assert row.nbytes == payload_bytes[j], (
                        paths[j], row.nbytes, payload_bytes[j])
                    buf[o:o + row.nbytes] = row
                chunks[i] = jax.device_put(buf.view(np.int32))
            except BaseException as e:
                errs.append(e)

        deadline = (t0 + upload_deadline_s
                    if upload_deadline_s is not None else None)
        offs_dev = jax.device_put(offsets)
        if k == 1 and deadline is None:
            _read_upload(0)
        else:
            ths = [threading.Thread(target=_read_upload, args=(i,),
                                    daemon=True) for i in range(k)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(timeout=None if deadline is None
                       else max(0.0, deadline - time.time()))
            stuck = [t for t in ths if t.is_alive()]
            if stuck:
                if telemetry is not None:
                    telemetry.update(aborted=1, upload_s=round(
                        time.time() - t0, 4))
                raise LinkCollapseError(
                    f'{len(stuck)}/{k} upload threads missed the '
                    f'{upload_deadline_s:.1f}s pass deadline — pass '
                    f'abandoned')
        if errs:
            raise errs[0]
        t1 = time.time()

        topk = self.pull_format == 'topk'
        out = fn(self.variables, tuple(chunks), offs_dev)
        target = out[0] if topk else out
        try:
            target.copy_to_host_async()
        except Exception:
            pass
        t2 = time.time()

        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        per_clip: List[List[dict]] = [[] for _ in range(n)]
        if deadline is None:
            buf = np.asarray(target)
        else:
            buf = self._materialize_with_deadline(
                target, deadline, upload_deadline_s, telemetry, t0)
        pulled_bytes = buf.nbytes
        t3 = time.time()
        if topk:
            self._decode_topk_into(per_clip, names, p, buf, out[1], 0, n)
        else:
            tb = self._track_bytes
            buf = buf[:n]
            act_n, act_c = np.nonzero(buf[:, :, :tb].any(axis=2))
            self._decode_tracks_into(per_clip, names, p,
                                     buf[act_n, act_c], act_n, act_c, 0)
        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        t4 = time.time()
        if telemetry is not None:
            telemetry.update(
                upload_s=round(t1 - t0, 4),   # includes pipelined reads
                launch_s=round(t2 - t1, 4),
                pull_s=round(t3 - t2, 4),
                decode_s=round(t4 - t3, 4),
                read_s=0.0,
                bytes_h2d=int(bounds_b[-1]) + offsets.nbytes,
                bytes_d2h=int(pulled_bytes),
                rpcs=k + 3, n_batches=n_batches)
        return per_clip, xmls

    def predict_rows_resident(self, rows_list: Sequence[np.ndarray],
                              names: Optional[List[str]] = None
                              ) -> Tuple[List[List[dict]], List[str]]:
        """In-memory ragged predict: each element of ``rows_list`` is
        one clip's variable-length uint8 v6 payload.  Used by the wire
        admission tool; results identical to the file path."""
        sizes = [int(r.nbytes) for r in rows_list]
        store = {i: r for i, r in enumerate(rows_list)}
        return self.predict_files_resident_ragged(
            list(range(len(rows_list))), lambda i: store[i],
            names=names or [f'clip{i}.wav' for i in store],
            upload_threads=1, payload_bytes=sizes)

    def predict_clips(self, wavs: np.ndarray,
                      names: Optional[List[str]] = None
                      ) -> Tuple[List[List[dict]], List[str]]:
        """N fixed-length clips -> per-clip (events, XML).

        One window per clip; framewise probabilities stay on-device
        (coverage-normalized there, matching ``pytorch/predict.py:349``)
        and only the threshold-active (clip, class) tracks are pulled to
        the host for event decoding.  This keeps device->host traffic at
        ~100 bytes/clip + ~2 KB per active track instead of 50 KB/clip.

        Dispatch-ahead is bounded: inputs larger than 64 forward batches
        are processed in chunks so live device buffers (framewise outputs
        of every dispatched batch) cannot grow with input size — for
        truly streaming inputs prefer ``predict_clips_stream``.
        """
        n = wavs.shape[0]
        if names is None:
            names = [f'clip{i}.wav' for i in range(n)]
        limit = self.dispatch_ahead_batches * self.batch_size
        if n > limit:
            per_clip, xmls = [], []
            for i in range(0, n, limit):
                ev, xm = self.predict_clips(wavs[i:i + limit],
                                            names[i:i + limit])
                per_clip.extend(ev)
                xmls.extend(xm)
            return per_clip, xmls
        widths = {self.window_samples}
        widths.update(wire_ops.wire_widths(self.window_samples))
        assert wavs.shape[1] in widths, (wavs.shape, widths)
        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        high = np.asarray(p['sed_high_threshold'], np.float64)

        bs = self.batch_size
        fps = float(self.cfg.frames_per_second)
        per_clip: List[List[dict]] = [[] for _ in range(n)]

        # Phase A — dispatch every batch's forward asynchronously; JAX's
        # async dispatch overlaps host->device transfers and compute of
        # batch i+1 with the pulls and host decode of batch i.
        handles = []
        for i0 in range(0, n, bs):
            chunk = wavs[i0:i0 + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:],
                                     chunk.dtype)], axis=0)
            framewise_dev, track_max_dev = self._forward_scan(
                self.variables, jnp.asarray(chunk))
            handles.append((i0, bs - pad, framewise_dev, track_max_dev))

        # Phase B — pull all per-track maxima in ONE transfer (each
        # pull has a fixed latency), then dispatch the active-track
        # gathers (still async).
        tm_all = np.asarray(jnp.concatenate(
            [h[3] for h in handles], axis=0))        # (ceil(n/bs)*bs, C)
        gathers = []
        G = self._gather_chunk
        gather_fn = (self._gather_packed
                     if self.gather_format == 'packed'
                     else self._gather_tracks)
        for bi, (i0, valid, framewise_dev, _tm) in enumerate(handles):
            track_max = tm_all[bi * bs:bi * bs + valid]
            act_n, act_c = np.nonzero(track_max > high[None, :])
            for j0 in range(0, act_n.size, G):
                sub_n = act_n[j0:j0 + G]
                sub_c = act_c[j0:j0 + G]
                idx_n = np.zeros(G, np.int32)
                idx_c = np.zeros(G, np.int32)
                idx_n[:sub_n.size] = sub_n
                idx_c[:sub_n.size] = sub_c
                tracks_dev = gather_fn(framewise_dev,
                                       jnp.asarray(idx_n),
                                       jnp.asarray(idx_c))
                gathers.append((i0, sub_n, sub_c, tracks_dev))
        # single pull for all gathered tracks
        if gathers:
            flat = np.asarray(jnp.concatenate([g[3] for g in gathers],
                                              axis=0))
            gathers = [
                (i0, sub_n, sub_c, flat[k * G:(k + 1) * G])
                for k, (i0, sub_n, sub_c, _dev) in enumerate(gathers)
            ]

        # Phase C — pull gathered float tracks, compute the two crossing
        # masks on host, decode (native batch decoder when g++ built it).
        for i0, act_n, act_c, tracks in gathers:
            self._decode_tracks_into(per_clip, names, p,
                                     tracks[:act_n.size], act_n, act_c, i0)

        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        return per_clip, xmls

    def predict_clips_stream(self, chunk_iter: Iterable[np.ndarray],
                             names: Optional[List[str]] = None
                             ) -> Tuple[List[List[dict]], List[str]]:
        """Pipelined ``predict_clips`` over a stream of clip chunks.

        Where ``device_put`` blocks the calling thread until the bytes
        arrive on device, the batched path's async dispatch hides
        nothing — uploads, host file decode, result pulls and event
        decode all serialize.  The transfer releases the GIL inside
        PJRT, so this variant runs a three-stage thread pipeline:

          caller's ``chunk_iter`` (file decode)  ->  reader thread
          upload + forward dispatch              ->  uploader thread
          track-max pull, gathers, event decode  ->  this thread

        Host-side work of batch k then overlaps the upload of batch
        k+1.  Results are identical to ``predict_clips`` —
        equivalence is tested in tests/test_serve.py.

        ``chunk_iter`` yields (n_i, wire_width) arrays, n_i <= batch_size
        (any wire format ``predict_clips`` accepts); ``names`` spans the
        concatenated stream.
        """
        p = self.sed_params.per_class(len(self.labels)) \
            if hasattr(self.sed_params, 'per_class') else self.sed_params
        high = np.asarray(p['sed_high_threshold'], np.float64)
        bs = self.batch_size
        G = self._gather_chunk
        gather_fn = (self._gather_packed
                     if self.gather_format == 'packed'
                     else self._gather_tracks)

        err: List[BaseException] = []
        stop = threading.Event()
        q_chunks: "queue.Queue" = queue.Queue(maxsize=2)
        q_dev: "queue.Queue" = queue.Queue(maxsize=2)

        def _put(q: "queue.Queue", item) -> bool:
            # bounded put that notices a dead consumer instead of
            # blocking forever (pinning device buffers in q_dev)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def _reader():
            try:
                for chunk in chunk_iter:
                    if stop.is_set() or not _put(q_chunks, chunk):
                        return
            except BaseException as e:          # propagated in main
                err.append(e)
            finally:
                _put(q_chunks, None)

        full = self.pull_format == 'full'
        topk = self.pull_format == 'topk'

        def _uploader():
            i0 = 0
            group = (self.launch_group
                     if self._forward_scan_group is not None else 1)
            pend: List[np.ndarray] = []

            def _start_pull(dev):
                # kick off the device->host copy of what the consumer
                # will pull (packed masks / top-k buffer / track maxima)
                # so it overlaps the next upload+launch instead of
                # serializing behind them; framewise / the all-tracks
                # fallback stay device-only
                target = dev[0] if (full or topk) else dev[1]
                try:
                    target.copy_to_host_async()
                except Exception:
                    pass

            def dispatch_one(chunk, valid) -> bool:
                nonlocal i0
                if topk:
                    dev = self._forward_packed_topk(self.variables,
                                                    jnp.asarray(chunk))
                elif full:
                    dev = (self._forward_packed_all(self.variables,
                                                    jnp.asarray(chunk)),)
                else:
                    dev = self._forward_scan(self.variables,
                                             jnp.asarray(chunk))
                _start_pull(dev)
                ok = _put(q_dev, (i0, valid) + dev)
                i0 += valid
                return ok

            def flush() -> bool:
                # pending FULL batches: one lax.map launch when a whole
                # group accumulated, per-batch launches for a remainder
                nonlocal i0
                if not pend:
                    return True
                if group > 1 and len(pend) == group:
                    # row-fill, not np.stack (audio_io.stack_rows docs)
                    stacked = jnp.asarray(audio_io.stack_rows(pend))
                    if topk:
                        dev = self._forward_packed_topk_group(
                            self.variables, stacked)
                    elif full:
                        dev = (self._forward_packed_all_group(
                            self.variables, stacked),)
                    else:
                        dev = self._forward_scan_group(self.variables,
                                                       stacked)
                    _start_pull(dev)
                    ok = _put(q_dev, (i0, group * bs) + dev)
                    i0 += group * bs
                else:
                    ok = all(dispatch_one(c, bs) for c in pend)
                pend.clear()
                return ok

            try:
                while not stop.is_set():
                    try:
                        chunk = q_chunks.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if chunk is None:
                        break
                    valid = chunk.shape[0]
                    if valid < bs:
                        chunk = np.concatenate(
                            [chunk, np.zeros((bs - valid,) + chunk.shape[1:],
                                             chunk.dtype)], axis=0)
                        # stream order: earlier full batches launch first
                        if not flush() or not dispatch_one(chunk, valid):
                            return
                    else:
                        pend.append(chunk)
                        if len(pend) >= group and not flush():
                            return
                flush()
            except BaseException as e:
                err.append(e)
            finally:
                _put(q_dev, None)

        threads = [threading.Thread(target=_reader, daemon=True),
                   threading.Thread(target=_uploader, daemon=True)]
        for t in threads:
            t.start()

        per_clip: List[List[dict]] = []
        tb = self._track_bytes
        try:
            while True:
                item = q_dev.get()
                if item is None:
                    break
                if topk:
                    i0, valid, tk_dev, all_dev = item
                    per_clip.extend([] for _ in range(valid))
                    self._decode_topk_into(per_clip, names, p,
                                           np.asarray(tk_dev), all_dev,
                                           i0, valid)
                    continue
                if full:
                    i0, valid, packed_dev = item
                    per_clip.extend([] for _ in range(valid))
                    buf = np.asarray(packed_dev)[:valid]  # (N, C, 2tb)
                    act_n, act_c = np.nonzero(
                        buf[:, :, :tb].any(axis=2))
                    self._decode_tracks_into(per_clip, names, p,
                                             buf[act_n, act_c],
                                             act_n, act_c, i0)
                    continue
                i0, valid, framewise_dev, track_max_dev = item
                per_clip.extend([] for _ in range(valid))
                track_max = np.asarray(track_max_dev)[:valid]
                act_n, act_c = np.nonzero(track_max > high[None, :])
                for j0 in range(0, act_n.size, G):
                    sub_n = act_n[j0:j0 + G]
                    sub_c = act_c[j0:j0 + G]
                    idx_n = np.zeros(G, np.int32)
                    idx_c = np.zeros(G, np.int32)
                    idx_n[:sub_n.size] = sub_n
                    idx_c[:sub_n.size] = sub_c
                    tracks = np.asarray(gather_fn(
                        framewise_dev, jnp.asarray(idx_n),
                        jnp.asarray(idx_c)))[:sub_n.size]
                    self._decode_tracks_into(per_clip, names, p, tracks,
                                             sub_n, sub_c, i0)
        finally:
            # unwind the pipeline on any exit: wake producers parked on
            # full queues and drop their queued device buffers
            stop.set()
            for q in (q_chunks, q_dev):
                while True:
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        break
            for t in threads:
                t.join(timeout=2.0)
        if err:
            raise err[0]
        if names is None:
            names = [f'clip{i}.wav' for i in range(len(per_clip))]
        xmls = [
            xml_writer.events_to_xml(
                sorted(evs, key=lambda e: e['onset']), names[i],
                fallback_span=(0, self.sample_duration))
            for i, evs in enumerate(per_clip)
        ]
        return per_clip, xmls
