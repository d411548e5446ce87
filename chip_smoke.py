#!/usr/bin/env python3
"""Run the serving and training path once on a GPU and check the results.

    python chip_smoke.py              # one GPU: serve, frontend, train
    python chip_smoke.py --multi-gpu  # every visible GPU: the data mesh

Model: ``Cnn_9layers_Gru_FrameAtt`` at 16 kHz, full width.  Phases:

* serve: 64 seeded 5 s clips with tone events and two seeded 60 s
  recordings, written as int16 wavs, go through ``sed_jax.cli.predict``
  with the trained bench checkpoint; every XML must parse and the clips
  must yield events.  The engine's framewise probabilities for the clips
  are compared with the same forward at "highest" matmul precision on
  the GPU (and its decoded events, by segment ER/F1), and that reference
  with the forward on the CPU.
* frontend: log-mel at 8, 16 and 32 kHz against a float64 numpy log-mel,
  at default and at "highest" precision, with the device time of a
  512-clip 16 kHz batch each way.
* train: five joint weak+strong steps at the reference batch scheme
  (``--batch_size 32`` with specaugment_timeshift_mixup: 192 weak and 64
  strong 10 s clips), one small step against the CPU, and a checkpoint
  save/restore round trip.
* multi (``--multi-gpu`` only): the joint step on a ``data`` mesh over
  every GPU against one GPU, and ``predict_clips`` over the mesh against
  the single-device engine.

Each phase prints one JSON line.  A failed check raises and ends the run
with a non-zero exit; the last line is printed only when every phase
passed.  Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(HERE, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'

# Tolerances, each with the precision of the two sides it compares, set
# a few times above what an H100 showed (PERF.md, "Bring-up").
# serve (a): engine (default precision: TF32 convs and matmuls, the
#   frontend at "highest") vs the same forward at "highest" on the GPU,
#   framewise probabilities; measured 2.7e-4, F1 1.0.
SERVE_TF32_MAX_ABS = 1e-3
SERVE_TF32_MIN_F1 = 0.99
# serve (b): "highest" on the GPU vs the CPU (float32 both); measured
#   6.7e-6.
SERVE_CPU_MAX_ABS = 5e-5
# frontend: max |dB| against float64 over bins above the amin floor, at
#   the frontend's precision ("highest"); measured 0.007 dB.  TF32 there
#   measured 13-19 dB on quiet bins.
FRONTEND_MAX_DB = 0.05
# train: one 4+4-clip step, GPU (default precision) vs CPU (float32),
#   relative loss difference; measured 3.2e-5.
TRAIN_CPU_LOSS_RTOL = 2e-4
# multi: mesh vs one GPU, both at default precision.  The first AMSGrad
#   step moves each parameter by at most lr (1e-3), so a gradient near
#   zero whose sign differs moves it by up to 2 lr; such flips must stay
#   rare.  Serving events are compared at "highest", where only the
#   sharding differs; at default precision the count of identical clips
#   is reported.
MULTI_LOSS_RTOL = 2e-4
MULTI_PARAM_ATOL = 2.1e-3
MULTI_MAX_FRAC_PARAMS_MOVED = 0.01


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({'phase': phase, **fields}), flush=True)


def timed(fn, *args):
    """(result, seconds) of fn(*args) with every output array ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def nvidia_smi_lines() -> list:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def write_wavs(directory: str, prefix: str, clips, sr: int) -> list:
    import numpy as np
    from scipy.io import wavfile
    names = []
    for i, clip in enumerate(clips):
        name = f'{prefix}{i:03d}.wav'
        pcm = np.clip(np.round(clip * 32767.0), -32768, 32767)
        wavfile.write(os.path.join(directory, name), sr, pcm.astype('<i2'))
        names.append(name)
    return names


def segment_er_f1(reference: list, estimated: list, names: list):
    from sed_jax.eval.segment_metrics import SegmentBasedMetrics
    metrics = SegmentBasedMetrics()
    for name in names:
        metrics.evaluate([e for e in reference if e['filename'] == name],
                         [e for e in estimated if e['filename'] == name])
    overall = metrics.results()['overall']
    return (overall['error_rate']['error_rate'],
            overall['f_measure']['f_measure'])


def phase_serve(tmp: str) -> None:
    import jax
    import numpy as np
    from bench_corpus import make_clips
    from sed_jax.cli import predict
    from sed_jax.config import AUDIO_16K, PREDICT_SED_PARAMS
    from sed_jax.data import audio_io
    from sed_jax.models.registry import get_model
    from sed_jax.native.vad_native import native_available
    from sed_jax.post.events import decode_batch
    from sed_jax.serve.engine import SedInferenceEngine
    from sed_jax.train.checkpoint import load_variables

    cfg = AUDIO_16K
    sr = cfg.sample_rate
    inputs = os.path.join(tmp, 'serve_in')
    os.makedirs(inputs)
    clips = make_clips(64, sr, seconds=5, seed=0)
    clip_names = write_wavs(inputs, 'clip', clips, sr)
    long_names = write_wavs(inputs, 'long',
                            make_clips(2, sr, seconds=60, seed=1), sr)

    workspace = os.path.join(tmp, 'serve_ws')
    t0 = time.perf_counter()
    predict.main(['predict', '--input_dir', inputs,
                  '--workspace', workspace, '--model_type', MODEL,
                  '--checkpoint', CHECKPOINT, '--overlap',
                  '--sample_duration', '5', '--audio_16k', '--bulk', '8'])
    cli_s = time.perf_counter() - t0
    results = None
    for root, _, files in os.walk(workspace):
        if any(f.endswith('.xml') for f in files):
            results = root
    check(results is not None, 'predict wrote no XML')
    clip_events = 0
    clips_with_events = 0
    for name in clip_names + long_names:
        path = os.path.join(results, os.path.splitext(name)[0] + '.xml')
        check(os.path.isfile(path), f'no XML for {name}')
        segments = ET.parse(path).getroot().iter('SoundSegment')
        n = sum(1 for s in segments if s.get('event') is not None)
        if name in clip_names:
            clip_events += n
            clips_with_events += n > 0
    check(clip_events > 0, 'the predict CLI found no events in the clips')

    # the engine on the same variables, and the two references
    model = get_model(MODEL, cfg)
    variables = load_variables(CHECKPOINT)
    engine = SedInferenceEngine(model, variables, cfg, sample_duration=5,
                                overlap=True, sed_params=PREDICT_SED_PARAMS,
                                batch_size=32)
    wavs = audio_io.stack_rows(
        audio_io.load_audio(os.path.join(inputs, n), sr=sr)[0]
        for n in clip_names)
    (fw_engine, _), engine_compile_s = timed(engine.infer_framewise, wavs)
    (fw_engine, _), engine_run_s = timed(engine.infer_framewise, wavs)

    def forward(v, w):
        return model.apply(v, w, train=False)['framewise_output']

    with jax.default_matmul_precision('highest'):
        ref_fn = jax.jit(forward)
        fw_ref, ref_compile_s = timed(ref_fn, variables, wavs)
        fw_ref = np.asarray(fw_ref)
        cpu = jax.devices('cpu')[0]
        fw_cpu, cpu_s = timed(ref_fn, jax.device_put(variables, cpu),
                              jax.device_put(wavs, cpu))
        fw_cpu = np.asarray(fw_cpu)
    check(fw_engine.shape == fw_ref.shape == (64, 500, 25),
          f'framewise shape {fw_engine.shape}')
    check(np.isfinite(fw_engine).all(), 'non-finite engine output')
    d_tf32 = float(np.max(np.abs(fw_engine - fw_ref)))
    d_cpu = float(np.max(np.abs(fw_ref - fw_cpu)))
    fps = cfg.frames_per_second
    ev_engine = decode_batch(fw_engine, clip_names, PREDICT_SED_PARAMS, fps)
    ev_ref = decode_batch(fw_ref, clip_names, PREDICT_SED_PARAMS, fps)
    er, f1 = segment_er_f1(ev_ref, ev_engine, clip_names)
    emit('serve', files=len(clip_names) + len(long_names),
         clip_events=clip_events, clips_with_events=clips_with_events,
         native_decoder=native_available(), cli_s=cli_s,
         engine_compile_s=engine_compile_s, engine_run_s=engine_run_s,
         ref_highest_compile_s=ref_compile_s, cpu_forward_s=cpu_s,
         max_abs_dp_engine_vs_highest=d_tf32,
         max_abs_dp_highest_gpu_vs_cpu=d_cpu,
         events_engine=len(ev_engine), events_highest=len(ev_ref),
         segment_er_vs_highest=er, segment_f1_vs_highest=f1)
    check(d_tf32 <= SERVE_TF32_MAX_ABS,
          f'engine vs highest: max |dp| {d_tf32} > {SERVE_TF32_MAX_ABS}')
    check(f1 >= SERVE_TF32_MIN_F1,
          f'engine vs highest: segment F1 {f1} < {SERVE_TF32_MIN_F1}')
    check(d_cpu <= SERVE_CPU_MAX_ABS,
          f'GPU vs CPU at highest: max |dp| {d_cpu} > {SERVE_CPU_MAX_ABS}')


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------


def device_ms(fn, x, reps: int = 20):
    """(seconds of the first call, compile included; median wall ms of
    the next ``reps`` calls), each call waited for."""
    import jax
    import numpy as np
    _, first_s = timed(fn, x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append(time.perf_counter() - t0)
    return first_s, float(np.median(times) * 1e3)


def phase_frontend() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bench_corpus import make_clips
    from sed_jax.config import AUDIO_8K, AUDIO_16K, AUDIO_32K
    from sed_jax.dsp import frontend as fe

    precisions = {'default': jax.lax.Precision.DEFAULT,
                  'highest': jax.lax.Precision.HIGHEST}
    fns = {name: jax.jit(lambda w, c, p=p: fe.logmel(w, c, precision=p),
                         static_argnums=1)
           for name, p in precisions.items()}
    chosen = 'highest' if fe.PRECISION == jax.lax.Precision.HIGHEST \
        else 'default'
    errors = {}
    for cfg in (AUDIO_8K, AUDIO_16K, AUDIO_32K):
        wav = make_clips(64, cfg.sample_rate, seconds=5, seed=2)
        mel, ref_db = fe.logmel_reference(wav, cfg)
        floor = mel > cfg.amin
        for name, fn in fns.items():
            got = np.asarray(fn(jnp.asarray(wav), cfg), np.float64)
            err = np.abs(got - ref_db)[floor]
            errors[f'{cfg.name}_{name}'] = {
                'max_db': float(err.max()),
                'p99_9_db': float(np.percentile(err, 99.9))}
    batch = jnp.asarray(make_clips(512, AUDIO_16K.sample_rate, seconds=5,
                                   seed=3))
    timings = {name: device_ms(lambda w, fn=fn: fn(w, AUDIO_16K), batch)
               for name, fn in fns.items()}
    emit('frontend', chosen_precision=chosen, error_vs_float64=errors,
         compile_and_first_call_s_512_clips_16k={
             k: v[0] for k, v in timings.items()},
         ms_512_clips_16k={k: v[1] for k, v in timings.items()})
    for key, err in errors.items():
        if key.endswith(chosen):
            check(err['max_db'] <= FRONTEND_MAX_DB,
                  f'frontend {key}: {err["max_db"]} dB > {FRONTEND_MAX_DB}')


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def train_batches(n_weak: int, n_strong: int, seed: int):
    """Seeded int16 10 s waveforms, targets and mixup lambdas, as the
    train CLI ships them (the step dequantizes on device)."""
    import numpy as np
    from sed_jax.augment.functional import MixupGenerator
    from sed_jax.config import AUDIO_16K, CLASSES_NUM
    rng = np.random.RandomState(seed)
    samples = AUDIO_16K.audio_samples
    frames = AUDIO_16K.frames_per_second * 10
    mixup = MixupGenerator(mixup_alpha=1.0, random_seed=seed)

    def pcm(n):
        return (rng.standard_normal((n, samples)) * 3000).astype(np.int16)

    weak = {'waveform': pcm(n_weak),
            'target': (rng.rand(n_weak, CLASSES_NUM) < 0.1
                       ).astype(np.float32),
            'mixup_lambda': mixup.get_lambda(n_weak).astype(np.float32)}
    strong = {'waveform': pcm(n_strong),
              'strong_target': (rng.rand(n_strong, frames, CLASSES_NUM)
                                < 0.05).astype(np.float32),
              'mixup_lambda': mixup.get_lambda(n_strong).astype(np.float32)}
    return weak, strong


def make_step(model, mesh=None, donate=True):
    from sed_jax import losses
    from sed_jax.config import AUDIO_16K
    from sed_jax.train.step import make_train_step
    return make_train_step(
        model, losses.get_loss_func('clip_bce'),
        losses.get_loss_func('frame_bce'), mixup=True, timeshift=True,
        spec_augment=True, mesh=mesh, donate=donate,
        wire_samples=AUDIO_16K.audio_samples)


def fresh_state(model):
    import jax
    import jax.numpy as jnp
    from sed_jax.config import AUDIO_16K
    from sed_jax.train.state import create_train_state
    return create_train_state(
        model, jax.random.PRNGKey(0),
        jnp.zeros((1, AUDIO_16K.audio_samples), jnp.float32))


def phase_train(tmp: str) -> None:
    import jax
    import numpy as np
    from sed_jax.config import AUDIO_16K
    from sed_jax.models.registry import get_model
    from sed_jax.train.checkpoint import restore_checkpoint, save_checkpoint

    model = get_model(MODEL, AUDIO_16K)
    step = make_step(model)
    state = fresh_state(model)
    weak, strong = train_batches(192, 64, seed=0)
    weak, strong = jax.device_put((weak, strong))
    losses, step_s = [], []
    for i in range(5):
        (state, metrics), dt = timed(step, state, weak, [strong],
                                     jax.random.PRNGKey(100 + i))
        losses.append(float(metrics['loss']))
        step_s.append(dt)
        check(np.isfinite(losses[-1]), f'train step {i}: loss {losses[-1]}')
    peak = (jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')

    # one 4+4-clip step on the GPU and on the CPU from the same state
    small_w, small_s = train_batches(4, 4, seed=1)
    key = jax.random.PRNGKey(7)
    (_, m_gpu) = make_step(model, donate=False)(
        fresh_state(model), small_w, [small_s], key)
    cpu = jax.devices('cpu')[0]
    (_, m_cpu) = make_step(model, donate=False)(
        jax.device_put(fresh_state(model), cpu),
        jax.device_put(small_w, cpu), [jax.device_put(small_s, cpu)],
        jax.device_put(key, cpu))
    loss_gpu, loss_cpu = float(m_gpu['loss']), float(m_cpu['loss'])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)

    path = os.path.join(tmp, 'iter_5.npz')
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, fresh_state(model))
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(jax.tree.leaves(restored),
                               jax.tree.leaves(state)))
    emit('train', weak_clips=192, strong_clips=64, losses=losses,
         compile_and_first_step_s=step_s[0],
         step_s_after_compile=float(np.median(step_s[1:])),
         peak_bytes_in_use=peak, small_step_loss_gpu=loss_gpu,
         small_step_loss_cpu=loss_cpu, small_step_loss_rel_diff=rel,
         checkpoint_restored_equal=same,
         checkpoint_bytes=os.path.getsize(path))
    check(rel <= TRAIN_CPU_LOSS_RTOL,
          f'GPU vs CPU step loss: rel diff {rel} > {TRAIN_CPU_LOSS_RTOL}')
    check(same, 'restored checkpoint differs from the saved state')
    check(int(restored.step) == 5, f'restored step {int(restored.step)}')


# ---------------------------------------------------------------------------
# multi
# ---------------------------------------------------------------------------


def phase_multi() -> None:
    import jax
    import numpy as np
    from bench_corpus import make_clips
    from sed_jax.config import AUDIO_16K
    from sed_jax.models.registry import get_model
    from sed_jax.parallel import mesh as mesh_lib
    from sed_jax.serve.engine import SedInferenceEngine
    from sed_jax.train.checkpoint import load_variables

    n_dev = len(jax.devices())
    check(n_dev > 1, f'--multi-gpu needs several GPUs, found {n_dev}')
    mesh = mesh_lib.make_mesh(n_dev)
    model = get_model(MODEL, AUDIO_16K)
    # the train phase's batch and step, so one GPU's program can come
    # from the persistent compile cache
    weak, strong = train_batches(192, 64, seed=0)
    key = jax.random.PRNGKey(100)
    (s_one, m_one), one_s = timed(make_step(model), fresh_state(model),
                                  weak, [strong], key)
    state = jax.device_put(fresh_state(model),
                           mesh_lib.replicated_sharding(mesh))
    (s_mesh, m_mesh), mesh_s = timed(
        make_step(model, mesh=mesh), state,
        mesh_lib.shard_batch(weak, mesh),
        [mesh_lib.shard_batch(strong, mesh)], key)
    loss_one, loss_mesh = float(m_one['loss']), float(m_mesh['loss'])
    rel = abs(loss_mesh - loss_one) / abs(loss_one)
    diffs = [np.abs(np.asarray(a) - np.asarray(b))
             for a, b in zip(jax.tree.leaves(s_mesh.params),
                             jax.tree.leaves(s_one.params))]
    d_param = float(max(d.max() for d in diffs))
    moved = float(sum((d > 1e-5).sum() for d in diffs)
                  / sum(d.size for d in diffs))

    cfg = AUDIO_16K
    variables = load_variables(CHECKPOINT)
    clips = make_clips(64, cfg.sample_rate, seconds=5, seed=0)
    names = [f'clip{i:03d}.wav' for i in range(len(clips))]

    def key_of(events):
        return [sorted((e['event_label'], e['onset'], e['offset'])
                       for e in clip) for clip in events]

    def serve_both():
        """(identical clips, events, seconds one GPU, seconds mesh) of
        fresh engines, compiled under the current matmul precision."""
        single = SedInferenceEngine(model, variables, cfg, batch_size=32)
        sharded = SedInferenceEngine(model, variables, cfg, batch_size=32,
                                     mesh=mesh)
        (ev_one, _), one_s = timed(single.predict_clips, clips, names)
        (ev_mesh, _), mesh_s = timed(sharded.predict_clips, clips, names)
        same = sum(a == b for a, b in zip(key_of(ev_one), key_of(ev_mesh)))
        return same, sum(len(c) for c in ev_one), one_s, mesh_s

    identical_default, _, _, _ = serve_both()
    with jax.default_matmul_precision('highest'):
        identical, n_events, serve_one_s, serve_mesh_s = serve_both()
    emit('multi', devices=n_dev, weak_clips=192, strong_clips=64,
         loss_one_gpu=loss_one, loss_mesh=loss_mesh, loss_rel_diff=rel,
         max_abs_param_diff=d_param, frac_params_diff_gt_1e5=moved,
         step_one_gpu_first_s=one_s, step_mesh_first_s=mesh_s,
         serve_clips=len(clips),
         clips_with_identical_events_highest=identical,
         clips_with_identical_events_default=identical_default,
         events=n_events,
         serve_one_gpu_first_s=serve_one_s, serve_mesh_first_s=serve_mesh_s)
    check(rel <= MULTI_LOSS_RTOL,
          f'mesh vs one GPU loss: rel diff {rel} > {MULTI_LOSS_RTOL}')
    check(d_param <= MULTI_PARAM_ATOL,
          f'mesh vs one GPU params: {d_param} > {MULTI_PARAM_ATOL}')
    check(moved <= MULTI_MAX_FRAC_PARAMS_MOVED,
          f'mesh vs one GPU: {moved} of the params differ by > 1e-5')
    check(identical == len(clips),
          f'sharded serving events differ on {len(clips) - identical} '
          'clips')


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--multi-gpu', action='store_true',
                        help='run only the data-mesh phase, over every '
                             'visible GPU')
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, 'sed_jax')):
        print('chip_smoke.py: the sed_jax package is not beside this '
              'script', file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, 'tools')]
    platforms = os.environ.get('JAX_PLATFORMS')
    if platforms and 'cpu' not in platforms.split(','):
        # the CPU references need the CPU backend beside the GPU
        os.environ['JAX_PLATFORMS'] = platforms + ',cpu'
    from sed_jax.utils import compile_cache
    compile_cache.enable()
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        print(f'chip_smoke.py: needs a GPU; JAX found '
              f'{devices[0].platform} devices', file=sys.stderr)
        return 2
    for line in nvidia_smi_lines():
        print(line, flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        if args.multi_gpu:
            phase_multi()
        else:
            phase_serve(tmp)
            phase_frontend()
            phase_train(tmp)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
