"""Serving engine tests: window schedule, wav->XML, bulk clip API."""

import re

import jax
import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, PREDICT_SED_PARAMS
from sed_jax.data import audio_io
from sed_jax.models.registry import get_model
from sed_jax.serve.engine import SedInferenceEngine, window_starts

# jit-heavy tier: excluded from the fast CI run (pytest -m "not slow")
pytestmark = pytest.mark.slow


def test_window_starts_overlap_schedule():
    # duration 12 s, 5 s windows, 1 s hop: starts 0..7
    assert window_starts(12.0, 5, True) == [0.0, 1, 2, 3, 4, 5, 6, 7]
    # short file -> single window
    assert window_starts(3.0, 5, True) == [0.0]
    # non-overlap
    assert window_starts(12.0, 5, False) == [0.0, 5]
    assert window_starts(15.0, 5, False) == [0.0, 5, 10]


@pytest.fixture(scope='module')
def engine():
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    wav = np.zeros((1, cfg.sample_rate * 5), np.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, wav,
                           train=False)
    return SedInferenceEngine(model, variables, cfg, sample_duration=5,
                              overlap=True, batch_size=8)


def test_predict_waveform_event_pipeline(engine):
    rng = np.random.RandomState(0)
    audio = rng.uniform(-0.3, 0.3, AUDIO_16K.sample_rate * 12)
    events = engine.predict_waveform(audio.astype(np.float32), 'x.wav')
    for e in events:
        assert 0.0 <= e['onset'] < e['offset'] <= 12.01
        assert e['filename'] == 'x.wav'


def test_predict_file_xml(engine, tmp_path):
    rng = np.random.RandomState(1)
    path = str(tmp_path / 'test.wav')
    audio_io.save_wav(path, rng.uniform(-0.3, 0.3, AUDIO_16K.sample_rate * 7),
                      AUDIO_16K.sample_rate)
    events, xml = engine.predict_file(path)
    assert xml.startswith('<AudioDoc name="test.wav">')
    assert xml.endswith('</AudioDoc>')
    # either real segments or the "Others" fallback
    assert ('<SoundSegment' in xml)
    if not events:
        assert 'Others' in xml


def test_predict_clips_bulk(engine):
    rng = np.random.RandomState(2)
    wavs = rng.uniform(-0.3, 0.3,
                       (5, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    per_clip, xmls = engine.predict_clips(wavs)
    assert len(per_clip) == 5 and len(xmls) == 5
    for xml in xmls:
        assert re.match(r'<AudioDoc name="clip\d+\.wav">', xml)


def test_mesh_parallel_serving_matches_single(engine):
    """Data-parallel serving over the 8-device virtual mesh produces the
    same events as the single-device engine."""
    import jax
    from sed_jax.parallel import mesh as mesh_lib
    assert jax.device_count() >= 8
    mesh = mesh_lib.make_mesh(8)
    mesh_engine = SedInferenceEngine(
        engine.model, engine.variables, AUDIO_16K, sample_duration=5,
        overlap=True, batch_size=8, mesh=mesh)
    rng = np.random.RandomState(5)
    wavs = rng.uniform(-0.3, 0.3,
                       (8, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    got, _ = mesh_engine.predict_clips(wavs)
    want, _ = engine.predict_clips(wavs)
    for g, w in zip(got, want):
        key = lambda e: (e['onset'], e['event_label'])  # noqa: E731
        assert sorted(g, key=key) == sorted(w, key=key)


def test_mesh_resident_serving_matches_single(engine):
    """The RESIDENT bulk path (the path every headline runs) on the
    8-device virtual mesh: row-sharded uploads + one sharded program,
    events/XML identical to the single-device resident pass (round-4
    verdict #5 — the flagship serving path must not be structurally
    single-device)."""
    import jax
    from sed_jax.parallel import mesh as mesh_lib
    assert jax.device_count() >= 8
    mesh = mesh_lib.make_mesh(8)
    mesh_engine = SedInferenceEngine(
        engine.model, engine.variables, AUDIO_16K, sample_duration=5,
        overlap=True, batch_size=8, mesh=mesh)
    rng = np.random.RandomState(29)
    wavs = rng.uniform(-0.3, 0.3,
                       (12, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    q6 = audio_io.qn_encode(wavs, 6)
    names = [f'c{i}.wav' for i in range(12)]
    mesh_engine.warmup_resident(12, q6.shape[1], q6.dtype, 2)
    got, gx = mesh_engine.predict_clips_resident(q6, names=names,
                                                 upload_threads=2)
    want, wx = engine.predict_clips_resident(q6, names=names,
                                             upload_threads=2)
    assert got == want and gx == wx


def test_packed_gather_matches_float_gather(engine):
    """The on-device packed-mask gather must be event-identical to the
    float-track gather (the decode consumes only crossing masks)."""
    float_engine = SedInferenceEngine(
        engine.model, engine.variables, AUDIO_16K, sample_duration=5,
        overlap=True, batch_size=8, gather_format='float')
    rng = np.random.RandomState(11)
    wavs = rng.uniform(-0.3, 0.3,
                       (8, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    got, _ = engine.predict_clips(wavs)       # default: packed
    want, _ = float_engine.predict_clips(wavs)
    assert got == want


def test_predict_waveforms_matches_per_file(engine):
    """Cross-file window batching must equal per-file prediction."""
    rng = np.random.RandomState(9)
    waves = [rng.uniform(-0.3, 0.3, AUDIO_16K.sample_rate * d)
             .astype(np.float32) for d in (7, 10, 12)]
    names = ['a.wav', 'b.wav', 'c.wav']
    got = engine.predict_waveforms(waves, names)
    want = []
    for w, n in zip(waves, names):
        want.extend(engine.predict_waveform(w, n))
    key = lambda e: (e['filename'], e['onset'], e['event_label'])  # noqa
    assert sorted(got, key=key) == sorted(want, key=key)


def test_windowed_clips_match_host_merge(engine):
    """Device-side overlap-add + packed decode must equal the host-merge
    path for uniform 10 s clips (the inference_prob_overlap grid)."""
    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=6, overlap=True,
                             overlap_value=0.5, batch_size=18)
    rng = np.random.RandomState(13)
    wavs = rng.uniform(-0.3, 0.3,
                       (3, AUDIO_16K.sample_rate * 10)).astype(np.float32)
    names = ['a', 'b', 'c']
    got = eng.predict_clips_windowed(wavs, names, duration=10.0, step=0.5)
    key = lambda e: (e['onset'], e['event_label'])  # noqa: E731
    for i, name in enumerate(names):
        want = eng.predict_waveform(wavs[i], name, duration=10.0,
                                    step=0.5)
        assert sorted(got[i], key=key) == sorted(want, key=key)


def test_stream_matches_bulk(engine):
    """The thread-pipelined streaming path must produce identical events
    and XML to predict_clips, including a ragged final chunk."""
    rng = np.random.RandomState(17)
    wavs = rng.uniform(-0.3, 0.3,
                       (21, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(21)]
    want_ev, want_xml = engine.predict_clips(wavs, names=names)

    def chunks():
        for i in range(0, 21, engine.batch_size):
            yield wavs[i:i + engine.batch_size]

    got_ev, got_xml = engine.predict_clips_stream(chunks(), names=names)
    assert got_ev == want_ev
    assert got_xml == want_xml

    # errors raised inside the caller's iterator must propagate
    def bad():
        yield wavs[:8]
        raise RuntimeError('decode failed')

    with pytest.raises(RuntimeError, match='decode failed'):
        engine.predict_clips_stream(bad(), names=names)


def test_stream_launch_group_matches_bulk():
    """launch_group fuses full batches into one lax.map launch; events
    and XML must match the ungrouped path, including a partial final
    chunk and a remainder group."""
    import jax
    from sed_jax.models.registry import get_model
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    wav0 = np.zeros((1, cfg.sample_rate * 5), np.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, wav0,
                           train=False)
    eng = SedInferenceEngine(model, variables, cfg, sample_duration=5,
                             overlap=True, batch_size=4, launch_group=2)
    rng = np.random.RandomState(55)
    # 4 full batches of 4 (two groups) + one partial chunk of 3
    wavs = rng.uniform(-0.3, 0.3,
                       (19, cfg.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(19)]
    want = eng.predict_clips(wavs, names=names)

    def chunks():
        for i in range(0, 19, 4):
            yield wavs[i:i + 4]

    got = eng.predict_clips_stream(chunks(), names=names)
    assert got == want
    # remainder group: 3 full batches with group=2 -> 1 grouped + 1 solo
    got2 = eng.predict_clips_stream(
        (wavs[i:i + 4] for i in range(0, 12, 4)), names=names[:12])
    want2 = eng.predict_clips(wavs[:12], names=names[:12])
    assert got2 == want2


def test_stream_pull_format_full_matches_tracks():
    """pull_format='full' (one launch returning packed masks for every
    track, one fixed-shape pull) must produce identical events/XML to
    the gather-based path, grouped and ungrouped."""
    import jax
    from sed_jax.models.registry import get_model
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    wav0 = np.zeros((1, cfg.sample_rate * 5), np.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, wav0,
                           train=False)
    rng = np.random.RandomState(77)
    wavs = rng.uniform(-0.3, 0.3,
                       (11, cfg.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(11)]

    base = SedInferenceEngine(model, variables, cfg, sample_duration=5,
                              overlap=True, batch_size=4)
    want = base.predict_clips(wavs, names=names)

    def chunks():
        for i in range(0, 11, 4):
            yield wavs[i:i + 4]

    for group in (1, 2):
        for pull in ('full', 'topk'):
            eng = SedInferenceEngine(model, variables, cfg,
                                     sample_duration=5, overlap=True,
                                     batch_size=4, launch_group=group,
                                     pull_format=pull)
            got = eng.predict_clips_stream(chunks(), names=names)
            assert got == want, f'group={group} pull={pull}'

    # top-k saturation: capacity 1 forces the on-device all-tracks
    # fallback; results still exact
    eng = SedInferenceEngine(model, variables, cfg, sample_duration=5,
                             overlap=True, batch_size=4,
                             pull_format='topk')
    eng._topk_capacity = 1
    got = eng.predict_clips_stream(chunks(), names=names)
    assert got == want


def test_engine_defaults_are_measured_fastest():
    """Production defaults: pull_format='topk' (the fewest pulled
    bytes; exact via saturation fallback) and launch_group=2 — what a
    user who sets nothing gets."""
    import jax
    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_Gru_FrameAtt', cfg)
    wav0 = np.zeros((1, cfg.sample_rate * 5), np.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, wav0,
                           train=False)
    eng = SedInferenceEngine(model, variables, cfg, batch_size=4)
    assert eng.pull_format == 'topk'
    assert eng.launch_group == 2
    # float gathers need the per-track pull path; the default adapts
    eng_f = SedInferenceEngine(model, variables, cfg, batch_size=4,
                               gather_format='float')
    assert eng_f.pull_format == 'tracks'
    # an explicit incompatible combination is rejected loudly instead of
    # decoding packed mask bytes as float probabilities
    with pytest.raises(AssertionError):
        SedInferenceEngine(model, variables, cfg, batch_size=4,
                           gather_format='float', pull_format='full')
    # the predict CLI builds its engine with the same defaults
    import inspect
    from sed_jax.cli import predict as predict_cli
    src = inspect.getsource(predict_cli._build_engine)
    assert "'launch_group', 2" in src and "'pull_format', None" in src


def test_topk_saturation_with_padded_batch(engine):
    """Regression: pad clips' tracks compete in lax.top_k, so a short
    final chunk where capacity k >= valid*nC but k < B*nC can have real
    active tracks displaced by pad tracks while every pulled margin is
    positive.  The fallback must trigger on the LAUNCH's total track
    count, not valid*nC."""
    nC = len(engine.labels)
    tb = engine._track_bytes
    valid, B = 1, 2
    k = nC + 1                       # >= valid*nC, < B*nC
    # the real clip's single active track: class 3, frames 40..79 high
    all_dev = np.zeros((B, nC, 2 * tb), np.uint8)
    bits = np.zeros(tb * 8, np.uint8)
    bits[40:80] = 1
    packed = np.packbits(bits)
    all_dev[0, 3, :tb] = packed
    all_dev[0, 3, tb:] = packed      # low mask = high mask
    # top-k buffer: ALL rows are pad-clip tracks (flat idx >= valid*nC)
    # with positive margins — the real track was displaced entirely
    buf = np.zeros((k, 2 * tb + 8), np.uint8)
    for j in range(k):
        flat = nC + j % nC           # pad clip's tracks
        buf[j, 2 * tb:2 * tb + 4] = np.array(
            [flat], np.int32).view(np.uint8)
        buf[j, 2 * tb + 4:] = np.array([0.25], np.float32).view(np.uint8)
    p = PREDICT_SED_PARAMS.per_class(nC)
    per_clip = [[] for _ in range(valid)]
    engine._decode_topk_into(per_clip, ['real.wav'], p, buf, all_dev,
                             0, valid)
    assert len(per_clip[0]) == 1     # recovered from the fallback buffer
    ev = per_clip[0][0]
    assert ev['event_label'] == engine.labels[3]
    assert abs(ev['onset'] - 0.40) < 1e-6
    assert abs(ev['offset'] - 0.80) < 1e-6


def test_resident_matches_bulk(engine):
    """predict_clips_resident (single upload + one lax.map launch + one
    pull) must produce identical events/XML to predict_clips for ragged
    clip counts, any upload split, both pull formats, and q6 wires."""
    rng = np.random.RandomState(61)
    wavs = rng.uniform(-0.3, 0.3,
                       (19, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(19)]
    want = engine.predict_clips(wavs, names=names)
    for threads in (1, 3):
        telemetry = {}
        got = engine.predict_clips_resident(wavs, names=names,
                                            upload_threads=threads,
                                            telemetry=telemetry)
        assert got == want, f'threads={threads}'
        assert telemetry['rpcs'] == threads + 2
        assert telemetry['bytes_h2d'] == 24 * wavs.shape[1] * 4
        assert telemetry['n_batches'] == 3
        for key in ('upload_s', 'launch_s', 'pull_s', 'decode_s',
                    'bytes_d2h'):
            assert key in telemetry

    # topk resident, incl. forced saturation -> on-device fallback
    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=5, overlap=True,
                             batch_size=8, pull_format='topk')
    got = eng.predict_clips_resident(wavs, names=names)
    assert got == want
    eng2 = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                              sample_duration=5, overlap=True,
                              batch_size=8, pull_format='topk')
    eng2._topk_capacity_resident = lambda n: 1
    got2 = eng2.predict_clips_resident(wavs, names=names)
    assert got2 == want

    # quantized wire: resident must equal the batched path on the SAME
    # wire (both decode q6 on device)
    q6 = audio_io.qn_encode(wavs, 6)
    want_q6 = engine.predict_clips(q6, names=names)
    got_q6 = engine.predict_clips_resident(q6, names=names)
    assert got_q6 == want_q6


def test_resident_chunked_launches_match_single(engine):
    """launch_chunks=m splits the resident pass into m concurrently
    dispatched upload+launch+pull chunks (upload/compute overlap on
    fast links) — must stay exactly equal to the single-launch pass for
    ragged clip counts, m > n_batches (clamped), both pull formats,
    forced topk saturation, and q6 wires."""
    rng = np.random.RandomState(62)
    wavs = rng.uniform(-0.3, 0.3,
                       (19, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(19)]
    want = engine.predict_clips_resident(wavs, names=names)
    for m in (2, 3, 7):                     # 7 > n_batches=3 -> clamped
        telemetry = {}
        got = engine.predict_clips_resident(wavs, names=names,
                                            launch_chunks=m,
                                            telemetry=telemetry)
        assert got == want, f'launch_chunks={m}'
        eff = min(m, 3)
        assert telemetry['launch_chunks'] == eff
        assert telemetry['rpcs'] == 3 * eff
        assert telemetry['bytes_h2d'] == 24 * wavs.shape[1] * 4
        assert telemetry['n_batches'] == 3

    # equal chunks share ONE compiled program; the 2-chunk split of 3
    # batches needs two (2-batch + 1-batch)
    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=5, overlap=True,
                             batch_size=8, pull_format='topk')
    eng.warmup_resident(19, wavs.shape[1], wavs.dtype, launch_chunks=3)
    n_cached = len(eng._resident_cache)
    assert n_cached == 1                    # 3 equal 1-batch chunks
    got = eng.predict_clips_resident(wavs, names=names, launch_chunks=3)
    assert got == want
    assert len(eng._resident_cache) == n_cached

    # forced saturation in a chunk -> that chunk's on-device fallback
    eng2 = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                              sample_duration=5, overlap=True,
                              batch_size=8, pull_format='topk')
    eng2._topk_capacity_resident = lambda n: 1
    got2 = eng2.predict_clips_resident(wavs, names=names, launch_chunks=2)
    assert got2 == want

    # q6 wire through the chunked path
    q6 = audio_io.qn_encode(wavs, 6)
    want_q6 = engine.predict_clips_resident(q6, names=names)
    got_q6 = engine.predict_clips_resident(q6, names=names,
                                           launch_chunks=2)
    assert got_q6 == want_q6


def test_files_resident_matches_clips_resident(engine, tmp_path):
    """predict_files_resident (file decode pipelined into the upload
    threads) must equal predict_clips_resident on the same wire bytes,
    for ragged counts and both pull formats."""
    rng = np.random.RandomState(67)
    wavs = rng.uniform(-0.3, 0.3,
                       (11, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    q6 = audio_io.qn_encode(wavs, 6)
    paths = []
    for i in range(11):
        p = str(tmp_path / f'r{i}.q6')
        audio_io.save_qn(p, wavs[i], AUDIO_16K.sample_rate, 6)
        paths.append(p)
    names = [f'r{i}.q6' for i in range(11)]
    reader = lambda p: audio_io.read_qn(p)[0]  # noqa: E731
    want = engine.predict_clips_resident(q6, names=names)
    for threads in (1, 3):
        tel = {}
        got = engine.predict_files_resident(paths, reader, names=names,
                                            upload_threads=threads,
                                            telemetry=tel)
        assert got == want, f'threads={threads}'
        assert tel['rpcs'] == threads + 2 and tel['read_s'] == 0.0

    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=5, overlap=True,
                             batch_size=8, pull_format='topk')
    got = eng.predict_files_resident(paths, reader, names=names)
    assert got == want

    # chunked launches: per-chunk read->upload->launch->pull pipeline
    tel = {}
    got = engine.predict_files_resident(paths, reader, names=names,
                                        launch_chunks=2, telemetry=tel)
    assert got == want
    assert tel['launch_chunks'] == 2 and tel['rpcs'] == 6

    # a reader exception must propagate, not hang the threads
    def bad_reader(p):
        raise RuntimeError('decode failed')
    with pytest.raises(RuntimeError, match='decode failed'):
        engine.predict_files_resident(paths, bad_reader, names=names)
    with pytest.raises(RuntimeError, match='decode failed'):
        engine.predict_files_resident(paths, bad_reader, names=names,
                                      launch_chunks=2)


def test_files_resident_chunked_passes_match_single(engine, tmp_path):
    """max_pass_clips bounds device memory: serving 23 files in resident
    passes of <=8 clips must produce results identical to one pass, and
    every pass must reuse ONE compiled program (pad-to-batch makes the
    7-clip remainder the same program shape)."""
    rng = np.random.RandomState(73)
    wavs = rng.uniform(-0.3, 0.3,
                       (23, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    paths, names = [], [f'k{i}.wav' for i in range(23)]
    for i in range(23):
        p = str(tmp_path / f'k{i}.q6')
        audio_io.save_qn(p, wavs[i], AUDIO_16K.sample_rate, 6)
        paths.append(p)
    reader = lambda p: audio_io.read_qn(p)[0]  # noqa: E731
    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=5, overlap=True,
                             batch_size=8, pull_format='topk')
    want = eng.predict_files_resident(paths, reader, names=names,
                                      upload_threads=3)
    cached_before = len(eng._resident_cache)
    tel = {}
    got = eng.predict_files_resident(paths, reader, names=names,
                                     upload_threads=3, telemetry=tel,
                                     max_pass_clips=8)
    assert got == want
    assert tel['passes'] == 3
    assert tel['rpcs'] == 3 * (3 + 2)
    # all three chunked passes (8, 8, and padded 7) share ONE program
    assert len(eng._resident_cache) == cached_before + 1


def test_warmup_resident_compiles_the_timed_program(engine, tmp_path):
    """warmup_resident (device-side zeros inputs, no corpus upload) must
    compile exactly the program the subsequent timed pass uses — same
    cache key, no recompile — and leave results identical."""
    rng = np.random.RandomState(71)
    wavs = rng.uniform(-0.3, 0.3,
                       (11, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    q6 = audio_io.qn_encode(wavs, 6)
    paths, names = [], [f'w{i}.q6' for i in range(11)]
    for i in range(11):
        p = str(tmp_path / f'w{i}.q6')
        audio_io.save_qn(p, wavs[i], AUDIO_16K.sample_rate, 6)
        paths.append(p)
    reader = lambda p: audio_io.read_qn(p)[0]  # noqa: E731
    want = engine.predict_clips_resident(q6, names=names)

    for pull in ('tracks', 'topk'):
        eng = SedInferenceEngine(engine.model, engine.variables,
                                 AUDIO_16K, sample_duration=5,
                                 overlap=True, batch_size=8,
                                 pull_format=pull)
        eng.warmup_resident(11, q6.shape[1], q6.dtype, upload_threads=3)
        assert len(eng._resident_cache) == 1
        got = eng.predict_files_resident(paths, reader, names=names,
                                         upload_threads=3)
        # the timed pass reused the warm program — no second entry
        assert len(eng._resident_cache) == 1, pull
        assert got == want, pull

    # clips variant, ragged corpus smaller than both batch and threads:
    # warm and pass must agree on the chunk split (clamp by the UNPADDED
    # count) or the "warm" silently recompiles
    eng = SedInferenceEngine(engine.model, engine.variables, AUDIO_16K,
                             sample_duration=5, overlap=True,
                             batch_size=8, pull_format='topk')
    eng.warmup_resident(3, q6.shape[1], q6.dtype, upload_threads=4)
    assert len(eng._resident_cache) == 1
    got3 = eng.predict_clips_resident(q6[:3], names=names[:3],
                                      upload_threads=4)
    assert len(eng._resident_cache) == 1
    assert got3[0] == want[0][:3]


def test_predict_clips_chunking_matches_unchunked(engine):
    """The dispatch-ahead bound (chunked processing of huge inputs) must
    not change results."""
    rng = np.random.RandomState(41)
    wavs = rng.uniform(-0.3, 0.3,
                       (18, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    names = [f'c{i}.wav' for i in range(18)]
    want = engine.predict_clips(wavs, names=names)
    old = engine.dispatch_ahead_batches
    try:
        engine.dispatch_ahead_batches = 1     # chunk every batch
        got = engine.predict_clips(wavs, names=names)
    finally:
        engine.dispatch_ahead_batches = old
    assert got == want


def test_stream_unwinds_pipeline_on_consumer_error(engine):
    """A failure in the consuming stage (here: names too short) must not
    leave the reader/uploader threads parked on full queues — the
    pipeline unwinds and the engine stays usable."""
    import threading
    rng = np.random.RandomState(29)
    wavs = rng.uniform(-0.3, 0.3,
                       (24, AUDIO_16K.sample_rate * 5)).astype(np.float32)

    def chunks():
        for i in range(0, 24, engine.batch_size):
            yield wavs[i:i + engine.batch_size]

    before = threading.active_count()
    with pytest.raises(IndexError):
        engine.predict_clips_stream(chunks(), names=['only-one.wav'])
    # the finally-block joins both pipeline threads (2 s timeout each)
    assert threading.active_count() <= before + 1
    # engine still serves correctly afterwards
    ev, _ = engine.predict_clips_stream(
        chunks(), names=[f'c{i}.wav' for i in range(24)])
    want, _ = engine.predict_clips(wavs,
                                   names=[f'c{i}.wav' for i in range(24)])
    assert ev == want


def test_bulk_matches_per_file(engine):
    """predict_clips must agree with predict_waveform for 5 s clips."""
    rng = np.random.RandomState(3)
    wavs = rng.uniform(-0.3, 0.3,
                       (3, AUDIO_16K.sample_rate * 5)).astype(np.float32)
    per_clip, _ = engine.predict_clips(wavs, names=['a', 'b', 'c'])
    for i, name in enumerate(['a', 'b', 'c']):
        want = engine.predict_waveform(wavs[i], name)
        got = sorted(per_clip[i], key=lambda e: (e['onset'], e['event_label']))
        want = sorted(want, key=lambda e: (e['onset'], e['event_label']))
        assert got == want


# ---------------------------------------------------------------------------
# mu-law wire format
# ---------------------------------------------------------------------------

def test_mulaw_codec_properties():
    """G.711 codec invariants over ALL 65536 int16 codes: bounded
    quantization error (coarse at full scale, fine near zero), sign
    symmetry, wav round trip without transcode."""
    x = np.arange(-32768, 32768, dtype=np.int16)
    rec = audio_io.mulaw_decode(audio_io.mulaw_encode(x))
    ref = x.astype(np.float64) / 32768.0
    err = np.abs(rec - ref)
    assert err.max() < 0.031                    # half-step at top segment
    small = np.abs(ref) < 0.01
    assert err[small].max() < 3e-4              # fine near zero
    # monotone non-decreasing reconstruction
    assert np.all(np.diff(rec) >= 0)

    rng = np.random.RandomState(0)
    wav = rng.uniform(-0.9, 0.9, 16000).astype(np.float32)
    import tempfile, os as _os
    with tempfile.TemporaryDirectory() as d:
        p = _os.path.join(d, 'a.wav')
        audio_io.save_wav_mulaw(p, wav, 16000)
        codes, sr = audio_io.fast_read_wav_mulaw(p)
        assert sr == 16000 and codes.dtype == np.uint8
        np.testing.assert_array_equal(codes, audio_io.mulaw_encode(wav))
        # PCM fallback path encodes on read
        p2 = _os.path.join(d, 'b.wav')
        audio_io.save_wav(p2, wav, 16000)
        codes2, _ = audio_io.fast_read_wav_mulaw(p2)
        pcm = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
        np.testing.assert_array_equal(codes2, audio_io.mulaw_encode(pcm))


def test_mulaw_wire_framewise_and_events_match_int16(engine):
    """The 8-bit wire is lossy; on the bench distribution the framewise
    probabilities must stay close to the int16 path and the decoded
    events must match nearly one-for-one."""
    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools'))
    from bench_corpus import make_clips as make_test_clips
    clips = make_test_clips(8, AUDIO_16K.sample_rate, seconds=5, seed=3)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    codes = audio_io.mulaw_encode(pcm)

    f16, _ = engine.infer_framewise(pcm)
    f8, _ = engine.infer_framewise(codes)
    assert np.abs(f16 - f8).max() < 0.02

    ev16, _ = engine.predict_clips(pcm)
    ev8, _ = engine.predict_clips(codes)

    def flat(per_clip):
        return {(i, e['event_label'], round(e['onset'], 2),
                 round(e['offset'], 2))
                for i, evs in enumerate(per_clip) for e in evs}

    a, b = flat(ev16), flat(ev8)
    # allow boundary flutter: match by (clip, label) with |onset/offset|
    # within 0.05 s
    def matched(src, dst):
        hit = 0
        for (i, lb, on, off) in src:
            if any(i == j and lb == lb2 and abs(on - on2) <= 0.05
                   and abs(off - off2) <= 0.05
                   for (j, lb2, on2, off2) in dst):
                hit += 1
        return hit
    total = max(len(a), len(b), 1)
    assert matched(a, b) + matched(b, a) >= 2 * 0.9 * total, (a, b)


def test_q4_codec_properties():
    """Block-scaled 4-bit codec: bounded relative error per block, exact
    zeros, host/device decode agreement (incl. f16 bitcast endianness)."""
    import jax.numpy as jnp
    from sed_jax.serve.engine import SedInferenceEngine  # noqa: F401
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.8, 0.8, (3, 2048)).astype(np.float32)
    x[0, :256] = 0.0
    buf = audio_io.q4_encode(x)
    assert buf.shape == (3, audio_io.q4_bytes(2048))
    rec = audio_io.q4_decode_np(buf, 2048)
    # error bounded by half a quantization step of the STORED (f16)
    # per-block scale, plus the clip slack from f16 rounding the scale
    blocks = x.reshape(3, -1, audio_io.Q4_BLOCK)
    step = buf[:, 2048 // 2:].view(np.float16).astype(np.float32)
    err = np.abs(rec.reshape(blocks.shape) - blocks)
    assert np.all(err <= step[:, :, None] * 0.505 + 1e-6)
    np.testing.assert_array_equal(rec[0, :256], 0.0)
    # int16 input accepted: reconstruction obeys the same step bound
    # against the original signal (scales differ by the PCM rounding)
    buf2 = audio_io.q4_encode((x * 32767).astype(np.int16))
    rec2 = audio_io.q4_decode_np(buf2, 2048).reshape(blocks.shape)
    step2 = buf2[:, 2048 // 2:].view(np.float16).astype(np.float32)
    assert np.all(np.abs(rec2 - blocks) <= step2[:, :, None] * 0.51
                  + 1e-4)


def test_qn_codec_properties():
    """Generalized N-bit block-scaled codec: roundtrip error bound per
    bit width, monotone quality, legacy q4 nibble layout preserved, and
    .qN container roundtrip."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-0.8, 0.8, (2, 2048)).astype(np.float32)
    prev_err = np.inf
    for bits in audio_io.QN_BITS:
        buf = audio_io.qn_encode(x, bits)
        assert buf.shape == (2, audio_io.qn_bytes(2048, bits))
        rec = audio_io.qn_decode_np(buf, 2048, bits)
        nb = 2048 * bits // 8
        step = buf[:, nb:].view(np.float16).astype(np.float32)
        blocks = x.reshape(2, -1, audio_io.Q4_BLOCK)
        err = np.abs(rec.reshape(blocks.shape) - blocks)
        assert np.all(err <= step[:, :, None] * 0.505 + 1e-6), bits
        # each extra bit halves the step -> error strictly improves
        assert err.max() < prev_err
        prev_err = err.max()
    # legacy q4 wire layout: high nibble first
    buf4 = audio_io.qn_encode(x, 4)
    top = 7
    scale = np.maximum(np.abs(blocks).max(axis=2) / top,
                       1e-6).astype(np.float16).astype(np.float32)
    q = np.clip(np.round(blocks / scale[:, :, None]), -8, 7) + 8
    q = q.astype(np.int64).reshape(2, 2048)
    want = ((q[:, 0::2] << 4) | q[:, 1::2]).astype(np.uint8)
    np.testing.assert_array_equal(buf4[:, :1024], want)

    import tempfile, os as _os
    with tempfile.TemporaryDirectory() as d:
        for bits in audio_io.QN_BITS:
            p = _os.path.join(d, f'a.q{bits}')
            audio_io.save_qn(p, x[0], 16000, bits)
            codes, sr, samples = audio_io.read_qn(p)
            assert (sr, samples) == (16000, 2048)
            np.testing.assert_array_equal(
                codes, audio_io.qn_encode(x[:1], bits)[0])


def test_qn_device_decode_matches_host(engine):
    """On-device q5/q6 decode equals the numpy reference; q6 framewise
    outputs track int16 at least as closely as mu-law does."""
    import jax.numpy as jnp
    s = engine.window_samples
    rng = np.random.RandomState(23)
    x = rng.uniform(-0.6, 0.6, (2, s)).astype(np.float32)
    for bits in (5, 6):
        buf = audio_io.qn_encode(x, bits)
        dec = np.asarray(engine._prep(jnp.asarray(buf)))
        np.testing.assert_allclose(dec, audio_io.qn_decode_np(buf, s, bits),
                                   rtol=1e-6, atol=1e-7)

    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools'))
    from bench_corpus import make_clips as make_test_clips
    clips = make_test_clips(6, AUDIO_16K.sample_rate, seconds=5, seed=9)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)
    f16, _ = engine.infer_framewise(pcm)
    fq6, _ = engine.infer_framewise(audio_io.qn_encode(clips, 6))
    fmu, _ = engine.infer_framewise(audio_io.mulaw_encode(clips))
    dq6 = np.abs(f16 - fq6).max()
    dmu = np.abs(f16 - fmu).max()
    assert dq6 < max(2 * dmu, 0.02), (dq6, dmu)


def test_q4_device_decode_matches_host(engine):
    """The engine's on-device q4 decode equals the numpy reference and
    the framewise outputs track the f32 path."""
    import jax.numpy as jnp
    s = engine.window_samples
    rng = np.random.RandomState(5)
    x = rng.uniform(-0.6, 0.6, (2, s)).astype(np.float32)
    buf = audio_io.q4_encode(x)
    dec = np.asarray(engine._prep(jnp.asarray(buf)))
    np.testing.assert_allclose(dec, audio_io.q4_decode_np(buf, s),
                               rtol=1e-6, atol=1e-7)

    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools'))
    from bench_corpus import make_clips as make_test_clips
    clips = make_test_clips(6, AUDIO_16K.sample_rate, seconds=5, seed=9)
    f32, _ = engine.infer_framewise(clips)
    fq4, _ = engine.infer_framewise(audio_io.q4_encode(clips))
    assert np.abs(f32 - fq4).max() < 0.08       # lossy but close
    ev, _ = engine.predict_clips(audio_io.q4_encode(clips))
    assert len(ev) == 6


def test_bf16_serving_events_match_f32():
    """bf16 conv-stack serving must decode (near-)identical events to
    f32 on the bench distribution with the TRAINED bench checkpoint —
    the precondition for ever serving in bf16."""
    import jax.numpy as jnp
    import sys as _sys, os as _os
    _sys.path.insert(0, _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools'))
    from bench_corpus import make_clips as make_test_clips
    from sed_jax.utils.npz_ckpt import load_variables_npz

    ckpt = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), 'tools', 'bench_checkpoint.npz')
    if not _os.path.exists(ckpt):
        pytest.skip('bench checkpoint not present')
    variables = load_variables_npz(ckpt)
    cfg = AUDIO_16K
    clips = make_test_clips(8, cfg.sample_rate, seconds=5, seed=5)
    pcm = (np.clip(clips, -1, 1) * 32767).astype(np.int16)

    engines = {}
    for tag, dtype in (('f32', None), ('bf16', jnp.bfloat16)):
        model = get_model('Cnn_9layers_Gru_FrameAtt', cfg,
                          compute_dtype=dtype)
        engines[tag] = SedInferenceEngine(model, variables, cfg,
                                          sample_duration=5,
                                          overlap=True, batch_size=8)

    fa, _ = engines['f32'].infer_framewise(pcm)
    fb, _ = engines['bf16'].infer_framewise(pcm)
    assert np.abs(fa - fb).max() < 0.05

    ea, _ = engines['f32'].predict_clips(pcm)
    eb, _ = engines['bf16'].predict_clips(pcm)

    def flat(per_clip):
        return {(i, e['event_label'], round(e['onset'], 2),
                 round(e['offset'], 2))
                for i, evs in enumerate(per_clip) for e in evs}

    a, b = flat(ea), flat(eb)

    def matched(src, dst):
        hit = 0
        for (i, lb, on, off) in src:
            if any(i == j and lb == lb2 and abs(on - on2) <= 0.05
                   and abs(off - off2) <= 0.05
                   for (j, lb2, on2, off2) in dst):
                hit += 1
        return hit

    total = max(len(a), len(b), 1)
    assert len(a) > 0                     # trained model finds events
    assert matched(a, b) + matched(b, a) >= 2 * 0.9 * total, (a, b)


def test_measure_forward_ms_returns_sane_reading(engine):
    """The chained-forward timing must return a finite positive ms/iter
    on any backend."""
    ms = engine.measure_forward_ms(iters=3)
    assert np.isfinite(ms) and ms >= 0.0
    # sanity: a batch-8 forward cannot take a minute per iteration
    assert ms < 60_000


def test_upload_deadline_aborts_collapsed_pass_engine_stays_usable(
        engine, tmp_path):
    """Injected-slowdown test: when an upload
    thread stalls past ``upload_deadline_s``, predict_files_resident
    must raise LinkCollapseError promptly, and the engine must serve
    the SAME files correctly on the retry."""
    import time as _time
    from sed_jax.serve.engine import LinkCollapseError

    rng = np.random.RandomState(0)
    sr = AUDIO_16K.sample_rate
    clips = rng.uniform(-0.3, 0.3, (8, sr * 5)).astype(np.float32)
    paths = []
    for i in range(8):
        p = tmp_path / f'c{i}.wav'
        audio_io.save_wav(str(p), clips[i], sr)
        paths.append(str(p))
    read = lambda p: audio_io.fast_read_wav_int16(p)[0]   # noqa: E731
    names = [f'c{i}.wav' for i in range(8)]

    baseline, _ = engine.predict_files_resident(paths, read, names=names,
                                                upload_threads=2)

    real_put = jax.device_put
    stall = {'on': True}

    def slow_put(x, *a, **kw):
        if stall['on'] and getattr(x, 'nbytes', 0) > 1000:
            _time.sleep(3.0)        # a stalled upload
        return real_put(x, *a, **kw)

    t0 = _time.time()
    try:
        jax.device_put = slow_put
        with pytest.raises(LinkCollapseError):
            engine.predict_files_resident(paths, read, names=names,
                                          upload_threads=2,
                                          upload_deadline_s=0.5)
        aborted_after = _time.time() - t0
    finally:
        jax.device_put = real_put
        stall['on'] = False
    # the abort must be prompt (deadline + epsilon, not the stall time)
    assert aborted_after < 2.5
    # the engine is fully usable afterwards and exact
    retry, _ = engine.predict_files_resident(paths, read, names=names,
                                             upload_threads=2)
    assert retry == baseline


def test_materialize_with_deadline_aborts_stalled_pull():
    """device_put can return before the bytes are on the device, so a
    stall surfaces in the blocking result pull — the deadline must
    bound that too."""
    import time as _time
    from sed_jax.serve.engine import (LinkCollapseError,
                                      SedInferenceEngine)

    class _Stalled:
        def __array__(self, dtype=None, copy=None):
            _time.sleep(3.0)
            return np.zeros(3)

    tel = {}
    t0 = _time.time()
    with pytest.raises(LinkCollapseError):
        SedInferenceEngine._materialize_with_deadline(
            _Stalled(), _time.time() + 0.3, 0.3, tel, t0)
    assert _time.time() - t0 < 2.0          # prompt, not the stall time
    assert tel.get('aborted') == 1

    class _Fast:
        def __array__(self, dtype=None, copy=None):
            return np.arange(4)

    out = SedInferenceEngine._materialize_with_deadline(
        _Fast(), _time.time() + 5.0, 5.0, None, _time.time())
    assert list(out) == [0, 1, 2, 3]
