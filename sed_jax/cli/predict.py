"""Production prediction CLI: audio files -> event XML
(``pytorch/predict.py:681-733``).

``predict``: every file in ``--input_dir`` is decoded (ffmpeg fallback
for non-wav), sliding-window inferred with framewise-averaged merging,
event-decoded, and written as ``<workspace>/predict_results/<name>.xml``.
``predict_asr`` additionally transcribes detected speech segments when a
speech-recognition backend is installed (optional dependency).
"""

from __future__ import annotations

import argparse
import os
import time

from sed_jax.utils import compile_cache
from sed_jax.cli import common
from sed_jax.config import PREDICT_SED_PARAMS, SPEECH_LABELS


def _build_engine(args, cfg, ws):
    from sed_jax.serve.engine import SedInferenceEngine
    model, variables = common.build_model_and_variables(
        args, cfg, ws, checkpoint=args.checkpoint)
    sed_params = common.load_sed_params(args, cfg, ws, PREDICT_SED_PARAMS)
    return SedInferenceEngine(
        model, variables, cfg, sample_duration=args.sample_duration,
        overlap=args.overlap, overlap_value=args.overlap_value,
        sed_params=sed_params, batch_size=args.batch_size,
        launch_group=getattr(args, 'launch_group', 2),
        pull_format=getattr(args, 'pull_format', None))


def _write_xml_for(out_dir, name, events, engine, duration):
    """XML with the reference's fallback-"Others" span for one file
    (same math as ``SedInferenceEngine.predict_file``)."""
    from sed_jax.post.xml_writer import events_to_xml
    from sed_jax.serve.engine import window_starts
    starts = window_starts(duration, engine.sample_duration, engine.overlap)
    last_start = starts[-1] + (1 if engine.overlap
                               else engine.sample_duration)
    end = min(duration, last_start + engine.sample_duration)
    xml = events_to_xml(sorted(events, key=lambda e: e['onset']), name,
                        fallback_span=(last_start, end))
    stem = os.path.splitext(name)[0]
    with open(os.path.join(out_dir, stem + '.xml'), 'w') as f:
        f.write(xml)


def _predict_bulk(args, engine, out_dir, audio_files):
    """Batch the windows of ``--bulk`` files into shared fixed-shape
    forwards (engine.predict_waveforms) instead of one forward per file
    — same events/XML, far fewer device launches."""
    from sed_jax.data import audio_io
    group = max(1, args.bulk)
    for g0 in range(0, len(audio_files), group):
        chunk = audio_files[g0:g0 + group]
        t0 = time.time()
        waves, names, durations = [], [], {}
        for path in chunk:
            audio, _ = audio_io.load_audio(path, sr=engine.cfg.sample_rate)
            name = os.path.basename(path)
            waves.append(audio)
            names.append(name)
            durations[name] = len(audio) / float(engine.cfg.sample_rate)
        events = engine.predict_waveforms(waves, names)
        per_file = {n: [] for n in names}
        for e in events:
            per_file[e['filename']].append(e)
        for name in names:
            _write_xml_for(out_dir, name, per_file[name], engine,
                           durations[name])
        print('Processed {} files in {:.2f} s'.format(
            len(chunk), time.time() - t0))
    return audio_files


def _predict_resident(args, engine, out_dir, audio_files):
    """Serve a UNIFORM fixed-length clip corpus via the engine's
    resident path (one bulk upload + one launch + one pull per pass).
    Clips must all
    decode to ``--sample_duration`` seconds in the same wire format
    (int16/mu-law wav or .qN container, sniffed from the first file)."""
    from sed_jax.data import audio_io
    if not audio_files:
        print('No audio files in --input_dir; nothing to do.')
        return audio_files
    if args.max_pass_clips < 0:
        raise SystemExit('--max_pass_clips must be >= 0 '
                         '(0 = whole corpus in one pass)')
    reader = audio_io.wire_reader_for(audio_files[0])
    names = [os.path.basename(p) for p in audio_files]
    t0 = time.time()
    telemetry = {}
    events, xmls = engine.predict_files_resident(
        audio_files, reader, names=names,
        upload_threads=args.upload_threads,
        max_pass_clips=args.max_pass_clips or None,
        launch_chunks=getattr(args, 'launch_chunks', 1),
        telemetry=telemetry)
    for name, xml in zip(names, xmls):
        with open(os.path.join(out_dir,
                               os.path.splitext(name)[0] + '.xml'),
                  'w') as f:
            f.write(xml)
    n_events = sum(len(e) for e in events)
    print('Processed {} clips in {:.2f} s ({} events); telemetry: {}'
          .format(len(audio_files), time.time() - t0, n_events,
                  telemetry))
    return audio_files


def predict(args):
    cfg, ws = common.resolve(args)
    engine = _build_engine(args, cfg, ws)
    out_dir = ws.predict_results_dir(create=True)

    audio_files = sorted(
        os.path.join(args.input_dir, f)
        for f in os.listdir(args.input_dir)
        if not f.startswith('.'))
    if getattr(args, 'resident', False):
        return _predict_resident(args, engine, out_dir, audio_files)
    if getattr(args, 'bulk', 0):
        return _predict_bulk(args, engine, out_dir, audio_files)
    for path in audio_files:
        print('Predicting on {}'.format(path))
        t0 = time.time()
        events, xml = engine.predict_file(path)
        for event in events:
            print('onset: {}, offset: {}, event_label: {}\n'.format(
                event['onset'], event['offset'], event['event_label']))
        name = os.path.basename(path)
        stem = os.path.splitext(name)[0]
        out_path = os.path.join(out_dir, stem + '.xml')
        with open(out_path, 'w') as f:
            f.write(xml)
        print('Time taken to process {}: {} s\n'.format(
            path, time.time() - t0))
    return audio_files


def predict_asr(args):
    """predict + ASR transcription of speech segments
    (``pytorch/predict.py:410-677``).  Requires the optional
    ``speech_recognition`` package and ffmpeg; events in speech classes
    get a ``text=`` attribute in the XML."""
    try:
        import speech_recognition as sr  # optional dependency
    except ImportError as exc:
        raise SystemExit(
            'predict_asr requires the optional speech_recognition '
            'package: ' + str(exc))
    import subprocess
    import tempfile

    cfg, ws = common.resolve(args)
    engine = _build_engine(args, cfg, ws)
    out_dir = ws.predict_results_dir(create=True)
    recognizer = sr.Recognizer()

    audio_files = sorted(
        os.path.join(args.input_dir, f)
        for f in os.listdir(args.input_dir)
        if not f.startswith('.'))
    for path in audio_files:
        events, _ = engine.predict_file(path)
        for event in events:
            if event['event_label'] in SPEECH_LABELS:
                with tempfile.NamedTemporaryFile(suffix='.wav') as tmp:
                    subprocess.run(
                        ['ffmpeg', '-y', '-i', path,
                         '-ss', str(event['onset']),
                         '-to', str(event['offset']),
                         '-ar', '16000', tmp.name],
                        check=True, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                    try:
                        with sr.AudioFile(tmp.name) as source:
                            audio_data = recognizer.record(source)
                        event['text'] = recognizer.recognize_google(
                            audio_data, language=args.asr_language)
                    except (sr.UnknownValueError, sr.RequestError):
                        pass
        from sed_jax.post.xml_writer import events_to_xml
        name = os.path.basename(path)
        stem = os.path.splitext(name)[0]
        xml = events_to_xml(events, name)
        with open(os.path.join(out_dir, stem + '.xml'), 'w') as f:
            f.write(xml)
    return audio_files


def get_parser():
    parser = argparse.ArgumentParser(description='sed_jax predict')
    subparsers = parser.add_subparsers(dest='mode', required=True)
    for mode in ('predict', 'predict_asr'):
        sub = subparsers.add_parser(mode)
        common.add_common_args(sub, require_dataset=False)
        sub.add_argument('--input_dir', type=str, required=True)
        sub.add_argument('--overlap', action='store_true', default=False)
        sub.add_argument('--sample_duration', type=int, default=5)
        sub.add_argument('--overlap_value', type=float, default=1.0)
        sub.add_argument('--checkpoint', type=str, default=None,
                         help='train .npz or reference .pth; defaults to '
                              'the workspace convention path.')
        if mode == 'predict':
            sub.add_argument('--bulk', type=int, default=0,
                             help='batch the windows of this many files '
                                  'into shared device forwards (0 = the '
                                  'reference\'s one-file-at-a-time loop)')
            sub.add_argument('--launch_group', type=int, default=2,
                             help='fuse this many batches per device '
                                  'launch in streaming APIs (amortizes '
                                  'the per-launch cost)')
            sub.add_argument('--pull_format', type=str, default=None,
                             choices=['tracks', 'full', 'topk'],
                             help='what streaming inference pulls '
                                  "off-device per batch (default 'topk', "
                                  'the fewest bytes; see '
                                  'SedInferenceEngine docs)')
            sub.add_argument('--resident', action='store_true',
                             default=False,
                             help='serve a UNIFORM fixed-length clip '
                                  'corpus via the resident path (one '
                                  'bulk upload + one launch + one pull '
                                  'per pass; all files must be '
                                  '--sample_duration clips in one wire '
                                  'format)')
            sub.add_argument('--upload_threads', type=int, default=4,
                             help='concurrent device_put streams for '
                                  '--resident uploads')
            sub.add_argument('--launch_chunks', type=int, default=1,
                             help='split each --resident pass into m '
                                  'concurrently dispatched upload+launch'
                                  '+pull chunks so transfer overlaps '
                                  'device compute (exact)')
            sub.add_argument('--max_pass_clips', type=int, default=0,
                             help='bound device memory for --resident: '
                                  'serve at most this many clips per '
                                  'resident pass (0 = whole corpus in '
                                  'one pass)')
        if mode == 'predict_asr':
            sub.add_argument('--asr_language', type=str, default='en-SG')
    return parser


def main(argv=None):
    args = get_parser().parse_args(argv)
    compile_cache.enable()
    if args.mode == 'predict':
        predict(args)
    else:
        predict_asr(args)


if __name__ == '__main__':
    main()
