"""Offline test for the AudioSet downloader
(``sed_jax/data/download.py``, reference ``download_audioset.py:1-50``):
stubbed yt-dlp/ffmpeg pin the command plumbing — URL resolution, the
ffmpeg crop args (-ss/-t/-ar/-ac), skip-existing, and the
one-bad-clip-must-not-abort policy — without network."""

import subprocess
import types

import numpy as np

from sed_jax.data import download


def test_download_audioset_stubbed(tmp_path, monkeypatch):
    csv_path = tmp_path / 'segments.csv'
    csv_path.write_text(
        '# header\n'
        'goodclip1,3.000,13.000,"Speech",/m/x\n'
        'badclip00,0.000,10.000,"Siren",/m/y\n'
        'goodclip2,7.000,17.000,"Train",/m/z\n')
    out_dir = tmp_path / 'wavs'
    # pre-existing file: must be skipped without invoking any tool
    out_dir.mkdir()
    (out_dir / 'goodclip2_7.wav').write_bytes(b'RIFF')

    monkeypatch.setattr(download.shutil, 'which', lambda t: f'/usr/bin/{t}')
    calls = []

    def fake_run(argv, **kw):
        calls.append(argv)
        if argv[0] == 'yt-dlp':
            ytid = argv[-1].split('v=')[1]
            if ytid == 'badclip00':
                raise subprocess.CalledProcessError(1, argv)
            return types.SimpleNamespace(
                stdout=f'https://cdn/{ytid}.m4a\n', returncode=0)
        assert argv[0] == 'ffmpeg'
        open(argv[-1], 'wb').write(b'RIFF')
        return types.SimpleNamespace(returncode=0)

    monkeypatch.setattr(download.subprocess, 'run', fake_run)
    counts = download.download_audioset(str(csv_path), str(out_dir),
                                        sample_rate=16000, duration=10.0)
    assert counts == {'downloaded': 1, 'failed': 1}

    # the good clip resolved then cropped with the csv's start offset
    resolve = [c for c in calls if c[0] == 'yt-dlp']
    crops = [c for c in calls if c[0] == 'ffmpeg']
    assert len(resolve) == 2 and len(crops) == 1
    argv = crops[0]
    assert argv[argv.index('-ss') + 1] == '3.0'
    assert argv[argv.index('-t') + 1] == '10.0'
    assert argv[argv.index('-ar') + 1] == '16000'
    assert argv[argv.index('-ac') + 1] == '1'
    assert argv[argv.index('-i') + 1] == 'https://cdn/goodclip1.m4a'
    assert (out_dir / 'goodclip1_3.wav').exists()
    # pre-existing clip untouched, never re-resolved
    assert all('goodclip2' not in c[-1] for c in resolve)


def test_download_audioset_requires_tools(tmp_path, monkeypatch):
    monkeypatch.setattr(download.shutil, 'which', lambda t: None)
    csv_path = tmp_path / 's.csv'
    csv_path.write_text('a,0.0,10.0,"x",/m/x\n')
    try:
        download.download_audioset(str(csv_path), str(tmp_path / 'o'))
        assert False, 'expected RuntimeError'
    except RuntimeError as e:
        assert 'ffmpeg' in str(e)
