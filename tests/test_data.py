"""Data pipeline tests: CSV parsing, targets, HDF5 pack, samplers, loader."""

import os

import h5py
import numpy as np
import pytest

from sed_jax.config import AUDIO_16K, CLASSES_NUM, LABELS
from sed_jax.data import audio_io, metadata
from sed_jax.data.dataset import (AudiosetDataset, DataLoader, TestSampler,
                                  TrainSampler, collate_fn, cycle_iteration,
                                  shard_for_host)
from sed_jax.data.hdf5_pack import (float32_to_int16, int16_to_float32,
                                    hdf5_filename, pack_audio_files_to_hdf5)


def test_weak_csv_formats(tmp_path):
    p = tmp_path / 'training_set.csv'
    p.write_text('-5QrBL6MzLg,60.000,70.000,"Applause,Siren",/m/x\n'
                 'abc,30.000,40.000,Cough,/m/y\n')
    metas = metadata.read_weak_csv(str(p), 'training')
    assert metas[0]['audio_name'] == '-5QrBL6MzLg_60.wav'
    assert metas[0]['labels'] == ['Applause', 'Siren']
    assert metas[1]['audio_name'] == 'abc_30.wav'

    # evaluation format: tab-separated, one label per row, merged
    q = tmp_path / 'eval.csv'
    q.write_text('a.wav\t30.0\t40.0\tApplause\na.wav\t30.0\t40.0\tSiren\n')
    metas = metadata.read_weak_csv(str(q), 'evaluation')
    assert len(metas) == 1
    assert metas[0]['labels'] == ['Applause', 'Siren']


def test_strong_csv_and_targets(tmp_path):
    p = tmp_path / 'strong.csv'
    p.write_text('a.wav,0.917,2.029,Applause\na.wav,4.0,7.0,Siren\n')
    meta = metadata.read_strong_csv(str(p))
    assert len(meta['a.wav']) == 2
    tgt = metadata.get_strong_target('a.wav', meta, 1000, 100)
    assert tgt.shape == (1000, CLASSES_NUM)
    k = LABELS.index('Applause')
    # bgn = round(0.917*100) = 92, end = round(2.029*100)+1 = 204
    assert tgt[92, k] and tgt[203, k]
    assert not tgt[91, k] and not tgt[204, k]

    weak = metadata.get_weak_target(['Cough', 'Siren'])
    assert weak.sum() == 2 and weak[LABELS.index('Cough')]


def test_int16_roundtrip():
    x = np.asarray([0.0, 0.5, -0.25, 1.5])  # over-range triggers peak norm
    q = float32_to_int16(x.copy())
    back = int16_to_float32(q)
    assert np.abs(back).max() <= 1.0
    np.testing.assert_allclose(back, x / 1.5, atol=1e-4)


@pytest.fixture
def packed(tmp_path):
    cfg = AUDIO_16K
    audios = tmp_path / 'audios'
    audios.mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i in range(4):
        name = f'clip{i}_0.wav'
        audio_io.save_wav(str(audios / name),
                          rng.uniform(-0.4, 0.4, cfg.sample_rate * 10),
                          cfg.sample_rate)
        names.append(name)
    csv_path = tmp_path / 'strong_training_set.csv'
    csv_path.write_text(''.join(
        f'clip{i},0.0,10.0,Applause,/m/x\n' for i in range(4)))
    strong_path = tmp_path / 'strong_meta.csv'
    strong_path.write_text(''.join(
        f'clip{i}_0.wav,1.0,3.0,Applause\n' for i in range(4)))
    out = str(tmp_path / hdf5_filename('strong_training', 'logmel', '16k'))
    pack_audio_files_to_hdf5(str(audios), str(csv_path), out,
                             'strong_training', cfg,
                             strong_csv_path=str(strong_path))
    return out, cfg


def test_pack_schema(packed):
    out, cfg = packed
    with h5py.File(out, 'r') as hf:
        assert hf['waveform'].shape == (4, cfg.audio_samples)
        assert hf['waveform'].dtype == np.int16
        assert hf['target'].shape == (4, CLASSES_NUM)
        assert hf['strong_target'].shape == (4, 1000, CLASSES_NUM)
        assert hf['audio_name'][0] == b'clip0_0.wav'
        k = LABELS.index('Applause')
        assert hf['target'][0][k]
        assert hf['strong_target'][0][100, k]
        assert not hf['strong_target'][0][99, k]


def test_dataset_and_samplers(packed):
    out, cfg = packed
    ds = AudiosetDataset()
    item = ds[{'hdf5_path': out, 'index_in_hdf5': 1}]
    assert item['audio_name'] == 'clip1_0.wav'
    assert item['waveform'].dtype == np.float32
    assert item['waveform'].shape == (cfg.audio_samples,)

    # seeded train sampler is deterministic
    s1 = list(zip(range(3), TrainSampler(out, 2)))
    s2 = list(zip(range(3), TrainSampler(out, 2)))
    for (_, a), (_, b) in zip(s1, s2):
        assert a == b

    # test sampler covers everything once
    seen = [m['index_in_hdf5'] for batch in TestSampler(out, 3)
            for m in batch]
    assert sorted(seen) == [0, 1, 2, 3]
    ds.close()


def test_loader_prefetch_and_cycle(packed):
    out, cfg = packed
    ds = AudiosetDataset()
    loader = DataLoader(ds, TestSampler(out, 2))
    batches = list(loader)
    assert len(batches) == 2
    assert batches[0]['waveform'].shape == (2, cfg.audio_samples)
    assert batches[0]['strong_target'].shape == (2, 1000, CLASSES_NUM)

    it = cycle_iteration(DataLoader(ds, TestSampler(out, 4)))
    a = next(it)
    b = next(it)  # cycles back
    assert a['waveform'].shape == b['waveform'].shape
    ds.close()


def test_shard_for_host():
    batch = {'x': np.arange(8)}
    out = shard_for_host(batch, process_index=1, process_count=2)
    np.testing.assert_array_equal(out['x'], [4, 5, 6, 7])


def test_multiworker_loader_matches_single_and_int16(packed):
    """num_workers>1 must yield IDENTICAL batches in sampler order;
    dequantize=False ships int16 waveforms unchanged."""
    out, cfg = packed
    ds = AudiosetDataset()
    single = list(DataLoader(ds, TestSampler(out, 2)))
    multi = list(DataLoader(ds, TestSampler(out, 2), num_workers=3))
    assert len(single) == len(multi)
    for a, b in zip(single, multi):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    # infinite sampler: multi-worker stream stays ordered + deterministic
    it1 = iter(DataLoader(ds, TrainSampler(out, 2), num_workers=3))
    it2 = iter(DataLoader(ds, TrainSampler(out, 2)))
    for _ in range(6):
        a, b = next(it1), next(it2)
        np.testing.assert_array_equal(a['waveform'], b['waveform'])

    ds16 = AudiosetDataset(dequantize=False)
    item = ds16[{'hdf5_path': out, 'index_in_hdf5': 0}]
    assert item['waveform'].dtype == np.int16
    ds.close()
    ds16.close()


def test_multiworker_loader_surfaces_errors(packed):
    out, _ = packed
    ds = AudiosetDataset()
    bad = [[{'hdf5_path': out, 'index_in_hdf5': 0}],
           [{'hdf5_path': out, 'index_in_hdf5': 999}]]  # out of range
    loader = DataLoader(ds, bad, num_workers=2)
    with pytest.raises(Exception):
        list(loader)
    ds.close()


def test_multiworker_loader_surfaces_sampler_errors(packed):
    """An exception raised by the SAMPLER itself (e.g. a mis-divisible
    multi-host batch assert) must reach the consumer, in stream order —
    not silently end the stream."""
    out, _ = packed

    def sampler():
        yield [{'hdf5_path': out, 'index_in_hdf5': 0}]
        yield [{'hdf5_path': out, 'index_in_hdf5': 1}]
        raise RuntimeError('sampler blew up')

    ds = AudiosetDataset()
    got = []
    with pytest.raises(RuntimeError, match='sampler blew up'):
        for batch in DataLoader(ds, sampler(), num_workers=2):
            got.append(batch)
    assert len(got) == 2      # every good batch arrived first
    ds.close()


def test_singleworker_loader_stops_when_abandoned(packed):
    """Abandoning a single-worker loader iterator must stop its producer
    thread instead of leaving it parked on the full prefetch queue."""
    import gc
    import time
    out, _ = packed
    drawn = [0]

    def sampler():
        while True:
            drawn[0] += 1
            yield [{'hdf5_path': out, 'index_in_hdf5': 0}]

    ds = AudiosetDataset()
    it = iter(DataLoader(ds, sampler(), prefetch=2))
    next(it)
    it.close()
    gc.collect()
    time.sleep(0.6)
    n = drawn[0]
    time.sleep(0.6)
    assert drawn[0] == n          # producer stopped drawing
    ds.close()


def test_fast_wav_reader_noncanonical_chunk_layouts(tmp_path):
    """Extra chunks before fmt parse fine; data-before-fmt falls back to
    the general reader's clear ValueError instead of crashing on
    int(None)."""
    import struct
    import pytest as _pytest
    from sed_jax.data import audio_io
    pcm = (np.arange(16) * 100).astype(np.int16)
    data = pcm.tobytes()
    fmt = struct.pack('<HHIIHH', 1, 1, 8000, 16000, 2, 16)

    def riff(body):
        return b'RIFF' + struct.pack('<I', 4 + len(body)) + b'WAVE' + body

    # LIST chunk ahead of fmt: canonical enough for the fast path
    extra = b'LIST' + struct.pack('<I', 4) + b'INFO'
    p1 = tmp_path / 'list_first.wav'
    p1.write_bytes(riff(extra + b'fmt ' + struct.pack('<I', len(fmt))
                        + fmt + b'data' + struct.pack('<I', len(data))
                        + data))
    x, sr = audio_io.fast_read_wav_int16(str(p1))
    assert sr == 8000
    np.testing.assert_array_equal(x, pcm)

    # data before fmt: both readers reject; must be a clean ValueError
    p2 = tmp_path / 'data_first.wav'
    p2.write_bytes(riff(b'data' + struct.pack('<I', len(data)) + data
                        + b'fmt ' + struct.pack('<I', len(fmt)) + fmt))
    with _pytest.raises(ValueError):
        audio_io.fast_read_wav_int16(str(p2))


def test_dataset_handles_do_not_accumulate_across_iterations(packed):
    """Re-iterating a multi-worker loader spawns fresh threads; dead
    threads' HDF5 handles must be released (via thread-local GC), not
    cached forever keyed by thread ident."""
    import gc
    out, _ = packed
    ds = AudiosetDataset()
    for _ in range(8):
        list(DataLoader(ds, TestSampler(out, 2), num_workers=2))
    gc.collect()
    live = [r for r in ds._all if r() is not None and r().id]
    # main thread + at most the last iteration's 2 workers
    assert len(live) <= 3, len(live)
    ds.close()
    assert not any(r() is not None and r().id for r in ds._all)


def test_train_step_accepts_int16_waveforms():
    """The jitted step dequantizes int16 batches on device with results
    identical to pre-converted float batches."""
    import jax
    import jax.numpy as jnp
    from sed_jax import losses
    from sed_jax.models.registry import get_model
    from sed_jax.train.state import create_train_state
    from sed_jax.train.step import make_train_step
    from sed_jax.data.hdf5_pack import int16_to_float32

    cfg = AUDIO_16K
    model = get_model('Cnn_9layers_FrameAvg', cfg)
    rng = np.random.RandomState(0)
    wav16 = rng.randint(-2000, 2000, (2, cfg.sample_rate)).astype(np.int16)
    weak = {'waveform': wav16,
            'target': (rng.rand(2, CLASSES_NUM) > 0.8).astype(np.float32)}
    strong = {'waveform': wav16.copy(),
              'strong_target': (rng.rand(2, 100, CLASSES_NUM) > 0.9)
              .astype(np.float32)}
    state = create_train_state(model, jax.random.PRNGKey(0),
                               jnp.asarray(int16_to_float32(wav16)))
    step = make_train_step(model, losses.clip_bce, losses.frame_bce,
                           mixup=False, timeshift=False, spec_augment=False,
                           donate=False)
    _, m16 = step(state, weak, [strong], jax.random.PRNGKey(1))

    weak_f = dict(weak, waveform=int16_to_float32(wav16))
    strong_f = dict(strong, waveform=int16_to_float32(wav16))
    _, mf = step(state, weak_f, [strong_f], jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(m16['loss']), float(mf['loss']),
                               rtol=1e-6)


def test_get_batch_hyperslab_matches_per_item(tmp_path):
    """The one-fancy-read-per-dataset batch fetch must be byte-identical
    to the per-item path, including duplicate indices (a mid-batch
    TrainSampler reshuffle can repeat one) and unsorted order."""
    import h5py
    from sed_jax.data.dataset import (AudiosetDataset, DataLoader,
                                      TestSampler, collate_fn)
    path = str(tmp_path / 'weak_training_logmel_16k.h5')
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w') as hf:
        hf.create_dataset('audio_name',
                          data=[f'c{i}.wav'.encode() for i in range(16)])
        hf.create_dataset('waveform',
                          data=rng.randint(-3000, 3000, (16, 256), np.int16))
        hf.create_dataset('target', data=rng.rand(16, 25) > 0.8)
        hf.create_dataset('strong_target',
                          data=rng.rand(16, 50, 25) > 0.9)
    for dequantize in (True, False):
        ds = AudiosetDataset(dequantize=dequantize)
        metas = [{'hdf5_path': path, 'index_in_hdf5': i}
                 for i in [7, 2, 2, 11, 0, 15, 7]]      # dups + unsorted
        got = ds.get_batch(metas)
        want = collate_fn([ds[m] for m in metas])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
        # the loader routes default-collate batches through get_batch
        loader = DataLoader(ds, TestSampler(path, 5))
        assert loader._fetch == ds.get_batch
        batches = list(loader)
        assert sum(b['waveform'].shape[0] for b in batches) == 16
        ds.close()


def test_stack_rows_matches_np_stack():
    """audio_io.stack_rows is the hot-path replacement for np.stack
    (it avoids the intermediate copies of NumPy's multi-array path) —
    must be value- and dtype-identical."""
    rng = np.random.RandomState(0)
    for dtype in (np.int16, np.uint8, np.float32):
        rows = [rng.randint(0, 100, 37).astype(dtype) for _ in range(5)]
        got = audio_io.stack_rows(rows)
        np.testing.assert_array_equal(got, np.stack(rows))
        assert got.dtype == dtype
    # generator input
    np.testing.assert_array_equal(
        audio_io.stack_rows(r for r in rows), np.stack(rows))


def test_wire_reader_for_sniffs_formats(tmp_path):
    """wire_reader_for picks the right zero-transcode reader per corpus:
    qN containers, mu-law wavs (format tag 7), and int16 PCM wavs."""
    rng = np.random.RandomState(3)
    x = rng.uniform(-0.5, 0.5, 1280).astype(np.float32)

    p16 = str(tmp_path / 'a.wav')
    audio_io.save_wav(p16, x, 16000)
    r = audio_io.wire_reader_for(p16)
    got = r(p16)
    assert got.dtype == np.int16
    assert np.array_equal(got, audio_io.fast_read_wav_int16(p16)[0])

    pmu = str(tmp_path / 'b.wav')
    audio_io.save_wav_mulaw(pmu, x, 16000)
    r = audio_io.wire_reader_for(pmu)
    got = r(pmu)
    assert got.dtype == np.uint8
    assert np.array_equal(got, audio_io.fast_read_wav_mulaw(pmu)[0])

    pq = str(tmp_path / 'c.q6')
    audio_io.save_qn(pq, x, 16000, 6)
    r = audio_io.wire_reader_for(pq)
    got = r(pq)
    assert got.dtype == np.uint8
    assert np.array_equal(got, audio_io.read_qn(pq)[0])
