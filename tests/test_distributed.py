"""Multi-host wiring unit tests (single-process semantics + slicing)."""

import numpy as np

from sed_jax.parallel.distributed import HostShardedSampler, \
    maybe_initialize


def test_maybe_initialize_noop_without_env(monkeypatch):
    for var in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                'JAX_PROCESS_ID', 'SED_JAX_MULTIHOST'):
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize() is False


def test_maybe_initialize_rejects_partial_env(monkeypatch):
    """A half-wired multi-host launch must be a loud configuration error,
    not a silent fleet of independent single-process training runs."""
    import pytest
    for var in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                'JAX_PROCESS_ID', 'JAX_PROCESS_COUNT', 'JAX_PROCESS_INDEX',
                'SED_JAX_MULTIHOST'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('JAX_COORDINATOR_ADDRESS', 'host0:8476')
    monkeypatch.setenv('JAX_NUM_PROCESSES', '2')
    with pytest.raises(RuntimeError, match='JAX_PROCESS_ID'):
        maybe_initialize()


def test_explicit_wiring_beats_multihost_autodetect(monkeypatch):
    """A pod launcher that exports BOTH the explicit coordinator wiring
    and SED_JAX_MULTIHOST=1 must get the operator's explicit wiring, not
    auto-detection."""
    for var in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                'JAX_PROCESS_ID', 'JAX_PROCESS_COUNT', 'JAX_PROCESS_INDEX',
                'SED_JAX_MULTIHOST'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('SED_JAX_MULTIHOST', '1')
    monkeypatch.setenv('JAX_COORDINATOR_ADDRESS', 'host0:8476')
    monkeypatch.setenv('JAX_NUM_PROCESSES', '2')
    monkeypatch.setenv('JAX_PROCESS_ID', '1')
    import jax
    calls = []
    monkeypatch.setattr(jax.distributed, 'initialize',
                        lambda **kw: calls.append(kw))
    assert maybe_initialize() is True
    assert calls == [{'coordinator_address': 'host0:8476',
                      'num_processes': 2, 'process_id': 1}]


def test_partial_env_error_names_the_aliases_set(monkeypatch):
    """The partial-config error must name the alias env vars the user
    actually set (JAX_PROCESS_COUNT/INDEX), not only the canonical
    names."""
    import pytest
    for var in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',
                'JAX_PROCESS_ID', 'JAX_PROCESS_COUNT', 'JAX_PROCESS_INDEX',
                'SED_JAX_MULTIHOST'):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv('JAX_PROCESS_COUNT', '4')
    with pytest.raises(RuntimeError) as exc:
        maybe_initialize()
    assert 'JAX_PROCESS_COUNT' in str(exc.value)


def test_host_sharded_sampler_slices_disjoint_and_complete():
    batches = [[{'i': i, 'b': b} for i in range(8)] for b in range(3)]
    shards = [list(HostShardedSampler(batches, process_index=k,
                                      process_count=4))
              for k in range(4)]
    for b in range(3):
        seen = [m['i'] for k in range(4) for m in shards[k][b]]
        assert seen == list(range(8))           # disjoint, ordered, complete
        assert all(len(shards[k][b]) == 2 for k in range(4))
    # single process: identity
    assert list(HostShardedSampler(batches, 0, 1)) == batches


def test_host_sharded_sampler_rejects_indivisible_batch():
    import pytest
    bad = [[{'i': i} for i in range(7)]]
    with pytest.raises(AssertionError):
        list(HostShardedSampler(bad, 0, 2))


def test_loader_over_host_sharded_sampler(tmp_path):
    """End-to-end: the local loader stream equals the matching slice of
    the global stream for every simulated host."""
    import h5py
    from sed_jax.data.dataset import (AudiosetDataset, DataLoader,
                                      TrainSampler)
    path = str(tmp_path / 'weak_training_logmel_16k.h5')
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w') as hf:
        hf.create_dataset('audio_name',
                          data=[f'c{i}.wav'.encode() for i in range(8)])
        hf.create_dataset('waveform',
                          data=rng.randint(-100, 100, (8, 64), np.int16))
        hf.create_dataset('target',
                          data=rng.rand(8, 25) > 0.8)
    ds = AudiosetDataset()
    global_batches = []
    it = iter(DataLoader(ds, TrainSampler(path, 4)))
    for _ in range(3):
        global_batches.append(next(it))
    for k in range(2):
        local_it = iter(DataLoader(
            ds, HostShardedSampler(TrainSampler(path, 4),
                                   process_index=k, process_count=2),
            num_workers=2))
        for b in range(3):
            local = next(local_it)
            np.testing.assert_array_equal(
                local['waveform'],
                global_batches[b]['waveform'][k * 2:(k + 1) * 2])
    ds.close()
