"""Loader microbenchmark: per-item h5py reads vs one hyperslab
fancy-read per batch (sed_jax/data/dataset.py get_batch), plus the
threaded DataLoader end-to-end. Run on an idle host."""
import os, sys, time, tempfile
import numpy as np, h5py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from sed_jax.data.dataset import AudiosetDataset, DataLoader, TrainSampler, collate_fn

d = tempfile.mkdtemp()
path = os.path.join(d, 'weak_training_logmel_16k.h5')
rng = np.random.RandomState(0)
n, samples = 400, 160000      # 400x10s @16k int16 = 128 MB
with h5py.File(path, 'w') as hf:
    hf.create_dataset('audio_name', data=[f'c{i}.wav'.encode() for i in range(n)])
    hf.create_dataset('waveform', data=rng.randint(-3000, 3000, (n, samples), np.int16))
    hf.create_dataset('target', data=rng.rand(n, 25) > 0.8)
    hf.create_dataset('strong_target', data=rng.rand(n, 1000, 25) > 0.9)

BS, NB = 48, 40
for tag, fetch in [('per-item', 'item'), ('hyperslab', 'batch')]:
    ds = AudiosetDataset(dequantize=False)
    sampler = iter(TrainSampler(path, BS))
    metas = [next(sampler) for _ in range(NB)]
    # warm cache
    _ = ds.get_batch(metas[0]) if fetch == 'batch' else collate_fn([ds[m] for m in metas[0]])
    t0 = time.time()
    for bm in metas:
        if fetch == 'batch':
            ds.get_batch(bm)
        else:
            collate_fn([ds[m] for m in bm])
    dt = time.time() - t0
    print(f'{tag}: {dt/NB*1000:.1f} ms/batch ({NB} x bs{BS})')
    ds.close()

# end-to-end loader with 3 workers, both paths
for workers in (1, 3):
    ds = AudiosetDataset(dequantize=False)
    loader = DataLoader(ds, TrainSampler(path, BS), num_workers=workers)
    it = iter(loader)
    next(it)
    t0 = time.time()
    for _ in range(NB):
        next(it)
    print(f'loader hyperslab workers={workers}: {(time.time()-t0)/NB*1000:.1f} ms/batch')
    ds.close()
