"""Device mesh and sharding helpers.

The reference's only distribution strategy is single-process
``torch.nn.DataParallel`` (``pytorch/main_strong.py:217``; SURVEY §2.12).
Its replacement here is a 1-D data mesh: the batch is sharded over the
``data`` axis, parameters are replicated, and XLA inserts the gradient
all-reduce during ``jit`` compilation of the global-batch loss.
A second optional ``model`` axis is exposed for FSDP-style parameter
sharding of the larger models (Cnn_14*, 94 M params).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ('data',),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With the default 1-D ``('data',)`` axis this is pure data parallelism;
    pass ``axis_names=('data', 'model')`` and a 2-D ``shape`` for hybrid
    data x model sharding.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def batch_sharding(mesh: Mesh, axis: str = 'data') -> NamedSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return NamedSharding(mesh, P(axis))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: dict, mesh: Mesh, axis: str = 'data') -> dict:
    """Device-put every array in a batch dict with its batch axis sharded.

    Multi-process: each host passes its LOCAL slice of the global batch
    (see ``parallel.distributed.HostShardedSampler``) and the global
    sharded array is assembled from the per-process shards — the
    device-side view is identical to the single-process case.
    """
    sharding = batch_sharding(mesh, axis)
    if jax.process_count() > 1:
        pc = jax.process_count()

        def put(x):
            x = np.asarray(x)
            gshape = (x.shape[0] * pc,) + x.shape[1:]
            return jax.make_array_from_process_local_data(sharding, x,
                                                          gshape)
        return jax.tree.map(put, batch)
    return jax.tree.map(lambda x: jax.device_put(x, sharding), batch)


def fsdp_shardings(tree, mesh: Mesh, axis: str = 'model',
                   min_size: int = 65536):
    """FSDP-style sharding tree: every leaf of at least ``min_size``
    elements is sharded along its largest ``axis``-divisible dimension
    over the ``axis`` mesh axis; everything else is replicated.

    Optimizer moments share parameter shapes, so the same tree applies to
    a whole train state.  Under ``jit``, XLA inserts the all-gathers /
    reduce-scatters, which lets the 94 M-param Cnn_14* models be sharded
    (the reference cannot distribute them, SURVEY §2.12).
    """
    size = mesh.shape[axis]

    def rule(leaf):
        shape = getattr(leaf, 'shape', ())
        n = int(np.prod(shape)) if shape else 0
        if n >= min_size:
            order = sorted(range(len(shape)), key=lambda d: -shape[d])
            for d in order:
                if shape[d] % size == 0 and shape[d] >= size:
                    spec = [None] * len(shape)
                    spec[d] = axis
                    return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    return jax.tree.map(rule, tree)
