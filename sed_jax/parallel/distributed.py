"""Multi-host process wiring.

The reference has no multi-machine story (``torch.nn.DataParallel`` is
single-process, SURVEY §2.12).  Here every host runs the same program,
``jax.distributed.initialize`` joins them into one runtime, the mesh
spans all processes' devices, every host draws the SAME seeded global
batch stream and loads only its slice (``HostShardedSampler``), and
``parallel.mesh.shard_batch`` assembles the global sharded array from
per-host shards.  XLA then inserts the gradient all-reduce across every
device of the mesh.

Invocation (per host)::

    JAX_COORDINATOR_ADDRESS=host0:8476 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=<k> python -m sed_jax.cli.main_strong train ...

Under a cluster launcher that JAX recognises (Slurm, Open MPI's
``mpirun``, or a Kubernetes job), ``SED_JAX_MULTIHOST=1`` lets
``jax.distributed.initialize()`` read the coordinator, process count and
process id from the launcher's environment instead.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List, Optional


def maybe_initialize() -> bool:
    """Join a multi-process JAX runtime when the environment asks for one.

    Returns True when ``jax.distributed.initialize`` was called.  A
    single-process run (no relevant env vars) is a no-op — the common
    case stays zero-config.
    """
    import jax

    def _env(*names):
        """First set env var among aliases -> (value, actual name set)."""
        for name in names:
            v = os.environ.get(name)
            if v is not None and v != '':
                return v, name
        return None, names[0]

    coord, coord_name = _env('JAX_COORDINATOR_ADDRESS')
    nproc, nproc_name = _env('JAX_NUM_PROCESSES', 'JAX_PROCESS_COUNT')
    pid, pid_name = _env('JAX_PROCESS_ID', 'JAX_PROCESS_INDEX')
    # an operator's fully explicit wiring takes precedence over
    # SED_JAX_MULTIHOST auto-detection: a pod launcher that exports both
    # gets exactly the coordinator/count/id it asked for
    if coord and nproc is not None and pid is not None:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=int(nproc),
                                   process_id=int(pid))
        logging.info('jax.distributed initialized: process %s of %s '
                     '(coordinator %s)', pid, nproc, coord)
        return True
    if os.environ.get('SED_JAX_MULTIHOST') == '1':
        jax.distributed.initialize()     # launcher auto detection
        logging.info('jax.distributed initialized from the launcher '
                     'environment: process %d of %d', jax.process_index(),
                     jax.process_count())
        return True
    have = {coord_name: coord, nproc_name: nproc, pid_name: pid}
    missing = [k for k, v in have.items() if v is None or v == '']
    if missing and len(missing) < len(have):
        # a partially-wired launch must not silently run every host as an
        # independent single-process copy of the training job; the error
        # names the alias env vars the user actually set
        raise RuntimeError(
            'multi-host launch is partially configured: '
            f'{[k for k in have if k not in missing]} set but {missing} '
            'missing — set all three (or SED_JAX_MULTIHOST=1 under a '
            'cluster launcher)')
    return False


class HostShardedSampler:
    """Wrap a batch-meta sampler so each host fetches only its share.

    All processes construct identically-seeded samplers (so the global
    stream is the same everywhere) and slice ``[k*share:(k+1)*share]`` —
    per-host HDF5 IO drops by ``1/process_count`` instead of loading the
    global batch and discarding most of it.
    """

    def __init__(self, sampler, process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 even_shares: bool = False):
        if process_index is None:
            import jax
            process_index = jax.process_index()
        if process_count is None:
            import jax
            process_count = jax.process_count()
        self.sampler = sampler
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        # pair-based augmentation (mixup) consumes consecutive sample
        # PAIRS with globally drawn (lam, 1-lam) lambdas: an odd
        # per-host share would split a pair across hosts and misalign
        # every following lambda slice
        self.even_shares = even_shares

    def __iter__(self) -> Iterator[List[dict]]:
        k, n = self.process_index, self.process_count
        for batch_meta in self.sampler:
            if n == 1:
                yield batch_meta
                continue
            share = len(batch_meta) // n
            assert share * n == len(batch_meta), (
                f'global batch {len(batch_meta)} must divide over '
                f'{n} processes')
            assert not (self.even_shares and share % 2), (
                f'per-host share {share} must be even to keep mixup '
                f'pairs host-local (global batch {len(batch_meta)}, '
                f'{n} processes)')
            yield batch_meta[k * share:(k + 1) * share]
