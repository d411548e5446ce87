"""Test config: run on CPU with an 8-device virtual mesh.

Every test runs on the CPU; multi-device sharding tests use the virtual
device mesh.  The program itself runs on the GPU, and ``chip_smoke.py``
checks it there.  XLA_FLAGS must be set before the CPU backend
initializes.
"""

import os

flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
