"""JAX's persistent compilation cache, in one fixed place.

``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX, which reads it
itself.  Otherwise the cache goes to ``<checkout>/.jax_cache`` (listed
in ``.gitignore``): a fixed path, because the cache is keyed by it, so
a second process finds what the first compiled.  Every entry point
calls ``enable()`` before its first compile; nothing else sets a cache.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, '.jax_cache')


def enable() -> str:
    """Point JAX's persistent cache at its directory; returns it."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    import jax
    jax.config.update('jax_compilation_cache_dir', DEFAULT_DIR)
    return DEFAULT_DIR
