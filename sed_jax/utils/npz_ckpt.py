"""Single-file .npz variable trees.

Every leaf is stored under its ``/``-joined pytree key path
(``params/conv_block1/conv1/kernel``, ``opt_state/0/mu/...``), so a
file restores into any tree of the same structure and its ``params`` /
``batch_stats`` load as plain nested dicts.  Train checkpoints
(``sed_jax.train.checkpoint``) keep float32; the small committed
artifacts (the trained bench checkpoint) are cast to float16.
"""

from __future__ import annotations

import os
from typing import Dict

import jax
import numpy as np


def _key_name(key) -> str:
    for attr in ('key', 'idx', 'name'):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    raise TypeError(f'unsupported pytree key {key!r}')


def named_leaves(tree):
    """([('/'-joined key path, leaf)], treedef) of ``tree``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    return ([('/'.join(_key_name(k) for k in path), leaf)
             for path, leaf in leaves], treedef)


def flatten(tree) -> Dict[str, np.ndarray]:
    """{'/'-joined key path: host array} for every leaf of ``tree``."""
    return {name: np.asarray(leaf) for name, leaf in named_leaves(tree)[0]}


def save_npz(path: str, flat: Dict[str, np.ndarray],
             compressed: bool = False) -> None:
    """Write ``flat`` to ``path`` atomically (rename of a temp file)."""
    tmp = f'{path}.tmp{os.getpid()}'
    with open(tmp, 'wb') as f:
        (np.savez_compressed if compressed else np.savez)(f, **flat)
    os.replace(tmp, path)


def save_variables_npz(path: str, variables: dict,
                       dtype=np.float16) -> None:
    """Save a variables tree ({'params', 'batch_stats', ...}) with its
    float32 leaves cast to ``dtype``."""
    cast = {k: (v.astype(dtype) if v.dtype == np.float32 else v)
            for k, v in flatten(variables).items()}
    save_npz(path, cast, compressed=True)


def load_variables_npz(path: str) -> dict:
    """Load back to a nested float32 tree."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            v = data[key]
            if v.dtype == np.float16:
                v = v.astype(np.float32)
            node = out
            parts = key.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out
