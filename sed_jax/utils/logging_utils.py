"""Logging setup (``utils/utilities.py:29-63``)."""

from __future__ import annotations

import logging
import os


def get_filename(path: str) -> str:
    name_ext = os.path.realpath(path).split('/')[-1]
    return os.path.splitext(name_ext)[0]


def count_parameters(params) -> int:
    """Log a per-module parameter-count table and return the total
    (``utils/utilities.py:17-27``'s PrettyTable, dependency-free)."""
    import jax
    import numpy as np
    rows = []
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        name = '/'.join(getattr(k, 'key', str(k)) for k in path)
        rows.append((name, int(np.prod(leaf.shape))))
    width = max([len(r[0]) for r in rows] + [len('Module')])
    sep = '+' + '-' * (width + 2) + '+' + '-' * 12 + '+'
    logging.info(sep)
    logging.info('| %-*s | %10s |', width, 'Module', 'Parameters')
    logging.info(sep)
    for name, n in rows:
        logging.info('| %-*s | %10d |', width, name, n)
    total = sum(n for _, n in rows)
    logging.info(sep)
    logging.info('Total trainable parameters: %d', total)
    return total


def create_logging(log_dir: str, filemode: str = 'w') -> logging.Logger:
    """File + console logging with sequentially numbered log files."""
    os.makedirs(log_dir, exist_ok=True)
    i = 0
    while os.path.isfile(os.path.join(log_dir, f'{i:04d}.log')):
        i += 1
    log_path = os.path.join(log_dir, f'{i:04d}.log')
    logging.basicConfig(
        level=logging.DEBUG,
        format=('%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s '
                '%(message)s'),
        datefmt='%a, %d %b %Y %H:%M:%S',
        filename=log_path,
        filemode=filemode,
        force=True)
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(
        logging.Formatter('%(name)-12s: %(levelname)-8s %(message)s'))
    logging.getLogger('').addHandler(console)
    # keep framework debug out of the root DEBUG stream
    for noisy in ('jax', 'jax._src', 'absl', 'h5py'):
        logging.getLogger(noisy).setLevel(logging.INFO)
    return logging
