"""ctypes bindings for the native IMA ADPCM encoder.

Same build pattern as ``vad_native``: compiled from ``adpcm_codec.cc``
with g++ on first use, cached next to the source, atomic rename so
concurrent processes never dlopen a half-written ELF.  Callers must
check ``native_available()`` and fall back to the numpy encoder
(``audio_io.adpcm_encode_np``) — the two are bit-exact
(tests/test_adpcm.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'adpcm_codec.cc')
_LIB_PATH = os.path.join(_HERE, '_adpcm_codec.so')

_lib = None
_lock = threading.Lock()
_build_failed = False


def _compile(out_path: str) -> None:
    tmp = f'{out_path}.tmp.{os.getpid()}'
    try:
        subprocess.run(
            ['g++', '-O3', '-shared', '-fPIC', '-std=c++17',
             _SRC, '-o', tmp],
            check=True, capture_output=True)
        os.rename(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        if not os.path.isfile(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            _compile(_LIB_PATH)
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _compile(_LIB_PATH)
            lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError) as exc:
        logging.warning('native adpcm encoder unavailable: %s', exc)
        _build_failed = True
        return None
    lib.sed_adpcm_encode.restype = ctypes.c_int
    lib.sed_adpcm_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.sed_adpcm_encode_n.restype = ctypes.c_int
    lib.sed_adpcm_encode_n.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            _lib = _build()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def encode(x: np.ndarray, block_align: int) -> np.ndarray:
    """int16 (B, S) -> (B, nbl*block_align + 1) uint8 ADPCM wire rows
    (bit-exact to ``audio_io.adpcm_encode_np``)."""
    lib = _get_lib()
    assert lib is not None, 'native adpcm encoder unavailable'
    x = np.ascontiguousarray(x, np.int16)
    assert x.ndim == 2, x.shape
    b, s = x.shape
    spb = (block_align - 4) * 2 + 1
    nbl = -(-s // spb)
    out = np.empty((b, nbl * block_align + 1), np.uint8)
    rc = lib.sed_adpcm_encode(x.ctypes.data, b, s, block_align,
                              out.ctypes.data)
    assert rc == 0, 'native adpcm encode failed'
    return out


def encode_n(x: np.ndarray, bits: int, block_align: int) -> np.ndarray:
    """int16 (B, S) -> narrow-code (bits in {2, 3}) ADPCM wire rows
    (bit-exact to ``audio_io.adpcm_n_encode_np``)."""
    from sed_jax.data.audio_io import ADPCM_N_PAD
    lib = _get_lib()
    assert lib is not None, 'native adpcm encoder unavailable'
    x = np.ascontiguousarray(x, np.int16)
    assert x.ndim == 2, x.shape
    b, s = x.shape
    spb = (block_align - 4) * 8 // bits + 1
    nbl = -(-s // spb)
    pad = ADPCM_N_PAD[bits]
    out = np.empty((b, nbl * block_align + pad), np.uint8)
    rc = lib.sed_adpcm_encode_n(x.ctypes.data, b, s, block_align, bits,
                                pad, out.ctypes.data)
    assert rc == 0, 'native adpcm_n encode failed'
    return out
