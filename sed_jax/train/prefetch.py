"""Device-side batch prefetch for the training loop.

A train step that receives host numpy batches pays the host->device
transfer before compute starts, and ``device_put`` may block its calling
thread until the bytes land on device (it releases the GIL inside PJRT).
The reference hides this with torch's pinned-memory DataLoader + CUDA
streams (``main_strong.py:254``); ``device_prefetch`` does it with a
daemon thread that assembles + uploads batch k+1 while the jitted step
runs batch k.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import jax


def device_prefetch(it: Iterator, size: int = 2,
                    put: Optional[Callable] = None) -> Iterator:
    """Iterate ``it`` in a background thread, applying ``put`` (default
    ``jax.device_put``) to each item so host->device transfers overlap
    the consumer's compute.  Items are yielded in order; exceptions from
    ``it`` or ``put`` re-raise at the consuming ``next()``.

    ``size`` bounds how many uploaded batches wait on device (device
    memory use = size x batch bytes).

    Abandoning the returned generator (train loop hits stop_iteration,
    or an exception unwinds it) stops the producer thread: it releases
    its queued device batches and stops drawing from ``it`` instead of
    running the upstream data pipeline for the rest of the process.
    """
    if put is None:
        put = jax.device_put
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in it:
                if stop.is_set() or not _put(put(item)):
                    return
        except BaseException as e:      # re-raised by the consumer
            _put(_END)
            _put(e)
            return
        _put(_END)
        _put(None)

    threading.Thread(target=_produce, daemon=True).start()

    try:
        while True:
            item = q.get()
            if item is _END:
                err = q.get()
                if err is not None:
                    raise err
                return
            yield item
    finally:
        stop.set()
