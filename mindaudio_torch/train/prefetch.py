"""Background batch prefetching (port of ``mindaudio_tpu.train.prefetch``).

A worker thread runs the batch iterator (and a ``transform``, typically the
copy to the card) while the training loop runs the previous step, through a
small queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

__all__ = ["prefetch"]

_SENTINEL = object()


def prefetch(iterator: Iterable, size: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Iterate ``iterator`` through a ``size``-deep background queue.

    ``transform`` runs in the worker thread on each item. An exception in
    the worker is raised in the consumer. Abandoning the generator early
    (``break``, garbage collection) stops the worker promptly: the producer
    polls a stop event instead of blocking on a full queue, and queued items
    are dropped.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        """put with stop polling; False = consumer gone, abort production."""
        while True:
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop.is_set():
                    return False

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                if transform is not None:
                    item = transform(item)
                if not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
