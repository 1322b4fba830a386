"""Background batch prefetching (port of ``mindaudio_tpu.train.prefetch``).

A worker thread runs the batch iterator (and a ``transform``, typically
:class:`ToDevice`, the copy to the card) while the training loop runs the
previous step, through a small queue.

Under a ``torch.profiler`` session the worker records the spans
``prefetch.produce`` (the iterator's ``next``) and ``prefetch.stage`` (the
transform), and the consumer ``prefetch.wait`` (its wait on the queue)
(``train.profiler.annotate``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .profiler import annotate

__all__ = ["prefetch", "ToDevice"]

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
            items = iter(iterator)
            while True:
                with annotate("prefetch.produce"):
                    item = next(items, _SENTINEL)
                if item is _SENTINEL or stop.is_set():
                    return
                if transform is not None:
                    with annotate("prefetch.stage"):
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
            with annotate("prefetch.wait"):
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


class ToDevice:
    """The prefetch transform: the numpy batch that ends an iterator's item
    (a tuple whose last element is a dict of arrays) to tensors on ``device``.

    On CUDA the arrays are pinned and copied with ``non_blocking=True`` on a
    side stream, from the prefetch worker thread, and an event is recorded
    on that stream after the copies. :meth:`ready` makes the consuming
    stream wait on that event (on the device; the host does not block) and
    calls ``record_stream`` on each tensor, so that the caching allocator
    does not hand its memory to another tensor while the consuming stream
    may still read it. Integer arrays other than the int16 audio become
    int64, as the models take them.
    """

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    @staticmethod
    def _host(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.long() if t.dtype == torch.int32 else t
        return out

    def __call__(self, item):
        """``item`` with its last element replaced by the staged batch."""
        *head, batch = item
        host = self._host(batch)
        if self.stream is None:
            return (*head, (host, None))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in host.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        return (*head, (dev, copied))

    def ready(self, staged):
        """The batch of ``staged`` (a :meth:`__call__` result's last part),
        safe to use on the current stream."""
        batch, copied = staged
        if copied is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(copied)
            for t in batch.values():
                t.record_stream(current)
        return batch
