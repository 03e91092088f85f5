"""Host-side input pipeline: background prefetch and device placement
(counterpart of ``repro/data/pipeline.py``).

A stalled producer is detected, not waited on: with ``stall_timeout_s``
set, ``PrefetchIterator`` emits a ``data_stall`` event each interval the
queue stays empty and, past ``stall_max_s``, raises ``DataStallError``.
The producer's exhaustion raises ``StopIteration``; its exceptions are
raised again on the consumer's thread.  ``place`` puts a batch on the
device (the JAX ``device_put_batch``).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.obs import events as obs_events


class DataStallError(RuntimeError):
    """The input pipeline produced nothing for longer than
    ``stall_max_s``: a dead loader, not a slow batch."""


_DONE = object()    # the producer thread's end marker


class PrefetchIterator:
    """Wraps a host iterator with a daemon prefetch thread, at most
    ``depth`` items ahead, and an optional ``place`` of each item."""

    def __init__(self, it: Iterator, depth: int = 2,
                 place: Optional[Callable] = None,
                 stall_timeout_s: Optional[float] = None,
                 stall_max_s: Optional[float] = None):
        self._it = it
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stall_timeout = stall_timeout_s
        self._stall_max = stall_max_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                if self._place is not None:
                    item = self._place(item)
                self._q.put(item)
        except Exception as e:              # raised again by __next__
            self._err = e
        self._q.put(_DONE)

    def _get(self):
        if self._stall_timeout is None:
            return self._q.get()
        waited = 0.0
        while True:
            try:
                return self._q.get(timeout=self._stall_timeout)
            except queue.Empty:
                waited += self._stall_timeout
                obs_events.emit("data_stall", waited_s=round(waited, 3),
                                timeout_s=self._stall_timeout)
                if self._stall_max is not None and waited >= self._stall_max:
                    raise DataStallError(
                        f"input pipeline produced nothing for "
                        f"{waited:.1f}s (stall_max_s={self._stall_max})"
                    ) from None

    def __iter__(self):
        return self

    def __next__(self):
        item = self._get()
        if item is _DONE:
            self._q.put(_DONE)              # stays terminal
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        self._stop.set()


def place(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every entry of a host batch (numpy arrays, or the chaos loss scale)
    as a tensor on ``device`` (also ``runtime.step.batch_to_device``)."""
    return {k: torch.from_numpy(np.asarray(v, order="C")).to(device)
            for k, v in batch.items()}
