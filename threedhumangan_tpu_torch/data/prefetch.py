"""Background-thread batch prefetcher (threedhumangan_tpu/data/prefetch.py).

One daemon thread keeps a bounded queue of ready batches ahead of the train
step: it builds each numpy batch (SMPL posing, collation) and runs
``transform`` on it, the trainer's host-to-device copy
(``data/dataset.py::to_tensors``: pinned memory, non-blocking, on the
default stream the step also uses).  An error in the worker surfaces on
the consumer side at the next ``next()``.  ``close()`` stops the worker
when the consumer leaves early (a curriculum stage change, ``max_steps``).
Spans (``utils.trace``): ``loader.build`` around each batch the worker
builds and transforms, ``loader.wait`` around the consumer's wait for one.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

from threedhumangan_tpu_torch.utils import trace


class PrefetchIterator:
    """Wrap a batch iterator; always ``depth`` batches ahead.  ``transform``
    (optional) runs on each item inside the worker thread."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error = None
        self._stop = threading.Event()

        def put(item):
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                items = iter(iterator)
                while not self._stop.is_set():
                    with trace.span("loader.build"):
                        item = next(items, self._SENTINEL)
                        if item is not self._SENTINEL and transform is not None:
                            item = transform(item)
                    if item is self._SENTINEL or not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with trace.span("loader.wait"):
            item = self._queue.get()
        if item is self._SENTINEL:
            self._queue.put(item)  # later next() calls end too
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drop the batches it has queued."""
        self._stop.set()
        self._thread.join()
        while not self._queue.empty():
            self._queue.get_nowait()


def prefetch(iterator: Iterator, depth: int = 2,
             transform: Optional[Callable] = None) -> PrefetchIterator:
    return PrefetchIterator(iterator, depth, transform=transform)
