"""A producer thread feeding a consumer through a bounded queue.

Counterpart of ``prefetch_iter`` in ``deeplearning4j_tpu/common/background.py``
(the reference's ``AsyncDataSetIterator`` pattern). Word2Vec's host pair path
runs its pair generation, batching and staging to the card in the producer,
so that the host work of block n + 1 overlaps the card's rounds of block n.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, List, TypeVar

T = TypeVar("T")

_END = object()


def prefetch_iter(source: Iterable[T], maxsize: int = 8) -> Iterator[T]:
    """Yield the items of ``source``, produced on a background thread
    through a queue of at most ``maxsize`` items.

    An exception raised by ``source`` is raised again, the same object with
    the producer's traceback, where the consumer reads, after the items
    produced before it: a failing producer never looks like one that has
    finished. Abandoning the returned iterator (``break``, ``close``,
    garbage collection) stops and joins the producer."""
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    stop = threading.Event()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in source:
                if stop.is_set() or not _put(item):
                    return
        except BaseException as e:  # re-raised on the consumer's side
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True,
                         name="dl4j-torch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
