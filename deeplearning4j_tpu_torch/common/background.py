"""A producer thread feeding a consumer through a bounded queue.

Counterpart of ``prefetch_iter`` and ``staged_iter`` in
``deeplearning4j_tpu/common/background.py`` (the reference's
``AsyncDataSetIterator`` pattern). Word2Vec's host pair path runs its pair
generation, batching and staging to the card in the producer, so that the
host work of block n + 1 overlaps the card's rounds of block n; the fit
loops' ``host_prefetch`` and ``AsyncDataSetIterator`` assemble batches in
it.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

from . import nan_panic

T = TypeVar("T")
U = TypeVar("U")

_END = object()


def prefetch_iter(source: Iterable[T], maxsize: int = 8) -> Iterator[T]:
    """Yield the items of ``source``, produced on a background thread
    through a queue of at most ``maxsize`` items.

    An exception raised by ``source`` is raised again, the same object with
    the producer's traceback, where the consumer reads, after the items
    produced before it: a failing producer never looks like one that has
    finished. Abandoning the returned iterator (``break``, ``close``,
    garbage collection) stops and joins the producer. While NAN_PANIC is
    on when the producer starts, it checks the producer's operations
    (``common/nan_panic.py``); its ``FloatingPointError`` reaches the
    consumer so."""
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
            with nan_panic.scope():
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


def staged_iter(source: Iterable[T],
                stage: Optional[Callable[[T], U]] = None,
                depth: int = 2, host_prefetch: int = 0) -> Iterator[U]:
    """Yield ``stage(item)`` for each item of ``source``, ``stage`` issued
    up to ``depth`` items ahead of the consumer (on the card a
    non-blocking copy returns at once, so the copy of item n + 1 overlaps
    the work on item n).

    ``stage`` runs on the consumer's thread; ``host_prefetch > 0`` draws
    ``source`` on a worker thread (:func:`prefetch_iter` with that queue
    size), so host-side assembly overlaps the consumer too."""
    if depth < 0:
        raise ValueError(f"depth must be >= 0, got {depth}")
    it: Iterator[T] = (prefetch_iter(source, maxsize=host_prefetch)
                       if host_prefetch > 0 else iter(source))
    if stage is None:
        stage = lambda x: x  # noqa: E731
    buf: "collections.deque" = collections.deque()
    try:
        for item in it:
            buf.append(stage(item))
            if len(buf) > depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()
    finally:
        # an abandoned feed closes the producer now (stop, drain, join)
        close = getattr(it, "close", None)
        if close is not None:
            close()
