"""ParallelInference — request micro-batching for serving.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``: requests queue
up, a worker coalesces up to ``batch_limit`` of them inside one
``max_wait_ms`` window, runs the model once on the merged batch, and
scatters the rows back to the requests' futures. ``workers`` coalescing
threads share one request queue; on one card they share its stream.

Modes: ``batched`` (coalesce) and ``sequential`` (run at once, no batching;
``inplace`` maps to it).

Failure contract:

- ``output`` bounds its wait with a deadline (``request_timeout_ms``;
  default ``max(1000 * max_wait_ms, 10 s)``) and raises ``TimeoutError``
  naming the request's true time in queue (``fut.enqueued_at``).
- An exception while serving a batch is set on that batch's futures; the
  worker keeps serving.
- ``shutdown`` stops the workers, lets in-flight batches finish (bounded),
  then fails every future still queued.

Results are tensors on the CPU (one device-to-host copy per batch), in the
model's output dtype. Replica resurrection, ``scale_to``, fault injection
and the health census arrive with a later slice.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch

from ..common.profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")


class _Request:
    """One queued request with its queue-entry timestamp."""

    __slots__ = ("arr", "fut", "seq", "t_enq")

    def __init__(self, arr, fut: Future, seq: int, t_enq: float):
        self.arr = arr
        self.fut = fut
        self.seq = seq
        self.t_enq = t_enq          # time.monotonic() at queue entry

    @property
    def n(self) -> int:
        return int(self.arr.shape[0])


class ParallelInference:
    class Builder:
        def __init__(self, model):
            self._model = model
            self._mode = "batched"
            self._batch_limit = 32
            self._queue_limit = 64
            self._max_wait_ms = 5.0
            self._workers = 1
            self._request_timeout_ms: Optional[float] = None

        def inference_mode(self, mode: str) -> "ParallelInference.Builder":
            self._mode = mode.lower()
            return self

        inferenceMode = inference_mode

        def batch_limit(self, n: int) -> "ParallelInference.Builder":
            self._batch_limit = n
            return self

        batchLimit = batch_limit

        def queue_limit(self, n: int) -> "ParallelInference.Builder":
            self._queue_limit = n
            return self

        def max_wait_ms(self, ms: float) -> "ParallelInference.Builder":
            self._max_wait_ms = ms
            return self

        def workers(self, n: int) -> "ParallelInference.Builder":
            """Coalescing worker threads sharing the request queue."""
            self._workers = max(1, int(n))
            return self

        def request_timeout_ms(self, ms: float) -> "ParallelInference.Builder":
            """Hard deadline for :meth:`output`."""
            self._request_timeout_ms = ms
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(
                self._model, self._mode, self._batch_limit,
                self._queue_limit, self._max_wait_ms, workers=self._workers,
                request_timeout_ms=self._request_timeout_ms)

    def __init__(self, model, mode: str = "batched", batch_limit: int = 32,
                 queue_limit: int = 64, max_wait_ms: float = 5.0,
                 workers: int = 1,
                 request_timeout_ms: Optional[float] = None):
        self.model = model
        self.mode = "sequential" if mode in ("sequential", "inplace") \
            else "batched"
        self.batch_limit = batch_limit
        self.max_wait_s = max_wait_ms / 1000.0
        # a healthy worker turns a batch around in ~max_wait_s; 1000x that
        # (floor 10 s) only fires on a wedged pipeline
        self.request_timeout_s = (request_timeout_ms / 1000.0
                                  if request_timeout_ms is not None
                                  else max(1000.0 * self.max_wait_s, 10.0))
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self._shutdown = False
        self._lock = threading.Lock()
        self._req_seq = 0
        self._busy = 0
        self._alive = 0
        self._workers: List[threading.Thread] = []
        if self.mode == "batched":
            self._alive = max(1, int(workers))
            for i in range(self._alive):
                t = threading.Thread(target=self._drain, args=(i,),
                                     daemon=True,
                                     name=f"dl4j-torch-inference-{i}")
                self._workers.append(t)
                t.start()

    def alive_replicas(self) -> int:
        with self._lock:
            return self._alive

    def output(self, x) -> torch.Tensor:
        """Synchronous single-request API (``x``: a numpy batch), bounded by
        the request deadline."""
        fut = self.output_async(x)
        try:
            return fut.result(timeout=self.request_timeout_s)
        except concurrent.futures.TimeoutError:
            t_enq = getattr(fut, "enqueued_at", None)
            waited = (f"{time.monotonic() - t_enq:.1f}s in queue"
                      if t_enq is not None
                      else f"{self.request_timeout_s:.1f}s")
            raise TimeoutError(
                f"inference request timed out after {waited} (deadline "
                f"{self.request_timeout_s:.1f}s, queue depth "
                f"{self._queue.qsize()}, {self.alive_replicas()}/"
                f"{len(self._workers) or 1} replicas alive); a wedged "
                f"worker or an overloaded queue — raise request_timeout_ms "
                f"or add workers") from None

    def output_async(self, x) -> Future:
        arr = np.asarray(x)
        fut: Future = Future()
        if self._shutdown:
            fut.set_exception(RuntimeError(
                "ParallelInference is shut down; no worker will serve this "
                "request"))
            return fut
        if self.mode == "sequential":
            try:
                fut.set_result(self._run(arr).cpu())
            except Exception as e:
                fut.set_exception(e)
            return fut
        with self._lock:
            seq = self._req_seq
            self._req_seq += 1
        req = _Request(arr, fut, seq, time.monotonic())
        fut.enqueued_at = req.t_enq
        try:
            # bounded by the deadline too: a full queue behind a wedged
            # worker must not turn "timeout instead of hang" into a block
            self._queue.put(req, timeout=self.request_timeout_s)
        except queue.Full:
            fut.set_exception(TimeoutError(
                f"inference queue stayed full (depth {self._queue.qsize()}) "
                f"for {self.request_timeout_s:.1f}s"))
        return fut

    def _run(self, batch) -> torch.Tensor:
        out = self.model.output(batch)
        return out[0] if isinstance(out, (list, tuple)) else out

    def _drain(self, worker_id: int) -> None:
        prof = OpProfiler.get()
        while not self._shutdown:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # ONE coalescing window for the whole batch (an absolute
            # deadline), so trickling requests cannot hold the first one
            # up to batch_limit x max_wait_s
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.batch_limit:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            with self._lock:
                self._busy += 1
            try:
                self._serve_batch(batch, prof)
            finally:
                with self._lock:
                    self._busy -= 1
        with self._lock:
            self._alive -= 1

    def _serve_batch(self, batch: List[_Request], prof) -> None:
        """Run one coalesced batch and scatter its rows to the futures."""
        try:
            result = self._run(np.concatenate([r.arr for r in batch])).cpu()
            prof.count("inference/batches")
            prof.count("inference/requests", len(batch))
            off = 0
            for r in batch:
                r.fut.set_result(result[off:off + r.n])
                off += r.n
        except Exception as e:   # scatter the failure to every waiter
            prof.count("inference/batch_errors")
            for r in batch:
                if not r.fut.done():
                    r.fut.set_exception(e)

    def _fail_queued(self, exc: Exception) -> int:
        n = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return n
            if not req.fut.done():
                req.fut.set_exception(exc)
                n += 1

    def shutdown(self, drain_timeout_s: float = 2.0) -> None:
        """Stop the workers, let in-flight batches finish (up to
        ``drain_timeout_s``), then fail every future still queued."""
        self._shutdown = True
        deadline = time.monotonic() + max(0.0, drain_timeout_s)
        for t in self._workers:
            t.join(timeout=max(0.05, deadline - time.monotonic()))
        with self._lock:
            still_busy = self._busy
        if still_busy:
            logger.warning("ParallelInference.shutdown: %d in-flight "
                           "batch(es) did not drain within %.1fs",
                           still_busy, drain_timeout_s)
        n = self._fail_queued(RuntimeError(
            "ParallelInference shut down with this request still queued"))
        if n:
            logger.warning("ParallelInference.shutdown failed %d queued "
                           "request(s)", n)
