"""ParallelInference — request micro-batching for serving.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py``: requests queue
up, a worker coalesces up to ``batch_limit`` of them inside one
``max_wait_ms`` window, runs the model once on the merged batch, and
scatters the rows back to the requests' futures. ``workers`` coalescing
threads ("replicas") share one request queue; on one card they share its
stream.

Modes: ``batched`` (coalesce) and ``sequential`` (run at once, no batching;
``inplace`` maps to it).

Failure contract:

- **Deadlines**: ``output`` bounds its wait (``request_timeout_ms``;
  default ``max(1000 * max_wait_ms, 10 s)``) and raises ``TimeoutError``
  naming the request's true time in queue (``fut.enqueued_at``), the queue
  depth and the live replicas.
- **Retirement**: a worker whose model dies fatally
  (``common/faultinject.DeadReplicaFault``; drillable at the
  ``inference/worker`` site, one index per request) fails its in-flight
  batch and retires; when the LAST replica retires, queued and new
  requests fail at once. An ordinary exception while serving a batch is
  set on that batch's futures and the worker keeps serving.
- **Resurrection** (on by default): a retired replica is replaced after an
  exponential backoff and a health probe (``inference/probe`` fault site;
  the model's device answers ``mesh.probe_device``, then the model re-runs
  a one-row slice of the last batch served), at most
  ``max_resurrections`` times. ``pool_stats()`` and :func:`pool_health`
  count live, retired and resurrected replicas.
- **Online scaling**: :meth:`ParallelInference.scale_to` grows the pool
  with fresh workers or asks the surplus to exit at a batch boundary.
- **Shutdown** stops the workers, lets in-flight batches finish (bounded),
  then fails every future still queued.

Results are tensors on the CPU (one device-to-host copy per batch), in the
model's output dtype. ``parallel/serving.ServingEngine`` is the serving
tier built on this pool.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ..common import faultinject, flightrec, nan_panic
from ..common.profiler import OpProfiler
from .mesh import probe_device

logger = logging.getLogger("deeplearning4j_tpu_torch")

# live pools, for the /api/health census (weak: a dropped pool vanishes)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def pool_health() -> Dict[str, int]:
    """Live/retired/resurrected counts summed over every live pool: the
    ``/api/health`` serving-capacity line."""
    agg = {"pools": 0, "workers": 0, "alive": 0, "retired": 0,
           "resurrected": 0}
    for pool in list(_POOLS):
        stats = pool.pool_stats()
        agg["pools"] += 1
        for k in ("workers", "alive", "retired", "resurrected"):
            agg[k] += stats[k]
    return agg


class _Request:
    """One queued request: its queue-entry timestamp (for true
    time-in-queue), a requeue ``attempts`` count (the serving tier rides a
    dying replica's batch through requeues), the real sequence length
    before sequence padding, and the SLO class."""

    __slots__ = ("arr", "fut", "seq", "t_enq", "attempts", "t_real", "slo")

    def __init__(self, arr, fut: Future, seq: int, t_enq: float,
                 attempts: int = 0, t_real: Optional[int] = None,
                 slo: Optional[str] = None):
        self.arr = arr
        self.fut = fut
        self.seq = seq
        self.t_enq = t_enq          # time.monotonic() at queue entry
        self.attempts = attempts
        self.t_real = t_real
        self.slo = slo

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
            self._resurrect = True
            self._resurrect_backoff_ms = 250.0
            self._max_resurrections = 16

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

        def resurrect_dead_replicas(self, enabled: bool = True,
                                    backoff_ms: Optional[float] = None,
                                    max_resurrections: Optional[int] = None
                                    ) -> "ParallelInference.Builder":
            """Replica resurrection (default on): a retired replica is
            replaced after a health probe and a backoff instead of
            shrinking the pool for good."""
            self._resurrect = enabled
            if backoff_ms is not None:
                self._resurrect_backoff_ms = backoff_ms
            if max_resurrections is not None:
                self._max_resurrections = max_resurrections
            return self

        def build(self) -> "ParallelInference":
            return ParallelInference(
                self._model, self._mode, self._batch_limit,
                self._queue_limit, self._max_wait_ms, workers=self._workers,
                request_timeout_ms=self._request_timeout_ms,
                resurrect=self._resurrect,
                resurrect_backoff_ms=self._resurrect_backoff_ms,
                max_resurrections=self._max_resurrections)

    def __init__(self, model, mode: str = "batched", batch_limit: int = 32,
                 queue_limit: int = 64, max_wait_ms: float = 5.0,
                 workers: int = 1,
                 request_timeout_ms: Optional[float] = None,
                 resurrect: bool = True,
                 resurrect_backoff_ms: float = 250.0,
                 max_resurrections: int = 16):
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
        self.resurrect = resurrect
        self.resurrect_backoff_s = resurrect_backoff_ms / 1000.0
        self.max_resurrections = max_resurrections
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self._shutdown = False
        self._lock = threading.Lock()
        self._req_seq = 0
        self._busy = 0
        self._alive = 0
        self._workers: List[threading.Thread] = []
        self._resurrectors: List[threading.Thread] = []
        self._pool_size = 0          # configured capacity
        self._target_alive = 0       # scale_to's target
        self._scale_down_pending = 0  # workers asked to exit at a boundary
        self._scaled_down_total = 0
        self._retired_total = 0
        self._resurrected_total = 0
        self._resurrections_started = 0
        self._probe_seq = 0
        self._probe_input = None
        if self.mode == "batched":
            self._alive = max(1, int(workers))
            self._pool_size = self._target_alive = self._alive
            for i in range(self._alive):
                self._workers.append(self._worker_thread(i))
            for t in self._workers:
                t.start()
        _POOLS.add(self)

    def _worker_thread(self, worker_id: int) -> threading.Thread:
        return threading.Thread(target=self._drain, args=(worker_id,),
                                daemon=True,
                                name=f"dl4j-torch-inference-{worker_id}")

    def alive_replicas(self) -> int:
        with self._lock:
            return self._alive

    def pool_stats(self) -> Dict[str, int]:
        """Live/retired/resurrected census (the ``/api/health`` line)."""
        with self._lock:
            return {"workers": self._pool_size, "alive": self._alive,
                    "target": self._target_alive,
                    "scaled_down": self._scaled_down_total,
                    "retired": self._retired_total,
                    "resurrected": self._resurrected_total}

    # --- online scaling -------------------------------------------------
    def scale_to(self, n: int, reason: str = "manual") -> int:
        """Resize the worker pool online: scale up starts fresh drain
        threads on the shared queue; scale down marks the surplus, and each
        surplus worker exits at its next batch boundary (never abandoning a
        batch it picked up). Returns the new target."""
        if self.mode != "batched":
            raise RuntimeError("scale_to needs a batched worker pool "
                               "(sequential mode has no workers)")
        n = max(1, int(n))
        started: List[threading.Thread] = []
        with self._lock:
            if self._shutdown:
                return self._alive
            self._target_alive = n
            pending = self._scale_down_pending
            effective = self._alive - pending
            if n > effective:
                # cancel queued scale-downs before starting new threads
                cancel = min(pending, n - effective)
                self._scale_down_pending -= cancel
                effective += cancel
                for _ in range(n - effective):
                    t = self._worker_thread(len(self._workers))
                    self._workers.append(t)
                    self._alive += 1
                    started.append(t)
            elif n < effective:
                self._scale_down_pending += effective - n
            self._pool_size = n
        for t in started:
            t.start()
        if started:
            OpProfiler.get().count("inference/workers_started", len(started))
        logger.info("inference pool scaled to %d workers (%s)", n, reason)
        return n

    def _take_scale_down(self, worker_id: int) -> bool:
        """The boundary check a worker runs between batches: True means
        this worker absorbs one pending scale-down and must exit."""
        if not self._scale_down_pending:
            return False
        with self._lock:
            if self._scale_down_pending <= 0:
                return False
            if self._alive <= self._target_alive:
                # a retirement already shrank the pool to the target since
                # this scale-down was queued: absorbing it would underflow
                self._scale_down_pending = 0
                return False
            self._scale_down_pending -= 1
            self._alive -= 1
            self._scaled_down_total += 1
            alive = self._alive
        self._on_scaled_out(worker_id)
        OpProfiler.get().count("inference/workers_stopped")
        logger.info("inference replica %d scaled out; %d workers remain",
                    worker_id, alive)
        return True

    def _on_scaled_out(self, worker_id: int) -> None:
        """Subclass hook: bookkeeping when a worker exits via scale-down."""

    # --- requests -------------------------------------------------------
    def output(self, x, **kwargs) -> torch.Tensor:
        """Synchronous single-request API (``x``: a numpy batch), bounded by
        the request deadline. Keyword arguments pass through to
        ``output_async`` (the serving tier's ``slo_class``)."""
        fut = self.output_async(x, **kwargs)
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
                f"replica or an overloaded queue — raise request_timeout_ms "
                f"or add workers") from None

    def output_async(self, x) -> Future:
        arr = np.asarray(x)
        fut: Future = Future()
        if self._shutdown:
            fut.set_exception(RuntimeError(
                "ParallelInference is shut down; no replicas will serve "
                "this request"))
            return fut
        if self.mode == "sequential":
            try:
                fut.set_result(self._run(arr).cpu())
            except Exception as e:
                fut.set_exception(e)
            return fut
        if self.alive_replicas() == 0:
            fut.set_exception(RuntimeError(
                "all inference replicas have been retired (fatal replica "
                "failures); a resurrection may be pending — retry, or "
                "restart the ParallelInference"))
            return fut
        with self._lock:
            seq = self._req_seq
            self._req_seq += 1
        self._enqueue(_Request(arr, fut, seq, time.monotonic()))
        return fut

    def _enqueue(self, req: _Request) -> None:
        """Queue one request; its future carries the queue-entry timestamp
        (``fut.enqueued_at``)."""
        req.fut.enqueued_at = req.t_enq
        try:
            # bounded by the deadline too: a full queue behind a wedged
            # replica must not turn "timeout instead of hang" into a block
            self._queue.put(req, timeout=self.request_timeout_s)
        except queue.Full:
            req.fut.set_exception(TimeoutError(
                f"inference queue stayed full (depth {self._queue.qsize()}) "
                f"for {self.request_timeout_s:.1f}s ({self.alive_replicas()}/"
                f"{len(self._workers) or 1} replicas alive)"))
            return
        # re-check after enqueueing: the last replica may have retired
        # between the alive check and the put
        if self.alive_replicas() == 0:
            self._fail_queued(RuntimeError(
                "all inference replicas have been retired (fatal replica "
                "failures); a resurrection may be pending — retry, or "
                "restart the ParallelInference"))

    def _run(self, batch) -> torch.Tensor:
        out = self.model.output(batch)
        return out[0] if isinstance(out, (list, tuple)) else out

    # --- retirement and resurrection ---------------------------------------
    def _retire(self, worker_id: int, exc: BaseException, futures) -> None:
        """Shared bookkeeping of every way a worker dies: fail its batch,
        drop it from the pool, fail everything queued when it was the last
        replica, and schedule a replacement. The pool shrinks before the
        batch's futures fail, so a caller that sees the failure also sees
        the smaller pool."""
        OpProfiler.get().count("inference/replica_retired")
        with self._lock:
            self._alive -= 1
            self._retired_total += 1
            last = self._alive == 0
        for fut in futures:
            if not fut.done():
                fut.set_exception(exc if isinstance(exc, Exception)
                                  else RuntimeError(f"inference replica "
                                                    f"died: {exc}"))
        logger.warning("inference replica %d retired (%s); %d replicas "
                       "remain", worker_id, exc, self.alive_replicas())
        if last:
            # bounded latency first: nobody waits out a backoff on a
            # request already queued
            self._fail_queued(RuntimeError("all inference replicas retired"))
        self._schedule_resurrection()

    def _schedule_resurrection(self) -> None:
        if not self.resurrect or self._shutdown or self.mode != "batched":
            return
        with self._lock:
            if self._resurrections_started >= self.max_resurrections:
                logger.warning("inference pool resurrection budget (%d) "
                               "exhausted; pool stays at %d/%d",
                               self.max_resurrections, self._alive,
                               self._pool_size)
                return
            self._resurrections_started += 1
            t = threading.Thread(target=self._resurrector, daemon=True,
                                 name="dl4j-torch-inference-resurrector")
            self._resurrectors.append(t)
        t.start()

    def _probe(self) -> None:
        """Health probe before a replacement joins: the model's device must
        answer (``mesh.probe_device``), then the model re-runs a one-row
        slice of the last batch served (nothing served yet: assumed
        healthy)."""
        faultinject.fault_point("inference/probe", self._next_probe_seq())
        dev = getattr(self.model, "device", None)
        if isinstance(dev, torch.device) and not probe_device(dev):
            raise RuntimeError(f"device {dev} failed its health probe")
        probe = self._probe_input
        if probe is not None:
            self._run(probe)

    def _next_probe_seq(self) -> int:
        with self._lock:
            seq = self._probe_seq
            self._probe_seq += 1
        return seq

    _PROBE_ATTEMPT_LIMIT = 10

    def _resurrector(self) -> None:
        backoff = self.resurrect_backoff_s
        probes = 0
        prof = OpProfiler.get()
        while not self._shutdown:
            # interruptible sleep, so shutdown is not held up
            deadline = time.monotonic() + backoff
            while not self._shutdown and time.monotonic() < deadline:
                time.sleep(min(0.05, backoff))
            if self._shutdown:
                return
            try:
                with nan_panic.scope():
                    self._probe()
            except Exception as e:
                prof.count("inference/probe_failures")
                probes += 1
                if probes >= self._PROBE_ATTEMPT_LIMIT:
                    prof.count("inference/resurrection_abandoned")
                    logger.warning(
                        "inference resurrection abandoned after %d failed "
                        "health probes (last: %s); pool stays at %d/%d",
                        probes, e, self.alive_replicas(), self._pool_size)
                    return
                logger.warning("inference resurrection probe failed (%s); "
                               "backing off %.2fs", e, backoff * 2)
                backoff = min(backoff * 2, 30.0)
                continue
            with self._lock:
                if self._shutdown:
                    return
                if self._alive - self._scale_down_pending \
                        >= self._target_alive:
                    # scaled down past this resurrection since it began
                    superseded = True
                else:
                    superseded = False
                    worker_id = len(self._workers)
                    t = self._worker_thread(worker_id)
                    self._workers.append(t)
                    self._alive += 1
                    self._resurrected_total += 1
                    # counted, and the census the event records read, with
                    # the pool's growth: a caller that sees the replica
                    # alive also sees it counted, and a shutdown racing the
                    # event cannot lower its census
                    prof.count("inference/replica_resurrected")
                    alive_now = self._alive
            if superseded:
                prof.count("inference/resurrection_superseded")
                return
            t.start()
            flightrec.event("inference/resurrected", worker=worker_id,
                            alive=alive_now)
            logger.warning("inference replica %d resurrected; %d/%d "
                           "replicas alive", worker_id, alive_now,
                           self._pool_size)
            return

    # --- the drain loop ---------------------------------------------------
    def _drain(self, worker_id: int) -> None:
        prof = OpProfiler.get()
        while not self._shutdown:
            if self._take_scale_down(worker_id):
                return            # scaled out at a batch boundary
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
                with nan_panic.scope():
                    self._serve_batch(worker_id, batch, prof)
            except faultinject.DeadReplicaFault:
                return            # retired inside _serve_batch
            finally:
                with self._lock:
                    self._busy -= 1
        with self._lock:
            self._alive -= 1

    def _serve_batch(self, worker_id: int, batch: List[_Request],
                     prof) -> None:
        """Run one coalesced batch and scatter its rows to the futures.
        Raises DeadReplicaFault after retiring the worker."""
        futures = [r.fut for r in batch]
        try:
            for r in batch:
                faultinject.fault_point("inference/worker", r.seq)
            merged = np.concatenate([r.arr for r in batch])
            result = self._run(merged).cpu()
            # a one-row copy of a known-good input for the resurrection
            # probe (a copy: a view would pin the whole batch)
            self._probe_input = merged[:1].copy()
            prof.count("inference/batches")
            prof.count("inference/requests", len(batch))
            off = 0
            for r in batch:
                r.fut.set_result(result[off:off + r.n])
                off += r.n
        except faultinject.DeadReplicaFault as e:
            self._retire(worker_id, e, futures)
            raise
        except Exception as e:   # scatter the failure to every waiter
            prof.count("inference/batch_errors")
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
        except BaseException as e:
            # an injected SimulatedCrash must not skip the bookkeeping
            self._retire(worker_id, e, futures)
            raise

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
        with self._lock:
            threads = self._workers + self._resurrectors
        for t in threads:
            if t.is_alive():
                t.join(timeout=max(0.05, deadline - time.monotonic()))
        with self._lock:
            still_busy = self._busy
            self._alive = 0      # pool_health must not count the dead
        if still_busy:
            logger.warning("ParallelInference.shutdown: %d in-flight "
                           "batch(es) did not drain within %.1fs",
                           still_busy, drain_timeout_s)
        _POOLS.discard(self)
        n = self._fail_queued(RuntimeError(
            "ParallelInference shut down with this request still queued"))
        if n:
            logger.warning("ParallelInference.shutdown failed %d queued "
                           "request(s)", n)
