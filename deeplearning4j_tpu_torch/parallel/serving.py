"""Production inference serving: continuous batching over padded shape
buckets.

Counterpart of ``deeplearning4j_tpu/parallel/serving.py``.
:class:`ServingEngine` is a :class:`~.inference.ParallelInference` replica
pool whose workers drain the shared request queue into padded shape
buckets:

- **Shape buckets** (:class:`BucketLadder`): a batch-size ladder (and an
  optional sequence-length ladder). Every request is padded up to the
  smallest admitting bucket, so the set of shapes the model ever sees is
  small, fixed and known at startup.
- **Warmup per bucket and device slot**: where the JAX package compiles one
  AOT executable per bucket, :meth:`ServingEngine.warmup` runs each (bucket
  shape, device slot) once through the model's functional forward
  (``model._forward(params, states, x, False)``), which picks cuDNN's
  algorithms and the caching allocator's blocks for that shape, and records
  the shape in the executable table. ``trace/serving_infer`` counts the
  first forward at each (shape, slot): after warmup it equals buckets x
  slots and stays flat, and ``serving/traces_after_warmup`` (a first
  forward after warmup: a bucket that escaped the warmup set) must stay 0.
- **Params are arguments**: one (params, states) dict per device slot, so
  :meth:`ServingEngine.refresh_params`, a canary, a promote and a rollback
  swap dicts and never warm again. A rollback re-installs the very tensors
  that served before, so it is bitwise by construction.
- **Pad-and-slice**: bucket padding is ``data/pipeline.pad_rows``, the
  wrap-real-rows rule of the training pipeline. The claim the port keeps:
  a request's answer is bitwise the model's forward on the same padded
  bucket, sliced. It does not claim bitwise equality with a forward on the
  unpadded rows: the convolution and matrix-product routines chosen for a
  batch size may sum in another order for another one (the JAX package's
  claim of it depends on its BLAS too).
- **Continuous batching**: workers fill toward the largest bucket under one
  ``max_wait_ms`` deadline; a request that would overflow it (or differs in
  its non-batch shape) is stashed for the next batch, never dropped.
- **bf16** (``Builder.bf16(True)``): params and states cast once with
  ``learning/precision.cast_floating`` at build and at each refresh or
  publication; inputs and outputs stay float32 at the API.
- **Device pinning** (``Builder.pin_devices(True)``): replicas take
  :func:`~.mesh.serving_devices` slots round-robin, each with its own
  param copy; ``Builder.devices(["cuda:0"] * 2)`` gives two slots on one
  card.
- **Replica pool**: retirement is transparent to in-flight requests (a
  dying replica's batch is requeued, at most ``max_requeues`` times, with
  its queue-entry timestamps), resurrection refills the pool, and
  ``scale_to`` resizes it online; new workers reuse the warmed buckets.

**Oversize requests**: under ``oversize="split"`` (the default) a request
with more rows than the largest bucket is split into largest-bucket chunks
served independently and concatenated in order; under ``"reject"`` it
raises :class:`OversizeRequest` at submission. A sequence longer than the
sequence ladder always rejects.

**Overload**: requests may carry an SLO class (:class:`SLOClass`). A shed
request gets :class:`Overloaded` (HTTP 429) synchronously, with a
``Retry-After`` from the measured drain rate. The
:class:`BrownoutController` sheds classes strictly lowest priority first,
one level per tick, and clears a level only after several clean ticks.

**Canaried publication**: :meth:`ServingEngine.publish_checkpoint` swaps
retrained weights onto ONE canary replica, promotes them fleet-wide after
an SLO-clean window, verifies every slot's copy by fingerprint, and rolls
back bitwise on a violation; the ``pub<N>`` correlation id chains canary ->
promote / rollback in the flight recorder.

HTTP serving lives on ``ui/server.UIServer`` (``POST /api/infer``). The
executable census (``common/xprof.py``) records each (bucket shape, slot)'s
first forward as a ``serving/bucket`` variant, and the warmup takes the
``serving_warmup`` memory watermark.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import faultinject, flightrec, nan_panic, xprof
from ..common import integrity as _integ
from ..common.profiler import OpProfiler
from ..common.tree import tree_map
from ..data.pipeline import pad_rows
from ..learning.precision import cast_floating as _cast_floating
from .inference import ParallelInference, _Request, logger
from .mesh import device_pool, probe_device, serving_devices

# live engines, for the /api/health serving census (weak: dropped → gone)
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()

# process-global publication ordinal: the pub<N> correlation id must be
# unique across every engine's lifetime (it is also the serving/promote
# fault index — see next_publication_ordinal)
_pub_lock = threading.Lock()
_pub_next = [0]


def next_publication_ordinal() -> int:
    """The ordinal (= ``serving/promote`` fault index, = the N in the
    ``pub<N>`` correlation id) the NEXT ``publish_checkpoint`` call will
    get — how drills target a specific publication."""
    with _pub_lock:
        return _pub_next[0]


class OversizeRequest(ValueError):
    """A request the bucket ladder refuses: more rows than the largest
    batch bucket under ``oversize="reject"``, or a sequence longer than
    the largest sequence bucket. Raised at submission; nothing is queued."""


class BucketLadder:
    """The bucket policy: sorted batch-size ladder, optional sequence-
    length ladder, and the oversize admission rule.

    ``bucket_batch(n)`` / ``bucket_seq(t)`` return the smallest admitting
    rung; ``admit(n)`` returns the chunk row-counts a request is served
    as (``[n]`` for an in-ladder request)."""

    def __init__(self, batch_sizes: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 seq_lens: Optional[Sequence[int]] = None,
                 oversize: str = "split"):
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch ladder needs positive sizes, got "
                             f"{batch_sizes!r}")
        self.batch_sizes: Tuple[int, ...] = tuple(sizes)
        self.seq_lens: Optional[Tuple[int, ...]] = None
        if seq_lens is not None:
            sl = sorted({int(t) for t in seq_lens})
            if not sl or sl[0] < 1:
                raise ValueError(f"sequence ladder needs positive lengths, "
                                 f"got {seq_lens!r}")
            self.seq_lens = tuple(sl)
        if oversize not in ("split", "reject"):
            raise ValueError(f"oversize must be 'split' or 'reject', got "
                             f"{oversize!r}")
        self.oversize = oversize

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def bucket_batch(self, n: int) -> Optional[int]:
        """Smallest batch bucket >= n, or None when n exceeds the ladder."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return None

    def bucket_seq(self, t: int) -> int:
        """Smallest sequence bucket >= t. Oversize sequences always
        reject."""
        assert self.seq_lens is not None
        for s in self.seq_lens:
            if s >= t:
                return s
        raise OversizeRequest(
            f"sequence length {t} exceeds the largest sequence bucket "
            f"{self.seq_lens[-1]}; lengthen the ladder or truncate "
            f"upstream")

    def admit(self, n: int) -> List[int]:
        """The admission rule. Raises :class:`OversizeRequest` under
        ``oversize='reject'``; splits into max-bucket chunks (+ remainder)
        under ``'split'``."""
        if n < 1:
            raise ValueError(f"a request needs at least one row, got {n}")
        if n <= self.max_batch:
            return [n]
        if self.oversize == "reject":
            raise OversizeRequest(
                f"request of {n} rows exceeds the largest batch bucket "
                f"{self.max_batch} (oversize='reject'); split it client-"
                f"side or configure oversize='split'")
        chunks = [self.max_batch] * (n // self.max_batch)
        if n % self.max_batch:
            chunks.append(n % self.max_batch)
        return chunks

    def shapes(self, feat: Tuple[int, ...]) -> List[Tuple[int, ...]]:
        """Every input shape the ladder admits — the warmup set. ``feat``
        is the per-request feature shape (no batch dim); with a sequence
        ladder its leading entry is the time axis and is replaced by each
        sequence rung."""
        if self.seq_lens is None:
            return [(b,) + tuple(feat) for b in self.batch_sizes]
        if not feat:
            raise ValueError("a sequence ladder needs a feature shape "
                             "with a leading time axis")
        return [(b, t) + tuple(feat[1:])
                for b in self.batch_sizes for t in self.seq_lens]


class Overloaded(RuntimeError):
    """Synchronous load-shed rejection (HTTP 429): the request's SLO class
    is inside the brownout shed set, its queue budget is exhausted, or an
    injected admission fault shed it. ``retry_after_s`` comes from the
    measured queue drain rate."""

    def __init__(self, message: str, slo_class: str, reason: str,
                 retry_after_s: float):
        super().__init__(message)
        self.slo_class = slo_class
        self.reason = reason          # "brownout" | "queue_budget" | "fault"
        self.retry_after_s = float(retry_after_s)


class SLOClass:
    """One admission class. ``priority`` orders shedding (strictly lowest
    first; the top class is never shed), ``p99_ms`` is the class's latency
    budget (the top class's is what the brownout controller defends and
    what a canaried publication's window defaults to), ``queue_budget``
    bounds its outstanding requests."""

    def __init__(self, name: str, priority: int, p99_ms: float,
                 queue_budget: int = 128):
        self.name = str(name)
        self.priority = int(priority)
        self.p99_ms = float(p99_ms)
        self.queue_budget = int(queue_budget)
        if not self.name:
            raise ValueError("an SLO class needs a non-empty name")
        if self.p99_ms <= 0 or self.queue_budget < 1:
            raise ValueError(f"SLO class {name!r} needs p99_ms > 0 and "
                             f"queue_budget >= 1")

    def __repr__(self) -> str:
        return (f"SLOClass({self.name!r}, priority={self.priority}, "
                f"p99_ms={self.p99_ms}, queue_budget={self.queue_budget})")


class AdmissionController:
    """Per-class admission state: outstanding counts against queue
    budgets, the brownout shed LEVEL (level k sheds the k lowest-priority
    classes), completion-rate tracking for ``Retry-After``, and the
    per-class shed counters (``serving/shed/<class>``)."""

    DRAIN_WINDOW_S = 5.0

    def __init__(self, classes: Sequence[SLOClass],
                 default: Optional[str] = None):
        classes = list(classes)
        if not classes:
            raise ValueError("admission control needs >= 1 SLO class")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO class names: {names}")
        if len({c.priority for c in classes}) != len(classes):
            raise ValueError("SLO class priorities must be unique — they "
                             "define the shed order")
        self._lock = threading.Lock()
        # ascending priority: index 0 sheds first, the last never sheds
        self.by_shed_order: Tuple[SLOClass, ...] = tuple(
            sorted(classes, key=lambda c: c.priority))
        self.top = self.by_shed_order[-1]
        self.by_name = {c.name: c for c in classes}
        self._rank = {c.name: i for i, c in enumerate(self.by_shed_order)}
        self.default = default if default is not None else self.top.name
        if self.default not in self.by_name:
            raise ValueError(f"default class {self.default!r} is not one "
                             f"of the configured SLO classes {names}")
        self._level = 0
        self._outstanding: Dict[str, int] = {c.name: 0 for c in classes}
        self._done: "collections.deque" = collections.deque(maxlen=4096)

    def resolve(self, name: Optional[str]) -> SLOClass:
        if name is None:
            name = self.default
        cls = self.by_name.get(name)
        if cls is None:
            raise ValueError(f"unknown SLO class {name!r}; configured: "
                             f"{sorted(self.by_name)}")
        return cls

    def level(self) -> int:
        with self._lock:
            return self._level

    def shed_names(self) -> List[str]:
        with self._lock:
            return [c.name for c in self.by_shed_order[:self._level]]

    def set_level(self, level: int, reason: str = "manual") -> int:
        """Move the shed level (the brownout controller's actuator and the
        drill hook), clamped so the top class is never shed. A change
        emits one ``serving/shed`` event and sets the
        ``serving/shed_level`` gauge."""
        level = max(0, min(int(level), len(self.by_shed_order) - 1))
        with self._lock:
            prev = self._level
            self._level = level
        if level != prev:
            prof = OpProfiler.get()
            prof.gauge("serving/shed_level", level)
            prof.count("serving/brownout_raise" if level > prev
                       else "serving/brownout_lower")
            flightrec.event(
                "serving/shed", severity="warn", level=level, prev=prev,
                shed=[c.name for c in self.by_shed_order[:level]],
                reason=str(reason)[:200])
            logger.warning("serving brownout level %d -> %d (%s)", prev,
                           level, reason)
        return level

    def note_queued(self, name: str) -> None:
        with self._lock:
            self._outstanding[name] = self._outstanding.get(name, 0) + 1

    def release(self, name: str, n: int = 1) -> None:
        """Return ``n`` reserved slots without recording completions (an
        admitted request that never reached the queue)."""
        with self._lock:
            self._outstanding[name] = max(
                0, self._outstanding.get(name, 0) - n)

    def note_done(self, name: str) -> None:
        with self._lock:
            self._outstanding[name] = max(
                0, self._outstanding.get(name, 0) - 1)
            self._done.append(time.monotonic())

    def _drain_rate_locked(self, now: float) -> float:
        recent = sum(1 for t in self._done
                     if now - t <= self.DRAIN_WINDOW_S)
        return recent / self.DRAIN_WINDOW_S

    def retry_after_s(self) -> float:
        """Backlog / measured drain rate, clamped to [0.1 s, 30 s]; with no
        completions observed, a per-request pessimistic constant."""
        now = time.monotonic()
        with self._lock:
            outstanding = sum(self._outstanding.values())
            rate = self._drain_rate_locked(now)
        if rate <= 0:
            return min(30.0, 1.0 + outstanding * 0.05)
        return float(min(30.0, max(0.1, outstanding / rate)))

    def admit(self, cls: SLOClass, n_chunks: int = 1) -> None:
        """Raise :class:`Overloaded` when the class is shed or over its
        queue budget; otherwise reserve ``n_chunks`` outstanding slots
        under the same lock (check-then-reserve atomically)."""
        with self._lock:
            if self._rank[cls.name] < self._level:
                reason = "brownout"
            elif self._outstanding.get(cls.name, 0) + n_chunks \
                    > cls.queue_budget:
                reason = "queue_budget"
            else:
                self._outstanding[cls.name] = \
                    self._outstanding.get(cls.name, 0) + n_chunks
                return
        self.count_shed(cls.name)
        ra = self.retry_after_s()
        raise Overloaded(
            f"request shed ({reason}): class {cls.name!r} "
            + ("is inside the brownout shed set"
               if reason == "brownout" else
               f"already has {cls.queue_budget} request(s) outstanding "
               f"(its queue budget)")
            + f"; retry after {ra:.2f}s", cls.name, reason, ra)

    @staticmethod
    def count_shed(name: str) -> None:
        prof = OpProfiler.get()
        prof.count(f"serving/shed/{name}")
        prof.count("serving/shed_total")

    def stats(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            return {
                "level": self._level,
                "shed": [c.name for c in self.by_shed_order[:self._level]],
                "classes": [c.name for c in reversed(self.by_shed_order)],
                "outstanding": dict(self._outstanding),
                "drain_rate_rps": round(self._drain_rate_locked(now), 3),
            }


class BrownoutController:
    """Keeps the TOP class inside its p99 budget by shedding lower classes.
    Evaluates at a fixed cadence: the level rises one step when the top
    class's recent p99 exceeds its budget or the windowed queue-depth HWM
    reaches the depth trigger, and falls one step only after
    ``clear_ticks`` consecutive clean evaluations (p99 under
    ``hysteresis_frac`` x budget and depth under half the trigger)."""

    def __init__(self, engine: "ServingEngine", adm: AdmissionController,
                 interval_s: float = 0.2,
                 depth_trigger: Optional[int] = None,
                 clear_ticks: int = 5, hysteresis_frac: float = 0.7):
        self.engine = engine
        self.adm = adm
        self.interval_s = float(interval_s)
        self.depth_trigger = (int(depth_trigger) if depth_trigger
                              else max(8, engine._queue.maxsize // 4))
        self.clear_ticks = max(1, int(clear_ticks))
        self.hysteresis_frac = float(hysteresis_frac)
        self._clean = 0           # single writer: the controller thread
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dl4j-torch-serving-brownout")
        self._thread.start()

    def evaluate(self, p99_ms: Optional[float], depth: int) -> int:
        """One control decision from measured signals; returns the level
        in force after it."""
        top = self.adm.top
        over = ((p99_ms is not None and p99_ms > top.p99_ms)
                or depth >= self.depth_trigger)
        level = self.adm.level()
        if over:
            self._clean = 0
            if level < len(self.adm.by_shed_order) - 1:
                return self.adm.set_level(
                    level + 1,
                    reason=f"overload: top p99={p99_ms and round(p99_ms, 1)}"
                           f"ms (budget {top.p99_ms}ms), depth={depth} "
                           f"(trigger {self.depth_trigger})")
            return level
        clean = ((p99_ms is None
                  or p99_ms <= self.hysteresis_frac * top.p99_ms)
                 and depth <= self.depth_trigger // 2)
        if not clean:
            self._clean = 0
            return level
        if level > 0:
            self._clean += 1
            if self._clean >= self.clear_ticks:
                self._clean = 0
                return self.adm.set_level(
                    level - 1, reason=f"recovered: {self.clear_ticks} "
                                      f"clean evaluations")
        return self.adm.level()

    def _run(self) -> None:
        eng = self.engine
        while not eng._shutdown:
            # short sleeps, so shutdown is not held up by a long interval
            deadline = time.monotonic() + self.interval_s
            while not eng._shutdown and time.monotonic() < deadline:
                time.sleep(min(0.05, self.interval_s))
            if eng._shutdown:
                return
            try:
                self.evaluate(
                    eng.class_recent_p99(self.adm.top.name),
                    eng.queue_depth_hwm())
            except Exception:
                logger.warning("brownout evaluation failed", exc_info=True)


class PublishHandle:
    """Tracks one canaried publication to ``"promoted"`` or
    ``"rolled_back"``; ``corr`` is its ``pub<N>`` correlation id."""

    def __init__(self, corr: str, path: str):
        self.corr = corr
        self.path = path
        self.phase = "canary"
        self._done = threading.Event()
        self._outcome: Optional[str] = None

    def _finish(self, outcome: str) -> None:
        self._outcome = outcome
        self.phase = outcome
        self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> str:
        if not self._done.wait(timeout):
            raise TimeoutError(f"publication {self.corr} still in phase "
                               f"{self.phase!r}")
        return self._outcome


def _placed(tree, device):
    """New copies of ``tree``'s tensors on ``device``."""
    return tree_map(lambda t: t.to(device, copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


def _to_cpu_f32(out) -> torch.Tensor:
    if isinstance(out, (list, tuple)):
        out = out[0]
    if not isinstance(out, torch.Tensor):
        out = torch.as_tensor(np.asarray(out))
    return out.detach().to("cpu", torch.float32)


class ServingEngine(ParallelInference):
    """The serving tier: a ParallelInference replica pool whose workers
    drain the shared queue into padded shape buckets. See the module
    docstring for the contract and :class:`Builder` for the knobs."""

    class Builder(ParallelInference.Builder):
        def __init__(self, model):
            super().__init__(model)
            self._max_wait_ms = 2.0      # serving default: tight window
            self._ladder: Optional[BucketLadder] = None
            self._input_shape: Optional[Tuple[int, ...]] = None
            self._in_dtype = np.float32
            self._bf16 = False
            self._warmup = True
            self._max_requeues = 2
            self._pin_devices = False
            self._devices: Optional[Sequence] = None
            self._slo_classes: Optional[List[SLOClass]] = None
            self._default_class: Optional[str] = None
            self._brownout_kw: Dict[str, Any] = {}
            self._qwin_window_s = 5.0

        def inference_mode(self, mode: str) -> "ServingEngine.Builder":
            """Serving is continuous batching; any other mode is refused."""
            if mode.lower() != "batched":
                raise ValueError(
                    f"ServingEngine only serves in 'batched' mode (its "
                    f"continuous-batching drain loop IS the engine), got "
                    f"{mode!r}; use a plain ParallelInference for "
                    f"sequential dispatch")
            return self

        inferenceMode = inference_mode

        def buckets(self, batch_sizes: Sequence[int],
                    seq_lens: Optional[Sequence[int]] = None,
                    oversize: str = "split") -> "ServingEngine.Builder":
            """The bucket ladder (see :class:`BucketLadder`)."""
            self._ladder = BucketLadder(batch_sizes, seq_lens, oversize)
            return self

        def ladder(self, ladder: BucketLadder) -> "ServingEngine.Builder":
            self._ladder = ladder
            return self

        def input_shape(self, shape: Sequence[int],
                        dtype=np.float32) -> "ServingEngine.Builder":
            """Per-request feature shape (without the batch dim), what
            warmup runs. With a sequence ladder the leading entry is the
            time axis (any value; the ladder replaces it)."""
            self._input_shape = tuple(int(s) for s in shape)
            self._in_dtype = np.dtype(dtype)
            return self

        def bf16(self, enabled: bool = True) -> "ServingEngine.Builder":
            """Serve with bfloat16 params and states (one cast at build and
            at each refresh or publication; float32 at the API)."""
            self._bf16 = enabled
            return self

        def warmup(self, enabled: bool) -> "ServingEngine.Builder":
            """Warm the bucket set at build (default); disabled, each
            bucket warms at its first hit (tests only)."""
            self._warmup = enabled
            return self

        def max_requeues(self, n: int) -> "ServingEngine.Builder":
            """How many replica deaths one request may ride through."""
            self._max_requeues = max(0, int(n))
            return self

        def slo_classes(self, classes: Sequence[SLOClass],
                        default: Optional[str] = None
                        ) -> "ServingEngine.Builder":
            """SLO-class admission control; ``default`` names the class of
            an unclassified request (the top class when omitted)."""
            self._slo_classes = [c if isinstance(c, SLOClass)
                                 else SLOClass(*c) for c in classes]
            self._default_class = default
            return self

        def queue_hwm_window(self, seconds: float
                             ) -> "ServingEngine.Builder":
            """Window of the decaying queue-depth high-water mark."""
            self._qwin_window_s = float(seconds)
            return self

        def brownout(self, interval_s: Optional[float] = None,
                     depth_trigger: Optional[int] = None,
                     clear_ticks: Optional[int] = None,
                     hysteresis_frac: Optional[float] = None
                     ) -> "ServingEngine.Builder":
            """Tune the brownout controller (see
            :class:`BrownoutController`)."""
            for k, v in (("interval_s", interval_s),
                         ("depth_trigger", depth_trigger),
                         ("clear_ticks", clear_ticks),
                         ("hysteresis_frac", hysteresis_frac)):
                if v is not None:
                    self._brownout_kw[k] = v
            return self

        def pin_devices(self, enabled: bool = True
                        ) -> "ServingEngine.Builder":
            """Pin replicas round-robin to device slots
            (:func:`~.mesh.serving_devices`), each slot with its own param
            copy (default pool: every card, or the CPU pool for a model on
            the CPU)."""
            self._pin_devices = enabled
            return self

        def devices(self, devices: Sequence) -> "ServingEngine.Builder":
            """The device pool pinned replicas take slots from; a device
            may repeat (``["cuda:0"] * 2``: two slots on one card)."""
            self._devices = list(devices)
            return self

        def build(self) -> "ServingEngine":
            if self._input_shape is None:
                raise ValueError(
                    "ServingEngine needs Builder.input_shape(...): the "
                    "buckets are warmed against it before any request "
                    "arrives")
            return ServingEngine(
                self._model, self._ladder or BucketLadder(),
                self._input_shape, in_dtype=self._in_dtype,
                bf16=self._bf16, warmup=self._warmup,
                max_requeues=self._max_requeues,
                pin_devices=self._pin_devices, devices=self._devices,
                slo_classes=self._slo_classes,
                default_class=self._default_class,
                brownout_kw=self._brownout_kw,
                queue_hwm_window_s=self._qwin_window_s,
                batch_limit=self._batch_limit,
                queue_limit=self._queue_limit,
                max_wait_ms=self._max_wait_ms, workers=self._workers,
                request_timeout_ms=self._request_timeout_ms,
                resurrect=self._resurrect,
                resurrect_backoff_ms=self._resurrect_backoff_ms,
                max_resurrections=self._max_resurrections)

    def __init__(self, model, ladder: BucketLadder,
                 input_shape: Tuple[int, ...], in_dtype=np.float32,
                 bf16: bool = False, warmup: bool = True,
                 max_requeues: int = 2, pin_devices: bool = False,
                 devices: Optional[Sequence] = None,
                 slo_classes: Optional[Sequence[SLOClass]] = None,
                 default_class: Optional[str] = None,
                 brownout_kw: Optional[Dict[str, Any]] = None,
                 queue_hwm_window_s: float = 5.0,
                 **pool_kwargs):
        # subclass state FIRST: super().__init__ starts the drain threads,
        # which call into the overridden _drain immediately
        self.ladder = ladder
        self._feat = tuple(input_shape)
        self._in_dtype = np.dtype(in_dtype)
        self._bf16 = bf16
        self.max_requeues = max_requeues
        self._compute_dtype = torch.bfloat16 if bf16 else None
        self._adm = (AdmissionController(slo_classes, default=default_class)
                     if slo_classes else None)
        # decaying windowed queue-depth high-water mark (two rolling
        # windows; the scale-down-capable signal) + the lifetime peak
        self._qwin_s = float(queue_hwm_window_s)
        self._qwin_start = time.monotonic()
        self._qwin_max = 0
        self._qwin_prev = 0
        self._q_peak = 0
        self._last_dispatch_t = time.monotonic()
        self._lat_recent: "collections.deque" = collections.deque(
            maxlen=2048)                 # (t_done, latency_s), all classes
        self._class_lats: Dict[str, "collections.deque"] = {}
        self._canary: Optional[Dict[str, Any]] = None
        self._pub_threads: List[threading.Thread] = []
        self._brownout: Optional[BrownoutController] = None
        self._aot = hasattr(model, "_forward") and hasattr(model, "_params")
        if pin_devices:
            pool = devices if devices is not None else device_pool(
                getattr(model, "device", None))
            self._devices: List[Any] = serving_devices(
                pool_kwargs.get("workers", 1), pool)
        else:
            self._devices = [None]
        # worker -> device slot; a retired worker's slot is freed for its
        # replacement (resurrection mints new worker ids)
        self._dev_of: Dict[int, int] = {}
        self._dev_free: List[int] = []
        self._stash_lock = threading.Lock()
        self._stashq: "collections.deque" = collections.deque()
        self._exec: Dict[Any, bool] = {}    # (shape, slot): warmed
        self._exec_lock = threading.Lock()
        self._lat_lock = threading.Lock()
        self._latencies: "collections.deque" = collections.deque(maxlen=4096)
        self._batch_seq = 0
        self._admit_seq = 0          # request ordinal (serving/enqueue)
        self._warm = False
        # THIS engine's first-forward count: the after-warmup alarm must
        # not fire on another engine's warmup
        self._trace_cell = [0]
        self._traces_seen = 0
        # None = unknown (shape heuristic), True/False once warmup has
        # probed whether outputs carry a per-timestep axis to slice
        self._seq_out_per_timestep: Optional[bool] = None
        self._dev_params: Dict[int, Any] = {}
        pool_kwargs.setdefault("mode", "batched")
        if self._aot:
            # before the workers start: a dispatch needs its slot's params
            self.model = model
            self._dev_params = self._place_params(
                *self._cast_serving(model._params, model._states))
        super().__init__(model, **pool_kwargs)
        #: seconds per warmed (bucket shape, slot), from :meth:`warmup`
        self.warmup_timings: Dict[str, float] = (self.warmup() if warmup
                                                 else {})
        if self._adm is not None:
            self._brownout = BrownoutController(self, self._adm,
                                                **(brownout_kw or {}))
            self._brownout.start()
        _ENGINES.add(self)

    # --- params ------------------------------------------------------------
    def _slot_device(self, slot: int) -> torch.device:
        dev = self._devices[slot]
        return dev.device if dev is not None else self.model.device

    def _cast_serving(self, params, states):
        if self._bf16:
            params = _cast_floating(params, torch.bfloat16)
            states = _cast_floating(states, torch.bfloat16)
        return params, states

    def _place_params(self, params, states) -> Dict[int, Any]:
        """One (params, states) copy per device slot: the arguments every
        bucket forward takes, so swapping a slot's entry (refresh, canary,
        promote, rollback) never warms again. Copies, never the model's
        own tensors: a fit that updates the model in place does not reach
        the served weights before :meth:`refresh_params`."""
        return {i: (_placed(params, self._slot_device(i)),
                    _placed(states, self._slot_device(i)))
                for i in range(len(self._devices))}

    def _snapshot_params(self) -> None:
        params, states = self._cast_serving(self.model._params,
                                            self.model._states)
        placed = self._place_params(params, states)
        with self._lock:
            self._dev_params = placed

    def _params_for(self, worker_id: Optional[int], dev_slot: int):
        """The params a dispatch uses: the canary replica reads the
        candidate weights during a publication's canary phase; everyone
        else reads the fleet set (whole dicts swap under the pool lock)."""
        can = self._canary
        if can is not None and worker_id is not None \
                and can.get("phase") == "canary" \
                and can.get("worker") == worker_id:
            return can["canary_params"]
        return self._dev_params[dev_slot]

    def refresh_params(self) -> None:
        """Re-snapshot the model's (possibly retrained) params into the
        serving copies, without warming again. Refused while a canaried
        publication is in flight."""
        if not self._aot:
            return
        with self._lock:
            if self._canary is not None:
                raise RuntimeError(
                    f"refresh_params refused: publication "
                    f"{self._canary['corr']} is in flight (phase "
                    f"{self._canary['phase']!r}); wait for it to resolve "
                    f"or use publish_checkpoint for the next weights")
        self._snapshot_params()

    # --- the bucket forward ------------------------------------------------
    def forward_bucket(self, params, states, x: torch.Tensor
                       ) -> torch.Tensor:
        """The served function: the model's functional inference forward of
        one padded bucket ``x`` (on the slot's device) with the given
        params, float32 out."""
        model = self.model
        with torch.inference_mode():
            if self._compute_dtype is not None and x.is_floating_point():
                x = x.to(self._compute_dtype)
            names = getattr(getattr(model, "conf", None), "network_inputs",
                            None)
            if names is not None:                   # ComputationGraph
                acts, _ = model._forward(params, states, {names[0]: x},
                                         False)
                out = acts[model.conf.network_outputs[0]]
            else:                                   # MultiLayerNetwork
                out, _ = model._forward(params, states, x, False)
            return out.float()

    def _compile_bucket(self, shape: Tuple[int, ...], dev_idx: int = 0
                        ) -> bool:
        """Record one (bucket shape, slot) in the executable table; the
        first call for a key counts ``trace/serving_infer`` (the forward
        that follows is the shape's first). Returns whether it was new."""
        key = (shape, dev_idx)
        if key in self._exec:          # lock-free steady-state path
            return False
        with self._exec_lock:
            if key in self._exec:
                return False
            self._exec[key] = True
            if self._aot:
                OpProfiler.get().count("trace/serving_infer")
                self._trace_cell[0] += 1
            OpProfiler.get().count("serving/buckets_compiled")
            return True

    def warmup(self) -> Dict[str, float]:
        """Run every ladder bucket (x device slot) once up front, so
        steady-state serving never meets a new shape. Returns {shape:
        seconds}; the total is the ``serving/warmup`` section."""
        prof = OpProfiler.get()
        timings: Dict[str, float] = {}
        seq_out: Dict[int, Optional[int]] = {}
        with prof.time_section("serving/warmup"):
            for shape in self.ladder.shapes(self._feat):
                for i in range(len(self._devices)):
                    t0 = time.perf_counter()
                    out = self._run_bucket(np.zeros(shape, self._in_dtype),
                                           i)
                    if i == 0 and self.ladder.seq_lens is not None:
                        seq_out[shape[1]] = (out.shape[1]
                                             if out.ndim >= 2 else None)
                    timings[f"{shape}@{i}" if len(self._devices) > 1
                            else str(shape)] = time.perf_counter() - t0
        if len(seq_out) >= 2:
            # two or more sequence rungs tell per-timestep outputs (dim 1
            # tracks the padded length) from pooled ones
            self._seq_out_per_timestep = all(w == t
                                             for t, w in seq_out.items())
        self._traces_seen = self._trace_cell[0]
        self._warm = True
        # the warmup placed every slot's params and ran every bucket: the
        # serving tier's steady-state memory footprint starts here
        xprof.memory_watermark("serving_warmup")
        return timings

    def _run_bucket(self, padded, dev_idx: int = 0,
                    worker_id: Optional[int] = None) -> torch.Tensor:
        """One padded bucket through the slot's params; a float32 CPU
        tensor out (the one device-to-host copy of a dispatch)."""
        slot = dev_idx % len(self._devices)
        first = self._compile_bucket(tuple(padded.shape), slot)
        if not self._aot:                     # a model without _forward
            return _to_cpu_f32(self.model.output(padded))
        params, states = self._params_for(worker_id, slot)
        x = torch.from_numpy(np.ascontiguousarray(
            padded, dtype=self._in_dtype)).to(self._slot_device(slot))
        OpProfiler.get().count("serving/forwards")
        if first and xprof.enabled():
            # the census's counterpart of an AOT executable: the shape's
            # first forward, counted (flops, bytes, memory) and timed
            t0 = time.perf_counter()
            out, record = xprof.count_call(self.forward_bucket, params,
                                           states, x)
            out = out.cpu()
            xprof.register_aot("serving/bucket", record,
                               variant=f"{tuple(padded.shape)}/dev{slot}",
                               compile_s=time.perf_counter() - t0)
            return out
        return self.forward_bucket(params, states, x).cpu()

    def _run(self, batch) -> torch.Tensor:
        """Single-batch path (health probes): the same buckets, padded and
        sliced like any served request."""
        n = batch.shape[0]
        bucket = self.ladder.bucket_batch(n)
        if bucket is None:
            return _to_cpu_f32(super()._run(batch))   # oversize: direct
        padded, _w = pad_rows(batch, bucket)
        return self._run_bucket(padded)[:n]

    # --- request admission ---------------------------------------------
    def output_async(self, x, slo_class: Optional[str] = None) -> Future:
        """Admit one request. Oversize rejections, shape violations and
        SLO sheds (:class:`Overloaded`) raise synchronously; every admitted
        request resolves through its future (a float32 CPU tensor)."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        arr = np.asarray(x)
        if arr.ndim != len(self._feat) + 1:
            raise ValueError(
                f"request rank {arr.ndim} does not match the serving "
                f"input shape (batch, *{self._feat})")
        if arr.dtype != self._in_dtype:
            arr = arr.astype(self._in_dtype)
        prof = OpProfiler.get()
        with self._lock:
            # the request ordinal (one per output_async call), distinct
            # from _req_seq, which ticks once per queued chunk
            admit_seq = self._admit_seq
            self._admit_seq += 1
        cls = None
        if self._adm is not None:
            cls = self._adm.resolve(slo_class)
            try:
                # the admission drill site: `slow` stalls the decision,
                # `transient` sheds THIS request
                faultinject.fault_point("serving/admission", admit_seq)
            except faultinject.TransientFault as e:
                AdmissionController.count_shed(cls.name)
                raise Overloaded(
                    f"injected admission fault shed request {admit_seq} "
                    f"(class {cls.name!r})", cls.name, "fault",
                    self._adm.retry_after_s()) from e
        elif slo_class is not None:
            raise ValueError(
                f"slo_class={slo_class!r} given but no SLO classes are "
                f"configured (Builder.slo_classes)")
        t_real = None
        if self.ladder.seq_lens is not None:
            t = int(arr.shape[1])
            tb = self.ladder.bucket_seq(t)    # oversize seq: raises
            if arr.shape[2:] != self._feat[1:]:
                raise ValueError(
                    f"request feature shape {arr.shape[2:]} does not "
                    f"match the serving input shape {self._feat[1:]}")
            if tb != t:
                arr, _w = pad_rows(arr, tb, axis=1)
                prof.count("serving/seq_padded")
            t_real = t
        elif arr.shape[1:] != self._feat:
            raise ValueError(
                f"request feature shape {arr.shape[1:]} does not match "
                f"the serving input shape {self._feat}")
        try:
            chunks = self.ladder.admit(arr.shape[0])
        except OversizeRequest:
            prof.count("serving/oversize_rejected")
            raise
        if cls is not None:
            self._adm.admit(cls, len(chunks))     # sheds here, or reserves
        try:
            faultinject.fault_point("serving/enqueue", admit_seq)
        except BaseException:
            if cls is not None:     # the reservation must not leak
                self._adm.release(cls.name, len(chunks))
            raise
        slo = cls.name if cls is not None else None
        if len(chunks) == 1:
            return self._submit(arr, t_real, slo=slo)
        prof.count("serving/oversize_split")
        futs, off = [], 0
        for c in chunks:
            futs.append(self._submit(arr[off:off + c], t_real, slo=slo))
            off += c
        return self._aggregate(futs)

    def _submit(self, arr: np.ndarray, t_real: Optional[int],
                slo: Optional[str] = None) -> Future:
        fut: Future = Future()
        if slo is not None:
            # the slot reserved in admit() comes back on every resolution
            # path (a callback added after resolution fires at once)
            fut.add_done_callback(
                lambda f, _n=slo: self._adm.note_done(_n))
        if self._shutdown:
            fut.set_exception(RuntimeError(
                "ServingEngine is shut down; no replicas will serve this "
                "request"))
            return fut
        if self.alive_replicas() == 0:
            fut.set_exception(RuntimeError(
                "all serving replicas have been retired; a resurrection "
                "may be pending — retry, or rebuild the engine"))
            return fut
        with self._lock:
            seq = self._req_seq
            self._req_seq += 1
            depth = self._queue.qsize() + 1
        self._qwin_update(depth)
        self._publish_queue_gauges()
        # lifecycle leg 1 (enqueue → batch → dispatch → reply), before the
        # put: a worker's batch/reply events must not precede it
        if flightrec.enabled():
            flightrec.event("serving/enqueue", corr=f"req{seq}", req=seq,
                            rows=int(arr.shape[0]))
        self._enqueue(_Request(arr, fut, seq, time.monotonic(),
                               t_real=t_real, slo=slo))
        return fut

    def _aggregate(self, futs: List[Future]) -> Future:
        """Recombine a split oversize request in submission order; the
        first chunk failure fails the whole request."""
        parent: Future = Future()
        parent.enqueued_at = min(getattr(f, "enqueued_at", time.monotonic())
                                 for f in futs)
        remaining = [len(futs)]
        lock = threading.Lock()

        def one_done(f: Future) -> None:
            with lock:
                if parent.done():
                    return
                exc = f.exception()
                if exc is not None:
                    parent.set_exception(exc)
                    return
                remaining[0] -= 1
                if remaining[0]:
                    return
            parent.set_result(torch.cat([fu.result() for fu in futs]))

        for f in futs:
            f.add_done_callback(one_done)
        return parent

    # --- load signals ---------------------------------------------------
    def _qwin_update(self, depth: Optional[int] = None) -> int:
        """Roll the two-window queue-depth high-water state (folding in a
        new sample); returns the windowed high-water mark, which decays to
        0 within about two windows of the backlog clearing."""
        now = time.monotonic()
        with self._lock:
            elapsed = now - self._qwin_start
            if elapsed >= 2 * self._qwin_s:
                self._qwin_prev = 0
                self._qwin_max = 0
                self._qwin_start = now
            elif elapsed >= self._qwin_s:
                self._qwin_prev = self._qwin_max
                self._qwin_max = 0
                self._qwin_start = now
            if depth is not None:
                if depth > self._qwin_max:
                    self._qwin_max = depth
                if depth > self._q_peak:
                    self._q_peak = depth
            return max(self._qwin_max, self._qwin_prev)

    def queue_depth_hwm(self) -> int:
        """The decaying windowed queue-depth high-water mark."""
        return self._qwin_update()

    @property
    def queue_depth_peak(self) -> int:
        """Lifetime queue-depth maximum (only ever rises)."""
        return self._q_peak

    def _publish_queue_gauges(self) -> None:
        """``serving/queue_depth_hwm`` = max windowed high-water over live
        engines; ``serving/queue_depth_peak`` = lifetime max."""
        prof = OpProfiler.get()
        win, peak = 0, 0
        for e in list(_ENGINES):
            win = max(win, e.queue_depth_hwm())
            peak = max(peak, e._q_peak)
        prof.gauge("serving/queue_depth_hwm", win)
        if peak > prof.counter_value("serving/queue_depth_peak"):
            prof.gauge("serving/queue_depth_peak", peak)

    def idle_seconds(self) -> float:
        """Seconds since the last batch dispatch."""
        return time.monotonic() - self._last_dispatch_t

    def recent_p99_ms(self, window_s: float = 5.0,
                      min_samples: int = 5) -> Optional[float]:
        """p99 latency over requests completed in the trailing window (all
        classes), or None with fewer than ``min_samples``."""
        now = time.monotonic()
        with self._lat_lock:
            vals = [lat for t, lat in self._lat_recent
                    if now - t <= window_s]
        if len(vals) < min_samples:
            return None
        return float(np.percentile(np.asarray(vals) * 1e3, 99))

    def class_recent_p99(self, name: str, window_s: float = 5.0,
                         min_samples: int = 5) -> Optional[float]:
        """Windowed per-class p99 (ms), the brownout's and the
        watchtower's latency signal; None until ``min_samples`` land in
        the window."""
        now = time.monotonic()
        with self._lat_lock:
            dq = self._class_lats.get(name)
            vals = ([lat for t, lat in dq if now - t <= window_s]
                    if dq else [])
        if len(vals) < min_samples:
            return None
        return float(np.percentile(np.asarray(vals) * 1e3, 99))

    def slo_classes(self) -> List[SLOClass]:
        """The configured SLO classes, highest priority first."""
        if self._adm is None:
            return []
        return list(reversed(self._adm.by_shed_order))

    def class_latency_stats(self) -> Dict[str, Dict[str, float]]:
        """Rolling per-class p50/p99 (ms) over each class's last <= 2048
        requests."""
        with self._lat_lock:
            per_class = {name: [lat for _, lat in dq]
                         for name, dq in self._class_lats.items() if dq}
        out: Dict[str, Dict[str, float]] = {}
        for name, vals in per_class.items():
            arr = np.asarray(vals) * 1e3
            out[name] = {"window": len(vals),
                         "p50_ms": float(np.percentile(arr, 50)),
                         "p99_ms": float(np.percentile(arr, 99))}
        return out

    def _on_scaled_out(self, worker_id: int) -> None:
        """A worker leaving by scale-down frees its device slot."""
        with self._lock:
            dev = self._dev_of.pop(worker_id, None)
            if dev is not None:
                self._dev_free.append(dev)

    # --- continuous-batching drain --------------------------------------
    def _next_request(self, timeout: float) -> Optional[_Request]:
        with self._stash_lock:
            if self._stashq:
                return self._stashq.popleft()
        try:
            return self._queue.get(timeout=max(0.0, timeout))
        except queue.Empty:
            return None

    def _stash(self, req: _Request) -> None:
        """Hold a request this batch cannot take for the NEXT batch;
        stashed requests outrank the queue."""
        with self._stash_lock:
            self._stashq.append(req)

    def _drain(self, worker_id: int) -> None:
        prof = OpProfiler.get()
        with self._lock:
            if worker_id not in self._dev_of:
                # claim a device slot: a retired worker's freed slot first
                # (the replacement takes over its device), round-robin
                # otherwise
                self._dev_of[worker_id] = (
                    self._dev_free.pop() if self._dev_free
                    else worker_id % len(self._devices))
        while not self._shutdown:
            if self._take_scale_down(worker_id):
                return     # scaled out at a batch boundary, nothing held
            first = self._next_request(0.1)
            if first is None:
                continue
            batch, rows = [first], first.n
            shape_tail = first.arr.shape[1:]
            # fill toward the LARGEST bucket under one absolute deadline
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.ladder.max_batch:
                nxt = self._next_request(deadline - time.monotonic())
                if nxt is None:
                    break
                if (nxt.arr.shape[1:] != shape_tail
                        or rows + nxt.n > self.ladder.max_batch):
                    self._stash(nxt)
                    break
                batch.append(nxt)
                rows += nxt.n
            with self._lock:
                self._busy += 1
            try:
                with nan_panic.scope():
                    self._dispatch(worker_id, batch, rows, prof)
            except faultinject.DeadReplicaFault:
                return          # replica retired inside _dispatch
            finally:
                with self._lock:
                    self._busy -= 1
        with self._lock:
            self._alive -= 1

    def _dispatch(self, worker_id: int, batch: List[_Request], rows: int,
                  prof) -> None:
        with self._lock:
            ordinal = self._batch_seq
            self._batch_seq += 1
            self._last_dispatch_t = time.monotonic()
        # leg 2, before the drill site: a killed dispatch still shows which
        # requests were aboard
        if flightrec.enabled():
            flightrec.event("serving/batch", batch=ordinal, rows=rows,
                            worker=worker_id,
                            reqs=[int(r.seq) for r in batch])
        try:
            faultinject.fault_point("serving/dispatch", ordinal)
        except faultinject.TransientFault:
            # one deterministic requeue-and-retry; the requests keep their
            # queue-entry timestamps
            self._requeue(batch, faultinject.TransientFault(
                "serving dispatch retry budget exhausted"))
            return
        except faultinject.DeadReplicaFault as e:
            self._retire_serving(worker_id, e, batch)
            raise
        bucket = self.ladder.bucket_batch(rows)
        merged = (batch[0].arr if len(batch) == 1
                  else np.concatenate([r.arr for r in batch], axis=0))
        padded, _w = pad_rows(merged, bucket)
        try:
            with prof.time_section("serving/dispatch"):
                result = self._run_bucket(
                    padded, self._dev_of.get(worker_id, 0),
                    worker_id=worker_id)
        except faultinject.DeadReplicaFault as e:
            self._retire_serving(worker_id, e, batch)
            raise
        except Exception as e:
            prof.count("serving/batch_errors")
            self._note_canary_result(worker_id, error=True)
            for r in batch:
                if not r.fut.done():
                    r.fut.set_exception(e)
            return
        except BaseException as e:
            # an injected SimulatedCrash must still retire cleanly
            self._retire(worker_id, e, [r.fut for r in batch])
            raise
        self._probe_input = padded[:1].copy()
        t_done = time.monotonic()
        t_pad = padded.shape[1] if padded.ndim >= 2 else None
        off = 0
        lats = []
        for r in batch:
            out = result[off:off + r.n]
            off += r.n
            if (r.t_real is not None and out.ndim >= 2
                    and out.shape[1] == t_pad
                    and self._seq_out_per_timestep is not False):
                # per-timestep output: slice the sequence pad back off
                out = out[:, :r.t_real]
            lats.append(t_done - r.t_enq)
            r.fut.set_result(out)
            if flightrec.enabled():
                flightrec.event(
                    "serving/reply", corr=f"req{r.seq}", req=int(r.seq),
                    batch=ordinal,
                    latency_ms=round((t_done - r.t_enq) * 1e3, 3))
        with self._lat_lock:
            self._latencies.extend(lats)
            self._lat_recent.extend((t_done, lat) for lat in lats)
            for r, lat in zip(batch, lats):
                if r.slo is not None:
                    self._class_lats.setdefault(
                        r.slo, collections.deque(maxlen=2048)
                    ).append((t_done, lat))
        self._note_canary_result(worker_id, lats=lats)
        prof.count("serving/requests", len(batch))
        prof.count("serving/batches")
        prof.count("serving/rows", rows)
        prof.count("serving/pad_rows", bucket - rows)
        prof.count("serving/capacity_rows", bucket)
        if self._warm and self._trace_cell[0] > self._traces_seen:
            # the one thing steady-state serving must never do
            with self._lock:
                delta = self._trace_cell[0] - self._traces_seen
                if delta > 0:
                    prof.count("serving/traces_after_warmup", delta)
                    self._traces_seen = self._trace_cell[0]
            if delta > 0:
                logger.warning("serving met a new shape AFTER warmup (%s) "
                               "— a bucket escaped the warmup set",
                               padded.shape)

    def _requeue(self, batch: List[_Request], exhausted_exc) -> None:
        prof = OpProfiler.get()
        for r in batch:
            r.attempts += 1
            if r.attempts > self.max_requeues:
                if not r.fut.done():
                    r.fut.set_exception(exhausted_exc)
                continue
            try:
                self._queue.put_nowait(r)
            except queue.Full:
                if not r.fut.done():
                    r.fut.set_exception(TimeoutError(
                        "serving queue full while requeueing a request "
                        "from a retired replica"))
                continue
            prof.count("serving/requeued")

    def _retire_serving(self, worker_id: int, exc: BaseException,
                        batch: List[_Request]) -> None:
        """Retirement transparent to in-flight requests: requeue the dying
        replica's batch, free its device slot, then the pool's shared
        retirement bookkeeping."""
        flightrec.event("serving/retire", severity="warn",
                        worker=worker_id, error=repr(exc)[:200],
                        requeued=[int(r.seq) for r in batch])
        self._requeue(batch, exc)
        with self._lock:
            dev = self._dev_of.pop(worker_id, None)
            if dev is not None:
                self._dev_free.append(dev)
        self._retire(worker_id, exc, [])      # casualties already failed

    def _probe(self) -> None:
        """Resurrection health probe on the device slot the replacement
        will claim: the slot's device must answer
        (``mesh.probe_device``), then a one-row bucket of the last served
        input runs there."""
        faultinject.fault_point("inference/probe", self._next_probe_seq())
        with self._lock:
            dev = self._dev_free[-1] if self._dev_free else 0
        slot = self._devices[dev]
        target = slot if slot is not None else getattr(self.model,
                                                       "device", None)
        if target is not None and not probe_device(target):
            raise RuntimeError(f"device slot {dev} ({target}) failed its "
                               f"health probe")
        probe = self._probe_input
        if probe is None:
            return
        bucket = self.ladder.bucket_batch(probe.shape[0])
        if bucket is None:
            self._run(probe)
            return
        padded, _w = pad_rows(probe, bucket)
        self._run_bucket(padded, dev)

    # --- canaried train-to-serve handoff --------------------------------
    _CANARY_PHASES = {"idle": 0, "canary": 1, "confirm": 2}

    def _note_canary_result(self, worker_id: int, lats: Sequence[float] = (),
                            error: bool = False) -> None:
        """Feed one dispatch outcome into the live publication's evidence:
        in the canary phase only the canary replica's count; after promote,
        the whole fleet's."""
        if self._canary is None:
            return
        with self._lock:
            can = self._canary
            if can is None:
                return
            if can["phase"] == "canary" and can.get("worker") != worker_id:
                return
            if error:
                can["errors"] += 1
            else:
                can["lats"].extend(lats)

    def _set_canary_phase(self, phase: str) -> None:
        OpProfiler.get().gauge("serving/canary_phase",
                               self._CANARY_PHASES[phase])

    def publish_checkpoint(self, path: str, canary_window_s: float = 3.0,
                           confirm_window_s: Optional[float] = None,
                           check_interval_s: float = 0.25,
                           min_samples: int = 8,
                           violation_p99_ms: Optional[float] = None
                           ) -> PublishHandle:
        """Canaried train-to-serve handoff: read the weights of a committed
        checkpoint (``util/checkpoint.read_checkpoint_params``), cast and
        place them per slot, and serve them from ONE canary replica. After
        an SLO-clean ``canary_window_s`` they promote fleet-wide, every
        slot's copy is verified by ``host_fingerprint``, and a
        ``confirm_window_s`` watch follows. A violation (serving errors on
        the new weights, p99 over ``violation_p99_ms`` — default: the top
        SLO class's budget — a slot whose copy disagrees, or an injected
        ``serving/promote`` fault) rolls back to the prior tensors,
        bitwise. With a p99 budget in force the promote also needs
        ``min_samples`` of canary evidence. One publication at a time."""
        if not self._aot:
            raise RuntimeError(
                "publish_checkpoint needs a model with a functional forward "
                "(a model without _forward serves through its own output "
                "and owns its weights)")
        # claim the slot FIRST: a refused publish must not burn an ordinal
        with self._lock:
            if self._canary is not None:
                raise RuntimeError(
                    f"publication {self._canary['corr']} is still in "
                    f"flight (phase {self._canary['phase']!r})")
            self._canary = {"phase": "loading", "corr": "pending",
                            "worker": None, "errors": 0, "lats": []}
        try:
            from ..util.checkpoint import read_checkpoint_params

            params, states = read_checkpoint_params(
                path, self.model._params, self.model._states)
            params, states = self._cast_serving(params, states)
            new_placed = self._place_params(params, states)
            # the canary replica: any live worker that claimed a slot
            deadline = time.monotonic() + 5.0
            worker = None
            while time.monotonic() < deadline:
                with self._lock:
                    if self._dev_of:
                        worker = next(iter(self._dev_of))
                        break
                time.sleep(0.01)
            if worker is None:
                raise RuntimeError("no live serving worker to canary "
                                   "onto")
        except BaseException:
            with self._lock:
                self._canary = None
            raise
        with _pub_lock:
            ordinal = _pub_next[0]
            _pub_next[0] += 1
        with self._lock:
            corr = f"pub{ordinal}"
            handle = PublishHandle(corr, path)
            slot = self._dev_of.get(worker, 0)
            budget = violation_p99_ms
            if budget is None and self._adm is not None:
                budget = self._adm.top.p99_ms
            self._canary = {
                "ordinal": ordinal, "corr": corr,
                "file": os.path.basename(path), "phase": "canary",
                "worker": worker, "canary_params": new_placed[slot],
                "new": new_placed, "prior": dict(self._dev_params),
                "lats": [], "errors": 0, "budget_ms": budget,
                "min_samples": int(min_samples), "handle": handle,
            }
        OpProfiler.get().count("serving/publications")
        self._set_canary_phase("canary")
        flightrec.event("serving/canary", corr=corr,
                        file=os.path.basename(path), worker=worker,
                        window_s=canary_window_s, budget_ms=budget)
        t = threading.Thread(
            target=self._canary_monitor,
            args=(canary_window_s,
                  canary_window_s if confirm_window_s is None
                  else confirm_window_s,
                  max(0.01, float(check_interval_s))),
            daemon=True, name=f"dl4j-torch-serving-canary-{ordinal}")
        with self._lock:
            self._pub_threads = [x for x in self._pub_threads
                                 if x.is_alive()]
            self._pub_threads.append(t)
        t.start()
        return handle

    def _canary_monitor(self, canary_window_s: float,
                        confirm_window_s: float, interval_s: float) -> None:
        with self._lock:
            can = self._canary
        if can is None:
            return
        deadline = time.monotonic() + canary_window_s
        while time.monotonic() < deadline:
            if self._shutdown:
                self._rollback(can, "canary", "engine shutdown")
                return
            time.sleep(interval_s)
            v = self._canary_violation(can)
            if v:
                self._rollback(can, "canary", v)
                return
        with self._lock:
            evidence = len(can["lats"]) + can["errors"]
            budget = can["budget_ms"]
        if budget is not None and evidence < can["min_samples"]:
            # a budget is in force but the canary served no judgeable
            # evidence: promoting would ship untested weights
            self._rollback(can, "canary",
                           f"insufficient canary evidence: {evidence} "
                           f"sample(s), need {can['min_samples']}")
            return
        # SLO-clean canary window: PROMOTE fleet-wide (an atomic dict swap)
        with self._lock:
            self._dev_params = can["new"]
            can["phase"] = "confirm"
            can["lats"] = []         # confirm judges fresh fleet evidence
            can["errors"] = 0
        can["handle"].phase = "confirm"
        self._set_canary_phase("confirm")
        flightrec.event("serving/promote", corr=can["corr"],
                        file=can["file"], replicas=self.alive_replicas())
        # post-promote fleet verify: every slot's copy must digest alike
        prof = OpProfiler.get()
        prof.count("integrity/publish_checks")
        digests = {slot: _integ.host_fingerprint(entry[0])
                   for slot, entry in can["new"].items()}
        counts = collections.Counter(digests.values())
        if len(counts) > 1:
            majority = counts.most_common(1)[0][0]
            bad = sorted(s for s, d in digests.items() if d != majority)
            prof.count("integrity/publish_divergences")
            self._rollback(can, "confirm",
                           f"post-promote fingerprint mismatch on "
                           f"slot(s) {bad}")
            return
        deadline = time.monotonic() + confirm_window_s
        while time.monotonic() < deadline:
            if self._shutdown:
                self._rollback(can, "confirm", "engine shutdown")
                return
            time.sleep(interval_s)
            try:
                # the forced-violation drill site (publication ordinal)
                faultinject.fault_point("serving/promote", can["ordinal"])
            except faultinject.TransientFault as e:
                self._rollback(can, "confirm", f"injected violation: {e}")
                return
            v = self._canary_violation(can)
            if v:
                self._rollback(can, "confirm", v)
                return
        with self._lock:
            self._canary = None
        prof.count("serving/promotions")
        self._set_canary_phase("idle")
        can["handle"]._finish("promoted")
        logger.info("serving publication %s promoted fleet-wide (%s)",
                    can["corr"], can["file"])

    def _canary_violation(self, can: Dict[str, Any]) -> Optional[str]:
        with self._lock:
            errors = can["errors"]
            lats = list(can["lats"])
            budget = can["budget_ms"]
            need = can["min_samples"]
        if errors:
            return f"{errors} serving error(s) on the candidate weights"
        if budget is not None and len(lats) >= need:
            p99 = float(np.percentile(np.asarray(lats) * 1e3, 99))
            if p99 > budget:
                return (f"p99 {p99:.1f}ms over the {budget:.0f}ms budget "
                        f"({len(lats)} samples)")
        return None

    def _rollback(self, can: Dict[str, Any], phase: str,
                  reason: str) -> None:
        """Restore the prior param set bitwise: the very tensors that
        served before are re-installed."""
        with self._lock:
            self._dev_params = can["prior"]
            self._canary = None
        OpProfiler.get().count("serving/rollbacks")
        self._set_canary_phase("idle")
        flightrec.event("serving/rollback", severity="warn",
                        corr=can["corr"], file=can["file"], phase=phase,
                        reason=str(reason)[:200])
        logger.warning("serving publication %s rolled back during %s: %s",
                       can["corr"], phase, reason)
        can["handle"]._finish("rolled_back")

    def shutdown(self, drain_timeout_s: float = 2.0) -> None:
        super().shutdown(drain_timeout_s)
        # canary monitors observe _shutdown and resolve their handles
        for t in list(self._pub_threads):
            t.join(timeout=2.0)
        bt = self._brownout._thread if self._brownout else None
        if bt is not None:
            bt.join(timeout=2.0)
        _ENGINES.discard(self)

    def _fail_queued(self, exc) -> int:
        """The stash is queue too: its requests fail with the rest."""
        n = super()._fail_queued(exc)
        while True:
            with self._stash_lock:
                if not self._stashq:
                    return n
                req = self._stashq.popleft()
            if not req.fut.done():
                req.fut.set_exception(exc)
                n += 1

    # --- stats ----------------------------------------------------------
    def latency_stats(self) -> Dict[str, float]:
        """Rolling p50/p99/max over the last <= 4096 requests, in ms."""
        with self._lat_lock:
            window = list(self._latencies)
        if not window:
            return {"window": 0}
        arr = np.asarray(window) * 1e3
        return {"window": len(window),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "max_ms": float(arr.max())}

    def serving_stats(self) -> Dict[str, Any]:
        """This engine's census for :func:`serving_health`."""
        out: Dict[str, Any] = dict(self.pool_stats())
        out.update(self.latency_stats())
        cl = self.class_latency_stats()
        if cl:
            out["class_latency"] = cl
        with self._exec_lock:
            out["buckets_compiled"] = len(self._exec)
        out["warm"] = self._warm
        out["queue_depth_hwm"] = self.queue_depth_hwm()   # windowed
        out["queue_depth_peak"] = self._q_peak            # lifetime
        out["bf16"] = self._bf16
        if self._adm is not None:
            out["admission"] = self._adm.stats()
        with self._lock:
            can = self._canary
            out["canary_phase"] = can["phase"] if can else "idle"
            if can:
                out["canary_corr"] = can["corr"]
        self._publish_queue_gauges()
        return out


def serving_health() -> Dict[str, Any]:
    """The ``/api/health`` "serving" section: the profiler's serving
    ledger merged with a per-engine census and the rolling latency
    quantiles only the engines hold."""
    out: Dict[str, Any] = dict(OpProfiler.get().serving_stats())
    engines = list(_ENGINES)
    out["engines"] = len(engines)
    if engines:
        out["engine_stats"] = [e.serving_stats() for e in engines]
        samples: List[float] = []
        class_samples: Dict[str, List[float]] = {}
        for e in engines:
            with e._lat_lock:
                samples.extend(e._latencies)
                for name, dq in e._class_lats.items():
                    class_samples.setdefault(name, []).extend(
                        lat for _, lat in dq)
        if samples:
            arr = np.asarray(samples) * 1e3
            out["latency_p50_ms"] = float(np.percentile(arr, 50))
            out["latency_p99_ms"] = float(np.percentile(arr, 99))
        if class_samples:
            out["class_latency"] = {
                name: {"window": len(vals),
                       "p50_ms": float(np.percentile(
                           np.asarray(vals) * 1e3, 50)),
                       "p99_ms": float(np.percentile(
                           np.asarray(vals) * 1e3, 99))}
                for name, vals in class_samples.items() if vals}
    return out
