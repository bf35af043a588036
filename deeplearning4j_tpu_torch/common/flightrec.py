"""Flight recorder: correlated cross-subsystem event tracing.

Counterpart of ``deeplearning4j_tpu/common/flightrec.py``, carried over
whole (it is plain host code). A thread-safe bounded ring buffer of
structured events that every subsystem appends to, cheap enough to leave
on and small enough to dump whole at a crash.

One event is one dict: monotonic and wall timestamps, a registered
``name`` (``subsystem/what``, :data:`EVENT_SITES`), a severity (``info``,
``warn``, ``error``), free-form ``attrs``, the emitting thread, an optional
correlation id and optional span / parent span ids.

- **Correlation ids** stitch one incident across threads: serving requests
  carry ``req<ordinal>`` through enqueue -> batch -> reply, and a canaried
  publication carries ``pub<N>`` through canary -> promote / rollback
  (``parallel/serving.py``); :func:`set_correlation` sets an ambient id
  that every event without its own inherits.
- **Spans** (:func:`span`) are nestable begin/end pairs with per-thread
  parent tracking.
- The disabled path is one global read and one attribute check.

Consumers: :func:`chrome_trace` / :func:`export_chrome_trace` (the Chrome
trace event format: spans as B/E pairs, instants as ``i``,
``OpProfiler.time_section`` durations as complete ``X`` events, one lane
per thread), ``GET /api/trace`` and ``GET /api/metrics`` on
``ui/server.UIServer``, and :func:`dump_blackbox` (the last N events as
JSONL). Among the emitters: the serving tier, the supervisor and the
cluster runtime, fault injection, checkpoints, the executable census
(``xprof/*``), the steady-state check (``tracecheck/violation``) and the
SLO watchtower (``watchtower/*``).

Stdlib only, so every module (the profiler included) can emit without an
import cycle.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

#: The event-name registry, with the JAX package's names and entries:
#: name -> what emits it + the drill that proves it fires. Names of
#: modules the port does not have yet stay registered, so a trace read by
#: either package's tools names events alike.
EVENT_SITES: Dict[str, Dict[str, str]] = {
    "supervisor/attempt_start": {
        "desc": "supervised attempt begins (resume point named)",
        "drill": "test_observability blackbox drill"},
    "supervisor/attempt": {
        "desc": "span around one supervised attempt",
        "drill": "obs-smoke chrome-trace gate"},
    "supervisor/attempt_failed": {
        "desc": "failure classified (class, policy, error)",
        "drill": "test_observability blackbox drill"},
    "supervisor/restart": {
        "desc": "checkpoint-restart decision + backoff",
        "drill": "test_observability blackbox drill"},
    "supervisor/watchdog_fire": {
        "desc": "hang watchdog abandoned a wedged attempt",
        "drill": "test_supervisor watchdog drill"},
    "supervisor/preempted": {
        "desc": "preemption signal -> flush checkpoint + resumable exit",
        "drill": "test_supervisor SIGTERM drill"},
    "supervisor/give_up": {
        "desc": "restart budget / storm breaker exhausted",
        "drill": "test_observability give-up drill"},
    "supervisor/completed": {
        "desc": "supervised fit ran to completion",
        "drill": "test_observability blackbox drill"},
    "checkpoint/commit": {
        "desc": "checkpoint atomically committed to the manifest",
        "drill": "test_observability blackbox drill"},
    "checkpoint/restore": {
        "desc": "checkpoint restored into a model (resume)",
        "drill": "test_observability blackbox drill"},
    "fault/fired": {
        "desc": "an injected fault fired (site, kind, index)",
        "drill": "test_observability blackbox drill"},
    "pipeline/epoch": {
        "desc": "span around one training epoch",
        "drill": "test_observability chrome-trace test; obs-smoke"},
    "pipeline/dispatch": {
        "desc": "one train-step dispatch (ordinal)",
        "drill": "test_observability chrome-trace test"},
    "pipeline/stage_fwd": {
        "desc": "per-stage forward schedule window (Chrome X on its own "
                "pipeline/stage<k>/fwd lane; bubbles are the gaps)",
        "drill": "test_pipeline_parallel lanes test; "
                 "pipeline-parallel-smoke"},
    "pipeline/stage_bwd": {
        "desc": "per-stage backward schedule window (its own /bwd lane "
                "— 1F1B fwd/bwd windows interleave)",
        "drill": "test_pipeline_parallel lanes test; "
                 "pipeline-parallel-smoke"},
    "pipeline/remap": {
        "desc": "span around an online stage-count remap (stages_from/"
                "stages_to + lost stages as attrs)",
        "drill": "test_pipeline_parallel remap drills; "
                 "pipeline-parallel-smoke"},
    "elastic/resize": {
        "desc": "span around an online data-axis resize",
        "drill": "test_elastic resize drill"},
    "serving/enqueue": {
        "desc": "request admitted to the serving queue (req ordinal)",
        "drill": "test_observability serving lifecycle test"},
    "serving/batch": {
        "desc": "continuous-batching batch formed (request ids)",
        "drill": "test_observability serving lifecycle test"},
    "serving/reply": {
        "desc": "request completed (latency attached)",
        "drill": "test_observability serving lifecycle test"},
    "serving/retire": {
        "desc": "serving replica retired mid-load (batch requeued)",
        "drill": "test_observability serving kill drill"},
    "serving/shed": {
        "desc": "brownout shed-level change (classes shed, reason)",
        "drill": "test_autoscale brownout drills; autoscale-smoke"},
    "serving/canary": {
        "desc": "candidate weights landed on the canary replica",
        "drill": "test_autoscale canary drills; autoscale-smoke"},
    "serving/promote": {
        "desc": "canary promoted fleet-wide after an SLO-clean window",
        "drill": "test_autoscale canary drills; autoscale-smoke"},
    "serving/rollback": {
        "desc": "violation rollback restored the prior params bitwise",
        "drill": "test_autoscale rollback drill; autoscale-smoke"},
    "autoscale/decide": {
        "desc": "span around one scale decision (input signals as attrs)",
        "drill": "test_autoscale controller drills; autoscale-smoke"},
    "autoscale/scale": {
        "desc": "replica-count change actuated (from, to, reason)",
        "drill": "test_autoscale controller drills; autoscale-smoke"},
    "inference/resurrected": {
        "desc": "a retired replica's replacement joined the pool",
        "drill": "test_observability serving kill drill"},
    "fleet/cull": {
        "desc": "a fleet member's alive bit dropped (updates freeze "
                "in-graph; reason attached)",
        "drill": "test_fleet cull drills; fleet-smoke"},
    "fleet/spawn": {
        "desc": "a fleet member slice re-initialized in place (params/"
                "updater/stream key fresh, alive restored)",
        "drill": "test_fleet spawn drills; fleet-smoke"},
    "fleet/nan_cull": {
        "desc": "per-member NaN isolation flipped one member's alive "
                "bit in-graph (other members' updates landed)",
        "drill": "test_fleet NaN drills; fleet-smoke"},
    "tracecheck/violation": {
        "desc": "a declared steady-state region retraced/synced",
        "drill": "test_observability injected-retrace test"},
    "profiler/section": {
        "desc": "one OpProfiler.time_section duration (Chrome X event)",
        "drill": "test_observability chrome-trace test"},
    "perf/rate": {
        "desc": "PerformanceListener throughput/latency sample",
        "drill": "test_observability PerformanceListener test"},
    "xprof/exec": {
        "desc": "executable census generation (jit retrace / AOT bucket "
                "/ counted sub-executable, compile wall attached)",
        "drill": "test_xprof census events; xprof-smoke"},
    "xprof/hbm": {
        "desc": "HBM watermark peak rose for a phase (live/device bytes "
                "attached)",
        "drill": "test_xprof watermark test; xprof-smoke"},
    "watchtower/alert": {
        "desc": "SLO alert state transition (slo, from/to, burn rates, "
                "budget remaining)",
        "drill": "test_watchtower burn/hysteresis drills; soak-smoke"},
    "watchtower/incident": {
        "desc": "incident report opened/finalized (id, reason, path)",
        "drill": "test_watchtower incident drills; soak-smoke"},
    "cluster/form": {
        "desc": "cluster bring-up landed (rank, world, coordinator, "
                "attempts, incarnation)",
        "drill": "test_cluster form drills; cluster-smoke"},
    "cluster/barrier": {
        "desc": "barrier deadline expired (rank, missing ranks, per-rank "
                "heartbeat staleness)",
        "drill": "test_cluster barrier-timeout drills; cluster-smoke"},
    "cluster/rank_lost": {
        "desc": "a rank classified dead/hung (rank, class, exit code) — "
                "incident-chain cause",
        "drill": "test_cluster exit-classification drills; cluster-smoke "
                 "kill drill"},
    "cluster/group_restart": {
        "desc": "group restart decision (lost rank, world_from/world_to; "
                "shrink-to-survivors when they differ)",
        "drill": "test_cluster shrink drill; cluster-smoke"},
    "integrity/fingerprint": {
        "desc": "replica-consistency check window drained (iteration, "
                "fp, running check count)",
        "drill": "test_integrity fingerprint drills; integrity-smoke"},
    "integrity/divergence": {
        "desc": "in-graph fingerprint divergence (iteration, replica, "
                "fp) — detection anchor for the incident chain",
        "drill": "test_integrity bitflip drills; integrity-smoke"},
    "integrity/scrub": {
        "desc": "checkpoint scrub pass summary "
                "(scanned/verified/quarantined/skipped)",
        "drill": "test_integrity scrubber drills; integrity-smoke "
                 "scrub drill"},
    "integrity/quarantine": {
        "desc": "divergent replica or rotten checkpoint generation "
                "quarantined (replica or file + reason) — mitigation "
                "anchor",
        "drill": "test_integrity quarantine drills; integrity-smoke"},
}

DEFAULT_CAPACITY = 4096


class FlightRecorder:
    """Thread-safe bounded ring buffer of structured events with a
    nestable span API. Enabled by default; :meth:`configure` flips it
    (the disabled path is one attribute check). Instantiable for tests;
    the process-wide instance is :func:`get`."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool = True):
        self._lock = threading.Lock()
        self._buf: "deque" = deque(maxlen=max(1, int(capacity)))
        self._enabled = bool(enabled)
        self._total = 0          # events ever appended (== next seq)
        self._dropped = 0        # ring-overflow evictions
        self._span_seq = 0
        self._corr: Optional[str] = None    # ambient correlation id
        self._tls = threading.local()       # per-thread span stack

    # -- config / introspection ------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None) -> "FlightRecorder":
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if capacity is not None and capacity != self._buf.maxlen:
                cap = max(1, int(capacity))
                # a shrink evicts the oldest buffered events — they count
                # as drops, or consumers trusting dropped==0 (the chrome
                # B/E-balance gate) would read a truncated ring as whole
                self._dropped += max(0, len(self._buf) - cap)
                self._buf = deque(self._buf, maxlen=cap)
        return self

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self._enabled,
                    "capacity": self._buf.maxlen,
                    "buffered": len(self._buf),
                    "events_total": self._total,
                    "dropped": self._dropped}

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()
            self._total = 0
            self._dropped = 0
            self._corr = None

    # -- correlation ------------------------------------------------------
    def set_correlation(self, corr: Optional[str]) -> None:
        """Set the AMBIENT correlation id every subsequent event (from
        any thread) inherits unless it passes an explicit ``corr``. The
        supervisor owns this slot during supervised runs (one run at a
        time); explicit per-event ids (serving requests) always win."""
        with self._lock:
            self._corr = corr

    def correlation(self) -> Optional[str]:
        return self._corr

    @contextlib.contextmanager
    def correlate(self, corr: Optional[str]) -> Iterator[None]:
        prev = self._corr
        self.set_correlation(corr)
        try:
            yield
        finally:
            self.set_correlation(prev)

    # -- emission ---------------------------------------------------------
    def record(self, name: str, severity: str = "info",
               corr: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None,
               phase: str = "i", span_id: Optional[int] = None,
               parent_id: Optional[int] = None,
               force: bool = False) -> None:
        """Append one event. Near-zero when disabled (one attribute
        check, nothing allocated). ``force`` records even while
        disabled — only span close uses it, so a mid-span disable cannot
        orphan a recorded B.

        Two reserved attr keys serve DERIVED timeline slices (events
        reconstructed after the fact, e.g. the pipeline trainer's
        per-stage schedule lanes): ``ts_mono`` overrides the event's
        monotonic timestamp (popped, not stored), and ``lane`` makes the
        Chrome exporter render the event on its own named synthetic lane
        instead of the emitting thread's."""
        if not self._enabled and not force:
            return
        m = time.monotonic()
        if attrs and "ts_mono" in attrs:
            attrs = dict(attrs)
            m = float(attrs.pop("ts_mono"))
        t = threading.current_thread()
        ev = {"t": time.time(), "m": m, "name": name,
              "sev": severity, "corr": corr, "ph": phase,
              "span": span_id, "parent": parent_id,
              "thread": t.name, "tid": t.ident,
              "attrs": attrs or {}}
        with self._lock:
            if corr is None:
                ev["corr"] = self._corr
            ev["seq"] = self._total
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(ev)
            self._total += 1

    def event(self, name: str, severity: str = "info",
              corr: Optional[str] = None, **attrs) -> None:
        self.record(name, severity=severity, corr=corr, attrs=attrs)

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, severity: str = "info",
             corr: Optional[str] = None, **attrs) -> Iterator[Optional[int]]:
        """Nestable begin/end span: emits a ``B`` event on entry and an
        ``E`` event on exit (exceptions included), parented on the
        calling thread's innermost open span."""
        if not self._enabled:
            yield None
            return
        stack = self._stack()
        with self._lock:
            self._span_seq += 1
            sid = self._span_seq
            if corr is None:
                # resolve the ambient id ONCE, at open: a span that
                # outlives a correlation change (a zombie attempt's epoch
                # unwinding after its replacement started) must close
                # under the incident it opened under
                corr = self._corr
        parent = stack[-1] if stack else None
        self.record(name, severity=severity, corr=corr, attrs=attrs,
                    phase="B", span_id=sid, parent_id=parent)
        stack.append(sid)
        try:
            yield sid
        finally:
            stack.pop()
            # force: a recorded B must get its E even if the recorder was
            # disabled mid-span, or the trace carries a never-ending
            # slice while dropped==0 claims the ring is whole
            self.record(name, severity=severity, corr=corr, phase="E",
                        span_id=sid, parent_id=parent, force=True)

    # -- reading ----------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        """Owning copy of the ring, oldest first."""
        with self._lock:
            return list(self._buf)

    def events(self, prefix: Optional[str] = None,
               corr: Optional[str] = None) -> List[Dict[str, Any]]:
        evs = self.snapshot()
        if prefix is not None:
            evs = [e for e in evs if e["name"].startswith(prefix)]
        if corr is not None:
            evs = [e for e in evs if e["corr"] == corr]
        return evs

    def tail(self, n: int) -> List[Dict[str, Any]]:
        return self.snapshot()[-max(0, int(n)):]

    # -- consumers --------------------------------------------------------
    def chrome_trace(self, corr: Optional[str] = None) -> Dict[str, Any]:
        """The ring as a Chrome trace event document (Perfetto /
        ``chrome://tracing`` loadable). Spans map to ``B``/``E`` pairs,
        instants to ``i``, events carrying a ``dur_s`` attr (the
        profiler's ``time_section`` durations) to complete ``X`` events
        named after their section; each emitting thread gets its own
        lane with a ``thread_name`` metadata record. ``corr`` filters to
        one correlation id — the incident-link view ``/api/trace``
        serves over HTTP."""
        evs = self.snapshot()
        if corr is not None:
            evs = [e for e in evs if e["corr"] == corr]
        pid = os.getpid()
        out: List[Dict[str, Any]] = []
        threads: Dict[int, str] = {}
        lane_tids: Dict[str, int] = {}
        for e in evs:
            args = dict(e["attrs"])
            lane = args.pop("lane", None)
            if lane is not None:
                # named synthetic lane (per-stage pipeline schedule
                # slices): negative tids can't collide with OS threads
                tid = lane_tids.setdefault(str(lane),
                                           -(len(lane_tids) + 1))
                threads.setdefault(tid, str(lane))
            else:
                tid = e["tid"] or 0
                threads.setdefault(tid, e["thread"])
            if e["corr"]:
                args["corr"] = e["corr"]
            if e["span"] is not None:
                args["span"] = e["span"]
                if e["parent"] is not None:
                    args["parent_span"] = e["parent"]
            name, cat = e["name"], e["name"].split("/", 1)[0]
            base = {"pid": pid, "tid": tid, "cat": cat, "args": args}
            dur = e["attrs"].get("dur_s")
            if e["ph"] in ("B", "E"):
                out.append({**base, "ph": e["ph"], "name": name,
                            "ts": e["m"] * 1e6})
            elif dur is not None:
                sec = e["attrs"].get("section", name)
                out.append({**base, "ph": "X",
                            "name": sec, "cat": str(sec).split("/", 1)[0],
                            "ts": (e["m"] - float(dur)) * 1e6,
                            "dur": float(dur) * 1e6})
            else:
                out.append({**base, "ph": "i", "s": "t", "name": name,
                            "ts": e["m"] * 1e6})
        for tid, tname in threads.items():
            out.append({"ph": "M", "pid": pid, "tid": tid,
                        "name": "thread_name", "args": {"name": tname}})
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str,
                            corr: Optional[str] = None) -> int:
        """Write :meth:`chrome_trace` atomically (tmp + rename).
        Returns the number of trace events written."""
        doc = self.chrome_trace(corr=corr)
        tmp = tmp_path(path)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return len(doc["traceEvents"])

    def dump_blackbox(self, path: str,
                      last_n: Optional[int] = None) -> str:
        """Write the last-N events (whole ring by default) as JSONL, one
        event per line, atomically (tmp + rename — a crash mid-dump
        leaves the previous black box intact). The postmortem artifact:
        readable with no live process, greppable by correlation id."""
        evs = self.snapshot()
        if last_n is not None:
            evs = evs[-max(0, int(last_n)):]
        tmp = tmp_path(path)
        with open(tmp, "w", encoding="utf-8") as f:
            for e in evs:
                f.write(json.dumps(e, default=str) + "\n")
        os.replace(tmp, path)
        return path


def tmp_path(path: str) -> str:
    """The temporary name an atomic write of ``path`` goes through: one of
    its own for each process and thread, so two writers of one file (the
    ranks of a group share a checkpoint directory) never rename each
    other's half-written file away."""
    return f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"


# -- the process-wide recorder + module-level facade ----------------------

_REC: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()


def get() -> FlightRecorder:
    global _REC
    rec = _REC
    if rec is None:
        with _rec_lock:
            if _REC is None:
                _REC = FlightRecorder()
            rec = _REC
    return rec


def configure(enabled: Optional[bool] = None,
              capacity: Optional[int] = None) -> FlightRecorder:
    return get().configure(enabled=enabled, capacity=capacity)


def enabled() -> bool:
    """Cheapest possible recording check — for call sites whose event
    ATTRS are themselves expensive to build (list comprehensions over a
    batch, latency math): guard them so the disabled path allocates
    nothing. A not-yet-created recorder reports True (it is born
    enabled; the first event() call creates it)."""
    rec = _REC
    return rec is None or rec._enabled


def event(name: str, severity: str = "info", corr: Optional[str] = None,
          **attrs) -> None:
    """Emit one instant event (the hot-path entry point — when the
    recorder is disabled this is one global read + one attribute
    check)."""
    rec = _REC
    if rec is None:
        rec = get()
    if not rec._enabled:
        return
    rec.record(name, severity=severity, corr=corr, attrs=attrs)


def span(name: str, severity: str = "info", corr: Optional[str] = None,
         **attrs):
    return get().span(name, severity=severity, corr=corr, **attrs)


def set_correlation(corr: Optional[str]) -> None:
    get().set_correlation(corr)


def correlate(corr: Optional[str]):
    return get().correlate(corr)


def events(prefix: Optional[str] = None,
           corr: Optional[str] = None) -> List[Dict[str, Any]]:
    return get().events(prefix=prefix, corr=corr)


def tail(n: int) -> List[Dict[str, Any]]:
    return get().tail(n)


def stats() -> Dict[str, Any]:
    return get().stats()


def reset() -> None:
    get().reset()


def chrome_trace(corr: Optional[str] = None) -> Dict[str, Any]:
    return get().chrome_trace(corr=corr)


def export_chrome_trace(path: str, corr: Optional[str] = None) -> int:
    return get().export_chrome_trace(path, corr=corr)


def dump_blackbox(path: str, last_n: Optional[int] = None) -> str:
    return get().dump_blackbox(path, last_n=last_n)
