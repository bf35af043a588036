"""Watchtower: SLO error budgets, burn-rate alerting, incident reports.

Counterpart of ``deeplearning4j_tpu/common/watchtower.py``, carried over
(it is plain host code over the flight recorder, the fault-injection
registry, the profiler and the executable census). The control loop over
the signals the port exports, the reference stack's
``StatsListener``/remote-UI monitoring role (SURVEY §5.5) rebuilt as SRE
practice:

SLOs & error budgets
--------------------
An :class:`SLO` is a declarative objective over exported signals (serving
per-class p99 and sheds, supervisor restart/storm counters, fleet NaN
culls, tracecheck violations, memory watermarks). Two sampler shapes
cover all of them:

- ``kind="ratio"``: the sampler returns CUMULATIVE ``(bad, total)``
  counts (e.g. failed vs served requests) — availability-style SLOs;
- ``kind="gauge"``: the sampler returns truthy when THIS evaluation tick
  violates (p99 over budget, watermark over ceiling, a counter moved) —
  each tick contributes one compliance sample.

Both reduce to a cumulative ``(t, bad, total)`` series per SLO, from
which the rolling **error budget** (allowed bad fraction over
``period_s``) and **burn rates** fall out as window deltas.

Multi-window burn-rate alerting
-------------------------------
Burn rate over a window = (observed bad fraction / budget). A **page**
fires when both the fast (5 m) and mid (1 h) windows burn >= ``page_burn``
(14.4x); a **warn** when both the mid and slow (6 h) windows burn >=
``warn_burn`` (6x). Raising is immediate; clearing takes ``clear_ticks``
consecutive clean evaluations (hysteresis). Every transition emits a
``watchtower/alert`` flight-recorder event, bumps ``watchtower/*``
profiler counters, and moves the ``watchtower/alert_state/<slo>`` gauge
(0 ok / 1 warn / 2 page) that ``/api/metrics`` re-exports as
``dl4j_alert_state``. The windows run on the monotonic clock; every
evaluation takes an injectable ``now`` so tests drive the window math
without sleeping.

Incident reports
----------------
Every alert firing — and every supervisor failure classification, via
:func:`note_supervisor_failure` — triggers :meth:`Watchtower.
assemble_incident`: walk the flight-recorder ring backwards from the
triggering event, follow correlation ids across subsystems, and join the
blackbox tail, the profiler ledger snapshot, the memory watermarks and
the executable-census rows into one ``incident-<id>.json`` (atomic
tmp+rename, beside the blackbox) with a derived
cause -> detection -> mitigation -> recovery chain. Open incidents are
re-assembled every evaluation tick until their chain completes (or a
timeout). ``GET /api/incidents`` lists and serves them.

The evaluation tick is a registered fault site (``watchtower/evaluate``,
kind ``transient`` = one skipped tick).

Threading: one daemon evaluator thread ticks at ``interval_s`` (joined by
:meth:`Watchtower.stop`) while callers (HTTP handlers, the supervisor
hook) read stats and open incidents concurrently; every state mutation
holds ``_lock``, and sampling, event emission and file IO happen outside
it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import faultinject, flightrec
from .profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")

# alert states (also the wire values of dl4j_alert_state)
OK, WARN, PAGE = 0, 1, 2
_STATE_NAMES = {OK: "ok", WARN: "warn", PAGE: "page"}

# chain-derivation anchors: which registered event names can play which
# role in a cause→detection→mitigation→recovery chain
_CAUSE_NAMES = ("fault/fired", "tracecheck/violation", "cluster/rank_lost")
_DETECTION_NAMES = ("watchtower/alert", "supervisor/attempt_failed",
                    "supervisor/watchdog_fire", "supervisor/give_up",
                    "cluster/barrier", "integrity/divergence")
_MITIGATION_NAMES = ("supervisor/restart", "supervisor/preempted",
                     "elastic/resize", "pipeline/remap",
                     "serving/rollback", "serving/retire", "serving/shed",
                     "autoscale/scale", "fleet/cull", "fleet/nan_cull",
                     "cluster/group_restart", "integrity/quarantine")
_RECOVERY_NAMES = ("supervisor/attempt_start", "supervisor/completed",
                   "checkpoint/restore", "inference/resurrected",
                   "serving/promote", "fleet/spawn", "cluster/form")


# -- samplers --------------------------------------------------------------

def counter_ratio_sampler(bad: Tuple[str, ...],
                          total: Tuple[str, ...]) -> Callable[[], Tuple[int, int]]:
    """Ratio sampler over profiler counters: cumulative (bad, total)."""
    def sample() -> Tuple[int, int]:
        prof = OpProfiler.get()
        return (sum(prof.counter_value(n) for n in bad),
                sum(prof.counter_value(n) for n in total))
    return sample


def counter_increment_sampler(*names: str) -> Callable[[], bool]:
    """Gauge sampler that violates on any increment of the summed
    counters since the previous tick. The first call arms (never
    violates) — a watchtower attached mid-run must not page on history."""
    state: Dict[str, Optional[int]] = {"last": None}

    def sample() -> bool:
        prof = OpProfiler.get()
        cur = sum(prof.counter_value(n) for n in names)
        prev, state["last"] = state["last"], cur
        return prev is not None and cur > prev
    return sample


def threshold_sampler(value_fn: Callable[[], Optional[float]],
                      ceiling: float) -> Callable[[], bool]:
    """Gauge sampler that violates while ``value_fn()`` exceeds
    ``ceiling`` (None = no reading = compliant)."""
    def sample() -> bool:
        try:
            v = value_fn()
        except Exception:
            return False
        return v is not None and v > ceiling
    return sample


class SLO:
    """One declarative objective. ``budget`` is the allowed bad fraction
    over ``period_s`` (0.001 = 99.9 %). ``incident`` picks what an alert
    firing does: ``"open"`` assembles a fresh incident, ``"attach"``
    joins the newest open incident for the same correlation family
    (supervisor-domain SLOs, whose failures already opened one via
    :func:`note_supervisor_failure`), ``"none"`` alerts only."""

    def __init__(self, name: str, sampler: Callable, budget: float,
                 kind: str = "gauge", description: str = "",
                 fast_s: float = 300.0, mid_s: float = 3600.0,
                 slow_s: float = 21600.0, page_burn: float = 14.4,
                 warn_burn: float = 6.0, clear_ticks: int = 3,
                 period_s: float = 86400.0, incident: str = "open"):
        if kind not in ("ratio", "gauge"):
            raise ValueError(f"kind must be 'ratio' or 'gauge', got {kind!r}")
        if incident not in ("open", "attach", "none"):
            raise ValueError(f"incident must be open/attach/none, "
                             f"got {incident!r}")
        if not 0.0 < budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {budget}")
        self.name = name
        self.sampler = sampler
        self.budget = float(budget)
        self.kind = kind
        self.description = description
        self.fast_s = float(fast_s)
        self.mid_s = float(mid_s)
        self.slow_s = float(slow_s)
        self.page_burn = float(page_burn)
        self.warn_burn = float(warn_burn)
        self.clear_ticks = max(1, int(clear_ticks))
        self.period_s = float(period_s)
        self.incident = incident


class _SloState:
    """Per-SLO mutable slot owned by the Watchtower (under its lock)."""

    def __init__(self) -> None:
        self.samples: List[Tuple[float, float, float]] = []  # (t, bad, tot)
        self.bad = 0.0           # cumulative (gauge kind accumulates here)
        self.total = 0.0
        self.state = OK
        self.pending = 0         # consecutive ticks below current state
        self.burns = (0.0, 0.0, 0.0)
        self.transitions = 0


def _window_burn(samples: List[Tuple[float, float, float]], now: float,
                 window_s: float, budget: float) -> float:
    """Burn rate over the trailing window: (Δbad/Δtotal)/budget, with
    the window start read from the newest sample at/older than it (the
    first sample when the series is younger than the window)."""
    if len(samples) < 2:
        return 0.0
    base = samples[0]
    start = now - window_s
    for s in reversed(samples):
        if s[0] <= start:
            base = s
            break
    db = samples[-1][1] - base[1]
    dt = samples[-1][2] - base[2]
    if dt <= 0:
        return 0.0
    return (db / dt) / budget


class Watchtower:
    """The evaluator: samples every SLO at ``interval_s`` (daemon thread
    via :meth:`start`, or deterministically via :meth:`evaluate_now`),
    runs the multi-window burn-rate state machine, and owns the incident
    registry under ``incident_dir``."""

    def __init__(self, slos: List[SLO], interval_s: float = 5.0,
                 incident_dir: Optional[str] = None,
                 ring_context: int = 400, lookback_s: float = 60.0,
                 finalize_after_s: float = 120.0, enabled: bool = True):
        names = [s.name for s in slos]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._lock = threading.RLock()
        self._slos: Dict[str, SLO] = {s.name: s for s in slos}
        self._states: Dict[str, _SloState] = {n: _SloState() for n in names}
        self.interval_s = float(interval_s)
        self.incident_dir = incident_dir
        self.ring_context = int(ring_context)
        self.lookback_s = float(lookback_s)
        self.finalize_after_s = float(finalize_after_s)
        self._enabled = bool(enabled)
        self._tick = 0
        self._skipped = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._incident_seq = 0
        self._incidents: Dict[str, Dict[str, Any]] = {}   # id -> spec

    # -- lifecycle --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: Optional[bool] = None) -> "Watchtower":
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
        return self

    def start(self) -> "Watchtower":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="watchtower", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        self._stop.set()
        if t is not None:
            t.join(timeout=5.0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_now()
            except Exception:
                logger.warning("watchtower: evaluation tick failed",
                               exc_info=True)

    # -- evaluation -------------------------------------------------------
    def evaluate_now(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation tick. ``now`` (monotonic seconds) is
        injectable so tests drive the window math without sleeping.
        Returns a summary; a tick skipped by the ``watchtower/evaluate``
        transient drill reports ``skipped=True`` with no state change."""
        if not self._enabled:
            return {"tick": self._tick, "skipped": True, "states": {}}
        with self._lock:
            ordinal = self._tick
            self._tick = ordinal + 1
        try:
            faultinject.fault_point("watchtower/evaluate", ordinal)
        except faultinject.TransientFault:
            with self._lock:
                self._skipped += 1
            OpProfiler.get().count("watchtower/skipped_evals")
            return {"tick": ordinal, "skipped": True, "states": {}}
        if now is None:
            now = time.monotonic()
        prof = OpProfiler.get()
        prof.count("watchtower/evaluations")

        # sample OUTSIDE the lock (samplers read other subsystems' locks)
        readings: Dict[str, Any] = {}
        for name, slo in self._slos.items():
            try:
                readings[name] = slo.sampler()
            except Exception:
                logger.warning("watchtower: sampler for SLO %r failed",
                               name, exc_info=True)
                readings[name] = None

        transitions: List[Tuple[str, int, int, Tuple[float, ...], float]] = []
        summary: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, slo in self._slos.items():
                st = self._states[name]
                self._absorb(slo, st, readings.get(name), now)
                burns = tuple(
                    _window_burn(st.samples, now, w, slo.budget)
                    for w in (slo.fast_s, slo.mid_s, slo.slow_s))
                st.burns = burns
                target = OK
                if burns[0] >= slo.page_burn and burns[1] >= slo.page_burn:
                    target = PAGE
                elif burns[1] >= slo.warn_burn and burns[2] >= slo.warn_burn:
                    target = WARN
                frm = st.state
                if target > st.state:        # raise immediately
                    st.state = target
                    st.pending = 0
                elif target < st.state:      # clear only after N clean ticks
                    st.pending += 1
                    if st.pending >= slo.clear_ticks:
                        st.state = target
                        st.pending = 0
                else:
                    st.pending = 0
                if st.state != frm:
                    st.transitions += 1
                    transitions.append((name, frm, st.state, burns,
                                        self._budget_remaining(slo, st, now)))
                summary[name] = {"state": st.state,
                                 "fast_burn": round(burns[0], 4),
                                 "mid_burn": round(burns[1], 4),
                                 "slow_burn": round(burns[2], 4)}

        for name, frm, to, burns, remaining in transitions:
            self._on_transition(name, frm, to, burns, remaining)
        self._refresh_incidents()
        return {"tick": ordinal, "skipped": False, "states": summary}

    @staticmethod
    def _absorb(slo: SLO, st: _SloState, reading: Any, now: float) -> None:
        """Fold one sampler reading into the cumulative series."""
        if slo.kind == "ratio":
            if reading is None:
                return
            bad, total = float(reading[0]), float(reading[1])
            if st.samples and (bad < st.bad or total < st.total):
                # counters went backwards (profiler reset) — re-base
                st.samples = []
            st.bad, st.total = bad, total
        else:
            st.bad += 1.0 if reading else 0.0
            st.total += 1.0
        st.samples.append((now, st.bad, st.total))
        # bound the series to what the slow window + period math can use
        horizon = now - max(slo.slow_s, slo.period_s) - 1.0
        while len(st.samples) > 2 and st.samples[1][0] < horizon:
            st.samples.pop(0)

    @staticmethod
    def _budget_remaining(slo: SLO, st: _SloState, now: float) -> float:
        """Fraction of the period's error budget still unspent."""
        if len(st.samples) < 2:
            return 1.0
        base = st.samples[0]
        start = now - slo.period_s
        for s in reversed(st.samples):
            if s[0] <= start:
                base = s
                break
        db = st.samples[-1][1] - base[1]
        dt = st.samples[-1][2] - base[2]
        if dt <= 0:
            return 1.0
        return max(0.0, 1.0 - (db / dt) / slo.budget)

    def _on_transition(self, name: str, frm: int, to: int,
                       burns: Tuple[float, ...], remaining: float) -> None:
        prof = OpProfiler.get()
        sev = "error" if to == PAGE else "warn" if to == WARN else "info"
        flightrec.event("watchtower/alert", severity=sev, slo=name,
                        frm=_STATE_NAMES[frm], to=_STATE_NAMES[to],
                        fast_burn=round(burns[0], 4),
                        mid_burn=round(burns[1], 4),
                        slow_burn=round(burns[2], 4),
                        budget_remaining=round(remaining, 4))
        prof.count("watchtower/alerts")
        if to == PAGE:
            prof.count("watchtower/pages")
        elif to == WARN:
            prof.count("watchtower/warns")
        else:
            prof.count("watchtower/clears")
        prof.gauge(f"watchtower/alert_state/{name}", to)
        slo = self._slos[name]
        if to > frm and slo.incident != "none":
            self.assemble_incident(
                kind="alert", reason=f"{name} {_STATE_NAMES[to]}",
                slo=name, attach_only=(slo.incident == "attach"))

    def alert_states(self) -> Dict[str, int]:
        with self._lock:
            return {n: st.state for n, st in self._states.items()}

    def stats(self) -> Dict[str, float]:
        """The ``watchtower`` profiler ledger (flat, numeric): per-SLO
        state / fast burn / budget remaining plus engine totals."""
        out: Dict[str, float] = {}
        now = time.monotonic()
        with self._lock:
            out["slos"] = len(self._slos)
            out["evaluations"] = self._tick
            out["skipped_evals"] = self._skipped
            out["incidents_open"] = sum(
                1 for i in self._incidents.values() if not i["finalized"])
            out["incidents_total"] = len(self._incidents)
            for name, st in self._states.items():
                slo = self._slos[name]
                out[f"state/{name}"] = st.state
                out[f"fast_burn/{name}"] = round(st.burns[0], 4)
                out[f"budget_remaining/{name}"] = round(
                    self._budget_remaining(slo, st, now), 4)
        return out

    # -- incidents --------------------------------------------------------
    @staticmethod
    def _corr_family(corr: Optional[str]) -> Optional[str]:
        """``inc3.a2`` -> ``inc3`` (one supervised incarnation = one
        family); anything else is its own family."""
        if corr and ".a" in corr and corr.startswith("inc"):
            return corr.split(".a", 1)[0]
        return corr

    def assemble_incident(self, kind: str, reason: str,
                          corr: Optional[str] = None,
                          slo: Optional[str] = None,
                          attach_only: bool = False,
                          attachments: Optional[Dict[str, Any]] = None
                          ) -> Optional[str]:
        """Open (or join) an incident and write its report. Returns the
        report path, or None when assembly is off (no ``incident_dir``)
        or an ``attach_only`` alert found nothing to join.
        ``attachments`` are caller-supplied payloads carried verbatim in
        the report (the cluster supervisor attaches the merged per-rank
        blackboxes here — one incident file tells the whole group's
        story)."""
        if self.incident_dir is None or not self._enabled:
            return None
        if corr is None:
            corr = flightrec.get().correlation()
        family = self._corr_family(corr)
        prof = OpProfiler.get()
        with self._lock:
            joined = None
            for inc in reversed(list(self._incidents.values())):
                if inc["finalized"]:
                    continue
                if (slo is not None and inc.get("slo") == slo) or \
                        (family is not None
                         and self._corr_family(inc.get("corr")) == family):
                    joined = inc
                    break
            if joined is not None:
                joined["alerts"].append(
                    {"kind": kind, "reason": reason, "slo": slo,
                     "corr": corr, "t": time.time()})
                if attachments:
                    joined.setdefault("attachments", {}).update(attachments)
                inc = joined
            elif attach_only:
                return None
            else:
                self._incident_seq += 1
                iid = f"{self._incident_seq:04d}"
                inc = {"id": iid, "kind": kind, "reason": reason,
                       "slo": slo, "corr": corr,
                       "opened_t": time.time(),
                       "opened_m": time.monotonic(),
                       "attachments": dict(attachments or {}),
                       "alerts": [], "finalized": False, "resolved": False,
                       "path": os.path.join(self.incident_dir,
                                            f"incident-{iid}.json")}
                self._incidents[inc["id"]] = inc
        if joined is None:
            prof.count("watchtower/incidents")
            flightrec.event("watchtower/incident", severity="warn",
                            id=inc["id"], kind=kind, reason=reason,
                            path=inc["path"])
        self._write_report(inc)
        return inc["path"]

    def _refresh_incidents(self) -> None:
        with self._lock:
            open_incs = [i for i in self._incidents.values()
                         if not i["finalized"]]
        for inc in open_incs:
            report = self._write_report(inc)
            age = time.monotonic() - inc["opened_m"]
            slo_ok = inc.get("slo") is None or \
                self.alert_states().get(inc["slo"], OK) == OK
            done = (report["complete"] and slo_ok) or \
                age > self.finalize_after_s
            if done:
                with self._lock:
                    inc["finalized"] = True
                    inc["resolved"] = report["complete"]
                self._write_report(inc)
                OpProfiler.get().count("watchtower/incidents_finalized")
                flightrec.event("watchtower/incident", severity="info",
                                id=inc["id"], resolved=report["complete"],
                                path=inc["path"])

    # -- report assembly --------------------------------------------------
    def _select_events(self, inc: Dict[str, Any]) -> List[Dict[str, Any]]:
        """Walk the ring backwards from the incident's anchor: keep
        every event in its correlation family plus every non-info or
        chain-anchor event inside the lookback window (and anything
        after the anchor — mitigation/recovery land later)."""
        family = self._corr_family(inc.get("corr"))
        floor = inc["opened_m"] - self.lookback_s
        sel: List[Dict[str, Any]] = []
        for e in reversed(flightrec.get().snapshot()):
            if len(sel) >= self.ring_context:
                break
            in_family = family is not None and \
                self._corr_family(e.get("corr")) == family
            interesting = e["sev"] != "info" or \
                e["name"] in _CAUSE_NAMES + _DETECTION_NAMES + \
                _MITIGATION_NAMES + _RECOVERY_NAMES
            if in_family or (e["m"] >= floor and interesting):
                sel.append(e)
        sel.reverse()
        return sel

    def _derive_chain(self, inc: Dict[str, Any],
                      evs: List[Dict[str, Any]]) -> Dict[str, Any]:
        def brief(e: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
            if e is None:
                return None
            return {"name": e["name"], "sev": e["sev"], "t": e["t"],
                    "seq": e["seq"], "corr": e.get("corr"),
                    "attrs": e.get("attrs", {})}

        # For supervisor-opened incidents prefer events carrying the
        # incident's exact correlation id — a second fault in the same
        # incarnation must not anchor on the first attempt's events.
        exact = inc.get("corr") if inc["kind"] != "alert" else None
        # The detection event is what TRIGGERED assembly (the supervisor
        # hook and the alert transition both emit it immediately before
        # opening), so it can never predate the opening by more than an
        # evaluator tick. Bounding the scan there keeps a fresh
        # supervisor's recycled correlation id (two drills both running
        # as inc1.a1) from anchoring detection on a PRIOR incident's
        # events that happen to share the string.
        det_floor = inc["opened_m"] - max(1.0, 2.0 * self.interval_s)

        def _scan_detection(pool: List[Dict[str, Any]]):
            for e in pool:
                if e["name"] not in _DETECTION_NAMES or \
                        e["m"] < det_floor:
                    continue
                if inc["kind"] == "alert":
                    if e["name"] == "watchtower/alert" and \
                            e["attrs"].get("slo") == inc.get("slo") and \
                            e["attrs"].get("to") != "ok":
                        return e
                elif e["name"] != "watchtower/alert":
                    return e
            return None

        evs_exact = [e for e in evs if e.get("corr") == exact] \
            if exact is not None else evs
        detection = _scan_detection(evs_exact) or _scan_detection(evs)
        cause = None
        det_seq = detection["seq"] if detection else None
        for pool in ((evs_exact, evs) if exact is not None else (evs,)):
            for e in reversed(pool):
                if e["name"] in _CAUSE_NAMES and \
                        (det_seq is None or e["seq"] <= det_seq):
                    cause = e
                    break
            if cause is not None:
                break
        anchor = cause["seq"] if cause else det_seq
        mitigation = None
        if anchor is not None:
            for e in evs:
                if e["seq"] > anchor and e["name"] in _MITIGATION_NAMES:
                    mitigation = e
                    break
        recovery = None
        if mitigation is not None:
            for e in evs:
                if e["seq"] <= mitigation["seq"]:
                    continue
                if e["name"] in _RECOVERY_NAMES:
                    recovery = e
                    break
                # an alert clearing back to ok is itself the recovery
                # anchor for purely alert-detected incidents
                if e["name"] == "watchtower/alert" and \
                        e["attrs"].get("slo") == inc.get("slo") and \
                        e["attrs"].get("to") == "ok":
                    recovery = e
                    break
        chain = {"cause": brief(cause), "detection": brief(detection),
                 "mitigation": brief(mitigation),
                 "recovery": brief(recovery)}
        chain["complete"] = all(chain[k] is not None for k in
                                ("cause", "detection", "mitigation",
                                 "recovery"))
        return chain

    def _write_report(self, inc: Dict[str, Any]) -> Dict[str, Any]:
        evs = self._select_events(inc)
        chain = self._derive_chain(inc, evs)
        prof = OpProfiler.get()
        try:
            ledgers = prof.ledger_stats()
        except Exception:
            ledgers = {}
        watermarks: Dict[str, float] = {}
        census: Dict[str, float] = {}
        try:
            from . import xprof
            for k, v in xprof.ledger().items():
                if k.startswith("hbm/"):
                    watermarks[k] = v
                else:
                    census[k] = v
        except Exception:
            pass
        blackbox = None
        bb = last_blackbox()
        if bb is not None:
            tail: List[Any] = []
            try:
                with open(bb, "r", encoding="utf-8") as f:
                    for line in f.readlines()[-16:]:
                        try:
                            tail.append(json.loads(line))
                        except ValueError:
                            pass
            except OSError:
                pass
            blackbox = {"path": bb, "tail": tail}
        report = {
            "id": inc["id"], "kind": inc["kind"], "reason": inc["reason"],
            "slo": inc.get("slo"), "corr": inc.get("corr"),
            "opened_t": inc["opened_t"], "updated_t": time.time(),
            "resolved": inc["resolved"], "finalized": inc["finalized"],
            "complete": chain["complete"], "chain": chain,
            "alerts": list(inc["alerts"]), "events": evs,
            "attachments": inc.get("attachments", {}),
            "blackbox": blackbox, "ledgers": ledgers,
            "watermarks": watermarks, "census": census,
        }
        try:
            os.makedirs(self.incident_dir, exist_ok=True)
            tmp = flightrec.tmp_path(inc["path"])
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(report, f, default=str)
            os.replace(tmp, inc["path"])
        except OSError:
            logger.warning("watchtower: incident write to %s failed",
                           inc["path"], exc_info=True)
        return report

    def incidents(self) -> List[Dict[str, Any]]:
        """Newest-first incident index (metadata only, for HTTP)."""
        with self._lock:
            incs = sorted(self._incidents.values(),
                          key=lambda i: i["id"], reverse=True)
            return [{"id": i["id"], "kind": i["kind"],
                     "reason": i["reason"], "slo": i.get("slo"),
                     "corr": i.get("corr"), "opened_t": i["opened_t"],
                     "finalized": i["finalized"],
                     "resolved": i["resolved"], "path": i["path"]}
                    for i in incs]

    def last_incident(self) -> Optional[Dict[str, Any]]:
        idx = self.incidents()
        if not idx:
            return None
        newest = idx[0]
        tail = None
        try:
            with open(newest["path"], "r", encoding="utf-8") as f:
                rep = json.load(f)
            tail = {"chain": rep.get("chain"),
                    "complete": rep.get("complete"),
                    "events": rep.get("events", [])[-8:]}
        except (OSError, ValueError):
            pass
        return {**newest, "tail": tail}


# -- process-wide installation + module facade -----------------------------

_TOWER: Optional[Watchtower] = None
_tower_lock = threading.Lock()
_LAST_BLACKBOX: Optional[str] = None


def install(tower: Watchtower) -> Watchtower:
    """Make ``tower`` the process-wide instance the supervisor hook,
    ``/api/metrics`` and ``/api/health`` consult. Returns it."""
    global _TOWER
    with _tower_lock:
        _TOWER = tower
    return tower


def uninstall() -> None:
    global _TOWER
    with _tower_lock:
        t, _TOWER = _TOWER, None
    if t is not None:
        t.stop()


def get() -> Optional[Watchtower]:
    return _TOWER


def alert_states() -> Dict[str, int]:
    """{slo: 0|1|2} for the ``dl4j_alert_state`` Prometheus family —
    empty (zero cost, zero rows) when no watchtower is installed."""
    t = _TOWER
    return t.alert_states() if t is not None else {}


def stats() -> Dict[str, float]:
    """The ``watchtower`` ledger payload (see ``OpProfiler.LEDGERS``)."""
    t = _TOWER
    return t.stats() if t is not None else {}


def note_blackbox(path: str) -> None:
    """The supervisor reports every blackbox dump here so incident
    reports (and ``/api/health``'s ``last_incident``) can point at the
    newest one without knowing the checkpoint layout."""
    global _LAST_BLACKBOX
    with _tower_lock:
        _LAST_BLACKBOX = path


def last_blackbox() -> Optional[str]:
    return _LAST_BLACKBOX


def note_supervisor_failure(failure_class: str, policy: str,
                            corr: Optional[str] = None,
                            error: str = "") -> Optional[str]:
    """Supervisor hook: every failure classification triggers incident
    assembly on the installed watchtower (no-op when none is installed —
    the supervised path owes zero overhead to observability it didn't
    ask for)."""
    t = _TOWER
    if t is None:
        return None
    try:
        return t.assemble_incident(
            kind="supervisor",
            reason=f"{failure_class} -> {policy}" + (
                f" ({error})" if error else ""),
            corr=corr)
    except Exception:
        logger.warning("watchtower: supervisor incident assembly failed",
                       exc_info=True)
        return None


def incidents() -> List[Dict[str, Any]]:
    t = _TOWER
    return t.incidents() if t is not None else []


def last_incident() -> Optional[Dict[str, Any]]:
    """The ``/api/health`` ``last_incident`` pointer: the newest
    incident (path + chain/event tail), falling back to the newest
    blackbox when no incident was ever assembled."""
    t = _TOWER
    if t is not None:
        li = t.last_incident()
        if li is not None:
            return li
    bb = last_blackbox()
    if bb is None:
        return None
    tail: List[Any] = []
    try:
        with open(bb, "r", encoding="utf-8") as f:
            for line in f.readlines()[-8:]:
                try:
                    tail.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        return None
    return {"kind": "blackbox", "path": bb, "tail": tail}


# -- the default objective catalog ----------------------------------------

def default_slos(engine: Any = None,
                 hbm_ceiling_bytes: Optional[float] = None,
                 fast_s: float = 300.0, mid_s: float = 3600.0,
                 slow_s: float = 21600.0, period_s: float = 86400.0,
                 clear_ticks: int = 3) -> List[SLO]:
    """The stock catalog over signals the repo already exports:
    availability (served vs errored requests), per-class latency p99
    when a :class:`~..parallel.serving.ServingEngine` is handed in,
    NaN-free steps, the restart budget, retrace flatness and the HBM
    watermark ceiling. Window arguments exist so compressed-time drills
    (the soak) can scale 5m/1h/6h down without touching thresholds."""
    win = dict(fast_s=fast_s, mid_s=mid_s, slow_s=slow_s,
               period_s=period_s, clear_ticks=clear_ticks)
    slos = [
        SLO("serving-availability",
            counter_ratio_sampler(bad=("serving/batch_errors",),
                                  total=("serving/requests",)),
            budget=0.001, kind="ratio",
            description="99.9% of admitted requests complete", **win),
        SLO("train-nan-free",
            counter_increment_sampler("telemetry/nan_events",
                                      "fleet/nan_culls"),
            budget=0.001, incident="attach",
            description="no poisoned updates reach the params", **win),
        SLO("replica-consistency",
            counter_increment_sampler("integrity/divergences",
                                      "integrity/quarantined_checkpoints"),
            budget=0.001, incident="attach",
            description="replicas stay bitwise-identical and retained "
                        "checkpoints verify on scrub", **win),
        SLO("restart-budget",
            counter_increment_sampler("supervisor/restarts",
                                      "supervisor/storm_trips"),
            budget=0.01, incident="attach",
            description="supervised restarts stay rare", **win),
        SLO("retrace-flat",
            counter_increment_sampler("tracecheck/violations"),
            budget=0.001, incident="attach",
            description="steady-state regions never retrace/sync", **win),
    ]
    if engine is not None:
        for cls in getattr(engine, "slo_classes", lambda: [])():
            slos.append(SLO(
                f"latency-{cls.name}",
                threshold_sampler(
                    lambda name=cls.name: engine.class_recent_p99(name),
                    float(cls.p99_ms)),
                budget=0.01,
                description=f"{cls.name} rolling p99 under "
                            f"{cls.p99_ms:g} ms", **win))
    if hbm_ceiling_bytes is not None:
        def _peak() -> Optional[float]:
            from . import xprof
            vals = [v for k, v in xprof.ledger().items()
                    if k.startswith("hbm/") and k.endswith("peak_live_bytes")]
            return max(vals) if vals else None
        slos.append(SLO(
            "hbm-ceiling", threshold_sampler(_peak, hbm_ceiling_bytes),
            budget=0.01,
            description="peak live HBM stays under the ceiling", **win))
    return slos
