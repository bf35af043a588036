"""Closed-loop serving autoscaler.

Counterpart of ``deeplearning4j_tpu/parallel/autoscale.py``. A controller
thread samples the serving engine's load signals (the windowed queue-depth
high-water mark, the recent p99, the bucket fill ratio, the idle time) at
a fixed cadence and drives :meth:`ServingEngine.scale_to`: replicas grow
on a spike and shrink when idle, with cooldowns and min/max bounds so the
controller cannot oscillate the fleet. A scale-up starts drain threads
that reuse the already-warmed buckets (``trace/serving_infer`` stays flat
at any replica count); a scale-down retires surplus workers at a batch
boundary.

Control law (:meth:`Autoscaler.decide`, a pure function of the signals):

- **Scale up** when the windowed HWM reaches ``up_queue_depth`` or the
  recent p99 reaches ``up_p99_frac`` x the top SLO class's budget,
  ``step`` replicas toward ``max_workers``, at most once per
  ``cooldown_up_s``.
- **Scale down** one replica toward ``min_workers`` when the windowed HWM
  has decayed to ``down_queue_depth`` and the engine has been idle
  ``down_idle_s`` (or the recent fill ratio is under ``down_fill_frac``),
  at most once per ``cooldown_down_s`` and never within it of a scale-up.

Every scale decision is an ``autoscale/decide`` flight-recorder span with
its input signals as attrs, plus an ``autoscale/scale`` instant; held
ticks are counters only. The ``autoscale/decide`` fault site skips one
tick (counted), never the loop. State: ``autoscale/*`` counters and the
``autoscale/replicas`` gauge, ``OpProfiler.autoscale_stats()`` and
:meth:`Autoscaler.stats`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional

from ..common import faultinject, flightrec
from ..common.profiler import OpProfiler
from .mesh import serving_capacity

logger = logging.getLogger("deeplearning4j_tpu_torch")


class AutoscalePolicy:
    """Bounds and thresholds for the control law (module docstring).
    ``max_workers`` defaults to 2x the card count
    (:func:`mesh.serving_capacity`; it raises without a card, so a CPU
    engine names its bound) — beyond that, replicas only contend for
    device streams that are already saturated."""

    def __init__(self, min_workers: int = 1,
                 max_workers: Optional[int] = None,
                 interval_s: float = 0.25,
                 up_queue_depth: int = 8,
                 up_p99_frac: float = 0.8,
                 down_queue_depth: int = 0,
                 down_idle_s: float = 2.0,
                 down_fill_frac: float = 0.25,
                 cooldown_up_s: float = 1.0,
                 cooldown_down_s: float = 3.0,
                 step: int = 1):
        self.min_workers = max(1, int(min_workers))
        self.max_workers = (int(max_workers) if max_workers is not None
                            else 2 * serving_capacity())
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers {self.max_workers} < min_workers "
                f"{self.min_workers}")
        self.interval_s = max(0.01, float(interval_s))
        self.up_queue_depth = int(up_queue_depth)
        self.up_p99_frac = float(up_p99_frac)
        self.down_queue_depth = int(down_queue_depth)
        self.down_idle_s = float(down_idle_s)
        self.down_fill_frac = float(down_fill_frac)
        self.cooldown_up_s = float(cooldown_up_s)
        self.cooldown_down_s = float(cooldown_down_s)
        self.step = max(1, int(step))


class Autoscaler:
    """The controller: samples the engine's load signals every
    ``policy.interval_s`` and actuates ``engine.scale_to``. ``start()``
    runs it on a daemon thread; ``tick()`` is public so drills and tests
    drive single deterministic evaluations."""

    def __init__(self, engine, policy: Optional[AutoscalePolicy] = None):
        self.engine = engine
        self.policy = policy or AutoscalePolicy()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ticks = 0
        self._last_up_t: Optional[float] = None
        self._last_down_t: Optional[float] = None
        self._prev_rows = 0
        self._prev_cap = 0

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Autoscaler":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="dl4j-torch-autoscaler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
        with self._lock:
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.policy.interval_s):
            if getattr(self.engine, "_shutdown", False):
                return
            try:
                self.tick()
            except Exception:
                OpProfiler.get().count("autoscale/decide_errors")
                logger.warning("autoscale tick failed", exc_info=True)

    # -- signals ---------------------------------------------------------
    def _signals(self) -> Dict[str, Any]:
        eng = self.engine
        prof = OpProfiler.get()
        rows = prof.counter_value("serving/rows")
        cap = prof.counter_value("serving/capacity_rows")
        with self._lock:
            d_rows = rows - self._prev_rows
            d_cap = cap - self._prev_cap
            self._prev_rows = rows
            self._prev_cap = cap
        top_budget = None
        adm = getattr(eng, "_adm", None)
        if adm is not None:
            top_budget = adm.top.p99_ms
        return {
            "alive": eng.alive_replicas(),
            "queue_hwm": eng.queue_depth_hwm(),
            "p99_ms": eng.recent_p99_ms(),
            "top_budget_ms": top_budget,
            "idle_s": eng.idle_seconds(),
            "fill_ratio": (d_rows / d_cap) if d_cap else None,
        }

    # -- control law -----------------------------------------------------
    def decide(self, sig: Dict[str, Any], now: Optional[float] = None
               ) -> Dict[str, Any]:
        """The pure control law: signals -> {"target", "reason"}. A
        target equal to ``sig["alive"]`` means hold. Cooldown state is
        read but not written — :meth:`tick` commits it when it actuates."""
        p = self.policy
        now = time.monotonic() if now is None else now
        alive = sig["alive"]
        with self._lock:
            last_up, last_down = self._last_up_t, self._last_down_t
        hot_queue = sig["queue_hwm"] >= p.up_queue_depth
        hot_p99 = (sig["p99_ms"] is not None
                   and sig["top_budget_ms"] is not None
                   and sig["p99_ms"] >= p.up_p99_frac
                   * sig["top_budget_ms"])
        if (hot_queue or hot_p99) and alive < p.max_workers:
            if last_up is not None and now - last_up < p.cooldown_up_s:
                return {"target": alive, "reason": "cooldown_up"}
            return {"target": min(alive + p.step, p.max_workers),
                    "reason": ("queue_hwm=%d" % sig["queue_hwm"]
                               if hot_queue else
                               "p99=%.0fms" % sig["p99_ms"])}
        cold_queue = sig["queue_hwm"] <= p.down_queue_depth
        cold = cold_queue and (
            sig["idle_s"] >= p.down_idle_s
            or (sig["fill_ratio"] is not None
                and sig["fill_ratio"] < p.down_fill_frac))
        if cold and alive > p.min_workers:
            last_any = max(t for t in (last_up, last_down, -1e18)
                           if t is not None)
            if last_any > -1e17 and now - last_any < p.cooldown_down_s:
                return {"target": alive, "reason": "cooldown_down"}
            return {"target": max(alive - 1, p.min_workers),
                    "reason": ("idle=%.1fs" % sig["idle_s"]
                               if sig["idle_s"] >= p.down_idle_s
                               else "fill=%.2f" % sig["fill_ratio"])}
        return {"target": alive, "reason": "steady"}

    # -- one evaluation --------------------------------------------------
    def tick(self) -> Optional[int]:
        """One controller evaluation: sample, decide, actuate. Returns
        the new target when a scale action was taken, None on hold. The
        ``autoscale/decide`` fault site turns a failed evaluation into a
        deterministic drill: a transient skips THIS tick (counted under
        ``autoscale/decide_errors``) and the loop carries on."""
        prof = OpProfiler.get()
        with self._lock:
            ordinal = self._ticks
            self._ticks += 1
        prof.count("autoscale/ticks")
        try:
            faultinject.fault_point("autoscale/decide", ordinal)
        except faultinject.TransientFault:
            prof.count("autoscale/decide_errors")
            return None
        sig = self._signals()
        prof.gauge("autoscale/replicas", sig["alive"])
        decision = self.decide(sig)
        target = decision["target"]
        if target == sig["alive"]:
            prof.count("autoscale/held")
            return None
        now = time.monotonic()
        attrs = {k: (round(v, 3) if isinstance(v, float) else v)
                 for k, v in sig.items() if v is not None}
        # the decision IS the span: its inputs ride as attrs so the
        # timeline answers "why did the fleet resize" without logs
        with flightrec.span("autoscale/decide", severity="warn",
                            target=target, reason=decision["reason"],
                            **attrs):
            self.engine.scale_to(target, reason=decision["reason"])
        up = target > sig["alive"]
        prof.count("autoscale/scale_ups" if up else "autoscale/scale_downs")
        prof.gauge("autoscale/replicas", target)
        with self._lock:
            if up:
                self._last_up_t = now
            else:
                self._last_down_t = now
        flightrec.event("autoscale/scale", frm=sig["alive"], to=target,
                        reason=decision["reason"])
        logger.info("autoscaled %d -> %d (%s)", sig["alive"], target,
                    decision["reason"])
        return target

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            ticks = self._ticks
        out = dict(OpProfiler.get().autoscale_stats())
        out["ticks_local"] = ticks
        out["policy"] = {"min": self.policy.min_workers,
                        "max": self.policy.max_workers,
                        "interval_s": self.policy.interval_s}
        return out
