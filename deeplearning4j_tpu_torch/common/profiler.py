"""Thread-safe event counters, gauges, wall-clock sections and ledgers.

The counterpart of ``deeplearning4j_tpu/common/profiler.py``'s
``OpProfiler``, with the same names:

- the fused inference epilogue: ``precision/epilogue_hits``,
  ``precision/epilogue_fallbacks``, ``precision/epilogue_residual_hits``;
- the fused weight update: ``precision/fused_hits`` (buckets updated by
  ``ops/update.fused_apply``), ``precision/fused_buckets_kernel`` (of those,
  by the CUDA kernel; the JAX package's ``fused_buckets_pallas``),
  ``precision/fused_buckets_plain`` (by the plain version: CPU tensors or a
  non-float32 bucket), ``precision/fused_fallbacks`` (an updater without a
  kernel, or not elementwise), ``precision/sr_draws`` (random 32-bit draws
  for stochastic rounding);
- Word2Vec: ``nlp/w2v_blocks`` and ``nlp/w2v_rounds`` (CBOW blocks and
  rounds run; each round launches ``embedding_bag`` once, counted beside
  its wrapper as ``ops/embeddings.embedding_bag_launches``);
- attention: ``attention/mha_flash`` and ``attention/mha_dense`` (calls of
  ``ops/nn.multi_head_dot_product_attention`` that took flash attention or
  the dense path), and the flash kernel's launches by route:
  ``attention/flash_bf16`` (the bf16 kernel, bf16 inputs as they lie) and
  ``attention/flash_f32`` (the float32 kernel, inputs cast to float32);
  both together are counted beside the wrappers as
  ``ops/attention.flash_attention_launches``. The JAX package counts none
  of these;
- gauges (levels, set not added; :meth:`OpProfiler.gauge_names`):
  ``precision/grads_flat_in_step`` (1 when the step's gradients were born
  in the flat buckets), ``precision/updater_state_bytes_<dtype>`` /
  ``..._total``, ``serving/shed_level``, ``serving/canary_phase``,
  ``serving/queue_depth_hwm``, ``autoscale/replicas``;
- data-parallel training (``parallel/wrapper.py``): the gradient-exchange
  ledger ``collective/*`` and ``zero1/*``, the elastic ledger ``elastic/*``
  and the replica-consistency ledger ``integrity/*``;
- serving (``parallel/inference.py``, ``parallel/serving.py``,
  ``parallel/autoscale.py``): ``inference/*``, ``serving/*``,
  ``autoscale/*`` and the retrace ledger's ``trace/serving_infer`` (the
  first forward at each bucket shape and device slot: the counterpart of
  an AOT compile); ``serving/forwards`` counts every bucket forward
  (warmup, dispatches, probes; the port's own);
- fault injection: ``faults/<site>/<kind>`` and ``pipeline/retries``;
- wall-clock sections (:meth:`OpProfiler.time_section`), each also
  recorded as a ``profiler/section`` flight-recorder event.

:data:`OpProfiler.LEDGERS` lists every derived ledger, the one list that
:meth:`OpProfiler.print_statistics`, ``/api/health`` and ``/api/metrics``
iterate; ``xla`` reads the executable census (``common/xprof.py``) and
``watchtower`` the installed SLO watchtower (``common/watchtower.py``).

:meth:`OpProfiler.start` / :meth:`OpProfiler.stop` (or ``with
trace(logdir)``) run ``torch.profiler`` over CPU and CUDA activity and
write a Chrome trace into ``logdir``.

The port runs eagerly, so a counter counts calls, where the JAX package,
counting at trace time, counts traces.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

from . import flightrec


class OpProfiler:
    _instance: Optional["OpProfiler"] = None
    _lock = threading.Lock()

    #: every derived ledger, by (label, method name), in the JAX package's
    #: order
    LEDGERS: Tuple[Tuple[str, str], ...] = (
        ("overlap", "overlap_stats"),
        ("telemetry", "telemetry_stats"),
        ("checkpoint", "checkpoint_stats"),
        ("supervisor", "supervisor_stats"),
        ("collectives", "collective_stats"),
        ("elastic", "elastic_stats"),
        ("pipeline", "pipeline_stats"),
        ("serving", "serving_stats"),
        ("autoscale", "autoscale_stats"),
        ("fleet", "fleet_stats"),
        ("precision", "precision_stats"),
        ("xla", "xla_stats"),
        ("tracecheck", "tracecheck_stats"),
        ("faults", "fault_stats"),
        ("watchtower", "watchtower_stats"),
        ("integrity", "integrity_stats"),
    )

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._sections: Dict[str, Dict[str, float]] = {}
        self._gauge_names: set = set()
        self._counter_lock = threading.Lock()
        self._trace = None           # the running torch.profiler.profile
        self._trace_dir: Optional[str] = None

    @classmethod
    def get(cls) -> "OpProfiler":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # --- device trace (torch.profiler → a Chrome trace) ----------------------
    def start(self, logdir: str) -> None:
        """Trace CPU and CUDA activity until :meth:`stop`."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with self._counter_lock:
            if self._trace is not None:
                raise RuntimeError("profiler already tracing")
            prof = torch.profiler.profile(activities=acts)
            self._trace, self._trace_dir = prof, logdir
        try:
            prof.__enter__()
        except BaseException:
            # a failed start must not leave the profiler "already tracing"
            with self._counter_lock:
                self._trace = self._trace_dir = None
            raise
        from .environment import Environment

        Environment.get().set_profiling(True)

    def stop(self) -> Optional[str]:
        """End the trace; returns the Chrome trace's path (None when no
        trace was running)."""
        with self._counter_lock:
            prof, logdir = self._trace, self._trace_dir
            self._trace = self._trace_dir = None
        if prof is None:
            return None
        from .environment import Environment

        Environment.get().set_profiling(False)
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"trace_{os.getpid()}_"
                                    f"{int(time.time() * 1e3)}.json")
        prof.export_chrome_trace(path)
        return path

    @contextmanager
    def trace(self, logdir: str):
        self.start(logdir)
        try:
            yield self
        finally:
            self.stop()

    # --- counters and gauges -------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: int) -> None:
        """Set a counter to an absolute value (a level, last write wins)."""
        with self._counter_lock:
            self._counters[name] = value
            self._gauge_names.add(name)

    def gauge_names(self) -> set:
        """Counter names set via :meth:`gauge` (levels, not totals)."""
        with self._counter_lock:
            return set(self._gauge_names)

    def counter_value(self, name: str) -> int:
        with self._counter_lock:
            return self._counters.get(name, 0)

    def get_counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self._counters)

    def trace_counts(self) -> Dict[str, int]:
        """Just the ``trace/*`` counters (the retrace ledger)."""
        with self._counter_lock:
            return {k: v for k, v in self._counters.items()
                    if k.startswith("trace/")}

    # --- wall-clock sections -------------------------------------------------
    @contextmanager
    def time_section(self, name: str):
        """Wall-clock time of the ``with`` block under ``name``: count,
        total and largest seconds (:meth:`get_statistics`), and one
        ``profiler/section`` flight-recorder event per entry."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._counter_lock:
                s = self._sections.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                s["count"] += 1
                s["total_s"] += dt
                s["max_s"] = max(s["max_s"], dt)
            # outside the profiler lock: the recorder has its own
            flightrec.event("profiler/section", section=name, dur_s=dt)

    def get_statistics(self) -> Dict[str, Dict[str, float]]:
        with self._counter_lock:
            return {k: dict(v) for k, v in self._sections.items()}

    # --- ledgers -------------------------------------------------------------
    def _with_prefix(self, prefix: str) -> Dict[str, float]:
        with self._counter_lock:
            return {k.split("/", 1)[1]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def _sections_into(self, out: Dict[str, float], pairs) -> None:
        with self._counter_lock:
            for sec, key in pairs:
                s = self._sections.get(sec)
                if s:
                    out[key] = s["total_s"]
                    out[key.replace("_s", "_count")] = s["count"]

    def _counters_into(self, out: Dict[str, float], pairs) -> None:
        with self._counter_lock:
            for ctr, key in pairs:
                n = self._counters.get(ctr)
                if n:
                    out[key] = n

    def overlap_stats(self) -> Dict[str, float]:
        """Input-pipeline overlap: host time blocked on the next batch
        against time issuing steps."""
        out: Dict[str, float] = {}
        self._sections_into(out, (("pipeline/next_batch", "host_wait_s"),
                                  ("pipeline/dispatch", "dispatch_s")))
        if "host_wait_s" in out and "dispatch_s" in out:
            busy = out["host_wait_s"] + out["dispatch_s"]
            if busy > 0:
                out["host_wait_frac"] = out["host_wait_s"] / busy
        return out

    def telemetry_stats(self) -> Dict[str, float]:
        """In-step telemetry drains: time, count, largest, steps drained."""
        out: Dict[str, float] = {}
        with self._counter_lock:
            s = self._sections.get("telemetry/drain")
            if s:
                out = {"drain_s": s["total_s"], "drain_count": s["count"],
                       "drain_max_s": s["max_s"]}
        self._counters_into(out, (("telemetry/drained_steps",
                                   "drained_steps"),))
        return out

    def checkpoint_stats(self) -> Dict[str, float]:
        """Checkpoint path: snapshot and write time, commits and bytes."""
        out: Dict[str, float] = {}
        self._sections_into(out, (("checkpoint/snapshot", "snapshot_s"),
                                  ("checkpoint/write", "write_s")))
        self._counters_into(out, (("checkpoint/committed", "committed"),
                                  ("checkpoint/bytes", "bytes")))
        return out

    def supervisor_stats(self) -> Dict[str, float]:
        """The training supervisor's ledger (``parallel/distributed``):
        attempts, restarts, watchdog fires, preemptions, shrinks, remaps,
        quarantines, storm trips and give-ups (the ``supervisor/*``
        counters), plus the backoff's seconds; empty when no supervisor
        ran."""
        out = self._with_prefix("supervisor/")
        self._sections_into(out, (("supervisor/backoff", "backoff_s"),))
        return out

    def collective_stats(self) -> Dict[str, float]:
        """The gradient-exchange ledger: bytes per collective kind, the
        ZeRO-1 updater-state footprint, and the encoded exchange's element
        counts with their density and the wire-format estimate (4-byte
        indices, or a 2-bit bitmap when that is smaller)."""
        out = self._with_prefix("collective/")
        with self._counter_lock:
            for ctr in ("zero1/updater_state_bytes_total",
                        "zero1/updater_state_bytes_per_replica"):
                n = self._counters.get(ctr)
                if n:
                    out[ctr.replace("/", "_")] = n
        sent = out.get("encoded_elems_sent")
        total = out.get("encoded_elems_total")
        if total:
            out["encoded_density"] = sent / total
            out["encoded_bytes_est"] = int(min(4 * sent, total // 4))
            out["encoded_dense_bytes_equiv"] = int(4 * total)
        return out

    def elastic_stats(self) -> Dict[str, float]:
        """The elastic ledger: resizes, shrinks, grows, the live worker
        count, and the resize section's seconds."""
        out = self._with_prefix("elastic/")
        with self._counter_lock:
            s = self._sections.get("elastic/resize")
            if s:
                out["resize_s"] = s["total_s"]
                out["resize_count"] = s["count"]
        return out

    def pipeline_stats(self) -> Dict[str, float]:
        """The pipeline trainer's ledger (``parallel/pipeline.py``): the
        live ``stages``, ``remaps`` and their seconds, ``microbatches``
        dispatched and the schedule's tick occupancy (``busy_ticks`` of
        ``tick_slots``, read off the tick tables the step runs) with the
        derived ``bubble_fraction``."""
        out: Dict[str, float] = {}
        self._counters_into(out, (("pipeline/stages", "stages"),
                                  ("pipeline/remaps", "remaps"),
                                  ("pipeline/microbatches", "microbatches"),
                                  ("pipeline/busy_ticks", "busy_ticks"),
                                  ("pipeline/tick_slots", "tick_slots")))
        slots = out.get("tick_slots")
        if slots:
            out["bubble_fraction"] = 1.0 - out.get("busy_ticks", 0) / slots
        with self._counter_lock:
            s = self._sections.get("pipeline/remap")
            if s:
                out["remap_s"] = s["total_s"]
                out["remap_count"] = s["count"]
        return out

    def serving_stats(self) -> Dict[str, float]:
        """The serving ledger: requests, batches, bucket fill ratio (real
        rows over dispatched bucket rows) and pad waste, queue-depth gauges,
        requeues, oversize admissions, ``traces_after_warmup`` (must stay
        0), and the dispatch and warmup seconds. Latency quantiles live on
        the engines (``parallel/serving.serving_health``)."""
        out = self._with_prefix("serving/")
        cap = out.get("capacity_rows")
        if cap:
            out["fill_ratio"] = out.get("rows", 0) / cap
            out["pad_waste"] = out.get("pad_rows", 0) / cap
        self._sections_into(out, (("serving/dispatch", "dispatch_s"),
                                  ("serving/warmup", "warmup_s")))
        return out

    def autoscale_stats(self) -> Dict[str, float]:
        """The autoscaler: ticks, scale-ups and -downs, holds, skipped
        evaluations, and the live ``replicas`` gauge."""
        return self._with_prefix("autoscale/")

    def fleet_stats(self) -> Dict[str, float]:
        """Fleet training (``parallel/fleet.py``): the live ``members``
        gauge, culls, spawns, NaN culls and telemetry drains."""
        return self._with_prefix("fleet/")

    def precision_stats(self) -> Dict[str, float]:
        """Mixed precision: the fused update's and epilogue's hits and
        fallbacks, stochastic-rounding draws, updater-state byte gauges."""
        return self._with_prefix("precision/")

    def xla_stats(self) -> Dict[str, float]:
        """The executable census (``common/xprof.py``): per-executable
        calls, mean dispatch ms, generations, first-call wall, counted
        flops/bytes, arithmetic intensity, MFU and the compute-vs-memory
        verdict, plus the census totals and the per-phase memory
        watermarks, under slash-keys. Empty until a step registers."""
        try:
            from . import xprof

            return xprof.ledger()
        except Exception:       # census failure: ledger-silent
            return {}

    def tracecheck_stats(self) -> Dict[str, float]:
        """Steady-state regions (``common/tracecheck.py``): regions armed
        and regions that tripped."""
        return self._with_prefix("tracecheck/")

    def fault_stats(self) -> Dict[str, float]:
        """Fault injection: ``faults/<site>/<kind>`` counters, pipeline
        retries and their backoff seconds."""
        with self._counter_lock:
            out: Dict[str, float] = {k: v for k, v in self._counters.items()
                                     if k.startswith("faults/")}
            n = self._counters.get("pipeline/retries")
            if n:
                out["retries"] = n
            s = self._sections.get("pipeline/retry_backoff")
            if s:
                out["retry_backoff_s"] = s["total_s"]
        return out

    def watchtower_stats(self) -> Dict[str, float]:
        """The SLO watchtower (``common/watchtower.py``): per-SLO alert
        state (0 ok / 1 warn / 2 page), fast-window burn rate and error
        budget remaining, plus evaluation/incident totals. Empty until a
        ``Watchtower`` is installed."""
        try:
            from . import watchtower

            return watchtower.stats()
        except Exception:   # watchtower absent/uninstalled: ledger-silent
            return {}

    def integrity_stats(self) -> Dict[str, float]:
        """Replica consistency and the checkpoint scrubber: checks,
        divergences, bit-flip drills, scrub passes, quarantines, publish
        checks."""
        return self._with_prefix("integrity/")

    def ledger_stats(self) -> Dict[str, Dict[str, float]]:
        """Every non-empty derived ledger (:data:`LEDGERS`), by label."""
        out: Dict[str, Dict[str, float]] = {}
        for label, attr in self.LEDGERS:
            stats = getattr(self, attr)()
            if stats:
                out[label] = stats
        return out

    def print_statistics(self) -> str:
        lines = [f"{'section':<32}{'count':>8}{'total ms':>12}"
                 f"{'mean ms':>12}{'max ms':>12}"]
        for name, s in sorted(self.get_statistics().items(),
                              key=lambda kv: -kv[1]["total_s"]):
            mean = s["total_s"] / max(s["count"], 1)
            lines.append(f"{name:<32}{s['count']:>8}"
                         f"{s['total_s'] * 1e3:>12.2f}"
                         f"{mean * 1e3:>12.2f}{s['max_s'] * 1e3:>12.2f}")
        for label, stats in self.ledger_stats().items():
            lines.append(f"[{label}] " + "  ".join(
                f"{k}={round(v, 6) if isinstance(v, float) else v}"
                for k, v in sorted(stats.items())
                if isinstance(v, (int, float))))
        out = "\n".join(lines)
        print(out)
        return out

    def reset(self) -> None:
        with self._counter_lock:
            self._counters.clear()
            self._sections.clear()
            self._gauge_names.clear()
