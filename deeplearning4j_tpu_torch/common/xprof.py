"""Performance observatory: executable census, roofline ledger, memory
watermarks.

Counterpart of ``deeplearning4j_tpu/common/xprof.py``, with its public
functions and :data:`EXEC_SITES` under the JAX names. The port has no jit,
so each JAX notion maps onto the eager program like this:

1. **Executable census.** Every long-lived step the port runs registers
   under a stable name from :data:`EXEC_SITES`. :func:`register_jit` wraps
   a port callable and tracks, per entry: calls, cumulative dispatch wall
   time, a GENERATION counter and the first-call wall time of each
   generation. A generation is a new argument signature (the shapes,
   dtypes and devices of the tensor arguments, and the values of the
   declared static arguments): the port's counterpart of a retrace.
   Python scalars and other objects among the arguments are dynamic
   values and do not enter the signature. The first call of each
   generation is timed on its own and so carries cuDNN's algorithm choice
   and lazy kernel loads. :func:`register_aot` records a warmed forward
   (the serving bucket ladder, one variant per (bucket shape, slot)), and
   :func:`note_subexec` records a hand-written kernel launched INSIDE a
   parent step (``ops/update.fused_apply``'s flat-bucket updater) with its
   analytic flops and bytes.
2. **Roofline attribution ledger.** The JAX package lowers a program
   without running it; the port cannot, and a train step run again for
   analysis would step the model. So the first call of each generation
   does the counting: its flops come from
   ``torch.utils.flop_counter.FlopCounterMode`` over that call, its bytes
   are counted from the argument and output tensors (the JAX package's
   COUNTED fallback), and on the card its memory is
   ``torch.cuda.max_memory_allocated`` over that call.
   :func:`analyze` only reads what was recorded and never re-runs a
   callable. FlopCounterMode sees aten operators only: the hand-written
   kernels loaded through ``ctypes`` (``ops/cuda_lib.load``) are not in
   its count (inference's ``bn_act`` epilogue, flash attention inside a
   forward), as XLA's cost analysis does not see a Pallas call; the
   optimizer kernel's cost comes from :func:`note_subexec`, as in the JAX
   package. :func:`roofline` joins the analytic cost with measured time
   into per-executable MFU, arithmetic intensity and a compute-bound
   versus memory-bound verdict against :data:`PLATFORM_ROOFS` (or
   :func:`set_roof`); :func:`ledger` flattens it into the profiler's
   ``xla`` ledger, so ``/api/health``, ``/api/metrics`` and
   ``print_statistics`` carry it. Dispatch wall time is host-side queueing
   time on the card; feed a fenced per-step median through
   :func:`note_measured` for an honest MFU.
3. **Memory watermarks.** :func:`memory_watermark` takes the same memory
   census ``/api/health`` serves (``common/system_info.memory_summary``:
   the caching allocator's bytes in use per card) and folds it into
   per-phase peak gauges. It never resets the allocator's peak (that is
   per device and other readers use it): it samples what is live and
   keeps its own per-phase maximum. ``data/pipeline.run_epochs`` samples
   once per epoch (phase ``fit``), the serving warmup samples
   ``serving_warmup``, and the supervisor's crash blackbox dumps the full
   census (:func:`dump_memory_census` -> ``memcensus.json`` beside
   ``blackbox.jsonl``). On the CPU the census has no card and the live
   figures are 0.

Census overhead is one enabled-flag read, a signature walk over the
tensor arguments, two ``perf_counter`` calls and a lock per dispatch
(``configure(enabled=False)`` reduces it to the flag read). Each new
generation is reported to ``common/tracecheck.note_compile``.

Executable-census registry
--------------------------
==========================  ============================================
census name                 executable / registrar
==========================  ============================================
mln/infer                   MultiLayerNetwork.output forward
mln/fit_step                MultiLayerNetwork per-step train step
mln/fit_chunk               no counterpart: the port runs a
                            steps_per_dispatch group step by step
                            (mln/fit_step)
mln/tbptt_step              MultiLayerNetwork TBPTT segment step
mln/pretrain_step           MultiLayerNetwork layerwise pretrain step
graph/infer                 ComputationGraph.output forward
graph/fit_step              ComputationGraph per-step train step
graph/fit_chunk             no counterpart: a group runs step by step
                            (graph/fit_step)
transfer/featurize          TransferLearningHelper frozen-bottom forward
pw/fit_step                 ParallelWrapper data-parallel step (dense +
                            ZeRO-1 paths)
pw/fit_chunk                no counterpart: a group runs step by step
                            (pw/fit_step)
pipeline/fit_step           PipelineTrainer whole-schedule step
pipeline/legacy_fwd         legacy PipelineParallel forward
pipeline/legacy_step        legacy PipelineParallel train step
pipeline/hetero_fwd         HeterogeneousPipeline forward
pipeline/hetero_step        HeterogeneousPipeline train step
fleet/step                  FleetTrainer member-batched population step
fleet/infer                 FleetTrainer member-batched inference
embeddings/lookup           ShardedEmbedding gather
embeddings/update           ShardedEmbedding scatter-update
serving/bucket              ServingEngine warmed bucket forwards (one
                            variant per (shape, device slot))
samediff/exec               SameDiff forward execution
samediff/grad               SameDiff gradient
samediff/fit_step           SameDiff train step
nlp/w2v_subsample           Word2Vec subsampling draw
nlp/w2v_sg_block            Word2Vec skip-gram pair block
nlp/w2v_table_block         Word2Vec dense-round table block
nlp/w2v_cbow_block          Word2Vec CBOW windowed block
nlp/pv_dbow_block           ParagraphVectors DBOW block
nlp/pv_dm_block             ParagraphVectors DM (CBOW-class) block
nlp/pv_pos_map              ParagraphVectors shuffled-pair order
nlp/pv_subsample            ParagraphVectors subsampling draw
nlp/fasttext_block          FastText subword CBOW block
nlp/glove_block             GloVe AdaGrad descent block
data/feature_transform      AsyncDataSetIterator feature transform
pallas/update_bucket        fused flat-bucket updater kernel
                            (csrc/fused_update.cu; counted
                            sub-executable: launched inside the parent
                            step; analytic flops/bytes per launch)
==========================  ============================================
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from . import flightrec, tracecheck
from .profiler import OpProfiler

_NO_PORT = "no counterpart in the port (a group runs step by step)"

#: The executable-census registry, with the JAX package's names: census
#: name -> what registers it + the drill that proves it. A
#: ``register_jit``/``register_aot``/``note_subexec`` call with a name not
#: in it raises ValueError.
EXEC_SITES: Dict[str, Dict[str, str]] = {
    "mln/infer": {
        "desc": "MultiLayerNetwork.output forward",
        "drill": "test_torch_xprof census coverage"},
    "mln/fit_step": {
        "desc": "MultiLayerNetwork per-step train step",
        "drill": "test_torch_xprof census coverage"},
    "mln/fit_chunk": {
        "desc": "MultiLayerNetwork steps_per_dispatch chunk: " + _NO_PORT,
        "drill": "test_torch_xprof registry table"},
    "mln/tbptt_step": {
        "desc": "MultiLayerNetwork TBPTT segment step",
        "drill": "test_torch_xprof census coverage"},
    "mln/pretrain_step": {
        "desc": "MultiLayerNetwork layerwise pretrain step",
        "drill": "test_torch_xprof registry table"},
    "graph/infer": {
        "desc": "ComputationGraph.output forward",
        "drill": "test_torch_xprof census coverage"},
    "graph/fit_step": {
        "desc": "ComputationGraph per-step train step",
        "drill": "test_torch_xprof census coverage; chip_smoke phase 59"},
    "graph/fit_chunk": {
        "desc": "ComputationGraph scan chunk: " + _NO_PORT,
        "drill": "test_torch_xprof registry table"},
    "transfer/featurize": {
        "desc": "TransferLearningHelper frozen-bottom forward",
        "drill": "test_torch_xprof census coverage"},
    "pw/fit_step": {
        "desc": "ParallelWrapper data-parallel step (dense + ZeRO-1)",
        "drill": "test_torch_xprof census coverage"},
    "pw/fit_chunk": {
        "desc": "ParallelWrapper scan chunk: " + _NO_PORT,
        "drill": "test_torch_xprof registry table"},
    "pipeline/fit_step": {
        "desc": "PipelineTrainer whole-schedule step",
        "drill": "test_torch_pipeline_parallel steady state"},
    "pipeline/legacy_fwd": {
        "desc": "legacy PipelineParallel forward",
        "drill": "test_torch_xprof registry table"},
    "pipeline/legacy_step": {
        "desc": "legacy PipelineParallel train step",
        "drill": "test_torch_xprof registry table"},
    "pipeline/hetero_fwd": {
        "desc": "HeterogeneousPipeline forward",
        "drill": "test_torch_xprof registry table"},
    "pipeline/hetero_step": {
        "desc": "HeterogeneousPipeline train step",
        "drill": "test_torch_xprof registry table"},
    "fleet/step": {
        "desc": "FleetTrainer member-batched population step",
        "drill": "test_torch_xprof census coverage"},
    "fleet/infer": {
        "desc": "FleetTrainer member-batched inference",
        "drill": "test_torch_xprof registry table"},
    "embeddings/lookup": {
        "desc": "ShardedEmbedding gather",
        "drill": "test_torch_xprof registry table"},
    "embeddings/update": {
        "desc": "ShardedEmbedding scatter-update",
        "drill": "test_torch_xprof registry table"},
    "serving/bucket": {
        "desc": "ServingEngine warmed bucket forward (variant per "
                "(shape, device slot))",
        "drill": "test_torch_xprof serving census; chip_smoke phase 60"},
    "samediff/exec": {
        "desc": "SameDiff forward execution",
        "drill": "test_torch_xprof registry table"},
    "samediff/grad": {
        "desc": "SameDiff gradient",
        "drill": "test_torch_xprof registry table"},
    "samediff/fit_step": {
        "desc": "SameDiff train step",
        "drill": "test_torch_xprof registry table"},
    "nlp/w2v_subsample": {
        "desc": "Word2Vec subsampling draw",
        "drill": "test_torch_xprof registry table"},
    "nlp/w2v_sg_block": {
        "desc": "Word2Vec skip-gram pair block",
        "drill": "test_torch_xprof registry table"},
    "nlp/w2v_table_block": {
        "desc": "Word2Vec dense-round table block (plain + sharded)",
        "drill": "test_torch_xprof registry table"},
    "nlp/w2v_cbow_block": {
        "desc": "Word2Vec CBOW windowed block",
        "drill": "test_torch_xprof registry table"},
    "nlp/pv_dbow_block": {
        "desc": "ParagraphVectors DBOW block",
        "drill": "test_torch_xprof registry table"},
    "nlp/pv_dm_block": {
        "desc": "ParagraphVectors DM block",
        "drill": "test_torch_xprof registry table"},
    "nlp/pv_pos_map": {
        "desc": "ParagraphVectors shuffled-pair order",
        "drill": "test_torch_xprof registry table"},
    "nlp/pv_subsample": {
        "desc": "ParagraphVectors subsampling draw",
        "drill": "test_torch_xprof registry table"},
    "nlp/fasttext_block": {
        "desc": "FastText subword CBOW block",
        "drill": "test_torch_xprof registry table"},
    "nlp/glove_block": {
        "desc": "GloVe AdaGrad descent block",
        "drill": "test_torch_xprof registry table"},
    "data/feature_transform": {
        "desc": "AsyncDataSetIterator feature transform",
        "drill": "test_torch_xprof registry table"},
    "pallas/update_bucket": {
        "desc": "fused flat-bucket updater kernel csrc/fused_update.cu "
                "(counted sub-executable inside the parent step)",
        "drill": "test_torch_xprof counted sub-executable test; "
                 "chip_smoke phase 59"},
}

#: Platform rooflines by the port's backend: (peak flops/s, peak memory
#: bytes/s). The ``gpu`` row is the H100 SXM's published dense bf16 peak
#: and HBM3 bandwidth (the figures the kernel bounds use); the ``cpu`` row
#: is a NOMINAL single-core planning roof (verdicts against it are
#: approximate by construction; :func:`set_roof` overrides both).
PLATFORM_ROOFS: Dict[str, Tuple[float, float]] = {
    "gpu": (989e12, 3.35e12),
    "cpu": (5e10, 2e10),
}


def _now() -> float:
    return time.perf_counter()


class _Entry:
    """One census entry: identity + accumulated dispatch/compile
    accounting + the newest generation's counted cost."""

    __slots__ = ("name", "calls", "dispatch_s", "generations", "compile_s",
                 "fingerprint", "cost", "memory",
                 "cost_source", "analyzed_gen", "measured_step_s",
                 "variants", "error", "subexec", "counted_gen")

    def __init__(self, name: str):
        self.name = name
        self.calls = 0
        self.dispatch_s = 0.0
        self.generations = 0        # distinct argument signatures seen
        self.compile_s = 0.0        # sum of first-call-per-generation wall
        self.fingerprint: Dict[str, Any] = {}
        self.cost: Optional[Dict[str, float]] = None
        self.memory: Optional[Dict[str, float]] = None
        self.cost_source: Optional[str] = None   # "flop_counter"|"counted"
        self.analyzed_gen = 0       # generation the last analyze() read
        self.counted_gen = 0        # generation the cost belongs to
        self.measured_step_s: Optional[float] = None
        self.variants = 0           # warmed variants folded in (serving)
        self.error: Optional[str] = None
        self.subexec = False        # counted-only sub-executable

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "calls": self.calls,
            "dispatch_s": round(self.dispatch_s, 6),
            "generations": self.generations,
            "compile_s": round(self.compile_s, 6),
            "fingerprint": dict(self.fingerprint),
            "cost_source": self.cost_source,
        }
        if self.cost:
            out["cost"] = dict(self.cost)
        if self.memory:
            out["memory"] = dict(self.memory)
        if self.variants:
            out["variants"] = self.variants
        if self.measured_step_s is not None:
            out["measured_step_s"] = self.measured_step_s
        if self.subexec:
            out["subexec"] = True
        if self.error:
            out["error"] = self.error
        return out


class ExecutableCensus:
    """The process-wide census (instantiable for tests). Thread-safe:
    dispatches land from the training thread, serving workers and the
    checkpoint writer alike."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._enabled = True
        self._roof: Optional[Tuple[float, float]] = None
        self._watermarks: Dict[str, Dict[str, Any]] = {}

    # -- config -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: Optional[bool] = None) -> "ExecutableCensus":
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
        return self

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._watermarks.clear()

    def set_roof(self, peak_flops: float, peak_bytes_per_s: float) -> None:
        with self._lock:
            self._roof = (float(peak_flops), float(peak_bytes_per_s))

    def _platform_roof(self) -> Tuple[Optional[float], Optional[float]]:
        if self._roof is not None:
            return self._roof
        try:
            import torch

            plat = "gpu" if torch.cuda.is_available() else "cpu"
        except Exception:
            plat = "cpu"
        return PLATFORM_ROOFS.get(plat, PLATFORM_ROOFS["cpu"])

    # -- registration -----------------------------------------------------
    def _entry(self, name: str) -> _Entry:
        if name not in EXEC_SITES:
            raise ValueError(
                f"unknown executable-census site {name!r} — register it "
                "in common.xprof.EXEC_SITES (and the docstring table)")
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name)
            return e

    def register_jit(self, name: str, fn, *, donate=None,
                     static_argnames=None):
        """Wrap a port callable under census ``name``. The wrapper is
        call-transparent (attribute access falls through to ``fn``).
        Re-registering a name (a rebuilt step) accumulates onto the same
        entry: that IS the generation ledger. Wrappers resolve their entry
        BY NAME per dispatch, so a :meth:`reset` opens a clean window
        without orphaning live wrappers. ``static_argnames``: keyword
        arguments whose values enter the signature."""
        fp: Dict[str, Any] = {}
        if donate is not None:
            fp["donate_argnums"] = tuple(donate)
        if static_argnames is not None:
            fp["static_argnames"] = tuple(static_argnames)
        e = self._entry(name)
        with self._lock:
            e.fingerprint.update(fp)
        return _Censused(self, name, fn, fp, tuple(static_argnames or ()))

    def register_aot(self, name: str, compiled, *, variant: str = "",
                     compile_s: Optional[float] = None) -> None:
        """Record a warmed forward: ``compiled`` is the record
        :func:`count_call` returned for its first run. Repeated variants
        (serving buckets) accumulate flops/bytes onto the one entry."""
        if compiled is None:
            return
        e = self._entry(name)
        cost = _cost_dict(compiled)
        mem = _memory_dict(compiled)
        source = "flop_counter" if cost and cost.get("flops") else "counted"
        with self._lock:
            e.generations += 1
            e.variants += 1
            if compile_s:
                e.compile_s += float(compile_s)
            if cost is not None:
                # key-UNION merge: a variant whose count omits a key must
                # not erase the other variants' accumulated mass
                prev = e.cost or {}
                e.cost = {k: prev.get(k, 0.0) + cost.get(k, 0.0)
                          for k in set(prev) | set(cost)}
                e.cost_source = ("flop_counter" if "flop_counter" in
                                 (source, e.cost_source) else "counted")
            elif e.cost_source is None:
                e.cost_source = "counted"
                e.cost = {}
            if mem is not None:
                prev_m = e.memory or {}
                e.memory = {k: (max(prev_m.get(k, 0), v)
                                if k == "peak_allocated_bytes"
                                else prev_m.get(k, 0) + v)
                            for k, v in mem.items()}
            if variant:
                e.fingerprint["last_variant"] = variant
            gen = e.generations
        tracecheck.note_compile(f"{name}:{variant}")
        flightrec.event("xprof/exec", executable=name,
                        generation=gen, variant=variant or None,
                        aot=True)

    def note_subexec(self, name: str, flops: Optional[float] = None,
                     bytes_accessed: Optional[float] = None,
                     **attrs) -> None:
        """Counted census entry for a kernel launched INSIDE a parent step
        (the fused flat-bucket updater). The port calls it at every
        launch: ``calls`` counts the launches, and a generation is a new
        (flops, bytes, attrs) description. The cost is LAST-LAUNCH-WINS,
        never accumulated: it describes one launch of the most recent
        parent."""
        e = self._entry(name)
        cost: Dict[str, float] = {}
        if flops is not None:
            cost["flops"] = float(flops)
        if bytes_accessed is not None:
            cost["bytes_accessed"] = float(bytes_accessed)
        with self._lock:
            e.subexec = True
            e.calls += 1
            e.cost_source = "counted"
            new = (e.cost != cost or any(e.fingerprint.get(k) != v
                                         for k, v in attrs.items()))
            if new:
                e.generations += 1
                e.cost = cost
                e.fingerprint.update(attrs)
            gen = e.generations
        if new:
            flightrec.event("xprof/exec", executable=name,
                            generation=gen, subexec=True)

    # -- dispatch accounting (wrapper callback) ---------------------------
    def _note_call(self, name: str, wrapper, dt: float, new_gen: bool,
                   signature, counted) -> None:
        with self._lock:
            # resolved BY NAME per dispatch (a reset() must not orphan
            # live wrappers)
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name)
                e.fingerprint.update(wrapper._fp)
            # post-reset (or census re-enabled): the warm signature
            # serving this call joins the fresh window as its FIRST
            # generation, with the cost counted at its first call and no
            # compile wall (nothing was new during this call)
            window_seed = not new_gen and e.generations == 0
            e.calls += 1
            e.dispatch_s += dt
            if new_gen:
                e.compile_s += dt
            if new_gen or window_seed:
                e.generations += 1
                if counted is None:
                    counted = wrapper._counted.get(signature)
                if counted is not None:
                    cost, mem, err = counted
                    e.cost = dict(cost)
                    e.cost_source = ("flop_counter" if cost.get("flops")
                                     else "counted")
                    e.memory = dict(mem) if mem else None
                    e.error = err
                    e.counted_gen = e.generations
                gen = e.generations
        if new_gen or window_seed:
            if new_gen:
                tracecheck.note_compile(name)
            flightrec.event("xprof/exec", executable=name,
                            generation=gen,
                            compile_s=round(dt, 6) if new_gen else None)

    def note_measured(self, name: str, step_s: float) -> None:
        """Feed a FENCED per-step time (a synchronized median) so the
        roofline joins against real device time instead of host-side
        queueing time."""
        e = self._entry(name)
        with self._lock:
            e.measured_step_s = float(step_s)

    # -- analysis ---------------------------------------------------------
    def analyze(self, names=None, compile: bool = True) -> Dict[str, dict]:
        """The cost of each registered entry's newest generation, as its
        first call counted it. Never re-runs a callable (a train step run
        again would step the model); ``compile`` is accepted for the JAX
        signature and changes nothing. Idempotent per generation: an
        entry is returned again only after a new generation."""
        with self._lock:
            todo = [e for e in self._entries.values()
                    if (names is None or e.name in names)
                    and not e.subexec and not e.variants
                    and e.generations > 0
                    and e.analyzed_gen != e.generations]
            out = {}
            for e in todo:
                if e.counted_gen != e.generations or e.cost is None:
                    e.error = e.error or "first call was not counted"
                    e.cost = e.cost or {}
                    e.cost_source = "counted"
                e.analyzed_gen = e.generations
                out[e.name] = e.summary()
        return out

    # -- roofline ---------------------------------------------------------
    def roofline(self) -> Dict[str, dict]:
        """Per-executable roofline attribution: measured step time joined
        with analytic flops/bytes -> MFU, arithmetic intensity, and the
        compute-vs-memory-bound verdict (AI against the roof's ridge
        point). Entries without a count carry what they have."""
        peak_f, peak_b = self._platform_roof()
        ridge = (peak_f / peak_b) if peak_f and peak_b else None
        out: Dict[str, dict] = {}
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            row = e.summary()
            step_s = e.measured_step_s
            if step_s is None and e.calls and not e.subexec:
                step_s = e.dispatch_s / e.calls
            cost = e.cost or {}
            flops = cost.get("flops")
            nbytes = cost.get("bytes_accessed")
            if step_s:
                row["step_s"] = round(step_s, 6)
            if flops and nbytes:
                row["arithmetic_intensity"] = flops / nbytes
                if ridge is not None:
                    row["bound"] = ("compute" if flops / nbytes >= ridge
                                    else "hbm")
            if flops and step_s and peak_f:
                row["effective_flops_per_s"] = flops / step_s
                row["mfu"] = flops / step_s / peak_f
            if nbytes and step_s and peak_b:
                row["achieved_bytes_per_s"] = nbytes / step_s
            out[e.name] = row
        return out

    def ledger(self) -> Dict[str, float]:
        """The flat ``xla`` profiler ledger (``OpProfiler.LEDGERS``):
        per-executable roofline numbers under slash-keys plus census
        totals and the memory watermark gauges — everything numeric, so
        ``/api/metrics`` and ``print_statistics`` render it as-is."""
        rows = self.roofline()
        peak_f, peak_b = self._platform_roof()
        out: Dict[str, float] = {}
        if rows:
            out["executables"] = len(rows)
            out["analyzed"] = sum(1 for r in rows.values() if "cost" in r)
            out["calls"] = sum(r.get("calls", 0) for r in rows.values())
            out["dispatch_s"] = round(sum(r.get("dispatch_s", 0.0)
                                          for r in rows.values()), 6)
            if peak_f:
                out["roof_peak_flops"] = peak_f
            if peak_b:
                out["roof_peak_bytes_per_s"] = peak_b
        for name, r in rows.items():
            cost = r.get("cost", {})
            if r.get("calls"):
                out[f"{name}/calls"] = r["calls"]
                out[f"{name}/dispatch_ms"] = round(
                    r["dispatch_s"] / r["calls"] * 1e3, 4)
            if r.get("generations"):
                out[f"{name}/generations"] = r["generations"]
            if r.get("compile_s"):
                out[f"{name}/compile_s"] = round(r["compile_s"], 4)
            if cost.get("flops"):
                out[f"{name}/flops"] = cost["flops"]
            if cost.get("bytes_accessed"):
                out[f"{name}/bytes"] = cost["bytes_accessed"]
            if r.get("memory", {}).get("temp_bytes") is not None:
                out[f"{name}/temp_bytes"] = r["memory"]["temp_bytes"]
            if "arithmetic_intensity" in r:
                out[f"{name}/ai"] = round(r["arithmetic_intensity"], 4)
            if "mfu" in r:
                out[f"{name}/mfu"] = round(r["mfu"], 6)
            if r.get("bound"):
                out[f"{name}/compute_bound"] = float(r["bound"] == "compute")
            if r.get("cost_source") == "counted":
                out[f"{name}/counted"] = 1.0
        with self._lock:
            wms = {p: dict(w) for p, w in self._watermarks.items()}
        for phase, wm in wms.items():
            out[f"hbm/{phase}/peak_live_bytes"] = wm["peak_live_bytes"]
            out[f"hbm/{phase}/last_live_bytes"] = wm["last_live_bytes"]
            out[f"hbm/{phase}/samples"] = wm["samples"]
            if wm.get("peak_device_bytes"):
                out[f"hbm/{phase}/peak_device_bytes"] = \
                    wm["peak_device_bytes"]
        return out

    # -- memory watermarks --------------------------------------------------
    def memory_watermark(self, phase: str = "global") -> Dict[str, Any]:
        """Take one memory census (``system_info.memory_summary`` — the
        SAME function ``/api/health`` serves) and fold it into the
        per-phase peak gauges. Returns the census."""
        if not self._enabled:
            return {}
        from .system_info import memory_summary

        census = memory_summary()
        live = int(census.get("live_buffers", {}).get("bytes", 0))
        dev = sum(int(d.get("bytes_in_use", 0))
                  for d in census.get("devices", []))
        rose = False
        with self._lock:
            wm = self._watermarks.setdefault(phase, {
                "peak_live_bytes": 0, "last_live_bytes": 0,
                "peak_device_bytes": 0, "samples": 0})
            wm["samples"] += 1
            wm["last_live_bytes"] = live
            if live > wm["peak_live_bytes"]:
                wm["peak_live_bytes"] = live
                rose = True
            if dev > wm["peak_device_bytes"]:
                wm["peak_device_bytes"] = dev
                rose = True
            peak = wm["peak_live_bytes"]
        prof = OpProfiler.get()
        prof.gauge("xprof/live_buffer_bytes", live)
        if rose or wm["samples"] == 1:
            prof.gauge(f"xprof/peak_live_bytes/{phase}", peak)
            flightrec.event("xprof/hbm", phase=phase, live_bytes=live,
                            peak_live_bytes=peak, device_bytes=dev)
        return census

    def watermarks(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {p: dict(w) for p, w in self._watermarks.items()}

    def dump_memory_census(self, path: str) -> str:
        """Write the full memory picture (per-phase watermarks + a fresh
        census + the ledger) as JSON, atomically — the crash-blackbox
        companion (``memcensus.json`` beside ``blackbox.jsonl``)."""
        from .system_info import memory_summary

        payload = {"watermarks": self.watermarks(),
                   "census": memory_summary(),
                   "ledger": self.ledger()}
        tmp = flightrec.tmp_path(path)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        return path


class _Censused:
    """Call-transparent census wrapper around one port callable.
    ``__getattr__`` falls through to the callable. The entry is looked up
    by name per dispatch — never captured — so a census reset cannot
    orphan a live wrapper. ``_counted`` keeps each signature's counted
    cost, so a fresh window (after a reset) still carries it."""

    __slots__ = ("_census", "_name", "_fn", "_fp", "_static", "_counted")

    def __init__(self, census: ExecutableCensus, name: str, fn,
                 fp: Dict[str, Any], static: Tuple[str, ...]):
        self._census = census
        self._name = name
        self._fn = fn
        self._fp = fp
        self._static = static
        self._counted: Dict[Any, Tuple[dict, Optional[dict], Optional[str]]] \
            = {}

    @property
    def wrapped(self):
        return self._fn

    def __call__(self, *args, **kwargs):
        census = self._census
        if not census._enabled:
            return self._fn(*args, **kwargs)
        sig = _signature(args, kwargs, self._static)
        with census._lock:
            new = sig not in self._counted
            if new:
                self._counted[sig] = None     # claimed: one counter per sig
        if not new:
            t0 = _now()
            out = self._fn(*args, **kwargs)
            census._note_call(self._name, self, _now() - t0, False, sig,
                              None)
            return out
        t0 = _now()
        try:
            out, record = count_call(self._fn, *args, **kwargs)
        except BaseException:
            with census._lock:
                self._counted.pop(sig, None)    # a failed call is no gen
            raise
        dt = _now() - t0
        counted = (_cost_dict(record) or {}, _memory_dict(record),
                   record.get("error"))
        with census._lock:
            self._counted[sig] = counted
        census._note_call(self._name, self, dt, True, sig, counted)
        return out

    def __getattr__(self, item):
        return getattr(self._fn, item)


# -- counting plumbing -------------------------------------------------------

def _leaves(tree):
    """The tensor / ndarray leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "shape") and hasattr(tree, "dtype"):
        yield tree


def _meta(x):
    dev = getattr(x, "device", None)
    return (tuple(x.shape), str(x.dtype), str(dev) if dev is not None
            else "host")


def _signature(args, kwargs, static: Tuple[str, ...]):
    """The generation key of one call: the shapes, dtypes and devices of
    the tensor (and ndarray) leaves, in argument order, plus the values of
    the static keyword arguments."""
    sig = tuple(_meta(x) for x in _leaves((args, kwargs)))
    if static:
        sig += tuple((k, repr(kwargs.get(k))) for k in static)
    return sig


def _nbytes(x) -> int:
    n = getattr(x, "nbytes", None)
    if n is not None:
        return int(n)
    return int(x.numel()) * int(x.element_size())


def count_call(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and
    return ``(output, record)``: ``record`` holds the counted ``flops``,
    the argument and output tensor bytes, the wall time and, on the card,
    the allocator figures over the call (``peak_allocated_bytes``: the
    device's ``max_memory_allocated`` after the call; ``temp_bytes``: the
    rise above the bytes allocated at entry, known only when the call set
    a new peak)."""
    import torch

    arg_bytes = sum(_nbytes(x) for x in _leaves((args, kwargs)))
    cuda_dev = next((x.device for x in _leaves((args, kwargs))
                     if getattr(getattr(x, "device", None), "type", None)
                     == "cuda"), None)
    if cuda_dev is None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        cuda_dev = torch.device("cuda", torch.cuda.current_device())
    if cuda_dev is not None:
        alloc0 = torch.cuda.memory_allocated(cuda_dev)
        peak0 = torch.cuda.max_memory_allocated(cuda_dev)
    record: Dict[str, Any] = {"argument_bytes": arg_bytes}
    flops = None
    t0 = _now()
    try:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
    except Exception as exc:        # counting must never take a call down
        counter = None
        record["error"] = f"{type(exc).__name__}: {exc}"
    if counter is not None:
        with counter:
            out = fn(*args, **kwargs)
        flops = counter.get_total_flops()
    else:
        out = fn(*args, **kwargs)
    record["wall_s"] = _now() - t0
    if flops:
        record["flops"] = float(flops)
    record["output_bytes"] = sum(_nbytes(x) for x in _leaves(out))
    if cuda_dev is not None:
        peak1 = torch.cuda.max_memory_allocated(cuda_dev)
        record["peak_allocated_bytes"] = int(peak1)
        if peak1 > peak0:
            record["temp_bytes"] = int(peak1 - alloc0)
    return out, record


def _cost_dict(record) -> Optional[Dict[str, float]]:
    """{flops, bytes_accessed} of a :func:`count_call` record (bytes: the
    argument and output tensors); None when there is nothing."""
    if not record:
        return None
    out: Dict[str, float] = {}
    if record.get("flops"):
        out["flops"] = float(record["flops"])
    nbytes = record.get("argument_bytes", 0) + record.get("output_bytes", 0)
    if nbytes:
        out["bytes_accessed"] = float(nbytes)
    return out or None


def _memory_dict(record) -> Optional[Dict[str, int]]:
    if not record:
        return None
    out = {k: int(record[k]) for k in ("argument_bytes", "output_bytes",
                                       "temp_bytes", "peak_allocated_bytes")
           if record.get(k) is not None}
    return out or None


# -- the process-wide census + module facade -------------------------------

_CENSUS = ExecutableCensus()


def get() -> ExecutableCensus:
    return _CENSUS


def configure(enabled: Optional[bool] = None) -> ExecutableCensus:
    return _CENSUS.configure(enabled=enabled)


def enabled() -> bool:
    return _CENSUS._enabled


def reset() -> None:
    _CENSUS.reset()


def set_roof(peak_flops: float, peak_bytes_per_s: float) -> None:
    _CENSUS.set_roof(peak_flops, peak_bytes_per_s)


def register_jit(name: str, fn, *, donate=None, static_argnames=None):
    return _CENSUS.register_jit(name, fn, donate=donate,
                                static_argnames=static_argnames)


def censused(owner, name: str, fn, key=None, static_argnames=None):
    """The census wrapper of ``fn`` under ``name``, made once per
    ``owner`` (an object whose ``__dict__`` keeps it) and ``(name, key)``
    and reused after: each owner's argument signatures are its own
    generations, as each JAX object's jit cache is its own. The wrapper
    calls the ``fn`` of the latest lookup, so an owner's method replaced
    on the instance takes effect."""
    cache = owner.__dict__.setdefault("_census_fns", {})
    wrapped = cache.get((name, key))
    if wrapped is None:
        wrapped = cache[(name, key)] = register_jit(
            name, fn, static_argnames=static_argnames)
    wrapped._fn = fn
    return wrapped


def register_aot(name: str, compiled, *, variant: str = "",
                 compile_s: Optional[float] = None) -> None:
    _CENSUS.register_aot(name, compiled, variant=variant,
                         compile_s=compile_s)


def note_subexec(name: str, flops: Optional[float] = None,
                 bytes_accessed: Optional[float] = None, **attrs) -> None:
    _CENSUS.note_subexec(name, flops=flops, bytes_accessed=bytes_accessed,
                         **attrs)


def note_measured(name: str, step_s: float) -> None:
    _CENSUS.note_measured(name, step_s)


def analyze(names=None, compile: bool = True) -> Dict[str, dict]:
    return _CENSUS.analyze(names=names, compile=compile)


def roofline() -> Dict[str, dict]:
    return _CENSUS.roofline()


def ledger() -> Dict[str, float]:
    return _CENSUS.ledger()


def census() -> Dict[str, dict]:
    """Structured snapshot of every entry (no analysis triggered)."""
    with _CENSUS._lock:
        return {n: e.summary() for n, e in _CENSUS._entries.items()}


def memory_watermark(phase: str = "global") -> Dict[str, Any]:
    return _CENSUS.memory_watermark(phase)


def watermarks() -> Dict[str, Dict[str, Any]]:
    return _CENSUS.watermarks()


def dump_memory_census(path: str) -> str:
    return _CENSUS.dump_memory_census(path)
