"""Runtime steady-state check: hard-fail on new programs or host syncs in a
declared steady-state region.

Counterpart of ``deeplearning4j_tpu/common/tracecheck.py``. After warmup, a
training or serving hot loop must be replay: no new argument signature for
a census-wrapped step, no kernel build, no surprise device-to-host
round-trip. :func:`steady_state` turns that into an armed tripwire::

    with tracecheck.steady_state("timed fit", max_host_syncs=2):
        model.fit(it, epochs=1)
    # SteadyStateViolation if anything compiled, moved a trace/* counter,
    # or synchronised with the host more than twice inside the region

The port runs eagerly, so there is no trace to watch; its three detectors
look at what stands in for one:

- **``trace/*`` counter deltas**: the ported paths bump the JAX package's
  retrace counters where a new program would be built
  (``trace/serving_infer`` at a new bucket shape and slot,
  ``trace/fleet_step``, ``trace/pipeline_fit_step``), and none may move;
- **compiles**: a new generation of a census entry (``common/xprof.py``:
  a new argument signature of a registered step, or a serving bucket run
  for the first time) and every ``nvcc`` build by ``ops/cuda_lib.build``,
  both reported through :func:`note_compile`;
- **host syncs**: on the card, ``torch.cuda.set_sync_debug_mode("warn")``
  is on for the region and each synchronizing CUDA call's warning is
  counted by the Python line that made the call (``report()["sync_sites"]``;
  the mode is process-wide, so syncs on other threads, such as
  a serving worker's reply copy, count too and belong in the budget); the
  previous mode is restored on exit, also when the region raises. The
  port's explicit readback points report through :func:`note_host_sync`
  (``optimize/telemetry.readback``, the listeners' score conversion,
  ``ui/stats.StatsListener``'s collection), so the CPU sees them as well.
  A region's ``host_syncs`` is the larger of the two counts: a readback
  point on the card is also one synchronizing call, and a sync that no
  readback point announced raises the warning count above it.

Violations raise at region exit, carrying every detector's evidence.
Every region bumps ``tracecheck/regions``; every violating region bumps
``tracecheck/violations`` and emits ``tracecheck/violation``.
"""

from __future__ import annotations

import contextlib
import threading
import traceback
import warnings
from typing import Dict, List, Optional

from . import flightrec
from .profiler import OpProfiler

_SYNC_WARNING = "synchronizing CUDA operation"


class SteadyStateViolation(RuntimeError):
    """The declared steady-state region compiled, moved a watched counter,
    or blocked on the host. ``report`` carries the per-detector
    evidence."""

    def __init__(self, message: str, report: Dict):
        super().__init__(message)
        self.report = report


class _Region:
    """Mutable state of one armed region (yielded by steady_state)."""

    def __init__(self, label: str, max_host_syncs: Optional[int]):
        self.label = label
        self.max_host_syncs = max_host_syncs
        self.compiles = 0
        self.compiled: List[str] = []
        self.readbacks = 0
        self.sync_warnings = 0
        self.sync_sites: Dict[str, int] = {}
        self.first_stack: Optional[str] = None
        self.counter_deltas: Dict[str, int] = {}

    @property
    def host_syncs(self) -> int:
        return max(self.readbacks, self.sync_warnings)

    def _stack_if_over(self) -> None:
        if (self.first_stack is None and self.max_host_syncs is not None
                and self.host_syncs > self.max_host_syncs):
            self.first_stack = "".join(traceback.format_stack(limit=18))

    def report(self) -> Dict:
        return {"label": self.label, "compiles": self.compiles,
                "compiled": list(self.compiled),
                "host_syncs": self.host_syncs, "readbacks": self.readbacks,
                "sync_warnings": self.sync_warnings,
                "sync_sites": dict(self.sync_sites),
                "counter_deltas": dict(self.counter_deltas),
                "first_stack": self.first_stack}


_active_lock = threading.Lock()
_active_region: Optional[_Region] = None


def note_compile(what: str) -> None:
    """A new program (census generation) or a kernel build happened; one
    global read when no region is armed."""
    region = _active_region
    if region is None:
        return
    with _active_lock:
        region.compiles += 1
        region.compiled.append(what)
        if region.first_stack is None:
            region.first_stack = "".join(traceback.format_stack(limit=18))


def note_host_sync(where: str = "") -> None:
    """An explicit device-to-host readback point is about to run; one
    global read when no region is armed."""
    region = _active_region
    if region is None:
        return
    with _active_lock:
        region.readbacks += 1
        region._stack_if_over()


def _cuda_armed() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def steady_state(label: str = "steady-state", *, allow_compiles: int = 0,
                 max_host_syncs: Optional[int] = 0,
                 watch_prefixes=("trace/",)):
    """Declare everything inside the ``with`` to be steady state.

    ``allow_compiles``: new programs tolerated, counted as the larger of
    the compile reports and the watched counters' total movement, so one
    new program is not billed twice. ``max_host_syncs``: host syncs
    tolerated (a declared once-per-window readback belongs in this
    budget); ``None`` counts but does not police. ``watch_prefixes``:
    profiler counter prefixes that must not move.

    Yields the region object (``.compiles`` / ``.host_syncs`` so far);
    raises :class:`SteadyStateViolation` at exit when any budget is
    exceeded. Regions do not nest: the inner declaration would silently
    re-budget the outer one.
    """
    global _active_region
    region = _Region(label, max_host_syncs)
    with _active_lock:
        if _active_region is not None:
            raise RuntimeError(
                f"steady_state regions do not nest (active: "
                f"{_active_region.label!r})")
        _active_region = region

    prof = OpProfiler.get()
    prof.count("tracecheck/regions")
    counters_before = {k: v for k, v in prof.get_counters().items()
                       if any(k.startswith(p) for p in watch_prefixes)}

    cuda = _cuda_armed()
    prev_mode = None
    caught = None
    try:
        if cuda:
            import torch

            prev_mode = torch.cuda.get_sync_debug_mode()
            caught = warnings.catch_warnings(record=True)
            log = caught.__enter__()
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
            torch.cuda.set_sync_debug_mode("warn")
        yield region
    finally:
        if cuda:
            import torch

            torch.cuda.set_sync_debug_mode(prev_mode)
            caught.__exit__(None, None, None)
            sites: Dict[str, int] = {}
            for w in log:
                if _SYNC_WARNING in str(w.message):
                    key = f"{w.filename}:{w.lineno}"
                    sites[key] = sites.get(key, 0) + 1
            with _active_lock:
                region.sync_warnings = sum(sites.values())
                region.sync_sites = sites
                region._stack_if_over()
            # warnings that were not the sync check's go on to the caller
            for w in log:
                msg = str(w.message)
                if _SYNC_WARNING not in msg and \
                        "Synchronization debug mode" not in msg:
                    warnings.warn_explicit(w.message, w.category,
                                           w.filename, w.lineno)
        with _active_lock:
            _active_region = None

    counters_after = {k: v for k, v in prof.get_counters().items()
                      if any(k.startswith(p) for p in watch_prefixes)}
    region.counter_deltas = {
        k: counters_after[k] - counters_before.get(k, 0)
        for k in counters_after
        if counters_after[k] != counters_before.get(k, 0)}

    problems: List[str] = []
    retraces = max(region.compiles, sum(region.counter_deltas.values()))
    if retraces > allow_compiles:
        moved = ", ".join(f"{k}+{v}" for k, v in
                          sorted(region.counter_deltas.items()))
        built = ", ".join(region.compiled)
        problems.append(
            "compiled inside steady state: "
            + "; ".join(x for x in (moved, built) if x)
            + f" (allowed {allow_compiles})")
    if max_host_syncs is not None and region.host_syncs > max_host_syncs:
        problems.append(
            f"{region.host_syncs} host sync(s) ({region.readbacks} readback "
            f"point(s), {region.sync_warnings} synchronizing CUDA call(s)) "
            f"(allowed {max_host_syncs})")
    if problems:
        prof.count("tracecheck/violations")
        flightrec.event("tracecheck/violation", severity="error",
                        label=label, problems="; ".join(problems))
        stack = (f"\nfirst offender stack:\n{region.first_stack}"
                 if region.first_stack else "")
        raise SteadyStateViolation(
            f"steady-state region {label!r}: " + "; ".join(problems)
            + stack, region.report())
