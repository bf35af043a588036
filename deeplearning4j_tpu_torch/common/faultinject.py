"""Deterministic fault injection for the training and serving stack.

Counterpart of ``deeplearning4j_tpu/common/faultinject.py``, carried over
whole: the same sites, kinds, plan format and environment plan
(``DL4J_TPU_FAULT_PLAN``), so one plan drives either package.

- A :class:`FaultPlan` is a list of fault specs, each bound to a SITE
  (:data:`FAULT_SITES`) and a zero-based INDEX at that site (the request
  ordinal at ``serving/enqueue`` and ``serving/admission``, the batch
  ordinal at ``serving/dispatch``, the publication ordinal at
  ``serving/promote``, the probe ordinal at ``inference/probe``, ...).
- Instrumented code calls :func:`fault_point(site, index)`. Raising kinds
  (``transient``, ``crash``, ``dead_replica``, ``device_loss``) raise
  there; ``slow`` sleeps in place; ``wedge`` blocks until
  :func:`release_wedges` or its ``seconds`` ceiling and then raises
  :class:`WedgeReleased`; ``preempt`` sends this process a SIGTERM;
  advisory kinds (``nan``, ``bitflip``) are returned for the caller to
  apply.
- Plans come from code (:func:`set_plan`) or the environment
  (``DL4J_TPU_FAULT_PLAN`` = inline JSON or ``@/path/to/plan.json``).

Spec fields: ``{"site": ..., "kind": ..., "index": k}`` plus ``times``
(how many calls at that index fire, default 1), ``seconds`` (``slow``,
``wedge``), ``mode`` and ``code`` (``crash``: ``"raise"`` or ``"exit"``),
``replica`` / ``stage`` (``device_loss``), ``offset`` / ``bit``
(``bitflip`` at ``checkpoint/scrub``).

The port reaches ``serving/enqueue``, ``serving/dispatch``,
``serving/admission``, ``serving/promote``, ``autoscale/decide``,
``inference/worker``, ``inference/probe``, ``checkpoint/scrub``,
``checkpoint/pre_rename``, the fit loop's ``pipeline/bind``,
``pipeline/place``, ``train/step``, ``train/wedge`` and ``device/loss``
(``data/pipeline.run_epochs``) and the data-parallel wrapper's
``integrity/fingerprint``. The other sites belong to modules it does not
have yet (the supervisor, pipeline parallelism, the cluster runtime, the
watchtower); their specs are parsed and validated alike.

Every fired fault bumps an ``OpProfiler`` counter
(``faults/<site>/<kind>``) and records a ``fault/fired`` flight-recorder
event before it acts.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from . import flightrec

logger = logging.getLogger("deeplearning4j_tpu_torch")

ENV_PLAN = "DL4J_TPU_FAULT_PLAN"

# The site registry, with the JAX package's sites: site name -> accepted
# kinds + the drill that exercises it. FaultPlan validates spec sites
# against it so a typo'd site fails at plan construction instead of
# silently never firing. A site of a module the port does not have yet is
# parsed like any other and fires where a ported caller reaches it.
FAULT_SITES = {
    "pipeline/bind": {
        "kinds": ("transient", "slow", "nan"),
        "drill": "test_fault_tolerance retry/NaN-poison; fault-smoke"},
    "pipeline/place": {
        "kinds": ("transient", "slow"),
        "drill": "test_fault_tolerance H2D placement-retry"},
    "train/step": {
        "kinds": ("crash", "preempt"),
        "drill": "test_kill_resume exact-parity kill; supervisor restarts; "
                 "soak-smoke SIGTERM preemption"},
    "train/wedge": {
        "kinds": ("wedge",),
        "drill": "test_supervisor watchdog abandonment"},
    "device/loss": {
        "kinds": ("device_loss",),
        "drill": "test_elastic shrink; elastic-smoke"},
    "supervisor/hang": {
        "kinds": ("wedge", "slow"),
        "drill": "test_supervisor pre-heartbeat hang"},
    "checkpoint/pre_rename": {
        "kinds": ("crash",),
        "drill": "test_fault_tolerance torn-write"},
    "inference/worker": {
        "kinds": ("dead_replica",),
        "drill": "test_fault_tolerance replica retirement"},
    "inference/probe": {
        "kinds": ("transient",),
        "drill": "test_supervisor resurrection probe backoff"},
    "elastic/probe": {
        "kinds": ("transient",),
        "drill": "test_elastic grow-back probe failure"},
    "serving/enqueue": {
        "kinds": ("transient", "slow"),
        "drill": "test_serving admission drills"},
    "serving/dispatch": {
        "kinds": ("slow", "transient", "dead_replica"),
        "drill": "test_serving wedge/requeue/kill; serving-smoke"},
    "serving/admission": {
        "kinds": ("transient", "slow"),
        "drill": "test_autoscale deterministic-429 shed drill"},
    "autoscale/decide": {
        "kinds": ("transient",),
        "drill": "test_autoscale skipped-tick drill"},
    "serving/promote": {
        "kinds": ("transient",),
        "drill": "test_autoscale forced-violation rollback; "
                 "autoscale-smoke"},
    "pipeline/stage": {
        "kinds": ("device_loss", "slow", "wedge"),
        "drill": "test_pipeline_parallel kill-a-stage remap; "
                 "pipeline-parallel-smoke"},
    "watchtower/evaluate": {
        "kinds": ("transient",),
        "drill": "test_watchtower skipped-tick drill; soak-smoke"},
    "cluster/init": {
        "kinds": ("transient",),
        "drill": "test_cluster bring-up retry/deadline drills; "
                 "cluster-smoke dead-coordinator drill"},
    "cluster/heartbeat": {
        "kinds": ("slow", "wedge"),
        "drill": "test_cluster stale-rank drills; cluster-smoke"},
    "cluster/barrier": {
        "kinds": ("crash",),
        "drill": "test_cluster rank-dies-at-the-fence drill; "
                 "cluster-smoke"},
    "cluster/commit": {
        "kinds": ("crash",),
        "drill": "test_cluster torn-group-commit drill"},
    "integrity/fingerprint": {
        "kinds": ("bitflip",),
        "drill": "test_integrity bitflip-detection/quarantine drills; "
                 "integrity-smoke"},
    "checkpoint/scrub": {
        "kinds": ("transient", "bitflip"),
        "drill": "test_integrity scrubber drills; integrity-smoke "
                 "scrub drill"},
}


class TransientFault(RuntimeError):
    """A retryable failure (flaky storage read, interrupted H2D transfer).
    The input pipeline retries these with bounded exponential backoff."""

    transient = True


class SimulatedCrash(BaseException):
    """An injected process death. Derives from BaseException so ordinary
    ``except Exception`` recovery paths cannot accidentally swallow the
    "kill" — it unwinds like a real SIGKILL would end the process."""


class DeadReplicaFault(RuntimeError):
    """An inference replica dying mid-request (wedged device, OOM-killed
    worker). ParallelInference retires the worker that sees one."""


class DeviceLostError(RuntimeError):
    """A data-parallel TRAINING replica's device disappeared mid-run (ICE
    link down, chip fault, host eviction of one accelerator). Unlike
    :class:`SimulatedCrash` (the whole process dies) the surviving
    replicas — and the holder's dispatch-boundary state — are intact, so
    the supervisor's ``shrink_and_continue`` policy can resize the data
    axis online instead of checkpoint-restarting. ``replica`` names the
    lost data-axis index when known (the injected ``device_loss`` kind
    carries it from the fault spec; real XLA failures usually don't);
    ``stage`` likewise names the lost PIPELINE stage — the
    ``pipeline/stage`` site's drills carry it, and the supervisor's
    ``remap_and_continue`` policy consumes it."""

    def __init__(self, message: str, replica: Optional[int] = None,
                 stage: Optional[int] = None):
        super().__init__(message)
        self.replica = replica
        self.stage = stage


class WedgeReleased(BaseException):
    """An injected wedge unblocked (watchdog abandonment or timeout).
    BaseException for the same reason as SimulatedCrash: the wedged
    thread must DIE, not be resurrected by a broad ``except Exception``
    — its supervisor has already restarted the work elsewhere."""


_wedge_event = threading.Event()


def release_wedges() -> None:
    """Unblock every thread parked in an injected ``wedge`` fault; each
    raises :class:`WedgeReleased` and unwinds. The supervisor's watchdog
    calls this when it abandons a hung attempt."""
    _wedge_event.set()


def reset_wedges() -> None:
    """Re-arm the wedge latch (test setup / after a supervised restart)."""
    _wedge_event.clear()


def is_transient(exc: BaseException) -> bool:
    """The pipeline's retry predicate: opt-in via the ``transient``
    attribute (so user iterators can mark their own retryable errors)."""
    return bool(getattr(exc, "transient", False))


class FaultPlan:
    """A deterministic, consumable schedule of faults. Thread-safe: sites
    fire from the training thread, checkpoint-writer thread, and inference
    workers alike."""

    def __init__(self, faults: List[Dict[str, Any]]):
        self._lock = threading.Lock()
        self._specs = []
        for f in faults:
            spec = dict(f)
            spec.setdefault("times", 1)
            spec["_fired"] = 0
            if "site" not in spec or "kind" not in spec:
                raise ValueError(f"fault spec needs site and kind: {f!r}")
            if spec["site"] not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {spec['site']!r} — register it "
                    "in FAULT_SITES (and the docstring table) first")
            self._specs.append(spec)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls(json.loads(text))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_PLAN)
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        return cls.from_json(raw)

    def take(self, site: str, index: Optional[int]) -> List[Dict[str, Any]]:
        """Consume and return the specs firing at (site, index). A spec
        with no ``index`` matches every call at its site (up to ``times``)."""
        fired = []
        with self._lock:
            for spec in self._specs:
                if spec["site"] != site or spec["_fired"] >= spec["times"]:
                    continue
                # an indexed spec only matches the SAME index — an
                # index-less call site (e.g. the manifest's own atomic
                # write) never consumes an indexed fault
                want = spec.get("index")
                if want is not None and want != index:
                    continue
                spec["_fired"] += 1
                fired.append(spec)
        return fired

    def fired_count(self, site: Optional[str] = None) -> int:
        with self._lock:
            return sum(s["_fired"] for s in self._specs
                       if site is None or s["site"] == site)


_plan_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_env_checked = False


def get_plan() -> Optional[FaultPlan]:
    """The active plan: set_plan() wins; otherwise DL4J_TPU_FAULT_PLAN is
    parsed once per process. None (the overwhelmingly common case) keeps
    fault_point() to a single attribute check."""
    global _plan, _env_checked
    with _plan_lock:
        if _plan is None and not _env_checked:
            _env_checked = True
            _plan = FaultPlan.from_env()
        return _plan


def set_plan(plan: Optional[FaultPlan]) -> None:
    global _plan, _env_checked
    reset_wedges()   # a stale release must not defang the new plan's wedges
    with _plan_lock:
        _plan = plan
        _env_checked = True   # an explicit None must not resurrect the env plan


def clear_plan() -> None:
    """Reset to 'no plan, env re-read on next use' (test teardown)."""
    global _plan, _env_checked
    reset_wedges()
    with _plan_lock:
        _plan = None
        _env_checked = False


def fault_point(site: str, index: Optional[int] = None) -> List[Dict[str, Any]]:
    """The instrumentation hook. Raising/sleeping kinds act here; advisory
    specs (``nan`` — and any unrecognized kind) are returned for the call
    site to apply. Returns [] when no plan is active (the hot-path cost is
    one function call + one lock-free None check)."""
    plan = _plan if _env_checked else get_plan()
    if plan is None:
        return []
    fired = plan.take(site, index)
    if not fired:
        return []
    from .profiler import OpProfiler

    prof = OpProfiler.get()
    advisory = []
    for spec in fired:
        kind = spec["kind"]
        prof.count(f"faults/{site}/{kind}")
        # timeline entry BEFORE the fault acts: a crash/wedge that
        # unwinds from here is already on the record for the black box.
        # A replica-addressed spec (bitflip, device_loss) stamps the
        # replica on the event — the incident chain's cause anchor then
        # NAMES the corrupted replica, not just the site.
        extra = ({"replica": spec["replica"]} if "replica" in spec else {})
        flightrec.event("fault/fired", severity="warn", site=site,
                        kind=kind, index=index, **extra)
        logger.warning("faultinject: firing %s at %s[%s]", kind, site, index)
        if kind == "slow":
            time.sleep(float(spec.get("seconds", 0.1)))
        elif kind == "wedge":
            _wedge_event.wait(timeout=float(spec.get("seconds", 300.0)))
            raise WedgeReleased(
                f"injected wedge at {site}[{index}] released")
        elif kind == "transient":
            raise TransientFault(
                f"injected transient fault at {site}[{index}]")
        elif kind == "dead_replica":
            raise DeadReplicaFault(
                f"injected replica death at {site}[{index}]")
        elif kind == "device_loss":
            # step-indexed, names a replica or a pipeline stage: the
            # deterministic elastic drills (site "device/loss" feeds the
            # supervisor's shrink-and-continue via .replica; site
            # "pipeline/stage" feeds remap-and-continue via .stage)
            rep = spec.get("replica")
            stg = spec.get("stage")
            raise DeviceLostError(
                f"injected device loss at {site}[{index}]"
                + (f" (replica {rep})" if rep is not None else "")
                + (f" (stage {stg})" if stg is not None else ""),
                replica=rep, stage=stg)
        elif kind == "crash":
            if spec.get("mode", "raise") == "exit":
                os._exit(int(spec.get("code", 137)))
            raise SimulatedCrash(f"injected crash at {site}[{index}]")
        elif kind == "preempt":
            # a REAL SIGTERM to our own pid — the supervisor's installed
            # handler sets its preempt flag and training unwinds at the
            # next step boundary, exactly the eviction a borg/k8s reclaim
            # delivers. Nothing raises here: the signal is the fault.
            import signal as _signal

            os.kill(os.getpid(), _signal.SIGTERM)
        else:
            advisory.append(spec)
    return advisory


def retry_call(fn, what: str, max_retries: int = 3,
               base_delay_s: float = 0.05, max_delay_s: float = 2.0):
    """Run ``fn()`` retrying TRANSIENT failures (:func:`is_transient`)
    with bounded exponential backoff. Non-transient exceptions and the
    final exhausted attempt propagate unchanged. Every retry bumps
    ``pipeline/retries`` and the backoff wall time is ledgered under the
    ``pipeline/retry_backoff`` profiler section — the fault-smoke bench
    and tests assert recovery happened (and didn't in clean runs)."""
    from .profiler import OpProfiler

    prof = OpProfiler.get()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if not is_transient(e) or attempt >= max_retries:
                raise
            delay = min(base_delay_s * (2 ** attempt), max_delay_s)
            logger.warning("%s failed transiently (%s); retry %d/%d in "
                           "%.2fs", what, e, attempt + 1, max_retries, delay)
            prof.count("pipeline/retries")
            with prof.time_section("pipeline/retry_backoff"):
                time.sleep(delay)
            attempt += 1
