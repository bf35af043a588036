"""Multi-process training: the control plane, the self-healing supervisor
and the master API.

Counterpart of ``deeplearning4j_tpu/parallel/distributed.py`` (the
reference's Spark ``SharedTrainingMaster`` with the Aeron parameter-server
fabric). The data plane is a ``torch.distributed`` process group joined by
``ParallelWrapper`` (``parallel/_collectives.ProcessGroupRoute``); the
bring-up is :func:`initialize` over :class:`cluster.ClusterRuntime`; and
:class:`TrainingSupervisor` is the heartbeat and dead-node half: a
self-healing restart loop around any fit path.

The supervisor, in one process:

- **failure classification** (:func:`classify_failure`): transient input
  faults, poisoned numerics, device or collective failure, preemption,
  hangs, user errors and silent corruption, each with a policy
  (:data:`DEFAULT_POLICIES`): retry, raise, checkpoint-restart, a clean
  resumable exit, shrink-and-continue, remap-and-continue or
  quarantine-and-continue;
- **a bounded restart budget** with exponential backoff and a
  restart-storm breaker; every restart resumes from the last intact
  checkpoint through ``util/checkpoint``, so a healed run's losses are
  bitwise an uninterrupted one's;
- **a progress watchdog**: the heartbeat is the steps completed (fed by the
  listener bus); no step within ``hang_deadline_s`` (a longer startup
  grace before the first) declares a hang, the wedged dispatch is
  abandoned and the run restarts;
- **preemption signals**: SIGTERM/SIGINT become a checkpoint taken at the
  next step boundary and a ``"preempted"``, resumable result. Handlers are
  installed only from the main thread and restored afterwards. Inside a
  process group each rank's signal rides the step's first gather
  (``ParallelWrapper.stop_event``), and every rank stops after the same
  step, so the preemption checkpoint is one group commit;
- **an incarnation fence**: each attempt claims a new incarnation in
  ``checkpoint.json``, so a late writer of an abandoned attempt cannot
  commit over its replacement; :class:`_AttemptFence` kills such a zombie
  thread at its next step boundary.

An in-memory continuation (shrink, quarantine, remap, grow-back) needs the
holder at a dispatch boundary with usable state. The JAX package checks
for donated buffers; the port donates nothing (``csrc/fused_update.cu``
writes the bucket in place, between dispatches), so its check is the
boundary plus a CUDA context that is not in a sticky error state (an
illegal address or a lost device cannot be healed in the process: such a
failure takes checkpoint-restart, and once the storm breaker trips, the
process exits for :func:`supervise_processes` to relaunch).

Across processes, :func:`supervise_processes` launches the ranks, reads
their heartbeat files, and when any rank dies (crash), stops beating while
alive (hang) or exits 75 (preempted), reaps the survivors (SIGTERM, a
grace period, SIGKILL) and relaunches the group, at full count or shrunk
through ``make_commands``; the relaunched ranks resume from the shared
checkpoint directory. Inside a process group a failure is never retried in
the process (the peers are inside a collective): :class:`SharedTrainingMaster`
supervises with no in-process restarts there, and its checkpoints are
group commits (:meth:`cluster.ClusterRuntime.commit_group_checkpoint`).

Every blackbox dump is reported to the watchtower
(``common/watchtower.note_blackbox``) and carries the memory census
(``memcensus.json``, ``common/xprof.dump_memory_census``) beside it; every
failure classification opens or joins an incident on the installed
watchtower (``note_supervisor_failure``), and a lost rank of a supervised
process group opens one carrying the merged per-rank blackboxes. With no
watchtower installed the hooks cost nothing.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..common import faultinject, flightrec
from ..common import watchtower as _watchtower
from ..common import xprof as _xprof
from ..common.profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")

#: the crash black box, dumped into the checkpoint directory on every
#: failure classification and on the preemption path: the flight
#: recorder's last events as JSONL
BLACKBOX_NAME = "blackbox.jsonl"
MEMCENSUS_NAME = "memcensus.json"

#: the runtime :func:`initialize` formed (None: no process group of ours)
_RUNTIME = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               init_deadline_s: float = 120.0,
               cluster_dir: Optional[str] = None):
    """Bring up this process's membership of a process group.

    Arguments fall back to ``DL4J_TPU_COORDINATOR`` (``host:port``),
    ``DL4J_TPU_NUM_PROCS`` and ``DL4J_TPU_PROC_ID``, as in the JAX package.
    With all three known, a :class:`cluster.ClusterRuntime` forms the group
    (bounded retries under ``init_deadline_s``, a heartbeat thread, a
    :class:`cluster.ClusterInitError` with the whole diagnosis instead of a
    hang) and is returned. Otherwise the group comes from torch's own
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    as ``torchrun`` sets them) and None is returned. Either way the
    backend is chosen by rule (:func:`cluster.choose_backend`).

    ``cluster_dir`` is the shared control-plane directory (heartbeats,
    barrier tokens); default ``$DL4J_TPU_CLUSTER_DIR``, else a temporary
    directory named after the coordinator address (one host)."""
    global _RUNTIME
    from datetime import timedelta

    import torch.distributed as dist

    from . import cluster as _cluster

    coordinator_address = coordinator_address or os.environ.get(
        "DL4J_TPU_COORDINATOR")
    if num_processes is None and "DL4J_TPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["DL4J_TPU_NUM_PROCS"])
    if process_id is None and "DL4J_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["DL4J_TPU_PROC_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
        device = _cluster.local_device(rank)
        dist.init_process_group(
            _cluster.choose_backend(world, device), init_method="env://",
            timeout=timedelta(seconds=_cluster.collective_timeout_s()))
        return None
    if cluster_dir is None:
        cluster_dir = os.environ.get("DL4J_TPU_CLUSTER_DIR")
    if cluster_dir is None:
        import tempfile

        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in coordinator_address)
        cluster_dir = os.path.join(tempfile.gettempdir(),
                                   f"dl4j_cluster_{safe}")
    rt = _cluster.ClusterRuntime(
        cluster_dir, process_id, num_processes,
        coordinator=coordinator_address, init_deadline_s=init_deadline_s,
        incarnation=int(os.environ.get("DL4J_ATTEMPT", "0") or 0))
    rt.form()
    _RUNTIME = rt
    return rt


def cluster_runtime():
    """The :class:`cluster.ClusterRuntime` :func:`initialize` formed, or
    None."""
    return _RUNTIME


def shutdown() -> None:
    """Stop the runtime's heartbeat and destroy the process group."""
    global _RUNTIME
    import torch.distributed as dist

    rt, _RUNTIME = _RUNTIME, None
    if rt is not None:
        rt.shutdown()
    if dist.is_initialized():
        dist.destroy_process_group()


def _group_world() -> int:
    """The default process group's size (1 without one)."""
    import torch.distributed as dist

    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


# ---------------------------------------------------------------------------
# failure classification
# ---------------------------------------------------------------------------

CLASS_TRANSIENT = "transient_input"
CLASS_NUMERIC = "poisoned_numerics"
CLASS_DEVICE = "device_failure"
CLASS_PREEMPTION = "preemption"
CLASS_HANG = "hang"
CLASS_USER = "user_error"
CLASS_CORRUPTION = "silent_corruption"

#: class -> what the supervisor does (the JAX package's table). "retry":
#: checkpoint-restart with flat backoff (a transient input fault that
#: outlived the pipeline's own retries); "restart": checkpoint-restart
#: with exponential backoff; "raise": propagate (a FloatingPointError means
#: the NaN guard was in raise mode; user errors are deterministic); "exit":
#: the preemption path, a checkpoint then a resumable result;
#: "shrink_and_continue" (device failures): resize the data axis over the
#: survivors and continue in memory from the dispatch boundary, falling
#: back to checkpoint-restart when the target cannot resize, the lost
#: replica cannot be named, or the holder's state is not usable. A pipeline
#: target (anything with ``remap``) resolves it to "remap_and_continue":
#: re-cut the stages over the survivors, with the same fallback when fewer
#: than 2 stages would survive. "quarantine_and_continue" (silent
#: corruption: the consistency fingerprint named a replica) evicts that
#: replica through the shrink machinery, falling back to a restart from
#: the newest scrub-verified generation when the divergence names no one.
DEFAULT_POLICIES: Dict[str, str] = {
    CLASS_TRANSIENT: "retry",
    CLASS_NUMERIC: "raise",
    CLASS_DEVICE: "shrink_and_continue",
    CLASS_HANG: "restart",
    CLASS_PREEMPTION: "exit",
    CLASS_USER: "raise",
    CLASS_CORRUPTION: "quarantine_and_continue",
}


class Preempted(BaseException):
    """Raised in the training thread (by the supervisor's heartbeat
    listener, at a dispatch boundary) when a preemption signal arrived.
    A BaseException, so ``except Exception`` in user code cannot swallow
    the shutdown."""


class ElasticResizeRequested(BaseException):
    """Raised in the training thread at a dispatch boundary when the
    grow-back probe found a lost device healthy: the fit unwinds, the
    supervisor resizes the data axis back up and continues in memory from
    the same cursor."""


class HangDetected(RuntimeError):
    """The watchdog's verdict on an attempt that stopped landing steps."""


class RestartBudgetExceeded(RuntimeError):
    """The supervisor gave up; ``history`` holds one record per failed
    attempt (class, policy, exception, steps landed)."""

    def __init__(self, message: str, history: Optional[List[dict]] = None):
        if history:
            tail = "; ".join(
                f"attempt {h['attempt']}: {h['class']} ({h['error']})"
                for h in history[-3:])
            message = f"{message} — failure history ({len(history)}): {tail}"
        super().__init__(message)
        self.history = list(history or [])


class RestartStorm(RestartBudgetExceeded):
    """The breaker: consecutive restarts with no step of progress."""


def classify_failure(exc: Optional[BaseException]) -> str:
    """An exception that escaped a fit attempt, as a failure class.
    Unknown exceptions (a CUDA error among them) are device failures,
    restartable within the budget; deterministic configuration errors are
    user errors, raised at once."""
    if exc is None:
        return CLASS_HANG
    if isinstance(exc, Preempted):
        return CLASS_PREEMPTION
    if faultinject.is_transient(exc):
        return CLASS_TRANSIENT
    from ..common.integrity import ReplicaCorruptionError

    if isinstance(exc, ReplicaCorruptionError):
        return CLASS_CORRUPTION
    if isinstance(exc, FloatingPointError):
        return CLASS_NUMERIC
    if isinstance(exc, (faultinject.SimulatedCrash,
                        faultinject.WedgeReleased,
                        faultinject.DeviceLostError)):
        return CLASS_DEVICE
    if isinstance(exc, (TypeError, ValueError, KeyError, AttributeError,
                        IndexError, NotImplementedError, AssertionError)):
        return CLASS_USER
    return CLASS_DEVICE


class SupervisedFitResult:
    """How a supervised fit ended: ``status`` ``"completed"`` or
    ``"preempted"`` (every other ending raises). A preempted result is
    ``resumable`` from ``resume_from``: exit with ``resumable_exit_code``
    and the process supervisor (or the scheduler) relaunches."""

    resumable_exit_code = 75      # EX_TEMPFAIL

    def __init__(self, status: str, resume_from: Optional[str],
                 restarts: int, attempts: int, history: List[dict]):
        self.status = status
        self.resumable = status == "preempted"
        self.resume_from = resume_from
        self.restarts = restarts
        self.attempts = attempts
        self.history = history

    def __repr__(self) -> str:
        return (f"SupervisedFitResult(status={self.status!r}, "
                f"attempts={self.attempts}, restarts={self.restarts}, "
                f"resume_from={self.resume_from!r})")


class AbandonedAttempt(BaseException):
    """Raised in a zombie attempt thread (abandoned by the watchdog, awake
    later) at its next listener boundary, so it dies instead of training
    beside its replacement."""


class _AttemptFence:
    """First listener of the supervised arrangement: only the current
    attempt's thread passes. A zombie dies at its next step or epoch
    boundary, before any other listener hears of it."""

    def __init__(self):
        self.thread: Optional[threading.Thread] = None

    def _check(self) -> None:
        if threading.current_thread() is not self.thread:
            raise AbandonedAttempt(
                "attempt thread was abandoned by the supervisor; "
                "unwinding instead of racing its replacement")

    def iteration_done(self, model, iteration: int, score) -> None:
        self._check()

    def epoch_done(self, model, epoch: int) -> None:
        self._check()


class _Heartbeat:
    """The progress pulse: every completed step beats, and the watchdog
    compares the beat's age with the deadline. At dispatch boundaries it
    also raises a pending preemption as :class:`Preempted` and a pending
    grow-back as :class:`ElasticResizeRequested`, where the holder's state
    is checkpoint-consistent. One per attempt."""

    def __init__(self, supervisor: "TrainingSupervisor"):
        self._sup = supervisor
        self.steps = 0
        self.last_beat = time.monotonic()

    def iteration_done(self, model, iteration: int, score) -> None:
        # one writer (the training thread); the watchdog's racy read is at
        # worst one stale poll
        self.steps += 1
        self.last_beat = time.monotonic()
        sup = self._sup
        boundary = getattr(model, "_at_dispatch_boundary", True)
        if sup._preempt_pending() and boundary:
            raise Preempted(
                f"preemption signal {sup._preempt_signal} received")
        if sup._resize_request is not None and boundary:
            raise ElasticResizeRequested(
                f"grow data axis back to {sup._resize_request} workers")

    def epoch_done(self, model, epoch: int) -> None:
        self.last_beat = time.monotonic()


class _Attempt:
    """One supervised try of the wrapped fit, on its own daemon thread.
    The thread takes the calling thread's random stream
    (``ndarray/rng.get_random``) at entry and hands its final state back;
    the network's own generator (dropout and rounding bits) rides the
    checkpoints."""

    def __init__(self, supervisor: "TrainingSupervisor", index: int,
                 data: Any, epochs: int, resume_from: Optional[str],
                 fit_kwargs: dict, entry_rng: dict,
                 heartbeat: _Heartbeat):
        self._sup = supervisor
        self.index = index
        self._data = data
        self._epochs = epochs
        self._resume_from = resume_from
        self._fit_kwargs = fit_kwargs
        self._entry_rng = entry_rng
        self.heartbeat = heartbeat
        self.error: Optional[BaseException] = None
        self.rng_state: Optional[dict] = None
        self.abandoned = False
        self.done = threading.Event()
        self.thread = threading.Thread(
            target=self._main, daemon=True,
            name=f"dl4j-supervised-fit-{index}")

    def start(self) -> None:
        self.thread.start()

    def _main(self) -> None:
        from ..ndarray.rng import get_random

        try:
            get_random().set_state(self._entry_rng)
            # a wedge here hangs the attempt before its first heartbeat
            faultinject.fault_point("supervisor/hang", self.index - 1)
            self._sup.target.fit(self._data, epochs=self._epochs,
                                 resume_from=self._resume_from,
                                 **self._fit_kwargs)
        except BaseException as e:   # SimulatedCrash, Preempted included
            # read only after done.wait() returns
            self.error = e
        finally:
            try:
                self.rng_state = get_random().get_state()
            finally:
                self.done.set()


class _GroupCheckpointListener:
    """The supervisor's checkpoint listener inside a process group: every
    rank snapshots at the same step boundary (a ZeRO-1 snapshot gathers the
    slices, a collective), rank 0 serializes, and the commit is the
    cluster's group commit (:meth:`cluster.ClusterRuntime
    .commit_group_checkpoint`). Synchronous: the barriers need every
    rank."""

    def __init__(self, runtime, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3, max_total_bytes: Optional[int] = None):
        self.rt = runtime
        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.max_total_bytes = max_total_bytes
        self._group: Optional[List[Any]] = None
        self._pending_tag: Optional[str] = None
        self.saved: List[str] = []
        self.commit_seconds: List[float] = []
        os.makedirs(directory, exist_ok=True)

    def bind_group(self, listeners: List[Any]) -> None:
        self._group = list(listeners)

    def save_now(self, model, tag: str) -> str:
        from ..util import checkpoint as _ckpt

        snap = _ckpt.snapshot_training_state(model, listeners=self._group)
        t0 = time.perf_counter()
        data = _ckpt.serialize_snapshot(snap) if self.rt.rank == 0 else b""
        path = self.rt.commit_group_checkpoint(
            self.dir, tag, data, snap["iteration"], keep_last=self.keep_last,
            seq=snap["iteration"], max_total_bytes=self.max_total_bytes,
            state_dtype=snap.get("state_dtype"))
        self.commit_seconds.append(time.perf_counter() - t0)
        self.saved.append(path)
        return path

    def iteration_done(self, model, iteration, score):
        if self.every_iter and iteration % self.every_iter == 0:
            self._pending_tag = f"iter_{iteration}"
        if self._pending_tag is not None and \
                getattr(model, "_at_dispatch_boundary", True):
            self._pending_tag = None
            self.save_now(model, f"iter_{iteration}")

    def epoch_done(self, model, epoch):
        if self.every_epoch and epoch % self.every_epoch == 0:
            self.save_now(model, f"epoch_{epoch}")

    def flush(self, timeout: Optional[float] = None) -> None:
        pass

    def close(self) -> None:
        pass

    def errors(self) -> List[BaseException]:
        return []


def _cuda_context_healthy(device) -> bool:
    """False when the card's context is in a sticky error state (an
    illegal address, a lost device): a synchronisation then raises."""
    import torch

    if getattr(device, "type", None) != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
        return True
    except Exception:
        return False


class TrainingSupervisor:
    """Self-healing wrapper around any fit path (``MultiLayerNetwork``,
    ``ComputationGraph``, ``ParallelWrapper``, ``PipelineTrainer``:
    anything with ``fit(data, epochs=..., resume_from=...)`` and
    ``set_listeners``).

    The loop: claim an incarnation, anchor a checkpoint (so a crash at
    step 0 replays exactly), run the fit on a worker thread and watch it;
    classify each failure and act on its policy: restart from the newest
    intact checkpoint within a bounded budget (exponential backoff, storm
    breaker), continue in memory after a shrink, quarantine or remap,
    declare a hang when no step lands within ``hang_deadline_s``, and turn
    SIGTERM/SIGINT into a checkpoint plus a resumable result. Every restart
    resumes through the exact-resume machinery (parameters, updater,
    generator, listener state, pipeline cursor; the data source rewound by
    ``source_state`` or made anew by a factory), so the healed run's losses
    are bitwise an uninterrupted run's.

    ``data`` may be a zero-argument factory, called once per attempt for a
    pristine source; a plain source is reused and rewound through
    ``source_state``/``restore_source_state`` when it has them.

    An abandoned hung attempt leaves its daemon thread behind. Each attempt
    claims a new incarnation with its own checkpoint listener, so a
    zombie's queued commits are refused at the manifest, and the
    :class:`_AttemptFence` kills the zombie at its next step boundary. A
    thread stuck in native code keeps running until the process exits: run
    under :func:`supervise_processes` for that case.

    Inside a process group (:func:`initialize` formed one) the checkpoints
    are group commits, the incarnation is claimed by rank 0 only, and
    in-memory continuations are refused (the peers sit in a collective)."""

    def __init__(self, target, checkpoint_dir: str, *,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3,
                 max_total_bytes: Optional[int] = None,
                 max_restarts: int = 5,
                 backoff_base_s: float = 0.25,
                 backoff_max_s: float = 30.0,
                 storm_threshold: int = 3,
                 hang_deadline_s: Optional[float] = None,
                 hang_startup_grace_s: Optional[float] = None,
                 poll_s: float = 0.05,
                 preempt_grace_s: float = 10.0,
                 handle_signals: Optional[bool] = None,
                 policies: Optional[Dict[str, str]] = None,
                 elastic_grow: bool = True,
                 grow_probe_base_s: float = 2.0,
                 grow_probe_max_s: float = 60.0,
                 grow_failure_limit: int = 5):
        self.target = target
        # a network is its own holder; a wrapper or a pipeline trainer
        # trains its ``model``
        self.holder = (target if hasattr(target, "conf")
                       and hasattr(target, "_params") else target.model)
        self.dir = checkpoint_dir
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.max_total_bytes = max_total_bytes
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.storm_threshold = storm_threshold
        self.hang_deadline_s = hang_deadline_s
        # before an attempt's first heartbeat, the restore and the first
        # step's setup may take longer than a steady step
        self.hang_startup_grace_s = (
            hang_startup_grace_s if hang_startup_grace_s is not None
            else (max(5.0 * hang_deadline_s, 10.0)
                  if hang_deadline_s is not None else None))
        self.poll_s = poll_s
        self.preempt_grace_s = preempt_grace_s
        self.handle_signals = handle_signals
        self.policies = dict(DEFAULT_POLICIES)
        self.policies.update(policies or {})
        # grow-back after a shrink: probe the lost devices with
        # exponential backoff and rejoin them at a dispatch boundary
        self.elastic_grow = elastic_grow
        self.grow_probe_base_s = grow_probe_base_s
        self.grow_probe_max_s = grow_probe_max_s
        # failed grow resizes in a row before staying shrunk for good
        self.grow_failure_limit = grow_failure_limit
        self.incarnation: Optional[int] = None
        self._preempt = threading.Event()
        self._preempt_signal: Optional[int] = None
        self._fence = _AttemptFence()
        self._old_handlers: Dict[int, Any] = {}
        self._grow: Optional[Dict[str, Any]] = None
        self._resize_request: Optional[int] = None
        self._probe_ordinal = 0
        #: the current attempt's checkpoint listener (its ``saved`` and
        #: ``commit_seconds`` stay readable after the fit)
        self.checkpoint_listener = None

    # --- signals --------------------------------------------------------
    def _preempt_pending(self) -> bool:
        """A preemption to take at this step boundary: this process's
        signal, or inside a process group the group's agreement (any
        rank's signal, seen by every rank after the same step)."""
        if getattr(self.target, "spans_processes", False):
            return self.target.group_stop
        return self._preempt.is_set()

    def _install_signals(self) -> None:
        if self.handle_signals is False:
            return
        if threading.current_thread() is not threading.main_thread():
            if self.handle_signals:
                logger.warning("supervisor: signal handlers need the main "
                               "thread; preemption signals will not be "
                               "caught in this run")
            return
        import signal as _signal

        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                self._old_handlers[sig] = _signal.signal(sig, self._on_signal)
            except (ValueError, OSError):
                pass

    def _on_signal(self, signum, frame) -> None:
        logger.warning("supervisor: signal %s received — checkpoint at the "
                       "next step boundary, then exit resumable", signum)
        self._preempt_signal = signum
        self._preempt.set()

    def _restore_signals(self) -> None:
        import signal as _signal

        for sig, old in self._old_handlers.items():
            try:
                _signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers = {}

    # --- elastic shrink / grow ------------------------------------------
    def _cursor_of(self) -> tuple:
        """The holder's live pipeline cursor: the dispatch boundary an
        in-memory continuation resumes from."""
        h = self.holder
        e0 = int(getattr(h, "_fit_epoch0", getattr(h, "_epoch", 0)))
        return (int(getattr(h, "_epoch", 0)) - e0,
                int(getattr(h, "_steps_in_epoch", 0)))

    def _holder_state_intact(self) -> bool:
        """Whether the holder's state can be continued in memory: at a
        dispatch boundary, outside a process group, with a healthy CUDA
        context (the port donates no buffer; see the module docstring)."""
        h = self.holder
        if not getattr(h, "_at_dispatch_boundary", True):
            return False
        if getattr(self.target, "spans_processes", False):
            return False
        return _cuda_context_healthy(getattr(h, "device", None))

    def _shrink_plan(self, exc: BaseException) -> Optional[List[int]]:
        """Which replicas to drop for shrink-and-continue, or None to fall
        back to checkpoint-restart. A :class:`faultinject.DeviceLostError`
        names its replica; any other device failure is checked by probing
        the replicas' devices (an exception that merely looks like a
        device failure must not shrink a healthy axis)."""
        t = self.target
        if not callable(getattr(t, "resize", None)) \
                or getattr(t, "model_axis", 1) != 1:
            return None
        n = int(getattr(t, "workers_count", 0))
        if n <= 1 or not self._holder_state_intact():
            return None
        if isinstance(exc, faultinject.DeviceLostError) \
                and exc.replica is not None:
            lost = [int(exc.replica)]
        else:
            probe = getattr(t, "probe_replicas", None)
            lost = list(probe()) if callable(probe) else []
        lost = sorted({r for r in lost if 0 <= r < n})
        if not lost or len(lost) >= n:
            return None
        return lost

    def _quarantine_plan(self, exc: BaseException) -> Optional[List[int]]:
        """Which replica to quarantine for silent corruption, or None to
        fall back to checkpoint-restart. The device is healthy and its
        state diverged, so the only admissible attribution is the majority
        vote the exception carries (``replica`` None: a 2-way split names
        no one)."""
        t = self.target
        if not callable(getattr(t, "resize", None)) \
                or getattr(t, "model_axis", 1) != 1:
            return None
        n = int(getattr(t, "workers_count", 0))
        if n <= 1 or not self._holder_state_intact():
            return None
        rep = getattr(exc, "replica", None)
        if rep is None or not 0 <= int(rep) < n:
            return None
        return [int(rep)]

    def _apply_shrink(self, lost: List[int]) -> Optional[List[Any]]:
        """Resize the data axis over the survivors and arm the grow-back
        probe. Returns the removed devices, or None when the resize failed
        (the caller falls back to checkpoint-restart)."""
        t = self.target
        old = int(t.workers_count)
        new = old - len(lost)
        try:
            removed = t.resize(new, lost_replicas=lost)
        except Exception:
            logger.warning("supervisor: online shrink to %d workers "
                           "failed; falling back to checkpoint-restart",
                           new, exc_info=True)
            return None
        logger.warning("supervisor: device loss — shrank the data axis "
                       "%d -> %d (lost replicas %s); continuing in "
                       "memory from the dispatch boundary", old, new, lost)
        self._arm_grow(old, removed)
        return removed

    def _arm_grow(self, old: int, removed) -> None:
        """Arm (or merge into) the grow-back probe after a shrink or remap.
        A grow-back armed before this loss must not fire now: the merged
        probe checks every lost device before any grow."""
        self._resize_request = None
        if not (self.elastic_grow and removed):
            return
        g = self._grow
        if g is None:
            self._grow = {"target": old, "devices": list(removed),
                          "delay": self.grow_probe_base_s,
                          "next": (time.monotonic()
                                   + self.grow_probe_base_s)}
        else:
            # a second loss while a grow-back is pending: probe every lost
            # device, keep the original full count as the target
            g["devices"].extend(d for d in removed
                                if d not in g["devices"])
            g["target"] = max(int(g["target"]), old)
            g["failures"] = 0
            g["delay"] = self.grow_probe_base_s
            g["next"] = time.monotonic() + self.grow_probe_base_s

    # --- elastic pipeline remap (stage axis) -----------------------------
    def _remap_plan(self, exc: BaseException) -> Optional[List[int]]:
        """Which pipeline stages to drop for remap-and-continue, or None
        for checkpoint-restart: the target must have ``remap``, the
        holder's state must be usable, the lost stage must be named (by
        :class:`faultinject.DeviceLostError` or a probe of the stage
        columns), and at least 2 stages must survive."""
        t = self.target
        if not callable(getattr(t, "remap", None)):
            return None
        n = int(getattr(t, "stages_count", 0))
        if n < 2 or not self._holder_state_intact():
            return None
        if isinstance(exc, faultinject.DeviceLostError) \
                and getattr(exc, "stage", None) is not None:
            lost = [int(exc.stage)]
        else:
            probe = getattr(t, "probe_stages", None)
            lost = list(probe()) if callable(probe) else []
        lost = sorted({s for s in lost if 0 <= s < n})
        if not lost or n - len(lost) < 2:
            return None
        return lost

    def _apply_remap(self, lost: List[int]) -> Optional[List[Any]]:
        """Re-cut the pipeline over the surviving stage devices and arm the
        grow-back probe. Returns the removed devices, or None when the
        remap failed."""
        t = self.target
        old = int(t.stages_count)
        new = old - len(lost)
        try:
            removed = t.remap(new, lost_stages=lost)
        except Exception:
            logger.warning("supervisor: online remap to %d stages "
                           "failed; falling back to checkpoint-restart",
                           new, exc_info=True)
            return None
        logger.warning("supervisor: stage loss — remapped the pipeline "
                       "%d -> %d stages (lost stages %s); continuing in "
                       "memory from the dispatch boundary", old, new, lost)
        self._arm_grow(old, removed)
        return removed

    def _maybe_probe_grow(self) -> None:
        """The grow-back probe with exponential backoff, run from the
        monitor loop; success arms ``_resize_request``, which the heartbeat
        raises at the next dispatch boundary. The ``elastic/probe`` site
        makes drills deterministic (a raising spec: still dead)."""
        g = self._grow
        if g is None or self._resize_request is not None:
            return
        now = time.monotonic()
        if now < g["next"]:
            return
        prof = OpProfiler.get()
        prof.count("elastic/probes")
        ordinal = self._probe_ordinal
        self._probe_ordinal += 1
        try:
            faultinject.fault_point("elastic/probe", ordinal)
            healthy = self._devices_healthy(g["devices"])
        except Exception:
            healthy = False
        if healthy:
            logger.warning("supervisor: lost device(s) answer probes "
                           "again — growing the data axis back to %d at "
                           "the next dispatch boundary", g["target"])
            self._resize_request = int(g["target"])
        else:
            prof.count("elastic/probe_failures")
            g["delay"] = min(g["delay"] * 2.0, self.grow_probe_max_s)
            g["next"] = now + g["delay"]

    @staticmethod
    def _devices_healthy(devices) -> bool:
        from .mesh import probe_device

        return all(probe_device(d) for d in devices)

    # --- crash black box -------------------------------------------------
    def blackbox_path(self) -> str:
        return os.path.join(self.dir, BLACKBOX_NAME)

    def memcensus_path(self) -> str:
        return os.path.join(self.dir, MEMCENSUS_NAME)

    def _dump_blackbox(self) -> Optional[str]:
        """The flight recorder's tail beside the checkpoints, on every
        failure classification, restart, preemption and give-up, so the
        newest dump tells the latest story. It is reported to the
        watchtower (incident reports and ``/api/health``'s
        ``last_incident`` find it there), and the memory census (per-phase
        watermarks + a fresh allocator census) rides along as
        ``memcensus.json``."""
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = flightrec.dump_blackbox(self.blackbox_path())
        except OSError:
            logger.warning("supervisor: black-box dump to %s failed",
                           self.blackbox_path(), exc_info=True)
            return None
        _watchtower.note_blackbox(path)
        try:
            _xprof.dump_memory_census(self.memcensus_path())
        except Exception:   # census failure must not mask the blackbox
            logger.warning("supervisor: memory-census dump to %s failed",
                           self.memcensus_path(), exc_info=True)
        return path

    def _attach_blackbox(self, exc: "RestartBudgetExceeded",
                         reason: str) -> None:
        """Give-up path: the verdict on record, the black box dumped, and
        its tail attached to the exception."""
        flightrec.event("supervisor/give_up", severity="error",
                        reason=reason)
        exc.blackbox_path = self._dump_blackbox()
        exc.blackbox_tail = flightrec.tail(64)

    # --- monitoring -----------------------------------------------------
    def _monitor(self, run: _Attempt) -> str:
        """Watch one attempt: ``"done"`` (the thread finished, cleanly or
        with ``run.error``), ``"hang"`` (the watchdog fired, the attempt
        was abandoned) or ``"preempt_timeout"`` (a signal arrived but the
        thread reached no step boundary within the grace window)."""
        prof = OpProfiler.get()
        heartbeat = run.heartbeat
        grace_deadline: Optional[float] = None
        while True:
            if run.done.wait(self.poll_s):
                return "done"
            self._maybe_probe_grow()
            now = time.monotonic()
            if self._preempt.is_set():
                if grace_deadline is None:
                    grace_deadline = now + self.preempt_grace_s
                elif now > grace_deadline:
                    run.abandoned = True
                    faultinject.release_wedges()
                    run.done.wait(2.0)
                    return "preempt_timeout"
            deadline = (self.hang_deadline_s if heartbeat.steps > 0
                        else self.hang_startup_grace_s)
            if deadline is not None and \
                    now - heartbeat.last_beat > deadline:
                prof.count("supervisor/watchdog_fires")
                flightrec.event("supervisor/watchdog_fire", severity="warn",
                                deadline_s=deadline, steps=heartbeat.steps)
                logger.warning(
                    "supervisor: watchdog — no step within %.2fs (last "
                    "heartbeat %d steps in); abandoning the wedged "
                    "dispatch and restarting from the last checkpoint",
                    deadline, heartbeat.steps)
                run.abandoned = True
                faultinject.release_wedges()
                if not run.done.wait(5.0):
                    logger.warning("supervisor: hung attempt thread did "
                                   "not unwind; abandoning it (daemon)")
                elif run.error is None:
                    # merely slow: it finished while being abandoned
                    run.abandoned = False
                    return "done"
                return "hang"

    # --- the self-healing loop -----------------------------------------
    def _new_listener(self, _ckpt):
        """One incarnation and one checkpoint listener per attempt (a
        zombie's queued writer holds a stale incarnation); in a process
        group, rank 0 claims and the commits are group commits."""
        from ..optimize.listeners import CheckpointListener

        rt = cluster_runtime() if _group_world() > 1 else None
        if rt is None and _group_world() > 1:
            raise ValueError(
                "supervised checkpoints inside a process group are group "
                "commits: form the group with initialize(coordinator, "
                "num_processes, process_id)")
        if rt is not None:
            if rt.rank == 0:
                self.incarnation = rt.claim_commit_incarnation(self.dir)
            lst = _GroupCheckpointListener(
                rt, self.dir, save_every_n_iterations=self.every_iter,
                save_every_n_epochs=self.every_epoch,
                keep_last=self.keep_last,
                max_total_bytes=self.max_total_bytes)
        else:
            self.incarnation = _ckpt.claim_incarnation(self.dir)
            lst = CheckpointListener(
                self.dir, save_every_n_iterations=self.every_iter,
                save_every_n_epochs=self.every_epoch,
                keep_last=self.keep_last,
                max_total_bytes=self.max_total_bytes,
                incarnation=self.incarnation)
        self.checkpoint_listener = lst
        return lst

    def fit(self, data, epochs: int = 1, resume: str = "auto",
            **fit_kwargs) -> SupervisedFitResult:
        """Run the wrapped fit to completion under supervision.

        ``resume="auto"`` (default): the first attempt resumes from the
        newest intact checkpoint already in the directory (the relaunched
        process). ``resume="never"``: the first attempt starts fresh; the
        checkpoints serve the restarts of this call only."""
        from ..ndarray.rng import get_random
        from ..util import checkpoint as _ckpt

        if resume not in ("auto", "never"):
            raise ValueError(f"resume must be 'auto' or 'never', "
                             f"got {resume!r}")
        prof = OpProfiler.get()
        make_data: Optional[Callable[[], Any]] = \
            data if callable(data) else None
        src = make_data() if make_data else data
        source_state = None
        if make_data is None:
            state_fn = getattr(src, "source_state", None)
            if callable(state_fn):
                source_state = state_fn()
        user_listeners = list(getattr(self.target, "_listeners", []))
        if not user_listeners and self.holder is not self.target:
            # listeners attached to the wrapper's MODEL ride the
            # supervised arrangement (and its checkpoints)
            user_listeners = list(getattr(self.holder, "_listeners", []))
        target_restore = list(getattr(self.target, "_listeners", []))
        entry_rng = get_random().get_state()
        self._preempt.clear()
        self._preempt_signal = None
        self._grow = None
        self._resize_request = None
        self._probe_ordinal = 0
        self._install_signals()
        if getattr(self.target, "spans_processes", False):
            self.target.stop_event = self._preempt
        history: List[dict] = []
        restarts = 0
        consec_no_progress = 0
        # armed by a shrink, quarantine, remap or grow: (cursor, rng) for
        # an in-memory continuation from the holder's live state
        mem_resume: Optional[tuple] = None
        # a silent-corruption failure that falls back to restart resumes
        # from a scrub-verified generation
        prefer_scrubbed = False
        status = "completed"
        resume_path: Optional[str] = None
        final_exc: Optional[BaseException] = None
        run: Optional[_Attempt] = None
        ckpt = None
        attempt = 0
        try:
            ckpt = self._new_listener(_ckpt)
            resume_from = (_ckpt.last_checkpoint(self.dir)
                           if resume == "auto" else None)
            if resume_from is None:
                # the anchor: a crash before the first periodic save
                # restarts exactly (initial parameters, updater, the
                # generator, the listeners' pre-fit state), bound in the
                # supervised arrangement's positions
                self.holder._fit_epoch0 = self.holder._epoch
                self.holder._steps_in_epoch = 0
                ckpt.bind_group([self._fence, *user_listeners])
                ckpt.save_now(
                    self.holder,
                    f"init_{int(getattr(self.holder, '_iteration', 0))}")
            while True:
                attempt += 1
                prof.count("supervisor/attempts")
                faultinject.reset_wedges()
                if attempt > 1:
                    # drain the failed attempt's writer before choosing
                    # the resume point
                    ckpt.close()
                    ckpt = self._new_listener(_ckpt)
                    resume_from = (None if mem_resume is not None
                                   else _ckpt.last_checkpoint(
                                       self.dir,
                                       require_scrubbed=prefer_scrubbed))
                    if make_data:
                        src = make_data()
                    elif source_state is not None:
                        src.restore_source_state(source_state)
                attempt_kwargs = fit_kwargs
                attempt_rng = entry_rng
                if mem_resume is not None:
                    cursor, rng_state = mem_resume
                    mem_resume = None
                    attempt_kwargs = dict(fit_kwargs, resume_cursor=cursor)
                    attempt_rng = rng_state
                # every event of this attempt carries incarnation.attempt
                flightrec.set_correlation(
                    f"inc{self.incarnation}.a{attempt}")
                flightrec.event(
                    "supervisor/attempt_start", attempt=attempt,
                    resume=("cursor%s" % (attempt_kwargs["resume_cursor"],)
                            if "resume_cursor" in attempt_kwargs
                            else resume_from))
                if attempt > 1:
                    self._dump_blackbox()
                heartbeat = _Heartbeat(self)
                # the fence first, the user's listeners next (their state
                # rides the checkpoint), the checkpoint listener, the
                # heartbeat last (a preempted step is recorded by all
                # before it unwinds)
                self.target.set_listeners(self._fence, *user_listeners,
                                          ckpt, heartbeat)
                run = _Attempt(self, attempt, src, epochs, resume_from,
                               attempt_kwargs, attempt_rng, heartbeat)
                self._fence.thread = run.thread
                with flightrec.span("supervisor/attempt", attempt=attempt):
                    run.start()
                    outcome = self._monitor(run)
                if outcome == "done" and run.error is None:
                    break
                if outcome == "done" and \
                        isinstance(run.error, ElasticResizeRequested):
                    mem_resume = self._grow_back(run, history, attempt,
                                                 entry_rng)
                    consec_no_progress = 0
                    continue
                watchdogged = outcome == "hang"
                if watchdogged:
                    exc: BaseException = HangDetected(
                        f"no step within {self.hang_deadline_s}s "
                        f"({run.heartbeat.steps} steps landed this "
                        f"attempt); thread error: {run.error!r}")
                else:
                    exc = run.error or HangDetected(
                        f"attempt abandoned ({outcome})")
                cls = CLASS_HANG if watchdogged else classify_failure(exc)
                policy = self.policies.get(cls, "restart")
                if policy == "shrink_and_continue" \
                        and callable(getattr(self.target, "remap", None)):
                    # a pipeline heals its stage axis
                    policy = "remap_and_continue"
                # only a finished, not abandoned, attempt left a
                # trustworthy boundary state behind
                trusted = outcome == "done" and not run.abandoned
                shrink_lost: Optional[List[int]] = None
                remap_lost: Optional[List[int]] = None
                quarantine_lost: Optional[List[int]] = None
                if policy == "shrink_and_continue":
                    shrink_lost = self._shrink_plan(exc) if trusted else None
                    if shrink_lost is None:
                        policy = "restart"
                if policy == "remap_and_continue":
                    remap_lost = self._remap_plan(exc) if trusted else None
                    if remap_lost is None:
                        policy = "restart"
                if policy == "quarantine_and_continue":
                    quarantine_lost = (self._quarantine_plan(exc)
                                       if trusted else None)
                    if quarantine_lost is None:
                        policy = "restart"
                        prefer_scrubbed = True
                history.append({
                    "attempt": attempt, "class": cls, "policy": policy,
                    "error": repr(exc), "steps": run.heartbeat.steps,
                    "iteration": int(getattr(self.holder, "_iteration", 0)),
                })
                logger.warning("supervisor: attempt %d failed [%s → %s]: "
                               "%r", attempt, cls, policy, exc)
                flightrec.event("supervisor/attempt_failed",
                                severity="error", attempt=attempt,
                                failure_class=cls, policy=policy,
                                error=repr(exc)[:300],
                                steps=run.heartbeat.steps)
                self._dump_blackbox()
                # every failure classification opens or joins an incident
                # on the installed watchtower (no-op when none is)
                _watchtower.note_supervisor_failure(
                    failure_class=cls, policy=policy, error=repr(exc)[:200])
                # the policy decides; a grace-window timeout always exits
                if policy == "exit" or outcome == "preempt_timeout":
                    prof.count("supervisor/preemptions")
                    status = "preempted"
                    if run.done.is_set() and not run.abandoned:
                        resume_path = ckpt.save_now(
                            self.holder,
                            f"preempt_{int(self.holder._iteration)}")
                    else:
                        # abandoned inside a dispatch: fall back to what
                        # already committed
                        ckpt.flush()
                        resume_path = _ckpt.last_checkpoint(self.dir)
                    flightrec.event("supervisor/preempted", severity="warn",
                                    signal=self._preempt_signal,
                                    resume_from=resume_path)
                    self._dump_blackbox()
                    break
                if policy == "raise":
                    final_exc = exc
                    break
                if policy == "remap_and_continue":
                    if self._apply_remap(remap_lost) is None:
                        history[-1]["policy"] = "remap_failed_restart"
                        policy = "restart"
                    else:
                        prof.count("supervisor/remaps")
                        # a remap is progress: no restart used, breaker
                        # reset
                        consec_no_progress = 0
                        mem_resume = (self._cursor_of(),
                                      run.rng_state or entry_rng)
                        continue
                if policy == "shrink_and_continue":
                    if self._apply_shrink(shrink_lost) is None:
                        history[-1]["policy"] = "shrink_failed_restart"
                        policy = "restart"
                    else:
                        prof.count("supervisor/shrinks")
                        consec_no_progress = 0
                        mem_resume = (self._cursor_of(),
                                      run.rng_state or entry_rng)
                        continue
                if policy == "quarantine_and_continue":
                    # the mitigation anchor before the resize
                    flightrec.event(
                        "integrity/quarantine", severity="warn",
                        replica=quarantine_lost[0],
                        iteration=int(getattr(self.holder,
                                              "_iteration", 0)))
                    if self._apply_shrink(quarantine_lost) is None:
                        history[-1]["policy"] = "quarantine_failed_restart"
                        policy = "restart"
                        prefer_scrubbed = True
                    else:
                        prof.count("supervisor/quarantines")
                        consec_no_progress = 0
                        mem_resume = (self._cursor_of(),
                                      run.rng_state or entry_rng)
                        continue
                # checkpoint-restart
                if cls == CLASS_PREEMPTION:
                    # a preemption routed here: consume the signal
                    self._preempt.clear()
                    self._preempt_signal = None
                if run.heartbeat.steps > 0:
                    consec_no_progress = 0
                else:
                    consec_no_progress += 1
                if consec_no_progress >= self.storm_threshold:
                    prof.count("supervisor/storm_trips")
                    final_exc = RestartStorm(
                        f"restart storm: {consec_no_progress} consecutive "
                        f"restarts with zero steps of progress", history)
                    self._attach_blackbox(final_exc, "storm")
                    break
                if restarts >= self.max_restarts:
                    prof.count("supervisor/giveups")
                    final_exc = RestartBudgetExceeded(
                        f"restart budget ({self.max_restarts}) exhausted",
                        history)
                    self._attach_blackbox(final_exc, "budget")
                    break
                restarts += 1
                prof.count("supervisor/restarts")
                delay = (self.backoff_base_s if policy == "retry" else
                         min(self.backoff_base_s * (2 ** (restarts - 1)),
                             self.backoff_max_s))
                flightrec.event("supervisor/restart", severity="warn",
                                restarts=restarts, policy=policy,
                                backoff_s=delay)
                with prof.time_section("supervisor/backoff"):
                    # a preemption during the backoff does not wait it out
                    self._preempt.wait(delay)
                if self._preempt.is_set():
                    prof.count("supervisor/preemptions")
                    status = "preempted"
                    ckpt.flush()
                    resume_path = _ckpt.last_checkpoint(self.dir)
                    flightrec.event("supervisor/preempted", severity="warn",
                                    signal=self._preempt_signal,
                                    resume_from=resume_path)
                    self._dump_blackbox()
                    break
        finally:
            self._restore_signals()
            if getattr(self.target, "spans_processes", False):
                self.target.stop_event = None
            self._fence.thread = None
            try:
                if ckpt is not None:
                    # the writer's last commits still belong to the last
                    # attempt: the correlation is cleared after them
                    ckpt.close()
            finally:
                self.target.set_listeners(*target_restore)
                flightrec.set_correlation(None)
        if final_exc is not None:
            raise final_exc
        if status == "completed":
            flightrec.event("supervisor/completed",
                            corr=f"inc{self.incarnation}.a{attempt}",
                            attempts=attempt, restarts=restarts)
            self._dump_blackbox()
        if status == "completed" and run is not None \
                and run.rng_state is not None:
            # the caller's stream ends where a plain fit would leave it
            get_random().set_state(run.rng_state)
        return SupervisedFitResult(status, resume_path, restarts,
                                   attempt, history)

    def _grow_back(self, run: _Attempt, history: List[dict], attempt: int,
                   entry_rng: dict) -> tuple:
        """The grow-back: the attempt unwound at a dispatch boundary after
        the probe found the lost devices healthy; resize up (or, after
        ``grow_failure_limit`` failed resizes, stay shrunk) and return the
        in-memory continuation."""
        prof = OpProfiler.get()
        target_n = self._resize_request
        self._resize_request = None
        grown = False
        if target_n:
            try:
                self.target.resize(int(target_n))
                grown = True
                self._grow = None
                prof.count("supervisor/grows")
                logger.warning("supervisor: data axis grown back to %d "
                               "workers", target_n)
            except Exception:
                g = self._grow
                fails = g.get("failures", 0) + 1 if g is not None else 1
                if g is not None and fails >= self.grow_failure_limit:
                    logger.warning(
                        "supervisor: grow-back resize to %s failed %d "
                        "times; giving up — staying shrunk", target_n,
                        fails, exc_info=True)
                    self._grow = None
                    prof.count("elastic/grow_abandoned")
                else:
                    logger.warning(
                        "supervisor: grow-back resize to %s failed; "
                        "staying shrunk and re-arming the probe", target_n,
                        exc_info=True)
                    if g is not None:
                        g["failures"] = fails
                        g["delay"] = min(g["delay"] * 2.0,
                                         self.grow_probe_max_s)
                        g["next"] = time.monotonic() + g["delay"]
        history.append({
            "attempt": attempt, "class": "elastic_grow",
            "policy": "grow_and_continue" if grown else "grow_failed",
            "error": repr(run.error), "steps": run.heartbeat.steps,
            "iteration": int(getattr(self.holder, "_iteration", 0)),
        })
        return (self._cursor_of(), run.rng_state or entry_rng)


# ---------------------------------------------------------------------------
# process-level supervision
# ---------------------------------------------------------------------------

def supervise_processes(commands: List[List[str]], *,
                        max_restarts: int = 5,
                        backoff_base_s: float = 1.0,
                        backoff_max_s: float = 60.0,
                        storm_threshold: int = 3,
                        storm_min_uptime_s: float = 1.0,
                        env: Optional[Dict[str, str]] = None,
                        make_env: Optional[Callable[[int],
                                                    Optional[dict]]] = None,
                        poll_s: float = 0.05,
                        kill_grace_s: float = 5.0,
                        resumable_code: int =
                        SupervisedFitResult.resumable_exit_code,
                        cluster_dir: Optional[str] = None,
                        heartbeat_stale_s: float = 10.0,
                        make_commands: Optional[Callable[[int, int],
                                                         List[List[str]]]]
                        = None,
                        shrink_to_survivors: bool = False,
                        min_world: int = 1,
                        timeout_s: Optional[float] = None) -> dict:
    """The restart loop of a process group. Every command starts together
    (command ``i`` is rank ``i``); when any rank dies, the survivors are
    stopped (SIGTERM, ``kill_grace_s``, SIGKILL: no orphans; a synchronous
    collective cannot continue around a lost rank) and the group is
    relaunched after exponential backoff, resuming from its checkpoint
    directory.

    Each rank's exit is classified: ``resumable_code`` (75, a supervised
    fit's preempted status) is ``"preempted"`` and returns
    ``status="preempted"`` without a restart; a rank whose heartbeat in
    ``cluster_dir`` is older than ``heartbeat_stale_s`` while its process
    lives is a ``"hang"`` (the group is killed and restarted); any other
    nonzero exit a ``"crash"``. History rows carry each rank's class.

    With ``cluster_dir``, a lost rank also merges every rank's dumped
    blackbox (``cluster.merge_rank_blackboxes``) and records
    ``cluster/rank_lost`` and ``cluster/group_restart``; the relaunched
    group's heartbeats record ``cluster/form``. With a watchtower
    installed, a lost rank opens one incident carrying the merged per-rank
    events (``cluster/rank_lost`` the cause, ``cluster/form`` the
    recovery).

    With ``shrink_to_survivors=True`` and ``make_commands(world,
    attempt)``, a crashed or hung rank shrinks the group: the relaunch runs
    ``world - 1`` commands (down to ``min_world``), whose workers reshard
    from the checkpoint's replica-count-independent layout. ``make_env(
    attempt)`` adds per-attempt environment (a fault plan for the first
    attempt only, say). The storm breaker trips on ``storm_threshold``
    groups in a row that died within ``storm_min_uptime_s``.
    ``timeout_s`` (a port addition) bounds each attempt's wall time: a
    group still running then is reaped and :class:`HangDetected` raised."""
    import subprocess

    from . import cluster as _cluster

    prof = OpProfiler.get()
    history: List[dict] = []
    restarts = 0
    consec_fast = 0
    attempt = 0
    world = len(commands)

    def _classify(code: Optional[int], hung: bool) -> str:
        if hung:
            return CLASS_HANG
        if code == resumable_code:
            return "preempted"
        return "crash" if code not in (0, None) else "ok"

    def _reap(procs: List[Any]) -> None:
        """SIGTERM every survivor, wait the grace period, SIGKILL the
        stragglers."""
        for p in procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + kill_grace_s
        for p in procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(5.0)

    while True:
        attempt += 1
        prof.count("supervisor/proc_attempts")
        e = dict(os.environ)
        e.update(env or {})
        if make_env is not None:
            e.update(make_env(attempt - 1) or {})
        cmds = (make_commands(world, attempt - 1)
                if make_commands is not None else commands)
        if cluster_dir is not None:
            # the last incarnation's heartbeats must not count toward (or
            # against) the relaunched group's formation
            for r in range(max(world, len(cmds)) + 8):
                try:
                    os.remove(_cluster.heartbeat_path(cluster_dir, r))
                except OSError:
                    pass
        t0 = time.monotonic()
        procs: List[Any] = []
        try:
            for c in cmds:
                procs.append(subprocess.Popen(list(c), env=e))
        except Exception:
            # a rank that cannot launch must not orphan the others
            _reap(procs)
            raise
        failed_rank: Optional[int] = None
        hung = False
        formed_seen = cluster_dir is None
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed_rank = next((i for i, c in enumerate(codes)
                                    if c not in (None, 0)), None)
                if failed_rank is not None or all(c == 0 for c in codes):
                    break
                if timeout_s is not None \
                        and time.monotonic() - t0 > timeout_s:
                    raise HangDetected(
                        f"process group attempt {attempt} still running "
                        f"after {timeout_s:.1f}s (exit codes {codes})")
                if cluster_dir is not None:
                    hb = _cluster.read_heartbeats(cluster_dir)
                    if not formed_seen and all(
                            r in hb and hb[r]["age_s"] <= heartbeat_stale_s
                            for r in range(len(procs))):
                        formed_seen = True
                        prof.count("cluster/groups_formed")
                        # every rank of the (re)launched group beats
                        flightrec.event("cluster/form", rank=-1,
                                        world=len(procs), attempts=attempt,
                                        observer="supervisor")
                    stale = [r for r in range(len(procs))
                             if codes[r] is None and r in hb
                             and hb[r]["age_s"] > heartbeat_stale_s]
                    if stale:
                        failed_rank, hung = stale[0], True
                        break
                time.sleep(poll_s)
        except BaseException:
            _reap(procs)
            raise
        uptime = time.monotonic() - t0
        if failed_rank is None:
            return {"status": "completed", "attempts": attempt,
                    "restarts": restarts, "world": world,
                    "history": history}
        failed_code = procs[failed_rank].poll()
        pre_codes = list(codes)   # the snapshot at detection
        _reap(procs)
        codes = [p.poll() for p in procs]
        classes = {r: ("terminated" if pre_codes[r] is None
                       and r != failed_rank
                       else _classify(codes[r], hung and r == failed_rank))
                   for r in range(len(procs))}
        cls = classes[failed_rank]
        history.append({"attempt": attempt, "codes": codes,
                        "failed_rank": failed_rank, "classes": classes,
                        "world": world, "uptime_s": round(uptime, 3)})
        logger.warning("supervise_processes: rank %d %s (exit %s) after "
                       "%.2fs", failed_rank, cls,
                       failed_code if not hung else "none/heartbeat-stale",
                       uptime)
        merged = None
        if cluster_dir is not None:
            # the per-rank story, joined; the incident below carries it
            merged = _cluster.merge_rank_blackboxes(cluster_dir)
            history[-1]["rank_blackbox_rows"] = len(merged)
        prof.count(f"cluster/rank_{cls}")
        flightrec.event("cluster/rank_lost", severity="error",
                        rank=failed_rank, code=failed_code,
                        world=world, hung=hung, **{"class": cls})
        flightrec.event("supervisor/attempt_failed", severity="error",
                        rank=failed_rank, error=f"rank {failed_rank} "
                        f"{cls}", **{"class": cls})
        if cls == "preempted":
            return {"status": "preempted", "resumable": True,
                    "attempts": attempt, "restarts": restarts,
                    "world": world, "history": history}
        tower = _watchtower.get()
        if tower is not None:
            tower.assemble_incident(
                "rank_lost",
                f"rank {failed_rank} {cls} "
                f"(exit {'heartbeat-stale' if hung else failed_code})",
                attachments={"lost_rank": failed_rank, "class": cls,
                             "world": world,
                             "rank_blackboxes": merged} if merged else
                {"lost_rank": failed_rank, "class": cls, "world": world})
        consec_fast = consec_fast + 1 if uptime < storm_min_uptime_s else 0
        if consec_fast >= storm_threshold:
            prof.count("supervisor/storm_trips")
            raise RestartStorm(
                f"process group died {consec_fast} consecutive times "
                f"within {storm_min_uptime_s}s", history)
        if restarts >= max_restarts:
            prof.count("supervisor/giveups")
            raise RestartBudgetExceeded(
                f"process-group restart budget ({max_restarts}) exhausted",
                history)
        world_to = world
        if shrink_to_survivors and make_commands is not None \
                and world - 1 >= min_world:
            world_to = world - 1
            prof.count("cluster/shrinks")
        flightrec.event("cluster/group_restart", severity="warn",
                        rank=failed_rank, world_from=world,
                        world_to=world_to, attempt=attempt, **{"class": cls})
        world = world_to
        restarts += 1
        prof.count("supervisor/proc_restarts")
        delay = min(backoff_base_s * (2 ** (restarts - 1)), backoff_max_s)
        with prof.time_section("supervisor/backoff"):
            time.sleep(delay)


class SharedTrainingMaster:
    """The reference ``SharedTrainingMaster``'s front for synchronous
    data-parallel training: the same builder surface (workers, batch size,
    threshold algorithm, accumulator, checkpoints), ``fit`` through a
    ``ParallelWrapper`` over every worker, supervised by a
    :class:`TrainingSupervisor` when a checkpoint directory is set.

    In one process the workers are the model's device pool (capped by
    ``workers_per_node``). Inside a process group (:func:`initialize`) each
    rank trains ``workers_per_node`` replicas (one by default) on its own
    data source, the wrapper joins the group, and the global worker count
    is ``world x workers_per_node``."""

    class Builder:
        def __init__(self, batch_size_per_worker: int = 32):
            self._batch = batch_size_per_worker
            self._workers_per_node: Optional[int] = None
            self._threshold: Optional[Any] = None
            self._accumulator: Optional[Any] = None
            self._checkpoint_dir: Optional[str] = None
            self._checkpoint_every = 0

        def workers_per_node(self, n: int) -> "SharedTrainingMaster.Builder":
            self._workers_per_node = n
            return self

        def threshold_algorithm(self, alg) -> "SharedTrainingMaster.Builder":
            """The threshold-encoded exchange (one process only)."""
            self._threshold = alg
            return self

        def gradients_accumulator(self, acc) -> "SharedTrainingMaster.Builder":
            """An explicit exchange, e.g. :class:`ReduceScatterAccumulator`
            for ZeRO-1; takes precedence over ``threshold_algorithm``."""
            self._accumulator = acc
            return self

        def checkpoint(self, directory: str, every_n_iterations: int
                       ) -> "SharedTrainingMaster.Builder":
            self._checkpoint_dir = directory
            self._checkpoint_every = every_n_iterations
            return self

        def build(self) -> "SharedTrainingMaster":
            return SharedTrainingMaster(self._batch, self._workers_per_node,
                                        self._checkpoint_dir,
                                        self._checkpoint_every,
                                        self._threshold, self._accumulator)

    def __init__(self, batch_size_per_worker: int,
                 workers_per_node: Optional[int],
                 checkpoint_dir: Optional[str], checkpoint_every: int,
                 threshold_algorithm: Optional[Any] = None,
                 accumulator: Optional[Any] = None):
        self.batch_size_per_worker = batch_size_per_worker
        self.workers_per_node = workers_per_node
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.threshold_algorithm = threshold_algorithm
        self.accumulator = accumulator
        #: the last supervised run's SupervisedFitResult (None before one)
        self.last_result: Optional[SupervisedFitResult] = None
        #: the last fit's wrapper
        self.wrapper = None

    def workers(self, model=None) -> int:
        """The global worker count: in one process ``workers_per_node``
        bounded by the device pool (all of it when unset); in a process
        group ``world x workers_per_node`` (one a rank when unset)."""
        world = _group_world()
        if world > 1:
            return world * (self.workers_per_node or 1)
        from .mesh import device_pool

        pool = len(device_pool(model.device if model is not None
                               else "cpu"))
        if self.workers_per_node is None:
            return pool
        return min(self.workers_per_node, pool)

    def fit(self, model, data, epochs: int = 1, *,
            supervise: bool = True,
            supervisor_opts: Optional[Dict[str, Any]] = None):
        """Train ``model`` over every worker. With a checkpoint directory
        the run is supervised by default (failure classification, bounded
        checkpoint-restart, the watchdog, the preemption checkpoint, the
        incarnation fence), and a relaunched process resumes from the
        newest intact checkpoint. Listeners already attached to ``model``
        are kept and forwarded, their state riding the checkpoints. The
        result lands on :attr:`last_result`; ``supervise=False`` keeps a
        plain single attempt; ``supervisor_opts`` go to the
        :class:`TrainingSupervisor`. Inside a process group a failure is
        not retried in the process (``max_restarts`` 0, no in-memory
        continuation): the process exits with it for
        :func:`supervise_processes` to relaunch the group."""
        from ..optimize.listeners import CheckpointListener
        from .accumulator import EncodedGradientsAccumulator
        from .wrapper import ParallelWrapper

        multi = _group_world() > 1
        builder = (ParallelWrapper.Builder(model)
                   .training_mode("shared_gradients"))
        if multi:
            builder.process_group().workers(self.workers_per_node or 1)
        else:
            builder.workers(self.workers(model))
        if self.accumulator is not None:
            builder.gradients_accumulator(self.accumulator)
        elif self.threshold_algorithm is not None:
            builder.gradients_accumulator(EncodedGradientsAccumulator(
                threshold_algorithm=self.threshold_algorithm))
        pw = builder.build()
        self.wrapper = pw
        # the reference master forwards the model's listeners
        user_listeners = list(getattr(model, "_listeners", []))
        if user_listeners:
            pw.set_listeners(*user_listeners)
        if self.checkpoint_dir and supervise:
            # a directory is enough to supervise: the anchor checkpoint
            # makes restarts and preemption checkpoints exact
            opts = dict(supervisor_opts or {})
            if multi:
                opts.setdefault("max_restarts", 0)
                opts.setdefault("policies", {
                    CLASS_DEVICE: "restart", CLASS_CORRUPTION: "restart",
                    CLASS_TRANSIENT: "restart"})
            sup = TrainingSupervisor(
                pw, self.checkpoint_dir,
                save_every_n_iterations=self.checkpoint_every or None,
                **opts)
            self.last_result = sup.fit(data, epochs=epochs)
            return model
        resume = (CheckpointListener.last_checkpoint(self.checkpoint_dir)
                  if self.checkpoint_dir else None)
        ckpt = None
        if self.checkpoint_dir and self.checkpoint_every:
            rt = cluster_runtime() if multi else None
            if multi and rt is None:
                raise ValueError(
                    "checkpoints inside a process group are group commits: "
                    "form the group with initialize(coordinator, "
                    "num_processes, process_id)")
            ckpt = (_GroupCheckpointListener(
                rt, self.checkpoint_dir,
                save_every_n_iterations=self.checkpoint_every)
                if rt is not None else CheckpointListener(
                    self.checkpoint_dir,
                    save_every_n_iterations=self.checkpoint_every))
            pw.set_listeners(*user_listeners, ckpt)
        try:
            pw.fit(data, epochs=epochs, resume_from=resume)
        finally:
            if ckpt is not None:
                ckpt.close()   # every submitted write committed
        return model
