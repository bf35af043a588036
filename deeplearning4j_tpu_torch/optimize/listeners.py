"""Training listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py``:
``TrainingListener`` (the protocol), ``ScoreIterationListener``,
``CollectScoresIterationListener``, ``PerformanceListener``,
``TimeIterationListener``, ``EvaluativeListener``,
``PipelineMetricsListener`` and ``CheckpointListener``.

``score`` reaches a listener as a device scalar (a 0-dim tensor on the
network's device): ``float(score)`` waits for the card, so a listener
converts it only where it prints or keeps a number. ``PerformanceListener``
reads the batch size the fit loop bound last (``model._last_batch_size``,
the padded size of a padded batch, as in the JAX package). A listener opts
into an exact resume with ``state_dict``/``load_state_dict``
(``CollectScoresIterationListener`` does); ``CheckpointListener`` saves its
peers' state beside the network's. ``PerformanceListener(storage=)``
publishes its rates into a ``ui/stats.StatsStorage``. Each conversion of
the score is a host readback, counted by
``common/tracecheck.note_host_sync`` so a steady-state region sees it.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, List, Optional

from ..common import tracecheck
from ..common.profiler import OpProfiler

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _read_score(score) -> float:
    """``float(score)``: one host readback of the device scalar."""
    tracecheck.note_host_sync("listener/score")
    return float(score)


class TrainingListener:
    def iteration_done(self, model, iteration: int, score) -> None:
        pass

    def epoch_done(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, score):
        if (iteration % self.print_iterations == 0
                and logger.isEnabledFor(logging.INFO)):
            logger.info("Score at iteration %d is %s", iteration,
                        _read_score(score))


class CollectScoresIterationListener(TrainingListener):
    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, _read_score(score)))

    # the checkpoint protocol: a resumed run's history continues the
    # killed run's
    def state_dict(self) -> dict:
        return {"scores": [[i, s] for i, s in self.scores]}

    def load_state_dict(self, state: dict) -> None:
        self.scores = [(int(i), float(s)) for i, s in state.get("scores", [])]


class PerformanceListener(TrainingListener):
    """Iterations/s, milliseconds per iteration and samples/s over each
    ``frequency`` iterations, by the host clock (steps that end without a
    wait for the card are counted when the host queued them); each rate is
    a ``perf/rate`` flight-recorder event and, with ``storage``, the
    scalars ``iterations_per_sec`` / ``iteration_ms`` / ``samples_per_sec``
    of session ``session_id`` in that ``ui/stats.StatsStorage``."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 storage=None, session_id: str = "performance"):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
        self.storage = storage
        self.session_id = session_id
        self._last_time = None
        self._last_iter = None
        self.last_iterations_per_sec = 0.0
        self.last_iteration_ms = 0.0
        self.last_samples_per_sec = 0.0

    def iteration_done(self, model, iteration, score):
        now = time.time()
        if self._last_time is None:
            self._last_time, self._last_iter = now, iteration
            return
        if iteration % self.frequency != 0:
            return
        dt = now - self._last_time
        iters = iteration - self._last_iter
        if dt > 0 and iters > 0:
            ips = iters / dt
            self.last_iterations_per_sec = ips
            self.last_iteration_ms = dt / iters * 1e3
            batch = getattr(model, "_last_batch_size", None)
            if batch:
                self.last_samples_per_sec = ips * batch
            if logger.isEnabledFor(logging.INFO):
                logger.info("iteration %d: %.1f iter/s, score=%s",
                            iteration, ips, _read_score(score))
            if self.storage is not None:
                self.storage.put_scalar(self.session_id,
                                        "iterations_per_sec", iteration, ips)
                self.storage.put_scalar(self.session_id, "iteration_ms",
                                        iteration, self.last_iteration_ms)
                if batch:
                    self.storage.put_scalar(self.session_id,
                                            "samples_per_sec", iteration,
                                            self.last_samples_per_sec)
            from ..common import flightrec

            flightrec.event(
                "perf/rate", iteration=iteration,
                iterations_per_sec=round(ips, 3),
                iteration_ms=round(self.last_iteration_ms, 3),
                **({"samples_per_sec": round(self.last_samples_per_sec, 1)}
                   if batch else {}))
        self._last_time, self._last_iter = now, iteration


class TimeIterationListener(TrainingListener):
    """ETA logging over an expected iteration count."""

    def __init__(self, expected_iterations: int, frequency: int = 50):
        self.expected = expected_iterations
        self.frequency = max(1, frequency)
        self.start = time.time()

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0 and iteration > 0:
            elapsed = time.time() - self.start
            remaining = elapsed / iteration * (self.expected - iteration)
            logger.info("iteration %d/%d, ETA %.0fs", iteration,
                        self.expected, max(0.0, remaining))


class EvaluativeListener(TrainingListener):
    """``model.evaluate(data)`` every ``frequency`` iterations; the metric
    (an ``Evaluation`` method name) goes to ``history``. A failed
    evaluation is logged and skipped, so a bad holdout batch does not end a
    long run; a metric name that does not exist raises."""

    def __init__(self, data, frequency: int = 100, metric: str = "accuracy"):
        self.data = data
        self.frequency = max(1, frequency)
        self.metric = metric
        self.history: List[tuple] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency != 0:
            return
        try:
            ev = model.evaluate(self.data)
        except Exception:
            logger.warning("EvaluativeListener: evaluation failed at "
                           "iteration %d; skipping this boundary", iteration,
                           exc_info=True)
            return
        metric_fn = getattr(ev, self.metric)
        try:
            value = metric_fn()
        except Exception:
            logger.warning("EvaluativeListener: %s computation failed at "
                           "iteration %d; skipping this boundary",
                           self.metric, iteration, exc_info=True)
            return
        self.history.append((iteration, value))
        logger.info("eval at iteration %d: %s=%.4f", iteration, self.metric,
                    value)


class PipelineMetricsListener(TrainingListener):
    """Per-epoch snapshots of the input pipeline's counters
    (``pipeline/padded_batches``, ``pipeline/dropped_batches``, from
    ``common/profiler.OpProfiler``). The JAX package's snapshot also holds
    its trace counts and overlap ledger; the port compiles no step and its
    fit loop times no pipeline section, so the snapshot has neither.
    :meth:`trace_count` and :meth:`overlap_stats` read what the port does
    count: the ``trace/*`` counters of the steps that note their first
    call (``serving_infer``, ``fleet_step``, ``pipeline_fit_step``) and the
    ``pipeline/dispatch`` section of the wrapper, fleet and pipeline fits."""

    def __init__(self, frequency_epochs: int = 1):
        self.frequency = max(1, frequency_epochs)
        self.snapshots: List[dict] = []

    def epoch_done(self, model, epoch: int) -> None:
        if epoch % self.frequency:
            return
        counters = OpProfiler.get().get_counters()
        self.snapshots.append({
            "epoch": epoch,
            "counters": {k: v for k, v in counters.items()
                         if k.startswith("pipeline/")}})

    def trace_count(self, step_name: str) -> int:
        """The ``trace/<step_name>`` counter, e.g. ``fleet_step``."""
        return OpProfiler.get().counter_value(f"trace/{step_name}")

    def overlap_stats(self) -> dict:
        return OpProfiler.get().overlap_stats()


class CheckpointListener(TrainingListener):
    """Rolling checkpoints every N iterations or epochs, on the
    ``util/checkpoint`` machinery (the JAX package's
    ``listeners.py:223-441``):

    - ``_save`` snapshots the network in one readback on the training
      thread, then (``async_write=True``, the default) hands the host
      snapshot to a background writer: serialization, fsync and the atomic
      rename never block the training loop. The durability points are
      :meth:`flush`, :meth:`close` and reading :attr:`saved`; a kill loses
      at most the writes in flight, and a resume falls back to the last
      committed file. A failed write is kept in :meth:`errors` (and
      logged), never swallowed.
    - The ``checkpoint.json`` manifest holds a sha256 per file;
      :meth:`last_checkpoint` verifies and falls back to the newest intact
      one.
    - Construction rebuilds the retention state from the directory and
      clears stale ``*.tmp`` wreckage.
    - Under ``steps_per_dispatch`` a save due inside a dispatch waits for
      its last step (the only one whose parameters the network holds); the
      tag names the iteration saved.

    A model without the networks' internals (SameDiff) saves through its
    own ``save``, registered in the same manifest, synchronously.
    ``snapshot_ms`` holds each snapshot's time on the training thread and
    ``commit_seconds`` (after :meth:`flush`) each serialize-and-commit's.
    """

    def __init__(self, directory: str,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3, async_write: bool = True,
                 max_total_bytes: Optional[int] = None,
                 incarnation: Optional[int] = None):
        from ..util import checkpoint as _ckpt

        self.dir = directory
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.keep_last = keep_last
        self.async_write = async_write
        self.max_total_bytes = max_total_bytes
        self.incarnation = incarnation
        os.makedirs(directory, exist_ok=True)
        _ckpt.clean_stale_tmp(directory)
        self._saved: List[str] = _ckpt.committed_checkpoints(directory)
        self._writer = None
        self._group: Optional[List[Any]] = None
        self._pending_tag: Optional[str] = None
        self._closed_errors: List[BaseException] = []
        self._sync_commit_seconds: List[float] = []
        self.snapshot_ms: List[float] = []
        # guards the writer handle and the committed-paths mirror, which
        # the writer thread's on_commit updates
        self._lock = threading.Lock()

    @property
    def saved(self) -> List[str]:
        """Committed checkpoint paths, oldest first; reading it flushes
        the writes in flight first."""
        self.flush()
        return self._saved

    @property
    def commit_seconds(self) -> List[float]:
        writer = self._writer
        return self._sync_commit_seconds + (
            list(writer.commit_seconds) if writer is not None else [])

    def bind_group(self, listeners: List[Any]) -> None:
        """``set_listeners`` hands over the whole list, so the snapshot
        holds the peers' ``state_dict``s."""
        self._group = list(listeners)

    def _note_commit(self, path: str) -> None:
        with self._lock:
            saved = [p for p in self._saved if p != path] + [path]
            if self.keep_last and len(saved) > self.keep_last:
                saved = saved[-self.keep_last:]
            if self.max_total_bytes:
                saved = [p for p in saved if os.path.exists(p)]
            self._saved = saved

    def _get_writer(self):
        from ..util import checkpoint as _ckpt

        with self._lock:
            if self._writer is None:
                self._writer = _ckpt.CheckpointWriter(
                    self.dir, self.keep_last, on_commit=self._note_commit,
                    max_total_bytes=self.max_total_bytes,
                    incarnation=self.incarnation)
            return self._writer

    def _save(self, model, tag: str) -> Optional[str]:
        from ..util import checkpoint as _ckpt

        if hasattr(model, "_params") and hasattr(model, "conf"):
            t0 = time.perf_counter()
            snapshot = _ckpt.snapshot_training_state(model,
                                                     listeners=self._group)
            self.snapshot_ms.append((time.perf_counter() - t0) * 1e3)
            if self.async_write:
                self._get_writer().submit(snapshot, tag)
                return None
            return self._commit_snapshot(snapshot, tag)
        path = os.path.join(self.dir, f"checkpoint_{tag}.zip")
        model.save(path, save_updater=True)
        _ckpt.register_committed(self.dir, path,
                                 int(getattr(model, "_iteration", 0)),
                                 self.keep_last,
                                 max_total_bytes=self.max_total_bytes,
                                 incarnation=self.incarnation)
        self._note_commit(path)
        return path

    def save_now(self, model, tag: str) -> str:
        """Snapshot ``model`` and commit it synchronously, outside the
        iteration cadence (after an elastic resize, say); returns the
        committed path."""
        from ..util import checkpoint as _ckpt

        return self._commit_snapshot(
            _ckpt.snapshot_training_state(model, listeners=self._group), tag)

    def _commit_snapshot(self, snapshot: dict, tag: str) -> str:
        from ..util import checkpoint as _ckpt

        t0 = time.perf_counter()
        data = _ckpt.serialize_snapshot(snapshot)
        path = _ckpt.commit_checkpoint(
            self.dir, tag, data, snapshot["iteration"], self.keep_last,
            max_total_bytes=self.max_total_bytes,
            incarnation=self.incarnation,
            state_dtype=snapshot.get("state_dtype"))
        self._sync_commit_seconds.append(time.perf_counter() - t0)
        self._note_commit(path)
        return path

    def iteration_done(self, model, iteration, score):
        if self.every_iter and iteration % self.every_iter == 0:
            self._pending_tag = f"iter_{iteration}"
        if self._pending_tag is not None and \
                getattr(model, "_at_dispatch_boundary", True):
            tag = (f"iter_{iteration}"
                   if self._pending_tag.startswith("iter_")
                   else self._pending_tag)
            self._pending_tag = None
            self._save(model, tag)

    def epoch_done(self, model, epoch):
        if self.every_epoch and epoch % self.every_epoch == 0:
            self._save(model, f"epoch_{epoch}")

    def flush(self, timeout: Optional[float] = 60.0) -> None:
        """Block until every submitted checkpoint is committed or failed."""
        if self._writer is not None:
            self._writer.flush(timeout)

    def close(self) -> None:
        with self._lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            writer.close()
            self._closed_errors = list(writer.errors)
            self._sync_commit_seconds += writer.commit_seconds

    def errors(self) -> List[BaseException]:
        """The writes that failed (their checkpoints never reached the
        manifest); kept after :meth:`close`."""
        if self._writer is not None:
            return list(self._writer.errors)
        return list(self._closed_errors)

    @staticmethod
    def last_checkpoint(directory: str) -> Optional[str]:
        """The newest checkpoint that proves intact
        (``util/checkpoint.last_checkpoint``)."""
        from ..util import checkpoint as _ckpt

        return _ckpt.last_checkpoint(directory)
