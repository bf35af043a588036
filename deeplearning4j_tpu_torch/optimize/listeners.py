"""Training listeners.

Counterpart of ``deeplearning4j_tpu/optimize/listeners.py:20-180``:
``TrainingListener`` (the protocol), ``ScoreIterationListener``,
``CollectScoresIterationListener``, ``PerformanceListener``,
``TimeIterationListener`` and ``EvaluativeListener``.

``score`` reaches a listener as a device scalar (a 0-dim tensor on the
network's device): ``float(score)`` waits for the card, so a listener
converts it only where it prints or keeps a number. ``PerformanceListener``
reads the batch size the fit loop bound last (``model._last_batch_size``,
the padded size of a padded batch, as in the JAX package). Not ported yet:
``CheckpointListener`` and the checkpoint protocol (``state_dict``), the
stats storage and the flight recorder that ``PerformanceListener`` feeds,
and the telemetry listeners.
"""

from __future__ import annotations

import logging
import time
from typing import List

logger = logging.getLogger("deeplearning4j_tpu_torch")


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
            logger.info("Score at iteration %d is %s", iteration, float(score))


class CollectScoresIterationListener(TrainingListener):
    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))


class PerformanceListener(TrainingListener):
    """Iterations/s, milliseconds per iteration and samples/s over each
    ``frequency`` iterations, by the host clock (steps that end without a
    wait for the card are counted when the host queued them)."""

    def __init__(self, frequency: int = 10, report_batch: bool = True):
        self.frequency = max(1, frequency)
        self.report_batch = report_batch
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
                            iteration, ips, float(score))
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
