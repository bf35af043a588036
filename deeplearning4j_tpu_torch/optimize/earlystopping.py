"""Early stopping: termination conditions, savers, trainer.

Counterpart of ``deeplearning4j_tpu/optimize/earlystopping.py``, copied
(host-side control: the same scores give the same epochs, best epoch and
termination reason), with ``LocalFileModelSaver`` reading its zips back
through ``util/model_serializer.restore_model`` (either network, on the
device the saved model was on). Reference: deeplearning4j-core
``org.deeplearning4j.earlystopping.*``: ``EarlyStoppingConfiguration``
(epoch + iteration termination conditions, score calculator, model saver,
evaluate-every-N), ``EarlyStoppingTrainer``, ``EarlyStoppingResult``
(SURVEY.md §2.3).

It decides when to stop and save; every training step remains the
network's own ``fit``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, List, Optional, Sequence


# --- termination conditions (reference: termination/*.java) --------------

class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score):
        return epoch >= self.max_epochs

    def __str__(self):
        return f"MaxEpochs({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after ``patience`` epochs without (min_improvement) progress."""

    def __init__(self, patience: int, min_improvement: float = 0.0):
        self.patience = patience
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._best_epoch = -1

    def terminate(self, epoch, score):
        if self._best is None or score < self._best - self.min_improvement:
            self._best = score
            self._best_epoch = epoch
            return False
        return (epoch - self._best_epoch) >= self.patience

    def __str__(self):
        return f"ScoreImprovement(patience={self.patience})"


class IterationTerminationCondition:
    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort immediately when the score explodes past a bound."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score or score != score  # NaN aborts too

    def __str__(self):
        return f"MaxScore({self.max_score})"


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start: Optional[float] = None   # clock starts at first check

    def terminate(self, score):
        if self._start is None:
            self._start = time.monotonic()
        return (time.monotonic() - self._start) >= self.max_seconds

    def __str__(self):
        return f"MaxTime({self.max_seconds}s)"


# --- score calculators (reference: scorecalc/*.java) ---------------------

class ScoreCalculator:
    def calculate_score(self, model) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over a held-out iterator (reference:
    DataSetLossCalculator, average=true)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculate_score(self, model):
        total, n = 0.0, 0
        self.iterator.reset()
        for ds in self.iterator:
            total += model.score(ds) * ds.num_examples()
            n += ds.num_examples()
        return total / max(n, 1)


# --- model savers (reference: saver/*.java) ------------------------------

class InMemoryModelSaver:
    def __init__(self) -> None:
        self._best = None
        self._latest = None

    def save_best_model(self, model, score: float) -> None:
        self._best = model.clone()

    def save_latest_model(self, model, score: float) -> None:
        self._latest = model.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """Best/latest model zips under a directory (reference:
    LocalFileModelSaver bestModel.bin/latestModel.bin), read back on the
    device of the model that was saved."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._device = None

    def _best_path(self):
        return str(self.dir / "bestModel.zip")

    def save_best_model(self, model, score: float) -> None:
        self._device = model.device
        model.save(self._best_path(), save_updater=True)

    def save_latest_model(self, model, score: float) -> None:
        self._device = model.device
        model.save(str(self.dir / "latestModel.zip"), save_updater=True)

    def _load(self, path: str):
        from ..util.model_serializer import restore_model

        return restore_model(path, load_updater=True, device=self._device)

    def get_best_model(self):
        return self._load(self._best_path())

    def get_latest_model(self):
        return self._load(str(self.dir / "latestModel.zip"))


# --- configuration + trainer ---------------------------------------------

class EarlyStoppingConfiguration:
    class Builder:
        def __init__(self) -> None:
            self._epoch_conds: List[EpochTerminationCondition] = []
            self._iter_conds: List[IterationTerminationCondition] = []
            self._calc: Optional[ScoreCalculator] = None
            self._saver = InMemoryModelSaver()
            self._every_n = 1
            self._save_last = False

        def epoch_termination_conditions(self, *conds):
            self._epoch_conds = list(conds)
            return self

        def iteration_termination_conditions(self, *conds):
            self._iter_conds = list(conds)
            return self

        def score_calculator(self, calc: ScoreCalculator):
            self._calc = calc
            return self

        def model_saver(self, saver):
            self._saver = saver
            return self

        def evaluate_every_n_epochs(self, n: int):
            self._every_n = n
            return self

        def save_last_model(self, flag: bool = True):
            self._save_last = flag
            return self

        def build(self) -> "EarlyStoppingConfiguration":
            if not self._epoch_conds and not self._iter_conds:
                raise ValueError("need at least one termination condition")
            return EarlyStoppingConfiguration(self)

    @staticmethod
    def builder() -> "EarlyStoppingConfiguration.Builder":
        return EarlyStoppingConfiguration.Builder()

    def __init__(self, b: "EarlyStoppingConfiguration.Builder"):
        self.epoch_conditions = b._epoch_conds
        self.iteration_conditions = b._iter_conds
        self.score_calculator = b._calc
        self.saver = b._saver
        self.evaluate_every_n = b._every_n
        self.save_last = b._save_last


class EarlyStoppingResult:
    class TerminationReason:
        EpochTerminationCondition = "EpochTerminationCondition"
        IterationTerminationCondition = "IterationTerminationCondition"
        Error = "Error"

    def __init__(self, reason: str, details: str, total_epochs: int,
                 best_epoch: int, best_score: float, saver):
        self.termination_reason = reason
        self.termination_details = details
        self.total_epochs = total_epochs
        self.best_model_epoch = best_epoch
        self.best_model_score = best_score
        self._saver = saver

    def get_best_model(self):
        return self._saver.get_best_model()

    def __repr__(self):
        return (f"EarlyStoppingResult(reason={self.termination_reason}, "
                f"details={self.termination_details!r}, "
                f"epochs={self.total_epochs}, "
                f"best_epoch={self.best_model_epoch}, "
                f"best_score={self.best_model_score:.6f})")


class EarlyStoppingTrainer:
    """Reference: EarlyStoppingTrainer over a MultiLayerNetwork (a
    ComputationGraph too: any model with fit/score/save)."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator):
        self.config = config
        self.model = model
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        best_score: Optional[float] = None
        best_epoch = -1
        epoch = 0
        while True:
            # one training epoch, iteration conditions checked per batch
            self.train_iterator.reset()
            for ds in self.train_iterator:
                self.model.fit(ds, epochs=1)
                if not cfg.iteration_conditions:
                    continue   # no per-batch device sync unless needed
                score = float(self.model.score_value)
                for cond in cfg.iteration_conditions:
                    if cond.terminate(score):
                        if best_score is None:
                            cfg.saver.save_best_model(self.model, score)
                            best_score, best_epoch = score, epoch
                        return EarlyStoppingResult(
                            EarlyStoppingResult.TerminationReason
                            .IterationTerminationCondition,
                            str(cond), epoch + 1, best_epoch, best_score,
                            cfg.saver)
            epoch += 1
            if cfg.save_last:
                cfg.saver.save_latest_model(self.model,
                                            float(self.model.score_value))
            if epoch % cfg.evaluate_every_n == 0:
                score = (cfg.score_calculator.calculate_score(self.model)
                         if cfg.score_calculator is not None
                         else float(self.model.score_value))
                if best_score is None or score < best_score:
                    best_score, best_epoch = score, epoch - 1
                    cfg.saver.save_best_model(self.model, score)
                for cond in cfg.epoch_conditions:
                    if cond.terminate(epoch, score):
                        return EarlyStoppingResult(
                            EarlyStoppingResult.TerminationReason
                            .EpochTerminationCondition,
                            str(cond), epoch, best_epoch, best_score,
                            cfg.saver)
