"""Evaluation: streaming, mergeable classification and regression metrics.

Counterpart of ``Evaluation`` (``deeplearning4j_tpu/eval/evaluation.py:17-120``)
and ``RegressionEvaluation`` (``:458``): the same arithmetic on numpy arrays,
so the two packages report the same accuracy and confusion matrix for the
same predictions. ``eval`` takes numpy arrays or tensors (a tensor is copied
to the host). ``EvaluationBinary``, ``ROC`` and the calibration metrics are
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _host(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        # numpy has no bfloat16: widen it (exactly) to float32
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


class Evaluation:
    """Multi-class metrics over one-hot or index labels; ``[B, T, C]`` time
    series are flattened with their ``[B, T]`` mask, plain batches take a
    ``[B]`` example mask."""

    def __init__(self, num_classes: Optional[int] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.top_n = top_n
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.count = 0

    def eval(self, labels, predictions, mask=None) -> None:
        labels, predictions, mask = (_host(labels), _host(predictions),
                                     _host(mask))
        if labels.ndim == 3:
            c = labels.shape[-1]
            labels = labels.reshape(-1, c)
            predictions = predictions.reshape(-1, c)
        if mask is not None:
            m = mask.reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        if labels.ndim == 2:
            true_idx = labels.argmax(1)
            n_cls = labels.shape[1]
        else:
            true_idx = labels.astype(int)
            n_cls = int(predictions.shape[-1])
        pred_idx = predictions.argmax(1)
        if self.confusion is None:
            self.num_classes = self.num_classes or n_cls
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        self.count += len(true_idx)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=1)[:, :self.top_n]
            self.top_n_correct += int((top == true_idx[:, None]).any(1).sum())
        else:
            self.top_n_correct += int((pred_idx == true_idx).sum())

    def merge(self, other: "Evaluation") -> "Evaluation":
        if self.confusion is None:
            self.confusion = other.confusion
            self.num_classes = other.num_classes
        elif other.confusion is not None:
            self.confusion = self.confusion + other.confusion
        self.count += other.count
        self.top_n_correct += other.top_n_correct
        return self

    def accuracy(self) -> float:
        if self.count == 0:
            return 0.0
        return float(np.trace(self.confusion)) / self.count

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / self.count if self.count else 0.0

    def _tp(self) -> np.ndarray:
        return np.diag(self.confusion).astype(np.float64)

    def _per_class(self, totals: np.ndarray, cls: Optional[int]) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(totals > 0, self._tp() / totals, 0.0)
        if cls is not None:
            return float(per[cls])
        return float(per[totals > 0].mean()) if (totals > 0).any() else 0.0

    def precision(self, cls: Optional[int] = None) -> float:
        return self._per_class(self.confusion.sum(0).astype(np.float64), cls)

    def recall(self, cls: Optional[int] = None) -> float:
        return self._per_class(self.confusion.sum(1).astype(np.float64), cls)

    def f1(self, cls: Optional[int] = None) -> float:
        p, r = self.precision(cls), self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    def matthews_correlation(self) -> float:
        """Binary MCC from the confusion matrix."""
        c = self.confusion
        if c.shape != (2, 2):
            raise ValueError("MCC defined for binary confusion only")
        tn, fp, fn, tp = c[0, 0], c[0, 1], c[1, 0], c[1, 1]
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0

    def stats(self) -> str:
        lines = [
            f"# examples: {self.count}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} accuracy: "
                         f"{self.top_n_accuracy():.4f}")
        lines.append("Confusion matrix (rows=actual):")
        lines.append(str(self.confusion))
        return "\n".join(lines)


class RegressionEvaluation:
    """Per-column MSE, MAE, RMSE, R² and Pearson correlation."""

    _SUMS = ("sum_err2", "sum_abs", "sum_label", "sum_label2", "sum_pred",
             "sum_pred2", "sum_lp")

    def __init__(self):
        self.n = 0
        for attr in self._SUMS:
            setattr(self, attr, None)

    def eval(self, labels, predictions, mask=None) -> None:
        lab = _host(labels).astype(np.float64)
        p = _host(predictions).astype(np.float64)
        if lab.ndim == 1:
            lab, p = lab[:, None], p[:, None]
        err = p - lab
        terms = ((err ** 2).sum(0), np.abs(err).sum(0), lab.sum(0),
                 (lab ** 2).sum(0), p.sum(0), (p ** 2).sum(0),
                 (lab * p).sum(0))
        for attr, v in zip(self._SUMS, terms):
            cur = getattr(self, attr)
            setattr(self, attr, v if cur is None else cur + v)
        self.n += lab.shape[0]

    def merge(self, other: "RegressionEvaluation") -> "RegressionEvaluation":
        for attr in self._SUMS:
            mine, theirs = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, theirs if mine is None else mine + theirs)
        self.n += other.n
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label2[col] - self.sum_label[col] ** 2 / self.n
        return float(1.0 - self.sum_err2[col] / ss_tot) if ss_tot > 0 \
            else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        cov = self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col] \
            / self.n
        vl = self.sum_label2[col] - self.sum_label[col] ** 2 / self.n
        vp = self.sum_pred2[col] - self.sum_pred[col] ** 2 / self.n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d > 0 else 0.0
