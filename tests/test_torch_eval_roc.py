"""The ROC family and the calibration evaluation in the port against the
JAX package, on the CPU (``eval/evaluation.py``): ``ROC`` (exact,
thresholded, spilled), ``ROCBinary``, ``ROCMultiClass``,
``EvaluationBinary`` and ``EvaluationCalibration``, each with ``merge``.

The same numpy arrays (made from a seed) go into both packages; the port
also takes them as tensors. Tolerance: every metric bitwise equal (the
port's arithmetic is the JAX package's numpy).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.eval import evaluation as J
from deeplearning4j_tpu_torch.eval import evaluation as T


def scores(n=300, k=4, seed=0, ties=False):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, (n, k)).astype(np.float32)
    s = np.clip(rng.rand(n, k) * 0.6 + y * 0.4 * rng.rand(n, k), 0, 1)
    if ties:
        s = np.round(s, 1)
    return y, s.astype(np.float32)


def softmax_scores(n=240, c=5, seed=1):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, c).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = np.eye(c, dtype=np.float32)[rng.randint(0, c, n)]
    return y, p.astype(np.float32)


def as_input(a, kind):
    return torch.from_numpy(a) if kind == "tensor" else a


KINDS = ["numpy", "tensor"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("thresholds", [0, 200, 37])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_roc_matches_jax(thresholds, ties, kind):
    y, s = scores(ties=ties)
    j, t = J.ROC(thresholds), T.ROC(thresholds)
    j.eval(y[:, 0], s[:, 0])
    t.eval(as_input(y[:, 0], kind), as_input(s[:, 0], kind))
    assert t.calculate_auc() == j.calculate_auc()
    assert t.calculate_auprc() == j.calculate_auprc()


@pytest.mark.parametrize("kind", KINDS)
def test_roc_two_column_and_spill(kind):
    y, s = scores(n=700, k=2)
    j, t = J.ROC(max_exact_examples=1000), T.ROC(max_exact_examples=1000)
    for _ in range(2):      # crosses the limit: both spill
        j.eval(y, s)
        t.eval(as_input(y, kind), as_input(s, kind))
    assert t.spilled and j.spilled
    assert t.calculate_auc() == j.calculate_auc()
    assert t.calculate_auprc() == j.calculate_auprc()


@pytest.mark.parametrize("modes", [(0, 0), (200, 0), (0, 200), (200, 200)],
                         ids=["exact+exact", "binned+exact", "exact+binned",
                              "binned+binned"])
def test_roc_merge_matches_jax(modes):
    y, s = scores(n=400)
    out = []
    for M in (J, T):
        a, b = M.ROC(modes[0]), M.ROC(modes[1])
        a.eval(y[:200, 0], s[:200, 0])
        b.eval(y[200:, 0], s[200:, 0])
        a.merge(b)
        out.append((a.calculate_auc(), a.calculate_auprc()))
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True])
def test_roc_binary_matches_jax(masked, kind):
    y, s = scores(k=3, seed=2)
    mask = (np.random.RandomState(3).rand(*y.shape) > 0.3).astype(
        np.float32) if masked else None
    j, t = J.ROCBinary(), T.ROCBinary()
    j.eval(y, s, mask)
    t.eval(as_input(y, kind), as_input(s, kind),
           None if mask is None else as_input(mask, kind))
    assert t.num_labels() == j.num_labels()
    assert [t.calculate_auc(i) for i in range(3)] == \
        [j.calculate_auc(i) for i in range(3)]
    assert t.calculate_average_auc() == j.calculate_average_auc()
    # merge into a fresh one, as JAX's
    jm, tm = J.ROCBinary().merge(j), T.ROCBinary().merge(t)
    assert tm.calculate_average_auc() == jm.calculate_average_auc()


@pytest.mark.parametrize("kind", KINDS)
def test_roc_multiclass_matches_jax(kind):
    y, p = softmax_scores()
    j, t = J.ROCMultiClass(), T.ROCMultiClass()
    for lo in (0, 120):
        j.eval(y[lo:lo + 120], p[lo:lo + 120])
        t.eval(as_input(y[lo:lo + 120], kind), as_input(p[lo:lo + 120], kind))
    assert [t.calculate_auc(c) for c in range(5)] == \
        [j.calculate_auc(c) for c in range(5)]
    assert t.calculate_average_auc() == j.calculate_average_auc()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("masked", [False, True])
def test_evaluation_binary_matches_jax(threshold, masked, kind):
    y, s = scores(k=3, seed=4)
    mask = (np.random.RandomState(5).rand(*y.shape) > 0.2).astype(
        np.float32) if masked else None
    j, t = J.EvaluationBinary(threshold), T.EvaluationBinary(threshold)
    for lo in (0, 150):
        sl = slice(lo, lo + 150)
        j.eval(y[sl], s[sl], None if mask is None else mask[sl])
        t.eval(as_input(y[sl], kind), as_input(s[sl], kind),
               None if mask is None else as_input(mask[sl], kind))
    for attr in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(t, attr), getattr(j, attr))
    for i in range(3):
        for m in ("accuracy", "precision", "recall", "f1"):
            assert getattr(t, m)(i) == getattr(j, m)(i), (m, i)
    jm = J.EvaluationBinary(threshold).merge(j)
    tm = T.EvaluationBinary(threshold).merge(t)
    np.testing.assert_array_equal(tm.tp, jm.tp)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mask", ["none", "rows", "cells"])
@pytest.mark.parametrize("bins", [(10, 50), (7, 13)])
def test_calibration_matches_jax(mask, bins, kind):
    y, p = softmax_scores(seed=6)
    rng = np.random.RandomState(7)
    m = {"none": None,
         "rows": (rng.rand(len(y)) > 0.3).astype(np.float32),
         "cells": (rng.rand(*y.shape) > 0.3).astype(np.float32)}[mask]
    j, t = J.EvaluationCalibration(*bins), T.EvaluationCalibration(*bins)
    j.eval(y, p, m)
    t.eval(as_input(y, kind), as_input(p, kind),
           None if m is None else as_input(m, kind))
    assert t.expected_calibration_error() == j.expected_calibration_error()
    for c in range(5):
        for a, b in zip(t.get_reliability_info(c),
                        j.get_reliability_info(c)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.get_probability_histogram(c),
                                      j.get_probability_histogram(c))
        assert t.expected_calibration_error(c) == \
            j.expected_calibration_error(c)


def test_calibration_merge_matches_jax_and_does_not_alias():
    y, p = softmax_scores(seed=8)
    out = []
    for M in (J, T):
        a, b = M.EvaluationCalibration(), M.EvaluationCalibration()
        b.eval(y[:100], p[:100])
        a.merge(b)
        b.eval(y[100:], p[100:])    # must not reach a
        c = M.EvaluationCalibration()
        c.eval(y[100:], p[100:])
        a.merge(c)
        out.append(a.expected_calibration_error())
    assert out[0] == out[1]


def test_bfloat16_tensor_predictions():
    """bf16 scores from the card's served forward widen exactly."""
    y, p = softmax_scores(seed=9)
    pb = torch.from_numpy(p).to(torch.bfloat16)
    t, j = T.ROCMultiClass(), J.ROCMultiClass()
    t.eval(torch.from_numpy(y), pb)
    j.eval(y, pb.float().numpy())
    assert t.calculate_average_auc() == j.calculate_average_auc()
