"""Loss ops (tensor level).

Counterpart of ``deeplearning4j_tpu/ops/loss.py`` (``softmax_cross_entropy``
with its reduction modes: none / sum / mean_by_weight /
mean_by_nonzero_weight, each computed in the JAX op's order).
"""

from __future__ import annotations

import torch

from .registry import op


def _reduce(per_ex, weights, reduction: str):
    if weights is None:
        weights = torch.ones_like(per_ex)
    weighted = per_ex * weights
    r = reduction.lower()
    if r == "none":
        return weighted
    if r == "sum":
        return torch.sum(weighted)
    if r == "mean_by_weight":
        return torch.sum(weighted) / torch.clamp(torch.sum(weights),
                                                 min=1e-12)
    if r == "mean_by_nonzero_weight" or r == "mean":
        nz = torch.sum((weights != 0).to(per_ex.dtype))
        return torch.sum(weighted) / torch.clamp(nz, min=1.0)
    raise ValueError(f"unknown reduction {reduction!r}")


@op("softmax_cross_entropy", "loss")
def softmax_cross_entropy(logits, labels, weights=None,
                          label_smoothing: float = 0.0,
                          reduction: str = "mean_by_nonzero_weight"):
    """labels: one-hot/soft distribution over the last axis."""
    if label_smoothing > 0:
        n = logits.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / n
    logp = torch.log_softmax(logits, dim=-1)
    per = -torch.sum(labels * logp, dim=-1)
    return _reduce(per, weights, reduction)
