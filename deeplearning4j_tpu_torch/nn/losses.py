"""Loss functions (the ``ILossFunction`` contract).

Counterpart of ``deeplearning4j_tpu/nn/losses.py``: a loss computes a
per-example score from (labels, pre-output, activation) with optional label
weights and a per-example mask, and owns applying the output activation.
The gradient comes from autograd through the whole network. Ported so far:
``LossMCXENT`` (ResNet-50's head), which works on logits through
``log_softmax`` when the activation is softmax.
"""

from __future__ import annotations

import torch

from .activations import activation_fn


class ILossFunction:
    name = "base"

    def score_array(self, labels, pre_output, activation: str, mask=None):
        """Per-example loss ``[batch]``."""
        raise NotImplementedError(
            f"loss {self.name!r}: scoring is not ported yet")

    def compute_score(self, labels, pre_output, activation: str, mask=None,
                      average: bool = True):
        per = self.score_array(labels, pre_output, activation, mask)
        return per.mean() if average else per.sum()

    # --- helpers -----------------------------------------------------------
    @staticmethod
    def _activate(pre_output, activation: str):
        return activation_fn(activation)(pre_output)

    @staticmethod
    def _apply_mask(per_element, mask):
        """``mask``: ``[batch]`` or ``[batch, time]``, broadcast over the
        per-element loss."""
        if mask is None:
            return per_element
        m = mask
        while m.ndim < per_element.ndim:
            m = m[..., None]
        return per_element * m

    @staticmethod
    def _sum_per_example(per_element):
        if per_element.ndim <= 1:
            return per_element
        return per_element.sum(dim=tuple(range(1, per_element.ndim)))


class LossMCXENT(ILossFunction):
    """Multi-class cross-entropy; with softmax activation it works on the
    logits through ``log_softmax``."""

    name = "mcxent"

    def __init__(self, weights=None, softmax_clip_eps: float = 1e-10):
        self.weights = weights
        self.eps = softmax_clip_eps

    def score_array(self, labels, pre_output, activation: str = "softmax",
                    mask=None):
        if activation.lower() == "softmax":
            logp = torch.log_softmax(pre_output, dim=-1)
        else:
            p = self._activate(pre_output, activation)
            logp = torch.log(torch.clamp(p, self.eps, 1.0))
        w = (torch.as_tensor(self.weights, dtype=logp.dtype,
                             device=logp.device)
             if self.weights is not None else 1.0)
        per_el = -(labels * logp * w)
        per_el = self._apply_mask(per_el, mask)
        return self._sum_per_example(per_el)


_BY_NAME = {"mcxent": LossMCXENT, "negativeloglikelihood": LossMCXENT}


def loss_from_name(name: str, **kwargs) -> ILossFunction:
    try:
        cls = _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; ported: "
                         f"{sorted(_BY_NAME)}") from None
    return cls(**kwargs)
