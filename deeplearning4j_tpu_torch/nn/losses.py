"""Loss functions, held as configuration.

Counterpart of ``deeplearning4j_tpu/nn/losses.py``. The inference slice only
needs ``OutputLayer`` to carry its loss as data (``loss_from_name("mcxent")``);
scoring and the other losses arrive with the training slice.
"""

from __future__ import annotations


class ILossFunction:
    name = "base"

    def compute_score(self, labels, pre_output, activation: str, mask=None,
                      average: bool = True):
        raise NotImplementedError(
            f"loss {self.name!r}: scoring is not ported yet (training slice)")


class LossMCXENT(ILossFunction):
    """Multi-class cross-entropy (expects softmax activation)."""

    name = "mcxent"

    def __init__(self, weights=None, softmax_clip_eps: float = 1e-10):
        self.weights = weights
        self.eps = softmax_clip_eps


_BY_NAME = {"mcxent": LossMCXENT, "negativeloglikelihood": LossMCXENT}


def loss_from_name(name: str, **kwargs) -> ILossFunction:
    try:
        cls = _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; ported: "
                         f"{sorted(_BY_NAME)}") from None
    return cls(**kwargs)
