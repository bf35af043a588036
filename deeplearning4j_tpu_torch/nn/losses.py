"""Loss functions (the ``ILossFunction`` contract).

Counterpart of ``deeplearning4j_tpu/nn/losses.py`` (reference nd4j-api
``org.nd4j.linalg.lossfunctions.impl.*``): a loss computes a per-example
score from (labels, pre-output, activation) with optional label weights and
a per-example or per-step mask, and owns applying the output activation.
The gradient comes from autograd through the whole network. All 15 classes
of the JAX package, each expression in its order: ``LossMCXENT`` (on the
logits through ``log_softmax`` when the activation is softmax),
``LossSparseMCXENT``, ``LossBinaryXENT`` (the stable form on the logits
under sigmoid), ``LossMSE``, ``LossL2``, ``LossMAE``, ``LossL1``,
``LossHinge``, ``LossSquaredHinge``, ``LossKLD``, ``LossPoisson``,
``LossCosineProximity``, ``LossWasserstein``, and the two that carry their
own reductions, ``LossFMeasure`` (a batch-level soft F-beta, broadcast per
example) and ``LossMixtureDensity`` (the mixture NLL through
``logsumexp``). ``loss_from_name`` takes the JAX package's names.

The JAX package's Python-float constants are weak scalars that round to
float32 once against float32 arrays; PyTorch rounds a Python scalar the
same way. A division by an output width goes through a 0-dim tensor
(:func:`_div`): on the card PyTorch turns division by a Python scalar into
a multiplication by its reciprocal.
"""

from __future__ import annotations

import math

import torch

from .activations import activation_fn

_EPS = 1e-7


class ILossFunction:
    name = "base"

    def score_array(self, labels, pre_output, activation: str, mask=None):
        """Per-example loss ``[batch]``."""
        raise NotImplementedError

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
        w = _as(self.weights, logp) if self.weights is not None else 1.0
        per_el = -(labels * logp * w)
        per_el = self._apply_mask(per_el, mask)
        return self._sum_per_example(per_el)


class LossSparseMCXENT(LossMCXENT):
    name = "sparse_mcxent"

    def score_array(self, labels, pre_output, activation: str = "softmax",
                    mask=None):
        logp = torch.log_softmax(pre_output, dim=-1)
        idx = labels.to(torch.int32)
        if idx.ndim == pre_output.ndim:  # [..., 1]
            idx = idx[..., 0]
        per = -torch.gather(logp, -1, idx[..., None].long())[..., 0]
        per = self._apply_mask(per, mask)
        return self._sum_per_example(per)


class LossBinaryXENT(ILossFunction):
    name = "binary_xent"

    def __init__(self, weights=None, clip_eps: float = 1e-5):
        self.weights = weights
        self.eps = clip_eps

    def score_array(self, labels, pre_output, activation: str = "sigmoid",
                    mask=None):
        if activation.lower() == "sigmoid":
            # stable form on the logits
            x = pre_output
            per_el = torch.clamp_min(x, 0) - x * labels + torch.log1p(
                torch.exp(-torch.abs(x)))
        else:
            p = torch.clamp(self._activate(pre_output, activation), self.eps,
                            1 - self.eps)
            per_el = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
        if self.weights is not None:
            per_el = per_el * _as(self.weights, per_el)
        per_el = self._apply_mask(per_el, mask)
        return self._sum_per_example(per_el)


class LossMSE(ILossFunction):
    name = "mse"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = self._apply_mask(torch.square(labels - out), mask)
        # the reference LossMSE divides by nOut (mean over output dims)
        return _div(self._sum_per_example(per_el), _n_out(per_el))


class LossL2(ILossFunction):
    name = "l2"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = self._apply_mask(torch.square(labels - out), mask)
        return self._sum_per_example(per_el)


class LossMAE(ILossFunction):
    name = "mae"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = self._apply_mask(torch.abs(labels - out), mask)
        return _div(self._sum_per_example(per_el), _n_out(per_el))


class LossL1(ILossFunction):
    name = "l1"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = self._apply_mask(torch.abs(labels - out), mask)
        return self._sum_per_example(per_el)


class LossHinge(ILossFunction):
    name = "hinge"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        signed = 2.0 * labels - 1.0
        per_el = self._apply_mask(torch.clamp_min(1.0 - signed * out, 0.0),
                                  mask)
        return self._sum_per_example(per_el)


class LossSquaredHinge(ILossFunction):
    name = "squared_hinge"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        signed = 2.0 * labels - 1.0
        per_el = self._apply_mask(
            torch.square(torch.clamp_min(1.0 - signed * out, 0.0)), mask)
        return self._sum_per_example(per_el)


class LossKLD(ILossFunction):
    name = "kld"

    def score_array(self, labels, pre_output, activation: str = "softmax",
                    mask=None):
        p = torch.clamp(self._activate(pre_output, activation), _EPS, 1.0)
        lab = torch.clamp(labels, _EPS, 1.0)
        per_el = self._apply_mask(labels * (torch.log(lab) - torch.log(p)),
                                  mask)
        return self._sum_per_example(per_el)


class LossPoisson(ILossFunction):
    name = "poisson"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = out - labels * torch.log(torch.clamp_min(out, _EPS))
        per_el = self._apply_mask(per_el, mask)
        return self._sum_per_example(per_el)


class LossCosineProximity(ILossFunction):
    name = "cosine_proximity"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        ln = labels / torch.clamp_min(_norm(labels), _EPS)
        on = out / torch.clamp_min(_norm(out), _EPS)
        per = -torch.sum(ln * on, dim=-1)
        if mask is not None:
            per = per * mask
        if per.ndim > 1:
            per = torch.sum(per, dim=tuple(range(1, per.ndim)))
        return per


class LossWasserstein(ILossFunction):
    name = "wasserstein"

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        out = self._activate(pre_output, activation)
        per_el = self._apply_mask(labels * out, mask)
        return _div(self._sum_per_example(per_el), _n_out(per_el))


class LossFMeasure(ILossFunction):
    """Differentiable (soft) F-beta on binary outputs: batch-level, not
    decomposable, so ``score_array`` returns the batch value broadcast per
    example (the mean recovers 1 - F)."""

    name = "fmeasure"

    def __init__(self, beta: float = 1.0):
        self.beta = beta

    def score_array(self, labels, pre_output, activation: str = "sigmoid",
                    mask=None):
        out = self._activate(pre_output, activation)
        if out.ndim > 1 and out.shape[-1] == 2:  # two-column one-hot form
            out = out[..., 1]
            labels = labels[..., 1]
        if mask is not None:
            out = out * mask
            labels = labels * mask
        tp = torch.sum(labels * out)
        fp = torch.sum((1 - labels) * out)
        fn = torch.sum(labels * (1 - out))
        b2 = self.beta ** 2
        f = (1 + b2) * tp / torch.clamp_min((1 + b2) * tp + b2 * fn + fp,
                                            _EPS)
        n = labels.shape[0]
        return (1.0 - f).expand(n)


class LossMixtureDensity(ILossFunction):
    """Mixture density network NLL: the pre-output packs [alpha(K),
    sigma(K), mu(K*L)] per example; the labels are [L]."""

    name = "mixture_density"

    def __init__(self, mixtures: int, labels_width: int):
        self.k = mixtures
        self.l = labels_width  # noqa: E741 (the JAX package's field name)

    def score_array(self, labels, pre_output, activation: str = "identity",
                    mask=None):
        k, lw = self.k, self.l
        alpha = torch.softmax(pre_output[..., :k], dim=-1)
        sigma = torch.exp(pre_output[..., k:2 * k])
        mu = pre_output[..., 2 * k:2 * k + k * lw].reshape(
            pre_output.shape[:-1] + (k, lw))
        diff = labels[..., None, :] - mu                     # [..., K, L]
        sq = torch.sum(torch.square(diff), dim=-1)           # [..., K]
        log_comp = (torch.log(alpha + _EPS)
                    - lw * torch.log(sigma + _EPS)
                    - 0.5 * lw * math.log(2 * math.pi)
                    - sq / (2.0 * torch.square(sigma)))
        per = -torch.logsumexp(log_comp, dim=-1)
        if mask is not None:
            per = per * mask
        if per.ndim > 1:
            per = torch.sum(per, dim=tuple(range(1, per.ndim)))
        return per


def _as(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def _n_out(per_el) -> int:
    return per_el.shape[-1] if per_el.ndim > 1 else 1


def _div(x: torch.Tensor, n) -> torch.Tensor:
    """``x / n`` as a true division (see the module docstring)."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The l2 norm over the last axis, kept (``jnp.linalg.norm``'s
    ``sqrt(sum(x * x))``)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


_BY_NAME = {
    "mcxent": LossMCXENT, "sparse_mcxent": LossSparseMCXENT,
    "negativeloglikelihood": LossMCXENT,  # reference alias
    "binary_xent": LossBinaryXENT, "xent": LossBinaryXENT,
    "mse": LossMSE, "squared_loss": LossMSE, "l2": LossL2,
    "mae": LossMAE, "l1": LossL1,
    "hinge": LossHinge, "squared_hinge": LossSquaredHinge,
    "kl_divergence": LossKLD, "kld": LossKLD,
    "poisson": LossPoisson, "cosine_proximity": LossCosineProximity,
    "wasserstein": LossWasserstein, "fmeasure": LossFMeasure,
}


def loss_from_name(name: str, **kwargs) -> ILossFunction:
    try:
        cls = _BY_NAME[name.lower()]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; known: "
                         f"{sorted(_BY_NAME)}") from None
    return cls(**kwargs)
