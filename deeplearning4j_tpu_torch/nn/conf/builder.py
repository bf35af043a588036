"""Network configuration builder: global defaults that cascade onto layers.

Counterpart of ``deeplearning4j_tpu/nn/conf/builder.py``
(``NeuralNetConfiguration.builder()`` → ``GlobalConf``). The list builder
and ``MultiLayerConfiguration`` arrive with ``MultiLayerNetwork``; the graph
builder (``nn/graph.py``) takes a ``Builder`` here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ...learning.updaters import GradientUpdater, Sgd
from . import layers as L


@dataclass
class GlobalConf:
    seed: int = 12345
    updater: GradientUpdater = field(default_factory=lambda: Sgd(1e-1))
    weight_init: str = "xavier"
    activation: str = "identity"
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    dtype: str = "float32"                 # parameter storage dtype
    # Mixed precision: forward compute dtype (e.g. "bfloat16") while the
    # parameters stay in `dtype`; BN running stats stay float32.
    compute_dtype: Optional[str] = None
    # Fused inference epilogue (ops/epilogue): inference BatchNormalization
    # + relu/identity run as one kernel, and ComputationGraph also fuses
    # the resnet block tail BN(identity) → ElementWiseVertex(add) → relu
    # into one BN+residual+relu launch. Opt-in (the folded affine
    # reassociates the dense ops); gated per call with a dense fallback,
    # counted under precision/epilogue_*.
    fused_epilogue: bool = False
    # Fused weight update (ops/update): parameters, gradients and updater
    # state live in Zero1Plan per-dtype flat buckets and the updater runs
    # as one kernel launch per float32 bucket instead of per leaf. Needs an
    # elementwise updater (falls back to the per-leaf path, counted under
    # precision/fused_fallbacks, otherwise). Composes with
    # updater.state_dtype (bf16 moments, stochastic rounding).
    fused_update: bool = False
    # The JAX package's switch between gradients born flat and a dense
    # gradient tree flattened before the update (the two give the same
    # bits). Kept for configuration parity; the port does not read it: with
    # fused_update on, each parameter's .grad is always a view of one flat
    # gradient bucket, so autograd accumulates straight into the layout the
    # kernel reads.
    flat_backward: bool = True
    # Gradient normalization/clipping between the backward and the update
    # (nn/gradnorm.py); None leaves the gradients as they are.
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0


class NeuralNetConfiguration:
    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self) -> None:
        self._conf = GlobalConf()

    def seed(self, s: int) -> "Builder":
        self._conf.seed = int(s)
        return self

    def updater(self, u: GradientUpdater) -> "Builder":
        self._conf.updater = u
        return self

    def weight_init(self, w: str) -> "Builder":
        self._conf.weight_init = w
        return self

    def activation(self, a: str) -> "Builder":
        self._conf.activation = a
        return self

    def l1(self, v: float) -> "Builder":
        self._conf.l1 = v
        return self

    def l2(self, v: float) -> "Builder":
        self._conf.l2 = v
        return self

    def dropout(self, v: float) -> "Builder":
        self._conf.dropout = v
        return self

    def gradient_normalization(self, mode: str,
                               threshold: float = 1.0) -> "Builder":
        """Normalize or clip the gradients before each update (the modes
        of nn/gradnorm.normalize_gradients_)."""
        self._conf.grad_normalization = mode
        self._conf.grad_norm_threshold = threshold
        return self

    def data_type(self, dtype: str) -> "Builder":
        self._conf.dtype = dtype
        return self

    def compute_dtype(self, dtype: str) -> "Builder":
        self._conf.compute_dtype = dtype
        return self

    def fused_update(self, v: bool = True) -> "Builder":
        """Apply the updater over flat per-dtype buckets, one fused kernel
        launch per float32 bucket (ops/update); see
        GlobalConf.fused_update."""
        self._conf.fused_update = bool(v)
        return self

    def fused_epilogue(self, v: bool = True) -> "Builder":
        """Fuse inference BN + relu (+ the graph residual add) into one
        epilogue kernel (ops/epilogue); see GlobalConf.fused_epilogue."""
        self._conf.fused_epilogue = bool(v)
        return self


def apply_layer_defaults(l: L.Layer, gc: GlobalConf) -> None:
    """Cascade global defaults onto a layer, and onto the layer a wrapper
    (``TimeDistributed``) holds."""
    if l.activation is None and not isinstance(l, L.OutputLayer):
        l.activation = gc.activation
    if l.weight_init is None:
        l.weight_init = gc.weight_init
    if isinstance(l, L.BatchNormalization) and l.fused_epilogue is None:
        l.fused_epilogue = gc.fused_epilogue
    if l.l1 is None:
        l.l1 = gc.l1
    if l.l2 is None:
        l.l2 = gc.l2
    if l.dropout is None:
        l.dropout = gc.dropout
    inner = getattr(l, "layer", None)
    if isinstance(inner, L.Layer):
        apply_layer_defaults(inner, gc)
