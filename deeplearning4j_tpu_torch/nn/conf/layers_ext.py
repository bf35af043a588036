"""Extended layers: layer normalization, the time-distributed wrapper and
the parameter constraints.

Counterpart of the classes of ``deeplearning4j_tpu/nn/conf/layers_ext.py``
that the self-attention encoder and ``MultiLayerNetwork`` use
(``LayerNormalization``, ``TimeDistributed``, and ``MaxNormConstraint``,
``MinMaxNormConstraint``, ``NonNegativeConstraint``,
``UnitNormConstraint``, ``layers_ext.py:721-765``); ``nn/conf/layers.py``
re-exports them, as the JAX package's does. Sequence activations are
``[B, T, F]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ...ops import nn as ops
from .inputs import CNNInput, FFInput, RNNInput
from .layers import Layer


@dataclass
class LayerNormalization(Layer):
    """Feature-axis layer norm with learned ``gain``/``bias``: FF [B, F] and
    RNN [B, T, F] over F, CNN [B, C, H, W] over C.

    On CNN input the port diverges from the JAX code on purpose. Both
    normalize over C, and both document gain and bias along C. The JAX
    layer passes its ``[C]`` vectors unreshaped to ``layer_norm(axis=1)``
    (``deeplearning4j_tpu/nn/conf/layers_ext.py:540-543``), where they
    broadcast against the last axis, W: a ``[B, C, H, W]`` input with
    W != C fails there, and with W == C the gain scales along W. The port
    reshapes them to ``[1, C, 1, 1]`` and applies them along C, as the
    documentation says; its tests hold this path to a numpy oracle, not to
    the JAX output."""

    eps: float = 1e-3

    def set_input_type(self, input_type):
        if isinstance(input_type, (FFInput, RNNInput)):
            self.n_in = input_type.size
        elif isinstance(input_type, CNNInput):
            self.n_in = input_type.channels
        else:
            raise ValueError("LayerNormalization needs FF/RNN/CNN input")
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"gain": torch.ones((self.n_in,), dtype=dtype, device=device),
                "bias": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        if x.ndim == 4:
            shape = (1, -1, 1, 1)
            gain, bias = (params[k].reshape(shape) for k in ("gain", "bias"))
            return ops.layer_norm(x, gain, bias, axis=1,
                                  epsilon=self.eps), state
        return ops.layer_norm(x, params["gain"], params["bias"], axis=-1,
                              epsilon=self.eps), state


@dataclass
class TimeDistributed(Layer):
    """Applies a feed-forward layer at every timestep of RNN input: [B, T, F]
    is flattened to [B*T, F] and back. The parameters are the inner
    layer's."""

    layer: Optional[Layer] = None

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("TimeDistributed needs RNN input")
        inner_out = self.layer.set_input_type(FFInput(input_type.size))
        self.n_in = input_type.size
        return RNNInput(inner_out.size, input_type.timesteps)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def init_state(self, device=None):
        return self.layer.init_state(device)

    def apply(self, params, x, state, training=False, *, generator=None):
        b, t, f = x.shape
        out, st = self.layer.apply(params, x.reshape(b * t, f), state,
                                   training, generator=generator)
        return out.reshape(b, t, -1), st

    @property
    def has_params(self):
        return self.layer.has_params


# --- parameter constraints ------------------------------------------------------


class ParamConstraint:
    """A projection of a weight after each update (``MultiLayerNetwork``
    applies it to every parameter but biases and normalization
    parameters)."""

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


def _norms(w: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(w), dim=axis, keepdim=True))


class MaxNormConstraint(ParamConstraint):
    def __init__(self, max_norm: float, axis: int = 0):
        self.max_norm = max_norm
        self.axis = axis

    def apply(self, w):
        scale = torch.clamp(self.max_norm / torch.clamp_min(
            _norms(w, self.axis), 1e-12), max=1.0)
        return w * scale


class MinMaxNormConstraint(ParamConstraint):
    def __init__(self, min_norm: float, max_norm: float, axis: int = 0):
        self.min_norm, self.max_norm, self.axis = min_norm, max_norm, axis

    def apply(self, w):
        norms = _norms(w, self.axis)
        clipped = torch.clamp(norms, self.min_norm, self.max_norm)
        return w * clipped / torch.clamp_min(norms, 1e-12)


class NonNegativeConstraint(ParamConstraint):
    def apply(self, w):
        return torch.clamp_min(w, 0.0)


class UnitNormConstraint(ParamConstraint):
    def __init__(self, axis: int = 0):
        self.axis = axis

    def apply(self, w):
        return w / torch.clamp_min(_norms(w, self.axis), 1e-12)
