"""Extended layers: layer normalization and the time-distributed wrapper.

Counterpart of the two classes of ``deeplearning4j_tpu/nn/conf/layers_ext.py``
that the self-attention encoder uses (``LayerNormalization``,
``TimeDistributed``); ``nn/conf/layers.py`` re-exports them, as the JAX
package's does. Sequence activations are ``[B, T, F]``.
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

    def apply(self, params, x, state, training=False):
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

    def apply(self, params, x, state, training=False):
        b, t, f = x.shape
        out, st = self.layer.apply(params, x.reshape(b * t, f), state,
                                   training)
        return out.reshape(b, t, -1), st

    @property
    def has_params(self):
        return self.layer.has_params
