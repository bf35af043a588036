"""Layer configurations + their runtime.

Counterpart of the core classes of ``deeplearning4j_tpu/nn/conf/layers.py``:
each dataclass carries its configuration fields plus ``init_params`` and
``apply(params, x, state, training) -> (y, new_state)`` on tensors.
Parameter layouts are the JAX package's, so parameters carry across by name
and shape: dense W=[nIn,nOut] applied as ``x @ W``, conv W=[out,in,kH,kW]
(OIHW), bias=[nOut]; BatchNormalization keeps ``gamma``/``beta`` as
parameters and ``mean``/``var`` (float32) as state; embedding tables
W=[vocab, nOut]; self-attention Wq/Wk/Wv=[nIn, H*hs] and Wo=[H*hs, nOut].
``LayerNormalization`` and ``TimeDistributed`` live in ``layers_ext`` and
are reachable from here, as in the JAX package.

Training mode: BatchNormalization normalizes with batch statistics
(``ops/nn.batchnorm_train``) and returns the updated running statistics.
Dense, Output, Convolution and SelfAttention layers apply inverted dropout
to their input where the JAX package's ``_maybe_dropout`` does
(``layers.py:102-108``), with bits from the ``generator`` keyword (the
network's own ``torch.Generator``); ``DropoutLayer`` drops at its ``rate``.
The embedding layers never apply their dropout. Otherwise the layers
compute as in inference, with autograd taking the backward.

``apply_masked(params, x, state, training, fmask)`` is the forward with a
``[B, T]`` feature mask (1 = a real step), as ``MultiLayerNetwork`` calls
it: mask-oblivious layers ignore the mask; ``GlobalPoolingLayer`` leaves
padded steps out of its pooling and ``SelfAttentionLayer`` masks the
attention keys.

The recurrent layers (``LSTM``, ``GravesLSTM``, ``GRU`` in both forms,
``SimpleRnn``) run the ops of ``ops/recurrent.py`` over ``[B, T, F]``. With
a feature mask their outputs at padded steps are zeroed; their carry does
not stop there, as in the JAX package. ``is_rnn``, ``init_rnn_state`` and
``apply_rnn`` carry the state across time chunks (truncated BPTT and
``MultiLayerNetwork.rnn_time_step``). ``Bidirectional`` runs its layer
forward and on the reversed sequence (parameters ``{"fwd": {...}, "bwd":
{...}}``), ``LastTimeStep`` keeps its layer's last step, and
``RnnOutputLayer`` is the dense head at every step.

``constraints`` (``layers_ext.MaxNormConstraint`` and kin) are projections
that ``MultiLayerNetwork`` applies to the weights after each update;
``weight_noise`` (``layers_ext.DropConnect``, ``WeightNoise``) perturbs the
layer's parameters before its ``apply`` in training.

``FrozenLayer`` wraps a layer whose parameters take no update (transfer
learning); ``PReLULayer``, ``ElementWiseMultiplicationLayer``,
``LearnedSelfAttentionLayer`` (learned queries) and
``RecurrentAttentionLayer`` (a Python loop over the steps, each attending
over the whole input) complete the JAX module's classes.

The convolution family takes ``convolution_mode="same"`` (TF's SAME
padding, output ``ceil(in / stride)``; ``ops/nn.same_pads``) or
``"truncate"`` with explicit padding: ``ConvolutionLayer``,
``Deconvolution2D`` (W ``[I, O, kH, kW]``), ``DepthwiseConvolution2D`` (W
``[mult, C, kH, kW]``), ``SeparableConvolution2D`` (``dW`` depthwise,
``pW`` ``[O, C * mult, 1, 1]`` pointwise) and ``SubsamplingLayer`` (max,
average, p-norm). The loss heads (``OutputLayer``, ``LossLayer`` and, in
``layers_ext``, ``CenterLossOutputLayer`` and ``Yolo2OutputLayer``) carry
``compute_score(params, x, labels, mask, average)``, the score of the
head's input ``x``.

:func:`dropout_rate_override` replaces the input-dropout rate of every
layer whose dropout is on, for the forwards run inside it on this thread
(a fleet member's swept ``dropout``, ``parallel/fleet.py``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ...ops import epilogue as _epilogue
from ...ops import nn as ops
from ...ops import recurrent as rnn_ops
from ..activations import activation_fn
from ..losses import ILossFunction, LossMCXENT, loss_from_name
from ...common.tree import ShardedTensor, tree_map
from ..weights import init_weights

# the input-dropout rate that dropout_rate_override installs (None: each
# layer's own), per thread
_DROPOUT_OVERRIDE = threading.local()


@contextlib.contextmanager
def dropout_rate_override(rate: float):
    """Within the block, every layer whose input dropout is on drops at
    ``rate`` instead of its own (``layers.py:53-63`` of the JAX package);
    layers without dropout stay without."""
    prev = getattr(_DROPOUT_OVERRIDE, "rate", None)
    _DROPOUT_OVERRIDE.rate = float(rate)
    try:
        yield
    finally:
        _DROPOUT_OVERRIDE.rate = prev
from .inputs import CNN3DInput, CNNInput, FFInput, InputType, RNNInput


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same(layer) -> bool:
    """Whether the layer's ``convolution_mode`` is SAME (else truncate)."""
    mode = str(layer.convolution_mode).lower()
    if mode not in ("same", "truncate"):
        raise ValueError(f"{type(layer).__name__}: convolution_mode "
                         f"{layer.convolution_mode!r} is 'truncate' or "
                         f"'same'")
    return mode == "same"


@dataclass
class Layer:
    """Base layer config. Fields that default to None inherit the network's
    global defaults (``apply_layer_defaults``)."""

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    n_in: Optional[int] = None
    # post-update weight projections (layers_ext.ParamConstraint)
    constraints: Optional[list] = None
    # training-time parameter noise (layers_ext.IWeightNoise), applied by
    # MultiLayerNetwork before apply
    weight_noise: Optional[Any] = None

    def set_input_type(self, input_type: InputType) -> InputType:
        """Infer nIn from the incoming type; return this layer's output type."""
        return input_type

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, params, x, state, training: bool = False, *,
              generator: Optional[torch.Generator] = None):
        raise NotImplementedError

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator: Optional[torch.Generator] = None):
        """Forward with a ``[B, T]`` feature mask; mask-oblivious layers
        ignore it."""
        return self.apply(params, x, state, training, generator=generator)

    def _maybe_dropout(self, x, training: bool,
                       generator: Optional[torch.Generator]):
        """Inverted dropout of the layer's input at rate ``dropout``, in
        training only (``ops/nn.dropout``)."""
        if training and self.dropout and self.dropout > 0.0:
            rate = getattr(_DROPOUT_OVERRIDE, "rate", None)
            return ops.dropout(x, self.dropout if rate is None else rate,
                               generator)
        return x

    @property
    def has_params(self) -> bool:
        return True

    # -- the recurrent carry of truncated BPTT and rnn_time_step --------
    def is_rnn(self) -> bool:
        return False

    def init_rnn_state(self, batch: int, dtype=torch.float32, device=None):
        """The zero carry of :meth:`apply_rnn`; None for a stateless
        layer."""
        return None

    def apply_rnn(self, params, x, rnn_state, state, training=False, *,
                  generator: Optional[torch.Generator] = None):
        """Forward one time chunk from an explicit recurrent carry:
        ``(y, new_rnn_state, new_state)``."""
        y, st = self.apply(params, x, state, training, generator=generator)
        return y, rnn_state, st


@dataclass
class DenseLayer(Layer):
    n_out: int = 0
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, FFInput):
            raise ValueError(f"DenseLayer needs FF input, got {input_type}")
        self.n_in = input_type.size
        return FFInput(self.n_out)

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.n_in, self.n_out),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def pre_output(self, params, x):
        return ops.linear(x, params["W"], params.get("b"))

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return activation_fn(self.activation or "identity")(
            self.pre_output(params, x)), state


@dataclass
class ConvolutionLayer(Layer):
    """2D convolution, SAME or with explicit padding. W=[out,in,kH,kW]."""

    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    convolution_mode: str = "truncate"   # truncate | same
    has_bias: bool = True

    def _padding(self):
        return "SAME" if _same(self) else self.padding

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError(f"{type(self).__name__} needs CNN input, got "
                             f"{input_type}")
        self.n_in = input_type.channels
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        if _same(self):
            return CNNInput(self.n_out, -(-input_type.height // sh),
                            -(-input_type.width // sw))
        ph, pw = _pair(self.padding)
        oh = (input_type.height + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
        ow = (input_type.width + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
        return CNNInput(self.n_out, oh, ow)

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(gen, (self.n_out, self.n_in, kh, kw),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        out = ops.conv2d(x, params["W"], params.get("b"),
                         strides=self.stride, padding=self._padding(),
                         dilation=self.dilation)
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution, W=[in,out,kH,kW]; under SAME the output is
    input x stride (``ops/nn.deconv2d``)."""

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError("Deconvolution2D needs CNN input")
        self.n_in = input_type.channels
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if _same(self):
            return CNNInput(self.n_out, input_type.height * sh,
                            input_type.width * sw)
        ph, pw = _pair(self.padding)
        return CNNInput(self.n_out, sh * (input_type.height - 1) + kh - 2 * ph,
                        sw * (input_type.width - 1) + kw - 2 * pw)

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(gen, (self.n_in, self.n_out, kh, kw),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        out = ops.deconv2d(x, params["W"], params.get("b"),
                           strides=self.stride, padding=self._padding())
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class DepthwiseConvolution2D(ConvolutionLayer):
    """Depthwise convolution, W=[mult,C,kH,kW]: C * mult output channels,
    channel ``c * mult + m`` from input channel c (``ops/nn.
    depthwise_conv2d``)."""

    depth_multiplier: int = 1

    def set_input_type(self, input_type):
        out_type = ConvolutionLayer.set_input_type(self, input_type)
        return CNNInput(self.n_in * self.depth_multiplier, out_type.height,
                        out_type.width)

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(gen, (self.depth_multiplier, self.n_in, kh, kw),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_in * self.depth_multiplier,),
                                 dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        out = ops.depthwise_conv2d(x, params["W"], params.get("b"),
                                   strides=self.stride,
                                   padding=self._padding(),
                                   dilation=self.dilation)
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise (``dW`` [mult,C,kH,kW]) then pointwise (``pW``
    [out,C*mult,1,1]) convolution, then the bias (``ops/nn.sconv2d``; the
    dilation is not applied, as in the JAX layer)."""

    depth_multiplier: int = 1

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        wi = self.weight_init or "xavier"
        mult = self.depth_multiplier
        p = {"dW": init_weights(gen, (mult, self.n_in, kh, kw), wi, dtype,
                                device=device),
             "pW": init_weights(gen, (self.n_out, self.n_in * mult, 1, 1),
                                wi, dtype, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        out = ops.sconv2d(x, params["dW"], params["pW"], params.get("b"),
                          strides=self.stride, padding=self._padding())
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class SubsamplingLayer(Layer):
    """Max, average or p-norm pooling, SAME or with explicit padding
    (``ops/nn.maxpool2d``, ``avgpool2d``, ``pnormpool2d``)."""

    pooling_type: str = "max"
    kernel_size: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (2, 2)
    padding: Tuple[int, int] = (0, 0)
    convolution_mode: str = "truncate"   # truncate | same
    pnorm: int = 2

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError("SubsamplingLayer needs CNN input")
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if _same(self):
            return CNNInput(input_type.channels, -(-input_type.height // sh),
                            -(-input_type.width // sw))
        ph, pw = _pair(self.padding)
        oh = (input_type.height + 2 * ph - kh) // sh + 1
        ow = (input_type.width + 2 * pw - kw) // sw + 1
        return CNNInput(input_type.channels, oh, ow)

    def apply(self, params, x, state, training=False, *, generator=None):
        pad = "SAME" if _same(self) else self.padding
        kind = self.pooling_type.lower()
        if kind == "max":
            out = ops.maxpool2d(x, self.kernel_size, self.stride, pad)
        elif kind in ("avg", "average"):
            out = ops.avgpool2d(x, self.kernel_size, self.stride, pad)
        elif kind == "pnorm":
            out = ops.pnormpool2d(x, self.kernel_size, self.stride, pad,
                                  pnorm=self.pnorm)
        else:
            raise ValueError(f"unknown pooling type {self.pooling_type!r}")
        return out, state

    @property
    def has_params(self):
        return False


@dataclass
class BatchNormalization(Layer):
    """Per-channel normalization with running mean/var state and trainable
    gamma/beta."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    # Fused inference epilogue (ops/epilogue): BN + relu/identity in one
    # kernel. None → inherit GlobalConf.fused_epilogue (cascaded by
    # apply_layer_defaults). Opt-in: the folded affine reassociates the
    # dense ops (tolerance-bounded, not bitwise).
    fused_epilogue: Optional[bool] = None

    def set_input_type(self, input_type):
        if isinstance(input_type, CNNInput):
            self.n_in = input_type.channels
        elif isinstance(input_type, FFInput):
            self.n_in = input_type.size
        else:
            raise ValueError("BatchNormalization needs FF or CNN input")
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": torch.ones((self.n_in,), dtype=dtype, device=device),
                "beta": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def init_state(self, device=None):
        return {"mean": torch.zeros((self.n_in,), dtype=torch.float32,
                                    device=device),
                "var": torch.ones((self.n_in,), dtype=torch.float32,
                                  device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        gamma, beta = params.get("gamma"), params.get("beta")
        axis = 1 if x.ndim == 4 else -1
        if training:
            # batch statistics with the hand backward; never fused. The
            # running statistics stay float32: (1 - decay) is a Python
            # float, rounded once
            out, mean, var = ops.batchnorm_train(
                x, gamma, beta, epsilon=self.eps, axis=axis,
                pivot=state["mean"])
            new_state = {
                "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                "var": self.decay * state["var"] + (1 - self.decay) * var}
            return activation_fn(self.activation or "identity")(out), \
                new_state
        mean, var = state["mean"], state["var"]
        if self.fused_epilogue:
            fused = _epilogue.bn_act(x, mean, var, gamma, beta,
                                     epsilon=self.eps, axis=axis,
                                     act=self.activation)
            if fused is not None:
                return fused, state
        out = ops.batchnorm(x, mean.to(x.dtype), var.to(x.dtype), gamma,
                            beta, epsilon=self.eps, axis=axis)
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class LocalResponseNormalization(Layer):
    """``x / (k + alpha * sum(x^2 over n channels))^beta`` (DL4J's alpha,
    on the window sum without Caffe's ``/ n``; ``ops/nn.lrn``)."""

    n: int = 5
    k: float = 2.0
    alpha: float = 1e-4
    beta: float = 0.75

    def apply(self, params, x, state, training=False, *, generator=None):
        return ops.lrn(x, depth=self.n, bias=self.k, alpha=self.alpha,
                       beta=self.beta), state

    @property
    def has_params(self):
        return False


@dataclass
class DropoutLayer(Layer):
    """Inverted dropout at ``rate`` in training, the identity otherwise."""

    rate: float = 0.5

    def apply(self, params, x, state, training=False, *, generator=None):
        if training and self.rate > 0:
            return ops.dropout(x, self.rate, generator), state
        return x, state

    @property
    def has_params(self):
        return False


@dataclass
class ActivationLayer(Layer):
    # optional slope/shape parameter, forwarded to leakyrelu and elu
    alpha: Optional[float] = None

    def apply(self, params, x, state, training=False, *, generator=None):
        act = (self.activation or "identity").lower()
        if self.alpha is not None and act in ("leakyrelu", "elu"):
            return activation_fn(act)(x, alpha=self.alpha), state
        return activation_fn(act)(x), state

    @property
    def has_params(self):
        return False


@dataclass
class GlobalPoolingLayer(Layer):
    """Pools CNN spatial dims (2D or 3D), or the time dim of RNN input
    [B, T, F], down to FF: max, avg, sum or pnorm (the L2 norm, whatever
    ``pnorm`` the JAX package's SubsamplingLayer carries). With a feature
    mask (:meth:`apply_masked`) padded steps are left out."""

    pooling_type: str = "max"

    def set_input_type(self, input_type):
        if isinstance(input_type, (CNNInput, CNN3DInput)):
            return FFInput(input_type.channels)
        if isinstance(input_type, RNNInput):
            return FFInput(input_type.size)
        raise ValueError("GlobalPoolingLayer needs CNN/CNN3D/RNN input")

    def apply(self, params, x, state, training=False, *, generator=None):
        kind = self.pooling_type.lower()
        dims = {5: (2, 3, 4), 4: (2, 3)}.get(x.ndim, (1,))
        if kind == "max":
            out = torch.amax(x, dim=dims)
        elif kind in ("avg", "average"):
            out = ops.global_avgpool(x) if x.ndim == 4 else x.mean(dim=dims)
        elif kind == "sum":
            out = x.sum(dim=dims)
        elif kind == "pnorm":
            out = (x.abs() ** 2).sum(dim=dims) ** 0.5
        else:
            raise ValueError(f"unknown pooling {self.pooling_type!r}")
        return out, state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        """Time pooling of ``[B, T, F]`` without the padded steps
        (``layers.py:580-602`` of the JAX package); other input ignores
        the mask."""
        if x.ndim != 3:
            return self.apply(params, x, state, training)
        kind = self.pooling_type.lower()
        m = fmask[..., None].to(x.dtype)
        if kind == "max":
            neg = torch.tensor(torch.finfo(x.dtype).min, dtype=x.dtype,
                               device=x.device)
            out = torch.amax(torch.where(m > 0, x, neg), dim=1)
        elif kind in ("avg", "average"):
            out = (x * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1e-9)
        elif kind == "sum":
            out = (x * m).sum(dim=1)
        elif kind == "pnorm":
            out = ((x * m).abs() ** 2).sum(dim=1) ** 0.5
        else:
            raise ValueError(f"unknown pooling {self.pooling_type!r}")
        return out, state

    @property
    def has_params(self):
        return False


# --- recurrent ---------------------------------------------------------------


@dataclass
class _RecurrentLayer(Layer):
    """What LSTM, GRU and SimpleRnn share: RNN input, the forward from an
    optional carry (:meth:`_run`), outputs at padded steps zeroed under a
    feature mask, and the carry across time chunks."""

    n_out: int = 0

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError(f"{type(self).__name__} needs RNN input "
                             f"[B, T, F]")
        self.n_in = input_type.size
        return RNNInput(self.n_out, input_type.timesteps)

    def _run(self, params, x, carry):
        """``(outputs, final carry)`` from ``carry`` (None: zeros)."""
        raise NotImplementedError

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return self._run(params, x, None)[0], state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        y, st = self.apply(params, x, state, training, generator=generator)
        return y * fmask[:, :, None].to(y.dtype), st

    def is_rnn(self):
        return True

    def init_rnn_state(self, batch, dtype=torch.float32, device=None):
        return torch.zeros((batch, self.n_out), dtype=dtype, device=device)

    def apply_rnn(self, params, x, rnn_state, state, training=False, *,
                  generator=None):
        x = self._maybe_dropout(x, training, generator)
        ys, carry = self._run(params, x, rnn_state)
        return ys, carry, state


@dataclass
class LSTM(_RecurrentLayer):
    """The LSTM with the fused ``[nIn+nOut, 4*nOut]`` IFOG weight ``W`` and
    bias ``b`` (forget-gate bias 1). The cell always uses tanh; another
    configured activation (but identity) applies again to the outputs, as
    in the JAX layer."""

    def init_params(self, gen, dtype=torch.float32, device=None):
        w = init_weights(gen, (self.n_in + self.n_out, 4 * self.n_out),
                         self.weight_init or "xavier", dtype, device=device)
        b = torch.zeros((4 * self.n_out,), dtype=dtype, device=device)
        b[self.n_out:2 * self.n_out] = 1.0
        return {"W": w, "b": b}

    def _run(self, params, x, carry):
        h0, c0 = carry if carry is not None else (None, None)
        ys, carry = rnn_ops.lstm_layer(x, params["W"], params["b"], h0=h0,
                                       c0=c0)
        act = self.activation
        if act and act.lower() not in ("tanh", "identity"):
            ys = activation_fn(act)(ys)
        return ys, carry

    def init_rnn_state(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z)


@dataclass
class GravesLSTM(LSTM):
    """GravesLSTM without peepholes (deprecated upstream): the LSTM."""


@dataclass
class GRU(_RecurrentLayer):
    """The GRU: ``reset_after=False`` is the reference gruCell (the reset
    applies before the recurrent product; ``W_ru``, ``W_c`` over
    ``[x, h]``), ``reset_after=True`` the CuDNN/Keras form (``W_cx``,
    ``W_ch`` apart, the reset on the recurrent product)."""

    reset_after: bool = False

    def init_params(self, gen, dtype=torch.float32, device=None):
        wi = self.weight_init or "xavier"
        nx, n = self.n_in, self.n_out
        p = {"W_ru": init_weights(gen, (nx + n, 2 * n), wi, dtype,
                                  device=device),
             "b_ru": torch.zeros((2 * n,), dtype=dtype, device=device)}
        if self.reset_after:
            p["W_cx"] = init_weights(gen, (nx, n), wi, dtype, device=device)
            p["W_ch"] = init_weights(gen, (n, n), wi, dtype, device=device)
            p["b_cx"] = torch.zeros((n,), dtype=dtype, device=device)
            p["b_ch"] = torch.zeros((n,), dtype=dtype, device=device)
        else:
            p["W_c"] = init_weights(gen, (nx + n, n), wi, dtype,
                                    device=device)
            p["b_c"] = torch.zeros((n,), dtype=dtype, device=device)
        return p

    def _run(self, params, x, carry):
        if self.reset_after:
            return rnn_ops.gru_layer_ra(
                x, params["W_ru"], params["W_cx"], params["W_ch"],
                params["b_ru"], params["b_cx"], params["b_ch"], h0=carry)
        return rnn_ops.gru_layer(x, params["W_ru"], params["W_c"],
                                 params["b_ru"], params["b_c"], h0=carry)


@dataclass
class SimpleRnn(_RecurrentLayer):
    """``h_t = act(x_t W + h_{t-1} RW + b)`` with the configured activation
    (tanh when none) inside the recurrence."""

    def init_params(self, gen, dtype=torch.float32, device=None):
        wi = self.weight_init or "xavier"
        return {"W": init_weights(gen, (self.n_in, self.n_out), wi, dtype,
                                  device=device),
                "RW": init_weights(gen, (self.n_out, self.n_out), wi, dtype,
                                   device=device),
                "b": torch.zeros((self.n_out,), dtype=dtype, device=device)}

    def _run(self, params, x, carry):
        return rnn_ops.simple_rnn_layer(
            x, params["W"], params["RW"], params["b"], h0=carry,
            activation=activation_fn(self.activation or "tanh"))


@dataclass
class Bidirectional(Layer):
    """Runs ``layer`` forward and on the time-reversed sequence (its own
    parameters each, ``{"fwd": {...}, "bwd": {...}}``) and merges the two
    by ``mode``: concat, add, mul, or else the average. Neither the mask
    nor a carry reaches the wrapped layer, as in the JAX wrapper."""

    layer: Optional[Layer] = None
    mode: str = "concat"

    def set_input_type(self, input_type):
        out = self.layer.set_input_type(input_type)
        if self.mode.lower() == "concat":
            return RNNInput(out.size * 2, out.timesteps)
        return out

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"fwd": self.layer.init_params(gen, dtype, device),
                "bwd": self.layer.init_params(gen, dtype, device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        fwd, _ = self.layer.apply(params["fwd"], x, {}, training,
                                  generator=generator)
        bwd, _ = self.layer.apply(params["bwd"], torch.flip(x, dims=(1,)),
                                  {}, training, generator=generator)
        mode = self.mode.lower()
        if mode not in ("concat", "add", "mul"):
            mode = "average"
        return rnn_ops.merge_directions(fwd, torch.flip(bwd, dims=(1,)),
                                        mode), state


@dataclass
class LastTimeStep(Layer):
    """``layer`` over RNN input ``[B, T, F]``, then its last step: FF
    ``[B, F]``. Under a feature mask it still takes step ``T - 1``, as the
    JAX wrapper does."""

    layer: Optional[Layer] = None

    def set_input_type(self, input_type):
        return FFInput(self.layer.set_input_type(input_type).size)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def apply(self, params, x, state, training=False, *, generator=None):
        ys, state = self.layer.apply(params, x, state, training,
                                     generator=generator)
        return ys[:, -1], state


# --- shape layers on CNN input -----------------------------------------------


@dataclass
class Upsampling2D(Layer):
    """Each pixel repeated ``size`` times along H and W
    (``ops/nn.upsampling2d``)."""

    size: Tuple[int, int] = (2, 2)

    def set_input_type(self, input_type):
        fh, fw = _pair(self.size)
        return CNNInput(input_type.channels, input_type.height * fh,
                        input_type.width * fw)

    def apply(self, params, x, state, training=False, *, generator=None):
        return ops.upsampling2d(x, factor=_pair(self.size)), state

    @property
    def has_params(self):
        return False


@dataclass
class ZeroPaddingLayer(Layer):
    """Zero rows and columns around NCHW input: ``padding`` is (top,
    bottom, left, right)."""

    padding: Tuple[int, int, int, int] = (1, 1, 1, 1)

    def set_input_type(self, input_type):
        t, b, l, r = self.padding
        return CNNInput(input_type.channels, input_type.height + t + b,
                        input_type.width + l + r)

    def apply(self, params, x, state, training=False, *, generator=None):
        t, b, l, r = self.padding
        return torch.nn.functional.pad(x, (l, r, t, b)), state

    @property
    def has_params(self):
        return False


@dataclass
class Cropping2D(Layer):
    """Rows and columns cut off NCHW input: ``cropping`` is (top, bottom,
    left, right)."""

    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)

    def set_input_type(self, input_type):
        t, b, l, r = self.cropping
        return CNNInput(input_type.channels, input_type.height - t - b,
                        input_type.width - l - r)

    def apply(self, params, x, state, training=False, *, generator=None):
        t, b, l, r = self.cropping
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t:h - b, l:w - r], state

    @property
    def has_params(self):
        return False


@dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head; the loss is held as configuration."""

    loss: Union[str, ILossFunction, None] = None

    def __post_init__(self):
        if self.loss is None:
            self.loss = LossMCXENT()
        elif isinstance(self.loss, str):
            self.loss = loss_from_name(self.loss)
        if self.activation is None:
            self.activation = "softmax"

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return activation_fn(self.activation)(self.pre_output(params, x)), \
            state

    def compute_score(self, params, x, labels, mask=None,
                      average: bool = True):
        return self.loss.compute_score(labels, self.pre_output(params, x),
                                       self.activation, mask, average)


@dataclass
class RnnOutputLayer(OutputLayer):
    """The dense head and its loss at every step of RNN input ``[B, T, F]``
    (the product broadcasts over T)."""

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError(f"RnnOutputLayer needs RNN input, got "
                             f"{input_type}")
        self.n_in = input_type.size
        return RNNInput(self.n_out, input_type.timesteps)


@dataclass
class LossLayer(Layer):
    """A loss head without parameters: the score of its input under its
    activation (identity unless set) and loss (mcxent unless set)."""

    loss: Union[str, ILossFunction, None] = None

    def __post_init__(self):
        if self.loss is None:
            self.loss = LossMCXENT()
        elif isinstance(self.loss, str):
            self.loss = loss_from_name(self.loss)
        if self.activation is None:
            self.activation = "identity"

    def pre_output(self, params, x):
        return x

    def apply(self, params, x, state, training=False, *, generator=None):
        return activation_fn(self.activation)(x), state

    def compute_score(self, params, x, labels, mask=None,
                      average: bool = True):
        return self.loss.compute_score(labels, x, self.activation, mask,
                                       average)

    @property
    def has_params(self):
        return False


@dataclass
class SelfAttentionLayer(Layer):
    """Multi-head dot-product self-attention (Q = K = V = the input) over
    RNN input [B, T, F]. ``project_input=True`` learns Wq/Wk/Wv/Wo (required
    when n_heads > 1) and runs ``ops/nn.multi_head_dot_product_attention``,
    which takes flash attention where the gate allows; otherwise raw
    single-head dense attention over the input, with n_out = n_in. With a
    feature mask (:meth:`apply_masked`, ``MultiLayerNetwork``'s masked
    path) padded steps are masked as attention keys (the additive bias
    ``where(mask, 0, -1e9)`` of the flash kernel) and the outputs at padded
    steps are zeroed."""

    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("SelfAttentionLayer needs RNN input [B, T, F]")
        self.n_in = input_type.size
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads=1")
            self.n_out = self.n_in
        return RNNInput(self.n_out, input_type.timesteps)

    def _hs(self) -> int:
        return self.head_size or self.n_out // self.n_heads

    def init_params(self, gen, dtype=torch.float32, device=None):
        if not self.project_input:
            return {}
        width = self.n_heads * self._hs()
        wi = self.weight_init or "xavier"
        shapes = {"Wq": (self.n_in, width), "Wk": (self.n_in, width),
                  "Wv": (self.n_in, width), "Wo": (width, self.n_out)}
        return {k: init_weights(gen, shape, wi, dtype, device=device)
                for k, shape in shapes.items()}

    def _attend(self, params, q, kv, fmask):
        if self.project_input:
            return ops.multi_head_dot_product_attention(
                q, kv, kv, params["Wq"], params["Wk"], params["Wv"],
                params["Wo"], num_heads=self.n_heads, mask=fmask)
        m = fmask[:, None, :] if fmask is not None else None
        return ops.dot_product_attention(q, kv, kv, mask=m)

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return self._attend(params, x, x, None), state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        """Attend with the key mask, then ``y * fmask[:, :, None]``
        (``layers.py:860-865`` of the JAX package)."""
        x = self._maybe_dropout(x, training, generator)
        y = self._attend(params, x, x, fmask)
        return y * fmask[:, :, None].to(y.dtype), state

    @property
    def has_params(self):
        return self.project_input


@dataclass
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """``n_queries`` learned query vectors ``Q`` ``[n_queries, n_in]``
    attend over the sequence: the output is ``[B, n_queries, n_out]``
    whatever the input's length (``layers.py:871-912``). The attention op
    takes the route it picks for these shapes (dense unless ``n_queries``
    equals the sequence length)."""

    n_queries: int = 1

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("LearnedSelfAttentionLayer needs RNN input")
        self.n_in = input_type.size
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads=1")
            self.n_out = self.n_in
        return RNNInput(self.n_out, self.n_queries)

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"Q": init_weights(gen, (self.n_queries, self.n_in),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        p.update(super().init_params(gen, dtype, device))
        return p

    def _queries(self, params, x):
        return params["Q"][None].expand((x.shape[0],)
                                        + tuple(params["Q"].shape))

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return self._attend(params, self._queries(params, x), x,
                            None), state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        """The keys masked; the outputs are the learned queries', all
        real."""
        x = self._maybe_dropout(x, training, generator)
        return self._attend(params, self._queries(params, x), x,
                            fmask), state

    @property
    def has_params(self):
        return True


@dataclass
class RecurrentAttentionLayer(Layer):
    """``y_t = act(x_t Wx + a_t Wr + b)``, where ``a_t`` is multi-head
    attention queried by ``y_{t-1}`` over the whole input sequence
    (``layers.py:915-972``). The JAX ``lax.scan`` is a Python loop over the
    steps here, as the recurrent layers' is; each step's attention goes
    through the attention op (one query against T keys: its dense
    route)."""

    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("RecurrentAttentionLayer needs RNN input")
        self.n_in = input_type.size
        return RNNInput(self.n_out, input_type.timesteps)

    def _hs(self) -> int:
        return self.head_size or self.n_out // self.n_heads

    def init_params(self, gen, dtype=torch.float32, device=None):
        width = self.n_heads * self._hs()
        wi = self.weight_init or "xavier"
        p = {}
        for k, shape in (("Wx", (self.n_in, self.n_out)),
                         ("Wr", (self.n_out, self.n_out)),
                         ("Wq", (self.n_out, width)),
                         ("Wk", (self.n_in, width)),
                         ("Wv", (self.n_in, width)),
                         ("Wo", (width, self.n_out))):
            p[k] = init_weights(gen, shape, wi, dtype, device=device)
        p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def _run(self, params, x, fmask):
        act = activation_fn(self.activation or "tanh")
        y = torch.zeros((x.shape[0], self.n_out), dtype=x.dtype,
                        device=x.device)
        ys = []
        for t in range(x.shape[1]):
            a = ops.multi_head_dot_product_attention(
                y[:, None, :], x, x, params["Wq"], params["Wk"],
                params["Wv"], params["Wo"], num_heads=self.n_heads,
                mask=fmask)[:, 0]
            y = act(x[:, t] @ params["Wx"] + a @ params["Wr"] + params["b"])
            ys.append(y)
        return torch.stack(ys, dim=1)

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return self._run(params, x, None), state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        x = self._maybe_dropout(x, training, generator)
        y = self._run(params, x, fmask)
        return y * fmask[:, :, None].to(y.dtype), state


@dataclass
class EmbeddingLayer(Layer):
    """Integer index [B] (or one-hot [B, vocab]) to [B, nOut]: a row of the
    table W = [vocab, nOut]. ``table_sharding`` names a mesh axis to
    row-shard the table over: under ``ParallelWrapper`` with a model axis
    the layer's ``W`` arrives as its row shards (a
    ``common/tree.ShardedTensor`` on dimension 0) and the lookup is
    ``sharded_rows_lookup`` (masked local gathers summed in slot order;
    the gradient reaches each shard's owned rows only); anywhere else the
    layer is the dense one. Indices outside the table raise on either
    path, where the JAX package's gather fills them. The layer never
    applies its dropout, in training or not, as the JAX embedding layers
    never do."""

    n_out: int = 0
    table_sharding: Optional[str] = None

    def set_input_type(self, input_type):
        self.n_in = input_type.size  # vocabulary size
        return FFInput(self.n_out)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"W": init_weights(gen, (self.n_in, self.n_out),
                                  self.weight_init or "xavier", dtype,
                                  device=device)}

    def _lookup(self, W, idx):
        idx = idx.to(torch.int64)
        if isinstance(W, ShardedTensor):
            from ...ops.embeddings import sharded_rows_lookup

            # as the dense gather: a negative index counts from the end,
            # one outside the table raises (the masked gathers would give
            # a zero row)
            v = W.shape[0]
            idx = torch.where(idx < 0, idx + v, idx)
            if idx.numel() and not bool(((idx >= 0) & (idx < v)).all()):
                raise IndexError(f"embedding index outside the table of "
                                 f"{v} rows")
            return sharded_rows_lookup(W.shards, idx)[0]
        return W[idx]

    def apply(self, params, x, state, training=False, *, generator=None):
        if x.is_floating_point() and x.ndim == 2 and x.shape[-1] == self.n_in:
            idx = torch.argmax(x, dim=-1)  # one-hot form
        else:
            idx = x
            if idx.ndim == 2 and idx.shape[-1] == 1:
                idx = idx[:, 0]
        out = self._lookup(params["W"], idx)
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class EmbeddingSequenceLayer(EmbeddingLayer):
    """Integer indices [B, T] to RNN [B, T, nOut]."""

    def set_input_type(self, input_type):
        self.n_in = input_type.size
        return RNNInput(self.n_out, getattr(input_type, "timesteps", None))

    def apply(self, params, x, state, training=False, *, generator=None):
        idx = x
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        out = self._lookup(params["W"], idx)
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class ElementWiseMultiplicationLayer(Layer):
    """``act(w * x + b)`` elementwise, ``w`` ones and ``b`` zeros
    ``[n_in]`` at init."""

    def set_input_type(self, input_type):
        self.n_in = input_type.size
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"w": torch.ones((self.n_in,), dtype=dtype, device=device),
                "b": torch.zeros((self.n_in,), dtype=dtype, device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        return activation_fn(self.activation or "identity")(
            x * params["w"] + params["b"]), state


def _frozen(params):
    """The parameters cut from autograd: no gradient reaches them."""
    return tree_map(lambda t: t.detach(), params)


@dataclass
class FrozenLayer(Layer):
    """A layer whose parameters take no update (``layers.py:1074-1109``):
    ``apply`` hands the inner layer its parameters detached (JAX's
    ``stop_gradient``), and passes ``training`` through, so in ``fit`` a
    frozen dense layer still drops out and a frozen BatchNormalization
    still normalizes with batch statistics and updates its running ones,
    as in the JAX package (DL4J's own FrozenLayer runs its layer in
    inference mode; ROADMAP §C). ``MultiLayerNetwork`` leaves the wrapper
    out of l1/l2 and restores its parameters after each update."""

    layer: Optional[Layer] = None

    def set_input_type(self, input_type):
        return self.layer.set_input_type(input_type)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.layer.init_params(gen, dtype, device)

    def init_state(self, device=None):
        return self.layer.init_state(device)

    def apply(self, params, x, state, training=False, *, generator=None):
        return self.layer.apply(_frozen(params), x, state, training,
                                generator=generator)

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        return self.layer.apply_masked(_frozen(params), x, state, training,
                                       fmask, generator=generator)

    def is_rnn(self):
        return self.layer.is_rnn()

    def init_rnn_state(self, batch, dtype=torch.float32, device=None):
        return self.layer.init_rnn_state(batch, dtype, device)

    def apply_rnn(self, params, x, rnn_state, state, training=False, *,
                  generator=None):
        return self.layer.apply_rnn(_frozen(params), x, rnn_state, state,
                                    training, generator=generator)

    @property
    def has_params(self):
        return self.layer.has_params


@dataclass
class PReLULayer(Layer):
    """Leaky ReLU with a learned slope per feature or channel: ``alpha``
    ``[n_in]``, zeros at init."""

    def set_input_type(self, input_type):
        if isinstance(input_type, FFInput):
            self.n_in = input_type.size
        elif isinstance(input_type, CNNInput):
            self.n_in = input_type.channels
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"alpha": torch.zeros((self.n_in,), dtype=dtype,
                                     device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        a = params["alpha"]
        if x.ndim == 4:
            a = a.reshape(1, -1, 1, 1)
        return activation_fn("prelu")(x, a), state


#: the layers that take feed-forward input: a CNN output feeding one gets
#: the ``cnn_to_ff`` adapter (both builders)
FF_LIKE: Tuple[Any, ...] = (DenseLayer, OutputLayer,
                            ElementWiseMultiplicationLayer)

from .layers_ext import (AlphaDropoutLayer,  # noqa: E402,F401
                         CapsuleLayer, CapsuleStrengthLayer,
                         CenterLossOutputLayer, Convolution1DLayer,
                         Convolution3DLayer, ConvLSTM2DLayer, Cropping1D,
                         Cropping3D, DropConnect, FlattenLayer,
                         GaussianDropoutLayer, GaussianNoiseLayer,
                         GroupNormalizationLayer, IWeightNoise, LambdaLayer,
                         LayerNormalization, LocallyConnected1D,
                         LocallyConnected2D, MaskingLayer, MaxNormConstraint,
                         MinMaxNormConstraint, NonNegativeConstraint,
                         ParamConstraint, Permute, PrimaryCapsules,
                         RepeatVector, ReshapeLayer, SeparableConvolution1D,
                         SpaceToBatchLayer, SpaceToDepthLayer,
                         SpatialDropoutLayer, Subsampling1DLayer,
                         Subsampling3DLayer, ThresholdedReLULayer,
                         TimeDistributed, TimeDistributedLayer,
                         UnitNormConstraint, Upsampling1D, Upsampling3D,
                         VariationalAutoencoder, WeightNoise,
                         Yolo2OutputLayer, ZeroPadding1DLayer,
                         ZeroPadding3DLayer)
