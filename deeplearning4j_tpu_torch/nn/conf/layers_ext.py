"""Extended layers: the 1D and 3D convolution families, locally connected
layers, layer and group normalization, the shape layers, the time-
distributed wrappers, masking, the dropout variants and noise, weight
noise, the variational autoencoder, capsules, the convolutional LSTM, the
lambda layer, space-to-depth and space-to-batch, the center-loss and YOLOv2
heads, and the parameter constraints.

Counterpart of every class of ``deeplearning4j_tpu/nn/conf/layers_ext.py``;
``nn/conf/layers.py`` re-exports them, as the JAX package's does. Sequence
activations are ``[B, T, F]``; the 1D layers act along T (``[B, F, T]``
inside, as the JAX layers do); volumes are NCDHW (``CNN3DInput``).

Random draws (the dropout variants, ``SpatialDropoutLayer``, the weight
noise, the autoencoder's ``eps``) come from the generator the network
passes (``ops/nn.dropout_mask``, ``ops/nn.normal``). Where the JAX package
runs a ``lax.scan`` (``ConvLSTM2DLayer``), the port runs a Python loop over
the steps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ...ops import nn as ops
from ...ops.shape import space_to_batch
from ..activations import activation_fn
from ..losses import ILossFunction
from ..weights import init_weights
from .inputs import CNN3DInput, CNNInput, FFInput, RNNInput
from .layers import Layer, OutputLayer, _pair


def _is_same(mode: str) -> bool:
    return str(mode).lower() == "same"


# --- the 1D convolution family, on [B, T, F] sequences ----------------------


@dataclass
class Convolution1DLayer(Layer):
    """1D convolution along T. W=[out, in, k]."""

    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("Convolution1DLayer needs RNN input [B, T, F]")
        self.n_in = input_type.size
        t = input_type.timesteps
        if t is not None:
            if _is_same(self.convolution_mode):
                t = -(-t // self.stride)
            else:
                eff_k = (self.kernel_size - 1) * self.dilation + 1
                t = (t + 2 * self.padding - eff_k) // self.stride + 1
        return RNNInput(self.n_out, t)

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.n_out, self.n_in, self.kernel_size),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        pad = "SAME" if _is_same(self.convolution_mode) else self.padding
        out = ops.conv1d(x.transpose(1, 2), params["W"], params.get("b"),
                         stride=self.stride, padding=pad,
                         dilation=self.dilation)
        return activation_fn(self.activation or "identity")(
            out.transpose(1, 2)), state


@dataclass
class Subsampling1DLayer(Layer):
    """Max or average pooling along T (the 2D pooling over ``[B, F, T,
    1]``, as the JAX layer does)."""

    kernel_size: int = 2
    stride: int = 2
    padding: int = 0
    pooling_type: str = "max"

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("Subsampling1DLayer needs RNN input")
        self.n_in = input_type.size
        t = input_type.timesteps
        if t is not None:
            t = (t + 2 * self.padding - self.kernel_size) // self.stride + 1
        return RNNInput(self.n_in, t)

    def apply(self, params, x, state, training=False, *, generator=None):
        xc = x.transpose(1, 2)[..., None]
        pool = (ops.maxpool2d if self.pooling_type.lower() == "max"
                else ops.avgpool2d)
        out = pool(xc, (self.kernel_size, 1), (self.stride, 1),
                   (self.padding, 0))
        return out[..., 0].transpose(1, 2), state

    @property
    def has_params(self):
        return False


@dataclass
class Upsampling1D(Layer):
    """Each step repeated ``size`` times."""

    size: int = 2

    def set_input_type(self, input_type):
        self.n_in = input_type.size
        t = input_type.timesteps
        return RNNInput(self.n_in, t * self.size if t else None)

    def apply(self, params, x, state, training=False, *, generator=None):
        return x.repeat_interleave(self.size, dim=1), state

    @property
    def has_params(self):
        return False


@dataclass
class ZeroPadding1DLayer(Layer):
    """Zero steps before and after: ``padding`` (before, after) or one
    count for both."""

    padding: Tuple[int, int] = (1, 1)

    def set_input_type(self, input_type):
        self.n_in = input_type.size
        t = input_type.timesteps
        p = _pair(self.padding)
        return RNNInput(self.n_in, t + p[0] + p[1] if t else None)

    def apply(self, params, x, state, training=False, *, generator=None):
        p = _pair(self.padding)
        return F.pad(x, (0, 0, p[0], p[1])), state

    @property
    def has_params(self):
        return False


@dataclass
class Cropping1D(Layer):
    """Steps cut off the start and the end: ``cropping`` (start, end) or
    one count for both."""

    cropping: Tuple[int, int] = (1, 1)

    def set_input_type(self, input_type):
        self.n_in = input_type.size
        t = input_type.timesteps
        c = _pair(self.cropping)
        return RNNInput(self.n_in, t - c[0] - c[1] if t else None)

    def apply(self, params, x, state, training=False, *, generator=None):
        c = _pair(self.cropping)
        return x[:, c[0]:x.shape[1] - c[1]], state

    @property
    def has_params(self):
        return False


@dataclass
class SeparableConvolution1D(Layer):
    """Depthwise then pointwise 1D convolution along T (Keras
    SeparableConv1D; the 2D separable convolution over ``[B, F, T, 1]``).
    dW=[m, C, k, 1], pW=[F_out, C*m, 1, 1]."""

    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    depth_multiplier: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("SeparableConvolution1D needs RNN input")
        self.n_in = input_type.size
        t = input_type.timesteps
        if t is not None:
            if _is_same(self.convolution_mode):
                t = -(-t // self.stride)
            else:
                t = (t - self.kernel_size) // self.stride + 1
        return RNNInput(self.n_out, t)

    def init_params(self, gen, dtype=torch.float32, device=None):
        wi = self.weight_init or "xavier"
        p = {"dW": init_weights(
                gen, (self.depth_multiplier, self.n_in, self.kernel_size, 1),
                wi, dtype, device=device),
             "pW": init_weights(
                gen, (self.n_out, self.n_in * self.depth_multiplier, 1, 1),
                wi, dtype, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        pad = "SAME" if _is_same(self.convolution_mode) else (0, 0)
        out = ops.sconv2d(x.transpose(1, 2)[..., None], params["dW"],
                          params["pW"], params.get("b"),
                          strides=(self.stride, 1), padding=pad)
        return activation_fn(self.activation or "identity")(
            out[..., 0].transpose(1, 2)), state


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


@dataclass
class MaskingLayer(Layer):
    """Keras Masking: steps whose features all equal ``mask_value`` are
    masked. The layer zeroes them; ``derive_mask`` gives the ``[B, T]``
    feature mask that ``MultiLayerNetwork`` hands to the layers after it
    and to a recurrent head's loss when no mask is given."""

    mask_value: float = 0.0

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("MaskingLayer needs RNN input [B, T, F]")
        self.n_in = input_type.size
        return input_type

    def derive_mask(self, x):
        return (x != self.mask_value).any(dim=-1).to(torch.float32)

    def apply(self, params, x, state, training=False, *, generator=None):
        m = self.derive_mask(x)
        return x * m[:, :, None].to(x.dtype), state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        y, st = self.apply(params, x, state, training)
        return y * fmask[:, :, None].to(y.dtype), st

    @property
    def has_params(self):
        return False


# --- parameter constraints ------------------------------------------------------



@dataclass
class SpaceToDepthLayer(Layer):
    """Blocks of ``block_size`` x ``block_size`` pixels to channels, in the
    JAX op's channel order (``ops/nn.space_to_depth``)."""

    block_size: int = 2

    def set_input_type(self, input_type):
        self.n_in = input_type.channels
        b = self.block_size
        return CNNInput(self.n_in * b * b, input_type.height // b,
                        input_type.width // b)

    def apply(self, params, x, state, training=False, *, generator=None):
        return ops.space_to_depth(x, self.block_size), state

    @property
    def has_params(self):
        return False


@dataclass
class CenterLossOutputLayer(OutputLayer):
    """The output layer's loss plus ``lambda_ / 2 * ||x - centers[y]||^2``
    (``centers`` [n_out, n_in], zeros at init).

    The JAX package's documented divergence from DL4J, kept: the centers
    are ordinary parameters trained by the network's updater, not moved by
    DL4J's alpha moving average (``alpha`` is kept for the configuration).
    The center term is in :meth:`compute_score`, which
    ``MultiLayerNetwork`` calls; a ``ComputationGraph`` scores its output
    layers by their ``loss`` alone, as the JAX graph does, so there the
    centers take no gradient."""

    alpha: float = 0.05
    lambda_: float = 0.5

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = super().init_params(gen, dtype, device)
        p["centers"] = torch.zeros((self.n_out, self.n_in), dtype=dtype,
                                   device=device)
        return p

    def compute_score(self, params, x, labels, mask=None,
                      average: bool = True):
        base = super().compute_score(params, x, labels, mask, average)
        centers = labels.to(params["centers"].dtype) @ params["centers"]
        term = 0.5 * self.lambda_ * torch.sum((x - centers) ** 2, dim=1)
        if mask is not None:
            term = term * mask.reshape(term.shape).to(term.dtype)
        return base + (term.mean() if average else term.sum())


@dataclass
class Yolo2OutputLayer(Layer):
    """The YOLOv2 detection loss over ``[B, A * (5 + C), H, W]`` raw
    activations (A anchors, C classes; ``layers_ext.py:1082-1203`` of the
    JAX package). Labels ``[B, 4 + C, H, W]``: per grid cell the box
    corners (x1, y1, x2, y2) in grid units, then the one-hot class; a cell
    whose class vector is all zero holds no object.

    Per object cell the responsible anchor is the one whose predicted box
    has the best IoU with the cell's box (the first on a tie, as
    ``argmax`` takes it); it takes ``lambda_coord`` times the squared error
    of its centre within the cell and of the square roots of width and
    height, the squared error of its confidence against that IoU (held
    constant), and the softmax cross-entropy of its classes; every other
    anchor takes ``lambda_no_obj`` times its squared confidence. The
    forward is the identity."""

    anchors: Tuple[Tuple[float, float], ...] = ((1.0, 1.0),)
    lambda_coord: float = 5.0
    lambda_no_obj: float = 0.5
    loss: Union[str, ILossFunction, None] = None

    def __post_init__(self):
        self.anchors = tuple(tuple(map(float, a)) for a in self.anchors)

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError("Yolo2OutputLayer needs CNN input")
        self.n_in = input_type.channels
        a = len(self.anchors)
        if input_type.channels % a:
            raise ValueError(f"channels {input_type.channels} not divisible "
                             f"by {a} anchors")
        if input_type.channels // a - 5 < 0:
            raise ValueError("channels must be anchors*(5+classes)")
        return input_type

    def apply(self, params, x, state, training=False, *, generator=None):
        return x, state

    @property
    def has_params(self):
        return False

    def compute_score(self, params, x, labels, mask=None,
                      average: bool = True):
        b, ch, h, w = x.shape
        a = len(self.anchors)
        x = x.reshape(b, a, ch // a, h, w)
        txy = torch.sigmoid(x[:, :, 0:2])
        twh = x[:, :, 2:4]
        conf = torch.sigmoid(x[:, :, 4])
        cls_logits = x[:, :, 5:]
        labels = labels.to(x.dtype)
        anchors = torch.tensor(self.anchors, dtype=x.dtype, device=x.device)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=x.dtype, device=x.device),
            torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
        # predicted boxes in grid units
        px = gx + txy[:, :, 0]
        py = gy + txy[:, :, 1]
        pw = anchors[None, :, 0, None, None] * torch.exp(twh[:, :, 0])
        ph = anchors[None, :, 1, None, None] * torch.exp(twh[:, :, 1])

        gt_x1, gt_y1, gt_x2, gt_y2 = (labels[:, i] for i in range(4))
        gt_cls = labels[:, 4:]
        obj = (gt_cls.sum(dim=1) > 0).to(x.dtype)              # [B, H, W]
        gw, gh = gt_x2 - gt_x1, gt_y2 - gt_y1
        gcx, gcy = 0.5 * (gt_x1 + gt_x2), 0.5 * (gt_y1 + gt_y2)

        # IoU of each anchor's predicted box with the cell's box
        ix1 = torch.maximum(px - pw / 2, gt_x1[:, None])
        iy1 = torch.maximum(py - ph / 2, gt_y1[:, None])
        ix2 = torch.minimum(px + pw / 2, gt_x2[:, None])
        iy2 = torch.minimum(py + ph / 2, gt_y2[:, None])
        inter = torch.clamp_min(ix2 - ix1, 0) * torch.clamp_min(iy2 - iy1, 0)
        union = pw * ph + (gw * gh)[:, None] - inter
        iou = (inter / torch.clamp_min(union, 1e-9)).detach()  # [B, A, H, W]
        best = torch.argmax(iou, dim=1)                        # [B, H, W]
        resp = F.one_hot(best, a).permute(0, 3, 1, 2).to(x.dtype) \
            * obj[:, None]

        tx, ty = gcx - gx, gcy - gy
        xy_l = (txy[:, :, 0] - tx[:, None]) ** 2 \
            + (txy[:, :, 1] - ty[:, None]) ** 2

        def root(v):
            return torch.sqrt(torch.clamp_min(v, 1e-9))

        wh_l = (root(pw) - root(gw)[:, None]) ** 2 \
            + (root(ph) - root(gh)[:, None]) ** 2
        dims = (1, 2, 3)
        coord = self.lambda_coord * torch.sum(resp * (xy_l + wh_l), dim=dims)
        obj_l = torch.sum(resp * (conf - iou) ** 2, dim=dims)
        noobj_l = self.lambda_no_obj * torch.sum((1.0 - resp) * conf ** 2,
                                                 dim=dims)
        logp = torch.log_softmax(cls_logits, dim=2)
        ce = -torch.sum(gt_cls[:, None] * logp, dim=2)         # [B, A, H, W]
        cls_l = torch.sum(resp * ce, dim=dims)
        total = coord + obj_l + noobj_l + cls_l                 # [B]
        return total.mean() if average else total.sum()


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


@dataclass
class SpaceToBatchLayer(Layer):
    """Blocks of ``block_size`` x ``block_size`` pixels to the batch: the
    NHWC ``space_to_batch`` op between two transposes, as the JAX layer
    computes it."""

    block_size: int = 2

    def set_input_type(self, input_type):
        self.n_in = input_type.channels
        b = self.block_size
        return CNNInput(self.n_in, input_type.height // b,
                        input_type.width // b)

    def apply(self, params, x, state, training=False, *, generator=None):
        b = self.block_size
        out = space_to_batch(x.permute(0, 2, 3, 1), (b, b), ((0, 0), (0, 0)))
        return out.permute(0, 3, 1, 2), state

    @property
    def has_params(self):
        return False


# --- the 3D convolution family (NCDHW, CNN3DInput) ------------------------------


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _triple_pairs(v):
    """A 3D padding or cropping spec as ``((lo, hi),) * 3``: an int, a
    ``(d, h, w)`` triple or Keras's ``((d1, d2), (h1, h2), (w1, w2))``."""
    if isinstance(v, int):
        return ((v, v),) * 3
    v = tuple(v)
    if all(isinstance(e, int) for e in v):
        return tuple((e, e) for e in v)
    return tuple((int(a), int(b)) for a, b in v)


def _need_3d(layer, input_type):
    if not isinstance(input_type, CNN3DInput):
        raise ValueError(f"{type(layer).__name__} needs CNN3D input (use "
                         f"InputType.convolutional_3d), got {input_type}")


@dataclass
class Convolution3DLayer(Layer):
    """3D convolution. W=[out, in, kD, kH, kW]; ``convolution_mode``
    "same" (TF's SAME) or "truncate" with explicit ``padding``."""

    n_out: int = 0
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    stride: Tuple[int, int, int] = (1, 1, 1)
    padding: Tuple[int, int, int] = (0, 0, 0)
    dilation: Tuple[int, int, int] = (1, 1, 1)
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def _dims(self, d, h, w):
        k, s = _triple(self.kernel_size), _triple(self.stride)
        if _is_same(self.convolution_mode):
            return tuple(-(-v // sv) for v, sv in zip((d, h, w), s))
        p, dil = _triple(self.padding), _triple(self.dilation)
        return tuple((v + 2 * pv - ((kv - 1) * dv + 1)) // sv + 1
                     for v, kv, sv, pv, dv in zip((d, h, w), k, s, p, dil))

    def set_input_type(self, input_type):
        _need_3d(self, input_type)
        self.n_in = input_type.channels
        return CNN3DInput(self.n_out, *self._dims(
            input_type.depth, input_type.height, input_type.width))

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self.n_out, self.n_in)
                               + _triple(self.kernel_size),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out,), dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        pad = ("SAME" if _is_same(self.convolution_mode)
               else _triple(self.padding))
        out = ops.conv3d(x, params["W"], params.get("b"),
                         strides=_triple(self.stride), padding=pad,
                         dilation=_triple(self.dilation))
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class Subsampling3DLayer(Layer):
    kernel_size: Tuple[int, int, int] = (2, 2, 2)
    stride: Tuple[int, int, int] = (2, 2, 2)
    padding: Tuple[int, int, int] = (0, 0, 0)
    pooling_type: str = "max"

    def set_input_type(self, input_type):
        _need_3d(self, input_type)
        self.n_in = input_type.channels
        k, s, p = (_triple(self.kernel_size), _triple(self.stride),
                   _triple(self.padding))
        return CNN3DInput(self.n_in, *(
            (v + 2 * pv - kv) // sv + 1 for v, kv, sv, pv in zip(
                (input_type.depth, input_type.height, input_type.width),
                k, s, p)))

    def apply(self, params, x, state, training=False, *, generator=None):
        pool = (ops.maxpool3d if self.pooling_type.lower() == "max"
                else ops.avgpool3d)
        return pool(x, _triple(self.kernel_size), _triple(self.stride),
                    _triple(self.padding)), state

    @property
    def has_params(self):
        return False


@dataclass
class Upsampling3D(Layer):
    size: Tuple[int, int, int] = (2, 2, 2)

    def set_input_type(self, input_type):
        self.n_in = input_type.channels
        s = _triple(self.size)
        return CNN3DInput(self.n_in, input_type.depth * s[0],
                          input_type.height * s[1], input_type.width * s[2])

    def apply(self, params, x, state, training=False, *, generator=None):
        return ops.upsampling3d(x, _triple(self.size)), state

    @property
    def has_params(self):
        return False


@dataclass
class ZeroPadding3DLayer(Layer):
    # an int, (d, h, w), or per side ((d1, d2), (h1, h2), (w1, w2))
    padding: Any = (1, 1, 1)

    def set_input_type(self, input_type):
        self.n_in = input_type.channels
        p = _triple_pairs(self.padding)
        return CNN3DInput(self.n_in, input_type.depth + sum(p[0]),
                          input_type.height + sum(p[1]),
                          input_type.width + sum(p[2]))

    def apply(self, params, x, state, training=False, *, generator=None):
        (d0, d1), (h0, h1), (w0, w1) = _triple_pairs(self.padding)
        return F.pad(x, (w0, w1, h0, h1, d0, d1)), state

    @property
    def has_params(self):
        return False


@dataclass
class Cropping3D(Layer):
    # an int, (d, h, w), or per side ((d1, d2), (h1, h2), (w1, w2))
    cropping: Any = (1, 1, 1)

    def set_input_type(self, input_type):
        self.n_in = input_type.channels
        c = _triple_pairs(self.cropping)
        return CNN3DInput(self.n_in, input_type.depth - sum(c[0]),
                          input_type.height - sum(c[1]),
                          input_type.width - sum(c[2]))

    def apply(self, params, x, state, training=False, *, generator=None):
        c = _triple_pairs(self.cropping)
        return x[:, :, c[0][0]:x.shape[2] - c[0][1],
                 c[1][0]:x.shape[3] - c[1][1],
                 c[2][0]:x.shape[4] - c[2][1]], state

    @property
    def has_params(self):
        return False


# --- locally connected: a kernel of its own at every output position ----------


@dataclass
class LocallyConnected2D(Layer):
    """Convolution arithmetic with unshared weights: W=[oh * ow, C * kH *
    kW, n_out] (one patch row per output position, in ``F.unfold``'s (C,
    kH, kW) order, which is ``conv_general_dilated_patches``'), b=[n_out,
    oh, ow]."""

    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError("LocallyConnected2D needs CNN input")
        self.n_in = input_type.channels
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        self._oh = (input_type.height - kh) // sh + 1
        self._ow = (input_type.width - kw) // sw + 1
        return CNNInput(self.n_out, self._oh, self._ow)

    def init_params(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        p = {"W": init_weights(gen, (self._oh * self._ow,
                                     self.n_in * kh * kw, self.n_out),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self.n_out, self._oh, self._ow),
                                 dtype=dtype, device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        patches = F.unfold(x, _pair(self.kernel_size),
                           stride=_pair(self.stride))      # [B, P, L]
        out = torch.einsum("bpl,lpo->bol", patches, params["W"])
        out = out.reshape(x.shape[0], self.n_out, self._oh, self._ow)
        if self.has_bias:
            out = out + params["b"][None]
        return activation_fn(self.activation or "identity")(out), state


@dataclass
class LocallyConnected1D(Layer):
    """Unshared 1D convolution along T of ``[B, T, F]``: W=[ot, F * k,
    n_out], b=[ot, n_out]; the sequence length must be known."""

    n_out: int = 0
    kernel_size: int = 3
    stride: int = 1
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("LocallyConnected1D needs RNN input")
        self.n_in = input_type.size
        if input_type.timesteps is None:
            raise ValueError("LocallyConnected1D needs a known sequence "
                             "length (unshared weights are per-position)")
        self._ot = (input_type.timesteps - self.kernel_size) \
            // self.stride + 1
        return RNNInput(self.n_out, self._ot)

    def init_params(self, gen, dtype=torch.float32, device=None):
        p = {"W": init_weights(gen, (self._ot, self.n_in * self.kernel_size,
                                     self.n_out),
                               self.weight_init or "xavier", dtype,
                               device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((self._ot, self.n_out), dtype=dtype,
                                 device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        patches = F.unfold(x.transpose(1, 2)[..., None],
                           (self.kernel_size, 1), stride=(self.stride, 1))
        out = torch.einsum("bpl,lpo->blo", patches, params["W"])
        if self.has_bias:
            out = out + params["b"][None]
        return activation_fn(self.activation or "identity")(out), state


# --- shape layers -------------------------------------------------------------


@dataclass
class FlattenLayer(Layer):
    """Row-major flatten of every axis but the batch's, before any layer
    (unlike the builders' automatic ``cnn_to_ff``)."""

    def set_input_type(self, input_type):
        if isinstance(input_type, FFInput):
            self.n_in = input_type.size
            return input_type
        if isinstance(input_type, CNNInput):
            n = input_type.channels * input_type.height * input_type.width
        elif isinstance(input_type, CNN3DInput):
            n = (input_type.channels * input_type.depth
                 * input_type.height * input_type.width)
        elif isinstance(input_type, RNNInput):
            if input_type.timesteps is None:
                raise ValueError("FlattenLayer needs known timesteps")
            n = input_type.size * input_type.timesteps
        else:
            raise ValueError(f"FlattenLayer: unsupported {input_type}")
        self.n_in = n
        return FFInput(n)

    def apply(self, params, x, state, training=False, *, generator=None):
        return x.reshape(x.shape[0], -1), state

    @property
    def has_params(self):
        return False


@dataclass
class Permute(Layer):
    """Keras's Permute of ``[B, T, F]`` (1-based dims, (2, 1) or (1,
    2))."""

    dims: Tuple[int, ...] = (2, 1)

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput) or tuple(self.dims) \
                not in ((2, 1), (1, 2)):
            raise ValueError("Permute supports RNN input with dims "
                             "(2,1)/(1,2) only")
        self.n_in = input_type.size
        if tuple(self.dims) == (1, 2):
            return input_type
        return RNNInput(input_type.timesteps, self.n_in)

    def apply(self, params, x, state, training=False, *, generator=None):
        if tuple(self.dims) == (2, 1):
            x = x.transpose(1, 2)
        return x, state

    @property
    def has_params(self):
        return False


@dataclass
class ReshapeLayer(Layer):
    """Row-major reshape of the non-batch axes between FF and RNN
    forms."""

    shape: Tuple[int, ...] = ()

    def set_input_type(self, input_type):
        if isinstance(input_type, FFInput):
            n = input_type.size
        elif isinstance(input_type, RNNInput):
            if input_type.timesteps is None:
                raise ValueError("ReshapeLayer needs a known timestep count")
            n = input_type.size * input_type.timesteps
        else:
            raise ValueError("ReshapeLayer supports FF/RNN input only")
        if math.prod(self.shape) != n:
            raise ValueError(f"cannot reshape {n} features into "
                             f"{self.shape}")
        self.n_in = n
        if len(self.shape) == 1:
            return FFInput(self.shape[0])
        if len(self.shape) == 2:
            return RNNInput(self.shape[1], self.shape[0])
        raise ValueError("ReshapeLayer target rank must be 1 or 2")

    def apply(self, params, x, state, training=False, *, generator=None):
        return x.reshape((x.shape[0],) + tuple(self.shape)), state

    @property
    def has_params(self):
        return False


@dataclass
class RepeatVector(Layer):
    """``[B, F]`` to ``[B, n, F]``."""

    n: int = 1

    def set_input_type(self, input_type):
        if not isinstance(input_type, FFInput):
            raise ValueError("RepeatVector needs FF input")
        self.n_in = input_type.size
        return RNNInput(self.n_in, self.n)

    def apply(self, params, x, state, training=False, *, generator=None):
        return x[:, None, :].expand(x.shape[0], self.n,
                                    x.shape[1]).contiguous(), state

    @property
    def has_params(self):
        return False


@dataclass
class TimeDistributedLayer(Layer):
    """Keras's TimeDistributed: the feed-forward ``inner`` layer at every
    step of ``[B, T, F]`` (the import-side twin of ``TimeDistributed``;
    the builders do not cascade their defaults into ``inner``)."""

    inner: Optional[Layer] = None

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("TimeDistributedLayer needs RNN input")
        self.n_in = input_type.size
        out = self.inner.set_input_type(FFInput(input_type.size))
        return RNNInput(out.size, input_type.timesteps)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return self.inner.init_params(gen, dtype, device)

    @property
    def has_params(self):
        return self.inner.has_params

    def apply(self, params, x, state, training=False, *, generator=None):
        b, t = x.shape[0], x.shape[1]
        y, st = self.inner.apply(params, x.reshape(b * t, -1), state,
                                 training, generator=generator)
        return y.reshape(b, t, -1), st

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        y, st = self.apply(params, x, state, training, generator=generator)
        return y * fmask[:, :, None].to(y.dtype), st


@dataclass
class LambdaLayer(Layer):
    """A function of tensors as a layer. Its body does not serialize: the
    configuration holds its ``name``, and reading it back looks the
    function up in ``imports/keras_import``'s registry
    (``register_lambda``). The output type comes from running the function
    on a batch of one of zeros (JAX's ``eval_shape``)."""

    fn: Optional[Any] = None
    name: str = ""

    def set_input_type(self, input_type):
        self.n_in = getattr(input_type, "size", None)
        t_unknown = (isinstance(input_type, RNNInput)
                     and input_type.timesteps is None)
        dummy_t = 4   # stands for an unknown T; must come back unchanged
        if isinstance(input_type, FFInput):
            shape = (1, input_type.size)
        elif isinstance(input_type, RNNInput):
            shape = (1, input_type.timesteps or dummy_t, input_type.size)
        elif isinstance(input_type, CNNInput):
            shape = (1, input_type.channels, input_type.height,
                     input_type.width)
        else:
            raise ValueError(
                f"Lambda {self.name!r}: unsupported input {input_type}")
        with torch.no_grad():
            s = tuple(self.fn(torch.zeros(shape)).shape)
        if len(s) == 2:
            return FFInput(s[1])
        if len(s) == 3:
            if t_unknown:
                if s[1] != dummy_t:
                    raise ValueError(
                        f"Lambda {self.name!r}: changes the time dimension "
                        "but the input timesteps are unknown: give the "
                        "input a static sequence length")
                return RNNInput(s[2], None)
            return RNNInput(s[2], s[1])
        if len(s) == 4:
            return CNNInput(s[1], s[2], s[3])
        raise ValueError(f"Lambda {self.name!r}: unsupported output rank "
                         f"{len(s)}")

    def apply(self, params, x, state, training=False, *, generator=None):
        return self.fn(x), state

    @property
    def has_params(self):
        return False


# --- elementwise and normalization layers -----------------------------------------


@dataclass
class ThresholdedReLULayer(Layer):
    """Keras's ThresholdedReLU: ``x`` where ``x > theta``, else 0."""

    theta: float = 1.0

    def set_input_type(self, input_type):
        self.n_in = getattr(input_type, "size", None)
        return input_type

    def apply(self, params, x, state, training=False, *, generator=None):
        return x * (x > self.theta).to(x.dtype), state

    @property
    def has_params(self):
        return False


@dataclass
class GroupNormalizationLayer(Layer):
    """Channels in ``groups``, each normalized over its channels and the
    spatial axes per example, then a per-channel gain and bias (CNN [B, C,
    H, W] or FF [B, F])."""

    groups: int = 32
    eps: float = 1e-3

    def set_input_type(self, input_type):
        if isinstance(input_type, CNNInput):
            self.n_in = input_type.channels
        elif isinstance(input_type, FFInput):
            self.n_in = input_type.size
        else:
            raise ValueError("GroupNormalizationLayer needs CNN or FF "
                             f"input, got {input_type}")
        if self.n_in % self.groups:
            raise ValueError(f"channels ({self.n_in}) must divide into "
                             f"groups ({self.groups})")
        return input_type

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"gain": torch.ones((self.n_in,), dtype=dtype, device=device),
                "bias": torch.zeros((self.n_in,), dtype=dtype,
                                    device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        b, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        xg = x.reshape((b, self.groups, c // self.groups) + spatial)
        axes = tuple(range(2, xg.ndim))
        mu = xg.mean(dim=axes, keepdim=True)
        var = ((xg - mu) ** 2).mean(dim=axes, keepdim=True)
        xn = ((xg - mu) / torch.sqrt(var + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * len(spatial)
        return (xn * params["gain"].reshape(shape)
                + params["bias"].reshape(shape)), state


# --- dropout variants and noise (training only; the identity otherwise) ---------


@dataclass
class AlphaDropoutLayer(Layer):
    """SELU-preserving dropout at ``rate`` (``ops/nn.alpha_dropout``)."""

    rate: float = 0.5

    def apply(self, params, x, state, training=False, *, generator=None):
        if training and self.rate > 0:
            return ops.alpha_dropout(x, self.rate, generator), state
        return x, state

    @property
    def has_params(self):
        return False


@dataclass
class GaussianDropoutLayer(Layer):
    """Multiplicative ``N(1, rate / (1 - rate))`` noise."""

    rate: float = 0.5

    def apply(self, params, x, state, training=False, *, generator=None):
        if training and self.rate > 0:
            return ops.gaussian_dropout(x, self.rate, generator), state
        return x, state

    @property
    def has_params(self):
        return False


@dataclass
class GaussianNoiseLayer(Layer):
    """Additive ``N(0, stddev)`` noise."""

    stddev: float = 0.1

    def apply(self, params, x, state, training=False, *, generator=None):
        if training and self.stddev > 0:
            return ops.gaussian_noise(x, self.stddev, generator), state
        return x, state

    @property
    def has_params(self):
        return False


@dataclass
class SpatialDropoutLayer(Layer):
    """Drops whole feature maps: one keep draw per (example, feature) of
    ``[B, T, F]`` or per (example, channel) of ``[B, C, ...]``, broadcast
    over time or space, inverted scaling."""

    rate: float = 0.5

    def set_input_type(self, input_type):
        self.n_in = getattr(input_type, "size",
                            getattr(input_type, "channels", None))
        return input_type

    def apply(self, params, x, state, training=False, *, generator=None):
        if not training or self.rate <= 0:
            return x, state
        if x.ndim == 3:
            shape = (x.shape[0], 1, x.shape[2])
        else:
            shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
        keep = ops.dropout_mask(shape, self.rate, generator, x.device)
        p = torch.tensor(1.0 - self.rate, dtype=x.dtype, device=x.device)
        return x * keep.to(x.dtype) / p, state

    def apply_masked(self, params, x, state, training, fmask, *,
                     generator=None):
        y, st = self.apply(params, x, state, training, generator=generator)
        if y.ndim == 3:
            y = y * fmask[:, :, None].to(y.dtype)
        return y, st

    @property
    def has_params(self):
        return False


class IWeightNoise:
    """A perturbation of a layer's parameters in training forwards,
    applied by ``MultiLayerNetwork`` before the layer's ``apply``, with
    draws from the network's generator."""

    def apply(self, params: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator], training: bool):
        raise NotImplementedError


class DropConnect(IWeightNoise):
    """Each weight kept with probability ``weight_retain_prob`` (and
    scaled by its inverse), else 0; biases too with
    ``apply_to_biases``."""

    def __init__(self, weight_retain_prob: float = 0.5,
                 apply_to_biases: bool = False):
        self.p = weight_retain_prob
        self.apply_to_biases = apply_to_biases

    def apply(self, params, generator, training):
        if not training:
            return params
        out = {}
        for k, w in params.items():
            if k == "b" and not self.apply_to_biases:
                out[k] = w
                continue
            keep = ops.dropout_mask(w.shape, 1.0 - self.p, generator,
                                    w.device)
            p = torch.tensor(self.p, dtype=w.dtype, device=w.device)
            out[k] = torch.where(keep, w / p, torch.zeros(
                (), dtype=w.dtype, device=w.device))
        return out


class WeightNoise(IWeightNoise):
    """``N(mean, stddev)`` noise added to (``additive``) or multiplying
    every weight but the biases."""

    def __init__(self, mean: float = 0.0, stddev: float = 0.1,
                 additive: bool = True):
        self.mean, self.stddev, self.additive = mean, stddev, additive

    def apply(self, params, generator, training):
        if not training:
            return params
        out = {}
        for k, w in params.items():
            if k == "b":
                out[k] = w
                continue
            noise = self.mean + self.stddev * ops.normal(
                w.shape, generator, w.dtype, w.device)
            out[k] = w + noise if self.additive else w * noise
        return out


# --- the variational autoencoder ------------------------------------------------


@dataclass
class VariationalAutoencoder(Layer):
    """Encoder MLP, ``(mean, logvar)`` of ``q(z|x)``, decoder MLP and a
    Gaussian (mean and log-variance, ``2 * n_in`` outputs) or Bernoulli
    (logits) reconstruction. ``apply`` (the supervised forward) gives the
    posterior mean; ``pretrain_loss`` is the negative ELBO that
    ``MultiLayerNetwork.pretrain`` minimizes, with ``num_samples`` draws
    of ``z``; ``reconstruction_error`` scores with ``z`` at the mean."""

    n_out: int = 0
    encoder_layer_sizes: Tuple[int, ...] = (64,)
    decoder_layer_sizes: Tuple[int, ...] = (64,)
    reconstruction_distribution: str = "gaussian"
    num_samples: int = 1

    def set_input_type(self, input_type):
        if not isinstance(input_type, FFInput):
            raise ValueError("VariationalAutoencoder needs FF input")
        self.n_in = input_type.size
        return FFInput(self.n_out)

    def init_params(self, gen, dtype=torch.float32, device=None):
        wi = self.weight_init or "xavier"

        def dense(p, wk, bk, a, b):
            p[wk] = init_weights(gen, (a, b), wi, dtype, device=device)
            p[bk] = torch.zeros((b,), dtype=dtype, device=device)

        p: Dict[str, torch.Tensor] = {}
        sizes = (self.n_in,) + tuple(self.encoder_layer_sizes)
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            dense(p, f"eW{i}", f"eb{i}", a, b)
        dense(p, "meanW", "meanb", sizes[-1], self.n_out)
        dense(p, "lvW", "lvb", sizes[-1], self.n_out)
        dsizes = (self.n_out,) + tuple(self.decoder_layer_sizes)
        for i, (a, b) in enumerate(zip(dsizes[:-1], dsizes[1:])):
            dense(p, f"dW{i}", f"db{i}", a, b)
        dense(p, "rW", "rb", dsizes[-1], 2 * self.n_in if self._gaussian()
              else self.n_in)
        return p

    def _gaussian(self) -> bool:
        return self.reconstruction_distribution == "gaussian"

    def _encode(self, params, x):
        act = activation_fn(self.activation or "tanh")
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        return (h @ params["meanW"] + params["meanb"],
                h @ params["lvW"] + params["lvb"])

    def _decode(self, params, z):
        act = activation_fn(self.activation or "tanh")
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["rW"] + params["rb"]

    def apply(self, params, x, state, training=False, *, generator=None):
        x = self._maybe_dropout(x, training, generator)
        return self._encode(params, x)[0], state

    def is_pretrain_layer(self) -> bool:
        return True

    def pretrain_loss(self, params, x, generator):
        """The negative ELBO averaged over the batch: ``KL(q(z|x) || N(0,
        I))`` minus the reconstruction log-likelihood averaged over
        ``num_samples`` draws ``z = mean + exp(logvar / 2) * eps``, ``eps``
        from ``generator`` (``ops/nn.normal``)."""
        mean, logvar = self._encode(params, x)
        kl = 0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar,
                             dim=1)
        recon = 0.0
        for _ in range(self.num_samples):
            eps = ops.normal(mean.shape, generator, mean.dtype, mean.device)
            out = self._decode(params, mean + torch.exp(0.5 * logvar) * eps)
            if self._gaussian():
                rmean, rlogvar = torch.chunk(out, 2, dim=1)
                ll = -0.5 * torch.sum(rlogvar + (x - rmean) ** 2
                                      / torch.exp(rlogvar)
                                      + math.log(2 * math.pi), dim=1)
            else:   # Bernoulli logits
                ll = -torch.sum(torch.clamp_min(out, 0) - out * x
                                + torch.log1p(torch.exp(-out.abs())), dim=1)
            recon = recon + ll
        return torch.mean(kl - recon / self.num_samples)

    def reconstruction_error(self, params, x, generator=None):
        """The mean squared reconstruction error with ``z`` at the
        posterior mean (no draw)."""
        out = self._decode(params, self._encode(params, x)[0])
        rmean = (torch.chunk(out, 2, dim=1)[0] if self._gaussian()
                 else torch.sigmoid(out))
        return torch.mean(torch.sum((x - rmean) ** 2, dim=1))


# --- capsules (Sabour et al. 2017) ----------------------------------------------


def _squash(s, dim=-1):
    n2 = torch.sum(torch.square(s), dim=dim, keepdim=True)
    return (n2 / (1.0 + n2)) * s / torch.sqrt(n2 + 1e-9)


@dataclass
class PrimaryCapsules(Layer):
    """A convolution to ``channels * capsule_dimensions`` maps, read as
    ``channels * oh * ow`` capsules of ``capsule_dimensions`` and
    squashed: ``[B, capsules, capsule_dimensions]``."""

    capsules: int = 0               # derived if 0
    capsule_dimensions: int = 8
    channels: int = 32
    kernel_size: Tuple[int, int] = (9, 9)
    stride: Tuple[int, int] = (2, 2)

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNNInput):
            raise ValueError("PrimaryCapsules needs CNN input")
        self.n_in = input_type.channels
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        oh = (input_type.height - kh) // sh + 1
        ow = (input_type.width - kw) // sw + 1
        self.capsules = self.channels * oh * ow
        return RNNInput(self.capsule_dimensions, self.capsules)

    def init_params(self, gen, dtype=torch.float32, device=None):
        n_out = self.channels * self.capsule_dimensions
        return {"W": init_weights(gen, (n_out, self.n_in)
                                  + _pair(self.kernel_size),
                                  self.weight_init or "xavier", dtype,
                                  device=device),
                "b": torch.zeros((n_out,), dtype=dtype, device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        out = ops.conv2d(x, params["W"], params["b"],
                         strides=_pair(self.stride), padding=(0, 0))
        caps = out.reshape(out.shape[0], self.capsule_dimensions, -1)
        return _squash(caps.transpose(1, 2)), state


@dataclass
class CapsuleLayer(Layer):
    """Dynamic routing (a fixed ``routings`` count, unrolled): ``u_hat =
    W x`` per (input, output) capsule pair, then coupling softmaxes over
    the output capsules and agreement updates; output ``[B, capsules,
    capsule_dimensions]``. W=[in caps, capsules, capsule_dimensions,
    in dim]."""

    capsules: int = 10
    capsule_dimensions: int = 16
    routings: int = 3

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("CapsuleLayer needs capsule input "
                             "[B, inCaps, inDim]")
        self._in_caps = input_type.timesteps
        self.n_in = input_type.size
        if self._in_caps is None:
            raise ValueError("CapsuleLayer needs a known capsule count")
        return RNNInput(self.capsule_dimensions, self.capsules)

    def init_params(self, gen, dtype=torch.float32, device=None):
        return {"W": init_weights(
            gen, (self._in_caps, self.capsules, self.capsule_dimensions,
                  self.n_in), self.weight_init or "xavier", dtype,
            device=device)}

    def apply(self, params, x, state, training=False, *, generator=None):
        u_hat = torch.einsum("ijdc,bic->bijd", params["W"], x)
        logits = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype,
                             device=u_hat.device)
        v = None
        for r in range(self.routings):
            c = torch.softmax(logits, dim=2)             # over output caps
            v = _squash(torch.einsum("bij,bijd->bjd", c, u_hat))
            if r < self.routings - 1:
                logits = logits + torch.einsum("bijd,bjd->bij", u_hat, v)
        return v, state


@dataclass
class CapsuleStrengthLayer(Layer):
    """Capsule lengths: ``[B, caps, dim]`` to ``[B, caps]``."""

    def set_input_type(self, input_type):
        if not isinstance(input_type, RNNInput):
            raise ValueError("CapsuleStrengthLayer needs capsule input")
        self.n_in = input_type.size
        return FFInput(input_type.timesteps)

    def apply(self, params, x, state, training=False, *, generator=None):
        return torch.sqrt(torch.sum(torch.square(x), dim=-1) + 1e-9), state

    @property
    def has_params(self):
        return False


# --- the convolutional LSTM -----------------------------------------------------


@dataclass
class ConvLSTM2DLayer(Layer):
    """Keras's ConvLSTM2D over ``[B, C, T, H, W]`` (CNN3D input with depth
    as time): per step ``g = conv(x_t, Wx) + conv(h, Wh, SAME) + b``, gates
    in Keras's order (i, f, c, o); output ``[B, F, T, H', W']`` with
    ``return_sequences``, else the last ``h``. The JAX ``lax.scan`` is a
    Python loop over the steps here."""

    n_out: int = 0
    kernel_size: Tuple[int, int] = (3, 3)
    convolution_mode: str = "truncate"
    return_sequences: bool = True
    has_bias: bool = True

    def set_input_type(self, input_type):
        if not isinstance(input_type, CNN3DInput):
            raise ValueError("ConvLSTM2DLayer needs CNN3D input "
                             "[B, C, T(depth), H, W]")
        self.n_in = input_type.channels
        kh, kw = _pair(self.kernel_size)
        if _is_same(self.convolution_mode):
            oh, ow = input_type.height, input_type.width
        else:
            oh, ow = input_type.height - kh + 1, input_type.width - kw + 1
        if self.return_sequences:
            return CNN3DInput(self.n_out, input_type.depth, oh, ow)
        return CNNInput(self.n_out, oh, ow)

    def init_params(self, gen, dtype=torch.float32, device=None):
        k = _pair(self.kernel_size)
        wi = self.weight_init or "xavier"
        p = {"Wx": init_weights(gen, (4 * self.n_out, self.n_in) + k, wi,
                                dtype, device=device),
             "Wh": init_weights(gen, (4 * self.n_out, self.n_out) + k, wi,
                                dtype, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros((4 * self.n_out,), dtype=dtype,
                                 device=device)
        return p

    def apply(self, params, x, state, training=False, *, generator=None):
        f = self.n_out
        pad = "SAME" if _is_same(self.convolution_mode) else (0, 0)
        kh, kw = _pair(self.kernel_size)
        b_, h_, w_ = x.shape[0], x.shape[3], x.shape[4]
        oh, ow = (h_, w_) if pad == "SAME" else (h_ - kh + 1, w_ - kw + 1)
        h = torch.zeros((b_, f, oh, ow), dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        bias = params.get("b")
        hs = []
        for t in range(x.shape[2]):
            g = (ops.conv2d(x[:, :, t], params["Wx"], padding=pad)
                 + ops.conv2d(h, params["Wh"], padding="SAME"))
            if bias is not None:
                g = g + bias[None, :, None, None]
            i = torch.sigmoid(g[:, 0:f])
            fg = torch.sigmoid(g[:, f:2 * f])
            gg = torch.tanh(g[:, 2 * f:3 * f])
            o = torch.sigmoid(g[:, 3 * f:4 * f])
            c = fg * c + i * gg
            h = o * torch.tanh(c)
            hs.append(h)
        if self.return_sequences:
            return torch.stack(hs, dim=2), state
        return h, state
