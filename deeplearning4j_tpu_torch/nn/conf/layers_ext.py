"""Extended layers: the 1D convolution family, layer normalization, the
time-distributed wrapper, masking, space-to-depth and space-to-batch, the
center-loss and YOLOv2 heads, and the parameter constraints.

Counterpart of the classes of ``deeplearning4j_tpu/nn/conf/layers_ext.py``
that the self-attention encoder, the zoo's CNNs, the recurrent networks and
``MultiLayerNetwork`` use (``Convolution1DLayer``, ``Subsampling1DLayer``,
``Upsampling1D``, ``ZeroPadding1DLayer``, ``Cropping1D``,
``SeparableConvolution1D``, ``LayerNormalization``, ``TimeDistributed``,
``MaskingLayer``, ``SpaceToDepthLayer``, ``SpaceToBatchLayer``,
``CenterLossOutputLayer``, ``Yolo2OutputLayer``, and
``MaxNormConstraint``, ``MinMaxNormConstraint``, ``NonNegativeConstraint``,
``UnitNormConstraint``, ``layers_ext.py:721-765``); ``nn/conf/layers.py``
re-exports them, as the JAX package's does. Sequence activations are
``[B, T, F]``; the 1D layers act along T (``[B, F, T]`` inside, as the
JAX layers do).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ...ops import nn as ops
from ...ops.shape import space_to_batch
from ..activations import activation_fn
from ..losses import ILossFunction
from ..weights import init_weights
from .inputs import CNNInput, FFInput, RNNInput
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
