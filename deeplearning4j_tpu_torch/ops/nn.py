"""Neural-net ops on the inference path: convolution, pooling, batchnorm.

Counterpart of the subset of ``deeplearning4j_tpu/ops/nn.py`` that ResNet-50
inference runs. Layouts are the JAX package's: activations NCHW, conv
weights OIHW. Convolutions go to ``F.conv2d`` (cuDNN on the card), as the JAX
package leaves them to XLA outside any Pallas kernel. Padding is explicit
(``(ph, pw)``); the "same" convolution mode arrives with the models that
use it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

Pair = Union[int, Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, strides: Pair = (1, 1),
           padding: Pair = (0, 0), dilation: Pair = (1, 1)) -> torch.Tensor:
    """2D convolution. x: NCHW; w: OIHW (reference layout)."""
    out = F.conv2d(x, w, None, stride=_pair(strides), padding=_pair(padding),
                   dilation=_pair(dilation))
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1).to(out.dtype)
    return out.to(x.dtype)


def maxpool2d(x: torch.Tensor, kernel: Pair = (2, 2), strides: Pair = (2, 2),
              padding: Pair = (0, 0)) -> torch.Tensor:
    """Max pooling with explicit padding: padded cells are -inf, as in
    the JAX package's ``reduce_window`` with a -inf init, so they never
    win (the ResNet-50 stem uses kernel (3,3), stride (2,2), pad (1,1))."""
    ph, pw = _pair(padding)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
    return F.max_pool2d(x, _pair(kernel), _pair(strides))


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def batchnorm(x: torch.Tensor, mean, var, gamma=None, beta=None,
              epsilon: float = 1e-5, axis: int = 1) -> torch.Tensor:
    """Inference-form batchnorm over ``axis`` (the dense path, unfolded:
    ``(x - mean) * rsqrt(var + eps) * gamma + beta``)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    inv = torch.rsqrt(var.reshape(shape) + epsilon)
    out = (x - mean.reshape(shape)) * inv
    if gamma is not None:
        out = out * gamma.reshape(shape)
    if beta is not None:
        out = out + beta.reshape(shape)
    return out.to(x.dtype)
