"""Neural-net ops of ResNet-50, LeNet, VGG16 and the self-attention
encoder: convolution, pooling, batchnorm, layer norm, linear, dropout,
attention.

Counterpart of the subset of ``deeplearning4j_tpu/ops/nn.py`` that ResNet-50
inference and training and the self-attention encoder run. Layouts are the
JAX package's: activations NCHW, conv weights OIHW. Convolutions and pooling
go to ``F.conv2d`` and ``F.max_pool2d`` (cuDNN on the card), backward
included through autograd, as the JAX package leaves them to XLA outside any
Pallas kernel. Padding is explicit (``(ph, pw)``); the "same" convolution
mode arrives with the models that use it.

:func:`batchnorm_train` is the training form with the JAX package's hand
backward (a ``torch.autograd.Function``), not ``F.batch_norm(training=True)``:
that one recentres differently and feeds the running variance the unbiased
batch variance, where the JAX package uses the biased one.

:func:`multi_head_dot_product_attention` keeps the JAX package's dispatch:
self-attention (``tq == tk``) that the Hopper gate takes goes to
``ops/attention.flash_attention`` (a mask becomes the additive bias
``where(mask, 0, -1e9)``), everything else to the dense
:func:`dot_product_attention`. The JAX package also requires its TPU
backend there; the port does not look at the device: ``flash_attention``
launches a kernel for CUDA tensors and runs its plain version for CPU
tensors. The heads go to it as views of the projections (``[B, T, H, dh]``
permuted, no copy; bf16 ones reach the bf16 kernel as they lie), and its
result is a view of a ``[B, T, H, dh]`` buffer, so merging the heads is a
view too. Each call is counted under ``attention/mha_flash`` or
``attention/mha_dense``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..common.profiler import OpProfiler
from .attention import flash_attention, supports_flash

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


def _bn_axes_shape(ndim: int, channels: int, axis: int):
    axis = axis % ndim
    axes = tuple(i for i in range(ndim) if i != axis)
    shape = [1] * ndim
    shape[axis] = channels
    return axes, shape


def _bn_count(x: torch.Tensor, axes) -> float:
    n = 1.0
    for a in axes:
        n *= x.shape[a]
    return n


class _BatchNormTrain(torch.autograd.Function):
    """Training batchnorm with the JAX package's forward and hand backward
    (``ops/nn.py:307-359``). Outputs ``(out, batch_mean, batch_var)``; the
    statistics are float32 and carry no gradient, nor does the pivot."""

    @staticmethod
    def forward(ctx, x, gamma, beta, pivot, axis: int, epsilon: float):
        axes, shape = _bn_axes_shape(x.ndim, x.shape[axis], axis)
        n = _bn_count(x, axes)
        # one pass of sibling sums about the x-independent pivot (the
        # running mean), so E[d^2] - E[d]^2 does not cancel when
        # |mean| >> std; the variance is the biased one
        d = x.to(torch.float32) - pivot.reshape(shape)
        s = d.sum(dim=axes)
        ss = (d * d).sum(dim=axes)
        del d
        mean_c = s / n
        var = torch.clamp_min(ss / n - mean_c * mean_c, 0.0)
        mean = mean_c + pivot
        inv = torch.rsqrt(var + epsilon)
        # the output in x's dtype from x-dtype mean, inv*gamma and beta,
        # the JAX package's rounding points
        out = ((x - mean.reshape(shape).to(x.dtype))
               * (inv * gamma.to(torch.float32)).reshape(shape).to(x.dtype)
               + beta.reshape(shape).to(x.dtype))
        ctx.save_for_backward(x, gamma, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, inv = ctx.saved_tensors
        axes, shape = _bn_axes_shape(x.ndim, x.shape[ctx.axis], ctx.axis)
        n = _bn_count(x, axes)
        xhat = (x - mean.reshape(shape).to(x.dtype)) \
            * inv.reshape(shape).to(x.dtype)
        dy = dy.to(x.dtype)
        sdy = dy.to(torch.float32).sum(dim=axes)
        sdyx = (dy * xhat).to(torch.float32).sum(dim=axes)
        gi = (gamma.to(torch.float32) * inv).reshape(shape).to(x.dtype)
        dx = gi * (dy
                   - (sdy / n).reshape(shape).to(x.dtype)
                   - xhat * (sdyx / n).reshape(shape).to(x.dtype))
        return dx, sdyx.to(gamma.dtype), sdy.to(gamma.dtype), None, None, None


def batchnorm_train(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                    beta: Optional[torch.Tensor] = None,
                    epsilon: float = 1e-5, axis: int = 1,
                    pivot: Optional[torch.Tensor] = None):
    """Training-form batchnorm: returns ``(out, batch_mean, batch_var)``,
    the statistics float32 and detached. ``pivot`` ([C], x-independent; the
    BN layer passes its running mean) recentres the single-pass variance
    and receives no gradient."""
    c = x.shape[axis]
    if gamma is None:
        gamma = torch.ones((c,), dtype=torch.float32, device=x.device)
    if beta is None:
        beta = torch.zeros((c,), dtype=torch.float32, device=x.device)
    if pivot is None:
        pivot = torch.zeros((c,), dtype=torch.float32, device=x.device)
    return _BatchNormTrain.apply(x, gamma, beta,
                                 pivot.to(torch.float32).detach(), axis,
                                 float(epsilon))


def layer_norm(x: torch.Tensor, gain=None, bias=None, axis: int = -1,
               epsilon: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * gain + bias`` over ``axis``, the
    biased variance, computed in ``x``'s dtype as the JAX package does."""
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if gain is not None:
        out = out * gain
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``x @ W + b`` with the reference layout ``W = [nIn, nOut]``."""
    out = x @ w
    if b is not None:
        out = out + b
    return out


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """The keep mask of inverted dropout: ``True`` with probability
    ``1 - rate``, from ``generator`` (on ``device``). The JAX package draws
    it with ``jax.random.bernoulli`` (threefry); the bits differ, the law
    is the same."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout as ``ops/nn.py:419-426`` of the JAX package computes
    it: ``where(keep, x / (1 - rate), 0)`` in ``x``'s dtype, the keep
    probability rounded once to that dtype (a weak scalar in JAX; a 0-dim
    tensor here, so the card divides and does not multiply by a
    reciprocal). ``keep`` (bool, ``x``'s shape) replaces the draw from
    ``generator``: the tests inject one mask into both packages."""
    if keep is None:
        if generator is None:
            raise ValueError("training-mode dropout needs a torch.Generator "
                             "(the network's own)")
        keep = dropout_mask(x.shape, rate, generator, x.device)
    p = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def dot_product_attention(q, k, v, mask=None, scaled: bool = True):
    """Dense single-head attention over the last two dims: q, k, v
    ``[..., T, d]``; ``mask`` (nonzero = attend) broadcasts against the
    ``[..., Tq, Tk]`` scores."""
    d = q.shape[-1]
    scores = torch.einsum("...qd,...kd->...qk", q, k)
    if scaled:
        scores = scores / torch.sqrt(torch.tensor(float(d), dtype=scores.dtype,
                                                  device=scores.device))
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores,
                             torch.tensor(-1e9, dtype=scores.dtype,
                                          device=scores.device))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("...qk,...kd->...qd", weights, v)


def multi_head_dot_product_attention(q, k, v, wq, wk, wv, wo, mask=None,
                                     num_heads: int = 1,
                                     scaled: bool = True) -> torch.Tensor:
    """q, k, v ``[B, T, dModel]``; per-head projections ``[dModel, H*dh]``,
    attention, then ``wo`` ``[H*dh, nOut]``. ``mask`` ``[B, Tk]`` masks keys.
    Self-attention that :func:`~.attention.supports_flash` takes runs
    through flash attention, the rest densely (see the module docstring)."""
    b, tq, _ = q.shape
    tk = k.shape[1]

    def split_heads(x, w):
        proj = x @ w                                   # [B, T, H*dh]
        return proj.reshape(b, x.shape[1], num_heads, -1).permute(0, 2, 1, 3)

    qh, kh, vh = split_heads(q, wq), split_heads(k, wk), split_heads(v, wv)
    dh = qh.shape[-1]
    prof = OpProfiler.get()
    if tq == tk and supports_flash(tq, dh):
        scale = dh ** -0.5 if scaled else 1.0
        bias = None
        if mask is not None:
            zero = torch.zeros((), dtype=torch.float32, device=qh.device)
            bias = torch.where(mask.reshape(b, 1, 1, tk).to(torch.bool), zero,
                               torch.full((), -1e9, dtype=torch.float32,
                                          device=qh.device))
        out = flash_attention(qh, kh, vh, sm_scale=scale, bias=bias)
        prof.count("attention/mha_flash")
    else:
        m = mask.reshape(b, 1, 1, tk) if mask is not None else None
        out = dot_product_attention(qh, kh, vh, m, scaled)   # [B, H, Tq, dh]
        prof.count("attention/mha_dense")
    out = out.permute(0, 2, 1, 3).reshape(b, tq, -1)
    return out @ wo
