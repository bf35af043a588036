"""Neural-net ops of the zoo's CNNs, the sequence layers and the
self-attention encoder: convolution (1D, 2D, transposed, depthwise,
separable, 3D), pooling (max, average, p-norm; 2D and 3D), upsampling,
batchnorm, local response normalization, layer norm, space-to-depth,
linear, dropout and its variants (alpha, gaussian, additive noise),
attention; and, at the end of the module, the registry's ``nn`` family
(the 32 ops of ``deeplearning4j_tpu/ops/nn.py`` with its signatures, over
the functions here).

Counterpart of ``deeplearning4j_tpu/ops/nn.py`` (and ``ops/shape.py``'s
``space_to_depth``). The functions above take the layers' NCHW
arguments. Layouts are the JAX package's: activations NCHW, conv weights OIHW,
transposed-conv weights ``[I, O, kH, kW]``, depthwise weights ``[mult, C,
kH, kW]``. Convolutions and pooling go to ``F.conv2d``,
``F.conv_transpose2d``, ``F.max_pool2d`` and ``F.avg_pool2d`` (cuDNN on the
card), backward included through autograd, as the JAX package leaves them to
XLA outside any Pallas kernel.

Random draws (:func:`dropout_mask`, :func:`normal`) come from an explicit
``torch.Generator``; they are module functions so that the tests can inject
the JAX package's draws into both packages.

Padding is explicit (``(ph, pw)``) or the string ``"SAME"``, the JAX
package's ``lax`` padding: per spatial axis a total of ``max((ceil(in / s) -
1) * s + k_eff - in, 0)`` with the smaller half first, so the output is
``ceil(in / s)``. ``F.conv2d(padding="same")`` refuses a stride above 1 and
pads the other way round, so :func:`same_pads` computes the amounts and
``F.pad`` applies them: zeros for convolutions, average and p-norm pooling
(which then divide by the kernel area, padding included, as the JAX
package's ``reduce_window`` sum does), ``-inf`` for max pooling.

:func:`batchnorm_train` is the training form with the JAX package's hand
backward (a ``torch.autograd.Function``), not ``F.batch_norm(training=True)``:
that one recentres differently and feeds the running variance the unbiased
batch variance, where the JAX package uses the biased one.

:func:`multi_head_dot_product_attention` keeps the JAX package's dispatch:
self-attention (``tq == tk``) that the Hopper gate takes goes, while
``Environment.allow_pallas()`` is on (``DL4J_TPU_ALLOW_PALLAS``), to
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

from ..common.environment import Environment
from ..common.profiler import OpProfiler
from .attention import flash_attention, supports_flash

Pair = Union[int, Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> Tuple[int, int]:
    """``(before, after)`` of TF's SAME padding on one axis (``lax``'s
    ``padtype_to_pads`` over the dilated kernel)."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel, strides, dilation=(1, 1),
              value: float = 0.0) -> torch.Tensor:
    (kh, kw), (sh, sw), (dh, dw) = _pair(kernel), _pair(strides), \
        _pair(dilation)
    top, bottom = same_pads(x.shape[2], kh, sh, dh)
    left, right = same_pads(x.shape[3], kw, sw, dw)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def _is_same(padding) -> bool:
    if isinstance(padding, str):
        if padding.upper() != "SAME":
            raise ValueError(f"padding {padding!r}: 'SAME' or (ph, pw)")
        return True
    return False


def _add_bias(out: torch.Tensor, b) -> torch.Tensor:
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1).to(out.dtype)
    return out


def conv2d(x: torch.Tensor, w: torch.Tensor, b=None, strides: Pair = (1, 1),
           padding: Union[Pair, str] = (0, 0), dilation: Pair = (1, 1),
           groups: int = 1) -> torch.Tensor:
    """2D convolution. x: NCHW; w: OIHW (``[O, I / groups, kH, kW]``);
    ``padding`` explicit or ``"SAME"``."""
    if _is_same(padding):
        x = _pad_same(x, w.shape[2:], strides, dilation)
        padding = (0, 0)
    out = F.conv2d(x, w, None, stride=_pair(strides), padding=_pair(padding),
                   dilation=_pair(dilation), groups=int(groups))
    return _add_bias(out, b).to(x.dtype)


def conv1d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
           padding: Union[int, str] = 0, dilation: int = 1) -> torch.Tensor:
    """1D convolution. x: ``[N, C, W]``; w: ``[O, I, K]``; ``padding``
    explicit or ``"SAME"``: the 2D convolution over a width-1 axis, as the
    JAX op computes it (``ops/nn.py:71-86``)."""
    pad = padding if isinstance(padding, str) else (int(padding), 0)
    out = conv2d(x[..., None], w[..., None], b, strides=(stride, 1),
                 padding=pad, dilation=(dilation, 1))
    return out[..., 0]


def deconv2d(x: torch.Tensor, w: torch.Tensor, b=None,
             strides: Pair = (1, 1),
             padding: Union[Pair, str] = (0, 0)) -> torch.Tensor:
    """Transposed convolution, w ``[I, O, kH, kW]`` (``ops/nn.py:105-139``
    of the JAX package). The JAX op is the lhs-dilated convolution with the
    flipped kernel, padded ``(k - 1 - p, k - 1 - p)``, or under SAME
    (output = input x stride) ``(k - 1 - pb, k - 1 - pe + max(s - k, 0))``
    with ``pb, pe`` the halves of ``max(k - s, 0)``. ``F.conv_transpose2d``
    without padding gives that convolution padded ``(k - 1, k - 1)``; the
    difference is cropped (or, where the JAX padding reaches past the
    input, zero-filled: no kernel tap meets the input there)."""
    sh, sw = _pair(strides)
    kh, kw = w.shape[2], w.shape[3]
    pads = []
    for k, s, p in ((kh, sh, 0), (kw, sw, 1)):
        if _is_same(padding):
            tot = max(k - s, 0)
            lo, hi = k - 1 - tot // 2, k - 1 - (tot - tot // 2) + max(s - k, 0)
        else:
            lo = hi = k - 1 - _pair(padding)[p]
        pads.append((lo - (k - 1), hi - (k - 1)))
    out = F.conv_transpose2d(x, w, None, stride=(sh, sw))
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        out = F.pad(out, (left, right, top, bottom))
    return _add_bias(out, b).to(x.dtype)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, b=None,
                     strides: Pair = (1, 1),
                     padding: Union[Pair, str] = (0, 0),
                     dilation: Pair = (1, 1)) -> torch.Tensor:
    """Depthwise convolution, w ``[mult, C, kH, kW]``: the grouped
    convolution of ``w.transpose(1, 0).reshape(C * mult, 1, kH, kW)``, so
    output channel ``c * mult + m`` is input channel ``c`` under
    ``w[m, c]`` (``ops/nn.py:143-162`` of the JAX package)."""
    mult, c = w.shape[0], w.shape[1]
    wg = w.transpose(0, 1).reshape(c * mult, 1, w.shape[2], w.shape[3])
    return conv2d(x, wg, b, strides, padding, dilation, groups=c)


def sconv2d(x: torch.Tensor, depth_w: torch.Tensor, point_w=None, b=None,
            strides: Pair = (1, 1),
            padding: Union[Pair, str] = (0, 0)) -> torch.Tensor:
    """Separable convolution: depthwise, then the 1x1 pointwise ``point_w``
    ``[O, C * mult, 1, 1]``, then the bias (``ops/nn.py:166-175``)."""
    out = depthwise_conv2d(x, depth_w, None, strides, padding)
    if point_w is not None:
        out = conv2d(out, point_w)
    return _add_bias(out, b)


def _pool_pad(x, kernel, strides, padding, value):
    if _is_same(padding):
        return _pad_same(x, kernel, strides, value=value)
    ph, pw = _pair(padding)
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph), value=value)
    return x


def maxpool2d(x: torch.Tensor, kernel: Pair = (2, 2), strides: Pair = (2, 2),
              padding: Union[Pair, str] = (0, 0)) -> torch.Tensor:
    """Max pooling: padded cells are -inf, as in the JAX package's
    ``reduce_window`` with a -inf init, so they never win (the ResNet-50
    stem uses kernel (3,3), stride (2,2), pad (1,1))."""
    x = _pool_pad(x, kernel, strides, padding, float("-inf"))
    return F.max_pool2d(x, _pair(kernel), _pair(strides))


def avgpool2d(x: torch.Tensor, kernel: Pair = (2, 2), strides: Pair = (2, 2),
              padding: Union[Pair, str] = (0, 0)) -> torch.Tensor:
    """Average pooling as the JAX package computes it (``ops/nn.py:178-
    199``): the window sum over zero padding divided by ``kH * kW``, the
    padding counted, under SAME too."""
    x = _pool_pad(x, kernel, strides, padding, 0.0)
    return F.avg_pool2d(x, _pair(kernel), _pair(strides))


def pnormpool2d(x: torch.Tensor, kernel: Pair = (2, 2),
                strides: Pair = (2, 2), padding: Union[Pair, str] = (0, 0),
                pnorm: int = 2) -> torch.Tensor:
    """``(sum |x|^p)^(1/p)`` over each window, zero padding
    (``ops/nn.py:211-223``)."""
    x = _pool_pad(x.abs() ** pnorm, kernel, strides, padding, 0.0)
    s = F.avg_pool2d(x, _pair(kernel), _pair(strides), divisor_override=1)
    return s ** (1.0 / pnorm)


def upsampling2d(x: torch.Tensor, factor: Pair = (2, 2)) -> torch.Tensor:
    """Nearest-neighbour upsampling of NCHW: each row repeated ``fh`` and
    each column ``fw`` times."""
    fh, fw = _pair(factor)
    return x.repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)


def lrn(x: torch.Tensor, depth: int = 5, bias: float = 1.0,
        alpha: float = 1.0, beta: float = 0.5) -> torch.Tensor:
    """Local response normalization across channels (NCHW), DL4J's form:
    ``x / (bias + alpha * sum(x^2 over depth channels))^beta``, alpha on
    the window sum itself (``F.local_response_norm`` divides it by
    ``depth`` first: another function)."""
    half = depth // 2
    sq = F.pad(x * x, (0, 0, 0, 0, half, half))
    c = x.shape[1]
    windows = sq[:, 0:c]
    for i in range(1, depth):
        windows = windows + sq[:, i:i + c]
    return x / torch.pow(bias + alpha * windows, beta)


def space_to_depth(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """NCHW space-to-depth in the JAX op's channel order (``ops/shape.py:
    409-418``, through NHWC): output channel ``(i * b + j) * C + c`` holds
    input channel ``c`` at offset ``(i, j)`` of each block."""
    n, c, h, w = x.shape
    b = block_size
    x = x.permute(0, 2, 3, 1).reshape(n, h // b, b, w // b, b, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b, b * b * c)
    return x.permute(0, 3, 1, 2)


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
    through flash attention while ``Environment.allow_pallas()`` (the JAX
    package's switch for its flash kernel) is on, the rest densely (see the
    module docstring)."""
    b, tq, _ = q.shape
    tk = k.shape[1]

    def split_heads(x, w):
        proj = x @ w                                   # [B, T, H*dh]
        return proj.reshape(b, x.shape[1], num_heads, -1).permute(0, 2, 1, 3)

    qh, kh, vh = split_heads(q, wq), split_heads(k, wk), split_heads(v, wv)
    dh = qh.shape[-1]
    prof = OpProfiler.get()
    if (tq == tk and Environment.get().allow_pallas()
            and supports_flash(tq, dh)):
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


def conv3d(x: torch.Tensor, w: torch.Tensor, b=None, strides=(1, 1, 1),
           padding: Union[Tuple[int, int, int], str] = (0, 0, 0),
           dilation=(1, 1, 1)) -> torch.Tensor:
    """3D convolution (``ops/nn.py:87-101`` of the JAX package). x: NCDHW;
    w: ``[O, I, kD, kH, kW]``; ``padding`` explicit or ``"SAME"``."""
    s = tuple(int(v) for v in strides)
    d = tuple(int(v) for v in dilation)
    if _is_same(padding):
        pads = [same_pads(x.shape[2 + i], w.shape[2 + i], s[i], d[i])
                for i in range(3)]
        x = F.pad(x, (*pads[2], *pads[1], *pads[0]))
        padding = (0, 0, 0)
    out = F.conv3d(x, w, None, stride=s,
                   padding=tuple(int(v) for v in padding), dilation=d)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1, 1).to(out.dtype)
    return out.to(x.dtype)


def _pool3d_pad(x, padding, value):
    p = tuple(int(v) for v in padding)
    if any(p):
        x = F.pad(x, (p[2], p[2], p[1], p[1], p[0], p[0]), value=value)
    return x


def maxpool3d(x: torch.Tensor, kernel=(2, 2, 2), strides=(2, 2, 2),
              padding=(0, 0, 0)) -> torch.Tensor:
    """Max pooling over NCDHW, padded cells -inf (``reduce_window``)."""
    x = _pool3d_pad(x, padding, float("-inf"))
    return F.max_pool3d(x, tuple(kernel), tuple(strides))


def avgpool3d(x: torch.Tensor, kernel=(2, 2, 2), strides=(2, 2, 2),
              padding=(0, 0, 0)) -> torch.Tensor:
    """The window sum over zero padding divided by the kernel volume."""
    x = _pool3d_pad(x, padding, 0.0)
    return F.avg_pool3d(x, tuple(kernel), tuple(strides))


def upsampling3d(x: torch.Tensor, factor=(2, 2, 2)) -> torch.Tensor:
    f = tuple(int(v) for v in factor)
    return (x.repeat_interleave(f[0], dim=2)
            .repeat_interleave(f[1], dim=3).repeat_interleave(f[2], dim=4))


def normal(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard normal draws from ``generator`` in ``dtype`` (the JAX
    package's ``jax.random.normal``: threefry; the bits differ, the law is
    the same)."""
    if generator is None:
        raise ValueError("training-mode noise needs a torch.Generator (the "
                         "network's own)")
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=device)


def alpha_dropout(x: torch.Tensor, rate: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """SELU-preserving dropout (``ops/nn.py:429-437``): dropped elements
    take SELU's negative saturation, then the affine ``a * . + b`` that
    keeps the mean and the variance."""
    alpha_p = -1.7580993408473766
    keep = 1.0 - rate
    mask = dropout_mask(x.shape, rate, generator, x.device)
    a = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    b = -a * alpha_p * (1 - keep)
    sat = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return (a * torch.where(mask, x, sat) + b).to(x.dtype)


def gaussian_dropout(x: torch.Tensor, rate: float,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
    """Multiplicative ``N(1, rate / (1 - rate))`` noise."""
    std = (rate / (1.0 - rate)) ** 0.5
    return (x * (1.0 + std * normal(x.shape, generator, x.dtype,
                                    x.device))).to(x.dtype)


def gaussian_noise(x: torch.Tensor, stddev: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Additive ``N(0, stddev)`` noise."""
    return (x + stddev * normal(x.shape, generator, x.dtype,
                                x.device)).to(x.dtype)


# --- the registry's nn family ----------------------------------------------------
#
# The JAX package's ``nn`` ops (32) with its signatures: ``data_format``
# ("NCHW" or "NHWC"; "NCW" or "NWC" for conv1d) and padding as ``(ph, pw)``,
# "SAME" or "VALID". An NHWC input is permuted to NCHW for the functions
# above and the result permuted back. The dropout and noise ops take the
# JAX op's ``key`` place with a ``torch.Generator`` (or an int seed for a
# new one on the input's device); SameDiff passes its own generator in
# training and runs them as the identity outside it, as the JAX SameDiff
# does.

from .registry import op  # noqa: E402


def _valid(padding, n: int = 2):
    """The JAX ops' padding argument with "VALID" as explicit zeros."""
    if isinstance(padding, str) and padding.upper() == "VALID":
        return (0,) * n
    return padding


def _to_nchw(x, data_format: str):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x, data_format: str):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


@op("conv2d", "nn")
def conv2d_op(x, w, b=None, strides=(1, 1), padding=(0, 0), dilation=(1, 1),
              data_format: str = "NCHW", groups: int = 1):
    """2D convolution. x: NCHW or NHWC; w: OIHW (``[O, I / groups, kH,
    kW]``)."""
    out = conv2d(_to_nchw(x, data_format), w, b, strides, _valid(padding),
                 dilation, groups)
    return _from_nchw(out, data_format)


@op("conv1d", "nn")
def conv1d_op(x, w, b=None, stride: int = 1, padding=0, dilation: int = 1,
              data_format: str = "NCW"):
    """x: ``[N, C, W]`` (NCW) or ``[N, W, C]`` (NWC); w: ``[O, I, K]``."""
    if data_format != "NCW":
        x = x.transpose(1, 2)
    valid = isinstance(padding, str) and padding.upper() == "VALID"
    out = conv1d(x, w, b, stride, 0 if valid else padding, dilation)
    return out if data_format == "NCW" else out.transpose(1, 2)


@op("conv3d", "nn")
def conv3d_op(x, w, b=None, strides=(1, 1, 1), padding=(0, 0, 0),
              dilation=(1, 1, 1), data_format: str = "NCDHW"):
    """x: NCDHW; w: ``[O, I, kD, kH, kW]``."""
    return conv3d(x, w, b, strides, _valid(padding, 3), dilation)


@op("deconv2d", "nn")
def deconv2d_op(x, w, b=None, strides=(1, 1), padding=(0, 0),
                data_format: str = "NCHW"):
    """Transposed convolution, w ``[I, O, kH, kW]``."""
    out = deconv2d(_to_nchw(x, data_format), w, b, strides, _valid(padding))
    return _from_nchw(out, data_format)


@op("depthwise_conv2d", "nn")
def depthwise_conv2d_op(x, w, b=None, strides=(1, 1), padding=(0, 0),
                        dilation=(1, 1), data_format: str = "NCHW"):
    """w: ``[depthMult, C, kH, kW]``."""
    out = depthwise_conv2d(_to_nchw(x, data_format), w, b, strides,
                           _valid(padding), dilation)
    return _from_nchw(out, data_format)


@op("sconv2d", "nn")
def sconv2d_op(x, depth_w, point_w=None, b=None, strides=(1, 1),
               padding=(0, 0), data_format: str = "NCHW"):
    """Separable convolution: depthwise, then the 1x1 pointwise."""
    out = sconv2d(_to_nchw(x, data_format), depth_w, point_w, b, strides,
                  _valid(padding))
    return _from_nchw(out, data_format)


@op("maxpool2d", "nn")
def maxpool2d_op(x, kernel=(2, 2), strides=(2, 2), padding=(0, 0),
                 data_format: str = "NCHW"):
    out = maxpool2d(_to_nchw(x, data_format), kernel, strides,
                    _valid(padding))
    return _from_nchw(out, data_format)


@op("avgpool2d", "nn")
def avgpool2d_op(x, kernel=(2, 2), strides=(2, 2), padding=(0, 0),
                 data_format: str = "NCHW"):
    """The window sum divided by the kernel area, padding counted."""
    out = avgpool2d(_to_nchw(x, data_format), kernel, strides,
                    _valid(padding))
    return _from_nchw(out, data_format)


@op("pnormpool2d", "nn")
def pnormpool2d_op(x, kernel=(2, 2), strides=(2, 2), padding=(0, 0),
                   pnorm: int = 2, data_format: str = "NCHW"):
    out = pnormpool2d(_to_nchw(x, data_format), kernel, strides,
                      _valid(padding), pnorm)
    return _from_nchw(out, data_format)


op("maxpool3d", "nn")(maxpool3d)
op("avgpool3d", "nn")(avgpool3d)
op("upsampling3d", "nn")(upsampling3d)


@op("global_avgpool", "nn")
def global_avgpool_op(x, data_format: str = "NCHW"):
    return x.mean(dim=(2, 3) if data_format == "NCHW" else (1, 2))


@op("upsampling2d", "nn")
def upsampling2d_op(x, factor=(2, 2), data_format: str = "NCHW"):
    return _from_nchw(upsampling2d(_to_nchw(x, data_format), factor),
                      data_format)


@op("im2col", "nn")
def im2col(x, kernel=(2, 2), strides=(1, 1), padding=(0, 0),
           dilation=(1, 1)):
    """NCHW patches as ``[N, C, kH, kW, oH, oW]``."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(strides)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, c, h, w = x.shape
    xp = F.pad(x, (pw, pw, ph, ph))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    patches = [xp[:, :, i * dh:i * dh + oh * sh:sh,
                  j * dw:j * dw + ow * sw:sw]
               for i in range(kh) for j in range(kw)]
    return torch.stack(patches, dim=2).reshape(n, c, kh, kw, oh, ow)


op("batchnorm", "nn")(batchnorm)
op("batchnorm_train", "nn")(batchnorm_train)
op("layer_norm", "nn")(layer_norm)
op("lrn", "nn")(lrn)
op("linear", "nn")(linear)
op("dot_product_attention", "nn")(dot_product_attention)
op("multi_head_dot_product_attention", "nn")(multi_head_dot_product_attention)


def _generator(key, device) -> torch.Generator:
    """The generator a dropout or noise op draws from: ``key`` itself, or a
    new one on ``device`` seeded with the int ``key``."""
    if isinstance(key, torch.Generator):
        return key
    if isinstance(key, int):
        return torch.Generator(device=device).manual_seed(key)
    raise TypeError(f"a dropout or noise op takes a torch.Generator or an "
                    f"int seed as its key, not {type(key).__name__}")


@op("dropout", "nn")
def dropout_op(x, key, rate: float, inverted: bool = True):
    """Dropout keeping each element with probability ``1 - rate``; with
    ``inverted`` the kept ones are scaled by ``1 / (1 - rate)``."""
    keep = dropout_mask(x.shape, rate, _generator(key, x.device), x.device)
    if inverted:
        return dropout(x, rate, keep=keep)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@op("alpha_dropout", "nn")
def alpha_dropout_op(x, key, rate: float):
    return alpha_dropout(x, rate, _generator(key, x.device))


@op("gaussian_dropout", "nn")
def gaussian_dropout_op(x, key, rate: float):
    return gaussian_dropout(x, rate, _generator(key, x.device))


@op("gaussian_noise", "nn")
def gaussian_noise_op(x, key, stddev: float):
    return gaussian_noise(x, stddev, _generator(key, x.device))


@op("bias_add", "nn")
def bias_add(x, b, data_format: str = "NCHW"):
    if x.dim() == 4:
        shape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        return x + b.reshape(shape)
    return x + b


@op("embedding_lookup", "nn")
def embedding_lookup(table, ids):
    from .shape import gather

    return gather(table, ids, 0)


@op("xw_plus_b", "nn")
def xw_plus_b(x, w, b):
    return x @ w + b


@op("relu_layer", "nn")
def relu_layer(x, w, b):
    return torch.clamp_min(x @ w + b, 0)


@op("log_sigmoid", "nn")
def log_sigmoid(x):
    return F.logsigmoid(x)


@op("softmax_bp", "nn")
def softmax_bp(x, grad, axis: int = -1):
    """The VJP of softmax, as an op."""
    s = torch.softmax(x, dim=axis)
    return s * (grad - torch.sum(grad * s, dim=axis, keepdim=True))
