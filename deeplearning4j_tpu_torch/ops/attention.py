"""Flash attention: blockwise online-softmax attention, forward and backward.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py``. The CUDA
kernel ``csrc/flash_attention.cu`` replaces its TPU kernel ``_fa_kernel``
(launched by ``_fa_forward``,
``deeplearning4j_tpu/ops/pallas_attention.py:51``).

- :func:`flash_attention` is the entry, with the JAX package's signature:
  q, k, v ``[B, H, T, D]`` (or ``[B, T, D]`` for one head), ``causal``,
  ``sm_scale`` (default ``1/sqrt(D)``), an additive logits ``bias``
  broadcastable to ``[B, H, T, T]``, ``block_q``/``block_k``. It casts to
  float32 and back, as the JAX package does (``:345-360``), and broadcasts
  the bias outside the autograd function (``expand``, a view with zero
  strides, not a copy), so the bias gradient sums back to the caller's
  shape through the broadcast's own backward.
- :class:`_FlashAttention` is the ``torch.autograd.Function``. Its forward
  launches the kernel for CUDA tensors (:func:`flash_attention_cuda`, which
  never falls back) and runs the plain version for CPU tensors
  (:func:`flash_attention_reference`). Its backward is a plain PyTorch port
  of ``_row_stats`` and ``_fa_backward`` (``:168``, ``:199``): in the JAX
  package it is an XLA ``lax.scan`` over k blocks, not a Pallas kernel, so it
  is a loop over k blocks here. It recomputes the row max and denominator
  (the forward saves neither) and builds the ``[B*H, T, T]`` bias gradient
  only when the bias needs one.

**The Hopper gate** (:func:`supports_flash`) is the port's own. The JAX gate
(``supports_flash``, ``:306-312``: ``T % block == 0``, ``block_q % 8``,
``block_k % 128``) is Mosaic's tiling; the CUDA kernel walks 64-row tiles
and masks the tail, so it takes any ``T >= 1``. It needs the head size
``D`` to be a multiple of 4 (16-byte loads) and at most 128 (its shared
memory and registers). So the port launches where the JAX package would
not: any ``T`` that is not a multiple of 128 (below 1024) or of 1024
(above), e.g. ``T = 64`` or ``T = 200``. The JAX package launches where
the port does not for ``D > 128`` or ``D % 4 != 0``; there the attention
layers take the dense path.

``block_q``/``block_k`` keep their meaning as tuning knobs: they change the
order of the sums, not the result. The plain version and the backward walk
k blocks of ``block_k`` (default 64, the kernel's tile; blocks shrink to
``T``). The kernel's tile is fixed at 64 x 64 by its shared memory and
registers, so on the card the blocks set only the backward's blocking.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from . import cuda_lib

KERNEL_NAME = "flash_attention"
SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
REPLACES = "deeplearning4j_tpu/ops/pallas_attention.py:51"

#: the kernel's tile (q rows and k rows), and the default blocks
TILE = 64
DEFAULT_BLOCK_Q = TILE
DEFAULT_BLOCK_K = TILE
MAX_HEAD_SIZE = 128

#: kernel launches made by :func:`flash_attention_cuda` (and nothing else)
flash_attention_launches = 0
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    global flash_attention_launches
    with _LAUNCH_LOCK:
        flash_attention_launches = 0


def pick_blocks(T: int, block_q: Optional[int] = None,
                block_k: Optional[int] = None):
    bq = block_q or min(DEFAULT_BLOCK_Q, T)
    bk = block_k or min(DEFAULT_BLOCK_K, T)
    return bq, bk


def supports_flash(T: int, d: int, block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> bool:
    """The Hopper gate: any ``T >= 1``, a head size ``d`` that is a multiple
    of 4 up to 128, positive blocks."""
    bq, bk = pick_blocks(T, block_q, block_k)
    return (T >= 1 and bq >= 1 and bk >= 1
            and 4 <= d <= MAX_HEAD_SIZE and d % 4 == 0)


def _bias_block(bias: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """Columns ``k0:k1`` of a ``[B, H, T, T]`` bias as ``[B*H, T, k1-k0]``."""
    b, h, t, _ = bias.shape
    return bias[..., k0:k1].reshape(b * h, t, k1 - k0)


def _masked_scores(s, bias, causal, k0, k1):
    """Add the bias block and mask causal positions (qpos < kpos) to -inf."""
    if bias is not None:
        s = s + _bias_block(bias, k0, k1)
    if causal:
        T = s.shape[1]
        qpos = torch.arange(T, device=s.device)[:, None]
        kpos = torch.arange(k0, k1, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              causal: bool = False,
                              bias: Optional[torch.Tensor] = None,
                              block_k: int = DEFAULT_BLOCK_K) -> torch.Tensor:
    """Plain PyTorch version of the kernel: q, k, v ``[B*H, T, D]`` float32,
    ``bias`` None or ``[B, H, T, T]`` (any strides). An online softmax over
    k blocks of ``block_k`` in float32, with ``_fa_kernel``'s guards: q is
    scaled before the product; ``safe`` is the running max where finite,
    else 0; ``p`` is 0 where the score is not finite; ``alpha`` is 0 where
    the old max is not finite; the output is ``acc / max(l, 1e-30)``."""
    bh, T, d = q.shape
    qs = q * scale
    m = torch.full((bh, T), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((bh, T), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        s = _masked_scores(qs @ k[:, k0:k1].transpose(1, 2), bias, causal,
                           k0, k1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]),
                        zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), zero)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, k0:k1]
        m = m_new
    return acc / l.clamp_min(1e-30)[..., None]


def _row_stats(q, k, scale, causal, block_k, bias):
    """The softmax row max (0 where not finite) and denominator, recomputed
    blockwise: ``_row_stats`` of the JAX package (the product is scaled
    after it, as there)."""
    bh, T, _ = q.shape
    m = torch.full((bh, T), float("-inf"), dtype=q.dtype, device=q.device)
    l = torch.zeros((bh, T), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        s = _masked_scores((q @ k[:, k0:k1].transpose(1, 2)) * scale, bias,
                           causal, k0, k1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]),
                        zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), zero)
        l = l * alpha + p.sum(dim=-1)
        m = m_new
    return torch.where(torch.isfinite(m), m, zero), l


def flash_attention_backward(q, k, v, o, do, scale: float, causal: bool,
                             block_k: int, bias=None,
                             need_dbias: bool = False):
    """``_fa_backward`` of the JAX package, a loop over k blocks with no
    ``[T, T]`` buffer unless ``need_dbias``:
    ``p = exp(s - m) / l``, ``D = sum(dO * O)``, ``dV_j = p^T dO``,
    ``dS = p * (dO V^T - D)``, ``dQ += dS K * scale``,
    ``dK_j = dS^T Q * scale``, and ``dBias = dS`` (the bias adds to the
    scaled logits). Returns ``(dq, dk, dv)`` or ``(dq, dk, dv, dbias)``
    with ``dbias`` ``[B*H, T, T]``."""
    bh, T, _ = q.shape
    m, l = _row_stats(q, k, scale, causal, block_k, bias)
    den = l.clamp_min(1e-30)[..., None]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    D = (do * o).sum(dim=-1)
    dq = torch.zeros_like(q)
    dks, dvs, dss = [], [], []
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        ks, vs = k[:, k0:k1], v[:, k0:k1]
        s = _masked_scores((q @ ks.transpose(1, 2)) * scale, bias, causal,
                           k0, k1)
        p = torch.where(torch.isfinite(s), torch.exp(s - m[..., None]),
                        zero) / den
        dvs.append(p.transpose(1, 2) @ do)
        ds = p * (do @ vs.transpose(1, 2) - D[..., None])
        dq = dq + (ds @ ks) * scale
        dks.append((ds.transpose(1, 2) @ q) * scale)
        if need_dbias:
            dss.append(ds)
    grads = (dq, torch.cat(dks, dim=1), torch.cat(dvs, dim=1))
    if need_dbias:
        grads = grads + (torch.cat(dss, dim=2),)
    return grads


def _check_cuda_args(q, k, v, bias) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.ndim != 3:
        raise ValueError(f"the flash_attention kernel takes [B*H, T, D], got "
                         f"shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dtype != torch.float32 or t.device != q.device
                or t.shape != q.shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"the flash_attention kernel needs {name} as a "
                             f"contiguous, 16-byte aligned float32 "
                             f"{tuple(q.shape)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    bh, T, d = q.shape
    if not supports_flash(T, d):
        raise ValueError(f"the flash_attention kernel takes a head size that "
                         f"is a multiple of 4 up to {MAX_HEAD_SIZE}, got "
                         f"T={T}, D={d}")
    if bh >= 2 ** 31 or (T + TILE - 1) // TILE > 65535:
        raise ValueError(f"tensor too large for the flash_attention kernel "
                         f"(B*H={bh}, T={T})")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != q.device
                or bias.ndim != 4 or tuple(bias.shape[2:]) != (T, T)
                or bias.shape[0] * bias.shape[1] != bh):
            raise ValueError(f"the flash_attention kernel needs the bias as "
                             f"a float32 [B, H, {T}, {T}] view with B*H={bh} "
                             f"on {q.device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")


def _bind(lib: ctypes.CDLL):
    fn = lib.dl4j_flash_attention_fwd
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, p, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool = False,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream: q, k,
    v ``[B*H, T, D]`` float32, ``bias`` None or a float32 ``[B, H, T, T]``
    view (read through its strides). Raises on anything the kernel does not
    take, and when the launch fails."""
    global flash_attention_launches
    _check_cuda_args(q, k, v, bias)
    bh, T, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind(lib)
    if bias is None:
        bptr, strides, heads = None, (0, 0, 0, 0), 1
    else:
        bptr, strides, heads = bias.data_ptr(), bias.stride(), bias.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, *strides,
                 heads, out.data_ptr(), bh, T, d, float(scale), int(causal),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                           f"{err} ({cuda_lib.error_string(lib, err)})")
    with _LAUNCH_LOCK:
        flash_attention_launches += 1
    return out


def _forward(q, k, v, bias, scale, causal, block_k):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, causal, bias,
                                         block_k)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, scale, causal, bias)
    raise ValueError(f"flash_attention has no implementation for {q.device}")


class _FlashAttention(torch.autograd.Function):
    """q, k, v ``[B*H, T, D]`` float32 and an optional ``[B, H, T, T]``
    bias; the blockwise backward of the JAX package."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, causal: bool,
                block_k: int):
        o = _forward(q, k, v, bias, scale, causal, block_k)
        ctx.save_for_backward(q, k, v, o, bias)
        ctx.scale, ctx.causal, ctx.block_k = scale, causal, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, bias = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = flash_attention_backward(q, k, v, o, do, ctx.scale,
                                         ctx.causal, ctx.block_k, bias,
                                         need_dbias)
        dbias = grads[3].reshape(bias.shape) if need_dbias else None
        return grads[0], grads[1], grads[2], dbias, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise fused attention. q, k, v ``[B, H, T, D]`` (or ``[B, T, D]``
    for one head); returns the same shape and dtype. Raises where the gate
    refuses (:func:`supports_flash`); use ``dot_product_attention`` there.

    ``bias``: an additive logits bias broadcastable to ``[B, H, T, T]`` (a
    padding mask as ``where(mask, 0, -1e9)``, or a learned bias, which is
    differentiated: its gradient sums back through the broadcast)."""
    squeeze = q.ndim == 3
    if squeeze:
        q, k, v = q[:, None], k[:, None], v[:, None]
    b, h, T, d = q.shape
    block_q, block_k = pick_blocks(T, block_q, block_k)
    if not supports_flash(T, d, block_q, block_k):
        raise ValueError(
            f"flash_attention needs a head size that is a multiple of 4 up "
            f"to {MAX_HEAD_SIZE} (T={T}, D={d}, blocks {block_q}/{block_k}); "
            f"fall back to dot_product_attention")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    in_dtype = q.dtype
    f32 = torch.float32
    qf, kf, vf = (t.reshape(b * h, T, d).to(f32).contiguous()
                  for t in (q, k, v))
    bf = None
    if bias is not None:
        if squeeze and bias.ndim == 3:
            bias = bias[:, None]
        bf = bias.to(f32).expand(b, h, T, T)
    o = _FlashAttention.apply(qf, kf, vf, bf, float(scale), bool(causal),
                              int(block_k))
    o = o.reshape(b, h, T, d).to(in_dtype)
    return o[:, 0] if squeeze else o
