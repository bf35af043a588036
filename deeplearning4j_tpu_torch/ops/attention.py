"""Flash attention: blockwise online-softmax attention, forward and backward.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py``. The CUDA
kernel ``csrc/flash_attention.cu`` replaces its TPU kernel ``_fa_kernel``
(launched by ``_fa_forward``,
``deeplearning4j_tpu/ops/pallas_attention.py:51``).

- :func:`flash_attention` is the entry, with the JAX package's signature:
  q, k, v ``[B, H, T, D]`` (or ``[B, T, D]`` for one head), ``causal``,
  ``sm_scale`` (default ``1/sqrt(D)``), an additive logits ``bias``
  broadcastable to ``[B, H, T, T]``, ``block_q``/``block_k``. q, k and v
  may have any strides with a contiguous last dimension (the MHA op hands
  over permuted views of its projections); the result is a ``[B, H, T,
  D]`` view of a ``[B, T, H, D]`` buffer (:func:`heads_view`), so merging
  the heads afterwards copies nothing. It broadcasts the bias outside the
  autograd function (``expand``, a view with zero strides, not a copy), so
  the bias gradient sums back to the caller's shape through the
  broadcast's own backward.
- What runs, by device, dtype and shape (each route counts its launches;
  none falls back to another, and a failed launch raises):
  - bf16 CUDA q, k, v that :func:`bf16_kernel_takes` (the encoder's path):
    the bf16 kernel (:func:`flash_attention_bf16_cuda`: wgmma, TMA), which
    reads them as they lie: no cast and no copy. It computes what the JAX
    package computes on the float32 upcast (``:345-360``) and rounds the
    result once to bf16.
  - other CUDA inputs (float32; fp16; bf16 the gate refuses): cast to
    contiguous float32 ``[B*H, T, D]`` for the float32 kernel
    (:func:`flash_attention_cuda`: each operand split into TF32 hi and lo
    parts, three TF32 tensor-core products a product), the result cast
    back, as the JAX package casts.
  - CPU tensors: the plain version (:func:`flash_attention_reference`), in
    float32 on the upcast.
- :class:`_FlashAttention` is the ``torch.autograd.Function``. Its forward
  also returns each row's log-sum-exp, which it saves. Its backward is a
  plain PyTorch port of ``_fa_backward`` (``:199``) on the float32 upcast:
  in the JAX package it is an XLA ``lax.scan`` over k blocks, not a Pallas
  kernel, so it is a loop over k blocks here. It takes ``p = exp(s -
  lse)`` from the forward's log-sum-exp instead of recomputing the row
  statistics (``_row_stats``, ``:168``): one QK^T pass fewer. It builds
  the ``[B, H, T, T]`` bias gradient only when the bias needs one, and
  returns gradients in the inputs' dtype.

**The Hopper gate** (:func:`supports_flash`) is the port's own. The JAX gate
(``supports_flash``, ``:306-312``: ``T % block == 0``, ``block_q % 8``,
``block_k % 128``) is Mosaic's tiling; the CUDA kernel walks 64-row tiles
and masks the tail, so it takes any ``T >= 1``. It needs the head size
``D`` to be a multiple of 4 (16-byte loads) and at most 128 (its shared
memory and registers); the bf16 kernel takes a multiple of 8 (16-byte TMA
strides), the rest goes through the cast. So the port launches where the JAX package would
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

import contextlib
import ctypes
import math
import threading
from typing import Optional

import torch

from ..common import nan_panic
from ..common.profiler import OpProfiler
from . import cuda_lib

KERNEL_NAME = "flash_attention"
SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
REPLACES = "deeplearning4j_tpu/ops/pallas_attention.py:51"

#: the kernel's tile (q rows and k rows), and the default blocks
TILE = 64
DEFAULT_BLOCK_Q = TILE
DEFAULT_BLOCK_K = TILE
MAX_HEAD_SIZE = 128

#: kernel launches made by :func:`flash_attention_cuda` and
#: :func:`flash_attention_bf16_cuda` (and nothing else); each route also
#: counts its own in the OpProfiler (``attention/flash_bf16``,
#: ``attention/flash_f32``)
flash_attention_launches = 0
#: the launcher's code for a tensor map it could not encode (+ the CUresult)
ENCODE_ERROR = 10000
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


def _bias_block(bias: torch.Tensor, s: torch.Tensor, k0: int,
                k1: int) -> torch.Tensor:
    """Columns ``k0:k1`` of a ``[B, H, T, T]`` bias, shaped as the score
    block ``s`` (``[B, H, T, k]``, or ``[B*H, T, k]``)."""
    return bias[..., k0:k1].reshape(s.shape)


def _masked_scores(s, bias, causal, k0, k1):
    """Add the bias block and mask causal positions (qpos < kpos) to -inf."""
    if bias is not None:
        s = s + _bias_block(bias, s, k0, k1)
    if causal:
        T = s.shape[-2]
        qpos = torch.arange(T, device=s.device)[:, None]
        kpos = torch.arange(k0, k1, device=s.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    return s


def _keys(t: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    return t[..., k0:k1, :]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              causal: bool = False,
                              bias: Optional[torch.Tensor] = None,
                              block_k: int = DEFAULT_BLOCK_K,
                              with_lse: bool = False,
                              with_f32: bool = False):
    """Plain PyTorch version of the kernels: q, k, v ``[B, H, T, D]`` or
    ``[B*H, T, D]``, any strides and floating dtype, ``bias`` None or
    ``[B, H, T, T]`` (any strides). An online softmax over k blocks of
    ``block_k`` in float32 on the upcast inputs, with ``_fa_kernel``'s
    guards: q is scaled before the product; ``safe`` is the running max
    where finite, else 0; ``p`` is 0 where the score is not finite;
    ``alpha`` is 0 where the old max is not finite; the output is
    ``acc / max(l, 1e-30)``, returned in q's dtype. With ``with_lse`` it
    returns ``(out, lse)``, ``lse = safe + log(max(l, 1e-30))`` float32 of
    q's shape without D: finite even for a row masked everywhere.
    ``with_f32`` appends the output before its cast to q's dtype (float32,
    q's shape), as the kernel's float32 output."""
    f32 = torch.float32
    qf, kf, vf = (t.to(f32) for t in (q, k, v))
    T = q.shape[-2]
    qs = qf * scale
    m = torch.full(q.shape[:-1], float("-inf"), dtype=f32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=f32, device=q.device)
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    safe = zero
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        s = _masked_scores(qs @ _keys(kf, k0, k1).transpose(-1, -2), bias,
                           causal, k0, k1)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]),
                        zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), zero)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ _keys(vf, k0, k1)
        m = m_new
    den = l.clamp_min(1e-30)
    o32 = acc / den[..., None]
    out = o32.to(q.dtype)
    result = (out,) + ((safe + torch.log(den),) if with_lse else ()) + \
        ((o32,) if with_f32 else ())
    return result if len(result) > 1 else out


def flash_attention_backward(q, k, v, o, do, lse, scale: float,
                             causal: bool, block_k: int, bias=None,
                             need_dbias: bool = False):
    """``_fa_backward`` of the JAX package, a loop over k blocks with no
    ``[T, T]`` buffer unless ``need_dbias``, on the float32 upcast of q, k,
    v, o and dO (``[B, H, T, D]`` or ``[B*H, T, D]``, any strides), with
    the forward's log-sum-exp ``lse`` (q's shape without D) in place of
    recomputed row statistics: ``p = exp(s - lse)`` where s is finite,
    else 0; ``D = sum(dO * O)``, ``dV_j = p^T dO``, ``dS = p * (dO V^T -
    D)``, ``dQ += dS K * scale``, ``dK_j = dS^T Q * scale``, and ``dBias =
    dS`` (the bias adds to the scaled logits). Returns ``(dq, dk, dv)`` in
    the inputs' dtypes, or ``(dq, dk, dv, dbias)`` with ``dbias`` float32
    of the score shape (``[B, H, T, T]`` or ``[B*H, T, T]``)."""
    f32 = torch.float32
    qf, kf, vf, of, dof = (t.to(f32) for t in (q, k, v, o, do))
    T = q.shape[-2]
    zero = torch.zeros((), dtype=f32, device=q.device)
    D = (dof * of).sum(dim=-1)
    lse = lse.to(f32)[..., None]
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dks, dvs, dss = [], [], []
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        ks, vs = _keys(kf, k0, k1), _keys(vf, k0, k1)
        s = _masked_scores((qf @ ks.transpose(-1, -2)) * scale, bias, causal,
                           k0, k1)
        p = torch.where(torch.isfinite(s), torch.exp(s - lse), zero)
        dvs.append(p.transpose(-1, -2) @ dof)
        ds = p * (dof @ vs.transpose(-1, -2) - D[..., None])
        dq = dq + (ds @ ks) * scale
        dks.append((ds.transpose(-1, -2) @ qf) * scale)
        if need_dbias:
            dss.append(ds)
    grads = (dq.to(q.dtype), torch.cat(dks, dim=-2).to(k.dtype),
             torch.cat(dvs, dim=-2).to(v.dtype))
    if need_dbias:
        grads = grads + (torch.cat(dss, dim=-1),)
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
    if bh * ((T + TILE - 1) // TILE) >= 2 ** 31:
        raise ValueError(f"tensor too large for the flash_attention kernel "
                         f"(B*H={bh}, T={T})")
    _check_bias(bias, bh, T, q.device)


def _check_bias(bias, bh: int, T: int, device) -> None:
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != device
                or bias.ndim != 4 or tuple(bias.shape[2:]) != (T, T)
                or bias.shape[0] * bias.shape[1] != bh):
            raise ValueError(f"the flash_attention kernel needs the bias as "
                             f"a float32 [B, H, {T}, {T}] view with B*H={bh} "
                             f"on {device}, got {bias.dtype} "
                             f"{tuple(bias.shape)} on {bias.device}")


def _bind(lib: ctypes.CDLL):
    fn = lib.dl4j_flash_attention_fwd
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, i, p, p, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def _bias_args(bias):
    if bias is None:
        return None, (0, 0, 0, 0)
    return bias.data_ptr(), bias.stride()


def _on(device):
    """The device's context for a launch, or nothing when it is current
    already (switching costs the host time on every call)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _count(route: str) -> None:
    global flash_attention_launches
    with _LAUNCH_LOCK:
        flash_attention_launches += 1
    OpProfiler.get().count(route)


def _raise_launch(lib, err: int) -> None:
    if err >= ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"(CUresult {err - ENCODE_ERROR})")
    raise RuntimeError(f"flash_attention kernel launch failed: cudaError "
                       f"{err} ({cuda_lib.error_string(lib, err)})")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, causal: bool = False,
                         bias: Optional[torch.Tensor] = None,
                         with_lse: bool = False):
    """Launch the float32 kernel of ``csrc/flash_attention.cu`` on
    PyTorch's current stream: q, k, v ``[B*H, T, D]`` float32, ``bias``
    None or a float32 ``[B, H, T, T]`` view (read through its strides).
    Returns ``out``, or ``(out, lse)`` with ``lse`` float32 ``[B*H, T]``.
    Raises on anything the kernel does not take, and when the launch
    fails."""
    _check_cuda_args(q, k, v, bias)
    bh, T, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind(lib)
    bptr, strides = _bias_args(bias)
    heads = 1 if bias is None else bias.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bptr, *strides,
                 heads, out.data_ptr(),
                 None if lse is None else lse.data_ptr(), bh, T, d,
                 float(scale), int(causal), stream)
    if err != 0:
        _raise_launch(lib, err)
    _count("attention/flash_f32")
    nan_panic.check_kernel(KERNEL_NAME, out, lse)
    return (out, lse) if with_lse else out


# --- the bf16 kernel ----------------------------------------------------------

def _bf16_refusal(q, k, v) -> Optional[str]:
    """Why the bf16 kernel does not take q, k, v, or None if it does."""
    if q.device.type != "cuda":
        return f"needs CUDA tensors, got {q.device}"
    if q.ndim != 4:
        return f"takes [B, H, T, D], got shape {tuple(q.shape)}"
    b, h, T, d = q.shape
    if not (8 <= d <= MAX_HEAD_SIZE and d % 8 == 0):
        return f"takes a head size that is a multiple of 8 up to " \
               f"{MAX_HEAD_SIZE}, got {d}"
    if b * h * ((T + TILE - 1) // TILE) >= 2 ** 31:
        return f"tensor too large (B*H={b * h}, T={T})"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device \
                or t.shape != q.shape:
            return (f"needs {name} as bfloat16 {tuple(q.shape)} on "
                    f"{q.device}, got {t.dtype} {tuple(t.shape)} on "
                    f"{t.device}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                n > 1 and (st <= 0 or st % 8)
                for n, st in zip(t.shape[:3], t.stride()[:3])):
            return (f"needs {name} 16-byte aligned with a contiguous head "
                    f"dimension and the other strides positive multiples "
                    f"of 8 elements, got strides {t.stride()} at "
                    f"{t.data_ptr() % 16} bytes past 16")
    return None


def bf16_kernel_takes(q, k, v) -> bool:
    """The bf16 kernel's gate: bf16 CUDA q, k, v ``[B, H, T, D]`` of one
    shape, D a multiple of 8 up to 128, 16-byte aligned, the head dimension
    contiguous and the other strides multiples of 8 elements (16 bytes, the
    TMA's rule). The rest takes the float32 kernel through a cast."""
    return _bf16_refusal(q, k, v) is None


def _bind_bf16(lib: ctypes.CDLL):
    fn = lib.dl4j_flash_attention_bf16_fwd
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, ll, p, p, p,
                       ctypes.c_float, i, p]
        fn.restype = i
    return fn


def heads_view(b: int, h: int, T: int, d: int, dtype,
               device) -> torch.Tensor:
    """A new ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer: the
    layout the projections leave the heads in, so that merging the heads
    afterwards (``permute(0, 2, 1, 3).reshape(B, T, H*D)``) is a view."""
    return torch.empty((b, T, h, d), dtype=dtype,
                       device=device).permute(0, 2, 1, 3)


def flash_attention_bf16_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float,
                              causal: bool = False,
                              bias: Optional[torch.Tensor] = None,
                              with_lse: bool = False,
                              with_f32: bool = False):
    """Launch the bf16 kernel of ``csrc/flash_attention.cu`` (wgmma, TMA)
    on PyTorch's current stream: q, k, v bf16 ``[B, H, T, D]`` views read
    through their strides (:func:`bf16_kernel_takes`), ``bias`` None or a
    float32 ``[B, H, T, T]`` view. Returns ``out``, a bf16 ``[B, H, T, D]``
    view of a ``[B, T, H, D]`` buffer (:func:`heads_view`), or ``(out,
    lse)`` with ``lse`` float32 ``[B*H, T]``; ``with_f32`` appends the
    output before its rounding to bf16, float32 ``[B*H, T, D]`` (what the
    backward reads). Raises on anything the kernel does not take, and when
    the launch fails."""
    why = _bf16_refusal(q, k, v)
    if why is not None:
        raise ValueError(f"the bf16 flash_attention kernel {why}")
    return _launch_bf16(q, k, v, scale, causal, bias, with_lse, with_f32)


def _launch_bf16(q, k, v, scale, causal, bias, with_lse, with_f32=False):
    b, h, T, d = q.shape
    _check_bias(bias, b * h, T, q.device)
    out = heads_view(b, h, T, d, torch.bfloat16, q.device)
    lse = torch.empty((b * h, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    o32 = torch.empty((b * h, T, d), dtype=torch.float32, device=q.device) \
        if with_f32 else None
    result = (out,) + ((lse,) if with_lse else ()) + \
        ((o32,) if with_f32 else ())
    if out.numel() == 0:
        return result if len(result) > 1 else out
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind_bf16(lib)
    geom = (ctypes.c_longlong * 16)(
        b, h, T, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    bptr, strides = _bias_args(bias)
    with _on(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), geom, bptr,
                 *strides, out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 None if o32 is None else o32.data_ptr(), float(scale),
                 int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        _raise_launch(lib, err)
    _count("attention/flash_bf16")
    nan_panic.check_kernel(KERNEL_NAME, *result)
    return result if len(result) > 1 else out


def bf16_layout_check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """One tile of the bf16 kernel's two products on the card: q, k, v
    bf16 ``[64, 64]`` contiguous; returns ``(s, o)`` float32 ``[64, 64]``
    with ``s = q k^T`` (wgmma from shared memory) and ``o = (p_hi + p_lo)
    v`` for ``p = s`` (wgmma with p from the registers that held s). Not
    counted as a launch: it checks the register layout the kernel builds
    on."""
    for t in (q, k, v):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or tuple(t.shape) != (64, 64) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("bf16_layout_check takes contiguous, 16-byte "
                             "aligned bf16 [64, 64] CUDA tensors")
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty_like(s)
    lib = cuda_lib.load(KERNEL_NAME)
    fn = lib.dl4j_flash_bf16_layout_check
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, p, p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
                 o.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        _raise_launch(lib, err)
    return s, o


# --- the autograd function and the entry ----------------------------------------

def _forward(q, k, v, bias, scale, causal, block_k, with_f32=False):
    """q, k, v ``[B, H, T, D]`` (any strides) to ``(out, lse, o32)``:
    ``out`` in q's dtype as a :func:`heads_view`, ``lse`` float32 ``[B*H,
    T]``, and with ``with_f32`` the output before its cast to q's dtype,
    float32 (None without, or when ``out`` is float32 already). CPU tensors
    take the plain version; bf16 CUDA tensors that the bf16 kernel takes go
    to it as they lie; other CUDA tensors are cast to contiguous float32
    ``[B*H, T, D]`` for the float32 kernel."""
    b, h, T, d = q.shape
    if q.device.type == "cuda" and bf16_kernel_takes(q, k, v):
        if with_f32:
            return _launch_bf16(q, k, v, scale, causal, bias, True, True)
        return _launch_bf16(q, k, v, scale, causal, bias, True) + (None,)
    if q.device.type == "cpu" and with_f32 and q.dtype != torch.float32:
        # the float32 result, cast into ``out`` below as the kernels cast
        _, lse, o = flash_attention_reference(q, k, v, scale, causal, bias,
                                              block_k, with_lse=True,
                                              with_f32=True)
    elif q.device.type == "cpu":
        o, lse = flash_attention_reference(q, k, v, scale, causal, bias,
                                           block_k, with_lse=True)
    elif q.device.type == "cuda":
        f32 = torch.float32
        qf, kf, vf = (t.reshape(b * h, T, d).to(f32).contiguous()
                      for t in (q, k, v))
        o, lse = flash_attention_cuda(qf, kf, vf, scale, causal, bias,
                                      with_lse=True)
    else:
        raise ValueError(f"flash_attention has no implementation for "
                         f"{q.device}")
    out = heads_view(b, h, T, d, q.dtype, q.device)
    out.copy_(o.view(b, h, T, d))
    o32 = o.view(b * h, T, d) if with_f32 and q.dtype != torch.float32 \
        else None
    return out, lse.reshape(b * h, T), o32


class _FlashAttention(torch.autograd.Function):
    """q, k, v ``[B, H, T, D]`` (any strides, one floating dtype) and an
    optional float32 ``[B, H, T, T]`` bias; saves the log-sum-exp and the
    float32 output for the blockwise backward of the JAX package, whose
    residual is the float32 output of the upcast inputs
    (``pallas_attention.py:345-347``): for bf16 inputs the backward's ``D =
    sum(dO * O)`` reads O before its rounding to bf16."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float, causal: bool,
                block_k: int):
        o, lse, o32 = _forward(q, k, v, bias, scale, causal, block_k,
                               with_f32=True)
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, bias, lse)
        ctx.scale, ctx.causal, ctx.block_k = scale, causal, block_k
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, bias, lse = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = flash_attention_backward(
            q, k, v, o.view(q.shape), do, lse.view(q.shape[:-1]), ctx.scale,
            ctx.causal, ctx.block_k, bias, need_dbias)
        dbias = grads[3] if need_dbias else None
        return grads[0], grads[1], grads[2], dbias, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Blockwise fused attention. q, k, v ``[B, H, T, D]`` (or ``[B, T,
    D]`` for one head), any strides; returns the same shape and dtype, the
    4-D result as a ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer
    (:func:`heads_view`). Raises where the gate refuses
    (:func:`supports_flash`); use ``dot_product_attention`` there.

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
    in_dtype = q.dtype
    if not (q.dtype == k.dtype == v.dtype):       # mixed: all in float32
        q, k, v = (t.float() for t in (q, k, v))
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    bf = None
    if bias is not None:
        if squeeze and bias.ndim == 3:
            bias = bias[:, None]
        bf = bias.to(torch.float32).expand(b, h, T, T)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bf)):
        o = _FlashAttention.apply(q, k, v, bf, float(scale), bool(causal),
                                  int(block_k))
    else:                        # nothing to differentiate: no autograd node
        o = _forward(q, k, v, bf, float(scale), bool(causal),
                     int(block_k))[0]     # no float32 output: no extra bytes
    if o.dtype != in_dtype:
        o = o.to(in_dtype)
    return o[:, 0] if squeeze else o


# --- the registry's flash_attention op -----------------------------------------

from .registry import op  # noqa: E402


@op("flash_attention", "nn")
def flash_attention_op(q, k, v, causal: bool = False,
                       sm_scale: Optional[float] = None, bias=None,
                       block_q: Optional[int] = None,
                       block_k: Optional[int] = None,
                       interpret: Optional[bool] = None):
    """:func:`flash_attention` under the JAX op's signature. ``interpret``
    (the JAX op's switch to the Pallas interpreter) is accepted for that
    signature and ignored: CUDA tensors launch the kernel, CPU tensors run
    the plain version."""
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                           bias=bias, block_q=block_q, block_k=block_k)
