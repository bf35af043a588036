"""Fused BN + activation (+ residual add) inference epilogue.

Counterpart of ``deeplearning4j_tpu/ops/pallas_epilogue.py``. Inference
BatchNormalization folds to a per-channel affine ``y = x*scale + shift``;
the ResNet block tail is ``relu(bn(x) + residual)``. One kernel does that in
a single read of ``x`` and ``residual`` and one write.

- :func:`bn_act` is the entry: it folds ``scale``/``shift`` in float32,
  counts the hit, and hands the tensor to :func:`bn_act_apply`, or returns
  ``None`` when the gate refuses (the caller keeps its dense path; the
  refusal is counted under ``precision/epilogue_fallbacks``).
- :func:`bn_act_cuda` launches the hand-written kernel ``csrc/bn_act.cu``
  for a CUDA tensor; it never falls back.
- :func:`bn_act_reference` is the plain PyTorch version of the same math,
  used only for a tensor on the CPU (and by the checks on the card).

The gate (:func:`fusable`) differs from the TPU's on purpose: the TPU kernel
needs ``C % 128 == 0`` (its lane width), the Hopper kernel reads NCHW
directly and takes any channel count. It refuses only an activation other
than relu/identity, a non-float tensor, a layout other than 4-D NCHW or
2-D ``[N, C]`` with ``axis=1``, and a residual shaped unlike ``x``. So one
ResNet-50 forward launches the kernel 53 times here (16 residual tails, 33
BN+relu, 4 shortcut BNs), against 46 in the JAX package, which refuses the
seven 64-channel BNs (``stem_bn`` and ``bn1``/``bn2`` of the three stage-0
blocks).

Numerics: ``scale``/``shift`` stay float32; ``x`` and ``residual`` are
upcast to float32, ``act(x*scale + shift [+ res])`` is computed there and
rounded once to ``x.dtype``. The JAX package's bf16 path instead rounds
``scale``/``shift`` to bf16 and computes in bf16; the two agree within
2 bf16 ulp of the output's magnitude (tests/test_torch_epilogue.py). In
float32 the kernel's fused multiply-add differs from the plain version's
two roundings by at most 2 ulp of the output scale.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..common.profiler import OpProfiler
from . import cuda_lib

KERNEL_NAME = "bn_act"
SOURCE = "deeplearning4j_tpu_torch/csrc/bn_act.cu"
REPLACES = "deeplearning4j_tpu/ops/pallas_epilogue.py:75"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = ("relu", "identity")

#: kernel launches made by :func:`bn_act_cuda` (and nothing else), and
#: those of them that add a residual
bn_act_launches = 0
bn_act_residual_launches = 0
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    global bn_act_launches, bn_act_residual_launches
    with _LAUNCH_LOCK:
        bn_act_launches = 0
        bn_act_residual_launches = 0


def fusable(x, axis: int, act: Optional[str]) -> bool:
    """Gate: can :func:`bn_act` fuse this epilogue? Any channel count."""
    act = (act or "identity").lower()
    if act not in _ACTS:
        return False
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return False
    nd = x.ndim
    return (nd == 4 and axis % 4 == 1) or (nd == 2 and axis % 2 == 1)


def fold(mean, var, gamma=None, beta=None,
         epsilon: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as a float32 per-channel affine (scale, shift)."""
    f32 = torch.float32
    scale = torch.rsqrt(var.to(f32) + epsilon)
    if gamma is not None:
        scale = gamma.to(f32) * scale
    shift = -mean.to(f32) * scale
    if beta is not None:
        shift = beta.to(f32) + shift
    return scale.contiguous(), shift.contiguous()


def bn_act_reference(x: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, residual: Optional[torch.Tensor] = None,
                     act: str = "identity") -> torch.Tensor:
    """Plain PyTorch version of the kernel: float32 math, one rounding."""
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    y = x.to(torch.float32) * scale.reshape(shape) + shift.reshape(shape)
    if residual is not None:
        y = y + residual.to(torch.float32)
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def _check_cuda_args(x, scale, shift, residual, act) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"bn_act_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"bn_act kernel takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if x.ndim not in (2, 4):
        raise ValueError(f"bn_act kernel takes NCHW or [N, C], got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("bn_act kernel needs a contiguous x")
    if act not in _ACTS:
        raise ValueError(f"bn_act kernel has no activation {act!r}")
    C = x.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if (v.dtype != torch.float32 or v.device != x.device
                or tuple(v.shape) != (C,) or not v.is_contiguous()):
            raise ValueError(f"bn_act kernel needs {name} as contiguous "
                             f"float32 ({C},) on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if residual is not None:
        if (residual.shape != x.shape or residual.dtype != x.dtype
                or residual.device != x.device
                or not residual.is_contiguous()):
            raise ValueError("bn_act kernel needs a contiguous residual of "
                             "x's shape, dtype and device")
    if x.numel() >= 2 ** 62:
        raise ValueError("tensor too large for the bn_act kernel")


def _bind(lib: ctypes.CDLL):
    fn = lib.dl4j_bn_act
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ll, ll, i, i, i, i, i, p]
        fn.restype = i
    return fn


def bn_act_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                act: str = "identity") -> torch.Tensor:
    """Launch ``csrc/bn_act.cu`` on PyTorch's current stream. Raises on
    anything the kernel does not take, and when the launch fails."""
    global bn_act_launches, bn_act_residual_launches
    _check_cuda_args(x, scale, shift, residual, act)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind(lib)
    C = int(x.shape[1])
    if x.ndim == 4:
        a, hw, rows = x.shape[0] * C, x.shape[2] * x.shape[3], 0
    else:
        a, hw, rows = x.numel(), 1, 1
    tensors = [x, out] + ([residual] if residual is not None else [])
    vec = int(all(t.data_ptr() % 16 == 0 for t in tensors))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), a, hw, C, rows, _DTYPE_CODES[x.dtype],
                 int(act == "relu"), vec, stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err} "
                           f"({cuda_lib.error_string(lib, err)})")
    with _LAUNCH_LOCK:
        bn_act_launches += 1
        bn_act_residual_launches += residual is not None
    return out


def bn_act_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 act: str = "identity") -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return bn_act_reference(x, scale, shift, residual, act)
    if x.device.type == "cuda":
        return bn_act_cuda(x, scale, shift, residual, act)
    raise ValueError(f"bn_act has no implementation for {x.device}")


def bn_act(x: torch.Tensor, mean, var, gamma=None, beta=None, *,
           epsilon: float = 1e-5, axis: int = 1, act: Optional[str] = None,
           residual: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Fused inference epilogue ``act(bn(x) [+ residual])``, or ``None``
    when the gate refuses (counted; the caller keeps its dense path).

    ``mean``/``var``/``gamma``/``beta``: per-channel ``(C,)`` (the BN
    layer's running stats and affine params; gamma/beta may be None).
    """
    act = (act or "identity").lower()
    prof = OpProfiler.get()
    if residual is not None and residual.shape != x.shape:
        prof.count("precision/epilogue_fallbacks")
        return None
    if not fusable(x, axis, act):
        prof.count("precision/epilogue_fallbacks")
        return None
    scale, shift = fold(mean, var, gamma, beta, epsilon)
    if residual is not None:
        residual = residual.to(x.dtype).contiguous()
    prof.count("precision/epilogue_hits")
    if residual is not None:
        prof.count("precision/epilogue_residual_hits")
    return bn_act_apply(x.contiguous(), scale, shift, residual, act)
