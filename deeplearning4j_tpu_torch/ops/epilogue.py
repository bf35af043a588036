"""Fused BN + activation (+ residual add) inference epilogue.

Counterpart of ``deeplearning4j_tpu/ops/pallas_epilogue.py``. Inference
BatchNormalization folds to a per-channel affine ``y = x*scale + shift``;
the ResNet block tail is ``relu(bn(x) + residual)``. One kernel does that in
a single read of ``x`` and ``residual`` and one write.

- :func:`bn_act` is the entry: it folds ``scale``/``shift`` in float32,
  counts the hit, and hands the tensor to :func:`bn_act_apply`, or returns
  ``None`` when the gate refuses (the caller keeps its dense path; the
  refusal is counted under ``precision/epilogue_fallbacks``).
- :func:`bn_act_apply` picks the version by ``ops/routing.use_kernel``: the
  kernel for a float32 or bfloat16 CUDA tensor when no gradient is needed
  through ``x``, ``scale``/``shift`` or the residual; otherwise the plain
  version, on the card counted under ``precision/epilogue_plain_on_card``.
  The JAX package has no backward kernel for this op either: it
  differentiates through its ``xla`` mode, and the plain version under
  autograd is that mode's counterpart.
- :func:`bn_act_cuda` launches the hand-written kernel ``csrc/bn_act.cu``
  for a CUDA tensor; it never falls back, and refuses an input that needs
  a gradient (its output has no ``grad_fn``). :func:`launch_plan` picks the
  kernel's index route, vector width and grid from the tensor's size.
- :func:`bn_act_reference` is the plain PyTorch version of the same math.

The gate (:func:`fusable`) differs from the TPU's on purpose: the TPU kernel
needs ``C % 128 == 0`` (its lane width), the Hopper kernel reads NCHW
directly and takes any channel count. It refuses only an activation other
than relu/identity, a non-float tensor, a layout other than 4-D NCHW or
2-D ``[N, C]`` with ``axis=1``, and a residual shaped unlike ``x``. So one
ResNet-50 forward launches the kernel 53 times here (16 residual tails, 33
BN+relu, 4 shortcut BNs), against 46 in the JAX package, which refuses the
seven 64-channel BNs (``stem_bn`` and ``bn1``/``bn2`` of the three stage-0
blocks).

Numerics: ``scale``/``shift`` are folded in float32; ``x`` and
``residual`` are upcast to float32, ``act(x*scale + shift [+ res])`` is
computed there and rounded once to ``x.dtype``. A float64 ``x`` is computed
in float64 instead, with ``scale``/``shift`` cast up from their float32
fold, as the JAX package's ``xla`` mode computes it. The JAX package's bf16
path instead rounds ``scale``/``shift`` to bf16 and computes in bf16; the
two agree within 2 bf16 ulp of the output's magnitude
(tests/test_torch_epilogue.py). In float32 the kernel's fused multiply-add
differs from the plain version's two roundings by at most 2 ulp of the
output scale.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from ..common import nan_panic
from ..common.profiler import OpProfiler
from . import cuda_lib, routing

KERNEL_NAME = "bn_act"
SOURCE = "deeplearning4j_tpu_torch/csrc/bn_act.cu"
REPLACES = "deeplearning4j_tpu/ops/pallas_epilogue.py:75"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the dtypes the kernel takes
KERNEL_DTYPES = tuple(_DTYPE_CODES)
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


def fold(mean, var, gamma=None, beta=None, epsilon: float = 1e-5,
         exact: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as a float32 per-channel affine (scale, shift).

    ``exact`` (:func:`bn_act` sets it for a dtype the kernel does not take)
    takes ``1/sqrt(var + eps)`` in float64, where square root and division
    are correctly rounded on every device, and rounds it once to float32.
    float32 ``rsqrt`` is within an ulp on the card and on the CPU but not
    the same ulp, which would keep a float64 network's card and CPU runs
    1e-7 apart. The kernel's dtypes keep the one ``rsqrt``."""
    f32 = torch.float32
    if exact:
        scale = (1.0 / torch.sqrt((var.to(f32) + epsilon).double())).to(f32)
    else:
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
    """Plain PyTorch version of the kernel: float32 math, one rounding
    (float64 math for a float64 ``x``). Differentiable."""
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = x.to(ct) * scale.reshape(shape).to(ct) + shift.reshape(shape).to(ct)
    if residual is not None:
        y = y + residual.to(ct)
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


#: threads a block (the kernel's kThreads), the most vectors a thread
#: loads before it computes (kMaxPerThread), and the most blocks a launch
#: gives each SM before the grid strides. Every launch of the forwards the
#: port serves is one pass: on an H100 one pass took 2-4% less than a grid
#: of 4 blocks an SM that strides, at the large shapes (PERF.md, §6).
THREADS = 256
MAX_PER_THREAD = 4
BLOCKS_PER_SM = 64
#: from this many elements on, the kernel takes its 64-bit index route
WIDE_AT = 2 ** 31


class LaunchPlan(NamedTuple):
    wide: bool          # 64-bit indices (numel >= WIDE_AT)
    vec: int            # elements a vector: 16 bytes, or 1 (scalar route)
    per_thread: int     # vectors a thread loads before computing
    blocks: int
    hw_magic: Tuple[int, int]   # divmod_magic(hw); (0, 0) on the wide route
    c_magic: Tuple[int, int]


def divmod_magic(d: int) -> Tuple[int, int]:
    """``(mul, shr)`` such that ``n // d == umulhi(2 * n, mul) >> shr`` for
    every ``0 <= n < 2**31`` (``umulhi``: the high 32 bits of the 64-bit
    product): ``shr = ceil(log2 d)``, ``mul = ceil(2**(31 + shr) / d)``
    (Granlund and Montgomery's round-up method for 31-bit dividends)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"divisor {d} outside [1, 2**31)")
    shr = (d - 1).bit_length()
    mul = -(-(1 << (31 + shr)) // d)
    return mul, shr


@functools.lru_cache(maxsize=4096)
def launch_plan(numel: int, hw: int, C: int, elem_size: int, aligned: bool,
                sms: int) -> LaunchPlan:
    """The kernel's launch for a contiguous tensor of ``numel`` elements of
    ``elem_size`` bytes, ``hw`` a plane and ``C`` channels, on a card of
    ``sms`` SMs: the index route, the vector width (16-byte vectors when
    every base pointer is ``aligned``), the vectors a thread loads at once
    (4, halved while one pass would leave SMs without a block) and the
    blocks (one pass, up to BLOCKS_PER_SM an SM; a grid-stride loop past
    that)."""
    vec = 16 // elem_size if aligned else 1
    nvec = numel // vec
    per_thread = MAX_PER_THREAD
    while per_thread > 1 and -(-nvec // (THREADS * per_thread)) < sms:
        per_thread //= 2
    blocks = min(-(-nvec // (THREADS * per_thread)), sms * BLOCKS_PER_SM)
    wide = numel >= WIDE_AT
    zero = (0, 0)
    return LaunchPlan(wide, vec, per_thread, max(blocks, 1),
                      zero if wide else divmod_magic(hw),
                      zero if wide else divmod_magic(C))


_SMS = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def bind(fn):
    """Set the argument types of a loaded ``dl4j_bn_act``."""
    p, ll, i, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_uint)
    fn.argtypes = [p, p, p, p, p, ll, ll, ll, i, i, i, i, i, i, u, u, u, u, p]
    fn.restype = i
    return fn


#: the loaded library and its bound entry, made at the first launch (a
#: measurement build may be put here in their place)
_LAUNCHER = None


def _launcher():
    global _LAUNCHER
    if _LAUNCHER is None:
        lib = cuda_lib.load(KERNEL_NAME)
        _LAUNCHER = (lib, bind(lib.dl4j_bn_act))
    return _LAUNCHER


def bn_act_cuda(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                residual: Optional[torch.Tensor] = None,
                act: str = "identity") -> torch.Tensor:
    """Launch ``csrc/bn_act.cu`` on PyTorch's current stream. Raises on
    anything the kernel does not take (an input that needs a gradient
    first), and when the launch fails."""
    global bn_act_launches, bn_act_residual_launches
    if routing.needs_grad(x, scale, shift, residual):
        raise RuntimeError(
            "the bn_act kernel has no backward (the JAX package "
            "differentiates through its xla mode): call it under "
            "torch.no_grad() or on tensors that do not require grad; "
            "bn_act_apply takes the plain version there")
    _check_cuda_args(x, scale, shift, residual, act)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel()
    if n == 0:
        return out
    lib, fn = _launcher()
    C = int(x.shape[1])
    hw = x.shape[2] * x.shape[3] if x.ndim == 4 else 1
    tensors = [x, out] + ([residual] if residual is not None else [])
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    plan = launch_plan(n, hw, C, x.element_size(), aligned,
                       _sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 residual.data_ptr() if residual is not None else None,
                 out.data_ptr(), n, hw, C, _DTYPE_CODES[x.dtype],
                 int(act == "relu"), int(plan.vec > 1), int(plan.wide),
                 plan.per_thread, plan.blocks, *plan.hw_magic,
                 *plan.c_magic, stream)
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: cudaError {err} "
                           f"({cuda_lib.error_string(lib, err)})")
    with _LAUNCH_LOCK:
        bn_act_launches += 1
        bn_act_residual_launches += residual is not None
    nan_panic.check_kernel(KERNEL_NAME, out)
    return out


def bn_act_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 act: str = "identity") -> torch.Tensor:
    """The kernel for a float32 or bfloat16 CUDA tensor when no gradient is
    needed; the plain version otherwise (``ops/routing.use_kernel``), on
    the card counted under ``precision/epilogue_plain_on_card``."""
    if routing.use_kernel(x.device, x.dtype in KERNEL_DTYPES, x, scale,
                          shift, residual):
        return bn_act_cuda(x, scale, shift, residual, act)
    if x.is_cuda:
        OpProfiler.get().count("precision/epilogue_plain_on_card")
    return bn_act_reference(x, scale, shift, residual, act)


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
    scale, shift = fold(mean, var, gamma, beta, epsilon,
                        exact=x.dtype not in KERNEL_DTYPES)
    if residual is not None:
        residual = residual.to(x.dtype).contiguous()
    prof.count("precision/epilogue_hits")
    if residual is not None:
        prof.count("precision/epilogue_residual_hits")
    return bn_act_apply(x.contiguous(), scale, shift, residual, act)
