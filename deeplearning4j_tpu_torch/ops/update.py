"""Fused weight update over flat per-dtype buckets, one launch per bucket.

Counterpart of ``deeplearning4j_tpu/ops/pallas_update.py``; the CUDA kernel
``csrc/fused_update.cu`` replaces its TPU kernel ``_kernel`` (launched by
``_launch_kernel``, ``deeplearning4j_tpu/ops/pallas_update.py:143``). One
launch applies SGD, Nesterovs, Adam or AdamW to a whole float32 bucket of
``parallel/sharding.Zero1Plan`` (for ResNet-50, one bucket of 25,557,032
elements holds all 161 parameter leaves) instead of a handful of small
kernels per leaf.

- :func:`fused_apply` is the entry: hyperparameters from :func:`_scalars`
  (Python float, then one cast to float32, as the JAX package computes
  them), random bits drawn per bucket from the graph's ``torch.Generator``
  when the moments are stored in bfloat16, then one update per bucket.
- :func:`fused_update_cuda` launches the kernel for CUDA tensors and never
  falls back; :func:`fused_update_reference` is the plain PyTorch version
  (:func:`_update_math`), used for CPU tensors and by the checks on the
  card.
- :func:`apply_flat_updater` sends an updater without a kernel through the
  per-leaf math on the buckets, counted under ``precision/fused_fallbacks``.

**In place.** The JAX version returns new arrays; here the parameter bucket
and the moment buckets are updated in place (the kernel writes through
their pointers, the plain version copies its result back), and
:func:`fused_apply` returns the same dicts. The graph's parameters are views
of the buckets, so they change with them.

**Bits.** One 32-bit draw per element per bucket, made outside the kernel
(``learning/precision.random_bits``) and carried as ``int32`` holding the
uint32 patterns: the low halfword rounds the first moment, the high halfword
(``>> 16``, then ``& 0xFFFF``) the second, as in the TPU kernel.

**Bound: bytes.** About 2-3 flops per byte. Nesterovs with bfloat16 state
moves 20 B/elem (read p 4, g 4, v 2, bits 4; write p 4, v 2), with float32
state also 20 B/elem; Adam 24 B/elem with bfloat16 state and 28 B/elem with
float32 state. Drawing the bits writes another 4 B/elem, outside the kernel.

**Numeric contract.** The kernel spells every operation with the
round-to-nearest intrinsics (``__fmul_rn``, ``__fadd_rn``, ``__fsub_rn``,
``__fdiv_rn``, ``__fsqrt_rn``), so nothing is contracted into an FMA and it
is meant to be bitwise equal to the plain version on the card, parameters
and moments alike. The acceptance floor for parameters and float32 moments
is the JAX package's contract between its modes
(``tests/test_precision.py:154-203``): at most 2 float32 ulp (2.4e-7
absolute at the test magnitudes). bfloat16 moments are held bitwise:
stochastic rounding picks between two neighbours 1 bf16 ulp apart, so the
JAX package's 1-ulp bound would not show a kernel that ignored the bits or
read the wrong halfword.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..common.dtypes import torch_dtype
from ..common.profiler import OpProfiler
from ..learning.precision import (apply_updater, random_bits, state_dtype_of,
                                  stochastic_round)
from ..learning.updaters import Adam, AdamW, Nesterovs, Sgd, _lr_at
from . import cuda_lib

KERNEL_NAME = "fused_update"
SOURCE = "deeplearning4j_tpu_torch/csrc/fused_update.cu"
REPLACES = "deeplearning4j_tpu/ops/pallas_update.py:143"

# exact-type match: a subclass of Adam with other apply() math must not
# take Adam's kernel
_KINDS = {Sgd: "sgd", Nesterovs: "nesterovs", Adam: "adam", AdamW: "adamw"}
_KIND_CODES = {"sgd": 0, "nesterovs": 1, "adam": 2, "adamw": 3}
SLOTS = {"sgd": (), "nesterovs": ("v",), "adam": ("m", "v"),
         "adamw": ("m", "v")}
_N_SCALARS = 9

#: kernel launches made by :func:`fused_update_cuda` (and nothing else)
fused_update_launches = 0
_LAUNCH_LOCK = threading.Lock()


def reset_launches() -> None:
    global fused_update_launches
    with _LAUNCH_LOCK:
        fused_update_launches = 0


def supports_fused(updater) -> bool:
    """True when ``updater`` has a fused kernel (exact type: Sgd,
    Nesterovs, Adam or AdamW)."""
    return type(updater) in _KINDS


def _scalars(updater, kind: str, iteration: int) -> Tuple[float, ...]:
    """The hyperparameters as float32 values (Python floats holding them):
    computed in Python float, then rounded to float32 once."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    lr = _lr_at(updater.learning_rate, iteration)
    if kind == "sgd":
        return (f32(lr),)
    if kind == "nesterovs":
        # (1+mu) in Python float, then cast: deriving it from a float32 mu
        # can land one ulp off
        return f32(lr), f32(updater.momentum), f32(1.0 + updater.momentum)
    t = iteration + 1
    bc1 = 1 - updater.beta1 ** t
    bc2 = 1 - updater.beta2 ** t
    sc = [f32(lr), f32(updater.beta1), f32(updater.beta2),
          f32(updater.epsilon), f32(bc1), f32(bc2),
          f32(1 - updater.beta1), f32(1 - updater.beta2)]
    if kind == "adamw":
        sc.append(f32(updater.weight_decay))
    return tuple(sc)


def _update_math(kind: str, sc, p, g, slots: Dict[str, torch.Tensor],
                 bits: Optional[torch.Tensor], sr_dtype):
    """The update in plain PyTorch, operation for operation as the kernel
    and as the JAX package's ``_update_math``. ``sc``: 0-dim float32
    tensors on ``p``'s device. Moments are upcast to float32; with
    ``sr_dtype`` the new moments are rounded down stochastically with
    ``bits`` (low halfword first slot, high halfword second)."""
    up = lambda a: a.to(torch.float32)  # noqa: E731

    def down(a, which: int):
        if sr_dtype is None:
            return a
        half = bits if which == 0 else ((bits >> 16) & 0xFFFF)
        return stochastic_round(a, half, sr_dtype)

    if kind == "sgd":
        return p - sc[0] * g, {}
    if kind == "nesterovs":
        lr, mu, opmu = sc
        v = up(slots["v"])
        v_new = mu * v - lr * g
        p_new = p + (-mu * v + opmu * v_new)
        return p_new, {"v": down(v_new, 0)}
    lr, b1, b2, eps, bc1, bc2, omb1, omb2 = sc[:8]
    m, v = up(slots["m"]), up(slots["v"])
    m_new = b1 * m + omb1 * g
    v_new = b2 * v + omb2 * (g * g)
    if kind == "adamw":
        step = lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                     + sc[8] * p)
    else:
        step = lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    return p - step, {"m": down(m_new, 0), "v": down(v_new, 1)}


def fused_update_reference(kind: str, sc: Tuple[float, ...], p, g, slots,
                           bits=None, sr_dtype=None):
    """Plain version of the kernel: returns ``(new_p, new_slots)`` as new
    tensors (the inputs are not touched)."""
    sct = tuple(torch.tensor(np.float32(v), device=p.device) for v in sc)
    return _update_math(kind, sct, p, g, slots, bits, sr_dtype)


def _check_cuda_args(kind, p, g, slots, bits, sr_dtype) -> None:
    names = SLOTS[kind]
    if p.device.type != "cuda":
        raise ValueError(f"fused_update_cuda needs CUDA tensors, got "
                         f"{p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"the fused_update kernel takes float32 parameter "
                        f"buckets, not {p.dtype}")
    n = p.numel()
    tensors = [("g", g)] + [(s, slots[s]) for s in names]
    if bits is not None:
        tensors.append(("bits", bits))
    for name, t in [("p", p)] + tensors:
        if t.device != p.device or t.dim() != 1 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"fused_update kernel needs {name} as a "
                             f"contiguous 1-D tensor of {n} elements on "
                             f"{p.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"fused_update kernel needs float32 grads, not "
                        f"{g.dtype}")
    want = torch.bfloat16 if sr_dtype is not None else torch.float32
    for s in names:
        if slots[s].dtype != want:
            raise TypeError(
                f"fused_update kernel: slot {s!r} is {slots[s].dtype}; "
                f"{'stochastic rounding' if sr_dtype else 'float32 state'}"
                f" needs {want}")
    if sr_dtype is not None and names:
        if sr_dtype != torch.bfloat16:
            raise TypeError(f"stochastic rounding targets bfloat16, not "
                            f"{sr_dtype}")
        if bits is None or bits.dtype != torch.int32:
            raise ValueError("bfloat16 state needs int32 random bits")
    if n >= 2 ** 62:
        raise ValueError("bucket too large for the fused_update kernel")


def _alignment(p, others) -> Tuple[int, int]:
    """(head, vec): the vector path needs, after ``head`` scalar elements,
    every float32/int32 pointer on 16 bytes and every bf16 pointer on 8.
    Otherwise the scalar variant (vec 0)."""
    addr = p.data_ptr()
    head = ((16 - addr % 16) % 16) // 4 if addr % 4 == 0 else 0
    head = min(head, p.numel())
    ok = (addr + 4 * head) % 16 == 0
    for t in others:
        width = 8 if t.element_size() == 2 else 16
        ok = ok and (t.data_ptr() + t.element_size() * head) % width == 0
    return (head, 1) if ok else (0, 0)


def _bind(lib: ctypes.CDLL):
    fn = lib.dl4j_fused_update
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([i, p, p, p, p, p, ctypes.c_longlong, i, i, i]
                       + [ctypes.c_float] * _N_SCALARS + [p])
        fn.restype = i
    return fn


def fused_update_cuda(kind: str, sc: Tuple[float, ...], p: torch.Tensor,
                      g: torch.Tensor, slots: Dict[str, torch.Tensor],
                      bits: Optional[torch.Tensor] = None,
                      sr_dtype=None) -> None:
    """Launch ``csrc/fused_update.cu`` on PyTorch's current stream: ``p``
    and the ``slots`` are updated in place. Raises on anything the kernel
    does not take, and when the launch fails."""
    global fused_update_launches
    names = SLOTS[kind]
    if not names:
        bits = None
    _check_cuda_args(kind, p, g, slots, bits, sr_dtype)
    n = p.numel()
    if n == 0:
        return
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind(lib)
    s = [slots[k] for k in names] + [None] * (2 - len(names))
    others = [t for t in [g] + s + [bits] if t is not None]
    head, vec = _alignment(p, others)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    scal = list(sc) + [0.0] * (_N_SCALARS - len(sc))
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(_KIND_CODES[kind], p.data_ptr(), g.data_ptr(), ptr(s[0]),
                 ptr(s[1]), ptr(bits), n,
                 int(sr_dtype is not None and bool(names)), head, vec,
                 *scal, stream)
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: cudaError "
                           f"{err} ({cuda_lib.error_string(lib, err)})")
    with _LAUNCH_LOCK:
        fused_update_launches += 1


def update_bucket(kind: str, sc: Tuple[float, ...], p, g, slots, bits,
                  sr_dtype) -> None:
    """One bucket in place: the kernel for a CUDA float32 bucket, the plain
    version for a CPU one. Raises for a CUDA bucket the kernel does not
    take."""
    prof = OpProfiler.get()
    if p.device.type == "cuda":
        fused_update_cuda(kind, sc, p, g, slots, bits, sr_dtype)
        prof.count("precision/fused_buckets_kernel")
        return
    if p.device.type != "cpu":
        raise ValueError(f"fused_update has no implementation for "
                         f"{p.device}")
    new_p, new_slots = fused_update_reference(kind, sc, p, g, slots, bits,
                                              sr_dtype)
    p.copy_(new_p)
    for k, v in new_slots.items():
        slots[k].copy_(v)
    prof.count("precision/fused_buckets_plain")


def fused_apply(updater, flat_params: Dict[str, torch.Tensor],
                flat_grads: Dict[str, torch.Tensor], state: dict,
                iteration: int, generator: Optional[torch.Generator] = None,
                bits: Optional[Dict[str, torch.Tensor]] = None):
    """Apply ``updater`` to ``Zero1Plan`` flat buckets, one update per
    bucket, IN PLACE. ``flat_params``/``flat_grads``:
    ``{"flat::<dtype>": [L]}``; ``state``: ``{slot: {"flat::<dtype>": [L]}}``.
    With ``state_dtype`` set, each bucket draws one 32-bit value per element
    from ``generator`` (or takes ``bits[bucket_key]``, int32, for tests that
    feed the JAX package's bits). Returns ``(flat_params, state)``, the same
    dicts."""
    kind = _KINDS.get(type(updater))
    if kind is None:
        raise NotImplementedError(
            f"no fused kernel for {type(updater).__name__}; gate on "
            "supports_fused() and fall back to apply_updater")
    sd = state_dtype_of(updater)
    sr_dtype = torch_dtype(sd) if sd else None
    names = SLOTS[kind]
    if sr_dtype is not None and names and generator is None and bits is None:
        raise ValueError("state_dtype set but no torch.Generator given to "
                         "fused_apply")
    sc = _scalars(updater, kind, iteration)
    prof = OpProfiler.get()
    for bkey, p in sorted(flat_params.items()):
        g = flat_grads[bkey]
        if g.dtype != p.dtype:
            g = g.to(p.dtype)
        slots = {n: state[n][bkey] for n in names}
        b = None
        if sr_dtype is not None and names:
            b = bits[bkey] if bits is not None else random_bits(
                p.numel(), generator, p.device)
        update_bucket(kind, sc, p, g, slots, b, sr_dtype)
        prof.count("precision/fused_hits")
    return flat_params, ({} if not names else state)


def apply_flat_updater(updater, flat_params, flat_grads, state,
                       iteration: int,
                       generator: Optional[torch.Generator] = None):
    """The fused kernel when the updater has one; otherwise the per-leaf
    updater math on the buckets (through ``learning.precision
    .apply_updater``, so ``state_dtype`` still works), counted under
    ``precision/fused_fallbacks`` and written back in place."""
    if supports_fused(updater):
        return fused_apply(updater, flat_params, flat_grads, state,
                           iteration, generator)
    OpProfiler.get().count("precision/fused_fallbacks")
    wrap = lambda d: {"flat": d}  # noqa: E731
    new_p, new_s = apply_updater(
        updater, wrap(flat_grads), {k: wrap(v) for k, v in state.items()},
        wrap(flat_params), iteration, generator)
    with torch.no_grad():
        for k, t in new_p["flat"].items():
            flat_params[k].copy_(t)
        for slot, d in new_s.items():
            for k, t in d["flat"].items():
                state[slot][k].copy_(t)
    return flat_params, state
