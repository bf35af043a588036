"""Mixed-precision rules for the training path.

Counterpart of ``deeplearning4j_tpu/learning/precision.py``:

- **Compute** may run in bfloat16 (``GlobalConf.compute_dtype``) while the
  master parameters stay float32; the loss head runs in float32.
- **Updater state** may be stored in bfloat16 (``updater.state_dtype``):
  :func:`apply_updater` upcasts the moments, runs the unchanged float32
  updater, and writes the new moments back with **stochastic rounding**
  (:func:`stochastic_round`), so an EMA whose increments fall below the
  bf16 rounding step keeps moving in expectation.

Random bits come from an explicit ``torch.Generator`` (the graph's), never
from PyTorch's global generator. Bits are carried as ``int32`` holding the
uint32 patterns of the JAX package (``np.uint32(...).view(np.int32)``):
PyTorch's ``uint32`` has too few operators on the CPU. The arithmetic below
gives the JAX package's bits for every finite input (a signed add of at
most ``0xFFFF`` overflows only for NaN patterns, and those are replaced).

Numerics envelope with ``state_dtype="bfloat16"`` (the JAX package's,
``precision.py:30-38``): the per-step loss tracks the float32-state run
within ``|Δ| <= 1e-3 + 0.05·|loss|``; float32 state changes nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..common.dtypes import dtype_name, torch_dtype
from ..common.profiler import OpProfiler

Tree = Dict[str, Dict[str, torch.Tensor]]

#: bf16 NaN with the sign of the input: the JAX package's round-to-nearest
#: float32 → bfloat16 cast turns every NaN into 0x7FC0 | sign
_BF16_QNAN = 0x7FC0


def cast_floating(tree, dtype):
    """Cast every floating tensor of a (nested dict) tree to ``dtype``
    (round-to-nearest), leaving other leaves untouched."""
    dt = torch_dtype(dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dt) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dt)
    return tree


def stochastic_round(x: torch.Tensor, rbits: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """float32 ``x`` → bfloat16 with stochastic rounding.

    ``rbits``: int32 random bits of ``x``'s shape; only the low 16 bits are
    used. bf16 is the top half of the float32 pattern, so adding a uniform
    16-bit integer to the pattern and truncating rounds up with probability
    (dropped bits)/2^16: E[SR(x)] == x. A carry runs into the exponent, past
    the largest finite value to ±inf; ±inf pass through; NaN becomes the
    quiet NaN 0x7FC0 with the input's sign.
    """
    if torch_dtype(dtype) != torch.bfloat16:
        raise NotImplementedError(
            f"stochastic rounding targets bfloat16 (top half of the fp32 "
            f"pattern); got {dtype}")
    u = x.to(torch.float32).view(torch.int32)
    r = rbits.to(torch.int32) & 0xFFFF
    # arithmetic shifts keep every value inside int16's range
    rounded = ((u + r) & -65536) >> 16
    top = u >> 16
    exp_all_ones = (u & 0x7F800000) == 0x7F800000
    is_nan = exp_all_ones & ((u & 0x007FFFFF) != 0)
    nan = (top & -32768) | _BF16_QNAN
    out = torch.where(exp_all_ones, torch.where(is_nan, nan, top), rounded)
    return out.to(torch.int16).view(torch.bfloat16)


def random_bits(n: int, generator: torch.Generator,
                device=None) -> torch.Tensor:
    """``n`` uniform 32-bit patterns as int32 from ``generator``, counted
    under ``precision/sr_draws``."""
    OpProfiler.get().count("precision/sr_draws", int(n))
    return torch.randint(-2 ** 31, 2 ** 31, (int(n),), dtype=torch.int32,
                         generator=generator,
                         device=device if device is not None
                         else generator.device)


def sr_cast_state(state, dtype, generator: torch.Generator):
    """Stochastically round every floating leaf of an (float32) updater
    state tree down to ``dtype``, each leaf on its own draw, in sorted
    slot/node/entry order."""
    if isinstance(state, dict):
        return {k: sr_cast_state(state[k], dtype, generator)
                for k in sorted(state)}
    if isinstance(state, torch.Tensor) and state.is_floating_point():
        bits = random_bits(state.numel(), generator, state.device)
        return stochastic_round(state, bits.view(state.shape), dtype)
    return state


def state_dtype_of(updater) -> Optional[str]:
    """The configured low-precision state dtype name, or None for float32
    state."""
    sd = getattr(updater, "state_dtype", None)
    return dtype_name(torch_dtype(sd)) if sd else None


def apply_updater(updater, grads, state, params, iteration: int,
                  generator: Optional[torch.Generator] = None):
    """The per-leaf updater dispatch. Float32 state: exactly
    ``updater.apply``. Low-precision state: upcast the moments, run the
    float32 updater, round the new moments back down stochastically with
    bits from ``generator``. Parameters stay float32 throughout."""
    sd = state_dtype_of(updater)
    if not sd:
        return updater.apply(grads, state, params, iteration)
    if generator is None:
        raise ValueError(
            f"{type(updater).__name__}(state_dtype={sd!r}) needs a "
            "torch.Generator for stochastic rounding")
    wide = cast_floating(state, torch.float32)
    new_params, new_state = updater.apply(grads, wide, params, iteration)
    return new_params, sr_cast_state(new_state, sd, generator)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def updater_state_bytes(state) -> Dict[str, int]:
    """Bytes per leaf dtype (plus ``total``); empty for stateless
    updaters."""
    out: Dict[str, int] = {}
    for leaf in _leaves(state or {}):
        k = dtype_name(leaf.dtype)
        out[k] = out.get(k, 0) + leaf.numel() * leaf.element_size()
    if out:
        out["total"] = sum(out.values())
    return out


def note_state_bytes(state, prefix: str = "precision") -> None:
    """Record the updater-state footprint as gauges
    ``precision/updater_state_bytes_<dtype>`` and ``..._total``; gauges of
    dtypes no longer present go to 0."""
    prof = OpProfiler.get()
    fresh = updater_state_bytes(state)
    head = f"{prefix}/updater_state_bytes_"
    for k in list(prof.get_counters()):
        if k.startswith(head) and k[len(head):] not in fresh:
            prof.gauge(k, 0)
    for k, v in fresh.items():
        prof.gauge(head + k, v)
