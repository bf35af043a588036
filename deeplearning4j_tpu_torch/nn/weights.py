"""Weight initialization from an explicit ``torch.Generator``.

Counterpart of ``deeplearning4j_tpu/nn/weights.py``: the schemes the ported
models use, with the same fan conventions, read off the shape alone (dense
W=[nIn,nOut]; 4-D W=[a, b, kH, kW] takes fan in ``b * kH * kW`` and fan out
``a * kH * kW``, so the transposed convolution's [I, O, kH, kW] and the
depthwise [mult, C, kH, kW] get the JAX package's fans too; any other rank
takes the element count for both). The draws come
from the generator the caller passes, so a seed fixes the weights; they are
not the JAX package's threefry numbers (tests carry weights across
instead).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def _fans(shape: Sequence[int]) -> Tuple[float, float]:
    shape = tuple(shape)
    if len(shape) == 2:                      # dense [nIn, nOut]
        return float(shape[0]), float(shape[1])
    if len(shape) == 4:                      # conv OIHW [out, in, kh, kw]
        rf = shape[2] * shape[3]
        return float(shape[1] * rf), float(shape[0] * rf)
    if len(shape) == 1:
        return float(shape[0]), float(shape[0])
    # any other rank (the 1D convolution's [out, in, k]): both fans are
    # the element count, as in the JAX package
    n = int(np.prod(shape))
    return float(n), float(n)


def init_weights(gen: torch.Generator, shape: Sequence[int],
                 scheme: str = "xavier", dtype=torch.float32,
                 gain: float = 1.0, device=None) -> torch.Tensor:
    """Draw a weight tensor from ``gen`` (a CPU generator, so one seed gives
    the same weights on every device), then move it to ``device``. Schemes:
    ``xavier`` (normal, std sqrt(2/(fan_in+fan_out))) and ``relu`` (He
    normal, std sqrt(2/fan_in)); the others arrive with the models that
    use them."""
    scheme = scheme.lower()
    fan_in, fan_out = _fans(shape)
    if scheme == "xavier":
        std = gain * np.sqrt(2.0 / (fan_in + fan_out))
    elif scheme in ("relu", "he", "he_normal"):
        std = gain * np.sqrt(2.0 / fan_in)
    else:
        raise ValueError(f"weight init {scheme!r} is not ported yet")
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32) * std
    return w.to(device=device, dtype=dtype)
