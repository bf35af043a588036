"""Shape and gather ops.

Counterpart of ``deeplearning4j_tpu/ops/shape.py`` (``reshape``,
``permute``, ``gather``). ``permute`` returns a view, as PyTorch does; the
op that reads it next copies when it must.
"""

from __future__ import annotations

import torch

from .registry import op


@op("reshape", "shape")
def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


@op("permute", "shape")
def permute(x, dims):
    return x.permute(tuple(dims))


@op("gather", "shape")
def gather(x, indices, axis: int = 0):
    """``jnp.take(x, indices, axis)``: the rows of ``x`` along ``axis`` at
    ``indices`` (any shape), which take that axis's place. Indices must
    lie in range (the card would assert; ``jnp.take`` fills)."""
    axis = axis % x.dim()
    idx = torch.as_tensor(indices, device=x.device)
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
