"""Shape and gather ops.

Counterpart of ``deeplearning4j_tpu/ops/shape.py`` (``reshape``,
``permute``, ``gather``, ``space_to_batch``). ``permute`` returns a view,
as PyTorch does; the op that reads it next copies when it must.
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


@op("space_to_batch", "shape")
def space_to_batch(x, block_shape, paddings):
    """NHWC ``x`` zero-padded by ``((top, bottom), (left, right))``, then
    each ``b0 x b1`` block's pixels to the batch: ``[N * b0 * b1, H / b0,
    W / b1, C]``, block offset major (TF's order)."""
    (pt, pb), (pl, pr) = paddings
    x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    n, h, w, c = x.shape
    b0, b1 = block_shape
    out = x.reshape(n, h // b0, b0, w // b1, b1, c).permute(2, 4, 0, 1, 3, 5)
    return out.reshape(n * b0 * b1, h // b0, w // b1, c)
