"""Reduction ops.

Counterpart of ``deeplearning4j_tpu/ops/reduce.py`` (``reduce_mean``).
"""

from __future__ import annotations

import torch

from .registry import op


def _axis(dims):
    if dims is None or dims == ():
        return None
    if isinstance(dims, int):
        return dims
    return tuple(dims)


@op("reduce_mean", "reduce")
def reduce_mean(x, dims=None, keep_dims: bool = False):
    axis = _axis(dims)
    if axis is None:
        return torch.mean(x).reshape((1,) * x.dim() if keep_dims else ())
    return torch.mean(x, dim=axis, keepdim=keep_dims)
