"""Broadcastable pairwise ops.

Counterpart of ``deeplearning4j_tpu/ops/broadcastable.py`` (the ops the
TF-imported BERT graph and the ``SDVariable`` arithmetic reach). Operands
broadcast and promote as ``torch`` does, which agrees with ``jnp`` for the
graph's float32 tensors and 0-dim constants.
"""

from __future__ import annotations

import torch

from .registry import op


@op("add", "broadcastable")
def add(x, y):
    return torch.add(x, y)


@op("subtract", "broadcastable")
def subtract(x, y):
    return torch.sub(x, y)


@op("multiply", "broadcastable")
def multiply(x, y):
    return torch.mul(x, y)


@op("divide", "broadcastable")
def divide(x, y):
    return torch.true_divide(x, y)


@op("squaredsubtract", "broadcastable")
def squaredsubtract(x, y):
    return torch.square(torch.sub(x, y))
