"""Activation resolution: DL4J activation names to elementwise torch
functions. Counterpart of ``deeplearning4j_tpu/nn/activations.py`` (whose
math lives in ``ops/transforms.py``); the same names, the same formulas.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def _where_pos(x, neg):
    return torch.where(x >= 0, x, neg)


def _rationaltanh(x):
    a = 0.6666667 * x
    approx = torch.sign(a) * (1.0 - 1.0 / (1.0 + a.abs() + a * a
                                           + 1.41645 * a ** 4))
    return 1.7159 * approx


_ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0, 6),
    "leakyrelu": lambda x, alpha=0.01: _where_pos(x, alpha * x),
    "prelu": lambda x, alpha: _where_pos(x, alpha * x),
    "rrelu": lambda x, alpha=0.01: _where_pos(x, alpha * x),
    "thresholdedrelu": lambda x, theta=1.0: torch.where(
        x > theta, x, torch.zeros((), dtype=x.dtype, device=x.device)),
    "elu": lambda x, alpha=1.0: torch.where(x > 0, x, alpha * torch.expm1(x)),
    "selu": lambda x: 1.0507009873554805 * torch.where(
        x > 0, x, 1.6732632423543772 * torch.expm1(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "exp": torch.exp,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "swish": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "tanh": torch.tanh,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "rectifiedtanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "softmax": lambda x, axis=-1: torch.softmax(x, dim=axis),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "cube": lambda x: x * x * x,
    "identity": lambda x: x,
}


def activation_fn(name: str) -> Callable:
    name = name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; known: "
                         f"{sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[name]


def is_known(name: str) -> bool:
    return name.lower() in _ACTIVATIONS
