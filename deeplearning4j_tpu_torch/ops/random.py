"""Random ops: distribution draws from an explicit generator.

Counterpart of ``deeplearning4j_tpu/ops/random.py`` (reference libnd4j
random kernels). Where each JAX op takes a PRNG key, each op here takes a
``torch.Generator`` first and draws on that generator's device (SameDiff
passes its own, ``SameDiff._rng``). Streams cannot match JAX's threefry
bitwise; shapes, dtypes (those of the JAX ops under the JAX package's x64
setting) and distributions do:

- ``random_truncated_normal`` is cut at two standard deviations, by the
  inverse CDF of a uniform draw as ``jax.random.truncated_normal(key, -2,
  2)`` computes it; ``random_binomial`` sums ``trials`` Bernoulli draws;
  ``random_exponential`` divides by ``lam`` and ``random_gamma`` by
  ``beta`` (a rate); ``random_poisson`` is int32 by default.
- ``random_gamma`` is Marsaglia and Tsang's method (with ``alpha + 1`` and
  a uniform power below ``alpha = 1``): eight candidates an element drawn
  at once, the first accepted kept, a redraw for the rare element with
  none (one host read of the count).
- ``random_multinomial`` draws row ``i`` of its result from logits row
  ``i`` for any batch, which is DL4J's ``RandomMultinomial`` and TF's
  ``multinomial``. The JAX op broadcasts its batch against the samples
  axis instead: it raises for a batch other than 1 or ``num_samples``, and
  at ``num_samples`` rows draws column ``j`` from row ``j`` (ROADMAP.md §C).
  For one row the two agree in distribution.
- ``random_shuffle``, ``random_crop`` and ``dropout_bp`` are functions of
  their draws (a permutation, the offsets, a mask): ``shuffle_with``,
  ``crop_with`` and ``dropout_bp_with`` take those draws, so a test can
  give them the JAX op's. ``random_crop`` takes its offsets as indices on
  the device: no host synchronisation.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..common.dtypes import torch_dtype
from .registry import op


def _dtype(d) -> torch.dtype:
    return d if isinstance(d, torch.dtype) else torch_dtype(np.dtype(d).name)


def _shape(shape) -> tuple:
    return tuple(int(s) for s in shape)


def _rand(g: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.rand(_shape(shape), generator=g, device=g.device,
                      dtype=dtype)


def _randn(g: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(_shape(shape), generator=g, device=g.device,
                       dtype=dtype)


@op("random_uniform", "random", differentiable=False)
def random_uniform(g, shape, low: float = 0.0, high: float = 1.0,
                   dtype=torch.float32):
    return _rand(g, shape, _dtype(dtype)) * (high - low) + low


@op("random_normal", "random", differentiable=False)
def random_normal(g, shape, mean: float = 0.0, stddev: float = 1.0,
                  dtype=torch.float32):
    return _randn(g, shape, _dtype(dtype)) * stddev + mean


@op("random_truncated_normal", "random", differentiable=False)
def random_truncated_normal(g, shape, mean: float = 0.0, stddev: float = 1.0,
                            dtype=torch.float32):
    dt = _dtype(dtype)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = _rand(g, shape, dt) * (hi - lo) + lo
    x = math.sqrt(2.0) * torch.erfinv(u)
    two = torch.tensor(2.0, dtype=dt, device=x.device)
    x = torch.clamp(x, torch.nextafter(-two, two), torch.nextafter(two, -two))
    return x * stddev + mean


@op("random_lognormal", "random", differentiable=False)
def random_lognormal(g, shape, mean: float = 0.0, stddev: float = 1.0,
                     dtype=torch.float32):
    return torch.exp(_randn(g, shape, _dtype(dtype)) * stddev + mean)


@op("random_bernoulli", "random", differentiable=False)
def random_bernoulli(g, shape, p: float = 0.5, dtype=torch.float32):
    return (_rand(g, shape) < p).to(_dtype(dtype))


@op("random_binomial", "random", differentiable=False)
def random_binomial(g, shape, trials: int, p: float, dtype=torch.float32):
    draws = _rand(g, (int(trials),) + _shape(shape)) < p
    return draws.to(_dtype(dtype)).sum(dim=0)


@op("random_exponential", "random", differentiable=False)
def random_exponential(g, shape, lam: float = 1.0, dtype=torch.float32):
    e = torch.empty(_shape(shape), dtype=_dtype(dtype), device=g.device)
    return e.exponential_(1.0, generator=g) / lam


def _gamma_at_least_one(g, a: torch.Tensor, candidates: int = 8):
    """Marsaglia-Tsang draws of Gamma(a) for a >= 1 (``a`` the full
    shape)."""
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while True:
        x = _randn(g, (candidates,) + tuple(a.shape), a.dtype)
        u = _rand(g, (candidates,) + tuple(a.shape), a.dtype)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
        got = torch.gather(ok, 0, first)[0]
        val = torch.gather(d * v, 0, first)[0]
        take = todo & got
        out = torch.where(take, val, out)
        todo = todo & ~got
        if not bool(todo.any()):
            return out


@op("random_gamma", "random", differentiable=False)
def random_gamma(g, shape, alpha: float, beta: float = 1.0,
                 dtype=torch.float32):
    dt = _dtype(dtype)
    shape = _shape(shape)
    a = torch.as_tensor(alpha, dtype=dt, device=g.device).expand(shape)
    small = a < 1.0
    x = _gamma_at_least_one(g, torch.where(small, a + 1.0, a).contiguous())
    boost = _rand(g, shape, dt) ** (1.0 / a)
    return torch.where(small, x * boost, x) / beta


@op("random_poisson", "random", differentiable=False)
def random_poisson(g, shape, lam: float, dtype=torch.int32):
    rates = torch.as_tensor(lam, dtype=torch.float32, device=g.device)
    rates = rates.expand(_shape(shape)).contiguous()
    return torch.poisson(rates, generator=g).to(_dtype(dtype))


@op("random_multinomial", "random", differentiable=False)
def random_multinomial(g, logits, num_samples: int):
    """``[B, num_samples]`` int64 class indices, row ``i`` drawn from the
    softmax of ``logits[i]``."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, int(num_samples), replacement=True,
                             generator=g)


def shuffle_with(x: torch.Tensor, perm: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """``x`` permuted along ``axis`` by ``perm``."""
    return torch.index_select(x, axis, perm.to(x.device))


@op("random_shuffle", "random", differentiable=False)
def random_shuffle(g, x, axis: int = 0):
    perm = torch.randperm(x.shape[axis], generator=g, device=g.device)
    return shuffle_with(x, perm, axis)


def crop_with(x: torch.Tensor, starts: torch.Tensor,
              crop_shape: Sequence[int]) -> torch.Tensor:
    """The ``crop_shape`` window of ``x`` at ``starts`` (one offset a
    dimension, a tensor on ``x``'s device)."""
    out = x
    for d, c in enumerate(crop_shape):
        idx = starts[d] + torch.arange(int(c), device=x.device)
        out = torch.index_select(out, d, idx)
    return out


@op("random_crop", "random", differentiable=False)
def random_crop(g, x, crop_shape):
    highs = torch.tensor([dim - int(c) + 1 for dim, c in zip(x.shape,
                                                            crop_shape)],
                         device=g.device, dtype=torch.float64)
    starts = (_rand(g, (x.ndim,), torch.float64) * highs).to(torch.int64)
    return crop_with(x, starts, crop_shape)


def dropout_bp_with(grad: torch.Tensor, keep_mask: torch.Tensor,
                    rate: float) -> torch.Tensor:
    """The gradient through inverted dropout with ``keep_mask``."""
    keep = 1.0 - rate
    return torch.where(keep_mask, grad / keep,
                       torch.zeros((), dtype=grad.dtype, device=grad.device))


@op("dropout_bp", "random", differentiable=False)
def dropout_bp(g, grad, rate: float):
    return dropout_bp_with(grad, _rand(g, grad.shape) < 1.0 - rate, rate)
