"""Gradient updaters (optimizers).

Counterpart of ``deeplearning4j_tpu/learning/updaters.py`` for the four
kinds the fused flat-bucket kernel takes: ``Sgd``, ``Nesterovs``, ``Adam``
and ``AdamW``. Each updater is a transform on nested dicts of tensors,
``init(params) -> state`` and ``apply(grads, state, params, iteration) ->
(new_params, new_state)``, with every expression in the JAX package's
order. The JAX package's Python-float hyperparameters are weak scalars that
round to float32 once against float32 tensors; here they are 0-dim float32
tensors on the parameters' device (:func:`f32_scalars`), which rounds them
the same way and keeps a division a true division on the card (PyTorch
turns division by a Python scalar into a multiplication by its reciprocal
there). The other updaters of the JAX package are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Union

import numpy as np
import torch

from ..common.dtypes import torch_dtype

Tree = Dict[str, Dict[str, torch.Tensor]]


def _lr_at(lr: Union[float, object], iteration: int) -> float:
    if hasattr(lr, "value_at"):
        return lr.value_at(iteration)
    return lr


def f32_scalars(values: Sequence[float], device) -> tuple:
    """Python floats as 0-dim float32 tensors on ``device``: one round to
    float32 each, as a weak scalar meets a float32 array in JAX."""
    return tuple(torch.tensor(np.float32(v), device=device) for v in values)


def tree_map(fn, *trees: Tree) -> Tree:
    """``fn`` over matching leaves of ``{node: {name: tensor}}`` trees."""
    first = trees[0]
    return {n: {k: fn(*(t[n][k] for t in trees)) for k in d}
            for n, d in first.items()}


def _device_of(tree: Tree):
    for d in tree.values():
        for t in d.values():
            return t.device
    return torch.device("cpu")


class GradientUpdater:
    """Base: stateless configuration; the state is an explicit tree.

    ``elementwise``: the updater computes each element from that element's
    own gradient and state alone, so applying it to any permutation or
    slice of the flattened parameters (the flat buckets of
    ``parallel/sharding.Zero1Plan``) equals applying it leaf by leaf. The
    base default is False, so a custom updater that couples elements is
    refused by the flat path unless its author opts in.

    ``state_dtype`` (e.g. ``"bfloat16"``): store the moments in this dtype.
    The math still runs in float32: ``learning.precision.apply_updater``
    upcasts, calls ``apply``, and rounds the new moments back down
    stochastically. ``apply`` itself never reads the field.
    """

    learning_rate: float = 1e-1
    elementwise: bool = False
    state_dtype = None

    def init(self, params: Tree) -> dict:
        return {}

    def _zeros_like(self, params: Tree) -> Tree:
        """Fresh state mirroring ``params``, in ``state_dtype`` when set."""
        if not self.state_dtype:
            return tree_map(torch.zeros_like, params)
        dt = torch_dtype(self.state_dtype)
        return tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device)
                        if p.is_floating_point() else torch.zeros_like(p),
                        params)

    def apply(self, grads: Tree, state, params: Tree, iteration: int):
        raise NotImplementedError(
            f"{type(self).__name__}.apply is not ported yet")


@dataclass
class Sgd(GradientUpdater):
    elementwise = True
    learning_rate: float = 1e-1

    def apply(self, grads, state, params, iteration):
        (lr,) = f32_scalars([_lr_at(self.learning_rate, iteration)],
                            _device_of(params))
        return tree_map(lambda p, g: p - lr * g, params, grads), state


@dataclass
class Nesterovs(GradientUpdater):
    elementwise = True
    learning_rate: float = 0.1
    momentum: float = 0.9

    def init(self, params):
        return {"v": self._zeros_like(params)}

    def apply(self, grads, state, params, iteration):
        # (1.0 + mu) is a Python float, rounded once, as in the JAX package
        lr, mu, opmu = f32_scalars(
            [_lr_at(self.learning_rate, iteration), self.momentum,
             1.0 + self.momentum], _device_of(params))
        new_p: Tree = {n: {} for n in params}
        new_v: Tree = {n: {} for n in params}
        # reference Nesterovs: vPrev = v; v = mu*v - lr*g;
        # p += -mu*vPrev + (1+mu)*v
        for n, d in params.items():
            for k, p in d.items():
                v = state["v"][n][k]
                v_new = mu * v - lr * grads[n][k]
                new_p[n][k] = p + (-mu * v + opmu * v_new)
                new_v[n][k] = v_new
        return new_p, {"v": new_v}


@dataclass
class Adam(GradientUpdater):
    elementwise = True
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init(self, params):
        return {"m": self._zeros_like(params),
                "v": self._zeros_like(params)}

    def _scalars(self, iteration, device):
        t = iteration + 1
        return f32_scalars(
            [_lr_at(self.learning_rate, iteration), self.beta1, self.beta2,
             self.epsilon, 1 - self.beta1 ** t, 1 - self.beta2 ** t,
             1 - self.beta1, 1 - self.beta2], device)

    def _step(self, sc, p, m_new, v_new):
        lr, eps, bc1, bc2 = sc[0], sc[3], sc[4], sc[5]
        return lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)

    def apply(self, grads, state, params, iteration):
        sc = self._scalars(iteration, _device_of(params))
        b1, b2, omb1, omb2 = sc[1], sc[2], sc[6], sc[7]
        new_p: Tree = {n: {} for n in params}
        new_m: Tree = {n: {} for n in params}
        new_v: Tree = {n: {} for n in params}
        for n, d in params.items():
            for k, p in d.items():
                g = grads[n][k]
                m_new = b1 * state["m"][n][k] + omb1 * g
                v_new = b2 * state["v"][n][k] + omb2 * (g * g)
                new_p[n][k] = p - self._step(sc, p, m_new, v_new)
                new_m[n][k] = m_new
                new_v[n][k] = v_new
        return new_p, {"m": new_m, "v": new_v}


@dataclass
class AdamW(Adam):
    """Adam with decoupled weight decay."""

    weight_decay: float = 1e-2

    def _scalars(self, iteration, device):
        return super()._scalars(iteration, device) + f32_scalars(
            [self.weight_decay], device)

    def _step(self, sc, p, m_new, v_new):
        lr, eps, bc1, bc2, wd = sc[0], sc[3], sc[4], sc[5], sc[8]
        return lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
                     + wd * p)
