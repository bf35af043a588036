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
there).

The per-leaf updaters without a fused kernel, ``NoOp``, ``AdaGrad``,
``AdaDelta``, ``RmsProp``, ``AdaMax``, ``Nadam`` and ``AMSGrad`` (JAX
``updaters.py:101-295``), follow the same rules. ``AdaMax``, ``Nadam`` and
``AMSGrad`` subclass ``Adam`` as in the JAX package; the fused kernel's kind
table matches on the exact type (``ops/update._KINDS``), so under
``fused_update`` they run this math on the flat buckets, counted under
``precision/fused_fallbacks``, where the JAX package falls back too.
``updater_from_name`` makes one by its lower-case name. A learning rate may
be a schedule (``learning/schedules.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Sequence, Union

import numpy as np
import torch

from ..common.dtypes import torch_dtype
from ..common.tree import get_path, leaf_paths, set_path, skeleton, tree_map

Tree = Dict[str, Dict[str, Any]]


def _lr_at(lr: Union[float, object], iteration: int) -> float:
    """The rate at ``iteration``: a schedule's value (a Python float, the
    JAX step's float64), or the constant."""
    if hasattr(lr, "value_at"):
        return lr.value_at(iteration)
    return lr


def f32_scalars(values: Sequence[float], device) -> tuple:
    """Python floats as 0-dim float32 tensors on ``device``: one round to
    float32 each, as a weak scalar meets a float32 array in JAX."""
    return tuple(torch.tensor(np.float32(v), device=device) for v in values)


def _device_of(tree: Tree):
    for p in leaf_paths(tree):
        return get_path(tree, p).device
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
        # reference Nesterovs: vPrev = v; v = mu*v - lr*g;
        # p += -mu*vPrev + (1+mu)*v
        def upd(p, g, v):
            v_new = mu * v - lr * g
            return p + (-mu * v + opmu * v_new), v_new

        new_p, (v,) = _map_leaves(upd, params, grads, state["v"])
        return new_p, {"v": v}


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

        def upd(p, g, m, v):
            m_new = b1 * m + omb1 * g
            v_new = b2 * v + omb2 * (g * g)
            return p - self._step(sc, p, m_new, v_new), m_new, v_new

        new_p, (m, v) = _map_leaves(upd, params, grads, state["m"],
                                    state["v"])
        return new_p, {"m": m, "v": v}


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


def _map_leaves(fn, params: Tree, grads: Tree, *slots: Tree):
    """``fn(p, g, *slot_leaves) -> (new_p, *new_slot_leaves)`` over every
    leaf; returns ``(new_params, [new_slot_tree, ...])``."""
    new_p: Tree = skeleton(params)
    new_s = [skeleton(params) for _ in slots]
    for path in leaf_paths(params):
        out = fn(get_path(params, path), get_path(grads, path),
                 *(get_path(s, path) for s in slots))
        set_path(new_p, path, out[0])
        for tree, leaf in zip(new_s, out[1:]):
            set_path(tree, path, leaf)
    return new_p, new_s


@dataclass
class NoOp(GradientUpdater):
    elementwise = True
    learning_rate: float = 0.0

    def apply(self, grads, state, params, iteration):
        return params, state


@dataclass
class AdaGrad(GradientUpdater):
    elementwise = True
    learning_rate: float = 1e-1
    epsilon: float = 1e-6

    def init(self, params):
        return {"h": self._zeros_like(params)}

    def apply(self, grads, state, params, iteration):
        lr, eps = f32_scalars([_lr_at(self.learning_rate, iteration),
                               self.epsilon], _device_of(params))

        def upd(p, g, h):
            h_new = h + g * g
            return p - lr * g / (torch.sqrt(h_new) + eps), h_new

        new_p, (h,) = _map_leaves(upd, params, grads, state["h"])
        return new_p, {"h": h}


@dataclass
class AdaDelta(GradientUpdater):
    elementwise = True
    rho: float = 0.95
    epsilon: float = 1e-6
    learning_rate: float = 1.0  # AdaDelta is LR-free

    def init(self, params):
        return {"msg": self._zeros_like(params),
                "msdx": self._zeros_like(params)}

    def apply(self, grads, state, params, iteration):
        rho, eps, omr = f32_scalars([self.rho, self.epsilon, 1 - self.rho],
                                    _device_of(params))

        def upd(p, g, msg, msdx):
            msg_new = rho * msg + omr * (g * g)
            dx = -torch.sqrt(msdx + eps) / torch.sqrt(msg_new + eps) * g
            msdx_new = rho * msdx + omr * (dx * dx)
            return p + dx, msg_new, msdx_new

        new_p, (msg, msdx) = _map_leaves(upd, params, grads, state["msg"],
                                         state["msdx"])
        return new_p, {"msg": msg, "msdx": msdx}


@dataclass
class RmsProp(GradientUpdater):
    elementwise = True
    learning_rate: float = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init(self, params):
        return {"g2": self._zeros_like(params)}

    def apply(self, grads, state, params, iteration):
        lr, d, omd, eps = f32_scalars(
            [_lr_at(self.learning_rate, iteration), self.rms_decay,
             1 - self.rms_decay, self.epsilon], _device_of(params))

        def upd(p, g, g2):
            g2_new = d * g2 + omd * (g * g)
            return p - lr * g / (torch.sqrt(g2_new) + eps), g2_new

        new_p, (g2,) = _map_leaves(upd, params, grads, state["g2"])
        return new_p, {"g2": g2}


@dataclass
class AdaMax(Adam):
    """Adam with the infinity norm; ``v`` holds ``u = max(beta2 u, |g|)``."""

    def apply(self, grads, state, params, iteration):
        sc = self._scalars(iteration, _device_of(params))
        lr, b1, b2, eps, bc1, omb1 = sc[0], sc[1], sc[2], sc[3], sc[4], sc[6]

        def upd(p, g, m, u):
            m_new = b1 * m + omb1 * g
            u_new = torch.maximum(b2 * u, torch.abs(g))
            return p - lr * (m_new / bc1) / (u_new + eps), m_new, u_new

        new_p, (m, v) = _map_leaves(upd, params, grads, state["m"],
                                    state["v"])
        return new_p, {"m": m, "v": v}


@dataclass
class Nadam(Adam):
    """Adam with Nesterov momentum."""

    def apply(self, grads, state, params, iteration):
        lr, b1, b2, eps, bc1, bc2, omb1, omb2 = self._scalars(
            iteration, _device_of(params))

        def upd(p, g, m, v):
            m_new = b1 * m + omb1 * g
            v_new = b2 * v + omb2 * (g * g)
            m_hat = b1 * m_new / bc1 + omb1 * g / bc1
            return (p - lr * m_hat / (torch.sqrt(v_new / bc2) + eps),
                    m_new, v_new)

        new_p, (m, v) = _map_leaves(upd, params, grads, state["m"],
                                    state["v"])
        return new_p, {"m": m, "v": v}


@dataclass
class AMSGrad(Adam):
    """Adam with the running maximum of ``v`` (``vhat``) in the
    denominator."""

    def init(self, params):
        return {"m": self._zeros_like(params),
                "v": self._zeros_like(params),
                "vhat": self._zeros_like(params)}

    def apply(self, grads, state, params, iteration):
        lr, b1, b2, eps, bc1, bc2, omb1, omb2 = self._scalars(
            iteration, _device_of(params))

        def upd(p, g, m, v, vh):
            m_new = b1 * m + omb1 * g
            v_new = b2 * v + omb2 * (g * g)
            vh_new = torch.maximum(vh, v_new)
            return (p - lr * (m_new / bc1) / (torch.sqrt(vh_new / bc2) + eps),
                    m_new, v_new, vh_new)

        new_p, (m, v, vh) = _map_leaves(upd, params, grads, state["m"],
                                        state["v"], state["vhat"])
        return new_p, {"m": m, "v": v, "vhat": vh}


_BY_NAME = {
    "sgd": Sgd, "adam": Adam, "adamw": AdamW, "nesterovs": Nesterovs,
    "adagrad": AdaGrad, "adadelta": AdaDelta, "adamax": AdaMax,
    "nadam": Nadam, "amsgrad": AMSGrad, "rmsprop": RmsProp, "noop": NoOp,
}


def updater_from_name(name: str, **kwargs) -> GradientUpdater:
    """The updater of lower-case ``name`` (the JAX package's names)."""
    return _BY_NAME[name.lower()](**kwargs)
