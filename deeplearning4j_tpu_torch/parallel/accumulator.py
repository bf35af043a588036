"""Gradient accumulators: how the replicas' gradients are exchanged.

Counterpart of ``deeplearning4j_tpu/parallel/accumulator.py`` (DL4J's
``GradientsAccumulator``, ``EncodedGradientsAccumulator`` and the threshold
algorithms). Three exchanges, which ``ParallelWrapper`` runs each step:

- :class:`DenseAllReduceAccumulator` (default): the mean of the gradients
  over the replicas (``parallel/_collectives.all_reduce_mean``); every
  replica applies the whole update to its own copy.
- :class:`ReduceScatterAccumulator`: ZeRO-1 (arXiv:2004.13336). Each
  replica receives the mean of its 1/N slice of the flat buckets, updates
  that slice against its 1/N of the updater state, and the slices are
  gathered back into every replica's parameters.
- :class:`EncodedGradientsAccumulator`: threshold encoding with a residual
  per replica (error feedback): ``u = g + residual``; elements with
  ``|u| >= t`` are sent as ``sign(u) * t``, the rest as 0; the residual
  keeps ``u - sent``; the mean of the sent tensors feeds the updater; the
  threshold then adapts to the global density (:class:`ThresholdAlgorithm`).

Encoding is elementwise, so the port encodes each replica's flat gradient
buckets; the JAX package encodes the dense gradient tree. The values, and
the counts of sent elements, are the same. As in the JAX package the
exchanged tensor is the dense thresholded one (mathematically the decoded
message) and the wire format is only estimated (``OpProfiler.
collective_stats``).

State layouts of the encoded accumulator:

- the **host layout** (:meth:`EncodedGradientsAccumulator.init_state`,
  :meth:`~EncodedGradientsAccumulator.resize_state`, checkpoints, and the
  model's ``_acc_state`` between fits), the JAX package's: ``residual`` a
  tree like the parameters with a leading replica axis ``[n, *shape]``,
  then the scalars ``threshold`` (float32), ``nnz_sum``, ``elems_sum``
  (float32) and ``steps`` (int32);
- the **placed layout** that :meth:`~EncodedGradientsAccumulator.exchange`
  takes during a fit: ``residual`` a list with one flat-bucket dict per
  replica on its device, the scalars as 0-dim tensors on replica 0's
  device. ``ParallelWrapper`` converts between the two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common.tree import get_path, leaf_paths, set_path, skeleton
from ._collectives import all_reduce_mean, sum_to


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``like``'s device (a fill,
    no host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _as_f32(x) -> torch.Tensor:
    return x.to(torch.float32) if isinstance(x, torch.Tensor) \
        else torch.tensor(x, dtype=torch.float32)


class GradientsAccumulator:
    """How per-replica gradients become the reduced update. Stateless
    accumulators implement :meth:`reduce_gradients`; stateful ones
    (``stateful = True``) also ``init_state``, ``state_specs``,
    ``exchange`` and ``resize_state``. ``axis_name`` names the replicas'
    axis of the mesh, as in the JAX package."""

    axis_name: str = "data"
    stateful: bool = False
    zero1: bool = False

    def reduce_gradients(self, grads: Sequence[torch.Tensor]
                         ) -> List[torch.Tensor]:
        raise NotImplementedError

    def init_state(self, params, n_shards: int = 1) -> Dict[str, Any]:
        return {}

    def state_specs(self, params) -> Dict[str, Any]:
        """Which leaves of the state are per replica (``"replica"``) and
        which are one value for all (``"replicated"``): the port's
        counterpart of the JAX ``PartitionSpec`` tree."""
        return {}

    def exchange(self, grads, state):
        """``(grads, state) -> (reduced, new_state, density)`` over the
        replicas' gradient dicts; ``density`` is None for a dense
        exchange."""
        keys = list(grads[0])
        red = {k: self.reduce_gradients([g[k] for g in grads]) for k in keys}
        return ([{k: red[k][r] for k in keys} for r in range(len(grads))],
                state, None)

    def resize_state(self, state, old_n: int, new_n: int,
                     lost_replicas=()):
        """The state through an online resize of the replica count
        (stateless accumulators pass it through)."""
        return state


class DenseAllReduceAccumulator(GradientsAccumulator):
    """The mean all-reduce over the replicas."""

    def __init__(self, axis_name: str = "data"):
        self.axis_name = axis_name

    def reduce_gradients(self, grads):
        return all_reduce_mean(grads)


class ReduceScatterAccumulator(DenseAllReduceAccumulator):
    """Selects ZeRO-1 in ``ParallelWrapper`` (see the module docstring);
    outside the wrapper it reduces as the dense mean."""

    zero1 = True


@dataclass
class ThresholdAlgorithm:
    """Owns the encoding threshold; the base class never moves it."""

    initial_threshold: float = 1e-3

    def initial(self) -> float:
        return float(self.initial_threshold)

    def update(self, threshold, density):
        return threshold


class FixedThresholdAlgorithm(ThresholdAlgorithm):
    pass


@dataclass
class AdaptiveThresholdAlgorithm(ThresholdAlgorithm):
    """Keeps the density inside ``[min_density, max_density]``: above it
    the threshold grows by ``1/decay``, below it shrinks by ``decay``,
    clipped to ``[min_threshold, max_threshold]``."""

    initial_threshold: float = 1e-3
    min_density: float = 1e-4
    max_density: float = 1e-2
    decay: float = 0.95
    min_threshold: float = 1e-6
    max_threshold: float = 1.0

    def update(self, threshold, density):
        t, d = _as_f32(threshold), _as_f32(density)
        c = lambda v: _const(v, t)  # noqa: E731
        new = torch.where(d > c(self.max_density), t / c(self.decay),
                          torch.where(d < c(self.min_density),
                                      t * c(self.decay), t))
        return torch.clamp(new, c(self.min_threshold), c(self.max_threshold))


@dataclass
class TargetSparsityThresholdAlgorithm(ThresholdAlgorithm):
    """Proportional control toward ``sparsity_target``:
    ``t * ((density + eps) / (target + eps)) ** gain``, clipped."""

    initial_threshold: float = 1e-3
    sparsity_target: float = 1e-3
    gain: float = 0.25
    min_threshold: float = 1e-6
    max_threshold: float = 1.0

    def update(self, threshold, density):
        t, d = _as_f32(threshold), _as_f32(density)
        c = lambda v: _const(v, t)  # noqa: E731
        eps = c(1e-12)
        ratio = (d + eps) / (c(self.sparsity_target) + eps)
        new = t * torch.pow(ratio, c(self.gain))
        return torch.clamp(new, c(self.min_threshold), c(self.max_threshold))


def _map_leaves(fn, tree):
    """``fn`` on every array leaf of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


class EncodedGradientsAccumulator(DenseAllReduceAccumulator):
    """Threshold encoding with a residual per replica (module
    docstring)."""

    stateful = True

    def __init__(self, parties: int = 1,
                 threshold_algorithm: Optional[ThresholdAlgorithm] = None,
                 residual_post_processor: Any = None,
                 axis_name: str = "data"):
        super().__init__(axis_name)
        self.parties = parties
        self.threshold_algorithm = (threshold_algorithm
                                    or AdaptiveThresholdAlgorithm())
        self.residual_post_processor = residual_post_processor

    def init_state(self, params, n_shards: int = 1) -> Dict[str, Any]:
        """The host layout, residuals zero: CPU tensors."""
        res = skeleton(params)
        for p in leaf_paths(params):
            t = get_path(params, p)
            set_path(res, p, torch.zeros((n_shards,) + tuple(t.shape),
                                         dtype=t.dtype))
        return {
            "residual": res,
            "threshold": torch.tensor(self.threshold_algorithm.initial(),
                                      dtype=torch.float32),
            "nnz_sum": torch.tensor(0.0, dtype=torch.float32),
            "elems_sum": torch.tensor(0.0, dtype=torch.float32),
            "steps": torch.tensor(0, dtype=torch.int32),
        }

    def state_specs(self, params) -> Dict[str, Any]:
        return {"residual": "replica", "threshold": "replicated",
                "nnz_sum": "replicated", "elems_sum": "replicated",
                "steps": "replicated"}

    def resize_state(self, state, old_n: int, new_n: int,
                     lost_replicas=()):
        """The host-layout state through an online resize (the JAX
        package's numerics): survivors keep their residual rows, compacted;
        each lost row, and on a shrink below the survivors the tail, is
        added onto row 0, so the pending mass ``sum_i r_i`` is kept; a grow
        adds zero rows. The scalars carry over unchanged. Leaves keep their
        kind (numpy arrays or tensors)."""
        if not (isinstance(state, dict) and "residual" in state):
            return state
        lost = sorted({int(r) for r in (lost_replicas or ())})
        old_n, new_n = int(old_n), int(new_n)

        def remap(r):
            is_np = not isinstance(r, torch.Tensor)
            t = torch.from_numpy(np.asarray(r)) if is_np else r
            out = t.new_zeros((new_n,) + tuple(t.shape[1:]))
            if t.ndim >= 1 and t.shape[0] == old_n:
                keep = [i for i in range(old_n) if i not in lost]
                fold = lost + keep[new_n:]
                keep = keep[:new_n]
                if keep:
                    out[:len(keep)] = t[keep]
                if fold:
                    out[0] = out[0] + t[fold].sum(dim=0)
            return out.numpy() if is_np else out

        st = dict(state)
        st["residual"] = _map_leaves(remap, state["residual"])
        return st

    def exchange(self, grads: Sequence[Dict[str, torch.Tensor]],
                 state: Dict[str, Any]):
        """One exchange over the replicas' flat gradient dicts, on the
        placed state: returns ``(reduced, new_state, density)``, ``reduced``
        one dict per replica (tensors shared by the replicas of a
        device)."""
        thr = state["threshold"]
        sent, new_res, nnz = [], [], []
        elems = 0
        for g, res in zip(grads, state["residual"]):
            e_r, r_r = {}, {}
            count = None
            for k, gk in g.items():
                u = gk + res[k].to(gk.dtype)
                t = thr.to(device=u.device, dtype=u.dtype)
                e = torch.where(u.abs() >= t, torch.sign(u) * t,
                                torch.zeros((), dtype=u.dtype,
                                            device=u.device))
                r_r[k] = u - e
                e_r[k] = e
                c = (e != 0).sum()
                count = c if count is None else count + c
                elems += e.numel()
            if self.residual_post_processor is not None:
                r_r = self.residual_post_processor(r_r)
            sent.append(e_r)
            new_res.append(r_r)
            nnz.append(count.to(torch.float32))
        keys = list(grads[0])
        red = {k: all_reduce_mean([e[k] for e in sent]) for k in keys}
        reduced = [{k: red[k][r] for k in keys} for r in range(len(grads))]
        nnz_t = sum_to(nnz, thr.device)
        elems_t = _const(float(elems), thr)
        density = nnz_t / torch.clamp_min(elems_t, 1.0)
        new_state = {
            "residual": new_res,
            "threshold": _as_f32(self.threshold_algorithm.update(
                thr, density)),
            "nnz_sum": state["nnz_sum"] + nnz_t,
            "elems_sum": state["elems_sum"] + elems_t,
            "steps": state["steps"] + 1,
        }
        return reduced, new_state, density
