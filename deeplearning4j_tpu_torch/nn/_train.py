"""What ``ComputationGraph`` and ``MultiLayerNetwork`` share around a step.

:class:`TrainableNetwork` is the base of both networks. It owns the state a
step reads and replaces, and the invariants that tie that state together:

- :meth:`~TrainableNetwork._compute_params`: the parameters in
  ``compute_dtype`` for inference, cached until a parameter is replaced or
  changed in place, and dropped by every training step;
- :meth:`~TrainableNetwork._flat_store`: the persistent flat buckets behind
  ``fused_update`` (``nn/_fused.FlatStore``), made or remade when the
  parameters or the updater state were replaced;
- :meth:`~TrainableNetwork._train_step`: one step after the forward: the
  backward, the gradient normalization (``nn/gradnorm.py``), and the
  update, through the buckets (one ``csrc/fused_update.cu`` launch per
  float32 bucket) or leaf by leaf (``learning/precision.apply_updater``);
  the counterpart of the JAX networks' ``_step_core``
  (``multilayer.py:386-484``, ``graph.py:747-808``);
- :meth:`~TrainableNetwork.generator`: the network's own generator for
  dropout and stochastic-rounding bits.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..common.dtypes import torch_dtype
from ..learning.precision import apply_updater
from ..parallel.sharding import leaf_paths
from ._fused import FlatStore, apply_fused_flat, fused_flat_plan
from .gradnorm import normalize_gradients_


class TrainableNetwork:
    """Parameters (``{name: {key: tensor}}``), layer states, updater state,
    flat buckets, the inference cast cache and the generator of a network
    built from ``conf``."""

    def __init__(self, conf):
        self.conf = conf
        self._params: Dict[str, Dict[str, torch.Tensor]] = {}
        self._states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._initialized = False
        self.device: Optional[torch.device] = None
        self._updater_state = None
        self._iteration = 0
        self._epoch = 0
        self._score: Optional[torch.Tensor] = None
        self._flat: Optional[FlatStore] = None
        self._cast_cache = None
        self._generator: Optional[torch.Generator] = None

    @property
    def score_value(self) -> float:
        """The loss of the last training step (nan before the first)."""
        return float(self._score) if self._score is not None \
            else float("nan")

    def _check_init(self) -> None:
        if not self._initialized:
            raise ValueError("call init() first")

    def generator(self) -> torch.Generator:
        """The network's own generator for dropout and stochastic-rounding
        bits, on its device, seeded from the configuration's seed."""
        if self._generator is None:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(int(self.conf.global_conf.seed))
        return self._generator

    def _compute_params(self, params):
        """``params`` with every float tensor cast to ``compute_dtype``,
        cached until a tensor is replaced or modified in place (the key
        holds each tensor's id and version) or a step runs: the fused
        kernel writes the bucket through raw pointers, which bumps no
        version."""
        ct = torch_dtype(self.conf.global_conf.compute_dtype)
        leaves = [t for p in params.values() for t in p.values()]
        key = (ct,) + tuple((id(t), t._version) for t in leaves)
        cached = self._cast_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        cast = {n: {k: (t.to(ct) if t.is_floating_point() else t)
                    for k, t in p.items()} for n, p in params.items()}
        # the cache holds the source tensors too, so their ids stay unique
        self._cast_cache = (key, cast, leaves)
        return cast

    def _flat_store(self) -> Optional[FlatStore]:
        """The flat buckets for ``fused_update`` (the parameters become
        views of them), or None on the per-leaf path."""
        store = self._flat
        if store is not None and self.conf.global_conf.fused_update \
                and store.holds(self._params):
            if self._updater_state is not store.state_views:
                store.set_state(self._updater_state)
                self._updater_state = store.state_views
            return store
        self._flat = None
        plan = fused_flat_plan(self.conf, self._params)
        if plan is None:
            return None
        store = FlatStore(plan, self._params, self._updater_state)
        self._params = store.param_views
        self._updater_state = store.state_views
        self._flat = store
        self._cast_cache = None
        return store

    def _train_step(self, store: Optional[FlatStore], loss_fn: Callable,
                    iteration: int):
        """Backward of ``loss_fn(params) -> (loss, new_states)``, gradient
        normalization and the update of the parameters in place (through
        ``store`` when given). Returns ``(loss, new_states)``, both
        detached."""
        gc = self.conf.global_conf
        params = self._params
        paths = leaf_paths(params)
        leaves = [params[n][k] for n, k in paths]
        if store is None:
            for t in leaves:
                if t.is_floating_point() and not t.requires_grad:
                    t.requires_grad_(True)
        else:
            store.bind_grads()
        with torch.enable_grad():
            loss, new_states = loss_fn(params)
            if store is not None:
                loss.backward()             # into the store's gradient buckets
            else:
                flat_grads = torch.autograd.grad(loss, leaves)
                grads = {n: {} for n in params}
                for (n, k), g in zip(paths, flat_grads):
                    grads[n][k] = g
        if gc.grad_normalization:
            # after the backward, before the update (the JAX networks'
            # order); on the fused path in place on the gradient bucket's
            # leaf views
            tree = store.grad_views if store is not None else grads
            normalize_gradients_([tree[n][k] for n, k in paths],
                                 gc.grad_normalization, gc.grad_norm_threshold)
        with torch.no_grad():
            if store is not None:
                apply_fused_flat(store, gc.updater, iteration,
                                 self.generator())
            else:
                new_params, self._updater_state = apply_updater(
                    gc.updater, grads, self._updater_state, params,
                    iteration, self.generator())
                for n, k in paths:
                    params[n][k].copy_(new_params[n][k])
        # the parameters changed in place: on the card the fused kernel
        # wrote them behind the versions that the cast cache's key reads
        self._cast_cache = None
        new_states = {n: {k: v.detach() for k, v in d.items()}
                      for n, d in new_states.items()}
        return loss.detach(), new_states
