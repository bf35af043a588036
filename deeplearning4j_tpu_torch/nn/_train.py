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
  dropout and stochastic-rounding bits;
- :meth:`~TrainableNetwork._run_fit`: the fit loop both networks share:
  the resume cursor (``util/checkpoint.begin_fit_cursor``), the updater
  state, the flat buckets, then one unpadded step per DataSet
  (:meth:`~TrainableNetwork._fit_serial`) or the input pipeline
  (``data/pipeline.run_epochs``), with the listeners told of every step
  and epoch. Each network binds a batch (``_bind_batch``), places it
  (``_place_batch``) and steps on it (``_step_core``);
- :meth:`~TrainableNetwork._step`: the step with the in-step telemetry
  when a listener asks for it (``optimize/telemetry.py``): the pre-step
  parameters (and, under the NaN guard, the updater state and the layer
  states) copied in one launch per bucket or dtype, the aux computed after
  the update, and under the guard the pre-step values written back with
  ``torch.where`` on a device boolean: no host synchronisation (the JAX
  step's ``layer_stats`` and ``apply_nan_guard``, ``multilayer.py:386-484``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..common.dtypes import tensor_from_numpy, torch_dtype
from ..common.tree import get_path, leaf_paths, set_path, skeleton, tree_map
from ..data import pipeline as _pipe
from ..learning.precision import (apply_updater, cast_floating,
                                  note_state_bytes)
from ..optimize import telemetry as _tel
from ._fused import FlatStore, apply_fused_flat, fused_flat_plan
from .gradnorm import normalize_gradients_


def frozen_ranges(store: FlatStore, paths) -> List[torch.Tensor]:
    """Views of ``store``'s parameter buckets that hold the leaves at
    ``paths``, adjacent leaves merged into one range."""
    want = set(paths)
    out = []
    if not want:
        return out
    for b in store.plan.buckets:
        flat = store.params[b.key]
        pos, start = 0, None
        for i, size in zip(b.leaf_idx, b.sizes):
            if store.plan.paths[i] in want:
                start = pos if start is None else start
            elif start is not None:
                out.append(flat[start:pos])
                start = None
            pos += size
        if start is not None:
            out.append(flat[start:pos])
    return out


class TrainableNetwork:
    """Parameters (``{name: {key: tensor}}``, one level deeper under a
    wrapper layer: ``common/tree.py``), layer states, updater state,
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
        self._listeners: List[Any] = []
        self._last_batch_size: Optional[int] = None
        self._steps_in_epoch = 0
        # the in-step telemetry the listeners ask for (None: off), the last
        # step's aux and the gradients its update took
        self._telemetry: Optional[_tel.TelemetryConfig] = None
        self._aux: Optional[dict] = None
        self._step_grads = None

    #: whether fit takes MultiDataSets (the graph's)
    _allow_multi = False

    @property
    def score_value(self) -> float:
        """The loss of the last training step (nan before the first)."""
        return float(self._score) if self._score is not None \
            else float("nan")

    def _check_init(self) -> None:
        if not self._initialized:
            raise ValueError("call init() first")

    def set_listeners(self, *listeners) -> None:
        """The listeners every step and epoch is told of; a checkpoint
        listener gets the whole list (``bind_group``) to save its peers'
        state for an exact resume. A telemetry listener (``TelemetrySink``,
        ``NanSentinelListener``) turns the step's aux on, and the NaN guard
        with the skip policy; the next step is the first with them."""
        self._listeners = list(listeners)
        for lst in self._listeners:
            bind = getattr(lst, "bind_group", None)
            if callable(bind):
                bind(self._listeners)
        self._telemetry = _tel.config_for(self._listeners)

    setListeners = set_listeners

    # --- parameters ----------------------------------------------------------
    def _leaves(self) -> List[torch.Tensor]:
        return [get_path(self._params, p) for p in leaf_paths(self._params)]

    def params(self) -> torch.Tensor:
        """All parameters as one flat vector, in the JAX network's order."""
        leaves = self._leaves()
        if not leaves:
            return torch.zeros((0,), device=self.device)
        with torch.no_grad():
            return torch.cat([t.reshape(-1) for t in leaves])

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in self._leaves())

    def _gradient_and_score(self, loss_fn):
        """``(grads, score)`` of ``loss_fn(params)`` by autograd, the
        gradients as ``{node: {name: tensor}}``; the score is published as
        ``score_value``."""
        paths = leaf_paths(self._params)
        leaves = [get_path(self._params, p).detach().requires_grad_(True)
                  for p in paths]
        params = skeleton(self._params)
        for p, t in zip(paths, leaves):
            set_path(params, p, t)
        with torch.enable_grad():
            loss = loss_fn(params)
            flat = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = skeleton(self._params)
        for p, t, g in zip(paths, leaves, flat):
            set_path(grads, p, torch.zeros_like(t) if g is None else g)
        self._score = loss.detach()
        return grads, float(self._score)

    # --- placement -----------------------------------------------------------
    def _to_device(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return tensor_from_numpy(np.asarray(v), self.device)

    def _place_array(self, a):
        """An array (numpy or tensor; None passes) on the network's device:
        from pinned host memory with a non-blocking copy on the card, so
        the pipeline's copies run ahead of the steps."""
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = tensor_from_numpy(np.asarray(a))
        if self.device.type == "cuda" and a.device.type == "cpu":
            return a.pin_memory().to(self.device, non_blocking=True)
        return a.to(self.device)

    # --- the fit loop --------------------------------------------------------
    def _begin_fit(self, resume_from: Optional[str]):
        from ..util.checkpoint import begin_fit_cursor

        return begin_fit_cursor(self, resume_from, listeners=self._listeners)

    def _on_epoch(self) -> None:
        self._epoch += 1
        self._steps_in_epoch = 0
        for lst in self._listeners:
            if hasattr(lst, "epoch_done"):
                lst.epoch_done(self, self._epoch)

    def _run_fit(self, data, epochs: int, batch_size: Optional[int], *,
                 pad_partial: bool, drop_remainder: bool, prefetch: int,
                 steps_per_dispatch: int, host_prefetch: int,
                 resume_from: Optional[str], serial: bool) -> None:
        self._check_init()
        skip = self._begin_fit(resume_from)
        if self._updater_state is None:
            self._updater_state = self.conf.global_conf.updater.init(
                self._params)
        store = self._flat_store()
        note_state_bytes(self._updater_state)
        if serial:
            self._fit_serial(data, epochs, store, skip, batch_size)
            return

        def dispatch(group):
            losses, auxes = [], []
            for j, b in enumerate(group):
                losses.append(self._step(store, b, self._iteration + j))
                auxes.append(self._aux)
            _pipe.note_steps(self, self._listeners, losses,
                             auxes if self._telemetry else None)

        _pipe.run_epochs(
            data, epochs, batch_size, pad_partial=pad_partial,
            drop_remainder=drop_remainder, prefetch=prefetch,
            steps_per_dispatch=steps_per_dispatch, bind=self._bind_batch,
            place=self._place_batch, dispatch=dispatch,
            on_epoch=self._on_epoch, allow_multi=self._allow_multi,
            skip=skip, host_prefetch=host_prefetch)

    def _fit_serial(self, data, epochs: int, store, skip,
                    batch_size: Optional[int] = None) -> None:
        """One unpadded step per DataSet (the loss's plain mean; a DataSet
        re-batched by ``batch_size`` when given); a resume cursor skips the
        steps the checkpoint had taken."""
        skip_epochs, skip_steps = skip if skip is not None else (0, 0)
        for e in range(max(1, epochs)):
            batches = _pipe.iter_datasets(data, batch_size,
                                          self._allow_multi)
            if e < skip_epochs:
                for _ in batches:
                    pass
                continue
            to_skip = skip_steps if e == skip_epochs else 0
            for ds in batches:
                if to_skip:
                    to_skip -= 1
                    continue
                batch = self._place_batch(self._bind_batch(ds, None))
                loss = self._serial_step(store, batch)
                _pipe.note_steps(self, self._listeners, [loss],
                                 [self._aux] if self._telemetry else None)
            self._on_epoch()

    def _serial_step(self, store, batch) -> torch.Tensor:
        """The serial loop's step on a placed batch (a network may run it as
        several, as truncated BPTT does; its aux is then the batch's)."""
        return self._step(store, batch, self._iteration)

    def _step(self, store: Optional[FlatStore], batch, iteration: int,
              *extra) -> torch.Tensor:
        """One step on a placed batch (``_step_core``; ``extra``: the
        network's own step arguments, a truncated-BPTT segment's carries),
        with the telemetry the listeners asked for: the aux in
        ``self._aux`` (None when off) and, under the NaN guard, a poisoned
        step's parameters, updater state and layer states put back to their
        pre-step values on the card. Returns the loss."""
        tele = self._telemetry
        if tele is None:
            self._aux = None
            return self._step_core(store, batch, iteration, *extra)
        guard = tele.nan_guard
        with torch.no_grad():
            if store is not None:
                old_flat = {k: v.clone() for k, v in store.params.items()}
                old_params = store.plan.unflatten(old_flat)
                old_upd = ({s: {k: v.clone() for k, v in d.items()}
                            for s, d in store.state.items()}
                           if guard else None)
            else:
                old_params = _tel.clone_tree(self._params)
                old_upd = self._updater_state
            old_states = _tel.clone_tree(self._states) if guard else None
        loss = self._step_core(store, batch, iteration, *extra)
        with torch.no_grad():
            aux = _tel.layer_stats(old_params, self._params,
                                   self._step_grads, loss)
            self._step_grads = None
            if guard:
                ok = aux["nonfinite_total"] == 0
                aux["skipped"] = (~ok).to(torch.int32)
                self._states = _tel.where_tree(ok, self._states, old_states)
                if store is not None:
                    for k, v in store.params.items():
                        torch.where(ok, v, old_flat[k], out=v)
                    for s, d in store.state.items():
                        for k, v in d.items():
                            torch.where(ok, v, old_upd[s][k], out=v)
                else:
                    paths = leaf_paths(self._params)
                    kept = _tel.where_tree(ok, self._params, old_params)
                    torch._foreach_copy_(
                        [get_path(self._params, p) for p in paths],
                        [get_path(kept, p) for p in paths])
                    if self._updater_state:
                        self._updater_state = _tel.where_tree(
                            ok, self._updater_state, old_upd)
        self._aux = aux
        return loss

    def _frozen_paths(self) -> List[tuple]:
        """The leaf paths whose parameters a step leaves unchanged (a
        ``MultiLayerNetwork``'s ``FrozenLayer`` layers)."""
        return []

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
        leaves = [get_path(params, p) for p in leaf_paths(params)]
        key = (ct,) + tuple((id(t), t._version) for t in leaves)
        cached = self._cast_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        cast = cast_floating(params, ct)
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
        leaves = [get_path(params, p) for p in paths]
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
                # a parameter outside the loss (a graph's center-loss
                # centers) takes a zero gradient, as under jax.grad
                flat_grads = torch.autograd.grad(loss, leaves,
                                                 allow_unused=True)
                grads = skeleton(params)
                for p, t, g in zip(paths, leaves, flat_grads):
                    set_path(grads, p,
                             torch.zeros_like(t) if g is None else g)
        tree = store.grad_views if store is not None else grads
        if gc.grad_normalization:
            # after the backward, before the update (the JAX networks'
            # order); on the fused path in place on the gradient bucket's
            # leaf views
            normalize_gradients_([get_path(tree, p) for p in paths],
                                 gc.grad_normalization, gc.grad_norm_threshold)
        if self._telemetry is not None:
            self._step_grads = tree     # what the update took, for the aux
        frozen = self._frozen_paths()
        with torch.no_grad():
            if store is not None:
                # the kernel updates the whole bucket, frozen ranges too (a
                # zero gradient moves an element under decoupled weight
                # decay): the frozen ranges are kept aside and written
                # back, as the JAX step restores the frozen layers' tensors
                # after its updater; their updater state evolves as there
                kept = [(r, r.clone()) for r in frozen_ranges(store, frozen)]
                apply_fused_flat(store, gc.updater, iteration,
                                 self.generator())
                for r, v in kept:
                    r.copy_(v)
            else:
                new_params, self._updater_state = apply_updater(
                    gc.updater, grads, self._updater_state, params,
                    iteration, self.generator())
                skip = set(frozen)
                for p in paths:
                    if p not in skip:
                        get_path(params, p).copy_(get_path(new_params, p))
        # the parameters changed in place: on the card the fused kernel
        # wrote them behind the versions that the cast cache's key reads
        self._cast_cache = None
        new_states = tree_map(lambda v: v.detach(), new_states)
        return loss.detach(), new_states
