"""The single-device fused weight update: flat buckets that persist.

Counterpart of ``_fused_flat_plan`` and ``_apply_fused_flat``
(``deeplearning4j_tpu/nn/multilayer.py:974-1031``), shared by the networks
(``ComputationGraph`` and ``MultiLayerNetwork``).

Where the JAX step flattens the parameters into buckets inside every
compiled step and unflattens the result, the port keeps each bucket as one
persistent tensor (:class:`FlatStore`): the network's parameters are leaf
views of the parameter bucket, their ``.grad`` are views of one gradient
bucket (so autograd accumulates the gradients straight into the flat layout,
the counterpart of ``Zero1Plan.unflatten_diff``: no gradient is born per
leaf and copied), and the updater state is kept in buckets with dense views.
The kernel then updates the parameter and moment buckets in place.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from ..common.profiler import OpProfiler
from ..common.tree import get_path, leaf_paths
from ..ops.update import apply_flat_updater
from ..parallel.sharding import Zero1Plan, is_flat_state

log = logging.getLogger("deeplearning4j_tpu_torch")


def fused_flat_plan(conf, params) -> Optional[Zero1Plan]:
    """The ``Zero1Plan(params, 1)`` behind ``fused_update``; None when the
    knob is off or the updater is not elementwise (counted under
    ``precision/fused_fallbacks`` and warned: the per-leaf path runs)."""
    if not conf.global_conf.fused_update:
        return None
    updater = conf.global_conf.updater
    if not getattr(updater, "elementwise", False):
        OpProfiler.get().count("precision/fused_fallbacks")
        log.warning("fused_update requested but %s does not declare "
                    "elementwise=True; using the per-leaf updater path",
                    type(updater).__name__)
        return None
    return Zero1Plan(params, 1)


class FlatStore:
    """Persistent parameter, gradient and updater-state buckets of one
    network, with the dense views the network works on."""

    def __init__(self, plan: Zero1Plan, params, upd_state):
        self.plan = plan
        with torch.no_grad():
            self.params = plan.flatten(params)
        self.param_views = plan.unflatten(self.params)
        for p in plan.paths:
            t = get_path(self.param_views, p)
            if t.is_floating_point():
                t.requires_grad_(True)
        self.grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.grad_views = plan.unflatten(self.grads)
        self.set_state(upd_state)

    def holds(self, params) -> bool:
        """True while ``params`` are still this store's views (a caller may
        have replaced the dict or single entries)."""
        views = self.param_views
        if len(leaf_paths(params)) != self.plan.n_leaves:
            return False
        try:
            return all(get_path(params, p) is get_path(views, p)
                       for p in self.plan.paths)
        except KeyError:
            return False

    def set_state(self, upd_state) -> None:
        """Take over an updater state (dense or flat): copied into buckets,
        exposed again as dense views (:attr:`state_views`)."""
        if is_flat_state(upd_state):
            upd_state = self.plan.unflatten_state(upd_state)
        with torch.no_grad():
            self.state = self.plan.flatten_state(upd_state or {})
        self.state_views = self.plan.unflatten_state_inplan(self.state)

    def bind_grads(self) -> None:
        """Zero the gradient buckets and make each parameter's ``.grad`` its
        view, so the next backward accumulates into the buckets."""
        for g in self.grads.values():
            g.zero_()
        for p in self.plan.paths:
            get_path(self.param_views, p).grad = get_path(self.grad_views, p)


def apply_fused_flat(store: FlatStore, updater, iteration: int,
                     generator: Optional[torch.Generator] = None) -> None:
    """One fused update of ``store``'s buckets, in place, from the
    gradients the backward accumulated into ``store.grads`` (born flat, as
    the gauge ``precision/grads_flat_in_step`` = 1 records)."""
    OpProfiler.get().gauge("precision/grads_flat_in_step", 1)
    apply_flat_updater(updater, store.params, store.grads, store.state,
                       iteration, generator)
