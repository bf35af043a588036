"""ParallelWrapper: data-parallel training, one replica per worker.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (DL4J's
``ParallelWrapper``). The user's API is the same: ``ParallelWrapper.
Builder(model).workers(n)...build().fit(data)`` from one process. DL4J
clones the model per GPU and runs a trainer thread per device; the JAX
package runs one SPMD program over a mesh. Here each worker is a
**replica**: its own parameters, layer states and (dense layout) updater
state, on its device slot (``parallel/mesh.py``), held in its own flat
buckets (``nn/_fused.FlatStore``: the parameters are views of one bucket
per dtype, their ``.grad`` views of a gradient bucket, so each replica's
backward writes its gradients straight into the flat layout). The
replicas run in turn from one thread; launches are asynchronous, so
replicas on different cards overlap.

One step, in the JAX step's order (``_local_core``, ``wrapper.py:
149-388``):

1. each replica: forward and backward on its slice of the batch. Its loss
   divides the weighted data loss by ``max(real, 1) / n`` (``real``: the
   real rows of the whole batch), so the mean over replicas is the mean
   over the real rows. BatchNorm normalizes each replica's slice with its
   own statistics, as a ``shard_map`` shard does;
2. the exchange (``parallel/accumulator.py``, ``parallel/_collectives.py``):
   the dense mean all-reduce, the ZeRO-1 mean reduce-scatter, or the
   threshold-encoded exchange; the losses and the floating layer states
   (BatchNorm's running statistics) are averaged too;
3. the update, through ``ops/update.apply_flat_updater`` (the
   ``csrc/fused_update.cu`` kernel on the card for Sgd, Nesterovs, Adam and
   AdamW): on each replica's whole bucket (dense, with ``fused_update``),
   or on its 1/N slice against its 1/N of the state (ZeRO-1, always), the
   slices then gathered into every replica. Without ``fused_update`` the
   dense layout runs the per-leaf updater (``learning/precision.
   apply_updater``), as the JAX package does;
4. with telemetry: the aux (``optimize/telemetry``: dense ``layer_stats``,
   ZeRO-1 ``sharded_layer_stats``; non-finite counts from each replica's
   gradients before the exchange), the NaN guard over every replica, and
   every ``integrity_every`` steps the replica-consistency verdict
   (``common/integrity.py``) on the step's INPUT state, with the step
   discarded on every replica when it diverges (the corrupt replica keeps
   its own poisoned input, so the fault persists and is found again).

**Random draws.** Dropout and stochastic rounding draw from the network's
generator, one stream, in replica order. In the dense layout the
stochastic-rounding bits of a step are drawn once and shared (each replica
restarts from the same stream position), so every replica's updater state
stays bitwise identical. The JAX package folds the replica index into the
key it hands its updater, so with ``state_dtype="bfloat16"`` its
"replicated" state drifts apart across replicas (ROADMAP §C). Under ZeRO-1
each replica draws for its own slice, in turn.

**The model between fits.** During a fit the model's ``_params`` are
replica 0's views and its ``_states`` replica 0's states; a checkpoint's
snapshot calls the wrapper's sync hook to fetch the updater state (ZeRO-1:
the slices gathered) and the accumulator state in their host layouts. At
the end of a fit (and after :meth:`resize`) the model gets its own copies,
so a single-device ``fit`` afterwards cannot touch a replica; the next
wrapper fit keeps its replicas only if those copies are untouched.

**Fault injection and events.** The fit runs the shared input pipeline,
so the fit loop's fault sites and its ``pipeline/dispatch`` events apply
(``data/pipeline.run_epochs``); before each dispatch the
``integrity/fingerprint`` site (indexed by the iteration the dispatch
starts at) takes a ``bitflip`` spec and flips one bit of the named
replica's parameter copy (``common/integrity.apply_bitflip``), for the
consistency check to catch (JAX ``parallel/wrapper.py:1000``).

**The model axis** (``model_axis(m)``, m > 1; JAX ``wrapper.py:466-500``):
the mesh is ``(data, model)``, a replica is a data row, and each layer with
``table_sharding="model"`` (the ``EmbeddingLayer`` family) keeps its table
row-sharded over the row's model slots (``rep.tables``: one shard per
slot, on its device; ``ops/embeddings.sharded_rows_lookup`` in the
forward) with its updater state split alike; every other leaf is
replicated, held and computed once per row (its model slots would do the
same arithmetic). The table shards' gradients are averaged over the data
rows shard by shard, as the rest is by the dense exchange, and the
per-leaf updater runs on each shard. The vocabulary must divide by the
axis size. As in the JAX wrapper, ZeRO-1, the encoded exchange, the
integrity fingerprints, a ``ComputationGraph`` with a sharded table and
the online resize refuse a model axis. The model's view during a fit, its
copies after one and a checkpoint's snapshot hold the whole tables (the
shards joined in slot order).

Not carried over from the JAX package: the per-worker-count compile cache
(nothing compiles). Like the JAX step, this step applies neither gradient
normalization nor weight constraints (ROADMAP §C).
``training_mode("averaging")`` and ``averaging_frequency`` are accepted
and run the same synchronous program, as the JAX package documents.

**Across processes** (``Builder.process_group()``, a port extension that
``parallel/distributed.SharedTrainingMaster`` uses when a process group is
up): each rank holds its own replicas (``workers`` of them, one by
default) and feeds them from its own data source, and the global worker
count is ``world x workers``. The exchange goes through
``parallel/_collectives.ProcessGroupRoute``: the step's losses, floating
layer states and gradient buckets of every replica are all-gathered (one
buffer per dtype), and each rank sums them in global replica order, rank 0
first, so a two-rank step is bitwise the one-process two-replica step on
the same rows. ZeRO-1 reduces each rank's own slices from the gathered
buckets and all-gathers the updated slices; with bfloat16 state each rank
first steps its generator past the lower ranks' rounding bits (the fused
kernel's draws), so the bits match one process's too. Each replica's
forward (dropout) draws from a stream of its own, seeded from the network
generator's state at the step's start and the replica's global index (the
JAX wrapper folds the replica index into the step's key), so a rank draws
what one process draws for the same replica. Every rank must produce the
same number of batches per epoch. The step's first gather also carries
each rank's stop flag (``stop_event``, the supervisor's preemption
signal): ``group_stop`` turns true on every rank after the same step, so
the group stops at one boundary. The encoded exchange, the model axis,
the integrity fingerprints and the online resize refuse a process group
(a lost rank is the process supervisor's:
``parallel/distributed.supervise_processes`` relaunches the group). In one
process the same code runs over ``_collectives.LocalRoute``, a world of
one whose gather hands the tensors back.

``Builder.devices(list)`` (a port extension, ROADMAP §C) places the
replicas on the given devices, repeats allowed: four replicas on one card
are ``devices(["cuda:0"] * 4)``. Without it the pool is the visible cards
(the CPU device 8 times for a model on the CPU), and ``workers(n)`` beyond
the pool raises, as the JAX ``make_mesh`` does.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from ..common import faultinject, xprof
from ..common import integrity as _integ
from ..common.profiler import OpProfiler
from ..common.tree import (ShardedTensor, get_path, leaf_paths, set_path,
                           skeleton)
from ..data import pipeline as _pipe
from ..learning.precision import (apply_updater, note_state_bytes,
                                  state_dtype_of)
# a module reference: nn/_fused imports parallel/sharding, which runs
# this package's __init__
from ..nn import _fused
from ..ops.update import apply_flat_updater
from ..optimize import telemetry as _tel
from ..util.model_serializer import load_leaves, tree_leaves
from ._collectives import (LocalRoute, ProcessGroupRoute, _count,
                           _mean_into, all_reduce_mean, reduce_scatter_mean,
                           sum_to)
from .accumulator import DenseAllReduceAccumulator, GradientsAccumulator
from .mesh import (as_slots, device_pool, elastic_pool, make_mesh,
                   probe_device, shard_batch)
from .sharding import Zero1Plan, is_flat_state, unflatten_updater_state

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _fold(state: torch.Tensor, index: int) -> int:
    """A seed from a generator's state and an index, on the host (the
    JAX ``fold_in`` of a replica index into the step's key)."""
    h = hashlib.blake2b(state.numpy().tobytes(), digest_size=8)
    h.update(int(index).to_bytes(8, "little", signed=True))
    return int.from_bytes(h.digest(), "little") >> 1


def _to(tree, device, copy: bool = False):
    """A nested dict of tensors on ``device`` (non-tensor leaves kept)."""
    if isinstance(tree, dict):
        return {k: _to(v, device, copy) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if device is None:
            return t.clone() if copy else t
        return t.to(device, copy=copy)
    return tree


def _where(ok: torch.Tensor, new, old):
    """``torch.where(ok, new, old)`` over matching nested dicts."""
    if isinstance(new, dict):
        return {k: _where(ok, new[k], old[k]) for k in new}
    if isinstance(new, torch.Tensor):
        return torch.where(ok.to(new.device), new, old)
    return new


def _keep_(ok: torch.Tensor, new, old) -> None:
    """In place: the leaves of ``new`` become ``old``'s where not ``ok``."""
    if isinstance(new, dict):
        for k in new:
            _keep_(ok, new[k], old[k])
    elif isinstance(new, torch.Tensor):
        torch.where(ok.to(new.device), new, old, out=new)


def _clone(tree):
    return _to(tree, None, copy=True) if tree is not None else None


def _versions(tree) -> tuple:
    leaves = tree_leaves(tree) if isinstance(tree, dict) else []
    return tuple((id(t), t._version) for t in leaves)


class _Replica:
    """One replica's training state on its slot's device: ``store`` (the
    parameter and gradient buckets with their views), ``states`` (layer
    states) and ``upd`` (dense layout: the flat state buckets on the fused
    path, the dense tree on the per-leaf path; ZeRO-1: its slice of each
    flat state bucket). With a model axis: ``tables`` (layer key to its
    table's row shards, one per model slot of the row) and ``tupd`` (layer
    key to each shard's updater state ``{name: tensor}``); the store then
    holds every other leaf."""

    __slots__ = ("slot", "device", "store", "states", "upd", "tables",
                 "tupd")

    def __init__(self, slot, store, states, upd, tables=None,
                 tupd=None) -> None:
        self.slot = slot
        self.device = slot.device
        self.store = store
        self.states = states
        self.upd = upd
        self.tables = tables or {}
        self.tupd = tupd or {}


def _without(tree: dict, keys) -> dict:
    """A model tree without the ``W`` of each layer in ``keys``."""
    return {k: ({n: t for n, t in v.items() if n != "W"} if k in keys
                else v) for k, v in tree.items()}


class ParallelWrapper:
    class Builder:
        def __init__(self, model):
            self._model = model
            self._workers: Optional[int] = None
            self._mode = "shared_gradients"
            self._accumulator: Optional[GradientsAccumulator] = None
            self._prefetch = 2
            self._averaging_frequency = 1
            self._model_axis = 1
            self._devices = None
            self._process_group = False

        def workers(self, n: int) -> "ParallelWrapper.Builder":
            self._workers = n
            return self

        def model_axis(self, m: int) -> "ParallelWrapper.Builder":
            """Devices along the mesh's ``model`` axis (workers must divide
            by it). Layers with ``table_sharding`` (the EmbeddingLayer
            family) shard their tables over this axis."""
            self._model_axis = int(m)
            return self

        def training_mode(self, mode: str) -> "ParallelWrapper.Builder":
            mode = mode.lower()
            if mode not in ("shared_gradients", "averaging"):
                raise ValueError(f"unknown training mode {mode!r}")
            self._mode = mode
            return self

        trainingMode = training_mode

        def gradients_accumulator(self, acc: GradientsAccumulator
                                  ) -> "ParallelWrapper.Builder":
            self._accumulator = acc
            return self

        def averaging_frequency(self, n: int) -> "ParallelWrapper.Builder":
            self._averaging_frequency = n   # accepted; see the module doc
            return self

        def prefetch_buffer(self, n: int) -> "ParallelWrapper.Builder":
            self._prefetch = n
            return self

        def devices(self, devices) -> "ParallelWrapper.Builder":
            """The device pool, in order, repeats allowed (a port
            extension: several replicas on one card)."""
            self._devices = list(devices)
            return self

        def process_group(self) -> "ParallelWrapper.Builder":
            """Join the default ``torch.distributed`` process group:
            ``workers`` becomes the replica count of this rank, one unless
            set (a port extension; see the module docstring)."""
            self._process_group = True
            return self

        def build(self) -> "ParallelWrapper":
            return ParallelWrapper(self._model, self._workers, self._mode,
                                   self._accumulator
                                   or DenseAllReduceAccumulator(),
                                   model_axis=self._model_axis,
                                   prefetch=self._prefetch,
                                   devices=self._devices,
                                   process_group=self._process_group)

    def __init__(self, model, workers: Optional[int], mode: str,
                 accumulator: GradientsAccumulator, model_axis: int = 1,
                 prefetch: int = 2, devices=None,
                 process_group: bool = False):
        self.model = model
        self._pool = (as_slots(devices) if devices is not None
                      else device_pool(model.device))
        if process_group and workers is None:
            workers = 1
        n = workers or len(self._pool)
        if n % model_axis:
            raise ValueError(
                f"workers={n} not divisible by model_axis={model_axis}")
        self.mesh = make_mesh(data=n // model_axis, model=model_axis,
                              devices=self._pool[:n])
        self.workers_count = n // model_axis
        self.model_axis = model_axis
        self.mode = mode
        self.accumulator = accumulator
        self.prefetch = prefetch
        self._listeners: List[Any] = []
        self._telemetry: Optional[_tel.TelemetryConfig] = None
        self._reps: Optional[List[_Replica]] = None
        self._plan: Optional[Zero1Plan] = None
        self._fused = False
        self._acc: Optional[dict] = None          # placed accumulator state
        self._released: Optional[tuple] = None    # what the model was given
        self._lost_devices: set = set()
        self._coll_bytes: Dict[str, int] = {}
        self._drained_encoded = (0.0, 0.0, 0)
        self._seg_ids: Dict[tuple, torch.Tensor] = {}
        self._gens: Dict[str, torch.Generator] = {}
        self._tables: Dict[str, str] = {}     # table layer key -> axis
        self._live_params = None
        #: where the replicas' tensors are exchanged: this process alone,
        #: or the process group
        self._route = LocalRoute(self.workers_count)
        #: across a process group: the stop signal each rank contributes
        #: to every step's first gather (set by the supervisor), and
        #: whether any rank's was set (the same on every rank)
        self.stop_event: Optional[threading.Event] = None
        self.group_stop = False
        if process_group:
            if model_axis != 1:
                raise NotImplementedError(
                    "a process group spans the data axis only; model_axis "
                    "> 1 does not compose with it")
            if accumulator.stateful:
                raise NotImplementedError(
                    "the encoded exchange keeps per-replica residuals in "
                    "one process; it does not run across a process group")
            self._route = ProcessGroupRoute(local=self.workers_count)

    @property
    def global_workers(self) -> int:
        """Replicas across every rank (``workers_count`` in one process)."""
        return self._route.n_global

    @property
    def spans_processes(self) -> bool:
        """Whether the replicas' exchange crosses processes."""
        return self._route.world > 1

    def set_listeners(self, *ls) -> None:
        self._listeners = list(ls)
        for lst in self._listeners:
            bind = getattr(lst, "bind_group", None)
            if callable(bind):
                bind(self._listeners)
        self._telemetry = _tel.config_for(self._listeners)

    setListeners = set_listeners

    # --- replicas ------------------------------------------------------------
    def replica_params(self, r: int):
        """Replica ``r``'s parameter tree (views of its bucket)."""
        self._ensure_parallel_state()
        return self._reps[r].store.param_views

    def replica_states(self, r: int):
        self._ensure_parallel_state()
        return self._reps[r].states

    def replica_updater_state(self, r: int):
        """Replica ``r``'s updater state: a dense tree (dense layout) or
        its slices of the flat buckets (ZeRO-1)."""
        self._ensure_parallel_state()
        rep = self._reps[r]
        if self.accumulator.zero1 or not self._fused:
            return rep.upd
        return rep.store.state_views

    def _live(self) -> bool:
        """Whether the model's fields are the replicas' live state (inside
        a fit)."""
        return (self._reps is not None
                and self.model._params is self._live_params)

    def _current(self) -> bool:
        if self._reps is None or len(self._reps) != self.workers_count:
            return False
        if self._live():
            return True
        m = self.model
        return self._released == (
            id(m._params), _versions(m._params), id(m._states),
            _versions(m._states), id(m._updater_state),
            _versions(m._updater_state), id(getattr(m, "_acc_state", None)))

    def _ensure_parallel_state(self) -> None:
        """Build the replicas from the model's state unless they are
        current: parameters and layer states copied to every replica,
        updater state made (fresh), converted (dense <-> ZeRO-1) or
        re-padded (a flat state saved under another replica count), the
        accumulator state placed, and the ledgers' byte counts set."""
        model = self.model
        acc = self.accumulator
        updater = model.conf.global_conf.updater
        self._tables = self._table_layers()
        if acc.zero1 and (self.model_axis != 1 or self._tables):
            raise NotImplementedError(
                "ZeRO-1 sharding assumes replicated params: it cannot "
                "compose with model_axis/table_sharding yet")
        if acc.stateful and self.model_axis != 1:
            raise NotImplementedError(
                "the encoded exchange keeps per-replica residuals of "
                "replicated params: it cannot compose with model_axis/"
                "table_sharding yet")
        if acc.zero1 and not getattr(updater, "elementwise", False):
            raise NotImplementedError(
                f"{type(updater).__name__} does not declare "
                "elementwise=True; ZeRO-1 weight-update sharding "
                "(ReduceScatterAccumulator) requires an elementwise updater "
                "— use the dense accumulator instead")
        if self._current():
            return
        prof = OpProfiler.get()
        slots = list(self.mesh.devices[:, 0])
        n = len(slots)
        n_all, lo = self.global_workers, self._route.lo
        params, states = model._params, model._states
        upd = model._updater_state
        tabs = self._tables
        full_params = params
        if tabs:
            if is_flat_state(upd):
                upd = unflatten_updater_state(upd, params)
            if upd is None:
                upd = updater.init(params)
            full_upd = upd
            params = _without(params, tabs)
            upd = {k: _without(v, tabs) for k, v in upd.items()} \
                if isinstance(upd, dict) else upd
        if acc.zero1:
            plan = Zero1Plan(params, n_all, shard_align=4)
            if upd is None:
                full = updater.init(plan.flatten(_to(params, None)))
            else:
                full = plan.reshard_state(upd)
        else:
            plan = Zero1Plan(params, 1)
            if is_flat_state(upd):
                upd = unflatten_updater_state(upd, params)
            if upd is None:
                upd = updater.init(params)
        self._plan = plan
        self._fused = not acc.zero1 and not tabs and _fused.fused_flat_plan(
            model.conf, params) is not None
        reps = []
        for r, slot in enumerate(slots):
            dev = slot.device
            p_r = _to(params, dev)
            if acc.zero1:
                store = _fused.FlatStore(plan, p_r, None)
                g = lo + r
                u = {s: {b.key: d[b.key][g * b.shard:(g + 1) * b.shard]
                         .to(dev, copy=True) for b in plan.buckets}
                     for s, d in full.items()}
            elif self._fused:
                store = _fused.FlatStore(plan, p_r, _to(upd, dev))
                u = store.state
            else:
                store = _fused.FlatStore(plan, p_r, None)
                u = _to(upd, dev, copy=True)
            tables, tupd = {}, {}
            row = [sl.device for sl in self.mesh.devices[r, :]]
            for key in tabs:
                tables[key] = ShardedTensor.split(
                    full_params[key]["W"].detach(), row).shards
                for t in tables[key]:
                    t.requires_grad_(True)
                per_slot = {name: ShardedTensor.split(
                    v[key]["W"].detach(), row).shards
                    for name, v in (full_upd or {}).items()}
                tupd[key] = [{name: sh[j] for name, sh in per_slot.items()}
                             for j in range(len(row))]
            reps.append(_Replica(slot, store, _to(states, dev, copy=True), u,
                                 tables, tupd))
        self._reps = reps
        self._seg_ids = {}
        if acc.zero1:
            total = sum(t.numel() * t.element_size() for rep in reps
                        for t in tree_leaves(rep.upd))
            prof.gauge("zero1/updater_state_bytes_total", int(total))
            prof.gauge("zero1/updater_state_bytes_per_replica",
                       int(total // n))
            note_state_bytes({str(r): rep.upd for r, rep in enumerate(reps)})
        else:
            note_state_bytes(reps[0].upd)
        self._acc = self._place_acc() if acc.stateful else None
        model._acc_blob = None
        model._live_workers = n_all
        prof.gauge("elastic/workers", n_all)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(params))
        if acc.zero1:
            flat = plan.bucket_bytes()
            self._coll_bytes = {"reduce_scatter_bytes": flat,
                                "all_gather_bytes": flat}
        else:
            self._coll_bytes = {"psum_bytes": param_bytes}
        self._coll_bytes["dense_grad_bytes"] = param_bytes
        model._parallel = self
        model._parallel_sync = self._sync_model
        self._publish_live()

    # --- the model's view of the replicas ------------------------------------
    def _dense_upd(self, rep: _Replica):
        return rep.store.state_views if self._fused else rep.upd

    def _gathered_upd(self, device=None):
        """ZeRO-1: the full flat state (this plan's padding) from every
        replica's slices, on ``device`` (default replica 0's); across a
        process group, every rank's slices (a collective)."""
        dev = self._reps[0].device if device is None else device
        names = [(s, k) for s in self._reps[0].upd
                 for k in self._reps[0].upd[s]]
        per = self._route.gather([[rep.upd[s][k] for s, k in names]
                                  for rep in self._reps])
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, (s, k) in enumerate(names):
            out.setdefault(s, {})[k] = torch.cat([p[i].to(dev)
                                                  for p in per])
        return out

    # --- the row-sharded tables --------------------------------------------
    def _table_layers(self) -> Dict[str, str]:
        """Layer key to ``table_sharding`` axis of every sharded-table
        layer that the model axis splits, validated as the JAX wrapper's
        ``_param_specs`` validates them."""
        model = self.model
        if not hasattr(model.conf, "layers"):          # ComputationGraph
            for node in getattr(model.conf, "nodes", {}).values():
                if getattr(getattr(node, "layer", None), "table_sharding",
                           None):
                    raise NotImplementedError(
                        "table_sharding through ParallelWrapper is wired "
                        "for MultiLayerNetwork; ComputationGraph tables "
                        "are not routed yet")
            return {}
        out = {}
        for key, layer in zip(model._keys, model.conf.layers):
            ax = getattr(layer, "table_sharding", None)
            if not ax:
                continue
            if ax not in self.mesh.shape:
                raise ValueError(f"table_sharding={ax!r} is not a mesh "
                                 f"axis of {tuple(self.mesh.shape)}")
            if ax != "model":
                raise ValueError(f"table_sharding={ax!r}: tables shard "
                                 "over the model axis only")
            n_sh = self.mesh.shape[ax]
            if layer.n_in is None or layer.n_in % n_sh:
                raise ValueError(
                    f"embedding vocab {layer.n_in} must be divisible by "
                    f"the {ax!r} axis size {n_sh} (pad the vocab)")
            if n_sh > 1:
                out[key] = ax
        return out

    def _replica_params(self, rep: _Replica):
        """The tree a replica's forward takes: its store's views, with each
        sharded table's ``W`` its list of row shards."""
        views = rep.store.param_views
        if not rep.tables:
            return views
        out = dict(views)
        for key, shards in rep.tables.items():
            out[key] = dict(views[key], W=ShardedTensor(shards))
        return out

    def _full_tree(self, tree, rep: _Replica, what: str):
        """``tree`` (the replica's store layout) with each table's whole
        ``W`` joined in slot order: ``what`` "params" (detached) or an
        updater-state name."""
        if not rep.tables:
            return tree
        out = dict(tree)
        for key, shards in rep.tables.items():
            parts = ([t.detach() for t in shards] if what == "params"
                     else [st[what] for st in rep.tupd[key]])
            out[key] = dict(tree[key],
                            W=ShardedTensor(parts).gather(rep.device))
        return out

    def _publish_live(self) -> None:
        model = self.model
        rep = self._reps[0]
        model._params = self._full_tree(rep.store.param_views, rep,
                                        "params")
        self._live_params = model._params
        model._states = rep.states
        if not self.accumulator.zero1:
            upd = self._dense_upd(rep)
            model._updater_state = (
                {n: self._full_tree(v, rep, n) for n, v in upd.items()}
                if rep.tables and isinstance(upd, dict) else upd)
        model._flat = None
        model._cast_cache = None

    def _sync_model(self) -> None:
        """The checkpoint snapshot's hook: the updater state (ZeRO-1: the
        slices gathered) and the accumulator state (host layout) onto the
        model; a no-op unless the model is this wrapper's live view."""
        if not self._live():
            return
        if self.accumulator.zero1:
            self.model._updater_state = self._gathered_upd()
        if self.accumulator.stateful:
            self.model._acc_state = self._host_acc()

    def _release(self, collective: bool = True) -> None:
        """Hand the model copies of replica 0's state (ZeRO-1: the gathered
        flat updater state), so nothing outside a fit aliases a replica,
        and remember them to know whether the replicas are still
        current. ``collective=False`` (a process-group fit unwinding from
        an error, its peers maybe gone): no cross-rank gather, and a
        ZeRO-1 model is left without updater state."""
        if self._reps is None:
            return
        if not collective and self.spans_processes \
                and self.accumulator.zero1:
            model = self.model
            model._params = self._full_tree(self._plan.unflatten(
                {k: v.detach().clone()
                 for k, v in self._reps[0].store.params.items()}),
                self._reps[0], "params")
            model._states = _clone(self._reps[0].states)
            model._updater_state = None
            model._flat = None
            model._cast_cache = None
            self._reps = None
            return
        model = self.model
        rep = self._reps[0]
        with torch.no_grad():
            buckets = {k: v.detach().clone()
                       for k, v in rep.store.params.items()}
            model._params = self._full_tree(
                self._plan.unflatten(buckets), rep, "params")
            model._states = _clone(rep.states)
            if self.accumulator.zero1:
                model._updater_state = self._gathered_upd()
            else:
                upd = _clone(self._dense_upd(rep))
                model._updater_state = (
                    {n: self._full_tree(v, rep, n) for n, v in upd.items()}
                    if rep.tables and isinstance(upd, dict) else upd)
            model._acc_state = (self._host_acc()
                                if self.accumulator.stateful else None)
        model._flat = None
        model._cast_cache = None
        self._released = (
            id(model._params), _versions(model._params), id(model._states),
            _versions(model._states), id(model._updater_state),
            _versions(model._updater_state), id(model._acc_state))

    # --- accumulator state layouts -------------------------------------------
    def _place_acc(self) -> dict:
        """The model's accumulator state (host layout, a checkpoint's
        blob, or fresh) as the placed layout."""
        model, acc = self.model, self.accumulator
        params = self._reps[0].store.param_views
        n = len(self._reps)
        host = getattr(model, "_acc_state", None) or None
        blob = getattr(model, "_acc_blob", None)
        if host is None and blob is not None:
            host = self._load_acc_blob(blob, acc)
        if host is None:
            host = acc.init_state(params, n_shards=n)
        else:
            host = self._reshape_acc_state(host, acc)
        dev0 = self._reps[0].device
        res = host["residual"]
        placed = {k: torch.as_tensor(v).to(dev0, copy=True)
                  for k, v in host.items() if k != "residual"}
        placed["residual"] = []
        for r, rep in enumerate(self._reps):
            tree = skeleton(params)
            for p in leaf_paths(params):
                set_path(tree, p, torch.as_tensor(get_path(res, p))[r])
            placed["residual"].append(_to(self._plan.flatten(tree),
                                          rep.device, copy=True))
        return placed

    def _host_acc(self) -> dict:
        """The placed accumulator state in the host layout (CPU tensors,
        residual leaves ``[n, *shape]``)."""
        st = self._acc
        trees = [self._plan.unflatten(r) for r in st["residual"]]
        params = self._reps[0].store.param_views
        res = skeleton(params)
        for p in leaf_paths(params):
            set_path(res, p, torch.stack([get_path(t, p).detach().cpu()
                                          for t in trees]))
        out = {k: v.detach().cpu().clone() for k, v in st.items()
               if k != "residual"}
        out["residual"] = res
        return out

    def _load_acc_blob(self, blob: bytes, acc):
        """A checkpoint's accumulator entry into this accumulator's host
        template (None, warned, when it does not fit)."""
        template = acc.init_state(self.model._params,
                                  n_shards=self.workers_count)
        paths = leaf_paths(template)
        try:
            leaves = load_leaves(blob, "accumulator state", len(paths))
        except Exception:
            logger.warning("checkpointed accumulator state does not match "
                           "this accumulator; starting it fresh")
            return None
        out = skeleton(template)
        for p, t in zip(paths, leaves):
            set_path(out, p, t)
        return out

    def _reshape_acc_state(self, st, acc):
        """Residuals saved for another replica count are reset to zero
        (warned); the scalars carry over."""
        res = st.get("residual") if isinstance(st, dict) else None
        if res is None:
            return st
        lead = {int(torch.as_tensor(get_path(res, p)).shape[0])
                for p in leaf_paths(res)}
        if lead == {self.workers_count}:
            return st
        logger.warning(
            "encoded-accumulator residuals were saved for %s workers; "
            "resetting them for %d (threshold and ledger carry over)",
            sorted(lead), self.workers_count)
        st = dict(st)
        params = self.model._params
        st["residual"] = acc.init_state(params,
                                        n_shards=self.workers_count
                                        )["residual"]
        return st

    # --- random draws --------------------------------------------------------
    @contextmanager
    def _draws(self, device, restart=None):
        """The network's generator on ``device``, from ``restart`` (a saved
        state) or from where it stands; the stream continues from wherever
        the body leaves it. Dropout inside sees it as the network's
        generator."""
        model = self.model
        gen = model.generator()
        if gen.device == device:
            if restart is not None:
                gen.set_state(restart)
            yield gen
            return
        g = self._gens.get(str(device))
        if g is None:
            g = torch.Generator(device=device)
            self._gens[str(device)] = g
        g.set_state(restart if restart is not None else gen.get_state())
        model._generator = g
        try:
            yield g
        finally:
            model._generator = gen
            gen.set_state(g.get_state())

    @contextmanager
    def _replica_draws(self, device, step_state: torch.Tensor, g: int,
                       drew: list):
        """Global replica ``g``'s forward on its own stream: a generator on
        ``device`` seeded from ``step_state`` (the network generator's
        state at the step's start) and ``g``, standing in for the
        network's generator. Appends to ``drew`` whether the forward drew
        from it."""
        model = self.model
        key = "fork:" + str(device)
        fork = self._gens.get(key)
        if fork is None:
            fork = self._gens[key] = torch.Generator(device=device)
        fork.manual_seed(_fold(step_state, g))
        seeded = fork.get_state()
        gen, model._generator = model._generator, fork
        try:
            yield
        finally:
            model._generator = gen
        drew.append(not torch.equal(fork.get_state(), seeded))

    # --- the step ------------------------------------------------------------
    def _replica_loss(self, rep: _Replica, batch, denom):
        model = self.model
        p = self._replica_params(rep)
        if hasattr(model.conf, "network_inputs"):
            inputs, labels, masks, w = batch
            return model._loss(p, rep.states, inputs, labels, masks, True, w,
                               w_denom=denom)
        x, y, mask, fmask, w = batch
        return model._loss(p, rep.states, x, y, mask, True, fmask, w,
                           w_denom=denom)

    def _segment_ids(self, key: str, r: int, shard: int, device):
        k = (key, r, str(device))
        ids = self._seg_ids.get(k)
        if ids is None:
            ids = self._plan.shard_segment_ids(key, r, shard, device)
            self._seg_ids[k] = ids
        return ids

    def _train_step(self, batch, it: int):
        """One step on ``batch`` (one placed batch per replica) at
        iteration ``it``; returns ``(loss, aux)``."""
        model, acc, plan, reps = self.model, self.accumulator, self._plan, \
            self._reps
        n = len(reps)
        route = self._route
        n_all, lo = self.global_workers, route.lo
        updater = model.conf.global_conf.updater
        zero1 = acc.zero1
        tele = self._telemetry
        stats = tele is not None and tele.stats
        guard = tele is not None and tele.nan_guard
        integ = tele.integrity_every if tele is not None else 0
        do_check = bool(integ) and it % integ == 0
        dev0 = reps[0].device

        # the global divisor: real rows of the whole batch over n; beside
        # it, across a process group, each rank's stop flag
        ev = self.stop_event
        got = route.gather([[r] if ev is None else [r, torch.full(
            (), float(ev.is_set()), dtype=r.dtype, device=r.device)]
            for r in (b[-1].sum() for b in batch)])
        reals = [v[0] for v in got]
        if ev is not None and not self.group_stop:
            self.group_stop = bool(sum_to([v[1] for v in got], dev0) > 0)
        real = sum_to(reals, dev0)
        denom = torch.clamp_min(real, 1.0) / _count(n_all, real.dtype, dev0)

        # the consistency fingerprints of the step's input state
        if do_check:
            p_fps = [_integ.fingerprint_flats(plan, rep.store.params)
                     for rep in reps]
            chk = p_fps if zero1 else [
                _integ.combine_fp(f, _integ.fingerprint_tree(
                    self._dense_upd(rep)).to(f.device))
                for f, rep in zip(p_fps, reps)]
        keep_old = guard or do_check
        with torch.no_grad():
            old_p = ([{k: v.clone() for k, v in rep.store.params.items()}
                      for rep in reps] if keep_old else None)
            old_u = ([_clone(rep.upd) for rep in reps] if keep_old else None)
            if stats and not zero1 and old_p is None:
                old_p = [{k: v.clone() for k, v in
                          reps[0].store.params.items()}]
            # the table shards and their updater state (a model axis)
            old_t = ([{k: [t.detach().clone() for t in sh]
                       for k, sh in rep.tables.items()} for rep in reps]
                     if self._tables and (keep_old or stats) else None)
            old_tu = ([{k: [dict(st) for st in sts]
                        for k, sts in rep.tupd.items()} for rep in reps]
                      if self._tables and keep_old else None)
        old_states = [rep.states for rep in reps]

        # 1. forward and backward, replica by replica, each on its own
        # stream; the network's generator moves on only if they drew
        losses, new_states, raw_nf, drew = [], [], [], []
        gen = model.generator()
        step_state = gen.get_state()
        for j, (rep, b) in enumerate(zip(reps, batch)):
            rep.store.bind_grads()
            for sh in rep.tables.values():
                for t in sh:
                    t.grad = None
            with self._replica_draws(rep.device, step_state, lo + j, drew):
                with torch.enable_grad():
                    loss, st = self._replica_loss(rep, b,
                                                  denom.to(rep.device))
                    loss.backward()
            losses.append(loss.detach())
            new_states.append(st)
            if stats:
                raw_nf.append(_tel.nonfinite_counts(rep.store.grad_views))
        if any(drew):
            gen.manual_seed(_fold(step_state, -1))

        # 2. the exchange; the losses and floating layer states averaged
        with torch.no_grad():
            raw = [rep.store.grads for rep in reps]
            s_paths = [p for p in leaf_paths(new_states[0])
                       if get_path(new_states[0], p).is_floating_point()]
            # every replica's losses, states and gradients, in global
            # replica order (this rank's own as they are)
            gkeys = list(raw[0])
            per = route.gather([
                [losses[j]]
                + [get_path(new_states[j], p).detach() for p in s_paths]
                + [raw[j][k] for k in gkeys]
                + ([raw_nf[j]] if stats else [])
                for j in range(n)])
            ns = len(s_paths)
            losses = [a[0] for a in per]
            s_vals = {p: [a[1 + i] for a in per]
                      for i, p in enumerate(s_paths)}
            raw_all = [{k: a[1 + ns + i] for i, k in enumerate(gkeys)}
                       for a in per]
            if stats:
                raw_nf = [a[-1] for a in per]
            loss = sum_to(losses, dev0) / _count(n_all, losses[0].dtype,
                                                 dev0)
            for p in s_paths:
                vals = all_reduce_mean(s_vals[p])[lo:lo + n]
                for st, v in zip(new_states, vals):
                    set_path(st, p, v)
            for rep, st in zip(reps, new_states):
                rep.states = st
            density = None
            if acc.stateful:
                red, self._acc, density = acc.exchange(raw, self._acc)
            elif zero1:
                sh = {b.key: reduce_scatter_mean(
                    [g[b.key] for g in raw_all], b.shard,
                    only=range(lo, lo + n),
                    devices=[rep.device for rep in reps])
                      for b in plan.buckets}
                red = [{k: v[r] for k, v in sh.items()} for r in range(n)]
            else:
                red = acc.exchange(raw_all, None)[0][lo:lo + n]
            # the table shards' gradients: the mean over the data rows,
            # shard by shard (tred[key][j][r]: replica r's copy)
            tred = {k: [all_reduce_mean([rep.tables[k][j].grad
                                         for rep in reps])
                        for j in range(len(reps[0].tables[k]))]
                    for k in self._tables}

            # 3. the update
            if zero1:
                old_sh = ([plan.shard_slice(old_p[r], lo + r)
                           for r in range(n)]
                          if old_p is not None and len(old_p) == n else
                          [{k: v.clone() for k, v in plan.shard_slice(
                              rep.store.params, lo + r).items()}
                           for r, rep in enumerate(reps)] if stats else None)
                self._skip_rounding_bits(lo, reps[0].device)
                for r, rep in enumerate(reps):
                    with self._draws(rep.device) as g:
                        apply_flat_updater(
                            updater,
                            plan.shard_slice(rep.store.params, lo + r),
                            red[r], rep.upd, it, g)
                self._skip_rounding_bits(n_all - lo - n, reps[-1].device)
                self._gather_slices()
            else:
                start = model.generator().get_state()
                for r, rep in enumerate(reps):
                    with self._draws(rep.device, restart=start) as g:
                        if self._fused:
                            apply_flat_updater(updater, rep.store.params,
                                               red[r], rep.upd, it, g)
                        else:
                            views = rep.store.param_views
                            new_p, rep.upd = apply_updater(
                                updater, plan.unflatten(red[r]), rep.upd,
                                views, it, g)
                            for p in plan.paths:
                                get_path(views, p).copy_(
                                    get_path(new_p, p))
                        self._update_tables(updater, rep, r, tred, it, g)

            # 4. telemetry, the NaN guard, the consistency verdict
            aux = None
            if tele is not None:
                if not stats:
                    aux = {"loss": loss}
                elif zero1:
                    parts = [(self._segment_ids(b.key, lo + r, b.shard,
                                                rep.device),
                              red[r][b.key],
                              plan.shard_slice(rep.store.params,
                                               lo + r)[b.key],
                              old_sh[r][b.key])
                             for r, rep in enumerate(reps)
                             for b in plan.buckets]
                    aux = _tel.sharded_layer_stats(
                        loss, parts, plan.n_layers,
                        nonfinite=sum_to(raw_nf, dev0))
                elif self._tables:
                    # the whole tables in the trees; non-finite counts
                    # from the exchanged gradients
                    r0 = reps[0]
                    old_full = dict(plan.unflatten(old_p[0]))
                    grads_full = dict(plan.unflatten(red[0]))
                    for k in self._tables:
                        old_full[k] = dict(old_full[k], W=torch.cat(
                            [t.to(dev0) for t in old_t[0][k]]))
                        grads_full[k] = dict(grads_full[k], W=torch.cat(
                            [g_[0].to(dev0) for g_ in tred[k]]))
                    aux = _tel.layer_stats(
                        old_full, self._full_tree(r0.store.param_views, r0,
                                                  "params"),
                        grads_full, loss)
                else:
                    aux = _tel.layer_stats(
                        plan.unflatten(old_p[0]), reps[0].store.param_views,
                        plan.unflatten(red[0]), loss,
                        nonfinite=sum_to(raw_nf, dev0))
                if density is not None:
                    aux["exchange_density"] = density
                if guard:
                    ok = aux["nonfinite_total"] == 0
                    aux["skipped"] = (~ok).to(torch.int32)
                    self._keep_pre_step(ok, old_p, old_u, old_states,
                                        old_t, old_tu)
                if integ:
                    if do_check:
                        mism = ([self._transport_mismatch(j)
                                 for j in range(n)] if zero1 else None)
                        checked, diverged, replica = \
                            _integ.replica_verdict(chk, mism, True)
                        fp = p_fps[0].to(dev0)
                        self._keep_pre_step(diverged == 0, old_p, old_u,
                                            old_states)
                    else:
                        z = torch.zeros((), dtype=torch.int32, device=dev0)
                        checked, diverged = z, z
                        replica = torch.full((), -1, dtype=torch.int32,
                                             device=dev0)
                        fp = torch.zeros((), dtype=torch.int64, device=dev0)
                    aux["integrity_checked"] = checked
                    aux["integrity_diverged"] = diverged
                    aux["integrity_replica"] = replica
                    aux["integrity_fp"] = fp
        self._publish_live()
        return loss, aux

    def _skip_rounding_bits(self, replicas: int, device) -> None:
        """ZeRO-1: step the network's generator past ``replicas`` slices'
        stochastic-rounding bits, as the fused kernel's updaters draw them
        (one int32 per element of each bucket's slice, buckets in key
        order), so each rank of a process group draws its own slices' bits
        where one process would."""
        from ..learning.precision import random_bits
        from ..ops.update import SLOTS, _KINDS

        updater = self.model.conf.global_conf.updater
        kind = _KINDS.get(type(updater))
        if replicas <= 0 or kind is None \
                or not SLOTS[kind] or not state_dtype_of(updater):
            return
        with self._draws(device) as g:
            for _ in range(replicas):
                for b in sorted(self._plan.buckets, key=lambda b: b.key):
                    random_bits(b.shard, g, device)

    def _gather_slices(self) -> None:
        """ZeRO-1: every replica's updated slice (across a process group,
        every rank's) into every local replica's buckets."""
        plan, reps, route = self._plan, self._reps, self._route
        lo = route.lo
        keys = [b.key for b in plan.buckets]
        own = [[plan.shard_slice(rep.store.params, lo + j)[k] for k in keys]
               for j, rep in enumerate(reps)]
        per = route.gather(own)
        for j, rep in enumerate(reps):
            for g, slices in enumerate(per):
                if g == lo + j:
                    continue
                dst = plan.shard_slice(rep.store.params, g)
                for k, src in zip(keys, slices):
                    dst[k].copy_(src, non_blocking=True)

    def _transport_mismatch(self, j: int) -> torch.Tensor:
        """Whether replica ``j``'s copy of any other replica's slice
        differs in its bits from the owner's (a corrupt receive flags the
        receiving replica)."""
        reps, plan = self._reps, self._plan
        out = torch.zeros((), dtype=torch.bool, device=reps[j].device)
        for r, rep in enumerate(reps):
            if r == j:
                continue
            mine = plan.shard_slice(reps[j].store.params, r)
            theirs = plan.shard_slice(rep.store.params, r)
            for k in mine:
                out = out | _integ.bitwise_neq(
                    mine[k], theirs[k].to(reps[j].device))
        return out.to(torch.int32)

    def _update_tables(self, updater, rep: _Replica, r: int, tred, it: int,
                       gen) -> None:
        """The per-leaf updater on each of replica ``r``'s table shards,
        with the data rows' mean gradient."""
        for key, shards in rep.tables.items():
            for j, t in enumerate(shards):
                new_p, st = apply_updater(
                    updater, {"W": tred[key][j][r]},
                    {n: {"W": v} for n, v in rep.tupd[key][j].items()},
                    {"W": t.detach()}, it, gen)
                t.detach().copy_(new_p["W"])
                rep.tupd[key][j] = {n: v["W"] for n, v in st.items()}

    def _keep_pre_step(self, ok, old_p, old_u, old_states, old_t=None,
                       old_tu=None) -> None:
        """Every replica back to its pre-step state where ``ok`` is false
        (a device boolean: no host synchronisation)."""
        for r, rep in enumerate(self._reps):
            for k, sh in rep.tables.items():
                for j, t in enumerate(sh):
                    td = t.detach()
                    torch.where(ok.to(td.device), td, old_t[r][k][j],
                                out=td)
                    rep.tupd[k][j] = {
                        n: torch.where(ok.to(v.device), v,
                                       old_tu[r][k][j][n])
                        for n, v in rep.tupd[k][j].items()}
            for k, v in rep.store.params.items():
                torch.where(ok.to(v.device), v, old_p[r][k], out=v)
            if isinstance(rep.upd, dict) and rep.upd:
                if self._fused or self.accumulator.zero1:
                    _keep_(ok, rep.upd, old_u[r])
                else:
                    rep.upd = _where(ok, rep.upd, old_u[r])
            rep.states = _where(ok, rep.states, old_states[r])

    # --- fit -----------------------------------------------------------------
    def _bind_batch(self, ds, w):
        return self.model._bind_batch(ds, w)

    def _place_batch(self, b):
        """One bound batch as one placed batch per replica."""
        parts = shard_batch(self.mesh, *b)
        return [tuple(p[r] for p in parts)
                for r in range(self.workers_count)]

    def _count_collectives(self, prof, k: int = 1) -> None:
        prof.count("collective/steps", k)
        for name, nbytes in self._coll_bytes.items():
            prof.count(f"collective/{name}", nbytes * k)

    def _drain_encoded_ledger(self, prof) -> None:
        """Once per epoch: the encoded exchange's counters as deltas."""
        st = self._acc
        if not (self.accumulator.stateful and st):
            return
        nnz, elems, steps = (float(st["nnz_sum"]), float(st["elems_sum"]),
                             int(st["steps"]))
        p_nnz, p_elems, p_steps = self._drained_encoded
        if steps > p_steps:
            prof.count("collective/encoded_elems_sent", int(nnz - p_nnz))
            prof.count("collective/encoded_elems_total",
                       int(elems - p_elems))
            prof.count("collective/encoded_steps", steps - p_steps)
        self._drained_encoded = (nnz, elems, steps)

    def _inject_faults(self) -> None:
        """The ``integrity/fingerprint`` site before a dispatch: a
        ``bitflip`` spec corrupts one replica's parameter copy between
        steps."""
        for spec in faultinject.fault_point("integrity/fingerprint",
                                            int(self.model._iteration)):
            if spec.get("kind") == "bitflip":
                _integ.apply_bitflip(self, self.mesh, spec)

    def _dispatch(self, group) -> None:
        model = self.model
        prof = OpProfiler.get()
        self._inject_faults()
        losses, auxes = [], []
        # the data-parallel step (dense and ZeRO-1) under the census
        step = xprof.censused(self, "pw/fit_step", self._train_step)
        with prof.time_section("pipeline/dispatch"):
            for j, b in enumerate(group):
                loss, aux = step(b, model._iteration + j)
                losses.append(loss)
                auxes.append(aux)
        self._count_collectives(prof, len(group))
        _pipe.note_steps(model, self._listeners, losses,
                         auxes if self._telemetry is not None else None)

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            *, pad_partial: Optional[bool] = None,
            drop_remainder: bool = False, prefetch: Optional[int] = None,
            steps_per_dispatch: int = 1, host_prefetch: int = 0,
            resume_from: Optional[str] = None,
            resume_cursor: Optional[tuple] = None) -> None:
        """Data-parallel training on the shared input pipeline
        (``data/pipeline.run_epochs``): batches padded to the target size
        and to a multiple of the replica count by wrapping real rows with
        weight 0, each split over the replicas and copied to their devices
        ``prefetch`` batches ahead (default: the builder's
        ``prefetch_buffer``); ``steps_per_dispatch=K`` runs K steps before
        the listeners hear of them. ``resume_from``: a checkpoint, resumed
        exactly (``util/checkpoint.begin_fit_cursor``; a ZeRO-1 fit keeps
        a flat updater state). ``resume_cursor=(epochs_done,
        steps_in_epoch)``: continue in memory from the state the wrapper
        holds (after :meth:`resize`), skipping the batches already
        taken."""
        model = self.model
        model._check_init()
        if not self._listeners and getattr(model, "_listeners", None):
            self.set_listeners(*model._listeners)
        from ..util.checkpoint import begin_fit_cursor

        if resume_cursor is not None:
            if resume_from is not None:
                raise ValueError(
                    "resume_from and resume_cursor are mutually exclusive")
            skip = (int(resume_cursor[0]), int(resume_cursor[1]))
            model._fit_epoch0 = model._epoch - skip[0]
            model._steps_in_epoch = skip[1]
        else:
            skip = begin_fit_cursor(model, resume_from,
                                    listeners=self._listeners,
                                    keep_flat=self.accumulator.zero1)
        self._ensure_parallel_state()
        tele = self._telemetry
        if tele is not None and tele.integrity_every \
                and self.spans_processes:
            raise NotImplementedError(
                "integrity fingerprints compare replica copies in one "
                "process; they do not run across a process group")
        if tele is not None and tele.integrity_every \
                and (self.model_axis != 1 or self._tables):
            raise NotImplementedError(
                "integrity fingerprints police the replicated-state "
                "invariant — model-sharded params have no replica copies "
                "to compare")
        self._publish_live()
        self.group_stop = False
        prof = OpProfiler.get()

        def on_epoch():
            model._epoch += 1
            model._steps_in_epoch = 0
            self._drain_encoded_ledger(prof)
            for lst in self._listeners:
                if hasattr(lst, "epoch_done"):
                    lst.epoch_done(model, model._epoch)

        try:
            _pipe.run_epochs(
                data, epochs, batch_size,
                pad_partial=True if pad_partial is None else pad_partial,
                drop_remainder=drop_remainder,
                prefetch=self.prefetch if prefetch is None else prefetch,
                steps_per_dispatch=steps_per_dispatch,
                bind=self._bind_batch, place=self._place_batch,
                dispatch=self._dispatch, on_epoch=on_epoch,
                allow_multi=hasattr(model.conf, "network_inputs"),
                skip=skip, host_prefetch=host_prefetch,
                round_to_multiple_of=self.workers_count)
        except BaseException as e:
            from .distributed import Preempted

            # a stop the group agreed on: every rank unwinds at the same
            # boundary, so the release may gather
            self._release(collective=self.group_stop
                          and isinstance(e, Preempted))
            raise
        self._release()

    # --- online elastic resize -----------------------------------------------
    def resize(self, workers: int, *, lost_replicas=None) -> List[Any]:
        """Resize the data axis to ``workers`` between steps, in memory:
        the new replicas are built from a surviving replica's parameters,
        layer states and (dense) updater state; a ZeRO-1 flat state is
        gathered from every replica's slice and re-padded for the new
        count; the encoded accumulator's residuals go through
        ``resize_state`` (a lost replica's residual folds into the first
        survivor). ``lost_replicas``: data-axis indices whose devices are
        gone; they are left out of the new mesh and stay out until a probe
        (:func:`~deeplearning4j_tpu_torch.parallel.mesh.probe_device`)
        finds them healthy at a later resize. Continue with
        ``fit(resume_cursor=...)``. Returns the slots that left."""
        n = int(workers)
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if self.spans_processes:
            raise NotImplementedError(
                "a process group does not resize in place; "
                "supervise_processes relaunches the group (shrunk with "
                "make_commands)")
        if self.model_axis != 1:
            raise NotImplementedError(
                "online elastic resize is a data-axis operation; it does "
                "not compose with model_axis/table_sharding yet")
        old_n = self.workers_count
        lost = sorted({int(r) for r in (lost_replicas or ())})
        if any(r < 0 or r >= old_n for r in lost):
            raise ValueError(f"lost_replicas {lost} out of range for "
                             f"{old_n} workers")
        if n == old_n and not lost:
            return []
        prof = OpProfiler.get()
        model = self.model
        with prof.time_section("elastic/resize"):
            mesh_devs = list(self.mesh.devices.flat)
            lost_devs = [mesh_devs[r] for r in lost]
            still_lost = {d for d in self._lost_devices
                          if not probe_device(d)} | set(lost_devs)
            pool = elastic_pool(self.mesh, exclude=still_lost,
                                devices=self._pool)
            if n > len(pool):
                raise ValueError(
                    f"resize to {n} workers needs {n} devices; only "
                    f"{len(pool)} are available")
            self._ensure_parallel_state()
            self._lost_devices = still_lost
            survivor = next(i for i in range(old_n) if i not in lost) \
                if len(lost) < old_n else 0
            src = self._reps[survivor]
            params = src.store.param_views
            states = src.states
            upd = (self._gathered_upd(src.device) if self.accumulator.zero1
                   else self._dense_upd(src))
            acc_st = None
            if self.accumulator.stateful:
                acc_st = self.accumulator.resize_state(
                    self._host_acc(), old_n, n, lost_replicas=lost)
            self.mesh = make_mesh(data=n, model=1, devices=pool[:n])
            new_devs = set(self.mesh.devices.flat)
            removed = [d for d in mesh_devs if d not in new_devs]
            self.workers_count = n
            self._route = LocalRoute(n)
            model._params, model._states = params, states
            model._updater_state, model._acc_state = upd, acc_st
            self._reps = None
            self._ensure_parallel_state()
            self._release()
        prof.count("elastic/resizes")
        if n < old_n:
            prof.count("elastic/shrinks")
        elif n > old_n:
            prof.count("elastic/grows")
        logger.warning("elastic resize: data axis %d -> %d workers%s",
                       old_n, n,
                       f" (lost replicas {lost})" if lost else "")
        return removed

    def probe_replicas(self) -> List[int]:
        """Data-axis indices whose device fails a round-trip."""
        return [i for i, d in enumerate(self.mesh.devices.flat)
                if not probe_device(d)]

    def shutdown(self) -> None:
        """Give the model its copies and drop the replicas."""
        self._release()
        self._reps = None
        self._acc = None
        self._released = None
        model = self.model
        if getattr(model, "_parallel", None) is self:
            model._parallel = None
            model._parallel_sync = None
