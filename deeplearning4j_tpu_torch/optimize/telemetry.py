"""In-step training telemetry and the NaN guard.

Counterpart of ``deeplearning4j_tpu/optimize/telemetry.py``. The JAX step
computes a small auxiliary tree of device values inside the compiled step;
here the networks' step (``nn/_train.TrainableNetwork._step``) computes the
same tree eagerly on the device, right after the update:

- ``loss``; ``grad_norm``, ``update_norm``, ``param_norm`` and
  ``update_ratio``, each ``[L]`` float32 in :func:`groups` order (one slot
  per layer, 0 for a layer without parameters); ``nonfinite`` ``[L]`` int32
  (non-finite gradient elements per layer); ``nonfinite_total`` (their sum,
  plus 1 for a non-finite loss); ``skipped`` under the guard.
- The per-layer reductions take a fixed number of launches, whatever the
  number of leaves: ``torch._foreach_norm`` over the leaves, one
  ``index_add_`` into the layers, and one cumulative sum over the
  concatenated gradients for the exact non-finite counts.
- :func:`apply_nan_guard` keeps the pre-step values where the step was
  poisoned: ``torch.where(ok, new, old)`` with ``ok`` a device boolean, so
  the decision never leaves the card and the step never synchronises the
  host. The listeners read the aux back only at their drain boundaries.

Host side, two listeners drain the aux: :class:`TelemetrySink` (every
``drain_every_n`` iterations one batched readback into a ``StatsStorage``,
``ui/stats.py``) and :class:`NanSentinelListener` (warn, skip, cull, raise).
Attaching either through ``set_listeners`` turns the aux on
(``wants_telemetry``). Under a fleet (``parallel/fleet.py``) ``"cull"``
also drops the poisoned member's alive bit on the device, for good; on one
model ``"cull"`` behaves as ``"skip"``, as in the JAX package.

Data-parallel training (``parallel/wrapper.py``) takes the non-finite
counts on each replica's own gradients before the exchange and sums them
(:func:`nonfinite_counts`), and under ZeRO-1 assembles the per-layer norms
from the replicas' flat slices (:func:`sharded_layer_stats`): no whole
gradient or update tensor is put together for telemetry.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..common import tracecheck
from ..common.profiler import OpProfiler
from ..common.tree import get_path, leaf_paths, set_path, skeleton
from ..parallel.sharding import groups
from .listeners import TrainingListener

logger = logging.getLogger("deeplearning4j_tpu_torch")

__all__ = ["TelemetryConfig", "config_for", "groups", "layer_names",
           "nonfinite_counts", "layer_stats", "sharded_layer_stats",
           "apply_nan_guard",
           "clone_tree", "where_tree", "TelemetrySink",
           "NanSentinelListener"]


@dataclass(frozen=True)
class TelemetryConfig:
    """What a listener set asks of the step: ``stats`` (the per-layer
    aux), ``nan_guard`` (the skip policy; forces ``stats``),
    ``member_cull`` (a fleet's; a single model ignores it) and
    ``integrity_every`` (the replicas' consistency check; nothing on one
    card reads it)."""

    nan_guard: bool = False
    member_cull: bool = False
    stats: bool = True
    integrity_every: int = 0


def config_for(listeners) -> Optional[TelemetryConfig]:
    """The telemetry config a listener set implies (None: no aux), from the
    listeners' ``wants_telemetry``, ``wants_nan_guard``,
    ``wants_member_cull``, ``wants_telemetry_stats`` and
    ``wants_integrity`` attributes, as in the JAX package."""
    if not any(getattr(l, "wants_telemetry", False) for l in listeners):
        return None
    nan_guard = any(getattr(l, "wants_nan_guard", False) for l in listeners)
    stats = nan_guard or any(
        getattr(l, "wants_telemetry_stats",
                getattr(l, "wants_telemetry", False))
        for l in listeners)
    integrity_every = 0
    for l in listeners:
        integrity_every = max(integrity_every,
                              int(getattr(l, "wants_integrity", 0) or 0))
    return TelemetryConfig(
        nan_guard=nan_guard,
        member_cull=any(getattr(l, "wants_member_cull", False)
                        for l in listeners),
        stats=stats,
        integrity_every=integrity_every)


def layer_names(model) -> List[str]:
    """Labels of the aux vectors' layer axis: ``<index>_<class>`` for a
    multilayer network, the sorted node names for a graph."""
    conf = getattr(model, "conf", None)
    layers = getattr(conf, "layers", None)
    if layers is not None:
        return [f"{i}_{type(l).__name__}" for i, l in enumerate(layers)]
    params = getattr(model, "_params", None)
    if isinstance(params, dict):
        return sorted(params)
    return []


# --- packed leaves ------------------------------------------------------------

def _leaves(tree) -> Tuple[list, list]:
    paths = leaf_paths(tree)
    return paths, [get_path(tree, p) for p in paths]


def _rebuild(tree, paths, flats, order):
    """A tree shaped like ``tree`` whose leaves are views of ``flats``
    (one flat tensor per dtype group, the leaves in ``order``)."""
    out = skeleton(tree)
    for flat, idx in zip(flats, order):
        pos = 0
        for i in idx:
            leaf = get_path(tree, paths[i])
            n = leaf.numel()
            set_path(out, paths[i], flat[pos:pos + n].view(leaf.shape))
            pos += n
    return out


def _dtype_groups(leaves) -> List[List[int]]:
    by: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(leaves):
        by.setdefault(t.dtype, []).append(i)
    return list(by.values())


def clone_tree(tree):
    """A copy of a tensor tree in one concatenation per dtype; the leaves of
    the copy are views of it."""
    paths, leaves = _leaves(tree)
    if not leaves:
        return tree
    order = _dtype_groups(leaves)
    flats = [torch.cat([leaves[i].detach().reshape(-1) for i in idx])
             for idx in order]
    return _rebuild(tree, paths, flats, order)


def where_tree(ok: torch.Tensor, new, old):
    """``torch.where(ok, new, old)`` leaf by leaf, in one ``where`` per
    dtype over the concatenated leaves (views of the result)."""
    paths, nl = _leaves(new)
    if not nl:
        return new
    ol = [get_path(old, p) for p in paths]
    order = _dtype_groups(nl)
    flats = [torch.where(ok, torch.cat([nl[i].detach().reshape(-1)
                                        for i in idx]),
                         torch.cat([ol[i].detach().reshape(-1)
                                    for i in idx]))
             for idx in order]
    return _rebuild(new, paths, flats, order)


# --- per-layer reductions -----------------------------------------------------

_INDEX_CACHE: Dict[tuple, torch.Tensor] = {}


def _cached_index(values: Tuple[int, ...], device) -> torch.Tensor:
    """An int64 index tensor on ``device``, made once per content (a
    host-to-device copy synchronises; the steps after the first reuse
    it)."""
    key = (values, str(device))
    t = _INDEX_CACHE.get(key)
    if t is None:
        if len(_INDEX_CACHE) > 64:
            _INDEX_CACHE.clear()
        t = torch.tensor(values, dtype=torch.int64, device=device)
        _INDEX_CACHE[key] = t
    return t


def _layer_of_leaves(params) -> Tuple[List[tuple], Tuple[int, ...], int]:
    """The leaf paths of ``params``, each leaf's slot in :func:`groups`
    order, and the number of slots."""
    keys = sorted(params)
    slot = {k: i for i, k in enumerate(keys)}
    paths = leaf_paths(params)
    return paths, tuple(slot[p[0]] for p in paths), len(keys)


def _per_layer_sumsq(leaves, slots, n_layers: int, device) -> torch.Tensor:
    """``[L]`` float32: each layer's sum of squares over its leaves."""
    out = torch.zeros((n_layers,), dtype=torch.float32, device=device)
    if not leaves:
        return out
    xs = [t if t.dtype == torch.float32 else t.float() for t in leaves]
    sq = torch.stack(torch._foreach_norm(xs)).square()
    return out.index_add_(0, _cached_index(slots, device), sq)


def _per_layer_nonfinite(leaves, slots, n_layers: int,
                         device) -> torch.Tensor:
    """``[L]`` int32: each layer's non-finite elements, counted exactly
    (a cumulative sum over the concatenated leaves, read at the leaves'
    ends)."""
    out = torch.zeros((n_layers,), dtype=torch.int32, device=device)
    if not leaves:
        return out
    # a leading 0 makes the cumulative sum at a leaf's start offset the
    # count before it
    flat = torch.cat([leaves[0].new_zeros((1,))]
                     + [t.detach().reshape(-1) for t in leaves])
    cs = torch.cumsum(~torch.isfinite(flat), 0, dtype=torch.int32)
    starts, ends, pos = [], [], 0
    for t in leaves:
        starts.append(pos)
        pos += t.numel()
        ends.append(pos)
    per_leaf = (cs[_cached_index(tuple(ends), device)]
                - cs[_cached_index(tuple(starts), device)])
    return out.index_add_(0, _cached_index(slots, device), per_leaf)


def nonfinite_counts(grads) -> torch.Tensor:
    """Per-layer non-finite element counts (``[L]`` int32) of a gradient
    tree."""
    paths, slots, n = _layer_of_leaves(grads)
    leaves = [get_path(grads, p) for p in paths]
    device = leaves[0].device if leaves else None
    return _per_layer_nonfinite(leaves, slots, n, device)


def layer_stats(params, new_params, grads, loss: torch.Tensor,
                nonfinite: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """The auxiliary telemetry tree of one step (device values): see the
    module docstring. ``params`` are the pre-step parameters, ``new_params``
    the step's result (frozen layers restored, constraints applied),
    ``grads`` the gradients the updater took."""
    paths, slots, n = _layer_of_leaves(params)
    old = [get_path(params, p) for p in paths]
    new = [get_path(new_params, p) for p in paths]
    gr = [get_path(grads, p) for p in paths]
    device = loss.device
    grad_norm = _per_layer_sumsq(gr, slots, n, device).sqrt()
    diff = torch._foreach_sub([t.detach() for t in new],
                              [t.detach() for t in old]) if new else []
    update_norm = _per_layer_sumsq(diff, slots, n, device).sqrt()
    param_norm = _per_layer_sumsq([t.detach() for t in new], slots, n,
                                  device).sqrt()
    nf = nonfinite if nonfinite is not None \
        else _per_layer_nonfinite(gr, slots, n, device)
    total = nf.sum(dtype=torch.int32) \
        + (~torch.isfinite(loss)).to(torch.int32)
    return {
        "loss": loss,
        "grad_norm": grad_norm,
        "update_norm": update_norm,
        "param_norm": param_norm,
        "update_ratio": update_norm / torch.clamp_min(param_norm, 1e-12),
        "nonfinite": nf,
        "nonfinite_total": total,
    }


def sharded_layer_stats(loss: torch.Tensor, parts, n_layers: int,
                        nonfinite: Optional[torch.Tensor] = None
                        ) -> Dict[str, torch.Tensor]:
    """:func:`layer_stats` from flat slices (ZeRO-1): ``parts`` holds, for
    every replica and bucket, ``(segment_ids, grad_slice, new_param_slice,
    old_param_slice)``, ``segment_ids`` mapping each position to its layer
    slot (``n_layers``: the pad tail, dropped). Each part's sums of squares
    are segment-summed (``index_add_``) on its device, then summed over the
    parts in order on ``loss``'s device (the JAX package's
    ``segment_sum`` + ``psum``, ``telemetry.py:188``). ``nonfinite``: the
    counts from the replicas' raw gradients."""
    dev = loss.device
    sums = []
    for seg, g, pn, po in parts:
        z = torch.zeros((3, n_layers + 1), dtype=torch.float32,
                        device=g.device)
        g32 = g.to(torch.float32)
        d32 = (pn - po).to(torch.float32)
        p32 = pn.to(torch.float32)
        z[0].index_add_(0, seg, g32 * g32)
        z[1].index_add_(0, seg, d32 * d32)
        z[2].index_add_(0, seg, p32 * p32)
        sums.append(z.to(dev))
    tot = sums[0]
    for z in sums[1:]:
        tot = tot + z
    grad_norm, update_norm, param_norm = tot[:, :n_layers].sqrt()
    nf = nonfinite if nonfinite is not None else torch.zeros(
        (n_layers,), dtype=torch.int32, device=dev)
    total = nf.sum(dtype=torch.int32) \
        + (~torch.isfinite(loss)).to(torch.int32)
    return {
        "loss": loss,
        "grad_norm": grad_norm,
        "update_norm": update_norm,
        "param_norm": param_norm,
        "update_ratio": update_norm / torch.clamp_min(param_norm, 1e-12),
        "nonfinite": nf,
        "nonfinite_total": total,
    }


def apply_nan_guard(aux, new_params, params, new_states, states,
                    new_upd, upd_state):
    """The skip policy on trees: where the step produced a non-finite
    gradient or loss, the pre-step parameters, layer states and updater
    state are kept (``torch.where`` on the card, no readback). Returns
    ``(aux + skipped, params, states, updater state)``."""
    ok = aux["nonfinite_total"] == 0
    aux = dict(aux)
    aux["skipped"] = (~ok).to(torch.int32)
    return (aux, where_tree(ok, new_params, params),
            where_tree(ok, new_states, states),
            where_tree(ok, new_upd, upd_state) if new_upd else new_upd)


def merge_segment_aux(prev: Optional[dict], seg: dict) -> dict:
    """A truncated-BPTT batch's aux: the norms of its last segment, the
    non-finite evidence (and skips) summed over its segments, so a
    poisoned middle segment stays visible."""
    if prev is None:
        return dict(seg)
    out = dict(seg)
    for k in ("nonfinite", "nonfinite_total", "skipped"):
        if k in seg:
            out[k] = prev[k] + seg[k]
    return out


def readback(auxes: List[dict]) -> List[Dict[str, Any]]:
    """A window of aux trees on the host in ONE device-to-host copy: each
    tree's entries concatenated as float64 (exact for the int32 counts),
    the window stacked. Returns one dict of numpy values per tree."""
    if not auxes:
        return []
    keys = sorted(auxes[0])
    shapes = [tuple(auxes[0][k].shape) for k in keys]
    rows = torch.stack([
        torch.cat([a[k].detach().reshape(-1).to(torch.float64)
                   for k in keys]) for a in auxes])
    tracecheck.note_host_sync("telemetry/readback")
    host = rows.cpu().numpy()
    out = []
    for r in host:
        d, pos = {}, 0
        for k, shp in zip(keys, shapes):
            n = 1
            for s in shp:
                n *= s
            v = r[pos:pos + n].reshape(shp)
            d[k] = v if shp else v.item()
            pos += n
        out.append(d)
    return out


# --- listener-bus drains (host side) ------------------------------------------

class TelemetrySink(TrainingListener):
    """Drains the step's aux into a ``StatsStorage``: the device trees are
    buffered per iteration and every ``drain_every_n`` iterations (and at
    each epoch's end) read back in one copy. ``keep_every_n`` subsamples.
    Scalars per drained iteration: ``loss``, ``nonfinite_total``
    (``skipped_updates`` under the guard; ``exchange_density`` under an
    encoded gradient exchange), ``{grad_norm, update_norm,
    param_norm, update_ratio}/<layer>`` and, where non-zero,
    ``nonfinite/<layer>``."""

    wants_telemetry = True

    def __init__(self, storage, drain_every_n: int = 10,
                 session_id: str = "", keep_every_n: int = 1):
        self.storage = storage
        self.every = max(1, drain_every_n)
        self.keep = max(1, keep_every_n)
        self.session = session_id
        self._buf: List[tuple] = []
        self._names: Optional[List[str]] = None
        self.drains = 0

    def telemetry_done(self, model, iteration: int, aux) -> None:
        if iteration % self.keep:
            return
        if self._names is None:
            self._names = layer_names(model)
        self._buf.append((iteration, aux))
        if len(self._buf) >= self.every:
            self.drain()

    def drain(self) -> None:
        """Flush the buffered window (one batched readback)."""
        if not self._buf:
            return
        host = readback([a for _, a in self._buf])
        names = self._names or []

        def name(j: int) -> str:
            return names[j] if j < len(names) else str(j)

        put = self.storage.put_scalar
        for (it, _), aux in zip(self._buf, host):
            put(self.session, "loss", it, float(aux["loss"]))
            put(self.session, "nonfinite_total", it,
                int(aux["nonfinite_total"]))
            if "skipped" in aux:
                put(self.session, "skipped_updates", it, int(aux["skipped"]))
            if "exchange_density" in aux:
                put(self.session, "exchange_density", it,
                    float(aux["exchange_density"]))
            for series in ("grad_norm", "update_norm", "param_norm",
                           "update_ratio"):
                vec = aux[series]
                for j in range(len(vec)):
                    put(self.session, f"{series}/{name(j)}", it,
                        float(vec[j]))
            nf = aux["nonfinite"]
            for j in range(len(nf)):
                if int(nf[j]):
                    put(self.session, f"nonfinite/{name(j)}", it,
                        int(nf[j]))
        OpProfiler.get().count("telemetry/drained_steps", len(self._buf))
        self.drains += 1
        self._buf.clear()

    def epoch_done(self, model, epoch: int) -> None:
        self.drain()


class NanSentinelListener(TrainingListener):
    """Graded NAN_PANIC. Policies: ``"warn"`` (log the offending layers),
    ``"skip"`` (the step keeps its pre-step values where it was poisoned,
    :func:`apply_nan_guard`; the listener reports), ``"cull"`` (a fleet's
    skip-and-isolate; on one model exactly ``"skip"``), ``"raise"``
    (``FloatingPointError`` naming the layer). The counts are read back
    every ``check_every_n`` iterations and at each epoch's end, never per
    step."""

    wants_telemetry = True
    POLICIES = ("warn", "skip", "cull", "raise")

    def __init__(self, policy: str = "warn", check_every_n: int = 10):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.wants_nan_guard = policy in ("skip", "cull")
        self.wants_member_cull = policy == "cull"
        self.every = max(1, check_every_n)
        self._buf: List[tuple] = []
        self._names: Optional[List[str]] = None
        self.events: List[dict] = []

    def telemetry_done(self, model, iteration: int, aux) -> None:
        if self._names is None:
            self._names = layer_names(model)
        self._buf.append((iteration, {"nonfinite": aux["nonfinite"],
                                      "nonfinite_total":
                                      aux["nonfinite_total"]}))
        if len(self._buf) >= self.every:
            self.check()

    def check(self) -> None:
        """Inspect the buffered window (one batched readback)."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        host = readback([a for _, a in buf])
        names = self._names or []
        for (it, _), aux in zip(buf, host):
            tot = int(aux["nonfinite_total"])
            if tot == 0:
                continue
            layers = [(names[j] if j < len(names) else str(j), int(c))
                      for j, c in enumerate(aux["nonfinite"]) if int(c)]
            where = ", ".join(f"{n} ({c} non-finite grad elements)"
                              for n, c in layers) or "loss"
            self.events.append({"iteration": it, "layers": layers,
                                "total": tot})
            OpProfiler.get().count("telemetry/nan_events")
            if self.policy == "raise":
                raise FloatingPointError(
                    f"non-finite gradients at iteration {it}: {where}")
            if self.policy in ("skip", "cull"):
                logger.warning("NanSentinel: skipped poisoned update at "
                               "iteration %d (%s)", it, where)
            else:
                logger.warning("NanSentinel: non-finite gradients at "
                               "iteration %d (%s)", it, where)

    def epoch_done(self, model, epoch: int) -> None:
        self.check()
