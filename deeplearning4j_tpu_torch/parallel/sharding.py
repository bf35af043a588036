"""The flat per-dtype bucket layout behind the fused weight update and
ZeRO-1.

Counterpart of ``Zero1Plan`` in ``deeplearning4j_tpu/parallel/sharding.py``:
a parameter tree
``{node: {name: tensor}}`` (one level deeper under a wrapper layer,
``common/tree.py``) is raveled into one 1-D buffer per dtype (a
"bucket", keyed ``flat::<dtype>``), zero-padded to a multiple of the shard
count. The layout is a pure permutation, so an elementwise updater on the
buckets equals the updater leaf by leaf.

Leaf order is ``jax.tree.flatten``'s on the same dicts: keys sorted at
every level (never dict insertion order), and buckets in sorted dtype-name
order. So a bucket here holds exactly the elements, in the same
places, as the JAX package's, and updater state carries across in either
layout.

:meth:`Zero1Plan.unflatten` returns **views** into the buckets (the JAX
version returns new arrays): the port's fused step keeps each float32
bucket as one persistent tensor, exposes the parameters as views of it and
updates the bucket in place.

**ZeRO-1** (``parallel/wrapper.py`` with ``ReduceScatterAccumulator``):
replica ``i`` owns elements ``[i*shard, (i+1)*shard)`` of every bucket
(:meth:`Zero1Plan.shard_slice`). The layout does not depend on the replica
count, only the zero tail does, so a flat state padded for N replicas moves
to M exactly (:meth:`Zero1Plan.reshard_state`). ``shard_align=a`` rounds
each shard to a multiple of ``a`` elements: the wrapper asks for 4, so every
float32 shard starts on 16 bytes and ``fused_update`` takes its vector path
on each (the JAX layout pads to a multiple of the replica count only; the
padding never reaches a checkpoint, whose layout is the dense tree).

**Tensor parallelism** (``tp_param_specs``, ``tp_shardings``,
``apply_tp``; JAX ``sharding.py:35-67``): the same spec rules (a dense
``[in, out]`` splits on ``out``, a convolution OIHW on ``O``, a 1-D leaf
when its length is at least twice the axis size; whatever does not divide
stays replicated), with the port's own :class:`PartitionSpec`. There a
spec is a compiler annotation and GSPMD inserts the collectives. Here
:func:`apply_tp` returns a ``common/tree.ShardedTree`` whose sharded
leaves are ``ShardedTensor`` s (one shard per slot of the axis, each on its
slot's device), and ``MultiLayerNetwork``'s forward takes such a tree
(:func:`tp_layer_fn`, chosen once a forward by the tree's type): a Dense
or Convolution layer with an elementwise activation runs column-parallel
(each slot multiplies by its slice of the output dimension, the slices
joined in slot order); any other layer gets its sharded leaves gathered
first. Weight noise and a rematerialization policy act on whole leaves and
are refused in a tensor-parallel training forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..common.dtypes import dtype_name
from ..common.tree import (ShardedTensor, ShardedTree, get_path, leaf_paths,
                           set_path, skeleton, sort_tree)

FLAT_PREFIX = "flat::"   # bucket keys ("flat::float32") mark the flat layout

Tree = Dict[str, Dict[str, Any]]


def groups(params) -> List[Any]:
    """Per-layer parameter subtrees in canonical order: list index for a
    list of layers, sorted node name for graph dicts (the JAX package's
    ``optimize/telemetry.groups``)."""
    if isinstance(params, dict):
        return [params[k] for k in sorted(params)]
    return list(params)


@dataclass(frozen=True)
class _Bucket:
    key: str                          # "flat::<dtype>"
    dtype: torch.dtype
    leaf_idx: Tuple[int, ...]         # positions in leaf order
    sizes: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    total: int                        # true (unpadded) element count
    padded: int                       # total rounded up to n_shards
    shard: int                        # padded // n_shards


class Zero1Plan:
    """The deterministic flat layout for one (params, n_shards) pair.
    ``flatten``/``unflatten`` move no arithmetic: ravel + concatenate and
    slice + view."""

    def __init__(self, params: Tree, n_shards: int = 1,
                 shard_align: int = 1):
        self.paths = leaf_paths(params)
        self.skeleton = skeleton(params)
        self.n_shards = int(n_shards)
        self.n_leaves = len(self.paths)
        node_slot = {k: i for i, k in enumerate(sorted(params))}
        self.n_layers = len(groups(params))
        leaves = [get_path(params, p) for p in self.paths]
        by_dtype: Dict[str, List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
        unit = self.n_shards * max(1, int(shard_align))
        self.buckets: List[_Bucket] = []
        self._bounds: Dict[str, Tuple[int, ...]] = {}
        self._interval_layers: Dict[str, Tuple[int, ...]] = {}
        for dt, idxs in sorted(by_dtype.items()):
            sizes = tuple(int(leaves[i].numel()) for i in idxs)
            total = sum(sizes)
            padded = -(-total // unit) * unit
            b = _Bucket(
                key=FLAT_PREFIX + dt, dtype=leaves[idxs[0]].dtype,
                leaf_idx=tuple(idxs), sizes=sizes,
                shapes=tuple(tuple(leaves[i].shape) for i in idxs),
                total=total, padded=padded, shard=padded // self.n_shards)
            self.buckets.append(b)
            # each leaf's flat start and its telemetry layer slot; the pad
            # tail [total, padded) falls in the overflow slot n_layers
            self._bounds[b.key] = tuple(int(v) for v in
                                        np.cumsum((0,) + sizes))
            self._interval_layers[b.key] = tuple(
                node_slot[self.paths[i][0]] for i in idxs) \
                + (self.n_layers,)

    def _leaves(self, tree) -> list:
        try:
            leaves = [get_path(tree, p) for p in self.paths]
        except KeyError as e:
            raise ValueError(f"tree does not match the plan: missing {e}") \
                from None
        n = len(leaf_paths(tree))
        if n != self.n_leaves:
            raise ValueError(f"tree has {n} leaves, plan expects "
                             f"{self.n_leaves}")
        return leaves

    # -- layout transforms ------------------------------------------------
    def flatten(self, tree: Tree) -> Dict[str, torch.Tensor]:
        """One new contiguous bucket per dtype. The zero tail takes the
        LEAVES' dtype, so a bfloat16 state tree flattens through its
        params' ``flat::float32`` keys without promotion."""
        leaves = self._leaves(tree)
        out = {}
        for b in self.buckets:
            parts = [leaves[i].reshape(-1) for i in b.leaf_idx]
            if b.padded > b.total:
                parts.append(parts[0].new_zeros((b.padded - b.total,)))
            out[b.key] = torch.cat(parts)
        return out

    def unflatten(self, flats: Dict[str, torch.Tensor]) -> Tree:
        """Views into ``flats`` (tensors, or numpy arrays on the host), one
        per leaf, in the params' tree shape (nodes without parameters map to
        empty dicts)."""
        out: Tree = skeleton(self.skeleton)
        for b in self.buckets:
            flat = flats[b.key]
            pos = 0
            for i, sz, shape in zip(b.leaf_idx, b.sizes, b.shapes):
                set_path(out, self.paths[i], flat[pos:pos + sz].reshape(shape))
                pos += sz
        return sort_tree(out)

    # -- shards ---------------------------------------------------------------
    def shard_slice(self, flats: Dict[str, torch.Tensor],
                    idx: int) -> Dict[str, torch.Tensor]:
        """Replica ``idx``'s slice of every bucket (views)."""
        return {b.key: flats[b.key][idx * b.shard:(idx + 1) * b.shard]
                for b in self.buckets}

    def unpadded_views(self, flats: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """Each bucket's live prefix ``[:total]``: the pad tail's length
        depends on the replica count, so a digest
        (``common/integrity.fingerprint_flats``) folds only this."""
        return {b.key: flats[b.key][:b.total] for b in self.buckets}

    def shard_segment_ids(self, key: str, idx: int, shard: int,
                          device=None) -> torch.Tensor:
        """The telemetry layer slot of each position of replica ``idx``'s
        slice of bucket ``key`` (int64, ascending; the pad tail maps to
        slot ``n_layers``), from the bucket's leaf boundaries."""
        bounds = torch.tensor(self._bounds[key], dtype=torch.int64,
                              device=device)
        layers = torch.tensor(self._interval_layers[key], dtype=torch.int64,
                              device=device)
        pos = idx * shard + torch.arange(shard, dtype=torch.int64,
                                         device=device)
        k = torch.searchsorted(bounds, pos, right=True) - 1
        return layers[k.clamp_max(len(self._interval_layers[key]) - 1)]

    def bucket_bytes(self) -> int:
        return sum(b.padded * torch.empty((), dtype=b.dtype).element_size()
                   for b in self.buckets)

    # -- updater-state layout conversion ------------------------------------
    def _mirrors_params(self, v) -> bool:
        return (isinstance(v, dict)
                and all(isinstance(d, dict) for d in v.values())
                and leaf_paths(v) == self.paths)

    def flatten_state(self, state):
        """Dense (params-mirroring) updater state → flat buckets. Subtrees
        not shaped like the params pass through."""
        if not isinstance(state, dict):
            return state
        return {k: (self.flatten(v) if self._mirrors_params(v) else v)
                for k, v in state.items()}

    def unflatten_state_inplan(self, state):
        """Flat updater state in THIS plan's padded layout → dense tree of
        views (no copy, no re-padding)."""
        return {k: (self.unflatten({b.key: v[b.key][:b.total]
                                    for b in self.buckets})
                    if _is_flat_dict(v) else v)
                for k, v in state.items()}

    def unflatten_state(self, state):
        """Flat updater state padded for ANY shard count → dense tree of
        the same kind of arrays (tensors, or numpy arrays); the zero tail
        is stripped."""
        if not is_flat_state(state):
            return state
        out = {}
        for k, v in state.items():
            if _is_flat_dict(v):
                out[k] = self.unflatten({b.key: self._strip(v[b.key], b)
                                         for b in self.buckets})
            else:
                out[k] = v
        return out

    def _strip(self, arr, b: _Bucket):
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        size = arr.numel() if isinstance(arr, torch.Tensor) else arr.size
        if size < b.total:
            raise ValueError(
                f"flat updater bucket {b.key} has {size} elements; "
                f"params imply {b.total} — the state does not match the "
                "model")
        return arr.reshape(-1)[:b.total]

    def _repad(self, arr, b: _Bucket) -> torch.Tensor:
        """One bucket saved under any shard count, with this plan's
        padding: the live elements untouched, the zero tail cut or
        grown."""
        live = self._strip(arr, b)
        if not isinstance(live, torch.Tensor):
            live = torch.from_numpy(np.ascontiguousarray(live))
        if b.padded > b.total:
            live = torch.cat([live, live.new_zeros((b.padded - b.total,))])
        return live

    def reshard_state(self, state):
        """A flat state (any previous shard count) or a dense tree → the
        flat state padded for THIS plan (new tensors)."""
        if is_flat_state(state):
            return {k: ({b.key: self._repad(v[b.key], b)
                         for b in self.buckets} if _is_flat_dict(v) else v)
                    for k, v in state.items()}
        return self.flatten_state(state)


def _is_flat_dict(v) -> bool:
    return (isinstance(v, dict) and bool(v)
            and all(str(k).startswith(FLAT_PREFIX) for k in v))


def is_flat_state(state) -> bool:
    """True when ``state`` is in the flat-bucket layout (top-level values
    are dicts keyed ``flat::<dtype>``)."""
    if not isinstance(state, dict) or not state:
        return False
    return any(_is_flat_dict(v) for v in state.values())


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per leading
    dimension, a mesh axis name or None; ``PartitionSpec()`` replicates."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def tp_param_specs(params, mesh, axis: str = "model"):
    """A :class:`PartitionSpec` per leaf of ``params`` for tensor-parallel
    placement over ``axis``; what does not divide evenly is replicated."""
    size = mesh.shape[axis]

    def spec_for(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 2 and shape[1] % size == 0 and shape[1] >= size:
            return P(None, axis)                    # dense [in, out]
        if len(shape) == 4 and shape[0] % size == 0 and shape[0] >= size:
            return P(axis, None, None, None)        # conv OIHW [out, ...]
        if len(shape) == 1 and shape[0] % size == 0 and shape[0] >= 2 * size:
            return P(axis)                          # bias / per-channel
        return P()

    return _map_leaves(spec_for, params)


class NamedSharding:
    """A placement: ``spec`` over ``mesh`` (the JAX type's counterpart)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def place(self, t: torch.Tensor):
        """``t`` as a :class:`ShardedTensor` over the spec's axis, or
        itself when the spec replicates it."""
        from .mesh import axis_slots

        for dim, name in enumerate(self.spec):
            if name is not None:
                return ShardedTensor.split(
                    t, [s.device for s in axis_slots(self.mesh, name)],
                    dim, spec=self.spec)
        return t

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"


def tp_shardings(params, mesh, axis: str = "model"):
    """A :class:`NamedSharding` per leaf (:func:`tp_param_specs`)."""
    return _map_leaves(lambda s: NamedSharding(mesh, s),
                       tp_param_specs(params, mesh, axis))


def apply_tp(params, mesh, axis: str = "model") -> ShardedTree:
    """``params`` with tensor-parallel placement, as a
    :class:`ShardedTree`: every leaf its spec splits becomes a
    :class:`ShardedTensor`; the others stay as they are."""
    specs = tp_param_specs(params, mesh, axis)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return NamedSharding(mesh, s).place(p)

    return ShardedTree(walk(params, specs))


def _gathered(tree, device):
    return _map_leaves(lambda t: t.gather(device)
                       if isinstance(t, ShardedTensor) else t, tree)


def _column_parallel(layer, lp) -> bool:
    """Whether ``layer`` runs column-parallel on ``lp``: a Dense or
    Convolution layer (not a subclass, so no output head), an elementwise
    activation, its W split on the output dimension and any other sharded
    leaf split alike."""
    from ..nn.conf import layers as L

    w = lp.get("W")
    if type(layer) is L.DenseLayer:
        out_dim = 1
    elif type(layer) is L.ConvolutionLayer:
        out_dim = 0
    else:
        return False
    act = (layer.activation or "").lower()
    if act in ("softmax", "logsoftmax", "log_softmax") \
            or not isinstance(w, ShardedTensor) or w.dim != out_dim:
        return False
    n = len(w.shards)
    return all(not isinstance(t, ShardedTensor)
               or (t.dim == 0 and len(t.shards) == n)
               for k, t in lp.items() if k != "W")


def tp_layer_fn(net, training: bool):
    """``net``'s per-layer forward on a :class:`ShardedTree`, with
    ``MultiLayerNetwork._apply_layer``'s signature: :func:`tp_apply_layer`.
    In training a layer's weight noise or a rematerialization policy would
    act on whole leaves; both are refused."""
    from ..nn.conf.builder import effective_remat_policy

    if training:
        noisy = [i for i, layer in enumerate(net.layers)
                 if layer.weight_noise is not None]
        if noisy:
            raise ValueError(f"tensor-parallel training forward: layers "
                             f"{noisy} have weight noise, which needs "
                             "whole leaves")
        pol = effective_remat_policy(net.conf.global_conf)
        if pol != "none":
            raise ValueError(f"tensor-parallel training forward: remat "
                             f"policy {pol!r} is not supported on sharded "
                             "leaves")

    def apply(i, lp, x, st, training, gen, fmask):
        return tp_apply_layer(net.layers[i], lp, x, st, training, gen, fmask)

    return apply


def tp_apply_layer(layer, lp, x: torch.Tensor, state, training: bool,
                   generator=None, fmask=None):
    """A layer's forward on a parameter tree with :class:`ShardedTensor`
    leaves: column-parallel where :func:`_column_parallel` allows (slot
    ``j`` applies the layer to its slices, a replicated bias sliced alike;
    the outputs joined along dimension 1 in slot order on ``x``'s device),
    otherwise on the gathered tree."""
    def run(p, xx):
        if fmask is not None:
            return layer.apply_masked(p, xx, state, training, fmask,
                                      generator=generator)
        return layer.apply(p, xx, state, training, generator=generator)

    def in_dtype(p):
        # a gathered or sliced leaf missed the compute-dtype cast of the
        # replicated ones: it takes the input's floating dtype
        if not x.is_floating_point():
            return p
        return _map_leaves(lambda v: v.to(x.dtype)
                           if v.is_floating_point() else v, p)

    if not _column_parallel(layer, lp):
        return run(in_dtype(_gathered(lp, x.device)), x)
    w = lp["W"]
    outs = []
    for j, wj in enumerate(w.shards):
        dev = wj.device
        n_out = wj.shape[w.dim]
        pj = {}
        for k, t in lp.items():
            if isinstance(t, ShardedTensor):
                pj[k] = t.shards[j]
            elif k == "b":
                pj[k] = t.narrow(0, j * n_out, n_out).to(dev)
            else:
                pj[k] = t.to(dev)
        y, _ = run(in_dtype(pj), x.to(dev))
        outs.append(y)
    from ._collectives import concat_to

    return concat_to(outs, 1, x.device), state


def unflatten_updater_state(state, params: Tree):
    """Flat updater state → dense tree mirroring ``params`` (identity for
    dense state)."""
    if not is_flat_state(state):
        return state
    return Zero1Plan(params, 1).unflatten_state(state)
