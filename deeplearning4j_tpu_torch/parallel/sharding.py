"""The flat per-dtype bucket layout behind the fused weight update.

Counterpart of the single-device part of ``Zero1Plan`` in
``deeplearning4j_tpu/parallel/sharding.py``: a parameter tree
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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..common.dtypes import dtype_name
from ..common.tree import get_path, leaf_paths, set_path, skeleton, sort_tree

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

    def __init__(self, params: Tree, n_shards: int = 1):
        self.paths = leaf_paths(params)
        self.skeleton = skeleton(params)
        self.n_shards = int(n_shards)
        self.n_leaves = len(self.paths)
        self.n_layers = len(groups(params))
        leaves = [get_path(params, p) for p in self.paths]
        by_dtype: Dict[str, List[int]] = {}
        for i, leaf in enumerate(leaves):
            by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
        self.buckets: List[_Bucket] = []
        for dt, idxs in sorted(by_dtype.items()):
            sizes = tuple(int(leaves[i].numel()) for i in idxs)
            total = sum(sizes)
            padded = -(-total // self.n_shards) * self.n_shards
            self.buckets.append(_Bucket(
                key=FLAT_PREFIX + dt, dtype=leaves[idxs[0]].dtype,
                leaf_idx=tuple(idxs), sizes=sizes,
                shapes=tuple(tuple(leaves[i].shape) for i in idxs),
                total=total, padded=padded, shard=padded // self.n_shards))

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


def _is_flat_dict(v) -> bool:
    return (isinstance(v, dict) and bool(v)
            and all(str(k).startswith(FLAT_PREFIX) for k in v))


def is_flat_state(state) -> bool:
    """True when ``state`` is in the flat-bucket layout (top-level values
    are dicts keyed ``flat::<dtype>``)."""
    if not isinstance(state, dict) or not state:
        return False
    return any(_is_flat_dict(v) for v in state.values())


def unflatten_updater_state(state, params: Tree):
    """Flat updater state → dense tree mirroring ``params`` (identity for
    dense state)."""
    if not is_flat_state(state):
        return state
    return Zero1Plan(params, 1).unflatten_state(state)
