"""Nested-dict parameter trees.

A network's parameters, layer states, gradients and updater-state slots are
nested dicts with tensor leaves: ``{node: {name: tensor}}``, one level
deeper where a wrapper layer keeps its inner layers' trees
(``Bidirectional``: ``{node: {"fwd": {...}, "bwd": {...}}}``). A leaf is
addressed by its key path; the leaf order is ``jax.tree.flatten``'s on the
JAX package's trees (keys sorted at every level), so flat vectors, flat
buckets and model zips hold the leaves in the JAX package's places.

A leaf may be a :class:`ShardedTensor`, a tensor held as per-slot pieces:
a tensor-parallel leaf (``parallel/sharding.apply_tp``, whose result is a
:class:`ShardedTree`) or a row-sharded table (a table under a model axis,
``Word2Vec(mesh=)``, ``parallel/sharded_embeddings.ShardedEmbedding``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Path = Tuple[str, ...]


def leaf_paths(tree: Dict[str, Any]) -> List[Path]:
    """The key path of every leaf, in ``jax.tree.flatten`` order. Empty
    dicts hold no leaf."""
    out: List[Path] = []

    def walk(node, prefix):
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out.append(prefix + (k,))

    walk(tree, ())
    return out


def get_path(tree: Dict[str, Any], path: Path):
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: Dict[str, Any], path: Path, value) -> None:
    """Set the leaf at ``path``, making the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_map(fn: Callable, *trees):
    """``fn`` over matching leaves of trees shaped like the first."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def skeleton(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The dicts of ``tree`` without its leaves (empty nodes kept), to be
    filled with :func:`set_path`."""
    return {k: skeleton(v) for k, v in tree.items() if isinstance(v, dict)}


def sort_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with the keys of every dict in sorted order."""
    return {k: (sort_tree(tree[k]) if isinstance(tree[k], dict) else tree[k])
            for k in sorted(tree)}


class ShardedTensor:
    """A tensor split along ``dim`` into per-slot ``shards`` (slot order),
    each on its slot's device; ``spec`` is the placement's
    ``PartitionSpec`` where one made it."""

    def __init__(self, shards: Sequence[torch.Tensor], dim: int = 0,
                 spec=None):
        self.shards, self.dim, self.spec = list(shards), int(dim), spec

    @classmethod
    def split(cls, t: torch.Tensor, devices, dim: int = 0,
              pad: bool = False, spec=None) -> "ShardedTensor":
        """``t`` cut along ``dim`` into ``len(devices)`` equal shards, shard
        ``j`` a copy on ``devices[j]``. ``pad``: ``t`` zero-padded along
        ``dim`` to a multiple of the count first (else the count must
        divide it)."""
        n = len(devices)
        size = t.shape[dim]
        if pad and size % n:
            shape = list(t.shape)
            shape[dim] = n - size % n
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
            size = t.shape[dim]
        if size % n:
            raise ValueError(f"{size} along dim {dim} does not split into "
                             f"{n} shards")
        step = size // n
        return cls([t.narrow(dim, j * step, step).to(d, copy=True)
                    for j, d in enumerate(devices)], dim, spec)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.dim] = sum(t.shape[self.dim] for t in self.shards)
        return torch.Size(s)

    @property
    def _version(self) -> int:
        # the compute-dtype cast cache keys on its leaves' versions
        return sum(t._version for t in self.shards)

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor: the shards concatenated in slot order on
        ``device`` (default the first shard's), the ``all_gather``."""
        from ..parallel._collectives import concat_to

        return concat_to(self.shards, self.dim, device)

    def sumsq(self, device) -> torch.Tensor:
        """The sum of squares of every element on ``device``, shard by
        shard in slot order."""
        return self._sum(torch.square, device)

    def sumabs(self, device) -> torch.Tensor:
        return self._sum(torch.abs, device)

    def _sum(self, fn, device) -> torch.Tensor:
        out: Optional[torch.Tensor] = None
        for t in self.shards:
            v = torch.sum(fn(t)).to(device)
            out = v if out is None else out + v
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, dim={self.dim}, "
                f"{len(self.shards)} shards)")


class ShardedTree(dict):
    """A parameter tree with :class:`ShardedTensor` leaves from
    ``parallel/sharding.apply_tp``: a network's forward on it runs
    tensor-parallel (the type is the flag, so a plain tree is never
    walked for sharded leaves)."""
