"""Nested-dict parameter trees.

A network's parameters, layer states, gradients and updater-state slots are
nested dicts with tensor leaves: ``{node: {name: tensor}}``, one level
deeper where a wrapper layer keeps its inner layers' trees
(``Bidirectional``: ``{node: {"fwd": {...}, "bwd": {...}}}``). A leaf is
addressed by its key path; the leaf order is ``jax.tree.flatten``'s on the
JAX package's trees (keys sorted at every level), so flat vectors, flat
buckets and model zips hold the leaves in the JAX package's places.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

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
