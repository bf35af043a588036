"""Every public name of the JAX package has a counterpart in the port.

Both trees are read with ``ast``; neither package is imported, so this runs
in well under a second. A public name is one without a leading underscore:

- a module's classes, functions and assigned names (constants, aliases),
  also those defined under a module-level ``if`` or ``try``;
- a class's methods, its class-level attributes (enum members, dataclass
  fields), its nested classes (``Builder``) and their members.

A JAX module file's counterpart is the port's file at the same path, or the
one :data:`MODULES` names. A name counts as present there when the port's
module defines or imports it; a class member when the port's class, or a
base class of it found anywhere in the port, defines it, sets it as
``self.<name>`` in a method (or by ``setattr(self, ...)`` over a class-level
tuple of names), or declares it in its body. :data:`MOVED` maps
a name the port keeps in another module; :data:`JAX_ONLY` lists the names
that have no counterpart, each with the reason. There is one case per JAX
module file, and a gap that neither list names fails it.
"""

from __future__ import annotations

import ast
import functools
from pathlib import Path
from typing import Dict, Set, Tuple

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "deeplearning4j_tpu"
PORT = ROOT / "deeplearning4j_tpu_torch"

#: JAX module file -> the port's file that holds its counterparts
MODULES = {
    "ops/pallas_attention.py": "ops/attention.py",
    "ops/pallas_epilogue.py": "ops/epilogue.py",
    "ops/pallas_update.py": "ops/update.py",
    "imports/onnx_ir_pb2.py": "imports/onnx_ir.py",
}

#: "module:name" of the JAX package -> "module:name" of its counterpart
MOVED = {
    "parallel/sharding.py:Zero1Plan.treedef":
        "parallel/sharding.py:Zero1Plan.skeleton",
    "imports/onnx_import.py:numpy_to_tensor":
        "imports/onnx_ir.py:numpy_to_tensor",
    "imports/onnx_import.py:tensor_to_numpy":
        "imports/onnx_ir.py:tensor_to_numpy",
}

_TILE = ("a Pallas block shape of the TPU kernel; the CUDA kernel plans its "
         "own grid")
_PYTREE = ("a typing alias for JAX pytrees; the port's trees are "
           "common/tree.Tree")
_SHARDING = ("builds a jax.sharding.NamedSharding; the port places tensors "
             "on the devices of its pool (parallel/mesh.py)")

#: "module:name" of the JAX package -> why the port has no counterpart
JAX_ONLY = {
    "ops/pallas_update.py:BLOCK_ROWS": _TILE,
    "ops/pallas_update.py:LANES": _TILE,
    "ops/pallas_epilogue.py:BLOCK_ROWS": _TILE,
    "ops/pallas_update.py:default_mode":
        "picks the TPU kernel, interpret or xla mode by backend; the port "
        "routes by the tensor's device and dtype (ops/routing.py)",
    "imports/onnx_ir_pb2.py:DESCRIPTOR":
        "protobuf's generated descriptor; imports/onnx_ir.py reads and "
        "writes the wire format itself",
    "parallel/mesh.py:replicated": _SHARDING,
    "parallel/mesh.py:data_sharded": _SHARDING,
    "ndarray/rng.py:Random.next_key":
        "splits a threefry key; the port's Random draws from a "
        "torch.Generator",
    "learning/precision.py:random_bits_for":
        "folds a leaf's path into a threefry key; the port's random_bits "
        "draws a bucket's bits from the network's torch.Generator",
    "learning/precision.py:SR_STREAM_TAG":
        "the threefry fold tag of the stochastic-rounding stream; the port "
        "has no key to fold",
    "learning/precision.py:Pytree": _PYTREE,
    "learning/updaters.py:Pytree": _PYTREE,
    "parallel/sharding.py:Zero1Plan.unflatten_diff":
        "a jax.custom_vjp that spells out unflatten's adjoint for XLA; "
        "autograd through the port's unflatten (slices and views) needs "
        "no such form",
    "ops/embeddings.py:DENSE_UPDATE_MAX_ROWS":
        "the vocabulary size under which the jitted round updates a dense "
        "table (0: never); the port's rounds scatter rows on the card",
    "data/pipeline.py:note_dispatch":
        "unpacks the 4- or 5-tuple that a jitted step returns; the port's "
        "steps set the holder's state themselves",
    "data/pipeline.py:unstack_aux":
        "splits the [K, ...] aux of a lax.scan chunk; the port runs a "
        "chunk's steps one by one",
    "data/pipeline.py:timed_iter":
        "times each next() of the jitted fit's feed; the port's fit loop "
        "times no per-batch wait (the overlap ledger's dispatch half comes "
        "from the wrapper, fleet and pipeline fits)",
}

Members = Dict[str, Set[str]]


class _Module:
    """The public surface of one module file: the names it defines and
    those it imports, and for each class (nested ones as ``Outer.Inner``)
    its members and bases."""

    def __init__(self, path: Path):
        tree = ast.parse(path.read_text(), str(path))
        self.defined: Set[str] = set()
        self.imported: Set[str] = set()
        self.classes: Members = {}
        self.bases: Dict[str, Tuple[str, ...]] = {}
        for node in _top_level(tree.body):
            if isinstance(node, ast.ClassDef):
                self.defined.add(node.name)
                self._class(node, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defined.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                self.imported.update((a.asname or a.name).split(".")[0]
                                     for a in node.names)
            else:
                self.defined.update(_assigned(node))

    def _class(self, node: ast.ClassDef, qual: str) -> None:
        members: Set[str] = set()
        names: Set[str] = set()     # class-level tuples of attribute names
        sets_by_name = False        # setattr(self, ...) in a method
        for b in node.body:
            if isinstance(b, ast.ClassDef):
                members.add(b.name)
                self._class(b, f"{qual}.{b.name}")
            elif isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                members.add(b.name)
                for n in ast.walk(b):
                    if (isinstance(n, ast.Attribute)
                            and isinstance(n.ctx, ast.Store)
                            and _is_self(n.value)):
                        members.add(n.attr)
                    elif (isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)
                          and n.func.id == "setattr" and n.args
                          and _is_self(n.args[0])):
                        sets_by_name = True
            else:
                members.update(_assigned(b))
                if isinstance(getattr(b, "value", None), (ast.Tuple,
                                                          ast.List)):
                    names.update(e.value for e in b.value.elts
                                 if isinstance(e, ast.Constant)
                                 and isinstance(e.value, str))
        if sets_by_name:
            members |= names
        self.classes[qual] = members
        self.bases[qual] = tuple(ast.unparse(x).split(".")[-1]
                                 for x in node.bases)


def _is_self(node) -> bool:
    return isinstance(node, ast.Name) and node.id == "self"


def _top_level(body):
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_level(node.body)
            yield from _top_level(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *(h.body for h in node.handlers)):
                yield from _top_level(part)
        else:
            yield node


def _assigned(node) -> Set[str]:
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        targets = [node.target]
    return {n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)}


@functools.lru_cache(maxsize=None)
def _tree(root: Path) -> Dict[str, _Module]:
    return {str(p.relative_to(root)): _Module(p)
            for p in sorted(root.rglob("*.py"))
            if "_build" not in p.parts}


@functools.lru_cache(maxsize=None)
def _port_classes() -> Dict[str, list]:
    """Every class of the port by its (last) name, for base resolution."""
    out: Dict[str, list] = {}
    for mod in _tree(PORT).values():
        for qual, members in mod.classes.items():
            out.setdefault(qual.split(".")[-1], []).append(
                (members, mod.bases[qual]))
    return out


def _port_members(mod: _Module, qual: str) -> Set[str]:
    """``qual``'s members in the port module, with those its bases give."""
    members = set(mod.classes.get(qual, ()))
    todo = list(mod.bases.get(qual, ()))
    seen: Set[str] = set()
    while todo:
        base = todo.pop()
        if base in seen:
            continue
        seen.add(base)
        for m, bases in _port_classes().get(base, ()):
            members |= m
            todo.extend(bases)
    return members


def _public(name: str) -> bool:
    return not name.startswith("_")


def _in_port(port_rel: str, name: str) -> bool:
    """Whether the port's module ``port_rel`` has ``name`` (``Class.member``
    for a member)."""
    mod = _tree(PORT).get(port_rel)
    if mod is None:
        return False
    qual, _, member = name.rpartition(".")
    if not qual:
        return name in mod.defined or name in mod.imported
    return qual in mod.classes and member in _port_members(mod, qual)


def _jax_names(jax_rel: str) -> list:
    """Every public name of a JAX module file, as ``module:name``."""
    jmod = _tree(JAX)[jax_rel]
    out = [f"{jax_rel}:{n}" for n in sorted(jmod.defined) if _public(n)]
    for qual in sorted(jmod.classes):
        if all(_public(p) for p in qual.split(".")):
            out += [f"{jax_rel}:{qual}.{m}"
                    for m in sorted(jmod.classes[qual]) if _public(m)]
    return out


def _has_counterpart(key: str) -> bool:
    rel, name = MOVED.get(key, key).split(":")
    return _in_port(MODULES.get(rel, rel), name)


def gaps(jax_rel: str) -> list:
    """The public names of a JAX module file with no counterpart in the
    port and no entry in :data:`JAX_ONLY`."""
    return [k for k in _jax_names(jax_rel)
            if k not in JAX_ONLY and not _has_counterpart(k)]


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("jax_rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(jax_rel):
    missing = gaps(jax_rel)
    assert not missing, (
        f"public names of deeplearning4j_tpu/{jax_rel} with no counterpart "
        f"in the port (port them, or list them in MOVED or JAX_ONLY with a "
        f"reason): {missing}")


def test_the_lists_name_real_jax_names_and_give_reasons():
    """Every entry of MOVED and JAX_ONLY is a public name of the JAX
    package; a JAX_ONLY name is not in the port (a stale entry would hide
    a later regression) and has a reason; a MOVED target exists."""
    every = {k for rel in JAX_MODULES for k in _jax_names(rel)}
    for key in [*MOVED, *JAX_ONLY]:
        assert key in every, f"{key} is not a public JAX name"
    for key in JAX_ONLY:
        rel, name = key.split(":")
        assert not _in_port(MODULES.get(rel, rel), name), \
            f"{key} has a counterpart in the port: drop its entry"
    for key, target in MOVED.items():
        assert _in_port(*target.split(":")), f"{key} -> {target} is missing"
    assert all(len(why.split()) >= 5 for why in JAX_ONLY.values())
