"""TF frozen-GraphDef import -> SameDiff.

Counterpart of ``deeplearning4j_tpu/imports/tf_graph_mapper.py`` (reference
nd4j-api ``org/nd4j/imports/graphmapper/tf/TFGraphMapper.java``), with the
same design:

- **Table-driven**: one small mapper per TF op name (``@tf_op``), each
  emitting ops of the registry into a ``SameDiff`` graph.
- **Structural-argument folding**: nodes whose inputs are all static fold
  to numpy constants at import time (``_FOLDERS``, the JAX package's table
  entry for entry, so the same constants fold: the position table's slice
  folds, ``Sqrt(2.0)`` stays a runtime ``sqrt``), and ``Shape`` resolves by
  walking the partial graph on the ``meta`` device.
- **Lazy constants**: a Const becomes a graph constant (named
  ``<node>_<port>``) only when an op consumes it as a tensor; shapes, axes
  and permutations never enter the graph.

The GraphDef is read by the port's own wire-format reader
(``imports/graphdef.py``): neither TensorFlow nor ``protobuf`` is needed.

Ported so far: the TF ops of a frozen BERT encoder (AddV2/Add,
BatchMatMulV2, Cast, Const, Erf, GatherV2, Identity, MatMul, Mean, Mul,
Placeholder, RealDiv, Reshape, Rsqrt, Softmax, Sqrt, SquaredDifference,
StridedSlice, Sub, Tanh, Transpose) and the structural ops that fold. Any
other TF op raises :class:`UnsupportedTFOpError` naming it, as the JAX
importer does for ops it has no mapper for; the rest of the JAX mapper
table is queued in ROADMAP.md.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..autodiff.samediff import SameDiff, SDVariable, VariableType
from .graphdef import GraphDef, make_ndarray, np_dtype, parse_graph_def

_TF_OPS: Dict[str, Callable] = {}


class UnsupportedTFOpError(NotImplementedError):
    def __init__(self, op: str, node_name: str):
        super().__init__(
            f"TF op {op!r} (node {node_name!r}) has no mapper in the port "
            f"yet; register one with @tf_op({op!r}) in "
            f"deeplearning4j_tpu_torch/imports/tf_graph_mapper.py")
        self.op = op


def tf_op(*names: str):
    """Register a mapper for one or more TF op names (mapper(ctx) ->
    SDVariable | tuple[SDVariable, ...])."""

    def deco(fn):
        for n in names:
            _TF_OPS[n] = fn
        return fn

    return deco


def supported_tf_ops() -> List[str]:
    return sorted(_TF_OPS)


class _Ctx:
    """Per-node mapper context: typed attr access, resolved inputs, static
    values, and shape inference over the partially built graph."""

    def __init__(self, imp: "_Importer", node):
        self.imp = imp
        self.node = node
        self.sd = imp.sd
        self.name = node.name
        self.data_inputs = [i for i in node.input if not i.startswith("^")]

    # --- attrs ---------------------------------------------------------
    def attr(self, name: str, default=None):
        a = self.node.attr.get(name)
        if a is None or a.kind is None:
            return default
        kind, v = a.kind, a.value
        if kind in ("i", "f", "b"):
            return v
        if kind == "s":
            return v.decode()
        if kind == "type":
            return np_dtype(v)
        if kind == "shape":
            return [d if d >= 0 else None for d in v.dim]
        if kind == "list":
            for f in ("i", "f", "b", "s", "type"):
                vals = getattr(v, f)
                if len(vals):
                    if f == "s":
                        return [x.decode() for x in vals]
                    if f == "type":
                        return [np_dtype(x) for x in vals]
                    return list(vals)
            return []
        if kind == "tensor":
            return make_ndarray(v)
        return default

    # --- inputs --------------------------------------------------------
    def n_in(self) -> int:
        return len(self.data_inputs)

    def var(self, i: int) -> SDVariable:
        return self.imp.resolve_var(self.data_inputs[i])

    def vars(self, start: int = 0, end: Optional[int] = None
             ) -> List[SDVariable]:
        return [self.imp.resolve_var(t) for t in self.data_inputs[start:end]]

    def static(self, i: int) -> np.ndarray:
        """Static (import-time) value of input i: a constant or a folded
        subgraph (shapes, axes, permutations must be static)."""
        t = self.data_inputs[i]
        v = self.imp.static_value(t)
        if v is None:
            raise ValueError(
                f"input {i} ({t!r}) of node {self.name!r} ({self.node.op}) "
                "must be statically resolvable (constant/shape subgraph); "
                "dynamic values are not supported for structural arguments")
        return v

    def shape_of_input(self, i: int) -> Tuple[int, ...]:
        return self.imp.infer_shape(self.data_inputs[i])

    def emit(self, op_name: str, inputs: Sequence[Any], n_outputs=None, **kw):
        return self.sd._add_op(op_name, list(inputs), name=self.name,
                               n_outputs=n_outputs, **kw)


class _Importer:
    def __init__(self, graph_def: GraphDef,
                 input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                 device=None):
        self.gd = graph_def
        self.sd = SameDiff.create(device)
        self.input_shapes = dict(input_shapes or {})
        self._env: Dict[str, SDVariable] = {}       # tf tensor -> SDVariable
        self._static: Dict[str, np.ndarray] = {}    # tf tensor -> ndarray
        self._shape_cache: Dict[str, Tuple[int, ...]] = {}
        self.placeholders: List[str] = []
        self.outputs: List[str] = []

    # --- name plumbing --------------------------------------------------
    @staticmethod
    def _canon(tensor_name: str) -> str:
        return tensor_name if ":" in tensor_name else tensor_name + ":0"

    def _bind(self, node_name: str, outs) -> None:
        if isinstance(outs, SDVariable):
            outs = (outs,)
        for i, v in enumerate(outs):
            self._env[f"{node_name}:{i}"] = v

    def resolve_var(self, tensor_name: str) -> SDVariable:
        key = self._canon(tensor_name)
        if key in self._env:
            return self._env[key]
        # a folded static that was never materialized as a graph constant
        sval = self._static.get(key)
        if sval is not None:
            v = self.sd.constant(key.replace(":", "_"), sval)
            self._env[key] = v
            return v
        raise KeyError(f"unresolved TF tensor {tensor_name!r}")

    def static_value(self, tensor_name: str) -> Optional[np.ndarray]:
        return self._static.get(self._canon(tensor_name))

    def set_static(self, node_name: str, value: np.ndarray,
                   out_index: int = 0):
        self._static[f"{node_name}:{out_index}"] = np.asarray(value)

    # --- shape inference over the partial graph -------------------------
    def infer_shape(self, tensor_name: str,
                    assume_unknown: Optional[int] = None) -> Tuple[int, ...]:
        """Shape of a tensor in the partially built graph, from a walk of
        the graph on the ``meta`` device (shapes and dtypes only). With
        ``assume_unknown``, unknown placeholder dims are taken to be that
        value instead of raising."""
        key = self._canon(tensor_name)
        if assume_unknown is None and key in self._shape_cache:
            return self._shape_cache[key]
        var = self.resolve_var(key)
        vinfo = self.sd._vars[var.name]
        if vinfo.shape is not None and all(d is not None for d in vinfo.shape):
            shp = tuple(int(d) for d in vinfo.shape)
            self._shape_cache[key] = shp
            return shp
        meta = torch.device("meta")
        feeds = {n: torch.empty(v.value.shape, dtype=v.value.dtype,
                                device=meta)
                 for n, v in self.sd._vars.items()
                 if v.vtype in (VariableType.VARIABLE, VariableType.CONSTANT)}
        for n in self.sd.placeholders():
            pshape = self.sd._vars[n].shape
            if pshape is None or any(d is None for d in pshape):
                # unknown RANK can't be assumed away, only unknown dims
                if assume_unknown is None or pshape is None:
                    raise ValueError(
                        f"cannot infer shape of {tensor_name!r}: placeholder "
                        f"{n!r} has unknown dims; pass input_shapes={{...}} "
                        "to the importer")
                pshape = [assume_unknown if d is None else d for d in pshape]
            feeds[n] = torch.empty(tuple(pshape), device=meta, dtype=getattr(
                torch, np.dtype(self.sd._vars[n].dtype).name))
        with torch.inference_mode():
            out = self.sd._run((var.name,), feeds)[0]
        shp = tuple(int(d) for d in out.shape)
        if assume_unknown is None:
            self._shape_cache[key] = shp
        return shp

    # --- main loop ------------------------------------------------------
    def run(self) -> SameDiff:
        order = _topo_order(self.gd.node)
        consumed: Dict[str, int] = {}
        for node in self.gd.node:
            for t in node.input:
                if not t.startswith("^"):
                    consumed[self._canon(t)] = \
                        consumed.get(self._canon(t), 0) + 1

        for node in order:
            opn = node.op
            if opn in ("NoOp", "Assert", "CheckNumerics"):
                continue
            if opn == "Const":
                self.set_static(node.name, make_ndarray(
                    node.attr["value"].value))
                # materialized lazily in resolve_var only when consumed as a
                # tensor: structural consts never enter the graph
                continue
            if opn in ("Placeholder", "PlaceholderWithDefault"):
                self._import_placeholder(node)
                continue
            if opn == "IteratorGetNext":
                self._import_iterator_get_next(node)
                continue
            ctx = _Ctx(self, node)
            folder = _FOLDERS.get(opn)
            if folder is not None:
                statics = [self.static_value(t) for t in ctx.data_inputs]
                if all(s is not None for s in statics):
                    try:
                        res = folder(ctx, statics)
                    except Exception:  # the op maps instead of folding
                        res = None
                    if res is not None:
                        if not isinstance(res, (list, tuple)):
                            res = (res,)
                        for i, r in enumerate(res):
                            self.set_static(node.name, r, i)
                        continue
            if opn == "Shape":
                shp = self.infer_shape(ctx.data_inputs[0])
                self.set_static(node.name, np.asarray(
                    shp, dtype=ctx.attr("out_type", np.dtype(np.int32))))
                continue
            mapper = _TF_OPS.get(opn)
            if mapper is None:
                raise UnsupportedTFOpError(opn, node.name)
            outs = mapper(ctx)
            if outs is not None:
                self._bind(node.name, outs)

        # graph outputs: nodes NONE of whose output ports are consumed
        for node in self.gd.node:
            key = f"{node.name}:0"
            if key not in self._env:
                continue
            i, any_consumed = 0, False
            while f"{node.name}:{i}" in self._env:
                if consumed.get(f"{node.name}:{i}", 0):
                    any_consumed = True
                i += 1
            if not any_consumed:
                self.outputs.append(self._env[key].name)
        return self.sd

    def _import_placeholder(self, node) -> None:
        dtype = node.attr["dtype"].value
        shape = None
        if "shape" in node.attr:
            shape = [d if d >= 0 else None
                     for d in node.attr["shape"].value.dim]
        if node.name in self.input_shapes:
            shape = list(self.input_shapes[node.name])
        v = self.sd.placeholder(node.name, shape=shape,
                                dtype=np_dtype(dtype).name)
        self._bind(node.name, v)
        self.placeholders.append(v.name)

    def _import_iterator_get_next(self, node) -> None:
        """BERT-style input nodes: each output becomes a placeholder named
        <node>_i so the dataset binds positionally."""
        a = node.attr
        dtypes = [np_dtype(t) for t in a["output_types"].value.type] \
            if "output_types" in a else []
        shapes = [[d if d >= 0 else None for d in s.dim]
                  for s in a["output_shapes"].value.shape] \
            if "output_shapes" in a else []
        outs = []
        for i, dt in enumerate(dtypes):
            shape = shapes[i] if i < len(shapes) else None
            name = node.name if i == 0 else f"{node.name}_{i}"
            if name in self.input_shapes:
                shape = list(self.input_shapes[name])
            v = self.sd.placeholder(name, shape=shape, dtype=dt.name)
            self.placeholders.append(v.name)
            outs.append(v)
        self._bind(node.name, tuple(outs))


def _topo_order(nodes) -> List[Any]:
    """Kahn's algorithm, sources in GraphDef order (iterative: deep op
    chains would exhaust Python's recursion limit under a DFS)."""
    by_name = {n.name: n for n in nodes}
    indeg: Dict[str, int] = {}
    dependents: Dict[str, List[str]] = {}
    for n in nodes:
        deps = {t[1:] if t.startswith("^") else t.split(":")[0]
                for t in n.input}
        deps = [d for d in deps if d in by_name]
        indeg[n.name] = len(deps)
        for d in deps:
            dependents.setdefault(d, []).append(n.name)
    queue = deque(n.name for n in nodes if indeg[n.name] == 0)
    order: List[Any] = []
    while queue:
        nm = queue.popleft()
        order.append(by_name[nm])
        for m in dependents.get(nm, ()):
            indeg[m] -= 1
            if indeg[m] == 0:
                queue.append(m)
    if len(order) != len(nodes):
        stuck = [n for n, d in indeg.items() if d > 0][:5]
        raise ValueError(f"graph has a cycle (frozen graphs are acyclic); "
                         f"unresolved: {stuck}")
    return order


# --------------------------------------------------------------------------
# numpy folding of structural subgraphs (the JAX importer's table)


def _strided_slice_spec(ctx: _Ctx, begin, end, strides):
    begin = np.asarray(begin).tolist()
    end = np.asarray(end).tolist()
    strides = (np.asarray(strides).tolist() if strides is not None
               else [1] * len(begin))
    bm = ctx.attr("begin_mask", 0)
    em = ctx.attr("end_mask", 0)
    ellipsis = ctx.attr("ellipsis_mask", 0)
    new_axis = ctx.attr("new_axis_mask", 0)
    shrink = ctx.attr("shrink_axis_mask", 0)
    spec = []
    for i in range(len(begin)):
        if ellipsis & (1 << i):
            spec.append(Ellipsis)
        elif new_axis & (1 << i):
            spec.append(None)
        elif shrink & (1 << i):
            spec.append(int(begin[i]))
        else:
            b = None if bm & (1 << i) else int(begin[i])
            e = None if em & (1 << i) else int(end[i])
            spec.append(slice(b, e, int(strides[i])))
    return tuple(spec)


_FOLDERS: Dict[str, Callable] = {
    "Identity": lambda ctx, s: s[0],
    "Add": lambda ctx, s: s[0] + s[1],
    "AddV2": lambda ctx, s: s[0] + s[1],
    "Sub": lambda ctx, s: s[0] - s[1],
    "Mul": lambda ctx, s: s[0] * s[1],
    "RealDiv": lambda ctx, s: s[0] / s[1],
    "FloorDiv": lambda ctx, s: s[0] // s[1],
    "FloorMod": lambda ctx, s: np.mod(s[0], s[1]),
    "Maximum": lambda ctx, s: np.maximum(s[0], s[1]),
    "Minimum": lambda ctx, s: np.minimum(s[0], s[1]),
    "Neg": lambda ctx, s: -s[0],
    "Cast": lambda ctx, s: s[0].astype(np_dtype(ctx.node.attr["DstT"].value)),
    "Pack": lambda ctx, s: np.stack(s, axis=ctx.attr("axis", 0)),
    "Unpack": lambda ctx, s: [np.squeeze(a, ctx.attr("axis", 0)) for a in
                              np.split(s[0], s[0].shape[ctx.attr("axis", 0)],
                                       ctx.attr("axis", 0))],
    "ConcatV2": lambda ctx, s: np.concatenate(s[:-1], axis=int(s[-1])),
    "ExpandDims": lambda ctx, s: np.expand_dims(s[0], int(s[1])),
    "Squeeze": lambda ctx, s: np.squeeze(
        s[0], tuple(ctx.attr("squeeze_dims", []) or ctx.attr("axis", []))
        or None),
    "Reshape": lambda ctx, s: np.reshape(s[0], np.asarray(s[1]).tolist()),
    "Transpose": lambda ctx, s: np.transpose(s[0], np.asarray(s[1]).tolist()),
    "Div": lambda ctx, s: (np.trunc(np.divide(s[0], s[1])).astype(
        np.result_type(s[0], s[1])) if np.issubdtype(
            np.result_type(s[0], s[1]), np.integer) else s[0] / s[1]),
    # .item() (not int()) keeps float ranges exact
    "Range": lambda ctx, s: np.arange(
        np.asarray(s[0]).item(), np.asarray(s[1]).item(),
        np.asarray(s[2]).item()).astype(np.result_type(s[0], s[1], s[2])),
    "GatherV2": lambda ctx, s: np.take(s[0], s[1].astype(np.int64),
                                       axis=int(s[2]) if len(s) > 2 else 0),
    "StridedSlice": lambda ctx, s: s[0][_strided_slice_spec(ctx, s[1], s[2],
                                                            s[3])],
    "Slice": lambda ctx, s: s[0][tuple(
        slice(int(b), int(b) + int(sz) if int(sz) >= 0 else None)
        for b, sz in zip(np.asarray(s[1]).tolist(),
                         np.asarray(s[2]).tolist()))],
    "Prod": lambda ctx, s: np.prod(s[0], axis=tuple(
        np.atleast_1d(s[1]).tolist()) if len(s) > 1 else None,
        keepdims=ctx.attr("keep_dims", False)),
    "Sum": lambda ctx, s: np.sum(s[0], axis=tuple(
        np.atleast_1d(s[1]).tolist()) if len(s) > 1 else None,
        keepdims=ctx.attr("keep_dims", False)),
    "Fill": lambda ctx, s: np.full(np.asarray(s[0]).tolist(), s[1]),
    "ZerosLike": lambda ctx, s: np.zeros_like(s[0]),
    "OnesLike": lambda ctx, s: np.ones_like(s[0]),
    # a STATIC condition folds to a constant coordinate list
    "Where": lambda ctx, s: (np.argwhere(s[0]).astype(np.int64)
                             if len(s) == 1 else None),
}


# --------------------------------------------------------------------------
# mappers


def _binary(op_name):
    def m(ctx: _Ctx):
        return ctx.emit(op_name, [ctx.var(0), ctx.var(1)])

    return m


_BINARY = {"Add": "add", "AddV2": "add", "Sub": "subtract",
           "Mul": "multiply", "RealDiv": "divide",
           "SquaredDifference": "squaredsubtract"}
for _tf_name, _our in _BINARY.items():
    tf_op(_tf_name)(_binary(_our))


def _unary(op_name):
    def m(ctx: _Ctx):
        return ctx.emit(op_name, [ctx.var(0)])

    return m


_UNARY = {"Sqrt": "sqrt", "Rsqrt": "rsqrt", "Tanh": "tanh", "Erf": "erf"}
for _tf_name, _our in _UNARY.items():
    tf_op(_tf_name)(_unary(_our))


@tf_op("Identity", "StopGradient", "PreventGradient", "Snapshot",
       "EnsureShape")
def _identity(ctx):
    return ctx.emit("identity", [ctx.var(0)])


@tf_op("Cast")
def _cast(ctx):
    dst = np_dtype(ctx.node.attr["DstT"].value)
    return ctx.emit("cast", [ctx.var(0)], dtype=dst.name)


_REDUCE = {"Mean": "reduce_mean"}


def _reduction(op_name):
    def m(ctx: _Ctx):
        if ctx.n_in() > 1:
            # structural arg: must resolve statically (an all-axes
            # reduction in its place would give wrong shapes silently)
            dims = tuple(np.atleast_1d(ctx.static(1)).tolist())
        else:
            dims = None
        return ctx.emit(op_name, [ctx.var(0)], dims=dims,
                        keep_dims=ctx.attr("keep_dims", False))

    return m


for _tf_name, _our in _REDUCE.items():
    tf_op(_tf_name)(_reduction(_our))


@tf_op("Reshape")
def _reshape(ctx):
    shape = np.asarray(ctx.static(1)).tolist()
    if any(d == -1 for d in shape):
        in_shape = ctx.shape_of_input(0)
        known = int(np.prod([d for d in shape if d != -1]))
        total = int(np.prod(in_shape))
        shape = [total // max(known, 1) if d == -1 else d for d in shape]
    return ctx.emit("reshape", [ctx.var(0), tuple(int(d) for d in shape)])


@tf_op("Transpose")
def _transpose(ctx):
    perm = tuple(int(d) for d in np.asarray(ctx.static(1)).tolist())
    return ctx.emit("permute", [ctx.var(0), perm])


def _encode_slice_spec(spec) -> List[List]:
    """numpy index spec -> JSON-safe encoding (the op's ``spec``)."""
    out: List[List] = []
    for s in spec:
        if isinstance(s, slice):
            out.append(["slice", s.start, s.stop, s.step])
        elif s is None:
            out.append(["newaxis"])
        elif s is Ellipsis:
            out.append(["ellipsis"])
        else:
            out.append(["idx", int(s)])
    return out


@tf_op("StridedSlice")
def _strided_slice(ctx):
    spec = _strided_slice_spec(ctx, ctx.static(1), ctx.static(2),
                               ctx.static(3))
    return ctx.sd._add_op("tf_strided_slice", [ctx.var(0)], name=ctx.name,
                          spec=_encode_slice_spec(spec))


@tf_op("GatherV2", "Gather")
def _gather(ctx):
    if ctx.attr("batch_dims", 0):
        raise UnsupportedTFOpError("GatherV2(batch_dims>0)", ctx.name)
    axis = int(ctx.static(2)) if ctx.n_in() > 2 else 0
    return ctx.emit("gather", [ctx.var(0), ctx.var(1)], axis=axis)


@tf_op("MatMul")
def _matmul(ctx):
    return ctx.emit("matmul", [ctx.var(0), ctx.var(1)],
                    transpose_x=ctx.attr("transpose_a", False),
                    transpose_y=ctx.attr("transpose_b", False))


@tf_op("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(ctx):
    return ctx.emit("batched_gemm", [ctx.var(0), ctx.var(1)],
                    transpose_x=ctx.attr("adj_x", False),
                    transpose_y=ctx.attr("adj_y", False))


@tf_op("Softmax")
def _softmax(ctx):
    return ctx.emit("softmax", [ctx.var(0)], axis=-1)


# --------------------------------------------------------------------------
# public API


class TFGraphMapper:
    """Reference-shaped entry (``TFGraphMapper.importGraph``)."""

    @staticmethod
    def import_graph(graph, input_shapes: Optional[Dict[str, Sequence[int]]]
                     = None, device=None) -> SameDiff:
        gd = _as_graph_def(graph)
        imp = _Importer(gd, input_shapes, device)
        sd = imp.run()
        sd.tf_placeholders = list(imp.placeholders)
        sd.tf_outputs = list(imp.outputs)
        return sd

    importGraph = import_graph


def import_frozen_tf(path_or_graphdef,
                     input_shapes: Optional[Dict[str, Sequence[int]]] = None,
                     device=None) -> SameDiff:
    """Reference ``SameDiff.importFrozenTF``: a frozen GraphDef (a ``.pb``
    path, its bytes, or an object with ``SerializeToString``) -> a SameDiff
    graph whose values live on ``device``: the card unless the caller asks
    for another (``device="cpu"``)."""
    return TFGraphMapper.import_graph(path_or_graphdef, input_shapes, device)


def _as_graph_def(graph) -> GraphDef:
    if isinstance(graph, GraphDef):
        return graph
    if isinstance(graph, str):
        with open(graph, "rb") as f:
            return parse_graph_def(f.read())
    if isinstance(graph, (bytes, bytearray, memoryview)):
        return parse_graph_def(graph)
    if hasattr(graph, "SerializeToString"):
        return parse_graph_def(graph.SerializeToString())
    raise TypeError(f"cannot interpret {type(graph)} as a GraphDef")
