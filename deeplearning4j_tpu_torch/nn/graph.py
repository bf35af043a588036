"""ComputationGraph — named-vertex DAG models (ResNet-50 et al).

Counterpart of ``deeplearning4j_tpu/nn/graph.py``: the same configuration
objects (``GraphBuilder``, ``ComputationGraphConfiguration`` with
``set_input_types`` and ``to_json``/``from_json`` in the JAX package's
format), the same vertices (Merge, ElementWise, DotProduct, Subset, Scale,
Shift, L2Normalize, Stack, Unstack, Reshape), the same node names and
parameter layouts, and the same walk. Inference collapses the resnet block
tail ``BN(identity) → add → relu`` into one kernel launch (the
fused-epilogue plan, with its dense replay when the gate refuses). PyTorch
runs the walk eagerly, node by node; there is no trace to cache.

Training runs one step per batch: the forward with batch statistics (no
fusion plan), the loss heads in float32 under ``compute_dtype`` (an
``OutputLayer`` or ``LossLayer`` scored by its ``loss`` alone, as the JAX
graph scores it, so a ``CenterLossOutputLayer``'s centers take no gradient
here; a ``Yolo2OutputLayer`` by its own ``compute_score``, where the JAX
graph cannot bind its labels), l1/l2
regularisation (not on ``b``/``beta``), backward through autograd, the
gradient normalization the configuration names (``nn/gradnorm.py``), then
the updater (``nn/_train.TrainableNetwork._train_step``). With
``GlobalConf.fused_update`` the parameters live in flat per-dtype buckets
(``nn/_fused.FlatStore``), the gradients are born in a flat bucket, and the
update is one launch of the ``csrc/fused_update.cu`` kernel per float32
bucket; otherwise the per-leaf ``learning.precision.apply_updater`` runs.
Random bits for dropout and for stochastic rounding come from the graph's
own ``torch.Generator``.

``fit`` has the JAX signature (``graph.py:853``). A ``DataSet`` or a
``MultiDataSet`` without ``batch_size`` takes one unpadded step
(``bench.py``'s loop); anything else goes through the input pipeline
(``data/pipeline.py``, shared with ``MultiLayerNetwork``): shape-stable
batches whose padded rows carry example weight 0 in every output's loss,
``prefetch`` batches placed ahead, ``steps_per_dispatch``. Listeners
(``set_listeners``) hear of every step; ``CheckpointListener`` writes
checkpoints that ``fit(resume_from=)`` continues bitwise
(``util/checkpoint.py``), and ``save``/``load`` write and read the JAX
package's model zip (``util/model_serializer.py``). ``host_prefetch=N``
assembles the batches on a worker thread through an N-deep queue; the
telemetry listeners (``TelemetrySink``, ``NanSentinelListener``) turn on
the in-step aux and the NaN guard (``nn/_train.TrainableNetwork._step``).

Rematerialization: in training each layer node's forward runs under the
configured policy (``GlobalConf.remat_policy`` or the legacy
``gradient_checkpointing``; ``set_remat_policy``), through
``conf.builder.remat_wrap`` with the node's name as its identity for a
selective list, as the JAX graph wraps each vertex in ``jax.checkpoint``
(``graph.py:606-614``).

``ComputationGraph.init`` places parameters on the card unless the caller
asks for another device (``device="cpu"``); so does ``load``. ``output``
takes one array per network input (or a dict by name) and returns a list of
tensors, one per network output. Under ``compute_dtype`` only floating
inputs are cast, so integer inputs (token ids, positions) stay integers.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..common.dtypes import torch_dtype
from ..common.environment import resolve_device
from ..common.tree import get_path, leaf_paths
from ..data import pipeline as _pipe
from ..data.dataset import DataSet, MultiDataSet
from ..learning.precision import cast_floating
from ..ops.epilogue import bn_act
from ._fused import FlatStore
from ._train import TrainableNetwork
from .conf import layers as L
from .conf.builder import (_CLASSES, GlobalConf, _check_policy,
                           _deser_obj, _ser_obj, apply_layer_defaults,
                           remat_wrap)
from .conf.inputs import (CNNFlatInput, CNNInput, FFInput, InputType,
                          RNNInput, cnn_to_ff, flat_to_cnn)
from .multilayer import _fold_weights


# --- graph vertices -----------------------------------------------------------


@dataclass
class GraphVertex:
    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def apply(self, *inputs):
        raise NotImplementedError


@dataclass
class MergeVertex(GraphVertex):
    """Concat along the feature/channel dim."""

    def output_type(self, *ts):
        t0 = ts[0]
        if isinstance(t0, CNNInput):
            return CNNInput(sum(t.channels for t in ts), t0.height, t0.width)
        if isinstance(t0, FFInput):
            return FFInput(sum(t.size for t in ts))
        if isinstance(t0, RNNInput):
            return RNNInput(sum(t.size for t in ts), t0.timesteps)
        raise ValueError(f"cannot merge {ts}")

    def apply(self, *inputs):
        return torch.cat(inputs, dim=1 if inputs[0].ndim == 4 else -1)


@dataclass
class ElementWiseVertex(GraphVertex):
    """Add/Subtract/Product/Average/Max/Min."""

    op: str = "add"

    def apply(self, *inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for v in inputs[1:]:
                out = out + v
            return out
        if op == "subtract":
            if len(inputs) != 2:
                raise ValueError(f"ElementWiseVertex(subtract) needs exactly "
                                 f"2 inputs, got {len(inputs)}")
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            out = inputs[0]
            for v in inputs[1:]:
                out = out * v
            return out
        if op in ("average", "avg"):
            return sum(inputs) / len(inputs)
        if op == "max":
            out = inputs[0]
            for v in inputs[1:]:
                out = torch.maximum(out, v)
            return out
        if op == "min":
            out = inputs[0]
            for v in inputs[1:]:
                out = torch.minimum(out, v)
            return out
        raise ValueError(f"unknown elementwise op {self.op!r}")


@dataclass
class DotProductVertex(GraphVertex):
    """Batched dot product of two FF inputs over the feature axis,
    optionally L2-normalized first (cosine proximity); output ``[B, 1]``."""

    normalize: bool = False

    def output_type(self, *ts):
        if len(ts) != 2 or not all(isinstance(t, FFInput) for t in ts):
            raise ValueError("DotProductVertex needs two FF inputs")
        if ts[0].size != ts[1].size:
            raise ValueError(f"DotProductVertex inputs differ: {ts[0].size} "
                             f"vs {ts[1].size}")
        return FFInput(1)

    def apply(self, a, b):
        if self.normalize:
            a = a / torch.clamp_min(_l2(a, (-1,)), 1e-12)
            b = b / torch.clamp_min(_l2(b, (-1,)), 1e-12)
        return torch.sum(a * b, dim=-1, keepdim=True)


@dataclass
class SubsetVertex(GraphVertex):
    """Feature-dim slice ``[from_idx, to_idx]``, inclusive."""

    from_idx: int = 0
    to_idx: int = 0

    def output_type(self, *ts):
        n = self.to_idx - self.from_idx + 1
        t = ts[0]
        if isinstance(t, FFInput):
            return FFInput(n)
        if isinstance(t, CNNInput):
            return CNNInput(n, t.height, t.width)
        if isinstance(t, RNNInput):
            return RNNInput(n, t.timesteps)
        raise ValueError(f"subset of {t}")

    def apply(self, *inputs):
        x = inputs[0]
        sl = slice(self.from_idx, self.to_idx + 1)
        return x[:, sl] if x.ndim == 4 else x[..., sl]


@dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, *inputs):
        return inputs[0] * self.scale


@dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, *inputs):
        return inputs[0] + self.shift


@dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def apply(self, *inputs):
        x = inputs[0]
        return x / torch.clamp_min(_l2(x, tuple(range(1, x.ndim))), self.eps)


@dataclass
class StackVertex(GraphVertex):
    """Stack along the batch dim."""

    def apply(self, *inputs):
        return torch.cat(inputs, dim=0)


@dataclass
class UnstackVertex(GraphVertex):
    from_idx: int = 0
    stack_size: int = 1

    def apply(self, *inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]


@dataclass
class ReshapeVertex(GraphVertex):
    shape: Tuple[int, ...] = ()

    def apply(self, *inputs):
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))


def _l2(x: torch.Tensor, dims) -> torch.Tensor:
    """``sqrt(sum(x * x))`` over ``dims``, kept (``jnp.linalg.norm``'s and
    the JAX vertex's spelling)."""
    return torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))


# the vertices take part in the configuration JSON as the layers do: the
# JAX package's list (graph.py:201-203), which leaves DotProductVertex out
for _v in (GraphVertex, MergeVertex, ElementWiseVertex, SubsetVertex,
           ScaleVertex, ShiftVertex, L2NormalizeVertex, StackVertex,
           UnstackVertex, ReshapeVertex):
    _CLASSES[_v.__name__] = _v


# --- graph node wiring ----------------------------------------------------------


@dataclass
class _Node:
    name: str
    kind: str                       # "input" | "layer" | "vertex"
    layer: Optional[L.Layer] = None
    vertex: Optional[GraphVertex] = None
    inputs: List[str] = field(default_factory=list)
    preprocessors: Dict[int, Any] = field(default_factory=dict)


class ComputationGraphConfiguration:
    def __init__(self, global_conf: GlobalConf):
        self.global_conf = global_conf
        self.network_inputs: List[str] = []
        self.network_outputs: List[str] = []
        self.nodes: Dict[str, _Node] = {}
        self.order: List[str] = []
        self.input_types: Dict[str, InputType] = {}
        self.node_output_types: Dict[str, InputType] = {}

    @staticmethod
    def graph_builder(builder=None) -> "GraphBuilder":
        return GraphBuilder(builder._conf if builder is not None
                            else GlobalConf())

    def set_input_types(self, *types: InputType) -> None:
        if len(types) != len(self.network_inputs):
            raise ValueError("one InputType per network input")
        self.input_types = dict(zip(self.network_inputs, types))
        self.node_output_types = {}
        for name in self.order:
            node = self.nodes[name]
            if node.kind == "input":
                t = self.input_types[name]
                if isinstance(t, CNNFlatInput):
                    node.preprocessors[0] = flat_to_cnn(t)
                    t = node.preprocessors[0].out_type
                self.node_output_types[name] = t
                continue
            in_types = [self.node_output_types[i] for i in node.inputs]
            if node.kind == "vertex":
                self.node_output_types[name] = \
                    node.vertex.output_type(*in_types)
                continue
            # CNN → FF adapter where a conv output feeds a dense layer
            t = in_types[0]
            if isinstance(t, CNNInput) and isinstance(node.layer, L.FF_LIKE) \
                    and not isinstance(node.layer, L.RnnOutputLayer):
                node.preprocessors[0] = cnn_to_ff(t)
                t = node.preprocessors[0].out_type
            self.node_output_types[name] = node.layer.set_input_type(t)


    # --- serde ------------------------------------------------------------
    def to_json(self) -> str:
        """The JAX package's format (``format_version`` 1), so a graph
        configuration written by one package reads in the other."""
        return json.dumps({
            "format_version": 1,
            "global": _ser_obj(self.global_conf),
            "inputs": self.network_inputs,
            "outputs": self.network_outputs,
            "order": self.order,
            "nodes": [
                {"name": n.name, "kind": n.kind,
                 "layer": _ser_obj(n.layer) if n.layer else None,
                 "vertex": _ser_obj(n.vertex) if n.vertex else None,
                 "inputs": n.inputs}
                for n in (self.nodes[nm] for nm in self.order)],
            "input_types": {k: _ser_obj(v)
                            for k, v in self.input_types.items()},
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        """Read :meth:`to_json`'s format; a field the port lacks reads only
        when it is inert (``nn/conf/builder._deser_obj``)."""
        d = json.loads(s)
        conf = ComputationGraphConfiguration(_deser_obj(d["global"]))
        conf.network_inputs = d["inputs"]
        conf.network_outputs = d["outputs"]
        for nd in d["nodes"]:
            node = _Node(nd["name"], nd["kind"],
                         _deser_obj(nd["layer"]) if nd["layer"] else None,
                         _deser_obj(nd["vertex"]) if nd["vertex"] else None,
                         nd["inputs"])
            conf.nodes[node.name] = node
            conf.order.append(node.name)
        if d.get("input_types"):
            conf.set_input_types(*[_deser_obj(v)
                                   for v in d["input_types"].values()])
        return conf


class GraphBuilder:
    def __init__(self, global_conf: GlobalConf):
        self._conf = ComputationGraphConfiguration(global_conf)
        self._pending_types: Sequence[InputType] = ()

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            self._conf.network_inputs.append(n)
            self._conf.nodes[n] = _Node(n, "input")
            self._conf.order.append(n)
        return self

    addInputs = add_inputs

    def add_layer(self, name: str, layer: L.Layer,
                  *inputs: str) -> "GraphBuilder":
        self._check_inputs(name, inputs)
        layer.name = name
        apply_layer_defaults(layer, self._conf.global_conf)
        self._conf.nodes[name] = _Node(name, "layer", layer=layer,
                                       inputs=list(inputs))
        self._conf.order.append(name)
        return self

    addLayer = add_layer

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._check_inputs(name, inputs)
        self._conf.nodes[name] = _Node(name, "vertex", vertex=vertex,
                                       inputs=list(inputs))
        self._conf.order.append(name)
        return self

    addVertex = add_vertex

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._conf.network_outputs = list(names)
        return self

    setOutputs = set_outputs

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._pending_types = types
        return self

    setInputTypes = set_input_types

    def build(self) -> ComputationGraphConfiguration:
        if not self._conf.network_outputs:
            raise ValueError("set_outputs(...) required")
        for out in self._conf.network_outputs:
            if out not in self._conf.nodes:
                raise ValueError(f"unknown output node {out!r}")
        if self._pending_types:
            self._conf.set_input_types(*self._pending_types)
        return self._conf

    def _check_inputs(self, name: str, inputs: Sequence[str]) -> None:
        if name in self._conf.nodes:
            raise ValueError(f"duplicate node name {name!r}")
        if not inputs:
            raise ValueError(f"node {name!r} needs at least one input")
        for i in inputs:
            if i not in self._conf.nodes:
                raise ValueError(f"node {name!r}: unknown input {i!r} "
                                 f"(declare nodes in topological order)")


class ComputationGraph(TrainableNetwork):
    """Runtime twin of the configuration."""

    #: the graph's batches may be MultiDataSets
    _allow_multi = True

    def __init__(self, conf: ComputationGraphConfiguration):
        super().__init__(conf)

    def init(self, seed: Optional[int] = None,
             device=None) -> "ComputationGraph":
        """Create parameters from a seeded ``torch.Generator`` (drawn on the
        CPU, so a seed gives the same weights on every device) and place
        them on ``device``: the card unless the caller asks for another."""
        if not self.conf.node_output_types:
            raise ValueError("configuration needs set_input_types(...) "
                             "before init()")
        self.device = resolve_device(device)
        gen = torch.Generator()
        gen.manual_seed(int(seed if seed is not None
                            else self.conf.global_conf.seed))
        dtype = torch_dtype(self.conf.global_conf.dtype)
        for name in self.conf.order:
            node = self.conf.nodes[name]
            if node.kind == "layer":
                self._params[name] = (
                    node.layer.init_params(gen, dtype, self.device)
                    if node.layer.has_params else {})
                self._states[name] = node.layer.init_state(self.device)
        self._initialized = True
        return self

    def set_remat_policy(self, policy) -> None:
        """Switch the rematerialization policy (``conf.builder.remat_wrap``:
        a named policy, or a list of node names); the next training step
        runs under it."""
        _check_policy(policy)
        self.conf.global_conf.remat_policy = policy

    # --- forward -----------------------------------------------------------
    def _epilogue_fusion_plan(self):
        """The resnet-block-tail chains ``BN(identity) →
        ElementWiseVertex(add, 2 inputs) → ActivationLayer(relu)`` that
        inference ``_forward`` collapses into one fused BN+residual+relu
        epilogue (ops/epilogue) when ``GlobalConf.fused_epilogue`` is on.
        Conservative: every interior node must have exactly one consumer
        (the next link), no preprocessors on the add/act links, and neither
        interior node may be a network output — so skipping their dense
        materialization can never change any other node. Returns None when
        the knob is off or nothing matches; a chain falls back to the dense
        ops per call if the gate refuses."""
        if not getattr(self.conf.global_conf, "fused_epilogue", False):
            return None
        consumers: Dict[str, set] = {}
        for name in self.conf.order:
            for i in self.conf.nodes[name].inputs:
                consumers.setdefault(i, set()).add(name)
        outputs = set(self.conf.network_outputs)
        bn_nodes, add_nodes, act_nodes = set(), {}, {}
        for name in self.conf.order:
            node = self.conf.nodes[name]
            if (node.kind != "layer"
                    or not isinstance(node.layer, L.ActivationLayer)
                    or (node.layer.activation or "").lower() != "relu"
                    or len(node.inputs) != 1 or node.preprocessors):
                continue
            add_name = node.inputs[0]
            add_node = self.conf.nodes.get(add_name)
            if (add_node is None or add_node.kind != "vertex"
                    or not isinstance(add_node.vertex, ElementWiseVertex)
                    or add_node.vertex.op.lower() != "add"
                    or len(add_node.inputs) != 2
                    or add_name in outputs
                    or consumers.get(add_name) != {name}):
                continue
            if add_node.inputs[0] == add_node.inputs[1]:
                # relu(bn(x) + bn(x)): deferring the BN would starve the
                # "other" operand — leave the degenerate chain dense
                continue
            bn_name = None
            for cand, oth in (add_node.inputs, reversed(add_node.inputs)):
                bn = self.conf.nodes.get(cand)
                if (bn is not None and bn.kind == "layer"
                        and isinstance(bn.layer, L.BatchNormalization)
                        # honor a per-layer fused_epilogue=False opt-out
                        # even when the global knob is on
                        and bn.layer.fused_epilogue
                        and (bn.layer.activation
                             or "identity").lower() == "identity"
                        and cand not in outputs and cand not in bn_nodes
                        and consumers.get(cand) == {add_name}):
                    bn_name, other = cand, oth
                    break
            if bn_name is None:
                continue
            bn_nodes.add(bn_name)
            add_nodes[add_name] = (bn_name, other)
            act_nodes[name] = (bn_name, add_name)
        if not act_nodes:
            return None
        return {"bn": bn_nodes, "add": add_nodes, "act": act_nodes}

    def _forward(self, params, states, inputs: Dict[str, torch.Tensor],
                 training: bool = False, to_preout: bool = False):
        """The walk: ``(acts, new_states)``. ``training``: batch statistics
        and no fusion plan, and the compute-dtype cast happens here, inside
        autograd (the inference cast cache holds inference tensors, which
        autograd cannot save). ``to_preout``: output layers give their
        pre-activation, in float32 under ``compute_dtype``."""
        cd = self.conf.global_conf.compute_dtype
        if cd:
            ct = torch_dtype(cd)
            if training:
                params = cast_floating(params, ct)
            else:
                params = self._compute_params(params)
            inputs = {k: (v.to(ct) if v.is_floating_point() else v)
                      for k, v in inputs.items()}
        acts: Dict[str, torch.Tensor] = {}
        new_states = dict(states)
        out_set = set(self.conf.network_outputs)
        plan = None if training else self._epilogue_fusion_plan()
        # dropout bits in training come from the graph's own generator
        gen = self.generator() if training else None
        pending_bn: Dict[str, Any] = {}
        pending_add: Dict[str, Any] = {}
        for name in self.conf.order:
            node = self.conf.nodes[name]
            if node.kind == "input":
                x = inputs[name]
                if 0 in node.preprocessors:
                    x = node.preprocessors[0](x)
                acts[name] = x
                continue
            if plan is not None and node.kind == "vertex" \
                    and name in plan["add"]:
                # fused-epilogue chain: defer the residual add to the relu
                bn_name, other = plan["add"][name]
                pending_add[name] = (pending_bn.pop(bn_name), acts[other])
                continue
            if plan is not None and name in plan["act"]:
                # the fused BN+residual+relu launch
                _, add_name = plan["act"][name]
                (xbn, bnp, bns, bnl), other = pending_add.pop(add_name)
                y = bn_act(xbn, bns["mean"], bns["var"], bnp.get("gamma"),
                           bnp.get("beta"), epsilon=bnl.eps,
                           axis=1 if xbn.ndim == 4 else -1, act="relu",
                           residual=other)
                if y is None:
                    # gate refused: replay the dense chain verbatim
                    bn_out, _ = bnl.apply(bnp, xbn, bns, training)
                    y, _ = node.layer.apply(params.get(name, {}),
                                            bn_out + other,
                                            states.get(name, {}), training)
                acts[name] = y
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(*ins)
                continue
            x = ins[0]
            if 0 in node.preprocessors:
                x = node.preprocessors[0](x)
            if plan is not None and name in plan["bn"]:
                # head of a fused chain: stash the raw input for the relu
                pending_bn[name] = (x, params.get(name, {}),
                                    states.get(name, {}), node.layer)
                continue
            if to_preout and name in out_set \
                    and isinstance(node.layer, (L.OutputLayer, L.LossLayer)):
                x = node.layer._maybe_dropout(x, training, gen)
                head_params = params.get(name, {})
                if cd:
                    # the head matmul and the loss in float32 (from the
                    # compute-dtype copies, as the JAX package does)
                    head_params = {k: t.to(torch.float32)
                                   for k, t in head_params.items()}
                    x = x.to(torch.float32)
                acts[name] = node.layer.pre_output(head_params, x)
                continue
            def run(lp, xx, st, _l=node.layer):
                return _l.apply(lp, xx, st, training, generator=gen)

            if training:
                # this node's activations recomputed in the backward per
                # the configured policy (graph.py:606-614 of the JAX
                # package); a selective list names nodes
                run = remat_wrap(self.conf.global_conf, run, block=name,
                                 generator=gen)
            y, st = run(params.get(name, {}), x, states.get(name, {}))
            acts[name] = y
            if st:
                new_states[name] = st
        return acts, new_states

    def output(self, *inputs, training: bool = False) -> List[torch.Tensor]:
        """Inference: one tensor per network output, on the graph's device."""
        self._check_init()
        feed = self._bind_inputs(inputs)
        with torch.inference_mode():
            acts, _ = self._forward(self._params, self._states, feed,
                                    training)
        return [acts[o] for o in self.conf.network_outputs]

    def _bind_inputs(self, inputs) -> Dict[str, torch.Tensor]:
        names = self.conf.network_inputs
        if len(inputs) == 1 and isinstance(inputs[0], dict):
            return {k: self._to_device(v) for k, v in inputs[0].items()}
        if len(inputs) != len(names):
            raise ValueError(f"expected {len(names)} inputs {names}, got "
                             f"{len(inputs)}")
        return {n: self._to_device(v) for n, v in zip(names, inputs)}

    # --- loss --------------------------------------------------------------
    def _output_names(self) -> List[str]:
        """The outputs with a loss head, in order: they take labels."""
        return [o for o in self.conf.network_outputs
                if hasattr(self.conf.nodes[o].layer, "compute_score")]

    def _bind_batch(self, ds, w) -> tuple:
        """A DataSet or MultiDataSet as the step's ``(inputs, labels,
        masks, w)`` dicts by node name, not yet placed (``w``: the
        pipeline's example weights, or None for the plain mean)."""
        self._last_batch_size = ds.num_examples()
        in_names, out_names = self.conf.network_inputs, self._output_names()
        if isinstance(ds, MultiDataSet):
            masks = {n: m for n, m in zip(out_names, ds.labels_masks or ())
                     if m is not None}
            return (dict(zip(in_names, ds.features)),
                    dict(zip(out_names, ds.labels)), masks, w)
        if not isinstance(ds, DataSet):
            raise TypeError(f"expected a DataSet or MultiDataSet, got "
                            f"{type(ds).__name__}")
        masks = ({out_names[0]: ds.labels_mask}
                 if ds.labels_mask is not None else {})
        return ({in_names[0]: ds.features}, {out_names[0]: ds.labels},
                masks, w)

    def _place_batch(self, b) -> tuple:
        inputs, labels, masks, w = b
        put = lambda d: {k: self._place_array(v)  # noqa: E731
                         for k, v in d.items()}
        return (put(inputs), put(labels), put(masks),
                None if w is None else self._place_array(w))

    def _bind_dataset(self, ds):
        return self._place_batch(self._bind_batch(ds, None))[:3]

    def _loss(self, params, states, inputs, labels, masks,
              training: bool, w=None):
        """Mean loss over the outputs (with the example weights ``w``:
        ``sum(w * loss) / max(sum(w), 1)`` per output, so padded rows count
        for nothing) plus l1/l2 regularisation (leaving out ``b`` and
        ``beta``), and the new layer states."""
        acts, new_states = self._forward(params, states, inputs, training,
                                         to_preout=True)
        total = 0.0
        for out_name in self._output_names():
            layer = self.conf.nodes[out_name].layer
            pre = acts[out_name]
            # under reduced-precision compute the loss reduces in float32
            if self.conf.global_conf.compute_dtype \
                    and pre.is_floating_point():
                pre = pre.to(torch.float32)
            mask = masks.get(out_name) if masks else None
            if w is not None:
                mask = _fold_weights(mask, w)
            if isinstance(layer, (L.OutputLayer, L.LossLayer)):
                # the head's loss alone, as the JAX graph scores it (a
                # CenterLossOutputLayer's center term is left out)
                s = layer.loss.compute_score(labels[out_name], pre,
                                             layer.activation, mask,
                                             average=w is None)
            else:
                # another loss head (Yolo2OutputLayer), which the JAX graph
                # cannot train: its own score of its input
                s = layer.compute_score({}, pre, labels[out_name], mask,
                                        average=w is None)
            total = total + (s if w is None
                             else s / torch.clamp_min(w.sum(), 1.0))
        gc = self.conf.global_conf
        reg = 0.0
        for lname in sorted(params):
            layer = self.conf.nodes[lname].layer
            l1 = layer.l1 if layer.l1 is not None else gc.l1
            l2 = layer.l2 if layer.l2 is not None else gc.l2
            for path in leaf_paths(params[lname]):
                if path[-1] in ("b", "beta"):
                    continue
                t = get_path(params[lname], path)
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(t * t)
                if l1:
                    reg = reg + l1 * torch.sum(torch.abs(t))
        return total + reg, new_states

    def score(self, ds, training: bool = False) -> float:
        """The loss on ``ds`` (regularisation included), without a step."""
        self._check_init()
        inputs, labels, masks = self._bind_dataset(ds)
        with torch.no_grad():
            loss, _ = self._loss(self._params, self._states, inputs, labels,
                                 masks, training)
        return float(loss)

    def compute_gradient_and_score(self, ds):
        """``(gradients, score)`` in inference mode, the gradients as
        ``{node: {name: tensor}}``."""
        self._check_init()
        inputs, labels, masks = self._bind_dataset(ds)
        return self._gradient_and_score(
            lambda p: self._loss(p, self._states, inputs, labels, masks,
                                 False)[0])

    # --- training ----------------------------------------------------------
    def _step_core(self, store: Optional[FlatStore], batch,
                   iteration: int) -> torch.Tensor:
        """One training step on a placed batch ``(inputs, labels, masks,
        w)``: forward, loss, backward, update (through ``store`` on the
        fused path). Returns the loss (detached)."""
        inputs, labels, masks, w = batch
        loss, self._states = self._train_step(
            store, lambda p: self._loss(p, self._states, inputs, labels,
                                        masks, True, w), iteration)
        return loss

    def fit(self, data, epochs: int = 1, batch_size: Optional[int] = None,
            *, pad_partial: Optional[bool] = None,
            drop_remainder: bool = False, prefetch: int = 2,
            steps_per_dispatch: int = 1, host_prefetch: int = 0,
            resume_from: Optional[str] = None) -> None:
        """Train on ``data`` for ``epochs`` passes: a DataSet or
        MultiDataSet without ``batch_size`` takes one unpadded step, the
        rest goes through the input pipeline (see the module docstring;
        ``pad_partial`` defaults to True). ``resume_from``: a checkpoint
        written by ``CheckpointListener``; the call must be given the same
        data, epochs and batch arguments as the run that wrote it, and
        continues it bitwise (``util/checkpoint.restore_training_state``)."""
        self._run_fit(data, epochs, batch_size,
                      pad_partial=True if pad_partial is None
                      else pad_partial, drop_remainder=drop_remainder,
                      prefetch=prefetch,
                      steps_per_dispatch=steps_per_dispatch,
                      host_prefetch=host_prefetch, resume_from=resume_from,
                      serial=isinstance(data, (DataSet, MultiDataSet))
                      and batch_size is None)

    # --- evaluation and persistence ------------------------------------------
    def evaluate(self, data):
        """Classification metrics of the first output over ``data``."""
        from ..eval.evaluation import Evaluation

        ev = Evaluation()
        for ds in _pipe.iter_datasets(data, None, allow_multi=True):
            if isinstance(ds, MultiDataSet):
                out = self.output(*ds.features)[0]
                ev.eval(ds.labels[0], out)
            else:
                out = self.output(ds.features)[0]
                ev.eval(ds.labels, out, ds.labels_mask)
        return ev

    def save(self, path: str, save_updater: bool = False) -> None:
        """The model zip in the JAX package's format
        (``util/model_serializer.write_model``)."""
        from ..util.model_serializer import write_model

        write_model(self, path, save_updater)

    @staticmethod
    def load(path: str, load_updater: bool = False,
             device=None) -> "ComputationGraph":
        """A graph from a model zip (either package's), on ``device``: the
        card unless the caller asks for another."""
        from ..util.model_serializer import restore_computation_graph

        return restore_computation_graph(path, load_updater, device)

    def summary(self) -> str:
        lines = [f"{'node':<28}{'kind':<10}{'out type':<34}{'params':<10}"]
        total = 0
        for name in self.conf.order:
            node = self.conf.nodes[name]
            d = self._params.get(name, {})
            n = (sum(int(get_path(d, p).numel()) for p in leaf_paths(d))
                 if self._initialized else 0)
            total += n
            ot = self.conf.node_output_types.get(name, "?")
            kind = node.kind if node.kind != "layer" \
                else type(node.layer).__name__
            lines.append(f"{name:<28}{kind[:24]:<10}{str(ot):<34}{n:<10}")
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
