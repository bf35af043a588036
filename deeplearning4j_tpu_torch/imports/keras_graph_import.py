"""Keras FUNCTIONAL-model import → ComputationGraph.

Counterpart of ``deeplearning4j_tpu/imports/keras_graph_import.py``, over
the port's HDF5 reader and network; the parameters are installed on the
graph's device (the card unless the caller passes another).

Reference: dl4j-modelimport ``KerasModelImport.importKerasModelAndWeights``
→ ``KerasModel`` (the non-Sequential path: layer DAG from
``inbound_nodes``, merge layers → graph vertices; SURVEY.md §2.3). The
Sequential path lives in ``keras_import.py``; this module reuses its
per-layer weight-layout conversions (HWIO→OIHW etc.) by driving the same
mapper methods one layer at a time, and adds:

- DAG topology from Keras-3 ``inbound_nodes`` (``keras_history`` entries),
- merge layers → vertices (Add/Subtract/Multiply/Average/Maximum →
  ElementWiseVertex, Concatenate → MergeVertex — channel-dim concat, the
  NHWC axis=-1 contract),
- Flatten → identity node; the first Dense behind it gets its kernel rows
  permuted HWC→CHW AFTER graph type inference resolves the CNN shape
  (same exactness trick as the Sequential importer, deferred because a
  DAG's shapes are only known post-inference),
- NHWC input contract preserved via a transpose preprocessor on each
  input node.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..nn.conf import layers as L
from ..nn.conf.builder import NeuralNetConfiguration
from ..nn.conf.inputs import CNNInput, InputType, Preprocessor
from ..nn.graph import (ComputationGraph, ComputationGraphConfiguration,
                        DotProductVertex, ElementWiseVertex, MergeVertex)
from ..util.convert import graph_state_from_numpy
from .keras_import import (UnsupportedKerasLayerError, _read_h5,
                           _SequentialBuilder)

_MERGE_OPS = {"Add": "add", "Subtract": "subtract",
              "Multiply": "mul", "Average": "avg", "Maximum": "max",
              "Minimum": "min"}


def _call_sites(kl: Dict[str, Any]) -> List[List[Tuple[str, Optional[list]]]]:
    """Per CALL SITE: [(source name, source shape-or-None), ...] from
    Keras-3 (keras_history + shape) or Keras-2 ([[name, 0, 0, {}]])
    inbound_nodes. A layer invoked more than once (shared layer) has
    multiple call sites."""
    sites: List[List[Tuple[str, Optional[list]]]] = []

    def walk(obj, acc):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                acc.append((obj["config"]["keras_history"][0],
                            obj["config"].get("shape")))
            else:
                for v in obj.get("args", []) if "args" in obj else []:
                    walk(v, acc)
        elif isinstance(obj, (list, tuple)):
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int)):
                acc.append((obj[0], None))   # Keras-2 triplet
            else:
                for v in obj:
                    walk(v, acc)

    for node in kl.get("inbound_nodes", []):
        acc: List[Tuple[str, Optional[list]]] = []
        walk(node, acc)
        if acc:
            sites.append(acc)
    return sites


def _endpoints(spec) -> List[str]:
    """input_layers/output_layers: [name,0,0] or a list of them."""
    if not spec:
        return []
    if isinstance(spec[0], str):
        return [spec[0]]
    return [e[0] for e in spec]


def _convert_layer(kl: Dict[str, Any], f) -> Tuple[L.Layer, Optional[Callable]]:
    """One Keras layer → (our layer, weight setter), reusing the Sequential
    importer's mappers without its linear shape tracking."""
    sb = _SequentialBuilder()
    sb.cur_cnn = None           # disable sequential CNN tracking
    sb.input_type = InputType.feed_forward(1)  # satisfies guards; unused
    sb.add(kl, f)
    if len(sb.layers) == 1:
        return sb.layers[0], sb.weights[0]
    if len(sb.layers) == 2 and isinstance(sb.layers[1], L.ActivationLayer):
        # the leaky-relu split produces two layers; refuse rather than
        # silently drop the activation in a DAG context
        raise UnsupportedKerasLayerError(
            kl["class_name"],
            "activation='leaky_relu' kwarg inside a functional graph — use "
            "a separate LeakyReLU layer")
    raise UnsupportedKerasLayerError(kl["class_name"],
                                     "unexpected multi-layer expansion")


def import_functional(h5_path, device=None) -> ComputationGraph:
    f, cfg = _read_h5(h5_path)
    try:
        return import_functional_parsed(f, cfg, device)
    finally:
        f.close()


def import_functional_parsed(f, cfg, device=None) -> ComputationGraph:
    if True:   # indentation block kept minimal for the shared body below
        if cfg["class_name"] not in ("Functional", "Model"):
            raise UnsupportedKerasLayerError(
                cfg["class_name"], "import_functional expects a functional "
                "model; use import_keras_sequential_model_and_weights")
        layers_cfg = cfg["config"]["layers"]
        gb = (ComputationGraphConfiguration
              .graph_builder(NeuralNetConfiguration.builder())
              )
        input_types: Dict[str, InputType] = {}
        input_nhwc: Dict[str, bool] = {}
        setters: Dict[str, Optional[Callable]] = {}
        flatten_src: Dict[str, str] = {}     # flatten node -> its input
        dense_after_flatten: List[Tuple[str, str]] = []
        # shape-preserving chain member -> flatten's source (its per-feature
        # weights need the same row permute as the downstream Dense kernel)
        perfeature_after_flatten: Dict[str, str] = {}
        # (cls, name, flatten source) of layers that break the permute chain
        broken_chain: List[Tuple[str, str, str]] = []
        node_of: Dict[str, str] = {}         # keras name -> graph node name

        inputs = []
        for kl in layers_cfg:
            if kl["class_name"] == "InputLayer":
                c = kl["config"]
                name = c["name"]
                shape = c.get("batch_shape") or c.get("batch_input_shape")
                dims = list(shape[1:])
                if len(dims) == 3:
                    h, w, ch = dims
                    input_types[name] = InputType.convolutional(h, w, ch)
                    input_nhwc[name] = True
                elif len(dims) == 4:   # NDHWC (Conv3D / ConvLSTM2D inputs)
                    d, h, w, ch = dims
                    input_types[name] = InputType.convolutional_3d(
                        d, h, w, ch)
                    input_nhwc[name] = "ndhwc"
                elif len(dims) == 1:
                    input_types[name] = InputType.feed_forward(dims[0])
                    input_nhwc[name] = False
                elif len(dims) == 2:
                    input_types[name] = InputType.recurrent(dims[1], dims[0])
                    input_nhwc[name] = False
                else:
                    raise UnsupportedKerasLayerError("InputLayer",
                                                     f"rank {len(dims)}")
                inputs.append(name)
                node_of[name] = name
        gb.add_inputs(*inputs)

        # layers whose output keeps the flattened row ORDER intact — the
        # deferred Dense kernel permute must chain through them (the
        # Sequential importer's flatten_pending equivalent)
        _SHAPE_PRESERVING = {"Dropout", "Activation", "ReLU", "LeakyReLU",
                             "Softmax", "ELU", "AlphaDropout",
                             "GaussianDropout", "GaussianNoise", "PReLU",
                             "LayerNormalization", "BatchNormalization"}
        for kl in layers_cfg:
            cls = kl["class_name"]
            if cls == "InputLayer":
                continue
            c = kl.get("config", {})
            name = c.get("name", cls)
            sites = _call_sites(kl)
            if not sites:
                raise UnsupportedKerasLayerError(
                    cls, f"{name}: no inbound nodes")
            if len(sites) > 1:
                # a SHARED layer (applied at several graph positions) would
                # need one node per call site with tied weights; wiring all
                # sources into one node would silently drop inputs
                raise UnsupportedKerasLayerError(
                    cls, f"{name}: shared layers (multiple call sites) are "
                    "not supported")
            srcs = [node_of[s] for s, _ in sites[0]]
            src_shapes = [shape for _, shape in sites[0]]
            if cls in _MERGE_OPS or cls == "Concatenate":
                # a merge fed by a Flatten chain scrambles the flattened
                # row order beyond tracking — a downstream Dense would
                # import silently wrong; record for the post-build check
                for s in srcs:
                    if s in flatten_src:
                        broken_chain.append((cls, name, flatten_src[s]))
            if cls in _MERGE_OPS:
                gb.add_vertex(name, ElementWiseVertex(_MERGE_OPS[cls]),
                              *srcs)
            elif cls == "Concatenate":
                axis = c.get("axis", -1)
                ranks = {len(sh) for sh in src_shapes if sh is not None}
                rank = ranks.pop() if len(ranks) == 1 else None
                # channel concat only: axis -1 always; positive axes only
                # when they denote the channel dim for the known rank
                ok = axis == -1 or (rank is not None and axis == rank - 1)
                if not ok:
                    raise UnsupportedKerasLayerError(
                        "Concatenate",
                        f"{name}: axis={axis} on rank-{rank} inputs "
                        "(channel-dim concat only)")
                gb.add_vertex(name, MergeVertex(), *srcs)
            elif cls == "Dot":
                axes = c.get("axes", -1)
                ax = (axes if isinstance(axes, int)
                      else (axes[0] if len(set(axes)) == 1 else None))
                if ax not in (-1, 1):
                    raise UnsupportedKerasLayerError(
                        "Dot", f"{name}: axes={axes} (feature-axis dot of "
                        "two [B, F] inputs only)")
                gb.add_vertex(name, DotProductVertex(
                    normalize=bool(c.get("normalize", False))), *srcs)
            elif cls == "Masking":
                raise UnsupportedKerasLayerError(
                    "Masking",
                    f"{name}: in-graph mask propagation is wired for "
                    "Sequential models only (MultiLayerNetwork threads the "
                    "derived mask; ComputationGraph does not)")
            elif cls == "Flatten":
                gb.add_layer(name, L.FlattenLayer(), *srcs)
                # chain through an upstream Flatten (or chain member): a
                # Flatten of an already-flat tensor is an identity, so the
                # permute source stays the ORIGINAL CNN tensor
                flatten_src[name] = flatten_src.get(srcs[0], srcs[0])
            else:
                layer, setter = _convert_layer(kl, f)
                gb.add_layer(name, layer, *srcs)
                setters[name] = setter
                if getattr(layer, "shape_preserving", False):
                    # registered custom layer opted in (keras_import.py
                    # hook contract) — chain without per-feature permute
                    # bookkeeping (custom layers own their weight layout)
                    if srcs[0] in flatten_src:
                        flatten_src[name] = flatten_src[srcs[0]]
                elif cls in _SHAPE_PRESERVING and srcs[0] in flatten_src:
                    flatten_src[name] = flatten_src[srcs[0]]
                    # per-feature weights of chain members (LayerNorm
                    # gain/bias, PReLU alpha) see CHW-ordered activations
                    perfeature_after_flatten[name] = flatten_src[srcs[0]]
                if isinstance(layer, L.DenseLayer) and \
                        srcs[0] in flatten_src:
                    dense_after_flatten.append((name, flatten_src[srcs[0]]))
                elif cls not in _SHAPE_PRESERVING and \
                        not getattr(layer, "shape_preserving", False) and \
                        srcs[0] in flatten_src:
                    # the pending HWC->CHW row permute can't be tracked
                    # through this layer — refuse IF the flatten was over a
                    # CNN tensor (checked after build, when output types of
                    # the flatten source are known)
                    broken_chain.append((cls, name, flatten_src[srcs[0]]))
            node_of[name] = name

        outputs = _endpoints(cfg["config"].get("output_layers"))
        gb.set_outputs(*outputs)
        conf = gb.set_input_types(*[input_types[i] for i in inputs]).build()

        for bcls, bname, bsrc in broken_chain:
            if isinstance(conf.node_output_types[bsrc], CNNInput):
                raise UnsupportedKerasLayerError(
                    bcls,
                    f"{bname}: layer between Flatten and Dense does not "
                    "preserve the flattened row order; the HWC->CHW kernel "
                    "permute cannot be applied soundly")

        # NHWC/NDHWC input contract: transpose once on entry per image
        # input (channels-last arrays in, channels-first body)
        for iname in inputs:
            if input_nhwc[iname]:
                node = conf.nodes[iname]
                prev = node.preprocessors.get(0)
                perm = ((0, 4, 1, 2, 3)
                        if input_nhwc[iname] == "ndhwc" else (0, 3, 1, 2))
                nhwc = Preprocessor("NhwcToNchw",
                                    lambda x, _p=perm: x.permute(*_p),
                                    conf.node_output_types[iname])
                if prev is not None:
                    node.preprocessors[0] = Preprocessor(
                        f"NhwcToNchw+{prev.name}",
                        lambda x, p=prev, n=nhwc: p(n(x)), prev.out_type)
                else:
                    node.preprocessors[0] = nhwc

        net = ComputationGraph(conf).init(device=device)

        # weights (+ the deferred flatten→dense row permute)
        permute_for = dict(dense_after_flatten)
        from .keras_import import (_check_tree_shapes, _f32_tree,
                                   _flatten_perm, _np_tree,
                                   _permute_per_feature)

        params_np = {k: _np_tree(v) for k, v in net._params.items()}
        states_np = {k: _np_tree(v) for k, v in net._states.items()}
        for name, setter in setters.items():
            if setter is None:
                continue
            params = params_np[name]
            if getattr(setter, "wants_state", False):
                state = states_np[name]
                setter(params, state)
                states_np[name] = _f32_tree(state)
            else:
                setter(params)
            if name in permute_for:
                t = conf.node_output_types[permute_for[name]]
                if isinstance(t, CNNInput):
                    perm = _flatten_perm(
                        (t.channels, t.height, t.width))
                    params["W"] = np.asarray(params["W"])[perm]
            if name in perfeature_after_flatten:
                t = conf.node_output_types[perfeature_after_flatten[name]]
                if isinstance(t, CNNInput):
                    perm = _flatten_perm(
                        (t.channels, t.height, t.width))
                    _permute_per_feature(params, perm)
                    if states_np.get(name):    # BN mean/var
                        st = dict(states_np[name])
                        _permute_per_feature(st, perm)
                        states_np[name] = _f32_tree(st)
            _check_tree_shapes(net._params[name], params, f"node {name!r}")
            params_np[name] = _f32_tree(params)
        return graph_state_from_numpy(net, params_np, states_np)
