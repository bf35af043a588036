"""The twelve CNN zoo models of the port against the JAX package's, on the
CPU.

- Parameter counts at the published defaults, from the configurations
  alone (no forward, nothing allocated): the JAX layers' ``init_params``
  under ``jax.eval_shape``, the port's with its weight draws replaced by
  tensors on the meta device.
- Each model at the reduced size ``tests/test_graph.py`` builds it (VGG19
  and AlexNet, whose constructors take no size, as narrow twins of their
  zoo configurations, ``torch_parity.vgg_conf`` / ``alexnet_conf``): the
  same weights in both packages, the served output, then one ``fit`` step
  with the model's own updater, on seeded pixels in [0, 1], one-hot labels,
  binary masks (UNet) or boxes in grid units (the YOLOs). Dropout is off
  on both sides (threefry draws cannot be matched;
  tests/test_torch_dropout.py injects masks).
- SimpleCNN and a BN graph with ``fused_epilogue`` on against the JAX
  package's fused path.

The JAX networks are initialized with zero weights (its per-layer draws
compile one program per shape: seconds per model) and given the port's
seeded draws, which ``graph_state_from_numpy`` /
``multilayer_state_from_numpy`` then copy back into the port, checking
every name, shape and dtype.

Tolerances, and why:
- the served output (BN at its default state) within 1e-5 of its scale
  (float32 sums in another order);
- the step starts from BN running statistics set to the batch's own
  (``_calibrate``): from the default pivot 0 the single-pass variance
  ``E[d^2] - E[d]^2`` of both packages cancels where a channel's mean is
  far above its spread, and the rounding of that cancellation moved deep
  gradients by up to 20% between the packages (Darknet19, batch 2);
- after the step, the loss within 1e-4 relative and the BN running
  statistics within 1e-5 of their scale (measured: loss 1.6e-5 at most,
  YOLO2);
- the training gradients of all parameters within 1e-2 of their norm, as
  one vector. The deep BatchNormalization stacks at batch 2 end in sums
  over a few positions (2x2 or 3x3), where a pre-activation within
  rounding of a relu or leakyrelu kink moves a weight's gradient by a
  whole term: nudging the input by one float32 ulp moves the port's own
  gradients by up to 2.7% of their norm (FaceNetNN4Small2; 1.2%
  InceptionResNetV1, 0.6% YOLO2 and Xception), and the two packages differ
  by up to 6.0e-3 of it (measured: InceptionResNetV1 6.0e-3, Darknet19
  4.1e-3, FaceNetNN4Small2 2.7e-3, Xception 2.1e-3, YOLO2 1.9e-3; the nets
  without BN 3e-7 to 2.3e-5). Float64 does not cure it: BN's statistics
  and reductions stay float32 in both packages. A wrong backward shows as
  a difference of the gradient's own order;
- the parameters after the step within a tenth of the step, as one vector
  (measured: at most 6.4e-2, InceptionResNetV1): Adam's first step is
  ``lr * g / (|g| + eps)``, so where a gradient element is within those
  differences of 0 its sign, and a step of up to ``lr``, can differ;
- the fused epilogue against the JAX package's: rtol 1e-5, atol 1e-5,
  the JAX package's own bound for the folded affine against the dense
  ops (tests/test_precision.py), since the JAX gate refuses the channel
  counts that are not a multiple of 128 and runs them dense.
"""

import contextlib
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.learning import precision as jprecision
from deeplearning4j_tpu.models import zoo as JZ
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf import layers_ext as JLX
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import zoo as TZ
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm
from deeplearning4j_tpu_torch.util.convert import (
    graph_state_from_numpy, multilayer_state_from_numpy)
from torch_parity import (alexnet_conf, modules, numpy_tree,  # noqa: F401
                          one_torch_thread, randomize_bn, vgg_conf,
                          yolo_labels)

TOL = 1e-5
STEP_LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-2
STEP_TOL = 0.1
B = 2

#: the published parameter counts at the defaults (the JAX zoo's)
DEFAULTS = ("SimpleCNN", "AlexNet", "VGG19", "SqueezeNet", "Darknet19",
            "UNet", "Xception", "InceptionResNetV1", "FaceNetNN4Small2",
            "NASNet", "TinyYOLO", "YOLO2")

VGG19_SMALL = {"blocks": ((2, 4), (2, 8), (4, 8), (4, 16), (4, 16)),
               "dense": 32, "classes": 10, "image": 32}
ALEX_SMALL = {"convs": (8, 16, 16, 16, 8), "dense": 32, "classes": 10}

#: the reduced sizes of tests/test_graph.py, with each model's input
REDUCED = {
    "SimpleCNN": ({}, (3, 48, 48)),
    "AlexNet": (None, (3, 227, 227)),
    "VGG19": (None, (3, 32, 32)),
    "SqueezeNet": ({"num_classes": 10}, (3, 224, 224)),
    "Darknet19": ({"num_classes": 10, "image_size": 64}, (3, 64, 64)),
    "UNet": ({"n_channels": 1, "n_classes": 1, "image_size": 32,
              "base": 8}, (1, 32, 32)),
    "Xception": ({"num_classes": 10, "image_size": 96}, (3, 96, 96)),
    "InceptionResNetV1": ({"num_classes": 16, "image_size": 96},
                          (3, 96, 96)),
    "FaceNetNN4Small2": ({"num_classes": 5, "image_size": 64}, (3, 64, 64)),
    "NASNet": ({"num_classes": 7, "image_size": 32, "cells_per_stack": 1},
               (3, 32, 32)),
    "TinyYOLO": ({"num_classes": 4, "image_size": 64}, (3, 64, 64)),
    "YOLO2": ({"num_classes": 4, "image_size": 64}, (3, 64, 64)),
}


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


# --- parameter counts ----------------------------------------------------------

def _layers(conf):
    if hasattr(conf, "nodes"):
        return [conf.nodes[n].layer for n in conf.order
                if conf.nodes[n].kind == "layer"]
    return list(conf.layers)


def _jax_conf(name):
    """The JAX zoo model's configuration, built by its ``init`` with the
    networks' own ``init`` turned into a no-op (nothing allocated)."""
    with mock.patch.object(JNet, "init", lambda self, *a, **k: self), \
            mock.patch.object(JGraph, "init", lambda self, *a, **k: self):
        return getattr(JZ, name)().init().conf


def _jax_count(conf):
    key = jax.random.PRNGKey(0)
    n = 0
    for layer in _layers(conf):
        if layer.has_params:
            shapes = jax.eval_shape(lambda k, l=layer: l.init_params(k), key)
            n += sum(int(np.prod(s.shape)) for s in shapes.values())
    return n


def _torch_count(conf):
    """Parameters of the port's configuration: each layer's
    ``init_params`` with its weight draws on the meta device."""
    def meta(gen, shape, scheme="xavier", dtype=torch.float32, gain=1.0,
             device=None):
        return torch.empty(tuple(shape), device="meta")

    n = 0
    with mock.patch.object(TL, "init_weights", meta):
        for layer in _layers(conf):
            if layer.has_params:
                p = layer.init_params(torch.Generator(), torch.float32,
                                      "meta")
                n += sum(int(t.numel()) for t in p.values())
    return n


@pytest.mark.parametrize("name", DEFAULTS)
def test_parameter_count_at_defaults_matches_jax(name):
    want = _jax_count(_jax_conf(name))
    got = _torch_count(getattr(TZ, name)().conf())
    assert got == want, (name, got, want)


def test_vgg19_and_alexnet_twins_are_the_zoo_topology():
    """The narrow twins below are the zoo configurations at other widths:
    at the zoo's widths the helpers build the zoo's layers, field for
    field."""
    for zoo, helper in ((TZ.VGG19().conf(), vgg_conf(
            "torch", {"blocks": TZ.VGG19()._blocks()})),
            (TZ.AlexNet().conf(), alexnet_conf("torch"))):
        assert json.loads(zoo.to_json()) == json.loads(helper.to_json())
        assert zoo.layer_output_types == helper.layer_output_types


# --- the models at reduced sizes against the JAX package -----------------------

@contextlib.contextmanager
def _zero_jax_init():
    def zeros(key, shape, scheme="xavier", dtype=jnp.float32, gain=1.0):
        return jnp.zeros(tuple(shape), dtype)

    with mock.patch.object(JL, "init_weights", zeros), \
            mock.patch.object(JLX, "init_weights", zeros):
        yield


def _twins(name):
    """(jax network, port network) with the port's seeded weights in both,
    dropout off."""
    kw, _ = REDUCED[name]
    with _zero_jax_init():
        if name == "VGG19":
            jn = JNet(vgg_conf("jax", VGG19_SMALL)).init()
            tn = TNet(vgg_conf("torch", VGG19_SMALL))
        elif name == "AlexNet":
            jn = JNet(alexnet_conf("jax", ALEX_SMALL)).init()
            tn = TNet(alexnet_conf("torch", ALEX_SMALL))
        else:
            jn = getattr(JZ, name)(**kw).init()
            conf = getattr(TZ, name)(**kw).conf()
            tn = TZ.network(conf)
    for conf in (jn.conf, tn.conf):
        for layer in _layers(conf):
            if hasattr(layer, "rate"):
                layer.rate = 0.0
            layer.dropout = 0.0
    tn.init(device="cpu")
    params = {n: {k: v.numpy() for k, v in d.items()}
              for n, d in tn._params.items()}
    if isinstance(jn, JNet):
        keys = sorted(params)
        jn._params = [{k: jnp.asarray(v) for k, v in params[n].items()}
                      for n in keys]
        multilayer_state_from_numpy(
            tn, [numpy_tree({0: d})[0] for d in jn._params],
            [numpy_tree({0: d})[0] for d in jn._states])
    else:
        jn._params = {n: {k: jnp.asarray(v) for k, v in d.items()}
                      for n, d in params.items()}
        graph_state_from_numpy(tn, numpy_tree(jn._params),
                               numpy_tree(jn._states))
    return jn, tn


def _batch(name, seed=0):
    """Seeded pixels in [0, 1] and labels in each model's format."""
    kw, shape = REDUCED[name]
    rng = np.random.default_rng(seed)
    x = rng.random((B,) + shape, dtype=np.float32)
    if name == "UNet":
        y = (rng.random((B, 1) + shape[1:]) < 0.5).astype(np.float32)
    elif name in ("TinyYOLO", "YOLO2"):
        grid = shape[1] // 32 + (1 if name == "TinyYOLO" else 0)
        y = yolo_labels(rng, B, kw["num_classes"], grid)
    else:
        classes = {"VGG19": VGG19_SMALL["classes"],
                   "AlexNet": ALEX_SMALL["classes"]}.get(
            name, (kw or {}).get("num_classes", 10))
        y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, B)]
    return x, y


def _out(o):
    o = o[0] if isinstance(o, (list, tuple)) else o
    if isinstance(o, torch.Tensor):
        return o.detach().numpy()
    return np.asarray(getattr(o, "value", o))


def _as_dict(tree):
    """A JAX network's per-layer list as a dict keyed like the port's."""
    if isinstance(tree, list):
        return {f"{i:04d}": d for i, d in enumerate(tree)}
    return tree


def _tree(tree):
    """``{(node or layer, name): numpy}`` of a parameter or state tree of
    either package."""
    return {(n, k): (v.detach().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v))
            for n, d in _as_dict(tree).items() for k, v in d.items()}


def _calibrate(jn, tn, x):
    """BN running statistics set to their inputs' own statistics on ``x``,
    in both packages: the step's statistics are then summed about a pivot
    (the running mean) near the batch mean. From the default pivot 0,
    ``E[d^2] - E[d]^2`` cancels where a channel's mean is far above its
    spread, and the rounding of that cancellation, which the two packages
    sum in another order, moves deep gradients by whole percents
    (measured: Darknet19's, batch 2)."""
    calibrate_batchnorm(tn, x)
    states = numpy_tree(tn._states)
    jstates = {n: {k: jnp.asarray(v) for k, v in d.items()}
               for n, d in states.items()}
    jn._states = ([jstates[n] for n in sorted(jstates)]
                  if isinstance(jn, JNet) else jstates)


def _feed(net, x, y, torch_side):
    """(inputs, labels) as the network's ``_loss`` takes them."""
    if torch_side:
        x, y = torch.from_numpy(x), torch.from_numpy(y)
    else:
        x, y = jnp.asarray(x), jnp.asarray(y)
    if isinstance(net, (JNet, TNet)):
        return x, y
    return {"input": x}, {net.conf.network_outputs[0]: y}


def _jax_step(jn, x, y):
    """The JAX package's training step (``_step_core``'s per-leaf path):
    ``jax.value_and_grad`` of the network's training loss, then its
    updater through ``apply_updater``. YOLO2's loss is its
    ``Yolo2OutputLayer.compute_score`` on the head's output: the JAX graph
    cannot fit it (its fit binds labels only to OutputLayer/LossLayer
    outputs). Returns (loss, gradients)."""
    key = jax.random.PRNGKey(0)
    inputs, labels = _feed(jn, x, y, False)
    if isinstance(jn, JNet):
        def loss_fn(p):
            return jn._loss(p, jn._states, inputs, labels, None, True, key)
    elif "yolo" in jn.conf.nodes:
        layer = jn.conf.nodes["yolo"].layer

        def loss_fn(p):
            acts, st = jn._forward(p, jn._states, inputs, True, key,
                                   to_preout=True)
            return layer.compute_score({}, acts["yolo"],
                                       labels["yolo"]), st
    else:
        def loss_fn(p):
            return jn._loss(p, jn._states, inputs, labels, {}, True, key)
    (loss, states), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jn._params)
    upd = jn.conf.global_conf.updater
    jn._params, _ = jax.jit(lambda g, p: jprecision.apply_updater(
        upd, g, upd.init(p), p, 0, key))(grads, jn._params)
    jn._states = states
    return float(loss), _tree(grads)


def _torch_grads(tn, x, y):
    """The port's gradients of its training loss at its current state
    (zeros where a parameter takes no part in it, as ``jax.grad`` gives)."""
    params = {n: {k: v.detach().clone().requires_grad_(True)
                  for k, v in d.items()} for n, d in tn._params.items()}
    states = {n: dict(d) for n, d in tn._states.items()}
    inputs, labels = _feed(tn, x, y, True)
    if isinstance(tn, TNet):
        loss, _ = tn._loss(params, states, inputs, labels, None, True)
    else:
        loss, _ = tn._loss(params, states, inputs, labels, {}, True)
    loss.backward()
    return {(n, k): (np.zeros(v.shape, np.float32) if v.grad is None
                     else v.grad.numpy())
            for n, d in params.items() for k, v in d.items()}


def _norm(tree, keys):
    return float(np.sqrt(sum(np.sum(np.asarray(tree[k], np.float64) ** 2)
                             for k in keys)))


@pytest.mark.parametrize("name", DEFAULTS)
def test_zoo_model_serves_and_steps_as_jax(name):
    jn, tn = _twins(name)
    x, y = _batch(name)
    want = _out(jn.output(x))
    got = _out(tn.output(x))
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)

    _calibrate(jn, tn, x)
    tg = _torch_grads(tn, x, y)
    before = {k: v.copy() for k, v in _tree(tn._params).items()}
    jloss, jg = _jax_step(jn, x, y)
    tn.fit(DataSet(x, y))
    assert abs(tn.score_value - jloss) <= STEP_LOSS_RTOL * abs(jloss), \
        (tn.score_value, jloss)
    for leaf, w in _tree(jn._states).items():
        np.testing.assert_allclose(
            _tree(tn._states)[leaf], w, rtol=0,
            atol=TOL * max(float(np.abs(w).max()), 1e-2),
            err_msg=f"{name} {leaf}")
    assert set(jg) == set(tg)
    keys = sorted(jg)
    gdiff = {k: tg[k] - jg[k] for k in keys}
    assert _norm(gdiff, keys) <= GRAD_RTOL * _norm(jg, keys), name
    jt, tt = _tree(jn._params), _tree(tn._params)
    assert set(jt) == set(tt) and all(np.isfinite(v).all()
                                      for v in tt.values())
    diff = {k: tt[k] - jt[k] for k in keys}
    step = {k: jt[k] - before[k] for k in keys}
    assert _norm(diff, keys) <= STEP_TOL * _norm(step, keys), name


# --- the fused epilogue against the JAX package's -----------------------------

def _bn_graph(which):
    """BN layers at 128 channels (the JAX gate fuses them) and at 48 (it
    runs them dense; the port fuses every one): relu, identity, and a
    resnet tail BN(identity) -> add -> relu."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(5).updater(m.Sgd(0.01))
         .activation("relu").weight_init("relu").fused_epilogue())
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("c1", m.L.ConvolutionLayer(
        n_out=128, kernel_size=(3, 3), convolution_mode="same",
        has_bias=False, activation="identity"), "in")
    gb.add_layer("bn1", m.L.BatchNormalization(activation="relu"), "c1")
    gb.add_layer("c2", m.L.ConvolutionLayer(
        n_out=128, kernel_size=(1, 1), has_bias=False,
        activation="identity"), "bn1")
    gb.add_layer("bn2", m.L.BatchNormalization(activation="identity"), "c2")
    gb.add_vertex("add", m.graph.ElementWiseVertex(op="add"), "bn2", "bn1")
    gb.add_layer("relu", m.L.ActivationLayer(activation="relu"), "add")
    gb.add_layer("c3", m.L.SeparableConvolution2D(
        n_out=48, kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same", has_bias=False, activation="identity"),
        "relu")
    gb.add_layer("bn3", m.L.BatchNormalization(activation="relu"), "c3")
    gb.add_layer("gap", m.L.GlobalPoolingLayer(pooling_type="avg"), "bn3")
    gb.add_layer("out", m.L.OutputLayer(n_out=5, activation="softmax",
                                        loss="mcxent"), "gap")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.convolutional(9, 9, 4))
    return gb.build()


@pytest.mark.parametrize("name", ["SimpleCNN", "bn_graph"])
def test_fused_epilogue_matches_jax(name):
    if name == "SimpleCNN":
        jn, tn = _twins(name)
        jn.conf.global_conf.fused_epilogue = True
        for layer in _layers(jn.conf) + _layers(tn.conf):
            if isinstance(layer, (JL.BatchNormalization,
                                  TL.BatchNormalization)):
                layer.fused_epilogue = True
        n_bn = 3
    else:
        jn = JGraph(_bn_graph("jax")).init()
        tn = TGraph(_bn_graph("torch")).init(device="cpu")
        n_bn = 3
    params, states = numpy_tree(_as_dict(jn._params)), \
        numpy_tree(_as_dict(jn._states))
    randomize_bn(params, states, seed=11)
    if isinstance(jn, JNet):
        multilayer_state_from_numpy(tn, [params[k] for k in sorted(params)],
                                    [states[k] for k in sorted(states)])
        jn._params = [{k: jnp.asarray(v) for k, v in params[n].items()}
                      for n in sorted(params)]
        jn._states = [{k: jnp.asarray(v) for k, v in states[n].items()}
                      for n in sorted(states)]
    else:
        graph_state_from_numpy(tn, params, states)
        jn._params = {n: {k: jnp.asarray(v) for k, v in d.items()}
                      for n, d in params.items()}
        jn._states = {n: {k: jnp.asarray(v) for k, v in d.items()}
                      for n, d in states.items()}
    shape = REDUCED["SimpleCNN"][1] if name == "SimpleCNN" else (4, 9, 9)
    x = np.random.default_rng(2).random((B,) + shape, dtype=np.float32)
    want = _out(jn.output(x))
    OpProfiler.get().reset()
    got = _out(tn.output(x))
    counters = OpProfiler.get().get_counters()
    assert counters.get("precision/epilogue_hits") == n_bn
    assert "precision/epilogue_fallbacks" not in counters
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)



@pytest.mark.parametrize("fault", ["deconv_io_swapped", "pointwise_width",
                                   "centers_missing", "depthwise_mult"])
def test_carry_over_refuses_new_layouts_that_do_not_fit(fault):
    """``graph_state_from_numpy`` copies the new parameters by name and
    shape and refuses one that does not fit: a transposed convolution's W
    given as [O, I, kH, kW], a pointwise W of another width, a center-loss
    head without its centers, a depthwise W of another multiplier."""
    name = {"deconv_io_swapped": "UNet", "pointwise_width": "Xception",
            "centers_missing": "FaceNetNN4Small2",
            "depthwise_mult": "Xception"}[fault]
    tn = TZ.network(getattr(TZ, name)(**REDUCED[name][0]).conf()).init(
        device="cpu")
    params = {n: {k: v.numpy().copy() for k, v in d.items()}
              for n, d in tn._params.items()}
    states = numpy_tree(tn._states)
    graph_state_from_numpy(tn, params, states)        # the layout fits
    if fault == "deconv_io_swapped":
        params["up1"]["W"] = np.ascontiguousarray(
            params["up1"]["W"].transpose(1, 0, 2, 3))
    elif fault == "pointwise_width":
        params["sep3"]["pW"] = params["sep3"]["pW"][:, :-1]
    elif fault == "centers_missing":
        del params["lossLayer"]["centers"]
    else:
        params["sep3"]["dW"] = np.concatenate([params["sep3"]["dW"]] * 2)
    with pytest.raises(ValueError):
        graph_state_from_numpy(tn, params, states)
