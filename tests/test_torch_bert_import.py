"""TF-imported BERT (``bench.py --config bert``'s path) in the port against
the JAX package and TensorFlow, at tests/test_bert_import.py's size (batch
2, seq 16, hidden 32, 2 layers, 4 heads).

Tolerances (float32 throughout; the JAX side computes in float32 with int32
ids although importing it turns on x64):
- the pooled output: the port within ``atol 1e-5, rtol 1e-4`` of the JAX
  import (the same ops in another summation order, through 2 layers and a
  tanh), and within ``atol 2e-4, rtol 1e-3`` of TensorFlow's session run,
  the JAX test's bound (tests/test_bert_import.py:49);
- the fine-tune graph's loss within ``rtol 1e-5`` and every gradient
  within ``1e-4`` of its own largest magnitude, except the key projections'
  biases, whose gradient is zero in exact arithmetic (adding q.b_k to every
  score of a row leaves the softmax unchanged): in both packages it is
  rounding noise (about 1e-12), held to an absolute 1e-9;
- 10 Adam(1e-3) steps: each loss within ``rtol 1e-4`` of the JAX loss at
  that step (differences of 1e-6 grow as the steps feed back).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.imports import import_frozen_tf as jax_import
from deeplearning4j_tpu.learning import Adam as JAdam
from deeplearning4j_tpu_torch.autodiff.samediff import TrainingConfig as PTC
from deeplearning4j_tpu_torch.imports import import_frozen_tf
from deeplearning4j_tpu_torch.imports import tf_fixtures as PF
from deeplearning4j_tpu_torch.learning.updaters import Adam as PAdam
from deeplearning4j_tpu_torch.util import samediff_state_from_numpy

CFG = dict(batch=2, seq=16, hidden=32, layers=2, heads=4, intermediate=64,
           vocab=97, type_vocab=2, max_pos=32)
N_CLASSES = 3


@pytest.fixture(scope="module")
def port_graph():
    data, names, _ = PF.build_bert_frozen_graph(**CFG)
    return data, names


@pytest.fixture(scope="module")
def tf_graph():
    pytest.importorskip("tensorflow")
    from deeplearning4j_tpu.imports.tf_fixtures import build_bert_frozen_graph

    gd, names, _ = build_bert_frozen_graph(**CFG)
    return gd, names


def _batch(names):
    ids, types, mask, y = PF.make_bert_batch(CFG["batch"], CFG["seq"],
                                             CFG["vocab"], N_CLASSES)
    batch = dict(zip(names, (ids, types, mask)))
    return batch, y


def _var_table(sd):
    def meta(v):
        return (tuple(v.shape), str(np.dtype(str(v.dtype).replace(
            "torch.", ""))))
    return [(n, meta(np.asarray(sd._vars[n].value)
                     if not isinstance(sd._vars[n].value, torch.Tensor)
                     else sd._vars[n].value)) for n in sd.variables()]


@pytest.mark.parametrize("source", ["tensorflow", "port_writer"])
def test_both_packages_import_the_same_variables(source, tf_graph,
                                                 port_graph):
    """The same bytes give the same variables in both packages: names,
    order, shapes, dtypes; the port writer's bytes give the TF build's
    set (the folded position slice ``strided_slice_0`` is [seq, hidden])."""
    graph = tf_graph[0].SerializeToString() if source == "tensorflow" \
        else port_graph[0]
    j, t = jax_import(graph), import_frozen_tf(graph, device="cpu")
    assert t.tf_outputs == j.tf_outputs == ["Identity"]
    assert t.tf_placeholders == j.tf_placeholders
    assert t.convert_to_variables() == j.convert_to_variables()
    table = _var_table(t)
    assert table == _var_table(j)
    assert len(table) == 3 + 16 * CFG["layers"] + 4
    assert dict(table)["strided_slice_0"] == ((CFG["seq"], CFG["hidden"]),
                                              "float32")
    if source == "port_writer":
        tf_sd = import_frozen_tf(tf_graph[0], device="cpu")
        tf_sd.convert_to_variables()
        assert _var_table(tf_sd) == table
        for n in tf_sd.variables():
            assert torch.equal(tf_sd._vars[n].value, t._vars[n].value), n


def test_pooled_output_matches_jax_and_tensorflow(tf_graph):
    import tensorflow as tf

    gd, names = tf_graph
    batch, _ = _batch(names)
    g = tf.Graph()
    with g.as_default():
        tf.graph_util.import_graph_def(gd, name="")
    with tf.compat.v1.Session(graph=g) as sess:
        want_tf = sess.run("Identity:0", {f"{k}:0": v
                                          for k, v in batch.items()})
    j = jax_import(gd)
    want_jax = j.output(batch, j.tf_outputs)["Identity"].to_numpy()
    assert want_jax.dtype == np.float32
    sd = import_frozen_tf(gd, device="cpu")
    got = sd.output(batch, sd.tf_outputs)["Identity"].numpy()
    assert got.dtype == np.float32 and got.shape == (CFG["batch"],
                                                     CFG["hidden"])
    np.testing.assert_allclose(got, want_jax, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got, want_tf, atol=2e-4, rtol=1e-3)


def _fine_tune(sd, adam, tc, lr):
    """bench.py's fine-tune graph: the frozen weights promoted, a
    [hidden, 3] classifier head, softmax cross-entropy."""
    sd.convert_to_variables()
    pooled = sd.get_variable(sd.tf_outputs[0])
    w = sd.var("cls_w", shape=(CFG["hidden"], N_CLASSES), init="xavier")
    b = sd.var("cls_b", shape=(N_CLASSES,), init="zeros")
    pooled.mmul(w).add(b).rename("logits")
    sd.placeholder("labels", shape=(CFG["batch"], N_CLASSES))
    sd.ops.softmax_cross_entropy(sd.get_variable("logits"),
                                 sd.get_variable("labels"), name="loss")
    sd.set_loss_variables("loss")
    sd.set_training_config(tc(updater=adam(lr), loss_name="loss"))
    return sd


def _twins(graph, lr):
    """The fine-tune graph in both packages, the port holding the JAX
    graph's values (the head's xavier draws cannot match)."""
    j = _fine_tune(jax_import(graph), JAdam, JTC, lr)
    t = _fine_tune(import_frozen_tf(graph, device="cpu"), PAdam, PTC, lr)
    assert t.variables() == j.variables()
    assert t.variables()[-2:] == ["cls_w", "cls_b"]
    samediff_state_from_numpy(t, {n: np.asarray(v)
                                  for n, v in j._params().items()})
    return j, t


def test_loss_and_every_gradient_match_jax(port_graph):
    data, names = port_graph
    j, t = _twins(data, 1e-3)
    batch, y = _batch(names)
    batch["labels"] = y
    lj = float(j.output(batch, ["loss"])["loss"].to_numpy())
    lt = float(t.output(batch, ["loss"])["loss"])
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    gj = j.calculate_gradients(batch, "loss")
    gt = t.calculate_gradients(batch, "loss")
    # (jax.grad returns its dict sorted by name)
    assert set(gt) == set(gj) and list(gt) == t.variables()
    assert len(gt) == 3 + 16 * CFG["layers"] + 6
    key_biases = {f"add_{5 + 14 * i}/y_0" for i in range(CFG["layers"])}
    for n in gj:
        want = gj[n].to_numpy()
        got = gt[n].numpy()
        assert got.shape == want.shape, n
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if n in key_biases:
            assert scale <= 1e-9 and float(np.abs(got).max()) <= 1e-9, n
            continue
        assert scale > 1e-7, n
        assert err <= 1e-4 * scale, (n, err, scale)


def test_ten_adam_steps_follow_the_jax_losses(port_graph):
    data, names = port_graph
    j, t = _twins(data, 1e-3)
    batch, y = _batch(names)
    batch["labels"] = y
    losses = {"jax": [], "torch": []}
    for _ in range(10):
        losses["jax"].append(j.fit(batch).final_loss())
        losses["torch"].append(t.fit(batch).final_loss())
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-4)
    before = losses["torch"][0]
    after = float(t.output(batch, ["loss"])["loss"])
    assert np.isfinite(after) and after < 0.8 * before, (before, after)
    assert t._iteration == j._iteration == 10
    # the values stayed on the graph's device and changed
    for n in t.variables():
        assert t._vars[n].value.device.type == "cpu"
    np.testing.assert_allclose(
        t._vars["cls_w"].value.numpy(),
        np.asarray(jax.device_get(j._params()["cls_w"])), rtol=1e-3,
        atol=1e-5)


def _structural_graph() -> bytes:
    """IteratorGetNext (two outputs), Tanh, Shape -> StridedSlice folded,
    Reshape with -1 (the shape inferred on the meta device), MatMul,
    Mean over a static axis: the importer's paths beside BERT's."""
    from deeplearning4j_tpu_torch.imports import graphdef as G

    f32, i32 = G.dtype_enum(np.float32), G.dtype_enum(np.int32)
    T = ("T", G.attr("type", f32))

    def node(name, op, inputs, **attrs):
        return G.NodeDef(name, op, inputs, "", attrs)

    def const(name, value):
        value = np.asarray(value)
        return node(name, "Const", [], dtype=G.attr(
            "type", G.dtype_enum(value.dtype)), value=G.attr("tensor", value))

    w = np.random.RandomState(3).normal(size=(4, 5)).astype(np.float32)
    nodes = [
        node("it", "IteratorGetNext", [], output_types=G.attr(
            "list", G.AttrList(type=[f32, f32])), output_shapes=G.attr(
            "list", G.AttrList(shape=[G.TensorShape([2, 3, 4]),
                                      G.TensorShape([2, 1, 5])]))),
        const("shape_of/begin", np.array([0], np.int32)),
        const("shape_of/end", np.array([1], np.int32)),
        const("shape_of/stride", np.array([1], np.int32)),
        const("flat", np.array([-1, 4], np.int32)),
        const("w", w),
        const("axis", np.array([0], np.int32)),
        node("t", "Tanh", ["it"], **dict([T])),
        node("shape", "Shape", ["t"], **dict([T]),
             out_type=G.attr("type", i32)),
        node("batch", "StridedSlice", ["shape", "shape_of/begin",
                                       "shape_of/end", "shape_of/stride"],
             **dict([T]), Index=G.attr("type", i32),
             **{k: G.attr("i", 0) for k in (
                 "begin_mask", "end_mask", "ellipsis_mask", "new_axis_mask",
                 "shrink_axis_mask")}),
        node("r", "Reshape", ["t", "flat"], **dict([T]),
             Tshape=G.attr("type", i32)),
        node("mm", "MatMul", ["r", "w"], **dict([T]),
             transpose_a=G.attr("b", False), transpose_b=G.attr("b", False)),
        node("m", "Mean", ["mm", "axis"], **dict([T]),
             Tidx=G.attr("type", i32), keep_dims=G.attr("b", True)),
        node("out", "AddV2", ["m", "it:1"], **dict([T])),
    ]
    return G.serialize_graph_def(nodes, PF.PRODUCER)


def test_importer_structural_paths_match_jax():
    pytest.importorskip("tensorflow")
    data = _structural_graph()
    j, t = jax_import(data), import_frozen_tf(data, device="cpu")
    assert t.tf_placeholders == j.tf_placeholders == ["it", "it_1"]
    assert t.tf_outputs == j.tf_outputs
    assert [(n, v.vtype, v.shape) for n, v in t._vars.items()] == \
        [(n, v.vtype, v.shape) for n, v in j._vars.items()]
    rs = np.random.RandomState(4)
    feed = {"it": rs.normal(size=(2, 3, 4)).astype(np.float32),
            "it_1": rs.normal(size=(2, 1, 5)).astype(np.float32)}
    out = t.tf_outputs[0]
    got = t.output(feed, [out])[out].numpy()
    want = j.output(feed, [out])[out].to_numpy()
    assert got.shape == (2, 1, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unported_tf_op_raises_by_name():
    from deeplearning4j_tpu_torch.imports import UnsupportedTFOpError
    from deeplearning4j_tpu_torch.imports import graphdef as G

    f32 = G.dtype_enum(np.float32)
    nodes = [G.NodeDef("x", "Placeholder", [], "", {
        "dtype": G.attr("type", f32), "shape": G.attr("shape", [2])}),
        G.NodeDef("y", "Relu", ["x"], "", {"T": G.attr("type", f32)})]
    with pytest.raises(UnsupportedTFOpError, match="'Relu'.*node 'y'"):
        import_frozen_tf(G.serialize_graph_def(nodes, PF.PRODUCER),
                         device="cpu")
