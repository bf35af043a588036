"""The port's GraphDef reader and BERT writer (imports/graphdef.py,
imports/tf_fixtures.py) against TensorFlow's own protobuf code, and a
TensorFlow-free round trip.

The TensorFlow-built graph is the JAX package's fixture at the size of
tests/test_bert_import.py (batch 2, seq 16, hidden 32, 2 layers, 4 heads):
its frozen constants use every encoding TensorFlow emits (raw
``tensor_content``, one value for a splat, no value for zeros, scalars in
the repeated fields). Arrays are compared bitwise.
"""

from __future__ import annotations

import collections
import struct

import numpy as np
import pytest

from deeplearning4j_tpu_torch.imports import graphdef as G
from deeplearning4j_tpu_torch.imports import tf_fixtures as PF

CFG = dict(batch=2, seq=16, hidden=32, layers=2, heads=4, intermediate=64,
           vocab=97, type_vocab=2, max_pos=32)


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


@pytest.fixture(scope="module")
def tf_graph(tf):
    from deeplearning4j_tpu.imports.tf_fixtures import build_bert_frozen_graph

    gd, names, n = build_bert_frozen_graph(**CFG)
    return gd, names, n


@pytest.fixture(scope="module")
def port_bytes():
    return PF.build_bert_frozen_graph(**CFG)


def _bitwise(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _tf_attr(a):
    """A TF AttrValue as (kind, python value) for comparison."""
    from tensorflow.python.framework import tensor_util

    kind = a.WhichOneof("value")
    v = getattr(a, kind)
    if kind == "tensor":
        return kind, tensor_util.MakeNdarray(v)
    if kind == "shape":
        return kind, [d.size for d in v.dim]
    if kind == "list":
        return kind, {f: list(getattr(v, f)) for f in ("s", "i", "f", "b",
                                                       "type")}
    return kind, v


def _port_attr(a: G.AttrValue):
    if a.kind == "tensor":
        return a.kind, G.make_ndarray(a.value)
    if a.kind == "shape":
        return a.kind, list(a.value.dim)
    if a.kind == "list":
        return a.kind, {f: list(getattr(a.value, f)) for f in (
            "s", "i", "f", "b", "type")}
    return a.kind, a.value


def _same_attr(x, y) -> bool:
    (kx, vx), (ky, vy) = x, y
    if kx != ky:
        return False
    if kx == "tensor":
        return _bitwise(vx, vy)
    return vx == vy


def test_reader_matches_tensorflow_on_tf_built_bytes(tf_graph):
    """Every node's name, op, inputs and attrs, and every Const's array
    bitwise against tensor_util.MakeNdarray, including the zero-value and
    one-value encodings."""
    gd, _, _ = tf_graph
    mine = G.parse_graph_def(gd.SerializeToString())
    assert mine.producer == gd.versions.producer
    assert len(mine.node) == len(gd.node)
    encodings = collections.Counter()
    for x, y in zip(gd.node, mine.node):
        assert (x.name, x.op, list(x.input), x.device) == \
            (y.name, y.op, y.input, y.device)
        assert set(x.attr) == set(y.attr), x.name
        for k in x.attr:
            assert _same_attr(_tf_attr(x.attr[k]), _port_attr(y.attr[k])), \
                (x.name, k)
        if x.op == "Const":
            t = x.attr["value"].tensor
            n = int(np.prod([d.size for d in t.tensor_shape.dim]))
            vals = len(t.float_val) + len(t.int_val)
            encodings["content" if t.tensor_content else
                      "none" if vals == 0 else
                      "one" if vals == 1 and n > 1 else "all"] += 1
    # the fixture's constants use every form TensorFlow's freeze emits
    assert encodings["content"] and encodings["none"] and encodings["one"] \
        and encodings["all"], encodings


def test_writer_bytes_parse_in_tensorflow_and_equal_its_build(tf, tf_graph,
                                                              port_bytes):
    """The port writer's bytes parse in TensorFlow; the nodes come in the
    same order with the same ops, inputs and attrs, and the weights are
    bitwise those of the TensorFlow build (the same RandomState draws).
    Only the position table's constant has another name: TensorFlow names
    it by a process-wide counter."""
    from tensorflow.core.framework import graph_pb2

    gd, names, n = tf_graph
    data, port_names, port_n = port_bytes
    assert port_names == names and port_n == n
    mine = graph_pb2.GraphDef()
    mine.ParseFromString(data)
    tf_pos, my_pos = ([x for x in g.node if x.name == "strided_slice"][0]
                      .input[0] for g in (gd, mine))
    rename = {tf_pos: my_pos}
    # the same bytes, but for the two mentions of that name
    assert len(data) - 2 * len(my_pos) == \
        len(gd.SerializeToString()) - 2 * len(tf_pos)
    ph = lambda g: sorted(x.name for x in g.node  # noqa: E731
                          if x.op == "Placeholder")
    assert ph(gd) == ph(mine) == sorted(names)
    assert [rename.get(x.name, x.name) for x in gd.node
            if x.op != "Placeholder"] == \
        [x.name for x in mine.node if x.op != "Placeholder"]
    assert collections.Counter(x.op for x in gd.node) == \
        collections.Counter(x.op for x in mine.node)
    by_name = {x.name: x for x in mine.node}
    for x in gd.node:
        y = by_name[rename.get(x.name, x.name)]
        assert x.op == y.op and [rename.get(i, i) for i in x.input] == \
            list(y.input), x.name
        assert set(x.attr) == set(y.attr), x.name
        for k in x.attr:
            assert _same_attr(_tf_attr(x.attr[k]), _tf_attr(y.attr[k])), \
                (x.name, k)
        if x.op == "Const":   # compressed as TensorFlow compresses it
            assert x.attr["value"].tensor.SerializeToString() == \
                y.attr["value"].tensor.SerializeToString(), x.name
    # TensorFlow imports and runs it to the TF build's pooled output
    ids, types, mask, _ = PF.make_bert_batch(CFG["batch"], CFG["seq"],
                                             CFG["vocab"], 3)
    outs = []
    for g in (gd, mine):
        graph = tf.Graph()
        with graph.as_default():
            tf.graph_util.import_graph_def(g, name="")
        with tf.compat.v1.Session(graph=graph) as sess:
            outs.append(sess.run("Identity:0", {
                f"{k}:0": v for k, v in zip(names, (ids, types, mask))}))
    assert _bitwise(outs[0], outs[1])


_ROUND_TRIP = {
    "f32_random": np.random.RandomState(0).normal(size=(7, 5)).astype(
        np.float32),
    "f32_zeros": np.zeros((3, 4), np.float32),
    "f32_splat": np.full((33,), 1.0, np.float32),
    "f32_trailing_run": np.array([1.5, 2.0] + [3.0] * 10, np.float32),
    "f32_scalar": np.float32(-2.5).reshape(()),
    "f32_negative_zero": np.full((4,), -0.0, np.float32),
    "f64": np.linspace(-1, 1, 6).reshape(2, 3),
    "i32_pair": np.array([0, 1], np.int32),
    "i32_negative": np.array([-1, -7, 3, 2**31 - 1, -2**31], np.int32),
    "i32_splat_pair": np.array([1, 1], np.int32),
    "i32_scalar_zero": np.int32(0).reshape(()),
    "i64": np.array([-(2**40), 5, 5, 5], np.int64),
    "bool": np.array([True, False, True, True]),
    "u8": np.arange(250, 256, dtype=np.uint8),
    "f16": np.array([0.5, -1.25, 3.0], np.float16),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("name", sorted(_ROUND_TRIP))
def test_tensor_round_trip_without_tensorflow(name):
    """Writer to reader, TF-free: every dtype and encoding comes back
    bitwise."""
    a = _ROUND_TRIP[name]
    enc = b"".join(G.tensor_proto(a))
    back = G.make_ndarray(G.parse_tensor(memoryview(enc)))
    assert _bitwise(np.asarray(a), back), (a, back)


@pytest.mark.parametrize("kind", ["float_val", "int_val", "int64_val",
                                  "bool_val"])
def test_unpacked_repeated_scalars_read_like_packed(kind):
    """Repeated scalars may arrive unpacked (one field per value); with fewer
    values than elements the last one repeats."""
    dtype, field, values, wire = {
        "float_val": (1, 5, [1.5, -2.0], "f"),
        "int_val": (3, 7, [-3, 9], "v"),
        "int64_val": (9, 10, [2**40, -1], "v"),
        "bool_val": (10, 11, [1, 0], "v")}[kind]
    body = G._vi(1, dtype) + b"".join(G._ld(2, G._enc_shape([4])))
    for v in values:
        if wire == "f":
            body += G._key(field, 5) + struct.pack("<f", v)
        else:
            body += G._vi(field, v)
    got = G.make_ndarray(G.parse_tensor(memoryview(body)))
    want = np.asarray(values + [values[-1]] * 2, G.np_dtype(dtype))
    assert _bitwise(got, want)


def test_graph_round_trip_without_tensorflow(port_bytes):
    """The BERT writer's bytes read back node for node: the ops, the
    wiring, the attrs, and the weights as views of the bytes."""
    data, names, _ = port_bytes
    gd = G.parse_graph_def(data)
    assert gd.producer == PF.PRODUCER
    assert [n.name for n in gd.node[:3]] == names
    ops = collections.Counter(n.op for n in gd.node)
    assert ops["BatchMatMulV2"] == 8 * CFG["layers"] and ops["MatMul"] == 1
    assert ops["Softmax"] == ops["Erf"] == ops["Sqrt"] == CFG["layers"]
    table = G.make_ndarray(next(n for n in gd.node if n.name ==
                                "GatherV2/params").attr["value"].value)
    assert table.shape == (CFG["vocab"], CFG["hidden"])
    assert not table.flags.writeable and not table.flags.owndata
    want = np.random.RandomState(0).normal(
        0.0, 0.02, (CFG["vocab"], CFG["hidden"])).astype(np.float32)
    assert _bitwise(table, want)
    ss = next(n for n in gd.node if n.name == "strided_slice_1")
    assert {k: a.value for k, a in ss.attr.items() if a.kind == "i"} == {
        "begin_mask": 1, "end_mask": 1, "ellipsis_mask": 0,
        "new_axis_mask": 0, "shrink_axis_mask": 2}
    # a list attr, encoded and read back
    node = G.NodeDef("n", "Op", ["a", "^b"], "", {"l": G.attr(
        "list", G.AttrList(s=[b"x", b"yz"], i=[1, -2], f=[0.5], b=[True],
                           type=[1, 3], shape=[G.TensorShape([2, -1])]))})
    back = G.parse_graph_def(G.serialize_graph_def([node], 7)).node[0]
    lst = back.attr["l"].value
    assert back.input == ["a", "^b"]
    assert (lst.s, lst.i, lst.f, lst.b, lst.type, lst.shape[0].dim) == (
        [b"x", b"yz"], [1, -2], [0.5], [True], [1, 3], [2, -1])
