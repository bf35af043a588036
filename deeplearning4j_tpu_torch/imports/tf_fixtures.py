"""The BERT frozen GraphDef, written without TensorFlow.

Counterpart of ``deeplearning4j_tpu/imports/tf_fixtures.py``, which builds
the graph with TensorFlow (a ``tf.function`` frozen by
``convert_variables_to_constants_v2``). The port writes the same frozen
graph straight onto the protobuf wire format (``imports/graphdef.py``):

- the same nodes: op types, attrs, input wiring and names, in the order
  TensorFlow 2.21's freeze emits them (the importer walks the graph in that
  order, so the variables come out in the same order and under the same
  names);
- the same weights, bitwise: drawn from ``np.random.RandomState(seed)`` in
  the order the TensorFlow builder draws them (word, type and position
  embeddings; per layer the q, k, v, o, up and down kernels; the pooler);
  zero biases, unit LayerNorm gains and zero betas draw nothing;
- the constants compressed as frozen constants are (see
  :func:`graphdef.tensor_proto`).

Two names cannot be reproduced from a description of the graph alone, and
neither reaches the imported graph's variables: the position table's
constant, which TensorFlow names by a process-wide counter (``19 + 16 *
layers`` in a fresh process; only its folded slice ``strided_slice`` is
materialized), and the order of the three placeholders, which varies
between TensorFlow runs (here always ``input_ids, token_type_ids,
input_mask``, as ``frozen.inputs`` lists them).

The topology is the canonical BERT encoder's (google-research/bert
``modeling.py``): embedding lookups plus position and token-type
embeddings, LayerNorm as Mean/SquaredDifference/Rsqrt, attention as
Reshape/Transpose/BatchMatMulV2/Softmax with an additive mask bias, the erf
GELU feed-forward, and the tanh pooler over [CLS].
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .graphdef import NodeDef, attr, dtype_enum, serialize_graph_def

#: GraphDef version of TensorFlow 2.21, whose freeze the writer follows
PRODUCER = 2474
F32, I32 = dtype_enum(np.float32), dtype_enum(np.int32)
INPUT_NAMES = ("input_ids", "token_type_ids", "input_mask")


def _n(base: str, i: int) -> str:
    """TensorFlow's unique name: ``base`` for the first, ``base_i`` after."""
    return base if i == 0 else f"{base}_{i}"


class _Graph:
    def __init__(self) -> None:
        self.consts: List[NodeDef] = []
        self.ops: List[NodeDef] = []

    def const(self, name: str, value: np.ndarray) -> str:
        value = np.asarray(value)
        self.consts.append(NodeDef(name, "Const", [], "", {
            "dtype": attr("type", dtype_enum(value.dtype)),
            "value": attr("tensor", value)}))
        return name

    def op(self, name: str, op: str, inputs, **attrs) -> str:
        self.ops.append(NodeDef(name, op, list(inputs), "", {
            k: attr(*v) for k, v in attrs.items()}))
        return name

    def t(self, name: str, op: str, inputs, **attrs) -> str:
        """An op whose only type attr is ``T`` (float32)."""
        return self.op(name, op, inputs, T=("type", F32), **attrs)


def build_bert_frozen_graph(batch: int = 4, seq: int = 128, hidden: int = 768,
                            layers: int = 12, heads: int = 12,
                            intermediate: int = 3072, vocab: int = 30522,
                            type_vocab: int = 2, max_pos: int = 512,
                            seed: int = 0) -> Tuple[bytes, List[str], int]:
    """BERT encoder (base configuration by default) as a serialized frozen
    GraphDef. Returns ``(graphdef_bytes, input_names, n_params)``, as the
    JAX package's builder returns ``(graph_def, input_names, n_params)``.
    Inputs ``input_ids``, ``token_type_ids``, ``input_mask``, all int32
    ``[batch, seq]``; output ``Identity``: the pooled ``[batch, hidden]``."""
    rng = np.random.RandomState(seed)
    std = 0.02

    def w(*shape):
        return rng.normal(0.0, std, shape).astype(np.float32)

    word_emb, type_emb, pos_emb = w(vocab, hidden), w(type_vocab, hidden), \
        w(max_pos, hidden)
    kernels = [{k: w(*s) for k, s in (
        ("q", (hidden, hidden)), ("k", (hidden, hidden)),
        ("v", (hidden, hidden)), ("o", (hidden, hidden)),
        ("up", (hidden, intermediate)), ("down", (intermediate, hidden)))}
        for _ in range(layers)]
    pool_w = w(hidden, hidden)
    zeros = lambda n: np.zeros(n, np.float32)  # noqa: E731
    ones = np.ones(hidden, np.float32)
    head_dim = hidden // heads
    i32 = lambda *v: np.asarray(v, np.int32)  # noqa: E731
    f32 = np.float32

    g = _Graph()
    ph = [NodeDef(n, "Placeholder", [], "", {
        "dtype": attr("type", I32), "shape": attr("shape", [batch, seq])})
        for n in INPUT_NAMES]
    # the GELU's 0.5 of every layer comes first, the last layer's leading
    for i in reversed(range(layers)):
        g.const(f"mul_{6 * i + 5}/x", f32(0.5))

    # embeddings: word + type + position[:seq], then LayerNorm
    g.const("GatherV2/params", word_emb)
    g.const("GatherV2/axis", i32(0).reshape(()))
    g.const("GatherV2_1/params", type_emb)
    g.const("GatherV2_1/axis", i32(0).reshape(()))
    pos = g.const(str(19 + 16 * layers), pos_emb)
    for k, v in (("stack", i32(0)), ("stack_1", i32(seq)),
                 ("stack_2", i32(1))):
        g.const(f"strided_slice/{k}", v)
    gather = dict(Tparams=("type", F32), Tindices=("type", I32),
                  Taxis=("type", I32), batch_dims=("i", 0))
    g.op("GatherV2", "GatherV2", ["GatherV2/params", "input_ids",
                                  "GatherV2/axis"], **gather)
    g.op("GatherV2_1", "GatherV2", ["GatherV2_1/params", "token_type_ids",
                                    "GatherV2_1/axis"], **gather)
    g.t("add", "AddV2", ["GatherV2", "GatherV2_1"])
    masks = dict(begin_mask=1, end_mask=0, ellipsis_mask=0, new_axis_mask=0,
                 shrink_axis_mask=0)
    g.t("strided_slice", "StridedSlice",
        [pos] + [f"strided_slice/{k}" for k in ("stack", "stack_1",
                                                "stack_2")],
        Index=("type", I32), **{k: ("i", v) for k, v in masks.items()})
    g.t("add_1", "AddV2", ["add", "strided_slice"])

    def layer_norm(x: str, mean: int, sub: int, sqd: int, add: int,
                   rsq: int, mul: int, gamma, beta) -> str:
        """Mean, Sub, SquaredDifference, Mean, AddV2 eps, Rsqrt, Mul, Mul
        gain, AddV2 bias; returns the output's name."""
        m0, m1 = _n("Mean", mean), _n("Mean", mean + 1)
        for m in (m0, m1):
            g.const(f"{m}/reduction_indices", i32(-1).reshape(()))
        g.const(f"{_n('add', add)}/y", f32(1e-12))
        g.const(f"{_n('mul', mul + 1)}/y", gamma)
        g.const(f"{_n('add', add + 1)}/y", beta)
        mean_kw = dict(Tidx=("type", I32), keep_dims=("b", True))
        g.t(m0, "Mean", [x, f"{m0}/reduction_indices"], **mean_kw)
        g.t(_n("sub", sub), "Sub", [x, m0])
        g.t(_n("SquaredDifference", sqd), "SquaredDifference", [x, m0])
        g.t(m1, "Mean", [_n("SquaredDifference", sqd),
                         f"{m1}/reduction_indices"], **mean_kw)
        a0, a1 = _n("add", add), _n("add", add + 1)
        g.t(a0, "AddV2", [m1, f"{a0}/y"])
        g.t(_n("Rsqrt", rsq), "Rsqrt", [a0])
        g.t(_n("mul", mul), "Mul", [_n("sub", sub), _n("Rsqrt", rsq)])
        g.t(_n("mul", mul + 1), "Mul", [_n("mul", mul),
                                        f"{_n('mul', mul + 1)}/y"])
        g.t(a1, "AddV2", [_n("mul", mul + 1), f"{a1}/y"])
        return a1

    # node order: TensorFlow emits the consts of a layer norm before its
    # ops, but the embedding norm's ops after the layer norm's consts
    x = layer_norm("add_1", mean=0, sub=0, sqd=0, add=2, rsq=0, mul=0,
                   gamma=ones, beta=zeros(hidden))
    bmm = dict(adj_x=("b", False), grad_x=("b", False), grad_y=("b", False))
    heads_shape = i32(batch, seq, heads, head_dim)
    perm = i32(0, 2, 1, 3)

    def dense_heads(mm: int, add: int, rs: int, tr: int, x: str, kernel):
        """BatchMatMulV2 + bias, Reshape to heads, Transpose."""
        m, a = _n("MatMul", mm), _n("add", add)
        r, t = _n("Reshape", rs), _n("transpose", tr)
        g.const(f"{m}/b", kernel)
        g.const(f"{a}/y", zeros(hidden))
        g.const(f"{r}/shape", heads_shape)
        g.const(f"{t}/perm", perm)
        return m, a, r, t

    for i in range(layers):
        mm, ad, rs, tr = 8 * i, 4 + 14 * i, 1 + 4 * i, 4 * i
        mean, sub, sqd, rsq, mul = 2 + 4 * i, 2 + 2 * i, 1 + 2 * i, \
            1 + 2 * i, 3 + 6 * i
        kw = kernels[i]
        q = dense_heads(mm, ad, rs, tr, x, kw["q"])
        k = dense_heads(mm + 1, ad + 1, rs + 1, tr + 1, x, kw["k"])
        td = _n("truediv", 2 * i)
        g.const(f"{td}/y", f32(np.sqrt(head_dim)))
        if i == 0:
            g.const("sub_1/x", f32(1.0))
            g.const("Reshape/shape", i32(batch, 1, 1, seq))
            g.const("mul_2/y", f32(-10000.0))
        v = dense_heads(mm + 2, ad + 2, rs + 2, tr + 2, x, kw["v"])
        t3, r3 = _n("transpose", tr + 3), _n("Reshape", rs + 3)
        g.const(f"{t3}/perm", perm)
        g.const(f"{r3}/shape", i32(batch, seq, hidden))
        mo, ao = _n("MatMul", mm + 5), _n("add", ad + 4)
        g.const(f"{mo}/b", kw["o"])
        g.const(f"{ao}/y", zeros(hidden))
        # the ops of q, k, the scores, the mask bias (layer 0), softmax, v
        for (m, a, r, t) in (q, k):
            g.t(m, "BatchMatMulV2", [x, f"{m}/b"], adj_y=("b", False), **bmm)
            g.t(a, "AddV2", [m, f"{a}/y"])
            g.t(r, "Reshape", [a, f"{r}/shape"], Tshape=("type", I32))
            g.t(t, "Transpose", [r, f"{t}/perm"], Tperm=("type", I32))
        scores = _n("MatMul", mm + 3)
        g.t(scores, "BatchMatMulV2", [q[3], k[3]], adj_y=("b", True), **bmm)
        g.t(td, "RealDiv", [scores, f"{td}/y"])
        if i == 0:
            g.op("Reshape", "Reshape", ["input_mask", "Reshape/shape"],
                 T=("type", I32), Tshape=("type", I32))
            g.op("Cast", "Cast", ["Reshape"], SrcT=("type", I32),
                 DstT=("type", F32), Truncate=("b", False))
            g.t("sub_1", "Sub", ["sub_1/x", "Cast"])
            g.t("mul_2", "Mul", ["sub_1", "mul_2/y"])
        biased, probs = _n("add", ad + 3), _n("Softmax", i)
        g.t(biased, "AddV2", [td, "mul_2"])
        g.t(probs, "Softmax", [biased])
        m, a, r, t = v
        g.t(m, "BatchMatMulV2", [x, f"{m}/b"], adj_y=("b", False), **bmm)
        g.t(a, "AddV2", [m, f"{a}/y"])
        g.t(r, "Reshape", [a, f"{r}/shape"], Tshape=("type", I32))
        g.t(t, "Transpose", [r, f"{t}/perm"], Tperm=("type", I32))
        ctx = _n("MatMul", mm + 4)
        g.t(ctx, "BatchMatMulV2", [probs, t], adj_y=("b", False), **bmm)
        g.t(t3, "Transpose", [ctx, f"{t3}/perm"], Tperm=("type", I32))
        g.t(r3, "Reshape", [t3, f"{r3}/shape"], Tshape=("type", I32))
        g.t(mo, "BatchMatMulV2", [r3, f"{mo}/b"], adj_y=("b", False), **bmm)
        g.t(ao, "AddV2", [mo, f"{ao}/y"])
        res1 = _n("add", ad + 5)
        g.t(res1, "AddV2", [x, ao])
        x = layer_norm(res1, mean=mean, sub=sub, sqd=sqd, add=ad + 6,
                       rsq=rsq, mul=mul, gamma=ones, beta=zeros(hidden))
        # feed-forward with the erf GELU: 0.5 * h * (1 + erf(h / sqrt(2)))
        mu, au = _n("MatMul", mm + 6), _n("add", ad + 8)
        one, sq2 = _n("add", ad + 9), _n("Sqrt", i)
        md, adn = _n("MatMul", mm + 7), _n("add", ad + 10)
        g.const(f"{mu}/b", kw["up"])
        g.const(f"{au}/y", zeros(intermediate))
        g.const(f"{one}/x", f32(1.0))
        g.const(f"{sq2}/x", f32(2.0))
        g.const(f"{md}/b", kw["down"])
        g.const(f"{adn}/y", zeros(hidden))
        g.t(mu, "BatchMatMulV2", [x, f"{mu}/b"], adj_y=("b", False), **bmm)
        g.t(au, "AddV2", [mu, f"{au}/y"])
        half, div = _n("mul", mul + 2), _n("truediv", 2 * i + 1)
        erf, gelu = _n("Erf", i), _n("mul", mul + 3)
        g.t(half, "Mul", [f"{half}/x", au])
        g.t(sq2, "Sqrt", [f"{sq2}/x"])
        g.t(div, "RealDiv", [au, sq2])
        g.t(erf, "Erf", [div])
        g.t(one, "AddV2", [f"{one}/x", erf])
        g.t(gelu, "Mul", [half, one])
        g.t(md, "BatchMatMulV2", [gelu, f"{md}/b"], adj_y=("b", False), **bmm)
        g.t(adn, "AddV2", [md, f"{adn}/y"])
        res2 = _n("add", ad + 11)
        g.t(res2, "AddV2", [x, adn])
        x = layer_norm(res2, mean=mean + 2, sub=sub + 1, sqd=sqd + 1,
                       add=ad + 12, rsq=rsq + 1, mul=mul + 4, gamma=ones,
                       beta=zeros(hidden))

    # pooler: tanh(x[:, 0] @ W + b)
    for k, v in (("stack", i32(0, 0)), ("stack_1", i32(0, 1)),
                 ("stack_2", i32(1, 1))):
        g.const(f"strided_slice_1/{k}", v)
    mp, ap = _n("MatMul", 8 * layers), _n("add", 4 + 14 * layers)
    g.const(f"{mp}/b", pool_w)
    g.const(f"{ap}/y", zeros(hidden))
    g.t("strided_slice_1", "StridedSlice",
        [x] + [f"strided_slice_1/{k}" for k in ("stack", "stack_1",
                                                "stack_2")],
        Index=("type", I32), begin_mask=("i", 1), end_mask=("i", 1),
        ellipsis_mask=("i", 0), new_axis_mask=("i", 0),
        shrink_axis_mask=("i", 2))
    g.t(mp, "MatMul", ["strided_slice_1", f"{mp}/b"],
        transpose_a=("b", False), transpose_b=("b", False),
        grad_a=("b", False), grad_b=("b", False))
    g.t(ap, "AddV2", [mp, f"{ap}/y"])
    g.t("Tanh", "Tanh", [ap])
    g.t("Identity", "Identity", ["Tanh"])

    data = serialize_graph_def(ph + g.consts + g.ops, PRODUCER)
    n_params = (vocab + type_vocab + max_pos) * hidden + layers * (
        4 * (hidden * hidden + hidden) + 2 * 2 * hidden
        + hidden * intermediate + intermediate + intermediate * hidden + hidden
    ) + 2 * hidden + hidden * hidden + hidden
    return data, list(INPUT_NAMES), n_params


def make_bert_batch(batch: int, seq: int, vocab: int, num_classes: int,
                    seed: int = 0):
    """Synthetic fine-tune minibatch: ids/types/mask + one-hot labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    types = np.zeros((batch, seq), np.int32)
    mask = np.ones((batch, seq), np.int32)
    labels = np.eye(num_classes, dtype=np.float32)[
        rng.randint(0, num_classes, batch)]
    return ids, types, mask, labels
