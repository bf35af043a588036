"""ONNX and TensorFlow graphs of ResNet-50 and of a BERT-base-width pre-LN
encoder, and Keras files of ResNet-50 and of a character LSTM, written
without ``onnx``, ``protobuf``, TensorFlow, Keras or ``h5py``.

The fixtures of ``chip_smoke.py``'s import phases (33-35) and of the port's
CPU tests (``tests/test_torch_onnx_models.py``). They follow the node
sequences that PyTorch's exporter emits for these architectures, as
``tests/test_onnx_deep_models.py`` writes them at opset 17, and are
serialized by the port's own wire-format writers
(``deeplearning4j_tpu_torch/imports/onnx_ir.py``, ``graphdef.py``):

- ResNet-50 (torchvision's widths): a 7x7/2 stem with 64 channels,
  BatchNorm, ReLU and a 3x3/2 max pool; bottlenecks [3, 4, 6, 3] of widths
  64, 128, 256 and 512 (expansion 4, the stride on the 3x3 convolution, a
  1x1 projection on the first block of each stage); global average pool,
  flatten, a 1000-way Gemm. 25,557,032 parameters and 53,120 BatchNorm
  statistics (102,440,608 bytes of float32 initializers). In ONNX:
  Conv/BatchNormalization/Relu/MaxPool/Add/GlobalAveragePool/Flatten/Gemm,
  NCHW, the batch left open. In TensorFlow (a frozen NHWC GraphDef):
  Conv2D/FusedBatchNormV3/Relu/MaxPool/Pad/AddV2/Mean/MatMul/BiasAdd, with
  explicit ``Pad`` + VALID where PyTorch's symmetric padding differs from
  TF's SAME (the stem, the strided 3x3 convolutions and the max pool,
  which follows a ReLU, so zero padding there is exact).
- The encoder: per block LayerNormalization, the Q/K/V projections as
  MatMul + Add, Reshape to heads (``[0, T, H, dh]``: 0 keeps the batch),
  Transpose, MatMul, Mul by ``1/sqrt(dh)``, Softmax, MatMul, Transpose,
  Reshape back, the output projection and the residual Add, then
  LayerNormalization, a Gelu MLP and the second residual; ReduceMean over
  time and a Gemm head.

The Keras files (``keras_resnet50_h5``, ``keras_char_lstm``) are written by
:func:`write_hdf5`, a writer for the subset of HDF5 that the port's reader
(``deeplearning4j_tpu_torch/imports/hdf5.py``) reads and that h5py writes
by default: superblock version 0, version-1 object headers, groups as
symbol tables (v1 B-trees of group nodes, local heaps, ``SNOD`` nodes),
contiguous little-endian datasets and variable-length string attributes in
global heap collections. ResNet-50 is ``keras.applications.ResNet50(
weights=None)`` as Keras 3 saves it to a legacy ``.h5`` (its 177 layers,
names, configuration fields and ``keras_history`` inbound nodes; the
weights under ``model_weights/<layer>/<layer>/<variable>``); the LSTM is
keras-io's character model (``examples/generative/
lstm_character_level_text_generation.py``: ``Input((40, V))``,
``LSTM(128)``, ``Dense(V, activation="softmax")``) as a Keras 3 ``.keras``
zip (``config.json``, ``metadata.json``, ``model.weights.h5`` with
``layers/<snake_name>/[cell/]vars/<i>``).

Weights come from ``np.random.default_rng(seed)``: He-normal convolutions,
BatchNorm statistics that are not the identity (running means about 0.1,
variances in [0.5, 1.5]) and small gains on each bottleneck's last
BatchNorm so that 16 residual blocks keep the activations' scale; the
encoder's matrices with standard deviation 0.02, as BERT initialises them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.imports import onnx_ir as IR
from deeplearning4j_tpu_torch.imports.graphdef import (AttrList, NodeDef,
                                                       attr,
                                                       serialize_graph_def)
from deeplearning4j_tpu_torch.imports.tf_fixtures import (F32, I32,
                                                          PRODUCER, _Graph)

RESNET50_BLOCKS = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)
RESNET50_PARAMS = 25_557_032
#: the encoder at BERT-base's widths (google-research/bert
#: uncased_L-12_H-768_A-12/bert_config.json), T 128
ENCODER = {"blocks": 12, "d": 768, "heads": 12, "ff": 3072, "t": 128,
           "classes": 4}
BN_EPS = 1e-5
LN_EPS = 1e-5

Params = Dict[str, np.ndarray]


# --- ONNX building blocks ---------------------------------------------------------


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: Optional[str] = None, **attrs) -> IR.NodeProto:
    """A NodeProto; attribute kinds from the Python values, as
    ``onnx.helper.make_node`` infers them."""
    T = IR.AttributeType
    n = IR.NodeProto(input=list(inputs), output=list(outputs),
                     name=name or f"{op_type}_{outputs[0]}", op_type=op_type)
    for k, v in attrs.items():
        a = IR.AttributeProto(name=k)
        if isinstance(v, (bool, int, np.integer)):
            a.type, a.i = T.INT, int(v)
        elif isinstance(v, (float, np.floating)):
            a.type, a.f = T.FLOAT, float(v)
        elif isinstance(v, str):
            a.type, a.s = T.STRING, v.encode()
        elif isinstance(v, (list, tuple)) and v and isinstance(
                v[0], (float, np.floating)):
            a.type, a.floats = T.FLOATS, [float(x) for x in v]
        elif isinstance(v, (list, tuple)):
            a.type, a.ints = T.INTS, [int(x) for x in v]
        else:
            raise TypeError(f"attr {k}: unsupported {type(v)}")
        n.attribute.append(a)
    return n


def _value_info(name: str, shape: Sequence[Optional[int]]
                ) -> IR.ValueInfoProto:
    dims = [IR.Dimension(dim_value=int(d)) if d is not None
            else IR.Dimension(dim_param="N") for d in shape]
    return IR.ValueInfoProto(name=name, type=IR.TypeProto(
        tensor_type=IR.TypeTensor(elem_type=IR.DataType.FLOAT,
                                  shape=IR.TensorShapeProto(dim=dims))))


def make_model(nodes: Iterable[IR.NodeProto],
               inputs: Sequence[Tuple[str, Sequence[Optional[int]]]],
               outputs: Sequence[str], initializers: Params,
               opset: int = 17) -> bytes:
    """The serialized ModelProto (float32 inputs)."""
    g = IR.GraphProto(name="fixture", node=list(nodes))
    g.input = [_value_info(n, s) for n, s in inputs]
    g.output = [IR.ValueInfoProto(name=n) for n in outputs]
    g.initializer = [IR.numpy_to_tensor(a, n)
                     for n, a in initializers.items()]
    m = IR.ModelProto(ir_version=8, producer_name="deeplearning4j-fixture",
                      graph=g,
                      opset_import=[IR.OperatorSetIdProto("", opset)])
    return IR.serialize_model(m)


def n_params(params: Params) -> int:
    """The trainable parameters (BatchNorm's running statistics are
    buffers, as torchvision counts them)."""
    return int(sum(a.size for k, a in params.items()
                   if not k.endswith(("_rm", "_rv"))))


# --- ResNet-50 ----------------------------------------------------------------------


def _stages(blocks: Sequence[int], widths: Sequence[int]):
    """(prefix, cin, width, stride, has projection) per bottleneck."""
    cin = widths[0]
    for si, (n, w) in enumerate(zip(blocks, widths)):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            yield f"l{si}b{bi}", cin, w, stride, bi == 0
            cin = 4 * w


def resnet50_params(seed: int = 0, blocks=RESNET50_BLOCKS,
                    widths=RESNET50_WIDTHS, classes: int = 1000) -> Params:
    """Seeded ResNet-50 weights by name (conv OIHW; ``fc_w`` ``[classes,
    features]``, the Gemm's transB layout)."""
    rng = np.random.default_rng(seed)

    def conv(o, i, k):
        return (rng.standard_normal((o, i, k, k), dtype=np.float32)
                * np.float32(np.sqrt(2.0 / (i * k * k))))

    def bn(p, c, gain=(0.8, 1.2)):
        out[f"{p}_g"] = rng.uniform(*gain, c).astype(np.float32)
        out[f"{p}_b"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        out[f"{p}_rm"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        out[f"{p}_rv"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    out: Params = {}
    out["c1_w"] = conv(widths[0], 3, 7)
    bn("bn1", widths[0])
    for p, cin, w, _, proj in _stages(blocks, widths):
        out[f"{p}_w1"] = conv(w, cin, 1)
        bn(f"{p}_bn1", w)
        out[f"{p}_w2"] = conv(w, w, 3)
        bn(f"{p}_bn2", w)
        out[f"{p}_w3"] = conv(4 * w, w, 1)
        bn(f"{p}_bn3", 4 * w, gain=(0.1, 0.3))
        if proj:
            out[f"{p}_dw"] = conv(4 * w, cin, 1)
            bn(f"{p}_dbn", 4 * w)
    feat = 4 * widths[-1]
    out["fc_w"] = (rng.standard_normal((classes, feat), dtype=np.float32)
                   * np.float32(np.sqrt(1.0 / feat)))
    out["fc_b"] = (0.01 * rng.standard_normal(classes)).astype(np.float32)
    return out


def _bn_node(p: str, src: str, dst: str) -> IR.NodeProto:
    return make_node("BatchNormalization",
                     [src, f"{p}_g", f"{p}_b", f"{p}_rm", f"{p}_rv"], [dst],
                     epsilon=BN_EPS)


def resnet50_onnx(params: Params, blocks=RESNET50_BLOCKS,
                  widths=RESNET50_WIDTHS, image: int = 224,
                  batch: Optional[int] = None) -> bytes:
    """The exporter-shaped NCHW ONNX model of ``params``; input ``x``
    ``[batch, 3, image, image]`` (batch open by default), output
    ``logits``."""
    nodes: List[IR.NodeProto] = [
        make_node("Conv", ["x", "c1_w"], ["c1"], kernel_shape=[7, 7],
                  strides=[2, 2], pads=[3, 3, 3, 3]),
        _bn_node("bn1", "c1", "n1"),
        make_node("Relu", ["n1"], ["r1"]),
        make_node("MaxPool", ["r1"], ["p1"], kernel_shape=[3, 3],
                  strides=[2, 2], pads=[1, 1, 1, 1])]
    h = "p1"
    for p, _, _, s, proj in _stages(blocks, widths):
        nodes += [
            make_node("Conv", [h, f"{p}_w1"], [f"{p}_c1"],
                      kernel_shape=[1, 1]),
            _bn_node(f"{p}_bn1", f"{p}_c1", f"{p}_n1"),
            make_node("Relu", [f"{p}_n1"], [f"{p}_r1"]),
            make_node("Conv", [f"{p}_r1", f"{p}_w2"], [f"{p}_c2"],
                      kernel_shape=[3, 3], strides=[s, s],
                      pads=[1, 1, 1, 1]),
            _bn_node(f"{p}_bn2", f"{p}_c2", f"{p}_n2"),
            make_node("Relu", [f"{p}_n2"], [f"{p}_r2"]),
            make_node("Conv", [f"{p}_r2", f"{p}_w3"], [f"{p}_c3"],
                      kernel_shape=[1, 1]),
            _bn_node(f"{p}_bn3", f"{p}_c3", f"{p}_n3")]
        idn = h
        if proj:
            nodes += [
                make_node("Conv", [h, f"{p}_dw"], [f"{p}_dc"],
                          kernel_shape=[1, 1], strides=[s, s]),
                _bn_node(f"{p}_dbn", f"{p}_dc", f"{p}_dn")]
            idn = f"{p}_dn"
        nodes += [make_node("Add", [f"{p}_n3", idn], [f"{p}_sum"]),
                  make_node("Relu", [f"{p}_sum"], [f"{p}_out"])]
        h = f"{p}_out"
    nodes += [make_node("GlobalAveragePool", [h], ["gap"]),
              make_node("Flatten", ["gap"], ["flat"], axis=1),
              make_node("Gemm", ["flat", "fc_w", "fc_b"], ["logits"],
                        transB=1)]
    return make_model(nodes, [("x", [batch, 3, image, image])], ["logits"],
                      params)


class _TFGraph(_Graph):
    """The BERT fixture's graph writer with ResNet's building blocks."""

    def pad(self, name: str, src: str, p: int) -> str:
        c = self.const(f"{name}/paddings", np.array(
            [[0, 0], [p, p], [p, p], [0, 0]], np.int32))
        return self.t(name, "Pad", [src, c], Tpaddings=("type", I32))

    def conv(self, name: str, src: str, w: np.ndarray, stride: int,
             padding: str) -> str:
        k = self.const(f"{name}/filter",
                       np.ascontiguousarray(w.transpose(2, 3, 1, 0)))  # HWIO
        return self.t(name, "Conv2D", [src, k],
                      strides=("list", AttrList(i=[1, stride, stride, 1])),
                      padding=("s", padding), data_format=("s", "NHWC"),
                      dilations=("list", AttrList(i=[1, 1, 1, 1])),
                      use_cudnn_on_gpu=("b", True))

    def bn(self, name: str, src: str, params: Params, p: str) -> str:
        ins = [src] + [self.const(f"{name}/{k}", params[f"{p}_{k}"])
                       for k in ("g", "b", "rm", "rv")]
        return self.t(name, "FusedBatchNormV3", ins, U=("type", F32),
                      epsilon=("f", BN_EPS), is_training=("b", False),
                      data_format=("s", "NHWC"),
                      exponential_avg_factor=("f", 1.0))

    def relu(self, name: str, src: str) -> str:
        return self.t(name, "Relu", [src])


def resnet50_graphdef(params: Params, batch: int, blocks=RESNET50_BLOCKS,
                      widths=RESNET50_WIDTHS, image: int = 224) -> bytes:
    """The same network as a frozen NHWC GraphDef: input ``x`` ``[batch,
    image, image, 3]``, output the BiasAdd ``logits``."""
    g = _TFGraph()
    x = NodeDef("x", "Placeholder", [], "", {
        "dtype": attr("type", F32),
        "shape": attr("shape", [batch, image, image, 3])})
    h = g.pad("stem/pad", "x", 3)
    h = g.conv("stem/conv", h, params["c1_w"], 2, "VALID")
    h = g.relu("stem/relu", g.bn("stem/bn", h, params, "bn1"))
    h = g.pad("stem/pool_pad", h, 1)
    h = g.t("stem/pool", "MaxPool", [h],
            ksize=("list", AttrList(i=[1, 3, 3, 1])),
            strides=("list", AttrList(i=[1, 2, 2, 1])),
            padding=("s", "VALID"), data_format=("s", "NHWC"))
    for p, _, _, s, proj in _stages(blocks, widths):
        r = g.relu(f"{p}/r1", g.bn(f"{p}/bn1", g.conv(
            f"{p}/c1", h, params[f"{p}_w1"], 1, "VALID"), params,
            f"{p}_bn1"))
        if s == 1:
            c2 = g.conv(f"{p}/c2", r, params[f"{p}_w2"], 1, "SAME")
        else:
            c2 = g.conv(f"{p}/c2", g.pad(f"{p}/pad", r, 1),
                        params[f"{p}_w2"], s, "VALID")
        r = g.relu(f"{p}/r2", g.bn(f"{p}/bn2", c2, params, f"{p}_bn2"))
        n3 = g.bn(f"{p}/bn3", g.conv(f"{p}/c3", r, params[f"{p}_w3"], 1,
                                     "VALID"), params, f"{p}_bn3")
        idn = h
        if proj:
            idn = g.bn(f"{p}/dbn", g.conv(f"{p}/dc", h, params[f"{p}_dw"],
                                          s, "VALID"), params, f"{p}_dbn")
        h = g.relu(f"{p}/out", g.t(f"{p}/add", "AddV2", [n3, idn]))
    axes = g.const("gap/axes", np.array([1, 2], np.int32))
    h = g.t("gap", "Mean", [h, axes], Tidx=("type", I32),
            keep_dims=("b", False))
    w = g.const("fc/w", np.ascontiguousarray(params["fc_w"].T))
    h = g.t("fc/matmul", "MatMul", [h, w], transpose_a=("b", False),
            transpose_b=("b", False))
    b = g.const("fc/b", params["fc_b"])
    g.t("logits", "BiasAdd", [h, b], data_format=("s", "NHWC"))
    return serialize_graph_def([x] + g.consts + g.ops, PRODUCER)


# --- the pre-LN encoder ---------------------------------------------------------------


def encoder_params(seed: int = 0, blocks: int = ENCODER["blocks"],
                   d: int = ENCODER["d"], ff: int = ENCODER["ff"],
                   classes: int = ENCODER["classes"]) -> Params:
    """Seeded encoder weights by name: linear weights ``[in, out]`` (the
    MatMul layout), ``head_w`` ``[classes, d]`` (the Gemm's transB)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) \
            * np.float32(0.02)

    def small(n):
        return (0.02 * rng.standard_normal(n)).astype(np.float32)

    out: Params = {}
    for bi in range(blocks):
        p = f"b{bi}"
        for ln in ("ln1", "ln2"):
            out[f"{p}_{ln}_g"] = (1.0 + 0.1 * rng.standard_normal(d)
                                  ).astype(np.float32)
            out[f"{p}_{ln}_b"] = small(d)
        for name, (i, o) in (("q", (d, d)), ("k", (d, d)), ("v", (d, d)),
                             ("o", (d, d)), ("f1", (d, ff)), ("f2", (ff, d))):
            out[f"{p}_{name}_w"] = w(i, o)
            out[f"{p}_{name}_b"] = small(o)
    out["head_w"] = w(classes, d)
    out["head_b"] = small(classes)
    return out


def encoder_onnx(params: Params, blocks: int = ENCODER["blocks"],
                 d: int = ENCODER["d"], heads: int = ENCODER["heads"],
                 t: int = ENCODER["t"], batch: Optional[int] = None) -> bytes:
    """The exporter-shaped pre-LN encoder: input ``x`` ``[batch, t, d]``
    (batch open by default), output ``logits``."""
    dh = d // heads
    init = dict(params)
    init["scale"] = np.asarray(1.0 / dh ** 0.5, np.float32)
    init["shape_heads"] = np.asarray([0, t, heads, dh], np.int64)
    init["shape_flat"] = np.asarray([0, t, d], np.int64)
    nodes: List[IR.NodeProto] = []

    def linear(p, src, dst):
        nodes.extend([make_node("MatMul", [src, f"{p}_w"], [f"{p}_mm"]),
                      make_node("Add", [f"{p}_mm", f"{p}_b"], [dst])])

    cur = "x"
    for bi in range(blocks):
        p = f"b{bi}"
        nodes.append(make_node("LayerNormalization",
                               [cur, f"{p}_ln1_g", f"{p}_ln1_b"], [f"{p}_h"],
                               axis=-1, epsilon=LN_EPS))
        for w in ("q", "k", "v"):
            linear(f"{p}_{w}", f"{p}_h", f"{p}_{w}p")
            nodes.extend([
                make_node("Reshape", [f"{p}_{w}p", "shape_heads"],
                          [f"{p}_{w}r"]),
                make_node("Transpose", [f"{p}_{w}r"], [f"{p}_{w}t"],
                          perm=[0, 2, 1, 3])])
        nodes.extend([
            make_node("Transpose", [f"{p}_kt"], [f"{p}_ktt"],
                      perm=[0, 1, 3, 2]),
            make_node("MatMul", [f"{p}_qt", f"{p}_ktt"], [f"{p}_qk"]),
            make_node("Mul", [f"{p}_qk", "scale"], [f"{p}_qks"]),
            make_node("Softmax", [f"{p}_qks"], [f"{p}_attn"], axis=-1),
            make_node("MatMul", [f"{p}_attn", f"{p}_vt"], [f"{p}_av"]),
            make_node("Transpose", [f"{p}_av"], [f"{p}_avt"],
                      perm=[0, 2, 1, 3]),
            make_node("Reshape", [f"{p}_avt", "shape_flat"], [f"{p}_avf"])])
        linear(f"{p}_o", f"{p}_avf", f"{p}_op")
        nodes.append(make_node("Add", [cur, f"{p}_op"], [f"{p}_res1"]))
        nodes.append(make_node("LayerNormalization",
                               [f"{p}_res1", f"{p}_ln2_g", f"{p}_ln2_b"],
                               [f"{p}_h2"], axis=-1, epsilon=LN_EPS))
        linear(f"{p}_f1", f"{p}_h2", f"{p}_f1o")
        nodes.append(make_node("Gelu", [f"{p}_f1o"], [f"{p}_gelu"]))
        linear(f"{p}_f2", f"{p}_gelu", f"{p}_f2o")
        nodes.append(make_node("Add", [f"{p}_res1", f"{p}_f2o"],
                               [f"{p}_out"]))
        cur = f"{p}_out"
    nodes += [make_node("ReduceMean", [cur], ["pooled"], axes=[1],
                        keepdims=0),
              make_node("Gemm", ["pooled", "head_w", "head_b"], ["logits"],
                        transB=1)]
    return make_model(nodes, [("x", [batch, t, d])], ["logits"], init)


# --- HDF5 ------------------------------------------------------------------------------

_UNDEF = b"\xff" * 8
_LEAF_K, _NODE_K = 4, 16          # h5py's defaults: 8 links an SNOD, 32 a node


class H5Group:
    """A group to write: ``attrs`` by name (a ``str``, a list of strings,
    or a numpy array) and ``members`` by name (an ``H5Group`` or a numpy
    array, written as a contiguous dataset)."""

    def __init__(self, attrs: Optional[Dict] = None,
                 members: Optional[Dict] = None):
        self.attrs = dict(attrs or {})
        self.members = dict(members or {})

    def group(self, path: str) -> "H5Group":
        """The subgroup at ``path`` ("a/b"), made where missing."""
        g = self
        for part in path.split("/"):
            g = g.members.setdefault(part, H5Group())
        return g


def _u(n: int, size: int = 8) -> bytes:
    return int(n).to_bytes(size, "little")


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _dtype_msg(dt: np.dtype) -> bytes:
    """An HDF5 datatype message for a little-endian number."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        exp, man, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                          8: (11, 52, 1023)}[dt.itemsize]
        bits = bytes([0x20, 8 * dt.itemsize - 1, 0])
        return (bytes([0x11]) + bits + _u(dt.itemsize, 4) + _u(0, 2)
                + _u(8 * dt.itemsize, 2) + bytes([man, exp, 0, man])
                + _u(bias, 4))
    if dt.kind in "iu":
        bits = bytes([0x08 if dt.kind == "i" else 0, 0, 0])
        return (bytes([0x10]) + bits + _u(dt.itemsize, 4) + _u(0, 2)
                + _u(8 * dt.itemsize, 2))
    raise ValueError(f"the fixture writer writes no {dt} data")


def _vlen_str_type(utf8: bool) -> bytes:
    base = bytes([0x10, 0, 0, 0]) + _u(1, 4) + _u(0, 2) + _u(8, 2)
    return bytes([0x19, 0x01, 0x01 if utf8 else 0, 0]) + _u(16, 4) + base


def _space_msg(shape: Tuple[int, ...]) -> bytes:
    out = bytes([1, len(shape), 1 if shape else 0, 0]) + _u(0, 4)
    dims = b"".join(_u(d) for d in shape)
    return out + dims + dims


class _H5Writer:
    """Lays a tree out bottom-up: every object is written after the
    objects it points to, so each address is known when it is needed."""

    def __init__(self):
        self.out = bytearray(96)            # the superblock, written last
        self.strings: Dict[str, Tuple[int, int]] = {}

    def alloc(self, data: bytes) -> int:
        self.out += b"\0" * (-len(self.out) % 8)
        at = len(self.out)
        self.out += data
        return at

    # --- the global heap --------------------------------------------------------
    def heap_strings(self, values: List[str]) -> None:
        pending = [v for v in dict.fromkeys(values) if v not in self.strings]
        while pending:
            chunk, pending = pending[:60000], pending[60000:]
            objs, at = [], 16
            for i, v in enumerate(chunk, 1):
                data = v.encode("utf-8")
                objs.append(_u(i, 2) + _u(1, 2) + _u(0, 4) + _u(len(data))
                            + _pad8(data))
            body = b"".join(objs)
            size = max(4096, 16 + len(body) + 16)
            free = size - 16 - len(body)
            blob = (b"GCOL" + bytes([1, 0, 0, 0]) + _u(size) + body
                    + _u(0, 2) + _u(0, 2) + _u(0, 4) + _u(free)
                    + b"\0" * (free - 16))
            addr = self.alloc(blob)
            for i, v in enumerate(chunk, 1):
                self.strings[v] = (addr, i)

    # --- object headers -----------------------------------------------------
    def header(self, msgs: List[Tuple[int, bytes]]) -> int:
        body = b""
        for mtype, data in msgs:
            data = _pad8(data)
            if len(data) > 0xFFFF:
                raise ValueError("an object header message over 64 KiB")
            body += _u(mtype, 2) + _u(len(data), 2) + bytes(4) + data
        return self.alloc(bytes([1, 0]) + _u(len(msgs), 2) + _u(1, 4)
                          + _u(len(body), 4) + bytes(4) + body)

    def attribute(self, name: str, value) -> bytes:
        nm = name.encode("utf-8") + b"\0"
        if isinstance(value, str) or (isinstance(value, (list, tuple))
                                      and all(isinstance(v, (str, bytes))
                                              for v in value) and value):
            vals = [value] if isinstance(value, str) else [
                v.decode() if isinstance(v, bytes) else v for v in value]
            shape = () if isinstance(value, str) else (len(vals),)
            utf8 = not all(v.isascii() for v in vals)
            dt = _vlen_str_type(utf8)
            data = b"".join(_u(len(v.encode("utf-8")), 4)
                            + _u(self.strings[v][0])
                            + _u(self.strings[v][1], 4) for v in vals)
        else:
            arr = np.ascontiguousarray(value)
            shape, dt, data = arr.shape, _dtype_msg(arr.dtype), arr.tobytes()
        space = _space_msg(tuple(shape))
        return (bytes([1, 0]) + _u(len(nm), 2) + _u(len(dt), 2)
                + _u(len(space), 2) + _pad8(nm) + _pad8(dt) + _pad8(space)
                + data)

    def attr_msgs(self, attrs: Dict) -> List[Tuple[int, bytes]]:
        return [(0x0C, self.attribute(k, v)) for k, v in attrs.items()]

    # --- objects --------------------------------------------------------------
    def dataset(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            raise ValueError("the fixture writer writes little-endian data")
        addr = self.alloc(arr.tobytes()) if arr.nbytes else None
        layout = (bytes([3, 1]) + (_u(addr) if addr is not None else _UNDEF)
                  + _u(arr.nbytes))
        return self.header([(0x01, _space_msg(arr.shape)),
                            (0x03, _dtype_msg(arr.dtype)),
                            (0x08, layout)])

    def group(self, g: H5Group) -> Tuple[int, int, int]:
        """(object header, B-tree, local heap) addresses of ``g``."""
        entries = []
        for name in sorted(g.members, key=lambda n: n.encode("utf-8")):
            m = g.members[name]
            if isinstance(m, H5Group):
                hdr, bt, hp = self.group(m)
                entries.append((name, hdr, (bt, hp)))
            else:
                entries.append((name, self.dataset(m), None))
        heap, offsets = b"\0" * 8, {}
        for name, _, _ in entries:
            offsets[name] = len(heap)
            heap += _pad8(name.encode("utf-8") + b"\0")
        heap_data = self.alloc(heap)
        heap_addr = self.alloc(b"HEAP" + bytes(4) + _u(len(heap)) + _u(1)
                               + _u(heap_data))
        # the leaves: SNODs of up to 2K links, then B-tree levels of up to
        # 2K children; each key is the heap offset of the last name on its
        # left (key 0 the empty name)
        level = []
        for i in range(0, len(entries), 2 * _LEAF_K):
            part = entries[i:i + 2 * _LEAF_K]
            body = b""
            for name, hdr, cache in part:
                scratch = (_u(cache[0]) + _u(cache[1])) if cache else bytes(16)
                body += (_u(offsets[name]) + _u(hdr)
                         + _u(1 if cache else 0, 4) + bytes(4) + scratch)
            body += bytes(40 * (2 * _LEAF_K - len(part)))
            level.append((self.alloc(b"SNOD" + bytes([1, 0])
                                     + _u(len(part), 2) + body),
                          offsets[part[-1][0]]))
        depth = 0
        while True:
            nodes = []
            for i in range(0, max(len(level), 1), 2 * _NODE_K):
                part = level[i:i + 2 * _NODE_K]
                body = _u(0)
                for child, last in part:
                    body += _u(child) + _u(last)
                body += bytes(16 * (2 * _NODE_K - len(part)))
                nodes.append((self.alloc(b"TREE" + bytes([0, depth])
                                         + _u(len(part), 2) + _UNDEF
                                         + _UNDEF + body),
                              part[-1][1] if part else 0))
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            level, depth = nodes, depth + 1
        hdr = self.header([(0x11, _u(btree) + _u(heap_addr))]
                          + self.attr_msgs(g.attrs))
        return hdr, btree, heap_addr

    def file(self, root: H5Group) -> bytes:
        strings: List[str] = []

        def gather(g: H5Group):
            for v in g.attrs.values():
                if isinstance(v, str):
                    strings.append(v)
                elif isinstance(v, (list, tuple)):
                    strings.extend(x.decode() if isinstance(x, bytes) else x
                                   for x in v)
            for m in g.members.values():
                if isinstance(m, H5Group):
                    gather(m)

        gather(root)
        self.heap_strings(strings)
        hdr, btree, heap = self.group(root)
        self.out += b"\0" * (-len(self.out) % 8)
        sb = (b"\x89HDF\r\n\x1a\n" + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + _u(_LEAF_K, 2) + _u(_NODE_K, 2) + _u(0, 4)
              + _u(0) + _UNDEF + _u(len(self.out)) + _UNDEF
              + _u(0) + _u(hdr) + _u(1, 4) + bytes(4) + _u(btree) + _u(heap))
        self.out[:96] = sb
        return bytes(self.out)


def write_hdf5(root: H5Group) -> bytes:
    """The bytes of an HDF5 file holding ``root``'s tree."""
    return _H5Writer().file(root)


# --- Keras ResNet-50 (legacy .h5) ------------------------------------------------------

KERAS_VERSION = "3.13.1"
KERAS_BN_EPS = 1.001e-5
#: a ``Sequential([Input((40, V)), LSTM(128), Dense(V, "softmax")])`` of
#: keras-io's character model; V is the corpus's character count
CHAR_LSTM = {"maxlen": 40, "units": 128}

_DTYPE_POLICY = {"module": "keras", "class_name": "DTypePolicy",
                 "config": {"name": "float32"}, "registered_name": None}


def _init(cls: str, **config) -> Dict:
    return {"module": "keras.initializers", "class_name": cls,
            "config": config, "registered_name": None}


def _ktensor(src: str, shape) -> Dict:
    return {"class_name": "__keras_tensor__",
            "config": {"shape": [None] + list(shape), "dtype": "float32",
                       "keras_history": [src, 0, 0]}}


class _KerasGraph:
    """Keras 3's functional ``model_config`` as the legacy ``.h5`` holds
    it: per layer ``class_name``, ``config``, ``name``, ``inbound_nodes``
    (``keras_history`` tensors), in Keras's topological order."""

    def __init__(self, image: int):
        self.layers: List[Dict] = [{
            "class_name": "InputLayer",
            "config": {"batch_shape": [None, image, image, 3],
                       "dtype": "float32", "sparse": False, "ragged": False,
                       "name": "input_layer", "optional": False},
            "name": "input_layer", "inbound_nodes": []}]
        self.shape = {"input_layer": (image, image, 3)}

    def add(self, cls: str, name: str, srcs: Sequence[str], shape,
            kwargs: Optional[Dict] = None, **config) -> str:
        tensors = [_ktensor(s, self.shape[s]) for s in srcs]
        args = [tensors] if len(tensors) > 1 else tensors
        self.layers.append({
            "class_name": cls,
            "config": {"name": name, "trainable": True,
                       "dtype": dict(_DTYPE_POLICY), **config},
            "name": name,
            "inbound_nodes": [{"args": args, "kwargs": kwargs or {}}]})
        self.shape[name] = tuple(shape)
        return name

    def conv(self, name: str, src: str, filters: int, k: int, stride: int,
             padding: str = "valid") -> str:
        h, w, _ = self.shape[src]
        if padding == "valid":
            h, w = (h - k) // stride + 1, (w - k) // stride + 1
        else:
            h, w = -(-h // stride), -(-w // stride)
        return self.add(
            "Conv2D", name, [src], (h, w, filters), filters=filters,
            kernel_size=[k, k], strides=[stride, stride], padding=padding,
            data_format="channels_last", dilation_rate=[1, 1], groups=1,
            activation="linear", use_bias=True,
            kernel_initializer=_init("GlorotUniform", seed=None),
            bias_initializer=_init("Zeros"), kernel_regularizer=None,
            bias_regularizer=None, activity_regularizer=None,
            kernel_constraint=None, bias_constraint=None)

    def bn(self, name: str, src: str) -> str:
        return self.add(
            "BatchNormalization", name, [src], self.shape[src],
            kwargs={"mask": None}, axis=3, momentum=0.99,
            epsilon=KERAS_BN_EPS, center=True, scale=True,
            beta_initializer=_init("Zeros"), gamma_initializer=_init("Ones"),
            moving_mean_initializer=_init("Zeros"),
            moving_variance_initializer=_init("Ones"),
            beta_regularizer=None, gamma_regularizer=None,
            beta_constraint=None, gamma_constraint=None, synchronized=False)

    def relu(self, name: str, src: str) -> str:
        return self.add("Activation", name, [src], self.shape[src],
                        activation="relu")

    def pad(self, name: str, src: str, p: int) -> str:
        h, w, c = self.shape[src]
        return self.add("ZeroPadding2D", name, [src], (h + 2 * p, w + 2 * p,
                                                      c),
                        padding=[[p, p], [p, p]], data_format="channels_last")


def _keras_blocks(blocks: Sequence[int], widths: Sequence[int]):
    """(prefix, width, stride, conv shortcut) per block of Keras's
    ``stack1``: the stride on the block's first 1x1 convolution and on its
    shortcut."""
    for si, (n, w) in enumerate(zip(blocks, widths)):
        for bi in range(n):
            yield (f"conv{si + 2}_block{bi + 1}", w,
                   2 if si > 0 and bi == 0 else 1, bi == 0)


def keras_resnet50_config(blocks=RESNET50_BLOCKS, widths=RESNET50_WIDTHS,
                          image: int = 224, classes: int = 1000) -> Dict:
    """The ``model_config`` of ``keras.applications.ResNet50(weights=None,
    input_shape=(image, image, 3), classes=classes)`` as Keras 3 writes it
    to a legacy ``.h5``."""
    g = _KerasGraph(image)
    h = g.pad("conv1_pad", "input_layer", 3)
    h = g.conv("conv1_conv", h, widths[0], 7, 2)
    h = g.relu("conv1_relu", g.bn("conv1_bn", h))
    h = g.pad("pool1_pad", h, 1)
    hh, ww, c = g.shape[h]
    h = g.add("MaxPooling2D", "pool1_pool", [h],
              ((hh - 3) // 2 + 1, (ww - 3) // 2 + 1, c), pool_size=[3, 3],
              padding="valid", strides=[2, 2], data_format="channels_last")
    for p, w, s, shortcut in _keras_blocks(blocks, widths):
        x = g.relu(f"{p}_1_relu", g.bn(f"{p}_1_bn", g.conv(
            f"{p}_1_conv", h, w, 1, s)))
        x = g.relu(f"{p}_2_relu", g.bn(f"{p}_2_bn", g.conv(
            f"{p}_2_conv", x, w, 3, 1, "same")))
        if shortcut:
            sc = g.conv(f"{p}_0_conv", h, 4 * w, 1, s)
            x = g.conv(f"{p}_3_conv", x, 4 * w, 1, 1)
            sc = g.bn(f"{p}_0_bn", sc)
        else:
            sc = h
            x = g.conv(f"{p}_3_conv", x, 4 * w, 1, 1)
        x = g.bn(f"{p}_3_bn", x)
        x = g.add("Add", f"{p}_add", [sc, x], g.shape[x])
        h = g.relu(f"{p}_out", x)
    h = g.add("GlobalAveragePooling2D", "avg_pool", [h], (g.shape[h][-1],),
              data_format="channels_last", keepdims=False)
    g.add("Dense", "predictions", [h], (classes,), units=classes,
          activation="softmax", use_bias=True,
          kernel_initializer=_init("GlorotUniform", seed=None),
          bias_initializer=_init("Zeros"), kernel_regularizer=None,
          bias_regularizer=None, kernel_constraint=None,
          bias_constraint=None, quantization_config=None)
    return {"class_name": "Functional",
            "config": {"name": "resnet50", "trainable": True,
                       "layers": g.layers,
                       "input_layers": ["input_layer", 0, 0],
                       "output_layers": ["predictions", 0, 0]}}


def keras_resnet50_weights(config: Dict, seed: int = 0) -> Dict[str, Dict]:
    """Seeded weights by layer, in Keras's layouts and ``weight_names``
    order: convolutions HWIO (He-normal) with small biases, BatchNorm's
    gamma, beta, moving mean and variance (not the identity; gains of 0.1
    to 0.3 on each block's last BatchNorm), the Dense kernel ``[in,
    out]``."""
    rng = np.random.default_rng(seed)
    chans = {"input_layer": 3}
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for l in config["config"]["layers"]:
        name, c = l["name"], l["config"]
        srcs = [t["config"]["keras_history"][0]
                for node in l["inbound_nodes"] for a in node["args"]
                for t in (a if isinstance(a, list) else [a])]
        cin = chans.get(srcs[0]) if srcs else None
        if l["class_name"] == "Conv2D":
            k, o = c["kernel_size"][0], c["filters"]
            out[name] = {
                "kernel": (rng.standard_normal((k, k, cin, o),
                                               dtype=np.float32)
                           * np.float32(np.sqrt(2.0 / (cin * k * k)))),
                "bias": (0.01 * rng.standard_normal(o)).astype(np.float32)}
            chans[name] = o
        elif l["class_name"] == "BatchNormalization":
            gain = (0.1, 0.3) if name.endswith("_3_bn") else (0.8, 1.2)
            out[name] = {
                "gamma": rng.uniform(*gain, cin).astype(np.float32),
                "beta": (0.1 * rng.standard_normal(cin)).astype(np.float32),
                "moving_mean": (0.1 * rng.standard_normal(cin)
                                ).astype(np.float32),
                "moving_variance": rng.uniform(0.5, 1.5, cin
                                               ).astype(np.float32)}
            chans[name] = cin
        elif l["class_name"] == "Dense":
            o = c["units"]
            out[name] = {
                "kernel": (rng.standard_normal((cin, o), dtype=np.float32)
                           * np.float32(np.sqrt(1.0 / cin))),
                "bias": (0.01 * rng.standard_normal(o)).astype(np.float32)}
            chans[name] = o
        elif srcs:
            chans[name] = cin
    return out


def keras_legacy_h5(config: Dict, weights: Dict[str, Dict]) -> bytes:
    """A Keras 3 legacy ``.h5``: ``model_config`` and the weights under
    ``model_weights/<layer>/<layer>/<variable>``, each layer group's
    ``weight_names`` in order (an empty float64 array for a layer without
    weights, as h5py stores Keras's empty list), and Keras's empty
    ``top_level_model_weights`` group."""
    import json

    names = [l["name"] for l in config["config"]["layers"]]
    root = H5Group({"backend": "tensorflow", "keras_version": KERAS_VERSION,
                    "model_config": json.dumps(config)})
    mw = root.group("model_weights")
    mw.attrs.update({"backend": "tensorflow", "keras_version": KERAS_VERSION,
                     "layer_names": names})
    for name in names:
        g = mw.group(name)
        ws = weights.get(name, {})
        g.attrs["weight_names"] = ([f"{name}/{k}" for k in ws] if ws
                                   else np.zeros((0,), np.float64))
        for k, v in ws.items():
            g.group(name).members[k] = v
    mw.group("top_level_model_weights").attrs["weight_names"] = np.zeros(
        (0,), np.float64)
    return write_hdf5(root)


def keras_resnet50_h5(seed: int = 0, blocks=RESNET50_BLOCKS,
                      widths=RESNET50_WIDTHS, image: int = 224,
                      classes: int = 1000) -> bytes:
    """Keras ResNet-50 (published widths by default) as a legacy ``.h5``."""
    cfg = keras_resnet50_config(blocks, widths, image, classes)
    return keras_legacy_h5(cfg, keras_resnet50_weights(cfg, seed))


# --- keras-io's character LSTM (.keras zip) ----------------------------------------------


def keras_char_lstm(vocab: int, seed: int = 0, maxlen: int = CHAR_LSTM["maxlen"],
                    units: int = CHAR_LSTM["units"]) -> bytes:
    """The character model as a Keras 3 ``.keras`` archive: the LSTM's
    kernel ``[V, 4u]``, recurrent kernel ``[u, 4u]`` and bias (gates i, f,
    c, o; the forget gate's bias 1, as ``unit_forget_bias``), the Dense
    kernel ``[u, V]`` and bias; Glorot-uniform draws from ``seed``."""
    import io
    import json
    import zipfile

    rng = np.random.default_rng(seed)

    def glorot(i, o):
        lim = np.sqrt(6.0 / (i + o))
        return rng.uniform(-lim, lim, (i, o)).astype(np.float32)

    bias = np.zeros(4 * units, np.float32)
    bias[units:2 * units] = 1.0

    def layer(cls, name, **config):
        return {"module": "keras.layers", "class_name": cls,
                "config": {"name": name, "trainable": True,
                           "dtype": dict(_DTYPE_POLICY), **config},
                "registered_name": None}

    lstm = layer("LSTM", "lstm", return_sequences=False, return_state=False,
                 go_backwards=False, stateful=False, unroll=False,
                 zero_output_for_mask=False, units=units, activation="tanh",
                 recurrent_activation="sigmoid", use_bias=True,
                 kernel_initializer=_init("GlorotUniform", seed=None),
                 recurrent_initializer=_init("Orthogonal", seed=None,
                                             gain=1.0),
                 bias_initializer=_init("Zeros"), unit_forget_bias=True,
                 kernel_regularizer=None, recurrent_regularizer=None,
                 bias_regularizer=None, activity_regularizer=None,
                 kernel_constraint=None, recurrent_constraint=None,
                 bias_constraint=None, dropout=0.0, recurrent_dropout=0.0,
                 seed=None)
    lstm["build_config"] = {"input_shape": [None, maxlen, vocab]}
    dense = layer("Dense", "dense", units=vocab, activation="softmax",
                  use_bias=True,
                  kernel_initializer=_init("GlorotUniform", seed=None),
                  bias_initializer=_init("Zeros"), kernel_regularizer=None,
                  bias_regularizer=None, kernel_constraint=None,
                  bias_constraint=None, quantization_config=None)
    dense["build_config"] = {"input_shape": [None, units]}
    inp = {"module": "keras.layers", "class_name": "InputLayer",
           "config": {"batch_shape": [None, maxlen, vocab],
                      "dtype": "float32", "sparse": False, "ragged": False,
                      "name": "input_layer", "optional": False},
           "registered_name": None}
    config = {"module": "keras", "class_name": "Sequential",
              "config": {"name": "sequential", "trainable": True,
                         "dtype": dict(_DTYPE_POLICY),
                         "layers": [inp, lstm, dense],
                         "build_input_shape": [None, maxlen, vocab]},
              "registered_name": None,
              "build_config": {"input_shape": [None, maxlen, vocab]},
              "compile_config": {}}
    root = H5Group()
    root.group("vars").attrs["name"] = "sequential"
    cell = root.group("layers/lstm/cell/vars")
    cell.attrs["name"] = "lstm_cell"
    cell.members.update({"0": glorot(vocab, 4 * units),
                         "1": glorot(units, 4 * units), "2": bias})
    root.group("layers/lstm/vars").attrs["name"] = "lstm"
    dv = root.group("layers/dense/vars")
    dv.attrs["name"] = "dense"
    dv.members.update({"0": glorot(units, vocab),
                       "1": np.zeros(vocab, np.float32)})
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("metadata.json", json.dumps(
            {"keras_version": KERAS_VERSION, "date_saved": "fixture"}))
        z.writestr("config.json", json.dumps(config))
        z.writestr("model.weights.h5", write_hdf5(root))
    return buf.getvalue()
