"""A TensorFlow GraphDef reader and writer on the protobuf wire format.

The JAX package reads frozen graphs through TensorFlow's proto classes
(``graph_pb2.GraphDef``, ``tensor_util.MakeNdarray``). The port needs neither
TensorFlow nor ``protobuf``: this module decodes and encodes the five
messages a frozen inference graph is made of, field by field, after
tensorflow/core/framework/{graph,node_def,attr_value,tensor,tensor_shape,
versions}.proto:

- ``GraphDef``: node = 1 (NodeDef), library = 2 (kept as raw bytes, not
  parsed), versions = 4 (VersionDef: producer = 1, min_consumer = 2);
- ``NodeDef``: name = 1, op = 2, input = 3, device = 4, attr = 5 (a map:
  entries of key = 1, value = 2);
- ``AttrValue``, a oneof: list = 1, s = 2, i = 3, f = 4, b = 5, type = 6,
  shape = 7, tensor = 8, placeholder = 9 (``func`` = 10 is kept raw);
  its ``ListValue``: s = 2, i = 3, f = 4, b = 5, type = 6, shape = 7,
  tensor = 8;
- ``TensorShapeProto``: dim = 2 (size = 1, name = 2), unknown_rank = 3;
- ``TensorProto``: dtype = 1, tensor_shape = 2, tensor_content = 4, and one
  repeated field per element type (half_val = 13, float_val = 5,
  double_val = 6, int_val = 7, int64_val = 10, bool_val = 11,
  uint32_val = 16, uint64_val = 17).

Decoding gives plain objects (``node.name``, ``node.op``, ``node.input``,
``node.attr[key].kind`` / ``.value``). Repeated scalars are read packed or
unpacked. ``tensor_content`` is little-endian raw bytes: :func:`make_ndarray`
views it with ``np.frombuffer`` on a memoryview of the graph's bytes, so a
weight is not copied while the graph is read (the caller's upload is its
one copy). Like ``tensor_util.MakeNdarray``, a tensor given by fewer values
than it has elements repeats the last value given, and one given by none is
all zeros: TensorFlow stores constants that way after freezing (an all-zero
bias has no values, a LayerNorm gain of ones has one).

Encoding writes the same messages; :func:`tensor_proto` compresses a
constant as TensorFlow's ``CompressTensorProtoInPlace`` does (a trailing
run of equal values is cut to its first element when that halves the
bytes; an all-zero tensor keeps no value).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

BytesLike = Union[bytes, bytearray, memoryview]

# DataType enum (tensorflow/core/framework/types.proto) -> numpy dtype name
DTYPES: Dict[int, str] = {
    1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
    6: "int8", 9: "int64", 10: "bool", 14: "bfloat16", 17: "uint16",
    19: "float16", 22: "uint32", 23: "uint64",
}
ENUMS: Dict[str, int] = {v: k for k, v in DTYPES.items()}

# the TensorProto field that carries each dtype's values, and its encoding:
# "varint" (int32 sign-extended, int64, bool, uint*), "f32"/"f64" (fixed)
_VAL_FIELD: Dict[str, Tuple[int, str]] = {
    "float32": (5, "f32"), "float64": (6, "f64"),
    "int32": (7, "varint"), "int16": (7, "varint"), "int8": (7, "varint"),
    "uint8": (7, "varint"), "uint16": (7, "varint"),
    "int64": (10, "varint"), "bool": (11, "varint"),
    "float16": (13, "varint"), "bfloat16": (13, "varint"),
    "uint32": (16, "varint"), "uint64": (17, "varint"),
}


def _le(dtype: np.dtype) -> np.dtype:
    """``dtype`` read as little-endian (the wire's byte order)."""
    return dtype if dtype.byteorder == "|" or dtype.name == "bfloat16" \
        else dtype.newbyteorder("<")


def np_dtype(enum: int) -> np.dtype:
    """The numpy dtype of a TensorFlow DataType enum value."""
    name = DTYPES.get(int(enum))
    if name is None:
        raise TypeError(f"TensorFlow DataType {enum} is not supported")
    if name == "bfloat16":
        import ml_dtypes  # numpy has no bfloat16 of its own

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def dtype_enum(dtype) -> int:
    name = np.dtype(dtype).name
    if name not in ENUMS:
        raise TypeError(f"no TensorFlow DataType for {name}")
    return ENUMS[name]


# ---------------------------------------------------------------------------
# messages


@dataclass
class TensorShape:
    dim: List[int] = field(default_factory=list)    # -1: unknown size
    unknown_rank: bool = False


@dataclass
class Tensor:
    dtype: int = 0
    shape: TensorShape = field(default_factory=TensorShape)
    content: Optional[memoryview] = None          # raw little-endian bytes
    values: list = field(default_factory=list)    # the repeated field
    packed: List[memoryview] = field(default_factory=list)  # packed chunks


@dataclass
class AttrList:
    s: List[bytes] = field(default_factory=list)
    i: List[int] = field(default_factory=list)
    f: List[float] = field(default_factory=list)
    b: List[bool] = field(default_factory=list)
    type: List[int] = field(default_factory=list)
    shape: List[TensorShape] = field(default_factory=list)
    tensor: List[Tensor] = field(default_factory=list)


@dataclass
class AttrValue:
    """One attr: ``kind`` names the oneof field that is set ("i", "f", "b",
    "s", "type", "shape", "tensor", "list", "placeholder" or "func") and
    ``value`` holds it."""

    kind: Optional[str] = None
    value: object = None


@dataclass
class NodeDef:
    name: str = ""
    op: str = ""
    input: List[str] = field(default_factory=list)
    device: str = ""
    attr: Dict[str, AttrValue] = field(default_factory=dict)


@dataclass
class GraphDef:
    node: List[NodeDef] = field(default_factory=list)
    producer: int = 0
    min_consumer: int = 0
    library: Optional[memoryview] = None


# ---------------------------------------------------------------------------
# decoding


def _varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("malformed varint")


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf: memoryview):
    """(field number, wire type, value) of each field of one message. A
    length-delimited value is a memoryview slice of ``buf`` (no copy)."""
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 2:
            n, pos = _varint(buf, pos)
            if pos + n > end:
                raise ValueError("truncated protobuf field")
            val, pos = buf[pos:pos + n], pos + n
        elif wt == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wt == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"unsupported protobuf wire type {wt}")
        yield num, wt, val


def _str(v: memoryview) -> str:
    return bytes(v).decode("utf-8")


def _packed_varints(v: memoryview) -> List[int]:
    out, pos = [], 0
    while pos < len(v):
        x, pos = _varint(v, pos)
        out.append(x)
    return out


def _scalars(wt: int, v, kind: str) -> list:
    """One repeated-scalar field occurrence, packed (wire type 2) or not."""
    if kind == "varint":
        return _packed_varints(v) if wt == 2 else [v]
    fmt = "<f" if kind == "f32" else "<d"
    return list(np.frombuffer(v, dtype=fmt)) if wt == 2 else \
        [struct.unpack(fmt, v)[0]]


def parse_shape(buf: memoryview) -> TensorShape:
    shp = TensorShape()
    for num, _, v in _fields(buf):
        if num == 2:
            size = 0
            for dnum, _, dv in _fields(v):
                if dnum == 1:
                    size = _signed64(dv)
            shp.dim.append(size)
        elif num == 3:
            shp.unknown_rank = bool(v)
    return shp


def parse_tensor(buf: memoryview) -> Tensor:
    t = Tensor()
    fields = list(_fields(buf))
    for num, _, v in fields:
        if num == 1:
            t.dtype = v
        elif num == 2:
            t.shape = parse_shape(v)
        elif num == 4:
            t.content = v
    name = DTYPES.get(t.dtype)
    if name is None:
        raise TypeError(f"TensorFlow DataType {t.dtype} is not supported")
    vnum, kind = _VAL_FIELD[name]
    for num, wt, v in fields:
        if num == vnum:
            if wt == 2 and kind != "varint":
                t.packed.append(v)
            else:
                t.values.extend(_scalars(wt, v, kind))
    return t


def _parse_list(buf: memoryview) -> AttrList:
    lst = AttrList()
    for num, wt, v in _fields(buf):
        if num == 2:
            lst.s.append(bytes(v))
        elif num == 3:
            lst.i.extend(_signed64(x) for x in _scalars(wt, v, "varint"))
        elif num == 4:
            lst.f.extend(float(x) for x in _scalars(wt, v, "f32"))
        elif num == 5:
            lst.b.extend(bool(x) for x in _scalars(wt, v, "varint"))
        elif num == 6:
            lst.type.extend(_scalars(wt, v, "varint"))
        elif num == 7:
            lst.shape.append(parse_shape(v))
        elif num == 8:
            lst.tensor.append(parse_tensor(v))
    return lst


_ATTR_KINDS = {1: "list", 2: "s", 3: "i", 4: "f", 5: "b", 6: "type",
               7: "shape", 8: "tensor", 9: "placeholder", 10: "func"}


def parse_attr(buf: memoryview) -> AttrValue:
    a = AttrValue()
    for num, _, v in _fields(buf):
        kind = _ATTR_KINDS.get(num)
        if kind is None:
            continue
        a.kind = kind
        if kind == "list":
            a.value = _parse_list(v)
        elif kind == "s":
            a.value = bytes(v)
        elif kind == "i":
            a.value = _signed64(v)
        elif kind == "f":
            a.value = struct.unpack("<f", v)[0]
        elif kind == "b":
            a.value = bool(v)
        elif kind == "type":
            a.value = v
        elif kind == "shape":
            a.value = parse_shape(v)
        elif kind == "tensor":
            a.value = parse_tensor(v)
        elif kind == "placeholder":
            a.value = _str(v)
        else:
            a.value = v
    return a


def parse_node(buf: memoryview) -> NodeDef:
    node = NodeDef()
    for num, _, v in _fields(buf):
        if num == 1:
            node.name = _str(v)
        elif num == 2:
            node.op = _str(v)
        elif num == 3:
            node.input.append(_str(v))
        elif num == 4:
            node.device = _str(v)
        elif num == 5:
            key, val = "", AttrValue()
            for enum_, _, ev in _fields(v):
                if enum_ == 1:
                    key = _str(ev)
                elif enum_ == 2:
                    val = parse_attr(ev)
            node.attr[key] = val
    return node


def parse_graph_def(data: BytesLike) -> GraphDef:
    """Decode a serialized GraphDef. The tensors' raw bytes stay views into
    ``data``, which must not change while they are in use."""
    buf = memoryview(data).cast("B")
    gd = GraphDef()
    for num, _, v in _fields(buf):
        if num == 1:
            gd.node.append(parse_node(v))
        elif num == 2:
            gd.library = v
        elif num == 4:
            for vnum, _, vv in _fields(v):
                if vnum == 1:
                    gd.producer = vv
                elif vnum == 2:
                    gd.min_consumer = vv
    return gd


def make_ndarray(t: Tensor) -> np.ndarray:
    """The array a TensorProto holds, as ``tensor_util.MakeNdarray`` makes
    it. ``tensor_content`` comes back as a read-only view of the graph's
    bytes; the repeated fields as a new array."""
    dtype = np_dtype(t.dtype)
    shape = tuple(int(d) for d in t.shape.dim)
    n = int(np.prod(shape, dtype=np.int64))
    if t.content is not None and len(t.content):
        raw = np.frombuffer(t.content, dtype=_le(dtype))
        if raw.size != n:
            raise ValueError(f"tensor_content holds {raw.size} elements, the "
                             f"shape {shape} has {n}")
        return raw.view(dtype).reshape(shape)
    if t.packed:
        values = np.concatenate([np.frombuffer(p, dtype=_le(dtype))
                                 for p in t.packed]
                                + [np.asarray(t.values, dtype)])
        values = values.astype(dtype, copy=False)
    elif dtype.name in ("float16", "bfloat16"):
        values = np.asarray(t.values, np.uint16).view(dtype)
    elif dtype.kind in "iu":
        # int32 and narrower arrive as sign-extended 64-bit varints
        raw = np.asarray(t.values, np.uint64)
        values = raw.view(np.int64).astype(dtype) if dtype.kind == "i" \
            else raw.astype(dtype)
    else:
        values = np.asarray(t.values, dtype)
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size > n:
        raise ValueError(f"{values.size} values for the shape {shape}")
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


# ---------------------------------------------------------------------------
# encoding


def _enc_varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(num: int, wt: int) -> bytes:
    return _enc_varint(num << 3 | wt)


def _ld(num: int, payload: Sequence[BytesLike]) -> List[BytesLike]:
    """A length-delimited field from chunks (the chunks are not copied)."""
    n = sum(memoryview(p).nbytes for p in payload)
    return [_key(num, 2), _enc_varint(n), *payload]


def _vi(num: int, v: int) -> bytes:
    return _key(num, 0) + _enc_varint(int(v))


def _s(num: int, text: Union[str, bytes]) -> List[BytesLike]:
    return _ld(num, [text.encode() if isinstance(text, str) else text])


def _enc_shape(dims: Sequence[int]) -> List[BytesLike]:
    out: List[BytesLike] = []
    for d in dims:
        out += _ld(2, [_vi(1, d)] if d else [])
    return out


def tensor_proto(arr: np.ndarray) -> List[BytesLike]:
    """The encoded TensorProto of ``arr``, compressed as TensorFlow stores a
    frozen constant: an all-zero tensor keeps no value; a tensor whose last
    values repeat keeps them up to the run's first element, in its repeated
    field, when that is at most half the raw bytes; otherwise (and always
    for more than one element that does not compress) ``tensor_content``,
    a view of ``arr``'s memory."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")     # (np.ascontiguousarray makes 0-d 1-d)
    name = arr.dtype.name
    out: List[BytesLike] = [_vi(1, dtype_enum(arr.dtype))]
    out += _ld(2, _enc_shape(arr.shape))
    bits = arr.reshape(-1).view(f"u{arr.dtype.itemsize}")
    n = bits.size
    if n == 0:
        return out
    diff = np.flatnonzero(bits != bits[-1])
    keep = int(diff[-1]) + 2 if diff.size else 1      # values to keep
    if keep == 1 and bits[-1] == 0:
        return out                                     # an all-zero tensor
    vnum, kind = _VAL_FIELD[name]
    field_bytes = {"float64": 8, "int64": 8, "uint64": 8, "bool": 1}.get(
        name, 4)
    if n > 1 and keep * field_bytes > arr.nbytes // 2:
        return out + _ld(4, [memoryview(arr).cast("B")])
    vals = arr.reshape(-1)[:keep]
    if kind == "varint":
        ints = vals.view(np.uint16) if name in ("float16", "bfloat16") \
            else vals
        payload = b"".join(_enc_varint(int(x)) for x in ints)
    else:
        payload = vals.astype(_le(vals.dtype)).tobytes()
    return out + _ld(vnum, [payload])


def _enc_attr(a: AttrValue) -> List[BytesLike]:
    k, v = a.kind, a.value
    if k == "i":
        return [_vi(3, v)]
    if k == "f":
        return [_key(4, 5), struct.pack("<f", v)]
    if k == "b":
        return [_vi(5, bool(v))]
    if k == "type":
        return [_vi(6, v)]
    if k == "s":
        return _s(2, v)
    if k == "shape":
        dims = v.dim if isinstance(v, TensorShape) else v
        return _ld(7, _enc_shape(dims))
    if k == "tensor":
        return _ld(8, tensor_proto(v))
    if k == "list":
        body: List[BytesLike] = []
        for s in v.s:
            body += _s(2, s)
        for num, xs in ((3, v.i), (5, v.b), (6, v.type)):
            if xs:
                body += _ld(num, [b"".join(_enc_varint(int(x)) for x in xs)])
        if v.f:
            body += _ld(4, [np.asarray(v.f, "<f4").tobytes()])
        for shp in v.shape:
            body += _ld(7, _enc_shape(shp.dim))
        return _ld(1, body)
    raise ValueError(f"cannot encode attr kind {k!r}")


def encode_node(node: NodeDef) -> List[BytesLike]:
    body: List[BytesLike] = _s(1, node.name) + _s(2, node.op)
    for i in node.input:
        body += _s(3, i)
    if node.device:
        body += _s(4, node.device)
    for key in sorted(node.attr):
        body += _ld(5, _s(1, key) + _ld(2, _enc_attr(node.attr[key])))
    return _ld(1, body)


def serialize_graph_def(nodes: Sequence[NodeDef], producer: int) -> bytes:
    """A GraphDef of ``nodes`` (whose tensor attrs hold numpy arrays) with
    ``versions.producer``; the weights are copied once, into the result."""
    chunks: List[BytesLike] = []
    for node in nodes:
        chunks += encode_node(node)
    chunks += _ld(4, [_vi(1, producer)])
    return b"".join(chunks)


def attr(kind: str, value) -> AttrValue:
    """An AttrValue for the writer: ``attr("type", 1)``, ``attr("b",
    False)``, ``attr("tensor", ndarray)``, ``attr("shape", [2, 16])``."""
    return AttrValue(kind, value)
