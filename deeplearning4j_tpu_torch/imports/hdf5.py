"""A reader for the subset of HDF5 that Keras and h5py write.

The JAX package opens Keras files with ``h5py``; the port reads them with
this module alone, as ``onnx_ir`` reads ONNX without ``onnx``. It returns
:class:`Group`, :class:`Dataset` (numpy arrays) and attributes, with
h5py's names for what it reads: ``f["model_weights/conv1/conv1/kernel"]``,
``name in group``, iteration in name order, ``group.attrs[name]``,
``np.asarray(dataset)``. Attribute values come back as h5py gives them: a
scalar variable-length string as ``str``, an array of them as an object
array of ``str``, a fixed-length string as ``bytes``, numbers as numpy
scalars or arrays.

The subset (the HDF5 file format specification, version 3.0):

- the superblock, versions 0 and 1 (what h5py's default "earliest" writes)
  and 2 and 3;
- object headers, version 1 (8-byte aligned messages) and version 2
  (``OHDR``/``OCHK``), with continuation blocks;
- groups as symbol tables (a v1 B-tree of group nodes at any depth, the
  local heap of link names, ``SNOD`` nodes) and as compact link messages;
- attribute messages, versions 1, 2 and 3;
- dataspaces (scalar, simple, null), datatypes: fixed-point and IEEE float
  (little-endian), fixed-length strings, variable-length strings through
  the global heap collections (``GCOL``);
- data layout messages, versions 3 and 4, compact and contiguous, with the
  undefined address for data never written (the fill value then).

Anything outside it raises :class:`UnsupportedHDF5Feature` naming the
feature (chunked or filtered data, big-endian or compound types, dense
link or attribute storage in fractal heaps, external files, soft links):
the reader never guesses. It does not write; the test fixtures' writer is
``import_fixtures.write_hdf5`` at the repository root.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

BytesLike = Union[bytes, bytearray, memoryview]


class HDF5FormatError(ValueError):
    """The bytes are not a well-formed HDF5 file."""


class UnsupportedHDF5Feature(NotImplementedError):
    """The file uses a part of HDF5 outside this reader's subset."""

    def __init__(self, feature: str):
        super().__init__(f"HDF5 feature outside the supported subset: "
                         f"{feature}")
        self.feature = feature


def _signature_offset(buf: BytesLike) -> Optional[int]:
    """The superblock's offset: 0, 512, 1024, 2048, ... (after a user
    block), or None."""
    off = 0
    while off + 8 <= len(buf):
        if bytes(buf[off:off + 8]) == SIGNATURE:
            return off
        off = 512 if off == 0 else off * 2
    return None


def is_hdf5(source: Union[str, BytesLike]) -> bool:
    """Whether ``source`` (a path or the file's bytes) holds an HDF5
    superblock signature."""
    if isinstance(source, str):
        try:
            with open(source, "rb") as fh:
                head = fh.read(1 << 20)
        except OSError:
            return False
        return _signature_offset(head) is not None
    return _signature_offset(source) is not None


# --- object header message types ---------------------------------------------------
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL_OLD, _FILL, _LINK, _EXTERNAL = 0x04, 0x05, 0x06, 0x07
_LAYOUT, _BOGUS, _GROUP_INFO, _FILTERS = 0x08, 0x09, 0x0A, 0x0B
_ATTRIBUTE, _COMMENT, _MTIME_OLD, _SHARED_TABLE = 0x0C, 0x0D, 0x0E, 0x0F
_CONTINUATION, _SYMBOL_TABLE, _MTIME, _BTREE_K = 0x10, 0x11, 0x12, 0x13
_STORAGE_INFO, _ATTR_INFO, _REFCOUNT = 0x14, 0x15, 0x16
#: messages that carry nothing this reader needs
_IGNORED = {_NIL, _FILL_OLD, _FILL, _BOGUS, _GROUP_INFO, _COMMENT,
            _MTIME_OLD, _MTIME, _BTREE_K, _STORAGE_INFO, _REFCOUNT}


class _Type:
    """A parsed datatype: ``kind`` is "num" (``dtype`` a numpy dtype),
    "str" (fixed length, ``dtype`` ``S<n>``) or "vlen_str"; ``size`` is
    its bytes per element in storage."""

    __slots__ = ("kind", "dtype", "size", "utf8")

    def __init__(self, kind: str, dtype, size: int, utf8: bool = False):
        self.kind, self.dtype, self.size, self.utf8 = kind, dtype, size, utf8


class _File:
    """The bytes of one file and the decoding of its structures."""

    def __init__(self, buf: BytesLike):
        self.buf = memoryview(buf).cast("B")
        off = _signature_offset(self.buf)
        if off is None:
            raise HDF5FormatError("no HDF5 superblock signature")
        self._collections: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._parse_superblock(off)

    # --- primitives --------------------------------------------------------------
    def u(self, pos: int, n: int) -> int:
        if pos + n > len(self.buf):
            raise HDF5FormatError(f"read past the end of the file at {pos}")
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def addr(self, pos: int) -> Optional[int]:
        """The address at ``pos`` (relative to the base address), or None
        for the undefined address."""
        a = self.u(pos, self.so)
        return None if a == self.undefined else a + self.base

    def sig(self, pos: int, want: bytes) -> None:
        got = bytes(self.buf[pos:pos + len(want)])
        if got != want:
            raise HDF5FormatError(f"expected {want!r} at {pos}, found {got!r}")

    def cstr(self, pos: int) -> str:
        end = pos
        while self.buf[end] != 0:
            end += 1
        return bytes(self.buf[pos:end]).decode("utf-8")

    # --- superblock ----------------------------------------------------------------
    def _parse_superblock(self, off: int) -> None:
        b = self.buf
        ver = b[off + 8]
        if ver in (0, 1):
            self.so, self.sl = b[off + 13], b[off + 14]
            p = off + 24 + (4 if ver == 1 else 0)
        elif ver in (2, 3):
            self.so, self.sl = b[off + 9], b[off + 10]
            p = off + 12
        else:
            raise UnsupportedHDF5Feature(f"superblock version {ver}")
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            raise HDF5FormatError(f"offset/length sizes {self.so}/{self.sl}")
        self.undefined = (1 << (8 * self.so)) - 1
        self.base = 0
        base = self.u(p, self.so)
        self.base = base
        if ver in (0, 1):
            # base, free-space info, end of file, the storage layer's
            # info block; then the root group's symbol table entry
            if self.addr(p + 3 * self.so) is not None:
                raise UnsupportedHDF5Feature("a storage layer information "
                                             "block (split or family files)")
            entry = p + 4 * self.so
            self.root = self.addr(entry + self.so)
        else:
            # base, superblock extension, end of file, root object header
            self.root = self.addr(p + 3 * self.so)
        if self.root is None:
            raise HDF5FormatError("no root group")

    # --- object headers --------------------------------------------------------------
    def messages(self, pos: int) -> List[Tuple[int, int, int, int]]:
        """``(type, flags, data offset, data size)`` of every message of
        the object header at ``pos``, continuation blocks followed."""
        if bytes(self.buf[pos:pos + 4]) == b"OHDR":
            return self._messages_v2(pos)
        ver = self.buf[pos]
        if ver != 1:
            raise UnsupportedHDF5Feature(f"object header version {ver}")
        blocks = [(pos + 16, self.u(pos + 8, 4))]
        out = []
        while blocks:
            start, length = blocks.pop(0)
            q, end = start, start + length
            while q + 8 <= end:
                mtype, msize = self.u(q, 2), self.u(q + 2, 2)
                flags = self.buf[q + 4]
                data = q + 8
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(data),
                                   self.u(data + self.so, self.sl)))
                else:
                    out.append((mtype, flags, data, msize))
                q = data + msize
        return out

    def _messages_v2(self, pos: int) -> List[Tuple[int, int, int, int]]:
        b = self.buf
        if b[pos + 4] != 2:
            raise UnsupportedHDF5Feature(f"object header version {b[pos + 4]}")
        flags = b[pos + 5]
        q = pos + 6
        if flags & 0x20:
            q += 16                      # access/modify/change/birth times
        if flags & 0x10:
            q += 4                       # attribute phase change values
        nsize = 1 << (flags & 0x03)
        blocks = [(q + nsize, self.u(q, nsize))]
        tracked = bool(flags & 0x04)
        out = []
        while blocks:
            start, length = blocks.pop(0)
            q, end = start, start + length
            while q + 4 <= end:
                mtype, msize, mflags = b[q], self.u(q + 1, 2), b[q + 3]
                data = q + 4 + (2 if tracked else 0)
                if mtype == _CONTINUATION:
                    cont = self.addr(data)
                    self.sig(cont, b"OCHK")
                    # the block's gap and checksum close it: 4 bytes each
                    blocks.append((cont + 4, self.u(data + self.so, self.sl)
                                   - 8))
                else:
                    out.append((mtype, mflags, data, msize))
                q = data + msize
        return out

    # --- datatypes and dataspaces -----------------------------------------------------
    def datatype(self, p: int) -> _Type:
        b = self.buf
        cls, ver = b[p] & 0x0F, b[p] >> 4
        bits = self.u(p + 1, 3)
        size = self.u(p + 4, 4)
        if cls in (0, 1) and bits & 0x01:
            raise UnsupportedHDF5Feature("big-endian datatype")
        if cls == 0:
            offset, precision = self.u(p + 8, 2), self.u(p + 10, 2)
            if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
                raise UnsupportedHDF5Feature(
                    f"fixed-point datatype of {size} bytes, bit offset "
                    f"{offset}, precision {precision}")
            signed = bool(bits & 0x08)
            return _Type("num", np.dtype(f"<{'i' if signed else 'u'}{size}"),
                         size)
        if cls == 1:
            ieee = {2: (5, 10), 4: (8, 23), 8: (11, 52)}
            exp_size, man_size = b[p + 13], b[p + 15]
            if bits & 0x40 or ieee.get(size) != (exp_size, man_size):
                raise UnsupportedHDF5Feature(
                    f"non-IEEE floating-point datatype of {size} bytes")
            return _Type("num", np.dtype(f"<f{size}"), size)
        if cls == 3:
            return _Type("str", np.dtype(f"S{size}"), size,
                         utf8=(bits >> 4) & 0x0F == 1)
        if cls == 9:
            if bits & 0x0F != 1:
                raise UnsupportedHDF5Feature("variable-length sequence "
                                             "datatype")
            return _Type("vlen_str", np.dtype(object), 4 + self.so + 4,
                         utf8=(bits >> 8) & 0x0F == 1)
        names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumeration", 10: "array"}
        raise UnsupportedHDF5Feature(
            f"{names.get(cls, f'class {cls}')} datatype (version {ver})")

    def dataspace(self, p: int) -> Optional[Tuple[int, ...]]:
        """The shape; ``()`` for a scalar, None for a null dataspace."""
        b = self.buf
        ver, ndims, flags = b[p], b[p + 1], b[p + 2]
        if ver == 1:
            q = p + 8
        elif ver == 2:
            if b[p + 3] == 2:
                return None
            q = p + 4
        else:
            raise UnsupportedHDF5Feature(f"dataspace version {ver}")
        if ver == 1 and flags & 0x02:
            raise UnsupportedHDF5Feature("dataspace permutation index")
        return tuple(self.u(q + i * self.sl, self.sl) for i in range(ndims))

    # --- data ------------------------------------------------------------------------
    def decode(self, t: _Type, shape: Optional[Tuple[int, ...]],
               raw: Optional[memoryview]):
        """The array of ``shape`` in ``raw`` (None: never written, zeros)."""
        if shape is None:
            return np.empty((0,), t.dtype if t.kind != "vlen_str" else object)
        n = int(np.prod(shape)) if shape else 1
        if t.kind == "vlen_str":
            out = np.empty((n,), dtype=object)
            for i in range(n):
                if raw is None:
                    out[i] = ""
                    continue
                q = i * t.size
                length = int.from_bytes(raw[q:q + 4], "little")
                coll = int.from_bytes(raw[q + 4:q + 4 + self.so], "little")
                idx = int.from_bytes(raw[q + 4 + self.so:q + 8 + self.so],
                                     "little")
                data = self._heap_object(coll + self.base, idx)[:length] \
                    if length else b""
                out[i] = data.decode("utf-8" if t.utf8 else "ascii")
            return out.reshape(shape)
        if raw is None:
            return np.zeros(shape, dtype=t.dtype)
        if len(raw) < n * t.size:
            raise HDF5FormatError(f"{len(raw)} bytes hold no {n} elements "
                                  f"of {t.size} bytes")
        return np.frombuffer(raw, dtype=t.dtype, count=n).reshape(shape).copy()

    def _heap_object(self, coll: int, index: int) -> bytes:
        objs = self._collections.get(coll)
        if objs is None:
            self.sig(coll, b"GCOL")
            size = self.u(coll + 8, self.sl)
            objs, q, end = {}, coll + 8 + self.sl, coll + size
            while q + 8 + self.sl <= end:
                i = self.u(q, 2)
                osize = self.u(q + 8, self.sl)
                if i == 0:
                    break                # the free space closes the collection
                objs[i] = (q + 8 + self.sl, osize)
                q += 8 + self.sl + ((osize + 7) & ~7)
            self._collections[coll] = objs
        if index not in objs:
            raise HDF5FormatError(f"global heap object {index} missing at "
                                  f"{coll}")
        start, size = objs[index]
        return bytes(self.buf[start:start + size])

    # --- attributes ------------------------------------------------------------------
    def attribute(self, p: int, msize: int) -> Tuple[str, Any]:
        b = self.buf
        ver, flags = b[p], b[p + 1]
        nsize, tsize, ssize = self.u(p + 2, 2), self.u(p + 4, 2), \
            self.u(p + 6, 2)
        if ver != 1 and flags & 0x03:
            raise UnsupportedHDF5Feature("shared datatype or dataspace in an "
                                         "attribute")
        if ver == 1:
            def pad(n):
                return (n + 7) & ~7
            q = p + 8
            name = bytes(b[q:q + nsize]).rstrip(b"\0").decode("utf-8")
            q += pad(nsize)
            t = self.datatype(q)
            q += pad(tsize)
            shape = self.dataspace(q)
            q += pad(ssize)
        elif ver in (2, 3):
            q = p + 8 + (1 if ver == 3 else 0)
            name = bytes(b[q:q + nsize]).rstrip(b"\0").decode("utf-8")
            q += nsize
            t = self.datatype(q)
            q += tsize
            shape = self.dataspace(q)
            q += ssize
        else:
            raise UnsupportedHDF5Feature(f"attribute message version {ver}")
        n = (int(np.prod(shape)) if shape else 1) if shape is not None else 0
        value = self.decode(t, shape, self.buf[q:q + n * t.size])
        if shape == ():
            value = value[()]
            if t.kind == "vlen_str":
                value = str(value)
        return name, value


class _Object:
    """What every node of the file has: its header's messages and its
    attributes."""

    def __init__(self, f: _File, pos: int, name: str):
        self._f, self._pos, self.name = f, pos, name
        self._msgs = f.messages(pos)
        self._attrs: Optional[Dict[str, Any]] = None
        for mtype, _, data, _ in self._msgs:
            if mtype == _ATTR_INFO:
                flags = f.buf[data + 1]
                q = data + 2 + (2 if flags & 0x01 else 0)
                if f.addr(q) is not None:
                    raise UnsupportedHDF5Feature(
                        "dense attribute storage (fractal heap)")
            elif mtype not in _IGNORED and mtype not in self._known:
                raise UnsupportedHDF5Feature(
                    f"object header message type {mtype:#x}")

    _known = {_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE, _SYMBOL_TABLE,
              _LINK_INFO, _LINK, _FILTERS, _EXTERNAL, _SHARED_TABLE}

    def _first(self, mtype: int) -> Optional[Tuple[int, int]]:
        for t, _, data, size in self._msgs:
            if t == mtype:
                return data, size
        return None

    @property
    def attrs(self) -> Dict[str, Any]:
        if self._attrs is None:
            self._attrs = dict(self._f.attribute(data, size)
                               for t, _, data, size in self._msgs
                               if t == _ATTRIBUTE)
        return self._attrs


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, and its array by ``np.asarray(d)``
    or ``d.read()``."""

    def __init__(self, f: _File, pos: int, name: str):
        super().__init__(f, pos, name)
        if self._first(_FILTERS) is not None:
            raise UnsupportedHDF5Feature(f"filtered data (filter pipeline) "
                                         f"in dataset {name!r}")
        if self._first(_EXTERNAL) is not None:
            raise UnsupportedHDF5Feature(f"external file storage in dataset "
                                         f"{name!r}")
        self._type = f.datatype(self._first(_DATATYPE)[0])
        self.shape = f.dataspace(self._first(_DATASPACE)[0])
        self.dtype = self._type.dtype
        lay = self._first(_LAYOUT)[0]
        ver, cls = f.buf[lay], f.buf[lay + 1]
        if ver not in (3, 4):
            raise UnsupportedHDF5Feature(f"data layout message version {ver}")
        if cls == 0:
            self._raw = (lay + 4, f.u(lay + 2, 2))
        elif cls == 1:
            a = f.addr(lay + 2)
            self._raw = None if a is None else (a, f.u(lay + 2 + f.so, f.sl))
        elif cls == 2:
            raise UnsupportedHDF5Feature(f"chunked data in dataset {name!r}")
        else:
            raise UnsupportedHDF5Feature(f"data layout class {cls} in "
                                         f"dataset {name!r}")

    def read(self) -> np.ndarray:
        if self._raw is None:
            fill = self._fill_value()
            if fill is not None:
                return np.full(self.shape, fill, dtype=self.dtype)
            return self._f.decode(self._type, self.shape, None)
        start, size = self._raw
        return self._f.decode(self._type, self.shape,
                              self._f.buf[start:start + size])

    def _fill_value(self):
        """A defined fill value of a never-written dataset, or None."""
        m = self._first(_FILL)
        if m is None or self._type.kind != "num":
            return None
        f, p = self._f, m[0]
        ver = f.buf[p]
        if ver in (1, 2):
            if not f.buf[p + 3]:
                return None
            q = p + 4
        elif ver == 3:
            if not f.buf[p + 1] & 0x20:
                return None
            q = p + 2
        else:
            raise UnsupportedHDF5Feature(f"fill value message version {ver}")
        size = f.u(q, 4)
        if size == 0:
            return None
        return np.frombuffer(f.buf[q + 4:q + 4 + size], self.dtype)[0]

    def __array__(self, dtype=None, copy=None):
        a = self.read()
        return a if dtype is None else a.astype(dtype)


class Group(_Object):
    """A group: its members by name (``g["a/b"]``, ``"a" in g``,
    iteration in name order) and its attributes."""

    def __init__(self, f: _File, pos: int, name: str):
        super().__init__(f, pos, name)
        self._links: Optional[Dict[str, int]] = None

    # --- links -----------------------------------------------------------------
    def _members(self) -> Dict[str, int]:
        if self._links is not None:
            return self._links
        f = self._f
        links: Dict[str, int] = {}
        st = self._first(_SYMBOL_TABLE)
        if st is not None:
            btree, heap = f.addr(st[0]), f.addr(st[0] + f.so)
            f.sig(heap, b"HEAP")
            names = f.addr(heap + 8 + 2 * f.sl)
            self._walk_btree(btree, names, links)
        li = self._first(_LINK_INFO)
        if li is not None:
            flags = f.buf[li[0] + 1]
            q = li[0] + 2 + (8 if flags & 0x01 else 0)
            if f.addr(q) is not None:
                raise UnsupportedHDF5Feature("dense link storage (fractal "
                                             "heap)")
        for t, _, data, _ in self._msgs:
            if t == _LINK:
                name, target = self._link(data)
                links[name] = target
        self._links = dict(sorted(links.items()))
        return self._links

    def _walk_btree(self, node: Optional[int], names: int,
                    links: Dict[str, int]) -> None:
        if node is None:
            return
        f = self._f
        f.sig(node, b"TREE")
        if f.buf[node + 4] != 0:
            raise HDF5FormatError("a group's B-tree holds no group nodes")
        level, used = f.buf[node + 5], f.u(node + 6, 2)
        q = node + 8 + 2 * f.so + f.sl          # past siblings and key 0
        for _ in range(used):
            child = f.addr(q)
            q += f.so + f.sl
            if level > 0:
                self._walk_btree(child, names, links)
                continue
            f.sig(child, b"SNOD")
            entry = child + 8
            for _ in range(f.u(child + 6, 2)):
                name = f.cstr(names + f.u(entry, f.so))
                # cache type 2: a soft link, no object header
                links[name] = (None if f.u(entry + 2 * f.so, 4) == 2
                               else f.addr(entry + f.so))
                entry += 2 * f.so + 24

    def _link(self, p: int) -> Tuple[str, int]:
        f = self._f
        flags = f.buf[p + 1]
        q = p + 2
        ltype = 0
        if flags & 0x08:
            ltype = f.buf[q]
            q += 1
        if flags & 0x04:
            q += 8
        if flags & 0x10:
            q += 1
        nlen = 1 << (flags & 0x03)
        n = f.u(q, nlen)
        q += nlen
        name = bytes(f.buf[q:q + n]).decode("utf-8")
        if ltype != 0:
            raise UnsupportedHDF5Feature(
                f"{'soft' if ltype == 1 else 'external'} link {name!r}")
        return name, f.addr(q + n)

    # --- mapping interface --------------------------------------------------------
    def _open(self, name: str, pos: int) -> Union["Group", Dataset]:
        full = f"{self.name.rstrip('/')}/{name}"
        if any(t == _LAYOUT for t, _, _, _ in self._f.messages(pos)):
            return Dataset(self._f, pos, full)
        return Group(self._f, pos, full)

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        node: Union[Group, Dataset] = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name!r} is a dataset, not a group")
            members = node._members()
            if part not in members:
                raise KeyError(f"no member {part!r} in {node.name!r}")
            if members[part] is None:
                raise UnsupportedHDF5Feature(f"soft link {part!r}")
            node = node._open(part, members[part])
        return node

    def get(self, path: str, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def __contains__(self, path: str) -> bool:
        return self.get(path) is not None

    def __iter__(self) -> Iterator[str]:
        return iter(self._members())

    def __len__(self) -> int:
        return len(self._members())

    def keys(self) -> List[str]:
        return list(self._members())


class File(Group):
    """An HDF5 file opened from a path or from its bytes (read-only)."""

    def __init__(self, source: Union[str, BytesLike], mode: str = "r"):
        if mode != "r":
            raise ValueError("this reader opens files read-only")
        if isinstance(source, str):
            with open(source, "rb") as fh:
                source = fh.read()
        f = _File(source)
        super().__init__(f, f.root, "/")

    def close(self) -> None:
        """Nothing to release: the bytes are read whole at open."""

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
