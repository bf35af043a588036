"""TensorBoard event files, without TensorFlow.

Counterpart of ``deeplearning4j_tpu/ui/tensorboard.py``, copied (it is
plain Python and numpy): scalar and histogram summaries in the standard
``tfevents`` TFRecord format (length-prefixed records with masked CRC32C,
``Event`` / ``Summary`` / ``HistogramProto`` payloads encoded by hand: only
a handful of protobuf fields are needed). ``TensorBoardStatsStorage``
(``ui/stats.py``) writes through :class:`TensorBoardEventWriter`, and
:func:`read_scalar_events` / :func:`read_histogram_events` read a file
back with its framing checked. :func:`host_histogram` is the one
histogram convention every stats storage shares.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# --- CRC32C (Castagnoli), table-driven --------------------------------------

def _build_crc_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


# built eagerly at import: a lazy build racing across writer threads could
# interleave appends and corrupt every CRC for the process lifetime
_CRC_TABLE = _build_crc_table()


def _crc32c(data: bytes) -> int:
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --- minimal protobuf encoding ----------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"protobuf varint fields here are unsigned; got {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    out = _field_double(1, wall_time)
    if step is not None:
        out += _field_varint(2, step)
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


def _packed_doubles(num: int, values) -> bytes:
    """Packed repeated double field (HistogramProto bucket/bucket_limit)."""
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _field_bytes(num, payload)


def host_histogram(values, bins: int = 30):
    """(finite_values, counts, edges) — the one histogram-preparation
    convention shared by every storage backend: non-finite values are
    dropped (TensorBoard refuses NaN bucket stats, np.histogram's
    auto-range refuses NaN) and an all-empty input degrades to a single
    zero bucket."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,))
    counts, edges = np.histogram(v, bins=bins)
    return v, counts, edges


def _histogram_summary(tag: str, values, bins: int = 30) -> bytes:
    """Summary.Value with a ``histo`` (HistogramProto, field 5) payload."""
    v, counts, edges = host_histogram(values, bins)
    histo = (_field_double(1, float(v.min()))          # min
             + _field_double(2, float(v.max()))        # max
             + _field_double(3, float(v.size))         # num
             + _field_double(4, float(v.sum()))        # sum
             + _field_double(5, float(np.square(v).sum()))  # sum_squares
             + _packed_doubles(6, edges[1:])           # bucket right edges
             + _packed_doubles(7, counts))             # bucket counts
    val = _field_bytes(1, tag.encode()) + _field_bytes(5, histo)
    return _field_bytes(1, val)


class TensorBoardEventWriter:
    """Append scalar events to a ``tfevents`` file under ``logdir``
    (one file per writer, standard naming so TensorBoard discovers it)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(time.time(),
                                  file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_event(time.time(), step=step,
                                  summary=_scalar_summary(tag, value)))

    def add_histogram(self, tag: str, values, step: int,
                      bins: int = 30) -> None:
        """Histogram summary (reference StatsListener's per-layer param/
        gradient/update histograms land here; TensorBoard's Histograms/
        Distributions tabs render them)."""
        self._write_record(_event(time.time(), step=step,
                                  summary=_histogram_summary(tag, values,
                                                             bins)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self.flush()
        self._f.close()


def _iter_record_payloads(path: str):
    """Yield the event payloads of a tfevents file, verifying the TFRecord
    framing (header + payload masked CRC32C)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if hcrc != _masked_crc(header):
                raise ValueError("corrupt header CRC")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if pcrc != _masked_crc(payload):
                raise ValueError("corrupt payload CRC")
            yield payload


def read_scalar_events(path: str):
    """Parse a tfevents file back into [(step, tag, value)] — used by tests
    to prove the files are well-formed (record framing + CRCs verified)."""
    out = []
    for payload in _iter_record_payloads(path):
        out.extend((s, t, v) for s, t, v, h in _parse_event(payload)
                   if h is None)
    return out


def read_histogram_events(path: str):
    """Parse a tfevents file's histogram summaries into
    [(step, tag, histo)] with ``histo`` a dict of the HistogramProto
    fields (min/max/num/sum/sum_squares/bucket_limit/bucket)."""
    out = []
    for payload in _iter_record_payloads(path):
        out.extend((s, t, h) for s, t, _v, h in _parse_event(payload)
                   if h is not None)
    return out


def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_event(buf: bytes):
    i = 0
    step = 0
    values = []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            i += 8
        elif wire == 5:
            i += 4
        elif wire == 0:
            v, i = _read_varint(buf, i)
            if num == 2:
                step = v
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            chunk = buf[i:i + ln]
            i += ln
            if num == 5:  # summary
                values.extend(_parse_summary(chunk))
    return [(step, tag, val, histo) for tag, val, histo in values]


def _parse_summary(buf: bytes):
    i = 0
    out = []
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, i = _read_varint(buf, i)
            if num == 1:  # Value
                out.append(_parse_value(buf[i:i + ln]))
            i += ln
        elif wire == 5:
            i += 4
        elif wire == 1:
            i += 8
        else:
            _, i = _read_varint(buf, i)
    return out


def _parse_value(buf: bytes):
    i = 0
    tag, val, histo = "", float("nan"), None
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, i = _read_varint(buf, i)
            if num == 1:
                tag = buf[i:i + ln].decode()
            elif num == 5:  # histo (HistogramProto)
                histo = _parse_histo(buf[i:i + ln])
            i += ln
        elif wire == 5:
            if num == 2:
                (val,) = struct.unpack("<f", buf[i:i + 4])
            i += 4
        elif wire == 1:
            i += 8
        else:
            _, i = _read_varint(buf, i)
    return tag, val, histo


_HISTO_DOUBLES = {1: "min", 2: "max", 3: "num", 4: "sum", 5: "sum_squares"}


def _parse_histo(buf: bytes):
    out = {"min": 0.0, "max": 0.0, "num": 0.0, "sum": 0.0,
           "sum_squares": 0.0, "bucket_limit": [], "bucket": []}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 1:
            (v,) = struct.unpack("<d", buf[i:i + 8])
            i += 8
            if num in _HISTO_DOUBLES:
                out[_HISTO_DOUBLES[num]] = v
        elif wire == 2:  # packed repeated double
            ln, i = _read_varint(buf, i)
            chunk = buf[i:i + ln]
            i += ln
            vals = [struct.unpack("<d", chunk[k:k + 8])[0]
                    for k in range(0, len(chunk) - 7, 8)]
            if num == 6:
                out["bucket_limit"] = vals
            elif num == 7:
                out["bucket"] = vals
        elif wire == 5:
            i += 4
        else:
            _, i = _read_varint(buf, i)
    return out
