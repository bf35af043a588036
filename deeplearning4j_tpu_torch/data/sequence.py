"""Sequence construction + windowing over record collections.

Counterpart of ``deeplearning4j_tpu/data/sequence.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: datavec-api ``transform.sequence`` —
``ConvertToSequence(groupBy, comparator)``, ``TimeWindowFunction`` /
``OverlappingTimeWindowFunction``-style windowing, and
``ReduceSequenceTransform`` (SURVEY §2.3 DataVec core row).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence

from .records import Record, SequenceRecord
from .reducers import Reducer
from .schema import Schema


def convert_to_sequence(schema: Schema, records: Sequence[Record],
                        group_by: str, sort_by: Optional[str] = None,
                        ascending: bool = True) -> List[SequenceRecord]:
    """Group flat records into sequences by a key column, each sequence
    sorted by ``sort_by`` (reference: ConvertToSequence + the numerical
    comparator)."""
    gi = schema.index_of(group_by)
    si = schema.index_of(sort_by) if sort_by is not None else None
    groups: "OrderedDict" = OrderedDict()
    for rec in records:
        groups.setdefault(rec[gi], []).append(list(rec))
    out = []
    for _, rows in groups.items():
        if si is not None:
            rows.sort(key=lambda r: r[si], reverse=not ascending)
        out.append(rows)
    return out


def window_sequence(sequence: SequenceRecord, window_size: int,
                    stride: Optional[int] = None,
                    drop_partial: bool = True) -> List[SequenceRecord]:
    """Fixed-size windows over one sequence; ``stride < window_size``
    gives overlapping windows (reference: Overlapping vs plain
    TimeWindowFunction, expressed in steps instead of wall time)."""
    if window_size <= 0:
        raise ValueError("window_size must be positive")
    stride = stride or window_size
    out = []
    for start in range(0, len(sequence), stride):
        win = sequence[start:start + window_size]
        if not win:
            break
        if drop_partial and len(win) < window_size:
            break
        out.append(win)
        if start + window_size >= len(sequence) and stride >= window_size:
            break
    return out


def window_sequences(sequences: Sequence[SequenceRecord], window_size: int,
                     stride: Optional[int] = None,
                     drop_partial: bool = True) -> List[SequenceRecord]:
    out = []
    for seq in sequences:
        out.extend(window_sequence(seq, window_size, stride, drop_partial))
    return out


def reduce_sequence(schema: Schema, sequence: SequenceRecord,
                    reducer: Reducer) -> Record:
    """Collapse one sequence to a single record with the reducer's ops
    (reference: ReduceSequenceTransform)."""
    reduced = reducer.reduce(schema, sequence)
    if len(reduced) != 1:
        raise ValueError(
            "reducer key columns must be constant within a sequence "
            f"(got {len(reduced)} groups)")
    return reduced[0]
