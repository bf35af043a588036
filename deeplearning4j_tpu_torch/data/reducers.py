"""Reduction (group-by aggregation) and joins over record collections.

Counterpart of ``deeplearning4j_tpu/data/reducers.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: datavec-api ``transform.reduce.Reducer`` (+ ``ReduceOp``) and
``transform.join.Join`` (SURVEY §2.3 DataVec core row). Same shapes: a
``Reducer`` groups records by key columns and aggregates every other
column with a configured op; a ``Join`` merges two record collections on
key columns with Inner/LeftOuter/RightOuter/FullOuter semantics.

Host-side pure Python/numpy — this is ETL front matter feeding the
vectorized DataSet assembly, not device math.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .records import Record
from .schema import Schema

_NUMERIC = ("double", "numeric", "integer", "long", "time")


def _agg(op: str, values: List[Any]):
    if op == "count":
        return len(values)
    if op == "count_unique":
        return len(set(values))
    if op == "first":
        return values[0]
    if op == "last":
        return values[-1]
    arr = np.asarray([float(v) for v in values], np.float64)
    if op == "sum":
        return float(arr.sum())
    if op == "mean":
        return float(arr.mean())
    if op == "min":
        return float(arr.min())
    if op == "max":
        return float(arr.max())
    if op == "range":
        return float(arr.max() - arr.min())
    if op == "stdev":
        return float(arr.std(ddof=1)) if arr.size > 1 else 0.0
    raise ValueError(f"unknown reduce op {op!r}")


_OUT_TYPE = {"count": "long", "count_unique": "long", "sum": "double",
             "mean": "double", "min": "double", "max": "double",
             "range": "double", "stdev": "double"}


class Reducer:
    """reference: Reducer.Builder(ReduceOp default).keyColumns(...)
    .sumColumns(...).meanColumns(...)... then ``reduce(records)``."""

    class Builder:
        def __init__(self, default_op: str = "first"):
            self._default = default_op
            self._keys: Tuple[str, ...] = ()
            self._ops: Dict[str, str] = {}

        def key_columns(self, *names: str) -> "Reducer.Builder":
            self._keys = names
            return self

        def _set(self, op: str, names: Sequence[str]) -> "Reducer.Builder":
            for n in names:
                self._ops[n] = op
            return self

        def sum_columns(self, *n): return self._set("sum", n)
        def mean_columns(self, *n): return self._set("mean", n)
        def min_columns(self, *n): return self._set("min", n)
        def max_columns(self, *n): return self._set("max", n)
        def range_columns(self, *n): return self._set("range", n)
        def stdev_columns(self, *n): return self._set("stdev", n)
        def count_columns(self, *n): return self._set("count", n)
        def count_unique_columns(self, *n): return self._set("count_unique", n)
        def first_columns(self, *n): return self._set("first", n)
        def last_columns(self, *n): return self._set("last", n)

        def build(self) -> "Reducer":
            if not self._keys:
                raise ValueError("key_columns required")
            return Reducer(self._keys, self._ops, self._default)

    @staticmethod
    def builder(default_op: str = "first") -> "Reducer.Builder":
        return Reducer.Builder(default_op)

    def __init__(self, keys: Sequence[str], ops: Dict[str, str],
                 default_op: str):
        self.keys = tuple(keys)
        self.ops = dict(ops)
        self.default_op = default_op

    def output_schema(self, schema: Schema) -> Schema:
        b = Schema.builder()
        for name in schema.column_names():
            if name in self.keys:
                ctype = schema.column_type(name)
            else:
                op = self.ops.get(name, self.default_op)
                ctype = _OUT_TYPE.get(op, schema.column_type(name))
            out_name = name if name in self.keys else \
                f"{self.ops.get(name, self.default_op)}({name})"
            if ctype == "integer":
                b.add_column_integer(out_name)
            elif ctype == "long":
                b.add_column_long(out_name)
            elif ctype == "categorical":
                b.add_column_categorical(out_name,
                                         schema.categorical_states(name))
            elif ctype == "string":
                b.add_column_string(out_name)
            else:
                b.add_column_double(out_name)
        return b.build()

    def reduce(self, schema: Schema, records: Sequence[Record]
               ) -> List[Record]:
        key_idx = [schema.index_of(k) for k in self.keys]
        names = schema.column_names()
        groups: "OrderedDict[Tuple, List[Record]]" = OrderedDict()
        for rec in records:
            k = tuple(rec[i] for i in key_idx)
            groups.setdefault(k, []).append(rec)
        out = []
        for k, rows in groups.items():
            rec_out: Record = []
            for i, name in enumerate(names):
                if name in self.keys:
                    rec_out.append(rows[0][i])
                else:
                    op = self.ops.get(name, self.default_op)
                    rec_out.append(_agg(op, [r[i] for r in rows]))
            out.append(rec_out)
        return out


class Join:
    """reference: transform.join.Join.Builder(JoinType).setJoinColumns(...)
    over two schemas; ``execute`` merges the record collections. Output
    columns = left columns + right columns minus the (shared) keys."""

    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"

    class Builder:
        def __init__(self, join_type: str = "inner"):
            self._type = join_type
            self._keys: Tuple[str, ...] = ()
            self._left: Optional[Schema] = None
            self._right: Optional[Schema] = None

        def set_join_columns(self, *names: str) -> "Join.Builder":
            self._keys = names
            return self

        def set_schemas(self, left: Schema, right: Schema) -> "Join.Builder":
            self._left, self._right = left, right
            return self

        def build(self) -> "Join":
            if not self._keys or self._left is None or self._right is None:
                raise ValueError("join columns + both schemas required")
            return Join(self._type, self._keys, self._left, self._right)

    @staticmethod
    def builder(join_type: str = "inner") -> "Join.Builder":
        return Join.Builder(join_type)

    def __init__(self, join_type: str, keys: Sequence[str], left: Schema,
                 right: Schema):
        if join_type not in (self.INNER, self.LEFT_OUTER, self.RIGHT_OUTER,
                             self.FULL_OUTER):
            raise ValueError(f"unknown join type {join_type!r}")
        self.join_type = join_type
        self.keys = tuple(keys)
        self.left = left
        self.right = right

    def output_schema(self) -> Schema:
        b = Schema.builder()
        added = set()

        def add(schema, name):
            ctype = schema.column_type(name)
            if ctype == "integer":
                b.add_column_integer(name)
            elif ctype == "long":
                b.add_column_long(name)
            elif ctype == "categorical":
                b.add_column_categorical(name,
                                         schema.categorical_states(name))
            elif ctype == "string":
                b.add_column_string(name)
            else:
                b.add_column_double(name)
            added.add(name)

        for n in self.left.column_names():
            add(self.left, n)
        for n in self.right.column_names():
            if n not in self.keys:
                add(self.right, f"right_{n}" if n in added else n)
        return b.build()

    def execute(self, left_records: Sequence[Record],
                right_records: Sequence[Record]) -> List[Record]:
        lk = [self.left.index_of(k) for k in self.keys]
        rk = [self.right.index_of(k) for k in self.keys]
        r_nonkey = [i for i, n in enumerate(self.right.column_names())
                    if n not in self.keys]
        r_by_key: "OrderedDict[Tuple, List[Record]]" = OrderedDict()
        for rec in right_records:
            r_by_key.setdefault(tuple(rec[i] for i in rk), []).append(rec)
        out: List[Record] = []
        matched_right = set()
        for rec in left_records:
            k = tuple(rec[i] for i in lk)
            matches = r_by_key.get(k)
            if matches:
                matched_right.add(k)
                for rrec in matches:
                    out.append(list(rec) + [rrec[i] for i in r_nonkey])
            elif self.join_type in (self.LEFT_OUTER, self.FULL_OUTER):
                out.append(list(rec) + [None] * len(r_nonkey))
        if self.join_type in (self.RIGHT_OUTER, self.FULL_OUTER):
            left_names = self.left.column_names()
            for k, rrecs in r_by_key.items():
                if k in matched_right:
                    continue
                for rrec in rrecs:
                    rec_out: Record = []
                    for n in left_names:
                        if n in self.keys:
                            rec_out.append(k[self.keys.index(n)])
                        else:
                            rec_out.append(None)
                    rec_out.extend(rrec[i] for i in r_nonkey)
                    out.append(rec_out)
        return out
