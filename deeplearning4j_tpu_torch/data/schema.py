"""Schema + TransformProcess (DataVec transform layer analog).

Counterpart of ``deeplearning4j_tpu/data/schema.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: datavec-api ``org.datavec.api.transform.schema.Schema`` and
``org.datavec.api.transform.TransformProcess`` (SURVEY.md §2.3 DataVec core
row): a declarative, schema-checked pipeline of column transforms compiled
once and applied per record. This rebuild keeps the same two-phase shape —
``TransformProcess.Builder`` validates each step against the evolving schema
at BUILD time (so column-name typos fail before any data flows), and
``execute`` applies the compiled steps to record collections.

Transforms operate on host-side Python records (the DataVec layer is a CPU
ETL stage in the reference too); the accelerator sees only the final dense
arrays assembled by ``RecordReaderDataSetIterator``.
"""

from __future__ import annotations

import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from .records import Record


class ColumnType:
    NUMERIC = "numeric"       # float/int cell
    INTEGER = "integer"
    CATEGORICAL = "categorical"
    STRING = "string"
    TIME = "time"


class Schema:
    """Ordered, typed column list (reference: Schema.Builder)."""

    class Builder:
        def __init__(self) -> None:
            self._cols: List[Dict[str, Any]] = []

        def add_column_double(self, name: str) -> "Schema.Builder":
            self._cols.append({"name": name, "type": ColumnType.NUMERIC})
            return self

        add_column_float = add_column_double

        def add_column_integer(self, name: str) -> "Schema.Builder":
            self._cols.append({"name": name, "type": ColumnType.INTEGER})
            return self

        def add_column_long(self, name: str) -> "Schema.Builder":
            return self.add_column_integer(name)

        def add_column_categorical(self, name: str,
                                   state_names: Sequence[str]) \
                -> "Schema.Builder":
            self._cols.append({"name": name, "type": ColumnType.CATEGORICAL,
                               "states": list(state_names)})
            return self

        def add_column_string(self, name: str) -> "Schema.Builder":
            self._cols.append({"name": name, "type": ColumnType.STRING})
            return self

        def add_column_time(self, name: str) -> "Schema.Builder":
            self._cols.append({"name": name, "type": ColumnType.TIME})
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()

    def __init__(self, cols: List[Dict[str, Any]]):
        self._cols = [dict(c) for c in cols]
        names = [c["name"] for c in self._cols]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names: {names}")

    # -- queries ----------------------------------------------------------
    def num_columns(self) -> int:
        return len(self._cols)

    def column_names(self) -> List[str]:
        return [c["name"] for c in self._cols]

    def column_type(self, name: str) -> str:
        return self._col(name)["type"]

    def categorical_states(self, name: str) -> List[str]:
        c = self._col(name)
        if c["type"] != ColumnType.CATEGORICAL:
            raise ValueError(f"column {name!r} is {c['type']}, "
                             "not categorical")
        return list(c["states"])

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self._cols):
            if c["name"] == name:
                return i
        raise KeyError(f"no column {name!r}; have {self.column_names()}")

    def _col(self, name: str) -> Dict[str, Any]:
        return self._cols[self.index_of(name)]

    def to_json(self) -> str:
        return json.dumps({"columns": self._cols})

    @staticmethod
    def from_json(s: str) -> "Schema":
        return Schema(json.loads(s)["columns"])

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self._cols == other._cols


class _Step:
    """One compiled transform: fn(record) -> record | None (None = filtered
    out), plus the schema it produces."""

    def __init__(self, name: str, fn: Callable[[Record], Optional[Record]],
                 out_schema: Schema):
        self.name = name
        self.fn = fn
        self.out_schema = out_schema


class TransformProcess:
    """Schema-validated transform pipeline (reference: TransformProcess)."""

    class Builder:
        def __init__(self, initial_schema: Schema):
            self._initial = initial_schema
            self._schema = initial_schema
            self._steps: List[_Step] = []

        # -- column surgery ---------------------------------------------
        def remove_columns(self, *names: str) -> "TransformProcess.Builder":
            idxs = sorted(self._schema.index_of(n) for n in names)
            keep = [i for i in range(self._schema.num_columns())
                    if i not in idxs]
            out = Schema([self._schema._cols[i] for i in keep])

            def fn(rec, keep=tuple(keep)):
                return [rec[i] for i in keep]

            self._push(f"remove{names}", fn, out)
            return self

        def remove_all_columns_except(self, *names: str) \
                -> "TransformProcess.Builder":
            drop = [n for n in self._schema.column_names() if n not in names]
            return self.remove_columns(*drop)

        def rename_column(self, old: str, new: str) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(old)
            cols = [dict(c) for c in self._schema._cols]
            cols[i]["name"] = new
            self._push(f"rename {old}->{new}", lambda rec: rec, Schema(cols))
            return self

        def reorder_columns(self, *names: str) -> "TransformProcess.Builder":
            idxs = [self._schema.index_of(n) for n in names]
            if len(idxs) != self._schema.num_columns():
                raise ValueError("reorder must list every column")
            out = Schema([self._schema._cols[i] for i in idxs])

            def fn(rec, idxs=tuple(idxs)):
                return [rec[i] for i in idxs]

            self._push("reorder", fn, out)
            return self

        def duplicate_column(self, name: str, new_name: str) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            col = dict(self._schema._cols[i])
            col["name"] = new_name
            out = Schema(self._schema._cols + [col])

            def fn(rec, i=i):
                return rec + [rec[i]]

            self._push(f"dup {name}", fn, out)
            return self

        # -- type conversions --------------------------------------------
        def string_to_categorical(self, name: str,
                                  state_names: Sequence[str]) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            cols = [dict(c) for c in self._schema._cols]
            cols[i] = {"name": name, "type": ColumnType.CATEGORICAL,
                       "states": list(state_names)}
            states = set(state_names)

            def fn(rec, i=i, states=states):
                if rec[i] not in states:
                    raise ValueError(
                        f"value {rec[i]!r} not a declared state of "
                        f"column {name!r}")
                return rec

            self._push(f"str->cat {name}", fn, Schema(cols))
            return self

        def categorical_to_integer(self, name: str) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            states = self._schema.categorical_states(name)
            lookup = {s: k for k, s in enumerate(states)}
            cols = [dict(c) for c in self._schema._cols]
            cols[i] = {"name": name, "type": ColumnType.INTEGER}

            def fn(rec, i=i, lookup=lookup):
                rec = list(rec)
                rec[i] = lookup[rec[i]]
                return rec

            self._push(f"cat->int {name}", fn, Schema(cols))
            return self

        def categorical_to_one_hot(self, name: str) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            states = self._schema.categorical_states(name)
            lookup = {s: k for k, s in enumerate(states)}
            cols = [dict(c) for c in self._schema._cols]
            onehot_cols = [{"name": f"{name}[{s}]",
                            "type": ColumnType.INTEGER} for s in states]
            cols[i:i + 1] = onehot_cols

            def fn(rec, i=i, lookup=lookup, n=len(states)):
                hot = [0] * n
                hot[lookup[rec[i]]] = 1
                return rec[:i] + hot + rec[i + 1:]

            self._push(f"cat->onehot {name}", fn, Schema(cols))
            return self

        def convert_to_double(self, name: str) -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            cols = [dict(c) for c in self._schema._cols]
            cols[i] = {"name": name, "type": ColumnType.NUMERIC}

            def fn(rec, i=i):
                rec = list(rec)
                rec[i] = float(rec[i])
                return rec

            self._push(f"->double {name}", fn, Schema(cols))
            return self

        def convert_to_integer(self, name: str) -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            cols = [dict(c) for c in self._schema._cols]
            cols[i] = {"name": name, "type": ColumnType.INTEGER}

            def fn(rec, i=i):
                rec = list(rec)
                rec[i] = int(float(rec[i]))
                return rec

            self._push(f"->int {name}", fn, Schema(cols))
            return self

        # -- math / string ops -------------------------------------------
        def double_math_op(self, name: str, op: str, value: float) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)
            self._require(name, (ColumnType.NUMERIC, ColumnType.INTEGER))
            ops = {"add": lambda v: v + value,
                   "subtract": lambda v: v - value,
                   "multiply": lambda v: v * value,
                   "divide": lambda v: v / value,
                   "modulus": lambda v: v % value,
                   "power": lambda v: v ** value}
            if op not in ops:
                raise ValueError(f"unknown math op {op!r}")
            f = ops[op]

            def fn(rec, i=i):
                rec = list(rec)
                rec[i] = f(float(rec[i]))
                return rec

            self._push(f"{op} {name}", fn, self._schema)
            return self

        def min_max_normalize(self, name: str, lo: float, hi: float) \
                -> "TransformProcess.Builder":
            """(x - lo) / (hi - lo) with the column's known range
            (reference: MinMaxNormalizer transform)."""
            i = self._schema.index_of(name)
            self._require(name, (ColumnType.NUMERIC, ColumnType.INTEGER))
            span = hi - lo
            if span <= 0:
                raise ValueError("hi must exceed lo")

            def fn(rec, i=i):
                rec = list(rec)
                rec[i] = (float(rec[i]) - lo) / span
                return rec

            self._push(f"minmax {name}", fn, self._schema)
            return self

        def string_map_transform(self, name: str, fn_str: Callable[[str], str]) \
                -> "TransformProcess.Builder":
            i = self._schema.index_of(name)

            def fn(rec, i=i):
                rec = list(rec)
                rec[i] = fn_str(str(rec[i]))
                return rec

            self._push(f"strmap {name}", fn, self._schema)
            return self

        # -- filters ------------------------------------------------------
        def filter_invalid_values(self, *names: str) \
                -> "TransformProcess.Builder":
            """Drop records whose named numeric cells fail to parse
            (reference: FilterInvalidValues)."""
            idxs = [self._schema.index_of(n) for n in names]

            def fn(rec, idxs=tuple(idxs)):
                for i in idxs:
                    try:
                        v = float(rec[i])
                    except (TypeError, ValueError):
                        return None
                    if math.isnan(v) or math.isinf(v):
                        return None
                return rec

            self._push(f"filter-invalid {names}", fn, self._schema)
            return self

        def filter(self, predicate: Callable[[Record], bool],
                   name: str = "filter") -> "TransformProcess.Builder":
            """Keep records where predicate(record) is True."""

            def fn(rec):
                return rec if predicate(rec) else None

            self._push(name, fn, self._schema)
            return self

        # -- plumbing ------------------------------------------------------
        def _require(self, name: str, types) -> None:
            t = self._schema.column_type(name)
            if t not in types:
                raise ValueError(
                    f"column {name!r} has type {t}, need one of {types}")

        def _push(self, name, fn, out_schema) -> None:
            self._steps.append(_Step(name, fn, out_schema))
            self._schema = out_schema

        def build(self) -> "TransformProcess":
            return TransformProcess(self._initial, self._steps)

    @staticmethod
    def builder(initial_schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(initial_schema)

    def __init__(self, initial_schema: Schema, steps: List[_Step]):
        self.initial_schema = initial_schema
        self._steps = steps

    def final_schema(self) -> Schema:
        return self._steps[-1].out_schema if self._steps \
            else self.initial_schema

    def execute(self, records) -> List[Record]:
        """Apply the pipeline to an iterable of records; filtered records
        are dropped (reference: LocalTransformExecutor.execute)."""
        out = []
        for rec in records:
            if len(rec) != self.initial_schema.num_columns():
                raise ValueError(
                    f"record width {len(rec)} != schema width "
                    f"{self.initial_schema.num_columns()}: {rec!r}")
            cur: Optional[Record] = list(rec)
            for step in self._steps:
                cur = step.fn(cur)
                if cur is None:
                    break
            if cur is not None:
                out.append(cur)
        return out

    def transform(self, record: Record) -> Optional[Record]:
        cur: Optional[Record] = list(record)
        for step in self._steps:
            cur = step.fn(cur)
            if cur is None:
                return None
        return cur
