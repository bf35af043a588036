"""Column analysis over record collections (AnalyzeLocal analog).

Counterpart of ``deeplearning4j_tpu/data/analysis.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: datavec ``transform.analysis.AnalyzeLocal.analyze(schema, rr)``
→ ``DataAnalysis`` with per-column statistics (SURVEY §2.3 DataVec core
row): numeric min/max/mean/stdev/zero- and missing-counts + histogram,
categorical state counts, string length stats.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .records import Record
from .schema import Schema

_NUMERIC = ("double", "numeric", "integer", "long", "time")


@dataclass
class ColumnAnalysis:
    name: str
    ctype: str
    count: int = 0
    count_missing: int = 0
    # numeric
    min: Optional[float] = None
    max: Optional[float] = None
    mean: Optional[float] = None
    stdev: Optional[float] = None
    count_zero: int = 0
    histogram_buckets: Optional[List[float]] = None
    histogram_counts: Optional[List[int]] = None
    # categorical / string
    state_counts: Optional[Dict[str, int]] = None
    min_length: Optional[int] = None
    max_length: Optional[int] = None

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if v is not None}


class DataAnalysis:
    def __init__(self, schema: Schema, columns: List[ColumnAnalysis]):
        self.schema = schema
        self._by_name = {c.name: c for c in columns}
        self.columns = columns

    def column_analysis(self, name: str) -> ColumnAnalysis:
        return self._by_name[name]

    def to_json(self) -> str:
        return json.dumps({c.name: c.to_dict() for c in self.columns},
                          indent=2)

    def __str__(self) -> str:
        return self.to_json()


class AnalyzeLocal:
    """reference: AnalyzeLocal.analyze — single-pass local analysis."""

    @staticmethod
    def analyze(schema: Schema, records: Sequence[Record],
                n_histogram_buckets: int = 20) -> DataAnalysis:
        cols = []
        names = schema.column_names()
        for i, name in enumerate(names):
            ctype = schema.column_type(name)
            values = [r[i] for r in records]
            present = [v for v in values if v is not None and v != ""]
            ca = ColumnAnalysis(name=name, ctype=ctype, count=len(values),
                                count_missing=len(values) - len(present))
            if ctype in _NUMERIC and present:
                arr = np.asarray([float(v) for v in present], np.float64)
                ca.min = float(arr.min())
                ca.max = float(arr.max())
                ca.mean = float(arr.mean())
                ca.stdev = float(arr.std(ddof=1)) if arr.size > 1 else 0.0
                ca.count_zero = int((arr == 0).sum())
                counts, edges = np.histogram(arr, bins=n_histogram_buckets)
                ca.histogram_buckets = [float(e) for e in edges]
                ca.histogram_counts = [int(c) for c in counts]
            elif ctype == "categorical" and present:
                sc: Dict[str, int] = {}
                for v in present:
                    sc[str(v)] = sc.get(str(v), 0) + 1
                ca.state_counts = sc
            elif ctype == "string" and present:
                lens = [len(str(v)) for v in present]
                ca.min_length = min(lens)
                ca.max_length = max(lens)
            cols.append(ca)
        return DataAnalysis(schema, cols)
