"""The storages that the training metrics bus writes to.

Counterpart of ``deeplearning4j_tpu/ui/stats.py:30-118``, copied:
``StatsStorage`` (the SPI), ``InMemoryStatsStorage`` (queryable records)
and ``FileStatsStorage`` (append-only JSONL, the same records line for
line). ``optimize/telemetry.TelemetrySink`` drains the in-step telemetry
into them. Reference: deeplearning4j-ui ``StatsStorage`` /
``InMemoryStatsStorage`` / ``FileStatsStorage`` (SURVEY.md §2.3 Training
UI row).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List

import numpy as np


def host_histogram(values, bins: int = 30):
    """(finite_values, counts, edges): non-finite values are dropped and an
    all-empty input becomes a single zero bucket (the JAX package's
    ``ui/tensorboard.host_histogram``)."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,))
    counts, edges = np.histogram(v, bins=bins)
    return v, counts, edges


class StatsStorage:
    """SPI (reference: StatsStorage / StatsStorageRouter)."""

    def put_scalar(self, session: str, tag: str, step: int,
                   value: float) -> None:
        raise NotImplementedError

    def put_histogram(self, session: str, tag: str, step: int,
                      values) -> None:
        """Histogram record (reference StatsListener's per-layer param/
        gradient/update histograms). Default: dropped — scalar-only
        backends stay valid without knowing about histograms."""

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.histograms: List[Dict[str, Any]] = []

    def put_scalar(self, session, tag, step, value):
        self.records.append({"session": session, "tag": tag, "step": step,
                             "value": float(value), "time": time.time()})

    def put_histogram(self, session, tag, step, values):
        _, counts, edges = host_histogram(values)
        self.histograms.append({
            "session": session, "tag": tag, "step": step,
            "bucket": counts.tolist(), "bucket_limit": edges[1:].tolist(),
            "time": time.time()})

    # -- queries (reference: StatsStorage.getAllUpdatesAfter etc.) -------
    def tags(self) -> List[str]:
        return sorted({r["tag"] for r in self.records})

    def histogram_tags(self) -> List[str]:
        return sorted({r["tag"] for r in self.histograms})

    def series(self, tag: str) -> List[tuple]:
        return [(r["step"], r["value"]) for r in self.records
                if r["tag"] == tag]


class FileStatsStorage(StatsStorage):
    """Append-only JSONL (reference: FileStatsStorage's MapDB file)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def put_scalar(self, session, tag, step, value):
        self._f.write(json.dumps({"session": session, "tag": tag,
                                  "step": step, "value": float(value),
                                  "time": time.time()}) + "\n")
        # per-write flush: a live dashboard (UIServer) tails this file
        # per request, and buffered records would lag it by ~8 KB
        self._f.flush()

    def put_histogram(self, session, tag, step, values):
        _, counts, edges = host_histogram(values)
        # "kind" distinguishes the record; scalar consumers (UIServer
        # series) filter on the presence of "value"
        self._f.write(json.dumps({"kind": "histogram", "session": session,
                                  "tag": tag, "step": step,
                                  "bucket": counts.tolist(),
                                  "bucket_limit": edges[1:].tolist(),
                                  "time": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    # torn tail line of a file being written concurrently
                    continue
        return out
