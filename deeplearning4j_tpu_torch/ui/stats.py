"""StatsListener -> StatsStorage: the training metrics bus.

Counterpart of ``deeplearning4j_tpu/ui/stats.py``: ``StatsStorage`` (the
SPI), ``InMemoryStatsStorage`` (queryable records), ``FileStatsStorage``
(append-only JSONL, the same records line for line),
``TensorBoardStatsStorage`` (``tfevents`` files through
``ui/tensorboard.py``) and ``StatsListener``. ``optimize/telemetry.
TelemetrySink`` drains the in-step telemetry into the same storages.
Reference: deeplearning4j-ui ``StatsListener`` / ``StatsStorage`` (SURVEY.md
§2.3 Training UI row, §5.5).

``StatsListener`` receives the loss as a device scalar and reads anything
back only every ``collect_every_n`` iterations: the score and the per-layer
parameter statistics of one collection come to the host in ONE
device-to-host copy (counted as one host sync by
``common/tracecheck.note_host_sync``), and the iterations in between cost
no synchronisation.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..common import tracecheck
from ..optimize.listeners import TrainingListener
from .tensorboard import TensorBoardEventWriter, host_histogram


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


class TensorBoardStatsStorage(StatsStorage):
    """Scalars and histograms as TensorBoard events: ``tensorboard
    --logdir`` is the training UI (SURVEY §5.5's named equivalent)."""

    def __init__(self, logdir: str):
        self._writer = TensorBoardEventWriter(logdir)

    @property
    def path(self) -> str:
        return self._writer.path

    def put_scalar(self, session, tag, step, value):
        self._writer.add_scalar(f"{session}/{tag}" if session else tag,
                                value, step)
        self._writer.flush()

    def put_histogram(self, session, tag, step, values):
        self._writer.add_histogram(f"{session}/{tag}" if session else tag,
                                   values, step)
        self._writer.flush()

    def close(self):
        self._writer.close()


def _layer_params(model) -> List[Dict[str, Any]]:
    """The per-layer parameter dicts the listener reports, in the JAX
    package's order: a ``MultiLayerNetwork``'s layers by index, a
    ``SameDiff``'s variables as one layer, and nothing for a
    ``ComputationGraph`` (whose JAX parameters are a dict as well)."""
    params = getattr(model, "_params", None)
    if callable(params):
        return [params()]
    keys = getattr(model, "_keys", None)
    if isinstance(params, dict) and keys is not None:
        return [params[k] for k in keys]
    return []


class StatsListener(TrainingListener):
    """Score and per-layer parameter statistics every ``collect_every_n``
    iterations into a StatsStorage (reference: StatsListener with its
    reporting frequency)."""

    def __init__(self, storage: StatsStorage, collect_every_n: int = 10,
                 session_id: str = "", collect_param_norms: bool = True,
                 collect_timing: bool = True,
                 collect_histograms: bool = False):
        self.storage = storage
        self.every = max(1, collect_every_n)
        self.session = session_id
        self.collect_param_norms = collect_param_norms
        self.collect_timing = collect_timing
        self.collect_histograms = collect_histograms
        self._last_time: Optional[float] = None

    def iteration_done(self, model, iteration: int, score) -> None:
        if iteration % self.every:
            return
        named = []
        if self.collect_param_norms or self.collect_histograms:
            for i, lp in enumerate(_layer_params(model)):
                named.extend((i, name, w) for name, w in lp.items())
        score_v, arrays = _collect(score, [w for _, _, w in named],
                                   whole=self.collect_histograms)
        self.storage.put_scalar(self.session, "score", iteration, score_v)
        if self.collect_timing:
            now = time.perf_counter()
            if self._last_time is not None:
                per_iter = (now - self._last_time) / self.every
                self.storage.put_scalar(self.session, "iteration_ms",
                                        iteration, per_iter * 1e3)
            self._last_time = now
        for (i, name, _w), arr in zip(named, arrays):
            if self.collect_param_norms:
                mean = (float(np.mean(np.abs(arr)))
                        if self.collect_histograms else float(arr))
                self.storage.put_scalar(
                    self.session, f"param_mean_magnitude/{i}_{name}",
                    iteration, mean)
            if self.collect_histograms:
                self.storage.put_histogram(
                    self.session, f"param/{i}_{name}", iteration, arr)

    def epoch_done(self, model, epoch: int) -> None:
        self.storage.put_scalar(self.session, "epoch", epoch, epoch)


def _collect(score, tensors: List[torch.Tensor], whole: bool):
    """The score and, per tensor, its mean magnitude (``whole=False``) or
    its values (``whole=True``), brought to the host in one copy: every
    figure is computed on the tensors' device, concatenated as float64 and
    copied once. Returns ``(score, [numpy value per tensor])``."""
    if not isinstance(score, torch.Tensor):
        score = torch.tensor(float(score), dtype=torch.float64)
    dev = score.device
    parts = [score.detach().reshape(1).to(torch.float64)]
    sizes = []
    with torch.no_grad():
        for w in tensors:
            w = w.detach()
            v = (w.reshape(-1) if whole
                 else w.abs().to(torch.float64).mean().reshape(1))
            parts.append(v.to(device=dev, dtype=torch.float64))
            sizes.append(v.numel())
        flat = torch.cat(parts)
    tracecheck.note_host_sync("stats_listener")
    host = flat.cpu().numpy()
    out, pos = [], 1
    for w, n in zip(tensors, sizes):
        v = host[pos:pos + n]
        pos += n
        # np.array: each storage may keep the array, so it owns its bytes
        out.append(np.array(v.reshape(tuple(w.shape))) if whole
                   else float(v[0]))
    return float(host[0]), out
