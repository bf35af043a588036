"""Thread-safe event counters and gauges.

The counter part of ``deeplearning4j_tpu/common/profiler.py``'s
``OpProfiler``, with the same names:

- the fused inference epilogue: ``precision/epilogue_hits``,
  ``precision/epilogue_fallbacks``, ``precision/epilogue_residual_hits``;
- the fused weight update: ``precision/fused_hits`` (buckets updated by
  ``ops/update.fused_apply``), ``precision/fused_buckets_kernel`` (of those,
  by the CUDA kernel; the JAX package's ``fused_buckets_pallas``),
  ``precision/fused_buckets_plain`` (by the plain version: CPU tensors or a
  non-float32 bucket), ``precision/fused_fallbacks`` (an updater without a
  kernel, or not elementwise), ``precision/sr_draws`` (random 32-bit draws
  for stochastic rounding);
- Word2Vec: ``nlp/w2v_blocks`` and ``nlp/w2v_rounds`` (CBOW blocks and
  rounds run; each round launches ``embedding_bag`` once, counted beside
  its wrapper as ``ops/embeddings.embedding_bag_launches``);
- attention: ``attention/mha_flash`` and ``attention/mha_dense`` (calls of
  ``ops/nn.multi_head_dot_product_attention`` that took flash attention or
  the dense path), and the flash kernel's launches by route:
  ``attention/flash_bf16`` (the bf16 kernel, bf16 inputs as they lie) and
  ``attention/flash_f32`` (the float32 kernel, inputs cast to float32);
  both together are counted beside the wrappers as
  ``ops/attention.flash_attention_launches``. The JAX package counts none
  of these;
- gauges (levels, set not added): ``precision/grads_flat_in_step`` (1 when
  the step's gradients were born in the flat buckets) and
  ``precision/updater_state_bytes_<dtype>`` / ``..._total``;
- data-parallel training (``parallel/wrapper.py``): the gradient-exchange
  ledger ``collective/*`` and ``zero1/*`` (:meth:`OpProfiler.collective_stats`),
  the elastic ledger ``elastic/*`` (:meth:`OpProfiler.elastic_stats`) and
  the replica-consistency ledger ``integrity/*``
  (:meth:`OpProfiler.integrity_stats`), with the JAX package's names; and
  wall-clock sections (:meth:`OpProfiler.time_section`).

The port runs eagerly, so a counter counts calls, where the JAX package,
counting at trace time, counts traces.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional


class OpProfiler:
    _instance: Optional["OpProfiler"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._sections: Dict[str, Dict[str, float]] = {}
        self._counter_lock = threading.Lock()

    @classmethod
    def get(cls) -> "OpProfiler":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def count(self, name: str, n: int = 1) -> None:
        with self._counter_lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: int) -> None:
        with self._counter_lock:
            self._counters[name] = value

    def counter_value(self, name: str) -> int:
        with self._counter_lock:
            return self._counters.get(name, 0)

    def get_counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self._counters)

    @contextmanager
    def time_section(self, name: str):
        """Wall-clock time of the ``with`` block under ``name``: count,
        total and largest seconds (:meth:`get_statistics`)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._counter_lock:
                s = self._sections.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                s["count"] += 1
                s["total_s"] += dt
                s["max_s"] = max(s["max_s"], dt)

    def get_statistics(self) -> Dict[str, Dict[str, float]]:
        with self._counter_lock:
            return {k: dict(v) for k, v in self._sections.items()}

    def _with_prefix(self, prefix: str) -> Dict[str, float]:
        with self._counter_lock:
            return {k.split("/", 1)[1]: v for k, v in self._counters.items()
                    if k.startswith(prefix)}

    def collective_stats(self) -> Dict[str, float]:
        """The gradient-exchange ledger (the JAX package's
        ``collective_stats``): bytes per collective kind, the ZeRO-1
        updater-state footprint, and the encoded exchange's element counts
        with their density and the wire-format estimate (4-byte indices,
        or a 2-bit bitmap when that is smaller)."""
        out = self._with_prefix("collective/")
        with self._counter_lock:
            for ctr in ("zero1/updater_state_bytes_total",
                        "zero1/updater_state_bytes_per_replica"):
                n = self._counters.get(ctr)
                if n:
                    out[ctr.replace("/", "_")] = n
        sent = out.get("encoded_elems_sent")
        total = out.get("encoded_elems_total")
        if total:
            out["encoded_density"] = sent / total
            out["encoded_bytes_est"] = int(min(4 * sent, total // 4))
            out["encoded_dense_bytes_equiv"] = int(4 * total)
        return out

    def elastic_stats(self) -> Dict[str, float]:
        """The elastic ledger: resizes, shrinks, grows, the live worker
        count, and the resize section's seconds."""
        out = self._with_prefix("elastic/")
        with self._counter_lock:
            s = self._sections.get("elastic/resize")
            if s:
                out["resize_s"] = s["total_s"]
                out["resize_count"] = s["count"]
        return out

    def integrity_stats(self) -> Dict[str, float]:
        """The replica-consistency ledger: checks, divergences and
        injected bit flips."""
        return self._with_prefix("integrity/")

    def reset(self) -> None:
        with self._counter_lock:
            self._counters.clear()
            self._sections.clear()
