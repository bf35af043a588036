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
  ``precision/updater_state_bytes_<dtype>`` / ``..._total``.

The port runs eagerly, so a counter counts calls, where the JAX package,
counting at trace time, counts traces.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class OpProfiler:
    _instance: Optional["OpProfiler"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
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

    def reset(self) -> None:
        with self._counter_lock:
            self._counters.clear()
