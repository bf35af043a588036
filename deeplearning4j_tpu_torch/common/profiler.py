"""Thread-safe event counters.

The counter part of ``deeplearning4j_tpu/common/profiler.py``'s
``OpProfiler``, with the same counter names (``precision/epilogue_hits``,
``precision/epilogue_fallbacks``, ``precision/epilogue_residual_hits``).
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

    def counter_value(self, name: str) -> int:
        with self._counter_lock:
            return self._counters.get(name, 0)

    def get_counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return dict(self._counters)

    def reset(self) -> None:
        with self._counter_lock:
            self._counters.clear()
