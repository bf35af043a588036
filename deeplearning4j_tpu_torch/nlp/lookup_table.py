"""In-memory embedding tables.

Counterpart of ``deeplearning4j_tpu/nlp/lookup_table.py``. ``syn0`` (input
vectors) and ``syn1neg`` (negative-sampling output vectors) are numpy arrays
on the host between fits, for queries; a fit copies them to the device, trains
them there and copies them back. Initialization is the JAX package's, draw for
draw: syn0 ~ U(-0.5, 0.5)/d from ``np.random.default_rng(seed)``, syn1 and
syn1neg zeros, so both packages start from bitwise equal tables.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class InMemoryLookupTable:
    def __init__(self, vocab_size: int, vector_length: int,
                 seed: int = 42, dtype: str = "float32"):
        self.vocab_size = vocab_size
        self.vector_length = vector_length
        self.seed = seed
        self.dtype = np.dtype(dtype)
        self.syn0: Optional[np.ndarray] = None
        self.syn1: Optional[np.ndarray] = None
        self.syn1neg: Optional[np.ndarray] = None

    def reset_weights(self, use_hs: bool, use_neg: bool) -> None:
        rng = np.random.default_rng(self.seed)
        d = self.vector_length
        self.syn0 = ((rng.random((self.vocab_size, d)) - 0.5) / d) \
            .astype(self.dtype)
        self.syn1 = (np.zeros((self.vocab_size, d), dtype=self.dtype)
                     if use_hs else None)
        self.syn1neg = (np.zeros((self.vocab_size, d), dtype=self.dtype)
                        if use_neg else None)

    def vector(self, index: int) -> np.ndarray:
        return np.asarray(self.syn0[index])

    def normalized(self) -> np.ndarray:
        """Row-normalized syn0 for cosine queries (not cached: training
        changes syn0)."""
        w = np.asarray(self.syn0, dtype=np.float32)
        norms = np.linalg.norm(w, axis=1, keepdims=True)
        return w / np.maximum(norms, 1e-12)
