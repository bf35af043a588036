"""Vocabulary, negative-sampling tables and subsampling probabilities.

Counterpart of ``deeplearning4j_tpu/nlp/vocab.py`` (the reference's
``VocabWord``, ``AbstractCache``, ``VocabConstructor`` and ``Huffman``), with
the same numpy code, so both packages build equal vocabularies and tables from
one corpus:

- count over the tokenized corpus, prune below ``min_word_frequency``;
- special tokens first, then descending count, ties broken by the word;
- the 2^20-slot unigram^0.75 table, apportioned by largest remainder;
- per-word keep probabilities for frequent-word subsampling.

The Huffman functions come along because they are numpy; the ported
training path (CBOW with negative sampling) does not call them yet.
"""

from __future__ import annotations

import heapq
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclass
class VocabWord:
    """One vocabulary entry."""

    word: str
    count: int
    index: int = -1
    # hierarchical-softmax Huffman path: bits and inner-node ids, root first
    code: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)


class VocabCache:
    """Word <-> index <-> count store."""

    def __init__(self) -> None:
        self._words: List[VocabWord] = []
        self._by_word: Dict[str, VocabWord] = {}
        self.total_word_count = 0

    def add(self, vw: VocabWord) -> None:
        vw.index = len(self._words)
        self._words.append(vw)
        self._by_word[vw.word] = vw
        self.total_word_count += vw.count

    def __len__(self) -> int:
        return len(self._words)

    def __contains__(self, word: str) -> bool:
        return word in self._by_word

    def word_for(self, index: int) -> str:
        return self._words[index].word

    def index_of(self, word: str) -> int:
        vw = self._by_word.get(word)
        return -1 if vw is None else vw.index

    def entry(self, word: str) -> Optional[VocabWord]:
        return self._by_word.get(word)

    def entry_at(self, index: int) -> VocabWord:
        return self._words[index]

    def words(self) -> List[str]:
        return [w.word for w in self._words]

    def counts(self) -> np.ndarray:
        return np.asarray([w.count for w in self._words], dtype=np.int64)


class VocabConstructor:
    """Corpus scan -> pruned, count-sorted VocabCache."""

    def __init__(self, min_word_frequency: int = 5,
                 special_tokens: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.special_tokens = list(special_tokens)

    def build(self, token_stream: Iterable[List[str]]) -> VocabCache:
        counts: Counter = Counter()
        for tokens in token_stream:
            counts.update(tokens)
        cache = VocabCache()
        # special tokens are exempt from frequency pruning
        for tok in self.special_tokens:
            cache.add(VocabWord(tok, max(counts.pop(tok, 0), 1)))
        kept = [(w, c) for w, c in counts.items()
                if c >= self.min_word_frequency]
        # descending count, ties by word for determinism
        kept.sort(key=lambda wc: (-wc[1], wc[0]))
        for w, c in kept:
            cache.add(VocabWord(w, c))
        return cache


def build_huffman(cache: VocabCache, max_code_length: int = 40) -> None:
    """Assign Huffman ``code``/``points`` to every VocabWord in place
    (repeatedly merge the two least frequent nodes; inner node ids are
    ``node_id - vocab_size`` so they index syn1)."""
    n = len(cache)
    if n == 0:
        return
    heap = [(cache.entry_at(i).count, i, i) for i in range(n)]
    heapq.heapify(heap)
    parent = np.zeros(2 * n, dtype=np.int64)
    binary = np.zeros(2 * n, dtype=np.int8)
    next_id = n
    while len(heap) > 1:
        c1, _, i1 = heapq.heappop(heap)
        c2, _, i2 = heapq.heappop(heap)
        parent[i1] = next_id
        parent[i2] = next_id
        binary[i2] = 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2]
    for i in range(n):
        code: List[int] = []
        points: List[int] = []
        node = i
        while node != root:
            code.append(int(binary[node]))
            node = int(parent[node])
            points.append(node - n)
        code.reverse()
        points.reverse()
        vw = cache.entry_at(i)
        vw.code = code[:max_code_length]
        vw.points = points[:max_code_length]


def huffman_arrays(cache: VocabCache) -> tuple:
    """Dense (codes, points, mask) arrays [V, L], every path padded to the
    longest and masked."""
    n = len(cache)
    L = max((len(cache.entry_at(i).code) for i in range(n)), default=1) or 1
    codes = np.zeros((n, L), dtype=np.int32)
    points = np.zeros((n, L), dtype=np.int32)
    mask = np.zeros((n, L), dtype=np.float32)
    for i in range(n):
        vw = cache.entry_at(i)
        k = len(vw.code)
        codes[i, :k] = vw.code
        points[i, :k] = vw.points
        mask[i, :k] = 1.0
    return codes, points, mask


def unigram_table(cache: VocabCache, power: float = 0.75) -> np.ndarray:
    """Cumulative f^0.75 distribution (exact CDF)."""
    counts = cache.counts().astype(np.float64)
    probs = counts ** power
    probs /= probs.sum()
    return np.cumsum(probs)


def unigram_int_table(cache: VocabCache, power: float = 0.75,
                      size: int = 1 << 20) -> np.ndarray:
    """Power-of-two int32 negative-sampling table: word i occupies a number
    of slots proportional to f_i^power (largest-remainder apportionment), so
    a draw is ``bits & (size - 1)`` and one gather. Words with probability
    below 1/size may get no slot, as in the reference's finite table."""
    if size <= 0 or size & (size - 1):
        raise ValueError(f"size must be a power of two, got {size}")
    counts = cache.counts().astype(np.float64)
    if counts.size == 0 or counts.sum() <= 0:
        raise ValueError("empty vocabulary after pruning — cannot build "
                         "the negative-sampling table")
    probs = counts ** power
    probs /= probs.sum()
    alloc = np.floor(probs * size).astype(np.int64)
    shortfall = size - alloc.sum()
    if shortfall > 0:
        frac = probs * size - alloc
        alloc[np.argsort(-frac)[:shortfall]] += 1
    return np.repeat(np.arange(len(counts), dtype=np.int32), alloc)


def subsample_keep_probs(cache: VocabCache, sampling: float) -> np.ndarray:
    """Per-word keep probability for frequent-word subsampling (the word2vec
    formula keep = sqrt(t*N/f) + t*N/f, clipped to [0, 1])."""
    if sampling <= 0:
        return np.ones(len(cache), dtype=np.float64)
    counts = cache.counts().astype(np.float64)
    total = counts.sum()
    ratio = sampling * total / np.maximum(counts, 1.0)
    keep = np.sqrt(ratio) + ratio
    return np.clip(keep, 0.0, 1.0)
