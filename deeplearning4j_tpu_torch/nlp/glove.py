"""GloVe: global vectors from a co-occurrence matrix, trained on the device.

Counterpart of ``deeplearning4j_tpu/nlp/glove.py`` (the reference's ``Glove``
and ``AbstractCoOccurrences``): co-occurrences counted on the host with
1/distance weights inside a symmetric window, then AdaGrad on the weighted
least squares

    J = sum_ij f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = min(1, (x / x_max)^alpha).

- :meth:`Glove.co_occurrences` is the JAX package's numpy code (one
  ``np.unique`` aggregation per chunk of sentences), so both count the same
  triplets bit for bit;
- the initial tables come from ``np.random.default_rng(seed)`` on the host,
  as there, and so does each epoch's order of the triplets;
- the triplets are uploaded once; per epoch the permutation is uploaded and
  the rounds of ``batch_size`` triplets run on the device in blocks of
  ``MAX_BLOCK_ROUNDS`` (:func:`glove_round`). The JAX block is XLA, with no
  Pallas kernel: here the round is eager PyTorch, gathers and
  ``index_add_``, updating the tables in place;
- the final vectors are ``w + w~``.

``words_per_sec`` counts the corpus words of every epoch over the host
counting and the training together (what ``bench.py``'s ``glove_train``
metric says it includes); ``last_fit_timing`` keeps the two apart.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..common import xprof
from ..common.environment import resolve_device
from .lookup_table import InMemoryLookupTable
from .text import (CollectionSentenceIterator, DefaultTokenizerFactory,
                   SentenceIterator, TokenizerFactory)
from .vocab import VocabCache, VocabConstructor
from .word2vec import WordVectors

_EPS = 1e-8


def glove_round(w, wc, b, bc, gw, gwc, gb, gbc, i, j, logx, fw, pm,
                lr: float) -> torch.Tensor:
    """One AdaGrad round over the triplets (i, j, log X_ij) with weights
    ``fw`` and pair mask ``pm``, updating the eight tables in place; returns
    the round's loss (0-dim). The order is the JAX block's: every gradient
    from the rows gathered at the start; the accumulators take their
    scatter-adds (duplicates summing) before they are read back for the
    step; then the steps scatter into w, w~, b and b~."""
    wi, wj = w[i], wc[j]
    diff = (wi * wj).sum(dim=1) + b[i] + bc[j] - logx
    fdiff = fw * diff * pm
    loss = 0.5 * (fdiff * diff).sum()
    g_wi = fdiff[:, None] * wj
    g_wj = fdiff[:, None] * wi
    g_b = fdiff * fdiff
    gw.index_add_(0, i, g_wi * g_wi)
    gwc.index_add_(0, j, g_wj * g_wj)
    gb.index_add_(0, i, g_b)
    gbc.index_add_(0, j, g_b)
    w.index_add_(0, i, -lr * g_wi / torch.sqrt(gw[i] + _EPS))
    wc.index_add_(0, j, -lr * g_wj / torch.sqrt(gwc[j] + _EPS))
    b.index_add_(0, i, -lr * fdiff / torch.sqrt(gb[i] + _EPS))
    bc.index_add_(0, j, -lr * fdiff / torch.sqrt(gbc[j] + _EPS))
    return loss


class Glove(WordVectors):
    MAX_BLOCK_ROUNDS = 64

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None
            self._tok: TokenizerFactory = DefaultTokenizerFactory()

        def min_word_frequency(self, v): self._kw["min_word_frequency"] = v; return self
        def layer_size(self, v): self._kw["layer_size"] = v; return self
        def window_size(self, v): self._kw["window"] = v; return self
        def learning_rate(self, v): self._kw["learning_rate"] = v; return self
        def epochs(self, v): self._kw["epochs"] = v; return self
        def x_max(self, v): self._kw["x_max"] = v; return self
        def alpha(self, v): self._kw["alpha"] = v; return self
        def batch_size(self, v): self._kw["batch_size"] = v; return self
        def seed(self, v): self._kw["seed"] = v; return self
        def symmetric(self, v): self._kw["symmetric"] = v; return self
        def shuffle(self, v): self._kw["shuffle"] = v; return self
        def device(self, v): self._kw["device"] = v; return self

        def iterate(self, it):
            if isinstance(it, (list, tuple)):
                it = CollectionSentenceIterator(it)
            self._iter = it
            return self

        def tokenizer_factory(self, tf):
            self._tok = tf
            return self

        def build(self) -> "Glove":
            g = Glove(**self._kw)
            g._sentence_iter = self._iter
            g._tokenizer = self._tok
            return g

    @staticmethod
    def builder() -> "Glove.Builder":
        return Glove.Builder()

    def __init__(self, *, layer_size: int = 100, window: int = 15,
                 learning_rate: float = 0.05, epochs: int = 5,
                 x_max: float = 100.0, alpha: float = 0.75,
                 min_word_frequency: int = 5, batch_size: int = 8192,
                 seed: int = 42, symmetric: bool = True,
                 shuffle: bool = True, device=None):
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.x_max = x_max
        self.alpha = alpha
        self.min_word_frequency = min_word_frequency
        self.batch_size = batch_size
        self.seed = seed
        # accepted for configuration parity: both directions are always
        # counted, as in the JAX package
        self.symmetric = symmetric
        self.shuffle = shuffle
        self.device = resolve_device(device)
        self._sentence_iter: Optional[SentenceIterator] = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
        self.words_per_sec = 0.0
        self.last_loss = 0.0
        #: the first block's mean loss in the last fit
        self.first_loss = 0.0
        #: the last fit: seconds of host "cooccur" counting and device
        #: "train", the "rounds" and "blocks", the "nnz" triplets and the
        #: corpus "words" of all epochs
        self.last_fit_timing = {}
        #: device the tables were trained on in the last fit
        self.table_device: Optional[torch.device] = None
        super().__init__(VocabCache(), InMemoryLookupTable(0, layer_size))

    def set_sentence_iterator(self, it) -> None:
        if isinstance(it, (list, tuple)):
            it = CollectionSentenceIterator(it)
        self._sentence_iter = it

    def _token_stream(self):
        if self._sentence_iter is None:
            raise ValueError("no corpus: call iterate()/"
                             "set_sentence_iterator first")
        self._sentence_iter.reset()
        for sentence in self._sentence_iter:
            yield self._tokenizer.create(sentence).get_tokens()

    def build_vocab(self, token_seqs) -> None:
        self.vocab = VocabConstructor(self.min_word_frequency).build(
            token_seqs)
        self.lookup_table = InMemoryLookupTable(
            len(self.vocab), self.layer_size, seed=self.seed)

    def co_occurrences(self, corpus: List[np.ndarray]):
        """(rows, cols, counts): the weighted co-occurrences of the corpus,
        both (i, j) and (j, i) of every pair within the window, weighted
        1/distance, summed per (i, j) in float64 and returned as int32,
        int32, float32 in (i, j) order."""
        V = len(self.vocab)
        W = self.window
        offs = np.arange(1, W + 1)
        weights = 1.0 / offs
        CHUNK = 4096
        keys_parts, vals_parts = [], []
        for s0 in range(0, len(corpus), CHUNK):
            chunk = corpus[s0:s0 + CHUNK]
            kk, vv = [], []
            for ids in chunk:
                n = ids.size
                if n < 2:
                    continue
                for d, wgt in zip(offs, weights):
                    if d >= n:
                        break
                    a, b = ids[:-d].astype(np.int64), ids[d:].astype(np.int64)
                    kk.append(a * V + b)
                    vv.append(np.full(a.size, wgt, np.float64))
                    kk.append(b * V + a)
                    vv.append(np.full(a.size, wgt, np.float64))
            if not kk:
                continue
            keys = np.concatenate(kk)
            vals = np.concatenate(vv)
            uk, inv = np.unique(keys, return_inverse=True)
            sums = np.zeros(uk.size, np.float64)
            np.add.at(sums, inv, vals)
            keys_parts.append(uk)
            vals_parts.append(sums)
        if not keys_parts:
            return (np.empty(0, np.int32),) * 2 + (np.empty(0, np.float32),)
        keys = np.concatenate(keys_parts)
        vals = np.concatenate(vals_parts)
        uk, inv = np.unique(keys, return_inverse=True)
        sums = np.zeros(uk.size, np.float64)
        np.add.at(sums, inv, vals)
        return ((uk // V).astype(np.int32), (uk % V).astype(np.int32),
                sums.astype(np.float32))

    def _initial_tables(self, rng: np.random.Generator):
        """w, w~ ~ U(-0.5, 0.5) / D from ``rng`` (in that order), the biases
        0 and the AdaGrad accumulators 1e-8, all float32 numpy."""
        V, D = len(self.vocab), self.layer_size
        w = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        wc = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
        zeros = np.zeros(V, np.float32)
        return (w, wc, zeros, zeros.copy(),
                np.full((V, D), _EPS, np.float32),
                np.full((V, D), _EPS, np.float32),
                np.full(V, _EPS, np.float32), np.full(V, _EPS, np.float32))

    def _block(self, tables, i, j, logx, fw, pm) -> torch.Tensor:
        """``MAX_BLOCK_ROUNDS`` rounds, the block's columns [R, B]; returns
        the mean of the rounds' losses (0-dim device tensor)."""
        lr = float(self.learning_rate)
        losses = [glove_round(*tables, i[r], j[r], logx[r], fw[r], pm[r], lr)
                  for r in range(i.shape[0])]
        return torch.stack(losses).mean()

    def _encoded_corpus(self) -> List[np.ndarray]:
        """The corpus as int32 ids, words outside the vocabulary dropped,
        empty sentences skipped; the first call builds the vocabulary."""
        if len(self.vocab) == 0:
            self.build_vocab(self._token_stream())
            if len(self.vocab) == 0:
                raise ValueError("empty vocabulary after pruning")
        corpus = []
        for tokens in self._token_stream():
            ids = [self.vocab.index_of(t) for t in tokens]
            ids = np.asarray([i for i in ids if i >= 0], dtype=np.int32)
            if ids.size:
                corpus.append(ids)
        return corpus

    def _triplets(self, corpus: List[np.ndarray]):
        """(rows, cols, log X, f(X)) of the corpus's co-occurrences."""
        rows, cols, counts = self.co_occurrences(corpus)
        if rows.size == 0:
            raise ValueError("no co-occurrences — corpus too small")
        logx = np.log(np.maximum(counts, 1e-12)).astype(np.float32)
        fw = np.minimum(1.0, (counts / self.x_max) ** self.alpha) \
            .astype(np.float32)
        return rows, cols, logx, fw

    def _epoch_columns(self, trip, rng: np.random.Generator):
        """One epoch's columns [rounds, B] on the device (i, j, log X, f(X),
        pair mask) from the uploaded triplets ``trip``: the triplets in the
        order of ``rng.permutation`` (or as they are without ``shuffle``),
        padded to whole blocks with masked filler."""
        nnz, B = trip[0].shape[0], self.batch_size
        order = rng.permutation(nnz) if self.shuffle else np.arange(nnz)
        pad = (-nnz) % (B * self.MAX_BLOCK_ROUNDS)
        # np.resize cycles when the pad is longer than the triplets
        idx = np.concatenate([order, np.resize(order, pad)]) if pad else order
        pm = np.ones(idx.size, np.float32)
        pm[nnz:] = 0.0
        n_rounds = idx.size // B
        idx_d = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        return ([t[idx_d].view(n_rounds, B) for t in trip]
                + [torch.from_numpy(pm).to(self.device).view(n_rounds, B)])

    def fit(self) -> None:
        """Count the co-occurrences, then train ``epochs`` passes on the
        device. The first call builds the vocabulary."""
        corpus = self._encoded_corpus()
        total_words = sum(c.size for c in corpus)
        t0 = time.perf_counter()
        host_trip = self._triplets(corpus)
        t_count = time.perf_counter() - t0

        dev, R = self.device, self.MAX_BLOCK_ROUNDS
        rng = np.random.default_rng(self.seed)
        tables = tuple(torch.from_numpy(a).to(dev)
                       for a in self._initial_tables(rng))
        trip = [torch.from_numpy(a).to(dev) for a in host_trip]
        t1 = time.perf_counter()
        losses = []
        block = xprof.censused(self, "nlp/glove_block", self._block)
        for _ep in range(self.epochs):
            cols = self._epoch_columns(trip, rng)
            for r0 in range(0, cols[0].shape[0], R):
                losses.append(block(tables, *(c[r0:r0 + R] for c in cols)))
        vals = (torch.stack([losses[0]] + losses[-20:]).cpu().numpy()
                if losses else np.zeros(2, np.float32))
        w, wc, b, bc = (t.cpu().numpy() for t in tables[:4])
        t_train = time.perf_counter() - t1
        self.words_per_sec = (total_words * self.epochs
                              / max(t_count + t_train, 1e-9))
        self.first_loss = float(vals[0])
        self.last_loss = float(vals[1:].mean())
        self.last_fit_timing = {"cooccur": t_count, "train": t_train,
                                "rounds": len(losses) * R,
                                "blocks": len(losses),
                                "nnz": int(host_trip[0].size),
                                "words": total_words * self.epochs}
        self.table_device = tables[0].device
        # the reference's convention: the final vectors are w + w~
        self.lookup_table.syn0 = w + wc
        self._w, self._wc, self._bias, self._bias_c = w, wc, b, bc
