"""FastText: word vectors enriched with subwords, trained on the device.

Counterpart of ``deeplearning4j_tpu/nlp/fasttext.py`` (Bojanowski et al.'s
skip-gram with subwords, where the reference wraps the fastText binary):

- every vocabulary word stands for itself and its character n-grams
  (``minn``..``maxn`` over ``<word>``), the n-grams hashed with fastText's
  FNV-1a into ``bucket`` rows above the vocabulary's; syn0 and syn1neg both
  have V + bucket rows;
- a center word's input vector is the mean of its subword rows, and the
  gradient spreads back over them: the shape of the CBOW round
  (``ops.embeddings.cbow``), whose window is the center's subword rows
  ([V, G] ids and mask, G the longest word's count) and whose center is the
  context word. So every round launches the ``embedding_bag`` kernel on a
  [B, G] bag of the [V + bucket, D] table;
- a word outside the vocabulary gets the mean of its n-gram rows.

The device path is the skip-gram windowed fit of
:class:`~.word2vec.SequenceVectors`, its pairs packed on the device, with
one override: :meth:`FastText._sg_round`, where a round's (center, context)
pairs become an update. The host path (``device_corpus = False``, or
hierarchical softmax, as in the JAX package) streams the skip-gram pairs'
subword windows through the host pair path's CBOW blocks.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..ops import embeddings as E
from .lookup_table import InMemoryLookupTable
from .text import CollectionSentenceIterator, DefaultTokenizerFactory
from .vocab import VocabConstructor
from .word2vec import SequenceVectors, _pool_negs


def fasttext_hash(ngram: str) -> int:
    """fastText's FNV-1a over the utf-8 bytes (``Dictionary::hash``), in
    32 bits."""
    h = 2166136261
    for byte in ngram.encode("utf-8"):
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def char_ngrams(word: str, minn: int, maxn: int) -> List[str]:
    """The character n-grams of ``<word>``, n from ``minn`` to ``maxn``,
    shortest first."""
    w = f"<{word}>"
    out = []
    for n in range(minn, maxn + 1):
        if n > len(w):
            break
        for i in range(len(w) - n + 1):
            out.append(w[i:i + n])
    return out


class FastText(SequenceVectors):
    class Builder:
        def __init__(self):
            self._kw = {}
            self._iter = None

        def min_word_frequency(self, v): self._kw["min_word_frequency"] = v; return self
        def layer_size(self, v): self._kw["layer_size"] = v; return self
        def window_size(self, v): self._kw["window"] = v; return self
        def learning_rate(self, v): self._kw["learning_rate"] = v; return self
        def negative_sample(self, v): self._kw["negative"] = int(v); return self
        def epochs(self, v): self._kw["epochs"] = v; return self
        def batch_size(self, v): self._kw["batch_size"] = v; return self
        def seed(self, v): self._kw["seed"] = v; return self
        def bucket(self, v): self._kw["bucket"] = v; return self
        def minn(self, v): self._kw["minn"] = v; return self
        def maxn(self, v): self._kw["maxn"] = v; return self
        def device(self, v): self._kw["device"] = v; return self

        def iterate(self, it):
            self._iter = it
            return self

        def build(self) -> "FastText":
            ft = FastText(**self._kw)
            if self._iter is not None:
                ft.set_sentence_iterator(self._iter)
            return ft

    @staticmethod
    def builder() -> "FastText.Builder":
        return FastText.Builder()

    def __init__(self, *, bucket: int = 100_000, minn: int = 3,
                 maxn: int = 6, **kw):
        kw.setdefault("algorithm", "cbow")   # the host path's CBOW blocks
        super().__init__(**kw)
        self.bucket = bucket
        self.minn = minn
        self.maxn = maxn
        self._sentence_iter = None
        self._subword_ids: Optional[np.ndarray] = None   # [V, G] padded
        self._subword_mask: Optional[np.ndarray] = None  # [V, G]
        self._subword_dev = None

    def set_sentence_iterator(self, it) -> None:
        if isinstance(it, (list, tuple)):
            it = CollectionSentenceIterator(it)
        self._sentence_iter = it

    def _token_stream(self):
        if self._sentence_iter is None:
            raise ValueError("no corpus: call iterate()/"
                             "set_sentence_iterator first")
        self._sentence_iter.reset()
        tok = DefaultTokenizerFactory()
        for sentence in self._sentence_iter:
            yield tok.create(sentence).get_tokens()

    def subword_row_ids(self, word: str, in_vocab_index: int = -1
                        ) -> List[int]:
        """The table rows of a word: its own (when in the vocabulary), then
        its n-grams' hashed rows above the vocabulary's."""
        V = len(self.vocab)
        ids = [in_vocab_index] if in_vocab_index >= 0 else []
        for g in char_ngrams(word, self.minn, self.maxn):
            ids.append(V + fasttext_hash(g) % self.bucket)
        return ids

    def build_vocab(self, token_seqs) -> None:
        self.vocab = VocabConstructor(self.min_word_frequency).build(
            token_seqs)
        self.lookup_table = InMemoryLookupTable(
            len(self.vocab) + self.bucket, self.layer_size, seed=self.seed)
        self.lookup_table.reset_weights(False, True)
        self.build_subwords()

    def build_subwords(self) -> None:
        """The [V, G] subword row ids of the vocabulary's words, zero-padded,
        and their 0/1 mask."""
        V = len(self.vocab)
        sub = [self.subword_row_ids(w, i)
               for i, w in enumerate(self.vocab.words())]
        G = max(len(s) for s in sub) if sub else 1
        self._subword_ids = np.zeros((V, G), np.int32)
        self._subword_mask = np.zeros((V, G), np.float32)
        for i, s in enumerate(sub):
            self._subword_ids[i, :len(s)] = s
            self._subword_mask[i, :len(s)] = 1.0
        self._subword_dev = None

    def _subwords_on_device(self):
        if self._subword_dev is None:
            self._subword_dev = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (self._subword_ids, self._subword_mask))
        return self._subword_dev

    # -- the device path -----------------------------------------------------
    def _sg_round(self, syn0, syn1, c, x, lab, hs, negpool, lr, pm,
                  blk_id: int, r: int) -> torch.Tensor:
        """One FastText round of the packed pairs: the CBOW round with the
        centers' subword rows as the window and the contexts as targets,
        against negatives from the pool (the JAX FastText block's body)."""
        if hs is not None:
            raise ValueError("FastText trains with negative sampling only")
        sub_ids, sub_mask = self._subwords_on_device()
        negs = _pool_negs(negpool, blk_id, r, c.shape[0], self.negative,
                          len(self.vocab), x)
        tgt = torch.cat([x[:, None], negs], dim=1)
        return E.cbow(syn0, syn1, sub_ids[c], sub_mask[c], tgt, lab, lr, pm)

    def fit(self) -> None:
        """Train: the device-windowed skip-gram loop with FastText's rounds,
        or the host stream under ``device_corpus = False`` or hierarchical
        softmax. The first call builds the vocabulary and the tables; a
        later one resumes from them."""
        t0 = time.perf_counter()
        if len(self.vocab) == 0 or self.lookup_table.syn0 is None:
            self.build_vocab(self._token_stream())
            if len(self.vocab) == 0:
                raise ValueError("empty vocabulary after pruning")
        corpus = self._encode_corpus(self._token_stream())
        self.last_fit_timing = {"prepare": time.perf_counter() - t0}
        if self.device_corpus and not self.use_hs:
            # the skip-gram sizing and branch of the windowed loop drive
            # _sg_round above; "cbow" stays the host path's stream format
            old = self.algorithm
            self.algorithm = "skipgram"
            try:
                return self._train_windowed(corpus)
            finally:
                self.algorithm = old
        sub_ids, sub_mask = self._subword_ids, self._subword_mask

        def stream(rng, keep):
            # skip-gram pairs: the round's window is the center's subword
            # set, its center the context word
            for ids in corpus:
                pairs = self._sentence_pairs(ids, rng, keep)
                if pairs is None:
                    continue
                centers, contexts = pairs
                yield ids.size, contexts, sub_ids[centers], sub_mask[centers]

        self._train_encoded(corpus, stream_factory=stream)

    # -- queries (subword means) ---------------------------------------------
    def get_word_vector(self, word: str) -> np.ndarray:
        """The mean of the word's rows: its own and its n-grams' in the
        vocabulary, its n-grams' alone outside it."""
        idx = self.vocab.index_of(word)
        rows = self.subword_row_ids(word, idx)
        if not rows:
            raise KeyError(f"cannot build a vector for {word!r}")
        syn0 = np.asarray(self.lookup_table.syn0)
        return syn0[np.asarray(rows, np.int64)].mean(axis=0)

    def get_word_vector_matrix(self) -> np.ndarray:
        """The [V, D] matrix of the vocabulary's subword means (what the
        serializer writes)."""
        syn0 = np.asarray(self.lookup_table.syn0)
        num = (syn0[self._subword_ids.reshape(-1)]
               .reshape(*self._subword_ids.shape, -1)
               * self._subword_mask[..., None]).sum(axis=1)
        return num / np.maximum(self._subword_mask.sum(axis=1), 1.0)[:, None]

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = {self.vocab.index_of(word_or_vec)}
        else:
            vec = np.asarray(word_or_vec, np.float32)
            exclude = set()
        mat = self.get_word_vector_matrix()
        mat = mat / np.maximum(np.linalg.norm(mat, axis=1, keepdims=True),
                               1e-12)
        v = vec / max(np.linalg.norm(vec), 1e-12)
        order = np.argsort(-(mat @ v))
        out = []
        for idx in order:
            if int(idx) in exclude:
                continue
            out.append(self.vocab.word_for(int(idx)))
            if len(out) == top_n:
                break
        return out
