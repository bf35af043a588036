"""ParagraphVectors (doc2vec): PV-DBOW and PV-DM, trained on the device.

Counterpart of ``deeplearning4j_tpu/nlp/paragraph_vectors.py`` (the
reference's ``ParagraphVectors`` with its ``DBOW`` and ``DM`` sequence
algorithms), its device-windowed path. Labels live in the same vocabulary
and syn0 table as words (special tokens, exempt from frequency pruning):

- **PV-DBOW**: the document's label row is the input and every word of the
  document a target: the skip-gram round with the label as center
  (:meth:`ParagraphVectors._dbow_block`). One pair per stream position, so
  no compaction: a fixed ``MAX_BLOCK_ROUNDS`` rounds per block. The pairs
  run in a shuffled order (``pos_map``, valid positions first), as in the
  JAX package: rounds of consecutive positions would sum a document's
  updates into its label row at once. With ``train_word_vectors`` (the
  default), each pass also runs the skip-gram block over the same device
  corpus first (:meth:`SequenceVectors._sg_pass`).
- **PV-DM**: the CBOW round with the label id as one extra, always-on
  context column (:meth:`ParagraphVectors._dm_block`): W = 2 * window + 1
  columns through the ``embedding_bag`` kernel.

The corpus, its sentence ids and a per-position label stream are uploaded
once; subsampling compacts all three with one slot map on the device.
:meth:`ParagraphVectors.infer_vector` fits a vector for unseen text against
the frozen tables with ``torch.autograd``, its negatives drawn from
``np.random.default_rng(seed)`` as in the JAX package, so the two agree.

With ``device_corpus = False`` the documents go through the host pair path
(``SequenceVectors._train_encoded``) as a custom stream, document by
document in corpus order: PV-DM as CBOW windows with the label as the extra
column, PV-DBOW as (label, word) pairs for every kept word, followed by the
document's skip-gram pairs when ``train_word_vectors``.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..common import xprof
from ..ops import embeddings as E
from .text import DefaultTokenizerFactory, LabelAwareIterator, TokenizerFactory
from .vocab import huffman_arrays, subsample_keep_probs, unigram_table
from .word2vec import (SENT_PAD, SequenceVectors, _FitStats, _compact,
                       _derive_windows, _subsample_slots, interpolate_rates,
                       span_rates)


class ParagraphVectors(SequenceVectors):
    class Builder:
        def __init__(self) -> None:
            self._kw = {}
            self._iter: Optional[LabelAwareIterator] = None
            self._tok: TokenizerFactory = DefaultTokenizerFactory()

        def min_word_frequency(self, v): self._kw["min_word_frequency"] = v; return self
        def iterations(self, v): self._kw["iterations"] = v; return self
        def epochs(self, v): self._kw["epochs"] = v; return self
        def layer_size(self, v): self._kw["layer_size"] = v; return self
        def seed(self, v): self._kw["seed"] = v; return self
        def window_size(self, v): self._kw["window"] = v; return self
        def learning_rate(self, v): self._kw["learning_rate"] = v; return self
        def min_learning_rate(self, v): self._kw["min_learning_rate"] = v; return self
        def negative_sample(self, v): self._kw["negative"] = int(v); return self
        def sampling(self, v): self._kw["sampling"] = v; return self
        def batch_size(self, v): self._kw["batch_size"] = v; return self
        def device(self, v): self._kw["device"] = v; return self

        def sequence_learning_algorithm(self, name: str):
            self._kw["dm"] = ("dm" in name.lower()
                              and "dbow" not in name.lower())
            return self

        def dm(self, flag: bool):
            self._kw["dm"] = flag
            return self

        def train_word_vectors(self, flag: bool):
            self._kw["train_word_vectors"] = flag
            return self

        def iterate(self, it: LabelAwareIterator):
            self._iter = it
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tok = tf
            return self

        def build(self) -> "ParagraphVectors":
            pv = ParagraphVectors(**self._kw)
            pv._doc_iter = self._iter
            pv._tokenizer = self._tok
            return pv

    @staticmethod
    def builder() -> "ParagraphVectors.Builder":
        return ParagraphVectors.Builder()

    def __init__(self, dm: bool = False, train_word_vectors: bool = True,
                 **kw):
        self.dm = dm
        # the reference trains word vectors beside the document vectors by
        # default; in DBOW that is the interleaved skip-gram pass
        self.train_word_vectors = train_word_vectors
        kw.setdefault("algorithm", "cbow" if dm else "skipgram")
        super().__init__(**kw)
        self._doc_iter: Optional[LabelAwareIterator] = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()
        self._label_ids: List[int] = []
        self._pv_corpus_dev_cache = None

    # -- training ------------------------------------------------------------
    def fit(self) -> None:
        """Build the vocabulary (labels first) and fresh tables, then train
        on the device: from the device-resident corpus, or through the host
        pair path when ``device_corpus`` is False."""
        if self._doc_iter is None:
            raise ValueError("no corpus: call iterate() first")
        t0 = time.perf_counter()
        labels = self._doc_iter.labels
        docs_tokens = [self._tokenizer.create(s).get_tokens()
                       for s in self._doc_iter]
        self._special_tokens = labels
        self.build_vocab(iter(docs_tokens))
        self._label_ids = [self.vocab.index_of(lb) for lb in labels]
        # per document, so that a document emptied by pruning drops its
        # label with it
        corpus, doc_labels = [], []
        for lbl, toks in zip(self._label_ids, docs_tokens):
            ids = [self.vocab.index_of(t) for t in toks]
            ids = np.asarray([i for i in ids if i >= 0], dtype=np.int32)
            if ids.size:
                corpus.append(ids)
                doc_labels.append(lbl)
        total = sum(len(s) for s in corpus) * self.epochs * self.iterations
        self.last_fit_timing = {"prepare": time.perf_counter() - t0}
        if self.device_corpus and self.mesh is None:
            return self._train_windowed_pv(corpus, doc_labels, total)
        if self.mesh is not None:
            raise ValueError(
                "sharded tables (mesh=...) are implemented for the "
                "Word2Vec windowed paths only — ParagraphVectors would "
                "silently train unsharded")
        self._train_encoded(corpus, stream_factory=self._host_stream(
            corpus, doc_labels), total_words=total)

    def _host_stream(self, corpus: List[np.ndarray], doc_labels: List[int]):
        """The host stream of the documents (see the module docstring), a
        function of (rng, keep) yielding (document words, *examples)."""
        def stream(rng, keep):
            for lbl, ids in zip(doc_labels, corpus):
                if self.dm:
                    wins = self._sentence_windows(ids, rng, keep)
                    if wins is None:
                        continue
                    c, ctx, cmask = wins
                    ctx = np.concatenate(
                        [ctx, np.full((c.size, 1), lbl, dtype=np.int32)],
                        axis=1)
                    cmask = np.concatenate(
                        [cmask, np.ones((c.size, 1), np.float32)], axis=1)
                    yield ids.size, c, ctx, cmask
                    continue
                kept = (ids[rng.random(ids.size) < keep[ids]]
                        if self.sampling > 0 else ids)
                if kept.size == 0:
                    continue
                centers = np.full(kept.size, lbl, dtype=np.int32)
                if self.train_word_vectors:
                    pairs = self._sentence_pairs(ids, rng, keep)
                    if pairs is not None:
                        centers = np.concatenate([centers, pairs[0]])
                        kept = np.concatenate([kept, pairs[1]])
                yield ids.size, centers, kept
        return stream

    @property
    def _dbow_pairs(self) -> int:
        """Pairs per DBOW round: ``batch_size`` under the same caps as
        ``_round_pairs`` (8 V, and ``HS_MAX_ROUND`` under hierarchical
        softmax), at least 2."""
        cap = min(self.batch_size, 8 * max(len(self.vocab), 1))
        if self.use_hs:
            cap = min(cap, self.HS_MAX_ROUND)
        return max(2, cap)

    def _pv_device_corpus(self, corpus: List[np.ndarray],
                          doc_labels: List[int], span: int):
        """The corpus as three int32 device buffers, ids, sentence ids
        (modulo 65535) and each position's label id, laid out ``[W pads]
        [stream][pads]`` and padded to a multiple of ``CORPUS_BUCKET`` plus
        one span; uploaded once per distinct corpus."""
        W = self.window
        flat = np.concatenate(corpus).astype(np.int32)
        lens = np.array([c.size for c in corpus], dtype=np.int64)
        labs_full = np.repeat(np.asarray(doc_labels, np.int32), lens)
        npad = -(-flat.size // self.CORPUS_BUCKET) * self.CORPUS_BUCKET
        buf_len = npad + span + 2 * W
        key = (flat.size, hash(flat.tobytes()), hash(labs_full.tobytes()),
               buf_len, str(self.device))
        if (self._pv_corpus_dev_cache is None
                or self._pv_corpus_dev_cache[0] != key):
            ids = np.zeros(buf_len, np.int32)
            ids[W:W + flat.size] = flat
            sent = np.full(buf_len, SENT_PAD, np.int32)
            sent[W:W + flat.size] = np.repeat(
                np.arange(len(corpus), dtype=np.int64), lens) % SENT_PAD
            labs = np.zeros(buf_len, np.int32)
            labs[W:W + flat.size] = labs_full
            self._pv_corpus_dev_cache = (key, tuple(
                torch.from_numpy(a).to(self.device)
                for a in (ids, sent, labs)))
        return flat, npad, self._pv_corpus_dev_cache[1]

    def _dbow_block(self, syn0: torch.Tensor, syn1: torch.Tensor,
                    ids: torch.Tensor, labs: torch.Tensor,
                    pos_map: torch.Tensor, n_valid, negpool, p0: int,
                    lrs: torch.Tensor, blk_id: int):
        """``MAX_BLOCK_ROUNDS`` DBOW rounds of ``_dbow_pairs`` pairs: the
        positions ``pos_map[p0:p0 + S]``, each a (label, word) pair, those
        from ``n_valid`` on masked out. Updates in place; returns the
        pair-weighted mean loss and the pairs trained (0-dim tensors)."""
        B, R = self._dbow_pairs, self.MAX_BLOCK_ROUNDS
        S = B * R
        pos = pos_map[p0:p0 + S] + self.window
        idw, labw = ids[pos], labs[pos]
        pm_all = ((p0 + torch.arange(S, device=ids.device)) < n_valid).to(
            torch.float32)
        lab, hs = self._round_inputs(B)
        losses = []
        for r in range(R):
            sl = slice(r * B, (r + 1) * B)
            losses.append(self._sg_round(syn0, syn1, labw[sl], idw[sl], lab,
                                         hs, negpool, lrs[r], pm_all[sl],
                                         blk_id, r))
        return self._block_result(losses, pm_all.view(R, B).sum(dim=1))

    def _dm_block(self, syn0: torch.Tensor, syn1: torch.Tensor,
                  ids: torch.Tensor, sent: torch.Tensor, labs: torch.Tensor,
                  n_valid, negpool, p0: int, lrs: torch.Tensor,
                  b: torch.Tensor, blk_id: int):
        """``MAX_BLOCK_ROUNDS`` PV-DM rounds: CBOW's windows
        (:func:`_derive_windows`, reduced windows ``b``) with the position's
        label as one more, always-on context column; an empty window still
        trains (the mean is the label row alone). Updates in place; returns
        the pair-weighted mean loss and the examples trained."""
        W, B_C, R = self.window, self._cbow_centers, self.MAX_BLOCK_ROUNDS
        S = B_C * R
        c_ids, ctx_all, valid, live = _derive_windows(ids, sent, n_valid, p0,
                                                      S, W, b)
        ctx_all = torch.cat([ctx_all, labs[p0 + W:p0 + W + S, None]], dim=1)
        cm_all = torch.cat([valid.to(torch.float32),
                            torch.ones((S, 1), device=ids.device)], dim=1)
        pm_all = live.to(torch.float32)
        losses = self._cbow_rounds(syn0, syn1, c_ids, ctx_all, cm_all, pm_all,
                                   negpool, lrs, blk_id)
        return self._block_result(losses, pm_all.view(R, B_C).sum(dim=1))

    def _train_windowed_pv(self, corpus: List[np.ndarray],
                           doc_labels: List[int], total_words: int) -> None:
        """The word2vec device-windowed fit with a per-position label
        stream: per epoch, subsampling (ids, sentence ids and labels
        compacted with one slot map) and, for DBOW, a fresh pair order;
        per pass, DBOW's skip-gram word pass (``train_word_vectors``), then
        the DBOW or DM blocks."""
        raw_words = sum(len(s) for s in corpus)
        if raw_words == 0:
            return
        dev = self.device
        keep = subsample_keep_probs(self.vocab, self.sampling)
        W, R = self.window, self.MAX_BLOCK_ROUNDS
        is_dm = self.dm
        pv_span = (self._cbow_centers if is_dm else self._dbow_pairs) * R
        word_pass = not is_dm and self.train_word_vectors
        sg_span = self._window_span if word_pass else pv_span
        syn0, syn1 = self._tables_to_device()
        negpool = None
        if not self.use_hs:
            negpool = self._negpool(self._cbow_centers if is_dm
                                    else self._dbow_pairs)
            if word_pass:
                self._negpool(self._round_pairs)        # its own check
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        stats = _FitStats()
        n_blocks = words_seen = 0
        t0 = time.perf_counter()

        flat, npad, (ids_full, sent_full, labs_full) = \
            self._pv_device_corpus(corpus, doc_labels, max(pv_span, sg_span))
        n_raw = flat.size
        if self.sampling > 0:
            keep_dev = torch.from_numpy(keep.astype(np.float32)).to(dev)
        n_exp, n_loop = self._expected_stream(flat, keep)
        rates = (self.learning_rate, self.min_learning_rate)
        for _epoch in range(self.epochs):
            if self.sampling > 0:
                u = torch.rand(ids_full.shape[0], generator=gen, device=dev)
                slot, n_valid = xprof.censused(
                    self, "nlp/pv_subsample", _subsample_slots)(
                    ids_full, keep_dev, n_raw, u, W)
                ids_dev, sent_dev, labs_dev = (
                    _compact(ids_full, slot, 0),
                    _compact(sent_full, slot, SENT_PAD),
                    _compact(labs_full, slot, 0))
            else:
                ids_dev, sent_dev, labs_dev = ids_full, sent_full, labs_full
                n_valid = n_raw
            pos_map = None
            if not is_dm:
                u = torch.rand(npad + pv_span, generator=gen, device=dev)
                pos_map = xprof.censused(self, "nlp/pv_pos_map",
                                         _pos_map)(n_valid, u)
            for _it in range(self.iterations):
                def ends(p0, span, seen=words_seen):
                    return span_rates(*rates, seen, p0, span, n_loop, n_exp,
                                      raw_words, total_words)

                if word_pass:
                    starts = list(range(0, n_loop, sg_span))
                    self._sg_pass(syn0, syn1, ids_dev, sent_dev, n_valid,
                                  negpool, gen,
                                  [(p0, *ends(p0, sg_span), n_blocks + i)
                                   for i, p0 in enumerate(starts)], stats)
                    n_blocks += len(starts)
                for p0 in range(0, n_loop, pv_span):
                    lrs = torch.from_numpy(interpolate_rates(
                        np.asarray([ends(p0, pv_span)], np.float32),
                        R)[0]).to(dev)
                    if is_dm:
                        b = torch.randint(1, W + 1, (pv_span,),
                                          generator=gen, device=dev)
                        stats.add(*xprof.censused(
                            self, "nlp/pv_dm_block", self._dm_block)(
                            syn0, syn1, ids_dev, sent_dev, labs_dev, n_valid,
                            negpool, p0, lrs, b, n_blocks))
                    else:
                        stats.add(*xprof.censused(
                            self, "nlp/pv_dbow_block", self._dbow_block)(
                            syn0, syn1, ids_dev, labs_dev, pos_map, n_valid,
                            negpool, p0, lrs, n_blocks))
                    n_blocks += 1
                words_seen += raw_words
        self._finish_fit(stats, words_seen, t0, n_blocks, syn0, syn1)

    # -- queries -------------------------------------------------------------
    def get_paragraph_vector(self, label: str) -> np.ndarray:
        return self.get_word_vector(label)

    def nearest_labels(self, vec_or_label, top_n: int = 5) -> List[str]:
        vec = (self.get_word_vector(vec_or_label)
               if isinstance(vec_or_label, str)
               else np.asarray(vec_or_label, np.float32))
        labels = set(self._label_ids)
        w = self.lookup_table.normalized()
        v = vec / max(np.linalg.norm(vec), 1e-12)
        sims = w @ v
        order = [i for i in np.argsort(-sims) if int(i) in labels]
        return [self.vocab.word_for(int(i)) for i in order[:top_n]]

    def infer_vector(self, text: str, steps: int = 50,
                     learning_rate: float = 0.025) -> np.ndarray:
        """A vector for unseen text, fitted against the frozen tables by
        ``steps`` gradient steps (``torch.autograd``) at a learning rate
        decaying linearly from ``learning_rate``: the text's words as
        targets of the vector (DBOW), or of the mean of the vector and the
        words' syn0 mean (DM), against negatives from the unigram^0.75 CDF
        drawn with ``np.random.default_rng(seed)``, or along their Huffman
        paths."""
        tokens = self._tokenizer.create(text).get_tokens()
        ids = np.asarray([i for i in (self.vocab.index_of(t) for t in tokens)
                          if i >= 0], dtype=np.int32)
        d = self.layer_size
        rng = np.random.default_rng(self.seed)
        vec = ((rng.random(d) - 0.5) / d).astype(np.float32)
        if ids.size == 0:
            return vec
        dev = self.device
        syn1 = torch.from_numpy(np.array(
            self.lookup_table.syn1 if self.use_hs
            else self.lookup_table.syn1neg, np.float32)).to(dev)
        syn0 = torch.from_numpy(np.array(self.lookup_table.syn0,
                                         np.float32)).to(dev)

        def step(v, loss_fn, lr, *args):
            v = v.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(loss_fn(v, *args), v)
            return (v - lr * g).detach()

        v = torch.from_numpy(vec).to(dev)
        if self.use_hs:
            codes, points, mask = huffman_arrays(self.vocab)
            u = syn1[torch.from_numpy(points[ids]).to(dev)]     # [N, L, D]
            m = torch.from_numpy(mask[ids]).to(dev)
            labels = (1.0 - torch.from_numpy(codes[ids]).to(dev).to(
                v.dtype)) * m

            def hs_loss(v):
                sig = torch.sigmoid(torch.einsum("d,nld->nl", v, u))
                xe = -(labels * torch.log(sig + E._EPS)
                       + (1 - labels) * torch.log(1 - sig + E._EPS)) * m
                return xe.sum() / m.sum().clamp_min(1.0)

            for s in range(steps):
                v = step(v, hs_loss, learning_rate * (1 - s / steps))
            return v.cpu().numpy()

        cdf = unigram_table(self.vocab)
        V, K = len(self.vocab), max(self.negative, 1)
        ctxmean = syn0[torch.from_numpy(ids).to(dev)].mean(dim=0)

        def ns_loss(v, tgt, lab):
            h = (v + ctxmean) / 2.0 if self.dm else v
            sig = torch.sigmoid(torch.einsum("d,nkd->nk", h, syn1[tgt]))
            xe = -(lab * torch.log(sig + E._EPS)
                   + (1 - lab) * torch.log(1 - sig + E._EPS))
            return xe.mean()

        for s in range(steps):
            tgt, lab = self._neg_targets(ids, rng, cdf, V, K)
            v = step(v, ns_loss, learning_rate * (1 - s / steps),
                     torch.from_numpy(tgt).to(dev),
                     torch.from_numpy(lab).to(dev))
        return v.cpu().numpy()


def _pos_map(n_valid, u: torch.Tensor) -> torch.Tensor:
    """DBOW's pair order for one epoch: a permutation of ``[0, len(u))``
    with the ``n_valid`` live stream positions first, in the random order
    of their uniforms ``u``, then the rest in order (int32)."""
    iota = torch.arange(u.shape[0], device=u.device)
    rank = torch.where(iota < n_valid, u, 2.0 + iota.to(torch.float32))
    return torch.argsort(rank, stable=True).to(torch.int32)

