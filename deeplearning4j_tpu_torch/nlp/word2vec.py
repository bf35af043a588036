"""Word2Vec, skip-gram and CBOW, with negative sampling or hierarchical
softmax, trained on the device.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (the reference's
``SequenceVectors`` engine and ``Word2Vec`` front): its device-windowed
paths. The statistical procedure is the JAX package's: count-pruned
vocabulary, frequent-word subsampling with stream compaction on the device,
a reduced window b ~ U[1, W] per position, negatives from a pre-drawn pool
of the unigram^0.75 table walked at a prime stride or the words' Huffman
paths, the exact gradient of CBOW's mean-forward loss, and a learning rate
that decays linearly with corpus words consumed.

One fit:

1. the vocabulary and tables (host, numpy; the Huffman tree for
   hierarchical softmax), the encoded corpus;
2. the corpus uploaded once into a padded device buffer (ids and sentence
   ids, ``[W pads][stream][pads]``), the negative pool drawn on the device
   (or the Huffman ``points``/``codes``/``mask`` tables uploaded), both
   once per vocabulary;
3. per epoch, subsampling and compaction on the device
   (:func:`_subsample`: cumsum plus a scatter into a fixed buffer; the kept
   count stays on the device);
4. blocks, each the counterpart of one jitted JAX block:

   - CBOW (:meth:`SequenceVectors._cbow_block`): ``MAX_BLOCK_ROUNDS`` = 64
     rounds over ``_cbow_centers * 64`` positions, each round one
     :func:`ops.embeddings.cbow` (or ``cbow_hs``), so one ``embedding_bag``
     kernel launch. The learning rates of every round of the fit are
     computed on the host up front and uploaded once; nothing waits for the
     device.
   - skip-gram (:meth:`SequenceVectors._sg_pack` and ``_sg_block``): the
     span's (center, context) pairs are derived and compacted densely into
     a buffer of capacity C (:func:`_pack_span`), then ``ceil(count / B)``
     rounds of B pairs train, each one :func:`ops.embeddings.skipgram` (or
     ``skipgram_hs``). The JAX block runs a ``lax.while_loop`` to that
     count, which exists only on the device; here the count comes to the
     host through a non-blocking copy into pinned memory and an event, one
     per block, and the next block's span is packed before this block's
     rounds are enqueued, so by the time the host reads a count the card
     has long computed it: the host never waits for the rounds. Each
     round's learning rate is then computed on the host in float32 in the
     JAX package's order of operations, ``lr0 + (lr1 - lr0) * (r*B) /
     max(count, 1)``, and uploaded once per block;
5. one readback at the end (the timed window for ``words_per_sec`` runs from
   before the corpus upload to that readback, as in the JAX package).

``table_dtype="bfloat16"`` keeps the tables on the device in bf16 (CBOW's
window mean then runs the bf16 route of the ``embedding_bag`` kernel); they
are cast back to float32 into the lookup table after the fit.

Random draws are arguments of the math (:func:`_derive_windows` and
:func:`_pack_span` take the reduced windows ``b``, :func:`_subsample` the
uniforms, :func:`negpool_from_bits` the bits), drawn from
``torch.Generator``s on the device seeded from ``seed``. They cannot match
JAX's threefry draws; the tests hand the JAX package's draws to these
functions instead.

**The host pair path** (``device_corpus = False``, and every custom stream:
ParagraphVectors' and FastText's host streams), :meth:`SequenceVectors.
_train_encoded`. A producer thread (:func:`common.background.prefetch_iter`)
makes the pairs on the host (skip-gram: :func:`native.sg_pairs`, the C++
helper, seeded from ``np.random.default_rng(seed)`` as in the JAX package, so
the pairs match it bit for bit; CBOW: :meth:`SequenceVectors.
_sentence_windows` in numpy), buffers them into flushes of whole blocks of
``MAX_BLOCK_ROUNDS`` rounds of ``batch_size`` examples (ids as uint16 when the
table has at most 2^16 rows, else int32), computes each flush's learning rate
from the corpus words it has consumed, and stages each block's columns to the
device from pinned memory. The consumer (:meth:`SequenceVectors.
_host_block`) draws the block's negatives on the device (:func:`
bulk_targets`) and runs its rounds: skip-gram or CBOW (one ``embedding_bag``
launch per round), negative sampling or hierarchical softmax.

Not ported here, and refused with an error rather than substituted: sharded
tables (``mesh=``). ROADMAP.md lists them.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..common.background import prefetch_iter
from ..common.environment import resolve_device
from ..common.profiler import OpProfiler
from ..ops import embeddings as E
from .lookup_table import InMemoryLookupTable
from .text import (CollectionSentenceIterator, DefaultTokenizerFactory,
                   SentenceIterator, TokenizerFactory)
from .vocab import (VocabCache, VocabConstructor, build_huffman,
                    huffman_arrays, subsample_keep_probs, unigram_int_table)

#: sentence id of the pad slots; real ids travel modulo 65535, which keeps
#: the boundary check exact (it compares positions at most W < 65535 apart)
SENT_PAD = 65535
_U32 = 0xFFFFFFFF


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet: this port "
        f"trains on one device from the device-resident corpus (see "
        f"ROADMAP.md, 'Modules to port')")


class WordVectors:
    """Query surface over a vocabulary and its syn0 table (numpy on the
    host): ``get_word_vector``, ``similarity``, ``words_nearest``,
    ``accuracy``."""

    def __init__(self, vocab: VocabCache, table: InMemoryLookupTable):
        self.vocab = vocab
        self.lookup_table = table

    def has_word(self, word: str) -> bool:
        return word in self.vocab

    def get_word_vector(self, word: str) -> np.ndarray:
        idx = self.vocab.index_of(word)
        if idx < 0:
            raise KeyError(f"word not in vocab: {word!r}")
        return self.lookup_table.vector(idx)

    def get_word_vector_matrix(self) -> np.ndarray:
        return np.asarray(self.lookup_table.syn0)

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.get_word_vector(w1), self.get_word_vector(w2)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        if isinstance(word_or_vec, str):
            vec = self.get_word_vector(word_or_vec)
            exclude = {self.vocab.index_of(word_or_vec)}
        else:
            vec = np.asarray(word_or_vec, dtype=np.float32)
            exclude = set()
        w = self.lookup_table.normalized()
        v = vec / max(np.linalg.norm(vec), 1e-12)
        sims = w @ v
        order = np.argsort(-sims)
        out = []
        for idx in order:
            if int(idx) in exclude:
                continue
            out.append(self.vocab.word_for(int(idx)))
            if len(out) == top_n:
                break
        return out

    def accuracy(self, questions: Sequence[Sequence[str]]) -> float:
        """Analogy accuracy: each question (a, b, c, expected) tests
        b - a + c ~ expected."""
        correct = total = 0
        for a, b, c, expected in questions:
            if not all(self.has_word(w) for w in (a, b, c, expected)):
                continue
            total += 1
            vec = (self.get_word_vector(b) - self.get_word_vector(a)
                   + self.get_word_vector(c))
            nearest = self.words_nearest(vec, top_n=4)
            preds = [w for w in nearest if w not in (a, b, c)]
            if preds and preds[0] == expected:
                correct += 1
        return correct / total if total else 0.0


class SequenceVectors(WordVectors):
    """The training engine behind :class:`Word2Vec` and
    :class:`~.paragraph_vectors.ParagraphVectors`."""

    #: training rounds per CBOW block (the JAX package's scan length), and
    #: the skip-gram block's expected rounds
    MAX_BLOCK_ROUNDS = 64
    #: the corpus buffer is padded to a multiple of this
    CORPUS_BUCKET = 1 << 16
    #: entries of the pre-drawn negative pool (int32, 32 MB)
    NEG_POOL_SIZE = 1 << 23
    #: hierarchical softmax's cap on a round: every pair's path reaches the
    #: Huffman root, so one round sums that many updates into its row (the
    #: JAX package's stability cap; larger rounds reach NaN there)
    HS_MAX_ROUND = 128

    def __init__(self, *, layer_size: int = 100, window: int = 5,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 negative: int = 5, use_hierarchic_softmax: bool = False,
                 sampling: float = 0.0, min_word_frequency: int = 5,
                 iterations: int = 1, epochs: int = 1, batch_size: int = 512,
                 seed: int = 42, algorithm: str = "skipgram",
                 workers: int = 1, table_dtype: str = "float32",
                 mesh=None, table_sharding_axis: str = "model",
                 special_tokens: Sequence[str] = (), device=None):
        if use_hierarchic_softmax:
            # one output path per fit, as in the JAX package: the
            # constructor's default of 5 negatives turns into 0, any other
            # positive count is refused rather than dropped
            if negative == 5:
                negative = 0
            elif negative > 0:
                raise ValueError(
                    "combined hierarchical-softmax + negative-sampling "
                    "training is not implemented; set negative=0 with "
                    "use_hierarchic_softmax=True (or disable HS)")
        elif negative <= 0:
            raise ValueError("need negative sampling (negative>0) or "
                             "use_hierarchic_softmax=True")
        self.algorithm = algorithm.lower()
        if self.algorithm not in ("skipgram", "cbow"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"table_dtype must be float32|bfloat16, "
                             f"got {table_dtype!r}")
        if mesh is not None:
            raise _not_ported("sharded tables (mesh=...)")
        if not 0 < window < SENT_PAD:
            raise ValueError(f"window must be in [1, {SENT_PAD - 1}], got "
                             f"{window}")
        self.layer_size = layer_size
        self.window = window
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.negative = negative
        self.use_hs = use_hierarchic_softmax
        self.sampling = sampling
        self.min_word_frequency = min_word_frequency
        self.iterations = iterations
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        # accepted for configuration parity; the rounds are batched on the
        # device, not spread over host threads
        self.workers = workers
        self.table_dtype = table_dtype
        self._special_tokens = list(special_tokens)
        #: False trains through the host pair path (``_train_encoded``), as
        #: in the JAX package
        self.device_corpus = True
        self.device = resolve_device(device)
        self.words_per_sec: float = 0.0
        self.pairs_per_sec: float = 0.0
        self.last_loss: float = 0.0
        #: the first block's mean loss in the last fit
        self.first_loss: float = 0.0
        #: device the tables were trained on in the last fit
        self.table_device: Optional[torch.device] = None
        #: the last fit: seconds of "prepare" (tokenizing, counting,
        #: encoding; host) and "train" (the words_per_sec window), its
        #: "blocks", the skip-gram counts read back ("readbacks") and the
        #: host's seconds waiting for them ("readback_wait"); on the host
        #: pair path also the consumer's seconds waiting for the producer
        #: ("producer_wait")
        self.last_fit_timing = {}
        self._corpus_dev_cache = None
        self._ntable_cache = None
        self._negpool_cache = None
        self._hs_cache = None
        super().__init__(VocabCache(), InMemoryLookupTable(0, layer_size))

    # -- corpus --------------------------------------------------------------
    def _encode_corpus(self, token_seqs: Iterable[List[str]]) -> List[np.ndarray]:
        enc = []
        for tokens in token_seqs:
            ids = [self.vocab.index_of(t) for t in tokens]
            ids = np.asarray([i for i in ids if i >= 0], dtype=np.int32)
            if ids.size:
                enc.append(ids)
        return enc

    def build_vocab(self, token_seqs: Iterable[List[str]]) -> None:
        self.vocab = VocabConstructor(
            self.min_word_frequency,
            special_tokens=self._special_tokens).build(token_seqs)
        if self.use_hs:
            build_huffman(self.vocab)
        self.lookup_table = InMemoryLookupTable(
            len(self.vocab), self.layer_size, seed=self.seed)
        self.lookup_table.reset_weights(self.use_hs, self.negative > 0)

    # -- round sizes ---------------------------------------------------------
    @property
    def _window_centers(self) -> int:
        """Centers per skip-gram round, sized so that one round trains about
        ``batch_size`` (center, context) slots."""
        return max(1, self.batch_size // (2 * self.window))

    @property
    def _round_pairs(self) -> int:
        """Dense pairs per skip-gram round: ``_window_centers * 2W``, capped
        at 8 V (the scatter-add sums colliding updates, and a tiny
        vocabulary with a big round diverges) and, under hierarchical
        softmax, at ``HS_MAX_ROUND``; never below 2W."""
        B = self._window_centers * 2 * self.window
        cap = min(B, 8 * max(len(self.vocab), 1))
        floor = max(2 * self.window, 2)
        if self.use_hs:
            return min(max(floor, cap), self.HS_MAX_ROUND)
        return max(floor, cap)

    @property
    def _window_span(self) -> int:
        """Corpus positions per skip-gram block, sized so that the expected
        pair count (at most W + 1 per position) fills ``MAX_BLOCK_ROUNDS``
        rounds."""
        return max(1, (self._round_pairs * self.MAX_BLOCK_ROUNDS)
                   // (self.window + 1))

    @property
    def _pack_capacity(self) -> int:
        """C, the skip-gram block's pair buffer: every position realizing
        its whole 2W window, rounded up to whole rounds, so no pair is ever
        dropped."""
        B = self._round_pairs
        return -(-(self._window_span * 2 * self.window) // B) * B

    @property
    def _cbow_centers(self) -> int:
        """Examples per CBOW round: ``batch_size``, capped at 8 V so that a
        tiny vocabulary does not sum too many updates into one row per
        round, and at ``HS_MAX_ROUND`` under hierarchical softmax."""
        cap = min(self.batch_size, 8 * max(len(self.vocab), 1))
        if self.use_hs:
            cap = min(cap, self.HS_MAX_ROUND)
        return max(1, cap)

    # -- device tables -------------------------------------------------------
    def _vocab_key(self):
        counts = np.ascontiguousarray(self.vocab.counts())
        return (len(self.vocab), hash(counts.tobytes()), str(self.device))

    def _negpool(self, round_size: Optional[int] = None) -> torch.Tensor:
        """The pre-drawn negative pool on the device, drawn once per
        vocabulary and configuration. A round's ``round_size * negative``
        window of the pool must fit in it; ``round_size`` is the examples
        per round, by default the algorithm's own (``_cbow_centers`` for
        CBOW, ``_round_pairs`` for skip-gram)."""
        if round_size is None:
            round_size = (self._cbow_centers if self.algorithm == "cbow"
                          else self._round_pairs)
        round_negs = round_size * self.negative
        if round_negs >= self.NEG_POOL_SIZE:
            raise ValueError(
                f"negatives per round ({round_negs}) must be below "
                f"NEG_POOL_SIZE={self.NEG_POOL_SIZE}; lower batch_size/"
                "negative or raise NEG_POOL_SIZE")
        key = self._vocab_key() + (self.negative, self.seed)
        if self._negpool_cache is None or self._negpool_cache[0] != key:
            ntable = self._ntable()
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.seed ^ 0x5DEECE66) & 0x7FFFFFFF)
            bits = torch.randint(-2 ** 31, 2 ** 31, (self.NEG_POOL_SIZE,),
                                 dtype=torch.int32, generator=gen,
                                 device=self.device)
            self._negpool_cache = (key, negpool_from_bits(ntable, bits))
        return self._negpool_cache[1]

    def _ntable(self) -> torch.Tensor:
        """The 2^20-slot unigram^0.75 table on the device (int32), uploaded
        once per vocabulary."""
        key = self._vocab_key()
        if self._ntable_cache is None or self._ntable_cache[0] != key:
            self._ntable_cache = (key, torch.from_numpy(
                unigram_int_table(self.vocab)).to(self.device))
        return self._ntable_cache[1]

    def _hs_tables(self):
        """The Huffman ``(points, codes, mask)`` tables ``[V, L]`` on the
        device (int32, int32, float32), uploaded once per vocabulary."""
        key = self._vocab_key()
        if self._hs_cache is None or self._hs_cache[0] != key:
            codes, points, mask = huffman_arrays(self.vocab)
            self._hs_cache = (key, tuple(
                torch.from_numpy(a).to(self.device)
                for a in (points, codes, mask)))
        return self._hs_cache[1]

    def _round_inputs(self, n: int):
        """(labels, hs) for rounds of ``n`` examples: the positives-first
        labels ``[n, 1 + K]`` for negative sampling, or the Huffman tables
        for hierarchical softmax (the other one None)."""
        if self.use_hs:
            return None, self._hs_tables()
        lab = torch.zeros((n, 1 + self.negative), dtype=torch.float32,
                          device=self.device)
        lab[:, 0] = 1.0
        return lab, None

    def _tables_to_device(self):
        """syn0 and the output table (syn1 under hierarchical softmax, else
        syn1neg) on the device, in the table dtype."""
        tdt = (torch.bfloat16 if self.table_dtype == "bfloat16"
               else torch.float32)
        out = (self.lookup_table.syn1 if self.use_hs
               else self.lookup_table.syn1neg)
        return tuple(
            torch.from_numpy(np.array(t, dtype=np.float32)).to(self.device,
                                                                tdt)
            for t in (self.lookup_table.syn0, out))

    def _tables_from_device(self, syn0: torch.Tensor,
                            syn1: torch.Tensor) -> None:
        """The trained tables back into the lookup table, as float32."""
        self.table_device = syn0.device
        self.lookup_table.syn0 = syn0.float().cpu().numpy()
        out = syn1.float().cpu().numpy()
        if self.use_hs:
            self.lookup_table.syn1 = out
        else:
            self.lookup_table.syn1neg = out

    def _device_corpus(self, corpus: List[np.ndarray], span: int):
        """The encoded corpus as two int32 device buffers, ids and sentence
        ids (modulo 65535), laid out ``[W pads][stream][pads]`` and padded
        to a multiple of ``CORPUS_BUCKET`` plus one span; uploaded once per
        distinct corpus."""
        W = self.window
        flat = (np.concatenate(corpus) if corpus
                else np.empty(0, np.int32)).astype(np.int32)
        npad = -(-max(flat.size, 1) // self.CORPUS_BUCKET) * self.CORPUS_BUCKET
        buf_len = npad + span + 2 * W
        key = (flat.size, hash(flat.tobytes()), buf_len, str(self.device))
        if self._corpus_dev_cache is None or self._corpus_dev_cache[0] != key:
            lens = np.array([c.size for c in corpus], dtype=np.int64)
            ids = np.zeros(buf_len, np.int32)
            ids[W:W + flat.size] = flat
            sent = np.full(buf_len, SENT_PAD, np.int32)
            sent[W:W + flat.size] = np.repeat(
                np.arange(len(corpus), dtype=np.int64), lens) % SENT_PAD
            self._corpus_dev_cache = (key, (
                torch.from_numpy(ids).to(self.device),
                torch.from_numpy(sent).to(self.device)))
        return flat, self._corpus_dev_cache[1]

    def _expected_stream(self, flat: np.ndarray, keep: np.ndarray):
        """(n_exp, n_loop): the expected kept count, which paces the
        learning rate, and the bound of the block loop, both without
        reading the device's count back: the real count exceeds E + 6 sigma
        with probability ~1e-9."""
        if self.sampling <= 0:
            return float(flat.size), flat.size
        kf = keep[flat]
        n_exp = float(kf.sum())
        return n_exp, min(flat.size, int(n_exp + 6.0 * np.sqrt(
            max(float((kf * (1.0 - kf)).sum()), 1.0)) + 1))

    # -- one CBOW block ------------------------------------------------------
    def _cbow_block(self, syn0: torch.Tensor, syn1: torch.Tensor,
                    ids: torch.Tensor, sent: torch.Tensor, n_valid,
                    negpool: Optional[torch.Tensor], p0: int,
                    lrs: torch.Tensor, b: torch.Tensor, blk_id: int):
        """``MAX_BLOCK_ROUNDS`` CBOW rounds over the span of
        ``_cbow_centers * MAX_BLOCK_ROUNDS`` positions from ``p0``; updates
        ``syn0``/``syn1`` in place and returns the pair-weighted mean loss
        and the number of trained examples, both 0-dim device tensors.

        ``lrs`` [R] float32 holds each round's learning rate, ``b`` [S] the
        reduced windows, ``n_valid`` the stream length (an int or a 0-dim
        device tensor); ``negpool`` is None under hierarchical softmax.
        Nothing here waits for the device."""
        W = self.window
        B_C, R = self._cbow_centers, self.MAX_BLOCK_ROUNDS
        c_ids, ctx_all, valid, live = _derive_windows(ids, sent, n_valid, p0,
                                                      B_C * R, W, b)
        cm_all = valid.to(torch.float32)
        # the JAX block's per-round (live & window nonempty), for all rounds
        pm_all = (live & (cm_all.sum(dim=1) > 0)).to(torch.float32)
        losses = self._cbow_rounds(syn0, syn1, c_ids, ctx_all, cm_all, pm_all,
                                   negpool, lrs, blk_id)
        return self._block_result(losses, pm_all.view(R, B_C).sum(dim=1))

    def _cbow_rounds(self, syn0, syn1, c_ids, ctx_all, cm_all, pm_all,
                     negpool, lrs, blk_id: int) -> List[torch.Tensor]:
        """The ``MAX_BLOCK_ROUNDS`` CBOW rounds (negative sampling or
        hierarchical softmax) of ``_cbow_centers`` examples each over a
        block's windows: centers ``c_ids`` [S], contexts ``ctx_all`` and
        their mask ``cm_all`` [S, W'], pair mask ``pm_all`` [S]; returns
        the rounds' losses."""
        V, K = len(self.vocab), self.negative
        B_C = self._cbow_centers
        lab, hs = self._round_inputs(B_C)
        losses = []
        for r in range(self.MAX_BLOCK_ROUNDS):
            sl = slice(r * B_C, (r + 1) * B_C)
            c = c_ids[sl]
            if hs is not None:
                points, codes, pmask = hs
                losses.append(E.cbow_hs(syn0, syn1, ctx_all[sl], cm_all[sl],
                                        points[c], codes[c], pmask[c],
                                        lrs[r], pm_all[sl]))
                continue
            negs = _pool_negs(negpool, blk_id, r, B_C, K, V, c)
            tgt = torch.cat([c[:, None], negs], dim=1)
            losses.append(E.cbow(syn0, syn1, ctx_all[sl], cm_all[sl], tgt, lab,
                                 lrs[r], pm_all[sl]))
        return losses

    def _block_result(self, losses: List[torch.Tensor], ns: torch.Tensor):
        """A fixed-length block's counters, its pair-weighted mean loss and
        its examples (0-dim tensors), ``ns`` the examples of each round."""
        prof = OpProfiler.get()
        prof.count("nlp/w2v_blocks")
        prof.count("nlp/w2v_rounds", len(losses))
        return ((torch.stack(losses) * ns).sum() / ns.sum().clamp_min(1.0),
                ns.sum())

    # -- one skip-gram block -------------------------------------------------
    def _sg_pack(self, ids: torch.Tensor, sent: torch.Tensor, n_valid,
                 p0: int, b: torch.Tensor):
        """The span of ``_window_span`` positions from ``p0`` derived and
        compacted (:func:`_pack_span`): ([C] centers, [C] contexts, the
        count on its way to the host as a :class:`PendingCount`)."""
        packed_c, packed_x, count = _pack_span(
            ids, sent, n_valid, p0, self._window_span, self.window,
            self._pack_capacity, b)
        return packed_c, packed_x, PendingCount(count)

    def _sg_block(self, syn0: torch.Tensor, syn1: torch.Tensor,
                  packed_c: torch.Tensor, packed_x: torch.Tensor, count: int,
                  negpool: Optional[torch.Tensor], lr0, lr1, blk_id: int):
        """``ceil(count / B)`` dense skip-gram rounds of B = ``_round_pairs``
        pairs over a packed span (the JAX block's ``while_loop``); updates
        ``syn0``/``syn1`` in place and returns the pair-weighted mean loss
        (a 0-dim device tensor) and the pairs trained (``count``).

        Each round's learning rate is :func:`sg_round_rates`'s, and its pair
        mask zeroes the slots past ``count``."""
        B = self._round_pairs
        rounds = -(-count // B)
        dev = syn0.device
        lab, hs = self._round_inputs(B)
        lrs = torch.from_numpy(sg_round_rates(lr0, lr1, B, count)).to(dev)
        ones = torch.ones(B, dtype=torch.float32, device=dev)
        losses = []
        for r in range(rounds):
            sl = slice(r * B, (r + 1) * B)
            live = count - r * B
            pm = ones if live >= B else (
                torch.arange(B, device=dev) < live).to(torch.float32)
            losses.append(self._sg_round(syn0, syn1, packed_c[sl],
                                         packed_x[sl], lab, hs, negpool,
                                         lrs[r], pm, blk_id, r))
        prof = OpProfiler.get()
        prof.count("nlp/w2v_blocks")
        prof.count("nlp/w2v_rounds", rounds)
        if not rounds:
            return torch.zeros((), dtype=torch.float32, device=dev), 0
        ns = torch.from_numpy(np.minimum(
            count - np.arange(rounds) * B, B).astype(np.float32)).to(dev)
        return (torch.stack(losses) * ns).sum() / max(count, 1), count

    def _sg_round(self, syn0, syn1, c, x, lab, hs, negpool, lr, pm,
                  blk_id: int, r: int) -> torch.Tensor:
        """One skip-gram round of centers ``c`` against contexts ``x``, by
        negative sampling (``lab``, ``negpool``) or along the contexts'
        Huffman paths (``hs``); returns its loss."""
        if hs is not None:
            points, codes, pmask = hs
            return E.skipgram_hs(syn0, syn1, c, points[x], codes[x],
                                 pmask[x], lr, pm)
        negs = _pool_negs(negpool, blk_id, r, c.shape[0], self.negative,
                          len(self.vocab), x)
        tgt = torch.cat([x[:, None], negs], dim=1)
        return E.skipgram(syn0, syn1, c, tgt, lab, lr, pm)

    def _sg_pass(self, syn0, syn1, ids, sent, n_valid, negpool, gen,
                 blocks, stats: "_FitStats") -> None:
        """The skip-gram blocks of one pass over the stream, ``blocks`` a
        list of (p0, lr0, lr1, blk_id): each block's span is packed before
        the previous block's rounds are enqueued, so reading its count back
        never waits for training."""
        W, S = self.window, self._window_span
        dev = syn0.device

        def pack(p0):
            b = torch.randint(1, W + 1, (S,), generator=gen, device=dev)
            return self._sg_pack(ids, sent, n_valid, p0, b)

        nxt = pack(blocks[0][0]) if blocks else None
        for i, (_p0, lr0, lr1, blk_id) in enumerate(blocks):
            packed_c, packed_x, pending = nxt
            nxt = pack(blocks[i + 1][0]) if i + 1 < len(blocks) else None
            t0 = time.perf_counter()
            count = pending.get()
            stats.readback_wait += time.perf_counter() - t0
            stats.readbacks += 1
            stats.add(*self._sg_block(syn0, syn1, packed_c, packed_x, count,
                                      negpool, lr0, lr1, blk_id))

    # -- the fit -------------------------------------------------------------
    def _train_windowed(self, corpus: List[np.ndarray],
                        total_words: Optional[int] = None) -> None:
        """Train the tables over the encoded corpus on ``self.device``, the
        corpus resident there."""
        dev = self.device
        keep = subsample_keep_probs(self.vocab, self.sampling)
        raw_words = sum(len(s) for s in corpus)
        if total_words is None:
            total_words = raw_words * self.epochs * self.iterations
        W, R = self.window, self.MAX_BLOCK_ROUNDS
        is_cbow = self.algorithm == "cbow"
        span = self._cbow_centers * R if is_cbow else self._window_span
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        syn0, syn1 = self._tables_to_device()
        negpool = None if self.use_hs else self._negpool()
        stats = _FitStats()
        n_blocks = 0
        t0 = time.perf_counter()

        flat, (ids_full, sent_full) = self._device_corpus(corpus, span)
        n_raw = flat.size
        if self.sampling > 0:
            keep_dev = torch.from_numpy(keep.astype(np.float32)).to(dev)
        n_exp, n_loop = self._expected_stream(flat, keep)
        ends = lr_endpoints(self.learning_rate, self.min_learning_rate,
                            self.epochs, self.iterations, n_loop, span, n_exp,
                            raw_words, total_words)
        if is_cbow:
            lrs_all = torch.from_numpy(interpolate_rates(ends, R)).to(dev)

        for _epoch in range(self.epochs):
            if self.sampling > 0:
                u = torch.rand(ids_full.shape[0], generator=gen, device=dev)
                ids_dev, sent_dev, n_valid = _subsample(
                    ids_full, sent_full, keep_dev, n_raw, u, W)
            else:
                ids_dev, sent_dev, n_valid = ids_full, sent_full, n_raw
            for _it in range(self.iterations):
                starts = list(range(0, n_loop, span))
                if not is_cbow:
                    self._sg_pass(syn0, syn1, ids_dev, sent_dev, n_valid,
                                  negpool, gen,
                                  [(p0, *ends[n_blocks + i], n_blocks + i)
                                   for i, p0 in enumerate(starts)], stats)
                    n_blocks += len(starts)
                    continue
                for p0 in starts:
                    b = torch.randint(1, W + 1, (span,), generator=gen,
                                      device=dev)
                    stats.add(*self._cbow_block(
                        syn0, syn1, ids_dev, sent_dev, n_valid, negpool, p0,
                        lrs_all[n_blocks], b, n_blocks))
                    n_blocks += 1
        self._finish_fit(stats, raw_words * self.epochs * self.iterations,
                         t0, n_blocks, syn0, syn1)

    def _finish_fit(self, stats: "_FitStats", words_seen: int, t0: float,
                    n_blocks: int, syn0: torch.Tensor,
                    syn1: torch.Tensor) -> None:
        """The one readback of a fit, its rates and timing, and the tables
        back into the lookup table."""
        first, last, pairs_seen = stats.read()
        dt = time.perf_counter() - t0
        self.words_per_sec = words_seen / max(dt, 1e-9)
        self.pairs_per_sec = pairs_seen / max(dt, 1e-9)
        self.first_loss, self.last_loss = first, last
        self.last_fit_timing.update(train=dt, blocks=n_blocks,
                                    readbacks=stats.readbacks,
                                    readback_wait=stats.readback_wait)
        self._tables_from_device(syn0, syn1)

    # -- the host pair path --------------------------------------------------
    def _reduced_windows(self, ids: np.ndarray, rng: np.random.Generator,
                         keep: np.ndarray):
        """One sentence after frequent-word subsampling, with a reduced
        window b ~ U[1, W] drawn per position (the JAX package's numpy
        draws, in its order): (ids [n], neighbour positions [n, 2W] clipped
        to the sentence, valid [n, 2W]), or None when fewer than two words
        survive."""
        if self.sampling > 0:
            ids = ids[rng.random(ids.size) < keep[ids]]
        n = ids.size
        if n < 2:
            return None
        W = self.window
        b = rng.integers(1, W + 1, size=n)
        offs = np.concatenate([np.arange(-W, 0), np.arange(1, W + 1)])
        pos = np.arange(n)[:, None] + offs[None, :]
        valid = ((np.abs(offs)[None, :] <= b[:, None])
                 & (pos >= 0) & (pos < n))
        return ids, np.clip(pos, 0, n - 1), valid

    def _sentence_pairs(self, ids: np.ndarray, rng: np.random.Generator,
                        keep: np.ndarray):
        """Skip-gram's (centers, contexts) int32 of one sentence, or
        None."""
        win = self._reduced_windows(ids, rng, keep)
        if win is None:
            return None
        ids, pos, valid = win
        return np.broadcast_to(ids[:, None], valid.shape)[valid], \
            ids[pos][valid]

    def _sentence_windows(self, ids: np.ndarray, rng: np.random.Generator,
                          keep: np.ndarray):
        """CBOW's examples of one sentence, or None: (centers [n], contexts
        [n, 2W] int32, their mask [n, 2W] float32), each center's whole
        reduced window."""
        win = self._reduced_windows(ids, rng, keep)
        if win is None:
            return None
        ids, pos, valid = win
        return (ids, (ids[pos] * valid).astype(np.int32),
                valid.astype(np.float32))

    def _host_bits(self, shape, blk_id: int,
                   gen: torch.Generator) -> torch.Tensor:
        """The random bits (int32, uint32 patterns) of one host block's
        negatives, ``shape`` = [R, B, K], drawn on the device. (The JAX
        block draws them from its key folded with ``blk_id``; tests hand
        those bits in here.)"""
        return torch.randint(-2 ** 31, 2 ** 31, tuple(shape),
                             dtype=torch.int32, generator=gen,
                             device=self.device)

    def _host_block(self, syn0: torch.Tensor, syn1: torch.Tensor, cols,
                    bits: Optional[torch.Tensor]):
        """One host block, the counterpart of the JAX package's
        ``_make_block``: R rounds of B = ``batch_size`` examples, updating
        ``syn0``/``syn1`` in place. ``cols`` are the staged columns, for
        skip-gram (centers, contexts, valid count per round, learning rate
        per round), for CBOW (contexts [R, B, W'], their 0/1 mask, centers,
        valid counts, rates); ids int32 or uint16 carried as int16.
        ``bits`` [R, B, K] are the negatives' bits (None under
        hierarchical softmax). Returns the pair-weighted mean loss and the
        examples trained (0-dim device tensors)."""
        is_cbow = self.algorithm == "cbow"
        if is_cbow:
            ctx, cm, c, nv, lrs = cols
            ctx, cm = _widen(ctx), cm.to(torch.float32)
        else:
            c, x, nv, lrs = cols
            x = _widen(x)
        c = _widen(c)
        R, B = c.shape
        pm_all = (torch.arange(B, device=c.device)[None, :]
                  < nv[:, None]).to(torch.float32)
        lab, hs = self._round_inputs(B)
        if hs is None:
            tgt_all = bulk_targets(self._ntable(), bits,
                                   c if is_cbow else x, len(self.vocab))
        losses = []
        for r in range(R):
            if is_cbow and hs is not None:
                points, codes, pmask = hs
                cr = c[r]
                losses.append(E.cbow_hs(syn0, syn1, ctx[r], cm[r],
                                        points[cr], codes[cr], pmask[cr],
                                        lrs[r], pm_all[r]))
            elif is_cbow:
                losses.append(E.cbow(syn0, syn1, ctx[r], cm[r], tgt_all[r],
                                     lab, lrs[r], pm_all[r]))
            elif hs is not None:
                points, codes, pmask = hs
                xr = x[r]
                losses.append(E.skipgram_hs(syn0, syn1, c[r], points[xr],
                                            codes[xr], pmask[xr], lrs[r],
                                            pm_all[r]))
            else:
                losses.append(E.skipgram(syn0, syn1, c[r], tgt_all[r], lab,
                                         lrs[r], pm_all[r]))
        return self._block_result(losses, nv.to(torch.float32))

    def _default_stream(self, corpus: List[np.ndarray]):
        """The host stream of a plain fit, a function of (rng, keep)
        yielding (corpus words consumed, *examples): CBOW windows from
        :meth:`_sentence_windows`; skip-gram pairs from the native helper,
        one call per chunk of 2048 sentences, each seeded from ``rng``."""
        def stream(rng, keep):
            if self.algorithm == "cbow":
                for ids in corpus:
                    wins = self._sentence_windows(ids, rng, keep)
                    if wins is not None:
                        yield (ids.size,) + wins
                return
            chunk_sents = 2048
            keep_arr = keep if self.sampling > 0 else None
            for s0 in range(0, len(corpus), chunk_sents):
                chunk = corpus[s0:s0 + chunk_sents]
                offsets = np.zeros(len(chunk) + 1, np.int64)
                np.cumsum([a.size for a in chunk], out=offsets[1:])
                c, x = native.sg_pairs(np.concatenate(chunk), offsets,
                                       self.window, keep_arr,
                                       int(rng.integers(1, 2 ** 63 - 1)))
                if c.size:
                    yield int(offsets[-1]), c, x
        return stream

    def _train_encoded(self, corpus: List[np.ndarray], stream_factory=None,
                       total_words: Optional[int] = None) -> None:
        """The fit over an encoded corpus. A plain fit with
        ``device_corpus`` takes the device-windowed path
        (:meth:`_train_windowed`); a custom stream (``stream_factory(rng,
        keep)`` yielding (words consumed, centers, contexts) for skip-gram
        or (words consumed, centers, contexts, mask) for CBOW), or
        ``device_corpus = False``, the host pair path: a producer thread
        makes, buffers and stages the blocks, this thread trains them."""
        if stream_factory is None and self.device_corpus:
            return self._train_windowed(corpus, total_words)
        if stream_factory is None:
            stream_factory = self._default_stream(corpus)
        dev = self.device
        rng = np.random.default_rng(self.seed)
        keep = subsample_keep_probs(self.vocab, self.sampling)
        B, R = self.batch_size, self.MAX_BLOCK_ROUNDS
        K = self.negative
        if total_words is None:
            total_words = (sum(len(s) for s in corpus)
                           * self.epochs * self.iterations)
        n_rows = self.lookup_table.vocab_size or len(self.vocab)
        idx_dt = np.uint16 if n_rows <= (1 << 16) else np.int32
        is_cbow = self.algorithm == "cbow"
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        syn0, syn1 = self._tables_to_device()
        if not self.use_hs:
            self._ntable()
        stats = _FitStats()
        prod = {"words_seen": 0}
        t0 = time.perf_counter()

        def lr_now() -> np.float32:
            # linear decay by corpus words consumed, computed when a flush
            # is made
            frac = min(prod["words_seen"] / max(total_words, 1), 1.0)
            return np.float32(max(self.learning_rate * (1 - frac),
                                  self.min_learning_rate))

        def flush(examples):
            """The blocks of a flush: the examples padded to whole blocks,
            the valid count of each round, the flush's learning rate."""
            n = examples[0].shape[0]
            pad = (-n) % (B * R)
            rounds = (n + pad) // B
            nv = np.minimum(np.maximum(n - np.arange(rounds) * B, 0),
                            B).astype(np.int32)
            lr = lr_now()
            shaped = []
            for a in examples:
                a = a.astype(np.uint8 if a.dtype == np.float32 else idx_dt)
                a = np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                shaped.append(a.reshape((rounds, B) + a.shape[1:]))
            if is_cbow:          # the JAX block's column order
                c3, ctx3, cm3 = shaped
                shaped = [ctx3, cm3, c3]
            for r in range(0, rounds, R):
                sl = slice(r, r + R)
                yield _stage([a[sl] for a in shaped]
                             + [nv[sl], np.full(R, lr, np.float32)], dev)

        def work_items():
            # mid-fit flushes emit whole blocks only and carry the rest
            # forward, across epochs too; one padded tail runs at the end
            chunk = R * B
            buf, buffered = [], 0
            for _epoch in range(self.epochs):
                for item in stream_factory(rng, keep):
                    nwords, ex = item[0], item[1:]
                    prod["words_seen"] += nwords * self.iterations
                    for _ in range(self.iterations):
                        buf.append(ex)
                        buffered += ex[0].shape[0]
                    if buffered >= chunk:
                        cat = [np.concatenate([e[i] for e in buf])
                               for i in range(len(ex))]
                        n_full = (cat[0].shape[0] // chunk) * chunk
                        yield from flush([a[:n_full] for a in cat])
                        buf = [tuple(a[n_full:] for a in cat)]
                        buffered = cat[0].shape[0] - n_full
            if buffered:
                yield from flush([np.concatenate([e[i] for e in buf])
                                  for i in range(len(buf[0]))])

        n_blocks = 0
        wait = 0.0
        blocks = prefetch_iter(work_items(), maxsize=8)
        try:
            while True:
                tw = time.perf_counter()
                cols = next(blocks, None)
                wait += time.perf_counter() - tw
                if cols is None:
                    break
                bits = None
                if not self.use_hs:
                    bits = self._host_bits((R, B, K), n_blocks, gen)
                stats.add(*self._host_block(syn0, syn1, cols, bits))
                n_blocks += 1
        finally:
            blocks.close()
        self.last_fit_timing["producer_wait"] = wait
        self._finish_fit(stats, prod["words_seen"], t0, n_blocks, syn0, syn1)

    @staticmethod
    def _neg_targets(pos: np.ndarray, rng: np.random.Generator,
                     cdf: np.ndarray, V: int, K: int):
        """[N, 1+K] targets (column 0 the positive) and labels, negatives
        drawn from the unigram^0.75 CDF, a collision with the positive
        shifted by one, as the JAX package draws them."""
        B = pos.shape[0]
        negs = np.searchsorted(cdf, rng.random((B, K))).astype(np.int32)
        negs = np.where(negs == pos[:, None], (negs + 1) % V, negs)
        targets = np.concatenate([pos[:, None], negs], axis=1)
        labels = np.zeros((B, 1 + K), dtype=np.float32)
        labels[:, 0] = 1.0
        return targets, labels


def _stage(arrays, device: torch.device):
    """A host block's columns on ``device``: uint16 ids carried as int16
    (:func:`_widen` restores them there), on the card copied from pinned
    memory without blocking. PyTorch's pinned-memory allocator records the
    copy and hands the block out again only after it has completed, so the
    host buffer outlives its copy."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(
            a.view(np.int16) if a.dtype == np.uint16 else a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


def _widen(ids: torch.Tensor) -> torch.Tensor:
    """int32 ids from their wire type: int32 as they are, uint16 carried as
    int16 masked back to [0, 65535] (a plain widening would turn ids from
    2^15 on negative)."""
    if ids.dtype == torch.int16:
        return ids.to(torch.int32) & 0xFFFF
    return ids.to(torch.int32)


def bulk_targets(ntable: torch.Tensor, bits: torch.Tensor, pos: torch.Tensor,
                 V: int) -> torch.Tensor:
    """A host block's targets [R, B, 1+K] int32: column 0 the positives
    ``pos`` [R, B], then negatives ``ntable[bits & (T - 1)]`` from the
    block's bits [R, B, K], a negative equal to its positive shifted to
    ``(neg + 1) % V`` (the JAX block's ``bulk_targets``)."""
    negs = negpool_from_bits(ntable, bits)
    negs = torch.where(negs == pos[..., None], (negs + 1) % V, negs)
    return torch.cat([pos[..., None], negs], dim=-1)


class PendingCount:
    """A 0-dim device count on its way to the host: on the card a
    non-blocking copy into pinned memory and an event recorded after it, so
    that :meth:`get` waits for the count alone, not for work enqueued after
    it; on the CPU the value itself."""

    def __init__(self, count: torch.Tensor):
        self._event = None
        if count.is_cuda:
            self._host = torch.empty((), dtype=count.dtype, pin_memory=True)
            self._host.copy_(count, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = count

    def get(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


class _FitStats:
    """A fit's block losses and pair counts (0-dim device tensors, or host
    numbers for skip-gram's counts), read back once at the end, and the
    skip-gram counts read back on the way."""

    def __init__(self) -> None:
        self.losses: List[torch.Tensor] = []
        self.pairs_dev: List[torch.Tensor] = []
        self.pairs_host = 0.0
        self.readbacks = 0
        self.readback_wait = 0.0

    def add(self, loss: torch.Tensor, pairs) -> None:
        self.losses.append(loss)
        if torch.is_tensor(pairs):
            self.pairs_dev.append(pairs)
        else:
            self.pairs_host += pairs

    def read(self):
        """(the first block's loss, the mean of the last 50 blocks' losses,
        the pairs trained), in one readback of values that depend on the
        whole chain."""
        if not self.losses:
            return 0.0, 0.0, self.pairs_host
        tail = self.losses[-50:]
        n = len(tail)
        vals = torch.stack([self.losses[0]] + tail + [
            p.to(torch.float32) for p in self.pairs_dev]).cpu().numpy()
        return (float(vals[0]), float(vals[1:1 + n].mean()),
                self.pairs_host + float(vals[1 + n:].sum()))


def span_rates(learning_rate: float, min_learning_rate: float,
               words_seen: int, p0: int, span: int, n_loop: int,
               n_exp: float, raw_words: int, total_words: int):
    """(lr0, lr1) float32: the learning rates at the start and the end of
    the span ``[p0, p0 + span)`` of a pass that begins after ``words_seen``
    corpus words, as the JAX package computes them on the host. The rate
    decays linearly with corpus words consumed (a compacted position p maps
    to p / n_exp of the pass's ``raw_words``), from ``learning_rate`` to the
    floor ``min_learning_rate``."""

    def lr_at(frac: float) -> np.float32:
        return np.float32(max(learning_rate * (1.0 - min(frac, 1.0)),
                              min_learning_rate))

    return (lr_at((words_seen + p0 / max(n_exp, 1.0) * raw_words)
                  / max(total_words, 1)),
            lr_at((words_seen + min(p0 + span, n_loop) / max(n_exp, 1.0)
                   * raw_words) / max(total_words, 1)))


def lr_endpoints(learning_rate: float, min_learning_rate: float, epochs: int,
                 iterations: int, n_loop: int, span: int, n_exp: float,
                 raw_words: int, total_words: int) -> np.ndarray:
    """float32 ``[blocks, 2]``: :func:`span_rates` of every block of a fit
    whose passes (``epochs * iterations``) each run the blocks of ``span``
    positions over ``n_loop``."""
    rows = []
    for k in range(epochs * iterations):
        rows += [span_rates(learning_rate, min_learning_rate, k * raw_words,
                            p0, span, n_loop, n_exp, raw_words, total_words)
                 for p0 in range(0, n_loop, span)]
    return np.asarray(rows, dtype=np.float32).reshape(-1, 2)


def interpolate_rates(ends: np.ndarray, rounds: int) -> np.ndarray:
    """float32 ``[blocks, rounds]``: ``lr0 + (lr1 - lr0) * r / rounds`` per
    block, as a fixed-length JAX block (CBOW, ParagraphVectors) computes
    each round's rate."""
    r = np.arange(rounds, dtype=np.float32)
    lr0, lr1 = ends[:, :1], ends[:, 1:]
    return (lr0 + (lr1 - lr0) * r / np.float32(rounds)).astype(np.float32)


def sg_round_rates(lr0, lr1, B: int, count: int) -> np.ndarray:
    """float32 ``[ceil(count / B)]``: the skip-gram block's rate of each
    round, ``lr0 + (lr1 - lr0) * (r*B) / max(count, 1)``, in float32 and in
    the JAX block's order of operations."""
    lr0, lr1 = np.float32(lr0), np.float32(lr1)
    rounds = -(-count // B)
    rb = (np.arange(rounds, dtype=np.int32) * np.int32(B)).astype(np.float32)
    countf = np.float32(max(count, 1))
    return (lr0 + (lr1 - lr0) * rb / countf).astype(np.float32)


def negpool_from_bits(ntable: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The negative pool: ``ntable[bits & (T - 1)]`` for a power-of-two
    table of T slots; ``bits`` int32 (uint32 patterns)."""
    T = ntable.shape[0]
    return ntable[(bits & (T - 1)).long()]


def _subsample_slots(ids: torch.Tensor, keep: torch.Tensor, n_full: int,
                     u: torch.Tensor, W: int):
    """Frequent-word subsampling's stream compaction on the device: the
    stream occupies buffer slots ``[W, W + n_full)``; position i is kept
    when ``u[i] < keep[ids[i]]``, and kept positions move, in order, to
    slots from W on (cumsum). Returns (the destination slot of every
    position, N for a dropped one; the kept count, a 0-dim device
    tensor)."""
    N = ids.shape[0]
    iota = torch.arange(N, device=ids.device)
    vf = (u < keep[ids]) & (iota >= W) & (iota < W + n_full)
    dest = torch.cumsum(vf.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return torch.where(vf, dest + W, N).long(), dest[-1] + 1


def _compact(x: torch.Tensor, slot: torch.Tensor, fill: int) -> torch.Tensor:
    """``x`` scattered into a fixed buffer of its length at ``slot``
    (:func:`_subsample_slots`); the rest of the buffer gets ``fill``."""
    N = x.shape[0]
    out = torch.full((N + 1,), fill, dtype=x.dtype, device=x.device)
    out.scatter_(0, slot, x)
    return out[:N]


def _subsample(ids: torch.Tensor, sent: torch.Tensor, keep: torch.Tensor,
               n_full: int, u: torch.Tensor, W: int):
    """Frequent-word subsampling and stream compaction on the device
    (:func:`_subsample_slots`); the freed slots get id 0 and the pad
    sentence id. Returns (ids', sent', count), the count a 0-dim device
    tensor: nothing is read back."""
    slot, count = _subsample_slots(ids, keep, n_full, u, W)
    return _compact(ids, slot, 0), _compact(sent, slot, SENT_PAD), count


def _derive_windows(ids: torch.Tensor, sent: torch.Tensor, n_valid, p0: int,
                    S: int, W: int, b: torch.Tensor):
    """The windows of S center positions from stream position ``p0``
    (buffer index ``p0 + W``): contexts as 2W shifted slices, valid where
    the offset is within the reduced window ``b``, the neighbour is in the
    center's sentence and the center is inside the stream (< ``n_valid``).
    Returns (c_ids [S], ctx [S, 2W] int32, valid [S, 2W] bool,
    live [S] bool)."""
    if p0 < 0 or p0 + S + 2 * W > ids.shape[0]:
        raise ValueError(f"span [{p0}, {p0 + S + 2 * W}) outside the corpus "
                         f"buffer of {ids.shape[0]}")
    idw = ids[p0:p0 + S + 2 * W].to(torch.int32)
    sw = sent[p0:p0 + S + 2 * W]
    c_ids = idw[W:W + S]
    c_sent = sw[W:W + S]
    p = p0 + torch.arange(S, device=ids.device)
    live = p < n_valid
    ctx_cols, v_cols = [], []
    for o in list(range(-W, 0)) + list(range(1, W + 1)):
        ctx_cols.append(idw[W + o:W + o + S])
        v_cols.append((b >= abs(o)) & live & (sw[W + o:W + o + S] == c_sent))
    return (c_ids, torch.stack(ctx_cols, dim=1), torch.stack(v_cols, dim=1),
            live)


def _pack_span(ids: torch.Tensor, sent: torch.Tensor, n_valid, p0: int,
               S: int, W: int, C: int, b: torch.Tensor):
    """A span's skip-gram pairs derived (:func:`_derive_windows`) and
    compacted densely, in corpus order, into buffers of capacity C: the
    order-preserving cumsum, then a scatter of each valid (center, context)
    slot to its rank. Returns ([C] centers, [C] contexts, count), int32, the
    count a 0-dim device tensor (at most C). Slots past the count hold 0."""
    c_ids, x_ids, valid, _ = _derive_windows(ids, sent, n_valid, p0, S, W, b)
    vf = valid.reshape(-1)
    dest = torch.cumsum(vf.to(torch.int32), dim=0, dtype=torch.int32) - 1
    count = torch.clamp(dest[-1] + 1, max=C)
    slot = torch.where(vf, dest, C).long()
    packed = []
    for src in (c_ids[:, None].expand(S, 2 * W).reshape(-1),
                x_ids.reshape(-1)):
        buf = torch.zeros(C + 1, dtype=torch.int32, device=ids.device)
        buf.scatter_(0, slot, src)
        packed.append(buf[:C])
    return packed[0], packed[1], count


def _pool_negs(negpool: torch.Tensor, blk_id: int, r: int, B: int, K: int,
               V: int, positives: torch.Tensor) -> torch.Tensor:
    """The [B, K] window of the pool for round ``r`` of block ``blk_id``,
    negatives equal to the positive shifted by one. The start is the JAX
    package's uint32 arithmetic, ``((blk_id*131 + r) * 48611) mod 2^32``
    modulo ``P - B*K``, done on host integers with the wrap spelled out."""
    g = (blk_id * 131 + r) & _U32
    start = ((g * 48611) & _U32) % (negpool.shape[0] - B * K)
    negs = negpool[start:start + B * K].view(B, K)
    return torch.where(negs == positives[:, None], (negs + 1) % V, negs)


class Word2Vec(SequenceVectors):
    """Word2Vec over a sentence corpus: skip-gram (the default) or CBOW, with
    negative sampling or hierarchical softmax."""

    class Builder:
        def __init__(self) -> None:
            self._kw = {}
            self._iter: Optional[SentenceIterator] = None
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
        def use_hierarchic_softmax(self, v): self._kw["use_hierarchic_softmax"] = v; return self
        def sampling(self, v): self._kw["sampling"] = v; return self
        def batch_size(self, v): self._kw["batch_size"] = v; return self
        def workers(self, v): self._kw["workers"] = v; return self
        def table_dtype(self, v): self._kw["table_dtype"] = v; return self
        def device(self, v): self._kw["device"] = v; return self

        def sharded_tables(self, mesh, axis: str = "model"):
            self._kw["mesh"] = mesh
            self._kw["table_sharding_axis"] = axis
            return self

        def elements_learning_algorithm(self, name: str):
            self._kw["algorithm"] = \
                "cbow" if "cbow" in name.lower() else "skipgram"
            return self

        def iterate(self, it):
            if isinstance(it, (list, tuple)):
                it = CollectionSentenceIterator(it)
            self._iter = it
            return self

        def tokenizer_factory(self, tf: TokenizerFactory):
            self._tok = tf
            return self

        def build(self) -> "Word2Vec":
            w2v = Word2Vec(**self._kw)
            w2v._sentence_iter = self._iter
            w2v._tokenizer = self._tok
            return w2v

    @staticmethod
    def builder() -> "Word2Vec.Builder":
        return Word2Vec.Builder()

    def __init__(self, **kw):
        super().__init__(**kw)
        self._sentence_iter: Optional[SentenceIterator] = None
        self._tokenizer: TokenizerFactory = DefaultTokenizerFactory()

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

    def fit(self) -> None:
        """Train. The first call builds the vocabulary and initializes the
        tables; a model that already has both (a second ``fit``, or state
        carried in with ``util.convert.word2vec_state_from_numpy``) resumes
        from them, dropping corpus words outside its vocabulary."""
        t0 = time.perf_counter()
        if len(self.vocab) == 0 or self.lookup_table.syn0 is None:
            self.build_vocab(self._token_stream())
            if len(self.vocab) == 0:
                raise ValueError("empty vocabulary after pruning — lower "
                                 "min_word_frequency or supply more text")
        corpus = self._encode_corpus(self._token_stream())
        self.last_fit_timing = {"prepare": time.perf_counter() - t0}
        self._train_encoded(corpus)
