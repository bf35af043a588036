"""Word2Vec, CBOW with negative sampling, trained on the device.

Counterpart of ``deeplearning4j_tpu/nlp/word2vec.py`` (the reference's
``SequenceVectors`` engine and ``Word2Vec`` front), the part that the
``word2vec-cbow`` configuration runs: the device-windowed CBOW path with
negative sampling. The statistical procedure is the JAX package's:
count-pruned vocabulary, frequent-word subsampling with stream compaction on
the device, a reduced window b ~ U[1, W] per position, negatives from a
pre-drawn pool of the unigram^0.75 table walked at a prime stride, the exact
gradient of the mean-forward loss, and a learning rate that decays linearly
with corpus words consumed.

One fit:

1. the vocabulary and tables (host, numpy), the encoded corpus;
2. the corpus uploaded once into a padded device buffer (ids and sentence
   ids, ``[W pads][stream][pads]``), the negative pool drawn on the device;
3. per epoch, subsampling and compaction on the device
   (:func:`_subsample`: cumsum plus a scatter into a fixed buffer; the kept
   count stays on the device);
4. blocks of ``MAX_BLOCK_ROUNDS`` = 64 rounds (:meth:`SequenceVectors.
   _cbow_block`), each round one :func:`ops.embeddings.cbow`, so one
   ``embedding_bag`` kernel launch. The JAX block is one jitted ``lax.scan``;
   here it is a Python loop that enqueues work and never waits for the
   device: losses and pair counts stay on the device, and the learning rates
   of every round of the fit are computed on the host up front and uploaded
   once;
5. one readback at the end (the timed window for ``words_per_sec`` runs from
   before the corpus upload to that readback, as in the JAX package).

Random draws are arguments of the math (:func:`_derive_windows` takes the
reduced windows ``b``, :func:`_subsample` the uniforms, :func:`negpool_from_bits`
the bits), drawn from ``torch.Generator``s on the device seeded from
``seed``. They cannot match JAX's threefry draws; the tests hand the JAX
package's draws to these functions instead.

Not ported here, and refused with an error rather than substituted:
skip-gram (the JAX package's default algorithm), hierarchical softmax,
bfloat16 tables, sharded tables (``mesh=``) and the host pair path
(``device_corpus = False``). ROADMAP.md lists them in order.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..common.environment import resolve_device
from ..common.profiler import OpProfiler
from ..ops import embeddings as E
from .lookup_table import InMemoryLookupTable
from .text import (CollectionSentenceIterator, DefaultTokenizerFactory,
                   SentenceIterator, TokenizerFactory)
from .vocab import (VocabCache, VocabConstructor, subsample_keep_probs,
                    unigram_int_table)

#: sentence id of the pad slots; real ids travel modulo 65535, which keeps
#: the boundary check exact (it compares positions at most W < 65535 apart)
SENT_PAD = 65535
_U32 = 0xFFFFFFFF


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet: this port "
        f"trains Word2Vec as CBOW with negative sampling, float32 tables on "
        f"one device (see ROADMAP.md, 'Still to port')")


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
    """The training engine behind :class:`Word2Vec`."""

    #: training rounds per block (the JAX package's scan length)
    MAX_BLOCK_ROUNDS = 64
    #: the corpus buffer is padded to a multiple of this
    CORPUS_BUCKET = 1 << 16
    #: entries of the pre-drawn negative pool (int32, 32 MB)
    NEG_POOL_SIZE = 1 << 23

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
            raise _not_ported("hierarchical softmax "
                              "(use_hierarchic_softmax=True)")
        if negative <= 0:
            raise ValueError("need negative sampling (negative>0) or "
                             "use_hierarchic_softmax=True")
        self.algorithm = algorithm.lower()
        if self.algorithm not in ("skipgram", "cbow"):
            raise ValueError(f"unknown algorithm {algorithm!r}")
        if self.algorithm == "skipgram":
            raise _not_ported("skip-gram (algorithm='skipgram', the default; "
                              "pass algorithm='cbow')")
        if table_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"table_dtype must be float32|bfloat16, "
                             f"got {table_dtype!r}")
        if table_dtype == "bfloat16":
            raise _not_ported("table_dtype='bfloat16'")
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
        #: the JAX package's switch to its host pair path; only the device
        #: path is ported, so False is refused at fit time
        self.device_corpus = True
        self.device = resolve_device(device)
        self.words_per_sec: float = 0.0
        self.pairs_per_sec: float = 0.0
        self.last_loss: float = 0.0
        #: device the tables were trained on in the last fit
        self.table_device: Optional[torch.device] = None
        #: seconds of the last fit: "prepare" (tokenizing, counting,
        #: encoding; host) and "train" (the words_per_sec window), and the
        #: blocks it ran
        self.last_fit_timing = {}
        self._corpus_dev_cache = None
        self._negpool_cache = None
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
        self.lookup_table = InMemoryLookupTable(
            len(self.vocab), self.layer_size, seed=self.seed)
        self.lookup_table.reset_weights(False, True)

    @property
    def _cbow_centers(self) -> int:
        """Examples per round: ``batch_size``, capped at 8 V so that a tiny
        vocabulary does not sum too many updates into one row per round."""
        return max(1, min(self.batch_size, 8 * max(len(self.vocab), 1)))

    def _negpool(self) -> torch.Tensor:
        """The pre-drawn negative pool on the device, drawn once per
        vocabulary and configuration."""
        round_negs = self._cbow_centers * self.negative
        if round_negs >= self.NEG_POOL_SIZE:
            raise ValueError(
                f"negatives per round ({round_negs}) must be below "
                f"NEG_POOL_SIZE={self.NEG_POOL_SIZE}; lower batch_size/"
                "negative or raise NEG_POOL_SIZE")
        counts = np.ascontiguousarray(self.vocab.counts())
        key = (len(self.vocab), hash(counts.tobytes()), self.negative,
               self.seed, str(self.device))
        if self._negpool_cache is None or self._negpool_cache[0] != key:
            ntable = torch.from_numpy(unigram_int_table(self.vocab)).to(
                self.device)
            gen = torch.Generator(device=self.device)
            gen.manual_seed((self.seed ^ 0x5DEECE66) & 0x7FFFFFFF)
            bits = torch.randint(-2 ** 31, 2 ** 31, (self.NEG_POOL_SIZE,),
                                 dtype=torch.int32, generator=gen,
                                 device=self.device)
            self._negpool_cache = (key, negpool_from_bits(ntable, bits))
        return self._negpool_cache[1]

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

    # -- one block -----------------------------------------------------------
    def _cbow_block(self, syn0: torch.Tensor, syn1: torch.Tensor,
                    ids: torch.Tensor, sent: torch.Tensor, n_valid,
                    negpool: torch.Tensor, p0: int, lrs: torch.Tensor,
                    b: torch.Tensor, blk_id: int):
        """``MAX_BLOCK_ROUNDS`` CBOW rounds over the span of
        ``_cbow_centers * MAX_BLOCK_ROUNDS`` positions from ``p0``; updates
        ``syn0``/``syn1`` in place and returns the pair-weighted mean loss
        and the number of trained examples, both 0-dim device tensors.

        ``lrs`` [R] float32 holds each round's learning rate, ``b`` [S] the
        reduced windows, ``n_valid`` the stream length (an int or a 0-dim
        device tensor). Nothing here waits for the device."""
        V, K, W = len(self.vocab), self.negative, self.window
        B_C, R = self._cbow_centers, self.MAX_BLOCK_ROUNDS
        c_ids, ctx_all, valid, live = _derive_windows(ids, sent, n_valid, p0,
                                                      B_C * R, W, b)
        cm_all = valid.to(torch.float32)
        # the JAX block's per-round (live & window nonempty), for all rounds
        pm_all = (live & (cm_all.sum(dim=1) > 0)).to(torch.float32)
        lab = torch.zeros((B_C, 1 + K), dtype=torch.float32,
                          device=syn0.device)
        lab[:, 0] = 1.0
        losses = []
        for r in range(R):
            sl = slice(r * B_C, (r + 1) * B_C)
            c = c_ids[sl]
            negs = _pool_negs(negpool, blk_id, r, B_C, K, V, c)
            tgt = torch.cat([c[:, None], negs], dim=1)
            losses.append(E.cbow(syn0, syn1, ctx_all[sl], cm_all[sl], tgt, lab,
                                 lrs[r], pm_all[sl]))
        prof = OpProfiler.get()
        prof.count("nlp/w2v_blocks")
        prof.count("nlp/w2v_rounds", R)
        ns = pm_all.view(R, B_C).sum(dim=1)
        mean_loss = (torch.stack(losses) * ns).sum() / ns.sum().clamp_min(1.0)
        return mean_loss, ns.sum()

    # -- the fit -------------------------------------------------------------
    def _train_windowed(self, corpus: List[np.ndarray],
                        total_words: Optional[int] = None) -> None:
        """Train the tables over the encoded corpus on ``self.device``."""
        if not self.device_corpus:
            raise _not_ported("the host pair path (device_corpus=False)")
        dev = self.device
        keep = subsample_keep_probs(self.vocab, self.sampling)
        raw_words = sum(len(s) for s in corpus)
        if total_words is None:
            total_words = raw_words * self.epochs * self.iterations
        W, R = self.window, self.MAX_BLOCK_ROUNDS
        span = self._cbow_centers * R
        negpool = self._negpool()
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        syn0 = torch.from_numpy(np.array(self.lookup_table.syn0,
                                         dtype=np.float32)).to(dev)
        syn1 = torch.from_numpy(np.array(self.lookup_table.syn1neg,
                                         dtype=np.float32)).to(dev)
        losses, pair_counts = [], []
        n_blocks = 0
        t0 = time.perf_counter()

        flat, (ids_full, sent_full) = self._device_corpus(corpus, span)
        n_raw = flat.size
        if self.sampling > 0:
            keep_dev = torch.from_numpy(keep.astype(np.float32)).to(dev)
            # the expected kept count paces the learning rate and bounds the
            # block loop without reading the device's count back: the real
            # count exceeds E + 6 sigma with probability ~1e-9
            kf = keep[flat]
            n_exp = float(kf.sum())
            n_loop = min(n_raw, int(n_exp + 6.0 * np.sqrt(
                max(float((kf * (1.0 - kf)).sum()), 1.0)) + 1))
        else:
            n_exp = float(n_raw)
            n_loop = n_raw
        lrs_all = torch.from_numpy(lr_schedule(
            self.learning_rate, self.min_learning_rate, self.epochs,
            self.iterations, n_loop, span, n_exp, raw_words, total_words,
            R)).to(dev)

        for _epoch in range(self.epochs):
            if self.sampling > 0:
                u = torch.rand(ids_full.shape[0], generator=gen, device=dev)
                ids_dev, sent_dev, n_valid = _subsample(
                    ids_full, sent_full, keep_dev, n_raw, u, W)
            else:
                ids_dev, sent_dev, n_valid = ids_full, sent_full, n_raw
            for _it in range(self.iterations):
                for p0 in range(0, n_loop, span):
                    b = torch.randint(1, W + 1, (span,), generator=gen,
                                      device=dev)
                    loss, n_pairs = self._cbow_block(
                        syn0, syn1, ids_dev, sent_dev, n_valid, negpool, p0,
                        lrs_all[n_blocks], b, n_blocks)
                    n_blocks += 1
                    losses.append(loss)
                    pair_counts.append(n_pairs)
        words_seen = raw_words * self.epochs * self.iterations
        # the one readback: values that depend on the whole chain
        last = (torch.stack(losses[-50:]).cpu().numpy() if losses
                else np.zeros(1, np.float32))
        pairs_seen = (float(torch.stack(pair_counts).sum().item())
                      if pair_counts else 0.0)
        dt = time.perf_counter() - t0
        self.words_per_sec = words_seen / max(dt, 1e-9)
        self.pairs_per_sec = pairs_seen / max(dt, 1e-9)
        self.last_loss = float(last.mean()) if losses else 0.0
        self.last_fit_timing.update(train=dt, blocks=n_blocks)
        self.table_device = syn0.device
        self.lookup_table.syn0 = syn0.cpu().numpy()
        self.lookup_table.syn1neg = syn1.cpu().numpy()


def lr_schedule(learning_rate: float, min_learning_rate: float, epochs: int,
                iterations: int, n_loop: int, span: int, n_exp: float,
                raw_words: int, total_words: int, rounds: int) -> np.ndarray:
    """float32 ``[blocks, rounds]``: every round's learning rate of one fit,
    as the JAX package computes it. Each block interpolates between the
    rates at its span's start and end, ``lr0 + (lr1 - lr0) * r / rounds``,
    in float32; each rate decays linearly with corpus words consumed, from
    ``learning_rate`` to the floor ``min_learning_rate``."""

    def lr_at(frac: float) -> np.float32:
        return np.float32(max(learning_rate * (1.0 - min(frac, 1.0)),
                              min_learning_rate))

    r = np.arange(rounds, dtype=np.float32)
    rows = []
    words_seen = 0
    for _epoch in range(epochs):
        for _it in range(iterations):
            for p0 in range(0, n_loop, span):
                lr0 = lr_at((words_seen + p0 / max(n_exp, 1.0) * raw_words)
                            / max(total_words, 1))
                lr1 = lr_at((words_seen + min(p0 + span, n_loop)
                             / max(n_exp, 1.0) * raw_words)
                            / max(total_words, 1))
                rows.append(lr0 + (lr1 - lr0) * r / np.float32(rounds))
            words_seen += raw_words
    return np.asarray(rows, dtype=np.float32).reshape(-1, rounds)


def negpool_from_bits(ntable: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The negative pool: ``ntable[bits & (T - 1)]`` for a power-of-two
    table of T slots; ``bits`` int32 (uint32 patterns)."""
    T = ntable.shape[0]
    return ntable[(bits & (T - 1)).long()]


def _subsample(ids: torch.Tensor, sent: torch.Tensor, keep: torch.Tensor,
               n_full: int, u: torch.Tensor, W: int):
    """Frequent-word subsampling and stream compaction on the device.

    The stream occupies buffer slots ``[W, W + n_full)``; position i is kept
    when ``u[i] < keep[ids[i]]``. Kept positions move, in order, to slots
    from W on (cumsum, then a scatter into a fixed buffer); the rest of the
    buffer gets id 0 and the pad sentence id. Returns (ids', sent', count),
    the count a 0-dim device tensor: nothing is read back."""
    N = ids.shape[0]
    iota = torch.arange(N, device=ids.device)
    vf = (u < keep[ids]) & (iota >= W) & (iota < W + n_full)
    dest = torch.cumsum(vf.to(torch.int32), dim=0, dtype=torch.int32) - 1
    slot = torch.where(vf, dest + W, N).long()
    ids_sub = torch.zeros(N + 1, dtype=ids.dtype, device=ids.device)
    ids_sub.scatter_(0, slot, ids)
    sent_sub = torch.full((N + 1,), SENT_PAD, dtype=sent.dtype,
                          device=sent.device)
    sent_sub.scatter_(0, slot, sent)
    return ids_sub[:N], sent_sub[:N], dest[-1] + 1


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
    """Word2Vec over a sentence corpus (CBOW with negative sampling)."""

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
        self._train_windowed(corpus)
