"""The port's host pair path (``device_corpus = False`` and the custom
streams of ParagraphVectors) against the JAX package's, on the CPU.

The producer's work is numpy and the native helper on both sides, so it must
match bit for bit: the pairs (``native.sg_pairs`` seeded from
``np.random.default_rng(seed)``), the CBOW windows, the padded columns, the
valid counts and each flush's learning rate. The block's negatives are drawn
from threefry bits in JAX and from a ``torch.Generator`` in the port; these
tests hand the JAX block's own bits (its key folded with the block id) to the
port (``_host_bits``).

Tolerances, and why:
- columns, counts, learning rates, pair streams: bitwise (same numpy and
  C++ code on the same inputs).
- one block and whole fits (SG and CBOW, NS and HS, PV-DBOW and PV-DM):
  2e-6 absolute on the O(1) tables and 1e-5 relative on the loss, the
  tolerance PR 8 stated for one device block (tests/test_torch_word2vec.py:
  each round's dots go through other matrix kernels and duplicate rows are
  summed in another order, a few float32 ulp over the rounds).
- the learning gates of tests/test_nlp.py: as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch import native as tnative
from deeplearning4j_tpu_torch.common.background import prefetch_iter
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import text as ttext
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    inject_jax_bits, jax_block_bits, one_torch_thread, record_host_blocks)


TOL = dict(rtol=0, atol=2e-6)


def _cluster_corpus(n_sent=300, sent_len=8, seed=0):
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=sent_len))
            for _ in range(n_sent)]


def _cluster_docs(n_docs=80, doc_len=30, seed=0):
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    docs = [" ".join(rng.choice(A if i % 2 == 0 else B, size=doc_len))
            for i in range(n_docs)]
    return docs, [f"DOC_{i}" for i in range(n_docs)]


def _tables(m):
    lt = m.lookup_table
    return (np.asarray(lt.syn0),
            np.asarray(lt.syn1 if m.use_hs else lt.syn1neg))


def _w2v_pair(sents, **kw):
    cfg = dict(min_word_frequency=5, layer_size=16, window=3, negative=5,
               batch_size=32, seed=7, epochs=2)
    cfg.update(kw)
    j = jw2v.Word2Vec(**cfg)
    t = tw2v.Word2Vec(device="cpu", **cfg)
    for m in (j, t):
        m.device_corpus = False
        m.set_sentence_iterator(sents)
    inject_jax_bits(t)
    return j, t


# --- the wire -------------------------------------------------------------------

def test_uint16_ids_above_2_15_stay_positive_on_the_device():
    ids = np.array([0, 1, 32767, 32768, 40000, 65535], np.uint16)
    (staged,) = tw2v._stage([ids], torch.device("cpu"))
    assert staged.dtype == torch.int16 and staged.element_size() == 2
    widened = tw2v._widen(staged)
    assert widened.dtype == torch.int32
    np.testing.assert_array_equal(widened.numpy(), ids.astype(np.int32))
    big = np.array([70000, 5], np.int32)
    (staged,) = tw2v._stage([big], torch.device("cpu"))
    np.testing.assert_array_equal(tw2v._widen(staged).numpy(), big)


def test_bulk_targets_are_the_jax_block_targets():
    """The block's [R, B, 1+K] targets from the same bits: positives first,
    then ntable[bits & (T-1)], collisions shifted."""
    j, t = _w2v_pair(_cluster_corpus())
    t.build_vocab(t._token_stream())
    ntable = jvocab.unigram_int_table(t.vocab)
    V, R, B, K = len(t.vocab), 4, 8, 5
    pos = np.random.default_rng(0).integers(0, V, (R, B)).astype(np.int32)
    bits = jax_block_bits(3, 1, (R, B, K))
    got = tw2v.bulk_targets(torch.from_numpy(ntable.copy()),
                            torch.from_numpy(bits),
                            torch.from_numpy(pos), V).numpy()
    negs = ntable[(bits.view(np.uint32) & (ntable.size - 1)).astype(np.int64)]
    negs = np.where(negs == pos[..., None], (negs + 1) % V, negs)
    np.testing.assert_array_equal(got, np.concatenate([pos[..., None], negs],
                                                      axis=-1))


# --- one block ------------------------------------------------------------------

def _block_cols(j, rng, cbow: bool, ctx_w: int):
    """Columns of one host block, as the JAX producer lays them out: ids
    uint16, a partial last round, a falling learning rate."""
    R, B, V = j.MAX_BLOCK_ROUNDS, j.batch_size, len(j.vocab)
    nv = np.full(R, B, np.int32)
    nv[-3:] = [B // 2, 0, 0]
    lr = np.full(R, np.float32(0.023), np.float32)
    c3 = rng.integers(0, V, (R, B)).astype(np.uint16)
    if not cbow:
        return (c3, rng.integers(0, V, (R, B)).astype(np.uint16), nv, lr)
    ctx = rng.integers(0, V, (R, B, ctx_w)).astype(np.uint16)
    cm = (rng.random((R, B, ctx_w)) < 0.7).astype(np.uint8)
    cm[:, :2] = 0                       # empty windows
    return (ctx, cm, c3, nv, lr)


@pytest.mark.parametrize("alg,hs", [("skipgram", False), ("skipgram", True),
                                    ("cbow", False), ("cbow", True)],
                         ids=["sg-ns", "sg-hs", "cbow-ns", "cbow-hs"])
def test_one_host_block_against_the_jax_block(alg, hs):
    kw = {"use_hierarchic_softmax": True, "negative": 0} if hs else {}
    j, t = _w2v_pair(_cluster_corpus(400, seed=2), algorithm=alg, **kw)
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    R, B, K = j.MAX_BLOCK_ROUNDS, j.batch_size, j.negative
    cols = _block_cols(j, np.random.default_rng(11), alg == "cbow",
                       2 * j.window)
    block = j._block_for("host", j._make_block, j.batch_size)
    base = jax.random.PRNGKey(j.seed)
    syn0, syn1 = _tables(j)
    blk_id = 5
    js0, js1, jloss = block(jnp.asarray(syn0), jnp.asarray(syn1),
                            tuple(jnp.asarray(c) for c in cols), base,
                            np.int32(blk_id))
    t0, t1 = (torch.from_numpy(a.copy()) for a in _tables(t))
    bits = None if hs else torch.from_numpy(jax_block_bits(j.seed, blk_id,
                                                      (R, B, K)))
    prof = OpProfiler.get()
    rounds = prof.counter_value("nlp/w2v_rounds")
    tloss, tn = t._host_block(t0, t1, tw2v._stage(list(cols),
                                                  torch.device("cpu")), bits)
    assert prof.counter_value("nlp/w2v_rounds") == rounds + R
    assert float(tn) == float(cols[-2].sum())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(js0), **TOL)
    np.testing.assert_allclose(t1.numpy(), np.asarray(js1), **TOL)
    assert np.abs(t1.numpy()).max() > 1e-3           # the block trained


# --- whole fits -----------------------------------------------------------------

@pytest.mark.parametrize("alg,hs,sampling", [
    ("skipgram", False, 0.0), ("skipgram", False, 1e-2),
    ("skipgram", True, 0.0), ("cbow", False, 0.0), ("cbow", True, 1e-2)],
    ids=["sg-ns", "sg-ns-sampled", "sg-hs", "cbow-ns", "cbow-hs-sampled"])
def test_host_fit_against_the_jax_fit(alg, hs, sampling):
    """A whole host-path fit: every block's columns (pairs or windows,
    valid counts, the flush's learning rate) bitwise, the tables within
    2e-6 and the loss within 1e-5 relative."""
    kw = {"use_hierarchic_softmax": True, "negative": 0} if hs else {}
    j, t = _w2v_pair(_cluster_corpus(300, seed=4), algorithm=alg,
                     sampling=sampling, **kw)
    jcols, tcols = record_host_blocks(j, t)
    native0 = tnative.sg_pairs_calls
    j.fit()
    t.fit()
    if alg == "skipgram":
        assert tnative.sg_pairs_calls > native0     # the native helper ran
    assert len(tcols) == len(jcols) >= 2
    for jc, tc in zip(jcols, tcols):
        assert len(jc) == len(tc)
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b, a.astype(b.dtype))
            assert b.dtype.itemsize >= a.dtype.itemsize
    # each flush's rate, computed in the producer after its words were
    # consumed: falling from below the initial rate
    rates = [float(c[-1][0]) for c in jcols]
    assert rates == sorted(rates, reverse=True)
    assert rates[0] < j.learning_rate and rates[-1] < rates[0]
    assert t.last_fit_timing["blocks"] == len(jcols)
    np.testing.assert_allclose(t.last_loss, j.last_loss, rtol=1e-5)
    for a, b in zip(_tables(t), _tables(j)):
        np.testing.assert_allclose(a, b, **TOL)
    assert t.table_device.type == "cpu"


def test_host_fit_with_a_vocabulary_past_2_15():
    """40,000 words (ids up to 39,999 travel as uint16 and are widened on
    the device): the host fit against JAX's."""
    rng = np.random.default_rng(5)
    words = np.array([f"v{i}" for i in range(40_000)])
    sents = [" ".join(row) for row in
             words[rng.permutation(40_000).reshape(-1, 10)]]
    j, t = _w2v_pair(sents, min_word_frequency=1, layer_size=4, window=2,
                     negative=2, batch_size=1024, epochs=1)
    jcols, tcols = record_host_blocks(j, t)
    j.fit()
    t.fit()
    assert len(t.vocab) == 40_000
    assert max(int(c[0].max()) for c in tcols) > 2 ** 15
    assert jcols[0][0].dtype == np.uint16
    for jc, tc in zip(jcols, tcols):
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b, a.astype(b.dtype))
    for a, b in zip(_tables(t), _tables(j)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("dm", [False, True], ids=["dbow", "dm"])
def test_pv_host_fit_against_the_jax_fit(dm):
    """ParagraphVectors' host stream (PV-DBOW with the word pairs, PV-DM
    with the label column) against JAX's: columns bitwise, tables within
    2e-6."""
    docs, labels = _cluster_docs(40, 20)
    cfg = dict(min_word_frequency=1, layer_size=12, epochs=2,
               negative_sample=5, batch_size=64, seed=3, dm=dm)

    def build(mod, txt, **extra):
        b = mod.ParagraphVectors.builder()
        for k, v in dict(cfg, **extra).items():
            getattr(b, k)(v)
        m = b.iterate(txt.LabelAwareIterator(docs, labels)).build()
        m.device_corpus = False
        return m

    j = build(jpv, jtext)
    t = build(tpv, ttext, device="cpu")
    inject_jax_bits(t)
    jcols, tcols = record_host_blocks(j, t)
    j.fit()
    t.fit()
    assert len(tcols) == len(jcols) >= 1
    for jc, tc in zip(jcols, tcols):
        for a, b in zip(jc, tc):
            np.testing.assert_array_equal(b, a.astype(b.dtype))
    if dm:
        assert tcols[0][0].shape[-1] == 2 * t.window + 1
    np.testing.assert_allclose(t.last_loss, j.last_loss, rtol=1e-5)
    for a, b in zip(_tables(t), _tables(j)):
        np.testing.assert_allclose(a, b, **TOL)


# --- the gates of tests/test_nlp.py ---------------------------------------------

def test_cbow_host_path_gate():
    """tests/test_nlp.py::test_cbow_host_path_still_available."""
    w = tw2v.Word2Vec(min_word_frequency=5, layer_size=16, negative=3,
                      algorithm="cbow", epochs=2, batch_size=128, seed=2,
                      device="cpu")
    w.device_corpus = False
    w.set_sentence_iterator(_cluster_corpus(300, sent_len=8))
    w.fit()
    assert np.isfinite(w.last_loss)
    assert w.last_fit_timing["producer_wait"] >= 0.0


def test_pv_host_fallback_gate():
    """tests/test_nlp.py::test_host_fallback_still_converges."""
    docs, labels = _cluster_docs()
    pv = (tpv.ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(10).negative_sample(5).batch_size(256).seed(3)
          .device("cpu").iterate(ttext.LabelAwareIterator(docs, labels))
          .build())
    pv.device_corpus = False
    pv.fit()
    sims = [pv.similarity("DOC_0", f"DOC_{i}") for i in range(1, 9)]
    same, diff = np.mean(sims[1::2]), np.mean(sims[0::2])
    assert same > diff + 0.3, (same, diff)


def test_skipgram_host_gate():
    """The host skip-gram learns the clusters (tests/test_nlp.py's
    skip-gram gate) through the native helper."""
    w = tw2v.Word2Vec(min_word_frequency=5, layer_size=24, epochs=3,
                      batch_size=256, seed=2, device="cpu")
    w.device_corpus = False
    w.set_sentence_iterator(_cluster_corpus(1000, sent_len=12))
    w.fit()
    same = np.mean([w.similarity("a0", f"a{i}") for i in range(1, 6)])
    diff = np.mean([w.similarity("a0", f"b{i}") for i in range(5)])
    assert same > diff + 0.4, (same, diff)


# --- the producer ---------------------------------------------------------------

def test_prefetch_iter_raises_the_producers_exception_in_the_consumer():
    def source():
        yield 1
        yield 2
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed") as e:
        for item in prefetch_iter(source(), maxsize=1):
            got.append(item)
    assert got == [1, 2]
    # the producer's frame is in the traceback
    assert any(f.name == "source" for f in
               __import__("traceback").extract_tb(e.value.__traceback__))


def test_prefetch_iter_abandoned_releases_the_producer():
    import threading

    before = threading.active_count()
    it = prefetch_iter(iter(range(10_000)), maxsize=2)
    assert next(it) == 0
    it.close()
    assert threading.active_count() <= before


def test_a_failing_producer_fails_the_fit(monkeypatch):
    """No quiet end of a fit: a native helper that cannot build (or any
    producer error) raises from fit."""
    def broken(*a, **k):
        raise RuntimeError("g++ failed for datavec_native.cpp")

    monkeypatch.setattr(tnative, "sg_pairs", broken)
    w = tw2v.Word2Vec(min_word_frequency=5, layer_size=8, batch_size=64,
                      device="cpu")
    w.device_corpus = False
    w.set_sentence_iterator(_cluster_corpus(100))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        w.fit()
