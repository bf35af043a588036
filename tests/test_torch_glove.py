"""The port's GloVe against the JAX package's, on the CPU.

Tolerances, and why:
- the co-occurrence triplets, the initial tables and the epochs' orders:
  bitwise (the same numpy code with the same generator).
- one block of 64 AdaGrad rounds from the same tables and columns, and a
  two-epoch fit's ``w + w~``: within 2^-18 of the table's largest value
  (32 float32 ulp of it; measured 4). The accumulators sum duplicate rows
  with ``index_add_`` in another order than XLA's scatter, the step divides
  by their square root, and the dot ``w_i . w~_j`` is summed in another
  order; the rounds carry each difference on.
- the learning gates of tests/test_nlp_breadth.py::TestGlove: as there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import glove as jg
from deeplearning4j_tpu_torch.nlp import glove as tg
from deeplearning4j_tpu_torch.util import glove_state_from_numpy
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


SHARE = 2.0 ** -18


def _cluster_corpus(n=1200, vocab_half=20, seed=0):
    """tests/test_nlp_breadth.py's corpus."""
    rng = np.random.default_rng(seed)
    sents = []
    for i in range(n):
        c = "a" if i % 2 == 0 else "b"
        sents.append(" ".join(
            f"{c}{j}" for j in rng.integers(0, vocab_half, 12)))
    return sents


def _zipf_corpus(n_sent=400, sent_len=12, vocab=80, seed=1):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    ids = rng.choice(vocab, size=(n_sent, sent_len), p=p)
    return [" ".join(f"w{i}" for i in row) for row in ids]


def _pair(sents, **kw):
    cfg = dict(min_word_frequency=2, layer_size=16, window=5, batch_size=128,
               seed=3, epochs=2)
    cfg.update(kw)
    j, t = jg.Glove(**cfg), tg.Glove(device="cpu", **cfg)
    for m in (j, t):
        m.set_sentence_iterator(sents)
    return j, t


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=SHARE * np.abs(want).max())


def test_co_occurrences_and_initial_tables_bitwise():
    j, t = _pair(_zipf_corpus())
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    assert t.vocab.words() == j.vocab.words()
    corpus = [np.asarray([t.vocab.index_of(w) for w in s.split()
                          if w in t.vocab], np.int32)
              for s in _zipf_corpus()]
    for a, b in zip(t.co_occurrences(corpus), j.co_occurrences(corpus)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    init = t._initial_tables(np.random.default_rng(t.seed))
    rng = np.random.default_rng(j.seed)
    V, D = len(j.vocab), j.layer_size
    want_w = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    want_wc = ((rng.random((V, D)) - 0.5) / D).astype(np.float32)
    np.testing.assert_array_equal(init[0], want_w)
    np.testing.assert_array_equal(init[1], want_wc)
    assert not init[2].any() and not init[3].any()
    assert all((a == np.float32(1e-8)).all() for a in init[4:])


def test_co_occurrence_weights():
    """tests/test_nlp_breadth.py::test_co_occurrences_weighting."""
    g = tg.Glove(min_word_frequency=1, window=2, device="cpu")
    g.set_sentence_iterator(["x y z"])
    g.build_vocab(g._token_stream())
    xi, yi, zi = (g.vocab.index_of(w) for w in ("x", "y", "z"))
    rows, cols, counts = g.co_occurrences([np.asarray([xi, yi, zi],
                                                      np.int32)])
    m = {(int(r), int(c)): float(v) for r, c, v in zip(rows, cols, counts)}
    assert m[(xi, yi)] == m[(yi, xi)] == pytest.approx(1.0)
    assert m[(xi, zi)] == m[(zi, xi)] == pytest.approx(0.5)


def test_one_block_against_the_jax_block():
    """One block of 64 rounds (duplicate rows within rounds, a masked tail)
    from the same tables and columns."""
    j, t = _pair(_zipf_corpus())
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    V, B, R = len(j.vocab), 64, j.MAX_BLOCK_ROUNDS
    rng = np.random.default_rng(9)
    tables = t._initial_tables(np.random.default_rng(3))
    i3 = rng.integers(0, V, (R, B)).astype(np.int32)
    j3 = rng.integers(0, V, (R, B)).astype(np.int32)
    counts = rng.random((R, B)).astype(np.float32) * 50 + 0.5
    lx3 = np.log(counts).astype(np.float32)
    fw3 = np.minimum(1.0, (counts / 100.0) ** 0.75).astype(np.float32)
    pm3 = np.ones((R, B), np.float32)
    pm3[-1, B // 2:] = 0.0
    out = j._make_block()(*(jnp.asarray(a) for a in tables),
                          tuple(jnp.asarray(a) for a in
                                (i3, j3, lx3, fw3, pm3)))
    tt = tuple(torch.from_numpy(a.copy()) for a in tables)
    loss = t._block(tt, *(torch.from_numpy(a) for a in
                          (i3, j3, lx3, fw3, pm3)))
    np.testing.assert_allclose(float(loss), float(out[-1]), rtol=1e-5)
    for got, want in zip(tt, out[:8]):
        _close(got.numpy(), np.asarray(want))
    assert np.abs(tt[0].numpy() - tables[0]).max() > 1e-3   # it trained


def test_two_epoch_fit_against_the_jax_fit():
    j, t = _pair(_zipf_corpus())
    j.fit()
    t.fit()
    _close(t.lookup_table.syn0, np.asarray(j.lookup_table.syn0))
    for name in ("_w", "_wc", "_bias", "_bias_c"):
        _close(getattr(t, name), np.asarray(getattr(j, name)))
    np.testing.assert_array_equal(t.lookup_table.syn0, t._w + t._wc)
    np.testing.assert_allclose(t.last_loss, j.last_loss, rtol=1e-5)
    tm = t.last_fit_timing
    assert tm["rounds"] == 64 * tm["blocks"] and tm["nnz"] > 1000
    assert t.words_per_sec > 0 and t.table_device.type == "cpu"


def test_learns_cluster_structure():
    """tests/test_nlp_breadth.py::TestGlove::test_learns_cluster_structure."""
    g = (tg.Glove.builder().min_word_frequency(3).layer_size(24)
         .window_size(8).epochs(30).learning_rate(0.05).batch_size(1024)
         .seed(1).device("cpu").iterate(_cluster_corpus()).build())
    g.fit()
    same = np.mean([g.similarity("a0", f"a{i}") for i in range(1, 6)])
    diff = np.mean([g.similarity("a0", f"b{i}") for i in range(5)])
    assert same > diff + 0.3, (same, diff)
    assert np.isfinite(g.last_loss)


def test_loss_decreases():
    """tests/test_nlp_breadth.py::TestGlove::test_loss_decreases."""
    sents = _cluster_corpus(400)

    def fit(epochs):
        g = (tg.Glove.builder().min_word_frequency(2).layer_size(16)
             .epochs(epochs).seed(3).batch_size(512).device("cpu")
             .iterate(sents).build())
        g.fit()
        return g

    g1, g30 = fit(1), fit(30)
    assert g30.last_loss < g1.last_loss * 0.8, (g1.last_loss, g30.last_loss)


def test_state_carry_over_and_queries():
    """A JAX GloVe carried in with glove_state_from_numpy answers the same
    queries."""
    j, _ = _pair(_zipf_corpus())
    j.fit()
    t = tg.Glove(layer_size=16, device="cpu")
    words = j.vocab.words()
    glove_state_from_numpy(t, words, [j.vocab.entry(w).count for w in words],
                           j._w, j._wc, j._bias, j._bias_c)
    np.testing.assert_array_equal(t.lookup_table.syn0,
                                  np.asarray(j.lookup_table.syn0))
    assert t.words_nearest("w0", 6) == j.words_nearest("w0", 6)
    assert t.similarity("w1", "w2") == j.similarity("w1", "w2")
    with pytest.raises(ValueError, match="shape"):
        glove_state_from_numpy(t, words, [1] * len(words), j._w[:2], j._wc,
                               j._bias, j._bias_c)


def test_refusals():
    with pytest.raises(ValueError, match="no corpus"):
        tg.Glove(device="cpu").fit()
    g = tg.Glove(min_word_frequency=50, device="cpu")
    g.set_sentence_iterator(["a b c"])
    with pytest.raises(ValueError, match="empty vocabulary"):
        g.fit()
