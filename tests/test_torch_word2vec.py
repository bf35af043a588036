"""The port's Word2Vec (skip-gram and CBOW, negative sampling or
hierarchical softmax, float32 or bf16 tables) against the JAX package, on
the CPU.

Corpora are made with numpy from a seed. Random draws cannot match (JAX's
threefry against ``torch.Generator``), so every function that draws takes its
draws as arguments in the port, and these tests hand it the JAX package's own
draws: the reduced windows ``b`` (``jax.random.randint`` under the block's
folded key), the subsampling uniforms and the negative pool's bits.

Tolerances, and why:
- vocabulary, unigram table, keep probabilities, initial syn0, window
  derivation, pool offsets, subsampling, skip-gram's packed pairs and
  count, the round sizes, skip-gram's per-round learning rates: bitwise
  (the same numpy code, integer and comparison work on the same inputs, or
  the same float32 operations in the same order).
- one whole block (CBOW with negative sampling or hierarchical softmax,
  skip-gram with either): 2e-6 absolute on the tables, 1e-5 relative on
  the mean loss. Each round's dot products go through different matrix
  kernels, duplicate rows are summed in another order, and XLA may fuse a
  multiply-add; the differences over a block's rounds stay at a few
  float32 ulp of the O(1) table values.
- one skip-gram block on bf16 tables: 2^-6 relative plus 2^-8 absolute,
  90% of the elements equal (see the test: one flipped bf16 rounding is an
  ulp, and the rounds carry it).
- the fits: the learning gates of tests/test_nlp.py:255-310.
- the query surface on carried-over tables: equal answers (the same numpy
  code on the same arrays).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.nlp import text as ttext
from deeplearning4j_tpu_torch.nlp import vocab as tvocab
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.ops import embeddings as temb
from deeplearning4j_tpu_torch.util import word2vec_state_from_numpy


def _cluster_corpus(n_sent=1500, sent_len=12, seed=0):
    """tests/test_nlp.py's corpus: each sentence draws from one of two
    disjoint 50-word clusters."""
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=sent_len))
            for _ in range(n_sent)]


def _zipf_corpus(n_sent=300, sent_len=10, vocab=60, seed=1):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    ids = rng.choice(vocab, size=(n_sent, sent_len), p=p)
    return [" ".join(f"w{i}" for i in row) for row in ids]


def _mean_sim(model, pairs):
    return float(np.mean([model.similarity(a, b) for a, b in pairs]))


def _pair(sents, **kw):
    """The JAX model and the port's on the CPU, same configuration and
    corpus."""
    cfg = dict(min_word_frequency=5, layer_size=16, window=3, negative=5,
               algorithm="cbow", batch_size=24, seed=7)
    cfg.update(kw)
    j = jw2v.Word2Vec(**cfg)
    t = tw2v.Word2Vec(device="cpu", **cfg)
    j.set_sentence_iterator(sents)
    t.set_sentence_iterator(sents)
    return j, t


# --- host side: text, vocabulary, tables --------------------------------------

def test_tokenizers_match():
    s = "Hello, World! 42 (test) foo"
    for pre in (None, "common", "lower"):
        jf, tf = jtext.DefaultTokenizerFactory(), ttext.DefaultTokenizerFactory()
        if pre == "common":
            jf.set_token_pre_processor(jtext.CommonPreprocessor())
            tf.set_token_pre_processor(ttext.CommonPreprocessor())
        elif pre == "lower":
            jf.set_token_pre_processor(jtext.LowCasePreProcessor())
            tf.set_token_pre_processor(ttext.LowCasePreProcessor())
        assert jf.create(s).get_tokens() == tf.create(s).get_tokens()


def test_line_sentence_iterator(tmp_path):
    p = tmp_path / "c.txt"
    p.write_text("a b c\n\n  d e  \n")
    assert list(ttext.LineSentenceIterator(p)) == \
        list(jtext.LineSentenceIterator(p)) == ["a b c", "d e"]


@pytest.mark.parametrize("corpus", ["cluster", "zipf"])
def test_vocab_tables_and_init_bitwise(corpus):
    sents = _cluster_corpus(300) if corpus == "cluster" else _zipf_corpus()
    j, t = _pair(sents, special_tokens=("LBL",), sampling=1e-3)
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    assert t.vocab.words() == j.vocab.words()
    assert t.vocab.words()[0] == "LBL"
    np.testing.assert_array_equal(t.vocab.counts(), j.vocab.counts())
    assert t.vocab.total_word_count == j.vocab.total_word_count
    np.testing.assert_array_equal(tvocab.unigram_int_table(t.vocab),
                                  jvocab.unigram_int_table(j.vocab))
    np.testing.assert_array_equal(tvocab.unigram_table(t.vocab),
                                  jvocab.unigram_table(j.vocab))
    np.testing.assert_array_equal(tvocab.subsample_keep_probs(t.vocab, 1e-3),
                                  jvocab.subsample_keep_probs(j.vocab, 1e-3))
    np.testing.assert_array_equal(t.lookup_table.syn0, j.lookup_table.syn0)
    np.testing.assert_array_equal(t.lookup_table.syn1neg,
                                  j.lookup_table.syn1neg)
    enc_t = t._encode_corpus(t._token_stream())
    enc_j = j._encode_corpus(j._token_stream())
    assert len(enc_t) == len(enc_j)
    assert all(np.array_equal(a, b) for a, b in zip(enc_t, enc_j))
    assert t._cbow_centers == j._cbow_centers


def test_huffman_matches():
    stream = [[w for w, c in [("a", 40), ("b", 20), ("c", 10), ("d", 5),
                              ("e", 2)] for _ in range(c)]]
    jc = jvocab.VocabConstructor(1).build(iter(stream))
    tc = tvocab.VocabConstructor(1).build(iter(stream))
    jvocab.build_huffman(jc)
    tvocab.build_huffman(tc)
    for a, b in zip(jvocab.huffman_arrays(jc), tvocab.huffman_arrays(tc)):
        np.testing.assert_array_equal(a, b)


# --- device-side pieces, JAX's draws injected ------------------------------------

def _buffers(flat, lens, W, extra):
    """The windowed path's corpus buffers: [W pads][stream][pads]."""
    n = flat.size
    buf = n + extra + 2 * W
    ids = np.zeros(buf, np.uint16)
    ids[W:W + n] = flat
    sent = np.full(buf, 65535, np.uint16)
    sent[W:W + n] = np.repeat(np.arange(len(lens)), lens) % 65535
    return ids, sent


def test_derive_windows_with_injected_b():
    rng = np.random.default_rng(3)
    lens = rng.integers(1, 9, size=40)
    flat = rng.integers(0, 50, size=int(lens.sum()))
    W, S, p0 = 4, 96, 17
    ids, sent = _buffers(flat, lens, W, S)
    n_valid = p0 + 70                       # the tail of the span is dead
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    want = jw2v._derive_windows(jnp.asarray(ids), jnp.asarray(sent),
                                np.int32(n_valid), np.int32(p0), S, W, key)
    b = np.array(jax.random.randint(key, (S,), 1, W + 1))
    got = tw2v._derive_windows(torch.from_numpy(ids.astype(np.int32)),
                               torch.from_numpy(sent.astype(np.int32)),
                               n_valid, p0, S, W, torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3].sum() == n_valid - p0 and got[2].any() and not got[2].all()


def test_pool_negs_including_a_uint32_wrap():
    rng = np.random.default_rng(4)
    V, B, K = 37, 16, 3
    pool = rng.integers(0, V, size=1000).astype(np.int32)
    pos = rng.integers(0, V, size=B).astype(np.int32)
    pos[:4] = pool[:4]                      # force a few collisions
    # blk_id * 131 + r passes 2**32: g wraps before the multiply
    wrap = (2 ** 32 - 5) // 131 + 1
    for blk_id, r in ((0, 0), (3, 17), (wrap, 40), (2 ** 31 - 1, 63)):
        want = jw2v._pool_negs(jnp.asarray(pool), np.int32(blk_id),
                               jnp.int32(r), B, K, V, jnp.asarray(pos))
        got = tw2v._pool_negs(torch.from_numpy(pool), blk_id, r, B, K, V,
                              torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (wrap * 131) >= 2 ** 32


def test_subsample_compaction_with_injected_uniforms():
    j, t = _pair(_zipf_corpus(200), sampling=1e-2)
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    corpus = j._encode_corpus(j._token_stream())
    flat = np.concatenate(corpus)
    lens = np.array([c.size for c in corpus])
    W = j.window
    ids, sent = _buffers(flat, lens, W, 50)
    keep = jvocab.subsample_keep_probs(j.vocab, j.sampling)
    key = jax.random.PRNGKey(11)
    want = j._subsample_fn()(jnp.asarray(ids), jnp.asarray(sent),
                             jnp.asarray(keep.astype(np.float32)),
                             np.int32(flat.size), key)
    u = np.array(jax.random.uniform(key, (ids.size,)))
    got = tw2v._subsample(torch.from_numpy(ids.astype(np.int32)),
                          torch.from_numpy(sent.astype(np.int32)),
                          torch.from_numpy(keep.astype(np.float32)),
                          flat.size, torch.from_numpy(u), W)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert 0 < int(got[2]) < flat.size      # some dropped, some kept


def test_negpool_from_jax_bits():
    j, t = _pair(_zipf_corpus(200))
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    ntable = jvocab.unigram_int_table(j.vocab)
    want = np.asarray(j._build_negpool(jnp.asarray(ntable), 8))
    kp = jax.random.PRNGKey((j.seed ^ 0x5DEECE66) & 0x7FFFFFFF)
    bits = np.array(jax.random.bits(kp, (j.NEG_POOL_SIZE,), jnp.uint32))
    got = tw2v.negpool_from_bits(torch.from_numpy(ntable),
                                 torch.from_numpy(bits.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's own pool: the same size, drawn from the same table
    own = t._negpool()
    assert own.shape == got.shape and own.dtype == torch.int32
    assert set(np.unique(own.numpy())) <= set(np.unique(ntable))


def test_lr_schedule_is_the_jax_interpolation():
    """Every round's rate: lr_at() at the span's ends, then
    lr0 + (lr1 - lr0) * r / R in float32, as the JAX block computes it."""
    sched = tw2v.interpolate_rates(tw2v.lr_endpoints(
        0.025, 1e-4, 2, 1, 1000, 300, 900.0, 1200, 2400), 64)
    assert sched.shape == (8, 64) and sched.dtype == np.float32
    r = jnp.arange(64, dtype=jnp.int32)
    for blk, p0 in enumerate(list(range(0, 1000, 300)) * 2):
        seen = 0 if blk < 4 else 1200
        lr0 = np.float32(max(0.025 * (1 - min((seen + p0 / 900 * 1200)
                                               / 2400, 1.0)), 1e-4))
        lr1 = np.float32(max(0.025 * (1 - min(
            (seen + min(p0 + 300, 1000) / 900 * 1200) / 2400, 1.0)), 1e-4))
        want = jnp.float32(lr0) + (jnp.float32(lr1) - jnp.float32(lr0)) \
            * r.astype(jnp.float32) / 64
        np.testing.assert_array_equal(sched[blk], np.asarray(want))
    assert sched[0, 0] == np.float32(0.025) and sched[-1, -1] >= 1e-4


def test_one_block_against_the_jax_block():
    """One 64-round CBOW block of ``_make_cbow_window_block`` against the
    port's ``_cbow_block`` from the same tables, with JAX's reduced windows
    and negative pool."""
    sents = _cluster_corpus(200, sent_len=8, seed=3)
    j, t = _pair(sents)
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    corpus = j._encode_corpus(j._token_stream())
    flat = np.concatenate(corpus)
    lens = np.array([c.size for c in corpus])
    W, R, B_C = j.window, j.MAX_BLOCK_ROUNDS, j._cbow_centers
    S = B_C * R
    assert S <= flat.size                   # every round trains examples
    ids, sent = _buffers(flat, lens, W, S)
    ntable = jnp.asarray(jvocab.unigram_int_table(j.vocab))
    block = j._make_cbow_window_block(ntable_dev=ntable)
    negpool = np.array(j._win_negpool)
    lr0, lr1, blk_id, p0 = np.float32(0.025), np.float32(0.02), 3, 0
    base = jax.random.PRNGKey(j.seed)
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0), jnp.asarray(j.lookup_table.syn1neg),
        jnp.asarray(ids), jnp.asarray(sent), np.int32(flat.size),
        jnp.asarray(negpool), np.int32(p0), (lr0, lr1), base,
        np.int32(blk_id))
    b = np.array(jax.random.randint(jax.random.fold_in(base, blk_id), (S,),
                                    1, W + 1))
    lrs = lr0 + (lr1 - lr0) * np.arange(R, dtype=np.float32) / np.float32(R)
    t0 = torch.from_numpy(t.lookup_table.syn0.copy())
    t1 = torch.from_numpy(t.lookup_table.syn1neg.copy())
    prof = OpProfiler.get()
    rounds = prof.counter_value("nlp/w2v_rounds")
    tloss, tn = t._cbow_block(
        t0, t1, torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sent.astype(np.int32)), flat.size,
        torch.from_numpy(negpool), p0, torch.from_numpy(lrs),
        torch.from_numpy(b), blk_id)
    assert prof.counter_value("nlp/w2v_rounds") == rounds + R
    assert float(tn) == float(jn) > 0.9 * S
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=0, atol=2e-6)
    assert np.abs(t1.numpy()).max() > 1e-3  # the block trained


# --- the entry points ------------------------------------------------------------

def test_cpu_fit_learns_cluster_structure():
    """tests/test_nlp.py::test_cbow_learns's configuration and gate."""
    w = tw2v.Word2Vec(min_word_frequency=5, layer_size=24, negative=5,
                      algorithm="cbow", epochs=10, batch_size=256, seed=2,
                      device="cpu")
    w.set_sentence_iterator(_cluster_corpus(1000))
    prof = OpProfiler.get()
    blocks = prof.counter_value("nlp/w2v_blocks")
    launches = temb.embedding_bag_launches
    w.fit()
    same = _mean_sim(w, [("a0", f"a{i}") for i in range(1, 6)])
    diff = _mean_sim(w, [("a0", f"b{i}") for i in range(5)])
    assert same > diff + 0.4, (same, diff)
    near = w.words_nearest("a0", 10)
    assert sum(n.startswith("a") for n in near) >= 8
    assert w.words_per_sec > 0 and np.isfinite(w.last_loss)
    assert w.last_fit_timing["blocks"] == 10
    assert prof.counter_value("nlp/w2v_blocks") == blocks + 10
    assert temb.embedding_bag_launches == launches   # CPU: the plain version
    assert w.table_device.type == "cpu"
    assert w.lookup_table.syn0.dtype == np.float32


def test_builder_subsampling_and_resume():
    sents = _cluster_corpus(400)
    w = (tw2v.Word2Vec.builder().min_word_frequency(5).layer_size(16)
         .seed(3).window_size(3).negative_sample(4).epochs(2)
         .batch_size(128).sampling(1e-2).elements_learning_algorithm("CBOW")
         .device("cpu").iterate(sents).build())
    assert w.algorithm == "cbow" and w.window == 3 and w.negative == 4
    w.fit()
    vocab, first = w.vocab, w.lookup_table.syn0.copy()
    assert np.isfinite(w.last_loss) and w.pairs_per_sec > 0
    w.fit()                                 # resumes: same vocabulary
    assert w.vocab is vocab
    assert not np.array_equal(first, w.lookup_table.syn0)
    # a second model from the same seed trains the same tables on the CPU
    w2 = (tw2v.Word2Vec.builder().min_word_frequency(5).layer_size(16)
          .seed(3).window_size(3).negative_sample(4).epochs(2)
          .batch_size(128).sampling(1e-2).elements_learning_algorithm("CBOW")
          .device("cpu").iterate(sents).build())
    w2.fit()
    np.testing.assert_array_equal(w2.lookup_table.syn0, first)


def test_state_carry_over_and_query_surface():
    """A JAX model's vocabulary and tables carried into the port answer
    every query the same, and a port fit resumes from them."""
    sents = _cluster_corpus(300)
    j = jw2v.Word2Vec(min_word_frequency=5, layer_size=16, negative=5,
                      algorithm="cbow", epochs=2, batch_size=128, seed=4)
    j.set_sentence_iterator(sents)
    j.fit()
    t = tw2v.Word2Vec(layer_size=16, negative=5, algorithm="cbow",
                      epochs=1, batch_size=128, seed=4, device="cpu")
    out = word2vec_state_from_numpy(t, j.vocab.words(), j.vocab.counts(),
                                    np.asarray(j.lookup_table.syn0),
                                    np.asarray(j.lookup_table.syn1neg))
    assert out is t and t.vocab.words() == j.vocab.words()
    np.testing.assert_array_equal(t.get_word_vector_matrix(),
                                  j.get_word_vector_matrix())
    for a, b in (("a0", "a1"), ("a0", "b3"), ("b2", "b7")):
        assert t.similarity(a, b) == j.similarity(a, b)
    assert t.words_nearest("a0", 7) == j.words_nearest("a0", 7)
    vec = j.get_word_vector("a3") - j.get_word_vector("b1")
    assert t.words_nearest(vec, 5) == j.words_nearest(vec, 5)
    qs = [("a0", "a1", "b0", "b1"), ("a2", "a3", "a4", "a5"),
          ("a0", "zz", "a1", "a2")]
    assert t.accuracy(qs) == j.accuracy(qs)
    with pytest.raises(KeyError):
        t.get_word_vector("zz")
    t.set_sentence_iterator(sents)
    t.fit()                                 # resumes from the carried tables
    assert t.vocab.words() == j.vocab.words()
    assert not np.array_equal(t.lookup_table.syn0,
                              np.asarray(j.lookup_table.syn0))


def test_state_carry_over_refuses_mismatches():
    t = tw2v.Word2Vec(layer_size=4, algorithm="cbow", device="cpu")
    syn = np.zeros((2, 4), np.float32)
    with pytest.raises(ValueError, match="repeat"):
        word2vec_state_from_numpy(t, ["a", "a"], [1, 1], syn, syn)
    with pytest.raises(ValueError, match="counts"):
        word2vec_state_from_numpy(t, ["a", "b"], [1], syn, syn)
    with pytest.raises(ValueError, match="shape"):
        word2vec_state_from_numpy(t, ["a", "b"], [1, 1], syn[:, :3], syn)
    with pytest.raises(ValueError, match="dtype"):
        word2vec_state_from_numpy(t, ["a", "b"], [1, 1], syn,
                                  syn.astype(np.float64))


@pytest.mark.parametrize("make,exc,match", [
    (lambda: tw2v.Word2Vec(device="cpu", mesh=object()),
     NotImplementedError, "mesh"),
    (lambda: tw2v.Word2Vec(algorithm="cbow", device="cpu", mesh=object()),
     NotImplementedError, "mesh"),
    (lambda: tw2v.Word2Vec(device="cpu", use_hierarchic_softmax=True,
                           negative=3), ValueError, "negative=0"),
], ids=["skipgram-mesh", "cbow-mesh", "hs-with-negative-3"])
def test_unported_configurations_raise(make, exc, match):
    """What stays unported (sharded tables) is refused by name, pointing at
    ROADMAP; HS with negatives other than the default 5 is refused as the
    JAX package refuses it. (The host pair path is ported:
    tests/test_torch_word2vec_host.py.)"""
    with pytest.raises(exc, match=match) as e:
        make()
    if exc is NotImplementedError:
        assert "ROADMAP" in str(e.value)


def test_host_pair_path_and_bad_configurations_raise():
    """The host pair path trains (no longer refused); bad configurations
    raise as in the JAX package."""
    w = tw2v.Word2Vec(algorithm="cbow", device="cpu")
    w.device_corpus = False
    w.set_sentence_iterator(_cluster_corpus(50))
    w.fit()
    assert np.isfinite(w.last_loss) and w.last_fit_timing["blocks"] >= 1
    with pytest.raises(ValueError, match="unknown algorithm"):
        tw2v.Word2Vec(algorithm="glove", device="cpu")
    with pytest.raises(ValueError, match="negative"):
        tw2v.Word2Vec(algorithm="cbow", negative=0, device="cpu")
    with pytest.raises(ValueError, match="table_dtype"):
        tw2v.Word2Vec(algorithm="cbow", table_dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="no corpus"):
        tw2v.Word2Vec(algorithm="cbow", device="cpu").fit()
    w = tw2v.Word2Vec(algorithm="cbow", min_word_frequency=50, device="cpu")
    w.set_sentence_iterator(["a b c"])
    with pytest.raises(ValueError, match="empty vocabulary"):
        w.fit()


# --- skip-gram, hierarchical softmax, bf16 tables -----------------------------

def _prepared(sents, **kw):
    """Both models with their vocabulary built, the encoded corpus, its
    buffers (with room for one skip-gram span) and the stream length."""
    j, t = _pair(sents, **kw)
    j.build_vocab(j._token_stream())
    t.build_vocab(t._token_stream())
    corpus = j._encode_corpus(j._token_stream())
    flat = np.concatenate(corpus)
    lens = np.array([c.size for c in corpus])
    span = (j._cbow_centers * j.MAX_BLOCK_ROUNDS
            if j.algorithm == "cbow" else j._window_span)
    ids, sent = _buffers(flat, lens, j.window, span)
    return j, t, flat, ids, sent


def _b_of(base, blk_id, S, W):
    """The reduced windows the JAX block draws for block ``blk_id``."""
    return np.array(jax.random.randint(jax.random.fold_in(base, blk_id),
                                       (S,), 1, W + 1))


@pytest.mark.parametrize("tail", [False, True])
def test_pack_span_bitwise(tail):
    """The order-preserving compaction of a span's pairs: the packed
    centers, contexts and the count, bitwise, with the JAX draws of b; with
    ``tail`` the span runs past the stream's end."""
    rng = np.random.default_rng(21)
    lens = rng.integers(1, 12, size=60)
    flat = rng.integers(0, 40, size=int(lens.sum()))
    W, S = 3, 120
    C = -(-(S * 2 * W) // 50) * 50
    ids, sent = _buffers(flat, lens, W, S)
    p0 = flat.size - 40 if tail else 7
    key = jax.random.PRNGKey(9)
    want = jw2v._pack_span(jnp.asarray(ids), jnp.asarray(sent),
                           np.int32(flat.size), np.int32(p0), S, W, C, key)
    b = np.array(jax.random.randint(key, (S,), 1, W + 1))
    got = tw2v._pack_span(torch.from_numpy(ids.astype(np.int32)),
                          torch.from_numpy(sent.astype(np.int32)), flat.size,
                          p0, S, W, C, torch.from_numpy(b))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) > 0
    assert got[2].dtype == torch.int32 and int(got[2]) < S * 2 * W


def test_round_sizes_match_the_jax_package():
    """B, S and C of the skip-gram block, the CBOW round with its HS cap and
    the HS round cap, at bench.py's configuration (a 10,000-word
    vocabulary) and on a tiny one."""
    vocab = jvocab.VocabConstructor(1).build(
        [[f"w{i}" for i in range(10_000)]])
    for kw in ({}, {"use_hierarchic_softmax": True, "negative": 0},
               {"algorithm": "cbow"},
               {"algorithm": "cbow", "use_hierarchic_softmax": True}):
        j = jw2v.Word2Vec(window=5, batch_size=8192, **kw)
        t = tw2v.Word2Vec(window=5, batch_size=8192, device="cpu", **kw)
        j.vocab = t.vocab = vocab
        assert t._round_pairs == j._round_pairs
        assert t._window_span == j._window_span
        assert t._cbow_centers == j._cbow_centers
        assert t.negative == j.negative
    t = tw2v.Word2Vec(window=5, batch_size=8192, device="cpu")
    t.vocab = vocab
    assert (t._round_pairs, t._window_span, t._pack_capacity) == \
        (8190, 87360, 876330)
    assert t._pack_capacity // t._round_pairs == 107
    t.vocab = jvocab.VocabConstructor(1).build([["a", "b", "c"]])
    assert t._round_pairs == 24 and t._cbow_centers == 24


def test_skipgram_round_rates_are_the_jax_block_rates():
    """The host's float32 rates equal the JAX block's expression, bit for
    bit, for counts that do and do not fill the last round."""
    rate = jax.jit(lambda lr0, lr1, r, B, count: lr0 + (lr1 - lr0) * (
        r * B).astype(jnp.float32) / jnp.maximum(
        count.astype(jnp.float32), 1.0))
    for lr0, lr1, B, count in ((0.025, 0.0243, 8190, 434_177),
                               (0.0125, 0.0117, 128, 5_000),
                               (0.02, 0.019, 50, 1), (0.02, 0.019, 50, 0)):
        got = tw2v.sg_round_rates(np.float32(lr0), np.float32(lr1), B, count)
        assert got.shape == (-(-count // B),) and got.dtype == np.float32
        want = [float(rate(np.float32(lr0), np.float32(lr1), np.int32(r),
                           np.int32(B), np.int32(count)))
                for r in range(got.size)]
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def _jax_hs_dev(j):
    codes, points, mask = jvocab.huffman_arrays(j.vocab)
    return tuple(jnp.asarray(a) for a in (points, codes, mask))


@pytest.mark.parametrize("hs", [False, True], ids=["ns", "hs"])
def test_one_skipgram_block_against_the_jax_block(hs):
    """One skip-gram block of ``_make_window_block`` against the port's
    ``_sg_pack`` + ``_sg_block`` from the same tables, with JAX's reduced
    windows and negative pool: the same count and rounds; the loss within
    1e-5 relative; the tables within 2e-6, as the CBOW block (the dots go
    through different matrix kernels and XLA may fuse a multiply-add, a
    few float32 ulp of the O(1) values over the block's rounds)."""
    kw = ({"use_hierarchic_softmax": True, "negative": 0} if hs else {})
    j, t, flat, ids, sent = _prepared(_cluster_corpus(300, sent_len=10,
                                                      seed=5),
                                      algorithm="skipgram", batch_size=60,
                                      **kw)
    W, S, B = j.window, j._window_span, j._round_pairs
    assert (t._window_span, t._round_pairs) == (S, B)
    ntable = jnp.asarray(jvocab.unigram_int_table(j.vocab))
    block = j._make_window_block(hs_dev=_jax_hs_dev(j) if hs else None,
                                 ntable_dev=None if hs else ntable)
    negpool = np.array(j._win_negpool)
    syn1_np = j.lookup_table.syn1 if hs else j.lookup_table.syn1neg
    lr0, lr1, blk_id, p0 = np.float32(0.025), np.float32(0.021), 2, 11
    base = jax.random.PRNGKey(j.seed)
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0), jnp.asarray(syn1_np),
        jnp.asarray(ids), jnp.asarray(sent), np.int32(flat.size),
        jnp.asarray(negpool), np.int32(p0), (lr0, lr1), base,
        np.int32(blk_id))
    t0 = torch.from_numpy(t.lookup_table.syn0.copy())
    t1 = torch.from_numpy((t.lookup_table.syn1 if hs
                           else t.lookup_table.syn1neg).copy())
    prof = OpProfiler.get()
    rounds = prof.counter_value("nlp/w2v_rounds")
    packed_c, packed_x, pending = t._sg_pack(
        torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sent.astype(np.int32)), flat.size, p0,
        torch.from_numpy(_b_of(base, blk_id, S, W)))
    count = pending.get()
    tloss, tn = t._sg_block(t0, t1, packed_c, packed_x, count,
                            None if hs else torch.from_numpy(negpool),
                            lr0, lr1, blk_id)
    assert count == tn == float(jn) and count > 40 * B
    assert prof.counter_value("nlp/w2v_rounds") == rounds + -(-count // B)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=0, atol=2e-6)
    assert np.abs(t1.numpy()).max() > 1e-3


def test_one_cbow_hs_block_against_the_jax_block():
    """One 64-round CBOW block with hierarchical softmax
    (``_make_cbow_window_block`` with the Huffman tables) against the
    port's, with JAX's reduced windows: as the NS block, 2e-6 on the
    tables and 1e-5 relative on the loss."""
    j, t, flat, ids, sent = _prepared(
        _cluster_corpus(300, sent_len=8, seed=6), algorithm="cbow",
        use_hierarchic_softmax=True, negative=0, batch_size=24)
    W, R, B_C = j.window, j.MAX_BLOCK_ROUNDS, j._cbow_centers
    S = B_C * R
    assert S <= flat.size and t._cbow_centers == B_C
    block = j._make_cbow_window_block(hs_dev=_jax_hs_dev(j))
    lr0, lr1, blk_id, p0 = np.float32(0.025), np.float32(0.02), 1, 0
    base = jax.random.PRNGKey(j.seed)
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0), jnp.asarray(j.lookup_table.syn1),
        jnp.asarray(ids), jnp.asarray(sent), np.int32(flat.size),
        jnp.asarray(j._win_negpool), np.int32(p0), (lr0, lr1), base,
        np.int32(blk_id))
    lrs = lr0 + (lr1 - lr0) * np.arange(R, dtype=np.float32) / np.float32(R)
    t0 = torch.from_numpy(t.lookup_table.syn0.copy())
    t1 = torch.from_numpy(t.lookup_table.syn1.copy())
    assert t.lookup_table.syn1neg is None
    tloss, tn = t._cbow_block(
        t0, t1, torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sent.astype(np.int32)), flat.size, None, p0,
        torch.from_numpy(lrs), torch.from_numpy(_b_of(base, blk_id, S, W)),
        blk_id)
    assert float(tn) == float(jn) > 0.9 * S
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=0, atol=2e-6)


def test_one_bf16_skipgram_block_against_the_jax_block():
    """The skip-gram block on bf16 tables. The bf16 dot rounds once after
    sums taken in different orders and the bf16 scatter-add rounds every
    addition, so one flipped rounding moves an element by a bf16 ulp and
    the rounds carry it on: the tables within 2^-6 of their magnitude
    (2 bf16 ulp) plus 2^-8, and at least 90% of the elements equal; the
    count exact, the loss within 1e-2 relative."""
    j, t, flat, ids, sent = _prepared(_cluster_corpus(300, sent_len=10,
                                                      seed=7),
                                      algorithm="skipgram", batch_size=60,
                                      table_dtype="bfloat16")
    W, S = j.window, j._window_span
    block = j._make_window_block(ntable_dev=jnp.asarray(
        jvocab.unigram_int_table(j.vocab)))
    negpool = np.array(j._win_negpool)
    lr0, lr1, blk_id, p0 = np.float32(0.025), np.float32(0.021), 0, 0
    base = jax.random.PRNGKey(j.seed)
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0, jnp.bfloat16),
        jnp.asarray(j.lookup_table.syn1neg, jnp.bfloat16),
        jnp.asarray(ids), jnp.asarray(sent), np.int32(flat.size),
        jnp.asarray(negpool), np.int32(p0), (lr0, lr1), base,
        np.int32(blk_id))
    t0, t1 = t._tables_to_device()
    assert t0.dtype == t1.dtype == torch.bfloat16
    packed_c, packed_x, pending = t._sg_pack(
        torch.from_numpy(ids.astype(np.int32)),
        torch.from_numpy(sent.astype(np.int32)), flat.size, p0,
        torch.from_numpy(_b_of(base, blk_id, S, W)))
    count = pending.get()
    tloss, _ = t._sg_block(t0, t1, packed_c, packed_x, count,
                           torch.from_numpy(negpool), lr0, lr1, blk_id)
    assert count == float(jn)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)
    for got, want in ((t0, s0), (t1, s1)):
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(g, w, rtol=2 ** -6, atol=2 ** -8)
        assert np.mean(g == w) > 0.9


def _gates(w, margin):
    same = _mean_sim(w, [("a0", f"a{i}") for i in range(1, 6)])
    diff = _mean_sim(w, [("a0", f"b{i}") for i in range(5)])
    assert same > diff + margin, (same, diff)
    return same, diff


@pytest.mark.parametrize("cfg,sents,margin,near", [
    # tests/test_nlp.py::test_skipgram_ns_learns_cluster_structure
    (dict(layer_size=32, seed=42, window=3, negative=5, epochs=3,
          batch_size=256), 1500, 0.4, True),
    # ::test_skipgram_bfloat16_tables_learn
    (dict(layer_size=32, seed=42, window=3, negative=5, epochs=3,
          batch_size=256, table_dtype="bfloat16"), 1500, 0.3, False),
    # ::test_hierarchical_softmax_learns
    (dict(layer_size=24, negative=0, use_hierarchic_softmax=True, epochs=3,
          batch_size=256, seed=1), 1000, 0.4, False),
    # ::test_cbow_hierarchical_softmax_learns
    (dict(layer_size=24, negative=0, use_hierarchic_softmax=True,
          algorithm="cbow", epochs=8, batch_size=256, seed=6), 1000, 0.3,
     False),
    # the CBOW configuration of ::test_cbow_learns on bf16 tables, gated at
    # the bf16 test's margin
    (dict(layer_size=24, negative=5, algorithm="cbow", epochs=10,
          batch_size=256, seed=2, table_dtype="bfloat16"), 1000, 0.3, False),
], ids=["skipgram-ns", "skipgram-bf16", "skipgram-hs", "cbow-hs",
        "cbow-bf16"])
def test_cpu_fits_learn_cluster_structure(cfg, sents, margin, near):
    """The learning gates of tests/test_nlp.py:255-310 on the port's CPU
    fits: skip-gram's rounds count equals the sum of ceil(count / B) over
    its blocks, no bag kernel launches on the CPU, tables stored back as
    float32."""
    w = tw2v.Word2Vec(min_word_frequency=5, device="cpu", **cfg)
    w.set_sentence_iterator(_cluster_corpus(sents))
    counts = []
    sg_block = w._sg_block

    def recording(*a, **k):
        counts.append(a[4])
        return sg_block(*a, **k)

    w._sg_block = recording
    prof = OpProfiler.get()
    rounds = prof.counter_value("nlp/w2v_rounds")
    launches = temb.embedding_bag_launches
    w.fit()
    _gates(w, margin)
    if near:
        assert sum(n.startswith("a")
                   for n in w.words_nearest("a0", 10)) >= 8
    done = prof.counter_value("nlp/w2v_rounds") - rounds
    if w.algorithm == "skipgram":
        B = w._round_pairs
        assert done == sum(-(-c // B) for c in counts) > 0
        assert len(counts) == w.last_fit_timing["blocks"] \
            == w.last_fit_timing["readbacks"]
    else:
        assert done == 64 * w.last_fit_timing["blocks"] and not counts
    assert temb.embedding_bag_launches == launches
    assert w.lookup_table.syn0.dtype == np.float32
    assert (w.lookup_table.syn1 is not None) == w.use_hs
    assert (w.lookup_table.syn1neg is not None) == (not w.use_hs)
    assert np.isfinite(w.last_loss) and w.last_loss < w.first_loss


def test_skipgram_default_resumes_and_reuses_device_state():
    """``Word2Vec()``'s default algorithm is skip-gram with negative
    sampling; a second fit resumes from the tables and reuses the corpus
    buffers and the negative pool."""
    w = tw2v.Word2Vec(min_word_frequency=5, layer_size=16, window=3,
                      batch_size=128, sampling=1e-2, seed=3, device="cpu")
    assert w.algorithm == "skipgram" and w.negative == 5 and not w.use_hs
    w.set_sentence_iterator(_cluster_corpus(300))
    w.fit()
    first = w.lookup_table.syn0.copy()
    pool, corpus = w._negpool_cache[1], w._corpus_dev_cache[1]
    w.fit()
    assert w._negpool_cache[1] is pool and w._corpus_dev_cache[1] is corpus
    assert not np.array_equal(first, w.lookup_table.syn0)
    assert np.isfinite(w.lookup_table.syn0).all()


def test_hs_state_carry_over_and_resume():
    """A JAX-trained hierarchical-softmax model (syn1, no syn1neg) carried
    into the port answers the same queries and resumes training there."""
    sents = _cluster_corpus(300)
    j = jw2v.Word2Vec(min_word_frequency=5, layer_size=16, negative=0,
                      use_hierarchic_softmax=True, epochs=1, batch_size=128,
                      seed=4)
    j.set_sentence_iterator(sents)
    j.fit()
    assert j.lookup_table.syn1neg is None
    t = tw2v.Word2Vec(layer_size=16, use_hierarchic_softmax=True, epochs=1,
                      batch_size=128, seed=4, device="cpu")
    with pytest.raises(ValueError, match="syn1"):
        word2vec_state_from_numpy(t, j.vocab.words(), j.vocab.counts(),
                                  np.asarray(j.lookup_table.syn0))
    word2vec_state_from_numpy(t, j.vocab.words(), j.vocab.counts(),
                              np.asarray(j.lookup_table.syn0),
                              syn1=np.asarray(j.lookup_table.syn1))
    assert t.lookup_table.syn1neg is None
    for x, y in zip(jvocab.huffman_arrays(j.vocab),
                    tvocab.huffman_arrays(t.vocab)):
        np.testing.assert_array_equal(x, y)
    assert t.words_nearest("a0", 7) == j.words_nearest("a0", 7)
    t.set_sentence_iterator(sents)
    t.fit()
    assert not np.array_equal(t.lookup_table.syn1,
                              np.asarray(j.lookup_table.syn1))
    assert np.isfinite(t.lookup_table.syn1).all()


def test_nlp_refuses_the_unported_models_by_name():
    """Every NLP name of the JAX package imports from the port now; only
    sharded tables (``mesh=``) are refused, by name."""
    import deeplearning4j_tpu.nlp as jnlp
    import deeplearning4j_tpu_torch.nlp as tnlp

    for name in ("FastText", "Glove", "DeepWalk", "Node2Vec", "Graph",
                 "random_walks", "char_ngrams", "fasttext_hash",
                 "read_word2vec_model", "write_word2vec_model",
                 "read_word_vectors", "write_word_vectors",
                 "read_paragraph_vectors", "write_paragraph_vectors"):
        assert name in jnlp.__all__ and name in tnlp.__all__
        assert callable(getattr(tnlp, name))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tnlp.Word2Vec(device="cpu", mesh=object())
    with pytest.raises(AttributeError):
        tnlp.NoSuchThing
