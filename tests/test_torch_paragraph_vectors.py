"""The port's ParagraphVectors (PV-DBOW and PV-DM on the device-windowed
path) against the JAX package, on the CPU.

Documents are made with numpy from a seed. Random draws cannot match (JAX's
threefry against ``torch.Generator``), so the port takes its draws as
arguments and these tests hand it the JAX package's: the reduced windows
``b``, the subsampling uniforms, DBOW's pair order and the negative pool.

Tolerances, and why:
- vocabulary, label ids, corpus buffers, subsampling with the label stream,
  DBOW's pair order: bitwise (the same numpy code, or integer and
  comparison work on the same inputs).
- one 64-round DBOW or DM block: 2e-6 absolute on the tables, 1e-5
  relative on the loss, as the Word2Vec blocks (the dots go through
  different matrix kernels and duplicate rows are summed in another order,
  a few float32 ulp of the O(1) values over the rounds).
- ``infer_vector`` on the same tables: 1e-6 absolute (values of about
  1e-2): both take the same negatives from the same numpy stream, and the
  gradient steps differ only in float32 rounding.
- the fits: the learning gates of tests/test_nlp.py:426-460.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import vocab as jvocab
from deeplearning4j_tpu.nlp.text import LabelAwareIterator as JLabels
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.nlp import LabelAwareIterator, ParagraphVectors
from deeplearning4j_tpu_torch.nlp import paragraph_vectors as tpv
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.ops import embeddings as temb


def _cluster_docs(n_docs=80, doc_len=30, seed=0, zipf=False):
    """tests/test_nlp.py's documents: even ones from cluster "a", odd ones
    from cluster "b"."""
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    p = None
    if zipf:
        p = 1.0 / np.arange(1, 51)
        p /= p.sum()
    docs = [" ".join(rng.choice(A if i % 2 == 0 else B, size=doc_len, p=p))
            for i in range(n_docs)]
    return docs, [f"DOC_{i}" for i in range(n_docs)]


def _mean_sim(model, pairs):
    return float(np.mean([model.similarity(a, b) for a, b in pairs]))


def _doc_gate(pv, margin):
    same = _mean_sim(pv, [("DOC_0", f"DOC_{i}") for i in (2, 4, 6, 8)])
    diff = _mean_sim(pv, [("DOC_0", f"DOC_{i}") for i in (1, 3, 5, 7)])
    assert same > diff + margin, (same, diff)


def _prepare(model, docs, labels):
    """What ``fit`` does before training: the vocabulary with the labels
    first, the label ids, the per-document corpus."""
    toks = [d.split() for d in docs]
    model._special_tokens = labels
    model.build_vocab(iter(toks))
    model._label_ids = [model.vocab.index_of(lb) for lb in labels]
    corpus, doc_labels = [], []
    for lbl, tk in zip(model._label_ids, toks):
        ids = np.asarray([i for i in (model.vocab.index_of(t) for t in tk)
                          if i >= 0], np.int32)
        if ids.size:
            corpus.append(ids)
            doc_labels.append(lbl)
    return corpus, doc_labels


def _twins(docs, labels, **kw):
    cfg = dict(min_word_frequency=1, layer_size=16, window=3, negative=5,
               batch_size=64, seed=3)
    cfg.update(kw)
    j = jpv.ParagraphVectors(**cfg)
    t = ParagraphVectors(device="cpu", **cfg)
    jc, jl = _prepare(j, docs, labels)
    tc, tl = _prepare(t, docs, labels)
    assert t.vocab.words() == j.vocab.words()
    assert t._label_ids == j._label_ids and tl == jl
    assert all(np.array_equal(a, b) for a, b in zip(tc, jc))
    np.testing.assert_array_equal(t.lookup_table.syn0, j.lookup_table.syn0)
    return j, t, tc, tl


def _jax_buffers(corpus, doc_labels, W, span, bucket):
    """The JAX fit's corpus buffers (ids, sentence ids, labels), int32."""
    flat = np.concatenate(corpus)
    lens = np.array([c.size for c in corpus])
    npad = -(-flat.size // bucket) * bucket
    n = npad + span + 2 * W
    ids = np.zeros(n, np.int32)
    ids[W:W + flat.size] = flat
    sent = np.full(n, 65535, np.int32)
    sent[W:W + flat.size] = np.repeat(np.arange(len(corpus)), lens) % 65535
    labs = np.zeros(n, np.int32)
    labs[W:W + flat.size] = np.repeat(np.asarray(doc_labels), lens)
    return flat, npad, ids, sent, labs


def test_device_corpus_buffers_match():
    docs, labels = _cluster_docs(30, 12)
    j, t, corpus, doc_labels = _twins(docs, labels)
    span = t._dbow_pairs * t.MAX_BLOCK_ROUNDS
    flat, npad, bufs = t._pv_device_corpus(corpus, doc_labels, span)
    want = _jax_buffers(corpus, doc_labels, t.window, span, t.CORPUS_BUCKET)
    assert npad == want[1]
    np.testing.assert_array_equal(flat, want[0])
    for got, w in zip(bufs, want[2:]):
        np.testing.assert_array_equal(got.numpy(), w)


def test_pos_map_with_injected_uniforms():
    n, pos_len = 700, 1024
    key = jax.random.PRNGKey(4)
    j = jpv.ParagraphVectors()
    want = np.asarray(j._pos_map_fn(pos_len)(np.int32(n), key))
    u = np.array(jax.random.uniform(key, (pos_len,)))
    got = tpv._pos_map(n, torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got[:n].tolist()) == list(range(n))
    np.testing.assert_array_equal(got[n:].numpy(), np.arange(n, pos_len))


def test_subsampling_compacts_the_label_stream_bitwise():
    docs, labels = _cluster_docs(40, 20, zipf=True)
    j, t, corpus, doc_labels = _twins(docs, labels, sampling=1e-2)
    W = t.window
    flat, _, ids, sent, labs = _jax_buffers(corpus, doc_labels, W, 100,
                                            t.CORPUS_BUCKET)
    keep = jvocab.subsample_keep_probs(j.vocab, j.sampling).astype(
        np.float32)
    key = jax.random.PRNGKey(8)
    want = j._subsample3_fn()(jnp.asarray(ids.astype(np.uint16)),
                              jnp.asarray(sent.astype(np.uint16)),
                              jnp.asarray(labs), jnp.asarray(keep),
                              np.int32(flat.size), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (ids.size,))))
    slot, count = tw2v._subsample_slots(torch.from_numpy(ids),
                                        torch.from_numpy(keep), flat.size,
                                        u, W)
    got = (tw2v._compact(torch.from_numpy(ids), slot, 0),
           tw2v._compact(torch.from_numpy(sent), slot, tw2v.SENT_PAD),
           tw2v._compact(torch.from_numpy(labs), slot, 0))
    for g, w in zip(got, want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int32))
    assert int(count) == int(want[3]) and 0 < int(count) < flat.size


def _block_inputs(j, t, corpus, doc_labels, span):
    flat, npad, ids, sent, labs = _jax_buffers(corpus, doc_labels, t.window,
                                               span, t.CORPUS_BUCKET)
    ntable = jnp.asarray(jvocab.unigram_int_table(j.vocab))
    return flat, npad, ids, sent, labs, ntable


def _rates(lr0, lr1, R):
    return torch.from_numpy(tw2v.interpolate_rates(
        np.asarray([[lr0, lr1]], np.float32), R)[0])


def test_one_dbow_block_against_the_jax_block():
    """One 64-round DBOW block of ``_make_dbow_window_block`` against the
    port's ``_dbow_block``: the same pair order (JAX's ``pos_map``), pool
    and tables; a span that runs past the stream, so masked pairs too."""
    docs, labels = _cluster_docs(60, 20)
    j, t, corpus, doc_labels = _twins(docs, labels, batch_size=16)
    B, R = t._dbow_pairs, t.MAX_BLOCK_ROUNDS
    assert B == j._dbow_pairs
    S = B * R
    flat, npad, ids, sent, labs, ntable = _block_inputs(j, t, corpus,
                                                        doc_labels, S)
    block = j._make_dbow_window_block(ntable_dev=ntable)
    negpool = np.array(j._win_negpool)
    pos_map = np.array(j._pos_map_fn(npad + S)(
        np.int32(flat.size), jax.random.PRNGKey(2)))
    p0 = flat.size - S // 2              # half the block past the stream
    lr0, lr1, blk_id = np.float32(0.025), np.float32(0.02), 5
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0), jnp.asarray(j.lookup_table.syn1neg),
        jnp.asarray(ids), jnp.asarray(labs), jnp.asarray(pos_map),
        np.int32(flat.size), jnp.asarray(negpool), np.int32(p0), (lr0, lr1),
        jax.random.PRNGKey(j.seed), np.int32(blk_id))
    t0 = torch.from_numpy(t.lookup_table.syn0.copy())
    t1 = torch.from_numpy(t.lookup_table.syn1neg.copy())
    tloss, tn = t._dbow_block(t0, t1, torch.from_numpy(ids),
                              torch.from_numpy(labs),
                              torch.from_numpy(pos_map), flat.size,
                              torch.from_numpy(negpool), p0,
                              _rates(lr0, lr1, R), blk_id)
    assert float(tn) == float(jn) == S // 2
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=0, atol=2e-6)
    # the label rows moved: they are DBOW's inputs
    moved = np.abs(t0.numpy() - t.lookup_table.syn0).sum(1) > 0
    assert moved[t._label_ids].any()


def test_one_dm_block_against_the_jax_block():
    """One 64-round PV-DM block of ``_make_dm_window_block`` against the
    port's ``_dm_block`` with JAX's reduced windows: the label as an
    always-on (2W + 1)-th context column through the bag."""
    docs, labels = _cluster_docs(60, 20, zipf=True)
    j, t, corpus, doc_labels = _twins(docs, labels, dm=True, batch_size=16)
    B_C, R, W = t._cbow_centers, t.MAX_BLOCK_ROUNDS, t.window
    S = B_C * R
    flat, npad, ids, sent, labs, ntable = _block_inputs(j, t, corpus,
                                                        doc_labels, S)
    block = j._make_dm_window_block(ntable_dev=ntable)
    negpool = np.array(j._win_negpool)
    lr0, lr1, blk_id, p0 = np.float32(0.05), np.float32(0.04), 3, 9
    base = jax.random.PRNGKey(j.seed)
    s0, s1, jloss, jn = block(
        jnp.asarray(j.lookup_table.syn0), jnp.asarray(j.lookup_table.syn1neg),
        jnp.asarray(ids), jnp.asarray(sent), jnp.asarray(labs),
        np.int32(flat.size), jnp.asarray(negpool), np.int32(p0), (lr0, lr1),
        base, np.int32(blk_id))
    b = np.array(jax.random.randint(jax.random.fold_in(base, blk_id), (S,),
                                    1, W + 1))
    t0 = torch.from_numpy(t.lookup_table.syn0.copy())
    t1 = torch.from_numpy(t.lookup_table.syn1neg.copy())
    tloss, tn = t._dm_block(t0, t1, torch.from_numpy(ids),
                            torch.from_numpy(sent), torch.from_numpy(labs),
                            flat.size, torch.from_numpy(negpool), p0,
                            _rates(lr0, lr1, R), torch.from_numpy(b), blk_id)
    assert float(tn) == float(jn) == S
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(t0.numpy(), np.asarray(s0), rtol=0, atol=2e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(s1), rtol=0, atol=2e-6)


def _jax_fit(docs, labels, **kw):
    j = jpv.ParagraphVectors(min_word_frequency=1, layer_size=16, epochs=2,
                             negative=5, batch_size=64, seed=3, **kw)
    j._doc_iter = JLabels(docs, labels)
    j.fit()
    return j


def _carried(j, docs, labels, **kw):
    """A port model with the JAX model's vocabulary and tables."""
    t = ParagraphVectors(min_word_frequency=1, layer_size=16, negative=5,
                         batch_size=64, seed=3, device="cpu", **kw)
    _prepare(t, docs, labels)
    assert t.vocab.words() == j.vocab.words() and t.negative == j.negative
    for name in ("syn0", "syn1", "syn1neg"):
        a = getattr(j.lookup_table, name)
        setattr(t.lookup_table, name, None if a is None else np.asarray(a))
    return t


_TEXT = " ".join(f"a{i}" for i in range(0, 50, 3)) + " zz unknown"


@pytest.mark.parametrize("kw", [{}, {"dm": True}], ids=["dbow", "dm"])
def test_infer_vector_against_jax_on_the_same_tables(kw):
    """``infer_vector`` on a JAX-trained model's tables: the same negatives
    (the numpy stream of the seed), torch.autograd in place of jax.grad."""
    docs, labels = _cluster_docs(40, 20)
    j = _jax_fit(docs, labels, **kw)
    t = _carried(j, docs, labels, **kw)
    got = t.infer_vector(_TEXT, steps=20)
    want = np.asarray(j.infer_vector(_TEXT, steps=20))
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not np.allclose(got, t.infer_vector("zz unknown"))
    assert t.nearest_labels(got, 5) == j.nearest_labels(want, 5)


def test_hs_infer_vector_where_the_jax_package_fails_to_trace():
    """A divergence: the JAX package's hierarchical-softmax ``infer_vector``
    raises (``loss_fn`` indexes the numpy Huffman tables with a traced
    argument under ``jax.jit``). The port runs it; it is held to the JAX
    package's loss, differentiated by ``jax.grad`` with the paths gathered
    outside the trace, step for step, within 1e-6."""
    docs, labels = _cluster_docs(40, 20)
    j = _jax_fit(docs, labels, use_hierarchic_softmax=True)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        j.infer_vector(_TEXT, steps=2)
    t = _carried(j, docs, labels, use_hierarchic_softmax=True)
    got = t.infer_vector(_TEXT, steps=20)
    ids = np.asarray([i for i in (j.vocab.index_of(w) for w in _TEXT.split())
                      if i >= 0], np.int32)
    codes, points, mask = jvocab.huffman_arrays(j.vocab)
    u = jnp.asarray(j.lookup_table.syn1)[points[ids]]
    m = jnp.asarray(mask[ids])
    lab = (1.0 - jnp.asarray(codes[ids], jnp.float32)) * m

    def loss_fn(v):
        sig = jax.nn.sigmoid(jnp.einsum("d,nld->nl", v, u))
        xe = -(lab * jnp.log(sig + 1e-7)
               + (1 - lab) * jnp.log(1 - sig + 1e-7)) * m
        return xe.sum() / jnp.maximum(m.sum(), 1.0)

    rng = np.random.default_rng(j.seed)
    v = jnp.asarray(((rng.random(16) - 0.5) / 16).astype(np.float32))
    grad = jax.grad(loss_fn)
    for step in range(20):
        v = v - 0.025 * (1 - step / 20) * grad(v)
    np.testing.assert_allclose(got, np.asarray(v), rtol=0, atol=1e-6)
    assert np.abs(got - np.asarray(t.infer_vector("zz"))).max() > 1e-4


def test_dbow_fit_separates_doc_clusters_and_infers():
    """tests/test_nlp.py's DBOW and infer_vector gates; with the word pass
    (train_word_vectors), skip-gram blocks run beside the DBOW blocks and
    their rounds count as sum(ceil(count / B))."""
    docs, labels = _cluster_docs()
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(10).negative_sample(5).batch_size(256).seed(3)
          .device("cpu").iterate(LabelAwareIterator(docs, labels)).build())
    counts = []
    sg_block = pv._sg_block
    pv._sg_block = lambda *a: counts.append(a[4]) or sg_block(*a)
    prof = OpProfiler.get()
    rounds = prof.counter_value("nlp/w2v_rounds")
    launches = temb.embedding_bag_launches
    pv.fit()
    _doc_gate(pv, 0.3)
    B = pv._round_pairs
    n_dbow = pv.last_fit_timing["blocks"] - len(counts)
    assert len(counts) == pv.last_fit_timing["readbacks"] == n_dbow == 10
    assert prof.counter_value("nlp/w2v_rounds") - rounds == \
        64 * n_dbow + sum(-(-c // B) for c in counts)
    assert temb.embedding_bag_launches == launches
    rng = np.random.default_rng(7)
    text = " ".join(f"a{i}" for i in rng.integers(0, 50, size=25))
    near = pv.nearest_labels(pv.infer_vector(text), 5)
    assert sum(int(lb.split("_")[1]) % 2 == 0 for lb in near) >= 4, near
    assert pv.get_paragraph_vector("DOC_0").shape == (24,)


def test_dm_fit_separates_doc_clusters():
    docs, labels = _cluster_docs(zipf=True)
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(24)
          .epochs(20).negative_sample(5).batch_size(128).seed(3).dm(True)
          .learning_rate(0.05).device("cpu")
          .iterate(LabelAwareIterator(docs, labels)).build())
    pv.fit()
    _doc_gate(pv, 0.2)
    assert pv.last_fit_timing["readbacks"] == 0
    assert np.isfinite(pv.last_loss) and pv.last_loss < pv.first_loss


def test_get_paragraph_vector_and_refusals():
    docs, labels = _cluster_docs(20, 10)
    pv = (ParagraphVectors.builder().min_word_frequency(1).layer_size(8)
          .epochs(1).negative_sample(2).batch_size(64).seed(3).device("cpu")
          .iterate(LabelAwareIterator(docs, labels)).build())
    pv.fit()
    assert pv.get_paragraph_vector("DOC_0").shape == (8,)
    assert pv.table_device.type == "cpu"
    with pytest.raises(ValueError, match="no corpus"):
        ParagraphVectors(device="cpu").fit()
    with pytest.raises(ValueError, match="align"):
        LabelAwareIterator(["a b"], ["x", "y"])
    assert LabelAwareIterator(["a", "b"]).labels == ["DOC_0", "DOC_1"]
