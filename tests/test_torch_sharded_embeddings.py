"""The port's row-sharded tables against the JAX package's, on the CPU.

Port counterparts of ``tests/test_parallel_extras.py``'s
``TestShardedEmbedding`` and ``TestWord2VecShardedTables``, plus parity
with the JAX objects: ``ShardedEmbedding`` (the same initial table, lookup
and update, bitwise), the sharded skip-gram round against the unsharded one
(bitwise: each id has one owning shard, the others add exact zeros), one
sharded Word2Vec block against the JAX sharded block (with the JAX block's
reduced windows and negative pool handed over, as
``tests/test_torch_word2vec.py`` does for the unsharded block), and whole
sharded fits against unsharded ones (bitwise, which is the JAX test's 1e-6
and more). The JAX side runs on its 8 virtual CPU devices, the port's
meshes on ``["cpu"] * n`` slots.

The one-block tolerance against the JAX block is the unsharded block's of
``tests/test_torch_word2vec.py`` (2e-6 on the tables, 1e-5 relative on the
loss): the dots go through different matrix kernels and XLA may fuse a
multiply-add, a few float32 ulp of the O(1) table values over the block's
rounds; sharding adds nothing to it (the port's sharded block is bitwise
its unsharded block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu_torch.nlp import Word2Vec
from deeplearning4j_tpu_torch.ops import embeddings as E
from deeplearning4j_tpu_torch.parallel import (ShardedEmbedding, make_mesh,
                                               make_pipeline_mesh)
from deeplearning4j_tpu_torch.util.convert import (
    sharded_embedding_from_numpy)


def _mesh(n, axis="model"):
    if axis == "model":
        return make_mesh(data=1, model=n, devices=["cpu"] * n)
    return make_mesh(data=n, model=1, devices=["cpu"] * n)


def _jmesh(axis, n):
    return JMesh(np.asarray(jax.devices()[:n]).reshape(n), (axis,))


class TestShardedTensorSplit:
    @pytest.mark.parametrize("rows,n,dim", [(13, 4, 0), (16, 4, 0),
                                            (6, 3, 1)])
    def test_split_pads_and_gathers_back(self, rows, n, dim):
        """``split(pad=True)`` zero-pads to a multiple of the shard count;
        the shards gathered in slot order give the tensor back, then the
        zero rows."""
        from deeplearning4j_tpu_torch.common.tree import ShardedTensor

        t = torch.from_numpy(np.random.default_rng(rows).standard_normal(
            (rows, 6) if dim == 0 else (5, rows)).astype(np.float32))
        st = ShardedTensor.split(t, ["cpu"] * n, dim=dim, pad=True)
        padded = -(-rows // n) * n
        assert len(st.shards) == n and st.shape[dim] == padded
        back = st.gather()
        assert torch.equal(back.narrow(dim, 0, rows), t)
        assert not back.narrow(dim, rows, padded - rows).any()
        assert float(st.sumsq("cpu")) == pytest.approx(
            float(torch.sum(t * t)), rel=1e-6)

    def test_split_without_pad_needs_a_divisor(self):
        from deeplearning4j_tpu_torch.common.tree import ShardedTensor

        with pytest.raises(ValueError, match="does not split"):
            ShardedTensor.split(torch.zeros(13, 2), ["cpu"] * 4)


class TestShardedEmbedding:
    def test_lookup_matches_dense(self):
        emb = ShardedEmbedding(vocab_size=50, dim=8, mesh=_mesh(4),
                               axis="model", seed=1)
        dense = emb.to_numpy()
        ids = np.asarray([0, 7, 13, 49, 25, 13], np.int32)
        np.testing.assert_allclose(emb.lookup(ids).numpy(), dense[ids],
                                   atol=1e-6)

    def test_vocab_not_divisible_pads_safely(self):
        emb = ShardedEmbedding(vocab_size=13, dim=4, mesh=_mesh(8),
                               axis="model", seed=2)
        assert emb.table.shape[0] % 8 == 0
        assert emb.n_shards == 8
        ids = np.arange(13, dtype=np.int32)
        np.testing.assert_allclose(emb.lookup(ids).numpy(), emb.to_numpy(),
                                   atol=1e-6)

    def test_scatter_update_only_touches_owned_rows(self):
        emb = ShardedEmbedding(vocab_size=40, dim=4, mesh=_mesh(4),
                               axis="model", seed=3)
        before = emb.to_numpy().copy()
        ids = np.asarray([3, 21, 3, 39], np.int32)     # id 3 twice: sums
        grads = np.ones((4, 4), np.float32)
        emb.apply_gradients(ids, grads)
        expected = before.copy()
        np.add.at(expected, ids, grads)
        np.testing.assert_allclose(emb.to_numpy(), expected, atol=1e-6)

    def test_trains_a_toy_objective(self):
        emb = ShardedEmbedding(vocab_size=20, dim=6, mesh=_mesh(4),
                               axis="model", seed=4)
        rng = np.random.default_rng(0)
        targets = rng.standard_normal((20, 6)).astype(np.float32)
        ids_all = np.arange(20, dtype=np.int32)

        def loss():
            return float(np.mean((emb.lookup(ids_all).numpy() - targets)
                                 ** 2))

        l0 = loss()
        for _ in range(100):
            ids = rng.integers(0, 20, 16).astype(np.int32)
            rows = emb.lookup(ids).numpy()
            emb.apply_gradients(ids, -(0.5 * (rows - targets[ids])))
        assert loss() < l0 * 0.1, (l0, loss())

    @pytest.mark.parametrize("n,vocab", [(4, 40), (8, 13)])
    def test_bitwise_against_jax(self, n, vocab):
        """The same table drawn from the seed, the same lookup and the same
        update as the JAX class, bit for bit; the carrier puts a JAX table
        into a port one."""
        from deeplearning4j_tpu.parallel import ShardedEmbedding as JEmb

        j = JEmb(vocab_size=vocab, dim=5, mesh=_jmesh("model", n),
                 axis="model", seed=9)
        t = ShardedEmbedding(vocab_size=vocab, dim=5, mesh=_mesh(n),
                             axis="model", seed=9)
        assert np.array_equal(t.to_numpy(), np.asarray(j.to_numpy()))
        assert np.array_equal(t.table.numpy(), np.asarray(j.table))
        rng = np.random.default_rng(1)
        ids = rng.integers(0, vocab, 17).astype(np.int32)
        assert np.array_equal(t.lookup(ids).numpy(),
                              np.asarray(j.lookup(ids)))
        g = rng.standard_normal((17, 5)).astype(np.float32)
        j.apply_gradients(ids, g)
        t.apply_gradients(ids, g)
        assert np.array_equal(t.to_numpy(), np.asarray(j.to_numpy()))
        fresh = ShardedEmbedding(vocab_size=vocab, dim=5, mesh=_mesh(n),
                                 axis="model", seed=0)
        sharded_embedding_from_numpy(fresh, np.asarray(j.to_numpy()))
        assert np.array_equal(fresh.table.numpy(), np.asarray(j.table))
        with pytest.raises(ValueError, match="shape"):
            sharded_embedding_from_numpy(fresh, np.zeros((3, 5),
                                                         np.float32))

    def test_shards_over_the_data_axis_and_a_pipeline_mesh(self):
        for mesh, axis in ((_mesh(4, "data"), "data"),
                           (make_pipeline_mesh(2, 3, ["cpu"] * 6), "stage")):
            emb = ShardedEmbedding(vocab_size=10, dim=3, mesh=mesh,
                                   axis=axis, seed=5)
            assert emb.n_shards == mesh.shape[axis]
            ids = np.arange(10)
            np.testing.assert_array_equal(emb.lookup(ids).numpy(),
                                          emb.to_numpy())


class TestShardedRound:
    @pytest.mark.parametrize("n", [1, 3, 8])
    def test_sharded_skipgram_bitwise_against_unsharded(self, n):
        rng = np.random.default_rng(n)
        V, D, B, K = 29, 6, 40, 3
        syn0 = torch.from_numpy(rng.standard_normal((V, D)).astype(
            np.float32))
        syn1 = torch.from_numpy(rng.standard_normal((V, D)).astype(
            np.float32) * 0.1)
        c = torch.from_numpy(rng.integers(0, V, B).astype(np.int32))
        tgt = torch.from_numpy(rng.integers(0, V, (B, 1 + K)).astype(
            np.int32))
        lab = torch.zeros((B, 1 + K))
        lab[:, 0] = 1.0
        pm = torch.ones(B)
        pm[-5:] = 0.0
        lr = torch.tensor(0.025)
        rows = -(-V // n)

        def shards(t):
            pad = torch.zeros((rows * n, D))
            pad[:V] = t
            return [pad[j * rows:(j + 1) * rows].clone() for j in range(n)]

        s0, s1 = shards(syn0), shards(syn1)
        u0, u1 = syn0.clone(), syn1.clone()
        loss_u = E.skipgram(u0, u1, c, tgt, lab, lr, pm)
        loss_s = E.sharded_skipgram(s0, s1, c, tgt, lab, lr, pm)
        assert torch.equal(loss_u, loss_s)
        assert torch.equal(torch.cat(s0)[:V], u0)
        assert torch.equal(torch.cat(s1)[:V], u1)
        assert not torch.cat(s0)[V:].any()      # the pad rows stay zero

    def test_sharded_round_against_jax_sharded_round(self):
        """``sharded_skipgram`` against the JAX helper under
        ``shard_map`` over 4 devices, from the same tables and pairs."""
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P

        from deeplearning4j_tpu.ops import embeddings as JE

        rng = np.random.default_rng(7)
        V, D, B, K = 24, 5, 32, 4
        syn0 = rng.standard_normal((V, D)).astype(np.float32)
        syn1 = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
        c = rng.integers(0, V, B).astype(np.int32)
        tgt = rng.integers(0, V, (B, 1 + K)).astype(np.int32)
        lab = np.zeros((B, 1 + K), np.float32)
        lab[:, 0] = 1.0
        pm = np.ones(B, np.float32)
        lr = np.float32(0.05)
        fn = shard_map(
            lambda a, b: JE.sharded_skipgram(a, b, c, tgt, lab, lr, pm,
                                             axis="model"),
            mesh=_jmesh("model", 4),
            in_specs=(P("model", None), P("model", None)),
            out_specs=(P("model", None), P("model", None), P()),
            check_rep=False)
        j0, j1, jl = jax.jit(fn)(syn0, syn1)
        s0 = list(torch.from_numpy(syn0.copy()).split(V // 4))
        s1 = list(torch.from_numpy(syn1.copy()).split(V // 4))
        s0 = [t.clone() for t in s0]
        s1 = [t.clone() for t in s1]
        tl = E.sharded_skipgram(s0, s1, torch.from_numpy(c),
                                torch.from_numpy(tgt), torch.from_numpy(lab),
                                torch.tensor(lr), torch.from_numpy(pm))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        np.testing.assert_allclose(torch.cat(s0).numpy(), np.asarray(j0),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(torch.cat(s1).numpy(), np.asarray(j1),
                                   rtol=0, atol=1e-6)


def _corpus(seed=5, n=400):
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(30)]
    B = [f"b{i}" for i in range(30)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=10))
            for _ in range(n)]


class TestWord2VecShardedTables:
    def _fit(self, sents, mesh, **kw):
        cfg = dict(min_word_frequency=1, layer_size=16, negative=3, epochs=2,
                   batch_size=256, seed=11, device="cpu")
        cfg.update(kw)
        if mesh is not None:
            cfg["mesh"] = mesh
        w = Word2Vec(**cfg)
        w.set_sentence_iterator(sents)
        w.fit()
        return w

    def test_sharded_fit_matches_single_device(self):
        sents = _corpus()
        w_ref = self._fit(sents, None)
        w_sh = self._fit(sents, _mesh(4))
        # exact: each row's lookup is its one owner's row plus zeros, and
        # each shard adds only its own rows' updates
        assert np.array_equal(w_sh.lookup_table.syn0,
                              w_ref.lookup_table.syn0)
        assert np.array_equal(w_sh.lookup_table.syn1neg,
                              w_ref.lookup_table.syn1neg)
        assert w_sh.last_loss == w_ref.last_loss
        same = np.mean([w_sh.similarity("a0", f"a{i}") for i in range(1, 6)])
        diff = np.mean([w_sh.similarity("a0", f"b{i}") for i in range(5)])
        assert same > diff + 0.3, (same, diff)

    def test_builder_route(self):
        w = (Word2Vec.builder().min_word_frequency(1).layer_size(8)
             .negative_sample(2).epochs(1).batch_size(128).seed(4)
             .device("cpu").sharded_tables(_mesh(8)).build())
        w.set_sentence_iterator(_corpus()[:100])
        w.fit()
        assert np.isfinite(w.last_loss)
        assert w.mesh.shape["model"] == 8

    def test_subsampled_bf16_and_padded_fits_match(self):
        """With subsampling, bf16 tables and a vocabulary of 60 over 7
        shards (63 rows, 3 of them padding) the sharded fit is still the
        unsharded one."""
        sents = _corpus(seed=8, n=200)
        kw = dict(sampling=1e-2, table_dtype="bfloat16", epochs=1)
        w_ref = self._fit(sents, None, **kw)
        w_sh = self._fit(sents, make_mesh(data=1, model=7,
                                          devices=["cpu"] * 7), **kw)
        assert np.array_equal(w_sh.lookup_table.syn0,
                              w_ref.lookup_table.syn0)

    def test_one_sharded_block_against_the_jax_sharded_block(self):
        """One skip-gram block of the JAX sharded block
        (``_make_window_block`` under the mesh's ``shard_map``) against the
        port's ``_sg_pack`` + ``_sg_block`` on row shards, 8 shards of a
        100-word vocabulary (padded to 104), with JAX's reduced windows and
        negative pool."""
        from deeplearning4j_tpu.nlp import vocab as jvocab
        from deeplearning4j_tpu.nlp import word2vec as jw2v

        rng = np.random.default_rng(0)
        A = [f"a{i}" for i in range(50)]
        Bw = [f"b{i}" for i in range(50)]
        sents = [" ".join(rng.choice(A if rng.random() < .5 else Bw,
                                     size=10)) for _ in range(300)]
        cfg = dict(min_word_frequency=5, layer_size=16, window=3, negative=5,
                   algorithm="skipgram", batch_size=60, seed=7)
        j = jw2v.Word2Vec(mesh=_jmesh("model", 8), **cfg)
        t = Word2Vec(device="cpu", mesh=_mesh(8), **cfg)
        for m in (j, t):
            m.set_sentence_iterator(sents)
            m.build_vocab(m._token_stream())
        assert len(j.vocab) == len(t.vocab) == 100
        corpus = j._encode_corpus(j._token_stream())
        flat = np.concatenate(corpus)
        lens = np.array([c.size for c in corpus])
        W, S, B = j.window, j._window_span, j._round_pairs
        n = flat.size
        ids = np.zeros(n + S + 2 * W, np.uint16)
        ids[W:W + n] = flat
        sent = np.full(n + S + 2 * W, 65535, np.uint16)
        sent[W:W + n] = np.repeat(np.arange(len(lens)), lens) % 65535
        ntable = jnp.asarray(jvocab.unigram_int_table(j.vocab))
        block = j._make_window_block(hs_dev=None, ntable_dev=ntable)
        negpool = np.array(j._win_negpool)
        pad = np.zeros((104 - 100, 16), np.float32)
        lr0, lr1, blk_id, p0 = np.float32(0.025), np.float32(0.021), 2, 11
        base = jax.random.PRNGKey(j.seed)
        s0, s1, jloss, jn = block(
            jnp.asarray(np.concatenate([j.lookup_table.syn0, pad])),
            jnp.asarray(np.concatenate([j.lookup_table.syn1neg, pad])),
            jnp.asarray(ids), jnp.asarray(sent), np.int32(n),
            jnp.asarray(negpool), np.int32(p0), (lr0, lr1), base,
            np.int32(blk_id))
        t0, t1 = t._tables_to_device()
        assert len(t0.shards) == 8 and t0.shape[0] == 104
        b = np.array(jax.random.randint(jax.random.fold_in(base, blk_id),
                                        (S,), 1, W + 1))
        packed_c, packed_x, pending = t._sg_pack(
            torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(sent.astype(np.int32)), n, p0,
            torch.from_numpy(b))
        count = pending.get()
        tloss, tn = t._sg_block(t0, t1, packed_c, packed_x, count,
                                torch.from_numpy(negpool), lr0, lr1, blk_id)
        assert count == tn == float(jn) and count > 40 * B
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(t0.gather().numpy(), np.asarray(s0),
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(t1.gather().numpy(), np.asarray(s1),
                                   rtol=0, atol=2e-6)

    @pytest.mark.parametrize("what", ["hs", "cbow", "host", "pv", "fasttext"])
    def test_refusals(self, what):
        from deeplearning4j_tpu_torch.nlp import (FastText,
                                                  LabelAwareIterator,
                                                  ParagraphVectors)

        sents = _corpus(n=40)
        mesh = _mesh(2)
        if what == "hs":
            with pytest.raises(ValueError, match="negative sampling only"):
                Word2Vec(device="cpu", mesh=mesh,
                         use_hierarchic_softmax=True)
            return
        if what == "cbow":
            w = Word2Vec(device="cpu", mesh=mesh, algorithm="cbow",
                         min_word_frequency=1)
            match = "skip-gram windowed path only"
        elif what == "host":
            w = Word2Vec(device="cpu", mesh=mesh, min_word_frequency=1)
            w.device_corpus = False
            match = "device-windowed paths only"
        elif what == "pv":
            w = (ParagraphVectors.builder().min_word_frequency(1)
                 .layer_size(8).device("cpu")
                 .iterate(LabelAwareIterator(sents, [f"d{i}" for i in
                                                     range(len(sents))]))
                 .build())
            w.mesh = mesh
            with pytest.raises(ValueError, match="ParagraphVectors"):
                w.fit()
            return
        else:
            w = (FastText.builder().min_word_frequency(1).layer_size(8)
                 .device("cpu").iterate(sents).build())
            w.mesh = mesh
            match = "device-windowed paths only"
        if what != "fasttext":
            w.set_sentence_iterator(sents)
        with pytest.raises(ValueError, match=match):
            w.fit()
