"""The port's tensor-parallel placement and the wrapper's model axis against
the JAX package's, on the CPU.

Port counterparts of ``tests/test_parallel.py``'s ``TestTensorParallel``
and ``tests/test_parallel_extras.py``'s ``TestEmbeddingLayerSharding``,
plus parity with the JAX package on the same parameters and batches: the
spec trees equal, the tensor-parallel forward within the JAX test's 1e-5,
a model-axis wrapper fit within the JAX test's 1e-3 (its tolerance: the
data-axis means in another association, through Adam's rsqrt), and the
refusals the JAX wrapper makes with a model axis. The JAX side runs on its 8
virtual CPU devices, the port on ``["cpu"] * n`` slots.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.parallel import (
    ParallelWrapper, PartitionSpec as P, ReduceScatterAccumulator,
    EncodedGradientsAccumulator, ShardedTensor, apply_tp, make_mesh,
    tp_param_specs, tp_shardings)
from torch_parity import mln_twins, modules

CPU = ["cpu"] * 8


def small_conf(which, seed=1):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder()
            .seed(seed).updater(m.Adam(0.05)).activation("tanh")
            .list()
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=3))
            .set_input_type(m.InputType.feed_forward(4))
            .build())


def cnn_conf(which, seed=3):
    m = modules(which)
    L = m.L
    return (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(m.Sgd(learning_rate=0.05)).list()
            .layer(L.ConvolutionLayer(n_out=8, kernel_size=(3, 3),
                                      activation="relu",
                                      convolution_mode="same"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      activation="relu",
                                      convolution_mode="same"))
            .layer(L.DenseLayer(n_out=16, activation="relu"))
            .layer(L.DenseLayer(n_out=10, activation="softmax"))
            .layer(L.OutputLayer(n_out=4, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.convolutional(8, 8, 2)).build())


def small_model(seed=1):
    m = modules("torch")
    return m.MultiLayerNetwork(small_conf("torch", seed)).init(device="cpu")


def _specs(tree):
    out = []
    for v in tree.values():
        out.extend(_specs(v) if isinstance(v, dict) else [v])
    return out


class TestTensorParallel:
    def test_tp_specs_shard_big_weights(self):
        model = small_model()
        specs = _specs(tp_param_specs(model._params,
                                      make_mesh(data=4, model=2,
                                                devices=CPU)))
        assert any(s == P(None, "model") for s in specs)   # dense W split
        assert P() in specs                                  # head replicated

    def test_tp_forward_matches_replicated(self):
        model = small_model()
        mesh = make_mesh(data=1, model=2, devices=CPU[:2])
        x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
        expected = model.output(x).numpy()
        model._params = apply_tp(model._params, mesh)
        assert isinstance(model._params["0000"]["W"], ShardedTensor)
        np.testing.assert_allclose(model.output(x).numpy(), expected,
                                   atol=1e-5)

    @pytest.mark.parametrize("which,n", [("small", 2), ("cnn", 2),
                                         ("cnn", 4)])
    def test_specs_and_forward_against_jax(self, which, n):
        from deeplearning4j_tpu.parallel import apply_tp as japply
        from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
        from deeplearning4j_tpu.parallel import tp_param_specs as jspecs

        make = small_conf if which == "small" else cnn_conf
        jn, tn = mln_twins(make("jax"), make("torch"))
        rng = np.random.RandomState(1)
        x = (rng.randn(4, 4) if which == "small"
             else rng.randn(3, 2, 8, 8)).astype(np.float32)
        jmesh = jmake_mesh(data=1, model=n, devices=jax.devices()[:n])
        tmesh = make_mesh(data=1, model=n, devices=CPU[:n])
        js = jspecs(jn._params, jmesh)
        ts = tp_param_specs(tn._params, tmesh)
        for i, layer in enumerate(js):
            for k, spec in layer.items():
                assert tuple(ts[f"{i:04d}"][k]) == tuple(spec), (i, k)
        jn._params = japply(jn._params, jmesh)
        jn._infer_fn = None
        want = np.asarray(jn.output(x).to_numpy())
        tn._params = apply_tp(tn._params, tmesh)
        shardings = tp_shardings(tn._params, tmesh)
        assert shardings["0000"]["W"].spec == ts["0000"]["W"]
        np.testing.assert_allclose(tn.output(x).numpy(), want, atol=1e-5)

    def test_tp_forward_in_the_compute_dtype(self):
        """With a bf16 compute dtype the shards are cast as the layer's
        input is; the forward stays within bf16 rounding of the replicated
        one."""
        m = modules("torch")
        net = m.MultiLayerNetwork(cnn_conf("torch")).init(device="cpu")
        net.conf.global_conf.compute_dtype = "bfloat16"
        x = np.random.RandomState(3).randn(2, 2, 8, 8).astype(np.float32)
        want = net.output(x).float().numpy()
        net._params = apply_tp(net._params, make_mesh(data=1, model=2,
                                                      devices=CPU[:2]))
        got = net.output(x).float().numpy()
        np.testing.assert_allclose(got, want, atol=2 ** -7)

    def test_non_elementwise_layer_is_gathered(self):
        """A Dense layer with softmax cannot run column-parallel: its
        sharded leaves are gathered, and the forward still matches."""
        m = modules("torch")
        net = m.MultiLayerNetwork(cnn_conf("torch")).init(device="cpu")
        x = np.random.RandomState(2).randn(2, 2, 8, 8).astype(np.float32)
        want = net.output(x).numpy()
        net._params = apply_tp(net._params, make_mesh(data=1, model=2,
                                                      devices=CPU[:2]))
        assert isinstance(net._params["0004"]["W"], ShardedTensor)
        np.testing.assert_allclose(net.output(x).numpy(), want, atol=1e-5)


    @pytest.mark.parametrize("what", ["weight_noise", "remat"])
    def test_training_forward_refuses_whole_leaf_features(self, what):
        """Weight noise and a rematerialization policy act on whole leaves:
        a tensor-parallel training forward refuses them, and the inference
        forward (which applies neither) still matches the replicated
        one."""
        m = modules("torch")
        noise = m.L.WeightNoise(stddev=1.0) if what == "weight_noise" \
            else None
        conf = (m.NeuralNetConfiguration.builder().seed(1)
                .updater(m.Sgd(0.1)).list()
                .layer(m.L.DenseLayer(n_out=16, activation="tanh",
                                      weight_noise=noise))
                .layer(m.L.OutputLayer(n_out=3))
                .set_input_type(m.InputType.feed_forward(4)).build())
        net = m.MultiLayerNetwork(conf).init(device="cpu")
        if what == "remat":
            net.set_remat_policy("full")
        x = np.random.RandomState(4).randn(4, 4).astype(np.float32)
        want = net.output(x).numpy()
        net._params = apply_tp(net._params, make_mesh(data=1, model=2,
                                                      devices=CPU[:2]))
        np.testing.assert_allclose(net.output(x).numpy(), want, atol=1e-5)
        with pytest.raises(ValueError, match="tensor-parallel"):
            net.output(x, training=True)

    def test_only_an_apply_tp_tree_runs_tensor_parallel(self):
        """The tree's type decides: ``apply_tp`` gives a ``ShardedTree``,
        and the same leaves in a plain dict take the plain path."""
        from deeplearning4j_tpu_torch.common.tree import ShardedTree

        model = small_model()
        x = np.random.RandomState(5).randn(4, 4).astype(np.float32)
        tree = apply_tp(model._params, make_mesh(data=1, model=2,
                                                 devices=CPU[:2]))
        assert type(tree) is ShardedTree
        model._params = dict(tree)
        with pytest.raises(TypeError):
            model.output(x)


def embedding_conf(which, seed=7, table_sharding=None, lr=0.01, vocab=64,
                   n_out=16, classes=4, T=6, l2=0.0):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(m.Adam(learning_rate=lr)).l2(l2)
            .list()
            .layer(m.L.EmbeddingSequenceLayer(n_out=n_out,
                                              table_sharding=table_sharding))
            .layer(m.L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(m.L.OutputLayer(n_out=classes, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.recurrent(vocab, T))
            .build())


def embedding_model(**kw):
    m = modules("torch")
    return m.MultiLayerNetwork(embedding_conf("torch", **kw)).init(
        device="cpu")


def embedding_batch(rng, n=32):
    c = rng.integers(0, 4, size=n)
    x = (c[:, None] * 16 + rng.integers(0, 16, size=(n, 6))).astype(
        np.float32)
    return x, np.eye(4, dtype=np.float32)[c]


class TestEmbeddingLayerSharding:
    @pytest.mark.parametrize("l2", [0.0, 1e-2])
    def test_sharded_step_matches_replicated(self, l2):
        """The JAX test, and with l2 (the sharded table's decay summed
        shard by shard)."""
        x, y = embedding_batch(np.random.default_rng(0))
        m_ref = embedding_model(seed=7, l2=l2)
        m_sh = embedding_model(seed=7, table_sharding="model", l2=l2)
        assert torch.equal(m_ref._params["0000"]["W"],
                           m_sh._params["0000"]["W"])
        ParallelWrapper.Builder(m_ref).workers(8).build().fit(DataSet(x, y))
        (ParallelWrapper.Builder(m_sh).workers(8).model_axis(4).build()
         .fit(DataSet(x, y)))
        for k in ("0000", "0002"):
            np.testing.assert_allclose(m_sh._params[k]["W"].numpy(),
                                       m_ref._params[k]["W"].numpy(),
                                       rtol=0, atol=1e-3)

    def test_sharded_training_converges(self):
        rng = np.random.default_rng(1)
        model = embedding_model(seed=3, table_sharding="model", lr=0.05)
        pw = ParallelWrapper.Builder(model).workers(8).model_axis(2).build()
        first = None
        for _ in range(120):
            pw.fit(DataSet(*embedding_batch(rng, 64)))
            if first is None:
                first = float(model._score)
        assert float(model._score) < first * 0.5, (first,
                                                    float(model._score))

    @pytest.mark.parametrize("ids", [[0, 17, 63, 5], [-1, -64, 40, 3]])
    def test_sharded_lookup_equals_the_dense_lookup(self, ids):
        """Row shards give the dense gather's rows bitwise, a negative id
        counting from the end as there."""
        from deeplearning4j_tpu_torch.common.tree import ShardedTensor

        model = embedding_model(table_sharding="model")
        layer, W = model.layers[0], model._params["0000"]["W"]
        sharded = ShardedTensor.split(W, CPU[:4])
        idx = torch.tensor([ids, ids[::-1]])
        assert torch.equal(layer._lookup(sharded, idx), layer._lookup(W, idx))

    @pytest.mark.parametrize("bad", [64, 1000, -65])
    def test_sharded_lookup_raises_outside_the_table(self, bad):
        """An id outside the table raises under a model axis as it does on
        the dense path (the masked gathers alone would give a zero
        row)."""
        from deeplearning4j_tpu_torch.common.tree import ShardedTensor

        model = embedding_model(table_sharding="model")
        layer, W = model.layers[0], model._params["0000"]["W"]
        idx = torch.tensor([[1, bad]])
        with pytest.raises(IndexError):
            layer._lookup(W, idx)
        with pytest.raises(IndexError, match="outside the table"):
            layer._lookup(ShardedTensor.split(W, CPU[:4]), idx)

    def test_vocab_divisibility_validated(self):
        model = embedding_model(table_sharding="model", vocab=63, n_out=8,
                                classes=2, T=4)
        pw = ParallelWrapper.Builder(model).workers(8).model_axis(4).build()
        rng = np.random.default_rng(2)
        x = rng.integers(0, 63, size=(8, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
        with pytest.raises(ValueError, match="divisible"):
            pw.fit(DataSet(x, y))

    def test_table_row_sharded_over_the_model_slots(self):
        model = embedding_model(table_sharding="model")
        pw = ParallelWrapper.Builder(model).workers(8).model_axis(4).build()
        x, y = embedding_batch(np.random.default_rng(3))
        pw.fit(DataSet(x, y))
        assert pw.workers_count == 2
        for r in range(2):
            shards = pw._reps[r].tables["0000"]
            assert [tuple(t.shape) for t in shards] == [(16, 16)] * 4
        # the model holds the whole table after the fit, the shards in order
        assert torch.equal(model._params["0000"]["W"],
                           torch.cat([t.detach() for t in
                                      pw._reps[0].tables["0000"]]))

    def test_model_axis_fit_against_jax(self):
        """Three model-axis steps (8 workers, model axis 4) against the JAX
        wrapper's on the same parameters and batches, at the JAX test's
        1e-3; with a NaN guard and telemetry on the port side."""
        from deeplearning4j_tpu.data import DataSet as JDataSet
        from deeplearning4j_tpu.parallel import ParallelWrapper as JPW

        jn, tn = mln_twins(embedding_conf("jax", table_sharding="model"),
                           embedding_conf("torch", table_sharding="model"))
        jpw = JPW.Builder(jn).workers(8).model_axis(4).build()
        tpw = ParallelWrapper.Builder(tn).workers(8).model_axis(4).build()
        rng = np.random.default_rng(4)
        for _ in range(3):
            x, y = embedding_batch(rng)
            jpw.fit(JDataSet(x, y))
            tpw.fit(DataSet(x, y))
            np.testing.assert_allclose(float(tn._score),
                                       float(jn._score_dev), rtol=1e-5)
        for i, k in enumerate(("0000", "0001", "0002")):
            for n, a in tn._params[k].items():
                np.testing.assert_allclose(a.numpy(),
                                           np.asarray(jn._params[i][n]),
                                           rtol=0, atol=1e-3)

    def test_guard_and_stats_with_a_model_axis(self):
        from deeplearning4j_tpu_torch.optimize.telemetry import (
            NanSentinelListener)

        class Sink:
            wants_telemetry = True

            def __init__(self):
                self.aux = []

            def iteration_done(self, model, iteration, score):
                pass

            def telemetry_done(self, model, iteration, aux):
                self.aux.append(aux)

        model = embedding_model(table_sharding="model")
        pw = ParallelWrapper.Builder(model).workers(4).model_axis(2).build()
        sink = Sink()
        pw.set_listeners(sink, NanSentinelListener("skip", check_every_n=1))
        rng = np.random.default_rng(5)
        x, y = embedding_batch(rng, 16)
        pw.fit(DataSet(x, y))
        before = model._params["0000"]["W"].clone()
        aux = sink.aux[-1]
        assert tuple(aux["grad_norm"].shape) == (3,)
        assert float(aux["grad_norm"][0]) > 0     # the table's gradient
        bad = x.copy()
        y_bad = y.copy()
        y_bad[0, 0] = np.nan
        pw.fit(DataSet(bad, y_bad))
        assert int(sink.aux[-1]["skipped"]) == 1
        assert torch.equal(model._params["0000"]["W"], before)


class TestModelAxisRefusals:
    def _iter(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((32, 4)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
        return NDArrayDataSetIterator(x, y, batch_size=16)

    def test_zero1_refused(self):
        pw = (ParallelWrapper.Builder(small_model()).workers(4).model_axis(2)
              .gradients_accumulator(ReduceScatterAccumulator()).build())
        with pytest.raises(NotImplementedError, match="replicated params"):
            pw.fit(self._iter(), epochs=1)

    def test_encoded_exchange_refused(self):
        pw = (ParallelWrapper.Builder(small_model()).workers(4).model_axis(2)
              .gradients_accumulator(EncodedGradientsAccumulator(parties=2))
              .build())
        with pytest.raises(NotImplementedError, match="replicated params"):
            pw.fit(self._iter(), epochs=1)

    def test_integrity_refused(self):
        from deeplearning4j_tpu_torch.common.integrity import (
            IntegrityListener)

        pw = (ParallelWrapper.Builder(small_model()).workers(2)
              .model_axis(2).build())
        pw.set_listeners(IntegrityListener(check_every=1))
        with pytest.raises(NotImplementedError, match="replicated"):
            pw.fit(self._iter(), epochs=1)

    def test_resize_refused(self):
        pw = (ParallelWrapper.Builder(small_model()).workers(4).model_axis(2)
              .build())
        with pytest.raises(NotImplementedError, match="data-axis"):
            pw.resize(1)

    def test_graph_table_refused(self):
        m = modules("torch")
        b = m.NeuralNetConfiguration.builder().seed(1).updater(m.Adam(0.01))
        conf = (m.graph.ComputationGraphConfiguration.graph_builder(b)
                .add_inputs("in")
                .add_layer("emb", m.L.EmbeddingSequenceLayer(
                    n_out=8, table_sharding="model"), "in")
                .add_layer("pool", m.L.GlobalPoolingLayer(
                    pooling_type="avg"), "emb")
                .add_layer("out", m.L.OutputLayer(
                    n_out=2, activation="softmax", loss="mcxent"), "pool")
                .set_outputs("out")
                .set_input_types(m.InputType.recurrent(16, 4)).build())
        g = m.graph.ComputationGraph(conf).init(device="cpu")
        pw = ParallelWrapper.Builder(g).workers(4).model_axis(2).build()
        rng = np.random.default_rng(1)
        x = rng.integers(0, 16, size=(8, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
        with pytest.raises(NotImplementedError, match="ComputationGraph"):
            pw.fit(DataSet(x, y))

    def test_model_axis_without_tables_trains(self):
        """A model axis over a model without sharded tables: every leaf
        replicated, one replica per data row."""
        pw = (ParallelWrapper.Builder(small_model()).workers(4).model_axis(2)
              .build())
        pw.fit(self._iter(), epochs=1)
        assert pw.workers_count == 2
