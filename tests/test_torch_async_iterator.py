"""The asynchronous feed and ``fit(host_prefetch=)`` in the port, on the
CPU (``data/record_iterator.AsyncDataSetIterator``,
``common/background.staged_iter``, ``data/pipeline.run_epochs``).

``AsyncDataSetIterator`` yields the JAX package's batches for the same
base (bitwise), with ``device_prefetch`` staged on the CPU here (the card's
copy stream runs in ``chip_smoke.py``'s phases 29-30 and the card-only
tests). ``fit(iterator, host_prefetch=2)`` is bitwise ``host_prefetch=0``
on both networks, padded batches and ``steps_per_dispatch`` included, and
a fit through the async feed matches the JAX network's within 1e-5 of the
parameters' scale.
"""

import threading
import time

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as T
from deeplearning4j_tpu_torch.common.background import staged_iter
from torch_parity import assert_scaled_close, mln_twins, modules


def datasets(M, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [M.DataSet(rng.normal(size=(4, 3)).astype(np.float32),
                      np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)])
            for _ in range(n)]


def arr(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a.value if hasattr(a, "value") else a)


@pytest.mark.parametrize("prefetch", [False, True],
                         ids=["host", "device_prefetch"])
@pytest.mark.parametrize("queue", [1, 3])
def test_same_batches_as_jax(prefetch, queue):
    kw = dict(queue_size=queue, device_prefetch=prefetch)
    t = list(T.AsyncDataSetIterator(T.ExistingDataSetIterator(
        datasets(T)), device="cpu" if prefetch else None, **kw))
    j = list(J.AsyncDataSetIterator(J.ExistingDataSetIterator(
        datasets(J)), **kw))
    assert len(t) == len(j) == 5
    for a, b in zip(t, j):
        for f in ("features", "labels"):
            x, y = arr(getattr(a, f)), arr(getattr(b, f))
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        if prefetch:
            assert isinstance(a.features, torch.Tensor)


def test_raw_tuples_and_feature_transform(tmp_path):
    """A raw-numpy container feed: uint8 staged, then divided by 255 by
    the transform, bitwise numpy's ``x.astype(float32) / 255`` (a tensor
    divisor: IEEE division, as on the card)."""
    from deeplearning4j_tpu_torch.data.binary_records import \
        BinaryRecordWriter

    p = tmp_path / "c.d4tbin"
    rng = np.random.default_rng(1)
    with BinaryRecordWriter(str(p), [("features", (3, 4, 4), "uint8"),
                                     ("label", (), "int32")],
                            chunk_records=4) as w:
        for i in range(10):
            w.append(rng.integers(0, 255, (3, 4, 4), dtype=np.uint8), i % 3)
    d255 = torch.full((), 255.0)
    it = T.AsyncDataSetIterator(
        T.BinaryRecordDataSetIterator(str(p), 4, num_classes=3,
                                      raw_numpy=True),
        queue_size=2, feature_transform=lambda x: x.float().div_(d255),
        device="cpu")
    raw = list(T.BinaryRecordDataSetIterator(str(p), 4, num_classes=3,
                                             raw_numpy=True))
    got = list(it)
    assert [g.features.shape[0] for g in got] == [4, 4, 2]
    for g, (x, y) in zip(got, raw):
        np.testing.assert_array_equal(g.features.numpy(),
                                      x.astype(np.float32) / 255)
        np.testing.assert_array_equal(g.labels.numpy(), y)
    # without device_prefetch the tuples come out as DataSets as they are
    plain = list(T.AsyncDataSetIterator(
        T.BinaryRecordDataSetIterator(str(p), 4, raw_numpy=True),
        device_prefetch=False))
    assert plain[0].features.dtype == np.uint8


def test_feature_transform_needs_device_prefetch():
    with pytest.raises(ValueError, match="device_prefetch"):
        T.AsyncDataSetIterator(T.ExistingDataSetIterator(datasets(T)),
                               device_prefetch=False,
                               feature_transform=lambda x: x)


def test_device_prefetch_defaults_to_the_card():
    """Staging on the card is the default; without a card it raises
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        it = T.AsyncDataSetIterator(T.ExistingDataSetIterator(datasets(T)))
        assert it.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            T.AsyncDataSetIterator(T.ExistingDataSetIterator(datasets(T)))


def test_worker_exception_propagates():
    class Boom(T.DataSetIterator):
        def __iter__(self):
            yield datasets(T, 1)[0]
            raise RuntimeError("reader failed")

    it = iter(T.AsyncDataSetIterator(Boom(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="reader failed"):
        next(it)


def test_overlaps_production_with_consumption():
    """The base is read on a worker thread while the consumer works."""
    seen = []

    class Slow(T.DataSetIterator):
        def __iter__(self):
            for ds in datasets(T, 4):
                seen.append(threading.current_thread().name)
                time.sleep(0.02)
                yield ds

    got = 0
    for _ in T.AsyncDataSetIterator(Slow(), queue_size=4, device="cpu"):
        time.sleep(0.02)
        got += 1
    assert got == 4 and len(seen) == 4
    assert all(n != threading.current_thread().name for n in seen)


@pytest.mark.parametrize("host_prefetch", [0, 1, 3])
@pytest.mark.parametrize("depth", [0, 2])
def test_staged_iter_keeps_order(depth, host_prefetch):
    staged = []
    out = list(staged_iter(range(10), stage=lambda v: staged.append(v) or v,
                           depth=depth, host_prefetch=host_prefetch))
    assert out == staged == list(range(10))


def _mln(fused):
    m = modules("torch")
    b = m.NeuralNetConfiguration.builder().seed(2).updater(
        m.Nesterovs(learning_rate=0.05, momentum=0.9))
    if fused:
        b = b.fused_update()
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    return MultiLayerNetwork(
        b.list().layer(m.L.DenseLayer(n_out=6, activation="tanh"))
        .layer(m.L.BatchNormalization())
        .layer(m.L.OutputLayer(n_out=2, loss="mcxent", activation="softmax"))
        .set_input_type(m.InputType.feed_forward(3)).build()
    ).init(device="cpu")


def _graph(fused):
    m = modules("torch")
    b = m.NeuralNetConfiguration.builder().seed(2).updater(m.Adam(0.02))
    if fused:
        b = b.fused_update()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("d", m.L.DenseLayer(n_out=6, activation="tanh"), "in")
    gb.add_layer("out", m.L.OutputLayer(n_out=2, loss="mcxent",
                                        activation="softmax"), "d")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ComputationGraph(gb.set_outputs("out").set_input_types(
        m.InputType.feed_forward(3)).build()).init(device="cpu")


@pytest.mark.parametrize("spd", [1, 2])
@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("make", [_mln, _graph], ids=["mln", "graph"])
def test_host_prefetch_is_bitwise(make, fused, spd):
    """fit(iterator, host_prefetch=2) against 0: the same parameters,
    states and updater state bitwise (a padded last batch, two epochs)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(22, 3)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 22)]
    nets = []
    for hp in (0, 2):
        net = make(fused)
        net.fit(T.NDArrayDataSetIterator(x, y, 8, shuffle=True), epochs=2,
                host_prefetch=hp, steps_per_dispatch=spd)
        nets.append(net)
    a, b = nets
    assert a._iteration == b._iteration == 6
    for ta, tb in ((a._params, b._params), (a._states, b._states),
                   (a._updater_state, b._updater_state)):
        from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

        for p in leaf_paths(ta or {}):
            assert torch.equal(get_path(ta, p), get_path(tb, p)), p


def test_host_prefetch_producer_error_reaches_fit():
    class Bad(T.DataSetIterator):
        def batch(self):
            return 4

        def __iter__(self):
            yield datasets(T, 1)[0]
            raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        _mln(True).fit(Bad(), host_prefetch=2)


def test_fit_through_async_record_pipeline_matches_jax(tmp_path):
    """CSV -> RecordReaderDataSetIterator -> AsyncDataSetIterator -> fit in
    both packages, from the same parameters: within 1e-5 of the
    parameters' scale after one epoch of 4 steps."""
    rng = np.random.default_rng(5)
    rows = [f"{a:.5f},{b:.5f},{c:.5f},{int(a + b > 0)}"
            for a, b, c in rng.normal(size=(30, 3))]
    (tmp_path / "d.csv").write_text("\n".join(rows) + "\n")

    def conf(which):
        m = modules(which)
        return (m.NeuralNetConfiguration.builder().seed(1)
                .updater(m.Sgd(0.1)).list()
                .layer(m.L.DenseLayer(n_out=5, activation="tanh"))
                .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                       activation="softmax"))
                .set_input_type(m.InputType.feed_forward(3)).build())

    jn, tn = mln_twins(conf("jax"), conf("torch"))
    for M, net, kw in ((J, jn, {}), (T, tn, {"device": "cpu"})):
        rr = M.CSVRecordReader()
        rr.initialize(M.FileSplit(tmp_path))
        it = M.AsyncDataSetIterator(M.RecordReaderDataSetIterator(
            rr, 8, label_index=3, num_classes=2), queue_size=2, **kw)
        net.fit(it, epochs=1)
    want = np.asarray(jn.params().value if hasattr(jn.params(), "value")
                      else jn.params())
    assert_scaled_close(tn.params(), want, "parameters", tol=1e-5)
    assert tn._iteration == jn._iteration == 4
