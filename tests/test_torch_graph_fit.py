"""``ComputationGraph.fit`` over the input pipeline, against the JAX
package's, on the CPU.

Both graphs are built from one description with the JAX graph's weights
carried across, and take the same numpy batches.

Tolerances, and why:
- the padded fit of a dense graph (22 examples at batch 8: the last batch
  of 6 padded by wrapping rows with example weight 0) against the JAX
  padded fit: losses within 1e-5 relative, parameters rtol 1e-5 / atol
  1e-6, the MultiLayerNetwork pipeline's bound
  (tests/test_torch_multilayer.py); the same for a two-input, two-output
  graph fed MultiDataSets;
- the residual graph with BatchNormalization through the pipeline: rtol
  1e-4 / atol 1e-6, the graph training bound of tests/test_torch_train.py
  (the batch statistics' sums run in another order and the difference
  grows with each step);
- the port's padded fit against its own ``pad_partial=False`` fit: within
  4 float32 ulp of the parameters' scale. Not bitwise: the JAX package's
  own graph test asks for equal bits and fails (its padded and unpadded
  fits differ in 2 of 16 elements), because the weight gradient sums 8
  rows where the unpadded step sums 6;
- ``steps_per_dispatch`` against one step per dispatch: bitwise (the same
  steps, run back to back).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
from deeplearning4j_tpu.data.iterators import (
    NDArrayDataSetIterator as JNDIter)
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import (DataSet, MultiDataSet,
                                           NDArrayDataSetIterator)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.optimize import (CollectScoresIterationListener,
                                               PipelineMetricsListener)
from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
from torch_parity import modules, numpy_tree, residual_conf

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


def dense_conf(which):
    """tests/test_input_pipeline.py's graph (TestGraphPipeline)."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(7).updater(m.Sgd(0.05))
         .activation("tanh").weight_init("xavier"))
    return (m.graph.ComputationGraphConfiguration.graph_builder(b)
            .add_inputs("in")
            .add_layer("d", m.L.DenseLayer(n_out=16), "in")
            .add_layer("out", m.L.OutputLayer(n_out=3, loss="mcxent",
                                              activation="softmax"), "d")
            .set_outputs("out").set_input_types(m.InputType.feed_forward(5))
            .build())


def multi_conf(which):
    """Two inputs, two outputs (softmax/mcxent and identity/mse)."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(9)
         .updater(m.Nesterovs(0.05, momentum=0.9)).activation("tanh"))
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("a", "b")
    gb.add_layer("da", m.L.DenseLayer(n_out=8), "a")
    gb.add_layer("db", m.L.DenseLayer(n_out=8), "b")
    gb.add_vertex("m", m.graph.MergeVertex(), "da", "db")
    gb.add_layer("cls", m.L.OutputLayer(n_out=3, loss="mcxent",
                                        activation="softmax"), "m")
    gb.add_layer("reg", m.L.OutputLayer(n_out=2, loss="mse",
                                        activation="identity"), "m")
    gb.set_outputs("cls", "reg")
    gb.set_input_types(m.InputType.feed_forward(5),
                       m.InputType.feed_forward(4))
    return gb.build()


def twins(make, **kw):
    jg = JGraph(make("jax", **kw)).init()
    tg = TGraph(make("torch", **kw)).init(device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params), numpy_tree(jg._states))
    return jg, tg


def _data(n=22, f=5, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return x, np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]


def _close_trees(tree, jtree, rtol=RTOL, atol=ATOL):
    for n, d in numpy_tree(jtree).items():
        for k, v in d.items():
            np.testing.assert_allclose(tree[n][k].detach().numpy(), v,
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{n}/{k}")


class MDSIterator:
    """MultiDataSets of ``batch`` rows (the last one short), for either
    package: ``reset``, ``__iter__`` and ``batch`` as the iterators."""

    def __init__(self, cls, arrays, batch):
        self.cls, self.arrays, self.b = cls, arrays, batch

    def reset(self):
        pass

    def batch(self):
        return self.b

    def __iter__(self):
        xa, xb, y1, y2 = self.arrays
        for i in range(0, len(xa), self.b):
            s = slice(i, i + self.b)
            yield self.cls([xa[s], xb[s]], [y1[s], y2[s]])


def test_padded_fit_matches_jax_padded_fit():
    jg, tg = twins(dense_conf)
    x, y = _data()
    jg.fit(JNDIter(x, y, batch_size=8), epochs=2)
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2)
    assert tg._iteration == jg._iteration == 6
    assert tg._epoch == jg._epoch == 2
    assert OpProfiler.get().counter_value("pipeline/padded_batches") == 2
    want = jg.score_value
    assert abs(tg.score_value - want) <= LOSS_RTOL * abs(want)
    _close_trees(tg._params, jg._params)
    np.testing.assert_allclose(tg.params().numpy(), np.asarray(
        jg.params().value), rtol=RTOL, atol=ATOL)


def test_residual_graph_through_the_pipeline_matches_jax():
    nest = lambda m: m.Nesterovs(0.01, momentum=0.9)  # noqa: E731
    jg, tg = twins(lambda w: residual_conf(w, False, 16, updater=nest,
                                           fused_update=True))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(10, 4, 8, 8)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 10)]
    jg.fit(JNDIter(x, y, batch_size=4), epochs=2)
    tg.fit(NDArrayDataSetIterator(x, y, batch_size=4), epochs=2)
    assert tg._iteration == jg._iteration == 6
    _close_trees(tg._params, jg._params, 1e-4)
    _close_trees(tg._states, jg._states, 1e-4)
    _close_trees(tg._updater_state["v"], jg._updater_state["v"], 1e-4)
    counters = OpProfiler.get().get_counters()
    assert counters["precision/fused_hits"] == 6
    assert counters.get("precision/fused_fallbacks", 0) == 0


def test_padded_fit_matches_the_unpadded_fit_within_4_ulp():
    x, y = _data()
    runs = []
    for pad in (True, False):
        _, tg = twins(dense_conf)
        tg.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2,
               pad_partial=pad)
        runs.append(tg.params().numpy())
    pa, pb = runs
    assert np.abs(pa - pb).max() <= 4 * np.spacing(np.abs(pb).max())


def test_drop_remainder_and_metrics_listener():
    _, tg = twins(dense_conf)
    metrics = PipelineMetricsListener()
    tg.set_listeners(metrics)
    x, y = _data()
    tg.fit(DataSet(x, y), epochs=2, batch_size=8, drop_remainder=True)
    assert tg._iteration == 4 and tg._epoch == 2
    assert [s["epoch"] for s in metrics.snapshots] == [1, 2]
    assert metrics.snapshots[-1]["counters"]["pipeline/dropped_batches"] == 2


def test_steps_per_dispatch_matches_one_step_per_dispatch():
    x, y = _data(32)
    runs = []
    for k in (2, 1):
        _, tg = twins(dense_conf)
        scores = CollectScoresIterationListener()
        tg.set_listeners(scores)
        tg.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2,
               steps_per_dispatch=k)
        runs.append((tg.params(), scores.scores))
    (pa, sa), (pb, sb) = runs
    assert torch.equal(pa, pb) and sa == sb and len(sa) == 8


def test_multidataset_fit_matches_jax():
    jg, tg = twins(multi_conf)
    rng = np.random.default_rng(5)
    arrays = (rng.normal(size=(10, 5)).astype(np.float32),
              rng.normal(size=(10, 4)).astype(np.float32),
              np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)],
              rng.normal(size=(10, 2)).astype(np.float32))
    jg.fit(MDSIterator(JMDS, arrays, 4), epochs=2)
    tg.fit(MDSIterator(MultiDataSet, arrays, 4), epochs=2)
    assert tg._iteration == jg._iteration == 6
    assert OpProfiler.get().counter_value("pipeline/padded_batches") == 2
    assert abs(tg.score_value - jg.score_value) <= \
        LOSS_RTOL * abs(jg.score_value)
    _close_trees(tg._params, jg._params)
    # one MultiDataSet, no batch size: the serial step
    whole = (JMDS(arrays[:2], arrays[2:]), MultiDataSet(arrays[:2],
                                                         arrays[2:]))
    jg.fit(whole[0])
    tg.fit(whole[1])
    _close_trees(tg._params, jg._params)
    with pytest.raises(TypeError, match="re-batched"):
        tg.fit(whole[1], batch_size=4)


def test_evaluate_score_gradients_and_summary_match_jax():
    jg, tg = twins(dense_conf)
    x, y = _data(16, seed=4)
    assert tg.evaluate(NDArrayDataSetIterator(x, y, 8)).accuracy() == \
        jg.evaluate(JNDIter(x, y, 8)).accuracy()
    jgrads, jscore = jg.compute_gradient_and_score(JDataSet(x, y))
    tgrads, tscore = tg.compute_gradient_and_score(DataSet(x, y))
    assert abs(tscore - jscore) <= LOSS_RTOL * abs(jscore)
    _close_trees(tgrads, jgrads)
    assert tg.num_params() == jg.num_params() == 5 * 16 + 16 + 16 * 3 + 3
    assert tg.summary() == jg.summary()
    # fit(host_prefetch=) is ported: the batches assembled on a worker
    # thread give bitwise the steps of the serial feed
    a, b = twins(dense_conf)[1], twins(dense_conf)[1]
    a.fit(NDArrayDataSetIterator(x, y, 5), host_prefetch=2)
    b.fit(NDArrayDataSetIterator(x, y, 5))
    assert torch.equal(a.params(), b.params())
