"""The port's training path (``ComputationGraph.fit``) against the JAX
package's, on the CPU.

Both graphs are built from one description (``torch_parity.residual_conf``
with Nesterovs and l2), parameters, BN state and a nonzero momentum are
carried across (``graph_state_from_numpy``, ``updater_state_from_numpy``),
and both take the same batches. The JAX side runs its fused update in its
CPU default (``xla``) mode; the port runs the plain version of its kernel.

Tolerances, and why: every loss of 3 steps, the parameters and the BN
running statistics within rtol 1e-4 / atol 1e-6 (the inference parity
bound of tests/test_torch_graph.py: float32 sums run in another order in the
two frameworks, and the difference grows a little with each step). With bfloat16 moments the port
draws its own random bits, so the two runs only share the documented
envelope ``|Δloss| <= 1e-3 + 0.05·|loss|`` (the JAX package's
``learning/precision.py:30-38``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel.sharding import Zero1Plan as JPlan
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.models import ResNet50
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.util.convert import (graph_state_from_numpy,
                                                    updater_state_from_numpy)
from torch_parity import numpy_tree, randomize_bn, residual_conf

RTOL, ATOL = 1e-4, 1e-6
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


def _nesterovs(m):
    return m.Nesterovs(0.01, momentum=0.9)


def _batches(n=STEPS, batch=4, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, 4, 8, 8)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, batch)])
            for _ in range(n)]


def _twins(fused_update=True, state_dtype=None, flat_momentum=False,
           channels=16):
    """JAX graph and port graph with the same weights, BN state and a
    seeded nonzero momentum."""
    jconf = residual_conf("jax", False, channels, updater=_nesterovs,
                          l2=1e-4, fused_update=fused_update)
    tconf = residual_conf("torch", False, channels, updater=_nesterovs,
                          l2=1e-4, fused_update=fused_update)
    for conf in (jconf, tconf):
        conf.global_conf.updater.state_dtype = state_dtype
    jg = JGraph(jconf).init()
    tg = TGraph(tconf).init(device="cpu")
    params, states = numpy_tree(jg._params), numpy_tree(jg._states)
    randomize_bn(params, states, seed=7)
    rng = np.random.default_rng(9)
    mom = {n: {k: (rng.normal(size=v.shape) * 1e-2).astype(np.float32)
               for k, v in d.items()} for n, d in params.items()}
    if state_dtype:
        mom = {n: {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                   for k, v in d.items()} for n, d in mom.items()}
    jstate = {"v": mom}
    jg._params = {n: {k: jnp.asarray(v) for k, v in d.items()}
                  for n, d in params.items()}
    jg._states = {n: {k: jnp.asarray(v) for k, v in d.items()}
                  for n, d in states.items()}
    jg._updater_state = {"v": {n: {k: jnp.asarray(v) for k, v in d.items()}
                               for n, d in mom.items()}}
    graph_state_from_numpy(tg, params, states)
    if flat_momentum:
        # the JAX package's other layout: flat buckets (ZeRO-1, 3 shards)
        jstate = JPlan(jg._params, 3).flatten_state(jstate)
        jstate = {k: {b: np.asarray(a) for b, a in v.items()}
                  for k, v in jstate.items()}
    updater_state_from_numpy(tg, jstate)
    return jg, tg


def _fit_both(jg, tg, batches):
    jl, tl = [], []
    for x, y in batches:
        jg.fit(JDataSet(x, y))
        jl.append(float(jg.score_value))
        tg.fit(DataSet(x, y))
        tl.append(tg.score_value)
    return np.array(jl), np.array(tl)


def _assert_close_trees(got, want, what):
    for n, d in want.items():
        for k, v in d.items():
            a = got[n][k].detach().float().numpy()
            b = np.asarray(v, np.float32)
            assert np.allclose(a, b, rtol=RTOL, atol=ATOL), \
                (what, n, k, np.abs(a - b).max())


@pytest.mark.parametrize("flat_momentum", [False, True])
@pytest.mark.parametrize("fused_update", [True, False])
def test_three_steps_match_jax(fused_update, flat_momentum):
    jg, tg = _twins(fused_update, flat_momentum=flat_momentum)
    jl, tl = _fit_both(jg, tg, _batches())
    assert np.allclose(tl, jl, rtol=RTOL, atol=ATOL), (tl, jl)
    _assert_close_trees(tg._params, numpy_tree(jg._params), "params")
    _assert_close_trees(tg._states, numpy_tree(jg._states), "states")
    _assert_close_trees(tg._updater_state["v"],
                        numpy_tree(jg._updater_state["v"]), "momentum")
    assert tg._iteration == jg._iteration == STEPS
    assert tg._epoch == STEPS
    prof = OpProfiler.get()
    assert prof.counter_value("precision/fused_hits") == \
        (STEPS if fused_update else 0)
    assert prof.counter_value("precision/fused_fallbacks") == 0


def test_bf16_state_within_the_envelope():
    jg, tg = _twins(True, state_dtype="bfloat16")
    jl, tl = _fit_both(jg, tg, _batches(5))
    assert np.all(np.abs(tl - jl) <= 1e-3 + 0.05 * np.abs(jl)), (tl, jl)
    v = tg._updater_state["v"]
    assert all(t.dtype == torch.bfloat16 for d in v.values()
               for t in d.values())
    prof = OpProfiler.get()
    n = sum(t.numel() for d in tg._params.values() for t in d.values())
    assert prof.counter_value("precision/sr_draws") == 5 * n
    assert prof.counter_value("precision/updater_state_bytes_bfloat16") \
        == 2 * n


def test_fused_flat_and_per_leaf_paths_are_bitwise_equal():
    """Float32 state: the fused flat path (gradients born flat) and the
    per-leaf path give the same bits."""
    runs = []
    for fused in (True, False):
        _, tg = _twins(fused)
        OpProfiler.get().reset()
        losses = [tg.fit(DataSet(x, y)) or tg.score_value
                  for x, y in _batches()]
        gauge = OpProfiler.get().counter_value(
            "precision/grads_flat_in_step")
        assert gauge == (1 if fused else 0)
        runs.append((losses, tg))
    (l0, g0) = runs[0]
    for losses, g in runs[1:]:
        assert losses == l0
        for n, d in g0._params.items():
            for k, t in d.items():
                assert torch.equal(t, g._params[n][k]), (n, k)


def test_params_are_views_of_one_bucket_and_change_in_place():
    _, tg = _twins(True)
    x, y = _batches(1)[0]
    tg.fit(DataSet(x, y))
    store = tg._flat
    assert store is not None and list(store.params) == ["flat::float32"]
    bucket = store.params["flat::float32"]
    before = bucket.clone()
    leaf = tg._params["c1"]["W"]
    assert leaf._base is bucket and leaf.requires_grad
    assert leaf.grad is not None and leaf.grad._base is \
        store.grads["flat::float32"]
    tg.fit(DataSet(x, y))
    assert tg._params["c1"]["W"] is leaf
    assert not torch.equal(before, bucket)
    # output() after training reads the updated parameters
    out = tg.output(x)[0]
    assert torch.isfinite(out).all()


def test_fit_over_an_iterable_and_epochs():
    _, tg = _twins(True)
    data = [DataSet(x, y) for x, y in _batches(2)]
    tg.fit(data, epochs=2)
    assert tg._iteration == 4 and tg._epoch == 2
    x, y = _batches(1, seed=5)[0]
    s = tg.score(DataSet(x, y))
    assert np.isfinite(s) and s > 0


def test_score_matches_jax():
    jg, tg = _twins(True)
    x, y = _batches(1)[0]
    want = jg.score(JDataSet(x, y))
    assert abs(tg.score(DataSet(x, y)) - want) <= 1e-5 * (abs(want) + 1)


def test_updater_state_carry_over_checks():
    jg, tg = _twins(True)
    bad = {"v": {n: dict(d) for n, d in numpy_tree(
        jg._updater_state["v"]).items()}}
    bad["v"]["c1"]["W"] = bad["v"]["c1"]["W"][:1]
    with pytest.raises(ValueError, match="shape"):
        updater_state_from_numpy(tg, bad)
    with pytest.raises(ValueError, match="slots"):
        updater_state_from_numpy(tg, {"m": bad["v"]})
    short = {"v": {"flat::float32": np.zeros(3, np.float32)}}
    with pytest.raises(ValueError, match="does not match"):
        updater_state_from_numpy(tg, short)


def test_bf16_compute_trains_with_float32_master_params():
    _, tg = _twins(True, state_dtype="bfloat16")
    tg.conf.global_conf.compute_dtype = "bfloat16"
    for x, y in _batches():
        tg.fit(DataSet(x, y))
        assert np.isfinite(tg.score_value)
    assert all(t.dtype == torch.float32 for d in tg._params.values()
               for t in d.values())
    assert all(t.dtype == torch.float32 for d in tg._states.values()
               for t in d.values())


def test_non_elementwise_updater_falls_back_counted():
    _, tg = _twins(True)
    tg.conf.global_conf.updater.elementwise = False
    x, y = _batches(1)[0]
    tg.fit(DataSet(x, y))
    prof = OpProfiler.get()
    assert prof.counter_value("precision/fused_fallbacks") == 1
    assert prof.counter_value("precision/fused_hits") == 0
    assert tg._flat is None and np.isfinite(tg.score_value)


def test_resnet50_one_bucket_and_one_fused_step():
    """The bench configuration's layout: 161 leaves in one float32 bucket
    of 25,557,032 elements, bf16 momentum of 51,114,064 bytes; one fit step
    at 32x32 takes one fused update and no fallback."""
    g = ResNet50(num_classes=1000, image_size=32).init(device="cpu")
    g.conf.global_conf.fused_update = True
    g.conf.global_conf.updater.state_dtype = "bfloat16"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, 2)]
    w0 = g._params["output"]["W"].clone()
    g.fit(DataSet(x, y))
    store = g._flat
    assert store.plan.n_leaves == 161
    assert [(b.key, b.total) for b in store.plan.buckets] == \
        [("flat::float32", 25_557_032)]
    prof = OpProfiler.get()
    assert prof.counter_value("precision/updater_state_bytes_total") == \
        51_114_064
    assert prof.counter_value("precision/fused_hits") == 1
    assert prof.counter_value("precision/fused_fallbacks") == 0
    assert prof.counter_value("precision/grads_flat_in_step") == 1
    assert np.isfinite(g.score_value)
    assert not torch.equal(w0, g._params["output"]["W"])
    assert tupdate.fused_update_launches == 0      # CPU: the plain version


def _embedding_conf(which, sequence):
    """An embedding layer with a dropout of its own, then layers without
    one (the global dropout stays 0)."""
    from torch_parity import modules

    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(5).updater(m.Sgd(0.5))
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    if sequence:
        gb.add_layer("emb", m.L.EmbeddingSequenceLayer(n_out=8, dropout=0.5),
                     "in")
        gb.add_layer("pool", m.L.GlobalPoolingLayer(pooling_type="avg"),
                     "emb")
        prev, it = "pool", m.InputType.recurrent(20, 6)
    else:
        gb.add_layer("emb", m.L.EmbeddingLayer(n_out=8, dropout=0.5,
                                               activation="tanh"), "in")
        prev, it = "emb", m.InputType.feed_forward(20)
    gb.add_layer("out", m.L.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"), prev)
    gb.set_outputs("out")
    gb.set_input_types(it)
    return gb.build()


@pytest.mark.parametrize("sequence", [False, True])
def test_embedding_layer_with_dropout_trains_as_jax(sequence):
    """The JAX embedding layers never apply their dropout, so a graph whose
    embedding layer has one trains; the port's does too, and matches it
    from copied parameters (rtol 1e-4 / atol 1e-6, as above)."""
    jg = JGraph(_embedding_conf("jax", sequence)).init()
    tg = TGraph(_embedding_conf("torch", sequence)).init(device="cpu")
    assert tg.conf.nodes["emb"].layer.dropout == 0.5
    assert tg.conf.nodes["out"].layer.dropout == 0.0
    graph_state_from_numpy(tg, numpy_tree(jg._params), numpy_tree(jg._states))
    rng = np.random.default_rng(2)
    batches = [(rng.integers(0, 20, size=(8, 6) if sequence else (8, 1))
                .astype(np.int32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
               for _ in range(STEPS)]
    w0 = tg._params["emb"]["W"].detach().clone()
    jl, tl = _fit_both(jg, tg, batches)
    assert np.allclose(tl, jl, rtol=RTOL, atol=ATOL), (tl, jl)
    _assert_close_trees(tg._params, numpy_tree(jg._params), "params")
    assert not torch.equal(w0, tg._params["emb"]["W"])
