"""In-step telemetry and the NaN guard in the port against the JAX package,
on the CPU (``optimize/telemetry.py``, ``nn/_train.TrainableNetwork._step``).

A small MultiLayerNetwork and a small ComputationGraph, both with a
BatchNormalization layer, are built in both packages from one description
with the JAX network's parameters carried across. The same batches (made
with numpy from a seed; one with a NaN in its features) go through both.
Tolerances: every aux entry within rtol 1e-5 of JAX's ``layer_stats``
(float32 in both; NaN where JAX has NaN), ``nonfinite``,
``nonfinite_total`` and ``skipped`` exactly; after a poisoned step under
``"skip"`` the parameters, the updater state and the BN statistics bitwise
the pre-step ones, on the fused and the per-leaf updater.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIter
from deeplearning4j_tpu.optimize import telemetry as jtel
from deeplearning4j_tpu.ui import FileStatsStorage as JFileStorage
from deeplearning4j_tpu.ui import InMemoryStatsStorage as JMemStorage
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize import telemetry as ttel
from deeplearning4j_tpu_torch.ui import FileStatsStorage, InMemoryStatsStorage
from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
from torch_parity import mln_twins, modules, numpy_tree

RTOL = 1e-5
EXACT = ("nonfinite", "nonfinite_total", "skipped")


class Capture:
    """A telemetry listener that keeps every aux on the host."""

    wants_telemetry = True

    def __init__(self):
        self.aux = []

    def iteration_done(self, model, iteration, score):
        pass

    def telemetry_done(self, model, iteration, aux):
        self.aux.append((iteration, {
            k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
            for k, v in aux.items()}))


def mln_conf(which, fused, updater=None):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(3)
         .updater(updater(m) if updater else
                  m.Nesterovs(learning_rate=0.1, momentum=0.9)))
    if fused:
        b = b.fused_update()
    return (b.list()
            .layer(m.L.DenseLayer(n_out=8, activation="tanh"))
            .layer(m.L.BatchNormalization())
            .layer(m.L.DenseLayer(n_out=6, activation="relu"))
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(5)).build())


def graph_conf(which, fused):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(5)
         .updater(m.Adam(0.05)))
    if fused:
        b = b.fused_update()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("d1", m.L.DenseLayer(n_out=8, activation="tanh"), "in")
    gb.add_layer("bn", m.L.BatchNormalization(), "d1")
    gb.add_layer("d2", m.L.DenseLayer(n_out=6, activation="relu"), "in")
    gb.add_vertex("cat", m.graph.MergeVertex(), "bn", "d2")
    gb.add_layer("out", m.L.OutputLayer(n_out=3, loss="mcxent",
                                        activation="softmax"), "cat")
    return (gb.set_outputs("out")
            .set_input_types(m.InputType.feed_forward(5)).build())


def graph_twins(fused):
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph

    jg = JGraph(graph_conf("jax", fused)).init()
    tg = TGraph(graph_conf("torch", fused)).init(device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params),
                           numpy_tree(jg._states))
    return jg, tg


def twins(kind, fused):
    if kind == "mln":
        return mln_twins(mln_conf("jax", fused), mln_conf("torch", fused))
    return graph_twins(fused)


def batches(n=4, seed=0, nan_at=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.normal(size=(6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        if i == nan_at:
            x[2, 1] = np.nan
        out.append((x, y))
    return out


def assert_aux_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.dtype,
                                                           w.dtype)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       equal_nan=True, err_msg=k)


def _tree_leaves(tree):
    return [get_path(tree, p) for p in leaf_paths(tree or {})]


def snapshot(net):
    """Copies of the parameters, layer states and updater state."""
    return [[t.detach().clone() for t in _tree_leaves(tr)]
            for tr in (net._params, net._states, net._updater_state)]


def assert_snapshot_equal(a, b):
    for xa, xb in zip(a, b):
        assert len(xa) == len(xb)
        for u, v in zip(xa, xb):
            assert torch.equal(u, v)


@pytest.mark.parametrize("guard", [False, True], ids=["stats", "guard"])
@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_aux_matches_jax_serial(kind, fused, guard):
    """fit(DataSet) steps (the serial loop), the second poisoned: every
    aux entry as JAX's, on both networks and both updater paths."""
    jn, tn = twins(kind, fused)
    cj, ct = Capture(), Capture()
    extra_j = [jtel.NanSentinelListener("skip", 10)] if guard else []
    extra_t = [ttel.NanSentinelListener("skip", 10)] if guard else []
    jn.set_listeners(cj, *extra_j)
    tn.set_listeners(ct, *extra_t)
    for x, y in batches(3, nan_at=1):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert len(ct.aux) == len(cj.aux) == 3
    for (it_t, a_t), (it_j, a_j) in zip(ct.aux, cj.aux):
        assert it_t == it_j
        assert_aux_close(a_t, a_j)
    assert int(ct.aux[1][1]["nonfinite_total"]) > 0
    if guard:
        assert [int(a["skipped"]) for _, a in ct.aux] == [0, 1, 0]
        params = tn.params().numpy()
        assert np.isfinite(params).all()
        np.testing.assert_allclose(params, np.asarray(jn.params().value
                                                      if hasattr(
                                                          jn.params(),
                                                          "value")
                                                      else jn.params()),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("spd", [1, 2], ids=["per_step", "chunked"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_sink_series_match_jax_pipeline(kind, spd):
    """fit(iterator) through the input pipeline (a padded last batch; with
    steps_per_dispatch=2 the chunked loop): TelemetrySink's stored series,
    tag for tag and value for value, as JAX's (rtol 1e-5)."""
    jn, tn = twins(kind, True)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 20)]
    js, ts = JMemStorage(), InMemoryStatsStorage()
    jn.set_listeners(jtel.TelemetrySink(js, drain_every_n=2))
    tn.set_listeners(ttel.TelemetrySink(ts, drain_every_n=2))
    jn.fit(JIter(x, y, batch_size=8), epochs=2, steps_per_dispatch=spd)
    tn.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2,
           steps_per_dispatch=spd)
    assert ts.tags() == js.tags()
    for tag in js.tags():
        got, want = ts.series(tag), js.series(tag)
        assert [s for s, _ in got] == [s for s, _ in want] == list(
            range(1, 7)), tag
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=RTOL,
                                   err_msg=tag)


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_skip_restores_pre_step_state_bitwise(kind, fused):
    """After a poisoned step under "skip": parameters, updater state and
    BN running statistics bitwise the pre-step ones; the next step
    trains."""
    _, tn = twins(kind, fused)
    sent = ttel.NanSentinelListener("skip", check_every_n=1)
    tn.set_listeners(sent)
    (x0, y0), (xb, yb), (x2, y2) = batches(3, nan_at=1)
    tn.fit(DataSet(x0, y0))
    before = snapshot(tn)
    tn.fit(DataSet(xb, yb))
    assert_snapshot_equal(before, snapshot(tn))
    assert len(sent.events) == 1 and sent.events[0]["iteration"] == 2
    tn.fit(DataSet(x2, y2))
    after = snapshot(tn)
    assert not all(torch.equal(u, v) for u, v in zip(before[0], after[0]))
    assert all(np.isfinite(t.numpy()).all() for t in after[0])


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
def test_skip_restores_updater_state_as_jax(fused):
    """Clean, poisoned, clean equals clean, clean (Nesterovs at a fixed
    rate: the skipped step leaves no trace), in the port as in JAX."""
    def run(which, seq):
        jn, tn = mln_twins(mln_conf("jax", fused), mln_conf("torch", fused))
        net = jn if which == "jax" else tn
        mk = (jtel if which == "jax" else ttel).NanSentinelListener
        net.set_listeners(mk("skip", check_every_n=1))
        DS = JDataSet if which == "jax" else DataSet
        for x, y in seq:
            net.fit(DS(x, y))
        return np.asarray(net.params().value if which == "jax"
                          else net.params().numpy())

    clean, bad, clean2 = batches(3, nan_at=1)
    for which in ("jax", "torch"):
        a = run(which, [clean, bad, clean2])
        b = run(which, [clean, clean2])
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_raise_policy_names_layer():
    _, tn = twins("mln", True)
    tn.set_listeners(ttel.NanSentinelListener("raise", check_every_n=1))
    (xb, yb), = batches(1, nan_at=0)
    with pytest.raises(FloatingPointError, match="DenseLayer"):
        tn.fit(DataSet(xb, yb))


def test_warn_policy_logs_and_continues(caplog):
    _, tn = twins("graph", False)
    sent = ttel.NanSentinelListener("warn", check_every_n=1)
    tn.set_listeners(sent)
    (xb, yb), = batches(1, nan_at=0)
    with caplog.at_level(logging.WARNING, "deeplearning4j_tpu_torch"):
        tn.fit(DataSet(xb, yb))
    assert any("non-finite" in r.message for r in caplog.records)
    assert sent.events and sent.events[0]["total"] > 0
    # "warn" keeps no guard: the poisoned update landed
    assert not np.isfinite(tn.params().numpy()).all()


def test_bad_policy_rejected():
    with pytest.raises(ValueError, match="policy"):
        ttel.NanSentinelListener("explode")


@pytest.mark.parametrize("policy", ["warn", "skip", "cull", "raise"])
def test_config_for_matches_jax(policy):
    """The listener set's telemetry config, field for field."""
    for make_j, make_t in (
            (lambda: [jtel.NanSentinelListener(policy)],
             lambda: [ttel.NanSentinelListener(policy)]),
            (lambda: [jtel.TelemetrySink(JMemStorage()),
                      jtel.NanSentinelListener(policy)],
             lambda: [ttel.TelemetrySink(InMemoryStatsStorage()),
                      ttel.NanSentinelListener(policy)])):
        j, t = jtel.config_for(make_j()), ttel.config_for(make_t())
        assert (t.nan_guard, t.member_cull, t.stats,
                t.integrity_every) == (j.nan_guard, j.member_cull, j.stats,
                                       j.integrity_every)
    assert ttel.config_for([]) is None and jtel.config_for([]) is None


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_layer_names_match_jax(kind):
    jn, tn = twins(kind, False)
    assert ttel.layer_names(tn) == jtel.layer_names(jn)


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
def test_frozen_layer_under_guard(fused):
    """A FrozenLayer network under "skip": the frozen parameters bitwise
    through a clean and a poisoned step; the poisoned step's state bitwise
    the pre-step one; the trainable layers train on the next step."""
    m = modules("torch")
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    b = m.NeuralNetConfiguration.builder().seed(4).updater(m.Adam(0.05))
    if fused:
        b = b.fused_update()
    conf = (b.list()
            .layer(m.L.FrozenLayer(layer=m.L.DenseLayer(
                n_out=8, activation="tanh")))
            .layer(m.L.BatchNormalization())
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(5)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    net.set_listeners(ttel.NanSentinelListener("skip", check_every_n=1))
    frozen0 = [t.detach().clone() for t in _tree_leaves(net._params["0000"])]
    (x0, y0), (xb, yb), (x2, y2) = batches(3, nan_at=1)
    net.fit(DataSet(x0, y0))
    before = snapshot(net)
    net.fit(DataSet(xb, yb))
    assert_snapshot_equal(before, snapshot(net))
    net.fit(DataSet(x2, y2))
    for a, b_ in zip(frozen0, _tree_leaves(net._params["0000"])):
        assert torch.equal(a, b_)
    head = _tree_leaves(net._params["0002"])
    n_head = len(head)
    assert not all(torch.equal(u, v)
                   for u, v in zip(before[0][-n_head:], head))


def _tbptt_conf(which):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(9)
         .updater(m.Adam(learning_rate=0.01)).list()
         .layer(m.L.SimpleRnn(n_out=4))
         .layer(m.L.RnnOutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax")))
    return (b.backprop_type("TruncatedBPTT").tbptt_length(4)
            .set_input_type(m.InputType.recurrent(2, 12)).build())


@pytest.mark.parametrize("policy", ["warn", "skip"])
def test_tbptt_mid_segment_nan(policy):
    """A NaN confined to a middle segment (t 4..7 of 12) reaches the
    sentinel, as in JAX: the events agree; under "skip" exactly one
    segment is skipped, its carries kept, and the parameters stay
    finite."""
    jn, tn = mln_twins(_tbptt_conf("jax"), _tbptt_conf("torch"))
    sj = jtel.NanSentinelListener(policy, check_every_n=1)
    st = ttel.NanSentinelListener(policy, check_every_n=1)
    cj, ct = Capture(), Capture()
    jn.set_listeners(sj, cj)
    tn.set_listeners(st, ct)
    rng = np.random.RandomState(0)
    x = rng.randn(6, 12, 2).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[:, :, 0].cumsum(1) > 0).astype(int)]
    x[2, 5, 1] = np.nan
    jn.fit(JDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert st.events == sj.events and st.events[0]["total"] > 0
    (_, a_t), = ct.aux
    (_, a_j), = cj.aux
    for k in ("nonfinite", "nonfinite_total") + (
            ("skipped",) if policy == "skip" else ()):
        np.testing.assert_array_equal(a_t[k], a_j[k], err_msg=k)
    if policy == "skip":
        assert int(a_t["skipped"]) == 1
        assert np.isfinite(tn.params().numpy()).all()


def test_sink_buffers_without_reading_back():
    """TelemetrySink reads nothing between drains (the aux stays
    untouched until the window is full)."""
    sink = ttel.TelemetrySink(InMemoryStatsStorage(), drain_every_n=100)

    class Spy:
        def __getattr__(self, name):
            raise AssertionError(f"read {name}")

    class FakeModel:
        conf = None
        _params = {}

    aux = {k: Spy() for k in ("loss", "grad_norm", "update_norm",
                              "param_norm", "update_ratio", "nonfinite",
                              "nonfinite_total")}
    for it in range(1, 50):
        sink.telemetry_done(FakeModel(), it, aux)
    assert len(sink._buf) == 49


def test_readback_is_one_copy(monkeypatch):
    """A drain window crosses to the host in one ``.cpu()``."""
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(self.shape)
        return real(self, *a, **k)

    aux = {"loss": torch.tensor(1.5), "nonfinite": torch.tensor([0, 2],
                                                                dtype=torch.int32),
           "nonfinite_total": torch.tensor(2, dtype=torch.int32),
           "grad_norm": torch.tensor([1.0, 2.0])}
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    host = ttel.readback([aux, aux, aux])
    assert len(calls) == 1 and len(host) == 3
    assert host[0]["nonfinite_total"] == 2 and host[2]["loss"] == 1.5
    np.testing.assert_array_equal(host[1]["nonfinite"], [0, 2])


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_file_storage_records_match_jax(kind, tmp_path):
    """FileStatsStorage's JSONL from a sink: the same records line for
    line as the JAX package's (but their times)."""
    jn, tn = twins(kind, True)
    jp, tp = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    js, ts = JFileStorage(str(jp)), FileStatsStorage(str(tp))
    jn.set_listeners(jtel.TelemetrySink(js, drain_every_n=1),
                     jtel.NanSentinelListener("skip", 1))
    tn.set_listeners(ttel.TelemetrySink(ts, drain_every_n=1),
                     ttel.NanSentinelListener("skip", 1))
    for x, y in batches(2, nan_at=1):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    js.close()
    ts.close()
    got, want = FileStatsStorage.read(str(tp)), JFileStorage.read(str(jp))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["session"], g["tag"], g["step"]) == (w["session"],
                                                       w["tag"], w["step"])
        np.testing.assert_allclose(g["value"], w["value"], rtol=RTOL,
                                   equal_nan=True, err_msg=g["tag"])
    assert ("skipped_updates", 2, 1.0) in [(r["tag"], r["step"], r["value"])
                                           for r in got]
    json.dumps(got)


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_tensorboard_storage_events_match_jax(kind, tmp_path):
    """A sink draining into TensorBoardStatsStorage: the event files read
    back the same (session/tag, step) series as the JAX package's, the
    values within the telemetry tolerance, NaN where the JAX file has it;
    and the histograms of a listener with histograms on, the same tags."""
    from deeplearning4j_tpu.ui import TensorBoardStatsStorage as JTB
    from deeplearning4j_tpu_torch.ui import (TensorBoardStatsStorage,
                                             read_scalar_events)

    jn, tn = twins(kind, True)
    js, ts = JTB(str(tmp_path / "j")), TensorBoardStatsStorage(
        str(tmp_path / "t"))
    jn.set_listeners(jtel.TelemetrySink(js, drain_every_n=2),
                     jtel.NanSentinelListener("skip", 1))
    tn.set_listeners(ttel.TelemetrySink(ts, drain_every_n=2),
                     ttel.NanSentinelListener("skip", 1))
    for x, y in batches(4, nan_at=2):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    js.close()
    ts.close()
    got = read_scalar_events(ts.path)
    want = read_scalar_events(js._writer.path)
    assert [(s, t) for s, t, _ in got] == [(s, t) for s, t, _ in want]
    assert len(got) > 0
    np.testing.assert_allclose([v for _, _, v in got],
                               [v for _, _, v in want], rtol=RTOL,
                               atol=1e-6, equal_nan=True)


def test_where_and_clone_tree_keep_dtypes_and_views():
    """``clone_tree`` and ``where_tree`` work per dtype; the result's
    leaves are views of one flat tensor per dtype."""
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3),
                  "h": torch.ones(2, dtype=torch.bfloat16)},
            "b": {"w": torch.full((3,), 7.0)}}
    c = ttel.clone_tree(tree)
    for p in leaf_paths(tree):
        assert torch.equal(get_path(c, p), get_path(tree, p))
        assert get_path(c, p).dtype == get_path(tree, p).dtype
    assert get_path(c, ("a", "w"))._base is get_path(c, ("b", "w"))._base
    new = {"a": {"w": torch.full((2, 3), float("nan")),
                 "h": torch.zeros(2, dtype=torch.bfloat16)},
           "b": {"w": torch.zeros(3)}}
    kept = ttel.where_tree(torch.tensor(False), new, tree)
    took = ttel.where_tree(torch.tensor(True), new, tree)
    for p in leaf_paths(tree):
        assert torch.equal(get_path(kept, p), get_path(tree, p))
        assert torch.equal(get_path(took, p), get_path(new, p),
                           ) or torch.isnan(get_path(took, p)).all()


def test_nonfinite_counts_exact_against_jax():
    """Per-layer non-finite counts of a gradient tree, NaN and both
    infinities, against the JAX function."""
    rng = np.random.default_rng(1)
    tree = {f"{i:04d}": {"W": rng.normal(size=(7, 5)).astype(np.float32),
                         "b": rng.normal(size=(5,)).astype(np.float32)}
            for i in range(3)}
    tree["0000"]["W"][1, 2] = np.nan
    tree["0002"]["b"][:] = np.inf
    tree["0002"]["W"][0, :3] = -np.inf
    tree["0003"] = {}
    got = ttel.nonfinite_counts({k: {n: torch.from_numpy(v)
                                     for n, v in d.items()}
                                 for k, d in tree.items()})
    want = jtel.nonfinite_counts([jax.tree.map(np.asarray, tree[k])
                                  for k in sorted(tree)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("poisoned", [False, True])
def test_apply_nan_guard_matches_jax(poisoned):
    """The tree form of the guard: ``skipped`` and the kept trees as
    JAX's ``apply_nan_guard``."""
    rng = np.random.default_rng(2)

    def tree():
        return {"0000": {"W": rng.normal(size=(3, 2)).astype(np.float32)},
                "0001": {"b": rng.normal(size=(2,)).astype(np.float32)}}

    new_p, old_p, new_s, old_s, new_u, old_u = (tree() for _ in range(6))
    total = np.int32(3 if poisoned else 0)
    to_t = lambda t: {k: {n: torch.from_numpy(v)  # noqa: E731
                          for n, v in d.items()} for k, d in t.items()}
    out_t = ttel.apply_nan_guard({"nonfinite_total": torch.tensor(total)},
                                 *(to_t(t) for t in (new_p, old_p, new_s,
                                                     old_s, new_u, old_u)))
    out_j = jtel.apply_nan_guard({"nonfinite_total": total},
                                 *(jax.tree.map(np.asarray, [t[k] for k in
                                                             sorted(t)])
                                   for t in (new_p, old_p, new_s, old_s,
                                             new_u, old_u)))
    assert int(out_t[0]["skipped"]) == int(out_j[0]["skipped"])
    for got, want in zip(out_t[1:], out_j[1:]):
        for k, jd in zip(sorted(got), want):
            for n in jd:
                np.testing.assert_array_equal(got[k][n].numpy(),
                                              np.asarray(jd[n]))
