"""Rematerialization in the port (``nn/conf/builder.remat_wrap``), on the
CPU, mirroring tests/test_remat_policies.py:78-190.

A policy recomputes, it never reassociates: on the CPU every policy gives
the "none" run's losses, parameters, layer states and updater state bit
for bit, with dropout on (the recompute replays the same draws from the
network's generator), on ``MultiLayerNetwork`` (per-leaf and fused), on
its truncated-BPTT segments and on ``ComputationGraph``. The recompute is
real: under "full" each checkpointed layer's forward runs again in the
backward, and the selective policies keep exactly the matrix products they
name (counted with a dispatch mode over the backward). Against the JAX
package under the same policy: three steps within 1e-5 of each parameter's
scale.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.builder import (
    REMAT_POLICIES, NeuralNetConfiguration, effective_remat_policy,
    remat_wrap)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from torch_parity import (assert_trees_close, mln_twins, modules,
                          residual_conf)

POLICIES = ["full", "dots_only", "checkpoint_dots_with_no_batch_dims",
            [0, 2]]
POLICY_IDS = ["full", "dots", "dots_nb", "selective"]


def stack(policy=None, fused=False, which="torch", dropout=0.25):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(11)
         .updater(m.Adam(1e-2)).dropout(dropout))
    if fused:
        b = b.fused_update()
    if policy is not None:
        b = b.remat_policy(policy)
    lb = b.list()
    lb = (lb.layer(m.L.DenseLayer(n_out=32, activation="relu"))
          .layer(m.L.BatchNormalization(activation="tanh"))
          .layer(m.L.DenseLayer(n_out=32, activation="relu"))
          .layer(m.L.DenseLayer(n_out=32, activation="tanh")))
    return (lb.layer(m.L.OutputLayer(n_out=5, activation="softmax",
                                     loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(16)).build())


def fit_data(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 16)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)])


def _net(policy, fused=False):
    mt = modules("torch")
    return mt.MultiLayerNetwork(stack(policy, fused)).init(device="cpu")


def _bitwise(a, b):
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.util.model_serializer import (
        dense_updater_state)

    for ta, tb in ((a._params, b._params), (a._states, b._states),
                   (dense_updater_state(a), dense_updater_state(b))):
        pa, pb = leaf_paths(ta), leaf_paths(tb)
        assert pa == pb
        for p in pa:
            assert torch.equal(get_path(ta, p), get_path(tb, p)), p


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("policy", POLICIES, ids=POLICY_IDS)
def test_loss_params_and_states_bitwise_vs_none(policy, fused):
    x, y = fit_data()
    base, rem = _net(None, fused), _net(policy, fused)
    base_losses, rem_losses = [], []
    for _ in range(4):
        base.fit(NDArrayDataSetIterator(x, y, batch_size=32))
        rem.fit(NDArrayDataSetIterator(x, y, batch_size=32))
        base_losses.append(base.score_value)
        rem_losses.append(rem.score_value)
    assert base_losses == rem_losses
    _bitwise(base, rem)


class _Counted:
    """Counts the calls of a layer's ``apply`` (or another method)."""

    def __init__(self, layer, method="apply"):
        self.calls = 0
        self.inner = getattr(layer, method)
        setattr(layer, method, self)

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.inner(*a, **kw)


def test_full_recomputes_every_layer_and_selective_only_its_list():
    x, y = fit_data(8)
    for policy, want in ((None, [1, 1, 1, 1]), ("full", [2, 2, 2, 2]),
                         ([0, 2], [2, 1, 2, 1])):
        net = _net(policy)
        counts = [_Counted(layer) for layer in net.layers[:-1]]
        net.fit(DataSet(x, y))
        assert [c.calls for c in counts] == want, policy
        # BN's running statistics were applied once: as without remat
    a, b = _net(None), _net("full")
    a.fit(DataSet(x, y))
    b.fit(DataSet(x, y))
    assert torch.equal(a._states["0001"]["mean"], b._states["0001"]["mean"])


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(make_net, policy, x, y):
    net = make_net(policy)
    params = net._params
    for t in net._leaves():
        t.requires_grad_(True)
    loss, _ = net._loss(params, net._states, torch.from_numpy(x),
                        torch.from_numpy(y), None, True)
    with _OpCount() as count:
        loss.backward()
    return count.ops


def _attention_net(policy):
    mt = modules("torch")
    b = NeuralNetConfiguration.builder().seed(2).updater(mt.Sgd(0.1))
    if policy is not None:
        b = b.remat_policy(policy)
    conf = (b.list()
            .layer(mt.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                         activation="relu"))
            .layer(mt.L.DenseLayer(n_out=12, activation="tanh"))
            .layer(mt.L.OutputLayer(n_out=5, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(mt.InputType.convolutional(6, 6, 2)).build())
    return mt.MultiLayerNetwork(conf).init(device="cpu")


def test_selective_policies_keep_the_products_they_name():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 2, 6, 6)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 4)]
    ops = {p: _backward_ops(_attention_net, p, x, y)
           for p in (None, "full", "dots_only",
                     "checkpoint_dots_with_no_batch_dims")}
    conv = lambda p: ops[p].get("convolution", 0)  # noqa: E731
    mm = lambda p: ops[p].get("mm", 0) + ops[p].get("addmm", 0)  # noqa: E731
    # "full" recomputes the forward: its convolution and its product
    assert conv("full") == conv(None) + 1 and mm("full") > mm(None)
    # the dot policies keep the dense product, recompute the convolution
    for p in ("dots_only", "checkpoint_dots_with_no_batch_dims"):
        assert mm(p) == mm(None) and conv(p) == conv(None) + 1, p


def test_dots_only_keeps_batched_products_and_no_batch_dims_does_not():
    mt = modules("torch")

    def net(policy):
        b = NeuralNetConfiguration.builder().seed(2).updater(mt.Sgd(0.1))
        if policy is not None:
            b = b.remat_policy(policy)
        conf = (b.list().layer(mt.L.SelfAttentionLayer(n_out=8, n_heads=2))
                .layer(mt.L.RnnOutputLayer(n_out=3, activation="softmax",
                                           loss="mcxent"))
                .set_input_type(mt.InputType.recurrent(8, 5)).build())
        return mt.MultiLayerNetwork(conf).init(device="cpu")

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5))]
    ops = {p: _backward_ops(net, p, x, y)
           for p in (None, "dots_only", "checkpoint_dots_with_no_batch_dims")}
    assert ops["dots_only"].get("bmm", 0) == ops[None].get("bmm", 0)
    assert ops["checkpoint_dots_with_no_batch_dims"].get("bmm", 0) \
        > ops[None].get("bmm", 0)


def test_unknown_policy_rejected_at_build_and_at_step_build():
    with pytest.raises(ValueError, match="remat"):
        NeuralNetConfiguration.builder().remat_policy("everything")
    net = _net(None)
    with pytest.raises(ValueError, match="remat"):
        net.set_remat_policy("everything")
    net.conf.global_conf.remat_policy = "everything"
    x, y = fit_data(8)
    with pytest.raises(ValueError, match="remat"):
        net.fit(DataSet(x, y))


def test_legacy_gradient_checkpointing_maps_to_full():
    net = _net(None)
    gc = net.conf.global_conf
    assert effective_remat_policy(gc) == "none"
    gc.gradient_checkpointing = True
    assert effective_remat_policy(gc) == "full"
    counts = [_Counted(layer) for layer in net.layers[:-1]]
    x, y = fit_data(8)
    net.fit(DataSet(x, y))
    assert [c.calls for c in counts] == [2, 2, 2, 2]
    gc.remat_policy = "dots_only"   # an explicit policy wins
    assert effective_remat_policy(gc) == "dots_only"
    assert NeuralNetConfiguration.builder().gradient_checkpointing() \
        ._conf.gradient_checkpointing


def test_remat_wrap_none_is_identity_and_the_registry_is_closed():
    gc = stack().global_conf

    def f(x):
        return x * 2

    assert remat_wrap(gc, f) is f
    assert set(REMAT_POLICIES) == {"none", "full", "dots_only",
                                   "checkpoint_dots_with_no_batch_dims"}


def test_set_remat_policy_switches_the_next_step():
    x, y = fit_data(8)
    net = _net(None)
    counts = [_Counted(layer) for layer in net.layers[:-1]]
    net.fit(DataSet(x, y))
    net.set_remat_policy("full")
    net.fit(DataSet(x, y))
    assert [c.calls for c in counts] == [3, 3, 3, 3]
    assert net.conf.global_conf.remat_policy == "full"


def test_policy_flip_then_refit_is_steady_state():
    """The JAX drill's region (``tests/test_remat_policies.py``): after a
    policy flip the refit loop is steady state. The port rebuilds nothing
    on a flip (the policy is read at the step), so the census keeps one
    generation across it."""
    from deeplearning4j_tpu_torch.common import tracecheck, xprof

    xprof.reset()
    x, y = fit_data()
    net = _net(None)
    net.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=2)
    net.set_remat_policy("dots_only")
    net.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1)
    with tracecheck.steady_state("post-flip refit",
                                 max_host_syncs=None) as region:
        net.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=2)
    assert region.compiles == 0 and region.counter_deltas == {}
    e = xprof.census()["mln/fit_step"]
    assert e["generations"] == 1 and e["calls"] == 10


@pytest.mark.parametrize("policy", POLICIES[:3] + [[2]],
                         ids=POLICY_IDS[:3] + ["selective"])
def test_policy_matches_jax_under_the_same_policy(policy):
    jn, tn = mln_twins(stack(policy, which="jax", dropout=0.0),
                       stack(policy, which="torch", dropout=0.0))
    for step in range(3):
        x, y = fit_data(16, seed=step)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        assert abs(tn.score_value - jn.score_value) \
            <= 1e-5 * jn.score_value
    assert_trees_close(tn, jn)


# --- truncated BPTT -------------------------------------------------------------------

def _tbptt(policy):
    mt = modules("torch")
    b = (NeuralNetConfiguration.builder().seed(4).updater(mt.Adam(1e-2))
         .dropout(0.2))
    if policy is not None:
        b = b.remat_policy(policy)
    conf = (b.list().layer(mt.L.LSTM(n_out=8, activation="tanh"))
            .layer(mt.L.GRU(n_out=6, activation="tanh"))
            .layer(mt.L.RnnOutputLayer(n_out=4, activation="softmax",
                                       loss="mcxent"))
            .backprop_type("TruncatedBPTT").tbptt_length(5)
            .set_input_type(mt.InputType.recurrent(3)).build())
    return mt.MultiLayerNetwork(conf).init(device="cpu")


@pytest.mark.parametrize("policy", ["full", "dots_only", [1]],
                         ids=["full", "dots", "selective"])
def test_tbptt_segments_bitwise_vs_none(policy):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 15, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (4, 15))]
    base, rem = _tbptt(None), _tbptt(policy)
    counts = [_Counted(layer, "apply_rnn") for layer in rem.layers[:-1]]
    for _ in range(2):
        base.fit(DataSet(x, y))
        rem.fit(DataSet(x, y))
        assert base.score_value == rem.score_value
    _bitwise(base, rem)
    # 3 segments a batch, 2 batches; a checkpointed segment runs twice
    want = {"full": [12, 12], "dots_only": [12, 12], "selective": [6, 12]}
    assert [c.calls for c in counts] == want[
        policy if isinstance(policy, str) else "selective"]


# --- ComputationGraph ---------------------------------------------------------------

def _graph(policy, fused=False):
    conf = residual_conf("torch", fused=False, channels=8,
                         updater=lambda m: m.Adam(1e-2),
                         fused_update=fused)
    conf.nodes["out"].layer.dropout = 0.3
    if policy is not None:
        conf.global_conf.remat_policy = policy
    return ComputationGraph(conf).init(device="cpu")


def _graph_data(seed=0, n=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 4, 8, 8)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)])


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("policy", POLICIES[:3] + [["c1", "scbn"]],
                         ids=POLICY_IDS)
def test_graph_policies_bitwise_vs_none(policy, fused):
    base, rem = _graph(None, fused), _graph(policy, fused)
    for step in range(3):
        x, y = _graph_data(step)
        base.fit(DataSet(x, y))
        rem.fit(DataSet(x, y))
        assert base.score_value == rem.score_value
    _bitwise(base, rem)


def test_graph_does_not_fit_silently_without_remat():
    """The graph honours its configuration's policy: under "full" every
    layer node's forward runs again in the backward (before this port had
    rematerialization, the graph ignored the policy and fitted without
    it); a selective list names nodes; an unknown policy raises."""
    x, y = _graph_data()
    for policy, again in (("full", {"c1", "bn3", "sc", "scbn", "relu"}),
                          (["c1", "scbn"], {"c1", "scbn"})):
        g = _graph(policy)
        counts = {n: _Counted(g.conf.nodes[n].layer)
                  for n in ("c1", "bn3", "sc", "scbn", "relu")}
        g.fit(DataSet(x, y))
        assert {n for n, c in counts.items() if c.calls == 2} == again
        assert all(c.calls in (1, 2) for c in counts.values())
    g = _graph(None)
    g.set_remat_policy("dots_only")
    assert g.conf.global_conf.remat_policy == "dots_only"
    with pytest.raises(ValueError, match="remat"):
        g.set_remat_policy("everything")
    g.conf.global_conf.remat_policy = "everything"
    with pytest.raises(ValueError, match="remat"):
        g.fit(DataSet(x, y))
