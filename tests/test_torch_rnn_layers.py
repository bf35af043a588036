"""The port's recurrent layers against the JAX package's, on the CPU.

Each layer (``LSTM`` under four activations, ``GravesLSTM``, ``GRU`` in
both forms, ``SimpleRnn``, ``Bidirectional`` in its four modes over an LSTM
and a GRU, ``LastTimeStep``, ``RnnOutputLayer``, ``MaskingLayer``) is built
in both packages with the JAX layer's parameters carried across:
``apply``, ``apply_masked`` and ``apply_rnn`` (outputs and carries), and
the gradients of a weighted sum of the outputs with respect to the
parameters and the input. Tolerance: float32, 1e-5 of each array's scale.

Then networks: a MaskingLayer in front (the mask derived from the input,
and the loss of a recurrent head masked by it), explicit feature masks, the
JAX package's updater state carried into a network whose Bidirectional
layer keeps a three-level tree (dense and flat layouts), the fused step
bitwise to the per-leaf one on that tree, the model zip both ways array for
array, and the recurrent layers, MaskingLayer and LastTimeStep as nodes of
a ComputationGraph.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.util import model_serializer as jser
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.util.convert import multilayer_state_from_numpy
from torch_parity import (assert_scaled_close, mln_twins, modules,
                          numpy_tree)

B, T, NIN = 3, 7, 4
LENGTHS = (7, 4, 2)


def _x(seed=0, shape=(B, T, NIN)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(lengths=LENGTHS, t=T):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [a for o in v for a in _flat(o)]
    return [v]


#: layer specs: name -> factory over a package's layers module
LAYERS = {
    "lstm": lambda L: L.LSTM(n_out=5),
    "lstm_tanh": lambda L: L.LSTM(n_out=5, activation="tanh"),
    "lstm_identity": lambda L: L.LSTM(n_out=5, activation="identity"),
    "lstm_relu": lambda L: L.LSTM(n_out=5, activation="relu"),
    "lstm_sigmoid": lambda L: L.LSTM(n_out=5, activation="sigmoid"),
    "graves_lstm": lambda L: L.GravesLSTM(n_out=5),
    "gru": lambda L: L.GRU(n_out=5),
    "gru_reset_after": lambda L: L.GRU(n_out=5, reset_after=True),
    "simple_rnn": lambda L: L.SimpleRnn(n_out=5),
    "simple_rnn_relu": lambda L: L.SimpleRnn(n_out=5, activation="relu"),
    **{f"bidirectional_lstm_{mode}": (
        lambda L, mode=mode: L.Bidirectional(layer=L.LSTM(n_out=5),
                                             mode=mode))
       for mode in ("concat", "add", "mul", "average")},
    **{f"bidirectional_gru_{mode}": (
        lambda L, mode=mode: L.Bidirectional(
            layer=L.GRU(n_out=5, reset_after=True), mode=mode))
       for mode in ("concat", "average")},
    "last_time_step_lstm": lambda L: L.LastTimeStep(layer=L.LSTM(n_out=5)),
    "last_time_step_gru": lambda L: L.LastTimeStep(layer=L.GRU(n_out=5)),
    "rnn_output": lambda L: L.RnnOutputLayer(n_out=3, loss="mcxent",
                                             activation="softmax"),
    "masking": lambda L: L.MaskingLayer(),
}


def _twins(spec):
    """The JAX layer and the port's, set up for RNN input, and the JAX
    layer's parameters as a numpy tree."""
    out = []
    for which in ("jax", "torch"):
        m = modules(which)
        layer = LAYERS[spec](m.L)
        for lay in (layer, getattr(layer, "layer", None)):
            if lay is not None and lay.weight_init is None:
                lay.weight_init = "xavier"
        layer.set_input_type(m.InputType.recurrent(NIN, T))
        out.append(layer)
    jl, tl = out
    params = numpy_tree(jl.init_params(jax.random.PRNGKey(3), jnp.float32))
    return jl, tl, params


def _torch_tree(params, grad=False):
    return {k: (_torch_tree(v, grad) if isinstance(v, dict)
                else torch.from_numpy(v.copy()).requires_grad_(grad))
            for k, v in params.items()}


def _jax_tree(params):
    return jax.tree.map(jnp.asarray, params)


def _x_for(spec, seed=0):
    x = _x(seed)
    if spec == "masking":
        x[_mask() == 0] = 0.0     # padded steps: all features 0
    return x


@pytest.mark.parametrize("spec", sorted(LAYERS))
def test_layer_forward_masked_and_carried_match_jax(spec):
    jl, tl, params = _twins(spec)
    x, m = _x_for(spec), _mask()
    want, _ = jl.apply(_jax_tree(params), jnp.asarray(x), {}, False, None)
    got, _ = tl.apply(_torch_tree(params), torch.from_numpy(x), {}, False)
    assert_scaled_close(got, want, f"{spec} apply")
    want, _ = jl.apply_masked(_jax_tree(params), jnp.asarray(x), {}, False,
                              None, jnp.asarray(m))
    got, _ = tl.apply_masked(_torch_tree(params), torch.from_numpy(x), {},
                             False, torch.from_numpy(m))
    assert_scaled_close(got, want, f"{spec} apply_masked")
    assert tl.is_rnn() == jl.is_rnn()
    carry_j = jl.init_rnn_state(B, jnp.float32)
    carry_t = tl.init_rnn_state(B, torch.float32)
    assert [np.shape(c) for c in _flat(carry_j) if c is not None] == \
        [tuple(c.shape) for c in _flat(carry_t) if c is not None]
    assert (carry_j is None) == (carry_t is None)
    if jl.is_rnn():   # from a nonzero carry
        carry_j = jax.tree.map(lambda c: c + 0.3, carry_j)
        carry_t = tuple(c + 0.3 for c in carry_t) \
            if isinstance(carry_t, tuple) else carry_t + 0.3
    yj, rj, _ = jl.apply_rnn(_jax_tree(params), jnp.asarray(x), carry_j, {},
                             False, None)
    yt, rt, _ = tl.apply_rnn(_torch_tree(params), torch.from_numpy(x),
                             carry_t, {}, False)
    assert_scaled_close(yt, yj, f"{spec} apply_rnn")
    if rj is not None:
        for i, (a, b) in enumerate(zip(_flat(rt), _flat(rj))):
            assert_scaled_close(a, b, f"{spec} carry {i}")


@pytest.mark.parametrize("spec", sorted(k for k in LAYERS if k != "masking"))
def test_layer_gradients_match_jax(spec):
    jl, tl, params = _twins(spec)
    x = _x_for(spec)
    want, _ = jl.apply(_jax_tree(params), jnp.asarray(x), {}, False, None)
    ct = np.random.default_rng(9).normal(size=np.shape(want)).astype(
        np.float32)

    def jloss(p, xx):
        y, _ = jl.apply(p, xx, {}, False, None)
        return jnp.sum(y * ct)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_jax_tree(params),
                                               jnp.asarray(x))
    tp = _torch_tree(params, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = tl.apply(tp, tx, {}, False)
    paths = leaf_paths(tp)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)),
                                [get_path(tp, p) for p in paths] + [tx])
    for p, g in zip(paths, grads):
        assert_scaled_close(g, get_path(jgp, p), f"{spec} d/d{'/'.join(p)}")
    assert_scaled_close(grads[-1], jgx, f"{spec} d/dx")


@pytest.mark.parametrize("spec", sorted(k for k in LAYERS if k != "masking"))
def test_init_params_names_shapes_and_forget_bias(spec):
    jl, tl, params = _twins(spec)
    got = tl.init_params(torch.Generator().manual_seed(0))
    assert leaf_paths(got) == leaf_paths(params)
    for p in leaf_paths(params):
        assert tuple(get_path(got, p).shape) == get_path(params, p).shape, p
        assert get_path(got, p).dtype == torch.float32
    for p in leaf_paths(got):
        if p[-1] == "b" and "lstm" in spec and "output" not in spec:
            b, n = get_path(got, p), get_path(got, p).shape[0] // 4
            want = np.zeros(4 * n, np.float32)
            want[n:2 * n] = 1.0      # the forget gate's bias
            np.testing.assert_array_equal(b.numpy(), want)
            np.testing.assert_array_equal(get_path(params, p), want)


# --- networks ------------------------------------------------------------------------

def _seq_conf(which, mode="concat", fused=False, updater=None,
              masking=True, head="rnn"):
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(5).updater(
        updater(m) if updater else m.Adam(0.01))
    if fused:
        b = b.fused_update()
    lb = b.list()
    if masking:
        lb = lb.layer(m.L.MaskingLayer())
    lb = (lb.layer(m.L.Bidirectional(layer=m.L.LSTM(n_out=5), mode=mode))
          .layer(m.L.GRU(n_out=4)))
    if head == "rnn":
        lb = lb.layer(m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                         activation="softmax"))
    else:
        lb = (lb.layer(m.L.LastTimeStep(layer=m.L.SimpleRnn(n_out=4)))
              .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax")))
    return lb.set_input_type(m.InputType.recurrent(NIN)).build()


def _seq_data(seed=1, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, NIN)).astype(np.float32)
    x[_mask(lengths) == 0] = 0.0
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (B, T))]
    return x, y


@pytest.mark.parametrize("mode", ["concat", "add", "mul", "average"])
def test_masking_layer_network_output_and_loss_match_jax(mode):
    jn, tn = mln_twins(_seq_conf("jax", mode), _seq_conf("torch", mode))
    x, y = _seq_data()
    assert_scaled_close(tn.output(x), np.asarray(jn.output(x).value), "derived mask")
    # the derived mask masks the recurrent head's loss
    assert_scaled_close(np.float32(tn.score(DataSet(x, y))),
           np.float32(jn.score(JDataSet(x, y))), "score")
    # an explicit feature mask takes precedence
    m = _mask((5, 5, 3))
    assert_scaled_close(tn.output(x, fmask=m),
           np.asarray(jn.output(x, fmask=jnp.asarray(m)).value),
           "explicit mask")
    grads, score = tn.compute_gradient_and_score(DataSet(x, y))
    jgrads, jscore = jn.compute_gradient_and_score(JDataSet(x, y))
    assert_scaled_close(np.float32(score), np.float32(jscore), "gradient score")
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        for p in leaf_paths(g):
            assert_scaled_close(get_path(g, p), np.asarray(get_path(jg, p)),
                   f"layer {i} {'/'.join(p)}")


def _state_numpy(state):
    """The JAX network's updater state (dense per-layer lists or flat
    buckets) as numpy."""
    return {k: ([numpy_tree(d) for d in v] if isinstance(v, list)
                else numpy_tree(v)) for k, v in state.items()}


@pytest.mark.parametrize("flat", [False, True], ids=["dense", "flat"])
def test_bidirectional_updater_state_carries_from_jax(flat):
    """The JAX network's dense state, or that state in the flat buckets of
    the JAX ``Zero1Plan`` (padded for 4 shards), into a fused port
    network: one more step on each side lands on the same parameters."""
    from deeplearning4j_tpu.parallel.sharding import Zero1Plan as JPlan

    jn, tn = mln_twins(_seq_conf("jax", fused=True),
                       _seq_conf("torch", fused=True))
    x, y = _seq_data()
    for _ in range(2):
        jn.fit(JDataSet(x, y))
    state = jn._updater_state
    if flat:
        state = JPlan(jn._params, 4).flatten_state(state, xp=jnp)
        assert all(str(k).startswith("flat::") for k in state["m"])
    state = _state_numpy(state)
    assert flat or "fwd" in state["m"][1]
    multilayer_state_from_numpy(tn, [numpy_tree(d) for d in jn._params],
                                [numpy_tree(d) for d in jn._states], state)
    tn._iteration = jn._iteration
    jn.fit(JDataSet(x, y))
    tn.fit(DataSet(x, y))
    assert_scaled_close(tn.params(), np.asarray(jn.params().value), "params after a step")
    assert tn._iteration == jn._iteration == 3


def test_fused_step_is_bitwise_the_per_leaf_step_on_a_bidirectional_tree():
    nets = [TNet(_seq_conf("torch", fused=f)).init(device="cpu")
            for f in (False, True)]
    x, y = _seq_data()
    for _ in range(3):
        for net in nets:
            net.fit(DataSet(x, y))
    leaf, fused = nets
    assert leaf.summary().endswith(f"Total params: {leaf.num_params()}")
    assert fused._flat is not None and leaf._flat is None
    assert "fwd" in fused._params["0001"]
    for p in leaf_paths(leaf._params):
        assert torch.equal(get_path(leaf._params, p),
                           get_path(fused._params, p)), p
    for slot in ("m", "v"):
        for p in leaf_paths(leaf._updater_state[slot]):
            assert torch.equal(get_path(leaf._updater_state[slot], p),
                               get_path(fused._updater_state[slot], p)), p
    assert leaf.score_value == fused.score_value


def _assert_tree_equal(got, want, what):
    assert leaf_paths(got) == leaf_paths(want), what
    for p in leaf_paths(want):
        g = get_path(got, p)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert np.array_equal(np.asarray(g), np.asarray(get_path(want, p))), \
            (what, p)


def test_bidirectional_model_zip_both_ways(tmp_path):
    jn, tn = mln_twins(_seq_conf("jax", fused=True, head="last"),
                       _seq_conf("torch", fused=True, head="last"))
    x, _ = _seq_data()
    y = np.eye(3, dtype=np.float32)[[0, 2, 1]]
    jn.fit(JDataSet(x, y))
    jpath = str(tmp_path / "jax.zip")
    jn.save(jpath, save_updater=True)
    tl = TNet.load(jpath, load_updater=True, device="cpu")
    want = {f"{i:04d}": numpy_tree(p) for i, p in enumerate(jn._params)}
    _assert_tree_equal(tl._params, want, "params from the JAX zip")
    for slot in ("m", "v"):
        _assert_tree_equal(tl._updater_state[slot], {
            f"{i:04d}": numpy_tree(d)
            for i, d in enumerate(jn._updater_state[slot])}, slot)
    tl.fit(DataSet(x, y))
    tpath = str(tmp_path / "port.zip")
    tl.save(tpath, save_updater=True)
    back = jser.restore_multi_layer_network(tpath, load_updater=True)
    _assert_tree_equal(tl._params, {f"{i:04d}": numpy_tree(p) for i, p in
                                    enumerate(back._params)},
                       "params into JAX")
    assert json.loads(back.conf.to_json()) == json.loads(tl.conf.to_json())
    for slot in ("m", "v"):
        _assert_tree_equal(tl._updater_state[slot], {
            f"{i:04d}": numpy_tree(d)
            for i, d in enumerate(back._updater_state[slot])}, slot)
    assert back._iteration == tl._iteration == 2


def _graph_conf(which):
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(5).updater(m.Adam(0.01))
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("mask", m.L.MaskingLayer(), "in")
    gb.add_layer("lstm", m.L.LSTM(n_out=5), "mask")
    gb.add_layer("bi", m.L.Bidirectional(
        layer=m.L.GRU(n_out=4, reset_after=True), mode="add"), "lstm")
    gb.add_layer("seq", m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                           activation="softmax"), "bi")
    gb.add_layer("last", m.L.LastTimeStep(layer=m.L.SimpleRnn(n_out=4)),
                 "lstm")
    gb.add_layer("cls", m.L.OutputLayer(n_out=2, loss="mcxent",
                                        activation="softmax"), "last")
    gb.set_outputs("seq", "cls")
    gb.set_input_types(m.InputType.recurrent(NIN))
    return gb.build()


def test_recurrent_layers_as_graph_nodes_match_jax():
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.data import MultiDataSet
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy

    jg = JGraph(_graph_conf("jax")).init()
    tg = TGraph(_graph_conf("torch")).init(device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params),
                           numpy_tree(jg._states))
    assert tg.summary().endswith(f"Total params: {tg.num_params()}")
    assert tg.num_params() == jg.num_params()
    x, y = _seq_data()
    yc = np.eye(2, dtype=np.float32)[[1, 0, 1]]
    for got, want in zip(tg.output(x), jg.output(x)):
        assert_scaled_close(got, np.asarray(want.value), "graph outputs")
    for _ in range(2):
        jg.fit(JMDS([x], [y, yc]))
        tg.fit(MultiDataSet([x], [y, yc]))
    assert_scaled_close(tg.params(), np.asarray(jg.params().value), "graph params")
