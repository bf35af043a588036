"""The self-attention encoder slice of the port against the JAX package, on
the CPU.

One helper (tests/torch_parity.py ``encoder_conf``) builds the same
BERT-shaped encoder in both packages at a small size (hidden 32, 4 heads,
feed-forward 64, 2 layers, T 128, vocabulary 100); the JAX graph's weights
are carried into the port with ``graph_state_from_numpy``. The JAX
package's CPU path runs dense attention (its flash kernel needs the TPU);
the port's runs the plain version of its flash kernel, so the tolerances
cover the two ways of scaling (q * scale before the product against
scores / sqrt(d) after it) and the sums taken in another order: 1e-5 on
the hidden states (unit scale after LayerNorm), 1e-6 on the
probabilities. Both sides compute in float32 (the JAX package under its
global x64 is built with ``data_type("float32")``).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
from torch_parity import encoder_conf, numpy_tree

ROOT = Path(__file__).resolve().parent.parent
B, T = 2, 128


@pytest.fixture(scope="module")
def twins():
    jg = JGraph(encoder_conf("jax")).init()
    tg = TGraph(encoder_conf("torch")).init(device="cpu")
    params = numpy_tree(jg._params)
    graph_state_from_numpy(tg, params, numpy_tree(jg._states))
    return jg, tg, params


def _feed(vocab=100, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, T)).astype(np.int32)
    positions = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    return tokens, positions


def test_encoder_matches_jax(twins):
    jg, tg, _ = twins
    tokens, positions = _feed()
    feed = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions)}
    jacts, _ = jg._forward(jg._params, jg._states, feed, False,
                           jax.random.PRNGKey(0))
    with torch.inference_mode():
        tacts, _ = tg._forward(tg._params, tg._states,
                               tg._bind_inputs((tokens, positions)))
    hidden = tacts["l1_ln2"].numpy()
    assert hidden.shape == (B, T, 32) and hidden.dtype == np.float32
    np.testing.assert_allclose(hidden, np.asarray(jacts["l1_ln2"]), rtol=0,
                               atol=1e-5)
    got = tg.output(tokens, positions)[0].numpy()
    want = np.asarray(jg.output(tokens, positions)[0])
    assert got.shape == (B, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_encoder_takes_flash_once_per_layer(twins):
    _, tg, _ = twins
    OpProfiler.get().reset()
    tg.output(*_feed(seed=1))
    counters = OpProfiler.get().get_counters()
    assert counters.get("attention/mha_flash") == 2
    assert "attention/mha_dense" not in counters


def test_bf16_compute_matches_jax_bf16_encoder():
    """Both packages in bf16 compute from the same weights. The JAX
    package's CPU path runs dense attention in bf16; the port's runs the
    plain flash version in float32 on the upcast and rounds its output to
    bf16; the matmuls and LayerNorms round at other places. bf16 keeps 8
    bits (2^-9 relative per rounding, compounded over two layers), so the
    last hidden states (unit scale after LayerNorm) may differ by 2% of
    their norm (measured about 0.7%), and the port must be no further from
    the float32 states than the JAX package's bf16 run is (with 20% and
    1e-3 to spare); the probabilities (near 0.5, where a bf16 ulp is
    2^-9) within 1e-2."""
    jg = JGraph(encoder_conf("jax", compute_dtype="bfloat16")).init()
    tg = TGraph(encoder_conf("torch", compute_dtype="bfloat16")).init(
        device="cpu")
    jf = JGraph(encoder_conf("jax")).init()
    graph_state_from_numpy(tg, numpy_tree(jg._params), numpy_tree(jg._states))
    tokens, positions = _feed(seed=3)
    feed = {"tokens": jnp.asarray(tokens), "positions": jnp.asarray(positions)}
    jacts, _ = jg._forward(jg._params, jg._states, feed, False,
                           jax.random.PRNGKey(0))
    facts, _ = jf._forward(jg._params, jg._states, feed, False,
                           jax.random.PRNGKey(0))
    with torch.inference_mode():
        tacts, _ = tg._forward(tg._params, tg._states,
                               tg._bind_inputs((tokens, positions)))
    assert tacts["l1_ln2"].dtype == torch.bfloat16
    got = tacts["l1_ln2"].float().numpy()
    want = np.asarray(jacts["l1_ln2"].astype(jnp.float32))
    f32 = np.asarray(facts["l1_ln2"])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) <= 2e-2
    assert rel(got, f32) <= 1.2 * rel(want, f32) + 1e-3
    probs = tg.output(tokens, positions)[0].float().numpy()
    jprobs = np.asarray(jg.output(tokens, positions)[0]).astype(np.float32)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-2)


def test_bf16_serving_keeps_token_ids_integer():
    """Under bf16 compute the integer inputs are not cast (a float id above
    256 would round in bf16), so tokens 257..260 pick four distinct rows;
    the rows of the output sum to 1."""
    tg = TGraph(encoder_conf("torch", vocab=1000,
                             compute_dtype="bfloat16")).init(device="cpu")
    tokens, positions = _feed(vocab=1000, seed=2)
    tokens[0, :4] = [257, 258, 259, 260]
    with torch.inference_mode():
        acts, _ = tg._forward(tg._params, tg._states,
                              tg._bind_inputs((tokens, positions)))
    table = tg._params["tok_emb"]["W"].bfloat16()
    assert torch.equal(acts["tok_emb"][0, :4], table[257:261])
    probs = tg.output(tokens, positions)[0].float()
    assert probs.shape == (B, 2) and bool(torch.isfinite(probs).all())
    assert (probs.sum(1) - 1).abs().max().item() <= 1e-2


@pytest.mark.parametrize("fault", ["shape", "dtype", "missing_node",
                                   "extra_entry"])
def test_carry_over_refuses_what_does_not_fit(twins, fault):
    _, _, params = twins
    bad = {n: dict(d) for n, d in params.items()}
    if fault == "shape":
        bad["tok_emb"]["W"] = np.zeros((101, 32), np.float32)
    elif fault == "dtype":
        bad["l0_attn"]["Wq"] = bad["l0_attn"]["Wq"].astype(np.float64)
    elif fault == "missing_node":
        del bad["l1_ff2"]
    else:
        bad["emb_ln"]["beta"] = np.zeros(32, np.float32)
    tg = TGraph(encoder_conf("torch")).init(device="cpu")
    with pytest.raises(ValueError):
        graph_state_from_numpy(tg, bad, {})


def test_chip_smoke_builds_the_tested_topology():
    """chip_smoke.py's encoder (full width there) is this helper's: the
    same nodes, layer classes, inputs and parameter shapes."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    a = cs.encoder_conf(vocab=100, positions=128, seq_len=128, hidden=32,
                        layers=2, heads=4, ff=64)
    b = encoder_conf("torch")
    assert a.order == b.order and a.network_inputs == b.network_inputs
    for name in a.order:
        na, nb = a.nodes[name], b.nodes[name]
        assert na.inputs == nb.inputs
        assert type(na.layer) is type(nb.layer)
        assert type(na.vertex) is type(nb.vertex)
        assert a.node_output_types[name] == b.node_output_types[name]
    ga, gb = (TGraph(c).init(device="cpu") for c in (a, b))
    assert {n: {k: t.shape for k, t in d.items()} for n, d in
            ga._params.items()} == {n: {k: t.shape for k, t in d.items()}
                                    for n, d in gb._params.items()}


# --- the layers, one at a time -----------------------------------------------

def _pair(jax_layer, torch_layer, input_type_args, kind="recurrent"):
    jt = getattr(JInputType, kind)(*input_type_args)
    tt = getattr(TInputType, kind)(*input_type_args)
    jo, to = jax_layer.set_input_type(jt), torch_layer.set_input_type(tt)
    params = {k: np.asarray(v) for k, v in
              jax_layer.init_params(jax.random.PRNGKey(3)).items()}
    return params, jo, to


def _apply_both(jax_layer, torch_layer, params, x):
    want, _ = jax_layer.apply({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), {}, False, None)
    got, _ = torch_layer.apply({k: torch.tensor(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), {})
    return got.numpy(), np.asarray(want)


def _x(*shape, seed=4):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("pooling", ["max", "avg", "sum"])
def test_global_pooling_over_time_matches_jax(pooling):
    jl, tl = (m.GlobalPoolingLayer(pooling_type=pooling) for m in (JL, TL))
    _, jo, to = _pair(jl, tl, (6, 5))
    assert (jo.size, to.size) == (6, 6)
    got, want = _apply_both(jl, tl, {}, _x(3, 5, 6))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,shape", [("recurrent", (3, 5, 8)),
                                        ("feed_forward", (3, 8))])
def test_layer_normalization_matches_jax(kind, shape):
    jl, tl = JL.LayerNormalization(eps=1e-12), TL.LayerNormalization(eps=1e-12)
    args = (8, 5) if kind == "recurrent" else (8,)
    params, _, _ = _pair(jl, tl, args, kind)
    rng = np.random.default_rng(5)
    params = {k: (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()}
    got, want = _apply_both(jl, tl, params, _x(*shape) * 3 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_time_distributed_dense_matches_jax():
    jl = JL.TimeDistributed(layer=JL.DenseLayer(n_out=7,
                                                activation="gelu_exact"))
    tl = TL.TimeDistributed(layer=TL.DenseLayer(n_out=7,
                                                activation="gelu_exact"))
    params, jo, to = _pair(jl, tl, (6, 5))
    assert jo.size == to.size == 7 and set(params) == {"W", "b"}
    params["b"] = _x(7, seed=6)
    got, want = _apply_both(jl, tl, params, _x(3, 5, 6))
    assert got.shape == (3, 5, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["index", "column", "one_hot", "sequence"])
def test_embedding_layers_match_jax(form):
    seq = form == "sequence"
    name = "EmbeddingSequenceLayer" if seq else "EmbeddingLayer"
    jl, tl = getattr(JL, name)(n_out=4), getattr(TL, name)(n_out=4)
    params, _, _ = _pair(jl, tl, (10, 3) if seq else (10,),
                         "recurrent" if seq else "feed_forward")
    idx = np.random.default_rng(7).integers(0, 10, (5, 3) if seq else 5)
    x = {"index": idx, "sequence": idx, "column": idx[:, None],
         "one_hot": np.eye(10, dtype=np.float32)[idx]}[form]
    got, want = _apply_both(jl, tl, params, np.asarray(x).astype(
        np.float32 if form == "one_hot" else np.int32))
    assert got.shape == ((5, 3, 4) if seq else (5, 4))
    np.testing.assert_array_equal(got, want)


def test_self_attention_without_projection_matches_jax():
    jl = JL.SelfAttentionLayer(project_input=False)
    tl = TL.SelfAttentionLayer(project_input=False)
    params, jo, to = _pair(jl, tl, (8, 6))
    assert params == {} and jo.size == to.size == 8 and not tl.has_params
    got, want = _apply_both(jl, tl, {}, _x(2, 6, 8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_attention_layer_refuses_training_dropout():
    tl = TL.SelfAttentionLayer(n_out=8, n_heads=2, dropout=0.1)
    tl.set_input_type(TInputType.recurrent(8, 4))
    params = tl.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        "Wq": (8, 8), "Wk": (8, 8), "Wv": (8, 8), "Wo": (8, 8)}
    # training-mode dropout needs the network's generator: refused
    # without one, applied with one, never at inference
    with pytest.raises(ValueError, match="dropout"):
        tl.apply(params, torch.zeros(1, 4, 8), {}, training=True)
    y, _ = tl.apply(params, torch.ones(1, 4, 8), {}, training=True,
                    generator=torch.Generator().manual_seed(0))
    assert y.shape == (1, 4, 8)
    with pytest.raises(ValueError, match="RNN"):
        TL.SelfAttentionLayer(n_out=8).set_input_type(
            TInputType.feed_forward(8))


# --- training -------------------------------------------------------------------

def _fit3(which, compute_dtype, start, tokens, positions, labels):
    """Three ``fit`` steps with Adam(2e-5) from ``start``: (losses,
    parameters as numpy)."""
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
    from deeplearning4j_tpu_torch.data import MultiDataSet as TMDS

    conf = encoder_conf(which, compute_dtype=compute_dtype,
                        updater=lambda m: m.Adam(2e-5))
    if which == "jax":
        g = JGraph(conf).init()
        g._params = {n: {k: jnp.asarray(v) for k, v in d.items()}
                     for n, d in start.items()}
        mds = JMDS
    else:
        g = TGraph(conf).init(device="cpu")
        graph_state_from_numpy(g, start, {})
        mds = TMDS
    losses = []
    for _ in range(3):
        g.fit(mds([tokens, positions], [labels]))
        losses.append(float(g.score_value))
    return losses, {n: {k: np.asarray(v.detach() if hasattr(v, "detach")
                                      else v) for k, v in d.items()}
                    for n, d in g._params.items()}


def _flat(tree):
    return np.concatenate([tree[n][k].ravel() for n in sorted(tree)
                           for k in sorted(tree[n])]).astype(np.float64)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_encoder_fit_three_steps_matches_jax(compute_dtype):
    """Three ``fit`` steps of the encoder with Adam(2e-5) (BERT's
    fine-tuning rate) from the same weights on the same batch, float32 and
    bf16 compute over float32 parameters. float32: losses within 1e-5
    relative, every parameter within 1e-5 of its own leaf's scale. bf16,
    the bound of the bf16 forward above: losses within 1e-2 relative, and
    the port's update over the three steps (the parameters less their
    start) no further from the float32 update than the JAX package's bf16
    update is, with 20% and 1e-3 of its norm to spare (Adam divides each
    gradient by its own root mean square, so bf16 rounding moves the
    updates of small gradients by whole steps, in both packages alike)."""
    start = numpy_tree(JGraph(encoder_conf("jax")).init()._params)
    tokens, positions = _feed(seed=5)
    labels = np.eye(2, dtype=np.float32)[[0, 1]]
    args = (start, tokens, positions, labels)
    jl, jp = _fit3("jax", compute_dtype, *args)
    tl, tp = _fit3("torch", compute_dtype, *args)
    rtol = 1e-5 if compute_dtype is None else 1e-2
    for got, want in zip(tl, jl):
        assert abs(got - want) <= rtol * abs(want)
    if compute_dtype is None:
        for n, d in jp.items():
            for k, v in d.items():
                np.testing.assert_allclose(
                    tp[n][k], v, rtol=0, atol=1e-5 * float(np.abs(v).max()),
                    err_msg=f"{n}/{k}")
        return
    _, fp = _fit3("jax", None, *args)
    s0 = _flat(start)
    u32, ujax, uport = (_flat(t) - s0 for t in (fp, jp, tp))
    n32 = np.linalg.norm(u32)
    assert np.linalg.norm(uport - u32) <= \
        1.2 * np.linalg.norm(ujax - u32) + 1e-3 * n32, (
            np.linalg.norm(uport - u32), np.linalg.norm(ujax - u32), n32)
