"""Training-mode dropout in the port against the JAX package, on the CPU.

The JAX package draws its keep mask with threefry (``jax.random.bernoulli``,
``deeplearning4j_tpu/ops/nn.py:419-426``), the port with its network's
``torch.Generator``: the bits cannot match. So each comparison injects one
keep mask into both: the port's ``ops.nn.dropout(keep=)`` or its
``dropout_mask``, and JAX's ``bernoulli`` patched to return the same mask.
With one mask the two compute the same formula, ``where(keep, x / (1 -
rate), 0)`` in x's dtype: compared bitwise (float32 and bfloat16). Losses of
networks that drop out: within 1e-5 relative (tests/test_torch_multilayer.py's
float32 bound). The port's own draws are checked by their law: the keep
share of 10^6 draws within 0.5 +- 0.005 (about 10 standard deviations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.ops import nn as jops
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.ops import nn as tops
from torch_parity import lenet_conf, mln_twins, modules


def _inject(monkeypatch, masks):
    """JAX's bernoulli returns ``masks`` (numpy bool) by shape, and the
    port's dropout_mask the same: one mask per shape, shared."""
    by_shape = {tuple(m.shape): m for m in masks}
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(by_shape[
                            tuple(shape)]))
    monkeypatch.setattr(tops, "dropout_mask",
                        lambda shape, rate, generator, device: torch.from_numpy(
                            by_shape[tuple(shape)]).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.5, 0.1, 0.75])
def test_injected_mask_matches_jax_formula(monkeypatch, dtype, rate):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 33)).astype(np.float32)
    keep = rng.random((16, 33)) < 1 - rate
    _inject(monkeypatch, [keep])
    jx = jnp.asarray(x).astype(dtype)
    want = jops.dropout(jx, jax.random.PRNGKey(0), rate=rate)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tops.dropout(tx, rate, keep=torch.from_numpy(keep))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    drawn = tops.dropout(tx, rate, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(drawn.float().numpy(),
                                  got.float().numpy())


@pytest.mark.parametrize("rate", [0.5, 0.2])
def test_keep_share_of_the_draws(rate):
    gen = torch.Generator().manual_seed(3)
    keep = tops.dropout_mask((1000, 1000), rate, gen, "cpu")
    assert abs(keep.float().mean().item() - (1 - rate)) <= 0.005
    again = tops.dropout_mask((1000, 1000), rate,
                              torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(keep, again)
    with pytest.raises(ValueError, match="Generator"):
        tops.dropout(torch.ones(3), 0.5)


def test_dropout_layer(monkeypatch):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 10)).astype(np.float32)
    keep = rng.random((4, 10)) < 0.7
    _inject(monkeypatch, [keep])
    jl, tl = modules("jax").L.DropoutLayer(rate=0.3), TL.DropoutLayer(rate=0.3)
    assert not tl.has_params
    want, _ = jl.apply({}, jnp.asarray(x), {}, True, jax.random.PRNGKey(0))
    got, _ = tl.apply({}, torch.from_numpy(x), {}, True,
                      generator=torch.Generator())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same, _ = tl.apply({}, torch.from_numpy(x), {}, False)
    np.testing.assert_array_equal(same.numpy(), x)


@pytest.mark.parametrize("kind", ["dense", "conv", "output", "attention"])
def test_layers_drop_their_input_in_training_only(monkeypatch, kind):
    """Each layer that the JAX package's ``_maybe_dropout`` reaches, with
    one injected mask, against the JAX layer."""
    mj, mt = modules("jax"), modules("torch")
    rng = np.random.default_rng(2)
    make = {"dense": (lambda m: m.L.DenseLayer(n_out=6, dropout=0.4),
                      lambda m: m.InputType.feed_forward(5), (3, 5)),
            "conv": (lambda m: m.L.ConvolutionLayer(n_out=2,
                                                    kernel_size=(2, 2),
                                                    dropout=0.4),
                     lambda m: m.InputType.convolutional(4, 4, 3),
                     (2, 3, 4, 4)),
            "output": (lambda m: m.L.OutputLayer(n_out=4, dropout=0.4),
                       lambda m: m.InputType.feed_forward(5), (3, 5)),
            "attention": (lambda m: m.L.SelfAttentionLayer(
                n_out=8, n_heads=2, dropout=0.4),
                lambda m: m.InputType.recurrent(8, 4), (2, 4, 8))}[kind]
    jl, tl = make[0](mj), make[0](mt)
    for layer, m in ((jl, mj), (tl, mt)):
        layer.activation = layer.activation or "identity"
        layer.weight_init = "xavier"
        layer.set_input_type(make[1](m))
    params = {k: np.array(v) for k, v in
              jl.init_params(jax.random.PRNGKey(0)).items()}
    x = rng.normal(size=make[2]).astype(np.float32)
    keep = rng.random(make[2]) < 0.6
    _inject(monkeypatch, [keep])
    want, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                       jnp.asarray(x), {}, True, jax.random.PRNGKey(1))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    got, _ = tl.apply(tp, torch.from_numpy(x), {}, True,
                      generator=torch.Generator())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    inference, _ = tl.apply(tp, torch.from_numpy(x), {}, False)
    plain, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x), {}, False, jax.random.PRNGKey(1))
    np.testing.assert_allclose(inference.numpy(), np.asarray(plain),
                               rtol=1e-5, atol=1e-6)


def test_network_with_dropout_trains_as_jax_on_one_mask(monkeypatch):
    """LeNet with dropout 0.5 on the dense layer's input: two steps with one
    injected mask (the jitted JAX step bakes the mask its trace saw, so
    both steps reuse it) against the JAX network."""
    jconf, tconf = lenet_conf("jax"), lenet_conf("torch")
    jconf.layers[4].dropout = tconf.layers[4].dropout = 0.5
    jn, tn = mln_twins(jconf, tconf)
    rng = np.random.default_rng(4)
    x = rng.random((16, 1, 28, 28), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    keep = rng.random((16, 800)) < 0.5
    _inject(monkeypatch, [keep])
    for _ in range(2):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        want = jn.score_value
        assert abs(tn.score_value - want) <= 1e-5 * abs(want)
    np.testing.assert_allclose(tn.params().numpy(),
                               np.asarray(jn.params().value), rtol=1e-5,
                               atol=1e-6)
    # inference never drops: the same output twice, and the JAX one
    out = tn.output(x).numpy()
    np.testing.assert_array_equal(out, tn.output(x).numpy())
    np.testing.assert_allclose(out, np.asarray(jn.output(x).value), rtol=0,
                               atol=1e-6)


def test_dropout_draws_come_from_the_network_generator():
    """Two networks from one configuration draw the same masks, step for
    step; the global dropout cascades onto every layer that drops."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = lenet_conf("torch")
    conf.layers[4].dropout = 0.5
    x = np.random.default_rng(5).random((8, 1, 28, 28), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[np.arange(8)]
    a = MultiLayerNetwork(conf).init(device="cpu")
    b = MultiLayerNetwork(lenet_conf("torch")).init(device="cpu")
    b.conf.layers[4].dropout = 0.5
    for net in (a, b):
        net.fit(DataSet(x, y))
    np.testing.assert_array_equal(a.params().numpy(), b.params().numpy())
    m = modules("torch")
    g = (m.NeuralNetConfiguration.builder().dropout(0.25).list()
         .layer(m.L.DenseLayer(n_out=4)).layer(m.L.OutputLayer(n_out=2))
         .set_input_type(m.InputType.feed_forward(3)).build())
    assert [layer.dropout for layer in g.layers] == [0.25, 0.25]


def test_graph_training_drops_out_as_jax(monkeypatch):
    """ComputationGraph passes its generator to the layers in training too:
    a dense layer with dropout 0.4 trains as the JAX graph does on one
    injected mask."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
    from torch_parity import numpy_tree

    def conf(which):
        m = modules(which)
        gb = m.graph.ComputationGraphConfiguration.graph_builder(
            m.NeuralNetConfiguration.builder().seed(3).updater(m.Sgd(0.1))
        ).add_inputs("in")
        gb.add_layer("d", m.L.DenseLayer(n_out=6, activation="relu",
                                         dropout=0.4), "in")
        gb.add_layer("out", m.L.OutputLayer(n_out=3), "d")
        return gb.set_outputs("out").set_input_types(
            m.InputType.feed_forward(5)).build()

    jg, tg = JGraph(conf("jax")).init(), TGraph(conf("torch")).init(
        device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params), {})
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    _inject(monkeypatch, [rng.random((4, 5)) < 0.6])
    for _ in range(2):
        jg.fit(JDataSet(x, y))
        tg.fit(DataSet(x, y))
        want = jg.score_value
        assert abs(tg.score_value - want) <= 1e-5 * abs(want)
