"""The variational autoencoder and layerwise pretraining in the port
against the JAX package, on the CPU.

The draws of ``eps`` (``jax.random.normal`` in the JAX package,
``ops.nn.normal`` in the port) are injected into both
(``torch_parity.inject_draws``). Tolerances: forwards, the negative ELBO
and gradients within 1e-5 of their largest magnitude; parameters after
pretraining or three fit steps within 1e-5 of each leaf's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import (
    NDArrayDataSetIterator as JIter)
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from torch_parity import (assert_scaled_close, assert_trees_close,
                          inject_draws, layer_parity, mln_twins, modules,
                          numpy_tree, seeded_params, to_jax, to_torch)

N_IN, LATENT = 12, 3


def _vae(dist, samples=1, act="tanh"):
    return lambda m: m.L.VariationalAutoencoder(
        n_out=LATENT, encoder_layer_sizes=(8, 6), decoder_layer_sizes=(7,),
        reconstruction_distribution=dist, num_samples=samples,
        activation=act)


def _ff(m):
    return m.InputType.feed_forward(N_IN)


def _data(dist, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, N_IN)).astype(np.float32)
    if dist == "bernoulli":
        x = (x > 0.5).astype(np.float32)
    return x


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_posterior_mean_forward_matches_jax(dist):
    layer_parity(_vae(dist), _ff)


@pytest.mark.parametrize("samples", [1, 2])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_negative_elbo_and_gradients_match_jax(monkeypatch, dist, samples):
    mj, mt = modules("jax"), modules("torch")
    jl, tl = _vae(dist, samples)(mj), _vae(dist, samples)(mt)
    jl.set_input_type(_ff(mj))
    tl.set_input_type(_ff(mt))
    params = seeded_params(jl, 3, scale=0.3)
    x = _data(dist, 5, 0)
    eps = np.random.default_rng(1).normal(size=(5, LATENT)).astype(
        np.float32)
    inject_draws(monkeypatch, normals=[eps])
    want, jg = jax.value_and_grad(
        lambda p: jl.pretrain_loss(p, jnp.asarray(x),
                                   jax.random.PRNGKey(0)))(to_jax(params))
    tp = to_torch(params, requires_grad=True)
    got = tl.pretrain_loss(tp, torch.from_numpy(x), torch.Generator())
    assert_scaled_close(got, np.asarray(want), "negative ELBO")
    grads = torch.autograd.grad(got, list(tp.values()))
    jg = numpy_tree(jg)
    for (k, _), g in zip(tp.items(), grads):
        assert_scaled_close(g, jg[k], f"d{k}")
    assert_scaled_close(
        tl.reconstruction_error(to_torch(params), torch.from_numpy(x)),
        np.asarray(jl.reconstruction_error(to_jax(params), jnp.asarray(x),
                                           jax.random.PRNGKey(0))),
        "reconstruction error")


def _net_conf(which, dist, updater=None, l2=0.0):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(7)
         .updater(updater(m) if updater else m.Adam(1e-2)).l2(l2))
    return (b.list()
            .layer(m.L.DenseLayer(n_out=N_IN, activation="sigmoid"))
            .layer(_vae(dist, act="leakyrelu")(m))
            .layer(m.L.OutputLayer(n_out=2, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(N_IN)).build())


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_pretrain_matches_jax(monkeypatch, dist):
    """One epoch of three batches: only the autoencoder moves, each step
    on the inference-mode output of the dense layer below it, with a fresh
    Adam; then three supervised fit steps through the posterior mean."""
    jn, tn = mln_twins(_net_conf("jax", dist), _net_conf("torch", dist))
    x = _data(dist, 12, 2)
    y = np.eye(2, dtype=np.float32)[np.arange(12) % 2]
    eps = np.random.default_rng(4).normal(size=(4, LATENT)).astype(
        np.float32)
    inject_draws(monkeypatch, normals=[eps])
    before = {k: {n: t.clone() for n, t in tn._params[k].items()}
              for k in ("0000", "0002")}
    jn.pretrain(JIter(x, y, batch_size=4), epochs=1)
    tn.pretrain(NDArrayDataSetIterator(x, y, batch_size=4), epochs=1)
    assert abs(tn.score_value - jn.score_value) \
        <= 1e-5 * abs(jn.score_value)
    assert_trees_close(tn, jn, what="pretrained")
    for k, tree in before.items():
        for n, t in tree.items():
            assert torch.equal(tn._params[k][n], t), (k, n)
    for step in range(3):
        jn.fit(JDataSet(x[step::3], y[step::3]))
        tn.fit(DataSet(x[step::3], y[step::3]))
    assert_trees_close(tn, jn, what="fit after pretraining")


def test_pretrain_lowers_the_negative_elbo_and_leaves_fused_buckets_valid():
    mt = modules("torch")
    conf = _net_conf("torch", "bernoulli", l2=1e-4)
    conf.global_conf.fused_update = True
    net = mt.MultiLayerNetwork(conf).init(device="cpu")
    x = _data("bernoulli", 64, 5)
    y = np.eye(2, dtype=np.float32)[np.arange(64) % 2]
    net.fit(DataSet(x, y))                  # builds the flat buckets
    store = net._flat
    vae = net.layers[1]
    feats = torch.sigmoid(torch.from_numpy(x) @ net._params["0000"]["W"]
                          + net._params["0000"]["b"])
    gen = torch.Generator().manual_seed(0)
    first = float(vae.pretrain_loss(net._params["0001"], feats, gen))
    net.pretrain(NDArrayDataSetIterator(x, y, batch_size=16), epochs=5)
    last = float(vae.pretrain_loss(net._params["0001"], feats,
                                   torch.Generator().manual_seed(0)))
    assert last < first
    assert net._flat is store and store.holds(net._params)
    net.fit(DataSet(x, y))
    assert np.isfinite(net.score_value)


def test_vae_model_zip_round_trip_between_packages(tmp_path):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jn, tn = mln_twins(_net_conf("jax", "gaussian"),
                       _net_conf("torch", "gaussian"))
    jn.save(str(tmp_path / "j.zip"))
    tn.save(str(tmp_path / "t.zip"))
    back = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    np.testing.assert_array_equal(back.params().numpy(),
                                  np.asarray(jn.params().value))
    assert sorted(back._params["0001"]) == sorted(jn._params[1])
    jback = JNet.load(str(tmp_path / "t.zip"))
    np.testing.assert_array_equal(np.asarray(jback.params().value),
                                  tn.params().numpy())
    assert jback.layers[1].encoder_layer_sizes == (8, 6)
