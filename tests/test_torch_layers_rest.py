"""The layer classes of ROADMAP A4's end, in the port against the JAX
package, on the CPU.

Each layer is built in both packages from one description, takes the same
seeded parameters (the JAX layer's shapes filled with normals, so that
zero-initialized slopes and gains take part) and the same seeded input:
the forward and the gradients with respect to every parameter and the
input are held within 1e-5 of each one's largest magnitude
(``torch_parity.layer_parity``). Then each in a two-layer
``MultiLayerNetwork`` (the layer and its loss head) from the JAX network's
parameters: three fit steps, every parameter within 1e-5 of its leaf's
scale. Random draws (the dropout variants, noise, DropConnect and
WeightNoise) are injected into both packages
(``torch_parity.inject_draws``), as tests/test_torch_dropout.py does.

Also here: the configuration JSON and the model zip of every new class
between the packages, the lambda registry, and the AST check that every
class of the JAX ``layers.py``, ``layers_ext.py``, ``inputs.py``,
``transfer.py`` and zoo has a counterpart in the port.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.ops import nn as tops
from torch_parity import (assert_trees_close, inject_draws, input_array,
                          labels_for, layer_parity, mln_twins, modules,
                          stack_conf)

ROOT = Path(__file__).resolve().parent.parent


def _ff(n):
    return lambda m: m.InputType.feed_forward(n)


def _rnn(n, t):
    return lambda m: m.InputType.recurrent(n, t)


def _cnn(h, w, c):
    return lambda m: m.InputType.convolutional(h, w, c)


def _cnn3d(d, h, w, c):
    return lambda m: m.InputType.convolutional_3d(d, h, w, c)


def _twice_plus_one(x):
    return x * 2.0 + 1.0


def _first_three(x):
    return x[:, :3]


# (id, make(m) -> layer, input type)
CASES = [
    ("prelu_ff", lambda m: m.L.PReLULayer(), _ff(6)),
    ("prelu_cnn", lambda m: m.L.PReLULayer(), _cnn(4, 4, 3)),
    ("elementwise_mul", lambda m: m.L.ElementWiseMultiplicationLayer(
        activation="tanh"), _ff(6)),
    ("thresholded_relu", lambda m: m.L.ThresholdedReLULayer(theta=0.3),
     _ff(6)),
    ("group_norm_cnn", lambda m: m.L.GroupNormalizationLayer(groups=2),
     _cnn(4, 4, 4)),
    ("group_norm_ff", lambda m: m.L.GroupNormalizationLayer(groups=3),
     _ff(6)),
    ("flatten_cnn", lambda m: m.L.FlattenLayer(), _cnn(3, 3, 2)),
    ("flatten_rnn", lambda m: m.L.FlattenLayer(), _rnn(4, 5)),
    ("flatten_cnn3d", lambda m: m.L.FlattenLayer(), _cnn3d(2, 3, 3, 2)),
    ("permute", lambda m: m.L.Permute(dims=(2, 1)), _rnn(4, 5)),
    ("reshape_ff_rnn", lambda m: m.L.ReshapeLayer(shape=(5, 4)), _ff(20)),
    ("reshape_rnn_ff", lambda m: m.L.ReshapeLayer(shape=(20,)), _rnn(4, 5)),
    ("repeat_vector", lambda m: m.L.RepeatVector(n=3), _ff(4)),
    ("time_distributed_layer", lambda m: m.L.TimeDistributedLayer(
        inner=m.L.DenseLayer(n_out=3, activation="tanh")), _rnn(4, 5)),
    ("lambda_affine", lambda m: m.L.LambdaLayer(fn=_twice_plus_one,
                                                name="twice_plus_one"),
     _ff(6)),
    ("lambda_slice", lambda m: m.L.LambdaLayer(fn=_first_three,
                                               name="first_three"), _ff(6)),
    ("conv3d", lambda m: m.L.Convolution3DLayer(
        n_out=3, kernel_size=(2, 2, 2), activation="relu"),
     _cnn3d(4, 5, 5, 2)),
    ("conv3d_same_stride", lambda m: m.L.Convolution3DLayer(
        n_out=2, kernel_size=(3, 3, 3), stride=(2, 2, 2),
        convolution_mode="same"), _cnn3d(5, 5, 4, 2)),
    ("conv3d_padded_dilated", lambda m: m.L.Convolution3DLayer(
        n_out=2, kernel_size=(2, 2, 2), padding=(1, 1, 1),
        dilation=(2, 1, 1), has_bias=False), _cnn3d(5, 4, 4, 2)),
    ("maxpool3d", lambda m: m.L.Subsampling3DLayer(), _cnn3d(4, 4, 6, 2)),
    ("avgpool3d_padded", lambda m: m.L.Subsampling3DLayer(
        pooling_type="avg", kernel_size=(3, 3, 3), stride=(2, 2, 2),
        padding=(1, 1, 1)), _cnn3d(5, 5, 5, 2)),
    ("upsampling3d", lambda m: m.L.Upsampling3D(size=(1, 2, 3)),
     _cnn3d(2, 3, 3, 2)),
    ("zero_padding3d", lambda m: m.L.ZeroPadding3DLayer(
        padding=((1, 0), (0, 2), (1, 1))), _cnn3d(2, 3, 3, 2)),
    ("cropping3d", lambda m: m.L.Cropping3D(cropping=(1, 0, 1)),
     _cnn3d(4, 4, 4, 2)),
    ("locally_connected2d", lambda m: m.L.LocallyConnected2D(
        n_out=3, kernel_size=(2, 3), stride=(1, 2), activation="tanh"),
     _cnn(5, 6, 2)),
    ("locally_connected1d", lambda m: m.L.LocallyConnected1D(
        n_out=3, kernel_size=3, stride=2), _rnn(4, 9)),
    ("learned_self_attention", lambda m: m.L.LearnedSelfAttentionLayer(
        n_out=8, n_heads=2, n_queries=3), _rnn(8, 5)),
    ("learned_self_attention_raw", lambda m: m.L.LearnedSelfAttentionLayer(
        project_input=False, n_queries=2), _rnn(6, 5)),
    ("recurrent_attention", lambda m: m.L.RecurrentAttentionLayer(
        n_out=6, n_heads=2), _rnn(4, 5)),
    ("conv_lstm2d_seq", lambda m: m.L.ConvLSTM2DLayer(
        n_out=3, kernel_size=(3, 3)), _cnn3d(3, 5, 5, 2)),
    ("conv_lstm2d_same_last", lambda m: m.L.ConvLSTM2DLayer(
        n_out=2, kernel_size=(3, 3), convolution_mode="same",
        return_sequences=False), _cnn3d(3, 4, 4, 2)),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(autouse=True)
def _lambdas():
    from deeplearning4j_tpu.imports import keras_import as jk
    from deeplearning4j_tpu_torch.imports import keras_import as tk

    for reg in (jk, tk):
        reg.register_lambda("twice_plus_one", _twice_plus_one)
        reg.register_lambda("first_three", _first_three)
    yield
    for reg in (jk, tk):
        reg.unregister_lambda("twice_plus_one")
        reg.unregister_lambda("first_three")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_layer_forward_and_gradients_match_jax(case):
    _, make, in_type = case
    layer_parity(make, in_type)


@pytest.mark.parametrize("n_queries, want", [(3, "dense"), (5, "flash")])
def test_learned_attention_takes_the_route_the_op_picks(n_queries, want):
    """The attention op picks its route from the shapes (flash for
    self-attention shapes, ``tq == tk``, dense otherwise) and counts it;
    the recurrent attention's single query always goes dense."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    mt = modules("torch")
    for layer, t, route in (
            (mt.L.LearnedSelfAttentionLayer(n_out=8, n_heads=2,
                                            n_queries=n_queries),
             _rnn(8, 5), want),
            (mt.L.RecurrentAttentionLayer(n_out=6, n_heads=2), _rnn(4, 5),
             "dense")):
        layer.set_input_type(t(mt))
        params = layer.init_params(torch.Generator().manual_seed(0))
        prof = OpProfiler.get()
        prof.reset()
        x = torch.randn(2, 5, t(mt).size, generator=torch.Generator())
        layer.apply(params, x, {}, False)
        counters = prof.get_counters()
        steps = 5 if isinstance(layer, mt.L.RecurrentAttentionLayer) else 1
        assert counters.get(f"attention/mha_{route}") == steps, counters


def _fit_three(make, in_type, updater=None, masks=(), normals=(),
               monkeypatch=None, batch=4, layers=None):
    mj, mt = modules("jax"), modules("torch")
    probe = make(mt)
    out_type = probe.set_input_type(in_type(mt))
    build = layers or (lambda m: [make(m)])
    jn, tn = mln_twins(stack_conf("jax", build, in_type, out_type, updater),
                       stack_conf("torch", build, in_type, out_type,
                                  updater))
    if monkeypatch is not None:
        inject_draws(monkeypatch, masks, normals)
    rng = np.random.default_rng(11)
    for _ in range(3):
        x = input_array(in_type(mj), batch, rng)
        y = labels_for(out_type, batch, rng)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        assert abs(tn.score_value - jn.score_value) \
            <= 1e-5 * max(abs(jn.score_value), 1.0)
    assert_trees_close(tn, jn)
    return jn, tn


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_three_fit_steps_match_jax(case):
    _, make, in_type = case
    _fit_three(make, in_type)


# --- the dropout variants and noise, with injected draws -------------------------

NOISE = [
    ("alpha_dropout", lambda m: m.L.AlphaDropoutLayer(rate=0.3), _ff(6),
     "mask"),
    ("gaussian_dropout", lambda m: m.L.GaussianDropoutLayer(rate=0.3),
     _ff(6), "normal"),
    ("gaussian_noise", lambda m: m.L.GaussianNoiseLayer(stddev=0.2),
     _rnn(4, 5), "normal"),
    ("spatial_dropout_rnn", lambda m: m.L.SpatialDropoutLayer(rate=0.4),
     _rnn(4, 5), "spatial"),
    ("spatial_dropout_cnn", lambda m: m.L.SpatialDropoutLayer(rate=0.4),
     _cnn(3, 3, 4), "spatial"),
]


def _noise_draws(kind, t, batch, rng):
    x = input_array(t, batch, rng)
    if kind == "mask":
        return [rng.random(x.shape) < 0.7], []
    if kind == "normal":
        return [], [rng.normal(size=x.shape).astype(np.float32)]
    shape = ((batch, 1, x.shape[2]) if x.ndim == 3
             else (batch, x.shape[1]) + (1,) * (x.ndim - 2))
    return [rng.random(shape) < 0.6], []


@pytest.mark.parametrize("case", NOISE, ids=[c[0] for c in NOISE])
def test_noise_layers_match_jax_with_injected_draws(monkeypatch, case):
    _, make, in_type, kind = case
    mt = modules("torch")
    masks, normals = _noise_draws(kind, in_type(mt), 3,
                                  np.random.default_rng(0))
    inject_draws(monkeypatch, masks, normals)
    layer_parity(make, in_type, training=True)
    # in inference every one is the identity
    layer = make(mt)
    layer.set_input_type(in_type(mt))
    x = torch.from_numpy(input_array(in_type(mt), 3,
                                     np.random.default_rng(1)))
    y, _ = layer.apply({}, x, {}, False)
    assert torch.equal(y, x)


@pytest.mark.parametrize("case", NOISE, ids=[c[0] for c in NOISE])
def test_noise_layers_fit_three_steps_like_jax(monkeypatch, case):
    _, make, in_type, kind = case
    mt = modules("torch")
    masks, normals = _noise_draws(kind, in_type(mt), 4,
                                  np.random.default_rng(2))

    def layers(m):
        return [m.L.DenseLayer(n_out=6, activation="tanh"), make(m)] \
            if type(in_type(m)).__name__ == "FFInput" else [make(m)]

    _fit_three(make, in_type, masks=masks, normals=normals,
               monkeypatch=monkeypatch, layers=layers)


def test_noise_draws_follow_their_law():
    gen = torch.Generator().manual_seed(4)
    x = torch.ones(400, 1000)
    y = tops.gaussian_dropout(x, 0.2, gen)
    assert abs(y.mean().item() - 1.0) < 0.005
    assert abs(y.var().item() - 0.25) < 0.005
    z = tops.gaussian_noise(torch.zeros(400, 1000), 0.3, gen)
    assert abs(z.std().item() - 0.3) < 0.003
    a = tops.alpha_dropout(torch.randn(400, 1000, generator=gen), 0.1, gen)
    assert abs(a.mean().item()) < 0.01 and abs(a.var().item() - 1) < 0.02


# --- weight noise ------------------------------------------------------------------

WEIGHT_NOISE = [
    ("dropconnect", lambda m: m.L.DropConnect(weight_retain_prob=0.7)),
    ("dropconnect_biases", lambda m: m.L.DropConnect(
        weight_retain_prob=0.6, apply_to_biases=True)),
    ("weightnoise_additive", lambda m: m.L.WeightNoise(stddev=0.1)),
    ("weightnoise_multiplicative", lambda m: m.L.WeightNoise(
        mean=1.0, stddev=0.2, additive=False)),
]


@pytest.mark.parametrize("case", WEIGHT_NOISE,
                         ids=[c[0] for c in WEIGHT_NOISE])
def test_weight_noise_fit_matches_jax(monkeypatch, case):
    _, noise = case
    rng = np.random.default_rng(3)
    w_shape, b_shape = (5, 7), (7,)
    masks = [rng.random(w_shape) < 0.65, rng.random(b_shape) < 0.65]
    normals = [rng.normal(size=w_shape).astype(np.float32)]

    def layers(m):
        return [m.L.DenseLayer(n_out=7, activation="tanh",
                               weight_noise=noise(m))]

    _fit_three(lambda m: layers(m)[0], _ff(5), masks=masks,
               normals=normals, monkeypatch=monkeypatch, layers=layers)


def test_weight_noise_acts_in_training_only():
    mt = modules("torch")
    conf = stack_conf("torch", lambda m: [m.L.DenseLayer(
        n_out=4, weight_noise=m.L.WeightNoise(stddev=1.0))],
        _ff(3), mt.InputType.feed_forward(4))
    net = mt.MultiLayerNetwork(conf).init(device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 3)).astype(np.float32)
    a, b = net.output(x), net.output(x)
    assert torch.equal(a, b)
    assert not torch.equal(net.output(x, training=True), a)


# --- configuration JSON and the model zip, both ways ------------------------------

SERDE = [c for c in CASES] + [
    (c[0], c[1], c[2]) for c in NOISE]


@pytest.mark.parametrize("case", SERDE, ids=[c[0] for c in SERDE])
def test_model_zip_round_trip_between_packages(tmp_path, case):
    _, make, in_type = case
    mt = modules("torch")
    out_type = make(mt).set_input_type(in_type(mt))
    jn, tn = mln_twins(stack_conf("jax", lambda m: [make(m)], in_type,
                                  out_type),
                       stack_conf("torch", lambda m: [make(m)], in_type,
                                  out_type))
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jn.save(str(tmp_path / "j.zip"))
    tn.save(str(tmp_path / "t.zip"))
    from_j = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    from_t = JNet.load(str(tmp_path / "t.zip"))
    assert [type(l).__name__ for l in from_j.layers] \
        == [type(l).__name__ for l in jn.layers]
    np.testing.assert_array_equal(from_j.params().numpy(),
                                  np.asarray(jn.params().value))
    np.testing.assert_array_equal(np.asarray(from_t.params().value),
                                  tn.params().numpy())
    x = input_array(in_type(mt), 2, np.random.default_rng(5))
    np.testing.assert_array_equal(from_j.output(x).numpy(),
                                  tn.output(x).numpy())


def test_weight_noise_configuration_round_trips_in_the_port():
    """The JAX package cannot write a configuration with weight noise (its
    ``_ser_obj`` raises TypeError; ROADMAP §C); the port writes and reads
    its own."""
    mj, mt = modules("jax"), modules("torch")

    def conf(m):
        return stack_conf(m is mj and "jax" or "torch", lambda mm: [
            mm.L.DenseLayer(n_out=4, weight_noise=mm.L.DropConnect(0.8,
                                                                   True)),
            mm.L.DenseLayer(n_out=4, weight_noise=mm.L.WeightNoise(
                0.5, 0.2, False))], _ff(3), m.InputType.feed_forward(4))

    with pytest.raises(TypeError):
        conf(mj).to_json()
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)

    back = MultiLayerConfiguration.from_json(conf(mt).to_json())
    a, b = back.layers[0].weight_noise, back.layers[1].weight_noise
    assert type(a).__name__ == "DropConnect" and a.p == 0.8 \
        and a.apply_to_biases
    assert type(b).__name__ == "WeightNoise" and (b.mean, b.stddev,
                                                  b.additive) == (0.5, 0.2,
                                                                  False)


def test_lambda_layer_serializes_by_name():
    from deeplearning4j_tpu_torch.imports import keras_import as tk
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration)

    mt = modules("torch")
    conf = stack_conf("torch", lambda m: [m.L.LambdaLayer(
        fn=_first_three, name="first_three")], _ff(6),
        mt.InputType.feed_forward(3))
    text = conf.to_json()
    assert '"__lambda__": "first_three"' in text
    assert MultiLayerConfiguration.from_json(text).layers[0].fn \
        is _first_three
    tk.unregister_lambda("first_three")
    with pytest.raises(ValueError, match="register_lambda"):
        MultiLayerConfiguration.from_json(text)
    with pytest.raises(TypeError, match="unnamed"):
        stack_conf("torch", lambda m: [m.L.LambdaLayer(fn=_first_three)],
                   _ff(6), mt.InputType.feed_forward(3)).to_json()


# --- every JAX class has its counterpart -------------------------------------------

JAX_FILES = ["nn/conf/layers.py", "nn/conf/layers_ext.py",
             "nn/conf/inputs.py", "nn/transfer.py", "models/zoo.py"]


def _classes(path: Path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(n.name for n in node.body
                       if isinstance(n, ast.ClassDef))
    return out


@pytest.mark.parametrize("rel", JAX_FILES)
def test_every_jax_class_has_a_port_counterpart(rel):
    want = _classes(ROOT / "deeplearning4j_tpu" / rel)
    have = _classes(ROOT / "deeplearning4j_tpu_torch" / rel)
    assert want and not (want - have), sorted(want - have)
