"""The capsule layers (``PrimaryCapsules``, ``CapsuleLayer`` with dynamic
routing, ``CapsuleStrengthLayer``) in the port against the JAX package, on
the CPU: each layer's forward and gradients within 1e-5 of their largest
magnitude (``torch_parity.layer_parity``), a narrow CapsNet (Sabour et al.
2017's structure: convolution, primary capsules, routed capsules, their
lengths, softmax, negative log-likelihood) over three fit steps within
1e-5 of each parameter's scale, per-leaf and fused, and its model zip
between the packages.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet
from torch_parity import (assert_scaled_close, assert_trees_close,
                          layer_parity, mln_twins, modules)


def _cnn(h, w, c):
    return lambda m: m.InputType.convolutional(h, w, c)


def _caps(n, dim):
    return lambda m: m.InputType.recurrent(dim, n)


@pytest.mark.parametrize("stride", [1, 2])
def test_primary_capsules_match_jax(stride):
    jt, tt = layer_parity(lambda m: m.L.PrimaryCapsules(
        capsule_dimensions=4, channels=3, kernel_size=(3, 3),
        stride=(stride, stride)), _cnn(9, 9, 2))
    assert (tt.timesteps, tt.size) == (jt.timesteps, jt.size)


@pytest.mark.parametrize("routings", [1, 2, 3])
def test_capsule_layer_routing_matches_jax(routings):
    layer_parity(lambda m: m.L.CapsuleLayer(
        capsules=3, capsule_dimensions=5, routings=routings), _caps(12, 4))


def test_capsule_strength_matches_jax():
    layer_parity(lambda m: m.L.CapsuleStrengthLayer(), _caps(6, 4))


def capsnet_conf(which, fused=False, width=8, channels=4, dims=4,
                 caps_out=5, dim_out=6, image=14, kernel=3):
    """CapsNet's structure at narrow widths (chip_smoke phase 27 runs the
    published ones): conv 9x9 ReLU, primary capsules 9x9 stride 2, routed
    capsules (3 routings), capsule lengths, softmax, negative
    log-likelihood."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(42)
         .updater(m.Adam(1e-3)))
    if fused:
        b = b.fused_update()
    return (b.list()
            .layer(m.L.ConvolutionLayer(n_out=width,
                                        kernel_size=(kernel, kernel),
                                        activation="relu"))
            .layer(m.L.PrimaryCapsules(capsule_dimensions=dims,
                                       channels=channels,
                                       kernel_size=(kernel, kernel),
                                       stride=(2, 2)))
            .layer(m.L.CapsuleLayer(capsules=caps_out,
                                    capsule_dimensions=dim_out, routings=3))
            .layer(m.L.CapsuleStrengthLayer())
            .layer(m.L.ActivationLayer(activation="softmax"))
            .layer(m.L.LossLayer(loss="negativeloglikelihood"))
            .set_input_type(m.InputType.convolutional(image, image, 1))
            .build())


def _batch(seed, n=4, image=14, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 1, image, image), dtype=np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
def test_capsnet_three_fit_steps_match_jax(fused):
    jn, tn = mln_twins(capsnet_conf("jax", fused), capsnet_conf("torch",
                                                                fused))
    assert tn.num_params() == jn.num_params()
    for step in range(3):
        x, y = _batch(step)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        assert abs(tn.score_value - jn.score_value) \
            <= 1e-5 * abs(jn.score_value)
    assert_trees_close(tn, jn)
    x, _ = _batch(9)
    assert_scaled_close(tn.output(x), np.asarray(jn.output(x).value),
                        "output")


def test_capsnet_model_zip_round_trip_between_packages(tmp_path):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    jn, tn = mln_twins(capsnet_conf("jax"), capsnet_conf("torch"))
    jn.save(str(tmp_path / "j.zip"))
    tn.save(str(tmp_path / "t.zip"))
    back = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    assert back.layers[1].capsules == jn.layers[1].capsules == 4 * 25
    x, _ = _batch(3)
    np.testing.assert_array_equal(back.output(x).numpy(),
                                  tn.output(x).numpy())
    np.testing.assert_array_equal(
        np.asarray(JNet.load(str(tmp_path / "t.zip")).params().value),
        tn.params().numpy())


def test_capsnet_at_published_widths_has_1152_primary_capsules():
    conf = capsnet_conf("torch", width=256, channels=32, dims=8,
                        caps_out=10, dim_out=16, image=28, kernel=9)
    assert conf.layers[1].capsules == 1152
    assert conf.layer_output_types[2].timesteps == 10
    w = conf.layers[2]
    assert (w._in_caps, w.capsules, w.capsule_dimensions, w.n_in) \
        == (1152, 10, 16, 8)
