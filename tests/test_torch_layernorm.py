"""The port's LayerNormalization on CNN input, held to a numpy oracle.

On ``[B, C, H, W]`` input the port normalizes over C and applies gain and
bias along C, as both packages document. The JAX layer's code applies its
``[C]`` vectors along W instead (they broadcast against the last axis;
``deeplearning4j_tpu/nn/conf/layers_ext.py:540-543``), so this path is held
to numpy, not to the JAX output; the last test pins that divergence.

Tolerance: 1e-5 absolute on outputs of order one (float32 against the
oracle's float64; the biased variance is summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from torch_parity import modules

ATOL = 1e-5


def _oracle(x, gain, bias, eps):
    x = x.astype(np.float64)
    mean = x.mean(axis=1, keepdims=True)
    var = ((x - mean) ** 2).mean(axis=1, keepdims=True)
    shape = (1, -1, 1, 1)
    return ((x - mean) / np.sqrt(var + eps) * gain.reshape(shape)
            + bias.reshape(shape))


def _layer_case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(loc=0.5, scale=2.0, size=shape).astype(np.float32)
    C = shape[1]
    gain = rng.normal(1.0, 0.5, C).astype(np.float32)
    bias = rng.normal(0.0, 0.5, C).astype(np.float32)
    return x, gain, bias


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (2, 4, 3, 4), (1, 7, 2, 2)])
def test_cnn_input_normalizes_over_channels_gain_along_channels(shape):
    L = modules("torch").L
    x, gain, bias = _layer_case(shape, sum(shape))
    layer = L.LayerNormalization(eps=1e-3)
    layer.set_input_type(modules("torch").InputType.convolutional(
        shape[2], shape[3], shape[1]))
    assert layer.n_in == shape[1]
    params = {"gain": torch.from_numpy(gain), "bias": torch.from_numpy(bias)}
    out, _ = layer.apply(params, torch.from_numpy(x), {})
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _oracle(x, gain, bias, 1e-3),
                               rtol=0, atol=ATOL)


def test_cnn_layer_norm_in_a_graph():
    """A graph with CNN input, a LayerNormalization and a softmax head: the
    layer's output inside the graph walk matches the oracle."""
    m = modules("torch")
    b = m.NeuralNetConfiguration.builder().seed(3)
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("ln", m.L.LayerNormalization(eps=1e-5), "in")
    gb.add_layer("out", m.L.OutputLayer(n_out=3, activation="softmax",
                                        loss="mcxent"), "ln")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.convolutional(4, 5, 3))
    g = ComputationGraph(gb.build()).init(device="cpu")
    x, gain, bias = _layer_case((2, 3, 4, 5), 9)
    with torch.no_grad():
        g._params["ln"]["gain"].copy_(torch.from_numpy(gain))
        g._params["ln"]["bias"].copy_(torch.from_numpy(bias))
    acts, _ = g._forward(g._params, g._states, {"in": torch.from_numpy(x)},
                         False)
    np.testing.assert_allclose(acts["ln"].numpy(),
                               _oracle(x, gain, bias, 1e-5), rtol=0,
                               atol=ATOL)
    probs = g.output(x)[0]
    assert probs.shape == (2, 3)
    np.testing.assert_allclose(probs.sum(1).numpy(), 1.0, atol=1e-6)


def test_jax_layer_applies_cnn_gain_along_width():
    """The divergence the port's docstring names: with W == C the JAX layer
    scales along W (and with W != C it cannot broadcast at all)."""
    jL = modules("jax").L
    x, gain, bias = _layer_case((2, 4, 3, 4), 5)
    layer = jL.LayerNormalization(eps=1e-3)
    layer.set_input_type(modules("jax").InputType.convolutional(3, 4, 4))
    out, _ = layer.apply({"gain": jnp.asarray(gain),
                          "bias": jnp.asarray(bias)}, jnp.asarray(x), {},
                         False, None)
    xd = x.astype(np.float64)
    norm = (xd - xd.mean(1, keepdims=True)) / np.sqrt(
        xd.var(1, keepdims=True) + 1e-3)
    along_w = norm * gain.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
    np.testing.assert_allclose(np.asarray(out), along_w, rtol=0, atol=ATOL)
    assert np.abs(along_w - _oracle(x, gain, bias, 1e-3)).max() > 0.1
