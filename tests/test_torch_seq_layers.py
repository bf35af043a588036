"""The port's sequence and shape layers against the JAX package's, on the
CPU: the 1D family on ``[B, T, F]`` (``Convolution1DLayer``,
``Subsampling1DLayer``, ``Upsampling1D``, ``ZeroPadding1DLayer``,
``Cropping1D``, ``SeparableConvolution1D``) and the 2D shape layers on
NCHW (``Upsampling2D``, ``ZeroPaddingLayer``, ``Cropping2D``,
``SpaceToBatchLayer``), with the ops under them (``conv1d``,
``upsampling2d``, ``space_to_batch``).

Each layer is built in both packages with the JAX layer's parameters
carried across: the inferred output type, the forward (whose shape must be
that type's), and the gradients of a weighted sum of the output with
respect to the parameters and the input. Then a network that puts the 1D
layers in front of an LSTM takes two steps in both packages. Tolerance:
float32, 1e-5 of each array's scale.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.ops import nn as tops
from torch_parity import (assert_scaled_close, mln_twins, modules,
                          numpy_tree)

SEQ = (2, 11, 4)        # B, T, F
IMG = (2, 3, 8, 6)      # N, C, H, W


LAYERS = {
    "conv1d": (SEQ, lambda L: L.Convolution1DLayer(n_out=5, kernel_size=3)),
    "conv1d_padded_strided": (SEQ, lambda L: L.Convolution1DLayer(
        n_out=5, kernel_size=3, stride=2, padding=1, activation="tanh")),
    "conv1d_dilated": (SEQ, lambda L: L.Convolution1DLayer(
        n_out=3, kernel_size=2, dilation=3, has_bias=False)),
    "conv1d_same": (SEQ, lambda L: L.Convolution1DLayer(
        n_out=5, kernel_size=4, stride=2, convolution_mode="same")),
    "subsampling1d_max": (SEQ, lambda L: L.Subsampling1DLayer()),
    "subsampling1d_avg_padded": (SEQ, lambda L: L.Subsampling1DLayer(
        kernel_size=3, stride=2, padding=1, pooling_type="avg")),
    "subsampling1d_max_padded": (SEQ, lambda L: L.Subsampling1DLayer(
        kernel_size=3, stride=1, padding=1)),
    "upsampling1d": (SEQ, lambda L: L.Upsampling1D(size=3)),
    "zero_padding1d": (SEQ, lambda L: L.ZeroPadding1DLayer(padding=(2, 1))),
    "zero_padding1d_int": (SEQ, lambda L: L.ZeroPadding1DLayer(padding=2)),
    "cropping1d": (SEQ, lambda L: L.Cropping1D(cropping=(1, 3))),
    "cropping1d_int": (SEQ, lambda L: L.Cropping1D(cropping=2)),
    "separable_conv1d": (SEQ, lambda L: L.SeparableConvolution1D(
        n_out=5, kernel_size=3, depth_multiplier=2)),
    "separable_conv1d_same": (SEQ, lambda L: L.SeparableConvolution1D(
        n_out=4, kernel_size=4, stride=2, convolution_mode="same",
        activation="relu")),
    "upsampling2d": (IMG, lambda L: L.Upsampling2D(size=(2, 3))),
    "zero_padding2d": (IMG, lambda L: L.ZeroPaddingLayer(
        padding=(1, 2, 0, 3))),
    "cropping2d": (IMG, lambda L: L.Cropping2D(cropping=(1, 2, 2, 1))),
    "space_to_batch": (IMG, lambda L: L.SpaceToBatchLayer(block_size=2)),
}


def _input_type(m, shape):
    if len(shape) == 3:
        return m.InputType.recurrent(shape[2], shape[1])
    return m.InputType.convolutional(shape[2], shape[3], shape[1])


def _twins(spec):
    shape, make = LAYERS[spec]
    out = []
    for which in ("jax", "torch"):
        m = modules(which)
        layer = make(m.L)
        if layer.weight_init is None:
            layer.weight_init = "xavier"
        if layer.activation is None:
            layer.activation = "identity"
        out.append((layer, layer.set_input_type(_input_type(m, shape))))
    (jl, jt), (tl, tt) = out
    params = numpy_tree(jl.init_params(jax.random.PRNGKey(4), jnp.float32)
                        if jl.has_params else {})
    return jl, jt, tl, tt, params, shape


@pytest.mark.parametrize("spec", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(spec):
    jl, jt, tl, tt, params, shape = _twins(spec)
    assert type(tt).__name__ == type(jt).__name__
    assert vars(tt) == vars(jt)
    assert tl.has_params == jl.has_params
    if tl.has_params:
        got = tl.init_params(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in params.items()}
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want, _ = jl.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), {},
                       False, None)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got, _ = tl.apply(tp, tx, {}, False)
    assert_scaled_close(got, want, f"{spec} forward")
    if len(shape) == 3 and type(tt).__name__ == "RNNInput":
        assert tuple(got.shape) == (shape[0], tt.timesteps, tt.size)
    elif spec != "space_to_batch":
        assert tuple(got.shape[1:]) == (tt.channels, tt.height, tt.width)
    ct = np.random.default_rng(3).normal(size=np.shape(want)).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, xx, {}, False, None)[0] * ct)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    names = sorted(tp)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(ct)),
                                [tp[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        assert_scaled_close(g, jgp[k], f"{spec} d/d{k}")
    assert_scaled_close(grads[-1], jgx, f"{spec} d/dx")


def test_conv1d_op_matches_jax_in_both_paddings():
    from deeplearning4j_tpu.ops import registry as jreg

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 4, 9)).astype(np.float32)
    w = rng.normal(size=(3, 4, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    for kw in ({"padding": 1, "stride": 2}, {"padding": "SAME"},
               {"dilation": 2}):
        want = jreg.get_op("conv1d").fn(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), **kw)
        got = tops.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), **kw)
        assert_scaled_close(got, want, f"conv1d {kw}")


def _net_conf(which):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(9).updater(m.Adam(0.01))
            .list()
            .layer(m.L.ZeroPadding1DLayer(padding=(1, 0)))
            .layer(m.L.Convolution1DLayer(n_out=6, kernel_size=3,
                                          activation="relu"))
            .layer(m.L.Subsampling1DLayer(kernel_size=2, stride=2))
            .layer(m.L.SeparableConvolution1D(n_out=5, kernel_size=2,
                                              convolution_mode="same"))
            .layer(m.L.Upsampling1D(size=2))
            .layer(m.L.Cropping1D(cropping=(0, 1)))
            .layer(m.L.LSTM(n_out=4))
            .layer(m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"))
            .set_input_type(m.InputType.recurrent(4, 12)).build())


def test_sequence_network_of_1d_layers_steps_as_jax():
    jn, tn = mln_twins(_net_conf("jax"), _net_conf("torch"))
    assert [vars(t) for t in tn.conf.layer_output_types] == \
        [vars(t) for t in jn.conf.layer_output_types]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 12, 4)).astype(np.float32)
    t_out = tn.conf.layer_output_types[-1].timesteps
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (3, t_out))]
    assert_scaled_close(tn.output(x), np.asarray(jn.output(x).value), "output")
    for _ in range(2):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert_scaled_close(tn.params(), np.asarray(jn.params().value), "parameters")
