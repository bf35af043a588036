"""The convolution family of the port against the JAX package, on the CPU.

Each op of ``deeplearning4j_tpu_torch/ops/nn.py`` that the zoo's CNNs run
(convolution with SAME padding, transposed, depthwise and separable
convolution, max, average and p-norm pooling, local response
normalization, space-to-depth) against its JAX counterpart
(``deeplearning4j_tpu/ops/nn.py``, ``ops/shape.py``) on the same seeded
numpy inputs: the forward, and the gradient of ``sum(out * ct)`` for a
seeded cotangent ``ct`` by ``jax.grad`` and autograd. Odd and even sizes,
strides 1 and 2, SAME and explicit padding, even and odd kernels, depth
multiplier 2. Then the layers (their output types against the shapes they
give), the bf16 compute path of convolution, pooling and BatchNormalization,
and the center-loss and YOLOv2 heads' scores and gradients.

Tolerances: float32 within 1e-5 of the output's (or gradient's) largest
magnitude, the sums running in another order; bf16 within 2 bf16 ulp of
the output's scale (2^-7 of it: each package rounds the convolution's
float32 accumulation once, at another place in its sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import inputs as JI
from deeplearning4j_tpu.nn.conf import layers as JL
from deeplearning4j_tpu.ops import nn as jops
from deeplearning4j_tpu.ops import shape as jshape
from deeplearning4j_tpu_torch.nn.conf import inputs as TI
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.ops import nn as tops
from torch_parity import one_torch_thread, yolo_labels  # noqa: F401

TOL = 1e-5


def _r(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


def _both(jfn, tfn, args, seed=99):
    """Forward and gradient (of every array argument) of ``sum(out * ct)``
    in both packages; the arrays in ``args`` are numpy float32."""
    jout = jax.jit(jfn)(*[jnp.asarray(a) for a in args])
    ct = _r(np.shape(jout), seed)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * ct),
                              argnums=tuple(range(len(args)))))(
        *[jnp.asarray(a) for a in args])
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    (tout * torch.from_numpy(ct)).sum().backward()
    _close(tout.detach().numpy(), jout)
    for t, g in zip(targs, jgrads):
        _close(t.grad.numpy(), g)
    return tout.detach().numpy()


# --- ops ---------------------------------------------------------------------

@pytest.mark.parametrize("size", [9, 14])
@pytest.mark.parametrize("k,stride,dil", [(3, 1, 1), (3, 2, 1), (1, 2, 1),
                                          (2, 2, 1), (7, 1, 1), (3, 1, 2)])
def test_conv2d_same_matches_jax(size, k, stride, dil):
    """Height ``size``, width ``size + 1``: an odd and an even axis."""
    x, w, b = _r((2, 3, size, size + 1), 0), _r((4, 3, k, k), 1), _r((4,), 2)
    out = _both(lambda x, w, b: jops.conv2d(x, w, b, (stride, stride), "SAME",
                                            (dil, dil)),
                lambda x, w, b: tops.conv2d(x, w, b, (stride, stride), "SAME",
                                            (dil, dil)), (x, w, b))
    assert out.shape[2:] == (-(-size // stride), -(-(size + 1) // stride))


DECONV = [(k, s, p) for k, s in ((2, 2), (3, 2), (3, 1), (4, 2), (1, 2),
                                  (5, 3))
          for p in ("SAME", (0, 0), (1, 1)) if p == "SAME" or p[0] < k]


@pytest.mark.parametrize("k,stride,padding", DECONV)
def test_deconv2d_matches_jax(k, stride, padding):
    size = 5                       # an odd height and an even width
    x, w, b = _r((2, 3, size, size - 1), 3), _r((3, 5, k, k), 4), _r((5,), 5)
    out = _both(lambda x, w, b: jops.deconv2d(x, w, b, (stride, stride),
                                              padding),
                lambda x, w, b: tops.deconv2d(x, w, b, (stride, stride),
                                              padding), (x, w, b))
    if padding == "SAME":
        assert out.shape[2:] == (size * stride, (size - 1) * stride)


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (1, (1, 1)), (2, (0, 0))])
def test_depthwise_and_separable_match_jax(mult, stride, padding):
    x = _r((2, 3, 7, 12), 6)       # an odd height and an even width
    dw, pw, b = _r((mult, 3, 3, 3), 7), _r((4, 3 * mult, 1, 1), 8), \
        _r((4,), 9)
    bd = _r((3 * mult,), 10)
    _both(lambda x, w, b: jops.depthwise_conv2d(x, w, b, (stride, stride),
                                                padding),
          lambda x, w, b: tops.depthwise_conv2d(x, w, b, (stride, stride),
                                                padding), (x, dw, bd))
    _both(lambda x, d, p, b: jops.sconv2d(x, d, p, b, (stride, stride),
                                          padding),
          lambda x, d, p, b: tops.sconv2d(x, d, p, b, (stride, stride),
                                          padding), (x, dw, pw, b))


def test_depthwise_channel_order_is_c_times_mult_plus_m():
    """Output channel ``c * mult + m`` is input channel c under w[m, c]."""
    x = _r((1, 3, 5, 5), 11)
    w = _r((2, 3, 3, 3), 12)
    out = tops.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                padding=(1, 1)).numpy()
    for c in range(3):
        for m in range(2):
            one = tops.conv2d(torch.from_numpy(x[:, c:c + 1]),
                              torch.from_numpy(w[m, c][None, None]),
                              padding=(1, 1)).numpy()
            _close(out[:, c * 2 + m:c * 2 + m + 1], one)


@pytest.mark.parametrize("kind", ["max", "avg", "pnorm"])
@pytest.mark.parametrize("size", [8, 75])
@pytest.mark.parametrize("k,stride,padding", [(3, 2, "SAME"), (2, 2, "SAME"),
                                              (3, 1, "SAME"), (3, 2, (1, 1))])
def test_pooling_matches_jax(kind, size, k, stride, padding):
    """Height ``size``, width ``size - 1`` (Xception's 75 x 74 at 299
    pixels has both)."""
    x = _r((2, 3, size, size - 1), 13)
    if kind == "max":
        jf, tf = jops.maxpool2d, tops.maxpool2d
    elif kind == "avg":
        jf, tf = jops.avgpool2d, tops.avgpool2d
    else:
        jf = lambda x, *a: jops.pnormpool2d(x, *a, pnorm=2)  # noqa: E731
        tf = lambda x, *a: tops.pnormpool2d(x, *a, pnorm=2)  # noqa: E731
    out = _both(lambda x: jf(x, (k, k), (stride, stride), padding),
                lambda x: tf(x, (k, k), (stride, stride), padding), (x,))
    if padding == "SAME":
        assert out.shape[2:] == (-(-size // stride), -(-(size - 1) // stride))


def test_pnorm_3_and_avg_divides_by_the_kernel_area():
    x = np.abs(_r((1, 2, 5, 5), 14)) + 0.1
    _both(lambda x: jops.pnormpool2d(x, (3, 3), (2, 2), "SAME", pnorm=3),
          lambda x: tops.pnormpool2d(x, (3, 3), (2, 2), "SAME", pnorm=3),
          (x,))
    ones = torch.ones(1, 1, 3, 3)
    got = tops.avgpool2d(ones, (2, 2), (2, 2), "SAME")
    # the corner window holds one real cell and three padded zeros
    assert got[0, 0, -1, -1].item() == 0.25


@pytest.mark.parametrize("n", [3, 5])
@pytest.mark.parametrize("channels", [4, 7])
def test_lrn_matches_jax(n, channels):
    x = _r((2, channels, 4, 5), 15)
    _both(lambda x: jops.lrn(x, depth=n, bias=2.0, alpha=1e-1, beta=0.75),
          lambda x: tops.lrn(x, depth=n, bias=2.0, alpha=1e-1, beta=0.75),
          (x,))


@pytest.mark.parametrize("block", [2, 3])
def test_space_to_depth_matches_jax(block):
    x = _r((2, 5, 6, 12), 16)
    _both(lambda x: jshape.space_to_depth(x, block, data_format="NCHW"),
          lambda x: tops.space_to_depth(x, block), (x,))


# --- layers -------------------------------------------------------------------

def _jax_shapes(layer):
    """The JAX layer's parameter shapes (no draw: ``jax.eval_shape``)."""
    if not layer.has_params:
        return {}
    out = jax.eval_shape(layer.init_params, jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in out.items()}


LAYERS = {
    "conv_same_s2": lambda L: L.ConvolutionLayer(
        n_out=4, kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    "conv_truncate": lambda L: L.ConvolutionLayer(
        n_out=4, kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)),
    "deconv_same": lambda L: L.Deconvolution2D(
        n_out=4, kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    "deconv_truncate": lambda L: L.Deconvolution2D(
        n_out=4, kernel_size=(2, 2), stride=(2, 2)),
    "depthwise": lambda L: L.DepthwiseConvolution2D(
        kernel_size=(3, 3), stride=(2, 2), depth_multiplier=2,
        convolution_mode="same"),
    "separable": lambda L: L.SeparableConvolution2D(
        n_out=5, kernel_size=(5, 5), stride=(2, 2), depth_multiplier=2,
        convolution_mode="same"),
    "avgpool_same": lambda L: L.SubsamplingLayer(
        pooling_type="avg", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"),
    "pnormpool": lambda L: L.SubsamplingLayer(
        pooling_type="pnorm", kernel_size=(2, 2), stride=(2, 2), pnorm=3),
    "maxpool_same": lambda L: L.SubsamplingLayer(
        kernel_size=(3, 3), stride=(1, 1), convolution_mode="same"),
    "lrn": lambda L: L.LocalResponseNormalization(),
    "space_to_depth": lambda L: L.SpaceToDepthLayer(block_size=2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax_and_its_output_type(name):
    size = 12 if name == "space_to_depth" else 11
    jl, tl = LAYERS[name](JL), LAYERS[name](TL)
    for layer in (jl, tl):
        layer.activation = "relu"
        layer.weight_init = "relu"
    jt = jl.set_input_type(JI.InputType.convolutional(size, size + 2, 3))
    tt = tl.set_input_type(TI.InputType.convolutional(size, size + 2, 3))
    assert (jt.channels, jt.height, jt.width) == \
        (tt.channels, tt.height, tt.width)
    params = {k: v.numpy() for k, v in
              tl.init_params(torch.Generator().manual_seed(0)).items()} \
        if tl.has_params else {}
    assert _jax_shapes(jl) == {k: v.shape for k, v in params.items()}
    rng = np.random.default_rng(2)
    params = {k: (v + rng.normal(size=v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()}
    names = sorted(params)
    x = _r((2, 3, size, size + 2), 17)

    def jfn(x, *ps):
        return jl.apply(dict(zip(names, ps)), x, {}, False, None)[0]

    def tfn(x, *ps):
        return tl.apply(dict(zip(names, ps)), x, {})[0]

    out = _both(jfn, tfn, (x,) + tuple(params[k] for k in names))
    assert out.shape[1:] == (tt.channels, tt.height, tt.width)


@pytest.mark.parametrize("layer", ["conv_same_s2", "avgpool_same",
                                   "maxpool_same", "batchnorm"])
def test_bf16_compute_matches_jax(layer):
    """Convolution, pooling and inference BatchNormalization in bf16 from
    the same bf16-rounded inputs."""
    x = _r((2, 3, 9, 10), 18)
    if layer == "batchnorm":
        jl, tl = JL.BatchNormalization(activation="relu"), \
            TL.BatchNormalization(activation="relu")
    else:
        jl, tl = LAYERS[layer](JL), LAYERS[layer](TL)
        jl.activation = tl.activation = "identity"
    jl.set_input_type(JI.InputType.convolutional(9, 10, 3))
    tl.set_input_type(TI.InputType.convolutional(9, 10, 3))
    rng = np.random.default_rng(3)
    params = {k: rng.normal(size=shape).astype(np.float32)
              for k, shape in _jax_shapes(jl).items()}
    state = {"mean": rng.normal(size=3).astype(np.float32),
             "var": rng.uniform(0.5, 2, 3).astype(np.float32)} \
        if layer == "batchnorm" else {}
    want, _ = jl.apply({k: jnp.asarray(v, jnp.bfloat16)
                        for k, v in params.items()},
                       jnp.asarray(x, jnp.bfloat16),
                       {k: jnp.asarray(v) for k, v in state.items()}, False,
                       None)
    got, _ = tl.apply({k: torch.from_numpy(v).bfloat16()
                       for k, v in params.items()},
                      torch.from_numpy(x).bfloat16(),
                      {k: torch.from_numpy(v) for k, v in state.items()})
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    _close(got.float().numpy(), want, tol=2.0 ** -7)


def test_batchnorm_train_bf16_matches_jax():
    """Training BatchNormalization in bf16: output and batch statistics."""
    x = _r((4, 6, 5, 5), 19) * 2 + 1
    g, b = _r((6,), 20), _r((6,), 21)
    piv = np.zeros(6, np.float32)
    jo, jm, jv = jops.batchnorm_train(jnp.asarray(x, jnp.bfloat16),
                                      jnp.asarray(g), jnp.asarray(b),
                                      pivot=jnp.asarray(piv))
    to, tm, tv = tops.batchnorm_train(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(g),
                                      torch.from_numpy(b),
                                      pivot=torch.from_numpy(piv))
    _close(tm.numpy(), jm)
    _close(tv.numpy(), jv)
    _close(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
           tol=2.0 ** -7)


# --- the loss heads -------------------------------------------------------------

def _head_both(jl, tl, params, x, labels):
    """Score and gradients (input and parameters) of a loss head."""
    names = sorted(params)

    def jscore(x, *ps):
        return jl.compute_score(dict(zip(names, ps)), x, jnp.asarray(labels))

    jout = jax.jit(jscore)(jnp.asarray(x),
                           *[jnp.asarray(params[k]) for k in names])
    jgrads = jax.jit(jax.grad(jscore, argnums=tuple(range(1 + len(names)))))(
        jnp.asarray(x), *[jnp.asarray(params[k]) for k in names])
    targs = [torch.from_numpy(a.copy()).requires_grad_(True)
             for a in [x] + [params[k] for k in names]]
    tout = tl.compute_score(dict(zip(names, targs[1:])), targs[0],
                            torch.from_numpy(labels))
    tout.backward()
    assert abs(tout.item() - float(jout)) <= TOL * abs(float(jout))
    for t, g in zip(targs, jgrads):
        _close(t.grad.numpy(), g)


def test_center_loss_score_and_gradients_match_jax():
    jl = JL.CenterLossOutputLayer(n_out=4, lambda_=0.7)
    tl = TL.CenterLossOutputLayer(n_out=4, lambda_=0.7)
    for layer, it in ((jl, JI), (tl, TI)):
        layer.activation = "softmax"
        layer.set_input_type(it.InputType.feed_forward(6))
    rng = np.random.default_rng(4)
    params = {"W": rng.normal(size=(6, 4)).astype(np.float32),
              "b": rng.normal(size=4).astype(np.float32),
              "centers": rng.normal(size=(4, 6)).astype(np.float32)}
    assert {k: tuple(v.shape) for k, v in tl.init_params(
        torch.Generator()).items()} == {k: v.shape for k, v in params.items()}
    x = rng.normal(size=(5, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[[0, 3, 1, 1, 2]]
    _head_both(jl, tl, params, x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_yolo2_score_and_gradients_match_jax(seed):
    """A 5x6 grid, 3 anchors, 2 classes: two objects in neighbouring cells,
    a third elsewhere, so anchors compete for overlapping boxes."""
    anchors = ((1.0, 1.5), (2.5, 2.0), (0.6, 0.6))
    jl, tl = JL.Yolo2OutputLayer(anchors=anchors), \
        TL.Yolo2OutputLayer(anchors=anchors)
    for layer, it in ((jl, JI), (tl, TI)):
        layer.set_input_type(it.InputType.convolutional(5, 6, 3 * 7))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 21, 5, 6)).astype(np.float32)
    lab = yolo_labels(rng, 2, 2, 5, objects=1)[:, :, :, :5]
    lab = np.concatenate([lab, np.zeros((2, 6, 5, 1), np.float32)], axis=3)
    lab[:, :, 2, 2] = 0.0
    lab[:, :, 2, 3] = 0.0
    lab[:, :4, 2, 2] = (1.9, 1.8, 3.4, 3.1)   # two overlapping boxes in
    lab[:, 4, 2, 2] = 1.0                     # neighbouring cells
    lab[:, :4, 2, 3] = (2.6, 1.7, 4.2, 3.4)
    lab[:, 5, 2, 3] = 1.0
    _head_both(jl, tl, {}, x, lab)
    y, _ = tl.apply({}, torch.from_numpy(x), {})
    assert torch.equal(y, torch.from_numpy(x))


def test_loss_layer_matches_jax():
    jl = JL.LossLayer(loss="mcxent", activation="softmax")
    tl = TL.LossLayer(loss="mcxent", activation="softmax")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 7)).astype(np.float32)
    y = np.eye(7, dtype=np.float32)[[1, 2, 3, 6]]
    _head_both(jl, tl, {}, x, y)
    assert not tl.has_params


def test_weight_init_fans_match_jax():
    """The fans of the transposed [I, O, kH, kW] and depthwise [mult, C,
    kH, kW] layouts: the standard deviation of a large draw is the JAX
    package's."""
    from deeplearning4j_tpu.nn import weights as jw
    from deeplearning4j_tpu_torch.nn import weights as tw

    for shape in ((16, 32, 3, 3), (2, 64, 3, 3), (64, 128)):
        assert tw._fans(shape) == jw._fans(shape)
    for shape, scheme in (((16, 32, 3, 3), "relu"),
                          ((2, 64, 3, 3), "xavier")):
        t = tw.init_weights(torch.Generator().manual_seed(0), shape,
                            scheme).numpy()
        j = np.asarray(jw.init_weights(jax.random.PRNGKey(0), shape, scheme))
        assert abs(t.std() / j.std() - 1) < 0.08, (shape, scheme)
