"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Both packages are built from one description: ``modules("jax")`` and
``modules("torch")`` name the same modules in ``deeplearning4j_tpu`` and
``deeplearning4j_tpu_torch``. Inputs and state are made with numpy from a
seed and carried across as numpy arrays.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

PACKAGES = {"jax": "deeplearning4j_tpu", "torch": "deeplearning4j_tpu_torch"}


def modules(which: str) -> SimpleNamespace:
    root = PACKAGES[which]
    imp = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return SimpleNamespace(
        L=imp("nn.conf.layers"),
        NeuralNetConfiguration=imp("nn.conf.builder").NeuralNetConfiguration,
        InputType=imp("nn.conf.inputs").InputType,
        graph=imp("nn.graph"),
        Sgd=imp("learning.updaters").Sgd,
        Nesterovs=imp("learning.updaters").Nesterovs,
        Adam=imp("learning.updaters").Adam,
        MultiLayerNetwork=imp("nn.multilayer").MultiLayerNetwork,
        zoo=imp("models.zoo"))


def residual_conf(which: str, fused: bool, channels: int = 128, seed: int = 3,
                  updater=None, l2: float = 0.0, fused_update: bool = False):
    """The residual graph of tests/test_precision.py::residual_graph.
    ``updater(m)`` makes the updater from the package's modules ``m``
    (default ``Sgd(0.01)``); ``l2`` cascades onto every layer."""
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(seed).updater(
        updater(m) if updater is not None else m.Sgd(0.01)).l2(l2)
    if fused:
        b = b.fused_epilogue()
    if fused_update:
        b = b.fused_update()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("c1", m.L.ConvolutionLayer(
        n_out=channels, kernel_size=(3, 3), padding=(1, 1), has_bias=False,
        activation="identity"), "in")
    gb.add_layer("bn3", m.L.BatchNormalization(activation="identity"), "c1")
    gb.add_layer("sc", m.L.ConvolutionLayer(
        n_out=channels, kernel_size=(1, 1), has_bias=False,
        activation="identity"), "in")
    gb.add_layer("scbn", m.L.BatchNormalization(activation="identity"), "sc")
    gb.add_vertex("add", m.graph.ElementWiseVertex(op="add"), "bn3", "scbn")
    gb.add_layer("relu", m.L.ActivationLayer(activation="relu"), "add")
    gb.add_layer("out", m.L.OutputLayer(n_out=5, activation="softmax",
                                        loss="mcxent"), "relu")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.convolutional(8, 8, 4))
    return gb.build()


def self_add_conf(which: str):
    """relu(bn(x) + bn(x)) (tests/test_precision.py:691-713)."""
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(3).updater(m.Sgd(0.01))
    b = b.fused_epilogue()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("c1", m.L.ConvolutionLayer(
        n_out=128, kernel_size=(1, 1), has_bias=False,
        activation="identity"), "in")
    gb.add_layer("bn3", m.L.BatchNormalization(activation="identity"), "c1")
    gb.add_vertex("add", m.graph.ElementWiseVertex(op="add"), "bn3", "bn3")
    gb.add_layer("relu", m.L.ActivationLayer(activation="relu"), "add")
    gb.add_layer("out", m.L.OutputLayer(n_out=5, activation="softmax",
                                        loss="mcxent"), "relu")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.convolutional(4, 4, 3))
    return gb.build()


def enable_fused(graph, which: str) -> None:
    """Post-build enablement as tests/test_precision.py:735-740 does it:
    the global knob AND the cascade onto the BN layers."""
    L = modules(which).L
    graph.conf.global_conf.fused_epilogue = True
    for name in graph.conf.order:
        node = graph.conf.nodes[name]
        if node.kind == "layer" and isinstance(node.layer,
                                               L.BatchNormalization):
            node.layer.fused_epilogue = True


def assert_scaled_close(got, want, what: str, tol: float = 1e-5) -> None:
    """``got`` (a tensor or array) within ``tol`` of the largest magnitude
    of ``want``, element by element, with ``want``'s shape and dtype."""
    if hasattr(got, "detach"):
        got = got.detach().cpu().numpy()
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} of the scale {scale}"


def numpy_tree(tree):
    """A (nested) dict of arrays as numpy arrays."""
    return {k: (numpy_tree(v) if isinstance(v, dict) else np.asarray(v))
            for k, v in tree.items()}


def randomize_bn(params, states, seed: int = 7, stats=None):
    """Seeded BN state and affine params (numpy trees, modified in place):
    gamma ~ N(1, 0.1), beta ~ N(0, 0.1); without ``stats``, mean ~ N(0, 0.1)
    and var ~ U(0.5, 2). With ``stats`` (per-node mean/var calibrated on a
    batch, with these gamma/beta in place), the draws perturb them gently
    instead, mean += N(0, 0.05)·std and var *= U(0.8, 1.25), so the
    activations of a deep net stay of order one."""
    rng = np.random.default_rng(seed)
    for name in sorted(states):
        st = states[name]
        if "mean" not in st:
            continue
        c = st["mean"].shape[0]
        p = params[name]
        if "gamma" in p and stats is None:
            p["gamma"] = rng.normal(1.0, 0.1, c).astype(np.float32)
            p["beta"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        if stats is None:
            st["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
        else:
            mean0, var0 = stats[name]["mean"], stats[name]["var"]
            st["mean"] = (mean0 + rng.normal(0.0, 0.05, c)
                          * np.sqrt(var0)).astype(np.float32)
            st["var"] = (var0 * rng.uniform(0.8, 1.25, c)).astype(np.float32)


def install_jax(graph, params, states) -> None:
    import jax.numpy as jnp

    graph._params = {n: {k: jnp.asarray(v) for k, v in d.items()}
                     for n, d in params.items()}
    graph._states = {n: {k: jnp.asarray(v) for k, v in d.items()}
                     for n, d in states.items()}
    graph._infer_fn = None


def twin_graphs(jax_conf, torch_conf, seed: int = 7, calibrate_x=None,
                head_scale: float = 1.0):
    """The JAX graph and its port twin with identical (carried) weights and
    seeded BN state. With ``calibrate_x`` the BN statistics are then set
    from that batch (the port's calibrate_batchnorm) and perturbed.
    ``head_scale`` multiplies the output layer's W: a deep net with random
    weights amplifies float32 rounding about a thousandfold by its logits
    (measured on ResNet-50 at 32x32: 5e-5 of the logit scale between two
    correct implementations), and a smaller head keeps the softmax off
    saturation and that noise inside the probabilities' tolerance."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm
    from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy

    jg = JGraph(jax_conf).init()
    tg = TGraph(torch_conf).init(device="cpu")
    params, states = numpy_tree(jg._params), numpy_tree(jg._states)
    if head_scale != 1.0:
        head = jax_conf.network_outputs[0]
        params[head]["W"] = (params[head]["W"] * head_scale).astype(
            params[head]["W"].dtype)
    graph_state_from_numpy(tg, params, states)
    randomize_bn(params, states, seed)
    graph_state_from_numpy(tg, params, states)
    if calibrate_x is not None:
        stats = numpy_tree({n: {k: v.numpy() for k, v in d.items()}
                            for n, d in calibrate_batchnorm(
                                tg, calibrate_x).items()})
        randomize_bn(params, states, seed + 1, stats)
        graph_state_from_numpy(tg, params, states)
    install_jax(jg, params, states)
    return jg, tg


def f32_ulp_bound(ref: np.ndarray) -> float:
    """2 float32 ulp of the output scale (FMA contraction allowance; the
    bound tests/test_precision.py::test_cross_mode_ulp_bound uses)."""
    return 2.0 ** -22 * (float(np.max(np.abs(ref))) + 1.0)


def encoder_conf(which: str, vocab: int = 100, positions: int = 128,
                 seq_len: int = 128, hidden: int = 32, layers: int = 2,
                 heads: int = 4, ff: int = 64, classes: int = 2,
                 eps: float = 1e-12, compute_dtype=None, seed: int = 11,
                 updater=None):
    """A BERT-shaped self-attention encoder as a DL4J user builds it with
    the graph builder (chip_smoke.py's ``encoder_conf`` at full width):
    token and position embeddings added and layer-normed, ``layers`` blocks
    of self-attention + residual + LayerNorm and a GELU (erf) feed-forward
    pair of TimeDistributed dense layers + residual + LayerNorm, an average
    pool over time and a softmax head. Inputs ``tokens`` and ``positions``,
    integer ``[B, seq_len]``. ``updater(m)`` makes the updater from the
    package's modules ``m`` (default the builder's)."""
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(seed).data_type("float32")
    if updater is not None:
        b = b.updater(updater(m))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("tokens", "positions")
    gb.add_layer("tok_emb", m.L.EmbeddingSequenceLayer(n_out=hidden),
                 "tokens")
    gb.add_layer("pos_emb", m.L.EmbeddingSequenceLayer(n_out=hidden),
                 "positions")
    gb.add_vertex("emb", m.graph.ElementWiseVertex(op="add"), "tok_emb",
                  "pos_emb")
    gb.add_layer("emb_ln", m.L.LayerNormalization(eps=eps), "emb")
    prev = "emb_ln"
    for i in range(layers):
        p = f"l{i}_"
        gb.add_layer(p + "attn", m.L.SelfAttentionLayer(
            n_out=hidden, n_heads=heads, project_input=True), prev)
        gb.add_vertex(p + "res1", m.graph.ElementWiseVertex(op="add"), prev,
                      p + "attn")
        gb.add_layer(p + "ln1", m.L.LayerNormalization(eps=eps), p + "res1")
        gb.add_layer(p + "ff1", m.L.TimeDistributed(layer=m.L.DenseLayer(
            n_out=ff, activation="gelu_exact")), p + "ln1")
        gb.add_layer(p + "ff2", m.L.TimeDistributed(layer=m.L.DenseLayer(
            n_out=hidden, activation="identity")), p + "ff1")
        gb.add_vertex(p + "res2", m.graph.ElementWiseVertex(op="add"),
                      p + "ln1", p + "ff2")
        gb.add_layer(p + "ln2", m.L.LayerNormalization(eps=eps), p + "res2")
        prev = p + "ln2"
    gb.add_layer("pool", m.L.GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", m.L.OutputLayer(n_out=classes, activation="softmax",
                                        loss="mcxent"), "pool")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.recurrent(vocab, seq_len),
                       m.InputType.recurrent(positions, seq_len))
    return gb.build()


def lenet_conf(which: str, fused_update: bool = False, l1: float = 0.0,
               l2: float = 0.0, grad_norm=None, seed: int = 123):
    """bench.py's ``_lenet_model`` configuration (bench.py:239-261),
    letter for letter, with the switches the tests turn: ``fused_update``,
    l1/l2 and a gradient normalization ``(mode, threshold)``."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(seed)
         .updater(m.Nesterovs(learning_rate=0.01, momentum=0.9))
         .activation("relu").weight_init("xavier").l1(l1).l2(l2))
    if fused_update:
        b = b.fused_update()
    if grad_norm is not None:
        b = b.gradient_normalization(*grad_norm)
    return (b.list()
            .layer(m.L.ConvolutionLayer(n_out=20, kernel_size=(5, 5)))
            .layer(m.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(m.L.ConvolutionLayer(n_out=50, kernel_size=(5, 5)))
            .layer(m.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(m.L.DenseLayer(n_out=500))
            .layer(m.L.OutputLayer(n_out=10, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.convolutional(28, 28, 1))
            .build())


#: zoo VGG16's widths (models/zoo.py:172-198 of the JAX package)
VGG16_WIDTHS = {"blocks": ((2, 64), (2, 128), (3, 256), (3, 512),
                           (3, 512)),
                "dense": 4096, "classes": 1000, "image": 224}


def vgg_conf(which: str, widths=None, dropout: float = 0.5,
             compute_dtype=None):
    """Zoo VGG16's configuration at ``widths`` (``blocks`` of (convs,
    channels), ``dense``, ``classes``, ``image``; VGG16_WIDTHS by
    default). ``dropout`` is the two dense layers' input dropout."""
    w = dict(VGG16_WIDTHS, **(widths or {}))
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(123)
         .updater(m.Nesterovs(learning_rate=1e-2, momentum=0.9))
         .activation("relu").weight_init("relu"))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    lb = b.list()
    for n_convs, ch in w["blocks"]:
        for _ in range(n_convs):
            lb = lb.layer(m.L.ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                               padding=(1, 1)))
        lb = lb.layer(m.L.SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)))
    return (lb.layer(m.L.DenseLayer(n_out=w["dense"], dropout=dropout))
            .layer(m.L.DenseLayer(n_out=w["dense"], dropout=dropout))
            .layer(m.L.OutputLayer(n_out=w["classes"]))
            .set_input_type(m.InputType.convolutional(w["image"], w["image"],
                                                      3))
            .build())


#: zoo AlexNet's widths (models/zoo.py:141-169 of the JAX package)
ALEXNET_WIDTHS = {"convs": (96, 256, 384, 384, 256), "dense": 4096,
                  "classes": 1000}


def alexnet_conf(which: str, widths=None):
    """Zoo AlexNet's configuration (227x227x3, single tower, LRN after the
    first two convolutions) at ``widths`` (the five convolutions' channels,
    ``dense``, ``classes``; ALEXNET_WIDTHS by default)."""
    w = dict(ALEXNET_WIDTHS, **(widths or {}))
    c1, c2, c3, c4, c5 = w["convs"]
    m = modules(which)
    L = m.L
    return (m.NeuralNetConfiguration.builder().seed(123)
            .updater(m.Nesterovs(learning_rate=1e-2, momentum=0.9))
            .activation("relu").weight_init("relu")
            .list()
            .layer(L.ConvolutionLayer(n_out=c1, kernel_size=(11, 11),
                                      stride=(4, 4)))
            .layer(L.LocalResponseNormalization())
            .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=c2, kernel_size=(5, 5),
                                      padding=(2, 2)))
            .layer(L.LocalResponseNormalization())
            .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=c3, kernel_size=(3, 3),
                                      padding=(1, 1)))
            .layer(L.ConvolutionLayer(n_out=c4, kernel_size=(3, 3),
                                      padding=(1, 1)))
            .layer(L.ConvolutionLayer(n_out=c5, kernel_size=(3, 3),
                                      padding=(1, 1)))
            .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
            .layer(L.DenseLayer(n_out=w["dense"], dropout=0.5))
            .layer(L.DenseLayer(n_out=w["dense"], dropout=0.5))
            .layer(L.OutputLayer(n_out=w["classes"]))
            .set_input_type(m.InputType.convolutional(227, 227, 3))
            .build())


def yolo_labels(rng, batch: int, classes: int, grid: int,
                objects: int = 2) -> np.ndarray:
    """YOLOv2 labels in the reference format, ``[batch, 4 + classes, grid,
    grid]``: ``objects`` distinct cells per image, each holding the corners
    (x1, y1, x2, y2, grid units) of a box centred in that cell with sides
    in [0.5, 3], and a one-hot class; the other cells hold zeros."""
    lab = np.zeros((batch, 4 + classes, grid, grid), np.float32)
    for b in range(batch):
        for cell in rng.choice(grid * grid, size=objects, replace=False):
            gy, gx = divmod(int(cell), grid)
            cx, cy = gx + rng.uniform(0.1, 0.9), gy + rng.uniform(0.1, 0.9)
            w, h = rng.uniform(0.5, 3.0, 2)
            lab[b, :4, gy, gx] = (cx - w / 2, cy - h / 2, cx + w / 2,
                                  cy + h / 2)
            lab[b, 4 + rng.integers(0, classes), gy, gx] = 1.0
    return lab


def masked_conf(which: str, width: int = 32, heads: int = 4,
                vocab: int = 50, seq_len: int = 16, classes: int = 2,
                compute_dtype=None, updater=None):
    """The masked sequence path of chip_smoke.py at ``width``: token
    embedding → self-attention → LayerNorm → self-attention → average
    pool over time → softmax head, trained and served with a ``[B, T]``
    feature mask. The depth is chip_smoke's, not a published model's.
    ``updater(m)`` makes the updater (default Nesterovs(0.1, 0.9): its step
    is proportional to the gradient, where Adam divides a tiny gradient by
    its own root mean square and so turns float32 rounding of a 1e-8
    gradient into a difference of up to its learning rate)."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(7)
         .updater(updater(m) if updater is not None
                  else m.Nesterovs(0.1, momentum=0.9)))
    if compute_dtype:
        b = b.compute_dtype(compute_dtype)
    return (b.list()
            .layer(m.L.EmbeddingSequenceLayer(n_out=width))
            .layer(m.L.SelfAttentionLayer(n_out=width, n_heads=heads))
            .layer(m.L.LayerNormalization())
            .layer(m.L.SelfAttentionLayer(n_out=width, n_heads=heads))
            .layer(m.L.GlobalPoolingLayer(pooling_type="avg"))
            .layer(m.L.OutputLayer(n_out=classes, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.recurrent(vocab, seq_len))
            .build())


def mln_twins(jax_conf, torch_conf, seed: int = 0):
    """The JAX MultiLayerNetwork and its port twin (on the CPU) with the
    JAX network's parameters and states carried across."""
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import (
        MultiLayerNetwork as TNet)
    from deeplearning4j_tpu_torch.util.convert import (
        multilayer_state_from_numpy)

    jn = JNet(jax_conf).init(seed)
    tn = TNet(torch_conf).init(device="cpu")
    multilayer_state_from_numpy(tn, [numpy_tree(d) for d in jn._params],
                                [numpy_tree(d) for d in jn._states])
    return jn, tn


def conf_param_count(conf) -> int:
    """Parameters of a Conv/Dense/Output stack, read off the layer shapes
    (no allocation), for either package's configuration."""
    n = 0
    for layer in conf.layers:
        kind = type(layer).__name__
        if kind == "ConvolutionLayer":
            kh, kw = layer.kernel_size
            n += layer.n_out * layer.n_in * kh * kw
        elif kind in ("DenseLayer", "OutputLayer"):
            n += layer.n_in * layer.n_out
        else:
            continue
        n += layer.n_out if layer.has_bias else 0
    return n


def jax_block_bits(seed: int, blk_id: int, shape) -> np.ndarray:
    """The uint32 bits (as int32) the JAX package's host block draws for
    its negatives: ``jax.random.bits`` under ``PRNGKey(seed)`` folded with
    the block id."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(seed), blk_id)
    return np.array(jax.random.bits(key, tuple(shape), jnp.uint32)).view(
        np.int32)


def inject_jax_bits(model) -> None:
    """Have the port's host blocks of ``model`` draw the JAX block's bits
    (``SequenceVectors._host_bits``)."""
    import torch

    model._host_bits = lambda shape, blk_id, gen: torch.from_numpy(
        jax_block_bits(model.seed, blk_id, shape))


def record_host_blocks(jax_model, torch_model):
    """Record the columns of every host block both models train, as numpy
    (the port's uint16 ids carried as int16 widened back): returns the two
    lists, filled as the models fit."""
    import torch

    from deeplearning4j_tpu_torch.nlp.word2vec import _widen

    jcols, tcols = [], []
    real_make = jax_model._make_block

    def make(hs_dev=None, ntable_dev=None):
        blk = real_make(hs_dev, ntable_dev)

        def rec(syn0, syn1, cols, key, blk_id):
            jcols.append([np.asarray(c) for c in cols])
            return blk(syn0, syn1, cols, key, blk_id)
        return rec

    jax_model._make_block = make
    real_block = torch_model._host_block

    def trec(syn0, syn1, cols, bits):
        tcols.append([(_widen(c) if c.dtype == torch.int16 else c)
                      .numpy().copy() for c in cols])
        return real_block(syn0, syn1, cols, bits)

    torch_model._host_block = trec
    return jcols, tcols


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Module-scoped autouse fixture (import it into a test module): PyTorch's
    intra-op threads set to 1 for the module's tests and restored after. The NLP
    parity tests run thousands of small eager operations; with several
    test workers on one host, each worker's thread pool spinning on every
    core makes them tens of times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# --- the layers of the fifteenth slice: one layer, both packages -------------

def inject_draws(monkeypatch, masks=(), normals=()):
    """JAX's ``bernoulli`` and ``normal`` return the given numpy arrays by
    shape, and so do the port's ``ops.nn.dropout_mask`` and
    ``ops.nn.normal``: one draw per shape, shared by both packages."""
    import jax
    import jax.numpy as jnp
    import torch

    from deeplearning4j_tpu_torch.ops import nn as tops

    keep = {tuple(m.shape): m for m in masks}
    gauss = {tuple(n.shape): n for n in normals}
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep[tuple(shape)]))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(
                            gauss[tuple(shape)], dtype))
    monkeypatch.setattr(tops, "dropout_mask",
                        lambda shape, rate, generator, device:
                        torch.from_numpy(keep[tuple(shape)]).to(device))
    monkeypatch.setattr(tops, "normal",
                        lambda shape, generator, dtype, device:
                        torch.from_numpy(gauss[tuple(shape)]).to(
                            device=device, dtype=dtype))


def input_array(t, batch: int, rng) -> np.ndarray:
    """A seeded float32 batch of either package's input type ``t``."""
    kind = type(t).__name__
    shape = {"FFInput": lambda: (t.size,),
             "RNNInput": lambda: (t.timesteps, t.size),
             "CNNInput": lambda: (t.channels, t.height, t.width),
             "CNN3DInput": lambda: (t.channels, t.depth, t.height,
                                    t.width)}[kind]()
    return rng.normal(size=(batch,) + shape).astype(np.float32)


def seeded_params(layer, seed: int, scale: float = 0.5):
    """The JAX layer's parameter tree (numpy), every leaf replaced by
    seeded normals times ``scale`` (so zero-initialized slopes, gains and
    biases take part in the comparison)."""
    import jax

    if not layer.has_params:
        return {}
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: (fill(v) if isinstance(v, dict) else
                    (rng.normal(size=np.shape(v)) * scale).astype(np.float32))
                for k, v in tree.items()}

    return fill(numpy_tree(layer.init_params(jax.random.PRNGKey(0))))


def to_jax(tree):
    import jax.numpy as jnp

    return {k: (to_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def to_torch(tree, requires_grad: bool = False):
    import torch

    return {k: (to_torch(v, requires_grad) if isinstance(v, dict) else
                torch.tensor(v, requires_grad=requires_grad))
            for k, v in tree.items()}


def flat_items(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def layer_parity(make, in_type, batch: int = 3, seed: int = 0,
                 training: bool = False, tol: float = 1e-5):
    """One layer built by ``make(m)`` on ``in_type(m)`` in both packages,
    the same seeded parameters and input: the forward and the gradients of
    ``sum(y * r)`` (``r`` seeded) with respect to every parameter and the
    input, each within ``tol`` of its largest magnitude. Returns the two
    output types."""
    import jax
    import jax.numpy as jnp
    import torch

    mj, mt = modules("jax"), modules("torch")
    jl, tl = make(mj), make(mt)
    jt, tt = jl.set_input_type(in_type(mj)), tl.set_input_type(in_type(mt))
    assert type(jt).__name__ == type(tt).__name__ \
        and jt.__dict__ == tt.__dict__, (jt, tt)
    rng = np.random.default_rng(seed)
    x = input_array(in_type(mj), batch, rng)
    params = seeded_params(jl, seed + 1)
    state = numpy_tree(jl.init_state())

    def jfwd(p, xx):
        return jl.apply(p, xx, to_jax(state), training,
                        jax.random.PRNGKey(1))[0]

    want, vjp = jax.vjp(jfwd, to_jax(params), jnp.asarray(x))
    tp = to_torch(params, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    got, _ = tl.apply(tp, tx, to_torch(state), training,
                      generator=torch.Generator().manual_seed(0))
    assert_scaled_close(got, np.asarray(want), "forward", tol)
    r = rng.normal(size=np.shape(want)).astype(np.float32)
    jg_p, jg_x = vjp(jnp.asarray(r))
    leaves = [t for _, t in flat_items(tp)]
    grads = torch.autograd.grad((got * torch.from_numpy(r)).sum(),
                                leaves + [tx], allow_unused=True)
    for (path, t), g, (_, jg) in zip(flat_items(tp), grads,
                                     flat_items(numpy_tree(jg_p))):
        # a parameter outside the forward takes a zero gradient in JAX
        g = torch.zeros_like(t) if g is None else g
        assert_scaled_close(g, np.asarray(jg), f"d{'/'.join(path)}", tol)
    assert_scaled_close(grads[-1], np.asarray(jg_x), "dx", tol)
    return jt, tt


def head_for(m, out_type, n_classes: int = 3):
    """The loss head a network with this output type ends in."""
    if type(out_type).__name__ == "RNNInput":
        return m.L.RnnOutputLayer(n_out=n_classes, activation="softmax",
                                  loss="mcxent")
    return m.L.OutputLayer(n_out=n_classes, activation="softmax",
                           loss="mcxent")


def labels_for(out_type, batch: int, rng, n_classes: int = 3):
    if type(out_type).__name__ == "RNNInput":
        return np.eye(n_classes, dtype=np.float32)[
            rng.integers(0, n_classes, (batch, out_type.timesteps))]
    return np.eye(n_classes, dtype=np.float32)[
        rng.integers(0, n_classes, batch)]


def stack_conf(which: str, make_layers, in_type, out_type, updater=None,
               seed: int = 5, fused_update: bool = False, policy=None,
               l2: float = 0.0):
    """A MultiLayerNetwork configuration: the layers ``make_layers(m)``,
    then the loss head for ``out_type``, on ``in_type(m)``."""
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(seed).updater(
        updater(m) if updater is not None else m.Sgd(0.1)).l2(l2)
    if fused_update:
        b = b.fused_update()
    if policy is not None:
        b = b.remat_policy(policy)
    lb = b.list()
    for layer in make_layers(m):
        lb = lb.layer(layer)
    return (lb.layer(head_for(m, out_type))
            .set_input_type(in_type(m)).build())


def assert_trees_close(tn, jn, tol: float = 1e-5, what: str = "") -> None:
    """Every parameter of the port network ``tn`` within ``tol`` of its
    leaf's largest magnitude in the JAX network ``jn``."""
    for i, key in enumerate(tn._keys):
        want = dict(flat_items(numpy_tree(jn._params[i])))
        got = dict(flat_items(tn._params[key]))
        assert set(want) == set(got), (i, set(want), set(got))
        for path, w in want.items():
            assert_scaled_close(got[path], w, f"{what} layer {i} "
                                f"{'/'.join(path)}", tol)
