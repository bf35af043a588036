"""Transfer learning in the port against the JAX package, on the CPU:
``FrozenLayer``, ``TransferLearning``, ``FineTuneConfiguration``,
``TransferLearningHelper`` and the zoo's pretrained-weights cache.

The same builder calls run in both packages on a narrow VGG-shaped
network (``torch_parity.vgg_conf`` at small widths) with the same
parameters; layers the builder re-initializes take the JAX network's
draws. Dropout on the frozen dense layers acts in ``fit`` in both (the
JAX ``FrozenLayer`` passes ``training`` through), with one injected mask
per shape (``torch_parity.inject_draws``). Tolerances: parameters and
updater state within 1e-5 of each leaf's scale after three steps; frozen
parameters bitwise unchanged, under Nesterovs, Adam and AdamW (whose
decoupled decay moves an element whose gradient is zero), on the fused
and the per-leaf path.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.util.convert import multilayer_state_from_numpy
from torch_parity import (assert_scaled_close, assert_trees_close,
                          flat_items, inject_draws, mln_twins, modules,
                          numpy_tree, vgg_conf)

SMALL = {"blocks": ((2, 4), (2, 8), (3, 8), (3, 16), (3, 16)),
         "dense": 32, "classes": 10, "image": 32}
FC2 = 19           # VGG16's layers: 13 convolutions + 5 pools, fc1, fc2, out


def _updater(kind):
    return {"nesterovs": lambda m: m.Nesterovs(learning_rate=1e-2,
                                               momentum=0.9),
            "adam": lambda m: m.Adam(1e-2),
            "adamw": lambda m: __import__(
                m.L.__name__.split(".")[0] + ".learning.updaters",
                fromlist=["AdamW"]).AdamW(learning_rate=1e-2,
                                          weight_decay=0.1)}[kind]


def _head(m, n_out=5):
    return m.L.OutputLayer(n_out=n_out, weight_init="xavier",
                           activation="softmax", loss="mcxent")


# builder calls, each applied to both packages' builders
def _edit_last(m, b):
    return (b.set_feature_extractor(FC2).remove_output_layer()
            .add_layer(_head(m)))


def _n_out_replace(m, b):
    return b.set_feature_extractor(17).n_out_replace(FC2, 24)


def _remove_two(m, b):
    return (b.set_feature_extractor(18).remove_layers_from_output(2)
            .add_layer(m.L.DenseLayer(n_out=24, activation="tanh"))
            .addLayer(_head(m)))


EDITS = {"edit_last": (_edit_last, {20}), "n_out_replace": (_n_out_replace,
                                                            {19, 20}),
         "remove_two": (_remove_two, {19, 20})}


def _transfer(which, src, edit, updater, fused):
    m = modules(which)
    tl = __import__(m.L.__name__.split(".")[0] + ".nn.transfer",
                    fromlist=["x"])
    ft = (tl.FineTuneConfiguration.builder().updater(updater(m))
          .seed(12345).build())
    net = edit(m, tl.TransferLearning.builder(src)
               .fine_tune_configuration(ft)).build()
    net.conf.global_conf.fused_update = fused
    return net


def _twins(edit, updater, fused):
    jsrc, tsrc = mln_twins(vgg_conf("jax", SMALL), vgg_conf("torch", SMALL))
    jn = _transfer("jax", jsrc, edit, updater, fused)
    tn = _transfer("torch", tsrc, edit, updater, fused)
    return jsrc, tsrc, jn, tn


def _batch(seed, n=4, classes=5):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3, 32, 32), dtype=np.float32),
            np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)])


def _masks(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.random((n, 16)) < 0.5, rng.random((n, 32)) < 0.5]


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_builder_carries_weights_and_reinfers_n_in(edit):
    fn, reinit = EDITS[edit]
    jsrc, tsrc, jn, tn = _twins(fn, _updater("nesterovs"), False)
    assert [type(l).__name__ for l in tn.layers] \
        == [type(l).__name__ for l in jn.layers]
    assert [getattr(l, "n_in", None) for l in tn.layers] \
        == [getattr(l, "n_in", None) for l in jn.layers]
    assert tn.num_params() == jn.num_params()
    assert tn.conf.global_conf.seed == 12345
    for i, key in enumerate(tn._keys):
        if i in reinit:
            continue
        want = dict(flat_items(numpy_tree(tsrc._params[tsrc._keys[i]])))
        for path, t in flat_items(tn._params[key]):
            np.testing.assert_array_equal(t.numpy(), want[path])
            # copies: the source's tensors are not shared
            assert t.data_ptr() != dict(flat_items(
                tsrc._params[tsrc._keys[i]]))[path].data_ptr()
    frozen = [i for i, l in enumerate(tn.layers)
              if type(l).__name__ == "FrozenLayer"]
    assert frozen == [i for i, l in enumerate(jn.layers)
                      if type(l).__name__ == "FrozenLayer"]


def test_builder_refuses_a_shape_mismatch_and_a_frozen_reinit():
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearning

    _, src = mln_twins(vgg_conf("jax", SMALL), vgg_conf("torch", SMALL))
    with pytest.raises(ValueError, match="both frozen"):
        (TransferLearning.builder(src).set_feature_extractor(FC2)
         .n_out_replace(FC2, 8).build())
    b = TransferLearning.builder(src)
    b._src.layers[FC2].n_out = 31          # the source's conf disagrees
    with pytest.raises(ValueError, match="shape mismatch"):
        b.build()


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("kind", ["nesterovs", "adam", "adamw"])
@pytest.mark.parametrize("edit", sorted(EDITS))
def test_fit_matches_jax_and_keeps_frozen_params(monkeypatch, edit, kind,
                                                 fused):
    fn, reinit = EDITS[edit]
    _, _, jn, tn = _twins(fn, _updater(kind), fused)
    # the re-initialized layers take the JAX network's draws
    multilayer_state_from_numpy(tn, [numpy_tree(d) for d in jn._params],
                                [numpy_tree(d) for d in jn._states])
    frozen = [k for k, l in zip(tn._keys, tn.layers)
              if type(l).__name__ == "FrozenLayer"]
    before = {k: {p: t.clone() for p, t in flat_items(tn._params[k])}
              for k in frozen}
    inject_draws(monkeypatch, masks=_masks(1))
    for step in range(3):
        x, y = _batch(step, classes=tn.layers[-1].n_out)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        assert abs(tn.score_value - jn.score_value) \
            <= 1e-5 * abs(jn.score_value)
    assert_trees_close(tn, jn)
    for k in frozen:
        for p, t in flat_items(tn._params[k]):
            assert torch.equal(t, before[k][p]), (k, p)
    # the updater state, frozen elements included, as the JAX step's
    jstate = numpy_tree({s: {tn._keys[i]: d for i, d in enumerate(v)}
                         for s, v in jn._updater_state.items()})
    from deeplearning4j_tpu_torch.util.model_serializer import (
        dense_updater_state)
    tstate = dense_updater_state(tn)
    for slot, tree in jstate.items():
        for path, want in flat_items(tree):
            got = dict(flat_items(tstate[slot]))[path]
            assert_scaled_close(got, want, f"{slot} {path}")
            if path[0] in frozen:
                assert not want.any() and not got.any(), (slot, path)


def test_frozen_dropout_acts_in_fit(monkeypatch):
    """A frozen dense layer's dropout draws a mask in ``fit`` and none in
    ``output``, as the JAX FrozenLayer (not DL4J's, ROADMAP §C)."""
    from deeplearning4j_tpu_torch.ops import nn as tops

    _, _, _, tn = _twins(_edit_last, _updater("nesterovs"), False)
    shapes = []
    draw = tops.dropout_mask
    monkeypatch.setattr(tops, "dropout_mask", lambda shape, *a: (
        shapes.append(tuple(shape)), draw(shape, *a))[1])
    x, y = _batch(0)
    tn.output(x)
    assert shapes == []
    tn.fit(DataSet(x, y))
    assert shapes == [(4, 16), (4, 32)]


def _bn_conf(which, frozen, l2=0.0):
    m = modules(which)
    bn = m.L.BatchNormalization(activation="relu")
    return (m.NeuralNetConfiguration.builder().seed(3).l2(l2)
            .updater(m.Sgd(0.1)).list()
            # no bias before the BN: its gradient is zero up to rounding
            .layer(m.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                        activation="identity",
                                        has_bias=False))
            .layer(m.L.FrozenLayer(layer=bn) if frozen else bn)
            .layer(m.L.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.convolutional(6, 6, 2)).build())


def test_frozen_batchnorm_normalizes_with_batch_statistics_in_fit():
    jn, tn = mln_twins(_bn_conf("jax", True), _bn_conf("torch", True))
    assert [type(l).__name__ for l in tn.layers][1] == "FrozenLayer"
    gamma = tn._params["0001"]["gamma"].clone()
    for step in range(3):
        x, y = _batch(step)
        x = x[:, :2, :6, :6].copy()
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert_trees_close(tn, jn)
    assert torch.equal(tn._params["0001"]["gamma"], gamma)
    for k in ("mean", "var"):
        assert_scaled_close(tn._states["0001"][k],
                            np.asarray(jn._states[1][k]), k)
    assert not torch.equal(tn._states["0001"]["mean"],
                           torch.zeros_like(gamma))


def test_frozen_layers_take_no_regularization():
    x, y = _batch(0)
    x = x[:, :2, :6, :6].copy()
    jn, tn = mln_twins(_bn_conf("jax", True, l2=0.5),
                       _bn_conf("torch", True, l2=0.5))
    frozen = tn.score(DataSet(x, y))
    assert abs(frozen - jn.score(JDataSet(x, y))) <= 1e-5 * abs(frozen)
    _, plain = mln_twins(_bn_conf("jax", False, l2=0.5),
                         _bn_conf("torch", False, l2=0.5))
    plain.set_params(tn.params())
    gamma = tn._params["0001"]["gamma"]
    assert abs(plain.score(DataSet(x, y)) - frozen
               - 0.25 * float((gamma * gamma).sum())) <= 1e-5 * frozen


def test_helper_featurizes_and_fits_the_top_like_jax():
    from deeplearning4j_tpu.nn.transfer import (
        TransferLearningHelper as JHelper)
    from deeplearning4j_tpu_torch.nn.transfer import TransferLearningHelper

    _, _, jn, tn = _twins(_remove_two, _updater("adam"), False)
    multilayer_state_from_numpy(tn, [numpy_tree(d) for d in jn._params],
                                [numpy_tree(d) for d in jn._states])
    jh, th = JHelper(jn), TransferLearningHelper(tn)
    assert th.frozen_until == jh.frozen_until == 18
    x, y = _batch(5, n=6)
    jf, tf = jh.featurize(JDataSet(x, y)), th.featurize(DataSet(x, y))
    assert_scaled_close(tf.features, np.asarray(jf.features.value),
                        "features")
    jh.fit_featurized(jf, epochs=3)
    th.fit_featurized(tf, epochs=3)
    assert_trees_close(tn, jn, what="after fit_featurized")
    top = th.unfrozen_mln()
    assert len(top.layers) == 2 and top is th.unfrozen_mln()
    full = tn.output(x)
    assert_scaled_close(top.output(tf.features), full.numpy(),
                        "top over features")
    assert_scaled_close(full, np.asarray(jn.output(x).value), "output")
    with pytest.raises(ValueError, match="FrozenLayer"):
        TransferLearningHelper(mln_twins(vgg_conf("jax", SMALL),
                                         vgg_conf("torch", SMALL))[1])


def test_frozen_layer_configuration_round_trips_between_packages(tmp_path):
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    _, _, jn, tn = _twins(_edit_last, _updater("nesterovs"), False)
    tn.save(str(tmp_path / "t.zip"))
    jn.save(str(tmp_path / "j.zip"))
    jback = JNet.load(str(tmp_path / "t.zip"))
    tback = MultiLayerNetwork.load(str(tmp_path / "j.zip"), device="cpu")
    assert type(jback.layers[0]).__name__ == "FrozenLayer"
    assert type(tback.layers[FC2]).__name__ == "FrozenLayer"
    np.testing.assert_array_equal(np.asarray(jback.params().value),
                                  tn.params().numpy())
    np.testing.assert_array_equal(tback.params().numpy(),
                                  np.asarray(jn.params().value))


def test_init_pretrained_reads_the_local_cache(monkeypatch, tmp_path):
    from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
    from deeplearning4j_tpu_torch.models import LeNet, PretrainedType

    monkeypatch.setenv("DL4J_TPU_PRETRAINED_DIR", str(tmp_path))
    zoo = LeNet()
    assert zoo.pretrained_cache_dir() == str(tmp_path)
    assert not zoo.pretrained_available(PretrainedType.MNIST)
    with pytest.raises(RuntimeError, match="LeNet_mnist.zip"):
        zoo.init_pretrained(PretrainedType.MNIST, device="cpu")
    net = zoo.init(device="cpu")
    net.save(zoo.pretrained_path(PretrainedType.MNIST))
    assert zoo.pretrained_path("mnist") == str(tmp_path / "LeNet_mnist.zip")
    back = zoo.initPretrained(PretrainedType.MNIST, device="cpu")
    assert torch.equal(back.params(), net.params())
    jback = JLeNet().init_pretrained(PretrainedType.MNIST)
    np.testing.assert_array_equal(np.asarray(jback.params().value),
                                  net.params().numpy())
    monkeypatch.delenv("DL4J_TPU_PRETRAINED_DIR")
    assert zoo.pretrained_cache_dir().endswith(
        "/.deeplearning4j_tpu/pretrained")
