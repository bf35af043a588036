"""The port's MultiLayerNetwork against the JAX package's, on the CPU.

Both networks are built from one description (``torch_parity.lenet_conf``:
bench.py's LeNet letter for letter; ``vgg_conf``: zoo VGG16's structure),
the JAX network's parameters are carried across
(``multilayer_state_from_numpy``), and both take the same float32 batches
made with numpy from a seed. Dropout is off in every parity test (threefry
draws cannot be matched; tests/test_torch_dropout.py injects masks).

Tolerances, and why:
- per-step losses within 1e-5 relative, parameters within rtol 1e-5 / atol
  1e-6 after the steps: float32 sums run in another order in the two
  frameworks (LeNet shows about 1e-7);
- probabilities within 1e-6 absolute; evaluation (accuracy, confusion
  matrix) equal;
- the port's own paths against each other (fused against per-leaf, the
  padded step against the unpadded masked step, K steps per dispatch
  against 1) bitwise or within 4 float32 ulp where a sum changes order.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import (
    NDArrayDataSetIterator as JNDIter)
from deeplearning4j_tpu.nn.conf.builder import (
    MultiLayerConfiguration as JMLC)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.models import LeNet, VGG16
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration as TMLC)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
from deeplearning4j_tpu_torch.util.convert import multilayer_state_from_numpy
from torch_parity import (VGG16_WIDTHS, conf_param_count, lenet_conf,
                          masked_conf, mln_twins, vgg_conf)

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
VGG_SMALL = {"blocks": ((2, 4), (2, 8), (3, 8), (3, 16), (3, 16)),
             "dense": 32, "classes": 10, "image": 32}


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


def _mnist_like(n, seed=0, classes=10, shape=(1, 28, 28)):
    rng = np.random.default_rng(seed)
    x = rng.random((n,) + shape, dtype=np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n)]
    return x, y


def _jparams(jn):
    return np.asarray(jn.params().value)


def _ulp_close(a, b, ulps=4):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.maximum(np.abs(a), np.abs(b))
    return bool(np.all(np.abs(a - b) <= ulps * np.spacing(scale)))


# --- LeNet against the JAX network ---------------------------------------------

def test_lenet_five_steps_match_jax():
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    assert jn.num_params() == tn.num_params() == 431_080
    for step in range(5):
        x, y = _mnist_like(16, seed=step)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        want = jn.score_value
        assert abs(tn.score_value - want) <= LOSS_RTOL * abs(want), step
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


def test_output_score_and_evaluate_match_jax():
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    x, y = _mnist_like(48, seed=3)
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x).value), rtol=0,
                               atol=1e-6)
    want = jn.score(JDataSet(x, y))
    assert abs(tn.score(DataSet(x, y)) - want) <= LOSS_RTOL * abs(want)
    jev = jn.evaluate(JNDIter(x, y, batch_size=16))
    tev = tn.evaluate(NDArrayDataSetIterator(x, y, batch_size=16))
    assert tev.count == jev.count == 48
    assert tev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(tev.confusion, jev.confusion)
    assert tev.stats() == jev.stats()


def test_feed_forward_and_gradients_match_jax():
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    x, y = _mnist_like(8, seed=4)
    jacts, tacts = jn.feed_forward(x), tn.feed_forward(x)
    assert len(jacts) == len(tacts) == 7
    for j, t in zip(jacts, tacts):
        np.testing.assert_allclose(t.numpy(), np.asarray(j.value), rtol=1e-5,
                                   atol=1e-6)
    jg, js = jn.compute_gradient_and_score(JDataSet(x, y))
    tg, ts = tn.compute_gradient_and_score(DataSet(x, y))
    assert abs(ts - js) <= LOSS_RTOL * abs(js)
    assert len(tg) == len(jg) == 6
    for jd, td in zip(jg, tg):
        assert sorted(jd) == sorted(td)
        for k in jd:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]),
                                       rtol=1e-4, atol=1e-6)


def test_params_round_trip_against_jax_vector():
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    vec = _jparams(jn)
    np.testing.assert_array_equal(tn.params().numpy(), vec)
    other = LeNet(seed=5).init(device="cpu")
    assert not np.array_equal(other.params().numpy(), vec)
    other.set_params(vec)
    np.testing.assert_array_equal(other.params().numpy(), vec)
    x, _ = _mnist_like(4, seed=6)
    np.testing.assert_array_equal(other.output(x).numpy(),
                                  tn.output(x).numpy())
    # and back: the port's vector loads into the JAX network
    jn.set_params(tn.params().numpy() * 0.5)
    np.testing.assert_array_equal(_jparams(jn), tn.params().numpy() * 0.5)
    with pytest.raises(ValueError, match="length"):
        other.set_params(vec[:-1])
    assert other.param_table(4)["W"].shape == (800, 500)
    assert "Total params: 431080" in other.summary()


def test_updater_state_carries_across():
    """Both carry-over routes: parameters and momentum from a JAX network
    that took a step, then both take the same two steps."""
    jn = JNet(lenet_conf("jax")).init(0)
    x, y = _mnist_like(16, seed=7)
    jn.fit(JDataSet(x, y))
    tn = MultiLayerNetwork(lenet_conf("torch")).init(device="cpu")
    upd = jax.tree.map(np.asarray, jn._updater_state)
    multilayer_state_from_numpy(
        tn, [{k: np.asarray(v) for k, v in d.items()} for d in jn._params],
        [{} for _ in jn._params], updater_state=upd)
    np.testing.assert_array_equal(tn._updater_state["v"]["0004"]["W"],
                                  upd["v"][4]["W"])
    for step in range(2):
        x, y = _mnist_like(16, seed=8 + step)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        want = jn.score_value
        assert abs(tn.score_value - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("case", ["l1_l2", "gradnorm", "labels_mask"])
def test_regularization_gradnorm_and_labels_mask_match_jax(case):
    kw = {"l1_l2": {"l1": 1e-4, "l2": 1e-3},
          "gradnorm": {"grad_norm": ("ClipL2PerParamType", 0.5)},
          "labels_mask": {}}[case]
    jn, tn = mln_twins(lenet_conf("jax", **kw), lenet_conf("torch", **kw))
    for step in range(3):
        x, y = _mnist_like(16, seed=20 + step)
        m = None
        if case == "labels_mask":
            m = (np.arange(16) % 3 != 0).astype(np.float32)
        jn.fit(JDataSet(x, y, labels_mask=m))
        tn.fit(DataSet(x, y, labels_mask=m))
        want = jn.score_value
        assert abs(tn.score_value - want) <= LOSS_RTOL * abs(want), step
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


# --- the port's own paths --------------------------------------------------------

@pytest.mark.parametrize("source", ["dataset", "iterator"])
def test_fused_update_matches_per_leaf(source):
    """The fused flat-bucket step (one kernel launch per step on the card;
    its plain version here) against the per-leaf updater: bitwise."""
    x, y = _mnist_like(40, seed=9)
    nets = []
    for fused in (True, False):
        net = LeNet().init(device="cpu")
        net.conf.global_conf.fused_update = fused
        if source == "dataset":
            for i in range(3):
                net.fit(DataSet(x[16 * i:16 * i + 16], y[16 * i:16 * i + 16]))
        else:
            net.fit(NDArrayDataSetIterator(x, y, batch_size=16))
        nets.append(net)
    fused, plain = nets
    counters = OpProfiler.get().get_counters()
    assert counters["precision/fused_buckets_plain"] == 3
    assert counters.get("precision/fused_fallbacks", 0) == 0
    assert fused._flat is not None and plain._flat is None
    np.testing.assert_array_equal(fused.params().numpy(),
                                  plain.params().numpy())
    assert fused.score_value == plain.score_value


def test_padded_fit_matches_jax_padded_fit():
    """An iterator of 40 at batch 16: the last batch of 8 is padded by
    wrapping rows with example weight 0, in both packages."""
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    x, y = _mnist_like(40, seed=10)
    jn.fit(JNDIter(x, y, batch_size=16))
    tn.fit(NDArrayDataSetIterator(x, y, batch_size=16))
    assert tn._iteration == jn._iteration == 3
    assert OpProfiler.get().counter_value("pipeline/padded_batches") == 1
    want = jn.score_value
    assert abs(tn.score_value - want) <= LOSS_RTOL * abs(want)
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


def test_padded_step_matches_unpadded_masked_step():
    """The port's padded step (8 real rows wrapped to 16, weights 0 on the
    copies) against its unpadded step on the 8 rows: within 4 f32 ulp."""
    x, y = _mnist_like(8, seed=11)
    padded, plain = LeNet().init(device="cpu"), LeNet().init(device="cpu")
    padded.fit(DataSet(x, y), batch_size=16)      # the pipeline pads
    plain.fit(DataSet(x, y))                       # the unpadded step
    assert OpProfiler.get().counter_value("pipeline/padded_batches") == 1
    assert _ulp_close(padded.score_value, plain.score_value)
    assert _ulp_close(padded.params().numpy(), plain.params().numpy())
    dropped = LeNet().init(device="cpu")
    dropped.fit(DataSet(x, y), batch_size=16, drop_remainder=True)
    assert dropped._iteration == 0


def test_padded_epochs_match_the_unpadded_weighted_run():
    """The JAX package's own check (tests/test_input_pipeline.py, 22
    examples at batch 8, 3 epochs), padded against ``pad_partial=False``:
    the JAX test asks for equal bits and fails on this tree by 1.2e-10;
    here within 4 float32 ulp of the parameters' scale (the convolution's
    weight gradient sums 8 rows where the unpadded step sums 6, in another
    blocking)."""
    x, y = _mnist_like(22, seed=15)
    a, b = LeNet().init(device="cpu"), LeNet().init(device="cpu")
    a.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=3)
    b.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=3,
          pad_partial=False)
    assert a._iteration == b._iteration == 9
    pa, pb = a.params().numpy(), b.params().numpy()
    bound = 4 * np.spacing(np.abs(pb).max())
    assert np.abs(pa - pb).max() <= bound


def test_steps_per_dispatch_matches_one():
    x, y = _mnist_like(80, seed=12)
    runs = []
    for k in (2, 1):
        net = LeNet().init(device="cpu")
        scores = CollectScoresIterationListener()
        net.set_listeners(scores)
        net.fit(NDArrayDataSetIterator(x, y, batch_size=16), epochs=2,
                steps_per_dispatch=k)
        runs.append((net, scores.scores))
    (a, sa), (b, sb) = runs
    assert a._iteration == b._iteration == 10 and a._epoch == b._epoch == 2
    assert sa == sb and [i for i, _ in sa] == list(range(1, 11))
    np.testing.assert_array_equal(a.params().numpy(), b.params().numpy())


def test_vgg_shaped_network_matches_jax():
    """Zoo VGG16's structure at 32x32 with narrow channels (dropout off):
    output, and the losses and parameters of 2 steps."""
    jn, tn = mln_twins(vgg_conf("jax", VGG_SMALL, dropout=0.0),
                       vgg_conf("torch", VGG_SMALL, dropout=0.0))
    x, y = _mnist_like(8, seed=13, shape=(3, 32, 32))
    np.testing.assert_allclose(tn.output(x).numpy(),
                               np.asarray(jn.output(x).value), rtol=0,
                               atol=1e-6)
    for step in range(2):
        x, y = _mnist_like(8, seed=14 + step, shape=(3, 32, 32))
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        want = jn.score_value
        assert abs(tn.score_value - want) <= LOSS_RTOL * abs(want), step
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


def test_vgg16_channel_widths_on_unit_normal_images_match_jax(monkeypatch):
    """Zoo VGG16's channel and dense widths (64..512 channels, 4096, 1000
    classes) at 64x64 images, batch 8, N(0, 1) pixels, dropout 0.5 with
    one injected mask per layer: the first loss lies far above ln(1000)
    in both packages alike (He init keeps the activations' second moment,
    each max-pool raises it, each inverted dropout doubles it), and the
    second step's loss too. The losses are printed (``-s``)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu_torch.ops import nn as tops

    image, batch = 64, 8
    rng = np.random.default_rng(7)
    masks = {(batch, n): rng.random((batch, n)) >= 0.5
             for n in (512 * (image // 32) ** 2, 4096)}
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape:
                        jnp.asarray(masks[tuple(shape)]))
    monkeypatch.setattr(tops, "dropout_mask",
                        lambda shape, rate, generator, device:
                        torch.from_numpy(masks[tuple(shape)]).to(device))
    jn, tn = mln_twins(vgg_conf("jax", {"image": image}),
                       vgg_conf("torch", {"image": image}))
    x = rng.normal(size=(batch, 3, image, image)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
    losses = []
    for _ in range(2):
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        losses.append((jn.score_value, tn.score_value))
    print(f"VGG16 widths, {image}x{image}, batch {batch}, N(0, 1): "
          f"(jax, port) losses {losses}")
    (j0, t0), (j1, t1) = losses
    assert abs(t0 - j0) <= LOSS_RTOL * abs(j0)
    assert j0 > 3 * np.log(1000)
    assert abs(t1 - j1) <= LOSS_RTOL * max(abs(j1), 1.0)


def test_full_width_vgg16_parameter_count_without_allocating():
    jconf, tconf = vgg_conf("jax"), VGG16().conf()
    assert conf_param_count(jconf) == conf_param_count(tconf) == 138_357_544
    shapes = [jax.eval_shape(layer.init_params, jax.random.PRNGKey(0))
              for layer in jconf.layers if layer.has_params]
    assert sum(int(np.prod(s.shape)) for d in shapes
               for s in d.values()) == 138_357_544
    assert len(tconf.layers) == 21 and tconf.preprocessors[18].out_type.size \
        == VGG16_WIDTHS["blocks"][-1][1] * 7 * 7


# --- configuration -------------------------------------------------------------

def _json(conf):
    return json.loads(conf.to_json())


@pytest.mark.parametrize("which", ["lenet", "vgg", "masked"])
def test_list_configuration_json_in_the_jax_format(which):
    make = {"lenet": lenet_conf, "vgg": lambda m: vgg_conf(m, VGG_SMALL),
            "masked": masked_conf}[which]
    jconf, tconf = make("jax"), make("torch")
    jd, td = _json(jconf), _json(tconf)
    assert td == jd
    # each package reads the other's
    back = TMLC.from_json(jconf.to_json())
    assert _json(back) == td
    assert back.layer_output_types == tconf.layer_output_types
    assert _json(JMLC.from_json(tconf.to_json())) == _json(jconf)


def test_zoo_models_are_the_jax_configurations():
    assert _json(LeNet().conf()) == _json(lenet_conf("jax"))
    jd, td = _json(vgg_conf("jax")), _json(VGG16().conf())
    assert td == jd
    assert LeNet().init(device="cpu").num_params() == 431_080


def test_preprocessors_and_flat_input():
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType

    conf = (NeuralNetConfiguration.builder().list()
            .layer(L.ConvolutionLayer(n_out=2, kernel_size=(3, 3)))
            .layer(L.OutputLayer(n_out=3))
            .set_input_type(InputType.convolutional_flat(5, 5, 1)).build())
    assert conf.preprocessors[0].name == "CnnFlatToCnn"
    assert conf.preprocessors[1].name == "CnnToFeedForward"
    net = MultiLayerNetwork(conf).init(device="cpu")
    x = np.arange(50, dtype=np.float32).reshape(2, 25)
    out = net.output(x)
    assert out.shape == (2, 3)
    # NCHW flatten order: the dense input is conv[:, c, h, w] raveled
    acts = net.feed_forward(x)
    np.testing.assert_array_equal(acts[1].reshape(2, -1).numpy(),
                                  acts[1].numpy().reshape(2, -1))
    rnn = (NeuralNetConfiguration.builder().list()
           .layer(L.DenseLayer(n_out=4))
           .layer(L.OutputLayer(n_out=2))
           .set_input_type(InputType.recurrent(3, 5)).build())
    assert rnn.preprocessors[0].name == "RnnToFeedForward"


def test_unported_paths_raise():
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)

    net = LeNet().init(device="cpu")
    x, y = _mnist_like(4)
    # fit(host_prefetch=) is ported: the same step as without it
    twin = LeNet().init(device="cpu")
    net.fit(DataSet(x, y), host_prefetch=2)
    twin.fit(DataSet(x, y))
    assert torch.equal(net.params(), twin.params())
    # rematerialization and pretraining are ported: an unknown policy is
    # refused, and pretraining a network without a pretrainable layer
    # leaves it as it was
    with pytest.raises(ValueError, match="remat"):
        net.set_remat_policy("everything")
    before = net.params().clone()
    net.pretrain(DataSet(x, y))
    assert torch.equal(net.params(), before)
    with pytest.raises(ValueError, match="tbptt"):
        (NeuralNetConfiguration.builder().list()
         .layer(L.OutputLayer(n_out=2)).backprop_type("TruncatedBPTT")
         .tbptt_fwd_length(4).tbptt_back_length(2).build())


def test_constraints_apply_after_each_update():
    from deeplearning4j_tpu.nn.conf.layers_ext import (
        MaxNormConstraint as JMax)
    from deeplearning4j_tpu_torch.nn.conf.layers import MaxNormConstraint

    jconf, tconf = lenet_conf("jax"), lenet_conf("torch")
    jconf.layers[4].constraints = [JMax(0.05, axis=0)]
    tconf.layers[4].constraints = [MaxNormConstraint(0.05, axis=0)]
    jn, tn = mln_twins(jconf, tconf)
    x, y = _mnist_like(16, seed=30)
    jn.fit(JDataSet(x, y))
    tn.fit(DataSet(x, y))
    w = tn.param_table(4)["W"].detach()
    assert float(torch.linalg.vector_norm(w, dim=0).max()) <= 0.05 * (1 + 1e-6)
    np.testing.assert_allclose(tn.params().numpy(), _jparams(jn), rtol=RTOL,
                               atol=ATOL)


def test_clone_copies_parameters_and_fused_updates_launch_nothing_here():
    net = LeNet().init(device="cpu")
    net.conf.global_conf.fused_update = True
    x, y = _mnist_like(16, seed=31)
    net.fit(DataSet(x, y))
    twin = net.clone()
    np.testing.assert_array_equal(twin.params().numpy(),
                                  net.params().numpy())
    net.fit(DataSet(x, y))
    assert not np.array_equal(twin.params().numpy(), net.params().numpy())
    assert tupdate.fused_update_launches == 0   # the CPU runs the plain one
    # set_params keeps the fused bucket's views
    store = net._flat
    net.set_params(twin.params())
    assert net._flat_store() is store
    np.testing.assert_array_equal(store.params["flat::float32"][:431_080]
                                  .numpy(), twin.params().numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_a_step_drops_the_inference_cast_cache(fused):
    """The fused kernel on the card writes the parameters without bumping
    their versions, so every step drops the bf16 copies that ``output``
    cached (the card-side check: tests/test_torch_kernel_cuda.py)."""
    net = LeNet().init(device="cpu")
    net.conf.global_conf.compute_dtype = "bfloat16"
    net.conf.global_conf.fused_update = fused
    x, y = _mnist_like(8, seed=41)
    before = net.output(x).float()
    assert net._cast_cache is not None
    net.fit(DataSet(x, y))
    assert net._cast_cache is None
    after = net.output(x).float()
    assert not torch.equal(after, before)
    net._cast_cache = None
    assert torch.equal(after, net.output(x).float())


def test_listeners_hear_every_step():
    from deeplearning4j_tpu_torch.optimize import (EvaluativeListener,
                                                   PerformanceListener,
                                                   ScoreIterationListener,
                                                   TimeIterationListener)

    x, y = _mnist_like(40, seed=32)
    net = LeNet().init(device="cpu")
    perf = PerformanceListener(frequency=1)
    ev = EvaluativeListener(DataSet(x[:8], y[:8]), frequency=2)
    scores = CollectScoresIterationListener()
    net.set_listeners(perf, ev, scores, ScoreIterationListener(1),
                      TimeIterationListener(3, frequency=1))
    net.fit(NDArrayDataSetIterator(x, y, batch_size=16))
    assert [i for i, _ in scores.scores] == [1, 2, 3]
    assert scores.scores[-1][1] == net.score_value
    # samples/s from the bound (padded) batch size
    assert net._last_batch_size == 16
    assert perf.last_samples_per_sec == pytest.approx(
        16 * perf.last_iterations_per_sec)
    assert [i for i, _ in ev.history] == [2]
    assert 0.0 <= ev.history[0][1] <= 1.0
    evr = net.evaluate_regression(DataSet(x[:4], y[:4]))
    assert evr.n == 4 and evr.mean_squared_error(0) >= 0.0
