"""The port's ComputationGraph against the JAX package's, on the CPU.

Both graphs are built from one description (tests/torch_parity.py), the JAX
graph's weights are carried into the port with ``graph_state_from_numpy``,
and BN state is seeded with numpy, so the fold does real work. The JAX side
runs its fused epilogue in its CPU default (``xla``) mode; the port runs the
plain version of its kernel.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common.profiler import OpProfiler as JaxProfiler
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
from torch_parity import (enable_fused, modules, numpy_tree, residual_conf,
                          self_add_conf, twin_graphs)


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_out(g, x):
    return np.asarray(g.output(x)[0])


class TestResidualGraph:
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("channels", [128, 48])
    def test_port_matches_jax(self, fused, channels):
        """channels=128: both fuse; channels=48: the JAX gate refuses and
        replays the dense chain, the port fuses (any C)."""
        jg, tg = twin_graphs(residual_conf("jax", fused, channels),
                             residual_conf("torch", fused, channels))
        x = _x((2, 4, 8, 8))
        got = tg.output(x)[0].numpy()
        assert np.allclose(got, _jax_out(jg, x), rtol=1e-5, atol=1e-5)
        prof = OpProfiler.get()
        assert prof.counter_value("precision/epilogue_residual_hits") == \
            (1 if fused else 0)
        assert prof.counter_value("precision/epilogue_fallbacks") == 0

    def test_fused_vs_dense_on_port(self):
        _, dense = twin_graphs(residual_conf("jax", False),
                               residual_conf("torch", False))
        fused = TGraph(residual_conf("torch", True)).init(device="cpu")
        graph_state_from_numpy(
            fused, numpy_tree({n: {k: v.numpy() for k, v in d.items()}
                               for n, d in dense._params.items()}),
            numpy_tree({n: {k: v.numpy() for k, v in d.items()}
                        for n, d in dense._states.items()}))
        x = _x((3, 4, 8, 8))
        assert np.allclose(fused.output(x)[0].numpy(),
                           dense.output(x)[0].numpy(), rtol=1e-5, atol=1e-5)


class TestFusionPlan:
    def _plans(self, conf_fn, mutate=None):
        jg = JGraph(conf_fn("jax")).init()
        tg = TGraph(conf_fn("torch")).init(device="cpu")
        if mutate is not None:
            mutate(jg)
            mutate(tg)
        return jg._epilogue_fusion_plan(), tg._epilogue_fusion_plan()

    def test_residual_chain(self):
        pj, pt = self._plans(lambda w: residual_conf(w, True))
        assert pt == pj == {"bn": {"bn3"}, "add": {"add": ("bn3", "scbn")},
                            "act": {"relu": ("bn3", "add")}}

    def test_knob_off(self):
        pj, pt = self._plans(lambda w: residual_conf(w, False))
        assert pj is None and pt is None

    def test_per_layer_opt_out(self):
        def opt_out_bn3(g):
            g.conf.nodes["bn3"].layer.fused_epilogue = False

        pj, pt = self._plans(lambda w: residual_conf(w, True), opt_out_bn3)
        assert pt == pj and pt["bn"] == {"scbn"}

        def opt_out_both(g):
            opt_out_bn3(g)
            g.conf.nodes["scbn"].layer.fused_epilogue = False

        pj, pt = self._plans(lambda w: residual_conf(w, True), opt_out_both)
        assert pj is None and pt is None

    def test_self_add_left_dense(self):
        pj, pt = self._plans(self_add_conf)
        assert pj is None and pt is None
        tg = TGraph(self_add_conf("torch")).init(device="cpu")
        out = tg.output(_x((2, 3, 4, 4)))[0]
        assert torch.isfinite(out).all()

    def test_resnet50_plan(self):
        def fuse(g):
            enable_fused(g, "jax" if isinstance(g, JGraph) else "torch")

        pj, pt = self._plans(
            lambda w: modules(w).zoo.ResNet50(num_classes=10,
                                              image_size=32).init().conf
            if w == "jax" else
            modules(w).zoo.ResNet50(num_classes=10, image_size=32).conf(),
            fuse)
        assert pt == pj
        assert len(pt["act"]) == 16


class TestResNet50:
    def _twins(self):
        jz, tz = modules("jax").zoo, modules("torch").zoo
        jconf = jz.ResNet50(num_classes=10, image_size=32).init().conf
        tconf = tz.ResNet50(num_classes=10, image_size=32).conf()
        jg, tg = twin_graphs(jconf, tconf,
                             calibrate_x=_x((64, 3, 32, 32), seed=11),
                             head_scale=0.1)
        enable_fused(jg, "jax")
        enable_fused(tg, "torch")
        return jg, tg

    def test_port_matches_jax_fused(self):
        """Full-depth ResNet-50 at 32x32, 10 classes, batch 2, float32,
        fused epilogue on in both: rtol 1e-4 / atol 1e-5 on the softmax
        (the JAX side fuses 46 BNs and runs 7 dense, the port fuses 53)."""
        jg, tg = self._twins()
        x = _x((2, 3, 32, 32))
        JaxProfiler.get().reset()
        want = _jax_out(jg, x)
        got = tg.output(x)[0].numpy()
        assert got.shape == want.shape == (2, 10)
        assert np.allclose(got, want, rtol=1e-4, atol=1e-5)
        # not saturated: the comparison sees real probabilities
        assert want.max() < 0.999
        # traced once: the JAX package counts its 46 launches at trace time
        assert JaxProfiler.get().counter_value(
            "precision/epilogue_hits") == 46
        assert JaxProfiler.get().counter_value(
            "precision/epilogue_fallbacks") == 7

    def test_53_epilogue_launches_per_forward(self):
        _, tg = self._twins()
        prof = OpProfiler.get()
        prof.reset()
        tg.output(_x((2, 3, 32, 32)))
        assert prof.counter_value("precision/epilogue_hits") == 53
        assert prof.counter_value("precision/epilogue_residual_hits") == 16
        assert prof.counter_value("precision/epilogue_fallbacks") == 0
        tg.output(_x((1, 3, 32, 32)))
        assert prof.counter_value("precision/epilogue_hits") == 106

    def test_bf16_compute(self):
        _, tg = self._twins()
        x = _x((2, 3, 32, 32))
        f32 = tg.output(x)[0]
        tg.conf.global_conf.compute_dtype = "bfloat16"
        bf16 = tg.output(x)[0]
        assert bf16.dtype == torch.bfloat16 and bf16.shape == f32.shape
        assert torch.isfinite(bf16.float()).all()
        assert torch.allclose(bf16.float().sum(1), torch.ones(2), atol=1e-2)
        # the parameters stay float32; the cast copies are cached
        assert all(t.dtype == torch.float32 for p in tg._params.values()
                   for t in p.values())
        assert tg._cast_cache is not None


class TestCarryOver:
    def test_mismatch_raises(self):
        jg = JGraph(residual_conf("jax", True)).init()
        tg = TGraph(residual_conf("torch", True)).init(device="cpu")
        params, states = numpy_tree(jg._params), numpy_tree(jg._states)
        bad = {n: dict(d) for n, d in params.items()}
        bad["c1"]["W"] = bad["c1"]["W"][:, :, :2]
        with pytest.raises(ValueError, match="shape"):
            graph_state_from_numpy(tg, bad, states)
        bad = {n: dict(d) for n, d in params.items()}
        bad["c1"]["W"] = bad["c1"]["W"].astype(np.float64)
        with pytest.raises(ValueError, match="dtype"):
            graph_state_from_numpy(tg, bad, states)
        bad = dict(params)
        bad["nope"] = bad.pop("c1")
        with pytest.raises(ValueError, match="node names"):
            graph_state_from_numpy(tg, bad, states)
        bad = {n: dict(d) for n, d in params.items()}
        bad["bn3"]["delta"] = bad["bn3"].pop("beta")
        with pytest.raises(ValueError, match="entries"):
            graph_state_from_numpy(tg, bad, states)

    def test_copy_is_exact(self):
        jg = JGraph(residual_conf("jax", True)).init()
        tg = TGraph(residual_conf("torch", True)).init(device="cpu")
        params = numpy_tree(jg._params)
        graph_state_from_numpy(tg, params, numpy_tree(jg._states))
        for n, d in params.items():
            for k, v in d.items():
                assert np.array_equal(tg._params[n][k].numpy(), v)
