"""Gradient normalization in the port's training step against the JAX
package's, on the CPU.

The port applies ``GlobalConf.grad_normalization`` after the backward and
before the update (``nn/gradnorm.normalize_gradients_``), on the per-leaf
path to the gradients and on the fused path in place on the leaf views of
the flat gradient bucket, where the JAX graph applies ``_normalize_gradients``
(``deeplearning4j_tpu/nn/graph.py:781-786``).

Both graphs are built from one description (a small dense graph with
Nesterovs momentum), the parameters are carried across, and both take the
same batches.

Tolerances, and why: the losses of 3 steps and the parameters within rtol
1e-5 / atol 1e-6. Float32 sums run in another order in the two frameworks
(the matrix products, and the norms that set the clipping scale), so the
last bits differ and each step carries them on (measured: at most 2.4e-7
on the losses, 1.2e-7 on the parameters). The function alone is held to
JAX's within rtol 1e-6 (one norm, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import _normalize_gradients
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.gradnorm import MODES, normalize_gradients_
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as TGraph
from deeplearning4j_tpu_torch.util.convert import graph_state_from_numpy
from torch_parity import modules, numpy_tree

RTOL, ATOL = 1e-5, 1e-6
STEPS = 3
#: a threshold at which every mode clips these gradients, and one at which
#: none does
ACTIVE, INACTIVE = 0.05, 100.0


def _conf(which, mode, threshold, fused_update):
    m = modules(which)
    b = m.NeuralNetConfiguration.builder().seed(5).updater(
        m.Nesterovs(0.1, momentum=0.9))
    if mode:
        b = b.gradient_normalization(mode, threshold)
    if fused_update:
        b = b.fused_update()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("d1", m.L.DenseLayer(n_out=16, activation="tanh"), "in")
    gb.add_layer("d2", m.L.DenseLayer(n_out=12, activation="relu"), "d1")
    gb.add_layer("out", m.L.OutputLayer(n_out=4, activation="softmax",
                                        loss="mcxent"), "d2")
    gb.set_outputs("out")
    gb.set_input_types(m.InputType.feed_forward(10))
    return gb.build()


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(8, 10)).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)])
            for _ in range(STEPS)]


def _port_twin(jg, mode, threshold, fused_update):
    tg = TGraph(_conf("torch", mode, threshold, fused_update)).init(
        device="cpu")
    graph_state_from_numpy(tg, numpy_tree(jg._params), numpy_tree(jg._states))
    return tg


def _params(tg):
    return {n: {k: t.detach().numpy().copy() for k, t in d.items()}
            for n, d in tg._params.items()}


@pytest.mark.parametrize("fused_update", [False, True])
@pytest.mark.parametrize("threshold", [ACTIVE, INACTIVE])
@pytest.mark.parametrize("mode", MODES)
def test_fit_matches_jax(mode, threshold, fused_update):
    jg = JGraph(_conf("jax", mode, threshold, fused_update)).init()
    tg = _port_twin(jg, mode, threshold, fused_update)
    plain = _port_twin(jg, None, threshold, fused_update)
    OpProfiler.get().reset()
    jl, tl = [], []
    for x, y in _batches():
        jg.fit(JDataSet(x, y))
        jl.append(float(jg.score_value))
        tg.fit(DataSet(x, y))
        tl.append(tg.score_value)
        plain.fit(DataSet(x, y))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    got, unclipped = _params(tg), _params(plain)
    for n, d in numpy_tree(jg._params).items():
        for k, want in d.items():
            np.testing.assert_allclose(got[n][k], want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n}/{k}")
    # the fused path ran where asked (gradients normalized in the bucket)
    assert (tg._flat is not None) == fused_update
    assert OpProfiler.get().counter_value("precision/fused_hits") == \
        (2 * STEPS if fused_update else 0)
    # the threshold clipped (changed the training) or left the gradients
    # bit for bit as they were
    moved = max(float(np.abs(got[n][k] - unclipped[n][k]).max())
                for n, d in got.items() for k in d)
    if threshold == ACTIVE:
        assert moved > 1e-4, moved
    else:
        assert moved == 0.0


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"W": rng.normal(size=(5, 3)).astype(np.float32),
                  "b": rng.normal(scale=0.01, size=(3,)).astype(np.float32)},
            "b": {"W": rng.normal(scale=3.0, size=(4, 4)).astype(np.float32)}}


@pytest.mark.parametrize("threshold", [0.5, 1e3])
@pytest.mark.parametrize("mode", MODES + ("ClipL2PerGradient",))
def test_function_matches_jax(mode, threshold):
    tree = _grad_tree(3)
    want = _normalize_gradients(
        {n: {k: jnp.asarray(v) for k, v in d.items()}
         for n, d in tree.items()}, mode, threshold)
    got = {n: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
           for n, d in tree.items()}
    normalize_gradients_([got[n][k] for n in sorted(got)
                          for k in sorted(got[n])], mode, threshold)
    for n, d in want.items():
        for k, v in d.items():
            assert got[n][k].dtype == torch.float32
            np.testing.assert_allclose(got[n][k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=0)


def test_unknown_mode_raises_as_in_jax():
    tree = _grad_tree(4)
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        _normalize_gradients({n: {k: jnp.asarray(v) for k, v in d.items()}
                              for n, d in tree.items()}, "clipnone", 1.0)
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        normalize_gradients_([torch.ones(3)], "clipnone", 1.0)
    jg = JGraph(_conf("jax", None, 1.0, False)).init()
    tg = _port_twin(jg, "clipnone", 1.0, False)
    x, y = _batches()[0]
    with pytest.raises(ValueError, match="unknown gradient normalization"):
        tg.fit(DataSet(x, y))


def test_builder_sets_mode_and_threshold():
    conf = _conf("torch", "clipl2pergradient", 0.25, False)
    gc = conf.global_conf
    assert (gc.grad_normalization, gc.grad_norm_threshold) == \
        ("clipl2pergradient", 0.25)
    jgc = _conf("jax", "clipl2pergradient", 0.25, False).global_conf
    assert (jgc.grad_normalization, jgc.grad_norm_threshold) == \
        (gc.grad_normalization, gc.grad_norm_threshold)
    default = _conf("torch", None, 1.0, False).global_conf
    assert default.grad_normalization is None
    assert default.grad_norm_threshold == 1.0
