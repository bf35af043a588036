"""The ``Environment`` switches of the port against the JAX package's, on
the CPU: NAN_PANIC (``set_check_nan``) on the dispatcher's operations, in a
backward pass, on an inference worker's, a serving dispatcher's and a
prefetch producer's thread, and through a LeNet fit;
``allow_pallas``; the factories' default dtype.

Under NAN_PANIC both packages raise ``FloatingPointError`` at the first
operation that makes a NaN (JAX through ``jax_debug_nans``, the port
through ``common/nan_panic.py``); turned off, the same calls flow and return
the NaN. Every test turns the flag off again in a ``finally``. The card's
counterparts (the four kernels' checks) are in
``tests/test_torch_kernel_cuda.py``; chip_smoke's environment phase runs
them all on the card.

Tolerances: the dense attention route against the JAX package's dense
``multi_head_dot_product_attention``, 1e-5 (float32 einsum and softmax in
another order).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

from deeplearning4j_tpu.common.environment import Environment as JEnv
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.ndarray import factory as jfactory
from deeplearning4j_tpu.ops import nn as jnn
from deeplearning4j_tpu.parallel import ParallelInference as JPI
from deeplearning4j_tpu_torch.common import nan_panic
from deeplearning4j_tpu_torch.common.environment import Environment as TEnv
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.ndarray import factory as tfactory
from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.parallel import ParallelInference as TPI
from torch_parity import lenet_conf, mln_twins, modules

PACKAGES = ("jax", "torch")


@contextlib.contextmanager
def nan_panic_on(which):
    env = JEnv.get() if which == "jax" else TEnv.get()
    env.set_check_nan(True)
    try:
        yield
    finally:
        env.set_check_nan(False)


def _log(which, x):
    if which == "jax":
        return np.asarray(jax.jit(jnp.log)(jnp.asarray(x)))
    return torch.log(torch.as_tensor(x)).numpy()


@pytest.mark.parametrize("which", PACKAGES)
def test_log_of_minus_one_raises_while_on_and_flows_while_off(which):
    x = np.array([-1.0, 2.0], np.float32)
    with nan_panic_on(which):
        assert (JEnv if which == "jax" else TEnv).get().is_check_nan()
        with pytest.raises(FloatingPointError) as ei:
            _log(which, x)
    if which == "torch":
        assert "aten.log" in str(ei.value)
    out = _log(which, x)
    assert np.isnan(out[0]) and out[1] == pytest.approx(np.log(2.0))


def test_off_means_off_no_mode_is_pushed():
    base = list(_get_current_dispatch_mode_stack())
    with nan_panic_on("torch"):
        assert len(_get_current_dispatch_mode_stack()) == len(base) + 1
        # a worker thread's scope does nothing on a thread already in it
        assert nan_panic.scope() is nan_panic._NULL
    assert list(_get_current_dispatch_mode_stack()) == base
    assert not TEnv.get().is_check_nan()
    assert nan_panic.scope() is nan_panic._NULL
    nan_panic.check_kernel("bn_act", torch.tensor([float("nan")]))


def test_views_and_uninitialised_memory_do_not_raise():
    with nan_panic_on("torch"):
        buf = torch.empty(1 << 16)            # any bits, NaNs included
        buf.fill_(1.0)
        x = torch.tensor([1.0, float("nan")])[:1]   # a view of a clean row
        assert float(x.sum()) == 1.0


@pytest.mark.parametrize("which", PACKAGES)
def test_a_nan_born_in_the_backward_pass_raises(which):
    """sqrt(w) * 0 at w = 0: the forward is 0; the backward's
    0 / (2 sqrt(0)) is a NaN."""
    with nan_panic_on(which):
        with pytest.raises(FloatingPointError):
            if which == "jax":
                jax.block_until_ready(jax.grad(
                    lambda w: jnp.sum(jnp.sqrt(w) * 0.0))(jnp.zeros(2)))
            else:
                w = torch.zeros(2, requires_grad=True)
                (torch.sqrt(w) * 0.0).sum().backward()
    w = torch.zeros(2, requires_grad=True)
    (torch.sqrt(w) * 0.0).sum().backward()
    assert torch.isnan(w.grad).all()


def _mlp_conf(which):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(5)
            .updater(m.Sgd(0.01)).list()
            .layer(m.L.DenseLayer(n_out=8, activation="relu"))
            .layer(m.L.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(4)).build())


@pytest.mark.parametrize("which", PACKAGES)
def test_a_nan_on_an_inference_worker_thread_fails_the_future(which):
    jn, tn = mln_twins(_mlp_conf("jax"), _mlp_conf("torch"))
    model, PI = (jn, JPI) if which == "jax" else (tn, TPI)
    pi = (PI.Builder(model).inference_mode("batched").batch_limit(4)
          .workers(1).max_wait_ms(1).build())
    x = np.ones((1, 4), np.float32)
    bad = np.full((1, 4), np.nan, np.float32)
    try:
        with nan_panic_on(which):
            fut = pi.output_async(bad)
            with pytest.raises(FloatingPointError):
                fut.result(timeout=60)
            ok = np.asarray(pi.output_async(x).result(timeout=60))
        assert np.isfinite(ok).all()
        # off again: the worker returns the NaN rows
        assert np.isnan(np.asarray(pi.output_async(bad).result(
            timeout=60))).all()
    finally:
        pi.shutdown()


def test_a_nan_on_a_serving_dispatcher_or_a_prefetch_thread_raises():
    """The serving tier's dispatcher fails the request's future; the
    background producer's error reaches the consumer."""
    from deeplearning4j_tpu_torch.common.background import prefetch_iter
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine

    _, tn = mln_twins(_mlp_conf("jax"), _mlp_conf("torch"))
    eng = (ServingEngine.Builder(tn).buckets((1, 2)).input_shape((4,))
           .workers(1).max_wait_ms(1.0).request_timeout_ms(15000).build())
    minus = torch.tensor([-1.0])
    try:
        with nan_panic_on("torch"):
            fut = eng.output_async(np.full((1, 4), np.nan, np.float32))
            with pytest.raises(FloatingPointError):
                fut.result(timeout=60)
            with pytest.raises(FloatingPointError, match="aten.log"):
                list(prefetch_iter(torch.log(minus + i) for i in range(3)))
        assert list(prefetch_iter(torch.log(minus + i) for i in range(2)))
    finally:
        eng.shutdown()


@pytest.mark.parametrize("which", PACKAGES)
def test_a_lenet_fit_with_a_nan_in_its_batch_raises(which):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 1, 28, 28)).astype(np.float32)
    x[2, 0, 5, 5] = np.nan
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    net = modules(which).MultiLayerNetwork(lenet_conf(which))
    net = net.init(3) if which == "jax" else net.init(device="cpu")
    ds = JDataSet(x, y) if which == "jax" else DataSet(x, y)
    with nan_panic_on(which):
        with pytest.raises(FloatingPointError):
            net.fit(ds)


def test_allow_pallas_off_takes_the_dense_route_and_matches_jax():
    rng = np.random.default_rng(4)
    b, t, dm, h = 2, 16, 16, 2
    q = rng.normal(size=(b, t, dm)).astype(np.float32)
    ws = [rng.normal(size=(dm, dm)).astype(np.float32) * 0.3
          for _ in range(4)]
    mask = np.ones((b, t), np.float32)
    mask[1, 11:] = 0
    want = np.asarray(jnn.multi_head_dot_product_attention(
        q, q, q, *ws, mask=mask, num_heads=h))
    args = [torch.from_numpy(a) for a in (q, q, q, *ws)]
    prof = OpProfiler.get()
    env = TEnv.get()
    routes = {}
    for allow in (True, False):
        env.set_allow_pallas(allow)
        try:
            before = prof.get_counters()
            got = tnn.multi_head_dot_product_attention(
                *args, mask=torch.from_numpy(mask), num_heads=h)
            after = prof.get_counters()
        finally:
            env.set_allow_pallas(True)
        routes[allow] = {k: after.get(k, 0) - before.get(k, 0)
                         for k in ("attention/mha_flash",
                                   "attention/mha_dense")}
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert routes[True] == {"attention/mha_flash": 1,
                            "attention/mha_dense": 0}
    assert routes[False] == {"attention/mha_flash": 0,
                             "attention/mha_dense": 1}


@pytest.mark.parametrize("name", ["float64", "float16", "float32"])
def test_default_dtype_drives_nd4j_create_as_in_jax(name, monkeypatch):
    """``DL4J_TPU_DTYPE`` read by a fresh Environment, and
    ``set_default_dtype`` on the singleton, in both packages."""
    monkeypatch.setenv("DL4J_TPU_DTYPE", name)
    assert JEnv().default_dtype() == TEnv().default_dtype() == name
    data = [[1.5, -2.0], [0.25, 3.0]]
    envs = (JEnv.get(), TEnv.get())
    for env in envs:
        env.set_default_dtype(name)
    try:
        j = jfactory.create(data)
        t = tfactory.create(data, device="cpu")
        z = tfactory.zeros(2, 3, device="cpu")
    finally:
        for env in envs:
            env.set_default_dtype("float32")
    assert str(j.value.dtype) == name
    assert t.value.dtype == z.value.dtype == getattr(torch, name)
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.value))
    assert tfactory.create(data, device="cpu").value.dtype == torch.float32
