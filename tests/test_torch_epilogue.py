"""The port's fused BN epilogue (deeplearning4j_tpu_torch/ops/epilogue.py)
against the JAX package's (ops/pallas_epilogue.py) on the CPU.

The JAX side runs ``bn_act`` in ``mode="xla"`` and ``mode="interpret"`` as
tests/test_precision.py does; the port runs its plain PyTorch version (the
wrapper's path for CPU tensors). Inputs are made with numpy from a seed.
The kernel itself is compared with the plain version on the card by
``chip_smoke.py`` and by tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_epilogue
from deeplearning4j_tpu.ops.registry import get_op
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.ops import epilogue
from torch_parity import f32_ulp_bound

BF16 = ml_dtypes.bfloat16


def _case(shape, residual, seed=3):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = rng.normal(size=shape).astype(np.float32)
    stats = (rng.normal(size=C).astype(np.float32),
             rng.uniform(0.5, 2.0, size=C).astype(np.float32),
             rng.normal(size=C).astype(np.float32),
             rng.normal(size=C).astype(np.float32))
    res = rng.normal(size=shape).astype(np.float32) if residual else None
    return x, stats, res


def _port(x, stats, res, act, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    mean, var, gamma, beta = (torch.from_numpy(s) for s in stats)
    out = epilogue.bn_act(t(x).to(dtype), mean, var, gamma, beta,
                          epsilon=1e-5, axis=1, act=act,
                          residual=None if res is None
                          else t(res).to(dtype))
    assert out is not None and out.dtype == dtype
    return out.float().numpy()


def _jax(x, stats, res, act, mode, dtype=jnp.float32):
    mean, var, gamma, beta = (jnp.asarray(s) for s in stats)
    out = pallas_epilogue.bn_act(
        jnp.asarray(x, dtype), mean, var, gamma, beta, epsilon=1e-5,
        axis=1, act=act,
        residual=None if res is None else jnp.asarray(res, dtype),
        mode=mode)
    assert out is not None
    return np.asarray(out.astype(jnp.float32))


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


class TestPlainVersionVsJax:
    @pytest.mark.parametrize("shape", [(2, 256, 7, 7), (16, 128)])
    @pytest.mark.parametrize("residual", [False, True])
    @pytest.mark.parametrize("act", ["relu", "identity"])
    @pytest.mark.parametrize("mode", ["xla", "interpret"])
    def test_f32_within_2_ulp(self, shape, residual, act, mode):
        x, stats, res = _case(shape, residual)
        ref = _jax(x, stats, res, act, mode)
        got = _port(x, stats, res, act)
        assert np.max(np.abs(got - ref)) <= f32_ulp_bound(ref)

    @pytest.mark.parametrize("shape", [(2, 256, 7, 7), (16, 128)])
    @pytest.mark.parametrize("residual", [False, True])
    def test_bf16_within_2_bf16_ulp(self, shape, residual):
        """The port computes in f32 and rounds once; JAX's bf16 path rounds
        scale/shift to bf16 and computes in bf16. Bound: 2 bf16 ulp
        (2 * 2**-7 relative, bf16 has 8 significant bits) of the output's
        magnitude, the largest |value| among the output and the terms
        x*scale, shift and residual that JAX rounds to bf16 on the way."""
        x, stats, res = _case(shape, residual)
        x = x.astype(BF16).astype(np.float32)
        res = None if res is None else res.astype(BF16).astype(np.float32)
        ref = _jax(x, stats, res, "relu", "xla", jnp.bfloat16)
        got = _port(x, stats, res, "relu", torch.bfloat16)
        mean, var, gamma, beta = stats
        scale = gamma / np.sqrt(var + 1e-5)
        terms = [np.abs(ref).max(), np.abs(beta - mean * scale).max(),
                 np.abs(x * scale.reshape((1, -1) + (1,) * (x.ndim - 2)))
                 .max()]
        if res is not None:
            terms.append(np.abs(res).max())
        assert np.max(np.abs(got - ref)) <= 2 * 2.0 ** -7 * max(terms)

    def test_no_gamma_beta(self):
        x, (mean, var, _, _), _ = _case((8, 128), False)
        got = epilogue.bn_act(torch.from_numpy(x), torch.from_numpy(mean),
                              torch.from_numpy(var), None, None, axis=1,
                              act="identity").numpy()
        ref = _jax(x, (mean, var, np.ones_like(mean), np.zeros_like(mean)),
                   None, "identity", "xla")
        assert np.max(np.abs(got - ref)) <= f32_ulp_bound(ref)


class TestGate:
    def test_refusals_counted(self):
        prof = OpProfiler.get()
        x, stats, _ = _case((2, 128, 4, 4), False)
        args = [torch.from_numpy(s) for s in stats]
        xt = torch.from_numpy(x)
        assert epilogue.bn_act(xt, *args, axis=1, act="tanh") is None
        bad_res = torch.zeros(2, 128, 4, 5)
        assert epilogue.bn_act(xt, *args, axis=1, act="relu",
                               residual=bad_res) is None
        assert epilogue.bn_act(xt.to(torch.int32), *args, axis=1,
                               act="relu") is None
        assert epilogue.bn_act(xt.reshape(2, 128, 16), *args, axis=1,
                               act="relu") is None
        assert prof.counter_value("precision/epilogue_fallbacks") == 4
        assert prof.counter_value("precision/epilogue_hits") == 0

    @pytest.mark.parametrize("shape", [(2, 65, 4, 4), (3, 65, 7, 5),
                                       (17, 130)])
    def test_any_channel_count_accepted(self, shape):
        """The TPU gate needs C % 128 == 0 (its lane width), so the JAX
        package refuses C=65 and C=130 (bn_act returns None there); the
        Hopper gate takes any C. The port then matches the JAX dense ops."""
        x, (mean, var, gamma, beta), res = _case(shape, True)
        assert pallas_epilogue.bn_act(
            jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var),
            jnp.asarray(gamma), jnp.asarray(beta), axis=1,
            act="relu") is None
        got = _port(x, (mean, var, gamma, beta), res, "relu")
        dense = get_op("batchnorm").fn(
            jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var),
            jnp.asarray(gamma), jnp.asarray(beta), epsilon=1e-5, axis=1)
        dense = np.maximum(np.asarray(dense) + res, 0)
        # the fold reassociates the dense ops: tolerance-bounded
        assert np.allclose(got, dense, rtol=1e-5, atol=1e-5)
        prof = OpProfiler.get()
        assert prof.counter_value("precision/epilogue_hits") == 1
        assert prof.counter_value("precision/epilogue_residual_hits") == 1

    def test_fusable(self):
        x4 = torch.zeros(2, 3, 4, 4)
        assert epilogue.fusable(x4, 1, "relu")
        assert epilogue.fusable(x4, -3, None)
        assert not epilogue.fusable(x4, 3, "relu")
        assert not epilogue.fusable(x4, 1, "sigmoid")
        assert epilogue.fusable(torch.zeros(4, 3), -1, "identity")
        assert not epilogue.fusable(torch.zeros(4, 3, dtype=torch.int64),
                                    1, "relu")


class TestDispatch:
    def test_cpu_tensor_takes_plain_version_without_launch(self):
        epilogue.reset_launches()
        x, stats, res = _case((2, 8, 3, 3), True)
        scale, shift = epilogue.fold(*(torch.from_numpy(s) for s in stats))
        out = epilogue.bn_act_apply(torch.from_numpy(x), scale, shift,
                                    torch.from_numpy(res), "relu")
        ref = epilogue.bn_act_reference(torch.from_numpy(x), scale, shift,
                                        torch.from_numpy(res), "relu")
        assert torch.equal(out, ref)
        assert epilogue.bn_act_launches == 0

    def test_kernel_wrapper_refuses_cpu_tensor(self):
        x = torch.zeros(2, 8, 3, 3)
        s = torch.ones(8)
        with pytest.raises(ValueError, match="CUDA tensor"):
            epilogue.bn_act_cuda(x, s, s)

    def test_plain_version_rounds_once(self):
        """bf16: the plain version computes in f32 and rounds once, so it
        equals the f32 result rounded to bf16."""
        x, stats, res = _case((2, 16, 5, 5), True)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        rb = torch.from_numpy(res).to(torch.bfloat16)
        scale, shift = epilogue.fold(*(torch.from_numpy(s) for s in stats))
        got = epilogue.bn_act_reference(xb, scale, shift, rb, "relu")
        want = epilogue.bn_act_reference(xb.float(), scale, shift,
                                         rb.float(), "relu")
        assert torch.equal(got, want.to(torch.bfloat16))
