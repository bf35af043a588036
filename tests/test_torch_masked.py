"""The feature-mask path of the port against the JAX package, on the CPU.

A ``[B, T]`` feature mask (1 = a real step) routes a MultiLayerNetwork's
layers through ``apply_masked``: global pooling leaves padded steps out,
self-attention masks its keys (the port's plain flash version with the
additive bias ``where(mask, 0, -1e9)``; the JAX package takes its dense
path on the CPU) and zeroes its padded outputs.

Tolerances: layers within 1e-6 absolute (pooling: the same float32 sums)
and 1e-5 (attention: flash's blockwise softmax against the dense one);
network outputs within 1e-6; 3 masked Nesterovs steps: losses within
1e-5 relative, parameters within rtol 1e-4 / atol 1e-6 (the bound of
tests/test_torch_train.py). Padding invariance: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.nn.conf import layers as TL
from deeplearning4j_tpu_torch.ops import attention
from torch_parity import masked_conf, mln_twins, modules

B, T, F = 3, 6, 8


def _mask(lengths, T=T):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)


def _x(seed=0, shape=(B, T, F)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


@pytest.mark.parametrize("kind", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_masked_matches_jax(kind):
    jl = modules("jax").L.GlobalPoolingLayer(pooling_type=kind)
    tl = TL.GlobalPoolingLayer(pooling_type=kind)
    x, m = _x(), _mask([6, 3, 1])
    want, _ = jl.apply_masked({}, jnp.asarray(x), {}, False, None,
                              jnp.asarray(m))
    got, _ = tl.apply_masked({}, torch.from_numpy(x), {}, False,
                             torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # without a mask (and on CNN input) the plain pooling, pnorm included
    want, _ = jl.apply({}, jnp.asarray(x), {}, False, None)
    got, _ = tl.apply({}, torch.from_numpy(x), {}, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    c = _x(1, (2, 3, 4, 4))
    got, _ = tl.apply_masked({}, torch.from_numpy(c), {}, False,
                             torch.ones(2, 4))
    want, _ = jl.apply({}, jnp.asarray(c), {}, False, None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("project", [True, False])
def test_self_attention_masked_matches_jax(project):
    mj = modules("jax")
    kw = dict(n_out=F, n_heads=2) if project else dict(project_input=False)
    jl, tl = mj.L.SelfAttentionLayer(**kw), TL.SelfAttentionLayer(**kw)
    for layer, m in ((jl, mj), (tl, modules("torch"))):
        layer.weight_init = "xavier"
        layer.set_input_type(m.InputType.recurrent(F, T))
    params = {k: np.array(v) for k, v in
              jl.init_params(jax.random.PRNGKey(0)).items()}
    x, m = _x(2), _mask([6, 4, 2])
    want, _ = jl.apply_masked({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(x), {}, False, None,
                              jnp.asarray(m))
    got, _ = tl.apply_masked({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x), {}, False,
                             torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[m == 0] == 0)
    counters = OpProfiler.get().get_counters()
    if project:
        assert counters.get("attention/mha_flash") == 1
        assert counters.get("attention/mha_dense", 0) == 0


def test_mask_bias_reaches_flash_as_a_view(monkeypatch):
    """The MHA op's padding mask becomes one float32 [B, 1, 1, T] bias,
    broadcast to [B, H, T, T] with zero strides (no copy); the bf16
    kernel's argument check takes that view as it lies."""
    seen = []
    plain = attention.flash_attention_reference

    def spy(q, k, v, scale, causal, bias, block_k, with_lse=False):
        seen.append(bias)
        return plain(q, k, v, scale, causal, bias, block_k, with_lse)

    monkeypatch.setattr(attention, "flash_attention_reference", spy)
    tl = TL.SelfAttentionLayer(n_out=F, n_heads=2, weight_init="xavier")
    tl.set_input_type(modules("torch").InputType.recurrent(F, T))
    params = tl.init_params(torch.Generator().manual_seed(0))
    tl.apply_masked(params, torch.from_numpy(_x(3)), {}, False,
                    torch.from_numpy(_mask([6, 5, 1])))
    (bias,) = seen
    assert bias.dtype == torch.float32 and tuple(bias.shape) == (B, 2, T, T)
    assert bias.stride()[1] == 0 and bias.stride()[2] == 0
    assert bias.untyped_storage().nbytes() == B * T * 4
    attention._check_bias(bias, B * 2, T, bias.device)
    assert float(bias[1, 1, 3, 5]) == -1e9 and float(bias[1, 0, 0, 4]) == 0


def _tokens(batch, seq, vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    lengths = rng.integers(3, seq + 1, batch)
    return tokens, _mask(lengths, seq)


def test_masked_network_output_and_fit_match_jax():
    jn, tn = mln_twins(masked_conf("jax"), masked_conf("torch"))
    tokens, fm = _tokens(4, 16, 50, seed=4)
    np.testing.assert_allclose(
        tn.output(tokens, fmask=fm).numpy(),
        np.asarray(jn.output(tokens, fmask=fm).value), rtol=0, atol=1e-6)
    for step in range(3):
        tokens, fm = _tokens(4, 16, 50, seed=5 + step)
        y = np.eye(2, dtype=np.float32)[np.arange(4) % 2]
        jn.fit(JDataSet(tokens, y, features_mask=fm))
        tn.fit(DataSet(tokens, y, features_mask=fm))
        want = jn.score_value
        assert abs(tn.score_value - want) <= 1e-5 * abs(want), step
    np.testing.assert_allclose(tn.params().numpy(),
                               np.asarray(jn.params().value), rtol=1e-4,
                               atol=1e-6)
    # evaluate threads the mask through output
    ev = tn.evaluate(DataSet(tokens, y, features_mask=fm))
    jev = jn.evaluate(JDataSet(tokens, y, features_mask=fm))
    np.testing.assert_array_equal(ev.confusion, jev.confusion)


def test_padding_invariance():
    """Other token ids at the padded steps change no output bit."""
    tn = mln_twins(masked_conf("jax"), masked_conf("torch"))[1]
    tokens, fm = _tokens(5, 16, 50, seed=9)
    other = np.where(fm > 0, tokens, (tokens + 17) % 50).astype(np.int32)
    assert (other != tokens).any()
    np.testing.assert_array_equal(tn.output(other, fmask=fm).numpy(),
                                  tn.output(tokens, fmask=fm).numpy())
    # without the mask the padded tokens do count
    assert not np.array_equal(tn.output(other).numpy(),
                              tn.output(tokens).numpy())


def test_masked_network_in_bf16_compute():
    """bf16 compute with float32 master parameters: probabilities within
    2e-2 of float32's (bf16 keeps 8 bits), and a finite training step."""
    conf32, conf16 = masked_conf("torch"), masked_conf(
        "torch", compute_dtype="bfloat16")
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    a = MultiLayerNetwork(conf32).init(device="cpu")
    b = MultiLayerNetwork(conf16).init(device="cpu")
    b.set_params(a.params())
    tokens, fm = _tokens(4, 16, 50, seed=11)
    pa = a.output(tokens, fmask=fm)
    pb = b.output(tokens, fmask=fm)
    assert pb.dtype == torch.bfloat16
    np.testing.assert_allclose(pb.float().numpy(), pa.numpy(), atol=2e-2)
    y = np.eye(2, dtype=np.float32)[np.arange(4) % 2]
    b.fit(DataSet(tokens, y, features_mask=fm))
    assert np.isfinite(b.score_value)
