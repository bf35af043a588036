"""The port's ring attention against the JAX package's, on the CPU.

Port counterparts of ``tests/test_ring_attention.py`` (the dense op, a
causal numpy reference, gradients, a long sequence), plus parity with the
JAX ring on the same inputs: the JAX ring on its 8 virtual CPU devices, the
port's on 8 CPU slots. Tolerances are the JAX tests': the outputs within
atol 2e-5 / rtol 1e-4, the gradients within atol 1e-4 / rtol 1e-3 (the
online softmax sums the blocks in another order than the dense softmax).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu_torch.ops import nn as tnn
from deeplearning4j_tpu_torch.parallel import (make_mesh, ring_attention,
                                               ring_self_attention)


def _weights(rng, F, H, hs, O):
    return (rng.randn(F, H * hs).astype(np.float32) * 0.3,
            rng.randn(F, H * hs).astype(np.float32) * 0.3,
            rng.randn(F, H * hs).astype(np.float32) * 0.3,
            rng.randn(H * hs, O).astype(np.float32) * 0.3)


def _mesh(n=8):
    return make_mesh(data=n, devices=["cpu"] * n)


def _jmesh():
    return JMesh(np.array(jax.devices()), ("data",))


def _dense(x, w, H):
    t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for a in (x, *w)]
    return tnn.multi_head_dot_product_attention(t[0], t[0], t[0], *t[1:],
                                                num_heads=H)


def _causal_reference(x, wq, wk, wv, wo, H, hs):
    B, T, _ = x.shape

    def split(w):
        return (x @ w).reshape(B, T, H, hs).transpose(0, 2, 1, 3)

    q, k, v = split(wq), split(wk), split(wv)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(hs)
    mask = np.tril(np.ones((T, T), bool))
    logits = np.where(mask[None, None], logits, -1e30)
    w_ = np.exp(logits - logits.max(-1, keepdims=True))
    w_ /= w_.sum(-1, keepdims=True)
    ctx = np.einsum("bhqk,bhkd->bhqd", w_, v).transpose(0, 2, 1, 3) \
        .reshape(B, T, -1)
    return ctx @ wo


class TestRingAttention:
    def test_matches_dense_attention(self):
        rng = np.random.RandomState(0)
        B, T, F, H, hs, O = 2, 32, 8, 2, 4, 8
        x = rng.randn(B, T, F).astype(np.float32)
        w = _weights(rng, F, H, hs, O)
        ring = ring_self_attention(x, *w, H, _mesh(), "data").numpy()
        np.testing.assert_allclose(ring, _dense(x, w, H).numpy(), atol=2e-5,
                                   rtol=1e-4)

    def test_causal_matches_dense_reference(self):
        rng = np.random.RandomState(1)
        B, T, F, H, hs = 2, 16, 6, 2, 3
        x = rng.randn(B, T, F).astype(np.float32)
        w = _weights(rng, F, H, hs, 6)
        ring = ring_self_attention(x, *w, H, _mesh(), "data",
                                   causal=True).numpy()
        np.testing.assert_allclose(ring, _causal_reference(x, *w, H, hs),
                                   atol=2e-5, rtol=1e-4)

    def test_gradients_flow_through_ring(self):
        rng = np.random.RandomState(2)
        B, T, F, H, hs, O = 1, 16, 4, 1, 4, 4
        x = rng.randn(B, T, F).astype(np.float32)
        wq, wk, wv, wo = _weights(rng, F, H, hs, O)

        def grad(fn):
            q = torch.from_numpy(wq.copy()).requires_grad_(True)
            (fn(q) ** 2).sum().backward()
            return q.grad.numpy()

        g_ring = grad(lambda q: ring_self_attention(
            x, q, wk, wv, wo, H, _mesh(), "data"))
        g_dense = grad(lambda q: _dense(x, (q, torch.from_numpy(wk),
                                            torch.from_numpy(wv),
                                            torch.from_numpy(wo)), H))
        np.testing.assert_allclose(g_ring, g_dense, atol=1e-4, rtol=1e-3)

    def test_long_sequence_runs(self):
        rng = np.random.RandomState(3)
        B, T, F, H, hs = 1, 256, 8, 2, 4
        x = rng.randn(B, T, F).astype(np.float32)
        w = _weights(rng, F, H, hs, 8)
        out = ring_self_attention(x, *w, H, _mesh(), "data")
        assert tuple(out.shape) == (B, T, 8)
        assert torch.isfinite(out).all()

    def test_fully_masked_blocks_are_guarded(self):
        """Causal slot 0 sees every later K/V block fully masked: the
        guards keep its running max and normalizer finite."""
        rng = np.random.RandomState(4)
        q = [torch.from_numpy(rng.randn(1, 4, 2, 3).astype(np.float32))
             for _ in range(4)]
        out = ring_attention(q, q, q, causal=True)
        assert all(torch.isfinite(o).all() for o in out)
        # the first query row attends to its own key alone
        np.testing.assert_allclose(out[0][:, 0].numpy(), q[0][:, 0].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_against_jax_ring(causal):
    from deeplearning4j_tpu.parallel import (
        ring_self_attention as jring)

    rng = np.random.RandomState(5)
    B, T, F, H, hs, O = 2, 64, 12, 3, 4, 10
    x = rng.randn(B, T, F).astype(np.float32)
    w = _weights(rng, F, H, hs, O)
    want = np.asarray(jring(x, *w, H, _jmesh(), "data", causal=causal))
    got = ring_self_attention(x, *w, H, _mesh(), "data",
                              causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_gradients_against_jax_ring(causal):
    from deeplearning4j_tpu.parallel import (
        ring_self_attention as jring)

    rng = np.random.RandomState(6)
    B, T, F, H, hs, O = 1, 32, 6, 2, 3, 5
    x = rng.randn(B, T, F).astype(np.float32)
    wq, wk, wv, wo = _weights(rng, F, H, hs, O)
    jg = jax.grad(lambda a, b, c, d: (jring(x, a, b, c, d, H, _jmesh(),
                                            "data", causal=causal) ** 2)
                  .sum(), argnums=(0, 1, 2, 3))(wq, wk, wv, wo)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (wq, wk, wv, wo)]
    (ring_self_attention(x, *ts, H, _mesh(), "data", causal=causal) ** 2) \
        .sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=1e-4, rtol=1e-3)
