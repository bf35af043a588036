"""The port's embedding bag and CBOW round against the JAX package, on the
CPU.

Inputs are made with numpy from a seed and handed to both packages. The JAX
side runs ``ops/embeddings.embedding_bag`` in ``interpret`` mode (its Pallas
kernel through the interpreter, as tests/test_op_validation.py does) and in
its CPU default mode (``xla``); the port runs the plain version of
``csrc/embedding_bag.cu``, which is what its wrapper takes for CPU tensors.

Tolerances, and why:
- against ``interpret``: bitwise for 0/1 masks (the CBOW path's). Both add
  ``row * mask`` in W order from zero, then divide by the counts. With
  other mask weights XLA's CPU backend contracts the interpreter's
  ``o += row * mask`` into a fused multiply-add, where the port rounds the
  product first (as its kernel does, to stay bitwise with its plain
  version); there the bound is 1e-6 absolute and the port is held bitwise
  to a numpy loop that rounds each step.
- against ``xla``: 1e-6 absolute. XLA sums the masked rows as a reduction,
  which may associate the W terms differently (values here are O(1)).
- the CBOW round: 1e-6 absolute on the tables (O(1) values, updates of
  O(lr)) and 1e-6 relative on the loss. The dot products go through
  different matrix kernels (XLA's and PyTorch's), so they round differently
  in the last bits; duplicate rows are summed in a different order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import embeddings as jemb
from deeplearning4j_tpu_torch.ops import embeddings as temb


def _bag_case(B, W, D, V=13, seed=0, fully_masked=(), ragged_mask=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    mask = (rng.random((B, W)) < 0.7).astype(np.float32) if ragged_mask \
        else np.ones((B, W), np.float32)
    for b in fully_masked:
        mask[b] = 0.0
    return table, idx, mask


def _jax(table, idx, mask, mode, impl):
    return np.asarray(jemb.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx),
        None if mask is None else jnp.asarray(mask), mode=mode, impl=impl))


def _port(table, idx, mask, mode):
    return temb.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx),
        None if mask is None else torch.from_numpy(mask), mode=mode).numpy()


CASES = {
    # name: (B, W, D, extra)
    "cbow-like": (9, 10, 8, {}),
    "d-not-multiple-of-4": (7, 4, 5, {}),
    "d-1": (6, 3, 1, {}),
    "w-1": (8, 1, 12, {}),
    "fully-masked-bags": (6, 5, 7, {"fully_masked": (0, 3)}),
}


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_embedding_bag_bitwise_against_interpret(case, mode):
    B, W, D, extra = CASES[case]
    table, idx, mask = _bag_case(B, W, D, **extra)
    got = _port(table, idx, mask, mode)
    want = _jax(table, idx, mask, mode, "interpret")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if "fully_masked" in extra:   # count clamps to 1: the bag is zero
        assert not got[list(extra["fully_masked"])].any()


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_embedding_bag_against_xla(case, mode):
    B, W, D, extra = CASES[case]
    table, idx, mask = _bag_case(B, W, D, seed=1, **extra)
    np.testing.assert_allclose(_port(table, idx, mask, mode),
                               _jax(table, idx, mask, mode, "xla"),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_embedding_bag_without_mask_pools_whole_window(impl):
    table, idx, _ = _bag_case(5, 4, 6, seed=2)
    got = _port(table, idx, None, "mean")
    want = _jax(table, idx, None, "mean", impl)
    if impl == "interpret":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_embedding_bag_clamps_indices_to_the_table(impl):
    """An index at V-1 is the last row; one past the table clamps to it, as
    the JAX gather and the Pallas kernel's row DMA do."""
    V = 11
    table, idx, mask = _bag_case(4, 3, 4, V=V, seed=3)
    idx[0, 0] = V - 1
    idx[1, 1] = V + 3
    idx[2, 2] = 2 ** 31 - 1
    got = _port(table, idx, mask, "sum")
    np.testing.assert_allclose(_jax(table, idx, mask, "sum", impl), got,
                               rtol=0, atol=1e-6)
    clamped = np.minimum(idx, V - 1)
    np.testing.assert_array_equal(
        got, _port(table, clamped, mask, "sum"))


def test_embedding_bag_mask_weights_and_int64_indices():
    """A non-binary mask weighs the rows; int64 indices are taken as int32
    (the JAX package casts them too)."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(10, 6)).astype(np.float32)
    idx = rng.integers(0, 10, size=(5, 4))
    mask = rng.random((5, 4)).astype(np.float32)
    got = temb.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                             torch.from_numpy(mask)).numpy()
    acc = np.zeros((5, 6), np.float32)
    for w in range(4):                      # one rounding per operation
        acc = acc + table[idx[:, w]] * mask[:, w, None]
    np.testing.assert_array_equal(
        got, acc / np.maximum(mask.sum(1, keepdims=True), np.float32(1)))
    for impl in ("interpret", "xla"):
        np.testing.assert_allclose(
            got, _jax(table, idx.astype(np.int32), mask, "mean", impl),
            rtol=0, atol=1e-6)


def test_embedding_bag_is_forward_only():
    table = torch.randn(6, 4, requires_grad=True)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        temb.embedding_bag(table, idx)
    with torch.no_grad():
        out = temb.embedding_bag(table, idx)
    assert out.shape == (2, 4) and not out.requires_grad
    with pytest.raises(ValueError, match="mode"):
        temb.embedding_bag(table.detach(), idx, mode="max")


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = temb.embedding_bag_launches
    table, idx, mask = _bag_case(4, 3, 8)
    _port(table, idx, mask, "mean")
    assert temb.embedding_bag_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        temb.embedding_bag_cuda(torch.from_numpy(table),
                                torch.from_numpy(idx),
                                torch.from_numpy(mask),
                                torch.ones(4), True)


def _round_case(B=12, W=6, K=4, V=9, D=8, seed=5):
    """A CBOW round on a small vocabulary: duplicate rows within the round
    (V is small), ragged windows, two examples with a zero pair mask and
    one with an empty window."""
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    syn1 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    ctx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    cm = (rng.random((B, W)) < 0.8).astype(np.float32)
    cm[4] = 0.0
    tgt = rng.integers(0, V, size=(B, 1 + K)).astype(np.int32)
    lab = np.zeros((B, 1 + K), np.float32)
    lab[:, 0] = 1.0
    pm = np.ones(B, np.float32)
    pm[[2, 7]] = 0.0
    return syn0, syn1, ctx, cm, tgt, lab, np.float32(0.05), pm


def test_cbow_round_against_jax():
    syn0, syn1, ctx, cm, tgt, lab, lr, pm = _round_case()
    assert len(np.unique(ctx)) < ctx.size          # duplicates in the round
    j0, j1, jloss = jemb.cbow(*(jnp.asarray(a) for a in
                                (syn0, syn1, ctx, cm, tgt, lab, lr, pm)))
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    tloss = temb.cbow(t0, t1, torch.from_numpy(ctx), torch.from_numpy(cm),
                      torch.from_numpy(tgt), torch.from_numpy(lab),
                      torch.tensor(lr), torch.from_numpy(pm))
    np.testing.assert_allclose(t0.numpy(), np.asarray(j0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    # the round moved the tables, and only the rows it touched
    assert not np.array_equal(t0.numpy(), syn0)
    untouched = np.setdiff1d(np.arange(syn1.shape[0]), tgt)
    np.testing.assert_array_equal(t1.numpy()[untouched], syn1[untouched])


def test_cbow_zero_pair_mask_changes_nothing():
    syn0, syn1, ctx, cm, tgt, lab, lr, _ = _round_case(seed=6)
    pm = np.zeros(ctx.shape[0], np.float32)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    loss = temb.cbow(t0, t1, torch.from_numpy(ctx), torch.from_numpy(cm),
                     torch.from_numpy(tgt), torch.from_numpy(lab),
                     torch.tensor(lr), torch.from_numpy(pm))
    np.testing.assert_array_equal(t0.numpy(), syn0)
    np.testing.assert_array_equal(t1.numpy(), syn1)
    assert float(loss) == 0.0


def test_neg_round_against_jax():
    rng = np.random.default_rng(7)
    h = rng.normal(size=(6, 5)).astype(np.float32)
    u = (rng.normal(size=(6, 3, 5)) * 4).astype(np.float32)   # some clamp
    lab = np.zeros((6, 3), np.float32)
    lab[:, 0] = 1.0
    pm = np.array([1, 1, 0, 1, 1, 1], np.float32)
    jh, ju, jl = jemb._neg_round(jnp.asarray(h), jnp.asarray(u),
                                 jnp.asarray(lab), jnp.float32(0.1),
                                 jnp.asarray(pm))
    th, tu, tl = temb._neg_round(torch.from_numpy(h), torch.from_numpy(u),
                                 torch.from_numpy(lab), torch.tensor(
                                     np.float32(0.1)), torch.from_numpy(pm))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
