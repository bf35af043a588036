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


# --- the wrapper's checks --------------------------------------------------------

def _previous_checks(table, indices, mask, counts):
    """The checks of the wrapper before its launch was made cheaper, as
    they were, the device type aside (that check comes first in both and is
    tested below): the oracle for what the kernel must refuse."""
    if table.dtype != torch.float32:
        raise TypeError("table dtype")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError("table shape")
    if indices.ndim != 2:
        raise ValueError("indices shape")
    B, W = indices.shape
    for t, dtype, shape in ((indices, torch.int32, (B, W)),
                            (mask, torch.float32, (B, W)),
                            (counts, torch.float32, (B,))):
        if (t.dtype != dtype or t.device != table.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError("argument")
    if table.shape[0] == 0 and B * W > 0:
        raise ValueError("empty table")
    if B * W >= 2 ** 62 or table.numel() >= 2 ** 62 \
            or table.shape[1] >= 2 ** 31:
        raise ValueError("too large")


def _args(**change):
    args = {"table": torch.zeros(7, 5), "indices": torch.zeros(
        4, 3, dtype=torch.int32), "mask": torch.ones(4, 3),
        "counts": torch.full((4,), 3.0)}
    args.update(change)
    return args


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


CHECK_CASES = {
    "ok": {},
    "ok-empty-window": {"indices": torch.zeros(4, 0, dtype=torch.int32),
                        "mask": torch.ones(4, 0)},
    "ok-empty-table-empty-window": {
        "table": torch.zeros(0, 5), "indices": torch.zeros(
            4, 0, dtype=torch.int32), "mask": torch.ones(4, 0)},
    "table-float64": {"table": torch.zeros(7, 5, dtype=torch.float64)},
    "table-bfloat16": {"table": torch.zeros(7, 5, dtype=torch.bfloat16)},
    "table-int32": {"table": torch.zeros(7, 5, dtype=torch.int32)},
    "table-1d": {"table": torch.zeros(35)},
    "table-3d": {"table": torch.zeros(7, 5, 1)},
    "table-transposed": {"table": torch.zeros(5, 7).t()},
    "indices-1d": {"indices": torch.zeros(12, dtype=torch.int32)},
    "indices-3d": {"indices": torch.zeros(4, 3, 1, dtype=torch.int32)},
    "indices-int64": {"indices": torch.zeros(4, 3, dtype=torch.int64)},
    "indices-float": {"indices": torch.zeros(4, 3)},
    "indices-transposed": {"indices": torch.zeros(
        3, 4, dtype=torch.int32).t()},
    "mask-float64": {"mask": torch.ones(4, 3, dtype=torch.float64)},
    "mask-narrow": {"mask": torch.ones(4, 2)},
    "mask-short": {"mask": torch.ones(3, 3)},
    "mask-transposed": {"mask": torch.ones(3, 4).t()},
    "counts-float64": {"counts": torch.ones(4, dtype=torch.float64)},
    "counts-column": {"counts": torch.ones(4, 1)},
    "counts-short": {"counts": torch.ones(3)},
    "counts-strided": {"counts": torch.ones(8)[::2]},
    "indices-elsewhere": {"indices": _meta(4, 3, dtype=torch.int32)},
    "mask-elsewhere": {"mask": _meta(4, 3)},
    "counts-elsewhere": {"counts": _meta(4)},
    "empty-table": {"table": torch.zeros(0, 5)},
    "row-too-wide": {"table": _meta(1, 2 ** 31), "indices": _meta(
        4, 3, dtype=torch.int32), "mask": _meta(4, 3), "counts": _meta(4)},
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_wrapper_checks_refuse_what_they_refused_before(case):
    """Every input the previous checks refused is refused again, with the
    same exception type, and every input they took is taken."""
    args = _args(**CHECK_CASES[case])
    try:
        _previous_checks(**args)
        want = None
    except (TypeError, ValueError) as e:
        want = type(e)
    assert (want is None) == case.startswith("ok")
    if want is None:
        temb._check_args(**args)
    else:
        with pytest.raises(want):
            temb._check_args(**args)


def test_wrapper_refuses_grad_then_device_first():
    """The grad refusal, then the device type, come before every other
    check, as before: a CPU table, even one the kernel could not take for
    other reasons, is refused for its device."""
    args = _args(table=torch.zeros(7, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        temb.embedding_bag_cuda(mean=True, **args)
    args = _args(table=torch.zeros(7, 5).requires_grad_())
    with pytest.raises(RuntimeError, match="forward-only"):
        temb.embedding_bag_cuda(mean=True, **args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        temb.embedding_bag_cuda(mean=True, **args)
    assert temb.embedding_bag_launches == 0


# --- the skip-gram and hierarchical-softmax rounds ---------------------------------

def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _path_case(B, L, V, seed):
    """Huffman-like paths [B, L]: inner-node points, 0/1 codes and a ragged
    path mask (each path at least 1 long)."""
    rng = np.random.default_rng(seed)
    points = rng.integers(0, V, size=(B, L)).astype(np.int32)
    codes = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.float32)
    return points, codes, mask


def _sg_case(B=12, K=4, V=9, D=8, seed=5):
    """A skip-gram round on a small vocabulary: duplicate centers and
    targets within the round, two pairs with a zero pair mask."""
    rng = np.random.default_rng(seed)
    syn0 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    syn1 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    centers = rng.integers(0, V, size=B).astype(np.int32)
    tgt = rng.integers(0, V, size=(B, 1 + K)).astype(np.int32)
    lab = np.zeros((B, 1 + K), np.float32)
    lab[:, 0] = 1.0
    pm = np.ones(B, np.float32)
    pm[[2, B - 1]] = 0.0
    return syn0, syn1, centers, tgt, lab, np.float32(0.05), pm


def _round_pair(name, args, table_dtype=np.float32):
    """Run the round ``name`` in both packages on copies of the same numpy
    inputs (the first two are the tables, in ``table_dtype`` where it is
    bf16); return (port syn0, port syn1, port loss, JAX syn0, JAX syn1, JAX
    loss) as float32 numpy."""
    jt = [jnp.asarray(a) for a in args]
    tt = _t(*args)
    if table_dtype != np.float32:
        jt[:2] = [a.astype(jnp.bfloat16) for a in jt[:2]]
        tt[:2] = [a.to(torch.bfloat16) for a in tt[:2]]
    tt[len(args) - 2] = torch.tensor(args[-2])          # lr, 0-dim
    j0, j1, jl = getattr(jemb, name)(*jt)
    tl = getattr(temb, name)(*tt)
    return (tt[0].float().numpy(), tt[1].float().numpy(), float(tl),
            np.asarray(j0.astype(jnp.float32)),
            np.asarray(j1.astype(jnp.float32)), float(jl))


def test_skipgram_round_against_jax():
    """Duplicate rows sum (scatter-add), masked pairs contribute nothing;
    1e-6 absolute on the tables and relative on the loss, as the CBOW
    round."""
    args = _sg_case()
    assert len(np.unique(args[2])) < args[2].size
    t0, t1, tl, j0, j1, jl = _round_pair("skipgram", args)
    np.testing.assert_allclose(t0, j0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert not np.array_equal(t0, args[0]) and not np.array_equal(t1, args[1])
    untouched = np.setdiff1d(np.arange(args[0].shape[0]), args[2])
    np.testing.assert_array_equal(t0[untouched], args[0][untouched])


@pytest.mark.parametrize("name", ["skipgram", "skipgram_hs", "cbow_hs"])
def test_zero_pair_mask_changes_nothing(name):
    rng = np.random.default_rng(8)
    B, V, D = 6, 7, 4
    syn0 = rng.normal(size=(V, D)).astype(np.float32)
    syn1 = rng.normal(size=(V, D)).astype(np.float32)
    pm = np.zeros(B, np.float32)
    if name == "skipgram":
        rest = _sg_case(B=B, V=V, D=D, seed=9)[2:5]
    else:
        points, codes, mask = _path_case(B, 3, V, 10)
        first = ([rng.integers(0, V, size=B).astype(np.int32)]
                 if name == "skipgram_hs" else
                 [rng.integers(0, V, size=(B, 4)).astype(np.int32),
                  np.ones((B, 4), np.float32)])
        rest = (*first, points, codes, mask)
    t0, t1 = torch.from_numpy(syn0.copy()), torch.from_numpy(syn1.copy())
    loss = getattr(temb, name)(t0, t1, *_t(*rest), torch.tensor(
        np.float32(0.5)), torch.from_numpy(pm))
    np.testing.assert_array_equal(t0.numpy(), syn0)
    np.testing.assert_array_equal(t1.numpy(), syn1)
    assert float(loss) == 0.0


def test_skipgram_hs_round_against_jax():
    """Paths of different lengths on a small table (duplicate inner nodes
    and centers), labels 1 - code, the path mask on u and on grad_u."""
    rng = np.random.default_rng(11)
    B, L, V, D = 10, 5, 7, 6
    syn0 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    syn1 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    centers = rng.integers(0, V, size=B).astype(np.int32)
    points, codes, mask = _path_case(B, L, V, 12)
    pm = np.ones(B, np.float32)
    pm[3] = 0.0
    args = (syn0, syn1, centers, points, codes, mask, np.float32(0.1), pm)
    t0, t1, tl, j0, j1, jl = _round_pair("skipgram_hs", args)
    np.testing.assert_allclose(t0, j0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    # a point only under the masked tail of every path stays as it was
    live = np.unique(points[mask > 0])
    dead = np.setdiff1d(np.arange(V), live)
    np.testing.assert_array_equal(t1[dead], syn1[dead])


def test_cbow_hs_round_against_jax():
    rng = np.random.default_rng(13)
    B, W, L, V, D = 9, 6, 4, 8, 5
    syn0 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    syn1 = rng.normal(scale=0.5, size=(V, D)).astype(np.float32)
    ctx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    cm = (rng.random((B, W)) < 0.8).astype(np.float32)
    cm[2] = 0.0                                   # an empty window
    points, codes, mask = _path_case(B, L, V, 14)
    pm = np.ones(B, np.float32)
    pm[5] = 0.0
    args = (syn0, syn1, ctx, cm, points, codes, mask, np.float32(0.1), pm)
    t0, t1, tl, j0, j1, jl = _round_pair("cbow_hs", args)
    np.testing.assert_allclose(t0, j0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


def test_round_goldens_of_the_jax_tests():
    """tests/test_nlp.py's hand-computed rounds (skip-gram's first update,
    duplicate sums, the HS label sign, CBOW-HS, the logit clamp), on the
    port."""
    def run(name, syn0, syn1, *rest, lr=1.0):
        s0, s1 = torch.tensor(syn0), torch.tensor(syn1)
        loss = getattr(temb, name)(s0, s1, *_t(*rest[:-1]),
                                   torch.tensor(np.float32(lr)),
                                   torch.from_numpy(rest[-1]))
        return s0.numpy(), s1.numpy(), float(loss)

    s0, s1, loss = run("skipgram", np.eye(4, 3, dtype=np.float32),
                       np.zeros((4, 3), np.float32), np.array([0], np.int32),
                       np.array([[1, 2]], np.int32),
                       np.array([[1.0, 0.0]], np.float32),
                       np.ones(1, np.float32))
    np.testing.assert_allclose(s1[1], [0.5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(s1[2], [-0.5, 0, 0], atol=1e-6)
    np.testing.assert_allclose(s0[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(loss, -np.log(0.5), rtol=1e-5)
    s0, _, _ = run("skipgram", np.ones((3, 2), np.float32),
                   np.full((3, 2), 0.5, np.float32), np.array([0, 0], np.int32),
                   np.array([[1], [1]], np.int32), np.ones((2, 1), np.float32),
                   np.ones(2, np.float32), lr=0.1)
    g = (1 - 1 / (1 + np.exp(-1.0))) * 0.1
    np.testing.assert_allclose(s0[0], 1 + 2 * g * 0.5, rtol=1e-5)
    for code, sign in ((0, 1.0), (1, -1.0)):
        _, s1, _ = run("skipgram_hs", np.eye(2, 2, dtype=np.float32),
                       np.zeros((2, 2), np.float32), np.array([0], np.int32),
                       np.array([[0]], np.int32), np.array([[code]], np.int32),
                       np.ones((1, 1), np.float32), np.ones(1, np.float32))
        np.testing.assert_allclose(s1[0], [sign * 0.5, 0], atol=1e-6)
    syn0 = np.array([[1, 0], [0, 1], [0, 0]], np.float32)
    s0, s1, loss = run("cbow_hs", syn0, np.ones((3, 2), np.float32),
                       np.array([[0, 1]], np.int32), np.ones((1, 2), np.float32),
                       np.array([[0]], np.int32), np.array([[0]], np.int32),
                       np.ones((1, 1), np.float32), np.ones(1, np.float32))
    g = 1 - 1 / (1 + np.exp(-1.0))
    np.testing.assert_allclose(s1[0], 1 + g * np.array([.5, .5]), rtol=1e-5)
    np.testing.assert_allclose(s0[0], [1, 0] + g * np.array([1, 1]) / 2,
                               rtol=1e-5)
    assert np.isfinite(loss)
    s0, _, loss = run("skipgram", np.full((2, 4), 100.0, np.float32),
                      np.full((2, 4), 100.0, np.float32),
                      np.array([0], np.int32), np.array([[1]], np.int32),
                      np.zeros((1, 1), np.float32), np.ones(1, np.float32),
                      lr=0.025)
    assert np.isfinite(s0).all() and np.isfinite(loss)


@pytest.mark.parametrize("name", ["skipgram", "cbow"])
def test_bf16_table_rounds_against_jax(name):
    """Both rounds on bf16 tables: the dot in bf16, the gradients in
    float32, the scatter-add in bf16, as the JAX package promotes. Tables
    within 1 bf16 ulp of their magnitude (2^-7 relative, with 2^-9 absolute
    for values near 0): the bf16 dot rounds once in both, after sums taken
    in different orders, and one flipped rounding moves an update by an
    ulp; the loss within 1e-2 relative."""
    if name == "skipgram":
        args = _sg_case(seed=15)
    else:
        args = _round_case(seed=16)
    t0, t1, tl, j0, j1, jl = _round_pair(name, args, table_dtype="bf16")
    for t, j, start in ((t0, j0, args[0]), (t1, j1, args[1])):
        np.testing.assert_allclose(t, j, rtol=2 ** -7, atol=2 ** -9)
        assert not np.array_equal(t, _bf16(start))     # the round trained
    np.testing.assert_allclose(tl, jl, rtol=1e-2)


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# --- the bf16 route of the bag ----------------------------------------------------

def _bf16_case(B, W, D, V=13, seed=0, fully_masked=()):
    """A bf16 table (the float32 draws rounded), indices and a 0/1 mask."""
    table, idx, mask = _bag_case(B, W, D, V=V, seed=seed,
                                 fully_masked=fully_masked)
    return (torch.from_numpy(table).to(torch.bfloat16), idx, mask)


def _jax_bf16(table, idx, mask, mode, impl):
    out = jemb.embedding_bag(jnp.asarray(table.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(idx), jnp.asarray(mask), mode=mode,
        impl=impl)
    assert out.dtype == jnp.bfloat16
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_embedding_bag_bitwise_against_interpret(case, mode):
    """The plain bf16 version against the Pallas kernel in interpret mode,
    bit for bit for 0/1 masks: both round each ``acc + row * mask`` and the
    quotient to bf16, in W order (the product of a bf16 value and 0 or 1 is
    exact)."""
    B, W, D, extra = CASES[case]
    table, idx, mask = _bf16_case(B, W, D, seed=3, **extra)
    got = temb.embedding_bag(table, torch.from_numpy(idx),
                             torch.from_numpy(mask), mode=mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  _jax_bf16(table, idx, mask, mode,
                                            "interpret"))


@pytest.mark.parametrize("mode", ["mean", "sum"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_embedding_bag_against_xla(case, mode):
    """Against the JAX package's ``xla`` lowering, which sums the masked
    bf16 rows as one reduction (XLA may carry it in float32 and round
    once): each rounding of the sequential sum is within half a bf16 ulp
    of its partial sum, so the two differ by at most W ulp of the largest
    partial sum: here 2^-8 * W * max|row| (and a mean is no further)."""
    B, W, D, extra = CASES[case]
    table, idx, mask = _bf16_case(B, W, D, seed=4, **extra)
    got = temb.embedding_bag(table, torch.from_numpy(idx),
                             torch.from_numpy(mask), mode=mode)
    bound = 2 ** -8 * W * float(table.float().abs().max())
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_bf16(table, idx, mask, mode, "xla"),
                               rtol=0, atol=bound)


def test_bf16_embedding_bag_is_the_rounded_sequential_sum():
    """The plain bf16 version rounds every product, sum and quotient to
    bf16: a numpy loop that does so (float32 arithmetic of bf16 values,
    then rounding) gives the same bits; float32 accumulation would not."""
    table, idx, mask = _bf16_case(64, 11, 100, V=50, seed=6)
    got = temb.embedding_bag(table, torch.from_numpy(idx),
                             torch.from_numpy(mask)).float().numpy()

    def rnd(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).float().numpy()

    t = table.float().numpy()
    acc = np.zeros((64, 100), np.float32)
    for w in range(11):
        acc = rnd(acc + rnd(t[idx[:, w]] * mask[:, w, None]))
    counts = np.maximum(mask.sum(1, keepdims=True), 1).astype(np.float32)
    np.testing.assert_array_equal(got, rnd(acc / counts))
    f32 = (t[idx] * mask[..., None]).sum(1) / counts
    assert not np.array_equal(got, f32)


def test_wrapper_checks_take_the_bf16_route():
    """A bf16 table with a bf16 mask and counts passes the checks; a bf16
    table with float32 ones, or a float16 table, is refused."""
    args = _args(table=torch.zeros(7, 5, dtype=torch.bfloat16),
                 mask=torch.ones(4, 3, dtype=torch.bfloat16),
                 counts=torch.full((4,), 3.0, dtype=torch.bfloat16))
    temb._check_args(**args)
    with pytest.raises(TypeError, match="bf16"):
        temb._check_args(**dict(args, mask=torch.ones(4, 3)))
    with pytest.raises(TypeError, match="bf16"):
        temb._check_args(**dict(args, counts=torch.ones(4)))
    with pytest.raises(TypeError):
        temb._check_args(**dict(args, table=torch.zeros(
            7, 5, dtype=torch.float16)))
    with pytest.raises(ValueError):
        temb._check_args(**dict(args, mask=torch.ones(
            4, 2, dtype=torch.bfloat16)))
    with pytest.raises(ValueError, match="CUDA"):
        temb.embedding_bag_cuda(mean=True, **args)
    assert temb.embedding_bag_bf16_launches == 0
