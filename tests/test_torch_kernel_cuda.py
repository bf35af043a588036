"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips where no card is
present. This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda --noconftest -q

(``--noconftest`` because tests/conftest.py sets up JAX.) ``chip_smoke.py``
makes the same comparison at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.learning import updaters
from deeplearning4j_tpu_torch.ops import (attention, embeddings, epilogue,
                                          update)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _case(shape, seed=3):
    rng = np.random.default_rng(seed)
    C = shape[1]
    x = rng.normal(size=shape).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    stats = (rng.normal(size=C), rng.uniform(0.5, 2.0, size=C),
             rng.normal(size=C), rng.normal(size=C))
    return x, res, [s.astype(np.float32) for s in stats]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 65, 7, 5), (17, 130), (4, 256, 14, 14),
                                   (2, 64, 112, 112)])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("residual", [False, True])
def test_bn_act_kernel_matches_plain_version(dtype, shape, act, residual):
    dev = _card()
    x, res, stats = _case(shape)
    xt = torch.from_numpy(x).to(dev, dtype)
    rt = torch.from_numpy(res).to(dev, dtype) if residual else None
    scale, shift = epilogue.fold(*(torch.from_numpy(s).to(dev)
                                   for s in stats))
    before = epilogue.bn_act_launches
    got = epilogue.bn_act_cuda(xt, scale, shift, rt, act).float()
    want = epilogue.bn_act_reference(xt, scale, shift, rt, act).float()
    torch.cuda.synchronize()
    assert epilogue.bn_act_launches == before + 1
    err = (got - want).abs().max().item()
    if dtype == torch.float32:
        # fmaf vs two roundings: 2 ulp of the output scale
        assert err <= 2.0 ** -22 * (want.abs().max().item() + 1.0)
    else:
        # both round once to bf16 from f32 values that differ by the
        # kernel's fmaf (2 f32 ulp of the terms at most): 1 bf16 ulp
        # (2**-7 relative at most) plus that, elementwise
        shape_c = [1, -1] + [1] * (xt.ndim - 2)
        terms = (xt.float() * scale.reshape(shape_c)).abs() \
            + shift.abs().reshape(shape_c)
        if rt is not None:
            terms = terms + rt.float().abs()
        tol = torch.maximum(got.abs(), want.abs()) * 2.0 ** -7 \
            + 2.0 ** -22 * terms
        assert bool((got - want).abs().le(tol).all())


@pytest.mark.cuda
def test_bn_act_kernel_refuses_what_it_does_not_take():
    dev = _card()
    x = torch.zeros(2, 8, 3, 3, device=dev)
    s = torch.ones(8, device=dev)
    with pytest.raises(TypeError):
        epilogue.bn_act_cuda(x.half(), s, s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x.transpose(2, 3), s, s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x, s.half(), s)
    with pytest.raises(ValueError):
        epilogue.bn_act_cuda(x, s, s, residual=torch.zeros(2, 8, 3, 4,
                                                           device=dev))


_UPDATERS = {"sgd": lambda: updaters.Sgd(0.1),
             "nesterovs": lambda: updaters.Nesterovs(0.1, momentum=0.9),
             "adam": lambda: updaters.Adam(1e-3),
             "adamw": lambda: updaters.AdamW(1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_UPDATERS))
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("n,offset", [(1, (0, 0)), (5, (0, 0)),
                                      (4097, (0, 0)), (4097, (1, 1)),
                                      (4097, (1, 0)), (1 << 20, (0, 0))])
def test_fused_update_kernel_matches_plain_version(kind, bf16, n, offset):
    """The kernel (in place) against its plain version on copies of the same
    inputs, bf16 moments with the same random bits. Bound: the JAX
    package's contract between its modes, 2 float32 ulp for parameters and
    float32 moments; bf16 moments bitwise, since stochastic rounding picks
    between two neighbours 1 bf16 ulp apart and only equal bits show that
    the kernel rounded each slot with its own halfword."""
    dev = _card()
    rng = np.random.default_rng(n + 7)

    def buf(a, dtype, which):
        o = offset[0] if which == "p" else offset[1]
        full = np.concatenate([np.zeros(o, np.float32), a,
                               np.zeros(4, np.float32)])
        return torch.from_numpy(full).to(dev, dtype)[o:o + n]

    p = buf(rng.normal(size=n).astype(np.float32), torch.float32, "p")
    g = buf((rng.normal(size=n) * 0.01).astype(np.float32), torch.float32,
            "g")
    sdt = torch.bfloat16 if bf16 else torch.float32
    slots = {}
    for s in update.SLOTS[kind]:
        a = rng.normal(size=n).astype(np.float32) * 0.1
        if s == "v" and kind != "nesterovs":
            a = np.abs(a) * 0.01
        slots[s] = buf(a, sdt, s)
    bits = None
    if bf16 and slots:
        raw = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
        bits = torch.from_numpy(np.concatenate(
            [np.zeros(offset[1], np.int32), raw,
             np.zeros(4, np.int32)])).to(dev)[offset[1]:offset[1] + n]
    sr = torch.bfloat16 if bf16 else None
    upd = _UPDATERS[kind]()
    sc = update._scalars(upd, kind, 3)
    want_p, want_s = update.fused_update_reference(kind, sc, p, g, slots,
                                                   bits, sr)
    before = update.fused_update_launches
    update.fused_update_cuda(kind, sc, p, g, slots, bits, sr)
    torch.cuda.synchronize()
    assert update.fused_update_launches == before + 1
    assert (p - want_p).abs().max().item() <= \
        2.0 ** -22 * (want_p.abs().max().item() + 1.0)
    for k, got in slots.items():
        if bf16:
            assert torch.equal(got, want_s[k]), k
        else:
            d = (got - want_s[k]).abs()
            assert d.max().item() <= 2.0 ** -22 * (
                want_s[k].abs().max().item() + 1.0)


@pytest.mark.cuda
def test_fused_update_kernel_refuses_what_it_does_not_take():
    dev = _card()
    p = torch.zeros(16, device=dev)
    v = torch.zeros(16, device=dev)
    sc = (0.1, 0.9, 1.9)
    with pytest.raises(TypeError):
        update.fused_update_cuda("nesterovs", sc, p.half(), p, {"v": v})
    with pytest.raises(TypeError):      # bf16 state without rounding bits
        update.fused_update_cuda("nesterovs", sc, p, p, {"v": v.bfloat16()})
    with pytest.raises(ValueError):
        update.fused_update_cuda("nesterovs", sc, p, p[:8], {"v": v})
    with pytest.raises(TypeError):      # rounding into a float32 slot
        update.fused_update_cuda("nesterovs", sc, p, p, {"v": v},
                                 bits=torch.zeros(16, dtype=torch.int32,
                                                  device=dev),
                                 sr_dtype=torch.bfloat16)


def _bag_inputs(B, W, V, D, dev, seed, offset=0, masked=()):
    """table (a view ``offset`` elements into its buffer), indices with the
    edges V-1 and past the table, a 0/1 mask with fully masked bags."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.normal(size=V * D + offset).astype(
        np.float32)).to(dev)
    table = buf[offset:].view(V, D)
    idx = rng.integers(0, V, size=(B, W)).astype(np.int32)
    if W and B > 2:
        idx[0, 0] = V - 1
        idx[1, -1] = V + 7
        idx[2, W // 2] = -3
    mask = (rng.random((B, W)) < 0.7).astype(np.float32)
    for b in masked:
        mask[b] = 0.0
    mask_t = torch.from_numpy(mask).to(dev)
    counts = mask_t.sum(1).clamp_min(1.0)
    return table, torch.from_numpy(idx).to(dev), mask_t, counts


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("B,W,V,D,offset", [
    (8192, 10, 10000, 100, 0),       # the CBOW path's shape
    (33, 10, 50, 1, 0), (33, 10, 50, 3, 0), (33, 10, 50, 101, 0),
    (33, 10, 50, 300, 0), (40, 1, 50, 64, 0), (40, 7, 50, 64, 1),
    (5, 0, 50, 8, 0),
    # index chunks past 32 lanes, at D 100 and 300
    (33, 32, 50, 100, 0), (33, 33, 50, 100, 0), (33, 40, 50, 100, 0),
    (33, 32, 50, 300, 0), (33, 33, 50, 300, 0), (33, 40, 50, 300, 0),
    # each count of rows in flight, B not a multiple of 8 bags per block
    (8191, 3, 10000, 100, 0), (8191, 5, 10000, 100, 0),
    (8191, 13, 10000, 100, 0),
    # the scalar route past 32 indices
    (1001, 33, 1000, 101, 1), (5, 40, 1000, 300, 1)])
def test_embedding_bag_kernel_bitwise_against_plain_version(mean, B, W, V,
                                                            D, offset):
    """Both add row * mask in W order from zero and divide by the count,
    each step rounded: bitwise. offset=1 puts the table 1 element into its
    buffer (the scalar path)."""
    dev = _card()
    table, idx, mask, counts = _bag_inputs(B, W, V, D, dev, B + D,
                                           offset, masked=(2, 4))
    before = embeddings.embedding_bag_launches
    got = embeddings.embedding_bag_cuda(table, idx, mask, counts, mean)
    want = embeddings.embedding_bag_reference(table, idx, mask, counts, mean)
    torch.cuda.synchronize()
    assert embeddings.embedding_bag_launches == before + 1
    assert torch.equal(got, want)
    if W:
        assert not got[2].any() and not got[4].any()


@pytest.mark.cuda
def test_embedding_bag_entry_launches_the_kernel_for_cuda_tensors():
    dev = _card()
    table, idx, mask, _ = _bag_inputs(64, 6, 30, 12, dev, 5)
    before = embeddings.embedding_bag_launches
    got = embeddings.embedding_bag(table, idx.long(), mask, mode="mean")
    assert embeddings.embedding_bag_launches == before + 1
    want = embeddings.embedding_bag(table.cpu(), idx.cpu(), mask.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_embedding_bag_kernel_refuses_what_it_does_not_take():
    dev = _card()
    table, idx, mask, counts = _bag_inputs(4, 3, 10, 8, dev, 6)
    with pytest.raises(TypeError):
        embeddings.embedding_bag_cuda(table.bfloat16(), idx, mask, counts,
                                      True)
    with pytest.raises(ValueError):
        embeddings.embedding_bag_cuda(table.t(), idx, mask, counts, True)
    with pytest.raises(ValueError):
        embeddings.embedding_bag_cuda(table, idx.long(), mask, counts, True)
    with pytest.raises(ValueError):
        embeddings.embedding_bag_cuda(table, idx, mask[:, :2], counts, True)
    with pytest.raises(ValueError):
        embeddings.embedding_bag_cuda(table, idx, mask, counts.cpu(), True)
    with pytest.raises(RuntimeError, match="forward-only"):
        embeddings.embedding_bag_cuda(table.clone().requires_grad_(), idx,
                                      mask, counts, True)


def _bf16_bag_inputs(B, W, V, D, dev, seed, offset=0, masked=()):
    """_bag_inputs rounded to bf16: the table (``offset`` elements into a
    bf16 buffer), the mask and the counts."""
    table, idx, mask, _ = _bag_inputs(B, W, V, D, dev, seed, masked=masked)
    buf = torch.empty(V * D + offset, dtype=torch.bfloat16, device=dev)
    t16 = buf[offset:].view(V, D)
    t16.copy_(table)
    m16 = mask.to(torch.bfloat16)
    return t16, idx, m16, m16.float().sum(1).clamp_min(1.0).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("B,W,V,D,offset", [
    (8192, 10, 10000, 100, 0),       # the bf16 CBOW path's shape
    (8192, 11, 10000, 100, 0),       # PV-DM's label column
    (33, 10, 50, 1, 0), (33, 10, 50, 3, 0), (33, 10, 50, 102, 0),
    (33, 10, 50, 128, 0), (33, 10, 50, 128, 1), (33, 10, 50, 300, 0),
    (33, 33, 50, 128, 0), (33, 40, 50, 256, 0), (5, 0, 50, 8, 0),
    # the paired layout (two bags a warp, 16 a block, 11 rows in flight):
    # W 11, 12, 16 and 17 (the float route's loop), B not a multiple of 2
    # or 16 (5, 15, 17, 8191; the inputs mask rows 2 and 4), rows of 25 and
    # 32 vectors (D 100, 128, a table 4 elements into its buffer), and D 102
    # and 300, which keep the loop
    (5, 12, 50, 100, 0), (15, 16, 50, 100, 4), (17, 11, 50, 128, 0),
    (17, 16, 50, 128, 4), (8191, 17, 10000, 100, 0), (15, 11, 50, 102, 0),
    (17, 12, 50, 300, 4), (5, 16, 50, 256, 0)])
def test_embedding_bag_bf16_route_bitwise_against_plain_version(mean, B, W,
                                                                V, D,
                                                                offset):
    """The bf16 route rounds every product, sum and quotient to bf16, as
    PyTorch's bf16 operations in the plain version do: bitwise, at each
    vector width (16-, 8-, 4-byte and single values)."""
    dev = _card()
    table, idx, mask, counts = _bf16_bag_inputs(B, W, V, D, dev, B + D,
                                                offset, masked=(2, 4))
    before = embeddings.embedding_bag_bf16_launches
    got = embeddings.embedding_bag_cuda(table, idx, mask, counts, mean)
    want = embeddings.embedding_bag_reference(table, idx, mask, counts, mean)
    torch.cuda.synchronize()
    assert embeddings.embedding_bag_bf16_launches == before + 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.cuda
def test_embedding_bag_entry_takes_the_bf16_route_for_bf16_tables():
    dev = _card()
    table, idx, mask, _ = _bf16_bag_inputs(64, 6, 30, 12, dev, 5)
    before = embeddings.embedding_bag_bf16_launches
    got = embeddings.embedding_bag(table, idx.long(), mask, mode="mean")
    assert embeddings.embedding_bag_bf16_launches == before + 1
    want = embeddings.embedding_bag(table.cpu(), idx.cpu(), mask.cpu())
    assert torch.equal(got.cpu(), want)


def _qkv(bh, T, D, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(bh, T, D)) * 0.3).astype(
        np.float32)).to(dev) for _ in range(3)]


def _masked_row(T):
    return min(3, T - 1)


def _bias(kind, B, H, T, dev, seed):
    """None; a padding mask broadcast from [B, 1, 1, T] as the MHA op builds
    it; a full [B, H, T, T] bias; or a bias that masks row ``_masked_row(T)``
    of every (batch, head) to -inf everywhere."""
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    if kind == "mask":
        keep = rng.random((B, 1, 1, T)) < 0.7
        keep[..., 0] = True
        b = np.where(keep, 0.0, -1e9).astype(np.float32)
        return torch.from_numpy(b).to(dev).expand(B, H, T, T)
    b = (rng.normal(size=(B, H, T, T)) * 0.5).astype(np.float32)
    if kind == "masked_row":
        b[:, :, _masked_row(T), :] = -np.inf
    return torch.from_numpy(b).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D", [
    (32, 12, 128, 64),               # the encoder path's [384, 128, 64]
    (2, 3, 200, 64),                 # a tail tile
    (1, 2, 512, 32), (1, 2, 512, 64), (1, 2, 512, 128),
    (2, 2, 64, 4), (1, 1, 1, 8), (1, 2, 70, 100),
    # the 3xTF32 kernel's tiles: a tail of 8 keys (T 200) and of 1 (513),
    # one, two and four 32-float chunks of the head size, D 100 zero-filled
    (2, 2, 200, 32), (2, 2, 200, 100), (2, 2, 513, 64), (1, 2, 513, 128),
    (1, 2, 513, 100)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [None, "mask", "full", "masked_row"])
def test_flash_attention_kernel_matches_plain_version(B, H, T, D, causal,
                                                      bias):
    """2e-5 absolute at inputs of scale 0.3 (the flash-against-dense
    tolerance of tests/test_pallas_attention.py); a row masked to -inf
    everywhere gives 0."""
    dev = _card()
    q, k, v = _qkv(B * H, T, D, dev, T + D)
    bt = _bias(bias, B, H, T, dev, T)
    scale = D ** -0.5
    before = attention.flash_attention_launches
    got = attention.flash_attention_cuda(q, k, v, scale, causal, bt)
    want = attention.flash_attention_reference(q, k, v, scale, causal, bt)
    torch.cuda.synchronize()
    assert attention.flash_attention_launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-5
    if bias == "masked_row":
        assert not got.view(B, H, T, D)[:, :, _masked_row(T)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D", [(32, 12, 128, 64), (2, 2, 513, 100),
                                     (1, 2, 200, 32)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_lse_matches_plain_version(B, H, T, D, causal):
    """The log-sum-exp the backward reads, within 1e-5 of the plain
    version's, finite for a row masked everywhere."""
    dev = _card()
    q, k, v = _qkv(B * H, T, D, dev, T + D + 1)
    bt = _bias("masked_row", B, H, T, dev, T)
    got, lse = attention.flash_attention_cuda(q, k, v, D ** -0.5, causal, bt,
                                              with_lse=True)
    _, want = attention.flash_attention_reference(q, k, v, D ** -0.5, causal,
                                                  bt, with_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (B * H, T) and bool(torch.isfinite(lse).all())
    assert (lse - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("T,D", [(256, 64), (200, 100), (513, 32)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [None, "full", "mask"])
def test_flash_attention_gradients_through_the_kernel_match_dense(T, D,
                                                                  causal,
                                                                  bias):
    """dq, dk, dv (and dbias) through the kernel's forward and the blockwise
    backward against autograd through the dense attention, within 1e-4.
    The loss ``sum(out * tgt)`` makes the output's cotangent ``tgt`` itself,
    so the gradients are of order one."""
    dev = _card()
    B, H = 2, 4
    q, k, v = (t.view(B, H, T, D).requires_grad_()
               for t in _qkv(B * H, T, D, dev, 9))
    bt = _bias(bias, B, H, T, dev, 10)
    if bt is not None:
        bt = (bt[:, :1, :1] if bias == "mask" else bt).clone() \
            .requires_grad_()
    tgt = torch.randn(B, H, T, D, device=dev, generator=torch.Generator(
        device=dev).manual_seed(3))
    before = attention.flash_attention_launches
    out = attention.flash_attention(q, k, v, causal=causal, bias=bt)
    assert attention.flash_attention_launches == before + 1
    leaves = [q, k, v] + ([bt] if bt is not None else [])
    got = torch.autograd.grad((out * tgt).sum(), leaves)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * D ** -0.5
    if bt is not None:
        s = s + bt
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=dev)
                          .triu(1), float("-inf"))
    dense = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
    want = torch.autograd.grad((dense * tgt).sum(), leaves)
    assert (out - dense).abs().max().item() <= 2e-5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q, k, v = _qkv(4, 32, 16, dev, 1)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q.double(), k, v, 0.25)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q.transpose(1, 2), k, v, 0.25)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q, k[:, :16], v, 0.25)
    with pytest.raises(ValueError):
        attention.flash_attention_cuda(q, k, v.cpu(), 0.25)
    with pytest.raises(ValueError):                  # head size 6
        attention.flash_attention_cuda(*_qkv(4, 32, 6, dev, 2), 0.25)
    with pytest.raises(ValueError):                  # head size 132
        attention.flash_attention_cuda(*_qkv(4, 32, 132, dev, 2), 0.25)
    with pytest.raises(ValueError):                  # B*H != 4
        attention.flash_attention_cuda(q, k, v, 0.25, bias=torch.zeros(
            3, 1, 32, 32, device=dev))
    with pytest.raises(ValueError):                  # 1 element in: unaligned
        buf = torch.zeros(4 * 32 * 16 + 1, device=dev)
        attention.flash_attention_cuda(buf[1:].view(4, 32, 16), k, v, 0.25)


# --- the bf16 flash kernel (wgmma, TMA) ------------------------------------------

def _bf16_qkv(B, H, T, D, dev, seed, layout):
    """bf16 q, k, v ``[B, H, T, D]`` of scale 0.3: "strided" as the MHA op
    hands them over (permuted views of ``[B, T, H, D]`` buffers),
    "contiguous" as ``[B, H, T, D]`` tensors."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = (rng.normal(size=(B, T, H, D)) * 0.3).astype(np.float32)
        t = torch.from_numpy(x).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
        out.append(t.contiguous() if layout == "contiguous" else t)
    return out


def test_bf16_layout_check_needs_the_card():
    """Without a card the one-tile check refuses CPU tensors (and the test
    of it below skips)."""
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention.bf16_layout_check(x, x, x)


@pytest.mark.cuda
def test_flash_bf16_one_tile_register_layout():
    """S = Q K^T from the SS wgmma, then O = (P_hi + P_lo) V with P taken
    from the registers that held S as the A operand of the RS wgmma, on one
    64 x 64 tile, against float64 products of the same bf16 values. bf16
    products are exact in float32, so S is within float32 summation error
    (2^-18 of the sum of |terms|); O also carries the hi/lo split's
    residual (at most 2^-17 of each |p|): 2^-15 of the sum of |terms|. A
    wrong register layout errs by the values' own size."""
    dev = _card()
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.normal(size=(64, 64)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    s, o = attention.bf16_layout_check(q, k, v)
    torch.cuda.synchronize()
    qd, kd, vd = (t.double() for t in (q, k, v))
    want_s = qd @ kd.T
    assert bool(((s.double() - want_s).abs()
                 <= 2.0 ** -18 * (qd.abs() @ kd.abs().T) + 1e-30).all())
    want_o = s.double() @ vd
    assert bool(((o.double() - want_o).abs()
                 <= 2.0 ** -15 * (s.double().abs() @ vd.abs())).all())


BF16_SHAPES = [
    (32, 12, 128, 64),               # the encoder path's [384, 128, 64]
    (2, 3, 1, 64), (2, 3, 63, 64), (2, 3, 64, 64),
    (2, 3, 200, 64),                 # a tail tile
    (1, 2, 512, 64),
    (2, 2, 128, 16), (2, 2, 128, 32),
    (2, 2, 128, 40),                 # the zero fill up to 64
    (1, 2, 512, 128), (2, 2, 200, 128),
    (8, 12, 512, 64),                # several items per persistent block
    (8, 12, 256, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D", BF16_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [None, "mask", "full", "masked_row"])
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
def test_flash_bf16_kernel_matches_plain_version(B, H, T, D, causal, bias,
                                                 layout):
    """Against the plain version in float32 on the upcast inputs (``want``,
    unrounded): every element within 2^-8 |want| + 2e-5 (half a bf16 ulp
    for the final rounding, plus the sums' order); at least 99% of the
    elements bitwise equal to ``want`` rounded to bf16; a row masked
    everywhere 0; the log-sum-exp within 1e-5."""
    dev = _card()
    q, k, v = _bf16_qkv(B, H, T, D, dev, T + D, layout)
    bt = _bias(bias, B, H, T, dev, T)
    scale = D ** -0.5
    before = attention.flash_attention_launches
    got, lse = attention.flash_attention_bf16_cuda(q, k, v, scale, causal, bt,
                                                   with_lse=True)
    want, want_lse = attention.flash_attention_reference(
        q.float(), k.float(), v.float(), scale, causal, bt, with_lse=True)
    torch.cuda.synchronize()
    assert attention.flash_attention_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, T, D)
    assert got.permute(0, 2, 1, 3).is_contiguous()
    g = got.float()
    assert bool(torch.isfinite(g).all())
    assert bool(((g - want).abs() <= 2.0 ** -8 * want.abs() + 2e-5).all())
    share = (got == want.bfloat16()).float().mean().item()
    assert share >= 0.99, share
    if bias == "masked_row":
        assert not got[:, :, _masked_row(T)].any()
    assert lse.shape == (B * H, T)
    assert (lse - want_lse.reshape(B * H, T)).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D", [(32, 12, 128, 64), (2, 3, 200, 64),
                                     (2, 3, 64, 128)])
@pytest.mark.parametrize("bias", [None, "masked_row"])
def test_flash_bf16_float32_output_is_the_unrounded_output(B, H, T, D,
                                                            bias):
    """The float32 output that autograd's forward asks for: the bf16
    output is exactly its rounding (the kernel rounds that float once), and
    it is within 2e-5 of the plain version's float32 output (the float32
    route's bound, chip_smoke's FA_TOL); a row masked everywhere 0."""
    dev = _card()
    q, k, v = _bf16_qkv(B, H, T, D, dev, T + D, "strided")
    bt = _bias(bias, B, H, T, dev, T)
    scale = D ** -0.5
    got, lse, o32 = attention.flash_attention_bf16_cuda(
        q, k, v, scale, False, bt, with_lse=True, with_f32=True)
    _, want_lse, want = attention.flash_attention_reference(
        q, k, v, scale, False, bt, with_lse=True, with_f32=True)
    torch.cuda.synchronize()
    assert o32.dtype == torch.float32 and o32.shape == (B * H, T, D)
    o = o32.view(B, H, T, D)
    assert torch.equal(o.bfloat16(), got)
    assert (o - want).abs().max().item() <= 2e-5
    assert (lse - want_lse.reshape(B * H, T)).abs().max().item() <= 1e-5
    if bias == "masked_row":
        assert not o[:, :, _masked_row(T)].any()


@pytest.mark.cuda
def test_flash_bf16_entry_takes_the_bf16_route_without_copies():
    """bf16 permuted views through the entry: one launch on the bf16 route,
    none on the float32 route, and the output's head merge is a view."""
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    dev = _card()
    q, k, v = _bf16_qkv(2, 4, 128, 64, dev, 5, "strided")
    OpProfiler.get().reset()
    out = attention.flash_attention(q, k, v)
    counters = OpProfiler.get().get_counters()
    assert counters.get("attention/flash_bf16") == 1
    assert "attention/flash_f32" not in counters
    assert out.dtype == torch.bfloat16
    merged = out.permute(0, 2, 1, 3)
    assert merged.is_contiguous()
    assert merged.reshape(2, 128, -1).data_ptr() == out.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_gradients_are_bf16_and_match_dense(causal):
    """Gradients through the bf16 kernel's forward come back in bf16 and
    match autograd through dense attention on the float32 upcast within 1%
    of the largest gradient: the forward's output is rounded to bf16 before
    it enters the backward's ``sum(dO * O)``, and the gradients are rounded
    to bf16 (2^-9 relative each)."""
    dev = _card()
    B, H, T, D = 2, 4, 256, 64
    q, k, v = (t.clone().requires_grad_()
               for t in _bf16_qkv(B, H, T, D, dev, 9, "strided"))
    tgt = torch.randn(B, H, T, D, device=dev, generator=torch.Generator(
        device=dev).manual_seed(3))
    out = attention.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad((out.float() * tgt).sum(), [q, k, v])
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(T, T, dtype=torch.bool, device=dev)
                          .triu(1), float("-inf"))
    dense = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vf)
    want = torch.autograd.grad((dense * tgt).sum(), [qf, kf, vf])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert (g.float() - w).abs().max().item() \
            <= 1e-2 * w.abs().max().item()


@pytest.mark.cuda
def test_flash_bf16_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q, k, v = _bf16_qkv(2, 2, 32, 64, dev, 1, "strided")
    with pytest.raises(ValueError, match="bfloat16"):       # mixed dtypes
        attention.flash_attention_bf16_cuda(q, k.float(), v, 0.25)
    with pytest.raises(ValueError, match="multiple of 8"):  # D > 128
        attention.flash_attention_bf16_cuda(
            *_bf16_qkv(1, 2, 32, 136, dev, 2, "strided"), 0.25)
    with pytest.raises(ValueError, match="multiple of 8"):  # D % 8
        attention.flash_attention_bf16_cuda(
            *_bf16_qkv(1, 2, 32, 12, dev, 2, "strided"), 0.25)
    buf = torch.zeros(2, 2, 32, 68, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="strides"):        # row stride 68
        attention.flash_attention_bf16_cuda(buf[..., :64], k, v, 0.25)
    flat = torch.zeros(2 * 2 * 32 * 64 + 1, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):        # 2 bytes in
        attention.flash_attention_bf16_cuda(flat[1:].view(2, 2, 32, 64), k, v,
                                            0.25)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_bf16_cuda(q.cpu(), k.cpu(), v.cpu(), 0.25)
    assert not attention.bf16_kernel_takes(q, k.float(), v)
    assert attention.bf16_kernel_takes(q, k, v)


@pytest.mark.cuda
def test_flash_bf16_failed_launch_raises(monkeypatch):
    """A head size the launcher refuses (12), past a gate told to take it:
    the launch function's error comes back as a RuntimeError."""
    dev = _card()
    monkeypatch.setattr(attention, "_bf16_refusal", lambda q, k, v: None)
    q, k, v = _bf16_qkv(1, 2, 32, 12, dev, 3, "contiguous")
    before = attention.flash_attention_launches
    with pytest.raises(RuntimeError, match="launch failed"):
        attention.flash_attention_bf16_cuda(q, k, v, 0.25)
    assert attention.flash_attention_launches == before


@pytest.mark.cuda
def test_output_after_a_fused_fit_reads_the_new_parameters():
    """bf16 ``compute_dtype`` with ``fused_update``: the kernel writes the
    parameter bucket through raw pointers, which bumps no tensor version,
    so the inference cast cache must be dropped by the step itself."""
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import LeNet

    dev = _card()
    net = LeNet().init(device=dev)
    gc = net.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.fused_update = True
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(size=(16, 1, 28, 28))
                         .astype(np.float32)).to(dev)
    y = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 10, size=16)), 10).float().to(dev)
    before = net.output(x).float()
    launches = update.fused_update_launches
    net.fit(DataSet(x, y))
    assert update.fused_update_launches == launches + 1
    after = net.output(x).float()
    net._cast_cache = None
    fresh = net.output(x).float()
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh)


@pytest.mark.cuda
def test_async_device_prefetch_stages_on_the_card():
    """AsyncDataSetIterator stages raw uint8 batches on the card (pinned
    memory, a copy stream, an event) and divides by 255 there: bitwise
    numpy's ``x.astype(float32) / 255`` with a 0-d card tensor divisor."""
    from deeplearning4j_tpu_torch.data import (AsyncDataSetIterator,
                                               DataSetIterator)

    dev = _card()
    rng = np.random.default_rng(11)
    raw = [(rng.integers(0, 255, (8, 3, 16, 16), dtype=np.uint8),
            np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)])
           for _ in range(6)]

    class Raw(DataSetIterator):
        def __iter__(self):
            yield from raw

    d255 = torch.full((), 255.0, device=dev)
    it = AsyncDataSetIterator(Raw(), queue_size=3,
                              feature_transform=lambda x: x.float().div_(
                                  d255))
    got = list(it)
    torch.cuda.synchronize()
    assert len(got) == 6
    for g, (x, y) in zip(got, raw):
        assert g.features.device.type == "cuda"
        assert torch.equal(g.features.cpu(),
                           torch.from_numpy(x.astype(np.float32) / 255))
        assert torch.equal(g.labels.cpu(), torch.from_numpy(y))


@pytest.mark.cuda
def test_guarded_steps_do_not_synchronise():
    """Fused steps with the telemetry aux and the NaN guard run under
    ``set_sync_debug_mode("error")`` (the readback waits for the epoch's
    end); the poisoned step keeps the pre-step parameters bitwise. (The
    per-leaf updater copies its scalars to the card every step,
    ``learning/updaters.f32_scalars``, which synchronises with or without
    telemetry.)"""
    from deeplearning4j_tpu_torch.data import DataSet, ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import (NanSentinelListener,
                                                   TelemetrySink)
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage

    dev = _card()
    b = NeuralNetConfiguration.builder().seed(3).updater(
        updaters.Nesterovs(learning_rate=0.05, momentum=0.9)).fused_update()
    net = MultiLayerNetwork(
        b.list().layer(L.DenseLayer(n_out=16, activation="tanh"))
        .layer(L.BatchNormalization())
        .layer(L.OutputLayer(n_out=3, loss="mcxent", activation="softmax"))
        .set_input_type(InputType.feed_forward(5)).build()).init(device=dev)
    rng = np.random.default_rng(2)
    batches = [DataSet(torch.from_numpy(rng.normal(size=(8, 5)).astype(
        np.float32)).to(dev), torch.from_numpy(np.eye(3, dtype=np.float32)[
            rng.integers(0, 3, 8)]).to(dev)) for _ in range(4)]
    batches[2].features[1, 1] = float("nan")

    class Lift:
        def iteration_done(self, model, iteration, score):
            pass

        def epoch_done(self, model, epoch):
            torch.cuda.set_sync_debug_mode(0)

    class Snap:
        def __init__(self):
            self.seen = []

        def iteration_done(self, model, iteration, score):
            self.seen.append(model.params().detach().clone())

    sent = NanSentinelListener("skip", check_every_n=100)
    snap = Snap()
    net.set_listeners(Lift(), snap, sent,
                      TelemetrySink(InMemoryStatsStorage(), 100))
    net.fit(batches[0])                  # builds the index caches
    snap.seen.clear()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        net.fit(ExistingDataSetIterator(batches))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(snap.seen[1], snap.seen[2])
    assert not torch.equal(snap.seen[2], snap.seen[3])
    assert [e["iteration"] for e in sent.events] == [net._iteration - 1]
