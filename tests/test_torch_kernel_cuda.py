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
from deeplearning4j_tpu_torch.ops import embeddings, epilogue, update


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
    if W and B > 1:
        idx[0, 0] = V - 1
        idx[1, -1] = V + 7
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
    (5, 0, 50, 8, 0)])
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
