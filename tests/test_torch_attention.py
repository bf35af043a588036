"""The port's flash attention against the JAX package's, on the CPU.

The port's ``flash_attention`` runs its plain version for CPU tensors; the
JAX side runs its Pallas kernel in interpret mode (``interpret=True``), as
tests/test_pallas_attention.py does. Inputs are made with numpy from a seed
(scale 0.3, as there). Forward within 1e-5; gradients (``dq``, ``dk``,
``dv``, ``dbias``) against ``jax.grad`` through the interpret-mode op within
3e-5, the tolerance of tests/test_pallas_attention.py. The losses are
``sum(out * tgt)``, whose output cotangent is ``tgt`` itself, so every
gradient is well above the tolerance (the smallest, dq, peaks near 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import nn as jnn
from deeplearning4j_tpu.ops import pallas_attention as jfa
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.ops import attention
from deeplearning4j_tpu_torch.ops import nn as tnn


def _arrays(*shapes, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _mask_bias(B, T, seed):
    """A padding mask as the MHA op builds it: [B, 1, 1, T] of 0 / -1e9."""
    keep = np.random.default_rng(seed).random((B, 1, 1, T)) < 0.7
    keep[..., 0] = True
    return np.where(keep, 0.0, -1e9).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


FORWARD_CASES = {
    # name: (B, H, T, D, causal, bias kind, block_q, block_k)
    "noncausal": (2, 2, 128, 32, False, None, None, None),
    "causal": (2, 2, 128, 32, True, None, None, None),
    "mask_bias": (2, 3, 128, 16, False, "mask", None, None),
    "full_bias": (1, 2, 128, 32, False, "full", None, None),
    "full_bias_causal": (1, 2, 128, 32, True, "full", None, None),
    "k_blocks_64_128": (1, 2, 256, 32, False, None, 64, 128),
    "k_blocks_causal": (1, 2, 256, 32, True, None, 64, 128),
}


def _bias_for(kind, B, H, T, seed):
    if kind == "mask":
        return _mask_bias(B, T, seed)
    if kind == "full":
        return _arrays((B, H, T, T), seed=seed, scale=0.5)[0]
    return None


@pytest.mark.parametrize("name", sorted(FORWARD_CASES))
def test_forward_matches_jax_interpret(name):
    B, H, T, D, causal, kind, bq, bk = FORWARD_CASES[name]
    q, k, v = _arrays((B, H, T, D), (B, H, T, D), (B, H, T, D), seed=T + D)
    bias = _bias_for(kind, B, H, T, seed=5)
    want = np.asarray(jfa.flash_attention(
        q, k, v, causal=causal, bias=bias, block_q=bq, block_k=bk,
        interpret=True))
    got = attention.flash_attention(
        *_t(q, k, v), causal=causal,
        bias=None if bias is None else torch.from_numpy(bias),
        block_q=bq, block_k=bk).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_three_dim_single_head_matches_jax():
    q, k, v = _arrays((2, 128, 32), (2, 128, 32), (2, 128, 32), seed=1)
    want = np.asarray(jfa.flash_attention(q, k, v, interpret=True))
    got = attention.flash_attention(*_t(q, k, v)).numpy()
    assert got.shape == (2, 128, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_row_masked_everywhere_gives_zero_not_nan():
    """A row whose bias is -inf everywhere: 0 in both packages (the
    ``acc / max(l, 1e-30)`` finish)."""
    q, k, v = _arrays((1, 2, 128, 16), (1, 2, 128, 16), (1, 2, 128, 16),
                      seed=2)
    bias = _arrays((1, 2, 128, 128), seed=3)[0]
    bias[:, :, 5, :] = -np.inf
    want = np.asarray(jfa.flash_attention(q, k, v, bias=bias,
                                          interpret=True))
    got = attention.flash_attention(*_t(q, k, v),
                                    bias=torch.from_numpy(bias)).numpy()
    assert np.isfinite(got).all() and not got[:, :, 5].any()
    assert not want[:, :, 5].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bf16_input_computes_in_float32_and_returns_bf16():
    q, k, v = _arrays((1, 2, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16), seed=4)
    qb, kb, vb = (t.bfloat16() for t in _t(q, k, v))
    got = attention.flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = attention.flash_attention(qb.float(), kb.float(), vb.float())
    assert torch.equal(got, want.bfloat16())


GRAD_CASES = {
    # name: (causal, bias kind, bias shape the gradient sums back to)
    "plain": (False, None, None),
    "causal": (True, None, None),
    "full_bias": (False, "full", (1, 2, 128, 128)),
    "full_bias_causal": (True, "full", (1, 2, 128, 128)),
    "mask_bias_sums_back": (False, "mask", (1, 1, 1, 128)),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_gradients_match_jax_grad_through_interpret(name):
    causal, kind, bshape = GRAD_CASES[name]
    B, H, T, D = 1, 2, 128, 32
    q, k, v, tgt = _arrays(*[(B, H, T, D)] * 4, seed=11)
    bias = _bias_for(kind, B, H, T, seed=12)
    if kind == "mask":
        # a learned additive bias of the mask's shape, so dbias sums back
        bias = bias + _arrays(bias.shape, seed=13)[0]
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)

    def loss_jax(q, k, v, b=None):
        out = jfa.flash_attention(q, k, v, causal=causal, bias=b,
                                  interpret=True)
        return jnp.sum(out * tgt)

    args = (q, k, v) + ((bias,) if bias is not None else ())
    want = jax.grad(loss_jax, argnums=argnums)(*args)
    leaves = [t.clone().requires_grad_() for t in _t(*args)]
    out = attention.flash_attention(*leaves[:3], causal=causal,
                                    bias=leaves[3] if bias is not None
                                    else None)
    got = torch.autograd.grad((out * torch.from_numpy(tgt)).sum(), leaves)
    if bshape is not None:
        assert tuple(got[3].shape) == bshape
    for g, w, n in zip(got, want, ("dq", "dk", "dv", "dbias")):
        w = np.asarray(w)
        assert np.abs(w).max() > 1e-3, n     # far above the tolerance
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=3e-5,
                                   err_msg=n)


def test_plain_version_is_blocking_invariant():
    """The k blocking changes the order of the sums only (T 200: a tail
    block for every block size)."""
    q, k, v = _t(*_arrays((3, 200, 16), (3, 200, 16), (3, 200, 16), seed=6))
    ref = attention.flash_attention_reference(q, k, v, 0.25, True, None, 200)
    for bk in (1, 17, 64, 128):
        got = attention.flash_attention_reference(q, k, v, 0.25, True, None,
                                                  bk)
        assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("T,d,port,jax_pkg", [
    (128, 64, True, True),          # the encoder's path: both launch
    (256, 32, True, True), (1024, 64, True, True),
    (64, 64, True, False),          # block_k 64 is not a multiple of 128
    (200, 64, True, False),         # not a multiple of the block
    (1536, 64, True, False),        # 1536 % 1024
    (128, 130, False, True),        # head size above 128
    (128, 6, False, True),          # head size not a multiple of 4
])
def test_gate_differs_from_the_tpu_gate_as_documented(T, d, port, jax_pkg):
    assert attention.supports_flash(T, d) is port
    assert jfa.supports_flash(T, d) is jax_pkg


def test_refused_head_size_raises_and_cpu_runs_no_kernel():
    q = torch.zeros(1, 2, 32, 6)
    with pytest.raises(ValueError, match="dot_product_attention"):
        attention.flash_attention(q, q, q)
    before = attention.flash_attention_launches
    x = torch.zeros(1, 2, 32, 8)
    attention.flash_attention(x, x, x)
    assert attention.flash_attention_launches == before
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_cuda(x[0], x[0], x[0], 0.5)


def test_dot_product_attention_matches_jax():
    q, k, v = _arrays((2, 3, 20, 8), (2, 3, 24, 8), (2, 3, 24, 8), seed=7)
    mask = np.random.default_rng(8).random((2, 1, 1, 24)) < 0.8
    for m in (None, mask):
        want = np.asarray(jnn.dot_product_attention(q, k, v, mask=m))
        got = tnn.dot_product_attention(
            *_t(q, k, v), None if m is None else torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tk,mask,route", [
    (32, False, "attention/mha_flash"), (32, True, "attention/mha_flash"),
    (24, False, "attention/mha_dense")])
def test_mha_matches_jax_dense_and_takes_the_documented_route(tk, mask,
                                                              route):
    """The JAX package's CPU path is dense (its flash needs the TPU), the
    port's self-attention takes flash's plain version: q*scale before the
    product against scores/sqrt(d) after it, within 1e-5."""
    B, tq, F, H = 2, 32, 24, 3
    x, kv, wq, wk, wv, wo = _arrays((B, tq, F), (B, tk, F), (F, F), (F, F),
                                    (F, F), (F, 16), seed=9, scale=0.5)
    if tk == tq:
        kv = x
    m = (np.random.default_rng(10).random((B, tk)) < 0.75).astype(np.float32)
    m = m if mask else None
    want = np.asarray(jnn.multi_head_dot_product_attention(
        x, kv, kv, wq, wk, wv, wo, mask=m, num_heads=H))
    OpProfiler.get().reset()
    got = tnn.multi_head_dot_product_attention(
        *_t(x, kv, kv, wq, wk, wv, wo),
        mask=None if m is None else torch.from_numpy(m), num_heads=H).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert OpProfiler.get().get_counters() == {route: 1}


def test_layer_norm_matches_jax():
    x, g, b = _arrays((3, 5, 16), (16,), (16,), seed=12, scale=2.0)
    for eps in (1e-12, 1e-3):
        want = np.asarray(jnn.layer_norm(x, g, b, epsilon=eps))
        got = tnn.layer_norm(*_t(x, g, b), epsilon=eps).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# --- strided views, the output layout, the log-sum-exp -----------------------

VIEW_CASES = {
    # name: (B, H, T, D, causal, bias kind)
    "noncausal": (2, 3, 128, 32, False, None),
    "causal": (2, 3, 128, 32, True, None),
    "mask_bias": (2, 3, 128, 16, False, "mask"),
    "full_bias_causal": (1, 2, 128, 32, True, "full"),
}


@pytest.mark.parametrize("name", sorted(VIEW_CASES))
def test_permuted_views_match_contiguous_and_jax(name):
    """q, k, v as the MHA op hands them over (permuted views of [B, T, H,
    D] buffers) give what contiguous [B, H, T, D] inputs give (within
    1e-6: the matmuls may sum in another order), and match the JAX
    package's kernel in interpret mode within 1e-5."""
    B, H, T, D, causal, kind = VIEW_CASES[name]
    qkv = _arrays((B, T, H, D), (B, T, H, D), (B, T, H, D), seed=T + 3 * D)
    views = [torch.from_numpy(a).permute(0, 2, 1, 3) for a in qkv]
    assert not views[0].is_contiguous()
    contig = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in qkv]
    bias = _bias_for(kind, B, H, T, seed=6)
    tb = None if bias is None else torch.from_numpy(bias)
    got = attention.flash_attention(*views, causal=causal, bias=tb)
    ref = attention.flash_attention(*_t(*contig), causal=causal, bias=tb)
    assert (got - ref).abs().max().item() <= 1e-6
    want = np.asarray(jfa.flash_attention(*contig, causal=causal, bias=bias,
                                          interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_output_is_a_heads_view_so_the_merge_copies_nothing(dtype):
    """The result is a [B, H, T, D] view of a [B, T, H, D] buffer: the MHA
    op's head merge (permute back, reshape) is a view of it."""
    q, k, v = (t.to(dtype) for t in _t(*_arrays(*[(2, 4, 64, 16)] * 3,
                                                 seed=8)))
    out = attention.flash_attention(q, k, v)
    assert out.shape == (2, 4, 64, 16) and out.dtype == dtype
    merged = out.permute(0, 2, 1, 3)
    assert merged.is_contiguous()
    assert merged.reshape(2, 64, 64).data_ptr() == out.data_ptr()


LSE_CASES = {
    # name: (causal, bias kind, block_k)
    "plain": (False, None, 128),
    "causal_blocks_64": (True, None, 64),
    "full_bias": (False, "full", 128),
    "masked_row": (False, "masked_row", 64),
}


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_lse_matches_jax_row_stats(name):
    """The plain version's log-sum-exp against the JAX package's
    ``_row_stats`` (m where finite else 0, and l): ``m + log(max(l,
    1e-30))`` within 1e-6. A row masked everywhere gives log(1e-30), finite,
    in both."""
    causal, kind, bk = LSE_CASES[name]
    B, H, T, D = 1, 2, 128, 32
    q, k, v = _arrays(*[(B, H, T, D)] * 3, seed=14)
    bias = None
    if kind is not None:
        bias = _arrays((B, H, T, T), seed=15, scale=0.5)[0]
        if kind == "masked_row":
            bias[:, :, 7, :] = -np.inf
    scale = D ** -0.5
    _, lse = attention.flash_attention_reference(
        *_t(q, k, v), scale, causal,
        None if bias is None else torch.from_numpy(bias), bk, with_lse=True)
    m, l = jfa._row_stats(q.reshape(B * H, T, D), k.reshape(B * H, T, D),
                          scale, causal, bk,
                          None if bias is None else bias.reshape(B * H, T, T))
    want = np.asarray(m) + np.log(np.maximum(np.asarray(l), 1e-30))
    got = lse.reshape(B * H, T).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if kind == "masked_row":
        assert np.allclose(got[:, 7], np.log(np.float32(1e-30)))


def _bf16_ulp(w: np.ndarray) -> np.ndarray:
    """One bf16 ulp of each element of ``w`` (8 significant bits; 0 at 0)."""
    _, e = np.frexp(np.abs(w))
    return np.where(w == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_inputs_give_bf16_gradients_close_to_jax(causal):
    """bf16 q, k, v: the gradients come back in bf16 and match ``jax.grad``
    through the JAX op on the same bf16 inputs up to their own bf16
    rounding. Both packages compute the same thing: the inputs upcast to
    float32, a float32 forward, a backward that takes ``D = sum(dO * O)``
    from the float32 output (the port saves the output before its rounding
    to bf16, as the JAX package's residual is), and one rounding of each
    gradient to bf16. What differs is the order of the float32 sums (the
    port's k blocks of 64 and the forward's log-sum-exp against JAX's blocks
    and recomputed row statistics), which can move a value across a bf16
    rounding boundary. So each element is held to 1 bf16 ulp of itself plus
    2^-20 of the largest gradient (the float32 term: about 8 float32 ulp of
    the largest, for the sums' order, which shows on elements near 0)."""
    B, H, T, D = 1, 2, 128, 32
    q, k, v, tgt = _arrays(*[(B, H, T, D)] * 4, seed=16)
    jb = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]

    def loss_jax(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * tgt)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*jb)
    leaves = [t.bfloat16().requires_grad_() for t in _t(q, k, v)]
    out = attention.flash_attention(*leaves, causal=causal)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad((out.float() * torch.from_numpy(tgt)).sum(),
                              leaves)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        bound = _bf16_ulp(w) + 2.0 ** -20 * np.abs(w).max()
        excess = np.abs(g.float().numpy() - w) - bound
        assert excess.max() <= 0, excess.max()


def test_backward_takes_the_forwards_lse():
    """The backward builds p from the saved log-sum-exp: handed a shifted
    lse, its gradients move (p = exp(s - lse) scales by e), where a
    backward that recomputed the row statistics would not notice."""
    q, k, v, do = _t(*_arrays(*[(2, 64, 16)] * 4, seed=17))
    o, lse = attention.flash_attention_reference(q, k, v, 0.25, with_lse=True)
    g0 = attention.flash_attention_backward(q, k, v, o, do, lse, 0.25, False,
                                            64)
    g1 = attention.flash_attention_backward(q, k, v, o, do, lse - 1.0, 0.25,
                                            False, 64)
    assert not torch.allclose(g0[2], g1[2])
    torch.testing.assert_close(g1[2], g0[2] * np.e, rtol=1e-5, atol=1e-6)


# --- the float32 kernel's arithmetic (3xTF32), emulated -----------------------

#: the tolerance of the float32 kernel against its plain version on the card
#: (chip_smoke.py FA_TOL, tests/test_torch_kernel_cuda.py), that of
#: tests/test_pallas_attention.py's flash against dense
FA_TOL = 2e-5
LOG2E = 1.4426950408889634


def _tf32(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, the 13 low mantissa bits cleared. On the int32
    view of the sign-magnitude bits, adding half of the kept last place and
    clearing the rest rounds the magnitude half away from zero."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    b = (b + 0x1000) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _split(x):
    """hi = tf32(x), lo = tf32(x - hi): the kernel's operand split."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _emulate_f32_kernel(q, k, v, scale, causal=False, bias=None,
                        passes=3):
    """The float32 kernel's arithmetic in plain PyTorch, on ``[BH, T, D]``
    float32 (``bias`` None or ``[BH, T, T]``): q scaled, then q, k, v split
    into TF32 hi and lo parts; the kernel's 64-key tiles in order, each
    ``S = Ql Kh^T + Qh Kl^T + Qh Kh^T`` (small terms first; the lo * lo
    term dropped; products of TF32 values are exact in float32), the bias
    and masks, the online softmax with exp as 2^(x log2 e - safe log2 e),
    and ``O = alpha O + (Pl Vh + Ph Vl) + Ph Vh``; out as ``o`` times the
    reciprocal of ``max(l, 1e-30)``. ``passes=1`` keeps the hi products
    alone (one TF32 product, for contrast)."""
    qh, ql = _split(q * scale)
    kh, kl = _split(k)
    vh, vl = _split(v)
    BH, T, D = q.shape
    m = torch.full((BH, T), float("-inf"))
    l = torch.zeros(BH, T)
    o = torch.zeros(BH, T, D)
    zero = torch.zeros(())
    for k0 in range(0, T, attention.TILE):
        k1 = min(k0 + attention.TILE, T)
        kth, ktl = kh[:, k0:k1].transpose(1, 2), kl[:, k0:k1].transpose(1, 2)
        s = qh @ kth
        if passes == 3:
            s = (ql @ kth + qh @ ktl) + s
        if bias is not None:
            s = s + bias[:, :, k0:k1]
        if causal:
            qpos = torch.arange(T)[:, None]
            s = s.masked_fill(qpos < torch.arange(k0, k1)[None, :],
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.where(torch.isfinite(s), torch.exp2(
            s * LOG2E - (safe * LOG2E)[..., None]), zero)
        alpha = torch.where(torch.isfinite(m), torch.exp2(
            m * LOG2E - safe * LOG2E), zero)
        l = l * alpha + p.sum(-1)
        ph, pl = _split(p)
        pv = ph @ vh[:, k0:k1]
        if passes == 3:
            pv = (pl @ vh[:, k0:k1] + ph @ vl[:, k0:k1]) + pv
        o = o * alpha[..., None] + pv
        m = m_new
    return o * (1.0 / l.clamp_min(1e-30))[..., None]


def test_tf32_rounding_is_cvt_rna():
    """Ties go away from zero, below a tie toward the nearer value, for
    both signs; the low 13 bits are cleared; hi + lo is x to 2^-22."""
    ulp = 2.0 ** -10                          # TF32's last place at 1.0
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + 1.5 * ulp,
                      -(1 + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, 1.0, 1 + 2 * ulp, -(1 + ulp), 3.0, 0.0])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(_arrays((4096,), seed=21, scale=10.0)[0])
    hi, lo = _split(y)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - y).abs() <= 2.0 ** -22 * y.abs()).all()


EMULATION_CASES = {
    # name: (B, H, T, D, causal, bias kind); T a multiple of 128 runs the
    # JAX package's Pallas kernel in interpret mode, "tail" (T = 200, a
    # 64-key tile of 8 keys at the end) its dense dot_product_attention,
    # the forward it documents for T that its blocks do not divide
    "encoder_shape": (2, 3, 128, 64, False, None),
    "causal_full_bias": (1, 2, 256, 64, True, "full"),
    "d100_mask_bias": (2, 2, 128, 100, False, "mask"),
    "tail": (2, 2, 200, 32, False, "mask"),
}


@pytest.mark.parametrize("name", sorted(EMULATION_CASES))
def test_f32_kernel_arithmetic_holds_fa_tol_against_jax(name):
    """The float32 kernel's 3xTF32 arithmetic, emulated on the CPU, against
    the JAX package's forward within FA_TOL; one TF32 product alone is at
    least ten times further off, so the lo terms are what hold it."""
    B, H, T, D, causal, kind = EMULATION_CASES[name]
    q, k, v = _arrays((B, H, T, D), (B, H, T, D), (B, H, T, D), seed=T + D)
    bias = _bias_for(kind, B, H, T, seed=6)
    if name == "tail":
        keep = bias[:, :, :, :] == 0.0            # [B, 1, 1, T]
        want = np.asarray(jnn.dot_product_attention(q, k, v, mask=keep))
    else:
        want = np.asarray(jfa.flash_attention(q, k, v, causal=causal,
                                              bias=bias, interpret=True))
    bt = None
    if bias is not None:
        bt = torch.from_numpy(np.broadcast_to(bias, (B, H, T, T)).reshape(
            B * H, T, T).copy())
    qt, kt, vt = (torch.from_numpy(a).reshape(B * H, T, D) for a in (q, k, v))
    got = _emulate_f32_kernel(qt, kt, vt, D ** -0.5, causal, bt)
    one = _emulate_f32_kernel(qt, kt, vt, D ** -0.5, causal, bt, passes=1)
    want = torch.from_numpy(np.array(want)).reshape(B * H, T, D)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= FA_TOL
    assert (one - want).abs().max().item() >= 10 * err
