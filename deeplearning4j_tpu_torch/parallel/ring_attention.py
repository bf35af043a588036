"""Ring attention: the sequence split over a mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py`` (the Ring
Attention construction of Liu et al.). The sequence axis is cut into one
block per slot of the axis; each slot keeps its Q block and attends over
the K/V block it holds, then hands that block to the next slot of the ring,
N times, so every Q block sees the whole sequence while a slot holds one
K/V block at a time.

There the blocks are the shards of a ``shard_map`` and the rotation is a
``ppermute``. Here a ring is a list of per-slot tensors, each on its
slot's device: the rotation is a rotation of the list with ``Tensor.to``
copies (slot ``i`` receives slot ``i-1``'s block,
``parallel/_collectives.rotate``), and the output is joined in slot order.
Every step is plain autograd arithmetic, so the ring is differentiable end
to end.

Numerics are the JAX block step's (``_block_attend``): an online softmax
with a running max and normalizer, the guards for a fully masked block
(max ``-inf``) included; a causal mask uses global block offsets. No Pallas
kernel backs the ring in the JAX package (its block step is einsums), and
none backs it here. Neither package registers the ring with the
executable census (``common/xprof.py`` has no site for it).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..common.dtypes import tensor_from_numpy
from ._collectives import rotate
from .mesh import Mesh, axis_slots


def _block_attend(q, k, v, bias_fn, m_prev, l_prev, o_prev):
    """One online-softmax step over a K/V block: q ``[B, Tq, H, D]``, k/v
    ``[B, Tk, H, D]``, the running (m, l, o) of the blocks before."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.sqrt(
        torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device))
    logits = bias_fn(logits)
    m_blk = logits.amax(dim=-1)                            # [B, H, Tq]
    m_new = torch.maximum(m_prev, m_blk)
    # a fully masked block has max -inf: exp(-inf - -inf) would be nan
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    safe_m = torch.where(torch.isfinite(m_new), m_new, zero)
    p = torch.exp(logits - safe_m[..., None])
    p = torch.where(torch.isfinite(logits), p, zero)
    scale = torch.where(torch.isfinite(m_prev), torch.exp(m_prev - safe_m),
                        zero)
    l_new = l_prev * scale + p.sum(dim=-1)
    o_new = o_prev * scale[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q: Sequence[torch.Tensor], k: Sequence[torch.Tensor],
                   v: Sequence[torch.Tensor],
                   causal: bool = False) -> List[torch.Tensor]:
    """Blockwise ring attention over per-slot blocks: ``q[i]``, ``k[i]``,
    ``v[i]`` are slot ``i``'s ``[B, T/N, H, D]`` blocks on its device
    (block ``i`` of the sequence). Returns each slot's ``[B, T/N, H, D]``
    output on its device."""
    n = len(q)
    b, t_local, h, d = q[0].shape
    devs = [t.device for t in q]
    dtype = q[0].dtype

    def bias_for(i: int, kv_idx: int):
        if not causal:
            return lambda logits: logits
        q_pos = i * t_local + torch.arange(t_local, device=devs[i])
        k_pos = kv_idx * t_local + torch.arange(t_local, device=devs[i])
        mask = q_pos[:, None] >= k_pos[None, :]               # [Tq, Tk]
        neg = torch.tensor(torch.finfo(dtype).min, dtype=dtype,
                           device=devs[i])
        return lambda logits: torch.where(mask[None, None], logits, neg)

    m = [torch.full((b, h, t_local), float("-inf"), dtype=dtype, device=dv)
         for dv in devs]
    l = [torch.zeros((b, h, t_local), dtype=dtype, device=dv) for dv in devs]
    o = [torch.zeros((b, h, t_local, d), dtype=dtype, device=dv)
         for dv in devs]
    k_blk, v_blk, kv_idx = list(k), list(v), list(range(n))
    for step in range(n):
        for i in range(n):
            m[i], l[i], o[i] = _block_attend(q[i], k_blk[i], v_blk[i],
                                             bias_for(i, kv_idx[i]),
                                             m[i], l[i], o[i])
        if step < n - 1:          # the last rotation would be discarded
            k_blk, v_blk = rotate(k_blk), rotate(v_blk)
            kv_idx = [(j - 1) % n for j in kv_idx]
    return [(o[i] / l[i][..., None].clamp_min(1e-30)).permute(0, 2, 1, 3)
            for i in range(n)]


def ring_self_attention(x, wq, wk, wv, wo, n_heads: int, mesh: Mesh,
                        seq_axis: str = "data", causal: bool = False):
    """Multi-head self-attention with the sequence split over ``seq_axis``:
    the projections run locally on each slot (they are position-wise), the
    attention core is :func:`ring_attention`. ``x`` ``[B, T, F]`` (T
    divisible by the axis size), numpy or a tensor; returns ``[B, T,
    n_out]`` on ``x``'s device (the CPU for numpy)."""
    x, wq, wk, wv, wo = (a if isinstance(a, torch.Tensor)
                         else tensor_from_numpy(a)
                         for a in (x, wq, wk, wv, wo))
    slots = axis_slots(mesh, seq_axis)
    n = len(slots)
    b, T, _ = x.shape
    if T % n:
        raise ValueError(f"sequence length {T} does not split over the "
                         f"{n} slots of {seq_axis!r}")
    t = T // n
    qs, ks, vs, ws = [], [], [], []
    for i, slot in enumerate(slots):
        dev = slot.device
        xb = x[:, i * t:(i + 1) * t].to(dev)
        w = [a.to(dev) for a in (wq, wk, wv, wo)]

        def proj(wm):
            return torch.einsum("btf,fd->btd", xb, wm).reshape(
                b, t, n_heads, -1)

        qs.append(proj(w[0]))
        ks.append(proj(w[1]))
        vs.append(proj(w[2]))
        ws.append(w[3])
    ctx = ring_attention(qs, ks, vs, causal=causal)
    outs = [torch.einsum("btd,do->bto", c.reshape(b, t, -1), w).to(x.device)
            for c, w in zip(ctx, ws)]
    return torch.cat(outs, dim=1)
