"""Embedding bag and the word2vec training rounds: skip-gram and CBOW, with
negative sampling or hierarchical softmax.

Counterpart of ``deeplearning4j_tpu/ops/embeddings.py``. The CUDA kernel
``csrc/embedding_bag.cu`` replaces its TPU kernel ``_bag_kernel`` (launched
by ``_bag_pallas``, ``deeplearning4j_tpu/ops/embeddings.py:69``). No Pallas
kernel backs the rounds there: their gathers, batched dots and scatter-adds
stay plain PyTorch operations here.

- :func:`embedding_bag` is the entry: the masked mean or sum of the W rows
  that each bag gathers. ``counts = max(mask.sum(1), 1)`` is computed once,
  as in the JAX package, and handed to the kernel or the plain version.
- :func:`embedding_bag_cuda` launches the kernel for CUDA tensors and never
  falls back; :func:`embedding_bag_reference` is the plain PyTorch version.
  Both accumulate in W order, ``acc = acc + row * mask`` from zero, then
  divide by the counts, rounding each step in the table's dtype, so they
  agree bit for bit.
  Indices are clamped to ``[0, V-1]`` in both (the JAX package's gather
  clamps too).
- Two routes, by the table's dtype, as the Pallas kernel runs in the
  table's dtype: float32, and bfloat16 (the mask and the counts in bf16
  too, the output bf16; every product, sum and quotient rounded to bf16, as
  the Pallas kernel's ``o_ref += row * mask`` stores each step in a bf16
  block). ``embedding_bag_launches`` counts both, ``embedding_bag_bf16_
  launches`` the bf16 route alone.
- The kernel is forward-only, as the Pallas one is: the CBOW rounds apply
  their updates by hand, under no gradient, and launch it. Where a
  gradient is needed through the table (or the mask), or the table is
  neither float32 nor bfloat16, :func:`embedding_bag` takes the plain
  version (``ops/routing.use_kernel``), which is differentiable, as the JAX op
  differentiates through its ``xla`` lowering; on the card that is counted
  under ``nlp/embedding_bag_plain_on_card``. :func:`embedding_bag_cuda`
  itself refuses a table that requires grad under grad mode.
- :func:`skipgram`, :func:`skipgram_hs`, :func:`cbow` and :func:`cbow_hs`
  are one training round each: ``_neg_round`` (logits clamped at +-6, the
  ascent direction pre-scaled by the learning rate, a monitoring loss) over
  negatives, or over the Huffman path with labels ``1 - code`` and the path
  mask applied to ``u`` and to ``grad_u``. CBOW's context rows get the exact
  gradient ``grad_h / counts`` (the JAX package's documented divergence from
  word2vec.c); its ``h`` is :func:`embedding_bag`'s masked mean.
- Mixed dtypes promote as in JAX: with bf16 tables the dot of ``h`` and
  ``u`` runs in bf16 (in float32 once the path mask has promoted ``u``),
  the gradients in float32 (the labels and the learning rate are float32),
  cast to bf16 by the scatter-add.

**In place.** The JAX rounds return new tables; here the rounds update
``syn0`` and ``syn1``/``syn1neg`` in place with ``index_add_`` (the
scatter-add branch of the JAX package's ``_table_add``; its one-hot matmul
branch is never selected there and is not ported). Both updates are
computed from the tables as they were before the round, as in the JAX
package. On the card ``index_add_`` sums duplicate rows with atomics, so the
order of the additions, and the last bits of a hot row, can differ from run
to run.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..common import nan_panic
from ..common.profiler import OpProfiler
from . import cuda_lib, routing

KERNEL_NAME = "embedding_bag"
SOURCE = "deeplearning4j_tpu_torch/csrc/embedding_bag.cu"
REPLACES = "deeplearning4j_tpu/ops/embeddings.py:69"

#: the table dtypes the kernel takes (its float32 and bf16 routes)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches made by :func:`embedding_bag_cuda` (and nothing else),
#: both routes; :data:`embedding_bag_bf16_launches` the bf16 route's alone
embedding_bag_launches = 0
embedding_bag_bf16_launches = 0
_LAUNCH_LOCK = threading.Lock()

# the reference's sigmoid table is clamped at +-MAX_EXP = 6
_MAX_EXP = 6.0
_EPS = 1e-7


def reset_launches() -> None:
    global embedding_bag_launches, embedding_bag_bf16_launches
    with _LAUNCH_LOCK:
        embedding_bag_launches = 0
        embedding_bag_bf16_launches = 0


def embedding_bag_reference(table: torch.Tensor, indices: torch.Tensor,
                            mask: torch.Tensor, counts: torch.Tensor,
                            mean: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``acc = acc + row * mask`` in W
    order from zero, then ``acc / counts`` for the mean, each operation in
    the table's dtype (so rounded to bf16 for a bf16 table). ``counts`` is
    ``[B, 1]`` (or ``[B]``)."""
    B, W = indices.shape
    idx = indices.clamp(0, table.shape[0] - 1)
    acc = torch.zeros((B, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for w in range(W):
        acc = acc + table.index_select(0, idx[:, w]) * mask[:, w, None]
    return acc / counts.reshape(B, 1) if mean else acc


def _check_args(table, indices, mask, counts) -> None:
    """Raise on what the kernel does not take, the device type aside (the
    caller checks that first)."""
    dt = table.dtype
    if dt is torch.bfloat16:
        if mask.dtype is not dt or counts.dtype is not dt:
            raise TypeError(f"the embedding_bag kernel's bf16 route takes "
                            f"the mask and the counts in bf16, not "
                            f"{mask.dtype} and {counts.dtype}")
    elif dt is not torch.float32:
        raise TypeError(f"the embedding_bag kernel takes a float32 or "
                        f"bfloat16 table, not {dt}")
    if table.dim() != 2 or not table.is_contiguous():
        raise ValueError(f"the embedding_bag kernel needs a contiguous "
                         f"[V, D] table, got shape {tuple(table.shape)}")
    if indices.dim() != 2:
        raise ValueError(f"indices must be [B, W], got "
                         f"{tuple(indices.shape)}")
    B, W = indices.shape
    dev = table.device
    for name, t, dtype, shape in (("indices", indices, torch.int32, (B, W)),
                                  ("mask", mask, dt, (B, W)),
                                  ("counts", counts, dt, (B,))):
        if (t.dtype is not dtype or t.device != dev or t.shape != shape
                or not t.is_contiguous()):
            raise ValueError(f"the embedding_bag kernel needs {name} as "
                             f"contiguous {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    V, D = table.shape
    if V == 0 and B * W > 0:
        raise ValueError("embedding_bag of an empty table")
    # (B * W and V * D stay below 2^62 in tensors of 2- and 4-byte elements)
    if D >= 2 ** 31 or W >= 2 ** 31:
        raise ValueError("tensor too large for the embedding_bag kernel")


def bind(fn):
    """``fn``, a C launch function of a loaded build
    (``dl4j_embedding_bag`` or ``dl4j_embedding_bag_bf16``), with its
    argument types set."""
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ll, i, i, ll, i, p]
    fn.restype = i
    return fn


#: the bound launch function of the float32 route and PyTorch's raw
#: current-stream getter, set at the first launch (neither exists before a
#: card is used); :data:`_LAUNCHER_BF16` the same for the bf16 route
_LAUNCHER = None
_LAUNCHER_BF16 = None


def _launcher(bf16: bool):
    global _LAUNCHER, _LAUNCHER_BF16
    if bf16:
        if _LAUNCHER_BF16 is None:
            _LAUNCHER_BF16 = (
                bind(cuda_lib.load(KERNEL_NAME).dl4j_embedding_bag_bf16),
                torch._C._cuda_getCurrentRawStream)
        return _LAUNCHER_BF16
    if _LAUNCHER is None:
        # an int, where torch.cuda.current_stream builds a Stream object
        _LAUNCHER = (bind(cuda_lib.load(KERNEL_NAME).dl4j_embedding_bag),
                     torch._C._cuda_getCurrentRawStream)
    return _LAUNCHER


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       mask: torch.Tensor, counts: torch.Tensor,
                       mean: bool) -> torch.Tensor:
    """Launch ``csrc/embedding_bag.cu`` on PyTorch's current stream: the
    float32 route for a float32 table, the bf16 route for a bf16 table
    (with a bf16 mask and counts). Raises on anything the kernel does not
    take (another dtype, a table that requires grad under grad mode), and
    when the launch fails.

    The host cost is kept low, since the CBOW round is host-bound: the
    cheapest checks first, the ctypes function bound once, the raw stream
    handle, and a device switch only when the table's card is not the
    current one. The kernel picks its vector width from D and the
    pointers' alignment."""
    global embedding_bag_launches, embedding_bag_bf16_launches
    _refuse_grad(table)
    if not table.is_cuda:
        raise ValueError(f"embedding_bag_cuda needs a CUDA table, got "
                         f"{table.device}")
    _check_args(table, indices, mask, counts)
    B, W = indices.shape
    V, D = table.shape
    out = table.new_empty((B, D))
    if B == 0 or D == 0:
        return out
    bf16 = table.dtype is torch.bfloat16
    fn, raw_stream = _launcher(bf16)
    device = table.get_device()
    args = (table.data_ptr(), indices.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), out.data_ptr(), B, W, D, V, int(mean))
    if device == torch.cuda.current_device():
        err = fn(*args, raw_stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, raw_stream(device))
    if err != 0:
        msg = cuda_lib.error_string(cuda_lib.load(KERNEL_NAME), err)
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError "
                           f"{err} ({msg})")
    with _LAUNCH_LOCK:
        embedding_bag_launches += 1
        if bf16:
            embedding_bag_bf16_launches += 1
    nan_panic.check_kernel(KERNEL_NAME, out)
    return out


def _refuse_grad(table: torch.Tensor) -> None:
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "embedding_bag is forward-only (its kernel has no backward, as "
            "the JAX package's Pallas kernel has none): call it under "
            "torch.no_grad() or on a table that does not require grad")


def _bag(table: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor,
         counts: torch.Tensor, mean: bool) -> torch.Tensor:
    """The kernel for a float32 or bfloat16 CUDA table when no gradient is
    needed; the plain version otherwise (``ops/routing.use_kernel``), on
    the card counted under ``nlp/embedding_bag_plain_on_card``."""
    if routing.use_kernel(table.device, table.dtype in KERNEL_DTYPES, table,
                          mask):
        return embedding_bag_cuda(table, indices, mask, counts.reshape(-1),
                                  mean)
    if table.is_cuda:
        OpProfiler.get().count("nlp/embedding_bag_plain_on_card")
    return embedding_bag_reference(table, indices, mask, counts, mean)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  mode: str = "mean") -> torch.Tensor:
    """Pooled embedding lookup: ``table [V, D]``, ``indices [B, W]``,
    optional ``mask [B, W]`` (0 = pad) -> ``[B, D]`` masked mean or sum of
    the gathered rows. Differentiable: a gradient takes the plain version
    (:func:`_bag`)."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"embedding_bag mode {mode!r}")
    if mask is None:
        mask = torch.ones(indices.shape, dtype=table.dtype,
                          device=table.device)
    mask = mask.to(table.dtype).contiguous()
    counts = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    return _bag(table, indices.to(torch.int32).contiguous(), mask, counts,
                mode == "mean")


def _table_add(table: torch.Tensor, idx: torch.Tensor,
               grads: torch.Tensor) -> None:
    """``table[idx] += grads`` in place, in the table's dtype; duplicate
    indices sum."""
    table.index_add_(0, idx, grads.to(table.dtype))


def _neg_round(h, u, labels, lr, pair_mask):
    """Shared NS/HS math: h [B,D] against u [B,K,D], labels [B,K].

    Returns (grad_h [B,D], grad_u [B,K,D], loss). The gradients are the
    ascent direction pre-scaled by ``lr`` (a 0-dim float32 tensor); the
    loss is the pair-masked mean binary cross-entropy, for monitoring. The
    dot runs in the promoted dtype of h and u, the gradients in g's (JAX's
    promotion; PyTorch's einsum wants equal dtypes)."""
    dt = torch.promote_types(h.dtype, u.dtype)
    logits = torch.einsum("bd,bkd->bk", h.to(dt), u.to(dt)).clamp(
        -_MAX_EXP, _MAX_EXP)
    sig = torch.sigmoid(logits)
    g = (labels - sig) * lr * pair_mask[:, None]
    grad_h = torch.einsum("bk,bkd->bd", g, u.to(g.dtype))
    grad_u = g[..., None] * h[:, None, :]
    xe = -(labels * torch.log(sig + _EPS)
           + (1 - labels) * torch.log(1 - sig + _EPS))
    denom = (pair_mask.sum() * labels.shape[1]).clamp_min(1.0)
    loss = (xe * pair_mask[:, None]).sum() / denom
    return grad_h, grad_u, loss


def _hs_labels(codes, path_mask, dtype):
    """HS labels per inner node, ``(1 - code) * path_mask`` (word2vec's
    convention), the code cast to the rows' dtype as JAX casts it."""
    return (1.0 - codes.to(dtype)) * path_mask


def skipgram(syn0: torch.Tensor, syn1neg: torch.Tensor,
             centers: torch.Tensor, targets: torch.Tensor,
             labels: torch.Tensor, lr: torch.Tensor,
             pair_mask: torch.Tensor) -> torch.Tensor:
    """One negative-sampling skip-gram round; updates ``syn0`` and
    ``syn1neg`` in place and returns the monitoring loss (a 0-dim tensor).

    centers [B] int32; targets [B,1+K] int32 (column 0 the true context,
    the rest negatives); labels [B,1+K] float32; lr a 0-dim float32 tensor;
    pair_mask [B] float32 zeroing padded pairs."""
    h = syn0[centers]
    u = syn1neg[targets]
    grad_h, grad_u, loss = _neg_round(h, u, labels, lr, pair_mask)
    _table_add(syn0, centers, grad_h)
    _table_add(syn1neg, targets.reshape(-1),
               grad_u.reshape(-1, syn0.shape[1]))
    return loss


def skipgram_hs(syn0: torch.Tensor, syn1: torch.Tensor,
                centers: torch.Tensor, points: torch.Tensor,
                codes: torch.Tensor, path_mask: torch.Tensor,
                lr: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
    """One hierarchical-softmax skip-gram round: points/codes/path_mask
    [B,L] are the context word's padded Huffman path. Updates in place,
    returns the monitoring loss."""
    h = syn0[centers]
    pm3 = path_mask[..., None]
    labels = _hs_labels(codes, path_mask, h.dtype)
    grad_h, grad_u, loss = _neg_round(h, syn1[points] * pm3, labels, lr,
                                      pair_mask)
    _table_add(syn0, centers, grad_h)
    _table_add(syn1, points.reshape(-1),
               (grad_u * pm3).reshape(-1, syn0.shape[1]))
    return loss


def _context_update(syn0, contexts, ctx_mask, counts, grad_h) -> None:
    """The exact gradient of the mean-forward loss, grad_h / |window|,
    spread over the context rows, where word2vec.c applies the whole hidden
    error to every context row (the JAX package's documented divergence:
    batched rounds sum many windows into one row, and the over-scaled update
    is unstable there)."""
    gctx = (grad_h / counts)[:, None, :] * ctx_mask[..., None]
    _table_add(syn0, contexts.reshape(-1), gctx.reshape(-1, syn0.shape[1]))


def _window_mean(syn0, contexts, ctx_mask, counts):
    """h, the masked mean of the context rows (:func:`embedding_bag`'s
    kernel), with the mask and the counts in the table's dtype as
    :func:`embedding_bag` takes them."""
    dt = syn0.dtype
    return _bag(syn0, contexts, ctx_mask.to(dt).contiguous(), counts.to(dt),
                True)


def cbow(syn0: torch.Tensor, syn1neg: torch.Tensor, contexts: torch.Tensor,
         ctx_mask: torch.Tensor, targets: torch.Tensor, labels: torch.Tensor,
         lr: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
    """One negative-sampling CBOW round; updates ``syn0`` and ``syn1neg``
    in place and returns the monitoring loss (a 0-dim tensor).

    contexts [B,W] int32 window word ids, ctx_mask [B,W] float32 (0 = pad);
    targets [B,1+K] (column 0 the center word, the rest negatives), labels
    [B,1+K]; lr a 0-dim float32 tensor; pair_mask [B] float32. h is the
    masked mean of the context rows (:func:`embedding_bag`)."""
    counts = ctx_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    h = _window_mean(syn0, contexts, ctx_mask, counts)
    u = syn1neg[targets]
    grad_h, grad_u, loss = _neg_round(h, u, labels, lr, pair_mask)
    _context_update(syn0, contexts, ctx_mask, counts, grad_h)
    _table_add(syn1neg, targets.reshape(-1),
               grad_u.reshape(-1, syn0.shape[1]))
    return loss


def cbow_hs(syn0: torch.Tensor, syn1: torch.Tensor, contexts: torch.Tensor,
            ctx_mask: torch.Tensor, points: torch.Tensor, codes: torch.Tensor,
            path_mask: torch.Tensor, lr: torch.Tensor,
            pair_mask: torch.Tensor) -> torch.Tensor:
    """One hierarchical-softmax CBOW round against the center word's
    Huffman path (points/codes/path_mask [B,L]); updates in place, returns
    the monitoring loss."""
    counts = ctx_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    h = _window_mean(syn0, contexts, ctx_mask, counts)
    pm3 = path_mask[..., None]
    labels = _hs_labels(codes, path_mask, h.dtype)
    grad_h, grad_u, loss = _neg_round(h, syn1[points] * pm3, labels, lr,
                                      pair_mask)
    _context_update(syn0, contexts, ctx_mask, counts, grad_h)
    _table_add(syn1, points.reshape(-1),
               (grad_u * pm3).reshape(-1, syn0.shape[1]))
    return loss


# --- row-sharded tables ---------------------------------------------------------------
#
# The JAX package's ``sharded_*`` helpers (``ops/embeddings.py:220-263``)
# run inside ``shard_map`` on one table shard and ``psum`` over the mesh
# axis. Here they take a sharded table as the list of its row shards (a
# ``common/tree.ShardedTensor``'s ``shards``), shard ``j`` holding rows
# ``[j*v, (j+1)*v)`` on its slot's device (``parallel/mesh.axis_slots``):
# a lookup gathers on every shard with the rows it does not own masked to
# zero and sums the shards' results in slot order (the psum: "the one real
# row plus zeros", so it is exact), an update adds into each shard only the
# rows it owns (the others get exact zeros at a clipped offset, as the JAX
# ``at[local].add`` of the masked gradient).


def sharded_local_offsets(shards, ids: torch.Tensor, j: int):
    """Global ids to (clipped local offsets, ownership mask) for shard
    ``j`` of ``shards``, on that shard's device, in the ids' integer dtype
    (``index_add_`` on the CPU accumulates a bf16 table's duplicates
    differently for int32 and int64 indices, so a sharded update keeps the
    unsharded one's)."""
    v_local = shards[j].shape[0]
    local = ids.to(shards[j].device) - j * v_local
    hit = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), hit


def sharded_rows_lookup(shards, ids: torch.Tensor, device=None):
    """Global ids ``[...]`` to (rows ``[..., D]`` on ``device``, default the
    ids' device; the per-shard ``(local, hit)``). Differentiable: the
    gradient reaches each shard's owned rows only."""
    dev = ids.device if device is None else torch.device(device)
    rows, aux = None, []
    for j, t in enumerate(shards):
        local, hit = sharded_local_offsets(shards, ids, j)
        part = (t[local] * hit[..., None].to(t.dtype)).to(dev)
        rows = part if rows is None else rows + part
        aux.append((local, hit))
    return rows, aux


def sharded_rows_add(shards, aux, grads: torch.Tensor) -> None:
    """In place: ``grads`` ``[N, D]`` added into the owned rows of each
    shard (duplicates sum), in the shard's dtype."""
    for t, (local, hit) in zip(shards, aux):
        g = grads.to(t.device) * hit.reshape(-1, 1).to(grads.dtype)
        t.index_add_(0, local.reshape(-1), g.to(t.dtype))


def sharded_skipgram(syn0_shards, syn1_shards, centers: torch.Tensor,
                     targets: torch.Tensor, labels: torch.Tensor,
                     lr: torch.Tensor, pair_mask: torch.Tensor
                     ) -> torch.Tensor:
    """:func:`skipgram` with syn0 and syn1neg as lists of row shards: the
    round runs on the ids' device from the assembled rows, and each shard
    takes only its own rows' updates, so the tables after the round are
    the unsharded round's."""
    h, aux_c = sharded_rows_lookup(syn0_shards, centers)
    b, k1 = targets.shape
    u_flat, aux_t = sharded_rows_lookup(syn1_shards, targets.reshape(-1))
    u = u_flat.reshape(b, k1, -1)
    grad_h, grad_u, loss = _neg_round(h, u, labels, lr, pair_mask)
    sharded_rows_add(syn0_shards, aux_c, grad_h)
    sharded_rows_add(syn1_shards, aux_t, grad_u.reshape(b * k1, -1))
    return loss


# --- the registry's nlp family ------------------------------------------------------
#
# The JAX package's five ``nlp`` ops with its signatures. The rounds there
# return new tables; these copy the tables, run the in-place round above on
# the copies and return ``(syn0, syn1, loss)``. ``dense`` (the JAX rounds'
# one-hot matmul update, the same sums) is accepted and changes nothing.

from .registry import op  # noqa: E402


def _lr(lr, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=torch.float32, device=like.device)


@op("embedding_bag", "nlp")
def embedding_bag_op(table, indices, mask=None, mode: str = "mean",
                     impl: Optional[str] = None):
    """:func:`embedding_bag`: the kernel for a CUDA table it takes with no
    gradient needed, its plain version otherwise (a table that requires
    grad differentiates on either device). ``impl`` (the JAX op's choice
    among its XLA and Pallas lowerings) has no meaning here and is
    ignored."""
    return embedding_bag(table, torch.as_tensor(indices,
                                                device=table.device),
                         mask, mode)


@op("skipgram", "nlp")
def skipgram_op(syn0, syn1neg, centers, targets, labels, lr, pair_mask,
                dense: bool = False):
    syn0, syn1neg = syn0.clone(), syn1neg.clone()
    loss = skipgram(syn0, syn1neg, centers, targets, labels, _lr(lr, syn0),
                    pair_mask)
    return syn0, syn1neg, loss


@op("skipgram_hs", "nlp")
def skipgram_hs_op(syn0, syn1, centers, points, codes, path_mask, lr,
                   pair_mask, dense: bool = False):
    syn0, syn1 = syn0.clone(), syn1.clone()
    loss = skipgram_hs(syn0, syn1, centers, points, codes, path_mask,
                       _lr(lr, syn0), pair_mask)
    return syn0, syn1, loss


@op("cbow", "nlp")
def cbow_op(syn0, syn1neg, contexts, ctx_mask, targets, labels, lr,
            pair_mask, dense: bool = False):
    syn0, syn1neg = syn0.clone(), syn1neg.clone()
    loss = cbow(syn0, syn1neg, contexts, ctx_mask, targets, labels,
                _lr(lr, syn0), pair_mask)
    return syn0, syn1neg, loss


@op("cbow_hs", "nlp")
def cbow_hs_op(syn0, syn1, contexts, ctx_mask, points, codes, path_mask, lr,
               pair_mask, dense: bool = False):
    syn0, syn1 = syn0.clone(), syn1.clone()
    loss = cbow_hs(syn0, syn1, contexts, ctx_mask, points, codes, path_mask,
                   _lr(lr, syn0), pair_mask)
    return syn0, syn1, loss
