"""Embedding bag and the negative-sampling CBOW round.

Counterpart of ``deeplearning4j_tpu/ops/embeddings.py`` for the CBOW
negative-sampling path. The CUDA kernel ``csrc/embedding_bag.cu`` replaces
its TPU kernel ``_bag_kernel`` (launched by ``_bag_pallas``,
``deeplearning4j_tpu/ops/embeddings.py:69``).

- :func:`embedding_bag` is the entry: the masked mean or sum of the W rows
  that each bag gathers. ``counts = max(mask.sum(1), 1)`` is computed once,
  as in the JAX package, and handed to the kernel or the plain version.
- :func:`embedding_bag_cuda` launches the kernel for CUDA tensors and never
  falls back; :func:`embedding_bag_reference` is the plain PyTorch version,
  used for CPU tensors and by the checks on the card. Both accumulate in W
  order, ``acc = acc + row * mask`` from zero, then divide by the counts,
  rounding each step, so they agree bit for bit. Indices are clamped to
  ``[0, V-1]`` in both (the JAX package's gather clamps too).
- The kernel is forward-only, as the Pallas one is: the CBOW round applies
  its updates by hand. :func:`embedding_bag` refuses a table that requires
  grad while grad mode is on.
- :func:`cbow` is one negative-sampling CBOW round (``_neg_round``, the
  exact gradient ``grad_h / counts`` spread over the window, the JAX
  package's documented divergence from word2vec.c).

**In place.** The JAX rounds return new tables; here :func:`cbow` updates
``syn0`` and ``syn1neg`` in place with ``index_add_`` (the scatter-add
branch of the JAX package's ``_table_add``; its one-hot matmul branch is
never selected there and is not ported). Both updates are computed from
the tables as they were before the round, as in the JAX package. On the
card ``index_add_`` sums duplicate rows with atomics, so the order of the
additions, and the last bits of a hot row, can differ from run to run.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import cuda_lib

KERNEL_NAME = "embedding_bag"
SOURCE = "deeplearning4j_tpu_torch/csrc/embedding_bag.cu"
REPLACES = "deeplearning4j_tpu/ops/embeddings.py:69"

#: kernel launches made by :func:`embedding_bag_cuda` (and nothing else)
embedding_bag_launches = 0
_LAUNCH_LOCK = threading.Lock()

# the reference's sigmoid table is clamped at +-MAX_EXP = 6
_MAX_EXP = 6.0
_EPS = 1e-7


def reset_launches() -> None:
    global embedding_bag_launches
    with _LAUNCH_LOCK:
        embedding_bag_launches = 0


def embedding_bag_reference(table: torch.Tensor, indices: torch.Tensor,
                            mask: torch.Tensor, counts: torch.Tensor,
                            mean: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``acc = acc + row * mask`` in W
    order from zero, then ``acc / counts`` for the mean. ``counts`` is
    ``[B, 1]`` (or ``[B]``)."""
    B, W = indices.shape
    idx = indices.clamp(0, table.shape[0] - 1)
    acc = torch.zeros((B, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for w in range(W):
        acc = acc + table.index_select(0, idx[:, w]) * mask[:, w, None]
    return acc / counts.reshape(B, 1) if mean else acc


def _check_cuda_args(table, indices, mask, counts) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag_cuda needs a CUDA table, got "
                         f"{table.device}")
    if table.dtype != torch.float32:
        raise TypeError(f"the embedding_bag kernel takes a float32 table, "
                        f"not {table.dtype}")
    if table.ndim != 2 or not table.is_contiguous():
        raise ValueError(f"the embedding_bag kernel needs a contiguous "
                         f"[V, D] table, got shape {tuple(table.shape)}")
    if indices.ndim != 2:
        raise ValueError(f"indices must be [B, W], got "
                         f"{tuple(indices.shape)}")
    B, W = indices.shape
    for name, t, dtype, shape in (("indices", indices, torch.int32, (B, W)),
                                  ("mask", mask, torch.float32, (B, W)),
                                  ("counts", counts, torch.float32, (B,))):
        if (t.dtype != dtype or t.device != table.device
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"the embedding_bag kernel needs {name} as "
                             f"contiguous {dtype} {shape} on {table.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if table.shape[0] == 0 and B * W > 0:
        raise ValueError("embedding_bag of an empty table")
    if B * W >= 2 ** 62 or table.numel() >= 2 ** 62 or table.shape[1] >= 2 ** 31:
        raise ValueError("tensor too large for the embedding_bag kernel")


def _bind(lib: ctypes.CDLL):
    fn = lib.dl4j_embedding_bag
    if fn.argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, ll, i, i, ll, i, i, p]
        fn.restype = i
    return fn


def embedding_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                       mask: torch.Tensor, counts: torch.Tensor,
                       mean: bool) -> torch.Tensor:
    """Launch ``csrc/embedding_bag.cu`` on PyTorch's current stream. Raises
    on anything the kernel does not take (a table other than float32, a
    table that requires grad under grad mode), and when the launch fails."""
    global embedding_bag_launches
    _refuse_grad(table)
    _check_cuda_args(table, indices, mask, counts)
    B, W = indices.shape
    V, D = table.shape
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load(KERNEL_NAME)
    fn = _bind(lib)
    vec = int(D % 4 == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), indices.data_ptr(), mask.data_ptr(),
                 counts.data_ptr(), out.data_ptr(), B, W, D, V, int(mean),
                 vec, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError "
                           f"{err} ({cuda_lib.error_string(lib, err)})")
    with _LAUNCH_LOCK:
        embedding_bag_launches += 1
    return out


def _refuse_grad(table: torch.Tensor) -> None:
    if table.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            "embedding_bag is forward-only (its kernel has no backward, as "
            "the JAX package's Pallas kernel has none): call it under "
            "torch.no_grad() or on a table that does not require grad")


def _bag(table: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor,
         counts: torch.Tensor, mean: bool) -> torch.Tensor:
    """The plain version for a CPU table, the kernel for a CUDA table."""
    if table.device.type == "cpu":
        return embedding_bag_reference(table, indices, mask, counts, mean)
    if table.device.type == "cuda":
        return embedding_bag_cuda(table, indices, mask, counts.reshape(-1),
                                  mean)
    raise ValueError(f"embedding_bag has no implementation for "
                     f"{table.device}")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  mode: str = "mean") -> torch.Tensor:
    """Pooled embedding lookup: ``table [V, D]``, ``indices [B, W]``,
    optional ``mask [B, W]`` (0 = pad) -> ``[B, D]`` masked mean or sum of
    the gathered rows. Forward-only."""
    if mode not in ("mean", "sum"):
        raise ValueError(f"embedding_bag mode {mode!r}")
    _refuse_grad(table)
    if mask is None:
        mask = torch.ones(indices.shape, dtype=table.dtype,
                          device=table.device)
    mask = mask.to(table.dtype).contiguous()
    counts = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    return _bag(table, indices.to(torch.int32).contiguous(), mask, counts,
                mode == "mean")


def _table_add(table: torch.Tensor, idx: torch.Tensor,
               grads: torch.Tensor) -> None:
    """``table[idx] += grads`` in place; duplicate indices sum."""
    table.index_add_(0, idx, grads.to(table.dtype))


def _neg_round(h, u, labels, lr, pair_mask):
    """Shared NS math: h [B,D] against u [B,K,D], labels [B,K] in {0,1}.

    Returns (grad_h [B,D], grad_u [B,K,D], loss). The gradients are the
    ascent direction pre-scaled by ``lr`` (a 0-dim float32 tensor); the
    loss is the pair-masked mean binary cross-entropy, for monitoring."""
    logits = torch.einsum("bd,bkd->bk", h, u).clamp(-_MAX_EXP, _MAX_EXP)
    sig = torch.sigmoid(logits)
    g = (labels - sig) * lr * pair_mask[:, None]
    grad_h = torch.einsum("bk,bkd->bd", g, u)
    grad_u = g[..., None] * h[:, None, :]
    xe = -(labels * torch.log(sig + _EPS)
           + (1 - labels) * torch.log(1 - sig + _EPS))
    denom = (pair_mask.sum() * labels.shape[1]).clamp_min(1.0)
    loss = (xe * pair_mask[:, None]).sum() / denom
    return grad_h, grad_u, loss


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
    h = _bag(syn0, contexts, ctx_mask, counts, True)
    u = syn1neg[targets]
    grad_h, grad_u, loss = _neg_round(h, u, labels, lr, pair_mask)
    d = syn0.shape[1]
    # the exact gradient of the mean-forward loss, grad_h / |window|, where
    # word2vec.c applies the whole hidden error to every context row (the
    # JAX package's documented divergence: batched rounds sum many windows
    # into one row, and the over-scaled update is unstable there)
    gctx = (grad_h / counts)[:, None, :] * ctx_mask[..., None]
    _table_add(syn0, contexts.reshape(-1), gctx.reshape(-1, d))
    _table_add(syn1neg, targets.reshape(-1), grad_u.reshape(-1, d))
    return loss
