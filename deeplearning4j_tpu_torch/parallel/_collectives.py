"""Collectives over per-replica tensors, one process.

The JAX wrapper exchanges gradients with ``pmean``, ``psum_scatter`` and
``all_gather`` over the mesh's ``data`` axis (``parallel/wrapper.py:
260-285``). Here the replicas are tensors in one process, one per replica,
each on its replica's device, and a collective is plain tensor arithmetic:

- every sum runs in a FIXED replica order (replica 0 first) on the
  receiving replica's device, with the other replicas' tensors brought over
  by ``Tensor.to``, and is then divided by the replica count, as
  ``pmean`` and ``psum_scatter(...) / n`` do. The mean all-reduce and the
  mean reduce-scatter therefore do the same arithmetic per element, so a
  ZeRO-1 step is bitwise the dense step on the same replica count
  (the JAX package's contract, ``wrapper.py:164-168``), by construction;
- the division is by a tensor holding the count, so it is a true division
  on the card too (a division by a Python number there is a multiplication
  by its reciprocal, which is not exact for 3);
- receivers on one device share one result (the sum is the same bits
  whichever replica asks for it).

The model-parallel tier (``ring_attention.py``, ``pipeline.py``,
``sharding.apply_tp``, the row-sharded tables) uses the rest: a
``ppermute`` to the next neighbour is :func:`rotate` (a rotation of the
per-slot list), an ``all_gather`` is :func:`concat_to` (a concatenation in
slot order), a ``psum`` over the model axis is :func:`sum_to`.

NCCL (``torch.distributed`` or ``torch.cuda.nccl``) is not used yet: it
waits for the first run on four cards, where it can be measured against
these copies (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

_COUNTS: Dict[tuple, torch.Tensor] = {}


def _count(n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``n`` as a 0-dim tensor of ``dtype`` on ``device``, made once by a
    fill (no host-to-device copy)."""
    key = (n, dtype, str(device))
    t = _COUNTS.get(key)
    if t is None:
        t = torch.full((), n, dtype=dtype, device=device)
        _COUNTS[key] = t
    return t


def _mean_into(out: torch.Tensor, parts: Sequence[torch.Tensor]) -> None:
    """``out = (((p0 + p1) + p2) + ...) / n`` on ``out``'s device."""
    dev = out.device
    out.copy_(parts[0])
    for p in parts[1:]:
        out.add_(p.to(dev, non_blocking=True))
    out.div_(_count(len(parts), out.dtype, dev))


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over replicas, for each replica on its own device (one
    result per device, shared by the replicas there)."""
    by_dev: Dict[str, torch.Tensor] = {}
    out = []
    for t in tensors:
        key = str(t.device)
        if key not in by_dev:
            res = torch.empty_like(t)
            _mean_into(res, tensors)
            by_dev[key] = res
        out.append(by_dev[key])
    return out


def reduce_scatter_mean(tensors: Sequence[torch.Tensor], shard: int,
                        outs: Optional[Sequence[torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """Replica ``r`` receives the mean over replicas of elements
    ``[r*shard, (r+1)*shard)``, on its own device (into ``outs[r]`` when
    given)."""
    res = []
    for r, t in enumerate(tensors):
        out = outs[r] if outs is not None else torch.empty(
            (shard,), dtype=t.dtype, device=t.device)
        _mean_into(out, [u[r * shard:(r + 1) * shard] for u in tensors])
        res.append(out)
    return res


def all_gather_(buckets: Sequence[torch.Tensor], shard: int) -> None:
    """In place: every replica's bucket receives element range
    ``[r*shard, (r+1)*shard)`` from replica ``r``'s bucket."""
    n = len(buckets)
    for j, dst in enumerate(buckets):
        for r in range(n):
            if r != j:
                dst[r * shard:(r + 1) * shard].copy_(
                    buckets[r][r * shard:(r + 1) * shard], non_blocking=True)


def all_gather_scalars(values: Sequence[torch.Tensor]) -> torch.Tensor:
    """One value per replica, stacked ``[n]`` on the first replica's
    device."""
    dev = values[0].device
    return torch.stack([v.to(dev) for v in values])


def sum_to(values: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """The sum of per-replica tensors in replica order, on ``device``
    (default: the first replica's)."""
    dev = values[0].device if device is None else device
    acc = values[0].to(dev, copy=True)
    for v in values[1:]:
        acc = acc + v.to(dev)
    return acc


def rotate(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ring step of a ``ppermute`` to the next neighbour: slot ``i``
    receives slot ``i-1``'s tensor (slot 0 the last one's), on its own
    device. Differentiable."""
    n = len(tensors)
    return [tensors[(i - 1) % n].to(tensors[i].device) for i in range(n)]


def concat_to(tensors: Sequence[torch.Tensor], dim: int = 0,
              device=None) -> torch.Tensor:
    """The ``all_gather`` of per-slot pieces: concatenated along ``dim`` in
    slot order on ``device`` (default: the first piece's)."""
    dev = tensors[0].device if device is None else device
    return torch.cat([t.to(dev) for t in tensors], dim=dim)
