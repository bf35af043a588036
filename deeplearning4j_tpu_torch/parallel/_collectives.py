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

Across processes (``ParallelWrapper`` joined to a ``torch.distributed``
process group, one or more replicas a rank): :class:`ProcessGroupRoute`.
Its only collective is an ``all_gather`` of each rank's replicas' tensors
(packed into one flat buffer per dtype), after which every rank holds every
replica's tensor and sums them with :func:`_mean_into` in global replica
order, rank 0 first, exactly as one process does (in one process the
wrapper runs the same arithmetic over :class:`LocalRoute`, whose gather
hands the tensors back). An ``all_reduce(SUM)``
is not used: its order is the ring's, not rank 0 first, so a two-rank step
would not be bitwise the one-process two-replica step. The backend is
chosen by rule (``parallel/cluster.choose_backend``): gloo where ranks share
a card or run on the CPU (a CUDA tensor is staged through host memory
here, by the same rule), NCCL where each rank has its own card. The NCCL
route is written but has not run: the card machine has one card, and NCCL
refuses two ranks on one device (ROADMAP A7).
"""

from __future__ import annotations

import time
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
                        outs: Optional[Sequence[torch.Tensor]] = None,
                        only: Optional[Sequence[int]] = None,
                        devices: Optional[Sequence] = None
                        ) -> List[torch.Tensor]:
    """Replica ``r`` receives the mean over replicas of elements
    ``[r*shard, (r+1)*shard)``, on its own device (into ``outs[r]`` when
    given). ``only``: compute for these replicas alone (a rank's own, the
    rest of ``tensors`` gathered from its peers), on ``devices``."""
    res = []
    idx = list(range(len(tensors))) if only is None else list(only)
    for i, r in enumerate(idx):
        dev = devices[i] if devices is not None else tensors[r].device
        out = outs[i] if outs is not None else torch.empty(
            (shard,), dtype=tensors[r].dtype, device=dev)
        _mean_into(out, [u[r * shard:(r + 1) * shard] for u in tensors])
        res.append(out)
    return res


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


class LocalRoute:
    """The exchange's route inside one process: rank 0 of a world of one,
    its ``local`` replicas global replicas ``0..local-1``, and
    :meth:`gather` hands the replicas' tensors back as they are. The
    wrapper runs one arithmetic over it and over
    :class:`ProcessGroupRoute`."""

    rank, world, backend = 0, 1, None

    def __init__(self, local: int = 1):
        self.local = int(local)

    @property
    def lo(self) -> int:
        """The global index of this rank's first replica."""
        return self.rank * self.local

    @property
    def n_global(self) -> int:
        return self.world * self.local

    def gather(self, per_replica: Sequence[Sequence[torch.Tensor]]
               ) -> List[List[torch.Tensor]]:
        """``per_replica[j]`` is local replica ``j``'s list of tensors;
        returns one such list for each global replica, in global order."""
        return [list(p) for p in per_replica]


class ProcessGroupRoute(LocalRoute):
    """The cross-process half of the collectives, over the default
    ``torch.distributed`` group: ``world`` ranks of ``local`` replicas
    each, global replica ``rank * local + j`` for local replica ``j``.
    :meth:`gather` is the one collective. Its time is kept in four parts,
    on the host's clock, for the step's breakdown:

    - ``drain_seconds``: the card finishing this rank's queued work (the
      forward and backward), a ``torch.cuda.synchronize`` before anything
      else; not the exchange's;
    - ``stage_seconds``: gloo's copies of CUDA tensors to host memory and
      back;
    - ``wait_seconds``: a one-element ``all_gather`` before the payload's,
      which returns when the slowest rank has arrived: the wait for the
      peers;
    - ``transport_seconds``: the payload's ``all_gather`` proper.

    ``seconds`` is the exchange's share (stage, wait and transport)."""

    def __init__(self, local: int = 1):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "ProcessGroupRoute needs an initialized torch.distributed "
                "process group (parallel.distributed.initialize)")
        super().__init__(local)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.drain_seconds = 0.0
        self.stage_seconds = 0.0
        self.wait_seconds = 0.0
        self.transport_seconds = 0.0
        self.calls = 0

    @property
    def seconds(self) -> float:
        return self.stage_seconds + self.wait_seconds \
            + self.transport_seconds

    def gather(self, per_replica: Sequence[Sequence[torch.Tensor]]
               ) -> List[List[torch.Tensor]]:
        """As :meth:`LocalRoute.gather`, across the ranks: the same shapes
        and dtypes on every replica of every rank; this rank's own tensors
        come back as given, the other ranks' on local replica 0's device.
        One ``all_gather`` per dtype, after the one-element one."""
        import torch.distributed as dist

        clock = time.perf_counter
        dev = per_replica[0][0].device
        t0 = clock()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = clock()
        self.drain_seconds += t1 - t0
        # group the positions by dtype; one flat buffer per dtype
        order: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(per_replica[0]):
            order.setdefault(t.dtype, []).append(i)
        stage = self.backend == "gloo" and dev.type != "cpu"
        flats = {}
        for dtype, idx in order.items():
            flat = torch.cat([per_replica[j][i].reshape(-1).to(dev)
                              for j in range(self.local) for i in idx])
            flats[dtype] = flat.cpu() if stage else flat.contiguous()
        t2 = clock()
        probe = torch.zeros(1, device="cpu" if stage else dev)
        dist.all_gather([torch.empty_like(probe)
                         for _ in range(self.world)], probe)
        t3 = clock()
        got = {}
        for dtype, flat in flats.items():
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            dist.all_gather(parts, flat)
            got[dtype] = parts
        t4 = clock()
        out: List[List[Optional[torch.Tensor]]] = [
            [None] * len(per_replica[0]) for _ in range(self.n_global)]
        for dtype, idx in order.items():
            sizes = [per_replica[0][i].numel() for i in idx]
            per = sum(sizes)
            for r, part in enumerate(got[dtype]):
                if r == self.rank:
                    continue
                if stage:
                    part = part.to(dev)
                for j in range(self.local):
                    chunk = part[j * per:(j + 1) * per]
                    off = 0
                    for i, n in zip(idx, sizes):
                        out[r * self.local + j][i] = chunk[off:off + n] \
                            .view(per_replica[j][i].shape)
                        off += n
        if stage:
            torch.cuda.synchronize(dev)
        t5 = clock()
        for j in range(self.local):
            out[self.lo + j] = list(per_replica[j])
        self.stage_seconds += (t2 - t1) + (t5 - t4)
        self.wait_seconds += t3 - t2
        self.transport_seconds += t4 - t3
        self.calls += 1
        return out  # type: ignore[return-value]
