"""Device meshes for data-, model- and pipeline-parallel training.

Counterpart of ``deeplearning4j_tpu/parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` over the chips, and a replica is a shard of one SPMD
program. Here a mesh is a grid of :class:`DeviceSlot` s, and a replica is a
copy of the training state that lives on its slot's device
(``parallel/wrapper.py``).

A slot is a place in a device pool, not a device: a pool may name one
device more than once. That is how several replicas share one card (the
wrapper's ``Builder.devices``), and how the CPU stands in for a pool of
devices: :func:`device_pool` on the CPU is the CPU device :data:`CPU_POOL`
times, the counterpart of the JAX test harness's 8 virtual CPU devices
(``tests/conftest.py``), which PyTorch has no flag for. Slots compare by
their place in the pool, so an elastic resize can exclude a lost replica's
slot while its device still serves the other slots.

Axis convention as in the JAX package: ``data`` (batch), ``model``
(tensor parallelism, row-sharded tables), ``stage`` (pipeline stages).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..common.dtypes import tensor_from_numpy
from ..common.environment import resolve_device

#: the size of the CPU device pool (the JAX test harness's virtual devices)
CPU_POOL = 8


class DeviceSlot:
    """Place ``index`` of a device pool, on ``device``."""

    __slots__ = ("index", "device")

    def __init__(self, index: int, device) -> None:
        self.index = int(index)
        self.device = torch.device(device)

    def __eq__(self, other) -> bool:
        return (isinstance(other, DeviceSlot) and other.index == self.index
                and other.device == self.device)

    def __hash__(self) -> int:
        return hash((self.index, str(self.device)))

    def __repr__(self) -> str:
        return f"DeviceSlot({self.index}, {self.device})"


def as_slots(devices: Sequence) -> List[DeviceSlot]:
    """Slots for a list of devices (``torch.device``, strings or slots);
    repeats are allowed and each entry is its own slot."""
    return [d if isinstance(d, DeviceSlot) else DeviceSlot(i, d)
            for i, d in enumerate(devices)]


def device_pool(device=None) -> List[DeviceSlot]:
    """The devices a mesh is cut from: every visible card (``device`` None
    or a CUDA device; raises without a card), or the CPU device
    :data:`CPU_POOL` times (``device`` a CPU device)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return as_slots([dev] * CPU_POOL)
    if dev.type != "cuda":
        raise ValueError(f"no device pool for {dev}")
    return as_slots([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])


class Mesh:
    """A grid of device slots, one axis per name: ``(data, model)``
    (:func:`make_mesh`) or ``(data, stage)`` (:func:`make_pipeline_mesh`)."""

    def __init__(self, devices: np.ndarray,
                 axis_names=("data", "model")) -> None:
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: :func:`device_pool`
    of the card); ``data=None`` takes every device left."""
    devs = as_slots(devices) if devices is not None else device_pool()
    if data is None:
        if len(devs) % model:
            raise ValueError(f"{len(devs)} devices not divisible by "
                             f"model={model}")
        data = len(devs) // model
    n = data * model
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    arr = np.empty((n,), dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(data, model))


def make_pipeline_mesh(data: int, stages: int,
                       devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, stage)`` mesh for pipeline-parallel training
    (``parallel/pipeline.py``): stage columns hold the layer runs, the
    data axis replicates the pipeline over batch shards. Its own
    constructor, as in the JAX package, because the stage axis resizes by
    remap, not by the data-axis elastic resize."""
    devs = as_slots(devices) if devices is not None else device_pool()
    data, stages = int(data), int(stages)
    if data < 1 or stages < 1:
        raise ValueError(f"need data >= 1 and stages >= 1, got "
                         f"({data}, {stages})")
    n = data * stages
    if n > len(devs):
        raise ValueError(f"need {n} devices for a ({data} x {stages}) "
                         f"pipeline mesh, have {len(devs)}")
    arr = np.empty((n,), dtype=object)
    for i, d in enumerate(devs[:n]):
        arr[i] = d
    return Mesh(arr.reshape(data, stages), ("data", "stage"))


def axis_slots(mesh: Mesh, axis: str) -> List[DeviceSlot]:
    """The slots along ``axis``, at place 0 of every other axis: the
    shards of a table row-sharded over ``axis``, or the blocks of a
    sequence split over it."""
    if axis not in mesh.axis_names:
        raise ValueError(f"{axis!r} is not a mesh axis of "
                         f"{mesh.axis_names}")
    k = mesh.axis_names.index(axis)
    idx = tuple(slice(None) if i == k else 0
                for i in range(mesh.devices.ndim))
    return list(mesh.devices[idx])


def elastic_pool(mesh: Mesh, exclude: Sequence = (),
                 devices: Optional[Sequence] = None) -> List[DeviceSlot]:
    """The slots an elastic resize picks from: the mesh's surviving slots
    first, then every other slot of ``devices`` (default: the pool of the
    mesh's first device), with ``exclude`` left out throughout."""
    excl = set(exclude)
    pool = [d for d in mesh.devices.flat if d not in excl]
    if devices is None:
        first = next(iter(mesh.devices.flat))
        devices = device_pool(first.device)
    for d in as_slots(devices):
        if d not in excl and d not in pool:
            pool.append(d)
    return pool


def serving_devices(workers: int,
                    devices: Optional[Sequence] = None) -> List[DeviceSlot]:
    """Round-robin slots for ``workers`` serving replicas: one per device
    while there are enough, shared beyond that."""
    devs = as_slots(devices) if devices is not None else device_pool()
    if not devs:
        raise ValueError("no devices available for serving replicas")
    return [devs[i % len(devs)] for i in range(max(1, int(workers)))]


def serving_capacity(devices: Optional[Sequence] = None) -> int:
    """Serving replicas the pool holds before they only share devices."""
    devs = as_slots(devices) if devices is not None else device_pool()
    return max(1, len(devs))


def probe_device(slot) -> bool:
    """A round-trip to the device (a write, a reduction, a synchronising
    read): True when it answers with finite data."""
    dev = slot.device if isinstance(slot, DeviceSlot) else torch.device(slot)
    try:
        x = torch.ones((2,), dtype=torch.float32, device=dev)
        return bool(torch.isfinite(x.sum()).item())
    except Exception:
        return False


def _split(a, n: int, slots: Sequence[DeviceSlot]):
    """``a`` (numpy or tensor) as ``n`` leading-axis pieces, each on its
    slot's device; from pinned host memory on a card."""
    if a is None:
        return [None] * n
    if isinstance(a, dict):
        parts = {k: _split(v, n, slots) for k, v in a.items()}
        return [{k: p[r] for k, p in parts.items()} for r in range(n)]
    t = a if isinstance(a, torch.Tensor) else tensor_from_numpy(a)
    if t.shape[0] % n:
        raise ValueError(f"a leading axis of {t.shape[0]} does not split "
                         f"over {n} replicas")
    rows = t.shape[0] // n
    out = []
    for r, slot in enumerate(slots):
        piece = t[r * rows:(r + 1) * rows]
        dev = slot.device
        if dev.type == "cuda" and piece.device.type == "cpu":
            piece = piece.contiguous().pin_memory().to(dev, non_blocking=True)
        else:
            piece = piece.to(dev)
        out.append(piece)
    return out


def shard_batch(mesh: Mesh, *arrays):
    """Split each array (numpy, tensor, None, or a dict of them) along its
    leading axis over the mesh's data axis: one piece per replica, copied
    to its replica's device (pinned, non-blocking on a card). The whole
    batch is never placed on a device first. Returns one list of pieces per
    array (just the list for one array)."""
    slots = list(mesh.devices[:, 0])
    out = tuple(_split(a, len(slots), slots) for a in arrays)
    return out if len(out) > 1 else out[0]
