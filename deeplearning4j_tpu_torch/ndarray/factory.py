"""Array factory: the ``Nd4j`` static-factory analog.

Counterpart of ``deeplearning4j_tpu/ndarray/factory.py`` (reference nd4j-api
``org.nd4j.linalg.factory.Nd4j``: create/zeros/ones/rand/randn/arange/
linspace/valueArrayOf/eye/concat/stack/gemm/write/read). Every creator takes
``device``: the card unless the caller asks for another (``device="cpu"``).
``dtype`` is a :class:`DataType`, a torch dtype or a numpy name; by default
``Environment.default_dtype()`` (``DL4J_TPU_DTYPE``, float32 when unset). ``write``/``read`` are the JAX package's file format byte for byte
(numpy's ``.npy``), so a file written by either package reads in the other.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..common.dtypes import DataType, tensor_from_numpy, torch_dtype
from ..common.environment import Environment, resolve_device
from .ndarray import NDArray, _as_tensor, _normalize_shape
from .rng import get_random


def _dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch_dtype(Environment.get().default_dtype())
    if isinstance(dtype, DataType):
        return dtype.to_torch()
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch_dtype(np.dtype(dtype).name)


def create(data=None, shape: Optional[Sequence[int]] = None, dtype=None,
           device=None) -> NDArray:
    """Nd4j.create analog: from data, or zero-filled by shape."""
    dt, dev = _dtype(dtype), resolve_device(device)
    if data is None:
        if shape is None:
            raise ValueError("create() needs data or shape")
        return NDArray(torch.zeros(tuple(shape), dtype=dt, device=dev))
    if isinstance(data, (NDArray, torch.Tensor)):
        t = _as_tensor(data, dt, dev)
    else:
        a = np.asarray(data)
        t = tensor_from_numpy(a.astype(np.float64) if a.dtype == object
                              else a).to(device=dev, dtype=dt)
    if shape is not None:
        t = t.reshape(tuple(shape))
    return NDArray(t.clone() if isinstance(data, (NDArray, torch.Tensor))
                   else t)


def zeros(*shape, dtype=None, device=None) -> NDArray:
    return NDArray(torch.zeros(_normalize_shape(shape), dtype=_dtype(dtype),
                               device=resolve_device(device)))


def ones(*shape, dtype=None, device=None) -> NDArray:
    return NDArray(torch.ones(_normalize_shape(shape), dtype=_dtype(dtype),
                              device=resolve_device(device)))


def zeros_like(arr) -> NDArray:
    return NDArray(torch.zeros_like(_as_tensor(arr)))


def ones_like(arr) -> NDArray:
    return NDArray(torch.ones_like(_as_tensor(arr)))


def value_array_of(shape: Sequence[int], value, dtype=None,
                   device=None) -> NDArray:
    return NDArray(torch.full(tuple(shape), value, dtype=_dtype(dtype),
                              device=resolve_device(device)))


def scalar(value, dtype=None, device=None) -> NDArray:
    return NDArray(torch.tensor(value, dtype=_dtype(dtype),
                                device=resolve_device(device)))


def eye(n: int, dtype=None, device=None) -> NDArray:
    return NDArray(torch.eye(n, dtype=_dtype(dtype),
                             device=resolve_device(device)))


def arange(*args, dtype=None, device=None) -> NDArray:
    return NDArray(torch.arange(*args, dtype=_dtype(dtype),
                                device=resolve_device(device)))


def linspace(start, stop, num: int, dtype=None, device=None) -> NDArray:
    return NDArray(torch.linspace(start, stop, num, dtype=_dtype(dtype),
                                  device=resolve_device(device)))


def rand(*shape, dtype=None, device=None) -> NDArray:
    return get_random().uniform(_normalize_shape(shape), dtype=_dtype(dtype),
                                device=device)


def randn(*shape, dtype=None, device=None) -> NDArray:
    return get_random().gaussian(_normalize_shape(shape),
                                 dtype=_dtype(dtype), device=device)


def concat(dim: int, *arrays) -> NDArray:
    return NDArray(torch.cat([_as_tensor(a) for a in arrays], dim=dim))


def stack(dim: int, *arrays) -> NDArray:
    return NDArray(torch.stack([_as_tensor(a) for a in arrays], dim=dim))


def hstack(*arrays) -> NDArray:
    return concat(-1, *arrays)


def vstack(*arrays) -> NDArray:
    return concat(0, *arrays)


def tile(arr, *reps) -> NDArray:
    return NDArray(torch.tile(_as_tensor(arr), _normalize_shape(reps)))


def where(cond, x, y) -> NDArray:
    c = _as_tensor(cond)
    return NDArray(torch.where(c, _as_tensor(x, device=c.device),
                               _as_tensor(y, device=c.device)))


def sort(arr, dim: int = -1, descending: bool = False) -> NDArray:
    s = torch.sort(_as_tensor(arr), dim=dim, stable=True).values
    if descending:
        s = torch.flip(s, dims=(dim,))
    return NDArray(s)


def gemm(a, b, transpose_a: bool = False, transpose_b: bool = False,
         alpha: float = 1.0, beta: float = 0.0, c=None) -> NDArray:
    """BLAS gemm analog (reference MmulHelper): ``alpha * op(a) @ op(b) +
    beta * c``."""
    av, bv = _as_tensor(a), _as_tensor(b)
    if transpose_a:
        av = av.T
    if transpose_b:
        bv = bv.T
    out = alpha * (av @ bv)
    if c is not None and beta != 0.0:
        out = out + beta * _as_tensor(c, device=out.device)
    return NDArray(out)


def matmul(a, b) -> NDArray:
    return NDArray(_as_tensor(a) @ _as_tensor(b))


def write(arr: NDArray, path: str) -> None:
    """Nd4j.write analog: numpy's ``.npy`` container."""
    np.save(path, arr.to_numpy())


def read(path: str, device=None) -> NDArray:
    return NDArray(tensor_from_numpy(np.load(path),
                                     resolve_device(device)))
