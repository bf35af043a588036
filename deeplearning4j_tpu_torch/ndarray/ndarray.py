"""NDArray: the INDArray analog, a mutable handle over tensors.

Counterpart of ``deeplearning4j_tpu/ndarray/ndarray.py`` (reference nd4j-api
``org.nd4j.linalg.api.ndarray.{INDArray, BaseNDArray}``), with its contract:

- in-place arithmetic (``addi``, ``muli``, ``assign``, ...) replaces the
  handle's tensor;
- a *view* (indexing, ``get``, ``slice_view``, ``tensor_along_dimension``)
  holds its base and an index; reading it indexes the base, and a write to
  it writes through to the base, up any chain of views (fancy and boolean
  indices too);
- ``reshape``, ``ravel``, ``permute`` and ``transpose`` return fresh arrays,
  *not* views: PyTorch would give views there, the port copies, so a write
  to the result never reaches the source, as in the JAX package.

Writes are functional, as the JAX class's scatter-updates are: a write makes
a new tensor (a clone with the index set) and swaps it in, so a tensor once
handed out by ``value`` never changes under its holder. The tensors stay on
their device; nothing is copied to the host but by ``to_numpy``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ..common.dtypes import DataType, dtype_name, tensor_from_numpy

IndexSpec = Union[int, slice, Tuple[Any, ...], torch.Tensor]


def _as_tensor(value, dtype: Optional[torch.dtype] = None,
               device=None) -> torch.Tensor:
    if isinstance(value, NDArray):
        value = value.value
    if isinstance(value, torch.Tensor):
        t = value
    elif isinstance(value, np.ndarray):
        t = tensor_from_numpy(value)
    else:
        t = torch.as_tensor(np.asarray(value))
    if dtype is not None or device is not None:
        t = t.to(device=device if device is not None else t.device,
                 dtype=dtype if dtype is not None else t.dtype)
    return t


def _normalize_shape(shape) -> Tuple[int, ...]:
    """Accept both f(2, 3) and f((2, 3)) varargs-shape call styles."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(shape)


def _clean_idx(idx):
    """Unwrap NDArray (fancy/boolean) indices to tensors."""
    if isinstance(idx, NDArray):
        return idx.value
    if isinstance(idx, tuple):
        return tuple(i.value if isinstance(i, NDArray) else i for i in idx)
    return idx


def _with_index_set(t: torch.Tensor, idx, new) -> torch.Tensor:
    out = t.clone()
    out[idx] = new
    return out


class NDArray:
    """Mutable tensor handle. ``.value`` is the current tensor."""

    __slots__ = ("_value", "_base", "_idx")

    def __init__(self, value, base: Optional["NDArray"] = None,
                 idx: Optional[IndexSpec] = None):
        self._base = base
        self._idx = idx
        self._value = None if base is not None else _as_tensor(value)

    # --- buffer access -------------------------------------------------
    @property
    def value(self) -> torch.Tensor:
        if self._base is not None:
            return self._base.value[self._idx]
        return self._value

    def _set_value(self, new: torch.Tensor) -> None:
        if self._base is not None:
            self._base._write(self._idx, new)
        else:
            self._value = new

    def _write(self, idx: IndexSpec, new: torch.Tensor) -> None:
        if self._base is not None:
            self._base._write(self._idx, _with_index_set(self.value, idx,
                                                         new))
        else:
            self._value = _with_index_set(self._value, idx, new)

    def _like(self, other) -> torch.Tensor:
        """``other`` as a tensor of this array's dtype on its device."""
        return _as_tensor(other, self.dtype, self.device)

    def _operand(self, other) -> torch.Tensor:
        return _as_tensor(other, device=self.device) \
            if isinstance(other, (NDArray, torch.Tensor, np.ndarray)) \
            else other

    @property
    def is_view(self) -> bool:
        return self._base is not None

    # --- metadata ------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def rank(self) -> int:
        return self.value.ndim

    @property
    def ndim(self) -> int:
        return self.value.ndim

    @property
    def device(self) -> torch.device:
        return self.value.device

    def length(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def data_type(self) -> DataType:
        return DataType(dtype_name(self.value.dtype))

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    def is_scalar(self) -> bool:
        return self.value.ndim == 0 or self.length() == 1

    def is_vector(self) -> bool:
        return self.rank == 1 or (self.rank == 2 and 1 in self.shape)

    def is_matrix(self) -> bool:
        return self.rank == 2

    def rows(self) -> int:
        return self.shape[0]

    def columns(self) -> int:
        return self.shape[1]

    # --- conversion ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        return self.value.detach().cpu().numpy()

    def dup(self) -> "NDArray":
        return NDArray(self.value.clone())

    def cast(self, dtype) -> "NDArray":
        dt = dtype.to_torch() if isinstance(dtype, DataType) else dtype
        if not isinstance(dt, torch.dtype):
            dt = DataType(np.dtype(dt).name).to_torch()
        return NDArray(self.value.to(dt))

    def astype(self, dtype) -> "NDArray":
        return self.cast(dtype)

    # --- scalar access -------------------------------------------------
    def get_double(self, *indices: int) -> float:
        return float(self.value[tuple(indices)] if indices else self.value)

    def get_int(self, *indices: int) -> int:
        return int(self.value[tuple(indices)] if indices else self.value)

    def get_scalar(self, *indices: int) -> "NDArray":
        return NDArray(self.value[tuple(indices)].clone())

    def put_scalar(self, indices, value) -> "NDArray":
        if isinstance(indices, int):
            indices = (indices,)
        self._write(tuple(indices), self._like(value))
        return self

    # --- views ---------------------------------------------------------
    def __getitem__(self, idx) -> "NDArray":
        return NDArray(None, base=self, idx=_clean_idx(idx))

    def __setitem__(self, idx, value) -> None:
        self._write(_clean_idx(idx), self._like(value))

    def get(self, idx) -> "NDArray":
        """View via index (INDArray.get(INDArrayIndex...) analog)."""
        return self[idx]

    def slice_view(self, i: int, dim: int = 0) -> "NDArray":
        idx = tuple([slice(None)] * dim + [i])
        return self[idx]

    def tensor_along_dimension(self, index: int, *dims: int) -> "NDArray":
        """TAD analog: the index-th subtensor spanning ``dims``."""
        dims = tuple(d % self.rank for d in dims)
        other = [d for d in range(self.rank) if d not in dims]
        counts = [self.shape[d] for d in other]
        sub = np.unravel_index(index, counts) if counts else ()
        idx: list = [slice(None)] * self.rank
        for d, i in zip(other, sub):
            idx[d] = int(i)
        return self[tuple(idx)]

    def assign(self, other) -> "NDArray":
        self._set_value(torch.broadcast_to(self._like(other),
                                           self.shape).clone())
        return self

    # --- shape ops (fresh arrays; see module docstring) ----------------
    def reshape(self, *shape) -> "NDArray":
        return NDArray(self.value.reshape(_normalize_shape(shape)).clone())

    def ravel(self) -> "NDArray":
        return NDArray(self.value.reshape(-1).clone())

    def permute(self, *dims) -> "NDArray":
        return NDArray(self.value.permute(_normalize_shape(dims))
                       .contiguous().clone())

    def transpose(self) -> "NDArray":
        return NDArray(self.value.permute(
            tuple(reversed(range(self.rank)))).contiguous().clone())

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    def broadcast(self, *shape) -> "NDArray":
        return NDArray(torch.broadcast_to(self.value,
                                          _normalize_shape(shape)).clone())

    def repeat(self, repeats: int, axis: int) -> "NDArray":
        return NDArray(torch.repeat_interleave(self.value, repeats, dim=axis))

    # --- arithmetic: pure ----------------------------------------------
    def add(self, other) -> "NDArray":
        return NDArray(self.value + self._operand(other))

    def sub(self, other) -> "NDArray":
        return NDArray(self.value - self._operand(other))

    def mul(self, other) -> "NDArray":
        return NDArray(self.value * self._operand(other))

    def div(self, other) -> "NDArray":
        return NDArray(self.value / self._operand(other))

    def rsub(self, other) -> "NDArray":
        return NDArray(self._operand(other) - self.value)

    def rdiv(self, other) -> "NDArray":
        return NDArray(self._operand(other) / self.value)

    def neg(self) -> "NDArray":
        return NDArray(-self.value)

    def mmul(self, other) -> "NDArray":
        return NDArray(self.value @ self._operand(other))

    # --- arithmetic: in-place (the DL4J `i` suffix family) -------------
    def _inplace(self, new: torch.Tensor) -> "NDArray":
        self._set_value(new.to(self.dtype))
        return self

    def addi(self, other) -> "NDArray":
        return self._inplace(self.value + self._operand(other))

    def subi(self, other) -> "NDArray":
        return self._inplace(self.value - self._operand(other))

    def muli(self, other) -> "NDArray":
        return self._inplace(self.value * self._operand(other))

    def divi(self, other) -> "NDArray":
        return self._inplace(self.value / self._operand(other))

    def rsubi(self, other) -> "NDArray":
        return self._inplace(self._operand(other) - self.value)

    def rdivi(self, other) -> "NDArray":
        return self._inplace(self._operand(other) / self.value)

    def negi(self) -> "NDArray":
        return self._inplace(-self.value)

    # --- python operators ----------------------------------------------
    __add__ = add
    __sub__ = sub
    __mul__ = mul
    __truediv__ = div
    __matmul__ = mmul
    __neg__ = neg

    def __radd__(self, other):
        return NDArray(self._operand(other) + self.value)

    def __rsub__(self, other):
        return self.rsub(other)

    def __rmul__(self, other):
        return NDArray(self._operand(other) * self.value)

    def __rtruediv__(self, other):
        return self.rdiv(other)

    def __pow__(self, p):
        return NDArray(self.value ** p)

    def __lt__(self, other):
        return NDArray(self.value < self._operand(other))

    def __le__(self, other):
        return NDArray(self.value <= self._operand(other))

    def __gt__(self, other):
        return NDArray(self.value > self._operand(other))

    def __ge__(self, other):
        return NDArray(self.value >= self._operand(other))

    def eq(self, other):
        return NDArray(self.value == self._operand(other))

    def neq(self, other):
        return NDArray(self.value != self._operand(other))

    # Elementwise like numpy — NDArray is consequently unhashable.
    __eq__ = eq
    __ne__ = neq
    __hash__ = None

    # --- reductions ----------------------------------------------------
    def _reduce(self, fn, dims, keepdims=False, **kw) -> "NDArray":
        if dims:
            return NDArray(fn(self.value, dim=dims, keepdim=keepdims, **kw))
        return NDArray(fn(self.value, **kw))

    def sum(self, *dims, keepdims: bool = False) -> "NDArray":
        return self._reduce(torch.sum, dims, keepdims)

    def mean(self, *dims, keepdims: bool = False) -> "NDArray":
        return self._reduce(torch.mean, dims, keepdims)

    def std(self, *dims, keepdims: bool = False,
            bias_corrected: bool = True) -> "NDArray":
        return self._reduce(torch.std, dims, keepdims,
                            correction=1 if bias_corrected else 0)

    def var(self, *dims, keepdims: bool = False,
            bias_corrected: bool = True) -> "NDArray":
        return self._reduce(torch.var, dims, keepdims,
                            correction=1 if bias_corrected else 0)

    def max(self, *dims, keepdims: bool = False) -> "NDArray":
        return self._reduce(torch.amax, dims, keepdims)

    def min(self, *dims, keepdims: bool = False) -> "NDArray":
        return self._reduce(torch.amin, dims, keepdims)

    def prod(self, *dims, keepdims: bool = False) -> "NDArray":
        out = self.value
        for d in sorted((d % self.rank for d in dims), reverse=True):
            out = torch.prod(out, dim=d, keepdim=keepdims)
        return NDArray(out if dims else torch.prod(self.value))

    def argmax(self, *dims) -> "NDArray":
        return NDArray(torch.argmax(self.value, dim=dims[0] if dims
                                    else None))

    def argmin(self, *dims) -> "NDArray":
        return NDArray(torch.argmin(self.value, dim=dims[0] if dims
                                    else None))

    def cumsum(self, dim: int = 0) -> "NDArray":
        return NDArray(torch.cumsum(self.value, dim=dim))

    def norm1(self, *dims) -> "NDArray":
        a = torch.abs(self.value)
        return NDArray(torch.sum(a, dim=dims) if dims else torch.sum(a))

    def norm2(self, *dims) -> "NDArray":
        a = torch.square(self.value)
        return NDArray(torch.sqrt(torch.sum(a, dim=dims) if dims
                                  else torch.sum(a)))

    def norm_max(self, *dims) -> "NDArray":
        a = torch.abs(self.value)
        return NDArray(torch.amax(a, dim=dims) if dims else torch.amax(a))

    # --- comparisons ----------------------------------------------------
    def equals_to(self, other, eps: float = 1e-5) -> bool:
        """Equal shapes and every element within ``eps``, compared in
        float64 (so values beyond float32's precision stay apart)."""
        other_v = _as_tensor(other, device=self.device)
        if tuple(other_v.shape) != self.shape:
            return False
        return bool(torch.all(torch.abs(self.value.to(torch.float64)
                                        - other_v.to(torch.float64)) <= eps))

    def __repr__(self) -> str:
        return (f"NDArray(shape={self.shape}, dtype={self.dtype}, "
                f"view={self.is_view})\n{self.to_numpy()}")

    def __len__(self) -> int:
        return self.shape[0]

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        a = self.to_numpy()
        return a.astype(dtype) if dtype is not None else a
