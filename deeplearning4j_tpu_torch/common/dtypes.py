"""Data type table: DL4J dtype names to torch dtypes.

Counterpart of ``deeplearning4j_tpu/common/dtypes.py``. The canonical names
("float32", "bfloat16", ...) are the ones configurations carry
(``GlobalConf.dtype``, ``compute_dtype``).
"""

from __future__ import annotations

import enum
import warnings

import numpy as np
import torch


class DataType(enum.Enum):
    FLOAT = "float32"
    DOUBLE = "float64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    BOOL = "bool"

    def to_torch(self) -> torch.dtype:
        return _TORCH[self.value]


_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """Resolve a dtype name (or a torch dtype) to a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _TORCH[str(name)]
    except KeyError:
        raise TypeError(f"no torch dtype for {name!r}; known: "
                        f"{sorted(_TORCH)}") from None


_NAMES = {v: k for k, v in _TORCH.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The canonical name of a torch dtype ("float32", "bfloat16", ...):
    numpy's spelling, which the flat bucket keys (``flat::<name>``) use."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no canonical name for {dtype}") from None


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy → torch (on ``device`` when given), including
    ``ml_dtypes.bfloat16`` arrays (which torch cannot read directly: they
    are reinterpreted through uint16). A 0-d array stays 0-d. Read-only
    memory (e.g. a view of a graph's bytes) is copied once: into a CPU
    tensor of its own, or straight to the card."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    on_cpu = device is None or torch.device(device).type == "cpu"
    if not a.flags.writeable and on_cpu:
        a = a.copy()      # torch tensors over read-only memory are unsafe
    bf16 = a.dtype.name == "bfloat16"
    with warnings.catch_warnings():
        # read-only memory bound for the card: the copy there only reads it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a.view(np.uint16) if bf16 else a)
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device) if device is not None else t
