"""Process-wide environment singleton: device selection and the TF32 policy.

Counterpart of ``deeplearning4j_tpu/common/environment.py``. The port runs
on the card by default:

- ``resolve_device(None)`` is ``cuda`` when a card is present and RAISES
  otherwise; it never falls back to the CPU silently.
- ``resolve_device("cpu")`` is the CPU, for tests and for callers that ask.

TF32 policy (stated and set explicitly, both off by default):

- ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's own default);
- ``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's default is True,
  which would run float32 convolutions with about three decimal digits).

So a float32 model computes in full float32, as the JAX reference does on the
CPU. Mixed precision is asked for explicitly with ``compute_dtype``
("bfloat16"), never obtained silently through TF32. ``set_tf32(True)`` turns
both on for callers that want the speed.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


class Environment:
    _instance: Optional["Environment"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.set_tf32(False)

    @classmethod
    def get(cls) -> "Environment":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def set_tf32(self, enabled: bool) -> None:
        """Set both TF32 switches (cuBLAS matmuls and cuDNN convolutions)."""
        torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
        torch.backends.cudnn.allow_tf32 = bool(enabled)

    @staticmethod
    def tf32_flags() -> Dict[str, bool]:
        return {"cuda.matmul.allow_tf32":
                bool(torch.backends.cuda.matmul.allow_tf32),
                "cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32)}

    def resolve_device(self, device: DeviceLike = None) -> torch.device:
        """The device an entry point runs on: the card unless the caller
        asked for another. Raises when the card is wanted but absent."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "deeplearning4j_tpu_torch runs on a CUDA card by default "
                    "and none is available; pass device='cpu' to run on the "
                    "CPU explicitly")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        return dev


def resolve_device(device: DeviceLike = None) -> torch.device:
    return Environment.get().resolve_device(device)
