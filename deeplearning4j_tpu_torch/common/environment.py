"""Process-wide environment singleton: device selection, the TF32 policy and
the framework's switches.

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

The switches read the JAX package's environment variables, so one shell
setting drives both packages:

- ``DL4J_TPU_DEBUG``, ``DL4J_TPU_VERBOSE``, ``DL4J_TPU_DETERMINISTIC``:
  stored flags (``is_debug`` ...), read by user code;
- ``DL4J_TPU_DTYPE``: the factories' default dtype (``ndarray/factory.py``),
  float32 when unset;
- ``DL4J_TPU_ALLOW_PALLAS``: on by default; off, the flash route of
  ``ops/nn.multi_head_dot_product_attention`` is not taken (the JAX flag
  gates the Pallas flash kernel, and only that);
- ``DL4J_TPU_COMPILE_CACHE``: the persistent build cache, the directory
  where the kernels of ``csrc/`` and the native helper are built and found
  (:func:`enable_compilation_cache`).

``set_check_nan(True)`` is NAN_PANIC (``common/nan_panic.py``): the first
operation whose floating-point output holds a NaN raises
``FloatingPointError`` naming it.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional, Union

import torch

from . import build_cache

DeviceLike = Union[str, torch.device, None]


class Environment:
    _instance: Optional["Environment"] = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.set_tf32(False)
        self._debug = _env_bool("DL4J_TPU_DEBUG", False)
        self._verbose = _env_bool("DL4J_TPU_VERBOSE", False)
        self._profiling = False
        self._deterministic = _env_bool("DL4J_TPU_DETERMINISTIC", False)
        self._default_dtype = os.environ.get("DL4J_TPU_DTYPE", "float32")
        self._allow_pallas = _env_bool("DL4J_TPU_ALLOW_PALLAS", True)
        self._properties: Dict[str, Any] = {}

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

    # --- flags ---------------------------------------------------------------
    def is_debug(self) -> bool:
        return self._debug

    def set_debug(self, v: bool) -> None:
        self._debug = bool(v)

    def is_verbose(self) -> bool:
        return self._verbose

    def set_verbose(self, v: bool) -> None:
        self._verbose = bool(v)

    def is_profiling(self) -> bool:
        """True while ``OpProfiler`` traces (its ``start`` .. ``stop``)."""
        return self._profiling

    def set_profiling(self, v: bool) -> None:
        self._profiling = bool(v)

    def is_check_nan(self) -> bool:
        from . import nan_panic

        return nan_panic.enabled()

    def set_check_nan(self, v: bool) -> None:
        """NAN_PANIC: while on, the first operation on any device whose
        floating-point output holds a NaN raises ``FloatingPointError``
        naming the operation (an aten op, or one of the hand-written
        kernels). Turned on, the check holds on this thread and on the
        port's worker threads; each check is a sync with the card. Off, no
        path carries any of it (``common/nan_panic.py``)."""
        from . import nan_panic

        nan_panic.set_enabled(bool(v))

    def is_deterministic(self) -> bool:
        return self._deterministic

    def set_deterministic(self, v: bool) -> None:
        self._deterministic = bool(v)

    def allow_pallas(self) -> bool:
        """The JAX package's name for "the flash attention kernel may
        run": off, ``multi_head_dot_product_attention`` takes its dense
        route. The three other kernels do not read it."""
        return self._allow_pallas

    def set_allow_pallas(self, v: bool) -> None:
        self._allow_pallas = bool(v)

    def default_dtype(self) -> str:
        return self._default_dtype

    def set_default_dtype(self, name: str) -> None:
        self._default_dtype = name

    def compile_cache_dir(self) -> Optional[str]:
        """The build cache in force (``DL4J_TPU_COMPILE_CACHE`` or
        :meth:`set_compile_cache`), None for the package's ``_build/``."""
        d = build_cache.cache_dir()
        return None if d is None else str(d)

    def set_compile_cache(self, path: str,
                          min_compile_secs: float = 1.0) -> str:
        """Build and find the kernel libraries in ``path`` (see
        :func:`enable_compilation_cache`)."""
        return enable_compilation_cache(path, min_compile_secs)

    # --- device info -----------------------------------------------------------
    def devices(self) -> List[torch.device]:
        """The CUDA devices of this process (none without a card)."""
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]

    def num_devices(self) -> int:
        return len(self.devices())

    def is_tpu(self) -> bool:
        return False

    # --- generic key/value (ND4JSystemProperties analog) -----------------------
    def set_property(self, key: str, value: Any) -> None:
        self._properties[key] = value

    def get_property(self, key: str, default: Any = None) -> Any:
        return self._properties.get(key, default)


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def enable_compilation_cache(path: Optional[str] = None,
                             min_compile_secs: float = 1.0) -> str:
    """Build the kernels of ``csrc/`` and the native helper into ``path``
    and look them up there: the counterpart of the JAX package's persistent
    executable cache (compile once per machine, not once per checkout).

    ``path`` defaults to ``$DL4J_TPU_COMPILE_CACHE`` or ``.torch_cache``
    under the current working directory; returns the directory used.
    Unset, the libraries go to the package's own ``_build/``. In a cache
    directory a library's file name carries a hash of its source, its
    compiler flags and the compiler's version, so processes of several
    checkouts share it and never load a library of another source.

    ``min_compile_secs`` is accepted for the JAX signature. JAX keeps only
    executables that took at least that long to compile; every library here
    takes seconds to build, so every one is kept.
    """
    path = (path or os.environ.get("DL4J_TPU_COMPILE_CACHE")
            or os.path.join(os.getcwd(), ".torch_cache"))
    os.makedirs(path, exist_ok=True)
    path = os.path.abspath(path)
    build_cache.set_cache_dir(path)
    return path


def resolve_device(device: DeviceLike = None) -> torch.device:
    return Environment.get().resolve_device(device)
