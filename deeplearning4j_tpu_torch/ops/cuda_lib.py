"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``deeplearning4j_tpu_torch/_build/lib<name>.so`` at first use and loaded with
``ctypes``; pointers and the stream travel as ``c_void_p``. Nothing is built
when a module is imported, and nothing here runs for CPU tensors.

A library is rebuilt when its source is newer than the built file. Builds of
several sources run in parallel (one ``nvcc`` each, :func:`build`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output of the last build of each library (``-Xptxas -v``:
#: registers, shared memory and spills per kernel)
BUILD_LOGS: Dict[str, str] = {}


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _up_to_date(name: str) -> bool:
    lib = library_path(name)
    return (lib.exists()
            and lib.stat().st_mtime >= source_path(name).stat().st_mtime)


def _command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(source_path(name))]


def build(names: Iterable[str], force: bool = False) -> Dict[str, float]:
    """Compile the named sources, all at once (one ``nvcc`` each), and
    return each build's wall time in seconds (0.0 when up to date). Raises
    with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        if not force and _up_to_date(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    times = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {source_path(name)} "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("\n".join(failures))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _up_to_date(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> Optional[str]:
    fn = lib.dl4j_cuda_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    msg = fn(int(code))
    return msg.decode() if msg else None
