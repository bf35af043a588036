"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``deeplearning4j_tpu_torch/_build/lib<name>.so`` at first use and loaded with
``ctypes``; pointers and the stream travel as ``c_void_p``. Nothing is built
when a module is imported, and nothing here runs for CPU tensors.

A library is rebuilt when its source is newer than the built file. Under
the persistent build cache (``DL4J_TPU_COMPILE_CACHE``,
``common/build_cache.py``) the libraries live in the cache's directory
instead, each under a name that carries the hash of its source, its flags
and ``nvcc``'s version, and a library found there is loaded without a
build. Builds of several sources run in parallel (one ``nvcc`` each,
:func:`build`). Every build and every check before a load holds the build
directory's ``.lock`` (``flock``), so processes started together (the ranks
of a process group) load what one of them built instead of compiling the
same sources at once. Every ``nvcc`` run is reported to
``common/tracecheck.note_compile`` (a kernel build inside a steady-state
region is a violation) and counted in :data:`nvcc_runs`.
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

from ..common import build_cache, tracecheck

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: compiler output of the last build of each library (``-Xptxas -v``:
#: registers, shared memory and spills per kernel)
BUILD_LOGS: Dict[str, str] = {}
#: ``nvcc`` runs of this process
nvcc_runs = 0


def source_path(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def build_dir() -> Path:
    """The build cache's directory, else the package's ``_build/``."""
    return build_cache.cache_dir() or BUILD_DIR


def library_path(name: str) -> Path:
    d = build_cache.cache_dir()
    if d is None:
        return BUILD_DIR / f"lib{name}.so"
    return d / build_cache.cached_name(f"lib{name}", source_path(name),
                                       FLAGS, nvcc_path())


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
    if build_cache.cache_dir() is not None:
        return lib.exists()          # the name carries the source's hash
    return (lib.exists()
            and lib.stat().st_mtime >= source_path(name).stat().st_mtime)


def _command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *FLAGS, "-o", str(out), str(source_path(name))]


def _build_lock():
    return build_cache.dir_lock(build_dir())


def build(names: Iterable[str], force: bool = False) -> Dict[str, float]:
    """Compile the named sources, all at once (one ``nvcc`` each), and
    return each build's wall time in seconds (0.0 when up to date). Raises
    with the compiler's output when one fails."""
    names = list(names)
    with _build_lock():
        return _build_locked(names, force)


def _build_locked(names: List[str], force: bool) -> Dict[str, float]:
    global nvcc_runs
    running = {}
    for name in names:
        if not force and _up_to_date(name):
            continue
        tmp = build_dir() / f"lib{name}.so.{os.getpid()}.tmp"
        tracecheck.note_compile(f"nvcc {name}")
        nvcc_runs += 1
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
            with _build_lock():
                if not _up_to_date(name):
                    _build_locked([name], False)
                lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> Optional[str]:
    fn = lib.dl4j_cuda_error_string
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    msg = fn(int(code))
    return msg.decode() if msg else None
