"""Native host helpers (C++ through ctypes): skip-gram pairs and tokenizing.

Counterpart of ``deeplearning4j_tpu/native/``. ``datavec_native.cpp`` here
is the port's own copy of the JAX package's source, so one seed gives both
packages the same pairs. It is compiled with ``g++`` into
``deeplearning4j_tpu_torch/_build/libdatavec_native.so`` at first use (never
when this module is imported) and rebuilt when the source is newer. Under
the persistent build cache (``DL4J_TPU_COMPILE_CACHE``,
``common/build_cache.py``) it is built into the cache's directory under a
name that carries the hash of its source, its flags and ``g++``'s version,
and found there by later processes without a build.

Sanitizer flavor (the JAX package's, after libnd4j's ``SD_SANITIZE``):
``DL4J_TPU_NATIVE_SANITIZE=address|undefined`` builds ``-O1 -g
-fsanitize=<flavor> -fno-omit-frame-pointer`` into a library named after the
flavor (``libdatavec_native_address.so``). The process that loads it needs
the sanitizer's runtime preloaded (``LD_PRELOAD=$(g++
-print-file-name=libasan.so)``).

There is no fallback: the JAX package trains on a numpy pair stream, which
draws other pairs, when its helper is missing; here a failed build raises
with the compiler's output, so a fit never trains on another stream than the
one asked for. :func:`available` says whether the helper builds and loads;
it brings no stand-in back.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..common import build_cache

SOURCE = Path(__file__).resolve().parent / "datavec_native.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
LIBRARY = BUILD_DIR / "libdatavec_native.so"
SANITIZERS = ("address", "undefined")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: the loaded library's sg_pairs calls, for checks that the host path ran
sg_pairs_calls = 0
#: ``g++`` runs of this process
builds = 0


def sanitize_flavor() -> str:
    """``DL4J_TPU_NATIVE_SANITIZE``'s flavor, "" for the plain build."""
    flavor = os.environ.get("DL4J_TPU_NATIVE_SANITIZE", "")
    if flavor and flavor not in SANITIZERS:
        raise ValueError(f"DL4J_TPU_NATIVE_SANITIZE={flavor!r}: the flavors "
                         f"are {SANITIZERS}")
    return flavor


def _flags() -> List[str]:
    flavor = sanitize_flavor()
    opt = (["-O1", "-g", f"-fsanitize={flavor}", "-fno-omit-frame-pointer"]
           if flavor else ["-O3"])
    return [*opt, "-shared", "-fPIC", "-std=c++17"]


def library_path() -> Path:
    """Where the helper is built and found: :data:`LIBRARY` (or its
    sanitizer flavor's file beside it), or its hashed name in the build
    cache."""
    flavor = sanitize_flavor()
    stem = LIBRARY.stem + (f"_{flavor}" if flavor else "")
    d = build_cache.cache_dir()
    if d is not None:
        return d / build_cache.cached_name(stem, SOURCE, _flags(), "g++")
    return LIBRARY.with_name(stem + LIBRARY.suffix)


def _up_to_date(lib: Path) -> bool:
    if build_cache.cache_dir() is not None:
        return lib.exists()          # the name carries the source's hash
    return lib.exists() and lib.stat().st_mtime >= SOURCE.stat().st_mtime


def _build(lib: Path) -> None:
    """Compile the source into ``lib`` (a temporary file renamed into
    place, so that processes building at once never load half a file).
    Raises with the compiler's output when it fails."""
    global builds
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_flags(), str(SOURCE), "-o", str(tmp)]
    builds += 1
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building {SOURCE} failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE} (exit {r.returncode}):"
                           f"\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """The loaded helper, built first if it is missing or older than its
    source."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib_path = library_path()
            with build_cache.dir_lock(lib_path.parent):
                if not _up_to_date(lib_path):
                    _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.sg_pairs.restype = ctypes.c_int64
            lib.sg_pairs.argtypes = [
                i32p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_uint64, i32p, i32p, ctypes.c_int64]
            lib.tokenize_spans.restype = ctypes.c_int64
            lib.tokenize_spans.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, i64p, i64p, ctypes.c_int64]
            _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the helper builds and loads. The callers do not ask: they
    call and raise when it is missing."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def sg_pairs(ids: np.ndarray, offsets: np.ndarray, window: int,
             keep: Optional[np.ndarray], seed: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Skip-gram (center, context) pairs of a chunk of sentences in one
    native call: ``ids`` the sentences' word ids concatenated, ``offsets``
    int64 ``[n_sent + 1]`` their bounds; per sentence, subsampling with the
    keep probabilities ``keep`` (None: none), then a reduced window
    b ~ U[1, window] per position. Returns int32 (centers, contexts)."""
    global sg_pairs_calls
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or offsets.size < 1 or offsets[0] != 0 \
            or offsets[-1] != ids.size or (np.diff(offsets) < 0).any():
        raise ValueError("offsets must rise from 0 to len(ids)")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    keep_ptr = None
    if keep is not None:
        keep = np.ascontiguousarray(keep, dtype=np.float64)
        if ids.size and (ids.min() < 0 or ids.max() >= keep.size):
            raise ValueError("an id has no keep probability")
        keep_ptr = keep.ctypes.data_as(ctypes.c_void_p)
    lib = load()
    cap = int(2 * window * max(ids.size, 1))
    centers = np.empty(cap, dtype=np.int32)
    contexts = np.empty(cap, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.sg_pairs(
        ids.ctypes.data_as(i32p),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets) - 1, window, keep_ptr, seed,
        centers.ctypes.data_as(i32p), contexts.ctypes.data_as(i32p), cap)
    with _LOCK:
        sg_pairs_calls += 1
    return centers[:n], contexts[:n]


def tokenize(text: str) -> List[str]:
    """The whitespace-separated tokens of ``text`` in one native pass."""
    lib = load()
    raw = text.encode("utf-8")
    cap = max(len(raw) // 2 + 1, 16)
    starts = np.empty(cap, dtype=np.int64)
    lens = np.empty(cap, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.tokenize_spans(raw, len(raw), starts.ctypes.data_as(i64p),
                           lens.ctypes.data_as(i64p), cap)
    return [raw[starts[i]:starts[i] + lens[i]].decode("utf-8")
            for i in range(n)]
