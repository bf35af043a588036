"""Where the port's native libraries are built and found.

Two homes, one rule for both build paths (``ops/cuda_lib.py`` for the kernels
of ``csrc/``, ``native/__init__.py`` for the host helper):

- unset, the package's own ``_build/``, one file per library, rebuilt when
  its source is newer (a checkout owns its build directory);
- the persistent build cache, a directory chosen by
  ``DL4J_TPU_COMPILE_CACHE`` or ``Environment.set_compile_cache``: a
  library's file name carries a hash of its source, its compiler flags and
  the compiler's version (:func:`cached_name`), so processes of several
  checkouts share the directory, a process whose libraries are there
  compiles nothing, and a library of another source is never loaded.

Builds in either home hold the directory's ``.lock`` (``flock``) and rename
a finished temporary file into place.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence

_DIR: Optional[str] = None
_VERSIONS: Dict[str, str] = {}
_VERSIONS_LOCK = threading.Lock()


def cache_dir() -> Optional[Path]:
    """The build cache's directory, or None for the package's ``_build/``:
    what ``set_cache_dir`` set, else ``$DL4J_TPU_COMPILE_CACHE``."""
    d = _DIR or os.environ.get("DL4J_TPU_COMPILE_CACHE")
    return Path(d) if d else None


def set_cache_dir(path: Optional[str]) -> None:
    global _DIR
    _DIR = os.fspath(path) if path else None


def compiler_version(compiler: str) -> str:
    """``<compiler> --version``'s output, once a process per compiler."""
    with _VERSIONS_LOCK:
        v = _VERSIONS.get(compiler)
        if v is None:
            r = subprocess.run([compiler, "--version"], capture_output=True,
                               text=True, timeout=60)
            if r.returncode != 0:
                raise RuntimeError(f"{compiler} --version failed: "
                                   f"{r.stderr.strip()}")
            v = _VERSIONS[compiler] = r.stdout
        return v


def cached_name(stem: str, source: Path, flags: Sequence[str],
                compiler: str) -> str:
    """``<stem>-<hash>.so``: the hash of the source's bytes, the flags and
    the compiler's version."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update("\0".join(flags).encode())
    h.update(compiler_version(compiler).encode())
    return f"{stem}-{h.hexdigest()[:20]}.so"


@contextmanager
def dir_lock(directory: Path) -> Iterator[None]:
    """The build directory's lock, across processes."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
