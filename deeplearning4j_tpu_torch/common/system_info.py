"""SystemInfo: hardware/software environment dump.

Counterpart of ``deeplearning4j_tpu/common/system_info.py`` (reference:
nd4j-common ``org/nd4j/systeminfo/SystemInfo.java``): the host (OS,
python, CPU, RAM), the CUDA cards with live memory figures, and the
library versions. Card memory comes from ``torch.cuda.mem_get_info``
(free and total as the driver sees them) and
``torch.cuda.memory_stats`` (the caching allocator's bytes in use, peak,
reserved and live allocations: the leak detector the JAX package reads
off ``jax.live_arrays``).
"""

from __future__ import annotations

import os
import platform
import sys
from typing import Any, Dict, List


def _host_ram_bytes() -> int:
    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return 0


def _rss_bytes() -> int:
    """Current process resident set size; without /proc the peak RSS
    (ru_maxrss: KiB on Linux, bytes on macOS). 0 when unknowable."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return 0


def _cuda_devices(with_kind: bool) -> List[Dict[str, Any]]:
    """One entry per visible card: id, platform, and (once the card is
    initialized in this process) its memory. Reading the memory of a card
    nobody has used would create a context on it, so an uninitialized
    process reports the inventory only."""
    import torch

    if not torch.cuda.is_available():
        return []
    out: List[Dict[str, Any]] = []
    for i in range(torch.cuda.device_count()):
        dev: Dict[str, Any] = {"id": i, "platform": "gpu"}
        if with_kind:
            dev["kind"] = torch.cuda.get_device_name(i)
        if torch.cuda.is_initialized():
            free, total = torch.cuda.mem_get_info(i)
            st = torch.cuda.memory_stats(i)
            dev["bytes_in_use"] = int(st.get("allocated_bytes.all.current",
                                             0))
            dev["bytes_limit"] = int(total)
            dev["bytes_free"] = int(free)
            dev["peak_bytes_in_use"] = int(st.get("allocated_bytes.all.peak",
                                                  0))
            dev["bytes_reserved"] = int(st.get("reserved_bytes.all.current",
                                               0))
            dev["live_allocations"] = int(st.get("allocation.all.current",
                                                 0))
        out.append(dev)
    return out


def memory_summary() -> Dict[str, Any]:
    """Live card and host memory, cheap enough to poll (``UIServer``'s
    ``/api/health`` calls it per request): per-card allocator and driver
    figures, the allocator's live-allocation census, and host RSS against
    total RAM."""
    out: Dict[str, Any] = {"host": {"ram_bytes": _host_ram_bytes(),
                                    "rss_bytes": _rss_bytes()}}
    try:
        import torch

        devices = _cuda_devices(with_kind=False)
        out["devices"] = devices
        out["backend"] = "gpu" if devices else "cpu"
        if devices and torch.cuda.is_initialized():
            out["live_buffers"] = {
                "count": sum(d.get("live_allocations", 0) for d in devices),
                "bytes": sum(d.get("bytes_in_use", 0) for d in devices)}
    except Exception as e:          # pragma: no cover - driver failure
        out["torch_error"] = str(e)
    return out


def gather() -> Dict[str, Any]:
    """Structured environment snapshot (JSON-serializable)."""
    info: Dict[str, Any] = {
        "os": f"{platform.system()} {platform.release()}",
        "machine": platform.machine(),
        "python": sys.version.split()[0],
        "cpu_count": os.cpu_count(),
        "host_ram_bytes": _host_ram_bytes(),
    }
    try:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
        info["devices"] = _cuda_devices(with_kind=True)
        info["default_backend"] = "gpu" if info["devices"] else "cpu"
    except Exception as e:          # pragma: no cover - driver failure
        info["torch_error"] = str(e)
    for mod in ("numpy", "triton"):
        try:
            m = __import__(mod)
            info[f"{mod}_version"] = getattr(m, "__version__", "?")
        except ImportError:
            pass
    return info


def dump() -> str:
    """Human-readable report (the reference's text-dump contract)."""
    info = gather()
    lines = ["=== SystemInfo ==="]
    for k in ("os", "machine", "python", "cpu_count"):
        lines.append(f"{k}: {info.get(k)}")
    ram = info.get("host_ram_bytes") or 0
    lines.append(f"host RAM: {ram / 2**30:.1f} GiB")
    lines.append(f"torch: {info.get('torch_version', '?')} (cuda "
                 f"{info.get('cuda_version')}, backend "
                 f"{info.get('default_backend', '?')})")
    for d in info.get("devices", []):
        mem = ""
        if "bytes_in_use" in d:
            mem = (f" — {d['bytes_in_use'] / 2**20:.0f} MiB in use"
                   f" / {d['bytes_limit'] / 2**20:.0f} MiB"
                   f" (peak {d['peak_bytes_in_use'] / 2**20:.0f})")
        lines.append(f"device {d['id']}: {d['platform']} "
                     f"{d.get('kind', '?')}{mem}")
    for k, v in info.items():
        if k.endswith("_version") and k not in ("torch_version",
                                                 "cuda_version"):
            lines.append(f"{k.replace('_version', '')}: {v}")
    return "\n".join(lines)


class SystemInfo:
    """Reference-shaped static facade."""

    gather = staticmethod(gather)
    dump = staticmethod(dump)
    memory_summary = staticmethod(memory_summary)
    # reference spelling
    getSystemInfo = staticmethod(dump)
