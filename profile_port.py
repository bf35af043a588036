#!/usr/bin/env python3
"""Where one ResNet-50 serving forward of the port spends its time, on the card.

    python3 profile_port.py        # from the repository root; needs one card

Builds the model ``chip_smoke.py`` serves (full-size ResNet-50, seeded random
weights, calibrated BN statistics, bf16 compute) and prints, beside the
card's name and power limit:

- the time of one forward (host clock around work that ends in
  ``torch.cuda.synchronize()``, median of 10 after 3 warm-ups) at batch 1, 8
  and 32, fused epilogue on, and at batch 32 with it off;
- a ``torch.profiler`` trace of 3 forwards at batch 32: the device's busy
  share of the wall time and the kernels that take the most device time.
  The Chrome trace goes to ``chiprun_out/profile_port_trace.json``.

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def forward_ms(model, x, runs: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        model.output(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model.output(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA card available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi, name = cs.phase_device()
    model = cs.build_model(dev)
    model.conf.global_conf.compute_dtype = "bfloat16"
    rng = np.random.default_rng(cs.SEED + 3)
    x32 = rng.normal(size=(32, 3, 224, 224)).astype(np.float32)
    result = {"device": name, "nvidia_smi": smi}
    cs.set_fused(model, True)
    for b in (1, 8, 32):
        ms = forward_ms(model, x32[:b])
        result[f"fused_b{b}_ms"] = ms
        print(f"[forward] batch {b} bf16 fused: {ms:.3f} ms "
              f"({b / ms * 1e3:.1f} images/s); {smi}", flush=True)
    cs.set_fused(model, False)
    ms = forward_ms(model, x32)
    result["dense_b32_ms"] = ms
    print(f"[forward] batch 32 bf16 dense (epilogue off): {ms:.3f} ms "
          f"({32 / ms * 1e3:.1f} images/s); {smi}", flush=True)
    cs.set_fused(model, True)

    from torch.profiler import ProfilerActivity, profile

    forward_ms(model, x32, runs=1, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model.output(x32)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    device_us = sum(_device_us(e) for e in events)
    events.sort(key=_device_us, reverse=True)
    top = [{"name": e.key[:80], "device_ms": _device_us(e) / 1e3 / 3,
            "calls_per_forward": e.count / 3} for e in events[:15]]
    result.update({"profiled_wall_ms_per_forward": wall_us / 1e3 / 3,
                   "device_ms_per_forward": device_us / 1e3 / 3,
                   "device_busy_share": device_us / wall_us if wall_us else
                   None, "top_kernels": top})
    print(f"[profile] batch 32 bf16 fused, 3 forwards: wall "
          f"{wall_us / 3e3:.3f} ms/forward, device busy "
          f"{device_us / 3e3:.3f} ms/forward "
          f"({100 * device_us / wall_us:.1f}% of wall); {smi}", flush=True)
    for t in top:
        print(f"[profile]   {t['device_ms']:8.3f} ms  x{t['calls_per_forward']:.0f}"
              f"  {t['name']}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out",
                                          "profile_port_trace.json"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
