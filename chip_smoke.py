#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (each fails the run with a nonzero exit if it fails):

1. device   -- nvidia-smi's name and power limit, torch's device name, the
               TF32 flags as set by the port's Environment.
2. build    -- compile every hand-written kernel from csrc/ with nvcc
               (sm_90a), all sources at once; print the build time.
3. kernels  -- each kernel's wrapper against its plain PyTorch version on
               the card, at every shape the main path gives it (ResNet-50,
               batch 32) plus ragged shapes, float32 and bfloat16; then the
               kernel, the plain version and the unfused PyTorch path timed
               with CUDA events beside the bandwidth bound.
4. serving  -- full-size ResNet-50 (224x224x3, 1000 classes, bf16 compute,
               fused epilogue) behind ParallelInference (batched, batch limit
               32, 2 workers): 64 single-image requests from 8 client
               threads, measured after one unmeasured round that warms the
               pool's worker threads. Checks every answer and that the main path launched
               the kernel 53 times per batch served, with no fallback.
5. parity   -- the same model in float32 with TF32 off, batch 8, fused
               epilogue on against off: rtol 1e-4, atol 1e-6.

Then it prints the kernels line (one JSON object) and, last, the device line
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, it exits nonzero and prints no result. Weights are random, made
from a seed; BN statistics are calibrated on a seeded batch and perturbed
(see deeplearning4j_tpu_torch/util/calibrate.py for why).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

SEED = 1234
BATCH = 32
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
F32_FLOPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
TIMED_RUNS = 30
WARMUP_RUNS = 5


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# --- phase 1 -------------------------------------------------------------------

def phase_device():
    from deeplearning4j_tpu_torch.common.environment import Environment

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    smi = r.stdout.strip().splitlines()[0].strip()
    log(smi)
    env = Environment.get()
    env.set_tf32(False)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{name}; count {torch.cuda.device_count()}; "
        f"tf32 {env.tf32_flags()}")
    return smi, name


# --- phase 2 -------------------------------------------------------------------

def phase_build():
    from deeplearning4j_tpu_torch.ops import cuda_lib

    names = sorted(p.stem for p in cuda_lib.CSRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    times = cuda_lib.build(names, force=True)
    wall = time.perf_counter() - t0
    for n in names:
        lib = cuda_lib.load(n)
        check(lib is not None, f"{n} did not load")
        ptxas = [ln.strip() for ln in cuda_lib.BUILD_LOGS.get(n, "").splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {n}: {times[n]:.2f} s; " + " | ".join(ptxas[:4]))
    log(f"[build] {len(names)} source(s) in {wall:.2f} s (parallel nvcc)")
    return names


# --- phase 3 -------------------------------------------------------------------

def main_path_bn_cases(batch: int):
    """(shape, act, residual) of every bn_act launch one ResNet-50 forward
    makes at ``batch``, read off the model's own configuration."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = ResNet50(num_classes=1000, image_size=224).conf()
    cases = set()
    for name in conf.order:
        node = conf.nodes[name]
        if node.kind != "layer" or not isinstance(node.layer,
                                                  L.BatchNormalization):
            continue
        t = conf.node_output_types[name]
        shape = (batch, t.channels, t.height, t.width)
        if name.endswith("_bn3"):           # the fused block tail
            cases.add((shape, "relu", True))
        else:
            cases.add((shape, node.layer.activation, False))
    return sorted(cases)


def _inputs(shape, dtype, residual, dev, gen):
    C = shape[1]
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    res = (torch.randn(shape, generator=gen, device=dev).to(dtype)
           if residual else None)
    mean = torch.randn(C, generator=gen, device=dev) * 0.1
    var = torch.rand(C, generator=gen, device=dev) * 1.5 + 0.5
    gamma = torch.randn(C, generator=gen, device=dev) * 0.1 + 1.0
    beta = torch.randn(C, generator=gen, device=dev) * 0.1
    return x, res, (mean, var, gamma, beta)


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(v.abs())          # v = m * 2**e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(v), e - 8)


def compare_bn_act(shape, act, residual, dtype, dev, gen):
    from deeplearning4j_tpu_torch.ops import epilogue

    x, res, stats = _inputs(shape, dtype, residual, dev, gen)
    scale, shift = epilogue.fold(*stats)
    got = epilogue.bn_act_cuda(x, scale, shift, res, act).float()
    want = epilogue.bn_act_reference(x, scale, shift, res, act).float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err = err.max().item()
    if dtype == torch.float32:
        # fmaf against two roundings: 2 ulp of the output scale
        tol = 2.0 ** -22 * (want.abs().max().item() + 1.0)
        ok = max_err <= tol
        tol_s = f"<= {tol:.3g} (2 f32 ulp of the output scale)"
    else:
        # both round once to bf16 from f32 values that differ by the
        # kernel's fmaf (at most 2 f32 ulp of the terms' magnitude), so
        # they differ by at most that plus 1 bf16 ulp, elementwise
        terms = (x.float() * scale.reshape([1, -1] + [1] * (x.ndim - 2))).abs() \
            + shift.abs().reshape([1, -1] + [1] * (x.ndim - 2))
        if res is not None:
            terms = terms + res.float().abs()
        tol = _bf16_ulp(torch.maximum(got.abs(), want.abs())) \
            + 2.0 ** -22 * terms
        ok = bool(err.le(tol).all())
        tol_s = "<= 1 bf16 ulp + 2 f32 ulp of the terms, elementwise"
    check(ok, f"bn_act {tuple(shape)} {act} res={residual} {dtype}: "
              f"max_abs_err {max_err} not {tol_s}")
    return max_err


def _time_ms(fn, flush) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()                     # start each run with a cold L2
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_bn_act(shape, dtype, dev, gen, flush):
    """Kernel, plain version and the unfused PyTorch path at one residual
    shape, plus the least time the card could take for the same work."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import epilogue

    x, res, (mean, var, gamma, beta) = _inputs(shape, dtype, True, dev, gen)
    scale, shift = epilogue.fold(mean, var, gamma, beta)
    mean_c, var_c, gamma_c, beta_c = (t.to(dtype)
                                      for t in (mean, var, gamma, beta))
    kernel = lambda: epilogue.bn_act_cuda(x, scale, shift, res, "relu")  # noqa: E731
    plain = lambda: epilogue.bn_act_reference(x, scale, shift, res, "relu")  # noqa: E731
    unfused = lambda: torch.relu(F.batch_norm(  # noqa: E731
        x, mean_c, var_c, gamma_c, beta_c, training=False, eps=1e-5) + res)
    n = x.numel()
    elem = x.element_size()
    nbytes = 3 * n * elem + 2 * shape[1] * 4     # x, res, out; scale, shift
    flops = 4 * n                                # fma (2), add, max
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    out = {"ms": _time_ms(kernel, flush), "plain_ms": _time_ms(plain, flush),
           "unfused_ms": _time_ms(unfused, flush),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes}
    return out


def phase_kernels(smi: str, dev):
    cases = main_path_bn_cases(BATCH)
    ragged = [((3, 65, 7, 5), a, r) for a in ("relu", "identity")
              for r in (False, True)]
    ragged += [((17, 130), a, r) for a in ("relu", "identity")
               for r in (False, True)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    for shape, act, residual in cases + ragged:
        for dtype in (torch.float32, torch.bfloat16):
            e = compare_bn_act(shape, act, residual, dtype, dev, gen)
            errs[dtype] = max(errs[dtype], e)
            n += 1
    log(f"[kernels] bn_act vs plain: {n} comparisons "
        f"({len(cases)} main-path cases at batch {BATCH} + {len(ragged)} "
        f"ragged, f32 and bf16) ok; max_abs_err f32 {errs[torch.float32]} "
        f"bf16 {errs[torch.bfloat16]}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = time_bn_act((BATCH, 256, 56, 56), dtype, dev, gen, flush)
        timing[dtype] = t
        log(f"[kernels] bn_act [32,256,56,56] residual relu {dtype}: "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"unfused F.batch_norm+add+relu {t['unfused_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{t['bytes']} B at 3.35 TB/s); median of {TIMED_RUNS} "
            f"(CUDA events, cold L2); {smi}")
    return errs, timing


# --- phases 4 and 5 -----------------------------------------------------------

def set_fused(graph, on: bool) -> None:
    """The global knob plus the cascade onto every BN layer."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    graph.conf.global_conf.fused_epilogue = on
    for name in graph.conf.order:
        node = graph.conf.nodes[name]
        if node.kind == "layer" and isinstance(node.layer,
                                               L.BatchNormalization):
            node.layer.fused_epilogue = on


def build_model(dev, image_size: int = 224, num_classes: int = 1000):
    """ResNet-50 with seeded random weights: gamma ~ N(1, 0.1) and
    beta ~ N(0, 0.1), BN statistics calibrated on a seeded batch, then
    perturbed (mean += N(0, 0.05)·std, var *= U(0.8, 1.25))."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.util.calibrate import calibrate_batchnorm

    model = ResNet50(num_classes=num_classes, image_size=image_size,
                     seed=SEED).init(device=dev)
    rng = np.random.default_rng(SEED)
    for name in sorted(model._states):
        p = model._params[name]
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["gamma"] = torch.from_numpy(
                rng.normal(1.0, 0.1, c).astype(np.float32)).to(dev)
            p["beta"] = torch.from_numpy(
                rng.normal(0.0, 0.1, c).astype(np.float32)).to(dev)
    calib = rng.normal(size=(BATCH, 3, image_size, image_size)).astype(
        np.float32)
    states = calibrate_batchnorm(model, calib)
    for name in sorted(states):
        st = states[name]
        if "mean" not in st:
            continue
        c = st["mean"].shape[0]
        dm = torch.from_numpy(rng.normal(0.0, 0.05, c).astype(np.float32))
        sv = torch.from_numpy(rng.uniform(0.8, 1.25, c).astype(np.float32))
        st["mean"] = st["mean"] + dm.to(dev) * st["var"].sqrt()
        st["var"] = st["var"] * sv.to(dev)
    return model


def serve_round(pi, images, clients: int = 8):
    """``len(images)`` single-image requests from ``clients`` threads, each
    submitting its share asynchronously and then waiting for it. Returns
    (results, latency in s per request, client errors, wall time in s)."""
    n = len(images)
    results = [None] * n
    latency = [0.0] * n
    errors = []
    per = n // clients

    def client(k: int) -> None:
        try:
            futs = []
            for i in range(per * k, per * (k + 1)):
                t0 = time.perf_counter()
                fut = pi.output_async(images[i])
                fut.add_done_callback(
                    lambda f, i=i, t0=t0: latency.__setitem__(
                        i, time.perf_counter() - t0))
                futs.append((i, fut))
            for i, fut in futs:
                results[i] = fut.result(timeout=120)
        except Exception as e:   # reported by the caller
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return results, latency, errors, time.perf_counter() - t0


def phase_serving(model, smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import epilogue
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    set_fused(model, True)
    model.conf.global_conf.compute_dtype = "bfloat16"
    size = model.conf.node_output_types["input"].height
    classes = model.conf.nodes["output"].layer.n_out
    rng = np.random.default_rng(SEED + 1)
    images = rng.normal(size=(64, 1, 3, size, size)).astype(np.float32)
    # warm-up outside the counted run: cuDNN handles, algorithms, the
    # bf16 parameter copies
    for b in (BATCH, 1):
        model.output(images[:b, 0])
    torch.cuda.synchronize()

    pi = (ParallelInference.Builder(model).inference_mode("batched")
          .batch_limit(BATCH).workers(2).max_wait_ms(10)
          .request_timeout_ms(120_000).build())
    prof = OpProfiler.get()
    try:
        # one round to warm the pool's own worker threads (each thread
        # makes its own cuDNN/cuBLAS handles on its first forward), then
        # the measured round with every count set to 0 just before it
        serve_round(pi, images)
        prof.reset()
        epilogue.reset_launches()
        results, latency, errors, wall = serve_round(pi, images)
        launches = epilogue.bn_act_launches
        counters = prof.get_counters()
    finally:
        pi.shutdown()

    check(not errors, f"client errors: {errors[:3]}")
    batches = counters.get("inference/batches", 0)
    check(counters.get("inference/requests", 0) == 64,
          f"served {counters.get('inference/requests')} of 64 requests")
    for i, r in enumerate(results):
        check(r is not None and tuple(r.shape) == (1, classes),
              f"answer {i} has shape {None if r is None else tuple(r.shape)}")
        v = r[0].float()
        check(bool(torch.isfinite(v).all()), f"answer {i} is not finite")
        check(abs(v.sum().item() - 1.0) <= 1e-2,
              f"answer {i} sums to {v.sum().item()}")
    check(launches == 53 * batches and launches > 0,
          f"bn_act kernel launched {launches} times for {batches} batches "
          f"(want 53 per batch)")
    check(counters.get("precision/epilogue_hits", 0) == 53 * batches,
          f"epilogue hits {counters.get('precision/epilogue_hits')}")
    check(counters.get("precision/epilogue_fallbacks", 0) == 0,
          f"epilogue fallbacks {counters.get('precision/epilogue_fallbacks')}")
    lat = sorted(latency)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(round(0.99 * (len(lat) - 1))))] * 1e3
    top = max(r[0].float().max().item() for r in results)
    log(f"[serving] ResNet-50 {size}x{size} {classes} classes bf16, fused "
        f"epilogue: "
        f"64 requests from 8 clients in {batches} batches, "
        f"{64 / wall:.2f} images/s, latency p50 {p50:.2f} ms p99 "
        f"{p99:.2f} ms; bn_act launches {launches} (53 x {batches}); "
        f"largest probability {top:.4f}; {smi}")
    return launches, batches


def phase_parity(model, dev):
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler

    Environment.get().set_tf32(False)
    check(not any(Environment.get().tf32_flags().values()), "TF32 is on")
    model.conf.global_conf.compute_dtype = None
    size = model.conf.node_output_types["input"].height
    x = np.random.default_rng(SEED + 2).normal(
        size=(8, 3, size, size)).astype(np.float32)
    prof = OpProfiler.get()
    prof.reset()
    set_fused(model, True)
    fused = model.output(x)[0].float().cpu()
    check(prof.counter_value("precision/epilogue_hits") == 53,
          "fused forward did not take 53 epilogue launches")
    set_fused(model, False)
    dense = model.output(x)[0].float().cpu()
    check(prof.counter_value("precision/epilogue_hits") == 53,
          "dense forward took the epilogue")
    diff = (fused - dense).abs().max().item()
    check(torch.allclose(fused, dense, rtol=1e-4, atol=1e-6),
          f"fused vs dense float32 disagree: max abs diff {diff}")
    log(f"[parity] float32 batch 8, TF32 off: fused vs dense max abs diff "
        f"{diff} (rtol 1e-4, atol 1e-6); largest probability "
        f"{fused.max().item():.4f}")


# --- main -----------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available; the port's main path "
              "runs on the card", file=sys.stderr)
        return 2
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
        from deeplearning4j_tpu_torch.ops import epilogue
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        smi, name = phase_device()
        phase_build()
        errs, timing = phase_kernels(smi, dev)
        model = build_model(dev)
        launches, batches = phase_serving(model, smi, dev)
        phase_parity(model, dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    kernels = {"kernels": [{
        "name": "bn_act", "route": "cuda", "source": epilogue.SOURCE,
        "replaces": epilogue.REPLACES, "launches": launches,
        "max_abs_err": max(errs.values()),
        "max_err_f32": errs[torch.float32],
        "max_err_bf16": errs[torch.bfloat16],
        "shape": [BATCH, 256, 56, 56], "dtype": "bfloat16",
        "ms": bf["ms"], "plain_ms": bf["plain_ms"],
        "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
        "library_ms": None, "unfused_ms": bf["unfused_ms"],
        "f32": {k: f32[k] for k in ("ms", "plain_ms", "unfused_ms",
                                    "bound_ms")},
        "batches": batches}]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
