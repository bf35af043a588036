#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main paths on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (each fails the run with a nonzero exit if it fails):

1. device   -- nvidia-smi's name and power limit, torch's device name, the
               TF32 flags as set by the port's Environment.
2. build    -- compile every hand-written kernel from csrc/ with nvcc
               (sm_90a), all sources at once; print the build time and
               ``-Xptxas -v`` (registers, spills) of each.
3. kernels  -- each kernel's wrapper against its plain PyTorch version on
               the card: bn_act at every shape the serving path gives it
               (ResNet-50, batch 32) plus ragged shapes, float32 and
               bfloat16; fused_update for sgd, nesterovs, adam and adamw,
               float32 state and bfloat16 state with identical random bits
               (bfloat16 moments must match bitwise), at the main path's
               bucket (25,557,032 elements), ragged sizes
               (1, 5, 4097) and views that start 1 element into a buffer
               (the head path and the scalar variant); embedding_bag bitwise
               at the CBOW path's shape ([8192, 10] bags of a [10000, 100]
               table) and ragged ones (D 1, 3, 101, 300; W 1; fully masked
               bags; a table 1 element into its buffer). Then each kernel,
               its plain version, the unfused PyTorch path and, where one
               PyTorch call computes the same function, that call, timed
               with CUDA events and a cold L2 after a 2 ms spin of the card
               (so the host's launch overhead is not timed), beside the
               bandwidth bound;
               embedding_bag also at a wide shape (V 3,000,000, D 300).
4. serving  -- full-size ResNet-50 (224x224x3, 1000 classes, bf16 compute,
               fused epilogue) behind ParallelInference (batched, batch limit
               32, 2 workers): 64 single-image requests from 8 client
               threads, measured after one unmeasured round that warms the
               pool's worker threads. Checks every answer and that the path
               launched bn_act 53 times per batch served, with no fallback.
5. parity   -- the same model in float32 with TF32 off, batch 8, fused
               epilogue on against off: rtol 1e-4, atol 1e-6.
6. train    -- full-size ResNet-50 training as bench.py configures it
               (bf16 compute, float32 master params, Nesterovs(0.1, 0.9),
               l2 1e-4, fused_update, bf16 updater state with stochastic
               rounding) through ComputationGraph.fit at batch 128 on a
               seeded synthetic batch: 2 unmeasured steps, then 10 timed
               ones. Gates: finite losses, one fused_update launch per step,
               no fallback, gradients born flat, bf16 state of 51,114,064
               bytes, parameters changed.
7. train-parity -- batch 8, float32 compute, TF32 off, deterministic cuDNN,
               float32 state: one fit step through the kernel against one
               through the per-leaf apply_updater path from the same
               parameters; parameters and momentum within 2 float32 ulp.
8. word2vec-cbow -- the word2vec-cbow configuration as bench.py runs it:
               Word2Vec CBOW with negative sampling, vocabulary 10,000 of a
               zipf corpus of 200,000 x 20 words (seed 123), layer 100,
               window 5, 5 negatives, sampling 1e-3, batch 8192, one epoch,
               fitted twice (cold, then warm). Gates: vocabulary 10,000,
               8192 examples per round, 384 embedding_bag launches per fit
               (one per round), tables on the card, finite losses, the last
               loss below ln 2. Then a CBOW fit of the cluster corpus of
               tests/test_nlp.py on the card, gated as there.

Then it prints the kernels line (one JSON object) and, last, the device line
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, it exits nonzero and prints no result. Weights are random, made
from a seed; for serving, BN statistics are calibrated on a seeded batch and
perturbed (see deeplearning4j_tpu_torch/util/calibrate.py for why).
"""

from __future__ import annotations

import argparse
import json
import re
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
SPIN_CYCLES = 4_000_000             # about 2 ms at the H100's 1.98 GHz
TRAIN_BATCH = 128
IMAGE = 224
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
RESNET50_PARAMS = 25_557_032        # elements of the one float32 bucket
W2V_VOCAB = 10_000                  # bench.py --config word2vec-cbow
W2V_WORDS = 4_000_000
W2V_ROUNDS_PER_FIT = 384            # 6 blocks of 64 rounds


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
        text = cuda_lib.BUILD_LOGS.get(n, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(v) for v in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", text))
        log(f"[build] {n}: {times[n]:.2f} s; -Xptxas -v: {len(regs)} "
            f"kernels, registers {min(regs, default=0)}-"
            f"{max(regs, default=0)} per thread, {spills} bytes spilled")
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
    """Median card time of ``fn`` over TIMED_RUNS runs, each from a cold
    L2. Before each run the card spins for about 2 ms, so the host has
    enqueued the whole run before the start event fires: the time is the
    card's, not the host's launch overhead (which a short kernel would
    otherwise show as its own time). A function whose host work takes
    longer than that (the per-leaf updater) still shows part of it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(WARMUP_RUNS):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()                     # start each run with a cold L2
        torch.cuda._sleep(SPIN_CYCLES)
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


# --- phase 3, embedding_bag -------------------------------------------------------

BAG_PATH = (8192, 10, W2V_VOCAB, 100)   # B, W, V, D of one CBOW round


def _bag_case(B, W, V, D, dev, gen, offset=0, dist="uniform", masked=0):
    """A table (a view ``offset`` elements into its buffer), indices, a 0/1
    mask with ``masked`` fully masked bags, and the counts. Indices are
    ``uniform`` over the table, ``zipf`` (the bench corpus's word
    frequencies, 1/rank) or ``subsampled`` (zipf after word2vec's
    frequent-word subsampling at 1e-3, keep = sqrt(t/f) + t/f: the
    distribution of the CBOW path's context words)."""
    buf = torch.randn(V * D + offset, generator=gen, device=dev)
    table = buf[offset:].view(V, D)
    if dist != "uniform":
        p = 1.0 / torch.arange(1, V + 1, device=dev, dtype=torch.float64)
        p = p / p.sum()
        if dist == "subsampled":
            p = p * ((1e-3 / p).sqrt() + 1e-3 / p).clamp(max=1.0)
        idx = torch.multinomial(p, B * W, replacement=True, generator=gen)
    else:
        idx = torch.randint(0, V, (B * W,), generator=gen, device=dev)
    idx = idx.view(B, W).to(torch.int32)
    mask = (torch.rand((B, W), generator=gen, device=dev) < 0.7).float()
    mask[:masked] = 0.0
    counts = mask.sum(1).clamp_min(1.0)
    return table, idx, mask, counts


def compare_embedding_bag(B, W, V, D, dev, gen, offset=0, masked=3):
    from deeplearning4j_tpu_torch.ops import embeddings

    table, idx, mask, counts = _bag_case(B, W, V, D, dev, gen, offset,
                                         masked=masked)
    if W:
        idx[0, 0], idx[-1, -1] = V - 1, V + 5      # the edge, and clamped
    err = 0.0
    for mean in (True, False):
        got = embeddings.embedding_bag_cuda(table, idx, mask, counts, mean)
        want = embeddings.embedding_bag_reference(table, idx, mask, counts,
                                                  mean)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item() if got.numel() else 0.0
        check(torch.equal(got, want),
              f"embedding_bag B={B} W={W} V={V} D={D} offset={offset} "
              f"mean={mean}: not bitwise (max_abs_err {e})")
        err = max(err, e)
    return err


def time_embedding_bag(B, W, V, D, dev, gen, flush, dist):
    """Kernel, plain version, F.embedding_bag (the one PyTorch call for the
    same function) and the unfused expression at one shape, beside the
    least bytes: indices, mask, counts, output, each distinct row once."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import embeddings

    table, idx, mask, counts = _bag_case(B, W, V, D, dev, gen, dist=dist)
    c2 = counts[:, None]
    idx64 = idx.long()
    kernel = lambda: embeddings.embedding_bag_cuda(  # noqa: E731
        table, idx, mask, counts, True)
    plain = lambda: embeddings.embedding_bag_reference(  # noqa: E731
        table, idx, mask, counts, True)
    library = lambda: F.embedding_bag(  # noqa: E731
        idx64, table, per_sample_weights=mask, mode="sum") / c2
    unfused = lambda: (table[idx64] * mask[..., None]).sum(1) / c2  # noqa: E731
    check(torch.allclose(library(), kernel(), rtol=1e-5, atol=1e-5),
          "F.embedding_bag yardstick computes another function")
    distinct = int(torch.unique(idx).numel())
    nbytes = 2 * B * W * 4 + B * 4 + B * D * 4 + distinct * D * 4
    no_reuse = 2 * B * W * 4 + B * 4 + B * D * 4 + B * W * D * 4
    flops = 2 * B * W * D + B * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    out = {"ms": _time_ms(kernel, flush), "plain_ms": _time_ms(plain, flush),
           "library_ms": _time_ms(library, flush),
           "unfused_ms": _time_ms(unfused, flush),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "bytes_no_reuse": no_reuse,
           "no_reuse_ms": no_reuse / HBM_BYTES_PER_S * 1e3,
           "distinct_rows": distinct, "shape": [B, W, V, D],
           "indices": dist,
           "hottest_row_share": torch.bincount(idx.view(-1).long()).max()
           .item() / (B * W)}
    del table, idx, mask, counts, idx64
    return out


def phase_embedding_bag(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    B, W, V, D = BAG_PATH
    cases = [(B, W, V, D, 0)]
    cases += [(257, 10, 1000, d, 0) for d in (1, 3, 101, 300)]
    cases += [(257, 1, 1000, 100, 0), (257, 10, 1000, 100, 1),
              (257, 10, 1000, 3, 1), (9, 0, 1000, 100, 0)]
    err = 0.0
    for b, w, v, d, off in cases:
        err = max(err, compare_embedding_bag(b, w, v, d, dev, gen, off))
    log(f"[kernels] embedding_bag vs plain: {2 * len(cases)} comparisons "
        f"(mean and sum; the CBOW path's [{B},{W}] x [{V},{D}], D 1/3/101/"
        f"300, W 1 and 0, 3 fully masked bags each, a table 1 element into "
        f"its buffer) all bitwise; max_abs_err {err}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = {"path": time_embedding_bag(B, W, V, D, dev, gen, flush,
                                         "subsampled"),
              "path_raw_zipf": time_embedding_bag(B, W, V, D, dev, gen, flush,
                                                  "zipf"),
              "wide": time_embedding_bag(B, W, 3_000_000, 300, dev, gen,
                                         flush, "uniform")}
    torch.cuda.empty_cache()
    for name, t in timing.items():
        log(f"[kernels] embedding_bag {name} {t['shape']} (B, W, V, D; "
            f"{t['indices']} indices, {t['distinct_rows']} distinct rows, "
            f"hottest row {100 * t['hottest_row_share']:.2f}% of the "
            f"lookups): kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms, F.embedding_bag/counts "
            f"{t['library_ms']:.4f} ms, unfused {t['unfused_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B "
            f"at 3.35 TB/s; {t['bytes_no_reuse']} B without reuse = "
            f"{t['no_reuse_ms']:.4f} ms); median of {TIMED_RUNS} (CUDA "
            f"events, cold L2); {smi}")
    return err, timing


# --- phase 3, fused_update -------------------------------------------------------

UPDATE_KINDS = ("sgd", "nesterovs", "adam", "adamw")


def _updater(kind: str, state_dtype=None):
    from deeplearning4j_tpu_torch.learning import updaters as U

    u = {"sgd": lambda: U.Sgd(0.1),
         "nesterovs": lambda: U.Nesterovs(0.1, momentum=0.9),
         "adam": lambda: U.Adam(1e-3), "adamw": lambda: U.AdamW(1e-3)}[kind]()
    u.state_dtype = state_dtype
    return u


def _update_case(kind, n, bf16, dev, gen, offset=(0, 0)):
    """p, g, slots, bits on the card; ``offset`` = (elements into the
    buffer for p, for every other tensor)."""
    from deeplearning4j_tpu_torch.ops import update

    def buf(dtype, fill):
        t = torch.empty(n + 4, dtype=torch.float32, device=dev)
        fill(t)
        return t.to(dtype)

    def view(t, which):
        o = offset[0] if which == "p" else offset[1]
        return t[o:o + n]

    p = view(buf(torch.float32, lambda t: t.normal_(generator=gen)), "p")
    g = view(buf(torch.float32,
                 lambda t: t.normal_(generator=gen).mul_(0.01)), "g")
    sdt = torch.bfloat16 if bf16 else torch.float32
    slots = {}
    for s in update.SLOTS[kind]:
        if s == "v" and kind != "nesterovs":
            fill = lambda t: t.normal_(generator=gen).abs_().mul_(1e-3)  # noqa: E731
        else:
            fill = lambda t: t.normal_(generator=gen).mul_(0.1)  # noqa: E731
        slots[s] = view(buf(sdt, fill), s)
    bits = None
    if bf16 and update.SLOTS[kind]:
        b = torch.randint(-2 ** 31, 2 ** 31, (n + 4,), dtype=torch.int32,
                          generator=gen, device=dev)
        bits = view(b, "bits")
    return p, g, slots, bits


def compare_fused_update(kind, n, bf16, dev, gen, offset=(0, 0)):
    """The kernel (in place) against the plain version on copies of the
    same inputs: parameters and float32 moments within 2 float32 ulp,
    bfloat16 moments bitwise. Returns (max param err, max moment err,
    bitwise)."""
    from deeplearning4j_tpu_torch.ops import update

    p, g, slots, bits = _update_case(kind, n, bf16, dev, gen, offset)
    sr = torch.bfloat16 if bf16 else None
    sc = update._scalars(_updater(kind, "bfloat16" if bf16 else None), kind,
                         3)
    want_p, want_s = update.fused_update_reference(kind, sc, p, g, slots,
                                                   bits, sr)
    update.fused_update_cuda(kind, sc, p, g, slots, bits, sr)
    torch.cuda.synchronize()
    bitwise = torch.equal(p, want_p) and all(
        torch.equal(slots[k], want_s[k]) for k in slots)
    perr = (p - want_p).abs().max().item() if n else 0.0
    # the JAX package's contract between its modes: 2 float32 ulp of the
    # magnitude for parameters
    ptol = 2.0 ** -22 * (want_p.abs().max().item() + 1.0) if n else 0.0
    check(perr <= ptol, f"fused_update {kind} n={n} bf16={bf16} "
                        f"offset={offset}: param err {perr} > {ptol}")
    serr = 0.0
    for k in slots:
        got, want = slots[k].float(), want_s[k].float()
        d = (got - want).abs()
        serr = max(serr, d.max().item() if n else 0.0)
        if bf16:
            # stochastic rounding picks one of two bf16 neighbours 1 ulp
            # apart, so only equal bits check that the kernel read the
            # right halfword of the right bits
            ok = torch.equal(slots[k], want_s[k])
            what = "bitwise equality"
        else:
            ok = d.max().item() <= 2.0 ** -22 * (want.abs().max().item()
                                                 + 1.0)
            what = "2 f32 ulp"
        check(ok, f"fused_update {kind} n={n} bf16={bf16} offset={offset}:"
                  f" moment {k} err {d.max().item()} beyond {what}")
    return perr, serr, bitwise


def resnet50_leaf_shapes():
    """(node, name, shape) of the 161 parameter leaves of full-size
    ResNet-50, read off the configuration."""
    from deeplearning4j_tpu_torch.models import ResNet50
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    conf = ResNet50(num_classes=1000, image_size=224).conf()
    out = []
    for name in sorted(conf.nodes):
        node = conf.nodes[name]
        if node.kind != "layer":
            continue
        layer = node.layer
        if isinstance(layer, L.ConvolutionLayer):
            kh, kw = layer.kernel_size
            shapes = {"W": (layer.n_out, layer.n_in, kh, kw)}
            if layer.has_bias:
                shapes["b"] = (layer.n_out,)
        elif isinstance(layer, L.BatchNormalization):
            shapes = {"beta": (layer.n_in,), "gamma": (layer.n_in,)}
        elif isinstance(layer, L.DenseLayer):
            shapes = {"W": (layer.n_in, layer.n_out)}
            if layer.has_bias:
                shapes["b"] = (layer.n_out,)
        else:
            continue
        out += [(name, k, s) for k, s in sorted(shapes.items())]
    return out


def time_fused_update(dev, gen, flush):
    """At the main path's bucket: Nesterovs with bf16 state (the train
    path) and Adam with float32 state, each kernel against its plain
    version; the per-leaf apply_updater over the 161 leaves; drawing the
    bits; and, for Adam, torch.optim.Adam(fused=True) on the same bucket
    (a yardstick only: the port never calls it)."""
    from deeplearning4j_tpu_torch.learning import precision
    from deeplearning4j_tpu_torch.ops import update
    from deeplearning4j_tpu_torch.parallel.sharding import Zero1Plan

    n = RESNET50_PARAMS
    rows = {}
    for kind, bf16, per_elem in (("nesterovs", True, 20),
                                 ("adam", False, 28)):
        p, g, slots, bits = _update_case(kind, n, bf16, dev, gen)
        sr = torch.bfloat16 if bf16 else None
        upd = _updater(kind, "bfloat16" if bf16 else None)
        sc = update._scalars(upd, kind, 3)
        nbytes = per_elem * n
        flops = {"nesterovs": 6, "adam": 14}[kind] * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / F32_FLOPS_PER_S * 1e3
        row = {
            "ms": _time_ms(lambda: update.fused_update_cuda(
                kind, sc, p, g, slots, bits, sr), flush),
            "plain_ms": _time_ms(lambda: update.fused_update_reference(
                kind, sc, p, g, slots, bits, sr), flush),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "library_ms": None}
        # the per-leaf path over ResNet-50's 161 leaves (views of the same
        # buckets, as the graph holds them)
        shapes = resnet50_leaf_shapes()
        tree = {}
        for node, name, shape in shapes:
            tree.setdefault(node, {})[name] = torch.empty(shape,
                                                          device="meta")
        plan = Zero1Plan(tree, 1)
        check(plan.buckets[0].total == n, f"ResNet-50 has "
              f"{plan.buckets[0].total} parameters, not {n}")
        pt, gt = plan.unflatten({"flat::float32": p}), \
            plan.unflatten({"flat::float32": g})
        st = {k: plan.unflatten({"flat::float32": v})
              for k, v in slots.items()}
        lgen = torch.Generator(device=dev)
        lgen.manual_seed(SEED)
        row["unfused_ms"] = _time_ms(lambda: precision.apply_updater(
            upd, gt, st, pt, 3, lgen), flush)
        if bf16:
            row["bits_ms"] = _time_ms(lambda: precision.random_bits(
                n, lgen, dev), flush)
            row["bits_bound_ms"] = 4 * n / HBM_BYTES_PER_S * 1e3
        else:
            lib_p = p.clone()
            lib_p.grad = g.clone()
            opt = torch.optim.Adam([lib_p], lr=1e-3, betas=(0.9, 0.999),
                                   eps=1e-8, fused=True)
            row["library_ms"] = _time_ms(opt.step, flush)
        rows[f"{kind}_{'bf16' if bf16 else 'f32'}"] = row
        del p, g, slots, bits, pt, gt, st
    return rows


def phase_fused_update(smi: str, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    perr = serr = 0.0
    n_cases = n_bitwise = 0
    sizes = [RESNET50_PARAMS, 1, 5, 4097]
    for kind in UPDATE_KINDS:
        for bf16 in (False, True):
            cases = [(n, (0, 0)) for n in sizes]
            # a view 1 element into its buffer: all tensors (head path)
            # and p alone (the scalar variant)
            cases += [(4097, (1, 1)), (4097, (1, 0))]
            for n, off in cases:
                pe, se, bw = compare_fused_update(kind, n, bf16, dev, gen,
                                                  off)
                perr, serr = max(perr, pe), max(serr, se)
                n_cases += 1
                n_bitwise += int(bw)
    log(f"[kernels] fused_update vs plain: {n_cases} comparisons (4 kinds x "
        f"f32/bf16 state x sizes {sizes} + 2 offset views) ok; "
        f"{n_bitwise} of {n_cases} bitwise; max param err {perr}, max "
        f"moment err {serr}")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timing = time_fused_update(dev, gen, flush)
    for name, t in timing.items():
        extra = (f"bits {t['bits_ms']:.4f} ms (bound {t['bits_bound_ms']:.4f})"
                 if "bits_ms" in t else
                 f"torch.optim.Adam(fused=True) {t['library_ms']:.4f} ms")
        log(f"[kernels] fused_update {name} n={RESNET50_PARAMS}: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, per-leaf "
            f"apply_updater (161 leaves) {t['unfused_ms']:.4f} ms, {extra}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} B "
            f"at 3.35 TB/s); median of {TIMED_RUNS} (CUDA events, cold L2); "
            f"{smi}")
    return {"max_err_param": perr, "max_err_moment": serr,
            "bitwise": n_bitwise, "cases": n_cases}, timing


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


# --- phases 6 and 7 -----------------------------------------------------------

def train_model(dev, fused: bool, compute_dtype, state_dtype):
    """Full-size ResNet-50 as bench.py trains it (models/zoo.py: Nesterovs
    0.1/0.9, l2 1e-4), random weights from the seed."""
    from deeplearning4j_tpu_torch.models import ResNet50

    model = ResNet50(num_classes=1000, image_size=IMAGE, seed=SEED).init(
        device=dev)
    gc = model.conf.global_conf
    gc.compute_dtype = compute_dtype
    gc.fused_update = fused
    gc.updater.state_dtype = state_dtype
    return model


def synthetic_batch(batch: int, dev, seed: int):
    """bench.py's synthetic batch: inputs N(0, 1), one-hot labels, from the
    seed, placed on the card once."""
    from deeplearning4j_tpu_torch.data import DataSet

    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 3, IMAGE, IMAGE).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.randint(0, 1000, batch)]
    return DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))


def phase_train(smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import epilogue, update

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = train_model(dev, True, "bfloat16", "bfloat16")
    ds = synthetic_batch(TRAIN_BATCH, dev, SEED)
    losses = []
    for _ in range(TRAIN_WARMUP):
        model.fit(ds)
        torch.cuda.synchronize()
        losses.append(model.score_value)
    bucket = model._flat.params["flat::float32"]
    before = bucket.clone()
    prof = OpProfiler.get()
    prof.reset()
    update.reset_launches()
    epilogue.reset_launches()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(model.score_value)
    launches = update.fused_update_launches
    counters = prof.get_counters()
    peak = torch.cuda.max_memory_allocated()
    changed = not torch.equal(before, bucket)
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(launches == TRAIN_STEPS, f"fused_update launched {launches} times "
          f"in {TRAIN_STEPS} steps (want 1 per step: one float32 bucket)")
    check(counters.get("precision/fused_buckets_kernel", 0) == TRAIN_STEPS,
          f"kernel buckets {counters.get('precision/fused_buckets_kernel')}")
    check(counters.get("precision/fused_fallbacks", 0) == 0,
          f"fused fallbacks {counters.get('precision/fused_fallbacks')}")
    check(counters.get("precision/grads_flat_in_step") == 1,
          "gradients were not born flat")
    state_bytes = counters.get("precision/updater_state_bytes_bfloat16", 0)
    check(state_bytes == 2 * RESNET50_PARAMS
          and counters.get("precision/updater_state_bytes_total") ==
          state_bytes, f"updater state {state_bytes} B, want "
          f"{2 * RESNET50_PARAMS} B of bfloat16")
    check(changed, "parameters did not change")
    ms = sorted(t * 1e3 for t in times)
    pct = lambda q: ms[min(len(ms) - 1, int(round(q * (len(ms) - 1))))]  # noqa: E731
    result = {"images_per_s": TRAIN_BATCH * TRAIN_STEPS / sum(times),
              "step_ms_median": statistics.median(ms),
              "step_ms_p10": pct(0.1), "step_ms_p90": pct(0.9),
              "losses": losses, "peak_bytes": peak,
              "state_bytes": state_bytes, "launches": launches,
              "bn_act_launches": epilogue.bn_act_launches,
              "counters": {k: v for k, v in sorted(counters.items())
                           if k.startswith("precision/")}}
    log(f"[train] ResNet-50 {IMAGE}x{IMAGE} 1000 classes, batch "
        f"{TRAIN_BATCH}, bf16 "
        f"compute, Nesterovs + l2, fused_update, bf16 state: "
        f"{result['images_per_s']:.2f} images/s, step ms median "
        f"{result['step_ms_median']:.2f} p10 {result['step_ms_p10']:.2f} "
        f"p90 {result['step_ms_p90']:.2f} ({TRAIN_STEPS} steps after "
        f"{TRAIN_WARMUP} warm-up); peak memory {peak} B; updater state "
        f"{state_bytes} B; fused_update launches {launches}; {smi}")
    log(f"[train] losses {losses}")
    log(f"[train] counters {result['counters']}")
    del model, ds, before
    torch.cuda.empty_cache()
    return result


def _f32_ulp_of(v: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(v.abs())
    return torch.ldexp(torch.ones_like(v), e - 24)


def phase_train_parity(dev):
    """One fit step through the kernel against one through the per-leaf
    apply_updater path from the same parameters."""
    from deeplearning4j_tpu_torch.common.environment import Environment
    from deeplearning4j_tpu_torch.parallel.sharding import leaf_paths

    Environment.get().set_tf32(False)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ds = synthetic_batch(8, dev, SEED + 4)
        runs = []
        for fused in (True, False):
            m = train_model(dev, fused, None, None)
            m.fit(ds)
            torch.cuda.synchronize()
            runs.append(m)
        a, b = runs
        worst = {"params": 0.0, "momentum": 0.0}
        bitwise = True
        for what, ta, tb in (("params", a._params, b._params),
                             ("momentum", a._updater_state["v"],
                              b._updater_state["v"])):
            for n, k in leaf_paths(tb):
                x, y = ta[n][k].detach(), tb[n][k].detach()
                d = (x - y).abs()
                bitwise = bitwise and torch.equal(x, y)
                ulps = (d / _f32_ulp_of(torch.maximum(x.abs(), y.abs())
                                        .clamp_min(2.0 ** -126))).max().item()
                worst[what] = max(worst[what], ulps)
        check(worst["params"] <= 2 and worst["momentum"] <= 2,
              f"fused vs per-leaf step: {worst} f32 ulp (want <= 2)")
        log(f"[train-parity] batch 8, float32, TF32 off, deterministic "
            f"cuDNN, float32 state: fused kernel step vs per-leaf step: "
            f"params within {worst['params']:.2f} ulp, momentum within "
            f"{worst['momentum']:.2f} ulp (bound 2); bitwise {bitwise}; "
            f"loss {a.score_value} vs {b.score_value}")
        del runs, a, b
        torch.cuda.empty_cache()
        return {"worst_ulp": worst, "bitwise": bitwise}
    finally:
        torch.backends.cudnn.deterministic = det


# --- phase 8 -------------------------------------------------------------------

def zipf_sentences(n_words: int, vocab_size: int = W2V_VOCAB,
                   sent_len: int = 20, seed: int = 123):
    """bench.py's word2vec corpus: zipf(1) word ids, 20-word sentences."""
    rng = np.random.default_rng(seed)
    n_sent = max(1, n_words // sent_len)
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    words = np.array([f"w{i}" for i in range(vocab_size)])
    ids = rng.choice(vocab_size, size=(n_sent, sent_len), p=p)
    return [" ".join(row) for row in words[ids]]


def cluster_corpus(n_sent: int, sent_len: int = 12, seed: int = 0):
    """tests/test_nlp.py's corpus: two disjoint 50-word clusters."""
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(50)]
    B = [f"b{i}" for i in range(50)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=sent_len))
            for _ in range(n_sent)]


def bench_word2vec(dev, sents):
    """The word2vec-cbow model of bench.py (bench_word2vec_variant)."""
    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(min_word_frequency=5, layer_size=100, window=5,
                   negative=5, sampling=1e-3, epochs=1, batch_size=8192,
                   seed=42, algorithm="cbow", device=dev)
    w2v.set_sentence_iterator(sents)
    return w2v


def phase_word2vec(smi: str, dev):
    from deeplearning4j_tpu_torch.common.profiler import OpProfiler
    from deeplearning4j_tpu_torch.ops import embeddings

    t0 = time.perf_counter()
    sents = zipf_sentences(W2V_WORDS)
    corpus_s = time.perf_counter() - t0
    w2v = bench_word2vec(dev, sents)
    prof = OpProfiler.get()
    prof.reset()
    embeddings.reset_launches()
    fits = []
    for label in ("cold", "warm"):
        launches0 = embeddings.embedding_bag_launches
        rounds0 = prof.counter_value("nlp/w2v_rounds")
        t0 = time.perf_counter()
        w2v.fit()
        wall = time.perf_counter() - t0
        timing = w2v.last_fit_timing
        fits.append({
            "fit": label, "words_per_s": w2v.words_per_sec,
            "pairs_per_s": w2v.pairs_per_sec, "last_loss": w2v.last_loss,
            "launches": embeddings.embedding_bag_launches - launches0,
            "rounds": prof.counter_value("nlp/w2v_rounds") - rounds0,
            "blocks": timing["blocks"], "wall_s": wall,
            "prepare_s": timing["prepare"], "train_s": timing["train"],
            "ms_per_block": timing["train"] / max(timing["blocks"], 1) * 1e3})
    launches = embeddings.embedding_bag_launches
    vocab = len(w2v.vocab)
    syn0, syn1 = w2v.lookup_table.syn0, w2v.lookup_table.syn1neg
    check(len(w2v.vocab) == W2V_VOCAB, f"vocabulary {len(w2v.vocab)}, want "
          f"{W2V_VOCAB}")
    check(w2v._cbow_centers == 8192, f"{w2v._cbow_centers} examples per "
          f"round, want 8192")
    check(w2v.table_device is not None and w2v.table_device.type == "cuda",
          f"tables trained on {w2v.table_device}")
    for f in fits:
        check(f["launches"] == f["rounds"] == W2V_ROUNDS_PER_FIT
              and f["blocks"] * 64 == f["rounds"],
              f"{f['fit']} fit: {f['launches']} embedding_bag launches, "
              f"{f['rounds']} rounds, {f['blocks']} blocks (want "
              f"{W2V_ROUNDS_PER_FIT} launches, one per round)")
        check(np.isfinite(f["last_loss"]) and f["last_loss"] < np.log(2.0),
              f"{f['fit']} fit: last loss {f['last_loss']} not finite or "
              f"not below ln 2")
    check(bool(np.isfinite(syn0).all() and np.isfinite(syn1).all()),
          "tables not finite")
    for f in fits:
        log(f"[word2vec-cbow] {f['fit']} fit: {f['words_per_s']:.1f} words/s, "
            f"{f['pairs_per_s']:.1f} examples/s over the train window "
            f"{f['train_s']:.3f} s ({f['blocks']} blocks, "
            f"{f['ms_per_block']:.2f} ms per block); host prepare "
            f"(tokenize, count, encode) {f['prepare_s']:.3f} s of "
            f"{f['wall_s']:.3f} s fit wall; embedding_bag launches "
            f"{f['launches']} = rounds {f['rounds']}; last loss "
            f"{f['last_loss']:.6f}; {smi}")
    log(f"[word2vec-cbow] vocabulary {len(w2v.vocab)}, corpus "
        f"{len(sents) * 20} words (made in {corpus_s:.2f} s), 8192 examples "
        f"per round; similarity(w1, w2) {w2v.similarity('w1', 'w2'):.4f}")
    del w2v, sents
    torch.cuda.empty_cache()

    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w = Word2Vec(min_word_frequency=5, layer_size=24, negative=5,
                 algorithm="cbow", epochs=10, batch_size=256, seed=2,
                 device=dev)
    w.set_sentence_iterator(cluster_corpus(1000))
    w.fit()
    same = float(np.mean([w.similarity("a0", f"a{i}") for i in range(1, 6)]))
    diff = float(np.mean([w.similarity("a0", f"b{i}") for i in range(5)]))
    check(same > diff + 0.4, f"cluster corpus on the card: same {same} not "
          f"above diff {diff} + 0.4")
    log(f"[word2vec-cbow] cluster corpus on the card: same {same:.4f}, diff "
        f"{diff:.4f} (gate same > diff + 0.4), last loss {w.last_loss:.4f}")
    return {"fits": fits, "launches": launches, "vocab": vocab,
            "cluster_same": same, "cluster_diff": diff}


# --- main -----------------------------------------------------------------------

def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available; the port's main path "
              "runs on the card", file=sys.stderr)
        return 2
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
        from deeplearning4j_tpu_torch.ops import embeddings, epilogue, update
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    kernels = []
    try:
        smi, name = phase_device()
        phase_build()
        errs, timing = phase_kernels(smi, dev)
        upd_errs, upd_timing = phase_fused_update(smi, dev)
        bag_err, bag_timing = phase_embedding_bag(smi, dev)
        model = build_model(dev)
        launches, batches = phase_serving(model, smi, dev)
        phase_parity(model, dev)
        del model
        torch.cuda.empty_cache()
        train = phase_train(smi, dev)
        tparity = phase_train_parity(dev)
        w2v = phase_word2vec(smi, dev)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    bf, f32 = timing[torch.bfloat16], timing[torch.float32]
    kernels.append({
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
        "batches": batches})
    nb, ad = upd_timing["nesterovs_bf16"], upd_timing["adam_f32"]
    kernels.append({
        "name": "fused_update", "route": "cuda", "source": update.SOURCE,
        "replaces": update.REPLACES, "launches": train["launches"],
        "max_abs_err": max(upd_errs["max_err_param"],
                           upd_errs["max_err_moment"]),
        "max_err_param": upd_errs["max_err_param"],
        "max_err_moment": upd_errs["max_err_moment"],
        "bitwise_cases": f"{upd_errs['bitwise']}/{upd_errs['cases']}",
        "shape": [RESNET50_PARAMS], "kind": "nesterovs",
        "state_dtype": "bfloat16",
        "ms": nb["ms"], "plain_ms": nb["plain_ms"],
        "bound_ms": nb["bound_ms"], "bound_by": nb["bound_by"],
        "library_ms": None, "unfused_ms": nb["unfused_ms"],
        "bits_ms": nb["bits_ms"],
        "adam_f32": {k: ad[k] for k in ("ms", "plain_ms", "unfused_ms",
                                        "bound_ms", "library_ms")}})
    bp = bag_timing["path"]
    kernels.append({
        "name": "embedding_bag", "route": "cuda",
        "source": embeddings.SOURCE, "replaces": embeddings.REPLACES,
        "launches": w2v["launches"], "max_abs_err": bag_err,
        "shape": bp["shape"], "dtype": "float32",
        "ms": bp["ms"], "plain_ms": bp["plain_ms"],
        "bound_ms": bp["bound_ms"], "bound_by": bp["bound_by"],
        "library_ms": bp["library_ms"], "unfused_ms": bp["unfused_ms"],
        "bytes": bp["bytes"], "bytes_no_reuse": bp["bytes_no_reuse"],
        "indices": bp["indices"],
        **{name: {k: bag_timing[name][k] for k in (
            "shape", "indices", "ms", "plain_ms", "library_ms", "unfused_ms",
            "bound_ms", "bytes", "bytes_no_reuse")}
           for name in ("path_raw_zipf", "wide")}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items()
                                if k != "counters"},
                      "train_parity": tparity,
                      "word2vec_cbow": w2v}), flush=True)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
