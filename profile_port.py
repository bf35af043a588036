#!/usr/bin/env python3
"""Where one ResNet-50 serving forward, or one training step, of the port
spends its time, on the card.

    python3 profile_port.py          # serving forward; needs one card
    python3 profile_port.py --train  # training step (chip_smoke phase 6)
    python3 profile_port.py --word2vec  # one CBOW block (chip_smoke phase 8)

Builds the model ``chip_smoke.py`` serves (full-size ResNet-50, seeded random
weights, calibrated BN statistics, bf16 compute) and prints, beside the
card's name and power limit:

- the time of one forward (host clock around work that ends in
  ``torch.cuda.synchronize()``, median of 10 after 3 warm-ups) at batch 1, 8
  and 32, fused epilogue on, and at batch 32 with it off;
- a ``torch.profiler`` trace of 3 forwards at batch 32: the device's busy
  share of the wall time and the kernels that take the most device time.
  The Chrome trace goes to ``chiprun_out/profile_port_trace.json``.

With ``--train`` it builds the model ``chip_smoke.py`` trains (full-size
ResNet-50, bf16 compute, fused_update, bf16 updater state, batch 128) and
prints the step time (median of 10 after 2 warm-ups) and a
``torch.profiler`` trace of 3 steps: device busy share, the kernels that take
the most device time, and the ``fused_update`` kernel's share. The trace goes
to ``chiprun_out/profile_port_train_trace.json.gz``.

With ``--word2vec`` it builds the word2vec-cbow model ``chip_smoke.py`` fits
(vocabulary 10,000, layer 100, window 5, 5 negatives, 8192 examples per
round), fits it once to make the vocabulary, tables, corpus buffers and
negative pool, and then runs single 64-round CBOW blocks from the stream's
start: the host time of a block (enqueue, and to completion), a
``torch.profiler`` trace of one block (device busy share of the wall, device
operations per round, device time of the ``embedding_bag`` kernel, of the
``index_add_`` scatter-adds and of the rest), and whether two runs of the
block from the same tables give bitwise equal tables, with ``index_add_``'s
atomics and with ``torch.use_deterministic_algorithms``. The trace goes to
``chiprun_out/profile_port_w2v_trace.json.gz``.

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


#: kernel-name patterns of the device-time breakdown, first match wins
CATEGORIES = (("fused_update", ("fused_update",)),
              ("bn_act", ("bn_act",)),
              ("embedding_bag", ("embedding_bag",)),
              ("scatter-add (index_add_)", ("indexFunc", "index_add",
                                            "indexing_backward")),
              ("cuDNN/cuBLAS (conv, matmul, layout transposes)",
               ("cudnn", "conv", "xmma", "gemm", "cutlass", "sm90",
                "nchwToNhwc", "nhwcToNchw")),
              ("reductions", ("reduce_kernel",)),
              ("elementwise", ("elementwise",)),
              ("memcpy/memset", ("Memcpy", "Memset")))


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _profile(step, n: int, label: str, smi: str, trace: str) -> dict:
    """``n`` calls of ``step`` under torch.profiler: wall time and the
    device time of the kernels (device-side events only: operator events
    also carry their kernels' time and would count it twice), per call, by
    category and by kernel. The Chrome trace goes to
    ``chiprun_out/<trace>``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    device_us = sum(us for us, _ in by_name.values())
    cats = {}
    for kname, (us, _) in by_name.items():
        c = _category(kname)
        cats[c] = cats.get(c, 0.0) + us / n / 1e3
    top = [{"name": k[:80], "device_ms": us / n / 1e3,
            "calls_per_call": c / n}
           for k, (us, c) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:15]]
    print(f"[profile] {label}, {n} calls: wall {wall_us / n / 1e3:.3f} "
          f"ms/call, device busy {device_us / n / 1e3:.3f} ms/call "
          f"({100 * device_us / wall_us:.1f}% of wall); {smi}", flush=True)
    for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:8.3f} ms  {c}", flush=True)
    for t in top:
        print(f"[profile]   {t['device_ms']:8.3f} ms  x{t['calls_per_call']:.0f}"
              f"  {t['name']}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", trace))
    return {"profiled_wall_ms": wall_us / 1e3 / n,
            "device_ms": device_us / 1e3 / n,
            "device_ops_per_call": sum(c for _, c in by_name.values()) / n,
            "device_busy_share": device_us / wall_us if wall_us else None,
            "device_ms_by_category": cats, "top_kernels": top}


def train_main(dev, smi: str, name: str) -> int:
    model = cs.train_model(dev, True, "bfloat16", "bfloat16")
    ds = cs.synthetic_batch(cs.TRAIN_BATCH, dev, cs.SEED)
    for _ in range(2):
        model.fit(ds)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"[train] batch {cs.TRAIN_BATCH} bf16, fused_update, bf16 state: "
          f"step {ms:.3f} ms ({cs.TRAIN_BATCH / ms * 1e3:.1f} images/s), "
          f"median of 10; {smi}", flush=True)
    prof = _profile(lambda: model.fit(ds), 3, f"train step batch "
                    f"{cs.TRAIN_BATCH}", smi, "profile_port_train_trace.json.gz")
    upd_ms = prof["device_ms_by_category"].get("fused_update", 0.0)
    print(f"[profile] fused_update kernel: {upd_ms:.3f} ms per step, "
          f"{100 * upd_ms / prof['device_ms']:.2f}% of device time; {smi}",
          flush=True)
    result = {"device": name, "nvidia_smi": smi, "train_step_ms": ms,
              "images_per_s": cs.TRAIN_BATCH / ms * 1e3,
              "fused_update_ms_per_step": upd_ms, **prof}
    print(json.dumps(result), flush=True)
    return 0


def word2vec_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.nlp.vocab import subsample_keep_probs
    from deeplearning4j_tpu_torch.nlp.word2vec import _subsample

    w2v = cs.bench_word2vec(dev, cs.zipf_sentences(cs.W2V_WORDS))
    w2v.fit()
    R, W = w2v.MAX_BLOCK_ROUNDS, w2v.window
    span = w2v._cbow_centers * R
    corpus = w2v._encode_corpus(w2v._token_stream())
    flat, (ids, sent) = w2v._device_corpus(corpus, span)
    keep = torch.from_numpy(subsample_keep_probs(
        w2v.vocab, w2v.sampling).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(w2v.seed)
    u = torch.rand(ids.shape[0], generator=gen, device=dev)
    ids, sent, n_valid = _subsample(ids, sent, keep, flat.size, u, W)
    b = torch.randint(1, W + 1, (span,), generator=gen, device=dev)
    negpool = w2v._negpool()
    lrs = torch.full((R,), 0.0125, dtype=torch.float32, device=dev)
    start = [torch.from_numpy(w2v.lookup_table.syn0).to(dev),
             torch.from_numpy(w2v.lookup_table.syn1neg).to(dev)]
    tables = [t.clone() for t in start]

    def block():
        return w2v._cbow_block(tables[0], tables[1], ids, sent, n_valid,
                               negpool, 0, lrs, b, 0)

    def timed_runs(n: int):
        enq, full = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            block()
            enq.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            full.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(enq), statistics.median(full)

    def repeat_is_bitwise():
        outs = []
        for _ in range(2):
            for t, s in zip(tables, start):
                t.copy_(s)
            block()
            torch.cuda.synchronize()
            outs.append([t.clone() for t in tables])
        return all(torch.equal(a, b) for a, b in zip(*outs))

    block()
    torch.cuda.synchronize()
    enq_ms, block_ms = timed_runs(5)
    print(f"[word2vec] one CBOW block (64 rounds of 8192): host enqueue "
          f"{enq_ms:.3f} ms, to completion {block_ms:.3f} ms, median of 5; "
          f"{smi}", flush=True)
    prof = _profile(block, 1, "one CBOW block", smi,
                    "profile_port_w2v_trace.json.gz")
    cats = prof["device_ms_by_category"]
    bag_ms = cats.get("embedding_bag", 0.0)
    add_ms = cats.get("scatter-add (index_add_)", 0.0)
    rest_ms = prof["device_ms"] - bag_ms - add_ms
    print(f"[profile] per round: {prof['device_ops_per_call'] / R:.1f} "
          f"device operations; embedding_bag {bag_ms / R * 1e3:.2f} us, "
          f"index_add_ {add_ms / R * 1e3:.2f} us, rest "
          f"{rest_ms / R * 1e3:.2f} us of device time; {smi}", flush=True)
    atomic_bitwise = repeat_is_bitwise()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_bitwise = repeat_is_bitwise()
        det_enq_ms, det_block_ms = timed_runs(5)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"[word2vec] two runs of the block from the same tables: bitwise "
          f"{atomic_bitwise} with index_add_'s atomics; with "
          f"torch.use_deterministic_algorithms bitwise {det_bitwise}, block "
          f"{det_block_ms:.3f} ms (enqueue {det_enq_ms:.3f} ms) against "
          f"{block_ms:.3f} ms; {smi}", flush=True)
    result = {"device": name, "nvidia_smi": smi, "block_ms": block_ms,
              "block_enqueue_ms": enq_ms, "rounds": R,
              "embedding_bag_ms_per_block": bag_ms,
              "index_add_ms_per_block": add_ms, "rest_ms_per_block": rest_ms,
              "device_ops_per_round": prof["device_ops_per_call"] / R,
              "repeat_bitwise_atomic": atomic_bitwise,
              "repeat_bitwise_deterministic": det_bitwise,
              "deterministic_block_ms": det_block_ms, **prof}
    print(json.dumps(result), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA card available", file=sys.stderr)
        return 2
    if "--word2vec" in sys.argv[1:]:
        # cuBLAS's deterministic workspace, for the determinism check; set
        # before the first cuBLAS handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    smi, name = cs.phase_device()
    if "--word2vec" in sys.argv[1:]:
        cs.phase_build()
        return word2vec_main(dev, smi, name)
    if "--train" in sys.argv[1:]:
        cs.phase_build()
        return train_main(dev, smi, name)
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

    forward_ms(model, x32, runs=1, warmup=2)
    prof = _profile(lambda: model.output(x32), 3, "batch 32 bf16 fused "
                    "forward", smi, "profile_port_trace.json")
    result.update(prof)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
