#!/usr/bin/env python3
"""Where one ResNet-50 serving forward, one training step, one CBOW block or
one encoder forward of the port spends its time, on the card.

    python3 profile_port.py          # serving forward; needs one card
    python3 profile_port.py --train  # training step (chip_smoke phase 6)
    python3 profile_port.py --mln    # VGG16 training step (phase 12)
    python3 profile_port.py --transfer  # re-headed VGG16 step (phase 26)
    python3 profile_port.py --word2vec  # one skip-gram and one CBOW block
    python3 profile_port.py --fasttext  # one FastText block (phase 20)
    python3 profile_port.py --glove     # one GloVe block (phase 21)
    python3 profile_port.py --encoder   # one encoder forward (phase 9)
    python3 profile_port.py --encoder-train  # one encoder fit step (9b)
    python3 profile_port.py --zoo [NAME]  # a zoo CNN's step and forward (24)
    python3 profile_port.py --flash [--levers]  # flash: bf16, then float32
    python3 profile_port.py --bert      # one SameDiff BERT-base step
    python3 profile_port.py --textgen   # one TextGenerationLSTM TBPTT batch
    python3 profile_port.py --bag [--levers] [--timeline]  # embedding_bag
    python3 profile_port.py --package DIR --bag  # DIR's port, this code
    python3 profile_port.py --alternate DIR --flash  # DIR's port and this
    python3 profile_port.py --bag-build "-DDL4J_BAG_STREAM=1" --word2vec

``--package DIR`` imports ``deeplearning4j_tpu_torch`` from DIR (a checkout
of another commit, e.g. ``git archive`` of the parent) instead of from
beside this script, and builds DIR's kernels into DIR: parent and change are
then measured by the same code, in turns, in one call. ``--bag-build OPTS``
builds ``csrc/embedding_bag.cu`` with the -D options OPTS (the measurement
settings its header lists) and has ``embedding_bag_cuda`` launch that build
in whatever mode follows. ``--alternate DIR`` runs one mode (``--flash`` or
``--bag``) as processes of their own on DIR's package and on this one in
turns (parent, change, change, parent, ...; ``--rounds`` each, 3 by
default) and prints the medians of each run's summary side by side.

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

With ``--encoder-train`` it builds the encoder ``chip_smoke.py`` trains
in phase 9b (BERT-base width, bf16 compute, Adam(2e-5) through
fused_update, batch 32) and prints a ``torch.profiler`` trace of 3 fit
steps by category (trace ``chiprun_out/profile_port_encoder_train_trace
.json.gz``). With ``--zoo NAME`` (Xception unless named) it builds that
zoo CNN as phase 24 trains and serves it (its defaults, bf16 compute,
fused_update, batch 16) and prints the step time and a trace of 3 fit
steps, then of 3 served forwards with fused_epilogue on, by category
(traces ``chiprun_out/profile_port_zoo_<NAME>_{train,serve}.json.gz``).

With ``--textgen`` it builds the TextGenerationLSTM of ``chip_smoke.py``
phase 25 (hidden 256, float32, Adam(2e-3) through fused_update, truncated
BPTT of 50 steps) and traces one fit of a batch of 32 sequences of 1,000
characters (20 segments) after a warm-up and 3 timed fits: device time by
class (cuBLAS, elementwise, reductions, ``fused_update``, copies), device
launches per timestep (the batch's launches over its 1,000 steps), the
host time per launch (the unprofiled batch time over the launches) and
the busy share (device time over the unprofiled and the profiled wall);
then the same trace for one ``rnn_time_step`` of one character. The
trace goes to ``chiprun_out/profile_port_textgen_trace.json.gz``.

With ``--mln`` it builds the VGG16 ``MultiLayerNetwork`` that
``chip_smoke.py`` trains (zoo VGG16, 138,357,544 parameters, bf16 compute,
fused_update, bf16 updater state, dropout 0.5 on both 4096 layers, batch 64
of 8-bit pixels scaled to [0, 1]) and prints the step time (median of 10
after 2 warm-ups) and a ``torch.profiler`` trace of 3 steps: device busy
share of the wall, device time by category (cuDNN/cuBLAS, elementwise,
reductions, ``fused_update``, the random bits of dropout's masks and of
stochastic rounding) and the kernels that take the most device time. Then
the loss of 4 float32 steps from N(0, 1) images (at the zoo's learning
rate of 0.01 and at 0.001) against 8-bit pixels scaled to [0, 1] (why
chip_smoke feeds the latter). The trace goes to
``chiprun_out/profile_port_mln_trace.json.gz``.

With ``--word2vec`` it first builds bench.py's word2vec model (skip-gram,
negative sampling; chip_smoke phase 14), fits it once and profiles one
skip-gram block from the stream's start: the pack (derive, compact, the
count's readback) and the ceil(count / B) rounds of 8190 pairs, with the
same report as the CBOW block's below (trace
``chiprun_out/profile_port_sg_trace.json.gz``). Then it builds the
word2vec-cbow model ``chip_smoke.py`` fits (vocabulary 10,000, layer 100,
window 5, 5 negatives, 8192 examples per round), fits it once to make the
vocabulary, tables, corpus buffers and negative pool, and then runs single
64-round CBOW blocks from the stream's start: the host time of a block (enqueue, and to completion), a
``torch.profiler`` trace of one block (device busy share of the wall, device
operations per round, device time of the ``embedding_bag`` kernel, of the
``index_add_`` scatter-adds and of the rest, and of every kernel; the host's
enqueue time per device operation), and whether two runs of the
block from the same tables give bitwise equal tables, with ``index_add_``'s
atomics and with ``torch.use_deterministic_algorithms``. The trace goes to
``chiprun_out/profile_port_w2v_trace.json.gz``.

With ``--fasttext`` it fits chip_smoke phase 20's FastText once and
profiles one block from the stream's start (pack, then the rounds of 8190
pairs, each one embedding_bag launch on [8190, G] bags of the [V + 100,000,
100] table), and with ``--glove`` it counts phase 21's co-occurrences on the
host (timed) and profiles the first block of 64 AdaGrad rounds; both with the
``--word2vec`` report (device busy share, device time by class, device
operations per round, host time per operation; traces
``chiprun_out/profile_port_{fasttext,glove}_trace.json.gz``).

With ``--encoder`` it builds the BERT-base-width encoder ``chip_smoke.py``
serves (seeded random weights, bf16 compute, float32 parameters) and prints
the time of one ``ComputationGraph.output`` forward at batch 32 and 1
(median of 10 after 3 warm-ups) and a ``torch.profiler`` trace of 3
forwards at batch 32: device busy share of the wall, device time by
category with the ``flash_attention`` kernel on its own line, and the
kernels that take the most device time. Then it counts the copy kernels
(casts and layout copies) of one whole forward, and lists the kernels of
one attention op by category: the projections' matmuls, the flash kernel,
and the casts or copies around it, which should be none. The trace goes to
``chiprun_out/profile_port_encoder_trace.json.gz``.

With ``--bag`` it times the embedding_bag kernel as chip_smoke.py phase 3
does, at the CBOW path's [8192, 10] x [10000, 100] with subsampled-zipf
indices and at the wide [8192, 10] x [3,000,000, 300]: cold and warm L2,
host time per launch, plain version, F.embedding_bag and the bound; its
bf16 route at [8192, 10] and PV-DM's [8192, 11] beside the float32 route
on the same values; and chip_smoke phase 16's bf16-table CBOW: a fit's
words/s, then one block's device time, bag time, host enqueue and
completion (trace ``chiprun_out/profile_port_cbow_bf16_trace.json.gz``).
With ``--levers`` also the kernel as each measurement build of BAG_LEVERS
and BAG16_LEVERS (the designs' levers undone or pushed, -D options)
computes it, and with ``--timeline`` the per-bag timeline of a build
stamped with %globaltimer.

With ``--bert`` it imports the BERT-base frozen graph ``chip_smoke.py``
phase 18 fine-tunes (``bench.py --config bert``: batch 32, T 128, float32,
TF32 off, Adam(2e-5), the [768, 3] head) and profiles one serving forward
of the pooled output and one fine-tune step (the step ``SameDiff.fit``
runs: forward and backward by autograd over the graph walk, then the
per-leaf Adam), each after warm-ups: the host's enqueue time, the wall to
completion, device busy share, device time by class (GEMM, elementwise,
reductions, softmax, the embedding gather and its backward scatter-add,
copies), launches per call and host time per launch; then the per-leaf
Adam alone (its kernels, launches and device time), whose share of the
step's elementwise time it names. Traces go to
``chiprun_out/profile_port_bert_{forward,step}_trace.json.gz``.

With ``--flash`` it times the bf16 flash kernel beside
F.scaled_dot_product_attention on the same bf16 tensors at T 128 for B*H
from 12 to 768, and at [96, 512, 64]; then the float32 kernel (3xTF32) at
[384, 128, 64] and [96, 512, 64] beside SDPA in float32 and its bound, and
one float32 encoder forward at batch 32 (12 float32 flash launches; trace
``chiprun_out/profile_port_encoder_f32_trace.json.gz``). With ``--levers``
also the float32 kernel's measurement builds (FLASH_LEVERS: the TF32
rounding by cvt.rna, and a build that counts each loop phase's clock64
cycles per block), each bitwise-checked against the shipped build and
timed in turns with it.

The last line is one JSON object with the numbers.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def forward_ms(model, *inputs, runs: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        model.output(*inputs)
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model.output(*inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


CUBLAS = "cuDNN/cuBLAS (conv, matmul, layout transposes)"
#: kernel-name patterns of the device-time breakdown, first match wins
CATEGORIES = (("flash_attention", ("flash_fwd_kernel", "flash_bf16_kernel")),
              ("fused_update", ("fused_update",)),
              ("random bits (dropout masks, stochastic rounding)",
               ("distribution_elementwise", "uniform_", "random_")),
              ("bn_act", ("bn_act",)),
              ("embedding_bag", ("embedding_bag",)),
              ("scatter-add (index_add_)", ("indexFunc", "index_add",
                                            "indexing_backward")),
              (CUBLAS,
               ("cudnn", "conv", "xmma", "gemm", "cutlass", "sm90", "nvjet",
                "nchwToNhwc", "nhwcToNchw")),
              ("reductions", ("reduce_kernel",)),
              ("elementwise", ("elementwise",)),
              ("memcpy/memset", ("Memcpy", "Memset")))


#: the SameDiff BERT step's classes (lower-case patterns, first match wins)
BERT_CATEGORIES = (("GEMM (cuBLAS)", ("gemm", "cutlass", "sm90", "nvjet",
                                      "xmma")),
                   ("softmax", ("softmax",)),
                   ("gather (index_select)", ("indexselect", "index_select")),
                   ("scatter-add (gather backward)", ("indexfunc",
                                                      "index_add",
                                                      "indexing_backward")),
                   ("reductions", ("reduce_kernel",)),
                   ("elementwise", ("elementwise",)),
                   ("copies (memcpy/memset, layout)", ("memcpy", "memset",
                                                       "copy")))


def _category(name: str, table=CATEGORIES, lower: bool = False) -> str:
    key = name.lower() if lower else name
    for cat, keys in table:
        if any(k in key for k in keys):
            return cat
    return "other"


def _profile(step, n: int, label: str, smi: str, trace: str,
             categorize=_category) -> dict:
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
        c = categorize(kname)
        cats[c] = cats.get(c, 0.0) + us / n / 1e3
    kernels = [{"name": k[:80], "device_ms": us / n / 1e3,
                "calls_per_call": c / n}
               for k, (us, c) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])]
    print(f"[profile] {label}, {n} calls: wall {wall_us / n / 1e3:.3f} "
          f"ms/call, device busy {device_us / n / 1e3:.3f} ms/call "
          f"({100 * device_us / wall_us:.1f}% of wall); {smi}", flush=True)
    for c, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:8.3f} ms  {c}", flush=True)
    for t in kernels[:15]:
        print(f"[profile]   {t['device_ms']:8.3f} ms  x{t['calls_per_call']:.0f}"
              f"  {t['name']}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    prof.export_chrome_trace(os.path.join("chiprun_out", trace))
    return {"profiled_wall_ms": wall_us / 1e3 / n,
            "device_ms": device_us / 1e3 / n,
            "device_ops_per_call": sum(c for _, c in by_name.values()) / n,
            "device_busy_share": device_us / wall_us if wall_us else None,
            "device_ms_by_category": cats, "kernels": kernels}


def _device_kernels(step) -> dict:
    """Names and counts of the device kernels of one call of ``step``
    (after a warm-up call), from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def attention_op_census(dev, smi: str) -> dict:
    """The kernels of one encoder attention op (``multi_head_dot_product_
    attention`` on bf16 [32, 128, 768] with bf16 [768, 768] projections, 12
    heads, as each encoder layer calls it), by category: the projections'
    matmuls, the flash kernel, and anything else (the float32 casts and
    head copies that the float32 route runs around its kernel: 8 per op)."""
    from deeplearning4j_tpu_torch.ops import nn as ops

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.randn((cs.ENC_BATCH, cs.SEQ_LEN, 768), generator=gen,
                    device=dev).to(torch.bfloat16)
    ws = [(torch.randn((768, 768), generator=gen, device=dev) * 0.03)
          .to(torch.bfloat16) for _ in range(4)]
    counts = _device_kernels(lambda: ops.multi_head_dot_product_attention(
        x, x, x, *ws, num_heads=12))
    by_cat = {}
    for kname, n in counts.items():
        c = _category(kname)
        by_cat[c] = by_cat.get(c, 0) + n
    other = {k[:80]: n for k, n in counts.items()
             if _category(k) not in ("flash_attention", CUBLAS)}
    n_other = sum(other.values())
    print(f"[profile] one attention op (bf16, [32, 128, 768], 12 heads): "
          f"{sum(counts.values())} kernels: {by_cat}; casts, copies and "
          f"other kernels around flash: {n_other} per op, "
          f"{n_other * 12} per forward {other}; {smi}", flush=True)
    return {"kernels_by_category": by_cat, "other_kernels": other,
            "other_per_forward": n_other * 12}


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


def mln_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import VGG16

    def vgg(compute_dtype):
        net = VGG16(seed=cs.SEED).init(device=dev)
        gc = net.conf.global_conf
        gc.compute_dtype = compute_dtype
        gc.fused_update = True
        gc.updater.state_dtype = "bfloat16"
        return net

    net = vgg("bfloat16")
    ds = cs.vgg_batch(dev, cs.SEED + 20)
    for _ in range(cs.VGG_WARMUP):
        net.fit(ds)
    torch.cuda.synchronize()
    times = []
    for _ in range(cs.VGG_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"[mln] VGG16 batch {cs.VGG_BATCH} bf16, fused_update, bf16 state, "
          f"dropout 0.5 x2: step {ms:.3f} ms ({cs.VGG_BATCH / ms * 1e3:.1f} "
          f"images/s), median of {cs.VGG_STEPS}; {smi}", flush=True)
    prof = _profile(lambda: net.fit(ds), 3, f"VGG16 train step batch "
                    f"{cs.VGG_BATCH}", smi, "profile_port_mln_trace.json.gz")
    upd_ms = prof["device_ms_by_category"].get("fused_update", 0.0)
    print(f"[profile] fused_update kernel: {upd_ms:.3f} ms per step, "
          f"{100 * upd_ms / prof['device_ms']:.2f}% of device time; {smi}",
          flush=True)
    del net
    torch.cuda.empty_cache()
    # why chip_smoke feeds pixels in [0, 1]: the loss from N(0, 1) images
    rng = np.random.RandomState(cs.SEED + 20)
    normal = DataSet(torch.from_numpy(rng.randn(
        cs.VGG_BATCH, 3, cs.IMAGE, cs.IMAGE).astype(np.float32)).to(dev),
        ds.labels)
    inputs = {}
    # the same N(0, 1) images at a tenth of the zoo's learning rate: a step
    # that overshoots diverges at 0.01 and not at 0.001, while a fault of
    # the initialization or of dropout's scale would not depend on it
    for label, data, lr in (("normal", normal, None),
                            ("normal_lr1e-3", normal, 1e-3),
                            ("pixels01", ds, None)):
        net = vgg(None)
        if lr is not None:
            net.conf.global_conf.updater.learning_rate = lr
        losses = []
        for _ in range(4):
            net.fit(data)
            losses.append(net.score_value)
        inputs[label] = losses
        print(f"[mln] float32 VGG16, 4 steps from {label} inputs: losses "
              f"{losses}; {smi}", flush=True)
        del net
        torch.cuda.empty_cache()
    result = {"device": name, "nvidia_smi": smi, "train_step_ms": ms,
              "images_per_s": cs.VGG_BATCH / ms * 1e3,
              "fused_update_ms_per_step": upd_ms, "input_losses": inputs,
              **prof}
    print(json.dumps(result), flush=True)
    return 0


def transfer_main(dev, smi: str, name: str) -> int:
    """One fit step of chip_smoke phase 26's re-headed VGG16 (layers 0-19
    frozen, a 5-class head, bf16 compute, fused_update, batch 15) by
    category: the frozen forward, the head, the update over all
    134,281,029 elements, and the copies that keep the frozen ranges."""
    from deeplearning4j_tpu_torch.models import VGG16

    net = cs.reheaded(VGG16(seed=cs.SEED).init(device=dev), cs.TL_FC2)
    torch.cuda.empty_cache()
    gc = net.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.fused_update = True
    ds = cs.transfer_batch(dev, cs.SEED + 70)
    for _ in range(cs.TL_WARMUP):
        net.fit(ds)
    torch.cuda.synchronize()
    times = []
    for _ in range(cs.TL_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"[transfer] re-headed VGG16 ({net.num_params()} parameters, "
          f"{cs.TL_TRAINABLE} trainable) batch {cs.TL_BATCH} bf16, "
          f"fused_update: step {ms:.3f} ms ({cs.TL_BATCH / ms * 1e3:.1f} "
          f"images/s), median of {cs.TL_STEPS}; {smi}", flush=True)
    prof = _profile(lambda: net.fit(ds), 3, f"re-headed VGG16 fit step "
                    f"batch {cs.TL_BATCH}", smi,
                    "profile_port_transfer_trace.json.gz")
    cats = prof["device_ms_by_category"]
    upd = cats.get("fused_update", 0.0)
    copies = cats.get("memcpy/memset", 0.0)
    print(f"[profile] fused_update over {net.num_params()} elements: "
          f"{upd:.3f} ms per step ({100 * upd / prof['device_ms']:.2f}% of "
          f"device time); copies and fills (the frozen ranges kept aside "
          f"and written back, the gradient bucket zeroed): {copies:.3f} ms "
          f"({100 * copies / prof['device_ms']:.2f}%); {smi}", flush=True)
    result = {"device": name, "nvidia_smi": smi, "step_ms": ms,
              "images_per_s": cs.TL_BATCH / ms * 1e3,
              "fused_update_ms_per_step": upd, "copies_ms_per_step": copies,
              **prof}
    print(json.dumps(result), flush=True)
    return 0


def _bert_category(name: str) -> str:
    return _category(name, BERT_CATEGORIES, lower=True)


def _host_and_wall(fn, runs: int = 5):
    """Medians of the host's enqueue time of ``fn`` (it must not wait for
    the card) and of its wall time to completion, in ms."""
    host, wall = [], []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def bert_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.autodiff.samediff import TREE
    from deeplearning4j_tpu_torch.imports import import_frozen_tf
    from deeplearning4j_tpu_torch.imports.tf_fixtures import \
        build_bert_frozen_graph

    data, names, _ = build_bert_frozen_graph(**cs.bert_dims(cs.SD_BATCH))
    sd = import_frozen_tf(data, device=dev)
    del data
    cs.bert_fine_tune_graph(sd, cs.BERT["hidden"], cs.SD_BATCH, cs.SEED)
    feed, labels = cs.bert_feed(names, cs.SD_BATCH, dev)
    batch = dict(feed, labels=labels)
    pooled = sd.tf_outputs[0]
    result = {"device": name, "nvidia_smi": smi,
              "graph_ops_per_forward": len(sd._plan((pooled,))),
              "graph_ops_to_loss": len(sd._plan(("loss",)))}

    def forward():
        sd.output(feed, [pooled])

    step_fn = sd._train_step_fn("loss")
    upd = sd._training_config.updater
    state = {"s": upd.init({TREE: sd._params()})}
    feeds = sd._feeds(batch)

    def step():
        # the step SameDiff.fit runs, without fit's loss readback
        params, state["s"], _ = step_fn(sd._params(), state["s"], feeds,
                                        sd._iteration)
        for n, t in params.items():
            sd._vars[n].value = t
        sd._iteration += 1

    for label, fn, trace in (
            ("serving forward (pooled, batch 32)", forward,
             "profile_port_bert_forward_trace.json.gz"),
            ("fine-tune step (batch 32)", step,
             "profile_port_bert_step_trace.json.gz")):
        for _ in range(2):
            fn()
        host, wall = _host_and_wall(fn)
        prof = _profile(fn, 3, f"SameDiff BERT-base {label}", smi, trace,
                        _bert_category)
        ops = prof["device_ops_per_call"]
        print(f"[bert] {label}: host enqueue {host:.3f} ms, wall {wall:.3f} "
              f"ms, {ops:.0f} device operations, {host / ops * 1e3:.2f} us "
              f"of host time per launch; {smi}", flush=True)
        key = "forward" if fn is forward else "step"
        result[key] = {"host_ms": host, "wall_ms": wall,
                       "host_us_per_launch": host / ops * 1e3, **prof}
    params = {TREE: sd._params()}
    grads = {TREE: {n: torch.full_like(p, 1e-3)
                    for n, p in params[TREE].items()}}
    n = sum(p.numel() for p in params[TREE].values())

    def adam_step():
        upd.apply(grads, state["s"], params, 5)

    host, wall = _host_and_wall(adam_step)
    adam = _profile(adam_step, 3, f"per-leaf Adam alone "
                    f"({len(params[TREE])} leaves)", smi,
                    "profile_port_bert_adam_trace.json.gz", _bert_category)
    # its bytes bound: each leaf reads p, g, m, v once and writes p, m, v
    bound = 7 * 4 * n / cs.HBM_BYTES_PER_S * 1e3
    step_elem = result["step"]["device_ms_by_category"].get("elementwise", 0)
    print(f"[bert] per-leaf Adam over {n} elements: host enqueue {host:.3f} "
          f"ms, wall {wall:.3f} ms, {adam['device_ops_per_call']:.0f} "
          f"launches ({host / adam['device_ops_per_call'] * 1e3:.2f} us of "
          f"host time each), {adam['device_ms']:.3f} ms of device time "
          f"(bytes bound {bound:.3f} ms): "
          f"{100 * adam['device_ms'] / result['step']['device_ms']:.1f}% of "
          f"the step's device time, {100 * adam['device_ms'] / step_elem:.1f}"
          f"% of its elementwise time; {smi}", flush=True)
    result["adam"] = {"host_ms": host, "wall_ms": wall, "elements": n,
                      "bound_ms": bound, **adam}
    print(json.dumps(result), flush=True)
    return 0


def _stream(w2v, dev, span: int):
    """The fitted model's corpus buffers, subsampled on the card with the
    model's seed: (ids, sentence ids, kept count, generator)."""
    from deeplearning4j_tpu_torch.nlp.vocab import subsample_keep_probs
    from deeplearning4j_tpu_torch.nlp.word2vec import _subsample

    corpus = w2v._encode_corpus(w2v._token_stream())
    flat, (ids, sent) = w2v._device_corpus(corpus, span)
    keep = torch.from_numpy(subsample_keep_probs(
        w2v.vocab, w2v.sampling).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(w2v.seed)
    u = torch.rand(ids.shape[0], generator=gen, device=dev)
    return (*_subsample(ids, sent, keep, flat.size, u, w2v.window), gen)


def _block_report(label: str, block, rounds: int, smi: str, trace: str):
    """Host enqueue and completion times of ``block`` (median of 5), a
    torch.profiler trace of one call: device busy, operations per round,
    the bag's and index_add_'s device time, host time per device
    operation."""

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

    block()
    torch.cuda.synchronize()
    enq_ms, block_ms = timed_runs(5)
    print(f"[word2vec] {label}: host enqueue {enq_ms:.3f} ms, to completion "
          f"{block_ms:.3f} ms, median of 5; {smi}", flush=True)
    prof = _profile(block, 1, label, smi, trace)
    cats = prof["device_ms_by_category"]
    bag_ms = cats.get("embedding_bag", 0.0)
    add_ms = cats.get("scatter-add (index_add_)", 0.0)
    rest_ms = prof["device_ms"] - bag_ms - add_ms
    host_per_op_us = enq_ms * 1e3 / prof["device_ops_per_call"]
    print(f"[profile] {label}, per round: "
          f"{prof['device_ops_per_call'] / rounds:.1f} device operations; "
          f"embedding_bag {bag_ms / rounds * 1e3:.2f} us, index_add_ "
          f"{add_ms / rounds * 1e3:.2f} us ({100 * add_ms / prof['device_ms']:.1f}"
          f"% of the device time), rest {rest_ms / rounds * 1e3:.2f} us; "
          f"host enqueue per device operation {host_per_op_us:.2f} us "
          f"({enq_ms:.3f} ms over {prof['device_ops_per_call']:.0f} "
          f"operations); device busy {prof['device_ms']:.3f} ms of "
          f"{block_ms:.3f} ms; {smi}", flush=True)
    print(f"[profile] {label}, device time by kernel (ms, launches):",
          flush=True)
    for k in prof["kernels"]:
        print(f"[profile]   {k['device_ms']:8.4f} ms  "
              f"x{k['calls_per_call']:.0f}  {k['name']}", flush=True)
    return {"block_ms": block_ms, "block_enqueue_ms": enq_ms,
            "rounds": rounds, "embedding_bag_ms_per_block": bag_ms,
            "host_us_per_device_op": host_per_op_us,
            "index_add_ms_per_block": add_ms, "rest_ms_per_block": rest_ms,
            "index_add_share": add_ms / prof["device_ms"],
            "device_ops_per_round": prof["device_ops_per_call"] / rounds,
            **prof}, timed_runs


def skipgram_block(dev, smi: str, sents) -> dict:
    """One skip-gram block of bench.py's word2vec model from the stream's
    start (after a fit that makes the vocabulary, tables, buffers and
    pool): the pack (derive and compact, then the count's readback) and
    the ceil(count / B) rounds, each profiled."""
    w = cs.w2v_model(dev)
    w.set_sentence_iterator(sents)
    w.fit()
    S = w._window_span
    ids, sent, n_valid, gen = _stream(w, dev, S)
    b = torch.randint(1, w.window + 1, (S,), generator=gen, device=dev)
    negpool = w._negpool()
    packed_c, packed_x, pending = w._sg_pack(ids, sent, n_valid, 0, b)
    count = pending.get()
    B = w._round_pairs
    rounds = -(-count // B)
    tables = [torch.from_numpy(t).to(dev) for t in (
        w.lookup_table.syn0, w.lookup_table.syn1neg)]

    def pack():
        return w._sg_pack(ids, sent, n_valid, 0, b)[2].get()

    def block():
        return w._sg_block(tables[0], tables[1], packed_c, packed_x, count,
                           negpool, 0.0125, 0.0124, 0)

    pack_prof = _profile(pack, 3, "skip-gram pack and count readback", smi,
                         "profile_port_sg_pack_trace.json.gz")
    out, _ = _block_report(f"one skip-gram block ({rounds} rounds of {B} "
                           f"pairs, {count} pairs)", block, rounds, smi,
                           "profile_port_sg_trace.json.gz")
    out.update(count=count, pairs_per_round=B, pack_wall_ms=pack_prof[
        "profiled_wall_ms"], pack_device_ms=pack_prof["device_ms"])
    return out


def cbow_block(w2v, dev):
    """One CBOW block of the fitted model ``w2v`` from the stream's start
    (64 rounds), on copies of its tables in the model's table dtype:
    (block, start tables, working tables)."""
    R, W = w2v.MAX_BLOCK_ROUNDS, w2v.window
    span = w2v._cbow_centers * R
    ids, sent, n_valid, gen = _stream(w2v, dev, span)
    b = torch.randint(1, W + 1, (span,), generator=gen, device=dev)
    negpool = w2v._negpool()
    lrs = torch.full((R,), 0.0125, dtype=torch.float32, device=dev)
    start = list(w2v._tables_to_device())
    tables = [t.clone() for t in start]

    def block():
        return w2v._cbow_block(tables[0], tables[1], ids, sent, n_valid,
                               negpool, 0, lrs, b, 0)
    return block, start, tables


def word2vec_main(dev, smi: str, name: str) -> int:
    sents = cs.zipf_sentences(cs.W2V_WORDS)
    sg = skipgram_block(dev, smi, sents)
    w2v = cs.bench_word2vec(dev, sents)
    w2v.fit()
    R = w2v.MAX_BLOCK_ROUNDS
    block, start, tables = cbow_block(w2v, dev)

    def repeat_is_bitwise():
        outs = []
        for _ in range(2):
            for t, s in zip(tables, start):
                t.copy_(s)
            block()
            torch.cuda.synchronize()
            outs.append([t.clone() for t in tables])
        return all(torch.equal(a, b) for a, b in zip(*outs))

    cbow, timed_runs = _block_report("one CBOW block (64 rounds of 8192)",
                                     block, R, smi,
                                     "profile_port_w2v_trace.json.gz")
    block_ms = cbow["block_ms"]
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
    result = {"device": name, "nvidia_smi": smi, **cbow,
              "repeat_bitwise_atomic": atomic_bitwise,
              "repeat_bitwise_deterministic": det_bitwise,
              "deterministic_block_ms": det_block_ms,
              "skipgram": {k: v for k, v in sg.items() if k != "kernels"}}
    print(json.dumps(result), flush=True)
    return 0


def fasttext_main(dev, smi: str, name: str) -> int:
    """chip_smoke phase 20's FastText (bench.py --config fasttext with
    subsampling at cs.FT_SAMPLING), fitted once; then one block from the
    stream's start profiled: the pack and the ceil(count / B) rounds, each
    a CBOW round of the centers' subword rows (one embedding_bag launch)."""
    from deeplearning4j_tpu_torch.nlp import FastText

    sents = cs.zipf_sentences(cs.FT_WORDS)
    ft = (FastText.builder().min_word_frequency(5).layer_size(100)
          .negative_sample(5).epochs(1).batch_size(8192).seed(42)
          .bucket(cs.FT_BUCKET).device(dev).iterate(sents).build())
    ft.sampling = cs.FT_SAMPLING
    t0 = time.perf_counter()
    ft.fit()
    fit_s = time.perf_counter() - t0
    ft.algorithm = "skipgram"          # the windowed loop's sizing, as fit
    S = ft._window_span
    ids, sent, n_valid, gen = _stream(ft, dev, S)
    b = torch.randint(1, ft.window + 1, (S,), generator=gen, device=dev)
    negpool = ft._negpool()
    packed_c, packed_x, pending = ft._sg_pack(ids, sent, n_valid, 0, b)
    count = pending.get()
    B, G = ft._round_pairs, ft._subword_ids.shape[1]
    rounds = -(-count // B)
    tables = [torch.from_numpy(t).to(dev) for t in (
        ft.lookup_table.syn0, ft.lookup_table.syn1neg)]

    def block():
        return ft._sg_block(tables[0], tables[1], packed_c, packed_x, count,
                            negpool, 0.0125, 0.0124, 0)

    out, _ = _block_report(
        f"one FastText block ({rounds} rounds of {B} pairs, bags [{B}, {G}] "
        f"of [{tables[0].shape[0]}, 100])", block, rounds, smi,
        "profile_port_fasttext_trace.json.gz")
    out.update(count=count, pairs_per_round=B, G=G, fit_s=fit_s,
               fit_words_per_s=ft.words_per_sec, vocab=len(ft.vocab))
    result = {"device": name, "nvidia_smi": smi,
              **{k: v for k, v in out.items() if k != "kernels"}}
    print(json.dumps(result), flush=True)
    return 0


def glove_main(dev, smi: str, name: str) -> int:
    """chip_smoke phase 21's GloVe (bench.py --config glove): the host
    co-occurrence count timed, then the first epoch's first block of 64
    AdaGrad rounds profiled from the initial tables."""
    from deeplearning4j_tpu_torch.nlp import Glove

    sents = cs.zipf_sentences(cs.GLOVE_WORDS)
    g = (Glove.builder().min_word_frequency(5).layer_size(100).window_size(5)
         .epochs(5).batch_size(8192).seed(42).device(dev).iterate(sents)
         .build())
    corpus = g._encoded_corpus()
    t0 = time.perf_counter()
    host_trip = g._triplets(corpus)
    count_s = time.perf_counter() - t0
    rng = np.random.default_rng(g.seed)
    init = g._initial_tables(rng)
    tables = [torch.from_numpy(a).to(dev) for a in init]
    trip = [torch.from_numpy(a).to(dev) for a in host_trip]
    R = g.MAX_BLOCK_ROUNDS
    cols = [c[:R] for c in g._epoch_columns(trip, rng)]
    print(f"[glove] vocabulary {len(g.vocab)}, {host_trip[0].size} "
          f"triplets counted on the host in {count_s:.3f} s "
          f"({sum(c.size for c in corpus)} words); {smi}", flush=True)

    def block():
        return g._block(tables, *cols)

    out, _ = _block_report(f"one GloVe block ({R} rounds of {g.batch_size} "
                           f"triplets)", block, R, smi,
                           "profile_port_glove_trace.json.gz")
    result = {"device": name, "nvidia_smi": smi, "cooccur_s": count_s,
              "nnz": int(host_trip[0].size), "vocab": len(g.vocab),
              **{k: v for k, v in out.items() if k != "kernels"}}
    print(json.dumps(result), flush=True)
    return 0


def encoder_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    model = ComputationGraph(cs.encoder_conf()).init(seed=cs.SEED, device=dev)
    model.conf.global_conf.compute_dtype = "bfloat16"
    result = {"device": name, "nvidia_smi": smi}
    feeds = {}
    for b in (cs.ENC_BATCH, 1):
        feeds[b] = tuple(torch.from_numpy(a).to(dev)
                         for a in cs.encoder_inputs(b, cs.SEED + 20))
        ms = forward_ms(model, *feeds[b])
        result[f"forward_b{b}_ms"] = ms
        print(f"[encoder] batch {b} bf16: forward {ms:.3f} ms "
              f"({b / ms * 1e3:.1f} sequences/s), median of 10; {smi}",
              flush=True)
    prof = _profile(lambda: model.output(*feeds[cs.ENC_BATCH]), 3,
                    f"encoder forward batch {cs.ENC_BATCH} bf16", smi,
                    "profile_port_encoder_trace.json.gz")
    fa_ms = prof["device_ms_by_category"].get("flash_attention", 0.0)
    print(f"[profile] flash_attention kernel: {fa_ms:.3f} ms per forward "
          f"(12 launches), {100 * fa_ms / prof['device_ms']:.2f}% of device "
          f"time; {smi}", flush=True)
    copies = sum(n for k, n in _device_kernels(
        lambda: model.output(*feeds[cs.ENC_BATCH])).items()
        if "copy" in k.lower())
    print(f"[profile] copy kernels (casts and layout copies) in one whole "
          f"forward: {copies}; {smi}", flush=True)
    result.update({"flash_attention_ms_per_forward": fa_ms,
                   "copy_kernels_per_forward": copies,
                   "attention_op": attention_op_census(dev, smi), **prof})
    print(json.dumps(result), flush=True)
    return 0


def flash_main(dev, smi: str, name: str, levers: bool = False) -> int:
    """The bf16 flash kernel and F.scaled_dot_product_attention on the same
    bf16 tensors (the MHA op's strided views, T 128, D 64) as B*H grows,
    timed as chip_smoke times them (cold L2, the card spun first): what a
    launch costs at the smallest size, how the time grows per (batch,
    head), and where the grid needs a second wave (768 blocks of 64 q rows
    at B*H 384, against 660 resident). Then the float32 kernel at the
    encoder path's [384, 128, 64] and at [96, 512, 64] beside SDPA on the
    same float32 tensors (chip_smoke's time_flash), and one float32
    encoder forward (encoder_f32_forward). With ``levers`` also the
    measurement builds of FLASH_LEVERS (flash_levers)."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import attention

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for bh, T in ((12, 128), (96, 128), (192, 128), (384, 128), (768, 128),
                  (96, 512)):
        q, k, v, _ = cs._fa_bf16_case(bh // 12, 12, T, 64, "strided", dev,
                                      gen)
        ms = cs._time_ms(lambda: attention.flash_attention_bf16_cuda(
            q, k, v, 0.125), flush)
        sdpa = cs._time_ms(lambda: F.scaled_dot_product_attention(q, k, v),
                           flush)
        rows.append({"bh": bh, "T": T, "ms": ms, "sdpa_ms": sdpa})
        print(f"[flash] B*H {bh} T {T} D 64 bf16 strided: kernel {ms:.5f} "
              f"ms, SDPA {sdpa:.5f} ms; {smi}", flush=True)
    summary = {}
    f32 = []
    for shape in (cs.FA_PATH, cs.FA_LONG):
        t = cs.time_flash(*shape, dev, gen, flush)
        f32.append(t)
        bh, T, _ = shape
        summary[f"f32_{bh}x{T}_ms"] = t["ms"]
        summary[f"f32_{bh}x{T}_sdpa_ms"] = t["library_ms"]
        print(f"[flash] float32 route {t['shape']}: kernel {t['ms']:.5f} ms, "
              f"SDPA {t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}; FFMA bound {t['ffma_bound_ms']:.5f} ms); "
              f"{smi}", flush=True)
    enc = encoder_f32_forward(dev, smi)
    summary.update(encoder_f32_forward_ms=enc["forward_ms"],
                   encoder_f32_flash_ms=enc["flash_ms"])
    result = {"device": name, "nvidia_smi": smi, "flash": rows,
              "float32": f32, "encoder_f32": enc, "summary": summary}
    if levers:
        result["levers"] = flash_levers(dev, smi, flush)
    print(json.dumps(result), flush=True)
    return 0


#: the float32 flash kernel's measurement builds (``--flash --levers``)
FLASH_LEVERS = (("TF32 rounding by cvt.rna.tf32.f32",
                 ("-DDL4J_FLASH_CVT_RNA=1",)),
                ("phases (clock64 per block)", ("-DDL4J_FLASH_PHASES",)))
FLASH_PHASES = ("the loads' wait and the barrier", "the splits",
                "S and the barrier", "the softmax and P's split", "O")


def flash_levers(dev, smi: str, flush) -> list:
    """The float32 kernel as each build of FLASH_LEVERS computes it, at
    [384, 128, 64] and [96, 512, 64]: bitwise against the shipped build,
    timed in turns with it (shipped, lever, lever, shipped), and for the
    phases build the cycles of each phase of the k-tile loop per block
    (thread 0's clock64; two blocks share an SM, so a phase's cycles
    include the other block's issue)."""
    from deeplearning4j_tpu_torch.ops import attention

    paths = measurement_builds({f"lever{n}": d for n, (_, d) in
                        enumerate(FLASH_LEVERS)}, kernel="flash_attention")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    rows = []
    for n, (label, defines) in enumerate(FLASH_LEVERS):
        lib = ctypes.CDLL(paths[f"lever{n}"])
        fn = attention._bind(lib)

        def launch(q, k, v):
            out = torch.empty_like(q)
            bh, T, D = q.shape
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, 0, 0, 0,
                     0, 1, out.data_ptr(), None, bh, T, D, D ** -0.5, 0,
                     torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"{label}: launch failed ({err})")
            return out

        for shape in (cs.FA_PATH, cs.FA_LONG):
            q, k, v, _ = cs._fa_case(*shape, dev, gen)
            shipped = lambda: attention.flash_attention_cuda(  # noqa: E731
                q, k, v, shape[2] ** -0.5)
            bitwise = torch.equal(launch(q, k, v), shipped())
            times = {"shipped": [], "lever": []}
            for side in ("shipped", "lever", "lever", "shipped"):
                times[side].append(cs._time_ms(
                    shipped if side == "shipped" else
                    (lambda: launch(q, k, v)), flush))
            row = {"setting": label, "defines": list(defines),
                   "shape": list(shape), "bitwise_to_shipped": bitwise,
                   "ms": statistics.median(times["lever"]),
                   "shipped_ms": statistics.median(times["shipped"])}
            if "-DDL4J_FLASH_PHASES" in defines:
                bh, T, _ = shape
                blocks = bh * -(-T // attention.TILE)
                buf = torch.zeros(blocks * 5, dtype=torch.int64, device=dev)
                lib.dl4j_flash_phases.argtypes = [ctypes.c_void_p]
                cs.check(lib.dl4j_flash_phases(buf.data_ptr()) == 0,
                         "phases: buffer not set")
                launch(q, k, v)
                torch.cuda.synchronize()
                lib.dl4j_flash_phases(None)
                cycles = buf.view(blocks, 5).double().mean(0).tolist()
                row["cycles_per_block"] = dict(zip(FLASH_PHASES, cycles))
                print(f"[flash] phases per block at {list(shape)} (mean "
                      f"clock64 cycles, {-(-T // attention.TILE)} k tiles): "
                      + ", ".join(f"{p} {c:.0f} ({100 * c / sum(cycles):.1f}%)"
                                  for p, c in zip(FLASH_PHASES, cycles))
                      + f"; {smi}", flush=True)
            rows.append(row)
            print(f"[flash] {label} at {list(shape)}: {row['ms']:.5f} ms "
                  f"against the shipped build's {row['shipped_ms']:.5f} ms "
                  f"(in turns), bitwise {bitwise}; {smi}", flush=True)
    return rows


def encoder_f32_forward(dev, smi: str) -> dict:
    """The encoder chip_smoke serves, in float32 compute at its batch of
    32: one ComputationGraph.output forward (median of 10 after 3
    warm-ups), the float32 flash kernel's launches in one forward (12, one
    a layer) and its device time per forward (torch.profiler, 3
    forwards)."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import attention

    model = ComputationGraph(cs.encoder_conf()).init(seed=cs.SEED, device=dev)
    model.conf.global_conf.compute_dtype = "float32"
    feed = tuple(torch.from_numpy(a).to(dev)
                 for a in cs.encoder_inputs(cs.ENC_BATCH, cs.SEED + 20))
    ms = forward_ms(model, *feed)
    before = attention.flash_attention_launches
    model.output(*feed)
    torch.cuda.synchronize()
    launches = attention.flash_attention_launches - before
    cs.check(launches == cs.BERT["layers"], f"float32 encoder forward: "
             f"{launches} flash launches, want {cs.BERT['layers']}")
    prof = _profile(lambda: model.output(*feed), 3,
                    f"encoder forward batch {cs.ENC_BATCH} float32", smi,
                    "profile_port_encoder_f32_trace.json.gz")
    fa_ms = prof["device_ms_by_category"].get("flash_attention", 0.0)
    print(f"[flash] float32 encoder forward at batch {cs.ENC_BATCH}: "
          f"{ms:.3f} ms, {launches} float32 flash launches taking {fa_ms:.4f}"
          f" ms of device time; {smi}", flush=True)
    del model
    torch.cuda.empty_cache()
    return {"forward_ms": ms, "flash_launches": launches, "flash_ms": fa_ms,
            "device_ms": prof["device_ms"]}


#: the design's levers undone or pushed one at a time (``--bag --levers``):
#: each a measurement build of csrc/embedding_bag.cu with these -D options
BAG_LEVERS = (("chosen (float4, 4 rows in flight, default caching)", ()),
              ("float2 lanes", ("-DDL4J_BAG_VEC=2",)),
              ("8 rows in flight", ("-DDL4J_BAG_ROWS=8",)),
              ("12 rows in flight", ("-DDL4J_BAG_ROWS=12",)),
              ("16 rows in flight", ("-DDL4J_BAG_ROWS=16",)),
              ("L2 evict_last", ("-DDL4J_BAG_L2_KEEP_BYTES=26214400",)),
              ("streaming hints", ("-DDL4J_BAG_STREAM=1",)),
              ("L2 evict_last and streaming hints",
               ("-DDL4J_BAG_L2_KEEP_BYTES=26214400", "-DDL4J_BAG_STREAM=1")))
#: the same for the bf16 route's design (``--bag --levers``, at the CBOW
#: path's shape and PV-DM's [8192, 11])
BAG16_LEVERS = (("chosen (two bags a warp, 11 rows in flight, bf16x2)", ()),
                ("one bag a warp (the float route's loop, bf16x2)",
                 ("-DDL4J_BAG_PAIRS=0",)),
                ("two bags a warp, 6 rows in flight",
                 ("-DDL4J_BAG_PAIR_WORDS=24",)),
                ("two bags a warp, 16 rows in flight",
                 ("-DDL4J_BAG_PAIR_WORDS=64",)))
BAG_WIDE = (8192, 10, 3_000_000, 300)
BAG_PV_DM = (8192, 11, cs.W2V_VOCAB, 100)


def measurement_builds(variants: dict,
                       kernel: str = "embedding_bag") -> dict:
    """Build csrc/<kernel>.cu once for each entry of ``variants`` (a tag
    and its -D options), all at once, into _build/ as libraries of their
    own; return each tag's library path."""
    from deeplearning4j_tpu_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for tag, defines in variants.items():
        path = str(cuda_lib.BUILD_DIR / f"lib{kernel}_{tag}.so")
        cmd = cuda_lib._command(kernel, path)
        running[tag] = (path, subprocess.Popen(
            cmd[:1] + list(defines) + cmd[1:], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    paths = {}
    for tag, (path, proc) in running.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"{kernel} build {tag}: {log}")
        paths[tag] = path
    return paths


def use_bag_build(path):
    """Make embedding_bag_cuda launch the library at ``path`` (a build of
    measurement_builds), or the package's own build for None; return the
    loaded library."""
    from deeplearning4j_tpu_torch.ops import embeddings

    if path is None:
        embeddings._LAUNCHER = embeddings._LAUNCHER_BF16 = None
        return None
    lib = ctypes.CDLL(path)
    stream = torch._C._cuda_getCurrentRawStream
    embeddings._LAUNCHER = (embeddings.bind(lib.dl4j_embedding_bag), stream)
    embeddings._LAUNCHER_BF16 = (
        embeddings.bind(lib.dl4j_embedding_bag_bf16), stream)
    return lib


def _bag_inputs(dev, shape, dist, bf16=False):
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    table, idx, mask, counts = cs._bag_case(*shape, dev, gen, dist=dist)
    if bf16:
        table, mask, counts = cs._to_bf16_route(table, mask)
    return table, idx, mask, counts


def bag_levers(dev, smi: str, flush) -> list:
    """The kernel under each build of BAG_LEVERS, cold and warm, through
    embedding_bag_cuda (bitwise checked), at the CBOW path's shape
    (subsampled-zipf indices) and at the wide one; and the bf16 route under
    each build of BAG16_LEVERS at the CBOW path's and PV-DM's shapes."""
    from deeplearning4j_tpu_torch.ops import embeddings

    levers = {f"lever{n}": d for n, (_, d) in enumerate(BAG_LEVERS) if d}
    levers.update({f"lever16_{n}": d
                   for n, (_, d) in enumerate(BAG16_LEVERS) if d})
    paths = measurement_builds(levers)
    rows = []
    for shape, dist, bf16 in ((cs.BAG_PATH, "subsampled", False),
                              (BAG_WIDE, "uniform", False),
                              (cs.BAG_PATH, "subsampled", True),
                              (BAG_PV_DM, "subsampled", True)):
        case = _bag_inputs(dev, shape, dist, bf16)
        want = embeddings.embedding_bag_reference(*case, True)
        for n, (label, defines) in enumerate(BAG16_LEVERS if bf16
                                             else BAG_LEVERS):
            use_bag_build(paths.get(f"lever16_{n}" if bf16 else f"lever{n}"))
            launch = lambda: embeddings.embedding_bag_cuda(  # noqa: E731
                *case, True)
            cs.check(torch.equal(launch(), want), f"{label}: not bitwise")
            row = {"setting": label, "defines": list(defines),
                   "shape": list(shape), "dtype": str(case[0].dtype),
                   "ms": cs._time_ms(launch, flush),
                   "ms_warm": cs._time_ms(launch, flush, cold=False)}
            rows.append(row)
            print(f"[bag] {label}: {row['ms']:.5f} ms cold, "
                  f"{row['ms_warm']:.5f} ms warm at {list(shape)} "
                  f"{row['dtype']} ({dist}); {smi}", flush=True)
        del case, want
        torch.cuda.empty_cache()
    use_bag_build(None)
    return rows


def bag_timeline(dev, smi: str, flush) -> list:
    """One cold launch at the CBOW path's shape of the kernel built with
    ``-DDL4J_BAG_TIMELINE``: each bag's %globaltimer stamps (start, index
    chunk arrived, rows arrived and summed, stored) and SM, taken by the
    lane that leads the bag. Prints the kernel's span, how many bags were
    in flight over it, each phase's duration per bag, and whether bags with
    hotter rows wait longer (L2 hot-spotting), for subsampled-zipf and
    uniform indices on the float32 route and subsampled-zipf on the bf16
    route."""
    from deeplearning4j_tpu_torch.ops import embeddings

    lib = use_bag_build(measurement_builds(
        {"timeline": ("-DDL4J_BAG_TIMELINE",)})["timeline"])
    lib.dl4j_embedding_bag_stamps.argtypes = [ctypes.c_void_p]
    B, W, V, D = cs.BAG_PATH
    rows = []
    for dist, bf16 in (("subsampled", False), ("uniform", False),
                       ("subsampled", True)):
        case = _bag_inputs(dev, cs.BAG_PATH, dist, bf16)
        launch = lambda: embeddings.embedding_bag_cuda(  # noqa: E731
            *case, True)
        stamps = torch.zeros(B * 5, dtype=torch.int64, device=dev)
        cs.check(lib.dl4j_embedding_bag_stamps(stamps.data_ptr()) == 0,
                 "timeline: stamps not set")
        for _ in range(3):
            launch()
        flush.zero_()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        launch()
        torch.cuda.synchronize()
        lib.dl4j_embedding_bag_stamps(None)
        s = stamps.view(B, 5).cpu().numpy()
        t = s[:, :4] - s[:, 0].min()
        start, idx_at, rows_at, end = t.T
        span = int(end.max())
        grid = np.linspace(0, span, 21)
        in_flight = [int(((start <= g) & (end > g)).sum()) for g in grid]
        hot = np.bincount(case[1].long().view(-1).cpu().numpy(),
                          minlength=V)[case[1].long().cpu().numpy()].max(1)
        wait = rows_at - idx_at
        q = lambda a: [int(np.percentile(a, x)) for x in (10, 50, 90)]  # noqa: E731
        row = {"indices": dist, "span_ns": span,
               "warps_in_flight": in_flight,
               "max_warps_in_flight": max(in_flight),
               "sms": int(len(np.unique(s[:, 4]))),
               "start_ns_p10_50_90": q(start),
               "index_wait_ns_p10_50_90": q(idx_at - start),
               "rows_wait_ns_p10_50_90": q(wait),
               "store_ns_p10_50_90": q(end - rows_at),
               "warp_ns_p10_50_90": q(end - start),
               "hot_vs_rows_wait_corr": float(np.corrcoef(hot, wait)[0, 1]),
               "rows_wait_ns_hottest_decile": float(
                   wait[hot >= np.percentile(hot, 90)].mean()),
               "rows_wait_ns_coldest_decile": float(
                   wait[hot <= np.percentile(hot, 10)].mean()),
               "row_bytes_per_s_over_span": B * W * D * case[0]
               .element_size() / (span * 1e-9), "dtype": str(case[0].dtype)}
        rows.append(row)
        print(f"[timeline] {dist} {row['dtype']}: span {span} ns on "
              f"{row['sms']} SMs, at "
              f"most {row['max_warps_in_flight']} warps in flight; per warp "
              f"(p10/p50/p90 ns): start {row['start_ns_p10_50_90']}, index "
              f"wait {row['index_wait_ns_p10_50_90']}, rows wait "
              f"{row['rows_wait_ns_p10_50_90']}, store "
              f"{row['store_ns_p10_50_90']}, whole warp "
              f"{row['warp_ns_p10_50_90']}; rows wait of the bags with the "
              f"hottest rows {row['rows_wait_ns_hottest_decile']:.0f} ns "
              f"against the coldest {row['rows_wait_ns_coldest_decile']:.0f}"
              f" ns (corr {row['hot_vs_rows_wait_corr']:.3f}); row bytes "
              f"over the span {row['row_bytes_per_s_over_span'] / 1e12:.2f}"
              f" TB/s; {smi}", flush=True)
        print(f"[timeline]   warps in flight at 5% steps of the span: "
              f"{in_flight}", flush=True)
    use_bag_build(None)
    return rows


def cbow_bf16_block(dev, smi: str) -> dict:
    """chip_smoke phase 16's bf16-table CBOW (the word2vec-cbow model with
    table_dtype bfloat16 on the bench corpus): one fit with its words/s and
    bag launches, then one 64-round block from the stream's start profiled
    (the --word2vec report): its device time, the bag's share, its host
    enqueue time and its time to completion."""
    w = cs.w2v_model(dev, algorithm="cbow", table_dtype="bfloat16")
    w.set_sentence_iterator(cs.zipf_sentences(cs.W2V_WORDS))
    fit = cs.fit_counted(w, "cold")
    cs.check(fit["bf16_launches"] == fit["rounds"] == cs.W2V_ROUNDS_PER_FIT,
             f"cbow bf16: {fit['bf16_launches']} bf16 launches, "
             f"{fit['rounds']} rounds")
    print(f"[bag] bf16-table CBOW fit: {fit['words_per_s']:.0f} words/s, "
          f"{fit['bf16_launches']} bf16 bag launches; {smi}", flush=True)
    block, _, _ = cbow_block(w, dev)
    rep, _ = _block_report("one bf16-table CBOW block (64 rounds of 8192)",
                           block, w.MAX_BLOCK_ROUNDS, smi,
                           "profile_port_cbow_bf16_trace.json.gz")
    del w
    torch.cuda.empty_cache()
    return {"fit_words_per_s": fit["words_per_s"],
            "fit_launches": fit["bf16_launches"],
            "block_ms": rep["block_ms"],
            "block_enqueue_ms": rep["block_enqueue_ms"],
            "block_device_ms": rep["device_ms"],
            "block_embedding_bag_ms": rep["embedding_bag_ms_per_block"],
            "device_busy_share": rep["device_busy_share"]}


def bag_main(dev, smi: str, name: str, levers: bool,
             timeline: bool) -> int:
    """embedding_bag_cuda of the package imported (``--package``: another
    commit's) at the CBOW path's shape with subsampled-zipf indices and at
    the wide shape, as chip_smoke times it: cold, warm, host time per
    launch, beside the plain version, F.embedding_bag and the bound; its
    bf16 route at the CBOW path's and PV-DM's shapes beside the float32
    route on the same values; and phase 16's bf16-table CBOW block
    (cbow_bf16_block). With ``levers`` also the builds of BAG_LEVERS and
    BAG16_LEVERS; with ``timeline`` a stamped build's timeline
    (bag_timeline)."""
    import deeplearning4j_tpu_torch
    from deeplearning4j_tpu_torch.ops import embeddings

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    B, W, V, D = cs.BAG_PATH
    result = {"device": name, "nvidia_smi": smi,
              "package": os.path.dirname(deeplearning4j_tpu_torch.__file__)}
    before = embeddings.embedding_bag_launches
    for label, shape, dist in (("path", (B, W, V, D), "subsampled"),
                               ("wide", BAG_WIDE, "uniform")):
        t = cs.time_embedding_bag(*shape, dev, gen, flush, dist)
        result[label] = t
        print(f"[bag] {label} {t['shape']} ({dist}): kernel {t['ms']:.5f} ms "
              f"cold, {t['ms_warm']:.5f} ms warm, host {t['host_us']:.2f} us "
              f"per launch; F.embedding_bag/counts {t['library_ms']:.5f} ms; "
              f"bound {t['bound_ms']:.5f} ms ({t['distinct_rows']} distinct "
              f"rows), no reuse {t['no_reuse_ms']:.5f} ms; package "
              f"{result['package']}; {smi}", flush=True)
    for label, shape in (("bf16", (B, W, V, D)), ("bf16_pv_dm", BAG_PV_DM)):
        t = cs.time_embedding_bag(*shape, dev, gen, flush, "subsampled",
                                  bf16=True)
        result[label] = t
        print(f"[bag] {label} {t['shape']} (subsampled): bf16 route "
              f"{t['ms']:.5f} ms cold, {t['ms_warm']:.5f} ms warm, host "
              f"{t['host_us']:.2f} us per launch; the float32 route on the "
              f"same values {t['f32_ms']:.5f} ms cold, {t['f32_ms_warm']:.5f}"
              f" ms warm; bound {t['bound_ms']:.5f} ms; package "
              f"{result['package']}; {smi}", flush=True)
    cs.check(embeddings.embedding_bag_launches > before,
             "the kernel was not launched")
    result["cbow_bf16"] = cbow_bf16_block(dev, smi)
    result["summary"] = {
        "path_ms": result["path"]["ms"],
        "path_ms_warm": result["path"]["ms_warm"],
        "bf16_ms": result["bf16"]["ms"],
        "bf16_ms_warm": result["bf16"]["ms_warm"],
        "bf16_f32_route_ms": result["bf16"]["f32_ms"],
        "bf16_pv_dm_ms": result["bf16_pv_dm"]["ms"],
        "bf16_pv_dm_ms_warm": result["bf16_pv_dm"]["ms_warm"],
        **{f"cbow_bf16_{k}": result["cbow_bf16"][k] for k in (
            "block_device_ms", "block_embedding_bag_ms", "block_ms",
            "block_enqueue_ms", "fit_words_per_s")}}
    if levers:
        result["levers"] = bag_levers(dev, smi, flush)
    if timeline:
        result["timeline"] = bag_timeline(dev, smi, flush)
    print(json.dumps(result), flush=True)
    return 0


def alternate_main(parent: str, rounds: int, args: list) -> int:
    """Parent and change in turns, each run a process of its own: this
    script with ``args`` (one mode, e.g. ``--flash``) on the package in
    ``parent`` (``--package``) and on the package beside it, ``rounds``
    times each in the order parent, change, change, parent, parent, ...
    Each run's lines are echoed with its side; then the median of each
    number in the runs' ``summary`` for both sides, and their ratio."""
    order = []
    for r in range(rounds):
        order += ["parent", "change"] if r % 2 == 0 else ["change", "parent"]
    runs = {"parent": [], "change": []}
    for n, side in enumerate(order):
        cmd = [sys.executable, os.path.abspath(__file__)] + (
            ["--package", parent] if side == "parent" else []) + args
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(f"[{side} {n}] {line}", flush=True)
        cs.check(proc.returncode == 0 and bool(lines),
                 f"{side} run {n} failed (exit {proc.returncode})")
        runs[side].append(json.loads(lines[-1])["summary"])
    keys = [k for k in runs["change"][0] if k in runs["parent"][0]]
    table = {}
    for k in keys:
        p = statistics.median(r[k] for r in runs["parent"])
        c = statistics.median(r[k] for r in runs["change"])
        table[k] = {"parent": p, "change": c, "change_over_parent": c / p,
                    "parent_runs": [r[k] for r in runs["parent"]],
                    "change_runs": [r[k] for r in runs["change"]]}
        print(f"[alternate] {k}: parent {p:.5f}, change {c:.5f} "
              f"(x{c / p:.3f}); parent runs {table[k]['parent_runs']}, "
              f"change runs {table[k]['change_runs']}", flush=True)
    print(json.dumps({"alternate": args, "parent": parent,
                      "order": order, "medians": table}), flush=True)
    return 0


#: the recurrent step's classes (lower-case patterns, first match wins)
TEXTGEN_CATEGORIES = (("fused_update", ("fused_update",)),
                      ("cuBLAS (GEMM)", ("gemm", "cutlass", "sm90", "nvjet",
                                         "xmma", "cublas")),
                      ("reductions", ("reduce_kernel",)),
                      ("copies (cat, memcpy, memset)", ("cat", "memcpy",
                                                        "memset", "copy")),
                      ("elementwise", ("elementwise",)))


def textgen_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.data import DataSet

    idx, chars = cs.text_corpus()
    vocab = len(chars)
    net = cs.text_generation_net(vocab, dev)
    x, y = cs.text_batch(idx, vocab, cs.TEXT_BATCH, cs.TEXT_SEQ, dev,
                         cs.SEED + 60)
    ds = DataSet(x, y)
    net.fit(ds)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(times)

    def category(kname):
        return _category(kname, TEXTGEN_CATEGORIES, lower=True)

    fit = _profile(lambda: net.fit(ds), 1, f"TextGenerationLSTM TBPTT "
                   f"batch {cs.TEXT_BATCH} x {cs.TEXT_SEQ} characters "
                   f"({cs.TEXT_SEQ // cs.TEXT_TBPTT} segments)", smi,
                   "profile_port_textgen_trace.json.gz", category)
    launches = fit["device_ops_per_call"]
    fit["batch_ms"] = wall_ms
    fit["launches_per_timestep"] = launches / cs.TEXT_SEQ
    fit["host_us_per_launch"] = wall_ms * 1e3 / launches
    fit["busy_share_unprofiled"] = fit["device_ms"] / wall_ms
    print(f"[textgen] batch {wall_ms:.2f} ms unprofiled (median of 3); "
          f"{launches:.0f} device launches per batch: "
          f"{fit['launches_per_timestep']:.1f} per timestep, "
          f"{fit['host_us_per_launch']:.2f} us of the unprofiled wall per "
          f"launch; device time {fit['device_ms']:.3f} ms, "
          f"{fit['busy_share_unprofiled']:.3f} of the unprofiled wall "
          f"({fit['device_busy_share']:.3f} of the profiled); {smi}",
          flush=True)
    eye = torch.eye(vocab, device=dev)
    net.rnn_clear_previous_state()
    net.rnn_time_step(eye[:1])
    torch.cuda.synchronize()
    step = _profile(lambda: net.rnn_time_step(eye[:1]), 20,
                    "rnn_time_step of one character", smi,
                    "profile_port_textgen_stream_trace.json.gz", category)
    print(json.dumps({"device": name, "nvidia_smi": smi, "fit": fit,
                      "rnn_time_step": step}), flush=True)
    return 0


def encoder_train_main(dev, smi: str, name: str) -> int:
    from deeplearning4j_tpu_torch.learning.updaters import Adam
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    model = ComputationGraph(cs.encoder_conf()).init(seed=cs.SEED,
                                                     device=dev)
    gc = model.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.updater = Adam(cs.ENC_TRAIN_LR)
    gc.fused_update = True
    ds = cs.encoder_train_batch(cs.ENC_BATCH, dev, cs.SEED + 30)
    for _ in range(cs.ENC_TRAIN_WARMUP):
        model.fit(ds)
    torch.cuda.synchronize()
    prof = _profile(lambda: model.fit(ds), 3, f"encoder fit step batch "
                    f"{cs.ENC_BATCH}", smi,
                    "profile_port_encoder_train_trace.json.gz")
    print(json.dumps({"device": name, "nvidia_smi": smi, **prof}),
          flush=True)
    return 0


def zoo_main(dev, smi: str, name: str, model_name: str) -> int:
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import zoo

    net = getattr(zoo, model_name)().init(device=dev)
    gc = net.conf.global_conf
    gc.compute_dtype = "bfloat16"
    gc.fused_update = True
    x, y = cs.zoo_batch(net.conf, cs.ZOO_BATCH, cs.SEED + 40)
    ds = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    for _ in range(cs.ZOO_WARMUP):
        net.fit(ds)
    torch.cuda.synchronize()
    times = []
    for _ in range(cs.ZOO_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"[zoo] {model_name} batch {cs.ZOO_BATCH} bf16, fused_update: "
          f"step {ms:.3f} ms ({cs.ZOO_BATCH / ms * 1e3:.1f} images/s), "
          f"median of {cs.ZOO_STEPS}; {smi}", flush=True)
    train = _profile(lambda: net.fit(ds), 3, f"{model_name} fit step",
                     smi, f"profile_port_zoo_{model_name}_train.json.gz")
    cs.set_fused_epilogue(net, True)
    serve = _profile(lambda: net.output(ds.features), 3,
                     f"{model_name} served forward, fused epilogue", smi,
                     f"profile_port_zoo_{model_name}_serve.json.gz")
    print(json.dumps({"device": name, "nvidia_smi": smi, "model":
                      model_name, "train_step_ms": ms, "train": train,
                      "serve": serve}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: no CUDA card available", file=sys.stderr)
        return 2
    if "--alternate" in sys.argv[1:]:
        # parent against change, in turns, one process a run
        argv = sys.argv[1:]
        i = argv.index("--alternate")
        parent = argv[i + 1]
        rest = argv[:i] + argv[i + 2:]
        rounds = 3
        if "--rounds" in rest:
            j = rest.index("--rounds")
            rounds = int(rest[j + 1])
            rest = rest[:j] + rest[j + 2:]
        return alternate_main(parent, rounds, rest)
    if "--package" in sys.argv[1:]:
        # another checkout's deeplearning4j_tpu_torch (for parent-against-
        # change runs), measured by this script's code
        root = sys.argv[sys.argv.index("--package") + 1]
        sys.path.insert(0, os.path.abspath(root))
    if "--word2vec" in sys.argv[1:]:
        # cuBLAS's deterministic workspace, for the determinism check; set
        # before the first cuBLAS handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    smi, name = cs.phase_device()
    if "--bag-build" in sys.argv[1:]:
        # a measurement build of embedding_bag.cu launched in place of the
        # package's own (its -D options in one argument)
        defines = sys.argv[sys.argv.index("--bag-build") + 1].split()
        cs.phase_build()
        use_bag_build(measurement_builds({"variant": defines})["variant"])
        print(f"[bag] embedding_bag built with {defines}", flush=True)
    if "--word2vec" in sys.argv[1:]:
        cs.phase_build()
        return word2vec_main(dev, smi, name)
    if "--fasttext" in sys.argv[1:]:
        cs.phase_build()
        return fasttext_main(dev, smi, name)
    if "--glove" in sys.argv[1:]:
        return glove_main(dev, smi, name)
    if "--train" in sys.argv[1:]:
        cs.phase_build()
        return train_main(dev, smi, name)
    if "--mln" in sys.argv[1:]:
        cs.phase_build()
        return mln_main(dev, smi, name)
    if "--transfer" in sys.argv[1:]:
        cs.phase_build()
        return transfer_main(dev, smi, name)
    if "--textgen" in sys.argv[1:]:
        cs.phase_build()
        return textgen_main(dev, smi, name)
    if "--encoder-train" in sys.argv[1:]:
        cs.phase_build()
        return encoder_train_main(dev, smi, name)
    if "--encoder" in sys.argv[1:]:
        cs.phase_build()
        return encoder_main(dev, smi, name)
    if "--zoo" in sys.argv[1:]:
        rest = sys.argv[sys.argv.index("--zoo") + 1:]
        cs.phase_build()
        return zoo_main(dev, smi, name, rest[0] if rest and not
                        rest[0].startswith("-") else "Xception")
    if "--flash" in sys.argv[1:]:
        cs.phase_build()
        return flash_main(dev, smi, name, "--levers" in sys.argv[1:])
    if "--bert" in sys.argv[1:]:
        return bert_main(dev, smi, name)
    if "--bag" in sys.argv[1:]:
        cs.phase_build()
        return bag_main(dev, smi, name, "--levers" in sys.argv[1:],
                        "--timeline" in sys.argv[1:])
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
