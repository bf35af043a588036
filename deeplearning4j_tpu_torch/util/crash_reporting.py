"""CrashReportingUtil: the out-of-memory / crash post-mortem memory report.

Counterpart of ``deeplearning4j_tpu/util/crash_reporting.py`` (reference:
dl4j-nn ``org/deeplearning4j/nn/util/CrashReportingUtil.java``, SURVEY
§2.3 Common/infra, §5.3): system info with the card's allocator figures
(``common/system_info.py``), parameter counts and bytes per layer, and an
activation-memory estimate per layer at a given minibatch — the numbers
that tell a user WHICH layer filled the card. The estimate reads the
shapes off the configuration's output-type chain (a
``MultiLayerConfiguration``'s ``layer_output_types``, a graph's
``node_output_types``) in the network's compute dtype; it runs no
forward.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

from ..common.tree import get_path, leaf_paths


def _leaves(tree) -> list:
    return [get_path(tree, p) for p in leaf_paths(tree)]


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _tree_count(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


def generate_memory_status_report(model, minibatch: int = 32) -> str:
    """The crash-report body: system info + per-layer parameter and
    activation memory for a ``MultiLayerNetwork`` or
    ``ComputationGraph``."""
    from ..common.system_info import SystemInfo

    lines = [f"=== deeplearning4j-tpu memory status report "
             f"({datetime.datetime.now().isoformat(timespec='seconds')}) ===",
             SystemInfo.dump(), "", f"--- model (minibatch={minibatch}) ---"]
    total_param_bytes = 0
    for label, p in _layer_params(model):
        pb = _tree_bytes(p)
        total_param_bytes += pb
        lines.append(f"layer {label}: {_tree_count(p):,} params, "
                     f"{pb / 2**20:.2f} MiB")
    lines.append(f"total parameters: {total_param_bytes / 2**20:.2f} MiB "
                 "(x2-3 live during training: gradients + updater state)")
    try:
        act_bytes = _activation_estimate(model, minibatch, lines)
        lines.append(f"activation estimate (fwd, minibatch {minibatch}): "
                     f"{act_bytes / 2**20:.2f} MiB (backward roughly "
                     "doubles this without gradient_checkpointing)")
    except Exception as e:           # the estimate is best-effort
        lines.append(f"activation estimate unavailable: {e}")
    return "\n".join(lines)


def _layer_params(model) -> List[Tuple[str, dict]]:
    """(label, parameter tree) per layer: a ``MultiLayerNetwork``'s by
    index and class, a graph's by vertex name (the JAX labels)."""
    params = model._params
    keys = getattr(model, "_keys", None)
    if keys is not None:
        layers = model.conf.layers
        return [(f"{i} ({type(layers[i]).__name__})", params[k])
                for i, k in enumerate(keys)]
    return [(str(n), p) for n, p in params.items()]


def _shape(t, minibatch: int) -> Tuple[int, ...]:
    from ..nn.conf.inputs import (CNN3DInput, CNNFlatInput, CNNInput,
                                  FFInput, RNNInput)

    if isinstance(t, FFInput):
        return (minibatch, t.size)
    if isinstance(t, RNNInput):
        return (minibatch, t.timesteps or 16, t.size)
    if isinstance(t, CNNInput):
        return (minibatch, t.channels, t.height, t.width)
    if isinstance(t, CNN3DInput):
        return (minibatch, t.channels, t.depth, t.height, t.width)
    if isinstance(t, CNNFlatInput):
        return (minibatch, t.channels * t.height * t.width)
    raise ValueError(f"unsupported output type {t}")


def _activation_estimate(model, minibatch: int, lines) -> int:
    from ..common.dtypes import torch_dtype

    gc = model.conf.global_conf
    itemsize = torch_dtype(gc.compute_dtype or gc.dtype).itemsize
    conf = model.conf
    if hasattr(conf, "layer_output_types"):
        rows = [(f"{i} {type(layer).__name__}", t) for i, (layer, t)
                in enumerate(zip(conf.layers, conf.layer_output_types))]
    else:
        inputs = set(conf.network_inputs)
        rows = []
        for name, t in conf.node_output_types.items():
            if name in inputs:
                continue
            node = conf.nodes[name]
            obj = node.layer if node.layer is not None else node.vertex
            rows.append((f"{name} {type(obj).__name__}", t))
    if not rows:
        raise ValueError("the configuration has no output types "
                         "(set_input_type was not called)")
    total = 0
    for label, t in rows:
        shape = _shape(t, minibatch)
        n = 1
        for s in shape:
            n *= s
        nbytes = n * itemsize
        total += nbytes
        lines.append(f"  activation[{label}]: {shape} = "
                     f"{nbytes / 2**20:.2f} MiB")
    return total


def write_memory_crash_dump(model, path: Optional[str] = None,
                            minibatch: int = 32) -> str:
    """Write the report to ``path`` (default: cwd
    ``dl4j-tpu-memory-crash-dump-<ts>.txt``) and return the path — the
    reference's ``writeMemoryCrashDump`` contract."""
    if path is None:
        ts = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        path = os.path.abspath(f"dl4j-tpu-memory-crash-dump-{ts}.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(generate_memory_status_report(model, minibatch))
    return path


class CrashReportingUtil:
    """Reference-shaped static facade."""

    generate_memory_status_report = staticmethod(
        generate_memory_status_report)
    write_memory_crash_dump = staticmethod(write_memory_crash_dump)
    # reference spelling
    writeMemoryCrashDump = staticmethod(write_memory_crash_dump)
