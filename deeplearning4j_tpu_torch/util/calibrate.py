"""BatchNorm running statistics from one batch, for models with random
weights.

A freshly initialized ResNet-50 keeps BN's default state (mean 0, var 1),
so nothing normalizes its activations: they grow through the 16 residual
blocks and the softmax saturates to one-hot rows, against which any
comparison is blind. :func:`calibrate_batchnorm` walks the graph once in
float32 on the dense path and sets each BN layer's running mean and
variance to its input's own statistics on ``x``, so the activations stay
of order one; checks then perturb those statistics from a seed.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..nn.conf import layers as L


def calibrate_batchnorm(graph, x) -> Dict[str, Dict[str, torch.Tensor]]:
    """Set the running statistics of every BatchNormalization layer of
    ``graph`` from batch ``x`` (one input network), in network order; each
    layer sees the output of the already-calibrated layers before it.
    Returns the new states (also installed on the graph)."""
    graph._check_init()
    conf = graph.conf
    if len(conf.network_inputs) != 1:
        raise ValueError("calibrate_batchnorm takes one-input graphs")
    acts: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for name in conf.order:
            node = conf.nodes[name]
            if node.kind == "input":
                acts[name] = graph._to_device(x).to(torch.float32)
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(*ins)
                continue
            h = ins[0]
            if 0 in node.preprocessors:
                h = node.preprocessors[0](h)
            if isinstance(node.layer, L.BatchNormalization):
                dims = (0, 2, 3) if h.ndim == 4 else (0,)
                graph._states[name] = {
                    "mean": h.mean(dim=dims).float().clone(),
                    "var": h.var(dim=dims, unbiased=False).float().clone()}
            acts[name], _ = node.layer.apply(graph._params.get(name, {}), h,
                                             graph._states.get(name, {}))
    return graph._states
