"""BatchNorm running statistics from one batch, for models with random
weights.

A freshly initialized ResNet-50 keeps BN's default state (mean 0, var 1),
so nothing normalizes its activations: they grow through the 16 residual
blocks and the softmax saturates to one-hot rows, against which any
comparison is blind. :func:`calibrate_batchnorm` walks the network (a
graph or a layer stack) once in its parameters' dtype (float32 unless the
configuration's ``data_type`` says otherwise) on the dense path and sets
each BN layer's running mean and variance to its input's own statistics on
``x``, so the activations stay of order one; checks then perturb those
statistics from a seed.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..common.dtypes import torch_dtype
from ..nn.conf import layers as L


def _bn_stats(h: torch.Tensor) -> Dict[str, torch.Tensor]:
    dims = (0, 2, 3) if h.ndim == 4 else (0,)
    return {"mean": h.mean(dim=dims).float().clone(),
            "var": h.var(dim=dims, unbiased=False).float().clone()}


def calibrate_batchnorm(net, x) -> Dict[str, Dict[str, torch.Tensor]]:
    """Set the running statistics of every BatchNormalization layer of
    ``net`` (a one-input ``ComputationGraph`` or a ``MultiLayerNetwork``)
    from batch ``x``, in network order; each layer sees the output of the
    already-calibrated layers before it. Returns the new states (also
    installed on the network)."""
    net._check_init()
    conf = net.conf
    dtype = torch_dtype(conf.global_conf.dtype)
    h = net._to_device(x).to(dtype)
    with torch.no_grad():
        if not hasattr(conf, "nodes"):
            for i, layer in enumerate(conf.layers):
                pre = conf.preprocessors.get(i)
                if pre is not None:
                    h = pre(h)
                key = net._keys[i]
                if isinstance(layer, L.BatchNormalization):
                    net._states[key] = _bn_stats(h)
                h, _ = layer.apply(net._params[key], h, net._states[key])
            return net._states
        if len(conf.network_inputs) != 1:
            raise ValueError("calibrate_batchnorm takes one-input graphs")
        acts: Dict[str, torch.Tensor] = {}
        for name in conf.order:
            node = conf.nodes[name]
            if node.kind == "input":
                acts[name] = h
                continue
            ins = [acts[i] for i in node.inputs]
            if node.kind == "vertex":
                acts[name] = node.vertex.apply(*ins)
                continue
            a = ins[0]
            if 0 in node.preprocessors:
                a = node.preprocessors[0](a)
            if isinstance(node.layer, L.BatchNormalization):
                net._states[name] = _bn_stats(a)
            acts[name], _ = node.layer.apply(net._params.get(name, {}), a,
                                             net._states.get(name, {}))
    return net._states
