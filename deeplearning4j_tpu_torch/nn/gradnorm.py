"""Gradient normalization and clipping between the backward and the update.

Counterpart of ``_normalize_gradients``
(``deeplearning4j_tpu/nn/multilayer.py:1105-1120``), which the JAX networks
apply after the backward and before the updater whenever
``GlobalConf.grad_normalization`` is set (``nn/graph.py:781-786``). The
port's networks call :func:`normalize_gradients_` at the same point.
"""

from __future__ import annotations

from typing import Sequence

import torch

#: the modes the JAX package accepts (case-insensitive)
MODES = ("clipelementwiseabsolutevalue", "clipl2pergradient",
         "clipl2perparamtype", "renormalizel2perlayer")


def normalize_gradients_(grads: Sequence[torch.Tensor], mode: str,
                         threshold: float) -> None:
    """Normalize ``grads`` in place (the JAX function returns new arrays).

    ``grads`` are the gradient leaves in ``leaf_paths`` order (the order of
    ``jax.tree.leaves``), the one order in which the global norm is summed.

    - ``clipelementwiseabsolutevalue``: each element clamped to
      ``[-threshold, threshold]``.
    - ``clipl2pergradient``: each leaf scaled by ``threshold / ||g||`` where
      its L2 norm exceeds the threshold.
    - ``clipl2perparamtype`` and ``renormalizel2perlayer``: every leaf
      scaled by ``min(1, threshold / max(||all||, 1e-12))``, with the norm
      taken over all the leaves together. The JAX code does exactly this
      for both modes (neither per parameter type nor per layer), and the
      port follows the code.

    An unknown mode raises ``ValueError``, as in the JAX package.
    """
    mode = mode.lower()
    if mode not in MODES:
        raise ValueError(f"unknown gradient normalization {mode!r}")
    with torch.no_grad():
        if mode == "clipelementwiseabsolutevalue":
            for g in grads:
                g.clamp_(-threshold, threshold)
        elif mode == "clipl2pergradient":
            for g in grads:
                n = torch.sqrt(torch.sum(torch.square(g)))
                g.copy_(torch.where(n > threshold, g * (threshold / n), g))
        else:
            # the JAX code's Python sum: 0 + s_0 + s_1 + ... in leaf order
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
            scale = torch.clamp(threshold / torch.clamp(gnorm, min=1e-12),
                                max=1.0)
            for g in grads:
                g.mul_(scale)
