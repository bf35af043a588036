"""Which version of a kernel op runs: its hand-written kernel or its plain
PyTorch version.

One rule for the three ops modules that carry a kernel with a plain twin
(``ops/update.py``, ``ops/epilogue.py``, ``ops/embeddings.py``). It gives
the card every route that the JAX package computes: there the Pallas
kernel runs only for the dtypes it takes and never under a gradient, and
everything else goes through the same math in its ``xla`` mode.

- A CPU tensor takes the plain version.
- A CUDA tensor takes the kernel when the kernel takes its dtype and no
  gradient is needed through it. Otherwise it takes the plain version on
  the card, and the caller counts that under its ``..._plain_on_card``
  counter.
- Any other device raises.

The rule reads the device type, whether the kernel takes the tensor and
whether a gradient is needed, and nothing else. It never looks at a build
or a launch: a kernel that fails to build or to launch raises, and the
plain version does not stand in for it.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """True under grad mode when any of ``tensors`` (``None`` skipped)
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def use_kernel(device: torch.device, takes: bool, *grad_inputs) -> bool:
    """True for a CUDA ``device`` when the kernel takes the tensor
    (``takes``: its dtype, and layout) and no gradient is needed through
    any of ``grad_inputs`` (:func:`needs_grad`); False for the CPU and for
    the plain version on the card. Raises for any other device."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no implementation for {device}")
    return takes and not needs_grad(*grad_inputs)
