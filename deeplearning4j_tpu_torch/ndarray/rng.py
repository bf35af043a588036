"""The random stream: a stateful shell over ``torch.Generator``s.

Counterpart of ``deeplearning4j_tpu/ndarray/rng.py`` (reference nd4j-api
``org.nd4j.linalg.api.rng.Random``; ``Nd4j.getRandom``). One
:class:`Random` a thread (:func:`get_random`), seeded with Nd4j's default
119 unless :func:`set_default_seed` says otherwise. It keeps one generator
a device, each seeded with the stream's seed when first used, so a seed
makes a run reproducible on each device; ``set_seed`` reseeds them all.
Streams agree with the JAX package's (threefry) in distribution only. Each
draw takes ``device``: the card unless the caller asks for another.
"""

from __future__ import annotations

import threading
from typing import Dict, Sequence

import torch

from ..common.dtypes import torch_dtype
from ..common.environment import resolve_device
from .ndarray import NDArray


class Random:
    """Stateful random stream (one generator a device); thread-safe."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._gens: Dict[torch.device, torch.Generator] = {}

    def set_seed(self, seed: int) -> None:
        with self._lock:
            self._seed = int(seed)
            self._gens.clear()

    def get_seed(self) -> int:
        return self._seed

    def generator(self, device=None) -> torch.Generator:
        """The stream's generator on ``device`` (the primitive every draw
        uses), made and seeded at its first use."""
        dev = resolve_device(device)
        with self._lock:
            g = self._gens.get(dev)
            if g is None:
                g = torch.Generator(device=dev).manual_seed(self._seed)
                self._gens[dev] = g
            return g

    # --- checkpoint/resume support ------------------------------------
    def get_state(self) -> dict:
        """The seed and each device generator's state (a resumed run draws
        what the interrupted one would have drawn next)."""
        with self._lock:
            return {"seed": self._seed,
                    "states": {str(d): g.get_state()
                               for d, g in self._gens.items()}}

    def set_state(self, state: dict) -> None:
        with self._lock:
            self._seed = int(state.get("seed", self._seed))
            self._gens.clear()
            for d, s in state.get("states", {}).items():
                g = torch.Generator(device=torch.device(d))
                g.set_state(s)
                self._gens[torch.device(d)] = g

    # --- distribution draws -------------------------------------------
    def uniform(self, shape: Sequence[int], low: float = 0.0,
                high: float = 1.0, dtype=torch.float32,
                device=None) -> NDArray:
        g = self.generator(device)
        u = torch.rand(tuple(shape), generator=g, device=g.device,
                       dtype=torch_dtype(dtype))
        return NDArray(u * (high - low) + low)

    def gaussian(self, shape: Sequence[int], mean: float = 0.0,
                 std: float = 1.0, dtype=torch.float32,
                 device=None) -> NDArray:
        g = self.generator(device)
        n = torch.randn(tuple(shape), generator=g, device=g.device,
                        dtype=torch_dtype(dtype))
        return NDArray(n * std + mean)

    def bernoulli(self, shape: Sequence[int], p: float = 0.5,
                  device=None) -> NDArray:
        g = self.generator(device)
        return NDArray(torch.rand(tuple(shape), generator=g,
                                  device=g.device) < p)

    def binomial(self, shape: Sequence[int], n: int, p: float,
                 device=None) -> NDArray:
        g = self.generator(device)
        draws = torch.rand((int(n),) + tuple(shape), generator=g,
                           device=g.device) < p
        return NDArray(draws.to(torch.int32).sum(dim=0, dtype=torch.int32))

    def randint(self, shape: Sequence[int], low: int, high: int,
                device=None) -> NDArray:
        g = self.generator(device)
        return NDArray(torch.randint(low, high, tuple(shape), generator=g,
                                     device=g.device, dtype=torch.int32))

    def permutation(self, n: int, device=None) -> NDArray:
        g = self.generator(device)
        return NDArray(torch.randperm(n, generator=g, device=g.device,
                                      dtype=torch.int32))

    def next_gaussian(self, device=None) -> float:
        return float(self.gaussian((), device=device).value)

    def next_double(self, device=None) -> float:
        return float(self.uniform((), device=device).value)

    def next_int(self, bound: int, device=None) -> int:
        return int(self.randint((), 0, bound, device=device).value)


_thread_local = threading.local()
_default_seed = 119  # Nd4j's default seed


def get_random() -> Random:
    """The calling thread's :class:`Random` (Nd4j.getRandom() analog)."""
    r = getattr(_thread_local, "random", None)
    if r is None:
        r = Random(_default_seed)
        _thread_local.random = r
    return r


def set_default_seed(seed: int) -> None:
    global _default_seed
    _default_seed = seed
    get_random().set_seed(seed)
