"""NDArray, its factory and the random stream (the reference's INDArray,
``Nd4j`` and ``Nd4j.getRandom``).

Counterpart of ``deeplearning4j_tpu/ndarray``: :class:`NDArray` is a
mutable handle over a tensor with the JAX class's contract (in-place
``addi``/``muli``/``assign``, view writes that reach their base, fresh
``reshape``/``permute``), ``factory`` the creators, ``gemm`` and the array
file format, ``rng`` the per-thread stream over ``torch.Generator``s.
"""

from . import factory
from .ndarray import NDArray
from .rng import Random, get_random, set_default_seed

__all__ = ["NDArray", "Random", "factory", "get_random", "set_default_seed"]
