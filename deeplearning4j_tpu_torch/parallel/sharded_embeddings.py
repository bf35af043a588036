"""Sharded embedding tables: the parameter-server row.

Counterpart of ``deeplearning4j_tpu/parallel/sharded_embeddings.py`` (the
reference's ``VoidParameterServer``: Word2Vec's table rows split over
shard nodes). The table lives row-sharded over a mesh axis, one shard per
slot of that axis (``parallel/mesh.axis_slots``), each on its slot's
device (a ``common/tree.ShardedTensor``); a lookup and an update are
``ops/embeddings.sharded_rows_lookup`` and ``sharded_rows_add`` over the
shard list: masked local gathers summed in slot order (the JAX ``psum``,
exact since each id has one owner), and additions into the owned rows
only.

A table whose row count does not divide the shard count is zero-padded to a
multiple of it; the pad rows are unreachable (ids < ``vocab_size``). The
initial table is drawn with numpy's ``default_rng(seed)`` exactly as the
JAX class draws it, so both packages start from the same table bit for
bit. The gather and the scatter-update run under the executable census
(``common/xprof.py``) as ``embeddings/lookup`` and ``embeddings/update``,
the JAX class's two registered programs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..common import xprof
from ..common.dtypes import tensor_from_numpy
from ..common.tree import ShardedTensor
from ..ops.embeddings import (sharded_local_offsets, sharded_rows_add,
                              sharded_rows_lookup)
from .mesh import Mesh, axis_slots


class ShardedEmbedding:
    def __init__(self, vocab_size: int, dim: int, mesh: Mesh,
                 axis: str = "model", seed: int = 0,
                 scale: Optional[float] = None):
        self.vocab_size = vocab_size
        self.dim = dim
        self.mesh = mesh
        self.axis = axis
        self.slots = axis_slots(mesh, axis)
        n_shards = len(self.slots)
        self._padded = -(-vocab_size // n_shards) * n_shards
        rng = np.random.default_rng(seed)
        scale = scale if scale is not None else 1.0 / dim
        host = (rng.random((self._padded, dim)) - 0.5).astype(np.float32) \
            * (2 * scale)
        self._place(host)

    def _place(self, host: np.ndarray) -> None:
        """A ``[vocab, dim]`` (or padded) host table into the shards, the
        pad rows zero."""
        t = tensor_from_numpy(np.ascontiguousarray(host[:self.vocab_size],
                                                   np.float32))
        self.sharded = ShardedTensor.split(
            t, [s.device for s in self.slots], pad=True)

    @property
    def shards(self) -> List[torch.Tensor]:
        """The row shards, in slot order."""
        return self.sharded.shards

    # -- API ---------------------------------------------------------------
    def lookup(self, ids) -> torch.Tensor:
        """``[B]`` global ids to ``[B, D]`` rows, on the first slot's
        device."""
        ids = torch.as_tensor(ids, dtype=torch.int64,
                              device=self.slots[0].device)
        return xprof.censused(self, "embeddings/lookup",
                              self._lookup_rows)(self.shards, ids)

    def apply_gradients(self, ids, grads) -> None:
        """Add ``grads`` ``[B, D]`` into rows ``ids`` (duplicates sum);
        only the owning shard of each row is touched."""
        dev = self.slots[0].device
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        grads = torch.as_tensor(grads, dtype=torch.float32, device=dev)
        xprof.censused(self, "embeddings/update", self._update_rows)(
            self.shards, ids, grads)

    @staticmethod
    def _lookup_rows(shards, ids) -> torch.Tensor:
        return sharded_rows_lookup(shards, ids)[0]

    @staticmethod
    def _update_rows(shards, ids, grads) -> None:
        aux = [sharded_local_offsets(shards, ids, j)
               for j in range(len(shards))]
        sharded_rows_add(shards, aux, grads)

    @property
    def table(self) -> torch.Tensor:
        """The padded table, the shards joined in slot order on the first
        slot's device."""
        return self.sharded.gather(self.slots[0].device)

    def to_numpy(self) -> np.ndarray:
        return self.sharded.gather("cpu")[:self.vocab_size].numpy()

    @property
    def n_shards(self) -> int:
        return len(self.slots)

