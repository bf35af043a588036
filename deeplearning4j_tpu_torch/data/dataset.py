"""DataSet and MultiDataSet: features + labels, with optional masks.

Counterpart of ``deeplearning4j_tpu/data/dataset.py``: what the
fit loops, the input pipeline and the iterators read. Arrays stay as given,
numpy arrays or tensors; the networks move them to their device when they
bind a batch. ``features_mask`` is ``[batch, time]`` (1 = a real step),
``labels_mask`` ``[batch]`` or ``[batch, time]``.

``shuffle(seed)`` draws its permutation from ``np.random.RandomState(seed)``
as the JAX package does, so one seed gives the same order in both packages;
without a seed it draws from a fresh, unseeded ``RandomState`` (never from
numpy's global one). ``MultiDataSet`` holds N feature arrays and M label
arrays, with optional mask lists, for a ``ComputationGraph`` with several
inputs or outputs.

``save``/``load`` use the JAX package's file: one ``.npz`` with the keys
``features``, ``labels``, ``features_mask`` and ``labels_mask`` (those that
are set), the suffix added when the path lacks it, so a file that either
package saves loads in the other. ``load`` gives numpy arrays.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.dtypes import DataType

_FIELDS = ("features", "labels", "features_mask", "labels_mask")


def _take(a, idx):
    """Rows ``idx`` (a numpy index array) of a numpy array or a tensor."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)]
    return np.asarray(a)[idx]


def _span(a, start: int, stop: int):
    """Rows ``start:stop`` of a numpy array or a tensor, as a copy. A
    tensor's rows are sliced and copied on its device: an index tensor
    would travel from the host and synchronise with the card."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a[start:stop].clone()
    return np.asarray(a)[start:stop].copy()


def _concat(parts):
    if parts[0] is None:
        return None
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate([np.asarray(p) for p in parts])


class DataSet:
    def __init__(self, features=None, labels=None, features_mask=None,
                 labels_mask=None):
        self.features = features
        self.labels = labels
        self.features_mask = features_mask
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return int(self.features.shape[0]) if self.features is not None else 0

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def _arrays(self):
        return [getattr(self, f) for f in _FIELDS]

    def _rows(self, idx) -> "DataSet":
        return DataSet(*(_take(a, idx) for a in self._arrays()))

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the examples in place (every array by the same
        permutation)."""
        perm = np.random.RandomState(seed).permutation(self.num_examples())
        for f, a in zip(_FIELDS, self._arrays()):
            setattr(self, f, _take(a, perm))

    def split_test_and_train(self, n_train: int
                             ) -> Tuple["DataSet", "DataSet"]:
        n = self.num_examples()
        return (self._rows(np.arange(0, min(n_train, n))),
                self._rows(np.arange(min(n_train, n), n)))

    def batch_by(self, batch_size: int,
                 drop_remainder: bool = False) -> Iterator["DataSet"]:
        n = self.num_examples()
        if drop_remainder:
            n = (n // batch_size) * batch_size
        for i in range(0, n, batch_size):
            yield DataSet(*(_span(a, i, min(i + batch_size, n))
                            for a in self._arrays()))

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(*(_concat([getattr(d, f) for d in datasets])
                         for f in _FIELDS))

    def save(self, path: str) -> None:
        np.savez(_npz(path), **{f: _host(a) for f, a in
                                zip(_FIELDS, self._arrays()) if a is not None})

    @staticmethod
    def load(path: str) -> "DataSet":
        with np.load(_npz(path)) as z:
            return DataSet(*(z[f] if f in z else None for f in _FIELDS))

    def __repr__(self) -> str:
        f = tuple(self.features.shape) if self.features is not None else None
        lab = tuple(self.labels.shape) if self.labels is not None else None
        return f"DataSet(features={f}, labels={lab})"


def _npz(path) -> str:
    path = str(path)
    # np.savez appends the suffix; keep save and load symmetric
    return path if path.endswith(".npz") else path + ".npz"


def _host(a) -> np.ndarray:
    """A numpy copy of an array or a tensor (a bfloat16 tensor as
    ``ml_dtypes.bfloat16``, the JAX package's host type)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    t = a.detach().cpu()
    if t.dtype is torch.bfloat16:
        return t.view(torch.uint16).numpy().view(
            DataType.BFLOAT16.to_np())
    return t.numpy()


class MultiDataSet:
    """N features + M labels (the reference MultiDataSet, for
    ``ComputationGraph``), in the graph's input and output order."""

    def __init__(self, features: Sequence, labels: Sequence,
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        self.features = list(features)
        self.labels = list(labels)
        self.features_masks = list(features_masks) if features_masks \
            else None
        self.labels_masks = list(labels_masks) if labels_masks else None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    def __repr__(self) -> str:
        f = [tuple(a.shape) for a in self.features]
        lab = [tuple(a.shape) for a in self.labels]
        return f"MultiDataSet(features={f}, labels={lab})"
