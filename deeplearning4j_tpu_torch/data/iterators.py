"""DataSetIterator and the iterators the fit loops take, with MNIST.

Counterpart of ``deeplearning4j_tpu/data/iterators.py:29-243``:
``DataSetIterator`` (with ``set_pre_processor``), ``NDArrayDataSetIterator``,
``ExistingDataSetIterator``, ``MultipleEpochsIterator`` and
``MnistDataSetIterator``.

MNIST reads the IDX files from ``DL4J_TPU_DATA_DIR`` (default
``~/.deeplearning4j_tpu/data``) when they are there, with the JAX package's
lookup (``_find_idx``, ``_read_idx``). Otherwise it makes the JAX package's
deterministic synthetic digits (``_synthetic_mnist``, a copy of
``iterators.py:152-201``: numpy only, the same bits for the same seed): at
most 12,000 training and 2,000 test images, marked ``synthetic``. The
iterators over files (Cifar10, EMNIST, LFW, TinyImageNet) and Iris are not
ported yet.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .dataset import DataSet


class DataSetIterator:
    """The iteration protocol: ``__iter__`` yields DataSets, ``reset``
    rewinds, ``batch`` reports the batch size the source makes."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch(self) -> int:
        raise NotImplementedError

    def set_pre_processor(self, normalizer) -> None:
        """Run ``normalizer.pre_process(ds)`` on every DataSet yielded."""
        self._pre_processor = normalizer

    def _apply_pre(self, ds: DataSet) -> DataSet:
        pre = getattr(self, "_pre_processor", None)
        if pre is not None:
            pre.pre_process(ds)
        return ds


class NDArrayDataSetIterator(DataSetIterator):
    """(features, labels) arrays in minibatches; with ``shuffle`` a new
    order each epoch from ``RandomState(seed + epoch)``, as the JAX
    package's."""

    def __init__(self, features, labels, batch_size: int,
                 shuffle: bool = False, seed: int = 123,
                 drop_remainder: bool = False):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0

    def batch(self) -> int:
        return self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.features))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        stop = len(idx)
        if self.drop_remainder:
            stop = (stop // self.batch_size) * self.batch_size
        for i in range(0, stop, self.batch_size):
            sel = idx[i:i + self.batch_size]
            yield self._apply_pre(DataSet(self.features[sel],
                                          self.labels[sel]))


class ExistingDataSetIterator(DataSetIterator):
    def __init__(self, datasets: List[DataSet]):
        self.datasets = datasets

    def __iter__(self):
        for ds in self.datasets:
            yield self._apply_pre(ds)

    def batch(self):
        return self.datasets[0].num_examples() if self.datasets else 0


class MultipleEpochsIterator(DataSetIterator):
    def __init__(self, epochs: int, inner: DataSetIterator):
        self.epochs = epochs
        self.inner = inner

    def __iter__(self):
        for _ in range(self.epochs):
            self.inner.reset()
            yield from self.inner

    def reset(self):
        self.inner.reset()

    def batch(self):
        return self.inner.batch()


# --- MNIST ------------------------------------------------------------------------

_DATA_DIR = os.environ.get("DL4J_TPU_DATA_DIR",
                           os.path.expanduser("~/.deeplearning4j_tpu/data"))


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _zero, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find_idx(names: List[str]) -> Optional[str]:
    for name in names:
        for cand in (os.path.join(_DATA_DIR, name),
                     os.path.join(_DATA_DIR, name + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _synthetic_mnist(n: int, seed: int,
                     train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like 28x28 glyphs: each class a distinct stroke
    pattern, with per-example jitter and noise (the JAX package's
    generator, draw for draw)."""
    rng = np.random.RandomState(seed + (0 if train else 1))
    labels = rng.randint(0, 10, n)
    images = np.zeros((n, 28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for i, c in enumerate(labels):
        ox, oy = rng.randint(-3, 4), rng.randint(-3, 4)
        thick = 1.5 + rng.rand()
        cxs = 14 + ox
        cys = 14 + oy
        if c == 0:
            r = ((yy - cys) ** 2 / 81 + (xx - cxs) ** 2 / 36)
            img = np.exp(-((r - 1.0) ** 2) * 8 / thick)
        elif c == 1:
            img = np.exp(-((xx - cxs) ** 2) / thick ** 2) \
                * (np.abs(yy - cys) < 10)
        elif c == 2:
            img = (np.exp(-((yy - cys + 8) ** 2 + (xx - cxs) ** 2 - 36) ** 2
                          / 300)
                   + np.exp(-((yy - cys - (xx - cxs) * 0.8 - 4) ** 2)
                            / thick ** 2) * (np.abs(xx - cxs) < 7)
                   + np.exp(-((yy - cys - 9) ** 2) / thick ** 2)
                   * (np.abs(xx - cxs) < 7))
        elif c == 3:
            img = (np.exp(-((yy - cys + 5) ** 2 / 4 + (xx - cxs) ** 2 / 25
                            - 1) ** 2 * 2)
                   + np.exp(-((yy - cys - 5) ** 2 / 4 + (xx - cxs) ** 2 / 25
                              - 1) ** 2 * 2))
        elif c == 4:
            img = (np.exp(-((xx - cxs - 3) ** 2) / thick ** 2)
                   * (np.abs(yy - cys) < 9)
                   + np.exp(-((yy - cys) ** 2) / thick ** 2)
                   * (np.abs(xx - cxs) < 8)
                   + np.exp(-((yy - cys + (xx - cxs) - 6) ** 2)
                            / (2 * thick ** 2)) * (yy < cys + 1))
        elif c == 5:
            img = (np.exp(-((yy - cys + 8) ** 2) / thick ** 2)
                   * (np.abs(xx - cxs) < 7)
                   + np.exp(-((xx - cxs + 6) ** 2) / thick ** 2)
                   * (np.abs(yy - cys + 4) < 5)
                   + np.exp(-((yy - cys - 4) ** 2 / 16 + (xx - cxs) ** 2 / 36
                              - 1) ** 2 * 3))
        elif c == 6:
            img = (np.exp(-((yy - cys - 4) ** 2 / 25 + (xx - cxs) ** 2 / 25
                            - 1) ** 2 * 3)
                   + np.exp(-((xx - cxs + 4 - (cys - yy) * 0.3) ** 2)
                            / thick ** 2) * (yy < cys + 2))
        elif c == 7:
            img = (np.exp(-((yy - cys + 8) ** 2) / thick ** 2)
                   * (np.abs(xx - cxs) < 8)
                   + np.exp(-((xx - cxs - 6 + (yy - cys + 8) * 0.55) ** 2)
                            / thick ** 2) * (yy > cys - 9))
        elif c == 8:
            img = (np.exp(-((yy - cys + 5) ** 2 / 9 + (xx - cxs) ** 2 / 16
                            - 1) ** 2 * 3)
                   + np.exp(-((yy - cys - 5) ** 2 / 12 + (xx - cxs) ** 2 / 20
                              - 1) ** 2 * 3))
        else:
            img = (np.exp(-((yy - cys + 4) ** 2 / 16 + (xx - cxs) ** 2 / 16
                            - 1) ** 2 * 3)
                   + np.exp(-((xx - cxs - 4 + (yy - cys) * 0.2) ** 2)
                            / thick ** 2) * (yy > cys - 6))
        img = np.clip(img, 0, 1)
        img += rng.randn(28, 28) * 0.05
        images[i] = np.clip(img, 0, 1) * 255.0
    return images.astype(np.uint8), labels.astype(np.int64)


class MnistDataSetIterator(DataSetIterator):
    """28x28 digits as features in [0, 1] (flat ``[784]``, or ``[1, 28,
    28]`` with ``flatten=False``) and one-hot ``[10]`` labels, float32."""

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 6,
                 flatten: bool = True):
        self.batch_size = batch_size
        self.flatten = flatten
        self.synthetic = False
        n = num_examples or (60000 if train else 10000)
        split = "train" if train else "t10k"
        img_path = _find_idx([f"{split}-images-idx3-ubyte",
                              f"{split}-images.idx3-ubyte"])
        lbl_path = _find_idx([f"{split}-labels-idx1-ubyte",
                              f"{split}-labels.idx1-ubyte"])
        if img_path and lbl_path:
            images = _read_idx(img_path)[:n]
            labels = _read_idx(lbl_path)[:n]
        else:
            self.synthetic = True
            n = min(n, 12000 if train else 2000)
            images, labels = _synthetic_mnist(n, seed, train)
        feats = images.astype(np.float32) / 255.0
        self.features = feats.reshape(len(feats), -1) if flatten \
            else feats.reshape(len(feats), 1, 28, 28)
        self.labels = np.eye(10, dtype=np.float32)[labels]

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.features)

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(
                self.features[i:i + self.batch_size],
                self.labels[i:i + self.batch_size]))
