"""DataSetIterator and the iterators the fit loops take, with MNIST.

Counterpart of ``deeplearning4j_tpu/data/iterators.py:29-243``:
``DataSetIterator`` (with ``set_pre_processor`` and the supervised-restart
protocol ``source_state`` / ``restore_source_state``),
``NDArrayDataSetIterator``,
``ExistingDataSetIterator``, ``MultipleEpochsIterator`` and
``MnistDataSetIterator``.

MNIST reads the IDX files from ``DL4J_TPU_DATA_DIR`` (default
``~/.deeplearning4j_tpu/data``) when they are there, with the JAX package's
lookup (``_find_idx``, ``_read_idx``). Otherwise it makes the JAX package's
deterministic synthetic digits (``_synthetic_mnist``, a copy of
``iterators.py:152-201``: numpy only, the same bits for the same seed): at
most 12,000 training and 2,000 test images, marked ``synthetic``.

``IrisDataSetIterator``, ``Cifar10DataSetIterator``,
``EmnistDataSetIterator``, ``LFWDataSetIterator``,
``TinyImageNetDataSetIterator`` and ``UciSequenceDataSetIterator`` with
their helpers (``_synthetic_class_images``, ``_load_image_tree``,
``_stratified_split``) are copies of ``iterators.py:244-679``: each reads
its files under ``DL4J_TPU_DATA_DIR`` when they are there, and otherwise
makes the JAX package's synthetic arrays, bit for bit for the same seed.
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

    # --- the supervised-restart protocol (parallel/distributed) ---------
    # A source with state across epochs (the per-epoch shuffle) exposes it:
    # the TrainingSupervisor takes source_state() when its fit begins and
    # hands it back before every restarted attempt, so the checkpoint
    # cursor's host replay sees the epochs and shuffles the failed attempt
    # saw. A source that is the same every epoch needs neither.
    def source_state(self) -> Optional[dict]:
        return None

    def restore_source_state(self, state: dict) -> None:
        pass


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

    def source_state(self) -> dict:
        # the shuffle of an epoch is RandomState(seed + epoch): rewinding
        # the epoch is all a restarted attempt needs to replay it
        return {"epoch": self._epoch}

    def restore_source_state(self, state: dict) -> None:
        self._epoch = int(state.get("epoch", 0))

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


class IrisDataSetIterator(DataSetIterator):
    """Reference IrisDataSetIterator — the canonical 150-example table is small
    enough to embed via its generating statistics; we synthesize the standard
    three-cluster structure deterministically."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150):
        rng = np.random.RandomState(42)
        n_per = num_examples // 3
        means = np.array([[5.0, 3.4, 1.5, 0.25], [5.9, 2.8, 4.3, 1.3],
                          [6.6, 3.0, 5.6, 2.0]], np.float32)
        stds = np.array([[0.35, 0.38, 0.17, 0.1], [0.51, 0.31, 0.47, 0.2],
                         [0.64, 0.32, 0.55, 0.27]], np.float32)
        feats, labels = [], []
        for c in range(3):
            feats.append(rng.randn(n_per, 4).astype(np.float32) * stds[c] + means[c])
            labels.append(np.full(n_per, c))
        self.features = np.concatenate(feats)
        self.labels = np.eye(3, dtype=np.float32)[np.concatenate(labels)]
        perm = rng.permutation(len(self.features))
        self.features, self.labels = self.features[perm], self.labels[perm]
        self.batch_size = batch_size

    def batch(self):
        return self.batch_size

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(self.features[i:i + self.batch_size],
                                          self.labels[i:i + self.batch_size]))


def _synthetic_class_images(n: int, n_classes: int, hw: int, channels: int,
                            seed: int, train: bool):
    """Per-class smooth random prototype + per-example shift/noise —
    deterministic, CNN-learnable, linearly non-trivial (the synthetic
    fallback pattern the MNIST iterator established)."""
    rng = np.random.RandomState(seed + (0 if train else 1))
    protos = np.zeros((n_classes, channels, hw, hw), np.float32)
    for c in range(n_classes):
        prng = np.random.RandomState(1000 + c)
        base = prng.randn(channels, 8, 8)
        # smooth upsample: nearest then box blur
        big = np.repeat(np.repeat(base, hw // 8 + 1, 1), hw // 8 + 1, 2)
        big = big[:, :hw, :hw]
        k = np.ones((3, 3), np.float32) / 9.0
        for ch in range(channels):
            p = np.pad(big[ch], 1, mode="edge")
            big[ch] = sum(p[dy:dy + hw, dx:dx + hw] * k[dy, dx]
                          for dy in range(3) for dx in range(3))
        protos[c] = big
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-9)
    labels = rng.randint(0, n_classes, n)
    images = np.zeros((n, channels, hw, hw), np.float32)
    for i, c in enumerate(labels):
        dx, dy = rng.randint(-3, 4, 2)
        img = np.roll(np.roll(protos[c], dy, axis=1), dx, axis=2)
        images[i] = np.clip(img + rng.randn(channels, hw, hw) * 0.15, 0, 1)
    return (images * 255).astype(np.uint8), labels.astype(np.int64)


class Cifar10DataSetIterator(DataSetIterator):
    """Reference dl4j-data Cifar10DataSetIterator: 32x32x3 in [0,1] (NCHW),
    one-hot [10]. Loads the standard binary batches when present under
    $DL4J_TPU_DATA_DIR/cifar-10-batches-bin; otherwise a deterministic
    synthetic fallback (marked via ``.synthetic``) keeps pipelines and CI
    runnable without egress."""

    LABELS = ["airplane", "automobile", "bird", "cat", "deer", "dog",
              "frog", "horse", "ship", "truck"]

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 6):
        self.batch_size = batch_size
        self.synthetic = False
        n = num_examples or (50000 if train else 10000)
        root = os.path.join(_DATA_DIR, "cifar-10-batches-bin")
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
                 else ["test_batch.bin"])
        paths = [os.path.join(root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            recs = []
            for p in paths:
                raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
                recs.append(raw)
            raw = np.concatenate(recs)[:n]
            labels = raw[:, 0].astype(np.int64)
            images = raw[:, 1:].reshape(-1, 3, 32, 32)
        else:
            self.synthetic = True
            n = min(n, 8000 if train else 1500)
            images, labels = _synthetic_class_images(n, 10, 32, 3, seed,
                                                     train)
        self.features = images.astype(np.float32) / 255.0
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


class EmnistDataSetIterator(DataSetIterator):
    """Reference dl4j-data EmnistDataSetIterator. ``dataset`` picks the
    split ("letters": 26 classes, "digits"/"mnist": 10, "balanced": 47);
    idx files are looked up like MNIST's, with the synthetic per-class
    fallback otherwise."""

    _CLASSES = {"letters": 26, "digits": 10, "mnist": 10, "balanced": 47,
                "byclass": 62, "bymerge": 47}

    def __init__(self, dataset: str, batch_size: int, train: bool = True,
                 num_examples: Optional[int] = None, seed: int = 6,
                 flatten: bool = True):
        if dataset not in self._CLASSES:
            raise ValueError(f"unknown EMNIST split {dataset!r}; one of "
                             f"{sorted(self._CLASSES)}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.flatten = flatten
        self.synthetic = False
        n_classes = self._CLASSES[dataset]
        n = num_examples or (60000 if train else 10000)
        tag = "train" if train else "test"
        img_path = _find_idx(
            [f"emnist-{dataset}-{tag}-images-idx3-ubyte"])
        lbl_path = _find_idx(
            [f"emnist-{dataset}-{tag}-labels-idx1-ubyte"])
        if img_path and lbl_path:
            images = _read_idx(img_path)[:n]
            labels = _read_idx(lbl_path)[:n].astype(np.int64)
            if dataset == "letters":     # letters labels are 1-based
                labels = labels - 1
            images = images.reshape(len(images), 1, 28, 28)
            # EMNIST idx files store each image TRANSPOSED relative to
            # MNIST orientation (the reference fetcher and torchvision
            # both transpose on read)
            images = images.transpose(0, 1, 3, 2)
        else:
            self.synthetic = True
            n = min(n, 6000 if train else 1000)
            images, labels = _synthetic_class_images(n, n_classes, 28, 1,
                                                     seed, train)
        feats = images.astype(np.float32) / 255.0
        self.features = feats.reshape(len(feats), -1) if flatten \
            else feats.reshape(len(feats), 1, 28, 28)
        self.labels = np.eye(n_classes, dtype=np.float32)[labels]

    def num_classes(self) -> int:
        return self.labels.shape[1]

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.features)

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(
                self.features[i:i + self.batch_size],
                self.labels[i:i + self.batch_size]))


class LFWDataSetIterator(DataSetIterator):
    """Reference dl4j-data LFWDataSetIterator (SURVEY §2.3 datasets row):
    face images labeled by person, loaded from a local
    ``<data dir>/lfw/<person>/<img>.jpg`` tree when present (the
    reference's auto-download has no egress analog here), else the
    established synthetic per-class fallback (marked ``.synthetic``).
    Images are NCHW float32 in [0, 1]."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 image_hw: int = 64, n_classes: int = 20, train: bool = True,
                 seed: int = 11):
        self.batch_size = batch_size
        self.synthetic = False
        root = os.path.join(_DATA_DIR, "lfw")
        loaded = None
        if os.path.isdir(root):
            loaded = _load_image_tree(root, image_hw,
                                      num_examples or 13233)
        if loaded is not None:
            images, labels, self._names = loaded
            # one-hot width = ALL class dirs (a capped load may not reach
            # the last ones); per-class split honors the train flag
            n_classes = len(self._names)
            sel = _stratified_split(labels, train, seed=seed)
            images, labels = images[sel], labels[sel]
        else:
            self.synthetic = True
            n = min(num_examples or 1600, 4000)
            images, labels = _synthetic_class_images(
                n, n_classes, image_hw, 3, seed, train)
            self._names = [f"person_{c}" for c in range(n_classes)]
        self.features = images.astype(np.float32) / 255.0
        self.labels = np.eye(n_classes, dtype=np.float32)[labels]

    def num_classes(self) -> int:
        return self.labels.shape[1]

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.features)

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(
                self.features[i:i + self.batch_size],
                self.labels[i:i + self.batch_size]))


class TinyImageNetDataSetIterator(DataSetIterator):
    """Reference dl4j-data TinyImageNetDataSetIterator: 64x64x3, 200
    classes, loaded from a local ``<data dir>/tiny-imagenet-200`` tree
    (``train/<wnid>/images/*.JPEG``) when present, else the synthetic
    per-class fallback (capped well below the real 100k examples)."""

    def __init__(self, batch_size: int, num_examples: Optional[int] = None,
                 train: bool = True, seed: int = 12):
        self.batch_size = batch_size
        self.synthetic = False
        base = os.path.join(_DATA_DIR, "tiny-imagenet-200")
        loaded = None
        if train and os.path.isdir(os.path.join(base, "train")):
            loaded = _load_image_tree(os.path.join(base, "train"), 64,
                                      num_examples or 100_000,
                                      nested="images")
            if loaded is not None:
                images, labels, names = loaded
                n_classes = len(names)
        elif not train and os.path.isdir(os.path.join(base, "val")):
            # the real val split is FLAT (val/images/*.JPEG +
            # val_annotations.txt mapping file → wnid), not per-class dirs
            loaded = self._load_val(base, num_examples or 10_000)
            if loaded is not None:
                images, labels, n_classes = loaded
        if loaded is None:
            self.synthetic = True
            n_classes = 200
            n = min(num_examples or 2000, 10_000)
            images, labels = _synthetic_class_images(
                n, n_classes, 64, 3, seed, train)
        self.features = images.astype(np.float32) / 255.0
        self.labels = np.eye(n_classes, dtype=np.float32)[labels]

    @staticmethod
    def _load_val(base: str, limit: int):
        """val/images/*.JPEG labeled via val_annotations.txt, with wnid →
        index taken from the sorted train/ class dirs (the canonical
        label order)."""
        try:
            from PIL import Image
        except ImportError:
            return None
        ann = os.path.join(base, "val", "val_annotations.txt")
        train_root = os.path.join(base, "train")
        if not os.path.exists(ann) or not os.path.isdir(train_root):
            return None
        classes = sorted(d for d in os.listdir(train_root)
                         if os.path.isdir(os.path.join(train_root, d)))
        class_of = {c: i for i, c in enumerate(classes)}
        images, labels = [], []
        with open(ann, encoding="utf-8") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) < 2 or parts[1] not in class_of:
                    continue
                p = os.path.join(base, "val", "images", parts[0])
                if not os.path.exists(p):
                    continue
                img = Image.open(p).convert("RGB")
                if img.size != (64, 64):
                    img = img.resize((64, 64))
                images.append(np.asarray(img, np.uint8).transpose(2, 0, 1))
                labels.append(class_of[parts[1]])
                if len(images) >= limit:
                    break
        if not images:
            return None
        return (np.stack(images), np.asarray(labels, np.int64),
                len(classes))

    def num_classes(self) -> int:
        return self.labels.shape[1]

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.features)

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(
                self.features[i:i + self.batch_size],
                self.labels[i:i + self.batch_size]))


def _load_image_tree(root: str, hw: int, limit: int,
                     nested: Optional[str] = None):
    """<root>/<class>/[nested/]*.{jpg,jpeg,png} → (uint8 NCHW, labels,
    class names); None when PIL is unavailable or the tree is empty.
    The ``limit`` cap applies PER CLASS (ceil(limit / n_classes)) so a
    capped load still spans every class instead of truncating the
    alphabetical walk to the first few."""
    try:
        from PIL import Image
    except ImportError:
        return None
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        return None
    per_class = max(1, -(-limit // len(classes)))
    images, labels = [], []
    for ci, cname in enumerate(classes):
        d = os.path.join(root, cname)
        if nested and os.path.isdir(os.path.join(d, nested)):
            d = os.path.join(d, nested)
        taken = 0
        for f in sorted(os.listdir(d)):
            if not f.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            img = Image.open(os.path.join(d, f)).convert("RGB")
            if img.size != (hw, hw):
                img = img.resize((hw, hw))
            images.append(np.asarray(img, np.uint8).transpose(2, 0, 1))
            labels.append(ci)
            taken += 1
            if taken >= per_class or len(images) >= limit:
                break
        if len(images) >= limit:
            break
    if not images:
        return None
    return (np.stack(images), np.asarray(labels, np.int64), classes)


def _stratified_split(labels: np.ndarray, train: bool, frac: float = 0.75,
                      seed: int = 0) -> np.ndarray:
    """Deterministic PER-CLASS train/test index split (the reference
    iterators split within each class, not with one global permutation)."""
    sel = []
    rng = np.random.RandomState(seed)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        idx = idx[rng.permutation(len(idx))]
        cut = int(round(len(idx) * frac))
        sel.append(idx[:cut] if train else idx[cut:])
    return np.sort(np.concatenate(sel)) if sel else np.zeros(0, np.int64)


class UciSequenceDataSetIterator(DataSetIterator):
    """Reference dl4j-data UciSequenceDataSetIterator: the UCI
    synthetic-control time series (600 sequences x 60 steps, 6 classes:
    normal, cyclic, increasing, decreasing, upward shift, downward
    shift). Reads a local ``synthetic_control.data`` when present;
    otherwise REGENERATES the six patterns with the dataset's own
    published generator equations (the original UCI data is itself
    synthetic, so the fallback is the same distribution, marked
    ``.synthetic``). Features [B, 60, 1], one-hot labels [B, 6]."""

    N_CLASSES = 6
    T = 60

    def __init__(self, batch_size: int, train: bool = True, seed: int = 13):
        self.batch_size = batch_size
        self.synthetic = False
        path = _find_idx(["synthetic_control.data"])
        if path:
            raw = np.loadtxt(path)               # [600, 60]
            labels = np.repeat(np.arange(6), 100)
        else:
            self.synthetic = True
            raw, labels = self._generate(600, seed + (0 if train else 1))
        # 75/25 split STRATIFIED per class (the reference splits within
        # each class block, never a global permutation)
        sel = _stratified_split(labels, train, seed=seed)
        self.features = raw[sel, :, None].astype(np.float32)
        self.labels = np.eye(self.N_CLASSES,
                             dtype=np.float32)[labels[sel]]

    @staticmethod
    def _generate(n: int, seed: int):
        """The six synthetic-control equations (Alcock & Manolopoulos):
        m=30, s=2; cyclic adds a sine, trends add +/- gradient, shifts
        add a step at a random changepoint."""
        rng = np.random.RandomState(seed)
        T = UciSequenceDataSetIterator.T
        t = np.arange(T, dtype=np.float64)
        seqs, labels = [], []
        per = n // 6
        for c in range(6):
            for _ in range(per):
                base = 30.0 + 2.0 * rng.standard_normal(T)
                if c == 1:    # cyclic
                    a = rng.uniform(10, 15)
                    period = rng.uniform(10, 15)
                    base += a * np.sin(2 * np.pi * t / period)
                elif c == 2:  # increasing trend
                    base += rng.uniform(0.2, 0.5) * t
                elif c == 3:  # decreasing trend
                    base -= rng.uniform(0.2, 0.5) * t
                elif c == 4:  # upward shift
                    p = rng.randint(T // 3, 2 * T // 3)
                    base += rng.uniform(7.5, 20) * (t >= p)
                elif c == 5:  # downward shift
                    p = rng.randint(T // 3, 2 * T // 3)
                    base -= rng.uniform(7.5, 20) * (t >= p)
                seqs.append(base)
                labels.append(c)
        return np.asarray(seqs), np.asarray(labels, np.int64)

    def num_classes(self) -> int:
        return self.N_CLASSES

    def batch(self) -> int:
        return self.batch_size

    def total_examples(self) -> int:
        return len(self.features)

    def __iter__(self):
        for i in range(0, len(self.features), self.batch_size):
            yield self._apply_pre(DataSet(
                self.features[i:i + self.batch_size],
                self.labels[i:i + self.batch_size]))
