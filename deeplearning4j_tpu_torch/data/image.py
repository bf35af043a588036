"""ImageRecordReader + image transform pipeline (datavec-data-image analog).

Counterpart of ``deeplearning4j_tpu/data/image.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: ``org.datavec.image.recordreader.ImageRecordReader`` (label =
parent directory name via ``ParentPathLabelGenerator``, decode → resize →
NCHW float) and ``org.datavec.image.transform.ImageTransform`` chain
(Crop/Flip/Rotate/ResizeImageTransform...; SURVEY.md §2.3 DataVec image
row). The reference decodes through JavaCPP/OpenCV; here PIL + numpy do the
host-side decode, and the arrays head straight into the device input
pipeline (``AsyncDataSetIterator`` overlaps this decode with the card's compute).

Output layout is NCHW float32 in [0,1] (divide-by-255 happens here, like
the reference's ``ImagePreProcessingScaler`` default), labels are integer
class indices resolved from sorted directory names.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .records import InputSplit, RecordReader


class ImageTransform:
    """SPI: np.ndarray [H,W,C] uint8 -> np.ndarray [H,W,C] uint8
    (reference: ImageTransform)."""

    def __call__(self, img: np.ndarray, rng: np.random.Generator) \
            -> np.ndarray:
        raise NotImplementedError


class ResizeImageTransform(ImageTransform):
    def __init__(self, width: int, height: int):
        self.width, self.height = width, height

    def __call__(self, img, rng):
        from PIL import Image

        return np.asarray(Image.fromarray(img).resize(
            (self.width, self.height), Image.BILINEAR))


class FlipImageTransform(ImageTransform):
    """Horizontal mirror with probability p (reference: FlipImageTransform
    random mode)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, rng):
        if rng.random() < self.p:
            return img[:, ::-1]
        return img


class CropImageTransform(ImageTransform):
    """Random crop of a fixed output size (reference: CropImageTransform)."""

    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def __call__(self, img, rng):
        h, w = img.shape[:2]
        if h < self.height or w < self.width:
            raise ValueError(f"crop {self.height}x{self.width} exceeds "
                             f"image {h}x{w}")
        top = int(rng.integers(0, h - self.height + 1))
        left = int(rng.integers(0, w - self.width + 1))
        return img[top:top + self.height, left:left + self.width]


class RotateImageTransform(ImageTransform):
    """Random rotation in ±max_degrees (reference: RotateImageTransform)."""

    def __init__(self, max_degrees: float):
        self.max_degrees = max_degrees

    def __call__(self, img, rng):
        from PIL import Image

        deg = float(rng.uniform(-self.max_degrees, self.max_degrees))
        return np.asarray(Image.fromarray(img).rotate(deg,
                                                      Image.BILINEAR))


class PipelineImageTransform(ImageTransform):
    """Chain of transforms (reference: PipelineImageTransform)."""

    def __init__(self, transforms: Sequence[ImageTransform]):
        self.transforms = list(transforms)

    def __call__(self, img, rng):
        for t in self.transforms:
            img = t(img, rng)
        return img


class ImageRecordReader(RecordReader):
    """Decode images under a FileSplit into [C,H,W] float32 in [0,1] +
    integer label from the parent directory name.

    Each record is ``[image_chw: np.ndarray, label_index: int]`` — the
    shape ``RecordReaderDataSetIterator`` assembles into NCHW batches.
    """

    def __init__(self, height: int, width: int, channels: int = 3,
                 transform: Optional[ImageTransform] = None,
                 seed: int = 0, workers: int = 1):
        self.height, self.width, self.channels = height, width, channels
        self.transform = transform
        self._rng = np.random.default_rng(seed)
        self.labels: List[str] = []
        # Decode thread pool size. PIL releases the GIL during decode, so
        # N workers ≈ N× decode throughput — the role the reference's
        # multi-threaded NativeImageLoader/Async pipeline plays. Results
        # are yielded IN ORDER with a bounded submission window (2×workers
        # outstanding) so memory stays flat on large splits.
        self.workers = max(1, workers)
        import threading

        # transforms draw from the shared rng; decode (the expensive part)
        # stays parallel, the cheap transform step serializes on this lock
        self._transform_lock = threading.Lock()

    def initialize(self, split: InputSplit) -> None:
        self._split = split
        files = split.locations()
        self.labels = sorted({p.parent.name for p in files})
        self._label_idx = {l: i for i, l in enumerate(self.labels)}
        self.reset()

    def num_labels(self) -> int:
        return len(self.labels)

    def _load(self, path: Path) -> np.ndarray:
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("L" if self.channels == 1 else "RGB")
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.transform is not None:
            with self._transform_lock:
                arr = self.transform(arr, self._rng)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        if arr.shape[0] != self.height or arr.shape[1] != self.width:
            from PIL import Image as _I

            squeezed = arr[:, :, 0] if arr.shape[2] == 1 else arr
            resized = np.asarray(_I.fromarray(squeezed).resize(
                (self.width, self.height), _I.BILINEAR))
            arr = resized[:, :, None] if resized.ndim == 2 else resized
        # HWC uint8 → CHW float32 [0,1]
        return (arr.astype(np.float32) / 255.0).transpose(2, 0, 1)

    def _make_iter(self):
        paths = self._split.locations()
        if self.workers == 1:
            for path in paths:
                yield [self._load(path), self._label_idx[path.parent.name]]
            return
        from concurrent.futures import ThreadPoolExecutor

        window = 2 * self.workers
        with ThreadPoolExecutor(self.workers) as pool:
            pending = []
            idx = 0
            while idx < len(paths) or pending:
                while idx < len(paths) and len(pending) < window:
                    p = paths[idx]
                    pending.append((pool.submit(self._load, p), p))
                    idx += 1
                fut, p = pending.pop(0)
                yield [fut.result(), self._label_idx[p.parent.name]]
