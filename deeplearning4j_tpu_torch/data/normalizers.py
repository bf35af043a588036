"""Data normalizers: fit statistics once, transform every batch.

Counterpart of ``deeplearning4j_tpu/data/normalizers.py``:
``NormalizerStandardize`` (per feature, or per channel for images and
sequences), ``NormalizerMinMaxScaler`` (per column for ``[B, F]``, one
global range otherwise) and ``ImagePreProcessingScaler`` (pixels ``[0,
max_pixel]`` to ``[min_range, max_range]``), each with ``fit``,
``transform``, ``pre_process`` (what an iterator's pre-processor runs) and
``revert``. Statistics are numpy arrays computed as the JAX package computes
them; features may be numpy arrays or tensors, and a transform keeps the
kind (a tensor stays on its device). ``to_json`` and
:func:`normalizer_from_json` write and read the JAX package's JSON (the
model zip's ``normalizer.json``, ``util/model_serializer.py``), so a
normalizer crosses between the packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .dataset import DataSet


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _stat(v: np.ndarray, like):
    """A statistic in the kind of ``like``: a tensor of its dtype on its
    device, or the numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(v), device=like.device).to(like.dtype)
    return v


def _channel_shape(x) -> list:
    shape = [1] * x.ndim
    shape[1 if x.ndim > 2 else -1] = -1
    return shape


class Normalizer:
    def fit(self, data) -> None:
        raise NotImplementedError

    def transform(self, ds: DataSet) -> None:
        raise NotImplementedError

    def revert(self, ds: DataSet) -> None:
        ds.features = self.revert_features(ds.features)

    def revert_features(self, x):
        raise NotImplementedError

    def to_json(self) -> dict:
        raise NotImplementedError

    def pre_process(self, ds: DataSet) -> None:
        self.transform(ds)


class NormalizerStandardize(Normalizer):
    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        feats = _collect_features(data)
        axes = (tuple(i for i in range(feats.ndim) if i != 1)
                if feats.ndim > 2 else (0,))
        self.mean = feats.mean(axis=axes)
        self.std = feats.std(axis=axes) + 1e-8

    def transform(self, ds: DataSet) -> None:
        x = ds.features
        shape = _channel_shape(x)
        ds.features = ((x - _stat(self.mean.reshape(shape), x))
                       / _stat(self.std.reshape(shape), x))

    def revert_features(self, x):
        shape = _channel_shape(x)
        return (x * _stat(self.std.reshape(shape), x)
                + _stat(self.mean.reshape(shape), x))

    def to_json(self) -> dict:
        return {"type": "standardize", "mean": self.mean.tolist(),
                "std": self.std.tolist()}


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data) -> None:
        feats = _collect_features(data)
        if feats.ndim == 2:
            self.data_min = feats.min(axis=0)
            self.data_max = feats.max(axis=0)
        else:
            # images and sequences: one global range
            self.data_min = np.asarray(feats.min())
            self.data_max = np.asarray(feats.max())

    def _scale(self) -> np.ndarray:
        span = np.maximum(self.data_max - self.data_min, 1e-8)
        return (self.max_range - self.min_range) / span

    def transform(self, ds: DataSet) -> None:
        x = ds.features
        ds.features = ((x - _stat(self.data_min, x)) * _stat(self._scale(), x)
                       + self.min_range)

    def revert_features(self, x):
        return ((x - self.min_range) / _stat(self._scale(), x)
                + _stat(self.data_min, x))

    def to_json(self) -> dict:
        return {"type": "minmax",
                "data_min": np.asarray(self.data_min).tolist(),
                "data_max": np.asarray(self.data_max).tolist(),
                "min_range": self.min_range, "max_range": self.max_range}


class ImagePreProcessingScaler(Normalizer):
    """Raw pixels ``[0, max_pixel]`` to ``[min_range, max_range]``
    (stateless), in float32."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data) -> None:
        pass

    def transform(self, ds: DataSet) -> None:
        x = ds.features
        x = x.to(torch.float32) if isinstance(x, torch.Tensor) \
            else np.asarray(x).astype(np.float32)
        ds.features = (x / self.max_pixel * (self.max_range - self.min_range)
                       + self.min_range)

    def revert_features(self, x):
        return ((x - self.min_range) / (self.max_range - self.min_range)
                * self.max_pixel)

    def to_json(self) -> dict:
        return {"type": "image", "min_range": self.min_range,
                "max_range": self.max_range, "max_pixel": self.max_pixel}


def normalizer_from_json(d: dict) -> Normalizer:
    """A normalizer from its ``to_json`` dict (either package's)."""
    t = d["type"]
    if t == "standardize":
        n = NormalizerStandardize()
        n.mean = np.asarray(d["mean"])
        n.std = np.asarray(d["std"])
        return n
    if t == "minmax":
        n = NormalizerMinMaxScaler(d["min_range"], d["max_range"])
        n.data_min = np.asarray(d["data_min"])
        n.data_max = np.asarray(d["data_max"])
        return n
    if t == "image":
        return ImagePreProcessingScaler(d["min_range"], d["max_range"],
                                        d["max_pixel"])
    raise ValueError(f"unknown normalizer type {t!r}")


def _collect_features(data) -> np.ndarray:
    if isinstance(data, DataSet):
        return _np(data.features)
    data.reset()
    parts = [_np(ds.features) for ds in data]
    data.reset()
    return np.concatenate(parts)
