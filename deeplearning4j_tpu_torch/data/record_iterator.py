"""RecordReader -> DataSet iterators, and the asynchronous device feed.

Counterpart of ``deeplearning4j_tpu/data/record_iterator.py``.
``RecordReaderDataSetIterator`` and ``SequenceRecordReaderDataSetIterator``
are copied (numpy: the same records give the same batches in both
packages). Reference: deeplearning4j-datavec-iterators
``RecordReaderDataSetIterator`` / ``SequenceRecordReaderDataSetIterator``
(label-column extraction, one-hot for classification, regression mode,
alignment + padding masks) and deeplearning4j-utility-iterators
``AsyncDataSetIterator`` (SURVEY.md §2.1 datasets row, §2.3 DataVec rows).

``AsyncDataSetIterator`` reads and assembles the next batches on a worker
thread (``common/background.prefetch_iter``, a queue of ``queue_size``)
while the card trains on the current one. With ``device_prefetch`` each
batch is staged on the card from the consumer's thread, as the JAX package
stages it: the worker has already copied its arrays into pinned host
memory, a ``non_blocking`` copy runs on a side stream, the compute stream
waits on an event recorded after it, and ``record_stream`` tells the caching
allocator that the compute stream uses the staged tensors, so their memory
is not handed out again before the step that reads them has run.
``feature_transform`` (a torch callable) then runs on the card, so a uint8
batch crosses PCIe at a quarter of float32's bytes. For numpy's
``x.astype(float32) / 255`` bit for bit divide by a tensor, ``lambda x:
x.float().div_(d255)`` with ``d255 = torch.full((), 255.0, device=card)``:
on the card PyTorch divides by a Python scalar as a multiplication by its
reciprocal.
"""

from __future__ import annotations

import warnings
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..common.background import prefetch_iter
from ..common.environment import resolve_device
from .dataset import DataSet
from .iterators import DataSetIterator
from .records import RecordReader, SequenceRecordReader


class RecordReaderDataSetIterator(DataSetIterator):
    """Assemble flat records into (features, labels) DataSet batches.

    Classification: ``label_index`` column → one-hot over ``num_classes``.
    Regression: ``regression=True`` keeps label columns as float values
    (``label_index``..``label_index_to`` inclusive, reference semantics).
    Image records (cell 0 is an ndarray) batch by stacking.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to if label_index_to is not None \
            else label_index

    def batch(self) -> int:
        return self.batch_size

    def reset(self) -> None:
        self.reader.reset()

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        batch: List[list] = []
        for rec in self.reader:
            batch.append(rec)
            if len(batch) == self.batch_size:
                yield self._apply_pre(self._assemble(batch))
                batch = []
        if batch:
            yield self._apply_pre(self._assemble(batch))

    def _assemble(self, batch: List[list]) -> DataSet:
        first = batch[0]
        if isinstance(first[0], np.ndarray) and first[0].ndim >= 2:
            # image records: [chw_array, label]
            x = np.stack([r[0] for r in batch]).astype(np.float32)
            y_idx = np.asarray([int(r[1]) for r in batch])
            n = self.num_classes or \
                (self.reader.num_labels()
                 if hasattr(self.reader, "num_labels") else 0)
            if not n:
                # per-batch max(label)+1 would give inconsistent one-hot
                # widths across batches
                raise ValueError("classification needs num_classes (or a "
                                 "reader exposing num_labels())")
            y = np.eye(n, dtype=np.float32)[y_idx]
            return DataSet(x, y)
        width = len(first)
        li = self.label_index % width if self.label_index is not None else None
        if li is None:
            x = np.asarray(batch, dtype=np.float32)
            return DataSet(x, None)
        lt = self.label_index_to % width
        feat_cols = [i for i in range(width) if not li <= i <= lt]
        x = np.asarray([[float(r[i]) for i in feat_cols] for r in batch],
                       dtype=np.float32)
        if self.regression:
            y = np.asarray([[float(r[i]) for i in range(li, lt + 1)]
                            for r in batch], dtype=np.float32)
        else:
            if not self.num_classes:
                raise ValueError("classification needs num_classes")
            y_idx = np.asarray([int(float(r[li])) for r in batch])
            if (y_idx < 0).any() or (y_idx >= self.num_classes).any():
                raise ValueError(
                    f"label index out of range [0, {self.num_classes}): "
                    f"{sorted(set(y_idx.tolist()))[:10]}")
            y = np.eye(self.num_classes, dtype=np.float32)[y_idx]
        return DataSet(x, y)


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence records → [N, T, F] batches with per-timestep label masks,
    padded to the longest sequence in the batch (reference:
    SequenceRecordReaderDataSetIterator, ALIGN_END label alignment with
    padding masks; SURVEY §5.7 masking row).

    DOCUMENTED LAYOUT DIVERGENCE: the reference emits [batch, features,
    time]; this framework's recurrent layers are batch-major
    [batch, time, features] throughout (see nn/conf/layers LSTM), so the
    iterator emits that — labels [N, T, C] one-hot for classification,
    [N, T] masks marking real timesteps.
    """

    def __init__(self, reader: SequenceRecordReader, batch_size: int,
                 label_index: int = -1, num_classes: Optional[int] = None,
                 regression: bool = False):
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def batch(self) -> int:
        return self.batch_size

    def reset(self) -> None:
        self.reader.reset()

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        batch: List[list] = []
        for seq in self.reader.sequences():
            batch.append(seq)
            if len(batch) == self.batch_size:
                yield self._apply_pre(self._assemble(batch))
                batch = []
        if batch:
            yield self._apply_pre(self._assemble(batch))

    def _assemble(self, seqs: List[list]) -> DataSet:
        width = len(seqs[0][0])
        li = self.label_index % width
        feat_cols = [i for i in range(width) if i != li]
        T = max(len(s) for s in seqs)
        N, F = len(seqs), len(feat_cols)
        x = np.zeros((N, T, F), np.float32)
        mask = np.zeros((N, T), np.float32)
        if self.regression:
            y = np.zeros((N, T, 1), np.float32)
        else:
            if not self.num_classes:
                raise ValueError("classification needs num_classes")
            y = np.zeros((N, T, self.num_classes), np.float32)
        for n, seq in enumerate(seqs):
            for t, rec in enumerate(seq):
                for f, col in enumerate(feat_cols):
                    x[n, t, f] = float(rec[col])
                mask[n, t] = 1.0
                if self.regression:
                    y[n, t, 0] = float(rec[li])
                else:
                    y[n, t, int(float(rec[li]))] = 1.0
        return DataSet(x, y, features_mask=mask, labels_mask=mask)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (reference: AsyncDataSetIterator
    with its blocking queue of ``queue_size``). The base may yield DataSets
    or raw ``(x, y)`` numpy tuples (``BinaryRecordDataSetIterator(
    raw_numpy=True)``); either comes out as a DataSet.

    ``device_prefetch=True`` stages every array of a batch on ``device``
    (the card unless the caller asks for another) as the module docstring
    says; ``feature_transform`` needs it. ``device_prefetch=False`` hands
    the batches on as the base made them."""

    def __init__(self, base: DataSetIterator, queue_size: int = 4,
                 device_prefetch: bool = True, feature_transform=None,
                 device=None):
        self.base = base
        self.queue_size = queue_size
        self.device_prefetch = device_prefetch
        if feature_transform is not None and not device_prefetch:
            raise ValueError("feature_transform is applied on device and "
                             "requires device_prefetch=True")
        self.feature_transform = feature_transform
        self.device = resolve_device(device) if device_prefetch else None
        self._copy_stream = None

    def batch(self) -> int:
        return self.base.batch()

    def reset(self) -> None:
        self.base.reset()

    def _host(self, item):
        """Worker side: the batch's arrays as CPU tensors, in pinned memory
        when they go to the card."""
        if not self.device_prefetch:
            return item
        if isinstance(item, tuple):
            arrays = [item[0], item[1], None, None]
        else:
            arrays = [item.features, item.labels, item.features_mask,
                      item.labels_mask]
        pin = self.device.type == "cuda"
        out = []
        for a in arrays:
            if a is not None and not isinstance(a, torch.Tensor):
                a = np.ascontiguousarray(a)
                if not a.flags.writeable and not pin:
                    a = a.copy()
                with warnings.catch_warnings():
                    # a read-only view (the container's memmap) is only
                    # read: the card's batch is a pinned copy of it
                    warnings.simplefilter("ignore", UserWarning)
                    a = torch.from_numpy(a)
            if a is not None and pin and a.device.type == "cpu":
                a = a.pin_memory()
            out.append(a)
        return out

    def _stage(self, item) -> DataSet:
        """Consumer side: the batch on the device (see the module
        docstring), then ``feature_transform``."""
        if not self.device_prefetch:
            if isinstance(item, tuple):
                return DataSet(item[0], item[1])
            return item
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._copy_stream):
                staged = [None if t is None
                          else t.to(self.device, non_blocking=True)
                          for t in item]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
            compute.wait_event(done)
            for t in staged:
                if t is not None:
                    t.record_stream(compute)
        else:
            staged = [None if t is None else t.to(self.device)
                      for t in item]
        if self.feature_transform is not None and staged[0] is not None:
            staged[0] = self.feature_transform(staged[0])
        return DataSet(*staged)

    def __iter__(self) -> Iterator[DataSet]:
        src = (self._host(item) for item in self.base)
        for item in prefetch_iter(src, maxsize=self.queue_size):
            yield self._stage(item)
