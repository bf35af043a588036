"""DataSet: a features + labels (+ label mask) container.

Counterpart of the core of ``deeplearning4j_tpu/data/dataset.py``: what
``ComputationGraph.fit`` and ``score`` read. Arrays stay as given (numpy
arrays or tensors); the graph moves them to its device when it binds a
batch. Shuffling, splitting and the padded input pipeline are not ported
yet.
"""

from __future__ import annotations


class DataSet:
    def __init__(self, features=None, labels=None, labels_mask=None):
        self.features = features
        self.labels = labels
        self.labels_mask = labels_mask

    def num_examples(self) -> int:
        return int(self.features.shape[0]) if self.features is not None else 0
