"""Model import: TF frozen GraphDef -> SameDiff.

Counterpart of ``deeplearning4j_tpu/imports`` (reference nd4j
``samediff-import-tensorflow`` and the legacy ``TFGraphMapper``). The
GraphDef is read and written by the port's own protobuf wire-format code
(``graphdef``), so neither TensorFlow nor ``protobuf`` is needed;
``tf_fixtures`` writes the BERT frozen graph that ``bench.py --config bert``
imports. ONNX and Keras import are not ported yet (ROADMAP.md).
"""

from .tf_graph_mapper import (TFGraphMapper, UnsupportedTFOpError,
                              import_frozen_tf, supported_tf_ops, tf_op)

__all__ = ["TFGraphMapper", "UnsupportedTFOpError", "import_frozen_tf",
           "supported_tf_ops", "tf_op"]
