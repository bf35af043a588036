"""Model import: ONNX and TF frozen GraphDef -> SameDiff, Keras ->
MultiLayerNetwork and ComputationGraph.

Counterpart of ``deeplearning4j_tpu/imports`` (reference nd4j
``samediff-import-onnx``, ``samediff-import-tensorflow`` and the legacy
``TFGraphMapper``). Models are read and written by the port's own protobuf
wire-format code (``onnx_ir`` for ONNX, ``graphdef`` for TensorFlow), so
neither ``onnx``, TensorFlow nor ``protobuf`` is needed; ``tf_fixtures``
writes the BERT frozen graph that ``bench.py --config bert`` imports. Keras
``.h5`` and ``.keras`` files are read by the port's HDF5 reader (``hdf5``;
no ``h5py``) into ``MultiLayerNetwork`` (``keras_import``) and
``ComputationGraph`` (``keras_graph_import``).
"""

from .keras_graph_import import import_functional
from .keras_import import (KerasModelImport, UnsupportedKerasLayerError,
                           register_custom_layer, register_lambda,
                           unregister_custom_layer, unregister_lambda)
from .onnx_import import (OnnxFrameworkImporter, UnsupportedOnnxOpError,
                          import_onnx, onnx_op, supported_onnx_ops)
from .tf_graph_mapper import (TFGraphMapper, UnsupportedTFOpError,
                              import_frozen_tf, supported_tf_ops, tf_op)

__all__ = ["KerasModelImport", "OnnxFrameworkImporter", "TFGraphMapper",
           "UnsupportedKerasLayerError", "UnsupportedOnnxOpError",
           "UnsupportedTFOpError", "import_frozen_tf", "import_functional",
           "import_onnx", "onnx_op", "register_custom_layer",
           "register_lambda", "supported_onnx_ops", "supported_tf_ops",
           "tf_op", "unregister_custom_layer", "unregister_lambda"]
