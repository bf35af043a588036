"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The port runs on one NVIDIA Hopper card (H100, ``sm_90a``). Its layout and
names mirror the JAX package so that each module's counterpart is easy to
find; inside, it is plain PyTorch: explicit ``torch.device``s, explicit
``torch.Generator``s, eager execution.

Every Pallas kernel of the JAX package that a ported path runs becomes a CUDA
kernel written by hand (``csrc/``), built at first use with ``nvcc`` into
``_build/`` (or the build cache that ``DL4J_TPU_COMPILE_CACHE`` names) and
bound with ``ctypes``. Beside each kernel sits a plain PyTorch
version of the same math; a wrapper takes the plain version only for a tensor
on the CPU (what the CPU tests run), and for a CUDA tensor launches the kernel
or raises.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a card and without that request they raise.

Layer map (ported so far; see ROADMAP.md for what follows):
  common/    environment (device, TF32 policy, the JAX package's switches:
             NAN_PANIC in nan_panic, allow_pallas, the default dtype, the
             persistent build cache in build_cache), dtype table,
             counters, replica-consistency fingerprints (integrity)
  imports/   TF frozen-GraphDef and ONNX import into SameDiff (protobuf
             wire-format readers and writers: no TensorFlow, no onnx),
             Keras .h5/.keras import into MultiLayerNetwork and
             ComputationGraph through an HDF5 reader of its own (no
             h5py), the BERT GraphDef writer that bench.py imports
  autodiff/  SameDiff: graphs of registered ops walked eagerly on the
             device, cond/while_loop, autograd gradients, fit with the
             port's updaters
  ops/       the op registry (all 331 ops of the JAX registry, the
             random family drawing from a torch.Generator), conv2d,
             pooling, inference and training batchnorm, the fused BN
             epilogue, the fused flat-bucket weight update, the embedding
             bag and the CBOW round
  csrc/      hand-written CUDA kernels (bn_act, fused_update, embedding_bag)
  nn/        activations, weight init, losses, layer configs (dropout,
             feature masks), ComputationGraph and MultiLayerNetwork
             (inference and fit)
  learning/  updaters (Sgd, Nesterovs, Adam, AdamW), mixed precision
             (bf16 updater state with stochastic rounding)
  data/      DataSet, iterators (MNIST and the file iterators with their
             synthetic fallbacks), normalizers with their JSON, the input
             pipeline (padded batches, staged feed, host_prefetch) and
             DataVec: record readers, ImageRecordReader, the pre-decoded
             container, AsyncDataSetIterator (the card feed), schema,
             reducers, sequences, analysis
  eval/      Evaluation, RegressionEvaluation, the ROC family, calibration
  optimize/  training listeners, in-step telemetry and the NaN guard,
             early stopping
  ui/        the stats storages that telemetry drains into
  models/    ResNet-50, LeNet, VGG16
  nlp/       Word2Vec (CBOW with negative sampling), tokenizers, vocabulary
  parallel/  ParallelWrapper (data-parallel training, one replica per
             worker: dense, ZeRO-1 and threshold-encoded gradient
             exchanges, elastic resize, the replica-consistency check),
             meshes of device slots, the collectives over replicas,
             ParallelInference (the request micro-batcher), the flat
             bucket layout (Zero1Plan)
  util/      weight, updater-state and Word2Vec carry-over from the JAX
             package (graphs, multilayer networks and SameDiff graphs)
  ndarray/   NDArray (in-place ops, views that write through), the
             factory (Nd4j's creators, gemm, the .npy format) and the
             per-thread random stream (get_random, set_default_seed)
"""

from .common.dtypes import DataType
from .common.environment import Environment
from .ndarray import factory
from .ndarray.ndarray import NDArray
from .ndarray.rng import get_random, set_default_seed

__version__ = "0.1.0"

__all__ = ["DataType", "Environment", "NDArray", "factory", "get_random",
           "set_default_seed"]
