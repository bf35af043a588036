"""Model zoo: the CNNs and the character-level LSTM of the JAX package's zoo.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``, each model with the JAX
constructor's arguments and defaults and the JAX configuration letter for
letter: the ``MultiLayerNetwork``s LeNet, SimpleCNN, AlexNet, VGG16, VGG19,
Darknet19, TinyYOLO and TextGenerationLSTM (parameters carry across by
layer), and the
``ComputationGraph``s ResNet50, SqueezeNet, UNet, YOLO2, Xception,
InceptionResNetV1, FaceNetNN4Small2 and NASNet, with the JAX package's node
names (parameters carry across by name, ``util/convert.py``). ``conf()``
builds the configuration without allocating; ``init(device=)`` the
initialized network, on the card unless the caller asks for another device.
``init_pretrained`` reads a model zip from the local cache of pretrained
weights (``ZooModel``).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

from ..learning.updaters import Adam, Nesterovs
from ..nn.conf import layers as L
from ..nn.conf.builder import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.graph import (ComputationGraph, ComputationGraphConfiguration,
                        ElementWiseVertex, L2NormalizeVertex, MergeVertex)
from ..nn.multilayer import MultiLayerNetwork


def network(conf):
    """The network a zoo configuration builds: a ``ComputationGraph`` or a
    ``MultiLayerNetwork`` (not yet initialized)."""
    if isinstance(conf, ComputationGraphConfiguration):
        return ComputationGraph(conf)
    return MultiLayerNetwork(conf)


class PretrainedType:
    """The kinds of pretrained weights (reference
    ``org.deeplearning4j.zoo.PretrainedType``)."""

    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"


class ZooModel:
    """A zoo model: ``conf()``, ``init(device=)`` and the pretrained
    weights of a local cache. ``$DL4J_TPU_PRETRAINED_DIR`` (default
    ``~/.deeplearning4j_tpu/pretrained``, the JAX package's) holds one
    model zip per model and kind, ``<ModelClass>_<kind>.zip``
    (``util/model_serializer.write_model``); ``init_pretrained`` reads one.
    Nothing is downloaded: a missing file raises with the path to fill, as
    in the JAX package (``models/zoo.py:30-84``), where DL4J downloads."""

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """The initialized network, on the card unless ``device`` says
        otherwise."""
        return network(self.conf()).init(device=device)

    @staticmethod
    def pretrained_cache_dir() -> str:
        return os.environ.get(
            "DL4J_TPU_PRETRAINED_DIR",
            os.path.join(os.path.expanduser("~"), ".deeplearning4j_tpu",
                         "pretrained"))

    def pretrained_path(self, kind: str = PretrainedType.IMAGENET) -> str:
        return os.path.join(self.pretrained_cache_dir(),
                            f"{type(self).__name__}_{kind}.zip")

    def pretrained_available(self,
                             kind: str = PretrainedType.IMAGENET) -> bool:
        return os.path.exists(self.pretrained_path(kind))

    def init_pretrained(self, kind: str = PretrainedType.IMAGENET,
                        device=None):
        """The network of the cached model zip for ``kind``, on the card
        unless ``device`` says otherwise."""
        from ..util.model_serializer import restore_model

        path = self.pretrained_path(kind)
        if not os.path.exists(path):
            raise RuntimeError(
                f"{type(self).__name__}: no pretrained {kind!r} weights in "
                f"the local cache ({path}). Nothing is downloaded: place a "
                f"model zip at that path (or set DL4J_TPU_PRETRAINED_DIR), "
                f"or train from scratch with init().")
        return restore_model(path, device=device)

    initPretrained = init_pretrained


def _graph(seed: int, updater, activation: str = "relu",
           weight_init: str = "relu"):
    """A graph builder over the zoo's usual global configuration, with the
    input ``"input"`` declared."""
    b = NeuralNetConfiguration.builder().seed(seed).updater(updater)
    if activation is not None:
        b = b.activation(activation)
    return (ComputationGraphConfiguration.graph_builder(
        b.weight_init(weight_init)).add_inputs("input"))


class ResNet50(ZooModel):
    """The reference zoo ResNet-50: conv/identity bottleneck blocks with
    ElementWiseVertex(add) residuals, NCHW."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 image_size: int = 224):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> ComputationGraphConfiguration:
        gb = (ComputationGraphConfiguration
              .graph_builder(NeuralNetConfiguration.builder()
                             .seed(self.seed)
                             .updater(Nesterovs(learning_rate=0.1,
                                                momentum=0.9))
                             .activation("relu").weight_init("relu")
                             .l2(1e-4))
              .add_inputs("input"))
        gb.add_layer("stem_conv", L.ConvolutionLayer(
            n_out=64, kernel_size=(7, 7), stride=(2, 2), padding=(3, 3),
            has_bias=False, activation="identity"), "input")
        gb.add_layer("stem_bn", L.BatchNormalization(activation="relu"),
                     "stem_conv")
        gb.add_layer("stem_pool", L.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), "stem_bn")

        prev = "stem_pool"
        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                  (3, 512, 2048, 2)]
        for s, (blocks, mid, out_ch, first_stride) in enumerate(stages):
            for b in range(blocks):
                stride = first_stride if b == 0 else 1
                name = f"s{s}b{b}"
                # main path: 1x1 -> 3x3 -> 1x1 (bottleneck)
                gb.add_layer(f"{name}_c1", L.ConvolutionLayer(
                    n_out=mid, kernel_size=(1, 1), stride=(stride, stride),
                    has_bias=False, activation="identity"), prev)
                gb.add_layer(f"{name}_bn1",
                             L.BatchNormalization(activation="relu"),
                             f"{name}_c1")
                gb.add_layer(f"{name}_c2", L.ConvolutionLayer(
                    n_out=mid, kernel_size=(3, 3), padding=(1, 1),
                    has_bias=False, activation="identity"), f"{name}_bn1")
                gb.add_layer(f"{name}_bn2",
                             L.BatchNormalization(activation="relu"),
                             f"{name}_c2")
                gb.add_layer(f"{name}_c3", L.ConvolutionLayer(
                    n_out=out_ch, kernel_size=(1, 1), has_bias=False,
                    activation="identity"), f"{name}_bn2")
                gb.add_layer(f"{name}_bn3",
                             L.BatchNormalization(activation="identity"),
                             f"{name}_c3")
                # shortcut
                if b == 0:
                    gb.add_layer(f"{name}_sc", L.ConvolutionLayer(
                        n_out=out_ch, kernel_size=(1, 1),
                        stride=(stride, stride), has_bias=False,
                        activation="identity"), prev)
                    gb.add_layer(f"{name}_scbn", L.BatchNormalization(
                        activation="identity"), f"{name}_sc")
                    shortcut = f"{name}_scbn"
                else:
                    shortcut = prev
                gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                              f"{name}_bn3", shortcut)
                gb.add_layer(f"{name}_relu",
                             L.ActivationLayer(activation="relu"),
                             f"{name}_add")
                prev = f"{name}_relu"

        gb.add_layer("avgpool", L.GlobalPoolingLayer(pooling_type="avg"),
                     prev)
        gb.add_layer("output", L.OutputLayer(
            n_out=self.num_classes, loss="mcxent", activation="softmax"),
            "avgpool")
        return (gb.set_outputs("output")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class LeNet(ZooModel):
    """The zoo LeNet (MNIST): conv 20 and 50 5x5, max pools 2x2, dense
    500, softmax; Nesterovs(0.01, 0.9), relu, xavier (``bench.py``'s
    ``_lenet_model`` with seed 123)."""

    def __init__(self, num_classes: int = 10, seed: int = 123):
        self.num_classes = num_classes
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Nesterovs(learning_rate=0.01, momentum=0.9))
                .activation("relu").weight_init("xavier")
                .list()
                .layer(L.ConvolutionLayer(n_out=20, kernel_size=(5, 5)))
                .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(L.ConvolutionLayer(n_out=50, kernel_size=(5, 5)))
                .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(L.DenseLayer(n_out=500))
                .layer(L.OutputLayer(n_out=self.num_classes, loss="mcxent",
                                     activation="softmax"))
                .set_input_type(InputType.convolutional(28, 28, 1))
                .build())


class VGG16(ZooModel):
    """The zoo VGG16 (224x224x3): 13 3x3 convolutions with padding 1 in
    five blocks, each closed by a 2x2 max pool, two dense 4096 layers with
    input dropout 0.5, softmax; Nesterovs(0.01, 0.9), relu, He init.
    138,357,544 parameters at 1000 classes."""

    def __init__(self, num_classes: int = 1000, seed: int = 123):
        self.num_classes = num_classes
        self.seed = seed

    def _blocks(self) -> Sequence[Tuple[int, int]]:
        return [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def conf(self) -> MultiLayerConfiguration:
        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed)
              .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
              .activation("relu").weight_init("relu")
              .list())
        for n_convs, ch in self._blocks():
            for _ in range(n_convs):
                lb = lb.layer(L.ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                                 padding=(1, 1)))
            lb = lb.layer(L.SubsamplingLayer(kernel_size=(2, 2),
                                             stride=(2, 2)))
        return (lb.layer(L.DenseLayer(n_out=4096, dropout=0.5))
                .layer(L.DenseLayer(n_out=4096, dropout=0.5))
                .layer(L.OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(224, 224, 3))
                .build())


class VGG19(VGG16):
    """The zoo VGG19: VGG16 with four convolutions in each of the last
    three blocks (143,667,240 parameters at 1000 classes)."""

    def _blocks(self):
        return [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class SimpleCNN(ZooModel):
    """The zoo SimpleCNN (48x48x3): three 3x3 convolutions with padding 1,
    each followed by BatchNormalization, two 2x2 max pools, dense 256,
    dropout 0.5, softmax; Adam(5e-4), relu."""

    def __init__(self, num_classes: int = 10, input_shape=(3, 48, 48),
                 seed: int = 123):
        self.num_classes = num_classes
        self.input_shape = input_shape
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        c, h, w = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(Adam(5e-4)).activation("relu")
                .list()
                .layer(L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.BatchNormalization())
                .layer(L.ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.BatchNormalization())
                .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(L.ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.BatchNormalization())
                .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(L.DenseLayer(n_out=256))
                .layer(L.DropoutLayer(rate=0.5))
                .layer(L.OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


class AlexNet(ZooModel):
    """The zoo AlexNet, single tower (227x227x3): conv 96 11x11/4, LRN,
    max pool, conv 256 5x5, LRN, max pool, three 3x3 convolutions, max
    pool, two dense 4096 with input dropout 0.5, softmax; Nesterovs(0.01,
    0.9), relu, He init."""

    def __init__(self, num_classes: int = 1000, seed: int = 123):
        self.num_classes = num_classes
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Nesterovs(learning_rate=1e-2, momentum=0.9))
                .activation("relu").weight_init("relu")
                .list()
                .layer(L.ConvolutionLayer(n_out=96, kernel_size=(11, 11),
                                          stride=(4, 4)))
                .layer(L.LocalResponseNormalization())
                .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(L.ConvolutionLayer(n_out=256, kernel_size=(5, 5),
                                          padding=(2, 2)))
                .layer(L.LocalResponseNormalization())
                .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(L.ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                          padding=(1, 1)))
                .layer(L.SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(L.DenseLayer(n_out=4096, dropout=0.5))
                .layer(L.DenseLayer(n_out=4096, dropout=0.5))
                .layer(L.OutputLayer(n_out=self.num_classes))
                .set_input_type(InputType.convolutional(227, 227, 3))
                .build())


class SqueezeNet(ZooModel):
    """The zoo SqueezeNet (224x224x3): fire modules (1x1 squeeze, 1x1 and
    3x3 expands joined by a MergeVertex), dropout 0.5, a 1x1 convolution to
    the classes, global average pooling and a softmax LossLayer;
    Adam(1e-3), relu, He init."""

    def __init__(self, num_classes: int = 1000, seed: int = 123):
        self.num_classes = num_classes
        self.seed = seed

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3))
        gb.add_layer("conv1", L.ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                                 stride=(2, 2)), "input")
        gb.add_layer("pool1", L.SubsamplingLayer(kernel_size=(3, 3),
                                                 stride=(2, 2)), "conv1")

        def fire(name, squeeze, expand, inp):
            gb.add_layer(f"{name}_sq", L.ConvolutionLayer(
                n_out=squeeze, kernel_size=(1, 1)), inp)
            gb.add_layer(f"{name}_e1", L.ConvolutionLayer(
                n_out=expand, kernel_size=(1, 1)), f"{name}_sq")
            gb.add_layer(f"{name}_e3", L.ConvolutionLayer(
                n_out=expand, kernel_size=(3, 3), padding=(1, 1)),
                f"{name}_sq")
            gb.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1",
                          f"{name}_e3")
            return f"{name}_cat"

        prev = fire("fire2", 16, 64, "pool1")
        prev = fire("fire3", 16, 64, prev)
        gb.add_layer("pool3", L.SubsamplingLayer(kernel_size=(3, 3),
                                                 stride=(2, 2)), prev)
        prev = fire("fire4", 32, 128, "pool3")
        prev = fire("fire5", 32, 128, prev)
        gb.add_layer("pool5", L.SubsamplingLayer(kernel_size=(3, 3),
                                                 stride=(2, 2)), prev)
        prev = fire("fire6", 48, 192, "pool5")
        prev = fire("fire7", 48, 192, prev)
        prev = fire("fire8", 64, 256, prev)
        prev = fire("fire9", 64, 256, prev)
        gb.add_layer("drop", L.DropoutLayer(rate=0.5), prev)
        gb.add_layer("conv10", L.ConvolutionLayer(n_out=self.num_classes,
                                                  kernel_size=(1, 1)), "drop")
        gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"),
                     "conv10")
        gb.add_layer("output", L.LossLayer(loss="mcxent",
                                           activation="softmax"), "gap")
        return (gb.set_outputs("output")
                .set_input_types(InputType.convolutional(224, 224, 3))
                .build())


class Darknet19(ZooModel):
    """The zoo Darknet19: 3x3 and 1x1 convolutions without bias, each with a
    leakyrelu BatchNormalization, five 2x2 max pools, a 1x1 convolution to
    the classes, global average pooling and a softmax LossLayer;
    Nesterovs(1e-3, 0.9), He init."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 image_size: int = 224):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> MultiLayerConfiguration:
        def conv_bn(lb, ch, k):
            pad = (k // 2, k // 2) if k > 1 else (0, 0)
            return (lb.layer(L.ConvolutionLayer(
                        n_out=ch, kernel_size=(k, k), padding=pad,
                        has_bias=False, activation="identity"))
                    .layer(L.BatchNormalization(activation="leakyrelu")))

        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed).updater(Nesterovs(1e-3, 0.9))
              .weight_init("relu").list())
        lb = conv_bn(lb, 32, 3)
        lb = lb.layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        lb = conv_bn(lb, 64, 3)
        lb = lb.layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for chs in ([128, 64, 128], [256, 128, 256]):
            for i, ch in enumerate(chs):
                lb = conv_bn(lb, ch, 3 if i % 2 == 0 else 1)
            lb = lb.layer(L.SubsamplingLayer(kernel_size=(2, 2),
                                             stride=(2, 2)))
        for chs in ([512, 256, 512, 256, 512], [1024, 512, 1024, 512, 1024]):
            for i, ch in enumerate(chs):
                lb = conv_bn(lb, ch, 3 if i % 2 == 0 else 1)
            if chs[0] == 512:
                lb = lb.layer(L.SubsamplingLayer(kernel_size=(2, 2),
                                                 stride=(2, 2)))
        lb = lb.layer(L.ConvolutionLayer(n_out=self.num_classes,
                                         kernel_size=(1, 1)))
        lb = lb.layer(L.GlobalPoolingLayer(pooling_type="avg"))
        return (lb.layer(L.LossLayer(loss="mcxent", activation="softmax"))
                .set_input_type(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class UNet(ZooModel):
    """The zoo UNet (segmentation): three double-convolution levels down
    with max pools, a middle level, three Deconvolution2D (2x2, stride 2)
    levels up, each merged with its skip; a 1x1 head and a sigmoid
    binary-cross-entropy LossLayer; Adam(1e-4), relu, He init."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1,
                 seed: int = 123, image_size: int = 128, base: int = 32):
        self.n_channels = n_channels
        self.n_classes = n_classes
        self.seed = seed
        self.image_size = image_size
        self.base = base

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-4))

        def double_conv(name, ch, inp):
            gb.add_layer(f"{name}_c1", L.ConvolutionLayer(
                n_out=ch, kernel_size=(3, 3), padding=(1, 1)), inp)
            gb.add_layer(f"{name}_c2", L.ConvolutionLayer(
                n_out=ch, kernel_size=(3, 3), padding=(1, 1)), f"{name}_c1")
            return f"{name}_c2"

        b = self.base
        d1 = double_conv("down1", b, "input")
        gb.add_layer("pool1", L.SubsamplingLayer(kernel_size=(2, 2),
                                                 stride=(2, 2)), d1)
        d2 = double_conv("down2", b * 2, "pool1")
        gb.add_layer("pool2", L.SubsamplingLayer(kernel_size=(2, 2),
                                                 stride=(2, 2)), d2)
        d3 = double_conv("down3", b * 4, "pool2")
        gb.add_layer("pool3", L.SubsamplingLayer(kernel_size=(2, 2),
                                                 stride=(2, 2)), d3)
        mid = double_conv("mid", b * 8, "pool3")
        prev = mid
        for level, skip in ((3, d3), (2, d2), (1, d1)):
            ch = b * 2 ** (level - 1)
            gb.add_layer(f"up{level}", L.Deconvolution2D(
                n_out=ch, kernel_size=(2, 2), stride=(2, 2)), prev)
            gb.add_vertex(f"cat{level}", MergeVertex(), f"up{level}", skip)
            prev = double_conv(f"upc{level}", ch, f"cat{level}")
        gb.add_layer("head", L.ConvolutionLayer(
            n_out=self.n_classes, kernel_size=(1, 1), activation="identity"),
            prev)
        gb.add_layer("output", L.LossLayer(loss="binary_xent",
                                           activation="sigmoid"), "head")
        return (gb.set_outputs("output")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, self.n_channels))
                .build())


class TextGenerationLSTM(ZooModel):
    """The zoo's character-level language model: two LSTM(hidden) layers and
    a softmax RnnOutputLayer with mcxent over the vocabulary, Adam(2e-3),
    one-hot characters in."""

    def __init__(self, vocab_size: int, hidden: int = 256, seed: int = 123):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(Adam(2e-3))
                .list()
                .layer(L.LSTM(n_out=self.hidden))
                .layer(L.LSTM(n_out=self.hidden))
                .layer(L.RnnOutputLayer(n_out=self.vocab_size, loss="mcxent",
                                        activation="softmax"))
                .set_input_type(InputType.recurrent(self.vocab_size))
                .build())


class TinyYOLO(ZooModel):
    """The zoo TinyYOLO: a darknet-tiny backbone (3x3 convolutions without
    bias, leakyrelu BatchNormalizations, six max pools, the last stride 1
    with padding 1) and the YOLOv2 head over 5 anchors (VOC's); Adam(1e-3),
    He init."""

    ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
               (16.62, 10.52))

    def __init__(self, num_classes: int = 20, seed: int = 123,
                 image_size: int = 416):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> MultiLayerConfiguration:
        def conv_bn(lb, ch):
            return (lb.layer(L.ConvolutionLayer(
                        n_out=ch, kernel_size=(3, 3), padding=(1, 1),
                        has_bias=False, activation="identity"))
                    .layer(L.BatchNormalization(activation="leakyrelu")))

        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed).updater(Adam(1e-3)).weight_init("relu")
              .list())
        for i, ch in enumerate((16, 32, 64, 128, 256, 512)):
            lb = conv_bn(lb, ch)
            lb = lb.layer(L.SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2) if i < 5 else (1, 1),
                padding=(0, 0) if i < 5 else (1, 1)))
        lb = conv_bn(lb, 1024)
        lb = conv_bn(lb, 1024)
        lb = lb.layer(L.ConvolutionLayer(
            n_out=len(self.ANCHORS) * (5 + self.num_classes),
            kernel_size=(1, 1), activation="identity"))
        return (lb.layer(L.Yolo2OutputLayer(anchors=self.ANCHORS))
                .set_input_type(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class YOLO2(ZooModel):
    """The zoo YOLO2: the Darknet-19 backbone, the passthrough route (the
    26x26 map through a SpaceToDepthLayer merged with the deep path) and
    the YOLOv2 head over 5 anchors (COCO's); Adam(1e-3), He init."""

    ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
               (7.88282, 3.52778), (9.77052, 9.16828))

    def __init__(self, num_classes: int = 80, seed: int = 123,
                 image_size: int = 416):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3), activation=None)
        idx = [0]

        def conv_bn(name_in, ch, k):
            i = idx[0]
            idx[0] += 1
            pad = (k // 2, k // 2) if k > 1 else (0, 0)
            gb.add_layer(f"conv{i}", L.ConvolutionLayer(
                n_out=ch, kernel_size=(k, k), padding=pad, has_bias=False,
                activation="identity"), name_in)
            gb.add_layer(f"bn{i}", L.BatchNormalization(
                activation="leakyrelu"), f"conv{i}")
            return f"bn{i}"

        def pool(name_in):
            i = idx[0]
            idx[0] += 1
            gb.add_layer(f"pool{i}", L.SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2)), name_in)
            return f"pool{i}"

        prev = pool(conv_bn("input", 32, 3))
        prev = pool(conv_bn(prev, 64, 3))
        for chs in ([128, 64, 128], [256, 128, 256]):
            for j, ch in enumerate(chs):
                prev = conv_bn(prev, ch, 3 if j % 2 == 0 else 1)
            prev = pool(prev)
        for j, ch in enumerate([512, 256, 512, 256, 512]):
            prev = conv_bn(prev, ch, 3 if j % 2 == 0 else 1)
        route = prev                       # the 26x26x512 passthrough
        prev = pool(prev)
        for j, ch in enumerate([1024, 512, 1024, 512, 1024]):
            prev = conv_bn(prev, ch, 3 if j % 2 == 0 else 1)
        prev = conv_bn(prev, 1024, 3)
        prev = conv_bn(prev, 1024, 3)
        gb.add_layer("reorg", L.SpaceToDepthLayer(block_size=2), route)
        gb.add_vertex("route_cat", MergeVertex(), "reorg", prev)
        prev = conv_bn("route_cat", 1024, 3)
        gb.add_layer("head", L.ConvolutionLayer(
            n_out=len(self.ANCHORS) * (5 + self.num_classes),
            kernel_size=(1, 1), activation="identity"), prev)
        gb.add_layer("yolo", L.Yolo2OutputLayer(anchors=self.ANCHORS),
                     "head")
        return (gb.set_outputs("yolo")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class Xception(ZooModel):
    """The zoo Xception (299x299x3): entry, middle (8 blocks) and exit
    flows of SAME separable convolutions with BatchNormalization, strided
    1x1 projections added back (ElementWiseVertex), global average
    pooling, softmax; Adam(1e-3), relu, He init."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 image_size: int = 299):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3))
        n = [0]

        def nxt():
            i = n[0]
            n[0] += 1
            return i

        def sep_bn(name_in, ch, act="relu"):
            i = nxt()
            gb.add_layer(f"sep{i}", L.SeparableConvolution2D(
                n_out=ch, kernel_size=(3, 3), convolution_mode="same",
                has_bias=False, activation="identity"), name_in)
            gb.add_layer(f"sbn{i}", L.BatchNormalization(activation=act),
                         f"sep{i}")
            return f"sbn{i}"

        def conv_bn(name_in, ch, k, stride, act="relu"):
            i = nxt()
            gb.add_layer(f"cv{i}", L.ConvolutionLayer(
                n_out=ch, kernel_size=(k, k), stride=(stride, stride),
                convolution_mode="same", has_bias=False,
                activation="identity"), name_in)
            gb.add_layer(f"cbn{i}", L.BatchNormalization(activation=act),
                         f"cv{i}")
            return f"cbn{i}"

        def maxpool(name_in):
            i = nxt()
            gb.add_layer(f"mp{i}", L.SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), name_in)
            return f"mp{i}"

        def add(a, b):
            name = f"add{nxt()}"
            gb.add_vertex(name, ElementWiseVertex("add"), a, b)
            return name

        # entry flow
        prev = conv_bn("input", 32, 3, 2)
        prev = conv_bn(prev, 64, 3, 1)
        for ch in (128, 256, 728):
            res = conv_bn(prev, ch, 1, 2, act="identity")
            x = sep_bn(prev, ch)
            x = sep_bn(x, ch, act="identity")
            prev = add(maxpool(x), res)
        # middle flow: 8 blocks of 3 separable convs + identity residual
        for _ in range(8):
            x = prev
            for _ in range(3):
                x = sep_bn(x, 728)
            prev = add(x, prev)
        # exit flow
        res = conv_bn(prev, 1024, 1, 2, act="identity")
        x = sep_bn(prev, 728)
        x = sep_bn(x, 1024, act="identity")
        prev = sep_bn(add(maxpool(x), res), 1536)
        prev = sep_bn(prev, 2048)
        gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), prev)
        gb.add_layer("out", L.OutputLayer(n_out=self.num_classes,
                                          loss="mcxent",
                                          activation="softmax"), "gap")
        return (gb.set_outputs("out")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class InceptionResNetV1(ZooModel):
    """The zoo InceptionResNetV1 (160x160x3): a stem, 5 inception-resnet-A
    blocks (256 channels), reduction-A, 10 blocks B (896), reduction-B, 5
    blocks C (1792); each block's branches merged, projected by a 1x1
    convolution, added back and relu'd; global average pooling, a 128-wide
    bottleneck and a softmax LossLayer; Adam(1e-3), relu, He init."""

    def __init__(self, num_classes: int = 128, seed: int = 123,
                 image_size: int = 160):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3))
        n = [0]

        def nxt():
            i = n[0]
            n[0] += 1
            return i

        def conv(name_in, ch, k, stride=1, same=True, act="relu"):
            i = nxt()
            gb.add_layer(f"c{i}", L.ConvolutionLayer(
                n_out=ch, kernel_size=(k, k), stride=(stride, stride),
                convolution_mode="same" if same else "truncate",
                has_bias=False, activation="identity"), name_in)
            gb.add_layer(f"b{i}", L.BatchNormalization(activation=act),
                         f"c{i}")
            return f"b{i}"

        def resnet_block(prev, branches, proj_ch):
            """concat(branches) -> 1x1 proj -> add residual -> relu."""
            i = nxt()
            gb.add_vertex(f"cat{i}", MergeVertex(), *branches)
            gb.add_layer(f"proj{i}", L.ConvolutionLayer(
                n_out=proj_ch, kernel_size=(1, 1),
                activation="identity"), f"cat{i}")
            gb.add_vertex(f"radd{i}", ElementWiseVertex("add"),
                          f"proj{i}", prev)
            gb.add_layer(f"ract{i}", L.ActivationLayer(activation="relu"),
                         f"radd{i}")
            return f"ract{i}"

        prev = conv("input", 32, 3, stride=2)
        prev = conv(prev, 32, 3)
        prev = conv(prev, 64, 3)
        gb.add_layer("stem_pool", L.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), prev)
        prev = conv("stem_pool", 80, 1)
        prev = conv(prev, 192, 3)
        prev = conv(prev, 256, 3, stride=2)
        for _ in range(5):                 # inception-resnet-A (256)
            b1 = conv(prev, 32, 1)
            b2 = conv(conv(prev, 32, 1), 32, 3)
            b3 = conv(conv(conv(prev, 32, 1), 32, 3), 32, 3)
            prev = resnet_block(prev, (b1, b2, b3), 256)
        ra1 = conv(prev, 384, 3, stride=2)  # reduction-A -> 896
        ra2 = conv(conv(conv(prev, 192, 1), 192, 3), 256, 3, stride=2)
        gb.add_layer("redA_pool", L.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), prev)
        gb.add_vertex("redA", MergeVertex(), ra1, ra2, "redA_pool")
        prev = "redA"
        for _ in range(10):                # inception-resnet-B (896)
            b1 = conv(prev, 128, 1)
            b2 = conv(conv(prev, 128, 1), 128, 7)
            prev = resnet_block(prev, (b1, b2), 896)
        rb1 = conv(conv(prev, 256, 1), 384, 3, stride=2)  # reduction-B
        rb2 = conv(conv(prev, 256, 1), 256, 3, stride=2)
        rb3 = conv(conv(conv(prev, 256, 1), 256, 3), 256, 3, stride=2)
        gb.add_layer("redB_pool", L.SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), prev)
        gb.add_vertex("redB", MergeVertex(), rb1, rb2, rb3, "redB_pool")
        prev = "redB"
        for _ in range(5):                 # inception-resnet-C (1792)
            b1 = conv(prev, 192, 1)
            b2 = conv(conv(prev, 192, 1), 192, 3)
            prev = resnet_block(prev, (b1, b2), 1792)
        gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), prev)
        gb.add_layer("bottleneck", L.DenseLayer(
            n_out=self.num_classes, activation="identity"), "gap")
        gb.add_layer("out", L.LossLayer(loss="mcxent",
                                        activation="softmax"), "bottleneck")
        return (gb.set_outputs("out")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class FaceNetNN4Small2(ZooModel):
    """The zoo FaceNetNN4Small2 (96x96x3, OpenFace nn4.small2): stem
    convolutions, inception modules (1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1
    merged), a 128-wide embedding, an L2NormalizeVertex and a
    CenterLossOutputLayer (alpha 0.1, lambda 3e-4); Adam(1e-3), relu, He
    init."""

    def __init__(self, num_classes: int = 100, embedding_size: int = 128,
                 seed: int = 123, image_size: int = 96):
        self.num_classes = num_classes
        self.embedding_size = embedding_size
        self.seed = seed
        self.image_size = image_size

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3))
        n = [0]

        def conv_bn(inp, ch, k, stride=1, pad=None):
            i = n[0]
            n[0] += 1
            pad = pad if pad is not None else k // 2
            gb.add_layer(f"c{i}", L.ConvolutionLayer(
                n_out=ch, kernel_size=(k, k), stride=(stride, stride),
                padding=(pad, pad), has_bias=False,
                activation="identity"), inp)
            gb.add_layer(f"b{i}", L.BatchNormalization(activation="relu"),
                         f"c{i}")
            return f"b{i}"

        def inception(name, inp, b1x1, b3r, b3, b5r, b5, pool_proj):
            """1x1 | 1x1 -> 3x3 | 1x1 -> 5x5 | pool -> 1x1, merged; a zero
            width drops its branch."""
            outs = []
            if b1x1:
                outs.append(conv_bn(inp, b1x1, 1))
            if b3:
                outs.append(conv_bn(conv_bn(inp, b3r, 1), b3, 3))
            if b5:
                outs.append(conv_bn(conv_bn(inp, b5r, 1), b5, 5))
            if pool_proj:
                gb.add_layer(f"{name}_pool", L.SubsamplingLayer(
                    kernel_size=(3, 3), stride=(1, 1), padding=(1, 1)), inp)
                outs.append(conv_bn(f"{name}_pool", pool_proj, 1))
            gb.add_vertex(f"{name}_cat", MergeVertex(), *outs)
            return f"{name}_cat"

        def pool(name, inp):
            gb.add_layer(name, L.SubsamplingLayer(
                kernel_size=(3, 3), stride=(2, 2), padding=(1, 1)), inp)
            return name

        prev = pool("stem_pool", conv_bn("input", 64, 7, 2, 3))
        prev = conv_bn(prev, 64, 1)
        prev = pool("stem_pool2", conv_bn(prev, 192, 3))
        prev = inception("i3a", prev, 64, 96, 128, 16, 32, 32)
        prev = inception("i3b", prev, 64, 96, 128, 32, 64, 64)
        prev = inception("i4a", pool("pool3", prev), 256, 96, 192, 32, 64,
                         128)
        prev = inception("i4e", prev, 0, 160, 256, 64, 128, 0)
        prev = inception("i5a", pool("pool4", prev), 256, 96, 384, 0, 0, 96)
        prev = inception("i5b", prev, 256, 96, 384, 0, 0, 96)
        gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), prev)
        gb.add_layer("bottleneck", L.DenseLayer(
            n_out=self.embedding_size, activation="identity"), "gap")
        gb.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        gb.add_layer("lossLayer", L.CenterLossOutputLayer(
            n_out=self.num_classes, loss="mcxent", activation="softmax",
            alpha=0.1, lambda_=3e-4), "embeddings")
        return (gb.set_outputs("lossLayer")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())


class NASNet(ZooModel):
    """The zoo NASNet (NASNet-A mobile, 96x96x3): a stem convolution and
    three stacks of normal cells with reduction cells between them; each
    cell's five branch pairs (separable 3x3/5x5/7x7, average and max
    pools, identity) added and merged, with 1x1 adjust projections;
    Adam(1e-3), relu, He init."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 image_size: int = 96, penultimate_filters: int = 192,
                 cells_per_stack: int = 2):
        self.num_classes = num_classes
        self.seed = seed
        self.image_size = image_size
        self.filters = penultimate_filters // 24 * 4   # base cell width
        self.cells_per_stack = cells_per_stack

    def conf(self) -> ComputationGraphConfiguration:
        gb = _graph(self.seed, Adam(1e-3))
        n = [0]

        def uid(tag):
            n[0] += 1
            return f"{tag}{n[0]}"

        def adjust(inp, ch, stride=1):
            """1x1 projection + BN to ch channels (the adjust block)."""
            c = uid("adj")
            gb.add_layer(c, L.ConvolutionLayer(
                n_out=ch, kernel_size=(1, 1), stride=(stride, stride),
                has_bias=False, activation="identity"), inp)
            b = uid("adjbn")
            gb.add_layer(b, L.BatchNormalization(activation="identity"), c)
            return b

        def sep(inp, ch, k, stride=1):
            s = uid("sep")
            gb.add_layer(s, L.SeparableConvolution2D(
                n_out=ch, kernel_size=(k, k), stride=(stride, stride),
                convolution_mode="same", has_bias=False,
                activation="identity"), inp)
            b = uid("sepbn")
            gb.add_layer(b, L.BatchNormalization(activation="relu"), s)
            return b

        def avgp(inp, stride=1):
            p = uid("avg")
            gb.add_layer(p, L.SubsamplingLayer(
                kernel_size=(3, 3), stride=(stride, stride), padding=(1, 1),
                pooling_type="avg"), inp)
            return p

        def maxp(inp, stride=1):
            p = uid("max")
            gb.add_layer(p, L.SubsamplingLayer(
                kernel_size=(3, 3), stride=(stride, stride),
                padding=(1, 1)), inp)
            return p

        def add(a, b):
            v = uid("addv")
            gb.add_vertex(v, ElementWiseVertex("add"), a, b)
            return v

        def normal_cell(prev, cur, ch, prev_stride=1):
            p = adjust(prev, ch, prev_stride)
            h = adjust(cur, ch)
            b1 = add(sep(h, ch, 5), sep(p, ch, 3))
            b2 = add(sep(p, ch, 5), sep(p, ch, 3))
            b3 = add(avgp(h), p)
            b4 = add(avgp(p), avgp(p))
            b5 = add(sep(h, ch, 3), h)
            cat = uid("ncat")
            gb.add_vertex(cat, MergeVertex(), b1, b2, b3, b4, b5)
            return cat

        def reduction_cell(prev, cur, ch):
            p = adjust(prev, ch)
            h = adjust(cur, ch)
            b1 = add(sep(h, ch, 5, 2), sep(p, ch, 7, 2))
            b2 = add(maxp(h, 2), sep(p, ch, 7, 2))
            b3 = add(avgp(h, 2), sep(p, ch, 5, 2))
            b4 = add(maxp(h, 2), sep(b1, ch, 3))
            b5 = add(avgp(b1), b2)
            cat = uid("rcat")
            gb.add_vertex(cat, MergeVertex(), b2, b3, b4, b5)
            return cat

        ch = self.filters
        stem = uid("stem")
        gb.add_layer(stem, L.ConvolutionLayer(
            n_out=ch, kernel_size=(3, 3), stride=(2, 2), padding=(1, 1),
            has_bias=False, activation="identity"), "input")
        stem_bn = uid("stembn")
        gb.add_layer(stem_bn, L.BatchNormalization(activation="identity"),
                     stem)
        prev_cell, cur = stem_bn, stem_bn
        after_reduction = False
        for stack in range(3):
            for _ in range(self.cells_per_stack):
                nxt = normal_cell(prev_cell, cur, ch,
                                  prev_stride=2 if after_reduction else 1)
                after_reduction = False
                prev_cell, cur = cur, nxt
            if stack < 2:
                nxt = reduction_cell(prev_cell, cur, ch * 2)
                prev_cell, cur = cur, nxt
                ch *= 2
                after_reduction = True
        act = uid("relu")
        gb.add_layer(act, L.ActivationLayer(activation="relu"), cur)
        gb.add_layer("gap", L.GlobalPoolingLayer(pooling_type="avg"), act)
        gb.add_layer("out", L.OutputLayer(n_out=self.num_classes,
                                          loss="mcxent",
                                          activation="softmax"), "gap")
        return (gb.set_outputs("out")
                .set_input_types(InputType.convolutional(
                    self.image_size, self.image_size, 3))
                .build())
