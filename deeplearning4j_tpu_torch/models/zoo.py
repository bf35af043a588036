"""Model zoo: ResNet-50, LeNet and VGG16.

Counterpart of ``deeplearning4j_tpu/models/zoo.py``: ``ResNet50`` (a
``ComputationGraph``, with the JAX package's node names, so parameters carry
across by name, ``util/convert.py``), ``LeNet`` (``zoo.py:87-110``) and
``VGG16`` (``zoo.py:172-198``), ``MultiLayerNetwork``s with the JAX
configurations letter for letter, so parameters carry across by layer.
``conf()`` builds the configuration without allocating; ``init(device=)``
the initialized network. AlexNet (``LocalResponseNormalization``),
SimpleCNN (the network's BatchNormalization) and the other zoo models are
not ported yet, nor are pretrained weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from ..learning.updaters import Nesterovs
from ..nn.conf import layers as L
from ..nn.conf.builder import MultiLayerConfiguration, NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.graph import (ComputationGraph, ComputationGraphConfiguration,
                        ElementWiseVertex)
from ..nn.multilayer import MultiLayerNetwork


class ZooModel:
    def init(self, device=None):
        raise NotImplementedError


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

    def init(self, device=None) -> ComputationGraph:
        """The initialized graph, on the card unless ``device`` says
        otherwise."""
        return ComputationGraph(self.conf()).init(device=device)


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

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf()).init(device=device)


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

    def init(self, device=None) -> MultiLayerNetwork:
        return MultiLayerNetwork(self.conf()).init(device=device)
