"""Model zoo: ResNet-50.

Counterpart of ``deeplearning4j_tpu/models/zoo.py`` (``ZooModel``,
``ResNet50``): the same architecture and the same node names, so parameters
carry across from the JAX package by name (``util/convert.py``). Other zoo
models follow with ``MultiLayerNetwork``.
"""

from __future__ import annotations

from ..learning.updaters import Nesterovs
from ..nn.conf import layers as L
from ..nn.conf.builder import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.graph import (ComputationGraph, ComputationGraphConfiguration,
                        ElementWiseVertex)


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
