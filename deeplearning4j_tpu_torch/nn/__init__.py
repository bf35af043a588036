from .conf.builder import NeuralNetConfiguration
from .conf.inputs import InputType
from .conf import layers
from .graph import (ComputationGraph, ComputationGraphConfiguration,
                    ElementWiseVertex, GraphBuilder, MergeVertex)
from .multilayer import MultiLayerNetwork
from .transfer import (FineTuneConfiguration, TransferLearning,
                       TransferLearningHelper)
