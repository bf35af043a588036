from .builder import Builder, GlobalConf, NeuralNetConfiguration
from .inputs import InputType
from . import layers
