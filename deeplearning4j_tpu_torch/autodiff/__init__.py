"""SameDiff: symbolic graphs of registered ops, run eagerly, trained by
autograd (counterpart of ``deeplearning4j_tpu/autodiff``)."""

from .history import History
from .samediff import SameDiff, SDVariable, TrainingConfig, VariableType

__all__ = ["History", "SameDiff", "SDVariable", "TrainingConfig",
           "VariableType"]
