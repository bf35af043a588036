"""Updater configurations.

Counterpart of ``deeplearning4j_tpu/learning/updaters.py``, as configuration
only: ``ResNet50`` names ``Nesterovs`` and other models ``Adam``/``Sgd``.
``apply`` arrives with the training slice and raises until then.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GradientUpdater:
    learning_rate: float = 1e-1

    def apply(self, grads, state, params, iteration):
        raise NotImplementedError(
            f"{type(self).__name__}.apply is not ported yet (training slice)")


@dataclass
class Sgd(GradientUpdater):
    learning_rate: float = 1e-1


@dataclass
class Nesterovs(GradientUpdater):
    learning_rate: float = 0.1
    momentum: float = 0.9


@dataclass
class Adam(GradientUpdater):
    learning_rate: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
