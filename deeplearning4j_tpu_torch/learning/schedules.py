"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/learning/schedules.py`` (reference
nd4j-api ``org.nd4j.linalg.schedule.*``): ``FixedSchedule``,
``StepSchedule``, ``ExponentialSchedule``, ``PolySchedule``,
``InverseSchedule``, ``SigmoidSchedule`` and ``CycleSchedule``, each a pure
function of the iteration.

The JAX step traces a schedule with the iteration as an int64 array (the
JAX package turns on ``jax_enable_x64``), so every rate is computed in
float64 and reaches the float32 update as a weakly typed scalar, rounded to
float32 once. Here the iteration is a Python int and each rate a Python
float (float64), with the same expressions; the updaters round it to
float32 once (``learning/updaters.f32_scalars``, ``ops/update._scalars``).
Where ``jnp.exp`` overflows to inf, :func:`_exp` does too (``math.exp``
raises instead).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def _exp(x: float) -> float:
    try:
        return math.exp(x)
    except OverflowError:
        return math.inf


class ISchedule:
    def value_at(self, iteration: int, epoch: int = 0) -> float:
        raise NotImplementedError

    def __call__(self, iteration: int, epoch: int = 0) -> float:
        return self.value_at(iteration, epoch)


@dataclass
class FixedSchedule(ISchedule):
    value: float

    def value_at(self, iteration, epoch=0):
        return self.value


@dataclass
class StepSchedule(ISchedule):
    """lr * decay_rate^floor(iter / step)"""

    initial_value: float
    decay_rate: float
    step: float

    def value_at(self, iteration, epoch=0):
        return self.initial_value * self.decay_rate ** float(
            math.floor(iteration / self.step))


@dataclass
class ExponentialSchedule(ISchedule):
    initial_value: float
    gamma: float

    def value_at(self, iteration, epoch=0):
        return self.initial_value * self.gamma ** float(iteration)


@dataclass
class PolySchedule(ISchedule):
    initial_value: float
    power: float
    max_iter: int

    def value_at(self, iteration, epoch=0):
        frac = min(iteration / self.max_iter, 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@dataclass
class InverseSchedule(ISchedule):
    initial_value: float
    gamma: float
    power: float

    def value_at(self, iteration, epoch=0):
        return self.initial_value / (1.0 + self.gamma * iteration) \
            ** self.power


@dataclass
class SigmoidSchedule(ISchedule):
    initial_value: float
    gamma: float
    step_size: int

    def value_at(self, iteration, epoch=0):
        return self.initial_value / (
            1.0 + _exp(self.gamma * (iteration - self.step_size)))


@dataclass
class CycleSchedule(ISchedule):
    """1cycle-style: ramp up to max, back down, then annihilate."""

    initial_value: float
    max_value: float
    cycle_length: int
    annealing_cycles: float = 0.1

    def value_at(self, iteration, epoch=0):
        up = self.cycle_length * (1.0 - self.annealing_cycles) / 2.0
        pos = iteration % self.cycle_length
        anneal_start = 2 * up
        if pos < up:
            return self.initial_value + (
                self.max_value - self.initial_value) * (pos / up)
        if pos < anneal_start:
            return self.max_value - (
                self.max_value - self.initial_value) * ((pos - up) / up)
        return self.initial_value * (1.0 - (pos - anneal_start)
                                     / max(self.cycle_length - anneal_start,
                                           1.0))
