"""Input type system + preprocessors.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``: CNN activations are
NCHW, feed-forward activations ``[batch, size]``, recurrent activations
``[batch, time, size]`` (the JAX package's layout, not DL4J's
``[batch, size, time]``); the graph builder inserts ``cnn_to_ff`` where a
CNN output feeds a dense layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional


class InputType:
    @staticmethod
    def feed_forward(size: int) -> "FFInput":
        return FFInput(size)

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "RNNInput":
        return RNNInput(size, timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "CNNInput":
        return CNNInput(channels, height, width)


@dataclass(frozen=True)
class FFInput(InputType):
    size: int


@dataclass(frozen=True)
class RNNInput(InputType):
    size: int
    timesteps: Optional[int] = None


@dataclass(frozen=True)
class CNNInput(InputType):
    channels: int
    height: int
    width: int


@dataclass
class Preprocessor:
    """Shape adapter inserted between layers (InputPreProcessor analog)."""

    name: str
    fn: Callable
    out_type: InputType

    def __call__(self, x):
        return self.fn(x)


def cnn_to_ff(t: CNNInput) -> Preprocessor:
    size = t.channels * t.height * t.width
    return Preprocessor("CnnToFeedForward",
                        lambda x: x.reshape(x.shape[0], -1), FFInput(size))
