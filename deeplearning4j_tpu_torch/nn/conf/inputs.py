"""Input type system + preprocessors.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``: CNN activations are
NCHW, feed-forward activations ``[batch, size]``, recurrent activations
``[batch, time, size]`` (the JAX package's layout, not DL4J's
``[batch, size, time]``), masks ``[batch, time]``. The builders insert the
adapters: ``cnn_to_ff`` where a CNN output feeds a dense layer (flattened
in NCHW order, ``C * H * W``, as ``inputs.py:94-97`` of the JAX package, so
a dense ``W`` after a convolution carries across unchanged),
``flat_to_cnn`` after a ``convolutional_flat`` input, ``rnn_to_ff``
where a sequence feeds a dense layer and ``cnn3d_to_ff`` where a volume
(``CNN3DInput``, NCDHW) feeds one.
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

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "CNNFlatInput":
        return CNNFlatInput(channels, height, width)

    @staticmethod
    def convolutional_3d(depth: int, height: int, width: int,
                         channels: int) -> "CNN3DInput":
        return CNN3DInput(channels, depth, height, width)


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


@dataclass(frozen=True)
class CNN3DInput(InputType):
    """Volumes ``[batch, C, D, H, W]`` (NCDHW)."""

    channels: int
    depth: int
    height: int
    width: int


@dataclass(frozen=True)
class CNNFlatInput(InputType):
    """Images given flat, ``[batch, C * H * W]`` (MNIST's 784 pixels)."""

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


def cnn3d_to_ff(t: CNN3DInput) -> Preprocessor:
    """NCDHW flattened to ``[batch, C * D * H * W]``."""
    size = t.channels * t.depth * t.height * t.width
    return Preprocessor("Cnn3DToFeedForward",
                        lambda x: x.reshape(x.shape[0], -1), FFInput(size))


def ff_to_cnn(t: FFInput, c: int, h: int, w: int) -> Preprocessor:
    return Preprocessor("FeedForwardToCnn",
                        lambda x: x.reshape(x.shape[0], c, h, w),
                        CNNInput(c, h, w))


def flat_to_cnn(t: CNNFlatInput) -> Preprocessor:
    c, h, w = t.channels, t.height, t.width
    return Preprocessor("CnnFlatToCnn",
                        lambda x: x.reshape(x.shape[0], c, h, w),
                        CNNInput(c, h, w))


def rnn_to_ff(t: RNNInput) -> Preprocessor:
    """``[B, T, F]`` to ``[B * T, F]`` (a dense layer at every step)."""
    return Preprocessor("RnnToFeedForward",
                        lambda x: x.reshape(-1, x.shape[-1]), FFInput(t.size))


def ff_to_rnn(t: FFInput, timesteps: int) -> Preprocessor:
    return Preprocessor("FeedForwardToRnn",
                        lambda x: x.reshape(-1, timesteps, x.shape[-1]),
                        RNNInput(t.size, timesteps))
