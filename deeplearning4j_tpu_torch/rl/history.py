"""HistoryProcessor: observation preprocessing + frame stacking.

Counterpart of ``deeplearning4j_tpu/rl/history.py`` (rl4j's
``util.HistoryProcessor`` and ``IHistoryProcessor.Configuration``): crop,
rescale, per-frame skip, and a ring of the last ``history_length`` frames
stacked as the network input. Plain numpy on the host (slicing crop,
nearest-neighbour rescale).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class HistoryProcessorConfiguration:
    """Mirrors IHistoryProcessor.Configuration."""

    history_length: int = 4
    rescaled_width: int = 0          # 0 = keep
    rescaled_height: int = 0
    crop_top: int = 0
    crop_bottom: int = 0
    crop_left: int = 0
    crop_right: int = 0
    skip_frame: int = 1              # record every k-th frame


class HistoryProcessor:
    def __init__(self, conf: Optional[HistoryProcessorConfiguration] = None):
        self.conf = conf or HistoryProcessorConfiguration()
        self._frames: deque = deque(maxlen=self.conf.history_length)
        self._calls = 0

    # -- per-frame transform ----------------------------------------------
    def preprocess(self, obs: np.ndarray) -> np.ndarray:
        c = self.conf
        out = np.asarray(obs, np.float32)
        if out.ndim >= 2 and (c.crop_top or c.crop_bottom or c.crop_left
                              or c.crop_right):
            h, w = out.shape[0], out.shape[1]
            out = out[c.crop_top:h - c.crop_bottom or h,
                      c.crop_left:w - c.crop_right or w]
        if out.ndim >= 2 and c.rescaled_width and c.rescaled_height:
            h, w = out.shape[0], out.shape[1]
            ri = (np.arange(c.rescaled_height) * h
                  // c.rescaled_height)
            ci = (np.arange(c.rescaled_width) * w // c.rescaled_width)
            out = out[ri][:, ci]
        return out

    # -- ring -------------------------------------------------------------
    def record(self, obs: np.ndarray) -> bool:
        """Offer a raw frame; returns True when it was added (respecting
        skip_frame)."""
        take = (self._calls % max(self.conf.skip_frame, 1)) == 0
        self._calls += 1
        if take:
            self.add(obs)
        return take

    def add(self, obs: np.ndarray) -> None:
        self._frames.append(self.preprocess(obs))

    def start_episode(self, obs: np.ndarray) -> None:
        """Reset the ring, filling all slots with the first frame (the
        reference pads the initial stack the same way)."""
        self._frames.clear()
        self._calls = 0
        f = self.preprocess(obs)
        for _ in range(self.conf.history_length):
            self._frames.append(f)

    def is_ready(self) -> bool:
        return len(self._frames) == self.conf.history_length

    def get_history(self) -> np.ndarray:
        """Stacked [history_length, *frame_shape] float32."""
        assert self.is_ready(), "history ring not yet full"
        return np.stack(list(self._frames)).astype(np.float32)

    def flat_history(self) -> np.ndarray:
        return self.get_history().reshape(-1)

    @property
    def shape(self) -> Tuple[int, ...]:
        assert self._frames, "no frames recorded"
        return (self.conf.history_length,) + tuple(self._frames[-1].shape)
