"""MDP SPI + built-in environments.

Counterpart of ``deeplearning4j_tpu/rl/mdp.py`` (rl4j's
``org.deeplearning4j.rl4j.mdp.MDP``: reset/step/isDone and the action and
observation spaces). The classic control dynamics ship inline, built in
process: CartPole (the standard published physics) and a deterministic 1-D
gridworld for fast convergence tests. Plain numpy on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class DiscreteSpace:
    def __init__(self, n: int):
        self.n = n

    def random_action(self, rng) -> int:
        return int(rng.integers(0, self.n))


class ObservationSpace:
    def __init__(self, shape: Tuple[int, ...]):
        self.shape = shape


class MDP:
    """reset() -> obs; step(action) -> (obs, reward, done, info)."""

    action_space: DiscreteSpace
    observation_space: ObservationSpace

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int):
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CartPole(MDP):
    """Classic cart-pole balancing (the rl4j quick-start environment —
    standard equations of motion, episode ends at |x|>2.4 or |θ|>12°)."""

    def __init__(self, seed: int = 0, max_steps: int = 500):
        self.rng = np.random.default_rng(seed)
        self.max_steps = max_steps
        self.action_space = DiscreteSpace(2)
        self.observation_space = ObservationSpace((4,))
        self._state = None
        self._steps = 0
        self._done = True

    def reset(self) -> np.ndarray:
        self._state = self.rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        self._done = False
        return self._state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = 10.0 if action == 1 else -10.0
        g, mc, mp, l, tau = 9.8, 1.0, 0.1, 0.5, 0.02
        total = mc + mp
        pml = mp * l
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        temp = (force + pml * theta_dot ** 2 * sin_t) / total
        theta_acc = (g * sin_t - cos_t * temp) / \
            (l * (4.0 / 3.0 - mp * cos_t ** 2 / total))
        x_acc = temp - pml * theta_acc * cos_t / total
        x += tau * x_dot
        x_dot += tau * x_acc
        theta += tau * theta_dot
        theta_dot += tau * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        self._done = bool(abs(x) > 2.4 or abs(theta) > 12 * np.pi / 180
                          or self._steps >= self.max_steps)
        return self._state.astype(np.float32), 1.0, self._done, {}

    def is_done(self) -> bool:
        return self._done


class GridWorld(MDP):
    """Deterministic 1-D corridor: start left, goal right; reward 1 at the
    goal, small step penalty — converges in a few hundred DQN steps (the
    fast CI environment)."""

    def __init__(self, size: int = 8, max_steps: int = 50):
        self.size = size
        self.max_steps = max_steps
        self.action_space = DiscreteSpace(2)      # 0=left, 1=right
        self.observation_space = ObservationSpace((size,))
        self._pos = 0
        self._steps = 0
        self._done = True

    def _obs(self) -> np.ndarray:
        o = np.zeros(self.size, np.float32)
        o[self._pos] = 1.0
        return o

    def reset(self) -> np.ndarray:
        self._pos = 0
        self._steps = 0
        self._done = False
        return self._obs()

    def step(self, action: int):
        self._pos = max(0, min(self.size - 1,
                               self._pos + (1 if action == 1 else -1)))
        self._steps += 1
        at_goal = self._pos == self.size - 1
        self._done = bool(at_goal or self._steps >= self.max_steps)
        reward = 1.0 if at_goal else -0.01
        return self._obs(), reward, self._done, {}

    def is_done(self) -> bool:
        return self._done
