"""Deep Q-learning (rl4j's QLearningDiscreteDense).

Counterpart of ``deeplearning4j_tpu/rl/dqn.py``: ``QLConfiguration`` (gamma,
epsilon schedule, replay size, batch, target-network period, double DQN),
the ``ExpReplay`` ring buffer, ``EpsGreedy`` over a Q network, and the
``train()`` episode loop.

The Q network is an ordinary ``MultiLayerNetwork`` with an MSE head (or a
``rl/networks.SameDiffQNetwork``), so the TD step is the network's own
``fit``: the TD target is written into the network's Q output for the taken
action (the others keep their current Q, so their gradient is zero), as
rl4j's ``QLearningDiscrete.setTarget`` does. A network with
``fused_update`` updates through one ``fused_update`` launch per TD step.
Environment stepping stays on the host."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..data.dataset import DataSet
from .mdp import MDP


def to_numpy(a) -> np.ndarray:
    """A network output (a tensor on any device, or an array) on the host."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class QLConfiguration:
    """Mirrors the reference QLearning.QLConfiguration fields."""

    seed: int = 123
    max_epoch_step: int = 200         # max steps per episode
    max_step: int = 10_000            # total training steps
    exp_rep_max_size: int = 10_000
    batch_size: int = 32
    target_dqn_update_freq: int = 100
    update_start: int = 100           # steps before learning starts
    reward_factor: float = 1.0
    gamma: float = 0.99
    error_clamp: float = 1.0          # TD error clip (0 = off)
    min_epsilon: float = 0.05
    epsilon_nb_step: int = 3000       # linear decay horizon
    double_dqn: bool = True


class ExpReplay:
    """Uniform ring-buffer replay (reference ExpReplay)."""

    def __init__(self, max_size: int, obs_dim: int, seed: int = 0):
        self.max_size = max_size
        self._obs = np.zeros((max_size, obs_dim), np.float32)
        self._next_obs = np.zeros((max_size, obs_dim), np.float32)
        self._action = np.zeros(max_size, np.int32)
        self._reward = np.zeros(max_size, np.float32)
        self._done = np.zeros(max_size, np.float32)
        self._n = 0
        self._i = 0
        self._rng = np.random.default_rng(seed)

    def store(self, obs, action, reward, next_obs, done) -> None:
        i = self._i
        self._obs[i] = obs
        self._action[i] = action
        self._reward[i] = reward
        self._next_obs[i] = next_obs
        self._done[i] = float(done)
        self._i = (i + 1) % self.max_size
        self._n = min(self._n + 1, self.max_size)

    def __len__(self) -> int:
        return self._n

    def sample(self, batch: int):
        idx = self._rng.integers(0, self._n, size=batch)
        return (self._obs[idx], self._action[idx], self._reward[idx],
                self._next_obs[idx], self._done[idx])


class EpsGreedy:
    """Linear-decay epsilon-greedy (reference policy.EpsGreedy)."""

    def __init__(self, conf: QLConfiguration, rng):
        self.conf = conf
        self.rng = rng

    def epsilon(self, step: int) -> float:
        frac = min(step / max(self.conf.epsilon_nb_step, 1), 1.0)
        return 1.0 + (self.conf.min_epsilon - 1.0) * frac

    def next_action(self, q_values: np.ndarray, step: int, n_actions: int
                    ) -> int:
        if self.rng.random() < self.epsilon(step):
            return int(self.rng.integers(0, n_actions))
        return int(np.argmax(q_values))


class DQNPolicy:
    """Greedy play policy over a trained Q network (reference DQNPolicy)."""

    def __init__(self, network):
        self.network = network

    def next_action(self, obs: np.ndarray) -> int:
        q = to_numpy(self.network.output(obs[None].astype(np.float32)))[0]
        return int(np.argmax(q))

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = mdp.step(self.next_action(obs))
            total += r
            if done:
                break
        return total


class QLearningDiscreteDense:
    """The rl4j entry point: dense-observation discrete-action Q-learning.

    ``network`` must be a MultiLayerNetwork whose output layer is an
    identity-activation MSE head with ``n_out == mdp.action_space.n`` (or a
    network with its ``output``/``fit``/``clone``). ``learn_steps`` counts
    the TD updates.
    """

    def __init__(self, mdp: MDP, network, config: QLConfiguration):
        self.mdp = mdp
        self.net = network
        self.conf = config
        self.rng = np.random.default_rng(config.seed)
        obs_dim = int(np.prod(mdp.observation_space.shape))
        self.replay = ExpReplay(config.exp_rep_max_size, obs_dim,
                                seed=config.seed)
        self.target = network.clone()
        self.policy_eps = EpsGreedy(config, self.rng)
        self.episode_rewards: List[float] = []
        self.step_count = 0
        self.learn_steps = 0

    # -- TD update ---------------------------------------------------------
    def _learn_batch(self) -> None:
        c = self.conf
        obs, action, reward, next_obs, done = \
            self.replay.sample(c.batch_size)
        q_cur = to_numpy(self.net.output(obs))
        q_next_t = to_numpy(self.target.output(next_obs))
        if c.double_dqn:
            # action selection by the online network, evaluation by the
            # target
            q_next_on = to_numpy(self.net.output(next_obs))
            best = np.argmax(q_next_on, axis=1)
            next_val = q_next_t[np.arange(len(best)), best]
        else:
            next_val = q_next_t.max(axis=1)
        td_target = reward * c.reward_factor + c.gamma * next_val * (1 - done)
        if c.error_clamp > 0:
            cur = q_cur[np.arange(len(action)), action]
            td_target = cur + np.clip(td_target - cur, -c.error_clamp,
                                      c.error_clamp)
        y = q_cur.copy()
        y[np.arange(len(action)), action] = td_target
        # non-taken actions keep their current Q -> zero gradient (the
        # reference's setTarget construction)
        self.net.fit(DataSet(obs, y), epochs=1)
        self.learn_steps += 1

    def _sync_target(self) -> None:
        self.target = self.net.clone()

    # -- training loop -----------------------------------------------------
    def train(self) -> List[float]:
        c = self.conf
        n_actions = self.mdp.action_space.n
        while self.step_count < c.max_step:
            obs = self.mdp.reset()
            ep_reward = 0.0
            for _ in range(c.max_epoch_step):
                q = to_numpy(self.net.output(
                    obs[None].astype(np.float32)))[0]
                action = self.policy_eps.next_action(q, self.step_count,
                                                     n_actions)
                next_obs, reward, done, _ = self.mdp.step(action)
                self.replay.store(obs, action, reward, next_obs, done)
                obs = next_obs
                ep_reward += reward
                self.step_count += 1
                if self.step_count >= c.update_start and \
                        len(self.replay) >= c.batch_size:
                    self._learn_batch()
                if self.step_count % c.target_dqn_update_freq == 0:
                    self._sync_target()
                if done or self.step_count >= c.max_step:
                    break
            self.episode_rewards.append(ep_reward)
        return self.episode_rewards

    def get_policy(self) -> DQNPolicy:
        return DQNPolicy(self.net)
