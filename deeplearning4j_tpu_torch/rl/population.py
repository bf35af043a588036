"""RL population training over a fleet.

Counterpart of ``deeplearning4j_tpu/rl/population.py``. M DQN agents, each
with its own environment, replay buffer and exploration stream, whose
Q-networks are ONE :class:`~..parallel.fleet.FleetTrainer` population: the
TD update of all M agents is one fleet step (with ``fused_update``, one
member-batched ``fused_update`` launch per bucket), action selection and
the TD targets evaluate all M members through ``FleetTrainer.output``
(live, or a frozen target snapshot), and the per-member telemetry drives
early stopping and NaN culls of diverged members without touching the
others. Environment stepping and replay stay on the host, per agent.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..parallel.fleet import FleetTrainer
from .dqn import EpsGreedy, ExpReplay, QLConfiguration, to_numpy
from .mdp import MDP


class FleetDQNPopulation:
    """M independent DQN agents over one fleet-trained Q-network stack.

    ``mdp_factory(i)`` builds agent i's environment; ``base_net`` is the
    shared Q-network architecture (an init()-ed MultiLayerNetwork with an
    identity-activation MSE head, exactly as ``QLearningDiscreteDense``
    takes); ``grid`` optionally sweeps per-member hyperparameters (lr /
    l2 / dropout) so a population IS a hyperparameter search. Listeners
    (``NanSentinelListener("cull")``, :class:`FleetEarlyStop`, sinks)
    attach straight onto the underlying fleet.
    """

    def __init__(self, mdp_factory: Callable[[int], MDP], base_net,
                 config: QLConfiguration, n_members: int,
                 grid=None, listeners=()):
        self.conf = config
        if grid is not None:
            self.fleet = FleetTrainer.from_sweep(base_net, grid,
                                                 seed=config.seed)
            if self.fleet.n_members != n_members:
                raise ValueError(
                    f"grid implies {self.fleet.n_members} members, "
                    f"n_members says {n_members}")
        else:
            self.fleet = FleetTrainer(base_net, n_members,
                                      seed=config.seed)
        if listeners:
            self.fleet.set_listeners(*listeners)
        M = self.fleet.n_members
        self.envs = [mdp_factory(i) for i in range(M)]
        obs_dim = int(np.prod(self.envs[0].observation_space.shape))
        self.n_actions = self.envs[0].action_space.n
        self.replays = [ExpReplay(config.exp_rep_max_size, obs_dim,
                                  seed=config.seed + i) for i in range(M)]
        self._eps = [EpsGreedy(config,
                               np.random.default_rng(config.seed + i))
                     for i in range(M)]
        # per-member frozen target stack, synced every
        # target_dqn_update_freq steps (reference QLearning.setTarget)
        self._target = self.fleet.stacked_state()
        self.episode_rewards: List[List[float]] = [[] for _ in range(M)]
        self.step_count = 0
        #: fleet steps taken (one TD update of every member each)
        self.learn_steps = 0

    # -- stacked Q evaluation ---------------------------------------------
    def _q_all(self, obs: np.ndarray, target: bool = False) -> np.ndarray:
        """``[M, B, obs]`` observations → ``[M, B, A]`` Q values of all M
        members (live or frozen-target parameters)."""
        params = self._target if target else None
        return to_numpy(self.fleet.output(obs, params=params))

    # -- one synchronized population step ---------------------------------
    def td_targets(self, obs, action, reward, nxt, done) -> np.ndarray:
        """The regression targets ``[M, B, A]`` of one replay batch per
        member (``[M, B, ...]`` columns): the current Q with the taken
        action's entry set to its (double-DQN, clamped) TD target."""
        c = self.conf
        M = self.fleet.n_members
        q_cur = self._q_all(obs)
        q_next_t = self._q_all(nxt, target=True)
        if c.double_dqn:
            best = np.argmax(self._q_all(nxt), axis=2)
        else:
            best = np.argmax(q_next_t, axis=2)
        rows = np.arange(obs.shape[1])
        next_val = np.stack([q_next_t[m, rows, best[m]] for m in range(M)])
        td = reward * c.reward_factor + c.gamma * next_val * (1 - done)
        if c.error_clamp > 0:
            cur = np.stack([q_cur[m, rows, action[m]] for m in range(M)])
            td = cur + np.clip(td - cur, -c.error_clamp, c.error_clamp)
        y = q_cur.copy()
        for m in range(M):
            y[m, rows, action[m]] = td[m]
        return y

    def _learn(self) -> None:
        c = self.conf
        cols = [r.sample(c.batch_size) for r in self.replays]
        obs, action, reward, nxt, done = (np.stack([col[i] for col in cols])
                                          for i in range(5))
        y = self.td_targets(obs, action, reward, nxt, done)
        # non-taken actions keep their current Q, so zero gradient: rl4j's
        # setTarget construction, all M agents in one step
        self.fleet.step(obs.astype(np.float32), y.astype(np.float32),
                        per_member=True)
        self.learn_steps += 1

    def train(self, max_steps: Optional[int] = None) -> List[List[float]]:
        """Synchronized population loop: all M envs step together (a
        culled member's env keeps playing its frozen policy — its
        learning is what stopped). Returns per-member episode rewards."""
        c = self.conf
        M = self.fleet.n_members
        limit = max_steps if max_steps is not None else c.max_step
        obs = [env.reset() for env in self.envs]
        ep_reward = [0.0] * M
        ep_len = [0] * M
        while self.step_count < limit:
            stacked = np.stack(obs).astype(np.float32)[:, None, :]
            q = self._q_all(stacked)[:, 0, :]
            for m in range(M):
                a = self._eps[m].next_action(q[m], self.step_count,
                                             self.n_actions)
                nxt, r, done, _ = self.envs[m].step(a)
                self.replays[m].store(obs[m], a, r, nxt, done)
                ep_reward[m] += r
                ep_len[m] += 1
                if done or ep_len[m] >= c.max_epoch_step:
                    self.episode_rewards[m].append(ep_reward[m])
                    ep_reward[m] = 0.0
                    ep_len[m] = 0
                    obs[m] = self.envs[m].reset()
                else:
                    obs[m] = nxt
            self.step_count += 1
            if self.step_count >= c.update_start and \
                    all(len(r) >= c.batch_size for r in self.replays):
                self._learn()
            if self.step_count % c.target_dqn_update_freq == 0:
                self._target = self.fleet.stacked_state()
        self.fleet.drain()
        return self.episode_rewards

    # -- winners -----------------------------------------------------------
    def best_member(self) -> int:
        """The alive member with the lowest last-drained TD loss (needs a
        telemetry listener)."""
        return self.fleet.best_member()

    def policy_of(self, member: int):
        """Greedy play policy of one member, exported as a solo network
        (servable through ``ServingEngine.publish_checkpoint`` like any
        model)."""
        from .dqn import DQNPolicy

        return DQNPolicy(self.fleet.export_member(member))
