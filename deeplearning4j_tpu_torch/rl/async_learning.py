"""Asynchronous RL family: A3C and async n-step Q-learning.

Counterpart of ``deeplearning4j_tpu/rl/async_learning.py`` (rl4j's
``async`` package: ``A3CDiscreteDense``, ``AsyncNStepQLearningDiscreteDense``,
``AsyncGlobal``/``AsyncThread``). N worker threads with their own
environments collect t_max-step fragments and apply updates to one shared
network; workers re-read the shared parameters at each fragment boundary.
Each update is one ``SameDiff.fit`` step, serialized by a lock: the
workers' parallelism overlaps the environment stepping, the host-bound
part.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..common import nan_panic
from .dqn import to_numpy
from .mdp import MDP
from .networks import ActorCriticNetwork, SameDiffQNetwork


@dataclass
class A3CConfiguration:
    """Mirrors rl4j A3CDiscrete.A3CConfiguration."""

    seed: int = 123
    max_epoch_step: int = 200
    max_step: int = 8_000           # total env steps across all workers
    num_threads: int = 2
    nstep: int = 8                  # t_max fragment length
    gamma: float = 0.99
    reward_factor: float = 1.0


class ACPolicy:
    """Stochastic policy over an actor-critic net (reference: ACPolicy —
    samples from π; ``greedy=True`` plays argmax)."""

    def __init__(self, network: ActorCriticNetwork,
                 rng: Optional[np.random.Generator] = None,
                 greedy: bool = False):
        self.network = network
        self.rng = rng or np.random.default_rng(0)
        self.greedy = greedy

    def next_action(self, obs: np.ndarray) -> int:
        probs = self.network.action_probs(np.asarray(obs, np.float32))
        if self.greedy:
            return int(np.argmax(probs))
        return int(self.rng.choice(probs.size, p=probs))

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = mdp.step(self.next_action(obs))
            total += r
            if done:
                break
        return total


class _AsyncBase:
    """Shared worker/step accounting for the async learners."""

    def __init__(self, conf, mdp_factory):
        self.conf = conf
        self.mdp_factory = mdp_factory
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self.step_count = 0
        self.episode_rewards: List[float] = []
        #: the loss of every update, in the order the lock took them
        self.losses: List[float] = []

    def _take_steps(self, n: int) -> bool:
        with self._step_lock:
            if self.step_count >= self.conf.max_step:
                return False
            self.step_count += n
            return True

    def _record_episode(self, r: float) -> None:
        with self._step_lock:
            self.episode_rewards.append(r)

    def train(self):
        errors: List[BaseException] = []

        def run(tid):
            try:
                with nan_panic.scope():
                    self._worker(tid)
            except BaseException as e:   # surface on the caller, not a
                errors.append(e)         # silently-dead daemon thread

        threads = [threading.Thread(target=run, args=(t,), daemon=True)
                   for t in range(self.conf.num_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return self.episode_rewards


class A3CDiscreteDense(_AsyncBase):
    """rl4j A3CDiscreteDense: dense observations, discrete actions.

    ``mdp_factory()`` must return a fresh MDP per worker."""

    def __init__(self, mdp_factory, network: ActorCriticNetwork,
                 config: A3CConfiguration):
        super().__init__(config, mdp_factory)
        self.net = network

    def _worker(self, tid: int) -> None:
        c = self.conf
        rng = np.random.default_rng(c.seed + tid)
        mdp = self.mdp_factory()
        policy = ACPolicy(self.net, rng)
        nA = mdp.action_space.n
        obs = mdp.reset()
        ep_reward, ep_steps = 0.0, 0
        while True:
            frag_obs, frag_act, frag_rew = [], [], []
            done = False
            for _ in range(c.nstep):
                a = policy.next_action(obs)
                nxt, r, done, _ = mdp.step(a)
                frag_obs.append(obs)
                frag_act.append(a)
                frag_rew.append(r * c.reward_factor)
                obs = nxt
                ep_reward += r
                ep_steps += 1
                if done or ep_steps >= c.max_epoch_step:
                    break
            if not self._take_steps(len(frag_obs)):
                return
            # n-step returns, bootstrapped with V(s_T) when not terminal
            if done or ep_steps >= c.max_epoch_step:
                boot = 0.0
            else:
                _, v = self.net.policy_and_value(
                    np.asarray(obs, np.float32)[None])
                boot = float(v[0])
            R = boot
            returns = np.zeros(len(frag_rew), np.float32)
            for i in reversed(range(len(frag_rew))):
                R = frag_rew[i] + c.gamma * R
                returns[i] = R
            ob = np.asarray(frag_obs, np.float32)
            _, values = self.net.policy_and_value(ob)
            adv = returns - values
            onehot = np.eye(nA, dtype=np.float32)[np.asarray(frag_act)]
            with self._lock:
                self.losses.append(
                    self.net.train_batch(ob, onehot, returns, adv))
            if done or ep_steps >= c.max_epoch_step:
                self._record_episode(ep_reward)
                obs = mdp.reset()
                ep_reward, ep_steps = 0.0, 0

    def get_policy(self) -> ACPolicy:
        return ACPolicy(self.net, greedy=True)


@dataclass
class AsyncQLConfiguration:
    """Mirrors rl4j AsyncNStepQLearning's AsyncQLConfiguration."""

    seed: int = 123
    max_epoch_step: int = 200
    max_step: int = 8_000
    num_threads: int = 2
    nstep: int = 5
    target_dqn_update_freq: int = 100   # in UPDATES, not env steps
    gamma: float = 0.99
    reward_factor: float = 1.0
    min_epsilon: float = 0.1
    epsilon_nb_step: int = 3000


class AsyncNStepQLearningDiscreteDense(_AsyncBase):
    """rl4j AsyncNStepQLearningDiscreteDense: worker threads, n-step
    targets from a shared target net, epsilon-greedy exploration."""

    def __init__(self, mdp_factory, network: SameDiffQNetwork,
                 config: AsyncQLConfiguration):
        super().__init__(config, mdp_factory)
        self.net = network
        self.target = network.clone()
        self._updates = 0

    def _epsilon(self, tid: int) -> float:
        c = self.conf
        frac = min(self.step_count / max(c.epsilon_nb_step, 1), 1.0)
        return 1.0 + (c.min_epsilon - 1.0) * frac

    def _worker(self, tid: int) -> None:
        from ..data.dataset import DataSet

        c = self.conf
        rng = np.random.default_rng(c.seed + tid)
        mdp = self.mdp_factory()
        nA = mdp.action_space.n
        obs = mdp.reset()
        ep_reward, ep_steps = 0.0, 0
        while True:
            frag_obs, frag_act, frag_rew = [], [], []
            done = False
            for _ in range(c.nstep):
                if rng.random() < self._epsilon(tid):
                    a = int(rng.integers(0, nA))
                else:
                    q = to_numpy(self.net.output(
                        np.asarray(obs, np.float32)[None]))[0]
                    a = int(np.argmax(q))
                nxt, r, done, _ = mdp.step(a)
                frag_obs.append(obs)
                frag_act.append(a)
                frag_rew.append(r * c.reward_factor)
                obs = nxt
                ep_reward += r
                ep_steps += 1
                if done or ep_steps >= c.max_epoch_step:
                    break
            if not self._take_steps(len(frag_obs)):
                return
            if done or ep_steps >= c.max_epoch_step:
                boot = 0.0
            else:
                qn = to_numpy(self.target.output(
                    np.asarray(obs, np.float32)[None]))[0]
                boot = float(qn.max())
            R = boot
            returns = np.zeros(len(frag_rew), np.float32)
            for i in reversed(range(len(frag_rew))):
                R = frag_rew[i] + c.gamma * R
                returns[i] = R
            ob = np.asarray(frag_obs, np.float32)
            with self._lock:
                y = np.array(to_numpy(self.net.output(ob)))  # writable
                y[np.arange(len(frag_act)), frag_act] = returns
                self.losses.append(
                    self.net.fit(DataSet(ob, y), epochs=1).final_loss())
                self._updates += 1
                if self._updates % c.target_dqn_update_freq == 0:
                    # a parameter copy, not clone(): a clone rebuilds the
                    # graph while every worker waits on this lock
                    self.target.copy_params_from(self.net)
            if done or ep_steps >= c.max_epoch_step:
                self._record_episode(ep_reward)
                obs = mdp.reset()
                ep_reward, ep_steps = 0.0, 0

    def get_policy(self):
        from .dqn import DQNPolicy

        return DQNPolicy(self.net)
