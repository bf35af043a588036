"""Reinforcement learning (rl4j), counterpart of ``deeplearning4j_tpu/rl``.

- ``mdp``             MDP SPI + CartPole / GridWorld environments
- ``dqn``             QLearningDiscreteDense, ExpReplay, EpsGreedy, DQNPolicy
- ``networks``        SameDiffQNetwork (+dueling), ActorCriticNetwork, on the
                      port's SameDiff
- ``async_learning``  A3CDiscreteDense, AsyncNStepQLearningDiscreteDense,
                      ACPolicy
- ``history``         HistoryProcessor (crop/rescale/skip/stack)
- ``population``      FleetDQNPopulation: M agents' Q-networks as ONE fleet
                      (``parallel/fleet.py``), per-member telemetry, early
                      stopping and NaN culls
"""

from .async_learning import (A3CConfiguration, A3CDiscreteDense, ACPolicy,
                             AsyncNStepQLearningDiscreteDense,
                             AsyncQLConfiguration)
from .dqn import (DQNPolicy, EpsGreedy, ExpReplay, QLConfiguration,
                  QLearningDiscreteDense)
from .history import HistoryProcessor, HistoryProcessorConfiguration
from .mdp import MDP, CartPole, DiscreteSpace, GridWorld, ObservationSpace
from .networks import (ActorCriticNetwork, DuelingQNetwork, SameDiffQNetwork)
from .population import FleetDQNPopulation

__all__ = ["A3CConfiguration", "A3CDiscreteDense", "ACPolicy",
           "ActorCriticNetwork", "AsyncNStepQLearningDiscreteDense",
           "AsyncQLConfiguration", "CartPole", "DQNPolicy", "DiscreteSpace",
           "DuelingQNetwork", "EpsGreedy", "ExpReplay",
           "FleetDQNPopulation", "GridWorld",
           "HistoryProcessor", "HistoryProcessorConfiguration", "MDP",
           "ObservationSpace", "QLConfiguration", "QLearningDiscreteDense",
           "SameDiffQNetwork"]
