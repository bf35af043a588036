"""RL network factories on SameDiff graphs.

Counterpart of ``deeplearning4j_tpu/rl/networks.py`` (rl4j's
``DQNFactoryStdDense`` and ``ActorCriticFactorySeparateStdDense``): each
network is one port ``SameDiff`` graph, losses included, with the small
``output`` / ``fit`` / ``clone`` protocol the learners use. Outputs are
tensors on the graph's device (the card unless ``device`` names another).
The initial weights are drawn with numpy from ``seed``, as in the JAX
package, so both packages start from the same values.

``DuelingQNetwork`` adds the dueling decomposition: Q(s,a) = V(s) + A(s,a)
- mean_a A(s,a), which plugs into ``QLearningDiscreteDense`` unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..autodiff.samediff import SameDiff, TrainingConfig
from ..data.dataset import DataSet
from ..learning import Adam


def _mlp_trunk(sd: SameDiff, x, obs_dim: int, hidden: Sequence[int],
               rng: np.random.RandomState, prefix: str = "h"):
    h = x
    n_in = obs_dim
    for i, n_out in enumerate(hidden):
        w = sd.var(f"{prefix}{i}_w", init=(rng.randn(n_in, n_out)
                                           * np.sqrt(2.0 / n_in))
                   .astype(np.float32))
        b = sd.var(f"{prefix}{i}_b", shape=(n_out,), init="zeros")
        h = sd.math.relu((h @ w) + b)
        n_in = n_out
    return h, n_in


def _head(sd: SameDiff, h, n_in: int, n_out: int, name: str,
          rng: np.random.RandomState):
    w = sd.var(f"{name}_w", init=(rng.randn(n_in, n_out)
                                  * np.sqrt(1.0 / n_in)).astype(np.float32))
    b = sd.var(f"{name}_b", shape=(n_out,), init="zeros")
    return (h @ w) + b


class SameDiffQNetwork:
    """Q network with the learner protocol (output / fit / clone).

    ``dueling=True`` builds the V/A decomposition; the MSE-vs-setTarget
    training contract is identical either way."""

    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (64, 64), lr: float = 1e-3,
                 dueling: bool = False, seed: int = 0, device=None):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.lr = lr
        self.dueling = dueling
        self.seed = seed
        rng = np.random.RandomState(seed)
        sd = SameDiff.create(device)
        x = sd.placeholder("x", shape=(None, obs_dim))
        y = sd.placeholder("y", shape=(None, n_actions))
        h, n_in = _mlp_trunk(sd, x, obs_dim, hidden, rng)
        if dueling:
            v = _head(sd, h, n_in, 1, "value", rng)              # [B, 1]
            a = _head(sd, h, n_in, n_actions, "adv", rng)        # [B, A]
            a_mean = sd.math.reduce_mean(a, dims=(-1,), keep_dims=True)
            q = (v + (a - a_mean)).rename("q")
        else:
            q = _head(sd, h, n_in, n_actions, "q_head", rng).rename("q")
        sd.loss_ops.mean_sqerr_loss(q, y).rename("loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(TrainingConfig(updater=Adam(lr),
                                              loss_name="loss"))
        self.sd = sd

    def output(self, x):
        return self.sd.output({"x": np.asarray(x, np.float32)}, ["q"])["q"]

    def fit(self, ds: DataSet, epochs: int = 1):
        return self.sd.fit(ds, epochs=epochs)

    def clone(self) -> "SameDiffQNetwork":
        new = SameDiffQNetwork(self.obs_dim, self.n_actions, self.hidden,
                               self.lr, self.dueling, self.seed,
                               self.sd.device)
        new.copy_params_from(self)
        return new

    def copy_params_from(self, other: "SameDiffQNetwork") -> None:
        _copy_variables(other.sd, self.sd)


def _copy_variables(src: SameDiff, dst: SameDiff) -> None:
    """Copies of ``src``'s trainable values into ``dst`` (same graph)."""
    for n, v in src._vars.items():
        if v.vtype == "VARIABLE":
            dst._vars[n].value = v.value.detach().clone()


def DuelingQNetwork(obs_dim: int, n_actions: int,
                    hidden: Sequence[int] = (64, 64), lr: float = 1e-3,
                    seed: int = 0, device=None) -> SameDiffQNetwork:
    return SameDiffQNetwork(obs_dim, n_actions, hidden, lr, dueling=True,
                            seed=seed, device=device)


class ActorCriticNetwork:
    """Shared-trunk actor-critic (rl4j's
    ``ActorCriticFactoryCompGraphStdDense``): policy logits and V(s) heads,
    one combined update: the policy gradient weighted by the advantage, the
    value MSE and an entropy bonus."""

    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (64, 64), lr: float = 3e-3,
                 entropy_beta: float = 0.01, value_coeff: float = 0.5,
                 seed: int = 0, device=None):
        self.obs_dim = obs_dim
        self.n_actions = n_actions
        self.hidden = tuple(hidden)
        self.lr = lr
        self.entropy_beta = entropy_beta
        self.value_coeff = value_coeff
        self.seed = seed
        rng = np.random.RandomState(seed)
        sd = SameDiff.create(device)
        x = sd.placeholder("x", shape=(None, obs_dim))
        actions = sd.placeholder("actions", shape=(None, n_actions))
        returns = sd.placeholder("returns", shape=(None,))
        adv = sd.placeholder("advantage", shape=(None,))
        h, n_in = _mlp_trunk(sd, x, obs_dim, hidden, rng)
        logits = _head(sd, h, n_in, n_actions, "policy", rng) \
            .rename("logits")
        value = sd.math.squeeze(
            _head(sd, h, n_in, 1, "value", rng), axis=(-1,)).rename("value")
        logp = sd.math.log_softmax(logits, axis=-1)
        taken_logp = sd.math.reduce_sum(actions * logp, dims=(-1,))
        pg = sd.math.neg(sd.math.reduce_mean(taken_logp * adv))
        v_err = value - returns
        v_loss = sd.math.reduce_mean(v_err * v_err)
        entropy = sd.math.neg(sd.math.reduce_mean(
            sd.math.reduce_sum(sd.math.softmax(logits, axis=-1) * logp,
                               dims=(-1,))))
        (pg + v_loss * float(value_coeff)
         - entropy * float(entropy_beta)).rename("loss")
        sd.set_loss_variables("loss")
        sd.set_training_config(TrainingConfig(updater=Adam(lr),
                                              loss_name="loss"))
        self.sd = sd

    # -- inference --------------------------------------------------------
    def policy_and_value(self, x):
        out = self.sd.output({"x": np.asarray(x, np.float32)},
                             ["logits", "value"])
        return (out["logits"].detach().cpu().numpy(),
                out["value"].detach().cpu().numpy())

    def action_probs(self, obs: np.ndarray) -> np.ndarray:
        logits, _ = self.policy_and_value(obs[None].astype(np.float32))
        z = logits[0] - logits[0].max()
        e = np.exp(z)
        return e / e.sum()

    # -- update -----------------------------------------------------------
    def train_batch(self, obs, action_onehot, returns, advantage) -> float:
        hist = self.sd.fit({
            "x": np.asarray(obs, np.float32),
            "actions": np.asarray(action_onehot, np.float32),
            "returns": np.asarray(returns, np.float32),
            "advantage": np.asarray(advantage, np.float32),
        }, epochs=1)
        return hist.final_loss()

    def clone(self) -> "ActorCriticNetwork":
        new = ActorCriticNetwork(self.obs_dim, self.n_actions, self.hidden,
                                 self.lr, self.entropy_beta,
                                 self.value_coeff, self.seed,
                                 self.sd.device)
        _copy_variables(self.sd, new.sd)
        return new
