"""The port's RL package (``deeplearning4j_tpu_torch/rl``): environments,
replay, the epsilon schedule and DQN against the JAX package's
(``tests/test_rl.py``), and the fleet population (``FleetDQNPopulation``,
``tests/test_fleet.py``'s population hook): its TD targets equal the JAX
population's on one fixed replay batch from the same stacked members
(within 1e-5), and a population trains as one fleet."""

import numpy as np
import pytest

import jax

from deeplearning4j_tpu import rl as jrl
from deeplearning4j_tpu_torch import rl
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.optimize import NanSentinelListener
from deeplearning4j_tpu_torch.util.convert import fleet_state_from_numpy
from torch_parity import modules, numpy_tree


def qnet_conf(which, obs_dim=4, n_actions=2, hidden=16, seed=3, lr=5e-3,
              fused=False):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(seed)
         .updater(m.Adam(learning_rate=lr)).activation("relu")
         .weight_init("xavier"))
    if fused:
        b = b.fused_update()
    return (b.list()
            .layer(m.L.DenseLayer(n_out=hidden))
            .layer(m.L.OutputLayer(n_out=n_actions, loss="mse",
                                   activation="identity"))
            .set_input_type(m.InputType.feed_forward(obs_dim)).build())


def qnet(which="torch", **kw):
    m = modules(which)
    net = m.MultiLayerNetwork(qnet_conf(which, **kw))
    return net.init() if which == "jax" else net.init(device="cpu")


class TestEnvironments:
    def test_cartpole_trajectory_equals_jax(self):
        rng = np.random.default_rng(4)
        actions = rng.integers(0, 2, 300)
        runs = []
        for pkg in (jrl, rl):
            env = pkg.CartPole(seed=3, max_steps=200)
            obs = [env.reset()]
            for a in actions:
                o, r, done, _ = env.step(int(a))
                obs.append(o)
                if done:
                    obs.append(env.reset())
            runs.append(np.stack(obs))
        np.testing.assert_array_equal(runs[0], runs[1])

    def test_cartpole_physics_and_termination(self):
        env = rl.CartPole(seed=0)
        assert env.reset().shape == (4,)
        steps, done = 0, False
        while not done and steps < 600:
            _, r, done, _ = env.step(0)
            assert r == 1.0
            steps += 1
        assert done and steps < 200

    def test_gridworld_optimal_path(self):
        env = rl.GridWorld(size=5)
        assert env.reset().argmax() == 0
        total = 0.0
        for _ in range(4):
            obs, r, done, _ = env.step(1)
            total += r
        assert done and obs.argmax() == 4
        assert total == pytest.approx(1.0 - 3 * 0.01)

    def test_replay_ring_buffer_samples_as_jax(self):
        out = []
        for pkg in (jrl, rl):
            rep = pkg.ExpReplay(max_size=4, obs_dim=2, seed=5)
            for i in range(6):
                rep.store(np.full(2, i), i % 2, float(i), np.full(2, i + 1),
                          False)
            assert len(rep) == 4
            out.append(rep.sample(8))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)
        assert out[1][2].min() >= 2.0

    def test_epsilon_linear_decay(self):
        conf = rl.QLConfiguration(min_epsilon=0.1, epsilon_nb_step=100)
        eps = rl.EpsGreedy(conf, np.random.default_rng(0))
        jeps = jrl.EpsGreedy(jrl.QLConfiguration(min_epsilon=0.1,
                                                 epsilon_nb_step=100),
                             np.random.default_rng(0))
        for s in (0, 50, 100, 1000):
            assert eps.epsilon(s) == jeps.epsilon(s)
        assert eps.epsilon(50) == pytest.approx(0.55)


class TestDQN:
    def test_dense_q_learning_counts_and_stays_finite(self):
        env = rl.GridWorld(size=5)
        net = qnet(obs_dim=5, fused=True)
        conf = rl.QLConfiguration(seed=3, max_step=150, max_epoch_step=30,
                                  batch_size=8, update_start=40,
                                  target_dqn_update_freq=30)
        ql = rl.QLearningDiscreteDense(env, net, conf)
        rewards = ql.train()
        assert ql.step_count == 150
        assert ql.learn_steps == 150 - 40 + 1
        assert len(rewards) >= 5
        assert np.isfinite(net.params().numpy()).all()
        q = rl.dqn.to_numpy(net.output(np.zeros((1, 5), np.float32)))
        assert q.shape == (1, 2) and np.isfinite(q).all()

    def test_td_update_equals_jax_from_the_same_network(self):
        """One QLearningDiscreteDense TD batch from the same network and
        replay in both packages: the fitted parameters within 1e-5."""
        from torch_parity import mln_twins

        jn, tn = mln_twins(qnet_conf("jax"), qnet_conf("torch"))
        for pkg, net in ((jrl, jn), (rl, tn)):
            conf = pkg.QLConfiguration(seed=3, batch_size=8)
            ql = pkg.QLearningDiscreteDense(pkg.CartPole(seed=1), net, conf)
            env = pkg.CartPole(seed=2)
            obs = env.reset()
            for i in range(20):
                nxt, r, done, _ = env.step(i % 2)
                ql.replay.store(obs, i % 2, r, nxt, done)
                obs = env.reset() if done else nxt
            ql._learn_batch()
        np.testing.assert_allclose(tn.params().numpy(),
                                   np.asarray(jn.params().to_numpy()),
                                   rtol=1e-5, atol=1e-6)


class TestPopulation:
    def _pops(self):
        conf_kw = dict(seed=3, max_step=60, max_epoch_step=20, batch_size=8,
                       update_start=30, target_dqn_update_freq=25)
        jpop = jrl.FleetDQNPopulation(lambda i: jrl.CartPole(seed=i),
                                      qnet("jax"),
                                      jrl.QLConfiguration(**conf_kw),
                                      n_members=3)
        tpop = rl.FleetDQNPopulation(lambda i: rl.CartPole(seed=i),
                                     qnet(), rl.QLConfiguration(**conf_kw),
                                     n_members=3)
        params, states = jpop.fleet.stacked_state()
        fleet_state_from_numpy(
            tpop.fleet, [numpy_tree(d) for d in jax.device_get(params)],
            [numpy_tree(d) for d in jax.device_get(states)])
        tpop._target = tpop.fleet.stacked_state()
        return jpop, tpop

    def test_td_targets_equal_jax_on_a_fixed_replay_batch(self):
        jpop, tpop = self._pops()
        for pop in (jpop, tpop):
            r = np.random.RandomState(0)
            for rep in pop.replays:
                for i in range(16):
                    rep.store(r.randn(4), i % 2, r.rand(), r.randn(4),
                              i % 5 == 4)
        captured = {}
        jpop.fleet.step = lambda x, y, per_member=False: captured.update(
            x=np.asarray(x), y=np.asarray(y))
        jpop._learn()
        cols = [rep.sample(8) for rep in tpop.replays]
        obs, action, reward, nxt, done = (np.stack([c[i] for c in cols])
                                          for i in range(5))
        np.testing.assert_array_equal(obs, captured["x"])
        y = tpop.td_targets(obs, action, reward, nxt, done)
        np.testing.assert_allclose(y, captured["y"], rtol=1e-5, atol=1e-6)

    def test_population_trains_as_one_fleet(self):
        prof = OpProfiler.get()
        before = prof.counter_value("trace/fleet_step")
        conf = rl.QLConfiguration(seed=3, max_step=120, max_epoch_step=20,
                                  batch_size=8, update_start=30,
                                  target_dqn_update_freq=25,
                                  epsilon_nb_step=80, min_epsilon=0.1)
        pop = rl.FleetDQNPopulation(
            lambda i: rl.GridWorld(size=4), qnet(fused=True), conf,
            n_members=3, grid={"lr": [1e-3, 5e-3, 1e-2]},
            listeners=(NanSentinelListener("cull", check_every_n=10),))
        rewards = pop.train()
        assert all(len(r) > 0 for r in rewards)
        assert pop.learn_steps == 120 - 30 + 1
        assert prof.counter_value("trace/fleet_step") - before == 1
        assert prof.counter_value(
            "precision/fused_member_buckets_plain") == pop.learn_steps
        best = pop.best_member()
        assert pop.policy_of(best).play(rl.GridWorld(size=4),
                                        max_steps=12) > -1.0

    def test_grid_member_count_must_agree(self):
        with pytest.raises(ValueError, match="grid implies"):
            rl.FleetDQNPopulation(lambda i: rl.GridWorld(size=4), qnet(),
                                  rl.QLConfiguration(), n_members=2,
                                  grid={"lr": [1e-3, 2e-3, 3e-3]})
