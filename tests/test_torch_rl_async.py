"""The port's asynchronous RL family, the SameDiff Q and actor-critic
networks and the HistoryProcessor, against the JAX package's
(``tests/test_rl_async.py``): the networks start from the same numpy draws,
so their outputs agree within 1e-5 and one update step within 1e-5; the
learners run two worker threads to their step budget with finite losses;
the history processor's frames equal the JAX package's."""

import numpy as np
import pytest

from deeplearning4j_tpu import rl as jrl
from deeplearning4j_tpu_torch import rl


def _gridworld_factory():
    return lambda: rl.GridWorld(size=6)


def _out(a):
    return rl.dqn.to_numpy(a) if hasattr(a, "detach") \
        else np.asarray(a.to_numpy())


class TestNetworks:
    @pytest.mark.parametrize("dueling", [False, True],
                             ids=["plain", "dueling"])
    def test_q_network_output_and_step_equal_jax(self, dueling):
        x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
        y = np.random.RandomState(1).randn(5, 3).astype(np.float32)
        nets = [pkg.SameDiffQNetwork(4, 3, hidden=(16,), lr=1e-2,
                                     dueling=dueling, seed=2, **kw)
                for pkg, kw in ((jrl, {}), (rl, {"device": "cpu"}))]
        np.testing.assert_allclose(_out(nets[1].output(x)),
                                   _out(nets[0].output(x)), rtol=1e-5,
                                   atol=1e-6)
        from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        nets[0].fit(JDataSet(x, y))
        nets[1].fit(DataSet(x, y))
        np.testing.assert_allclose(_out(nets[1].output(x)),
                                   _out(nets[0].output(x)), rtol=1e-5,
                                   atol=1e-6)

    def test_dueling_head_structure(self):
        net = rl.DuelingQNetwork(4, 3, hidden=(16,), seed=0, device="cpu")
        assert tuple(net.output(np.zeros((2, 4), np.float32)).shape) == (2, 3)
        names = set(net.sd._vars)
        assert "value_w" in names and "adv_w" in names

    def test_clone_copies_the_weights(self):
        net = rl.SameDiffQNetwork(4, 2, hidden=(8,), seed=3, device="cpu")
        x = np.ones((1, 4), np.float32)
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        net.fit(DataSet(x, np.zeros((1, 2), np.float32)))
        twin = net.clone()
        np.testing.assert_array_equal(_out(twin.output(x)),
                                      _out(net.output(x)))

    def test_actor_critic_equals_jax(self):
        x = np.random.RandomState(0).randn(6, 4).astype(np.float32)
        nets = [pkg.ActorCriticNetwork(4, 3, hidden=(8,), seed=1, **kw)
                for pkg, kw in ((jrl, {}), (rl, {"device": "cpu"}))]
        for a, b in zip(nets[1].policy_and_value(x),
                        nets[0].policy_and_value(x)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        onehot = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]]
        ret = np.linspace(0, 1, 6).astype(np.float32)
        adv = np.linspace(-1, 1, 6).astype(np.float32)
        losses = [n.train_batch(x, onehot, ret, adv) for n in nets]
        assert losses[1] == pytest.approx(losses[0], rel=1e-5)
        for a, b in zip(nets[1].policy_and_value(x),
                        nets[0].policy_and_value(x)):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


class TestA3C:
    def test_two_workers_train_concurrently(self):
        net = rl.ActorCriticNetwork(6, 2, hidden=(16,), lr=5e-3, seed=5,
                                    device="cpu")
        conf = rl.A3CConfiguration(seed=5, max_step=240, max_epoch_step=40,
                                   num_threads=2, nstep=8)
        a3c = rl.A3CDiscreteDense(_gridworld_factory(), net, conf)
        rewards = a3c.train()
        assert a3c.step_count >= 240
        assert len(rewards) >= 2
        assert a3c.losses and np.isfinite(a3c.losses).all()
        logits, value = net.policy_and_value(np.zeros((1, 6), np.float32))
        assert np.isfinite(logits).all() and np.isfinite(value).all()

    def test_ac_policy_samples_and_greedy(self):
        net = rl.ActorCriticNetwork(4, 3, hidden=(8,), seed=0, device="cpu")
        stochastic = rl.ACPolicy(net, np.random.default_rng(0))
        greedy = rl.ACPolicy(net, greedy=True)
        obs = np.zeros(4, np.float32)
        assert len({stochastic.next_action(obs) for _ in range(30)}) >= 2
        assert len({greedy.next_action(obs) for _ in range(5)}) == 1


class TestAsyncNStepQ:
    def test_two_workers_train_concurrently(self):
        net = rl.SameDiffQNetwork(6, 2, hidden=(16,), lr=5e-3, seed=4,
                                  device="cpu")
        conf = rl.AsyncQLConfiguration(seed=4, max_step=240,
                                       max_epoch_step=40, num_threads=2,
                                       nstep=5, target_dqn_update_freq=20)
        learner = rl.AsyncNStepQLearningDiscreteDense(_gridworld_factory(),
                                                      net, conf)
        rewards = learner.train()
        assert learner.step_count >= 240
        assert len(rewards) >= 2
        assert len(learner.losses) == learner._updates > 0
        assert np.isfinite(learner.losses).all()
        assert np.isfinite(_out(net.output(np.zeros((1, 6),
                                                    np.float32)))).all()
        assert isinstance(learner.get_policy(), rl.DQNPolicy)


class TestHistoryProcessor:
    def test_stacking_and_initial_fill(self):
        hp = rl.HistoryProcessor(rl.HistoryProcessorConfiguration(
            history_length=3))
        hp.start_episode(np.asarray([1.0, 2.0]))
        assert hp.is_ready()
        np.testing.assert_array_equal(hp.get_history(),
                                      np.tile([1.0, 2.0], (3, 1)))
        hp.add(np.asarray([3.0, 4.0]))
        h = hp.get_history()
        np.testing.assert_array_equal(h[-1], [3.0, 4.0])
        np.testing.assert_array_equal(h[0], [1.0, 2.0])
        assert hp.flat_history().shape == (6,)

    def test_skip_frame(self):
        hp = rl.HistoryProcessor(rl.HistoryProcessorConfiguration(
            history_length=2, skip_frame=3))
        taken = [hp.record(np.asarray([float(i)])) for i in range(7)]
        assert taken == [True, False, False, True, False, False, True]
        np.testing.assert_array_equal(hp.get_history(), [[3.0], [6.0]])

    def test_crop_and_rescale_equal_jax(self):
        kw = dict(history_length=2, crop_top=2, crop_bottom=2, crop_left=4,
                  crop_right=4, rescaled_width=4, rescaled_height=4,
                  skip_frame=2)
        frames = np.random.RandomState(3).rand(5, 20, 16).astype(np.float32)
        out = []
        for pkg in (jrl, rl):
            hp = pkg.HistoryProcessor(pkg.HistoryProcessorConfiguration(
                **kw))
            hp.start_episode(frames[0])
            for f in frames[1:]:
                hp.record(f)
            out.append(hp.get_history())
        assert out[1].shape == (2, 4, 4)
        np.testing.assert_array_equal(out[1], out[0])
        assert out[1][0, 0, 0] == frames[1][2, 4]
