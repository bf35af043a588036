"""Online elastic resize of the port's ParallelWrapper against the JAX
package's contract (``tests/test_elastic.py``): the device pool (survivors
first, lost slots left out), the encoded accumulator's residual carry
through a resize (compared with the JAX ``resize_state`` on the same
arrays), and bitwise parity of a shrunk or grown continuation with a fresh
run handed the same state, cursor and random stream. A lost device is
simulated by a listener that stops the fit at a step boundary, where the
JAX tests inject ``device/loss``; the supervisor's drills
(``TestSupervisorElastic``) inject ``device/loss`` as the JAX tests do."""

import json
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import (
    EncodedGradientsAccumulator as JEncoded)
from deeplearning4j_tpu_torch.common import faultinject
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresIterationListener)
from deeplearning4j_tpu_torch.parallel import (EncodedGradientsAccumulator,
                                               ParallelWrapper,
                                               ReduceScatterAccumulator,
                                               TrainingSupervisor,
                                               classify_failure,
                                               device_pool, elastic_pool,
                                               make_mesh)
from deeplearning4j_tpu_torch.parallel.distributed import (CLASS_DEVICE,
                                                           DEFAULT_POLICIES)
from torch_parity import mln_twins, modules


@pytest.fixture(autouse=True)
def _clean():
    OpProfiler.get().reset()
    yield


def small_model(sgd=False, seed=5):
    def conf(which):
        m = modules(which)
        u = m.Sgd(learning_rate=0.1) if sgd else m.Adam(learning_rate=0.05)
        return (m.NeuralNetConfiguration.builder().seed(seed).updater(u)
                .activation("tanh").list()
                .layer(m.L.DenseLayer(n_out=9))
                .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                       activation="softmax"))
                .set_input_type(m.InputType.feed_forward(4)).build())

    return mln_twins(conf("jax"), conf("torch"))[1]


def make_iter(n=96, batch=24):
    rng = np.random.RandomState(7)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return NDArrayDataSetIterator(x, y, batch_size=batch, shuffle=True,
                                  seed=3)


def build_wrapper(model, workers=4, acc="zero1"):
    b = ParallelWrapper.Builder(model).workers(workers)
    if acc == "zero1":
        b.gradients_accumulator(ReduceScatterAccumulator())
    elif acc is not None:
        b.gradients_accumulator(acc)
    return b.build()


class _Lost(RuntimeError):
    pass


class LoseAt:
    """Stops the fit after ``at`` steps, as a lost device would."""

    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            raise _Lost(iteration)


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def host_state(model):
    return _host((model._params, model._states, model._updater_state,
                  getattr(model, "_acc_state", None) or None))


def install_state(model, state):
    params, states, upd, acc = state
    model._params, model._states = _host(params), _host(states)
    model._updater_state, model._acc_state = _host(upd), _host(acc)


def bitwise(a, b) -> bool:
    return leaf_paths(a) == leaf_paths(b) and all(
        torch.equal(get_path(a, p), get_path(b, p)) for p in leaf_paths(a))


def run_to_loss(pw, step, epochs=3, **fit_kwargs):
    """Fit until the stop; return the cursor and the generator state at
    the boundary."""
    pw.set_listeners(LoseAt(step))
    with pytest.raises(_Lost):
        pw.fit(make_iter(), epochs=epochs, **fit_kwargs)
    pw.set_listeners()
    m = pw.model
    return ((m._epoch - m._fit_epoch0, m._steps_in_epoch),
            m.generator().get_state())


def fresh_run(snap, it, ep, gen_state, cursor, workers, acc="zero1",
              sgd=False, epochs=3, **fit_kwargs):
    m = small_model(sgd=sgd)
    install_state(m, snap)
    m._iteration, m._epoch = it, ep
    m.generator().set_state(gen_state)
    pw = build_wrapper(m, workers=workers, acc=acc)
    pw.fit(make_iter(), epochs=epochs, resume_cursor=cursor, **fit_kwargs)
    return m


# ---------------------------------------------------------------------------
# the device pool
# ---------------------------------------------------------------------------

class TestElasticPlumbing:
    def test_elastic_pool_orders_survivors_first(self):
        devs = device_pool("cpu")
        mesh = make_mesh(data=3, model=1, devices=devs[:3])
        pool = elastic_pool(mesh)
        assert pool[:3] == list(mesh.devices.flat)
        assert set(pool) == set(devs)

    def test_elastic_pool_excludes_lost(self):
        devs = device_pool("cpu")
        mesh = make_mesh(data=4, model=1, devices=devs[:4])
        pool = elastic_pool(mesh, exclude=[devs[1]])
        assert devs[1] not in pool
        assert pool[:3] == [devs[0], devs[2], devs[3]]


# ---------------------------------------------------------------------------
# the encoded accumulator's residual carry (host layout, numpy)
# ---------------------------------------------------------------------------

class TestResidualResize:
    def _state(self, n, shapes=((5,), (3, 2))):
        rng = np.random.RandomState(0)
        return {"residual": [rng.randn(n, *s).astype(np.float32)
                             for s in shapes],
                "threshold": np.float32(1e-3), "steps": np.int32(7)}

    def _both(self, n_old, n_new, lost=()):
        st = self._state(n_old)
        out = EncodedGradientsAccumulator().resize_state(
            st, n_old, n_new, lost_replicas=list(lost))
        want = JEncoded().resize_state(self._state(n_old), n_old, n_new,
                                       lost_replicas=list(lost))
        for got, ref in zip(out["residual"], want["residual"]):
            np.testing.assert_array_equal(got, ref)
        return st, out

    def test_shrink_folds_lost_residual_mass(self):
        st, out = self._both(4, 3, lost=[1])
        for old, new in zip(st["residual"], out["residual"]):
            assert new.shape == (3,) + old.shape[1:]
            np.testing.assert_array_equal(new[0], old[0] + old[1])
            np.testing.assert_array_equal(new[1], old[2])
            np.testing.assert_array_equal(new[2], old[3])
            np.testing.assert_allclose(new.sum(axis=0), old.sum(axis=0),
                                       rtol=1e-6)
        assert out["threshold"] == st["threshold"]
        assert out["steps"] == st["steps"]

    def test_grow_adds_zero_rows(self):
        st, out = self._both(3, 4)
        for old, new in zip(st["residual"], out["residual"]):
            np.testing.assert_array_equal(new[:3], old)
            assert not new[3].any()

    def test_shrink_without_loss_list_folds_tail(self):
        st, out = self._both(4, 3)
        for old, new in zip(st["residual"], out["residual"]):
            np.testing.assert_array_equal(new[0], old[0] + old[3])
            np.testing.assert_allclose(new.sum(axis=0), old.sum(axis=0),
                                       rtol=1e-6)

    def test_non_residual_state_passthrough(self):
        acc = EncodedGradientsAccumulator()
        assert acc.resize_state({"foo": 1}, 4, 3) == {"foo": 1}
        assert acc.resize_state(None, 4, 3) is None

    def test_stateless_accumulator_passthrough(self):
        acc = ReduceScatterAccumulator()
        st = {"anything": np.zeros(3)}
        assert acc.resize_state(st, 4, 2) is st


# ---------------------------------------------------------------------------
# resize mechanics and bitwise parity
# ---------------------------------------------------------------------------

class TestResizeParity:
    def test_resize_same_count_is_noop(self):
        pw = build_wrapper(small_model(), workers=3)
        pw.fit(make_iter(), epochs=1)
        assert pw.resize(3) == []
        assert OpProfiler.get().counter_value("elastic/resizes") == 0

    def test_resize_validations(self):
        pw = build_wrapper(small_model(), workers=2)
        with pytest.raises(ValueError):
            pw.resize(0)
        with pytest.raises(ValueError):
            pw.resize(1, lost_replicas=[5])
        with pytest.raises(ValueError, match="needs 9 devices"):
            pw.resize(len(device_pool("cpu")) + 1)
        assert pw.workers_count == 2

    def test_shrink_midepoch_bitwise_parity_zero1(self):
        """4 workers, a loss mid epoch 2, resize to 3, continue: the same
        bits as a fresh 3-worker run from the same state."""
        m1 = small_model()
        pw = build_wrapper(m1, workers=4)
        cursor, gen = run_to_loss(pw, step=5)
        assert cursor == (1, 1)          # 4 steps an epoch
        snap = host_state(m1)
        it, ep = m1._iteration, m1._epoch
        removed = pw.resize(3, lost_replicas=[1])
        assert len(removed) == 1
        stats = OpProfiler.get().elastic_stats()
        assert stats["resizes"] == 1 and stats["shrinks"] == 1
        assert stats["workers"] == 3 and stats["resize_count"] == 1
        pw.fit(make_iter(), epochs=3, resume_cursor=cursor)
        m2 = fresh_run(snap, it, ep, gen, cursor, workers=3)
        assert bitwise(m1._params, m2._params)
        assert bitwise(m1._updater_state, m2._updater_state)

    def test_shrink_parity_dense_accumulator(self):
        m1 = small_model(sgd=True)
        pw = build_wrapper(m1, workers=4, acc=None)
        cursor, gen = run_to_loss(pw, step=6)
        snap = host_state(m1)
        it, ep = m1._iteration, m1._epoch
        pw.resize(3, lost_replicas=[0])
        pw.fit(make_iter(), epochs=3, resume_cursor=cursor)
        m2 = fresh_run(snap, it, ep, gen, cursor, workers=3, acc=None,
                       sgd=True)
        assert bitwise(m1._params, m2._params)

    def test_growback_parity(self):
        m1 = small_model()
        pw = build_wrapper(m1, workers=3)
        pw.fit(make_iter(), epochs=1)
        snap = host_state(m1)
        it, ep = m1._iteration, m1._epoch
        gen = m1.generator().get_state()
        pw.resize(4)
        assert pw.workers_count == 4
        pw.fit(make_iter(), epochs=2, resume_cursor=(1, 0))
        m2 = fresh_run(snap, it, ep, gen, (1, 0), workers=4, epochs=2)
        assert bitwise(m1._params, m2._params)
        stats = OpProfiler.get().elastic_stats()
        assert stats["grows"] == 1 and stats["workers"] == 4

    def test_shrink_encoded_chunks_parity(self):
        """The encoded accumulator under steps_per_dispatch: the residuals
        ride the resize (folded, not reset) and the continuation equals a
        fresh 3-worker run handed the same folded residuals."""
        m1 = small_model()
        pw = build_wrapper(m1, workers=4, acc=EncodedGradientsAccumulator())
        cursor, gen = run_to_loss(pw, step=4, steps_per_dispatch=2)
        snap = host_state(m1)
        it, ep = m1._iteration, m1._epoch
        pw.resize(3, lost_replicas=[2])
        res = m1._acc_state["residual"]
        assert all(get_path(res, p).shape[0] == 3 for p in leaf_paths(res))
        pw.fit(make_iter(), epochs=3, resume_cursor=cursor,
               steps_per_dispatch=2)
        acc2 = EncodedGradientsAccumulator()
        params, states, upd, acc_st = snap
        acc_st = acc2.resize_state(acc_st, 4, 3, lost_replicas=[2])
        m2 = small_model()
        install_state(m2, (params, states, upd, acc_st))
        m2._iteration, m2._epoch = it, ep
        m2.generator().set_state(gen)
        pw2 = build_wrapper(m2, workers=3, acc=acc2)
        pw2.fit(make_iter(), epochs=3, resume_cursor=cursor,
                steps_per_dispatch=2)
        assert bitwise(m1._params, m2._params)
        assert bitwise(m1._acc_state["residual"], m2._acc_state["residual"])

    def test_checkpoint_records_live_workers_and_resumes(self, tmp_path):
        """A checkpoint taken after a shrink says workers=3 in its cursor
        and restores into a fresh 3-worker wrapper bit-exactly."""
        m1 = small_model()
        pw = build_wrapper(m1, workers=4)
        cursor, _ = run_to_loss(pw, step=5)
        pw.resize(3, lost_replicas=[1])
        cl = CheckpointListener(str(tmp_path))
        path = cl.save_now(m1, "post_shrink")
        cl.close()
        with zipfile.ZipFile(path) as zf:
            resume = json.loads(zf.read("resume.json"))
        assert resume["cursor"] == {"epochs_done": cursor[0],
                                    "steps_in_epoch": cursor[1],
                                    "workers": 3}
        pw.fit(make_iter(), epochs=3, resume_cursor=cursor)
        m2 = small_model()
        pw2 = build_wrapper(m2, workers=3)
        pw2.fit(make_iter(), epochs=3, resume_from=path)
        assert m2._ckpt_workers == 3
        assert bitwise(m1._params, m2._params)


# ---------------------------------------------------------------------------
# the supervisor's shrink-and-continue and grow-back (tests/test_elastic.py
# TestSupervisorElastic and the classification of a device loss)
# ---------------------------------------------------------------------------

def run_to_device_loss(pw, step, replica, epochs=3, **fit_kwargs):
    """Fit until the injected device loss fires; return the live cursor
    and the generator state at the boundary the fit unwound at."""
    faultinject.set_plan(faultinject.FaultPlan(
        [{"site": "device/loss", "index": step, "kind": "device_loss",
          "replica": replica}]))
    try:
        with pytest.raises(faultinject.DeviceLostError) as ei:
            pw.fit(make_iter(), epochs=epochs, **fit_kwargs)
    finally:
        faultinject.clear_plan()
    m = pw.model
    assert ei.value.replica == replica
    return ((m._epoch - m._fit_epoch0, m._steps_in_epoch),
            m.generator().get_state())


@pytest.fixture
def _no_plan():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()


@pytest.mark.usefixtures("_no_plan")
class TestSupervisorElastic:
    def test_device_loss_classifies_as_device_failure(self):
        exc = faultinject.DeviceLostError("gone", replica=1)
        assert classify_failure(exc) == CLASS_DEVICE
        assert DEFAULT_POLICIES[CLASS_DEVICE] == "shrink_and_continue"

    def test_supervised_shrink_drill_bitwise_parity(self, tmp_path):
        """device/loss kills 1 of 4 workers mid epoch: the supervised run
        completes with no restart, and its final parameters are bitwise a
        run resized by hand and a fresh 3-worker run from the same
        state."""
        m1 = small_model()
        pw = build_wrapper(m1, workers=4)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 5, "kind": "device_loss",
              "replica": 1}]))
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                 elastic_grow=False)
        res = sup.fit(make_iter, epochs=3)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 0
        assert [h["policy"] for h in res.history] == ["shrink_and_continue"]
        assert pw.workers_count == 3
        stats = OpProfiler.get().elastic_stats()
        assert stats["shrinks"] == 1 and stats["workers"] == 3
        assert OpProfiler.get().counter_value("supervisor/shrinks") == 1

        m2 = small_model()
        pw2 = build_wrapper(m2, workers=4)
        cursor, gen = run_to_device_loss(pw2, step=5, replica=1)
        snap = host_state(m2)
        it, ep = m2._iteration, m2._epoch
        pw2.resize(3, lost_replicas=[1])
        pw2.fit(make_iter(), epochs=3, resume_cursor=cursor)
        assert bitwise(m1._params, m2._params)
        m3 = fresh_run(snap, it, ep, gen, cursor, workers=3)
        assert bitwise(m1._params, m3._params)
        assert bitwise(m1._updater_state, m3._updater_state)

    def test_shrink_counts_as_progress_never_storms(self, tmp_path):
        pw = build_wrapper(small_model(), workers=4)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 3, "kind": "device_loss",
              "replica": 3}]))
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                 max_restarts=0, storm_threshold=1,
                                 elastic_grow=False)
        res = sup.fit(make_iter, epochs=2)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 0
        assert pw.workers_count == 3

    def test_fallback_to_restart_without_resize_target(self, tmp_path):
        model = small_model()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 3, "kind": "device_loss"}]))
        sup = TrainingSupervisor(model, checkpoint_dir=str(tmp_path),
                                 backoff_base_s=0.01)
        res = sup.fit(make_iter, epochs=2)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 1
        assert [h["policy"] for h in res.history] == ["restart"]

    def test_resize_never_reinstates_dead_device_from_cache(
            self, monkeypatch):
        pw = build_wrapper(small_model(), workers=4)
        pw.fit(make_iter(), epochs=1)
        dead = list(pw.mesh.devices.flat)[1]
        pw.resize(3, lost_replicas=[1])
        from deeplearning4j_tpu_torch.parallel import wrapper as wmod

        monkeypatch.setattr(wmod, "probe_device", lambda d: d is not dead)
        pw.resize(4)
        assert pw.workers_count == 4
        assert dead not in set(pw.mesh.devices.flat)   # a spare took over

    def test_grow_failure_limit_gives_up_and_stays_shrunk(
            self, tmp_path, monkeypatch):
        pw = build_wrapper(small_model(), workers=4)
        orig = pw.resize

        def flaky(n, **kw):
            if n > pw.workers_count and not kw.get("lost_replicas"):
                raise RuntimeError("placement OOM on returning device")
            return orig(n, **kw)

        monkeypatch.setattr(pw, "resize", flaky)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 2, "kind": "device_loss",
              "replica": 1},
             # steps slow enough that the probes land mid-run
             {"site": "pipeline/bind", "kind": "slow", "seconds": 0.02,
              "times": 1000}]))
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                 poll_s=0.01, grow_probe_base_s=0.0,
                                 grow_probe_max_s=0.01,
                                 grow_failure_limit=2)
        res = sup.fit(make_iter, epochs=6)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 0
        assert pw.workers_count == 3
        policies = [h["policy"] for h in res.history]
        assert policies.count("grow_failed") == 2
        assert "grow_and_continue" not in policies
        assert OpProfiler.get().counter_value("elastic/grow_abandoned") == 1

    def test_second_loss_disarms_pending_grow_and_merges(self, tmp_path):
        pw = build_wrapper(small_model(), workers=4)
        pw.fit(make_iter(), epochs=1)
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path))
        removed_a = sup._apply_shrink([2])
        assert sup._grow["target"] == 4
        sup._resize_request = 4            # the probe found A healthy
        removed_b = sup._apply_shrink([0])
        assert sup._resize_request is None
        assert sup._grow["target"] == 4
        assert set(map(id, sup._grow["devices"])) == \
            set(map(id, removed_a + removed_b))
        assert pw.workers_count == 2

    def test_supervised_growback_drill(self, tmp_path):
        """Shrink on a device loss, then the grow-back probe returns the
        device at the next dispatch boundary; every step still lands."""
        m = small_model()
        scores = CollectScoresIterationListener()
        pw = build_wrapper(m, workers=4)
        pw.set_listeners(scores)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 3, "kind": "device_loss",
              "replica": 2},
             {"site": "pipeline/bind", "kind": "slow", "seconds": 0.02,
              "times": 1000}]))
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                 elastic_grow=True, grow_probe_base_s=0.0,
                                 poll_s=0.01)
        res = sup.fit(make_iter, epochs=6)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 0
        assert pw.workers_count == 4
        classes = [h["class"] for h in res.history]
        assert classes[0] == "device_failure"
        assert "elastic_grow" in classes
        assert len(scores.scores) == 6 * 4      # no step lost or doubled
        stats = OpProfiler.get().elastic_stats()
        assert stats["shrinks"] == 1 and stats["grows"] >= 1
        assert stats["workers"] == 4

    def test_grow_probe_failure_backoff(self, tmp_path):
        pw = build_wrapper(small_model(), workers=4)
        faultinject.set_plan(faultinject.FaultPlan([
            {"site": "device/loss", "index": 2, "kind": "device_loss",
             "replica": 0},
            {"site": "elastic/probe", "kind": "dead_replica", "times": 2},
            # steps slow enough that the backed-off probes land mid-run
            {"site": "pipeline/bind", "kind": "slow", "seconds": 0.02,
             "times": 1000},
        ]))
        sup = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                 elastic_grow=True,
                                 grow_probe_base_s=0.05,
                                 grow_probe_max_s=0.1)
        res = sup.fit(make_iter, epochs=8)
        faultinject.clear_plan()
        assert res.status == "completed"
        assert pw.workers_count == 4
        prof = OpProfiler.get()
        assert prof.counter_value("elastic/probe_failures") == 2
        assert prof.counter_value("elastic/probes") >= 3
