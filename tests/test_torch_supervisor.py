"""The port's TrainingSupervisor against the JAX package's contract
(``tests/test_supervisor.py``): the restart loop, the watchdog, the
preemption path, the incarnation fence, the disk budget, the master's
listener forwarding and replica resurrection.

Held to itself bitwise: every healed run's losses are exactly the
uninterrupted run's, and the caller's stream ends where a plain fit leaves
it. Held to the JAX package: ``classify_failure`` gives the same class for
every exception kind, and the healed run's loss sequence is the JAX
package's uninterrupted one on copied weights within the tolerance of
``tests/test_torch_multilayer.py`` (1e-5 relative; float32 in both).
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from deeplearning4j_tpu.common import faultinject as jfi
from deeplearning4j_tpu.common.integrity import (
    ReplicaCorruptionError as JCorrupt)
from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIterator
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JScores)
from deeplearning4j_tpu.parallel import distributed as jdist
from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.integrity import ReplicaCorruptionError
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.ndarray.rng import get_random, set_default_seed
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresIterationListener, TrainingListener)
from deeplearning4j_tpu_torch.parallel import (Preempted,
                                               RestartBudgetExceeded,
                                               RestartStorm,
                                               TrainingSupervisor,
                                               classify_failure)
from deeplearning4j_tpu_torch.parallel import distributed as tdist
from deeplearning4j_tpu_torch.parallel.distributed import (
    CLASS_DEVICE, CLASS_HANG, CLASS_NUMERIC, CLASS_PREEMPTION,
    CLASS_TRANSIENT, CLASS_USER)
from deeplearning4j_tpu_torch.util import checkpoint as ckpt_util
from torch_parity import mln_twins, modules

_rng = np.random.RandomState(7)
X = _rng.randn(64, 4).astype(np.float32)
Y = np.eye(2, dtype=np.float32)[(X.sum(1) > 0).astype(int)]
EPOCHS = 5          # 4 steps an epoch at batch 16: 20 steps
LOSS_RTOL = 1e-5


def conf(which):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(5)
            .updater(m.Sgd(learning_rate=0.3)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=8))
            .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())


def twins():
    return mln_twins(conf("jax"), conf("torch"))


def make_model():
    return twins()[1]


def make_it():
    # shuffled: a restart must also rewind the per-epoch shuffle
    return NDArrayDataSetIterator(X, Y, batch_size=16, shuffle=True, seed=3)


_BASELINE = None


def baseline_scores():
    global _BASELINE
    if _BASELINE is None:
        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores)
        model.fit(make_it(), epochs=EPOCHS, batch_size=16)
        _BASELINE = [s for _, s in scores.scores]
    return list(_BASELINE)


def supervised(tmp_path, plan=None, data=None, **opts):
    """A supervised fit of a fresh model with a score listener; returns
    (result, scores)."""
    if plan is not None:
        faultinject.set_plan(faultinject.FaultPlan(plan))
    model = make_model()
    scores = CollectScoresIterationListener()
    model.set_listeners(scores)
    opts.setdefault("backoff_base_s", 0.01)
    sup = TrainingSupervisor(model, str(tmp_path), **opts)
    res = sup.fit(data or make_it(), epochs=EPOCHS, batch_size=16,
                  resume="never")
    return res, [s for _, s in scores.scores]


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.clear_plan()
    OpProfiler.get().reset()
    yield
    faultinject.clear_plan()


class TestCrashRestart:
    def test_env_fault_plan_kill_then_auto_restart_bit_exact(
            self, tmp_path, monkeypatch):
        base = baseline_scores()
        monkeypatch.setenv(faultinject.ENV_PLAN, json.dumps(
            [{"site": "train/step", "index": 12, "kind": "crash"}]))
        faultinject.clear_plan()          # the env plan is read anew
        res, scores = supervised(tmp_path, save_every_n_iterations=5)
        assert res.status == "completed" and res.restarts == 1
        assert len(res.history) == 1
        assert res.history[0]["class"] == CLASS_DEVICE
        assert scores == base
        stats = OpProfiler.get().supervisor_stats()
        assert stats["restarts"] == 1 and stats["attempts"] == 2
        assert stats["backoff_count"] == 1 and stats["backoff_s"] > 0

    def test_crash_before_any_checkpoint_restarts_from_anchor(
            self, tmp_path):
        base = baseline_scores()
        res, scores = supervised(
            tmp_path, [{"site": "train/step", "index": 2, "kind": "crash"}],
            save_every_n_iterations=50)
        assert res.status == "completed" and res.restarts == 1
        assert scores == base

    def test_healed_run_matches_the_jax_uninterrupted_run(self, tmp_path):
        """The port's healed run against the JAX package's uninterrupted
        fit on the same copied weights and the same shuffled batches."""
        jn, tn = twins()
        js = JScores()
        jn.set_listeners(js)
        jn.fit(JIterator(X, Y, batch_size=16, shuffle=True, seed=3),
               epochs=EPOCHS, batch_size=16)
        want = [s for _, s in js.scores]
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "train/step", "index": 9, "kind": "crash"}]))
        scores = CollectScoresIterationListener()
        tn.set_listeners(scores)
        res = TrainingSupervisor(tn, str(tmp_path),
                                 save_every_n_iterations=4,
                                 backoff_base_s=0.01).fit(
            make_it(), epochs=EPOCHS, batch_size=16, resume="never")
        got = [s for _, s in scores.scores]
        assert res.restarts == 1 and len(got) == len(want) == 20
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)


class TestWatchdog:
    def test_wedged_dispatch_abandoned_and_healed_bit_exact(self, tmp_path):
        base = baseline_scores()
        res, scores = supervised(
            tmp_path, [{"site": "train/wedge", "index": 9, "kind": "wedge"}],
            save_every_n_iterations=4, hang_deadline_s=0.5, poll_s=0.02)
        assert res.status == "completed" and res.restarts == 1
        assert res.history[0]["class"] == CLASS_HANG
        assert scores == base
        assert OpProfiler.get().supervisor_stats()["watchdog_fires"] == 1
        assert flightrec.events("supervisor/watchdog_fire")

    def test_hang_before_first_heartbeat(self, tmp_path):
        base = baseline_scores()
        res, scores = supervised(
            tmp_path,
            [{"site": "supervisor/hang", "index": 0, "kind": "wedge"}],
            save_every_n_iterations=50, hang_deadline_s=0.4,
            hang_startup_grace_s=1.2, poll_s=0.02)
        assert res.status == "completed" and res.restarts == 1
        assert scores == base


class TestBudgetAndStorm:
    def test_restart_budget_exhaustion_raises_with_history(self, tmp_path):
        with pytest.raises(RestartBudgetExceeded) as ei:
            supervised(tmp_path, [{"site": "train/step", "index": 2,
                                   "kind": "crash", "times": 99}],
                       save_every_n_iterations=50, max_restarts=2)
        assert not isinstance(ei.value, RestartStorm)
        assert len(ei.value.history) == 3          # budget 2: 3 attempts
        assert all(h["class"] == CLASS_DEVICE for h in ei.value.history)
        assert "failure history" in str(ei.value)
        assert OpProfiler.get().supervisor_stats()["giveups"] == 1

    def test_restart_storm_circuit_breaker(self, tmp_path):
        with pytest.raises(RestartStorm) as ei:
            supervised(tmp_path, [{"site": "train/step", "index": 0,
                                   "kind": "crash", "times": 99}],
                       save_every_n_iterations=50, max_restarts=10,
                       storm_threshold=2)
        assert len(ei.value.history) == 2
        assert all(h["steps"] == 0 for h in ei.value.history)
        assert OpProfiler.get().supervisor_stats()["storm_trips"] == 1
        # the give-up carries its black box
        assert os.path.exists(ei.value.blackbox_path)
        assert ei.value.blackbox_tail

    def test_user_errors_raise_immediately(self, tmp_path):
        model = make_model()
        sup = TrainingSupervisor(model, str(tmp_path), backoff_base_s=0.01)
        with pytest.raises(TypeError):
            sup.fit("not a data source", epochs=1, resume="never")
        assert OpProfiler.get().supervisor_stats().get("restarts", 0) == 0

    @pytest.mark.parametrize("kind", [
        "transient", "numeric", "crash", "preempted", "user", "none",
        "unknown", "wedge", "device_loss", "corruption", "cuda_error"])
    def test_classification_table(self, kind):
        """The same class as the JAX package for each exception kind."""
        make = {
            "transient": lambda fi: fi.TransientFault("x"),
            "numeric": lambda fi: FloatingPointError("nan"),
            "crash": lambda fi: fi.SimulatedCrash("k"),
            "preempted": None, "user": lambda fi: ValueError("bad config"),
            "none": lambda fi: None,
            "unknown": lambda fi: RuntimeError("??"),
            "wedge": lambda fi: fi.WedgeReleased("w"),
            "device_loss": lambda fi: fi.DeviceLostError("gone", replica=1),
            "corruption": None,
            # a sticky CUDA error reaches the supervisor as a RuntimeError
            "cuda_error": lambda fi: RuntimeError(
                "CUDA error: an illegal memory access was encountered"),
        }[kind]
        if kind == "preempted":
            pair = (Preempted("sig"), jdist.Preempted("sig"))
        elif kind == "corruption":
            pair = (ReplicaCorruptionError("d", replica=2, iteration=9),
                    JCorrupt("d", replica=2, iteration=9))
        else:
            pair = (make(faultinject), make(jfi))
        got = classify_failure(pair[0])
        assert got == jdist.classify_failure(pair[1])
        want = {"transient": CLASS_TRANSIENT, "numeric": CLASS_NUMERIC,
                "preempted": CLASS_PREEMPTION, "user": CLASS_USER,
                "none": CLASS_HANG}.get(kind)
        if want is not None:
            assert got == want
        assert tdist.DEFAULT_POLICIES == jdist.DEFAULT_POLICIES


class TestPreemption:
    def test_sigterm_drill_flush_checkpoint_then_exact_resume(
            self, tmp_path):
        base = baseline_scores()

        class KillerAt(TrainingListener):
            def __init__(self, at):
                self.at = at

            def iteration_done(self, model, iteration, score):
                if iteration == self.at:
                    os.kill(os.getpid(), signal.SIGTERM)

        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores, KillerAt(7))
        sup = TrainingSupervisor(model, str(tmp_path),
                                 save_every_n_iterations=100,
                                 backoff_base_s=0.01)
        old = signal.getsignal(signal.SIGTERM)
        res = sup.fit(make_it(), epochs=EPOCHS, batch_size=16,
                      resume="never")
        assert signal.getsignal(signal.SIGTERM) is old   # restored
        assert res.status == "preempted" and res.resumable
        assert res.resume_from and os.path.exists(res.resume_from)
        assert os.path.basename(res.resume_from).startswith(
            "checkpoint_preempt_")
        assert res.history[0]["class"] == CLASS_PREEMPTION
        assert OpProfiler.get().supervisor_stats()["preemptions"] == 1
        pre = flightrec.events("supervisor/preempted")
        assert pre and pre[-1]["attrs"]["resume_from"] == res.resume_from
        assert os.path.exists(sup.blackbox_path())

        # a new process: a fresh model and listeners, resume="auto"
        model2 = make_model()
        scores2 = CollectScoresIterationListener()
        model2.set_listeners(scores2)
        res2 = TrainingSupervisor(model2, str(tmp_path),
                                  save_every_n_iterations=100,
                                  backoff_base_s=0.01).fit(
            make_it(), epochs=EPOCHS, batch_size=16)
        assert res2.status == "completed"
        assert [s for _, s in scores2.scores] == base

    def test_preempt_fault_kind_delivers_real_sigterm(self, tmp_path):
        base = baseline_scores()
        res, _ = supervised(
            tmp_path, [{"site": "train/step", "index": 7,
                        "kind": "preempt"}],
            save_every_n_iterations=100)
        assert res.status == "preempted" and res.resumable
        assert res.restarts == 0
        assert res.history[0]["class"] == CLASS_PREEMPTION
        faultinject.clear_plan()
        model2 = make_model()
        scores2 = CollectScoresIterationListener()
        model2.set_listeners(scores2)
        res2 = TrainingSupervisor(model2, str(tmp_path),
                                  save_every_n_iterations=100,
                                  backoff_base_s=0.01).fit(
            make_it(), epochs=EPOCHS, batch_size=16)
        assert res2.status == "completed"
        assert [s for _, s in scores2.scores] == base


class TestIncarnationFence:
    def test_stale_writer_cannot_commit(self, tmp_path):
        d = str(tmp_path)
        inc1 = ckpt_util.claim_incarnation(d)
        assert inc1 == 1
        ckpt_util.commit_checkpoint(d, "a", b"old" * 50, 1, 3,
                                    incarnation=inc1)
        inc2 = ckpt_util.claim_incarnation(d)
        assert inc2 == 2
        with pytest.raises(ckpt_util.StaleIncarnationError):
            ckpt_util.commit_checkpoint(d, "b", b"stale" * 50, 2, 3,
                                        incarnation=inc1)
        assert not os.path.exists(os.path.join(d, "checkpoint_b.zip"))
        names = [e["file"] for e in ckpt_util.read_manifest(d)]
        assert names == ["checkpoint_a.zip"]
        ckpt_util.commit_checkpoint(d, "c", b"new" * 50, 2, 3,
                                    incarnation=inc2)
        names = [e["file"] for e in ckpt_util.read_manifest(d)]
        assert names == ["checkpoint_a.zip", "checkpoint_c.zip"]
        assert ckpt_util.manifest_incarnation(d) == 2

    def test_stale_async_listener_records_error_not_corruption(
            self, tmp_path):
        d = str(tmp_path)
        model = make_model()
        model.fit((X, Y), epochs=1)
        stale = CheckpointListener(d, keep_last=3,
                                   incarnation=ckpt_util.claim_incarnation(d))
        new_inc = ckpt_util.claim_incarnation(d)
        fresh = CheckpointListener(d, keep_last=3, incarnation=new_inc)
        fresh.save_now(model, "fresh")
        stale._save(model, "stale")     # async submit
        stale.flush()
        errs = stale.errors()
        assert errs and isinstance(errs[0],
                                   ckpt_util.StaleIncarnationError)
        stale.close()
        fresh.close()
        last = CheckpointListener.last_checkpoint(d)
        assert last is not None and last.endswith("checkpoint_fresh.zip")


class TestDiskBudgetRetention:
    def test_max_total_bytes_gc_keeps_newest(self, tmp_path):
        d = str(tmp_path)
        payload = b"x" * 1000
        for i in range(5):
            ckpt_util.commit_checkpoint(d, f"iter_{i}", payload, i,
                                        keep_last=0, max_total_bytes=2500)
        names = [e["file"] for e in ckpt_util.read_manifest(d)]
        assert names == ["checkpoint_iter_3.zip", "checkpoint_iter_4.zip"]
        on_disk = sorted(f for f in os.listdir(d)
                         if f.startswith("checkpoint_") and
                         f.endswith(".zip"))
        assert on_disk == names
        ckpt_util.commit_checkpoint(d, "big", b"y" * 5000, 9,
                                    keep_last=0, max_total_bytes=2500)
        names = [e["file"] for e in ckpt_util.read_manifest(d)]
        assert names == ["checkpoint_big.zip"]
        assert OpProfiler.get().counter_value("checkpoint/bytes_gc") >= 3

    def test_listener_threads_byte_budget_through_async_writer(
            self, tmp_path):
        d = str(tmp_path)
        model = make_model()
        cl = CheckpointListener(d, save_every_n_iterations=2, keep_last=50,
                                max_total_bytes=1)
        model.set_listeners(CollectScoresIterationListener(), cl)
        model.fit(make_it(), epochs=2, batch_size=16)
        saved = cl.saved
        cl.close()
        assert len(saved) == 1
        files = [f for f in os.listdir(d)
                 if f.startswith("checkpoint_") and f.endswith(".zip")]
        assert len(files) == 1


class TestMasterIntegration:
    def test_master_preserves_user_listeners_and_supervises(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster

        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores)
        master = (SharedTrainingMaster.Builder(batch_size_per_worker=16)
                  .checkpoint(str(tmp_path), every_n_iterations=4)
                  .build())
        master.fit(model, make_it(), epochs=2)
        assert scores.scores, "user listener was dropped by master.fit"
        assert master.last_result.status == "completed"
        assert model._listeners == [scores]

    def test_wrapper_inherits_model_listeners(self):
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores)
        pw = ParallelWrapper.Builder(model).workers(1).build()
        pw.fit(make_it(), epochs=1, batch_size=16)
        assert scores.scores, "wrapper dropped the model's listeners"

    def test_supervised_wrapper_keeps_model_listeners(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores)
        pw = ParallelWrapper.Builder(model).workers(1).build()
        sup = TrainingSupervisor(pw, str(tmp_path),
                                 save_every_n_iterations=4,
                                 backoff_base_s=0.01)
        res = sup.fit(make_it(), epochs=2, batch_size=16, resume="never")
        assert res.status == "completed"
        assert scores.scores, "supervisor displaced model listeners"


class TestSupervisorTransparency:
    def test_no_fault_supervised_run_is_bit_identical_and_rng_transparent(
            self, tmp_path):
        """Supervision is numerically invisible: the same losses as a plain
        fit, the network's generator where the plain fit leaves it, and
        the caller's stream too (a following draw matches)."""
        set_default_seed(42)
        bmodel = make_model()
        bscores = CollectScoresIterationListener()
        bmodel.set_listeners(bscores)
        bmodel.fit(make_it(), epochs=EPOCHS, batch_size=16)
        base = [s for _, s in bscores.scores]
        after_base = float(get_random().next_double(device="cpu"))

        set_default_seed(42)
        model = make_model()
        scores = CollectScoresIterationListener()
        model.set_listeners(scores)
        sup = TrainingSupervisor(model, str(tmp_path),
                                 save_every_n_iterations=6,
                                 backoff_base_s=0.01)
        res = sup.fit(make_it(), epochs=EPOCHS, batch_size=16,
                      resume="never")
        assert res.status == "completed" and res.restarts == 0
        assert [s for _, s in scores.scores] == base
        assert float(get_random().next_double(device="cpu")) == after_base
        assert np.array_equal(model.generator().get_state().numpy(),
                              bmodel.generator().get_state().numpy())

    def test_data_factory_gets_fresh_source_per_attempt(self, tmp_path):
        base = baseline_scores()
        calls = []

        def factory():
            calls.append(1)
            return make_it()

        res, scores = supervised(
            tmp_path, [{"site": "train/step", "index": 9, "kind": "crash"}],
            data=factory, save_every_n_iterations=4)
        assert res.status == "completed" and len(calls) == 2
        assert scores == base

    def test_iterator_restart_protocol(self):
        it = make_it()
        state = it.source_state()
        first = [ds.features.copy() for ds in it]
        assert it.source_state() == {"epoch": 1}
        it.restore_source_state(state)
        again = [ds.features.copy() for ds in it]
        assert all(np.array_equal(a, b) for a, b in zip(first, again))
        jit = JIterator(X, Y, batch_size=16, shuffle=True, seed=3)
        assert jit.source_state() == state
        for a, b in zip(first, jit):
            assert np.array_equal(a, np.asarray(b.features.value))


class TestReplicaResurrection:
    def test_pool_capacity_recovers_after_dead_replica(self):
        from deeplearning4j_tpu_torch.parallel import ParallelInference

        model = make_model()
        pi = (ParallelInference.Builder(model).inference_mode("batched")
              .workers(2).max_wait_ms(5).request_timeout_ms(5000)
              .resurrect_dead_replicas(backoff_ms=20).build())
        try:
            assert pi.output(np.zeros((2, 4), np.float32)).shape == (2, 2)
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "inference/worker", "kind": "dead_replica"}]))
            with pytest.raises(faultinject.DeadReplicaFault):
                pi.output(np.zeros((2, 4), np.float32))
            faultinject.clear_plan()
            deadline = time.monotonic() + 5.0
            while pi.alive_replicas() < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert pi.pool_stats() == {"workers": 2, "alive": 2,
                                       "retired": 1, "resurrected": 1,
                                       "target": 2, "scaled_down": 0}
            assert pi.output(np.zeros((3, 4), np.float32)).shape == (3, 2)
            prof = OpProfiler.get()
            assert prof.counter_value("inference/replica_resurrected") == 1
        finally:
            pi.shutdown()

    def test_failed_health_probe_backs_off_then_recovers(self):
        from deeplearning4j_tpu_torch.parallel import ParallelInference

        model = make_model()
        pi = (ParallelInference.Builder(model).inference_mode("batched")
              .workers(1).max_wait_ms(5).request_timeout_ms(5000)
              .resurrect_dead_replicas(backoff_ms=20).build())
        try:
            assert pi.output(np.zeros((2, 4), np.float32)).shape == (2, 2)
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "inference/worker", "kind": "dead_replica"},
                 {"site": "inference/probe", "kind": "dead_replica"}]))
            with pytest.raises(faultinject.DeadReplicaFault):
                pi.output(np.zeros((2, 4), np.float32))
            deadline = time.monotonic() + 5.0
            while pi.alive_replicas() < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            faultinject.clear_plan()
            assert pi.pool_stats()["alive"] == 1
            assert OpProfiler.get().counter_value(
                "inference/probe_failures") == 1
            assert pi.output(np.zeros((1, 4), np.float32)).shape == (1, 2)
        finally:
            pi.shutdown()

    def test_health_endpoint_reports_supervisor_and_pools(self):
        from deeplearning4j_tpu_torch.parallel.inference import pool_health
        from deeplearning4j_tpu_torch.ui.server import UIServer

        OpProfiler.get().count("supervisor/restarts", 2)
        OpProfiler.get().count("supervisor/shrinks", 1)
        h = UIServer().health()
        assert h["supervisor"]["restarts"] == 2
        assert h["supervisor"]["shrinks"] == 1
        # the newest incident, else the newest blackbox (None before any)
        from deeplearning4j_tpu_torch.common import watchtower

        assert h["last_incident"] == watchtower.last_incident()
        assert set(h["inference"]) == {"pools", "workers", "alive",
                                       "retired", "resurrected"}
        assert "faults" in h
        assert pool_health()["pools"] == h["inference"]["pools"]


class TestStickyDeviceError:
    def test_unusable_context_refuses_in_memory_continuation(
            self, tmp_path, monkeypatch):
        """A device failure while the card's context is in a sticky error
        state takes checkpoint-restart, never an in-memory continuation."""
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

        model = make_model()
        pw = ParallelWrapper.Builder(model).workers(2).build()
        sup = TrainingSupervisor(pw, str(tmp_path), elastic_grow=False)
        exc = faultinject.DeviceLostError("gone", replica=1)
        assert sup._shrink_plan(exc) == [1]
        monkeypatch.setattr(tdist, "_cuda_context_healthy", lambda d: False)
        assert sup._shrink_plan(exc) is None
        assert sup._quarantine_plan(
            ReplicaCorruptionError("d", replica=1, iteration=3)) is None
