"""The port's ParallelInference (deeplearning4j_tpu_torch/parallel/
inference.py) on the CPU: coalescing, scatter, sequential mode, shutdown and
deadlines, and the serving slice end to end against the JAX package."""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import ParallelInference as JaxPI
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.parallel import ParallelInference
from torch_parity import enable_fused, modules, twin_graphs


class _RecordingModel:
    """output(batch) = 2 * batch; records the batch sizes it was given.
    ``gate`` (an Event) holds every call until it is set."""

    def __init__(self, gate=None, delay_s=0.0):
        self.sizes = []
        self.gate = gate
        self.delay_s = delay_s
        self._lock = threading.Lock()

    def output(self, batch):
        if self.gate is not None:
            self.gate.wait(timeout=10)
        if self.delay_s:
            time.sleep(self.delay_s)
        t = torch.as_tensor(np.asarray(batch))
        with self._lock:
            self.sizes.append(int(t.shape[0]))
        return [2.0 * t]


def _req(i, n=1):
    return np.full((n, 4), float(i), np.float32)


@pytest.fixture(autouse=True)
def _fresh_counters():
    OpProfiler.get().reset()
    yield


class TestBatching:
    def test_coalesces_up_to_batch_limit(self):
        gate = threading.Event()
        model = _RecordingModel(gate)
        pi = (ParallelInference.Builder(model).inference_mode("batched")
              .batch_limit(4).max_wait_ms(200).queue_limit(64).build())
        try:
            # the first request is picked up and held at the gate; the
            # next ten queue behind it
            futs = [pi.output_async(_req(0))]
            time.sleep(0.3)
            futs += [pi.output_async(_req(i)) for i in range(1, 11)]
            gate.set()
            for f in futs:
                f.result(timeout=10)
            assert sum(model.sizes) == 11
            assert max(model.sizes) == 4          # never above the limit
            assert model.sizes[1:] == [4, 4, 2]   # coalesced behind it
            prof = OpProfiler.get()
            assert prof.counter_value("inference/batches") == \
                len(model.sizes)
            assert prof.counter_value("inference/requests") == 11
        finally:
            pi.shutdown()

    def test_results_scattered_to_the_right_futures(self):
        model = _RecordingModel()
        pi = (ParallelInference.Builder(model).batch_limit(8)
              .max_wait_ms(50).workers(2).build())
        try:
            futs = [pi.output_async(_req(i, n=1 + i % 3)) for i in range(12)]
            for i, f in enumerate(futs):
                out = f.result(timeout=10)
                assert out.shape == (1 + i % 3, 4)
                assert torch.equal(out, torch.full((1 + i % 3, 4), 2.0 * i))
                assert out.device.type == "cpu"
        finally:
            pi.shutdown()

    def test_batch_error_scatters_and_worker_survives(self):
        class Flaky(_RecordingModel):
            def output(self, batch):
                if np.asarray(batch)[0, 0] < 0:
                    raise ValueError("bad request")
                return super().output(batch)

        pi = (ParallelInference.Builder(Flaky()).batch_limit(1)
              .max_wait_ms(1).build())
        try:
            with pytest.raises(ValueError, match="bad request"):
                pi.output(_req(-1))
            assert torch.equal(pi.output(_req(3)), torch.full((1, 4), 6.0))
            assert OpProfiler.get().counter_value(
                "inference/batch_errors") == 1
        finally:
            pi.shutdown()


class TestModes:
    def test_sequential_mode_runs_at_once(self):
        model = _RecordingModel()
        pi = (ParallelInference.Builder(model)
              .inference_mode("sequential").build())
        outs = [pi.output(_req(i, 2)) for i in range(3)]
        assert model.sizes == [2, 2, 2]
        assert [o.shape for o in outs] == [(2, 4)] * 3
        assert not pi._workers
        pi.shutdown()

    def test_inplace_maps_to_sequential(self):
        pi = ParallelInference.Builder(_RecordingModel()) \
            .inference_mode("inplace").build()
        assert pi.mode == "sequential"
        pi.shutdown()


class TestFailureContract:
    def test_request_timeout_raises(self):
        gate = threading.Event()    # a wedged worker, released at the end
        pi = (ParallelInference.Builder(_RecordingModel(gate))
              .max_wait_ms(5).request_timeout_ms(200).build())
        try:
            with pytest.raises(TimeoutError) as ei:
                pi.output(_req(0))
            msg = str(ei.value)
            assert "queue depth" in msg and "replicas alive" in msg
            assert "in queue" in msg
        finally:
            gate.set()
            pi.shutdown()

    def test_shutdown_fails_queued_futures(self):
        pi = (ParallelInference.Builder(_RecordingModel(delay_s=0.5))
              .batch_limit(1).max_wait_ms(1).build())
        futs = [pi.output_async(_req(0)) for _ in range(4)]
        time.sleep(0.1)
        pi.shutdown()
        assert all(f.done() for f in futs)
        errs = [f for f in futs if f.exception(timeout=0) is not None]
        assert errs and all(isinstance(f.exception(), RuntimeError)
                            for f in errs)
        # the batch already in flight finished normally
        assert futs[0].exception(timeout=0) is None
        late = pi.output_async(_req(0))
        assert isinstance(late.exception(timeout=0), RuntimeError)

    def test_enqueued_at_recorded(self):
        pi = ParallelInference.Builder(_RecordingModel()).build()
        try:
            t0 = time.monotonic()
            fut = pi.output_async(_req(0))
            assert t0 <= fut.enqueued_at <= time.monotonic()
            fut.result(timeout=10)
        finally:
            pi.shutdown()


class TestServingSlice:
    def test_resnet50_served_like_the_jax_package(self):
        """ResNet-50 (32x32, 10 classes) behind ParallelInference in both
        packages, with carried weights and the fused epilogue on: the
        answers agree per request."""
        jz, tz = modules("jax").zoo, modules("torch").zoo
        jg, tg = twin_graphs(
            jz.ResNet50(num_classes=10, image_size=32).init().conf,
            tz.ResNet50(num_classes=10, image_size=32).conf(),
            calibrate_x=np.random.default_rng(11).normal(
                size=(64, 3, 32, 32)).astype(np.float32),
            head_scale=0.1)
        enable_fused(jg, "jax")
        enable_fused(tg, "torch")
        xs = np.random.default_rng(5).normal(
            size=(6, 1, 3, 32, 32)).astype(np.float32)
        tpi = (ParallelInference.Builder(tg).batch_limit(4).max_wait_ms(50)
               .workers(2).build())
        jpi = JaxPI.Builder(jg).batch_limit(4).max_wait_ms(50).build()
        try:
            tf = [tpi.output_async(x) for x in xs]
            jf = [jpi.output_async(x) for x in xs]
            for a, b in zip(tf, jf):
                got = a.result(timeout=60).numpy()
                want = b.result(timeout=60).to_numpy()
                assert got.shape == want.shape == (1, 10)
                assert np.allclose(got, want, rtol=1e-4, atol=1e-5)
            prof = OpProfiler.get()
            assert prof.counter_value("precision/epilogue_hits") == \
                53 * prof.counter_value("inference/batches")
        finally:
            tpi.shutdown()
            jpi.shutdown()


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


class _JaxDoubler:
    """The JAX package's counterpart of _RecordingModel (NDArray out)."""

    def output(self, batch):
        from deeplearning4j_tpu.ndarray.ndarray import NDArray

        return NDArray(2.0 * np.asarray(batch))


class TestResurrection:
    @pytest.fixture(autouse=True)
    def _plans(self):
        from deeplearning4j_tpu.common import faultinject as jfi
        from deeplearning4j_tpu_torch.common import faultinject

        faultinject.clear_plan()
        jfi.clear_plan()
        yield
        faultinject.clear_plan()
        jfi.clear_plan()

    def test_retired_replica_is_replaced_like_the_jax_pool(self):
        """The same drill (the replica serving request 1 dies) on both
        packages' pools: the same census after the resurrection."""
        from deeplearning4j_tpu.common import faultinject as jfi
        from deeplearning4j_tpu_torch.common import faultinject, flightrec

        spec = [{"site": "inference/worker", "kind": "dead_replica",
                 "index": 1}]
        stats = []
        for fi, pi_cls, model in ((faultinject, ParallelInference,
                                   _RecordingModel()),
                                  (jfi, JaxPI, _JaxDoubler())):
            fi.set_plan(fi.FaultPlan(spec))
            pi = (pi_cls.Builder(model).batch_limit(1).max_wait_ms(1)
                  .workers(2).resurrect_dead_replicas(True, backoff_ms=20)
                  .build())
            try:
                outcomes = []
                for i in range(3):
                    fut = pi.output_async(_req(i))
                    outcomes.append(type(fut.exception(timeout=10)).__name__)
                assert _wait(lambda: pi.pool_stats()["resurrected"] == 1
                             and pi.alive_replicas() == 2)
                stats.append((outcomes, pi.pool_stats()))
            finally:
                pi.shutdown()
        assert stats[0] == stats[1]
        assert stats[0][0] == ["NoneType", "DeadReplicaFault", "NoneType"]
        assert stats[0][1]["retired"] == 1
        ev = flightrec.events("inference/resurrected")[-1]
        assert ev["attrs"]["alive"] == 2

    def test_failed_probes_back_off_then_resurrect(self):
        from deeplearning4j_tpu_torch.common import faultinject

        prof = OpProfiler.get()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "inference/worker", "kind": "dead_replica",
              "index": 0},
             {"site": "inference/probe", "kind": "transient", "times": 2}]))
        pi = (ParallelInference.Builder(_RecordingModel()).batch_limit(1)
              .max_wait_ms(1).workers(1)
              .resurrect_dead_replicas(True, backoff_ms=20).build())
        try:
            assert isinstance(pi.output_async(_req(0)).exception(timeout=10),
                              Exception)
            assert _wait(lambda: pi.alive_replicas() == 1)
            assert prof.counter_value("inference/probe_failures") == 2
            assert prof.counter_value("inference/replica_resurrected") == 1
            assert torch.equal(pi.output(_req(3)), torch.full((1, 4), 6.0))
        finally:
            pi.shutdown()

    def test_last_replica_fails_fast_without_resurrection(self):
        from deeplearning4j_tpu_torch.common import faultinject

        gate = threading.Event()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "inference/worker", "kind": "dead_replica",
              "index": 0}]))
        pi = (ParallelInference.Builder(_RecordingModel(gate))
              .batch_limit(1).max_wait_ms(1).workers(1)
              .resurrect_dead_replicas(False).build())
        try:
            dead = pi.output_async(_req(0))
            gate.set()
            assert dead.exception(timeout=10) is not None
            assert _wait(lambda: pi.alive_replicas() == 0)
            late = pi.output_async(_req(1))
            assert "retired" in str(late.exception(timeout=1))
            assert pi.pool_stats()["resurrected"] == 0
        finally:
            pi.shutdown()

    def test_resurrection_budget(self):
        from deeplearning4j_tpu_torch.common import faultinject

        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "inference/worker", "kind": "dead_replica",
              "index": i} for i in (0, 1)]))
        pi = (ParallelInference.Builder(_RecordingModel()).batch_limit(1)
              .max_wait_ms(1).workers(1)
              .resurrect_dead_replicas(True, backoff_ms=10,
                                       max_resurrections=1).build())
        try:
            pi.output_async(_req(0)).exception(timeout=10)
            assert _wait(lambda: pi.alive_replicas() == 1)
            pi.output_async(_req(1)).exception(timeout=10)
            assert _wait(lambda: pi.pool_stats()["retired"] == 2)
            time.sleep(0.1)
            assert pi.alive_replicas() == 0
            assert pi.pool_stats()["resurrected"] == 1
        finally:
            pi.shutdown()


class TestPoolCensus:
    def test_scale_to_and_pool_health(self):
        from deeplearning4j_tpu_torch.parallel.inference import pool_health

        prof = OpProfiler.get()
        pi = (ParallelInference.Builder(_RecordingModel()).batch_limit(2)
              .max_wait_ms(1).workers(1).build())
        try:
            base = pool_health()
            assert pi.scale_to(3, reason="test") == 3
            assert _wait(lambda: pi.alive_replicas() == 3)
            assert pool_health()["alive"] == base["alive"] + 2
            assert prof.counter_value("inference/workers_started") == 2
            for i in range(6):
                assert torch.equal(pi.output(_req(i)),
                                   torch.full((1, 4), 2.0 * i))
            pi.scale_to(1, reason="test")
            assert _wait(lambda: pi.alive_replicas() == 1)
            stats = pi.pool_stats()
            assert stats == {"workers": 1, "alive": 1, "target": 1,
                             "scaled_down": 2, "retired": 0,
                             "resurrected": 0}
            assert prof.counter_value("inference/workers_stopped") == 2
        finally:
            pi.shutdown()
        assert pi.alive_replicas() == 0
        assert all(not t.is_alive() for t in pi._workers)

    def test_sequential_pool_cannot_scale(self):
        pi = ParallelInference.Builder(_RecordingModel()) \
            .inference_mode("sequential").build()
        with pytest.raises(RuntimeError, match="batched"):
            pi.scale_to(2)
        pi.shutdown()

    def test_builder_matches_the_jax_defaults(self):
        t = ParallelInference.Builder(_RecordingModel())
        j = JaxPI.Builder(_JaxDoubler())
        for k in ("_resurrect", "_resurrect_backoff_ms",
                  "_max_resurrections", "_batch_limit", "_queue_limit",
                  "_max_wait_ms", "_workers"):
            assert getattr(t, k) == getattr(j, k), k
