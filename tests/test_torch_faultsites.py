"""The training paths' fault sites and flight-recorder events in the port:
the fit loop's ``pipeline/bind``, ``pipeline/place``, ``train/step``,
``train/wedge`` and ``device/loss`` (``data/pipeline.run_epochs``), the
``pipeline/dispatch`` and ``pipeline/epoch`` events, the data-parallel
wrapper's ``integrity/fingerprint`` site with the ``integrity/divergence``
and ``integrity/fingerprint`` events, ``checkpoint/restore`` and
``perf/rate``.

Against the JAX package: one ``FaultPlan`` run through a fit in both
packages gives the same fault counts, the same retries and the same
sequence of fault and pipeline events (names and attributes). The device
loss drill is the counterpart of ``tests/test_elastic.py``'s
``test_device_loss_fault_raises_and_counts``.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.common import faultinject as jfi
from deeplearning4j_tpu.common import flightrec as jfr
from deeplearning4j_tpu.common.profiler import OpProfiler as JProfiler
from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIterator
from deeplearning4j_tpu.optimize import NanSentinelListener as JNan
from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.integrity import (IntegrityListener,
                                                       ReplicaCorruptionError)
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize import (NanSentinelListener,
                                               PerformanceListener)
from deeplearning4j_tpu_torch.parallel import ParallelWrapper
from torch_parity import mln_twins, modules


@pytest.fixture(autouse=True)
def _clean():
    for fi in (faultinject, jfi):
        fi.clear_plan()
    OpProfiler.get().reset()
    flightrec.reset()
    yield
    for fi in (faultinject, jfi):
        fi.clear_plan()


def conf(which, seed=5):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(m.Sgd(0.1)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=9))
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())


def data(n=24):
    rng = np.random.RandomState(7)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def lenet_narrow():
    m = modules("torch")
    c = (m.NeuralNetConfiguration.builder().seed(123)
         .updater(m.Nesterovs(learning_rate=0.01, momentum=0.9))
         .activation("relu").weight_init("xavier").fused_update().list()
         .layer(m.L.ConvolutionLayer(n_out=4, kernel_size=(5, 5)))
         .layer(m.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
         .layer(m.L.DenseLayer(n_out=16))
         .layer(m.L.OutputLayer(n_out=10, loss="mcxent",
                                activation="softmax"))
         .set_input_type(m.InputType.convolutional(12, 12, 1)).build())
    return m.MultiLayerNetwork(c).init(device="cpu")


def fault_trail(events):
    return [(e["name"], e["attrs"]) for e in events
            if e["name"].startswith(("fault/", "pipeline/"))]


class TestDeviceLoss:
    def test_device_loss_fault_raises_and_counts(self):
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 2, "kind": "device_loss",
              "replica": 3}]))
        assert faultinject.fault_point("device/loss", 0) == []
        with pytest.raises(faultinject.DeviceLostError) as ei:
            faultinject.fault_point("device/loss", 2)
        assert ei.value.replica == 3
        assert OpProfiler.get().fault_stats()[
            "faults/device/loss/device_loss"] == 1

    def test_device_loss_in_a_fit_stops_it_at_the_step(self):
        """The site fires before dispatch 2 of a (narrow) LeNet fit: two
        steps were taken, the error names the replica, the fault is
        counted and on the flight recorder."""
        rng = np.random.RandomState(0)
        x = rng.rand(24, 1, 12, 12).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 24)]
        net = lenet_narrow()
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "device/loss", "index": 2, "kind": "device_loss",
              "replica": 0}]))
        with pytest.raises(faultinject.DeviceLostError) as ei:
            net.fit(NDArrayDataSetIterator(x, y, batch_size=4))
        assert ei.value.replica == 0 and "replica 0" in str(ei.value)
        assert net._iteration == 2
        assert OpProfiler.get().fault_stats()[
            "faults/device/loss/device_loss"] == 1
        fired = flightrec.events("fault/fired")
        assert fired[-1]["attrs"]["replica"] == 0


class TestFitSites:
    PLAN = [{"site": "pipeline/bind", "kind": "transient", "index": 1},
            {"site": "pipeline/place", "kind": "transient", "index": 2},
            {"site": "pipeline/bind", "kind": "nan", "index": 3},
            {"site": "device/loss", "kind": "device_loss", "index": 5,
             "replica": 1}]

    def test_fault_counts_and_events_equal_jax(self):
        """One plan through a fit in both packages: the same fault counts
        and retries, and the same fault and pipeline events in order."""
        x, y = data()
        jn, tn = mln_twins(conf("jax"), conf("torch"))
        out = {}
        for which, net, fi, fr, prof, it, nan in (
                ("jax", jn, jfi, jfr, JProfiler, JIterator, JNan),
                ("torch", tn, faultinject, flightrec, OpProfiler,
                 NDArrayDataSetIterator, NanSentinelListener)):
            net.set_listeners(nan("skip", check_every_n=1))
            prof.get().reset()
            fr.reset()
            fi.set_plan(fi.FaultPlan(self.PLAN))
            try:
                with pytest.raises(fi.DeviceLostError):
                    net.fit(it(x, y, batch_size=4), epochs=2)
            finally:
                fi.clear_plan()
            stats = prof.get().fault_stats()
            out[which] = ({k: v for k, v in stats.items()
                           if k.startswith("faults/")},
                          prof.get().counter_value("pipeline/retries"),
                          fault_trail(fr.events()), net._iteration)
        assert out["torch"] == out["jax"]
        assert out["torch"][1] == 2

    def test_nan_spec_poisons_the_batch_and_the_guard_skips_it(self):
        x, y = data()
        net = mln_twins(conf("jax"), conf("torch"))[1]
        lst = NanSentinelListener("skip", check_every_n=1)
        net.set_listeners(lst)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/bind", "kind": "nan", "index": 1}]))
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4))
        assert [e["iteration"] for e in lst.events] == [2]
        assert all(np.isfinite(net.params().numpy()))

    @pytest.mark.parametrize("site,kind,exc", [
        ("train/step", "crash", faultinject.SimulatedCrash),
        ("pipeline/bind", "transient", faultinject.TransientFault)])
    def test_raising_kinds_stop_the_fit(self, site, kind, exc):
        x, y = data()
        net = mln_twins(conf("jax"), conf("torch"))[1]
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": site, "kind": kind, "index": 3, "times": 9}]))
        with pytest.raises(exc):
            # prefetch 0: batch 3 is bound when step 3 is due
            net.fit(NDArrayDataSetIterator(x, y, batch_size=4), prefetch=0)
        assert net._iteration == 3

    def test_chunked_dispatch_events_carry_steps(self):
        x, y = data(20)
        net = mln_twins(conf("jax"), conf("torch"))[1]
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4),
                steps_per_dispatch=2)
        ev = [e["attrs"] for e in flightrec.events("pipeline/dispatch")]
        assert ev == [{"ordinal": 0, "steps": 2}, {"ordinal": 2, "steps": 2},
                      {"ordinal": 4, "steps": 1}]


class TestEvents:
    def test_bitflip_through_the_fingerprint_site_is_caught(self):
        """The wrapper's ``integrity/fingerprint`` site flips one bit of
        replica 2's parameters before the dispatch at iteration 6; the
        check at that step names the replica and records the events."""
        model = mln_twins(conf("jax"), conf("torch"))[1]
        pw = ParallelWrapper.Builder(model).workers(4).build()
        lst = IntegrityListener(check_every=1)
        pw.set_listeners(lst)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "integrity/fingerprint", "kind": "bitflip",
              "index": 6, "replica": 2, "bit": 12, "offset": 3}]))
        x, y = data(96)
        with pytest.raises(ReplicaCorruptionError) as ei:
            pw.fit(NDArrayDataSetIterator(x, y, batch_size=24), epochs=3)
        assert ei.value.replica == 2 and ei.value.iteration == 7
        prof = OpProfiler.get()
        assert prof.counter_value("integrity/bitflips_injected") == 1
        assert prof.fault_stats()[
            "faults/integrity/fingerprint/bitflip"] == 1
        div = flightrec.events("integrity/divergence")
        assert div and div[0]["attrs"]["replica"] == 2
        assert flightrec.events("integrity/fingerprint")

    def test_checkpoint_restore_event(self, tmp_path):
        from deeplearning4j_tpu_torch.optimize import CheckpointListener

        x, y = data()
        net = mln_twins(conf("jax"), conf("torch"))[1]
        ck = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        net.set_listeners(ck)
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4))
        ck.close()
        fresh = mln_twins(conf("jax"), conf("torch"))[1]
        path = str(tmp_path / "checkpoint_iter_3.zip")
        fresh.fit(NDArrayDataSetIterator(x, y, batch_size=4),
                  resume_from=path)
        ev = flightrec.events("checkpoint/restore")
        assert ev[-1]["attrs"] == {"file": "checkpoint_iter_3.zip",
                                   "epochs_done": 0, "steps_in_epoch": 3}

    def test_performance_listener_records_perf_rate(self):
        x, y = data()
        net = mln_twins(conf("jax"), conf("torch"))[1]
        net.set_listeners(PerformanceListener(frequency=2))
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4))
        ev = flightrec.events("perf/rate")
        assert [e["attrs"]["iteration"] for e in ev] == [2, 4, 6]
        assert all(e["attrs"]["samples_per_sec"] > 0 for e in ev)
