"""The port's steady-state check (``common/tracecheck.py``) against the JAX
package's drills (``tests/test_observability.py::TestTraceCheck``): a
declared region stays quiet on replay and hard-fails on a new program (a
new census generation, a kernel build, a moved ``trace/*`` counter) and on
unbudgeted host syncs. On the CPU the host syncs are the port's counted
readback points (the listeners' score conversion, the telemetry drain,
StatsListener's collection); on the card the sync debug mode counts every
synchronizing call as well (chip_smoke phases 59 and 60)."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import tracecheck as jtc
from deeplearning4j_tpu.common.profiler import OpProfiler as JProf
from deeplearning4j_tpu_torch.common import flightrec, tracecheck, xprof
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.ops import cuda_lib
from deeplearning4j_tpu_torch.optimize import telemetry
from deeplearning4j_tpu_torch.optimize.listeners import (
    CollectScoresIterationListener)
from torch_parity import modules


@pytest.fixture(autouse=True)
def _census_on():
    xprof.configure(enabled=True)
    yield
    xprof.configure(enabled=True)


def _model():
    m = modules("torch")
    conf = (m.NeuralNetConfiguration.builder().seed(7)
            .updater(m.Sgd(learning_rate=0.1)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=8))
            .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())
    return m.MultiLayerNetwork(conf).init(device="cpu")


def _batch(n=16):
    rng = np.random.RandomState(3)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return DataSet(x, y)


def _counter(name):
    return OpProfiler.get().counter_value(name)


def test_clean_steady_state_passes():
    model, ds = _model(), _batch()
    model.fit(ds)                              # the first generation
    before = _counter("tracecheck/regions")
    with tracecheck.steady_state("clean replay") as region:
        for _ in range(3):
            model.fit(ds)
    assert region.counter_deltas == {} and region.compiles == 0
    assert region.host_syncs == 0
    assert _counter("tracecheck/regions") == before + 1


def test_new_signature_hard_fails():
    model = _model()
    model.fit(_batch(16))
    before = _counter("tracecheck/violations")
    with pytest.raises(tracecheck.SteadyStateViolation,
                       match="compiled inside steady state") as ei:
        with tracecheck.steady_state("injected retrace"):
            model.fit(_batch(24))              # a new batch size
    assert ei.value.report["compiles"] == 1
    assert ei.value.report["compiled"] == ["mln/fit_step"]
    assert _counter("tracecheck/violations") == before + 1
    viol = flightrec.events("tracecheck/violation")
    assert viol and viol[-1]["attrs"]["label"] == "injected retrace"
    # a budget of one new program lets the same region pass
    with tracecheck.steady_state("budgeted", allow_compiles=1) as r:
        model.fit(_batch(32))
    assert r.compiles == 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_moved_trace_counter_fails_as_in_jax(pkg):
    """The ``trace/*`` counter detector: the same counter script gives the
    same verdict and evidence in both packages."""
    tc, prof = ((jtc, JProf.get()) if pkg == "jax"
                else (tracecheck, OpProfiler.get()))
    with pytest.raises(tc.SteadyStateViolation) as ei:
        with tc.steady_state("counter moved", max_host_syncs=None):
            prof.count("trace/serving_infer")
            prof.count("trace/serving_infer")
            prof.count("serving/forwards")   # not watched
    assert ei.value.report["counter_deltas"] == {"trace/serving_infer": 2}
    assert "trace/serving_infer+2" in str(ei.value)
    # one new program within budget, counted once across the detectors
    with tc.steady_state("budget", allow_compiles=1,
                         max_host_syncs=None) as r:
        prof.count("trace/fleet_step")
    assert r.counter_deltas == {"trace/fleet_step": 1}


def test_host_sync_budget():
    model, ds = _model(), _batch()
    model.fit(ds)
    model.set_listeners(CollectScoresIterationListener())
    with pytest.raises(tracecheck.SteadyStateViolation, match="host sync"):
        with tracecheck.steady_state("no syncs"):
            model.fit(ds)                      # one score readback
    with tracecheck.steady_state("one sync", max_host_syncs=1) as r:
        model.fit(ds)
    assert r.host_syncs == 1 and r.readbacks == 1
    with tracecheck.steady_state("counted", max_host_syncs=None) as r:
        model.fit(ds)
        model.fit(ds)
    assert r.host_syncs == 2


def test_telemetry_readback_is_a_counted_sync():
    auxes = [{"loss": torch.tensor(1.0), "n": torch.tensor([2, 3])}
             for _ in range(3)]
    with tracecheck.steady_state("drain", max_host_syncs=None) as r:
        out = telemetry.readback(auxes)
    assert r.readbacks == 1 and len(out) == 3
    assert out[0]["n"].tolist() == [2, 3]


def test_kernel_build_is_a_compile(tmp_path, monkeypatch):
    """Every nvcc run of ``ops/cuda_lib.build`` is reported: a kernel build
    inside a region is a violation."""
    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            open(cmd[-1], "wb").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "_command", lambda name, out: [str(out)])
    monkeypatch.setattr(cuda_lib.subprocess, "Popen", FakeProc)
    with pytest.raises(tracecheck.SteadyStateViolation) as ei:
        with tracecheck.steady_state("build"):
            cuda_lib.build(["bn_act"], force=True)
    assert ei.value.report["compiled"] == ["nvcc bn_act"]


def test_regions_do_not_nest_and_release_after_a_raise():
    with tracecheck.steady_state("outer", max_host_syncs=None):
        with pytest.raises(RuntimeError, match="do not nest"):
            with tracecheck.steady_state("inner"):
                pass
    with pytest.raises(tracecheck.SteadyStateViolation):
        with tracecheck.steady_state("raises"):
            tracecheck.note_host_sync("x")
    # the raising region released the slot; reports outside one are free
    tracecheck.note_host_sync("outside")
    tracecheck.note_compile("outside")
    with tracecheck.steady_state("after") as r:
        pass
    assert r.host_syncs == 0 and r.compiles == 0
    with pytest.raises(ValueError):
        with tracecheck.steady_state("body raises"):
            raise ValueError("the body's own error")
    with tracecheck.steady_state("free again"):
        pass


def test_stats_ledger_like_jax():
    with tracecheck.steady_state("ledger", max_host_syncs=None):
        pass
    with jtc.steady_state("ledger", max_host_syncs=None):
        pass
    got, want = OpProfiler.get().tracecheck_stats(), \
        JProf.get().tracecheck_stats()
    assert set(want) <= {"regions", "violations"}
    assert set(got) <= {"regions", "violations"} and got["regions"] >= 1
