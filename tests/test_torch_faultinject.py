"""The port's fault injection (deeplearning4j_tpu_torch/common/faultinject.py)
against the JAX package's: one plan spec fires at the same (site, index)
calls with the same effect, retries and the environment plan alike."""

import json
import threading
import time

import pytest

from deeplearning4j_tpu.common import faultinject as jfi
from deeplearning4j_tpu.common.profiler import OpProfiler as JProf
from deeplearning4j_tpu_torch.common import faultinject as tfi
from deeplearning4j_tpu_torch.common import flightrec as tfr
from deeplearning4j_tpu_torch.common.profiler import OpProfiler as TProf

PACKAGES = ((jfi, JProf), (tfi, TProf))


@pytest.fixture(autouse=True)
def _clean():
    for fi, _ in PACKAGES:
        fi.clear_plan()
    yield
    for fi, _ in PACKAGES:
        fi.clear_plan()


def _outcomes(fi, specs, calls):
    """What each (site, index) call does under the plan: the exception's
    class name, or the advisory kinds it returned."""
    fi.set_plan(fi.FaultPlan(specs))
    out = []
    for site, index in calls:
        try:
            adv = fi.fault_point(site, index)
            out.append(("ok", tuple(s["kind"] for s in adv)))
        except BaseException as e:          # SimulatedCrash, WedgeReleased
            out.append((type(e).__name__,
                        getattr(e, "replica", None),
                        getattr(e, "stage", None)))
    fired = fi.get_plan().fired_count()
    fi.clear_plan()
    return out, fired


CALLS = [(site, i) for site in ("serving/dispatch", "serving/admission",
                                "serving/enqueue", "serving/promote",
                                "inference/worker", "inference/probe",
                                "checkpoint/scrub", "device/loss",
                                "pipeline/bind", "autoscale/decide")
         for i in (0, 1, 2, 3, None)]

SPECS = [
    [{"site": "serving/dispatch", "kind": "transient", "index": 2}],
    [{"site": "serving/dispatch", "kind": "dead_replica", "index": 0}],
    [{"site": "serving/dispatch", "kind": "slow", "seconds": 0.001,
      "times": 3}],
    [{"site": "serving/admission", "kind": "transient", "index": 1,
      "times": 2}],
    [{"site": "serving/promote", "kind": "transient", "index": 3}],
    [{"site": "inference/worker", "kind": "dead_replica", "index": 1},
     {"site": "inference/probe", "kind": "transient"}],
    [{"site": "checkpoint/scrub", "kind": "bitflip", "index": 0,
      "offset": 7, "bit": 2},
     {"site": "checkpoint/scrub", "kind": "transient", "index": 2}],
    [{"site": "device/loss", "kind": "device_loss", "index": 1,
      "replica": 3}],
    [{"site": "pipeline/bind", "kind": "nan", "index": 2},
     {"site": "autoscale/decide", "kind": "transient", "index": 0}],
    [{"site": "serving/enqueue", "kind": "crash", "index": 1}],
]


class TestPlans:
    @pytest.mark.parametrize("spec", SPECS,
                             ids=[json.dumps(s)[:60] for s in SPECS])
    def test_same_spec_fires_at_the_same_calls(self, spec):
        j = _outcomes(jfi, spec, CALLS)
        t = _outcomes(tfi, spec, CALLS)
        assert j == t
        assert t[1] > 0          # the plan fired

    def test_counters_and_flight_recorder(self):
        tfr.reset()
        for fi, prof in PACKAGES:
            prof.get().reset()
            fi.set_plan(fi.FaultPlan(
                [{"site": "serving/dispatch", "kind": "transient",
                  "index": 4, "times": 1}]))
            with pytest.raises(fi.TransientFault):
                fi.fault_point("serving/dispatch", 4)
            assert fi.fault_point("serving/dispatch", 4) == []
        assert TProf.get().fault_stats() == JProf.get().fault_stats() == {
            "faults/serving/dispatch/transient": 1}
        ev = tfr.events("fault/fired")[-1]
        assert ev["attrs"] == {"site": "serving/dispatch",
                               "kind": "transient", "index": 4}

    @pytest.mark.parametrize("bad", [
        [{"site": "serving/nowhere", "kind": "transient"}],
        [{"kind": "transient"}], [{"site": "serving/dispatch"}]])
    def test_bad_specs_refused_alike(self, bad):
        for fi, _ in PACKAGES:
            with pytest.raises(ValueError):
                fi.FaultPlan(bad)

    def test_registry_is_the_jax_registry(self):
        assert {k: v["kinds"] for k, v in tfi.FAULT_SITES.items()} == \
            {k: v["kinds"] for k, v in jfi.FAULT_SITES.items()}
        assert tfi.ENV_PLAN == jfi.ENV_PLAN

    @pytest.mark.parametrize("inline", [True, False])
    def test_environment_plan(self, monkeypatch, tmp_path, inline):
        spec = [{"site": "serving/dispatch", "kind": "transient",
                 "index": 1}]
        raw = json.dumps(spec)
        if not inline:
            p = tmp_path / "plan.json"
            p.write_text(raw)
            raw = f"@{p}"
        monkeypatch.setenv(tfi.ENV_PLAN, raw)
        res = []
        for fi, _ in PACKAGES:
            fi.clear_plan()
            res.append(_outcomes_env(fi))
        assert res[0] == res[1] == ["ok", "TransientFault", "ok"]


def _outcomes_env(fi):
    out = []
    for i in range(3):
        try:
            fi.fault_point("serving/dispatch", i)
            out.append("ok")
        except Exception as e:
            out.append(type(e).__name__)
    return out


class TestRetryAndWedge:
    @pytest.mark.parametrize("fails,max_retries", [(0, 3), (2, 3), (3, 3),
                                                   (4, 3), (1, 0)])
    def test_retry_call_alike(self, fails, max_retries):
        res = []
        for fi, prof in PACKAGES:
            prof.get().reset()
            n = [0]

            def fn():
                n[0] += 1
                if n[0] <= fails:
                    raise fi.TransientFault("flaky")
                return n[0]

            try:
                got = fi.retry_call(fn, "test", max_retries=max_retries,
                                    base_delay_s=0.001)
            except fi.TransientFault:
                got = "raised"
            res.append((got, n[0],
                        prof.get().counter_value("pipeline/retries")))
        assert res[0] == res[1]

    def test_non_transient_is_not_retried(self):
        calls = [0]

        def fn():
            calls[0] += 1
            raise KeyError("no")

        with pytest.raises(KeyError):
            tfi.retry_call(fn, "test", base_delay_s=0.001)
        assert calls[0] == 1

    def test_wedge_blocks_until_released(self):
        tfi.set_plan(tfi.FaultPlan([{"site": "train/wedge", "kind": "wedge",
                                     "seconds": 5.0}]))
        t0 = time.monotonic()
        timer = threading.Timer(0.1, tfi.release_wedges)
        timer.start()
        try:
            with pytest.raises(tfi.WedgeReleased):
                tfi.fault_point("train/wedge", 0)
            assert time.monotonic() - t0 < 2.0
        finally:
            timer.join(timeout=2.0)
            tfi.reset_wedges()

    def test_is_transient(self):
        assert tfi.is_transient(tfi.TransientFault("x"))
        assert not tfi.is_transient(tfi.DeadReplicaFault("x"))
        assert issubclass(tfi.SimulatedCrash, BaseException)
        assert not issubclass(tfi.SimulatedCrash, Exception)
