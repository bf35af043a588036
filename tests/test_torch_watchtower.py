"""The port's SLO watchtower (``deeplearning4j_tpu_torch/common/
watchtower.py``) against the JAX package's drills
(``tests/test_watchtower.py``): the window and budget math, the samplers
and the burn-rate state machine run the same script under an injected
clock in both packages with the same transitions; incidents are assembled
from the port's own supervised crash drill and flight-recorder chains; and
``/api/incidents``, ``/api/metrics``'s ``dl4j_alert_state`` and
``/api/health``'s ``last_incident`` serve them. No test starts the
evaluator thread without stopping (joining) it."""

import json
import os
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from deeplearning4j_tpu.common import faultinject as jfi
from deeplearning4j_tpu.common import flightrec as jfr
from deeplearning4j_tpu.common import watchtower as jwt
from deeplearning4j_tpu.common.profiler import OpProfiler as JProf
from deeplearning4j_tpu_torch.common import faultinject, flightrec, watchtower
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.common.watchtower import (
    OK, PAGE, WARN, Watchtower, counter_increment_sampler,
    counter_ratio_sampler, threshold_sampler)
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from torch_parity import modules

PKG = {"jax": SimpleNamespace(wt=jwt, fr=jfr, fi=jfi, prof=JProf),
       "torch": SimpleNamespace(wt=watchtower, fr=flightrec, fi=faultinject,
                                prof=OpProfiler)}


@pytest.fixture(autouse=True)
def _clean():
    for p in PKG.values():
        p.fi.clear_plan()
        p.fr.reset()
    yield
    for p in PKG.values():
        p.wt.uninstall()
        p.fi.clear_plan()


class _Script:
    """Sampler that replays a fixed list of readings (the last one sticks)."""

    def __init__(self, values):
        self.values = list(values)
        self.i = 0

    def __call__(self):
        v = self.values[min(self.i, len(self.values) - 1)]
        self.i += 1
        return v


def _slo(wt, name="t", sampler=None, **kw):
    base = dict(budget=0.1, fast_s=10.0, mid_s=30.0, slow_s=60.0,
                page_burn=2.0, warn_burn=1.5, clear_ticks=2, period_s=100.0)
    base.update(kw)
    return wt.SLO(name, sampler or _Script([False]), **base)


def _run(pkg, script, times, **kw):
    """One SLO script under an injected clock: per tick its state and
    burns, and the alert events' transitions."""
    p = PKG[pkg]
    t = p.wt.Watchtower([_slo(p.wt, sampler=_Script(script), **kw)])
    states = [t.evaluate_now(now=float(x))["states"]["t"] for x in times]
    trans = [(e["attrs"]["frm"], e["attrs"]["to"])
             for e in p.fr.events(prefix="watchtower/alert")]
    return states, trans


# --- the same scripts, the same transitions ---------------------------------

SCRIPTS = {
    "sustained": ([True] * 10, range(6), {}),
    "fast_then_mid": ([False] * 30 + [True] * 10, range(36),
                      {"warn_burn": 1e9}),
    "warn_only": ([True, True, False, False], (0.0, 1.0, 15.0, 16.0),
                  {"page_burn": 20.0}),
    "hysteresis": ([True, True, False], (0.0, 1.0, 40.0, 41.0), {}),
    "ratio_rebase": ([(5, 100), (6, 110), (2, 10), (3, 20)], range(4),
                     {"kind": "ratio"}),
    "flapping": ([True, False] * 10 + [False] * 10,
                 [0.5 * i for i in range(30)], {"clear_ticks": 3}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_transitions_as_jax(name):
    script, times, kw = SCRIPTS[name]
    assert _run("torch", script, times, **kw) == \
        _run("jax", script, times, **kw)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
class TestWindowMath:
    def test_window_burn_reads_window_start_sample(self, pkg):
        wt = PKG[pkg].wt
        samples = [(0.0, 0.0, 0.0), (1.0, 1.0, 2.0), (2.0, 1.0, 4.0),
                   (3.0, 3.0, 6.0)]
        assert wt._window_burn(samples, 3.0, 2.0, 0.1) == pytest.approx(
            ((3.0 - 1.0) / (6.0 - 2.0)) / 0.1)
        assert wt._window_burn(samples, 3.0, 100.0, 0.1) == pytest.approx(
            (3.0 / 6.0) / 0.1)
        assert wt._window_burn([], 0.0, 10.0, 0.1) == 0.0
        assert wt._window_burn([(0, 0, 0)], 0.0, 10.0, 0.1) == 0.0
        assert wt._window_burn([(0.0, 1.0, 5.0), (1.0, 1.0, 5.0)], 1.0,
                               10.0, 0.1) == 0.0

    def test_budget_remaining(self, pkg):
        wt = PKG[pkg].wt
        slo = _slo(wt, budget=0.1, period_s=100.0)
        st = wt._SloState()
        st.samples = [(0.0, 0.0, 0.0), (50.0, 5.0, 100.0)]
        assert wt.Watchtower._budget_remaining(slo, st, 50.0) == \
            pytest.approx(0.5)
        st.samples = [(0.0, 0.0, 0.0), (50.0, 50.0, 100.0)]
        assert wt.Watchtower._budget_remaining(slo, st, 50.0) == 0.0
        st.samples = [(0.0, 0.0, 0.0)]
        assert wt.Watchtower._budget_remaining(slo, st, 0.0) == 1.0

    def test_gauge_kind_accumulates_per_tick(self, pkg):
        wt = PKG[pkg].wt
        t = wt.Watchtower([_slo(wt, sampler=_Script([False, True, False]))])
        for i in range(3):
            r = t.evaluate_now(now=float(i))
        assert r["states"]["t"]["fast_burn"] == pytest.approx(
            (1.0 / 2.0) / 0.1)

    def test_sampler_exception_is_contained(self, pkg):
        wt = PKG[pkg].wt

        def boom():
            raise RuntimeError("sampler broke")

        t = wt.Watchtower([_slo(wt, name="good",
                                sampler=_Script([True, True])),
                           _slo(wt, name="bad", sampler=boom)])
        for i in range(2):
            r = t.evaluate_now(now=float(i))
        assert r["states"]["good"]["state"] == wt.PAGE
        assert r["states"]["bad"]["state"] == wt.OK

    def test_slo_validation(self, pkg):
        wt = PKG[pkg].wt
        with pytest.raises(ValueError, match="kind"):
            wt.SLO("x", _Script([0]), budget=0.1, kind="nope")
        with pytest.raises(ValueError, match="incident"):
            wt.SLO("x", _Script([0]), budget=0.1, incident="maybe")
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError, match="budget"):
                wt.SLO("x", _Script([0]), budget=bad)
        with pytest.raises(ValueError, match="duplicate"):
            wt.Watchtower([_slo(wt, name="a"), _slo(wt, name="a")])


def _counter(name):
    return OpProfiler.get().counter_value(name)


class TestSamplers:
    def test_counter_ratio_sampler_sums_counters(self):
        prof = OpProfiler.get()
        b0, t0 = _counter("wtst/bad"), _counter("wtst/total")
        s = counter_ratio_sampler(bad=("wtst/bad",), total=("wtst/total",))
        prof.count("wtst/bad")
        prof.count("wtst/total", 4)
        bad, total = s()
        assert (bad - b0, total - t0) == (1, 4)

    def test_counter_increment_sampler_arms_on_first_call(self):
        prof = OpProfiler.get()
        prof.count("wtst/incr")           # history before the tower
        s = counter_increment_sampler("wtst/incr")
        assert s() is False and s() is False
        prof.count("wtst/incr")
        assert s() is True and s() is False

    def test_threshold_sampler(self):
        vals = iter([None, 10.0, 99.0])
        s = threshold_sampler(lambda: next(vals), 50.0)
        assert [s(), s(), s()] == [False, False, True]

        def boom():
            raise RuntimeError

        assert threshold_sampler(boom, 1.0)() is False


# --- the state machine ----------------------------------------------------------

class TestBurnAlerting:
    def test_page_requires_fast_and_mid_windows(self):
        states, _ = _run("torch", [False] * 30 + [True] * 10, range(36),
                         warn_burn=1e9)
        assert states[31]["fast_burn"] >= 2.0 and states[31]["mid_burn"] < 2.0
        assert states[31]["state"] == states[34]["state"] == OK
        assert states[35]["mid_burn"] >= 2.0 and states[35]["state"] == PAGE

    def test_warn_on_mid_and_slow_without_page(self):
        pages0 = _counter("watchtower/pages")
        states, _ = _run("torch", [True, True, False, False],
                         (0.0, 1.0, 15.0, 16.0), page_burn=20.0)
        seen = [s["state"] for s in states]
        assert WARN in seen and PAGE not in seen
        assert _counter("watchtower/pages") == pages0

    def test_hysteresis_and_no_refire(self):
        states, trans = _run("torch", [True, True, False],
                             (0.0, 1.0, 40.0, 41.0))
        assert [s["state"] for s in states] == [OK, PAGE, PAGE, OK]
        assert trans == [("ok", "page"), ("page", "ok")]
        flightrec.reset()
        _, trans = _run("torch", [True] * 10, range(6))
        assert trans == [("ok", "page")]

    def test_alert_event_counters_and_gauge_roundtrip(self):
        pages0, clears0 = _counter("watchtower/pages"), \
            _counter("watchtower/clears")
        t = Watchtower([_slo(watchtower, name="rt",
                             sampler=_Script([True, True, False]),
                             clear_ticks=1)])
        for now in (0.0, 1.0, 40.0):
            t.evaluate_now(now=now)
        assert _counter("watchtower/pages") == pages0 + 1
        assert _counter("watchtower/clears") == clears0 + 1
        prof = OpProfiler.get()
        assert prof.counter_value("watchtower/alert_state/rt") == OK
        assert "watchtower/alert_state/rt" in prof.gauge_names()
        page = [e for e in flightrec.events(prefix="watchtower/alert")
                if e["attrs"]["to"] == "page"][0]
        assert page["sev"] == "error" and page["attrs"]["slo"] == "rt"
        assert page["attrs"]["fast_burn"] >= 2.0
        assert 0.0 <= page["attrs"]["budget_remaining"] <= 1.0


class TestLedgerAndPrometheus:
    def test_watchtower_ledger_rides_profiler_ledgers(self):
        t = watchtower.install(Watchtower([_slo(watchtower, name="led")]))
        t.evaluate_now(now=0.0)
        led = OpProfiler.get().ledger_stats()
        assert led["watchtower"]["slos"] == 1
        assert led["watchtower"]["state/led"] == OK
        assert "budget_remaining/led" in led["watchtower"]
        watchtower.uninstall()
        assert "watchtower" not in OpProfiler.get().ledger_stats()

    def test_alert_state_in_prometheus_text(self):
        from deeplearning4j_tpu_torch.ui.server import prometheus_text

        t = watchtower.install(Watchtower(
            [_slo(watchtower, name="prom", sampler=_Script([True] * 4))]))
        for i in range(2):
            t.evaluate_now(now=float(i))
        text = prometheus_text()
        assert "# TYPE dl4j_alert_state gauge" in text
        assert 'dl4j_alert_state{slo="prom"} 2' in text


# --- incidents --------------------------------------------------------------

def _model():
    m = modules("torch")
    conf = (m.NeuralNetConfiguration.builder().seed(5)
            .updater(m.Sgd(learning_rate=0.1)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=8))
            .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())
    return m.MultiLayerNetwork(conf).init(device="cpu")


def _it():
    rng = np.random.RandomState(7)
    x = rng.randn(64, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return NDArrayDataSetIterator(x, y, batch_size=16)


def _seed_synthetic_incident(pkg="torch", corr="inc1.a1"):
    p = PKG[pkg]
    fam = corr.split(".a", 1)[0]
    p.fr.event("fault/fired", severity="error", corr=corr,
               site="train/step", kind="crash")
    p.fr.event("supervisor/attempt_failed", severity="error", corr=corr,
               failure_class="device_failure", policy="restart")
    p.fr.event("supervisor/restart", severity="warn", corr=corr)
    p.fr.event("supervisor/attempt_start", severity="info",
               corr=f"{fam}.a2")
    return p.wt.note_supervisor_failure("device_failure", "restart",
                                        corr=corr, error="SimulatedCrash")


def _chain(path):
    with open(path) as f:
        rep = json.load(f)
    return rep, {k: (rep["chain"][k] or {}).get("name") for k in
                 ("cause", "detection", "mitigation", "recovery")}


@pytest.mark.parametrize("script", ["supervisor", "alert"])
def test_same_incident_chains_as_jax(tmp_path, script):
    """One incident script through both packages: the same index and the
    same cause -> detection -> mitigation -> recovery chain."""
    out = {}
    for pkg, p in PKG.items():
        d = tmp_path / pkg
        if script == "supervisor":
            tower = p.wt.install(p.wt.Watchtower([], incident_dir=str(d)))
            _seed_synthetic_incident(pkg)
            tower.evaluate_now(now=0.0)
        else:
            p.fr.event("fault/fired", severity="error",
                       site="serving/dispatch", kind="dead_replica")
            p.fr.event("serving/retire", severity="warn", replica=0)
            tower = p.wt.install(p.wt.Watchtower(
                [_slo(p.wt, name="avail",
                      sampler=_Script([True, True, False]))],
                incident_dir=str(d)))
            for now in (0.0, 1.0, 100.0, 101.0):
                tower.evaluate_now(now=now)
        idx = tower.incidents()
        rep, names = _chain(idx[0]["path"])
        out[pkg] = ([{k: i[k] for k in ("id", "kind", "slo", "corr",
                                         "finalized", "resolved")}
                     for i in idx], names, rep["complete"],
                    [a["slo"] for a in rep["alerts"]])
        p.wt.uninstall()
    assert out["torch"] == out["jax"]
    assert out["torch"][2] is True


class TestIncidents:
    def test_supervised_crash_drill_assembles_incident(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

        tower = watchtower.install(
            Watchtower([], incident_dir=str(tmp_path / "incidents")))
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "train/step", "index": 6, "kind": "crash"}]))
        sup = TrainingSupervisor(_model(), str(tmp_path / "ckpt"),
                                 save_every_n_iterations=4,
                                 backoff_base_s=0.01)
        res = sup.fit(_it, epochs=3, resume="never")
        assert res.status == "completed" and res.restarts == 1
        assert len(tower.incidents()) == 1
        tower.evaluate_now(now=0.0)
        idx = tower.incidents()[0]
        assert idx["kind"] == "supervisor" and idx["corr"].endswith(".a1")
        assert idx["finalized"] and idx["resolved"]
        rep, names = _chain(idx["path"])
        assert rep["complete"]
        assert names["cause"] == "fault/fired"
        assert names["detection"] == "supervisor/attempt_failed"
        assert rep["chain"]["detection"]["attrs"]["failure_class"] == \
            "device_failure"
        assert names["mitigation"] == "supervisor/restart"
        assert names["recovery"] in ("supervisor/attempt_start",
                                     "checkpoint/restore")
        seqs = [rep["chain"][k]["seq"] for k in
                ("cause", "detection", "mitigation", "recovery")]
        assert seqs == sorted(seqs)
        assert rep["blackbox"]["path"] == sup.blackbox_path()
        assert len(rep["blackbox"]["tail"]) > 0
        assert os.path.exists(sup.memcensus_path())
        assert "ledgers" in rep and "watermarks" in rep and "census" in rep
        assert any(e["name"] == "watchtower/incident"
                   for e in flightrec.events(prefix="watchtower/"))

    def test_second_fault_same_incarnation_anchors_its_own_attempt(
            self, tmp_path):
        tower = watchtower.install(Watchtower([], incident_dir=str(tmp_path)))
        _seed_synthetic_incident(corr="inc1.a1")
        tower.evaluate_now(now=0.0)
        flightrec.event("fault/fired", severity="error", corr="inc1.a3",
                        site="train/wedge", kind="wedge")
        flightrec.event("supervisor/watchdog_fire", severity="error",
                        corr="inc1.a3")
        flightrec.event("supervisor/restart", severity="warn",
                        corr="inc1.a3")
        watchtower.note_supervisor_failure("hang", "restart", corr="inc1.a3")
        incs = tower.incidents()
        assert len(incs) == 2
        rep, names = _chain(incs[0]["path"])
        assert rep["chain"]["cause"]["corr"] == "inc1.a3"
        assert rep["chain"]["cause"]["attrs"]["site"] == "train/wedge"
        assert names["detection"] == "supervisor/watchdog_fire"

    def test_recycled_corr_across_fresh_supervisors(self, tmp_path):
        tower = watchtower.install(Watchtower([], incident_dir=str(tmp_path),
                                              interval_s=0.1))
        _seed_synthetic_incident(corr="inc1.a1")
        tower.evaluate_now(now=0.0)
        time.sleep(1.2)          # past the detection scan's floor
        flightrec.event("fault/fired", severity="error", corr="inc1.a1",
                        site="device/loss", kind="device_loss")
        flightrec.event("supervisor/attempt_failed", severity="error",
                        corr="inc1.a1", failure_class="device_failure",
                        policy="restart")
        flightrec.event("supervisor/restart", severity="warn",
                        corr="inc1.a1")
        watchtower.note_supervisor_failure("device_failure", "restart",
                                           corr="inc1.a1")
        incs = tower.incidents()
        assert len(incs) == 2
        rep, names = _chain(incs[0]["path"])
        assert rep["chain"]["cause"]["attrs"]["site"] == "device/loss"
        assert names["detection"] == "supervisor/attempt_failed"
        assert rep["chain"]["detection"]["seq"] > rep["chain"]["cause"]["seq"]

    def test_alert_incident_lifecycle_completes_on_clear(self, tmp_path):
        flightrec.event("fault/fired", severity="error",
                        site="serving/dispatch", kind="dead_replica")
        flightrec.event("serving/retire", severity="warn", replica=0)
        tower = watchtower.install(Watchtower(
            [_slo(watchtower, name="avail",
                  sampler=_Script([True, True, False]), clear_ticks=2)],
            incident_dir=str(tmp_path)))
        tower.evaluate_now(now=0.0)
        tower.evaluate_now(now=1.0)
        incs = tower.incidents()
        assert len(incs) == 1 and incs[0]["kind"] == "alert"
        assert incs[0]["slo"] == "avail" and not incs[0]["finalized"]
        rep, names = _chain(incs[0]["path"])
        assert not rep["complete"]
        assert rep["chain"]["detection"]["attrs"]["to"] == "page"
        assert names["mitigation"] == "serving/retire"
        tower.evaluate_now(now=100.0)
        tower.evaluate_now(now=101.0)
        idx = tower.incidents()[0]
        assert idx["finalized"] and idx["resolved"]
        rep, names = _chain(idx["path"])
        assert rep["complete"] and names["recovery"] == "watchtower/alert"
        assert rep["chain"]["recovery"]["attrs"]["to"] == "ok"

    def test_incident_dedup_and_attach(self, tmp_path):
        tower = watchtower.install(Watchtower(
            [], incident_dir=str(tmp_path), finalize_after_s=1e9))
        assert tower.assemble_incident("alert", "nan page",
                                       slo="train-nan-free",
                                       attach_only=True) is None
        assert tower.incidents() == []
        watchtower.note_supervisor_failure("device_failure", "restart",
                                           corr="inc7.a1")
        p = tower.assemble_incident("alert", "train-nan-free page",
                                    slo="train-nan-free", corr="inc7.a2",
                                    attach_only=True)
        assert p == tower.incidents()[0]["path"]
        assert len(tower.incidents()) == 1
        rep, _ = _chain(p)
        assert any(a["slo"] == "train-nan-free" for a in rep["alerts"])
        watchtower.note_supervisor_failure("hang", "restart", corr="inc7.a2")
        assert len(tower.incidents()) == 1
        watchtower.note_supervisor_failure("device_failure", "restart",
                                           corr="inc8.a1")
        assert len(tower.incidents()) == 2
        tower.assemble_incident("alert", "latency page", slo="lat-gold")
        tower.assemble_incident("alert", "latency page", slo="lat-gold")
        assert len(tower.incidents()) == 3

    def test_finalize_timeout_leaves_unresolved(self, tmp_path):
        tower = watchtower.install(Watchtower(
            [], incident_dir=str(tmp_path), finalize_after_s=0.0))
        watchtower.note_supervisor_failure("mystery", "restart",
                                           corr="inc9.a1")
        tower.evaluate_now(now=0.0)
        idx = tower.incidents()[0]
        assert idx["finalized"] and not idx["resolved"]

    def test_last_incident_blackbox_fallback(self, tmp_path):
        assert watchtower.get() is None
        assert watchtower.note_supervisor_failure("x", "restart") is None
        bb = tmp_path / "blackbox.jsonl"
        bb.write_text(json.dumps({"name": "fault/fired"}) + "\n" +
                      json.dumps({"name": "supervisor/restart"}) + "\n")
        watchtower.note_blackbox(str(bb))
        li = watchtower.last_incident()
        assert li["kind"] == "blackbox" and li["path"] == str(bb)
        assert [e["name"] for e in li["tail"]] == \
            ["fault/fired", "supervisor/restart"]


class TestHttpSurface:
    def test_incidents_trace_and_health_endpoints(self, tmp_path):
        from deeplearning4j_tpu_torch.ui.server import UIServer

        tower = watchtower.install(Watchtower([], incident_dir=str(tmp_path)))
        _seed_synthetic_incident(corr="inc1.a1")
        tower.evaluate_now(now=0.0)
        ui = UIServer()
        port = ui.enable(0)
        try:
            def get(path):
                return urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}", timeout=15)

            idx = json.load(get("/api/incidents"))
            assert len(idx) == 1 and idx[0]["id"] == "0001"
            assert idx[0]["finalized"]
            rep = json.load(get(f"/api/incidents?id={idx[0]['id']}"))
            assert rep["complete"]
            assert rep["chain"]["mitigation"]["name"] == "supervisor/restart"
            with pytest.raises(urllib.error.HTTPError) as ei:
                get("/api/incidents?id=9999")
            assert ei.value.code == 404
            doc = json.load(get("/api/trace"))
            names = {e["name"] for e in doc["traceEvents"]}
            assert {"fault/fired", "watchtower/incident"} <= names
            narrowed = json.load(get("/api/trace?corr=inc1.a1"))
            rows = [e for e in narrowed["traceEvents"] if e["ph"] != "M"]
            assert rows and all(e["args"]["corr"] == "inc1.a1" for e in rows)
            li = json.load(get("/api/health"))["last_incident"]
            assert li["path"].endswith("incident-0001.json")
            assert li["tail"]["complete"]
            assert li["tail"]["chain"]["cause"]["name"] == "fault/fired"
        finally:
            ui.stop()


class TestEvaluationFaultDrill:
    def test_transient_fault_skips_one_tick_only(self):
        skipped0 = _counter("watchtower/skipped_evals")
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "watchtower/evaluate", "index": 1,
              "kind": "transient"}]))
        t = Watchtower([_slo(watchtower, sampler=_Script([True] * 5))])
        r0, r1, r2 = (t.evaluate_now(now=float(i)) for i in range(3))
        assert not r0["skipped"] and not r2["skipped"]
        assert r1["skipped"] and r1["states"] == {}
        assert _counter("watchtower/skipped_evals") == skipped0 + 1
        assert t.stats()["skipped_evals"] == 1
        assert t.stats()["evaluations"] == 3
        assert r2["states"]["t"]["state"] == PAGE


class TestThreadDisabledAndFacade:
    def test_evaluator_thread_ticks_and_joins(self):
        t = Watchtower([_slo(watchtower, sampler=_Script([True] * 1000),
                             fast_s=0.2, mid_s=0.4, slow_s=0.8)],
                       interval_s=0.01)
        t.start()
        try:
            deadline = time.monotonic() + 10.0
            while t.alert_states()["t"] != PAGE and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            t.stop()
        assert t._thread is None and t.alert_states()["t"] == PAGE
        assert t.stats()["evaluations"] >= 2

    def test_disabled_tower_is_inert(self, tmp_path):
        evals0 = _counter("watchtower/evaluations")
        t = Watchtower([_slo(watchtower, sampler=_Script([True] * 5))],
                       incident_dir=str(tmp_path), enabled=False)
        r = t.evaluate_now(now=0.0)
        assert r["skipped"] and r["states"] == {}
        assert _counter("watchtower/evaluations") == evals0
        assert t.assemble_incident("alert", "x", slo="s") is None
        assert not os.listdir(str(tmp_path))
        t.configure(enabled=True)
        assert not t.evaluate_now(now=1.0)["skipped"]

    def test_facade_is_empty_without_tower(self):
        assert watchtower.get() is None
        assert watchtower.stats() == {} and watchtower.alert_states() == {}
        assert watchtower.incidents() == []
        assert "watchtower" not in OpProfiler.get().ledger_stats()


class TestDefaultCatalog:
    def test_default_slos_are_the_jax_catalog(self):
        got = {s.name: (s.kind, s.incident, s.budget)
               for s in watchtower.default_slos()}
        want = {s.name: (s.kind, s.incident, s.budget)
                for s in jwt.default_slos()}
        assert got == want
        assert set(got) == {"serving-availability", "train-nan-free",
                            "restart-budget", "retrace-flat",
                            "replica-consistency"}

    def test_default_slos_with_engine_and_hbm_ceiling(self):
        class _Cls:
            def __init__(self, name, p99):
                self.name, self.p99_ms = name, p99

        class _Eng:
            def slo_classes(self):
                return [_Cls("gold", 250.0), _Cls("batch", 1000.0)]

            def class_recent_p99(self, name):
                return 300.0

        slos = watchtower.default_slos(engine=_Eng(), hbm_ceiling_bytes=1e9,
                                       fast_s=10.0, mid_s=30.0, slow_s=60.0,
                                       period_s=100.0)
        assert {"latency-gold", "latency-batch", "hbm-ceiling"} <= \
            {s.name for s in slos}
        t = Watchtower(slos)
        for i in range(3):
            r = t.evaluate_now(now=float(i))
        assert r["states"]["latency-gold"]["state"] == PAGE
        assert r["states"]["latency-batch"]["state"] == OK


class TestServingClassLatency:
    def test_per_class_quantiles_and_the_latency_slo(self):
        from deeplearning4j_tpu_torch.parallel import ServingEngine, SLOClass
        from deeplearning4j_tpu_torch.parallel.serving import serving_health
        from deeplearning4j_tpu_torch.ui.server import prometheus_text

        m = modules("torch")
        conf = (m.NeuralNetConfiguration.builder().seed(1)
                .updater(m.Sgd(learning_rate=0.05)).activation("tanh").list()
                .layer(m.L.DenseLayer(n_out=8))
                .layer(m.L.OutputLayer(n_out=3))
                .set_input_type(m.InputType.feed_forward(4)).build())
        model = m.MultiLayerNetwork(conf).init(device="cpu")
        eng = (ServingEngine.Builder(model).buckets((1, 2, 4))
               .input_shape((4,)).workers(1).max_wait_ms(2.0)
               .request_timeout_ms(15000).devices(["cpu"])
               .slo_classes([SLOClass("gold", 2, 250.0, queue_budget=64),
                             SLOClass("batch", 0, 1000.0, queue_budget=32)])
               .brownout(interval_s=60.0).build())
        try:
            x = np.zeros((1, 4), np.float32)
            for _ in range(6):
                eng.output(x, slo_class="gold")
            for _ in range(3):
                eng.output(x, slo_class="batch")
            cl = eng.class_latency_stats()
            assert 0.0 < cl["gold"]["p50_ms"] <= cl["gold"]["p99_ms"]
            assert cl["batch"]["window"] == 3
            assert eng.class_recent_p99("gold") > 0.0
            assert eng.class_recent_p99("batch") is None   # 3 < 5 samples
            assert serving_health()["class_latency"]["gold"]["p99_ms"] > 0
            assert 'dl4j_serving_latency_ms{class="gold",quantile="0.99"}' \
                in prometheus_text()
            # the watchtower's latency SLO reads the engine's public p99
            slos = {s.name: s for s in watchtower.default_slos(engine=eng)}
            assert slos["latency-gold"].sampler() is False     # under 250
        finally:
            eng.shutdown()
