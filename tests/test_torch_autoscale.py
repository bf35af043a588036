"""The port's overload control and elastic serving on the CPU: SLO-class
admission (shed order, queue budgets, Retry-After), the brownout
controller's and the autoscaler's control laws against the JAX package's
(fed the same signal sequences, decisions equal), ``scale_to``, and the
canaried publication (promote, and rollback bitwise)."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu.parallel import AutoscalePolicy as JPolicy
from deeplearning4j_tpu.parallel import Autoscaler as JScaler
from deeplearning4j_tpu.parallel import BrownoutController as JBrownout
from deeplearning4j_tpu.parallel import Overloaded as JOverloaded
from deeplearning4j_tpu.parallel import SLOClass as JSLO
from deeplearning4j_tpu.parallel.serving import \
    AdmissionController as JAdmission
from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize import CheckpointListener
from deeplearning4j_tpu_torch.parallel import (AdmissionController,
                                               AutoscalePolicy, Autoscaler,
                                               BrownoutController,
                                               Overloaded, ServingEngine,
                                               SLOClass)
from deeplearning4j_tpu_torch.parallel.serving import \
    next_publication_ordinal
from deeplearning4j_tpu_torch.util.checkpoint import (committed_checkpoints,
                                                      read_checkpoint_params,
                                                      tree_leaves)
from torch_parity import modules

CLASSES = (("gold", 2, 250.0, 64), ("silver", 1, 400.0, 32),
           ("batch", 0, 1000.0, 32))


def mlp(seed=1):
    m = modules("torch")
    conf = (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(m.Adam(0.05)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=3))
            .set_input_type(m.InputType.feed_forward(4)).build())
    return m.MultiLayerNetwork(conf).init(device="cpu")


def build(model=None, workers=1, classes=True, **kw):
    b = (ServingEngine.Builder(model or mlp()).buckets((1, 2, 4, 8))
         .input_shape((4,)).workers(workers).max_wait_ms(2.0)
         .request_timeout_ms(15000).resurrect_dead_replicas(True,
                                                            backoff_ms=50))
    if kw.pop("pin", False):
        b.pin_devices(True).devices(["cpu"] * workers)
    if classes:
        b.slo_classes([SLOClass(*c) for c in CLASSES])
        # a long interval: tests drive levels and evaluations themselves
        b.brownout(interval_s=kw.pop("brownout_interval_s", 60.0))
    assert not kw, kw
    return b.build()


def wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.fixture(autouse=True)
def _clean():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Two committed checkpoints of the serving MLP's configuration with
    different trained weights, written by the port's CheckpointListener."""
    d = str(tmp_path_factory.mktemp("torch_autoscale_ckpts"))
    m = mlp(seed=9)
    rng = np.random.RandomState(3)
    x = rng.randn(32, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    cl = CheckpointListener(d, save_every_n_iterations=2, keep_last=4)
    m.set_listeners(cl)
    m.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2)
    cl.close()
    paths = committed_checkpoints(d)
    assert len(paths) >= 2
    return paths[-2:]


def slot_leaves(eng, slot=0):
    p, s = eng._dev_params[slot]
    return [t.clone() for t in tree_leaves(p) + tree_leaves(s)]


class TestAdmission:
    def test_validation_alike(self):
        for slo, adm in ((SLOClass, AdmissionController),
                         (JSLO, JAdmission)):
            with pytest.raises(ValueError, match="p99_ms"):
                slo("x", 0, 0.0)
            with pytest.raises(ValueError, match="duplicate"):
                adm([slo("a", 0, 1), slo("a", 1, 1)])
            with pytest.raises(ValueError, match="priorities must be"):
                adm([slo("a", 0, 1), slo("b", 0, 1)])
            with pytest.raises(ValueError, match="default"):
                adm([slo("a", 0, 1)], default="nope")
            a = adm([slo(*c) for c in CLASSES])
            assert a.top.name == "gold" and a.default == "gold"
            with pytest.raises(ValueError, match="unknown SLO class"):
                a.resolve("platinum")

    @settings(max_examples=40, deadline=None)
    @given(ops=st.lists(st.tuples(
        st.sampled_from(["level", "admit", "done"]),
        st.integers(0, 5), st.sampled_from(["gold", "silver", "batch"])),
        min_size=1, max_size=40))
    def test_shed_decisions_equal_jax(self, ops):
        t = AdmissionController([SLOClass(n, p, q, 3)
                                 for n, p, q, _ in CLASSES])
        j = JAdmission([JSLO(n, p, q, 3) for n, p, q, _ in CLASSES])
        for op, k, name in ops:
            res = []
            for a, over in ((t, Overloaded), (j, JOverloaded)):
                if op == "level":
                    res.append(a.set_level(k, reason="test"))
                elif op == "admit":
                    try:
                        a.admit(a.by_name[name], n_chunks=1 + k % 2)
                        res.append("admitted")
                    except over as e:
                        res.append((e.reason, e.slo_class))
                else:
                    a.note_done(name)
                    res.append(None)
                res.append((a.shed_names(), a.stats()["outstanding"]))
            assert res[:2] == res[2:]

    def test_retry_after_from_the_drain_rate_alike(self):
        t = AdmissionController([SLOClass(*c) for c in CLASSES])
        j = JAdmission([JSLO(*c) for c in CLASSES])
        assert t.retry_after_s() == pytest.approx(j.retry_after_s())
        assert 0 < t.retry_after_s() <= 30.0
        now = time.monotonic()
        for a in (t, j):
            for _ in range(50):
                a._done.append(now)
            for _ in range(20):
                a.note_queued("gold")
        ra = t.retry_after_s()          # 20 / (50 / 5 s) = 2 s
        assert ra == pytest.approx(j.retry_after_s()) == pytest.approx(2.0)
        for a in (t, j):
            for _ in range(20):
                a.note_queued("silver")
        assert t.retry_after_s() == pytest.approx(j.retry_after_s())
        assert t.retry_after_s() > ra * 1.5

    def test_engine_sheds_strictly_lowest_class_first(self):
        prof = OpProfiler.get()
        eng = build()
        x = np.zeros((1, 4), np.float32)
        try:
            adm = eng._adm
            g0 = prof.counter_value("serving/shed/gold")
            flightrec.reset()
            assert adm.set_level(1, reason="drill") == 1
            assert flightrec.events("serving/shed")
            with pytest.raises(Overloaded) as ei:
                eng.output(x, slo_class="batch")
            assert ei.value.reason == "brownout"
            assert 0.1 <= ei.value.retry_after_s <= 30.0
            eng.output(x, slo_class="silver")
            eng.output(x, slo_class="gold")
            assert adm.set_level(2, reason="drill") == 2
            with pytest.raises(Overloaded):
                eng.output(x, slo_class="silver")
            eng.output(x, slo_class="gold")
            assert adm.set_level(99, reason="drill") == 2   # clamped
            eng.output(x)                                   # default gold
            assert prof.counter_value("serving/shed/gold") == g0
            stats = eng.serving_stats()["admission"]
            assert stats["level"] == 2 and stats["shed"] == ["batch",
                                                             "silver"]
            adm.set_level(1, reason="drill over")
            adm.set_level(0, reason="drill over")
            levels = [(e["attrs"]["prev"], e["attrs"]["level"])
                      for e in flightrec.events("serving/shed")]
            assert levels == [(0, 1), (1, 2), (2, 1), (1, 0)]
        finally:
            eng.shutdown()

    def test_queue_budget_backpressure(self):
        eng = build()
        x = np.zeros((1, 4), np.float32)
        try:
            eng._adm.by_name["batch"].queue_budget = 2
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/dispatch", "kind": "slow",
                  "seconds": 0.2, "times": 4}]))
            futs = [eng.output_async(x, slo_class="batch")
                    for _ in range(2)]
            with pytest.raises(Overloaded) as ei:
                eng.output_async(x, slo_class="batch")
            assert ei.value.reason == "queue_budget"
            eng.output_async(x, slo_class="gold").result(timeout=15)
            for f in futs:
                f.result(timeout=15)
            faultinject.clear_plan()
            eng.output(x, slo_class="batch")          # budget freed
        finally:
            eng.shutdown()

    def test_admission_fault_sheds_exactly_that_request(self):
        eng = build()
        x = np.zeros((1, 4), np.float32)
        try:
            base = eng._admit_seq
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/admission", "kind": "transient",
                  "index": base + 1}]))
            eng.output(x, slo_class="gold")
            with pytest.raises(Overloaded) as ei:
                eng.output(x, slo_class="gold")
            assert ei.value.reason == "fault"
            eng.output(x, slo_class="gold")
        finally:
            eng.shutdown()


SIGNALS = st.lists(st.tuples(st.one_of(st.none(),
                                       st.floats(0.0, 1000.0)),
                             st.integers(0, 40)), min_size=1, max_size=40)


class TestControlLaws:
    @settings(max_examples=50, deadline=None)
    @given(seq=SIGNALS, clear=st.integers(1, 4),
           frac=st.sampled_from([0.5, 0.7, 0.9]))
    def test_brownout_evaluate_equal_jax(self, seq, clear, frac):
        t_adm = AdmissionController([SLOClass(*c) for c in CLASSES])
        j_adm = JAdmission([JSLO(*c) for c in CLASSES])
        t = BrownoutController(None, t_adm, depth_trigger=10,
                               clear_ticks=clear, hysteresis_frac=frac)
        j = JBrownout(None, j_adm, depth_trigger=10, clear_ticks=clear,
                      hysteresis_frac=frac)
        for p99, depth in seq:
            assert t.evaluate(p99, depth) == j.evaluate(p99, depth)
            assert t_adm.shed_names() == j_adm.shed_names()

    def test_brownout_hysteresis_raises_fast_clears_slow(self):
        adm = AdmissionController([SLOClass(*c) for c in CLASSES])
        ctl = BrownoutController(None, adm, depth_trigger=10, clear_ticks=3)
        assert ctl.evaluate(p99_ms=500.0, depth=0) == 1
        assert ctl.evaluate(p99_ms=None, depth=50) == 2
        assert ctl.evaluate(p99_ms=2500.0, depth=999) == 2  # gold never
        for want in (2, 2, 1):
            assert ctl.evaluate(p99_ms=100.0, depth=0) == want

    @settings(max_examples=50, deadline=None)
    @given(steps=st.lists(st.tuples(
        st.integers(1, 6), st.integers(0, 20),
        st.one_of(st.none(), st.floats(0.0, 400.0)),
        st.floats(0.0, 5.0), st.one_of(st.none(), st.floats(0.0, 1.0)),
        st.floats(0.0, 2.0)), min_size=1, max_size=30))
    def test_autoscaler_decide_equal_jax(self, steps):
        kw = dict(min_workers=1, max_workers=4, up_queue_depth=8,
                  up_p99_frac=0.8, down_idle_s=2.0, down_fill_frac=0.25,
                  cooldown_up_s=1.0, cooldown_down_s=3.0)
        t, j = Autoscaler(None, AutoscalePolicy(**kw)), JScaler(
            None, JPolicy(**kw))
        now = 1000.0
        for alive, hwm, p99, idle, fill, dt in steps:
            now += dt
            sig = {"alive": alive, "queue_hwm": hwm, "p99_ms": p99,
                   "top_budget_ms": 250.0, "idle_s": idle,
                   "fill_ratio": fill}
            dt_, dj = t.decide(sig, now=now), j.decide(sig, now=now)
            assert dt_ == dj
            # commit the cooldown state as tick() would
            for a in (t, j):
                if dt_["target"] > alive:
                    a._last_up_t = now
                elif dt_["target"] < alive:
                    a._last_down_t = now

    def test_decide_cases(self):
        a = Autoscaler(None, AutoscalePolicy(min_workers=1, max_workers=4))
        d = {"alive": 2, "queue_hwm": 0, "p99_ms": None,
             "top_budget_ms": 250.0, "idle_s": 0.0, "fill_ratio": 0.9}
        assert a.decide(d)["target"] == 2
        assert a.decide({**d, "queue_hwm": 8})["target"] == 3
        assert a.decide({**d, "p99_ms": 240.0})["target"] == 3
        assert a.decide({**d, "queue_hwm": 8, "alive": 4})["target"] == 4
        assert a.decide({**d, "idle_s": 3.0})["target"] == 1
        assert a.decide({**d, "fill_ratio": 0.1})["target"] == 1
        now = time.monotonic()
        a._last_up_t = now
        assert a.decide({**d, "queue_hwm": 8},
                        now=now + 0.5)["reason"] == "cooldown_up"
        assert a.decide({**d, "idle_s": 3.0},
                        now=now + 1.0)["reason"] == "cooldown_down"

    def test_policy_bounds(self):
        with pytest.raises(ValueError, match="max_workers"):
            AutoscalePolicy(min_workers=3, max_workers=2)


class TestScaling:
    def test_scale_to_up_and_down_with_no_new_warmup(self):
        prof = OpProfiler.get()
        eng = build(workers=1, classes=False)
        x = np.random.randn(3, 4).astype(np.float32)
        try:
            eng.output(x)
            traces0 = prof.counter_value("trace/serving_infer")
            assert eng.scale_to(3, reason="test") == 3
            assert wait_for(lambda: eng.alive_replicas() == 3)
            for _ in range(6):
                eng.output(x)
            assert prof.counter_value("trace/serving_infer") == traces0
            eng.scale_to(1, reason="test")
            assert wait_for(lambda: eng.alive_replicas() == 1)
            stats = eng.pool_stats()
            assert stats["alive"] == 1 and stats["target"] == 1
            assert stats["scaled_down"] == 2
            eng.output(x)
        finally:
            eng.shutdown()

    def test_tick_scales_up_on_a_backlog_then_down_when_idle(self):
        prof = OpProfiler.get()
        eng = build(workers=1, classes=False)
        try:
            eng._qwin_s = 0.1
            a = Autoscaler(eng, AutoscalePolicy(
                min_workers=1, max_workers=2, up_queue_depth=4,
                down_idle_s=0.1, cooldown_up_s=0.0, cooldown_down_s=0.0))
            eng._qwin_update(6)
            flightrec.reset()
            assert a.tick() == 2
            assert wait_for(lambda: eng.alive_replicas() == 2)
            dec = flightrec.events("autoscale/decide")[0]
            assert dec["attrs"]["queue_hwm"] == 6
            assert flightrec.events("autoscale/scale")
            time.sleep(0.25)
            assert a.tick() == 1
            assert wait_for(lambda: eng.alive_replicas() == 1)
            ledger = prof.autoscale_stats()
            assert ledger["replicas"] == 1 and ledger["scale_downs"] >= 1
            assert "autoscale" in prof.ledger_stats()
        finally:
            eng.shutdown()

    def test_decide_fault_skips_one_tick_and_the_loop_runs(self):
        prof = OpProfiler.get()
        eng = build(workers=1, classes=False)
        a = Autoscaler(eng, AutoscalePolicy(min_workers=1, max_workers=2,
                                            interval_s=0.05))
        try:
            e0 = prof.counter_value("autoscale/decide_errors")
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "autoscale/decide", "kind": "transient",
                  "index": 0}]))
            assert a.tick() is None
            assert prof.counter_value("autoscale/decide_errors") == e0 + 1
            t0 = prof.counter_value("autoscale/ticks")
            a.start()
            assert wait_for(lambda: prof.counter_value("autoscale/ticks")
                            >= t0 + 2)
        finally:
            a.stop()
            eng.shutdown()
        assert a._thread is None


class TestCanaryPublish:
    def test_promote_serves_the_checkpoint_and_leaves_the_chain(self, ckpts):
        prof = OpProfiler.get()
        eng = build(workers=2, classes=True, pin=True)
        x = np.random.randn(2, 4).astype(np.float32)
        try:
            eng.output(x)
            traces0 = prof.counter_value("trace/serving_infer")
            flightrec.reset()
            h = eng.publish_checkpoint(ckpts[0], canary_window_s=0.3,
                                       confirm_window_s=0.3,
                                       check_interval_s=0.05)
            assert h.corr.startswith("pub")
            deadline = time.monotonic() + 10
            while not h.done and time.monotonic() < deadline:
                eng.output(x, slo_class="gold")
            assert h.result(timeout=10) == "promoted"
            want_p, want_s = read_checkpoint_params(
                ckpts[0], eng.model._params, eng.model._states)
            want = tree_leaves(want_p) + tree_leaves(want_s)
            for slot in (0, 1):
                got = slot_leaves(eng, slot)
                assert len(got) == len(want)
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            assert prof.counter_value("trace/serving_infer") == traces0
            chain = [e["name"] for e in flightrec.events(corr=h.corr)]
            assert chain == ["serving/canary", "serving/promote"]
            ev = flightrec.events("serving/canary", corr=h.corr)[0]
            assert ev["attrs"]["file"] == os.path.basename(ckpts[0])
            assert eng.serving_stats()["canary_phase"] == "idle"
            eng.refresh_params()             # allowed once resolved
        finally:
            eng.shutdown()

    def test_forced_violation_rolls_back_bitwise(self, ckpts):
        prof = OpProfiler.get()
        eng = build(workers=2, classes=True)
        x = np.random.randn(2, 4).astype(np.float32)
        try:
            eng.output(x, slo_class="gold")
            prior = slot_leaves(eng)
            prior_obj = eng._dev_params[0]
            ordinal = next_publication_ordinal()
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/promote", "kind": "transient",
                  "index": ordinal}]))
            flightrec.reset()
            h = eng.publish_checkpoint(ckpts[1], canary_window_s=0.25,
                                       confirm_window_s=2.0,
                                       check_interval_s=0.05)
            failures = []
            deadline = time.monotonic() + 10
            while not h.done and time.monotonic() < deadline:
                try:
                    eng.output(x, slo_class="gold")
                except Exception as e:           # the drill's census
                    failures.append(e)
            assert h.result(timeout=10) == "rolled_back"
            assert not failures
            after = slot_leaves(eng)
            assert all(torch.equal(a, b) for a, b in zip(after, prior))
            assert eng._dev_params[0] is prior_obj   # the very tensors
            names = [e["name"] for e in flightrec.events(corr=h.corr)]
            assert names == ["serving/canary", "serving/promote",
                             "serving/rollback"]
            rb = flightrec.events("serving/rollback", corr=h.corr)[0]
            assert rb["attrs"]["phase"] == "confirm"
            assert prof.counter_value("faults/serving/promote/transient") \
                >= 1
        finally:
            eng.shutdown()

    def test_canary_violation_aborts_before_promote(self, ckpts):
        eng = build(workers=1, classes=True)
        x = np.random.randn(1, 4).astype(np.float32)
        try:
            fleet = eng._dev_params[0]
            h = eng.publish_checkpoint(ckpts[0], canary_window_s=5.0,
                                       check_interval_s=0.05, min_samples=1,
                                       violation_p99_ms=1e-6)
            deadline = time.monotonic() + 10
            while not h.done and time.monotonic() < deadline:
                eng.output(x, slo_class="gold")
            assert h.result(timeout=10) == "rolled_back"
            assert eng._dev_params[0] is fleet
            rb = flightrec.events("serving/rollback", corr=h.corr)[0]
            assert rb["attrs"]["phase"] == "canary"
        finally:
            eng.shutdown()

    def test_idle_canary_rolls_back_untested_weights(self, ckpts):
        eng = build(workers=1, classes=True)
        try:
            before = eng._dev_params[0]
            h = eng.publish_checkpoint(ckpts[0], canary_window_s=0.2,
                                       check_interval_s=0.05)
            assert h.result(timeout=10) == "rolled_back"
            assert eng._dev_params[0] is before
            rb = flightrec.events("serving/rollback", corr=h.corr)[0]
            assert "insufficient canary evidence" in rb["attrs"]["reason"]
        finally:
            eng.shutdown()

    def test_refresh_refused_mid_publication(self, ckpts):
        eng = build(workers=1, classes=False)
        try:
            h = eng.publish_checkpoint(ckpts[0], canary_window_s=0.3,
                                       confirm_window_s=0.1,
                                       check_interval_s=0.05)
            with pytest.raises(RuntimeError, match="refresh_params refused"):
                eng.refresh_params()
            with pytest.raises(RuntimeError, match="still in flight"):
                eng.publish_checkpoint(ckpts[1])
            assert h.result(timeout=10) == "promoted"
        finally:
            eng.shutdown()

    def test_shutdown_resolves_a_live_publication(self, ckpts):
        eng = build(workers=1, classes=False)
        try:
            h = eng.publish_checkpoint(ckpts[0], canary_window_s=5.0,
                                       check_interval_s=0.05)
        finally:
            eng.shutdown()
        assert h.result(timeout=5) == "rolled_back"
        assert all(not t.is_alive() for t in eng._pub_threads)


class TestHttp429:
    def test_429_with_retry_after_while_batch_is_shed(self):
        from deeplearning4j_tpu_torch.ui.server import UIServer

        eng = build()
        ui = UIServer().attach_serving(eng)
        port = ui.enable(0)

        def post(payload):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/infer",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=15)

        x = np.zeros((1, 4), np.float32).tolist()
        try:
            eng._adm.set_level(2, reason="http drill")
            with pytest.raises(urllib.error.HTTPError) as ei:
                post({"inputs": x, "slo_class": "batch"})
            assert ei.value.code == 429
            assert 1 <= int(ei.value.headers["Retry-After"]) <= 30
            assert "shed" in ei.value.read().decode()
            with post({"inputs": x, "slo_class": "gold"}) as r:
                assert json.loads(r.read())["shape"] == [1, 3]
            with pytest.raises(urllib.error.HTTPError) as ei:
                post({"inputs": x, "slo_class": "platinum"})
            assert ei.value.code == 400
        finally:
            ui.stop()
            ui.detach_all()
            eng.shutdown()
