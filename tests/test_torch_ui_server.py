"""The port's UI server (deeplearning4j_tpu_torch/ui/server.py) on the CPU:
``POST /api/infer`` with its codes (200, 400, 413, 429, 503, 504), health,
metrics, trace and incidents; the remote stats router; the JSONL tail cache
and the Prometheus exposition against the JAX package's; the graph log."""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ui import server as jserver
from deeplearning4j_tpu_torch.common import faultinject, flightrec, watchtower
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.parallel import ServingEngine, SLOClass
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         InMemoryStatsStorage,
                                         RemoteUIStatsStorageRouter,
                                         UIServer, prometheus_text)
from deeplearning4j_tpu_torch.ui import server as tserver
from deeplearning4j_tpu_torch.ui.graph_log import (LogFileWriter,
                                                   graph_structure,
                                                   read_graph_log)
from torch_parity import modules


def mlp():
    m = modules("torch")
    conf = (m.NeuralNetConfiguration.builder().seed(1)
            .updater(m.Adam(0.05)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=3))
            .set_input_type(m.InputType.feed_forward(4)).build())
    return m.MultiLayerNetwork(conf).init(device="cpu")


def engine(**kw):
    b = (ServingEngine.Builder(mlp()).buckets((1, 2, 4),
                                              oversize="reject")
         .input_shape((4,)).max_wait_ms(2.0)
         .request_timeout_ms(kw.pop("timeout_ms", 15000)))
    if kw.pop("classes", False):
        b.slo_classes([SLOClass("gold", 2, 250.0), SLOClass("batch", 0,
                                                            1000.0)])
        b.brownout(interval_s=60.0)
    assert not kw
    return b.build()


def post(base, payload=None, raw=None, path="/api/infer"):
    req = urllib.request.Request(
        base + path,
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=15)


def code_of(base, payload=None, raw=None):
    try:
        with post(base, payload, raw):
            return 200, None
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Retry-After")


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=15) as r:
        return r.read()


@pytest.fixture
def served():
    faultinject.clear_plan()
    eng = engine(classes=True)
    ui = UIServer().attach_serving(eng)
    base = f"http://127.0.0.1:{ui.enable(0)}"
    try:
        yield eng, base
    finally:
        faultinject.clear_plan()
        ui.stop()
        ui.detach_all()
        eng.shutdown()


class TestInfer:
    def test_200_answers_like_the_engine(self, served):
        eng, base = served
        x = np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
        with post(base, {"inputs": x.tolist()}) as r:
            body = json.loads(r.read())
        assert body["shape"] == [3, 3] and body["latency_ms"] > 0
        got = torch.tensor(body["outputs"], dtype=torch.float32)
        assert torch.equal(got, eng.output(x))

    @pytest.mark.parametrize("payload,raw,code", [
        (None, b"{not json", 400),
        ({"nothing": 1}, None, 400),
        ({"inputs": [[0.0] * 5]}, None, 400),            # feature shape
        ({"inputs": [[0.0] * 4] * 5}, None, 413),        # reject ladder
        ({"inputs": [[0.0] * 4], "slo_class": "platinum"}, None, 400),
    ])
    def test_client_error_codes(self, served, payload, raw, code):
        _, base = served
        assert code_of(base, payload, raw)[0] == code

    def test_429_with_retry_after_while_batch_is_shed(self, served):
        eng, base = served
        eng._adm.set_level(1, reason="http drill")
        try:
            code, retry = code_of(base, {"inputs": [[0.0] * 4],
                                         "slo_class": "batch"})
            assert code == 429 and 1 <= int(retry) <= 30
            assert code_of(base, {"inputs": [[0.0] * 4],
                                  "slo_class": "gold"})[0] == 200
        finally:
            eng._adm.set_level(0, reason="http drill over")

    def test_503_without_an_engine_and_after_shutdown(self):
        ui = UIServer()
        base = f"http://127.0.0.1:{ui.enable(0)}"
        try:
            assert code_of(base, {"inputs": [[0.0]]})[0] == 503
            eng = engine()
            eng.shutdown()
            ui.attach_serving(eng)
            assert code_of(base, {"inputs": [[0.0] * 4]})[0] == 503
        finally:
            ui.stop()

    def test_504_when_the_deadline_expires(self):
        eng = engine(timeout_ms=200)
        ui = UIServer().attach_serving(eng)
        base = f"http://127.0.0.1:{ui.enable(0)}"
        try:
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/dispatch", "kind": "slow",
                  "seconds": 0.5}]))
            assert code_of(base, {"inputs": [[0.0] * 4]})[0] == 504
        finally:
            faultinject.clear_plan()
            ui.stop()
            eng.shutdown()


class TestObservability:
    def test_health_has_the_serving_section_and_every_ledger(self, served):
        eng, base = served
        eng.output(np.zeros((2, 4), np.float32))
        h = json.loads(get(base, "/api/health"))
        # with no watchtower: the newest blackbox, None before any
        assert h["status"] == "ok"
        assert h["last_incident"] == watchtower.last_incident()
        assert h["serving"]["engines"] >= 1 and h["serving"]["requests"] >= 1
        assert h["inference"]["pools"] >= 1
        assert {"flightrec", "host", "devices", "backend"} <= set(h)
        labels = {label for label, _ in OpProfiler.LEDGERS}
        assert labels <= set(h)

    def test_metrics_exposition(self, served):
        eng, base = served
        eng.output(np.zeros((1, 4), np.float32), slo_class="gold")
        prof = OpProfiler.get()
        prof.gauge("autoscale/replicas", 2)
        prof.gauge("serving/canary_phase", 0)
        text = get(base, "/api/metrics").decode()
        assert "dl4j_serving_latency_ms{quantile=\"0.99\"}" in text
        assert 'dl4j_serving_latency_ms{class="gold",quantile="0.5"}' in text
        assert 'dl4j_gauge{name="autoscale/replicas"} 2' in text
        assert 'name="serving/canary_phase"' in text
        assert "# TYPE dl4j_flightrec_events_total counter" in text
        assert "dl4j_alert_state" not in text      # no watchtower rows
        assert "dl4j_counter_total" in prometheus_text()

    def test_watchtower_alerts_incidents_and_last_incident(self, served,
                                                            tmp_path):
        """With a watchtower installed: the ``dl4j_alert_state`` rows as the
        JAX server writes them, ``/api/incidents`` and ``?id=`` serving the
        alert's report, ``/api/health``'s ``last_incident`` and its
        ``watchtower`` ledger."""
        from deeplearning4j_tpu.common import watchtower as jwt

        eng, base = served
        texts = {}
        for mod, prom in ((jwt, jserver.prometheus_text),
                          (watchtower, tserver.prometheus_text)):
            slo = mod.SLO("gold-p99", mod.threshold_sampler(
                lambda: 1e9, 250.0), budget=0.1, fast_s=10.0, mid_s=30.0,
                slow_s=60.0, page_burn=2.0, warn_burn=1.5, clear_ticks=2,
                period_s=100.0)
            tower = mod.install(mod.Watchtower(
                [slo], incident_dir=str(tmp_path / mod.__name__)))
            for i in range(2):
                tower.evaluate_now(now=float(i))
            texts[mod] = [ln for ln in prom().splitlines()
                          if "dl4j_alert_state" in ln]
        try:
            assert texts[watchtower] == texts[jwt]
            assert 'dl4j_alert_state{slo="gold-p99"} 2' in texts[watchtower]
            metrics = get(base, "/api/metrics").decode()
            assert 'dl4j_alert_state{slo="gold-p99"} 2' in metrics
            idx = json.loads(get(base, "/api/incidents"))
            assert [i["slo"] for i in idx] == ["gold-p99"]
            rep = json.loads(get(base, f"/api/incidents?id={idx[0]['id']}"))
            assert rep["chain"]["detection"]["name"] == "watchtower/alert"
            assert rep["chain"]["detection"]["attrs"]["to"] == "page"
            h = json.loads(get(base, "/api/health"))
            assert h["last_incident"]["id"] == idx[0]["id"]
            assert h["watchtower"]["state/gold-p99"] == 2
        finally:
            jwt.uninstall()
            watchtower.uninstall()
        assert "dl4j_alert_state{" not in get(base, "/api/metrics").decode()

    def test_trace_and_incidents(self, served):
        eng, base = served
        flightrec.reset()
        eng.output(np.zeros((1, 4), np.float32))
        seq = eng._req_seq - 1
        doc = json.loads(get(base, f"/api/trace?corr=req{seq}"))
        names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "i"]
        assert names == ["serving/enqueue", "serving/reply"]
        assert json.loads(get(base, "/api/incidents")) == []
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(base, "/api/incidents?id=inc1")
        assert ei.value.code == 404
        assert get(base, "/healthz") == b"ok"
        assert b"deeplearning4j training UI" in get(base, "/")
        with pytest.raises(urllib.error.HTTPError) as ei:
            get(base, "/nowhere")
        assert ei.value.code == 404

    @pytest.mark.parametrize("value", ['a"b', "back\\slash", "two\nlines",
                                       "plain"])
    def test_prometheus_escaping_matches_jax(self, value):
        assert tserver._prom_escape(value) == jserver._prom_escape(value)
        assert tserver._prom_escape_help(value) == \
            jserver._prom_escape_help(value)


class TestStatsSources:
    def test_remote_router_posts_into_the_server(self):
        ui = UIServer()
        base = f"http://127.0.0.1:{ui.enable(0)}"
        router = RemoteUIStatsStorageRouter(base)
        try:
            for step in range(5):
                router.put_scalar("s1", "loss", step, 1.0 / (step + 1))
            router.flush(deadline=5.0)
            assert json.loads(get(base, "/api/tags")) == ["loss"]
            series = json.loads(get(base, "/api/series?tag=loss"))
            assert [s for s, _ in series] == list(range(5))
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(base, raw=b'[{"tag": "x"}]', path="/api/post")
            assert ei.value.code == 400
        finally:
            router.close()
            router._thread.join(timeout=2.0)
            ui.stop()

    def test_attached_stores_and_sessions(self, tmp_path):
        mem = InMemoryStatsStorage()
        mem.put_scalar("a", "acc", 1, 0.5)
        path = str(tmp_path / "stats.jsonl")
        fs = FileStatsStorage(path)
        fs.put_scalar("b", "acc", 2, 0.7)
        fs.close()
        ui = UIServer().attach(mem).attach(path)
        assert ui.sessions() == ["a", "b"]
        assert ui.tags() == ["a/acc", "b/acc"]
        assert ui.series("b/acc") == [(2, 0.7)]
        with pytest.raises(TypeError):
            ui.attach(object())

    @pytest.mark.parametrize("steps", [
        ["grow", "grow", "same"], ["grow", "rewrite", "grow"],
        ["torn", "complete", "same"]])
    def test_jsonl_tail_cache_matches_jax(self, tmp_path, steps):
        caches = [tserver._JsonlTailCache(), jserver._JsonlTailCache()]
        path = str(tmp_path / "s.jsonl")
        open(path, "w").close()
        n = 0
        for step in steps:
            if step == "grow":
                with open(path, "a") as f:
                    f.write(json.dumps({"tag": "t", "step": n,
                                        "value": 1.0}) + "\n")
                n += 1
            elif step == "rewrite":
                with open(path, "w") as f:
                    f.write(json.dumps({"tag": "u", "step": 0,
                                        "value": 2.0}) + "\n")
            elif step == "torn":
                with open(path, "a") as f:
                    f.write('{"tag": "t", "step": 9')
            elif step == "complete":
                with open(path, "a") as f:
                    f.write(', "value": 3.0}\n')
            time.sleep(0.01)
            os.utime(path)
            got = [c.read(path) for c in caches]
            assert got[0] == got[1]
        assert caches[0].stats() == caches[1].stats()


class TestGraphLog:
    def test_graph_structure_log_and_endpoint(self, tmp_path):
        from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

        sd = SameDiff.create(device="cpu")
        x = sd.placeholder("x", (2, 3))
        w = sd.var("w", init=np.ones((3, 4), np.float32))
        sd.nn.relu(x.mmul(w), name="y")
        g = graph_structure(sd)
        assert g["n_ops"] >= 2 and g["placeholders"] == ["x"]
        assert g["max_depth"] >= 2
        path = str(tmp_path / "graph.log")
        with LogFileWriter(path) as lw:
            lw.write_graph_structure(sd)
            lw.write_scalar_event("loss", 1, 0.25)
        log = read_graph_log(path)
        assert log["graph"]["n_ops"] == g["n_ops"]
        assert log["events"] == [{"type": "event", "name": "loss",
                                  "step": 1, "value": 0.25}]
        ui = UIServer().attach_graph(path)
        base = f"http://127.0.0.1:{ui.enable(0)}"
        try:
            assert json.loads(get(base, "/api/graph"))["n_ops"] == g["n_ops"]
        finally:
            ui.stop()
