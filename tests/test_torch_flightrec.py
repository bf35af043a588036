"""The port's flight recorder (deeplearning4j_tpu_torch/common/flightrec.py)
against the JAX package's: the same events in give the same ring, drops,
spans, correlation filtering, Chrome trace structure and black box."""

import json
import threading

import pytest

from deeplearning4j_tpu.common import flightrec as jfr
from deeplearning4j_tpu_torch.common import flightrec as tfr


def _drive(mod, rec):
    """One fixed event script (spans nested on two threads, instants, a
    profiler-style duration, a synthetic lane, correlation ids)."""
    rec.event("serving/enqueue", corr="req0", req=0, rows=2)
    with rec.span("supervisor/attempt", severity="info", attempt=1):
        rec.event("pipeline/dispatch", ordinal=0)
        with rec.span("elastic/resize", severity="warn", frm=4, to=3):
            rec.event("fault/fired", severity="warn", site="serving/"
                      "dispatch", kind="slow", index=3)
        with rec.correlate("inc1.a0"):
            rec.event("checkpoint/commit", tag="iter_3", iteration=3)
    rec.record("profiler/section", attrs={"section": "serving/dispatch",
                                          "dur_s": 0.25})
    rec.record("pipeline/stage_fwd", attrs={"lane": "pipeline/stage0/fwd",
                                            "dur_s": 0.1})

    def other():
        with rec.span("autoscale/decide", severity="warn", target=2):
            rec.event("autoscale/scale", frm=1, to=2, reason="queue_hwm=9")

    t = threading.Thread(target=other, name="worker-x")
    t.start()
    t.join()
    rec.event("serving/reply", corr="req0", req=0, latency_ms=1.5)


def _strip(e):
    return {k: v for k, v in e.items() if k not in ("t", "m", "tid")}


class TestRing:
    @pytest.mark.parametrize("capacity,n", [(1, 5), (3, 3), (3, 10),
                                            (8, 7), (8, 40), (64, 40)])
    def test_ring_evicts_and_counts_the_same(self, capacity, n):
        recs = [jfr.FlightRecorder(capacity), tfr.FlightRecorder(capacity)]
        for r in recs:
            for i in range(n):
                r.event("pipeline/dispatch", ordinal=i)
        j, t = recs
        assert j.stats() == t.stats()
        assert [_strip(e) for e in j.snapshot()] == \
            [_strip(e) for e in t.snapshot()]
        assert t.stats()["dropped"] == max(0, n - capacity)
        assert [e["seq"] for e in t.tail(2)] == [e["seq"] for e in j.tail(2)]

    @pytest.mark.parametrize("shrink", [1, 2, 5])
    def test_shrink_counts_drops_the_same(self, shrink):
        recs = [jfr.FlightRecorder(6), tfr.FlightRecorder(6)]
        for r in recs:
            for i in range(6):
                r.event("pipeline/dispatch", ordinal=i)
            r.configure(capacity=shrink)
        assert recs[0].stats() == recs[1].stats()

    def test_disabled_records_nothing_but_closes_open_spans(self):
        for mod in (jfr, tfr):
            r = mod.FlightRecorder(16)
            with r.span("elastic/resize"):
                r.configure(enabled=False)
                r.event("pipeline/dispatch")
            phases = [e["ph"] for e in r.snapshot()]
            assert phases == ["B", "E"]
            r.configure(enabled=True)
            r.reset()
            assert r.stats()["events_total"] == 0


class TestEventsAndSpans:
    def test_script_gives_the_same_events(self):
        recs = [jfr.FlightRecorder(256), tfr.FlightRecorder(256)]
        for mod, r in zip((jfr, tfr), recs):
            _drive(mod, r)
        j, t = recs
        assert [_strip(e) for e in j.snapshot()] == \
            [_strip(e) for e in t.snapshot()]
        # nested spans parent on the calling thread's innermost span
        spans = [e for e in t.snapshot() if e["ph"] == "B"]
        by_name = {e["name"]: e for e in spans}
        assert by_name["elastic/resize"]["parent"] == \
            by_name["supervisor/attempt"]["span"]
        assert by_name["autoscale/decide"]["parent"] is None

    @pytest.mark.parametrize("prefix,corr", [(None, "req0"),
                                             ("serving/", None),
                                             (None, "inc1.a0"),
                                             ("autoscale/", None),
                                             ("checkpoint/", "inc1.a0")])
    def test_filters_agree(self, prefix, corr):
        recs = [jfr.FlightRecorder(256), tfr.FlightRecorder(256)]
        for mod, r in zip((jfr, tfr), recs):
            _drive(mod, r)
        j, t = (r.events(prefix=prefix, corr=corr) for r in recs)
        assert [_strip(e) for e in j] == [_strip(e) for e in t] and t

    def test_module_facade(self):
        tfr.reset()
        tfr.event("serving/shed", severity="warn", level=1)
        with tfr.span("autoscale/decide", target=2):
            pass
        with tfr.correlate("pub7"):
            tfr.event("serving/canary", file="x.zip")
        assert tfr.enabled()
        assert [e["name"] for e in tfr.events(corr="pub7")] == \
            ["serving/canary"]
        assert tfr.stats()["events_total"] == 4
        assert tfr.tail(1)[0]["name"] == "serving/canary"
        assert tfr.get() is tfr.get()

    def test_registry_is_the_jax_registry(self):
        assert set(tfr.EVENT_SITES) == set(jfr.EVENT_SITES)
        assert tfr.DEFAULT_CAPACITY == jfr.DEFAULT_CAPACITY


class TestConsumers:
    @pytest.mark.parametrize("corr", [None, "req0", "inc1.a0"])
    def test_chrome_trace_has_the_same_structure(self, corr):
        recs = [jfr.FlightRecorder(256), tfr.FlightRecorder(256)]
        for mod, r in zip((jfr, tfr), recs):
            _drive(mod, r)
        docs = [r.chrome_trace(corr=corr) for r in recs]

        def shape(doc):
            # a thread's tid is its OS ident, which differs between the
            # two drives unless the OS happens to reuse it: compare thread
            # lanes by order of first appearance, synthetic lanes (< 0) as
            # they are
            order = {}
            out = []
            for e in doc["traceEvents"]:
                e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
                tid = e.get("tid")
                if isinstance(tid, int) and tid >= 0:
                    e["tid"] = order.setdefault(tid, len(order))
                out.append(e)
            return out

        assert docs[0]["displayTimeUnit"] == docs[1]["displayTimeUnit"]
        assert shape(docs[0]) == shape(docs[1])
        kinds = {e["ph"] for e in docs[1]["traceEvents"]}
        if corr is None:
            assert kinds == {"B", "E", "i", "X", "M"}
            lanes = [e for e in docs[1]["traceEvents"] if e["ph"] == "M"
                     and e["args"]["name"] == "pipeline/stage0/fwd"]
            assert lanes and lanes[0]["tid"] < 0

    def test_export_and_blackbox_files(self, tmp_path):
        recs = [jfr.FlightRecorder(256), tfr.FlightRecorder(256)]
        for mod, r in zip((jfr, tfr), recs):
            _drive(mod, r)
        n = [r.export_chrome_trace(str(tmp_path / f"t{i}.json"))
             for i, r in enumerate(recs)]
        assert n[0] == n[1] > 0
        for i in range(2):
            doc = json.loads((tmp_path / f"t{i}.json").read_text())
            assert len(doc["traceEvents"]) == n[i]
        boxes = [r.dump_blackbox(str(tmp_path / f"b{i}.jsonl"), last_n=5)
                 for i, r in enumerate(recs)]
        lines = [open(b).read().splitlines() for b in boxes]
        assert len(lines[0]) == len(lines[1]) == 5
        assert [_strip(json.loads(x)) for x in lines[0]] == \
            [_strip(json.loads(x)) for x in lines[1]]

    def test_concurrent_blackbox_writers_of_one_file(self, tmp_path):
        # the ranks of a group dump into one checkpoint directory: writers
        # of one path must not rename each other's temporary file away
        rec = tfr.FlightRecorder(256)
        _drive(tfr, rec)
        path = str(tmp_path / "blackbox.jsonl")
        errors = []

        def writer():
            try:
                for _ in range(200):
                    rec.dump_blackbox(path)
            except OSError as e:
                errors.append(repr(e))

        ts = [threading.Thread(target=writer) for _ in range(4)]
        try:
            for t in ts:
                t.start()
        finally:
            for t in ts:
                t.join()
        assert not errors, errors[:3]
        lines = open(path).read().splitlines()
        assert len(lines) == len(rec.snapshot())
        assert sorted(p.name for p in tmp_path.iterdir()) == \
            ["blackbox.jsonl"]
