"""The port's OpProfiler (deeplearning4j_tpu_torch/common/profiler.py)
against the JAX package's: the same counters, gauges and sections give the
same ledgers, ``ledger_stats`` and ``print_statistics``; sections reach the
flight recorder; ``trace`` writes a torch.profiler trace."""

import json
import os

import pytest

from deeplearning4j_tpu.common.profiler import OpProfiler as JProf
from deeplearning4j_tpu_torch.common import flightrec
from deeplearning4j_tpu_torch.common.profiler import OpProfiler as TProf

COUNTS = {
    "serving/requests": 7, "serving/batches": 3, "serving/rows": 18,
    "serving/pad_rows": 6, "serving/capacity_rows": 24,
    "serving/shed/batch": 2, "serving/traces_after_warmup": 0,
    "autoscale/ticks": 5, "autoscale/scale_ups": 1,
    "checkpoint/committed": 2, "checkpoint/bytes": 4096,
    "collective/psum_bytes": 100, "collective/encoded_elems_sent": 10,
    "collective/encoded_elems_total": 400,
    "zero1/updater_state_bytes_total": 64,
    "elastic/resizes": 1, "integrity/checks": 4,
    "integrity/scrub_passes": 1, "faults/serving/dispatch/slow": 2,
    "pipeline/retries": 1, "precision/epilogue_hits": 53,
    "supervisor/restarts": 1, "fleet/culls": 1, "tracecheck/armed": 1,
    "telemetry/drained_steps": 8, "pipeline/stages": 2,
    "pipeline/busy_ticks": 6, "pipeline/tick_slots": 8,
    "trace/serving_infer": 12, "inference/replica_retired": 1,
}
GAUGES = {"serving/shed_level": 1, "autoscale/replicas": 2,
          "elastic/workers": 4}
SECTIONS = {"serving/dispatch": (3, 0.3, 0.2), "serving/warmup": (1, 1.5,
                                                                   1.5),
            "checkpoint/write": (2, 0.5, 0.3), "elastic/resize": (1, 0.1,
                                                                  0.1),
            "telemetry/drain": (4, 0.04, 0.02),
            "pipeline/retry_backoff": (1, 0.05, 0.05),
            "pipeline/next_batch": (5, 0.2, 0.1),
            "pipeline/dispatch": (5, 0.8, 0.3),
            "supervisor/backoff": (1, 0.25, 0.25),
            "pipeline/remap": (1, 0.3, 0.3)}


def _filled(cls):
    p = cls()
    for k, v in COUNTS.items():
        p.count(k, v)
    for k, v in GAUGES.items():
        p.gauge(k, v)
    for k, (n, total, mx) in SECTIONS.items():
        p._sections[k] = {"count": n, "total_s": total, "max_s": mx}
    return p


PORTED = [label for label, _ in TProf.LEDGERS
          if label not in ("xla", "watchtower")]


class TestLedgers:
    def test_ledger_list_is_the_jax_list(self):
        assert TProf.LEDGERS == JProf.LEDGERS

    @pytest.mark.parametrize("label", PORTED)
    def test_each_ledger_equals_jax(self, label):
        attr = dict(TProf.LEDGERS)[label]
        t, j = _filled(TProf), _filled(JProf)
        assert getattr(t, attr)() == pytest.approx(getattr(j, attr)())
        assert getattr(t, attr)()

    def test_unported_ledgers_are_empty(self):
        # the census and the watchtower ledgers read no counters: empty
        # until a step registers and a watchtower is installed
        from deeplearning4j_tpu_torch.common import watchtower, xprof

        xprof.reset()
        watchtower.uninstall()
        t = _filled(TProf)
        assert t.xla_stats() == {} and t.watchtower_stats() == {}
        try:
            xprof.note_subexec("pallas/update_bucket", flops=1.0,
                               bytes_accessed=4.0)
            watchtower.install(watchtower.Watchtower([]))
            assert t.xla_stats()["pallas/update_bucket/flops"] == 1.0
            assert t.watchtower_stats()["slos"] == 0
        finally:
            xprof.reset()
            watchtower.uninstall()

    def test_gauges_traces_and_statistics(self, capsys):
        t, j = _filled(TProf), _filled(JProf)
        assert t.gauge_names() == j.gauge_names() == set(GAUGES)
        assert t.trace_counts() == j.trace_counts()
        assert t.get_counters() == j.get_counters()
        ts = {k: v for k, v in t.ledger_stats().items()
              if k not in ("xla", "watchtower")}
        js = {k: v for k, v in j.ledger_stats().items()
              if k not in ("xla", "watchtower")}
        assert ts.keys() == js.keys()
        lines_t = t.print_statistics().splitlines()
        lines_j = j.print_statistics().splitlines()
        keep = [x for x in lines_j if not x.startswith(("[xla]",
                                                        "[watchtower]"))]
        assert lines_t == keep
        assert capsys.readouterr().out
        t.reset()
        assert t.get_counters() == {} and t.gauge_names() == set()


class TestSectionsAndTrace:
    def test_time_section_reaches_the_flight_recorder(self):
        p = TProf()
        flightrec.reset()
        with p.time_section("serving/dispatch"):
            pass
        s = p.get_statistics()["serving/dispatch"]
        assert s["count"] == 1 and s["total_s"] >= 0
        ev = flightrec.events("profiler/section")[-1]
        assert ev["attrs"]["section"] == "serving/dispatch"
        assert ev["attrs"]["dur_s"] == pytest.approx(s["total_s"])
        doc = flightrec.chrome_trace()
        assert any(e["ph"] == "X" and e["name"] == "serving/dispatch"
                   for e in doc["traceEvents"])

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        import torch

        p = TProf()
        with p.trace(str(tmp_path)):
            torch.ones(8).sum()
            with pytest.raises(RuntimeError, match="already tracing"):
                p.start(str(tmp_path))
        files = os.listdir(tmp_path)
        assert len(files) == 1 and files[0].endswith(".json")
        with open(tmp_path / files[0]) as f:
            assert "traceEvents" in json.load(f)
        assert p.stop() is None              # nothing running
