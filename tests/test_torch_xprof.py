"""The port's executable census, roofline ledger and memory watermarks
(``deeplearning4j_tpu_torch/common/xprof.py``) against the JAX package's
(``tests/test_xprof.py``): the registry is the JAX registry; a generation
is a new argument signature, counted once on its first call
(FlopCounterMode's flops, the argument and output bytes); the counted
flops of a matmul and of a Dense MLP equal the hand count XLA's cost
analysis gives in the JAX package; the roofline's join math and verdicts
are the JAX census's on the same numbers; and every trainer family the
JAX census covers registers its step."""

import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.common import xprof as jx
from deeplearning4j_tpu_torch.common import flightrec, system_info, xprof
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from torch_parity import mln_twins, modules

EXPECTED_SITES = [
    "data/feature_transform",
    "embeddings/lookup", "embeddings/update",
    "fleet/infer", "fleet/step",
    "graph/fit_chunk", "graph/fit_step", "graph/infer",
    "mln/fit_chunk", "mln/fit_step", "mln/infer", "mln/pretrain_step",
    "mln/tbptt_step",
    "nlp/fasttext_block", "nlp/glove_block",
    "nlp/pv_dbow_block", "nlp/pv_dm_block",
    "nlp/pv_pos_map", "nlp/pv_subsample",
    "nlp/w2v_cbow_block", "nlp/w2v_sg_block", "nlp/w2v_subsample",
    "nlp/w2v_table_block",
    "pallas/update_bucket",
    "pipeline/fit_step", "pipeline/hetero_fwd", "pipeline/hetero_step",
    "pipeline/legacy_fwd", "pipeline/legacy_step",
    "pw/fit_chunk", "pw/fit_step",
    "samediff/exec", "samediff/fit_step", "samediff/grad",
    "serving/bucket",
    "transfer/featurize",
]


@pytest.fixture(autouse=True)
def fresh_census():
    for c in (xprof, jx):
        c.reset()
        c.configure(enabled=True)
    yield
    for c in (xprof, jx):
        c.reset()
        c.configure(enabled=True)
        c.get()._roof = None


def _mlp_conf(m, updater=None, n_in=16, hidden=24, n_out=4, fused=False):
    b = (m.NeuralNetConfiguration.builder().seed(3)
         .updater(updater(m) if updater else m.Nesterovs(
             learning_rate=0.01, momentum=0.9))
         .activation("relu").weight_init("xavier"))
    if fused:
        b = b.fused_update()
    return (b.list()
            .layer(m.L.DenseLayer(n_out=hidden))
            .layer(m.L.OutputLayer(n_out=n_out, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(n_in)).build())


def _mlp(**kw):
    m = modules("torch")
    return m.MultiLayerNetwork(_mlp_conf(m, **kw)).init(device="cpu")


def _batches(n=96, n_in=16, n_out=4, batch=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, n_in).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.randint(0, n_out, n)]
    return x, y, NDArrayDataSetIterator(x, y, batch_size=batch)


# --- census core ------------------------------------------------------------

class TestCensusCore:
    def test_unknown_site_refused(self):
        with pytest.raises(ValueError, match="unknown executable-census"):
            xprof.register_jit("bogus/site", lambda x: x)
        with pytest.raises(ValueError, match="unknown executable-census"):
            xprof.note_subexec("bogus/site", flops=1.0)

    def test_wrapper_counts_calls_and_generations(self):
        f = xprof.register_jit("mln/infer", lambda x, k=0: x * 2)
        f(torch.ones(4))
        f(torch.ones(4))
        e = xprof.census()["mln/infer"]
        assert e["calls"] == 2 and e["generations"] == 1
        f(torch.ones(8))                  # a new signature = a new generation
        f(torch.ones(8, dtype=torch.float64))   # so is a new dtype
        e = xprof.census()["mln/infer"]
        assert e["calls"] == 4 and e["generations"] == 3
        assert e["compile_s"] > 0
        f(torch.ones(4), 7)               # python scalars are dynamic values
        assert xprof.census()["mln/infer"]["generations"] == 3

    def test_static_arguments_enter_the_signature(self):
        f = xprof.register_jit("mln/infer", lambda x, training=False: x,
                               static_argnames=("training",))
        f(torch.ones(2), training=False)
        f(torch.ones(2), training=True)
        f(torch.ones(2), training=True)
        e = xprof.census()["mln/infer"]
        assert e["generations"] == 2 and e["calls"] == 3
        assert e["fingerprint"]["static_argnames"] == ("training",)

    def test_wrapper_is_call_transparent(self):
        def fn(x):
            return x + 1

        fn.tag = "mine"
        f = xprof.register_jit("mln/infer", fn)
        assert f.wrapped is fn and f.tag == "mine"
        assert torch.equal(f(torch.zeros(3)), torch.ones(3))

    def test_censused_calls_the_latest_method(self):
        """An owner's wrapper is made once, but calls the method as the
        instance holds it now (a method replaced on the instance, as a
        counting spy does, takes effect on the next lookup)."""
        class Owner:
            def block(self, x):
                return x + 1

        o = Owner()
        f = xprof.censused(o, "nlp/glove_block", o.block)
        assert float(f(torch.zeros(1))) == 1.0
        o.block = lambda x: x + 5
        g = xprof.censused(o, "nlp/glove_block", o.block)
        assert g is f and float(g(torch.zeros(1))) == 5.0
        e = xprof.census()["nlp/glove_block"]
        assert e["calls"] == 2 and e["generations"] == 1

    def test_disabled_census_counts_nothing(self):
        f = xprof.register_jit("mln/infer", lambda x: x)
        xprof.configure(enabled=False)
        try:
            assert float(f(torch.ones(2))[0]) == 1.0
            assert xprof.census()["mln/infer"]["calls"] == 0
        finally:
            xprof.configure(enabled=True)

    def test_reregistration_accumulates(self):
        f1 = xprof.register_jit("mln/fit_step", lambda x: x)
        f1(torch.ones(2))
        f2 = xprof.register_jit("mln/fit_step", lambda x: -x)
        f2(torch.ones(2))
        e = xprof.census()["mln/fit_step"]
        assert e["calls"] == 2 and e["generations"] == 2

    def test_register_aot_accumulates_variants(self):
        a, b = torch.ones(8, 16), torch.ones(16, 4)
        _, rec = xprof.count_call(lambda x, y: x @ y, a, b)
        xprof.register_aot("serving/bucket", rec, variant="(8, 16)",
                            compile_s=0.25)
        e = xprof.census()["serving/bucket"]
        assert e["variants"] == 1 and e["compile_s"] == 0.25
        assert e["cost"]["flops"] == 2 * 8 * 16 * 4
        assert e["cost_source"] == "flop_counter"
        assert e["memory"]["argument_bytes"] == 4 * (8 * 16 + 16 * 4)
        xprof.register_aot("serving/bucket", rec, variant="again")
        e = xprof.census()["serving/bucket"]
        assert e["variants"] == 2 and e["generations"] == 2
        assert e["cost"]["flops"] == 2 * 2 * 8 * 16 * 4
        assert e["fingerprint"]["last_variant"] == "again"

    def test_register_aot_none_is_noop(self):
        xprof.register_aot("serving/bucket", None)
        assert "serving/bucket" not in xprof.census()

    def test_reset_opens_a_clean_window_without_orphaning(self):
        f = xprof.register_jit("mln/fit_step", lambda x: x * 2,
                               donate=(0,))
        f(torch.ones(4, 4))
        xprof.reset()
        assert xprof.census() == {}
        f(torch.ones(4, 4))               # the warm signature, a fresh window
        e = xprof.census()["mln/fit_step"]
        assert e["calls"] == 1 and e["generations"] == 1
        assert e["compile_s"] == 0.0
        assert e["fingerprint"]["donate_argnums"] == (0,)
        # the first call's count carries into the fresh window
        assert list(xprof.analyze()) == ["mln/fit_step"]
        assert e["cost"]["bytes_accessed"] == 2 * 64

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_note_subexec_cost_is_last_one_wins(self, pkg):
        c = jx if pkg == "jax" else xprof
        c.note_subexec("pallas/update_bucket", flops=100.0,
                       bytes_accessed=400.0, kind="adam")
        c.note_subexec("pallas/update_bucket", flops=100.0,
                       bytes_accessed=400.0, kind="adam")
        c.note_subexec("pallas/update_bucket", flops=50.0,
                       bytes_accessed=200.0, kind="adam")
        e = c.census()["pallas/update_bucket"]
        assert e["subexec"] is True and e["cost_source"] == "counted"
        assert e["cost"] == {"flops": 50.0, "bytes_accessed": 200.0}
        # JAX notes once a trace; the port once a launch, and a generation
        # is a new description of the launch
        assert e["generations"] == (3 if pkg == "jax" else 2)
        if pkg == "torch":
            assert e["calls"] == 3


# --- analysis -----------------------------------------------------------------

class TestAnalysis:
    def test_flops_match_the_hand_count_and_xla(self):
        """x@w on (B,K)x(K,N): 2*B*K*N flops, 4*(BK + KN + BN) bytes, as
        the JAX census's XLA cost analysis gives for the same matmul."""
        B, K, N = 8, 32, 6
        rng = np.random.RandomState(0)
        x = rng.randn(B, K).astype(np.float32)
        w = rng.randn(K, N).astype(np.float32)
        jf = jx.register_jit("mln/infer", jax.jit(lambda a, b: a @ b))
        jf(jnp.asarray(x), jnp.asarray(w))
        jx.analyze()
        tf = xprof.register_jit("mln/infer", lambda a, b: a @ b)
        tf(torch.from_numpy(x), torch.from_numpy(w))
        assert list(xprof.analyze()) == ["mln/infer"]
        j, t = jx.census()["mln/infer"], xprof.census()["mln/infer"]
        assert t["cost_source"] == "flop_counter"
        assert t["cost"]["flops"] == 2 * B * K * N == j["cost"]["flops"]
        assert t["cost"]["bytes_accessed"] == 4 * (B * K + K * N + B * N) \
            == j["cost"]["bytes_accessed"]
        assert t["memory"]["argument_bytes"] == 4 * (B * K + K * N) \
            == j["memory"]["argument_bytes"]
        assert t["memory"]["output_bytes"] == 4 * B * N \
            == j["memory"]["output_bytes"]

    def test_dense_mlp_inference_flops(self):
        """One Dense MLP through MultiLayerNetwork.output: the matmuls'
        hand count, 2*B*(in*h + h*out) (FlopCounterMode counts the
        products; bias adds and activations are not matmul flops)."""
        net = _mlp(n_in=16, hidden=24, n_out=4)
        x = np.random.RandomState(1).randn(8, 16).astype(np.float32)
        net.output(x)
        e = xprof.census()["mln/infer"]
        assert e["cost"]["flops"] == 2 * 8 * (16 * 24 + 24 * 4)
        assert e["cost"]["bytes_accessed"] == 4 * (8 * 16 + 8 * 4)

    def test_analyze_is_idempotent_per_generation(self):
        calls = []

        def step(x):
            calls.append(1)
            return x * 3

        f = xprof.register_jit("mln/infer", step)
        f(torch.ones(4))
        assert list(xprof.analyze()) == ["mln/infer"]
        assert xprof.analyze() == {}      # nothing new to analyze
        f(torch.ones(6))                  # a new generation
        assert list(xprof.analyze()) == ["mln/infer"]
        assert len(calls) == 2            # analysis never re-ran the step

    def test_counted_fallback_when_the_flop_counter_fails(self, monkeypatch):
        import torch.utils.flop_counter as fc

        def boom(*a, **k):
            raise RuntimeError("no flop counter")

        monkeypatch.setattr(fc, "FlopCounterMode", boom)
        f = xprof.register_jit("mln/infer", lambda x: x + 1)
        f(torch.ones(10))
        res = xprof.analyze()
        e = res["mln/infer"]
        assert e["cost_source"] == "counted"
        assert e["cost"]["bytes_accessed"] >= 40
        assert "no flop counter" in e["error"]
        assert xprof.ledger()["mln/infer/counted"] == 1.0

    def test_collected_callable_keeps_its_count(self):
        f = xprof.register_jit("mln/infer", lambda x: x @ x)
        f(torch.ones(3, 3))
        del f
        gc.collect()
        e = xprof.analyze()["mln/infer"]
        assert e["cost"]["flops"] == 2 * 27 and "error" not in e


# --- roofline -----------------------------------------------------------------

class TestRoofline:
    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_join_math_and_bound_verdict(self, pkg):
        c = jx if pkg == "jax" else xprof
        c.set_roof(1e12, 1e11)            # ridge 10 flops a byte
        c.note_subexec("pallas/update_bucket", flops=5e8,
                       bytes_accessed=1e9)
        c.note_measured("pallas/update_bucket", 1e-3)
        row = c.roofline()["pallas/update_bucket"]
        assert row["arithmetic_intensity"] == pytest.approx(0.5)
        assert row["bound"] == "hbm"
        assert row["mfu"] == pytest.approx(0.5)
        assert row["effective_flops_per_s"] == pytest.approx(5e11)
        assert row["achieved_bytes_per_s"] == pytest.approx(1e12)
        c.note_subexec("pallas/update_bucket", flops=2e10,
                       bytes_accessed=1e9)
        row = c.roofline()["pallas/update_bucket"]
        assert row["arithmetic_intensity"] == pytest.approx(20.0)
        assert row["bound"] == "compute"

    def test_ledger_rows_as_jax(self):
        for c in (jx, xprof):
            c.set_roof(1e12, 1e11)
            c.note_subexec("pallas/update_bucket", flops=1e6,
                           bytes_accessed=1e7)
            c.note_measured("pallas/update_bucket", 2e-3)
        t, j = xprof.ledger(), jx.ledger()
        keys = [k for k in j if k.startswith("pallas/")]
        assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
        assert t["executables"] == j["executables"] == 1

    def test_ledger_is_flat_and_on_the_profiler(self):
        xprof.set_roof(1e12, 1e11)
        xprof.note_subexec("pallas/update_bucket", flops=1e6,
                           bytes_accessed=1e7)
        led = OpProfiler.get().xla_stats()
        assert led["executables"] == 1
        assert led["pallas/update_bucket/flops"] == 1e6
        assert led["pallas/update_bucket/compute_bound"] == 0.0
        assert all(isinstance(v, (int, float)) for v in led.values())
        assert ("xla", "xla_stats") in OpProfiler.LEDGERS

    def test_measured_step_beats_dispatch_mean(self):
        f = xprof.register_jit("mln/infer", lambda x: x)
        f(torch.ones(4))
        xprof.note_measured("mln/infer", 42.0)
        assert xprof.roofline()["mln/infer"]["step_s"] == 42.0

    def test_platform_roofs(self):
        assert xprof.PLATFORM_ROOFS["gpu"] == (989e12, 3.35e12)
        assert "cpu" in xprof.PLATFORM_ROOFS
        assert "tpu" not in xprof.PLATFORM_ROOFS


# --- trainer families ---------------------------------------------------------

class TestTrainerFamilies:
    def test_mln_fit_and_infer_register(self):
        model = _mlp()
        x, _, it = _batches()
        model.fit(it, epochs=1)
        model.output(x[:8])
        census = xprof.census()
        assert census["mln/fit_step"]["calls"] == 3
        assert census["mln/fit_step"]["generations"] == 1
        assert census["mln/infer"]["calls"] == 1

    def test_tbptt_and_pretrain_register(self):
        m = modules("torch")
        conf = (m.NeuralNetConfiguration.builder().seed(1)
                .updater(m.Sgd(0.1)).list()
                .layer(m.L.LSTM(n_out=6))
                .layer(m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                          activation="softmax"))
                .set_input_type(m.InputType.recurrent(4, 8))
                .backprop_type("TruncatedBPTT").tbptt_length(4).build())
        net = m.MultiLayerNetwork(conf).init(device="cpu")
        rng = np.random.RandomState(0)
        from deeplearning4j_tpu_torch.data import DataSet

        x = rng.randn(5, 8, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (5, 8))]
        net.fit(DataSet(x, y))
        e = xprof.census()["mln/tbptt_step"]
        assert e["calls"] == 2 and e["generations"] == 1

    def test_graph_fit_and_infer_register(self):
        from torch_parity import residual_conf

        m = modules("torch")
        from deeplearning4j_tpu_torch.data import DataSet

        g = m.graph.ComputationGraph(residual_conf(
            "torch", fused=False, channels=4)).init(device="cpu")
        rng = np.random.RandomState(0)
        x = rng.randn(2, 4, 8, 8).astype(np.float32)
        out_n = g.output(x)[0].shape[1]
        y = np.eye(out_n, dtype=np.float32)[rng.randint(0, out_n, 2)]
        g.fit(DataSet(x, y))
        g.fit(DataSet(x, y))
        census = xprof.census()
        assert census["graph/fit_step"]["calls"] == 2
        assert census["graph/fit_step"]["generations"] == 1
        assert census["graph/infer"]["cost"]["flops"] > 0

    def test_fleet_step_registers(self):
        from deeplearning4j_tpu_torch.parallel.fleet import FleetTrainer

        fleet = FleetTrainer(_mlp(n_in=8, hidden=8, n_out=2,
                                  updater=lambda m: m.Adam(1e-3)), 3,
                             seed=7)
        rng = np.random.RandomState(0)
        x = rng.randn(16, 8).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.randint(0, 2, 16)]
        fleet.step(x, y)
        fleet.step(x, y)
        e = xprof.census()["fleet/step"]
        assert e["calls"] == 2 and e["generations"] == 1
        fleet.output(x, per_member=False)
        assert xprof.census()["fleet/infer"]["calls"] == 1

    def test_serving_bucket_census(self):
        from deeplearning4j_tpu_torch.parallel import ServingEngine

        model = _mlp(n_in=12, hidden=8, n_out=3,
                     updater=lambda m: m.Adam(1e-3))
        eng = (ServingEngine.Builder(model).buckets([1, 4])
               .input_shape((12,)).workers(1).max_wait_ms(1.0)
               .devices(["cpu"]).build())
        try:
            e = xprof.census()["serving/bucket"]
            assert e["variants"] == 2 and e["generations"] == 2
            assert e["cost_source"] == "flop_counter"
            # the two buckets' forwards: 2*B*(12*8 + 8*3) at B = 1 and 4
            assert e["cost"]["flops"] == 2 * 5 * (12 * 8 + 8 * 3)
            assert e["compile_s"] > 0
            assert e["fingerprint"]["last_variant"] == "(4, 12)/dev0"
            assert xprof.watermarks()["serving_warmup"]["samples"] >= 1
            eng.output(np.zeros((3, 12), np.float32))
            assert xprof.census()["serving/bucket"]["generations"] == 2
        finally:
            eng.shutdown()

    def test_fused_update_counted_subexec_as_jax(self):
        """The fused optimizer kernel's analytic cost: Adam 12 flops an
        element; p, g read and p written, m and v read and written."""
        jm, tm = mln_twins(_mlp_conf(modules("jax"),
                                     updater=lambda m: m.Adam(1e-3),
                                     fused=True),
                           _mlp_conf(modules("torch"),
                                     updater=lambda m: m.Adam(1e-3),
                                     fused=True))
        from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIt

        x, y, it = _batches()
        jm.fit(JIt(x, y, batch_size=32), epochs=1)
        tm.fit(it, epochs=1)
        t = xprof.census()["pallas/update_bucket"]
        j = jx.census()["pallas/update_bucket"]
        n = tm.num_params()
        assert t["subexec"] is True and t["cost_source"] == "counted"
        assert t["cost"] == j["cost"]
        assert t["cost"]["flops"] == 12 * n
        assert t["cost"]["bytes_accessed"] == (3 * 4 + 2 * 2 * 4) * n
        assert t["calls"] == 3 and t["fingerprint"]["kind"] == "adam"

    def test_exec_events_emitted(self):
        rec = flightrec.get()
        rec.configure(enabled=True)
        before = len(rec.events(prefix="xprof/exec"))
        model = _mlp()
        _, _, it = _batches()
        model.fit(it, epochs=1)
        evs = rec.events(prefix="xprof/exec")[before:]
        assert any(e["attrs"].get("executable") == "mln/fit_step"
                   for e in evs)


# --- memory watermarks --------------------------------------------------------

class TestWatermarks:
    def test_one_sample_an_epoch_of_fit(self):
        model = _mlp()
        _, _, it = _batches()
        model.fit(it, epochs=3)
        wm = xprof.watermarks()["fit"]
        assert wm["samples"] == 3
        counters = OpProfiler.get().get_counters()
        assert "xprof/live_buffer_bytes" in counters
        assert "xprof/peak_live_bytes/fit" in counters

    def test_rise_and_fall(self, monkeypatch):
        """The peak keeps the largest census; the last follows it down (the
        card's allocator figures, fed here in turn)."""
        seq = iter([1000, 5000, 2000])

        def census():
            live = next(seq)
            return {"host": {}, "devices": [{"bytes_in_use": live}],
                    "live_buffers": {"bytes": live}}

        monkeypatch.setattr(system_info, "memory_summary", census)
        for _ in range(3):
            xprof.memory_watermark("fit")
        wm = xprof.watermarks()["fit"]
        assert wm["peak_live_bytes"] == 5000 == wm["peak_device_bytes"]
        assert wm["last_live_bytes"] == 2000 and wm["samples"] == 3
        led = xprof.ledger()
        assert led["hbm/fit/peak_live_bytes"] == 5000
        evs = flightrec.events(prefix="xprof/hbm")
        assert [e["attrs"]["live_bytes"] for e in evs[-2:]] == [1000, 5000]

    def test_watermark_shares_the_health_census(self):
        census = xprof.memory_watermark("global")
        assert "host" in census and "devices" in census
        assert set(census) == set(system_info.memory_summary())
        evs = flightrec.events(prefix="xprof/hbm")
        assert any(e["attrs"].get("phase") == "global" for e in evs)

    def test_dump_memory_census(self, tmp_path):
        xprof.memory_watermark("fit")
        path = str(tmp_path / "memcensus.json")
        assert xprof.dump_memory_census(path) == path
        blob = json.load(open(path))
        assert blob["watermarks"]["fit"]["samples"] == 1
        assert "census" in blob and "ledger" in blob

    def test_blackbox_dumps_memcensus_alongside(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

        sup = TrainingSupervisor(_mlp(), str(tmp_path))
        xprof.memory_watermark("fit")
        assert sup._dump_blackbox() is not None
        assert os.path.exists(sup.blackbox_path())
        assert os.path.dirname(sup.memcensus_path()) == os.path.dirname(
            sup.blackbox_path())
        blob = json.load(open(sup.memcensus_path()))
        assert "watermarks" in blob and "census" in blob

    def test_health_and_metrics_carry_the_xla_ledger(self):
        from deeplearning4j_tpu_torch.ui.server import (UIServer,
                                                         prometheus_text)

        xprof.set_roof(1e12, 1e11)
        xprof.note_subexec("pallas/update_bucket", flops=1e6,
                           bytes_accessed=1e7)
        assert UIServer().health()["xla"]["pallas/update_bucket/flops"] \
            == 1e6
        assert 'ledger="xla"' in prometheus_text()


# --- the registry -------------------------------------------------------------

class TestRegistryTable:
    def test_registry_is_the_jax_registry(self):
        assert EXPECTED_SITES == sorted(xprof.EXEC_SITES) \
            == sorted(jx.EXEC_SITES)

    def test_registry_covers_every_docstring_site(self):
        for site in xprof.EXEC_SITES:
            assert site in (xprof.__doc__ or ""), site

    def test_registry_entries_carry_desc_and_drill(self):
        for site, meta in xprof.EXEC_SITES.items():
            assert meta["desc"] and meta["drill"], site

    def test_xprof_events_registered(self):
        assert {"xprof/exec", "xprof/hbm"} <= set(flightrec.EVENT_SITES)
