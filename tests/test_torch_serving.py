"""The port's serving tier (deeplearning4j_tpu_torch/parallel/serving.py) on
the CPU, against the JAX package's ServingEngine on the same seeded inputs
and carried weights: the bucket policy, padding, served outputs (within
1e-6 of the JAX engine's), the port's own claim that an answer is bitwise
its padded bucket's forward sliced, oversize requests, sequence ladders,
refresh without new warmup shapes, requeue, retirement and shutdown.

The JAX engine's own claim that a padded bucket is bitwise the forward on
the unpadded rows depends on its BLAS; these tests never compare through
it, only the two packages' answers within a tolerance."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu.common import faultinject as jfi
from deeplearning4j_tpu.data.pipeline import pad_rows as jpad_rows
from deeplearning4j_tpu.parallel import BucketLadder as JLadder
from deeplearning4j_tpu.parallel import OversizeRequest as JOversize
from deeplearning4j_tpu.parallel import ServingEngine as JEngine
from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data.pipeline import pad_rows
from deeplearning4j_tpu_torch.parallel import (BucketLadder,
                                               OversizeRequest,
                                               ServingEngine, serving_health)
from deeplearning4j_tpu_torch.parallel.inference import _Request
from torch_parity import (enable_fused, mln_twins, modules, numpy_tree,
                          residual_conf, twin_graphs)

#: the JAX engine against the port's, float32 on the CPU
ENGINE_TOL = 1e-6
#: the port's served graph against the JAX graph's own output (the graph
#: parity bound of tests/test_torch_graph.py)
GRAPH_RTOL, GRAPH_ATOL = 1e-4, 1e-6


def mlp_conf(which, seed=1, n_in=4, n_out=3):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(m.Adam(0.05)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=n_out))
            .set_input_type(m.InputType.feed_forward(n_in)).build())


def mlp(seed=1):
    m = modules("torch")
    return m.MultiLayerNetwork(mlp_conf("torch", seed)).init(device="cpu")


def two_block_conf(which, channels=8, seed=3):
    """Two conv -> BN(relu) blocks and a softmax head: with the fused
    epilogue on, each BN runs the epilogue (its plain version on the
    CPU)."""
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(seed)
         .updater(m.Sgd(0.01)).fused_epilogue().list())
    for _ in range(2):
        b = b.layer(m.L.ConvolutionLayer(
            n_out=channels, kernel_size=(3, 3), padding=(1, 1),
            activation="identity")).layer(
            m.L.BatchNormalization(activation="relu"))
    return (b.layer(m.L.OutputLayer(n_out=5, activation="softmax",
                                    loss="mcxent"))
            .set_input_type(m.InputType.convolutional(6, 6, 3)).build())


def cnn_twins(seed=7):
    """The JAX network and its port twin with carried weights and the same
    seeded BN affine and statistics."""
    import jax.numpy as jnp

    from deeplearning4j_tpu_torch.util.convert import (
        multilayer_state_from_numpy)

    jn, tn = mln_twins(two_block_conf("jax"), two_block_conf("torch"))
    params = [numpy_tree(d) for d in jn._params]
    states = [numpy_tree(d) for d in jn._states]
    rng = np.random.default_rng(seed)
    for p, st in zip(params, states):
        if "mean" in st:
            c = st["mean"].shape[0]
            p["gamma"] = rng.normal(1.0, 0.1, c).astype(np.float32)
            p["beta"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            st["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    jn._params = [{k: jnp.asarray(v) for k, v in d.items()} for d in params]
    jn._states = [{k: jnp.asarray(v) for k, v in d.items()} for d in states]
    multilayer_state_from_numpy(tn, params, states)
    return jn, tn


def build(model, buckets=(1, 2, 4, 8), workers=1, **kw):
    b = (ServingEngine.Builder(model)
         .buckets(buckets, seq_lens=kw.pop("seq_lens", None),
                  oversize=kw.pop("oversize", "split"))
         .input_shape(kw.pop("input_shape", (4,)))
         .workers(workers).max_wait_ms(kw.pop("max_wait_ms", 2.0))
         .request_timeout_ms(kw.pop("request_timeout_ms", 15000))
         .resurrect_dead_replicas(True, backoff_ms=50))
    if kw.pop("bf16", False):
        b.bf16(True)
    if kw.pop("pin", False):
        b.pin_devices(True).devices(["cpu"] * workers)
    assert not kw, kw
    return b.build()


def jbuild(model, buckets=(1, 2, 4, 8), input_shape=(4,)):
    return (JEngine.Builder(model).buckets(buckets).input_shape(input_shape)
            .workers(1).max_wait_ms(2.0).request_timeout_ms(15000).build())


@pytest.fixture(autouse=True)
def _clean():
    faultinject.clear_plan()
    jfi.clear_plan()
    yield
    faultinject.clear_plan()
    jfi.clear_plan()


class TestBucketLadder:
    @settings(max_examples=60, deadline=None)
    @given(sizes=st.lists(st.integers(1, 64), min_size=1, max_size=6),
           n=st.integers(1, 200), oversize=st.sampled_from(["split",
                                                          "reject"]))
    def test_bucket_and_admit_equal_jax(self, sizes, n, oversize):
        tl, jl = BucketLadder(sizes, oversize=oversize), JLadder(
            sizes, oversize=oversize)
        assert tl.batch_sizes == jl.batch_sizes
        assert tl.bucket_batch(n) == jl.bucket_batch(n)
        try:
            want = jl.admit(n)
        except JOversize:
            with pytest.raises(OversizeRequest):
                tl.admit(n)
        else:
            assert tl.admit(n) == want

    @settings(max_examples=40, deadline=None)
    @given(sizes=st.lists(st.integers(1, 16), min_size=1, max_size=4),
           seqs=st.lists(st.integers(1, 32), min_size=1, max_size=4),
           feat=st.tuples(st.integers(1, 9), st.integers(1, 5)),
           t=st.integers(1, 40))
    def test_shapes_and_seq_equal_jax(self, sizes, seqs, feat, t):
        tl, jl = BucketLadder(sizes, seqs), JLadder(sizes, seqs)
        assert tl.shapes(feat) == jl.shapes(feat)
        assert BucketLadder(sizes).shapes(feat) == JLadder(sizes).shapes(
            feat)
        try:
            want = jl.bucket_seq(t)
        except JOversize:
            with pytest.raises(OversizeRequest, match="sequence length"):
                tl.bucket_seq(t)
        else:
            assert tl.bucket_seq(t) == want

    @pytest.mark.parametrize("args,match", [
        (([0, 2],), "positive"), (([2], None, "explode"), "split.*reject"),
        (([2], [0]), "positive")])
    def test_validation(self, args, match):
        with pytest.raises(ValueError, match=match):
            BucketLadder(*args)
        with pytest.raises(ValueError, match=match):
            JLadder(*args)

    def test_admit_needs_a_row(self):
        with pytest.raises(ValueError, match="at least one row"):
            BucketLadder([1, 2]).admit(0)


class TestPadRows:
    @settings(max_examples=60, deadline=None)
    @given(n=st.integers(1, 9), extra=st.integers(0, 9),
           axis=st.integers(0, 2), seed=st.integers(0, 2 ** 16))
    def test_equal_jax_numpy_and_tensor(self, n, extra, axis, seed):
        shape = [3, 4, 2]
        shape[axis] = n
        a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
        want, jw = jpad_rows(a, n + extra, axis=axis)
        got, w = pad_rows(a, n + extra, axis=axis)
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(w, jw)
        tgot, tw = pad_rows(torch.from_numpy(a), n + extra, axis=axis)
        assert isinstance(tgot, torch.Tensor) and tgot.device.type == "cpu"
        np.testing.assert_array_equal(tgot.numpy(), want)
        np.testing.assert_array_equal(tw, jw)

    def test_full_input_returned_as_is_and_oversize_raises(self):
        a = np.zeros((4, 2), np.float32)
        same, w = pad_rows(a, 4)
        assert same is a and w.sum() == 4
        t = torch.zeros(4, 2)
        assert pad_rows(t, 4)[0] is t
        with pytest.raises(ValueError, match="exceed"):
            pad_rows(np.zeros((5, 2)), 4)


class TestAgainstJax:
    def test_mlp_engine_outputs_match_the_jax_engine(self):
        jn, tn = mln_twins(mlp_conf("jax"), mlp_conf("torch"))
        eng, jeng = build(tn), jbuild(jn)
        try:
            rng = np.random.default_rng(4)
            for n in (1, 3, 5, 8, 11):
                x = rng.normal(size=(n, 4)).astype(np.float32)
                got = eng.output(x)
                want = jeng.output(x).to_numpy()
                assert got.dtype == torch.float32 and tuple(got.shape) == \
                    want.shape
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=ENGINE_TOL)
        finally:
            eng.shutdown()
            jeng.shutdown()

    def test_bn_cnn_engine_matches_the_jax_engine(self):
        jn, tn = cnn_twins()
        prof = OpProfiler.get()
        eng = build(tn, buckets=(2, 4), input_shape=(3, 6, 6))
        jeng = jbuild(jn, buckets=(2, 4), input_shape=(3, 6, 6))
        try:
            f0 = prof.counter_value("serving/forwards")
            h0 = prof.counter_value("precision/epilogue_hits")
            fb0 = prof.counter_value("precision/epilogue_fallbacks")
            for n in (1, 3, 4):
                x = np.random.default_rng(6 + n).normal(
                    size=(n, 3, 6, 6)).astype(np.float32)
                got = eng.output(x).numpy()
                want = jeng.output(x).to_numpy()
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=ENGINE_TOL)
            # the epilogue's plain version: 2 BN layers a bucket forward
            forwards = prof.counter_value("serving/forwards") - f0
            assert forwards == 3 and prof.counter_value(
                "precision/epilogue_hits") - h0 == 2 * forwards
            assert prof.counter_value("precision/epilogue_fallbacks") == fb0
        finally:
            eng.shutdown()
            jeng.shutdown()


class TestGraphServing:
    """A port extension: the JAX engine calls the MultiLayerNetwork
    ``_forward`` signature, which a ComputationGraph (a dict of inputs)
    refuses at warmup; the port's ``forward_bucket`` serves both."""

    def test_jax_engine_cannot_serve_a_graph_beside_the_port(self):
        from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph

        jg = JGraph(residual_conf("jax", True, 8)).init()
        with pytest.raises(TypeError, match="string indexing"):
            jbuild(jg, buckets=(2,), input_shape=(4, 8, 8))

    def test_port_serves_the_residual_graph_on_the_epilogue(self):
        jg, tg = twin_graphs(residual_conf("jax", True, 8),
                             residual_conf("torch", True, 8))
        enable_fused(jg, "jax")
        enable_fused(tg, "torch")
        prof = OpProfiler.get()
        eng = build(tg, buckets=(2, 4), input_shape=(4, 8, 8))
        try:
            h0 = prof.counter_value("precision/epilogue_hits")
            fb0 = prof.counter_value("precision/epilogue_fallbacks")
            x = np.random.default_rng(3).normal(
                size=(3, 4, 8, 8)).astype(np.float32)
            got = eng.output(x)
            padded, _ = pad_rows(x, 4)
            assert torch.equal(got, eng.forward_bucket(
                *eng._dev_params[0], torch.from_numpy(padded))[:3])
            want = np.asarray(jg.output(x)[0].value)
            np.testing.assert_allclose(got.numpy(), want, rtol=GRAPH_RTOL,
                                       atol=GRAPH_ATOL)
            # both BNs run the epilogue (the tail fused with the residual
            # and relu, the shortcut's alone), in the served forward and in
            # the comparison's
            assert prof.counter_value("precision/epilogue_hits") - h0 == 4
            assert prof.counter_value("precision/epilogue_fallbacks") == fb0
        finally:
            eng.shutdown()


class TestServingEngine:
    @pytest.mark.parametrize("bf16", [False, True])
    def test_answer_is_bitwise_its_padded_bucket_sliced(self, bf16):
        model = mlp()
        eng = build(model, buckets=(8,), bf16=bf16)
        try:
            for n in (1, 3, 5, 8):
                x = np.random.default_rng(n).normal(size=(n, 4)).astype(
                    np.float32)
                got = eng.output(x)
                padded, _ = pad_rows(x, 8)
                want = eng.forward_bucket(*eng._dev_params[0],
                                          torch.from_numpy(padded))[:n]
                assert torch.equal(got, want)
                assert got.dtype == torch.float32
            if bf16:
                assert all(t.dtype == torch.bfloat16
                           for d in eng._dev_params[0][0].values()
                           for t in d.values())
        finally:
            eng.shutdown()

    def test_one_first_forward_per_bucket_and_slot_then_flat(self):
        prof = OpProfiler.get()
        before = prof.counter_value("trace/serving_infer")
        eng = build(mlp(), buckets=(1, 2, 4, 8), workers=2, pin=True)
        try:
            assert prof.counter_value("trace/serving_infer") - before == 8
            assert len(eng.warmup_timings) == 8
            futs = [eng.output_async(
                np.random.randn((i % 4) + 1, 4).astype(np.float32))
                for i in range(24)]
            for f in futs:
                f.result(timeout=15)
            assert prof.counter_value("trace/serving_infer") - before == 8
            assert eng._traces_seen == eng._trace_cell[0] == 8
        finally:
            eng.shutdown()

    def test_a_bucket_missed_by_warmup_sets_the_alarm(self):
        model = mlp()
        eng = build(model, buckets=(2, 4))
        try:
            a0 = OpProfiler.get().counter_value("serving/traces_after_warmup")
            del eng._exec[((4, 4), 0)]        # as if warmup had missed it
            eng.output(np.zeros((3, 4), np.float32))
            assert OpProfiler.get().counter_value(
                "serving/traces_after_warmup") == a0 + 1
        finally:
            eng.shutdown()

    def test_oversize_split_concatenates_in_order(self):
        model = mlp()
        eng = build(model, buckets=(1, 2, 4))
        try:
            x = np.linspace(-1, 1, 11 * 4, dtype=np.float32).reshape(11, 4)
            out = eng.output(x)                     # 11 -> 4 + 4 + 3
            assert tuple(out.shape) == (11, 3)
            parts = [eng.forward_bucket(*eng._dev_params[0], torch.from_numpy(
                pad_rows(x[i:j], 4)[0]))[:j - i]
                for i, j in ((0, 4), (4, 8), (8, 11))]
            assert torch.equal(out, torch.cat(parts))
            assert OpProfiler.get().counter_value(
                "serving/oversize_split") >= 1
        finally:
            eng.shutdown()

    def test_oversize_reject_and_shape_validation(self):
        eng = build(mlp(), buckets=(1, 2, 4), oversize="reject")
        try:
            with pytest.raises(OversizeRequest):
                eng.output_async(np.zeros((5, 4), np.float32))
            with pytest.raises(ValueError, match="rank"):
                eng.output_async(np.zeros((3,), np.float32))
            with pytest.raises(ValueError, match="feature shape"):
                eng.output_async(np.zeros((2, 5), np.float32))
            with pytest.raises(ValueError, match="at least one row"):
                eng.output_async(np.zeros((0, 4), np.float32))
            with pytest.raises(ValueError, match="no SLO classes"):
                eng.output_async(np.zeros((1, 4), np.float32),
                                 slo_class="gold")
        finally:
            eng.shutdown()

    def test_builder_refuses_other_modes_and_needs_a_shape(self):
        with pytest.raises(ValueError, match="batched"):
            ServingEngine.Builder(mlp()).inference_mode("sequential")
        with pytest.raises(ValueError, match="input_shape"):
            ServingEngine.Builder(mlp()).build()

    def test_model_without_forward_serves_through_output(self):
        class Doubler:
            calls = 0

            def output(self, batch):
                Doubler.calls += 1
                return np.asarray(batch) * 2.0

        eng = build(Doubler(), buckets=(4,))
        try:
            assert Doubler.calls == 1              # one warmup run
            x = np.random.randn(3, 4).astype(np.float32)
            for _ in range(3):
                np.testing.assert_array_equal(eng.output(x).numpy(), x * 2)
            assert Doubler.calls == 4
            with pytest.raises(RuntimeError, match="functional forward"):
                eng.publish_checkpoint("nowhere.zip")
        finally:
            eng.shutdown()

    def test_seq_ladder_pads_time_and_slices_it_back(self):
        class PerStep:
            def output(self, batch):
                return np.asarray(batch).sum(-1, keepdims=True)

        eng = build(PerStep(), buckets=(2,), seq_lens=(4, 8),
                    input_shape=(8, 3))
        try:
            x = np.random.randn(1, 3, 3).astype(np.float32)   # t 3 -> 4
            out = eng.output(x).numpy()
            assert out.shape == (1, 3, 1)
            np.testing.assert_allclose(out, x.sum(-1, keepdims=True),
                                       rtol=1e-6)
            assert OpProfiler.get().counter_value("serving/seq_padded") >= 1
            with pytest.raises(OversizeRequest):
                eng.output_async(np.zeros((1, 9, 3), np.float32))
        finally:
            eng.shutdown()

    def test_pooled_seq_output_matching_a_rung_is_not_sliced(self):
        class Pooled:
            def output(self, batch):      # [n, t, 8] -> [n, 8]
                return np.asarray(batch).sum(axis=1)

        eng = build(Pooled(), buckets=(2,), seq_lens=(4, 8),
                    input_shape=(8, 8))
        try:
            out = eng.output(np.zeros((1, 5, 8), np.float32))
            assert tuple(out.shape) == (1, 8)
        finally:
            eng.shutdown()

    def test_refresh_params_swaps_without_new_warmup_shapes(self):
        prof = OpProfiler.get()
        model = mlp()
        eng = build(model, buckets=(4,))
        try:
            traces = prof.counter_value("trace/serving_infer")
            shapes = set(eng._exec)
            x = np.random.randn(2, 4).astype(np.float32)
            before = eng.output(x)
            with torch.no_grad():
                for d in model._params.values():
                    for t in d.values():
                        t.add_(0.25)
            # the slots hold a snapshot: nothing changes until the refresh
            assert torch.equal(eng.output(x), before)
            eng.refresh_params()
            after = eng.output(x)
            assert not torch.equal(before, after)
            want = eng.forward_bucket(*eng._dev_params[0], torch.from_numpy(
                pad_rows(x, 4)[0]))[:2]
            assert torch.equal(after, want)
            assert prof.counter_value("trace/serving_infer") == traces
            assert set(eng._exec) == shapes
        finally:
            eng.shutdown()

    def test_enqueue_fault_index_is_the_request_ordinal(self):
        eng = build(mlp(), buckets=(1, 2))
        try:
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/enqueue", "kind": "transient",
                  "index": 1}]))
            eng.output(np.zeros((3, 4), np.float32))   # ordinal 0, split
            with pytest.raises(faultinject.TransientFault):
                eng.output_async(np.zeros((1, 4), np.float32))
        finally:
            eng.shutdown()

    def test_transient_dispatch_fault_requeues_and_recovers(self):
        model = mlp()
        eng = build(model, buckets=(2,))
        try:
            r0 = OpProfiler.get().counter_value("serving/requeued")
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/dispatch", "kind": "transient",
                  "index": eng._batch_seq}]))
            x = np.random.randn(2, 4).astype(np.float32)
            out = eng.output(x)
            want = eng.forward_bucket(*eng._dev_params[0],
                                      torch.from_numpy(x))
            assert torch.equal(out, want)
            assert OpProfiler.get().counter_value("serving/requeued") == \
                r0 + 1
        finally:
            eng.shutdown()

    def test_mid_load_retirement_zero_failed_requests(self):
        prof = OpProfiler.get()
        retired0 = prof.counter_value("inference/replica_retired")
        res0 = prof.counter_value("inference/replica_resurrected")
        eng = build(mlp(), buckets=(1, 2, 4, 8), workers=2, pin=True)
        try:
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/dispatch", "kind": "dead_replica",
                  "index": 2}]))
            x = np.random.randn(2, 4).astype(np.float32)
            futs = [eng.output_async(x) for _ in range(40)]
            outs = [f.result(timeout=20) for f in futs]
            want = eng.forward_bucket(*eng._dev_params[0],
                                      torch.from_numpy(x))
            # requests coalesce into larger buckets: a row's rounding may
            # move with the batch size, so within 1e-6, not bitwise
            assert all(torch.allclose(o, want, rtol=0, atol=1e-6)
                       for o in outs)
            assert prof.counter_value("inference/replica_retired") == \
                retired0 + 1
            assert prof.counter_value("serving/requeued") >= 1
            faultinject.clear_plan()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and (
                    eng.alive_replicas() < 2 or len(eng._dev_of) < 2):
                time.sleep(0.02)
            assert prof.counter_value("inference/replica_resurrected") == \
                res0 + 1
            # the replacement took over the dead worker's device slot
            assert sorted(eng._dev_of.values()) == [0, 1]
            names = [e["name"] for e in flightrec.events("serving/retire")]
            assert names
        finally:
            eng.shutdown()

    def test_deadline_under_a_wedged_replica_reports_queue_time(self):
        eng = build(mlp(), workers=1, request_timeout_ms=300)
        try:
            faultinject.set_plan(faultinject.FaultPlan(
                [{"site": "serving/dispatch", "kind": "slow",
                  "seconds": 0.5}]))
            t0 = time.monotonic()
            with pytest.raises(TimeoutError) as ei:
                eng.output(np.zeros((1, 4), np.float32))
            assert time.monotonic() - t0 < 0.5 + 0.4
            msg = str(ei.value)
            assert "in queue" in msg and "replicas alive" in msg
        finally:
            eng.shutdown()

    def test_shutdown_drains_in_flight_then_fails_queued(self):
        class Slow:
            def output(self, batch):
                time.sleep(0.3)
                return np.asarray(batch) + 1.0

        eng = build(Slow(), buckets=(1,), workers=1, max_wait_ms=1.0)
        try:
            in_flight = eng.output_async(np.zeros((1, 4), np.float32))
            time.sleep(0.15)              # the worker picked it up
            queued = [eng.output_async(np.zeros((1, 4), np.float32))
                      for _ in range(3)]
        finally:
            eng.shutdown(drain_timeout_s=3.0)
        np.testing.assert_array_equal(in_flight.result(timeout=0).numpy(),
                                      np.ones((1, 4)))
        for f in queued:
            with pytest.raises(RuntimeError, match="still queued"):
                f.result(timeout=0)
        assert all(not t.is_alive() for t in eng._workers)

    def test_shutdown_fails_stashed_requests_too(self):
        eng = build(mlp(), buckets=(2,))
        eng.shutdown()
        fut = Future()
        fut.enqueued_at = time.monotonic()
        eng._stash(_Request(np.zeros((1, 4), np.float32), fut, 0,
                            fut.enqueued_at))
        assert eng._fail_queued(RuntimeError("still queued")) == 1
        with pytest.raises(RuntimeError, match="still queued"):
            fut.result(timeout=0)

    def test_ledger_health_and_census(self):
        prof = OpProfiler.get()
        prof.reset()
        eng = build(mlp(), buckets=(1, 2, 4))
        try:
            for _ in range(5):
                eng.output(np.zeros((3, 4), np.float32))
            stats = prof.serving_stats()
            assert stats["requests"] == 5 and stats["batches"] >= 1
            assert stats["pad_waste"] == pytest.approx(
                1 - stats["fill_ratio"])
            assert stats["warmup_count"] == 1
            health = serving_health()
            assert health["engines"] >= 1 and health["latency_p99_ms"] > 0
            mine = [e for e in health["engine_stats"]
                    if e["buckets_compiled"] == 3]
            assert mine and mine[0]["warm"] and mine[0]["window"] == 5
            n = health["engines"]
        finally:
            eng.shutdown()
        assert serving_health()["engines"] == n - 1

    def test_queue_depth_hwm_is_windowed_and_peak_is_lifetime(self):
        eng = build(mlp(), buckets=(1,))
        try:
            eng._qwin_s = 0.05
            eng._qwin_update(50)
            assert eng.queue_depth_hwm() == 50
            assert eng.serving_stats()["queue_depth_peak"] == 50
            time.sleep(0.12)
            assert eng.queue_depth_hwm() == 0
            assert eng.queue_depth_peak == 50
        finally:
            eng.shutdown()

    def test_request_lifecycle_in_the_flight_recorder(self):
        eng = build(mlp(), buckets=(2,))
        try:
            flightrec.reset()
            eng.output(np.zeros((2, 4), np.float32))
            seq = eng._req_seq - 1
            names = [e["name"] for e in flightrec.events(corr=f"req{seq}")]
            assert names == ["serving/enqueue", "serving/reply"]
            assert flightrec.events("serving/batch")[-1]["attrs"]["reqs"] \
                == [seq]
        finally:
            eng.shutdown()

    def test_stress_every_client_gets_its_own_rows(self):
        """More workers than cores, a short switch interval, clients
        racing the drain loops, the stash and the admission counts: every
        answer is its own request's, the ledger counts every request, and
        the class budget's reservations all come back."""
        import os
        import sys

        from deeplearning4j_tpu_torch.parallel import SLOClass

        workers = (os.cpu_count() or 4) + 2
        eng = (ServingEngine.Builder(mlp()).buckets((1, 2, 4, 8))
               .input_shape((4,)).workers(workers).max_wait_ms(1.0)
               .request_timeout_ms(30000).queue_limit(512)
               .slo_classes([SLOClass("gold", 1, 1e6, queue_budget=10 ** 6)])
               .brownout(interval_s=60.0).build())
        prof = OpProfiler.get()
        r0 = prof.counter_value("serving/requests")
        rows = {n: eng.forward_bucket(*eng._dev_params[0], torch.from_numpy(
            np.full((1, 4), float(n), np.float32)))[0] for n in range(8)}
        errors, clients, per = [], 8, 25
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)

        def client(k):
            try:
                for i in range(per):
                    v = (k + i) % 8
                    n = 1 + (k * 7 + i) % 11          # 1..11: splits too
                    got = eng.output(np.full((n, 4), float(v), np.float32))
                    # another request's rows differ by far more than
                    # the 1e-6 a batch size can move a row's rounding
                    if tuple(got.shape) != (n, 3) or not all(
                            torch.allclose(g, rows[v], rtol=0, atol=1e-6)
                            for g in got):
                        errors.append((k, i))
            except Exception as e:           # reported below
                errors.append(repr(e))

        ts = [threading.Thread(target=client, args=(k,))
              for k in range(clients)]
        try:
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
            assert not errors, errors[:5]
            chunks = sum(len(eng.ladder.admit(1 + (k * 7 + i) % 11))
                         for k in range(clients) for i in range(per))
            assert prof.counter_value("serving/requests") - r0 == chunks
            assert _wait_for(lambda: eng._adm.stats()["outstanding"]
                             == {"gold": 0})
        finally:
            sys.setswitchinterval(switch)
            eng.shutdown()
        assert not any(t.is_alive() for t in eng._workers)


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.slow
class TestPoissonLoad:
    def test_open_loop_poisson_never_fails_or_rewarms(self):
        """The counterpart of the JAX package's slow Poisson test."""
        prof = OpProfiler.get()
        eng = build(mlp(), buckets=(1, 2, 4, 8), workers=2)
        traces0 = prof.counter_value("trace/serving_infer")
        r = np.random.RandomState(3)
        lat, failures = [], []
        lock = threading.Lock()
        try:
            gaps = r.exponential(1 / 120.0, 240)
            t_next = time.monotonic()
            futs = []
            for i in range(240):
                t_next += gaps[i]
                d = t_next - time.monotonic()
                if d > 0:
                    time.sleep(d)
                fut = eng.output_async(
                    np.random.randn(r.randint(1, 5), 4).astype(np.float32))

                def on_done(f, t_sub=t_next):
                    with lock:
                        if f.exception() is not None:
                            failures.append(str(f.exception()))
                        else:
                            lat.append(time.monotonic() - t_sub)

                fut.add_done_callback(on_done)
                futs.append(fut)
            for f in futs:
                f.exception(timeout=20)
            assert not failures, failures[:3]
            assert float(np.percentile(np.asarray(lat) * 1e3, 99)) < 500.0
            assert prof.counter_value("trace/serving_infer") == traces0
        finally:
            eng.shutdown()
