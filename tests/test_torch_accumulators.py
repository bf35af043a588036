"""The port's gradient accumulators and ZeRO-1 layout against the JAX
package's (``tests/test_accumulator_sharding.py``): the threshold
algorithms' update rules, the flat bucket layout and its resharding across
replica counts, ZeRO-1 bitwise to the dense exchange inside the port
(plain fit, multi-step dispatch, kill and resume, resume under another
replica count), the encoded exchange's error feedback, and the collective
ledger with the sharded telemetry. On the CPU: the port's device pool is
the CPU device 8 times, the JAX side its 8 virtual CPU devices."""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIter
from deeplearning4j_tpu.ndarray.rng import set_default_seed
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JScores)
from deeplearning4j_tpu.parallel import (
    AdaptiveThresholdAlgorithm as JAdaptive,
    EncodedGradientsAccumulator as JEncoded,
    FixedThresholdAlgorithm as JFixed, ParallelWrapper as JPW,
    ReduceScatterAccumulator as JRS,
    TargetSparsityThresholdAlgorithm as JTarget, Zero1Plan as JPlan,
    make_mesh as jmake_mesh)
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.learning.updaters import GradientUpdater
from deeplearning4j_tpu_torch.optimize import TelemetrySink
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresIterationListener)
from deeplearning4j_tpu_torch.parallel import (
    AdaptiveThresholdAlgorithm, EncodedGradientsAccumulator,
    FixedThresholdAlgorithm, ParallelWrapper, ReduceScatterAccumulator,
    TargetSparsityThresholdAlgorithm, Zero1Plan, unflatten_updater_state)
from deeplearning4j_tpu_torch.parallel.sharding import is_flat_state
from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage
from torch_parity import mln_twins, modules


@pytest.fixture(autouse=True)
def _clean():
    OpProfiler.get().reset()
    yield


def small_conf(which, updater=None, seed=5):
    m = modules(which)
    u = updater(m) if updater is not None else m.Adam(learning_rate=0.05)
    return (m.NeuralNetConfiguration.builder().seed(seed).updater(u)
            .activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=9))      # odd widths: uneven leaves
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())


def twins(updater=None, seed=5):
    return mln_twins(small_conf("jax", updater, seed),
                     small_conf("torch", updater, seed))


def small_model(updater=None, seed=5):
    return twins(updater, seed)[1]


SGD = lambda m: m.Sgd(learning_rate=0.1)  # noqa: E731
ADAM = lambda m: m.Adam(learning_rate=0.05)  # noqa: E731


def make_iter(cls=NDArrayDataSetIterator, n=64, batch=16):
    rng = np.random.RandomState(7)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return cls(x, y, batch_size=batch, shuffle=True, seed=3)


class _Crash(RuntimeError):
    pass


class CrashAt:
    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            raise _Crash(iteration)


def run_wrapper(acc, workers=4, epochs=2, updater=None, spd=1,
                listeners=(), resume_from=None, model=None, crash_at=None):
    """One port wrapper fit; returns (losses, model, wrapper)."""
    if model is None:
        model = small_model(updater)
    scores = CollectScoresIterationListener()
    b = ParallelWrapper.Builder(model).workers(workers)
    if acc is not None:
        b.gradients_accumulator(acc)
    pw = b.build()
    extra = [CrashAt(crash_at)] if crash_at is not None else []
    pw.set_listeners(scores, *listeners, *extra)
    if crash_at is not None:
        with pytest.raises(_Crash):
            pw.fit(make_iter(), epochs=epochs, steps_per_dispatch=spd,
                   resume_from=resume_from)
        return None, model, pw
    pw.fit(make_iter(), epochs=epochs, steps_per_dispatch=spd,
           resume_from=resume_from)
    return [s for _, s in scores.scores], model, pw


def run_jax(jn, acc, workers=4, epochs=2, spd=1):
    set_default_seed(99)
    scores = JScores()
    b = JPW.Builder(jn).workers(workers)
    if acc is not None:
        b.gradients_accumulator(acc)
    pw = b.build()
    pw.set_listeners(scores)
    pw.fit(make_iter(JIter), epochs=epochs, steps_per_dispatch=spd)
    return [float(s) for _, s in scores.scores]


def bitwise(a, b) -> bool:
    return leaf_paths(a) == leaf_paths(b) and all(
        torch.equal(get_path(a, p), get_path(b, p)) for p in leaf_paths(a))


# ---------------------------------------------------------------------------
# threshold algorithms
# ---------------------------------------------------------------------------

def t32(v):
    return torch.tensor(v, dtype=torch.float32)


class TestThresholdAlgorithms:
    def test_fixed_threshold_never_moves(self):
        alg = FixedThresholdAlgorithm(initial_threshold=1e-2)
        t = t32(alg.initial())
        for d in (0.0, 1e-3, 0.5, 1.0):
            t = alg.update(t, t32(d))
        assert float(t) == pytest.approx(1e-2)

    def test_adaptive_raises_threshold_when_too_dense(self):
        kw = dict(initial_threshold=1e-3, max_density=1e-2, decay=0.95)
        new = AdaptiveThresholdAlgorithm(**kw).update(t32(1e-3), t32(0.5))
        assert float(new) == pytest.approx(1e-3 / 0.95)
        want = JAdaptive(**kw).update(jnp.float32(1e-3), jnp.float32(0.5))
        assert float(new) == float(want)

    def test_adaptive_lowers_threshold_when_starving(self):
        kw = dict(initial_threshold=1e-3, min_density=1e-4, decay=0.95)
        new = AdaptiveThresholdAlgorithm(**kw).update(t32(1e-3), t32(1e-5))
        assert float(new) == pytest.approx(1e-3 * 0.95)
        want = JAdaptive(**kw).update(jnp.float32(1e-3), jnp.float32(1e-5))
        assert float(new) == float(want)

    def test_adaptive_holds_inside_band(self):
        alg = AdaptiveThresholdAlgorithm(min_density=1e-4, max_density=1e-2)
        assert float(alg.update(t32(5e-3), t32(1e-3))) \
            == pytest.approx(5e-3)

    def test_adaptive_clips_to_bounds(self):
        kw = dict(decay=0.5, min_threshold=1e-4, max_threshold=1e-2)
        alg, jalg = AdaptiveThresholdAlgorithm(**kw), JAdaptive(**kw)
        for start, dens, bound in ((9e-3, 1.0, 1e-2), (2e-4, 0.0, 1e-4)):
            t, jt = t32(start), jnp.float32(start)
            for _ in range(10):
                t = alg.update(t, t32(dens))
                jt = jalg.update(jt, jnp.float32(dens))
            assert float(t) == pytest.approx(bound)
            assert float(t) == float(jt)

    def test_target_sparsity_is_proportional_control(self):
        kw = dict(sparsity_target=1e-3, gain=0.25)
        alg, jalg = TargetSparsityThresholdAlgorithm(**kw), JTarget(**kw)
        up = float(alg.update(t32(1e-3), t32(1e-2)))
        down = float(alg.update(t32(1e-3), t32(1e-4)))
        hold = float(alg.update(t32(1e-3), t32(1e-3)))
        assert up > 1e-3 and down < 1e-3
        assert hold == pytest.approx(1e-3, rel=1e-4)
        near = float(alg.update(t32(1e-3), t32(2e-3)))
        assert 1e-3 < near < up
        for d, got in ((1e-2, up), (1e-4, down), (2e-3, near)):
            want = float(jalg.update(jnp.float32(1e-3), jnp.float32(d)))
            assert got == pytest.approx(want, rel=2e-7)

    def test_updates_take_tensors_and_numbers(self):
        """The JAX rules are traced; the port's run eagerly on 0-dim
        tensors or Python numbers alike."""
        for alg in (AdaptiveThresholdAlgorithm(),
                    TargetSparsityThresholdAlgorithm(),
                    FixedThresholdAlgorithm()):
            for t, d in ((t32(1e-3), t32(0.5)), (1e-3, 0.5)):
                out = alg.update(t, d)
                assert np.isfinite(float(out))


# ---------------------------------------------------------------------------
# the flat bucket layout
# ---------------------------------------------------------------------------

def _np_tree():
    rng = np.random.RandomState(3)
    return [{"W": rng.randn(5, 9).astype(np.float32),
             "b": rng.randn(9).astype(np.float32)},
            {"W": rng.randn(9, 3).astype(np.float32),
             "b": rng.randn(3).astype(np.float32)}]


def _tree():
    return {f"{i:04d}": {k: torch.from_numpy(v.copy()) for k, v in d.items()}
            for i, d in enumerate(_np_tree())}


class TestZero1Plan:
    def test_flatten_unflatten_roundtrip(self):
        tree = _tree()
        plan = Zero1Plan(tree, 4)
        assert bitwise(plan.unflatten(plan.flatten(tree)), tree)
        # the same elements in the same places as the JAX package's bucket
        jflat = JPlan(_np_tree(), 4).flatten(_np_tree(), xp=np)
        for k, v in plan.flatten(tree).items():
            np.testing.assert_array_equal(v.numpy(), jflat[k])

    def test_buckets_pad_to_shard_multiple(self):
        tree = _tree()     # 45 + 9 + 27 + 3 = 84 elements
        for align in (1, 4):
            plan = Zero1Plan(tree, 8, shard_align=align)
            for b in plan.buckets:
                assert b.padded % (8 * align) == 0
                assert b.padded - b.total < 8 * align
                assert b.shard == b.padded // 8
        jb = JPlan(_np_tree(), 8).buckets[0]
        b = Zero1Plan(tree, 8).buckets[0]
        assert (b.total, b.padded, b.shard) == (jb.total, jb.padded,
                                                jb.shard)

    def test_layout_is_replica_count_independent(self):
        tree = _tree()
        f4 = Zero1Plan(tree, 4).flatten(tree)
        f2 = Zero1Plan(tree, 2).flatten(tree)
        total = Zero1Plan(tree, 4).buckets[0].total
        for k in f4:
            assert torch.equal(f4[k][:total], f2[k][:total])

    def test_shard_slices_cover_bucket(self):
        tree = _tree()
        plan = Zero1Plan(tree, 4)
        flat = plan.flatten(tree)
        parts = [plan.shard_slice(flat, i) for i in range(4)]
        for b in plan.buckets:
            assert torch.equal(torch.cat([p[b.key] for p in parts]),
                               flat[b.key])
        # the segment ids map every position to its layer (pad: slot L)
        seg = torch.cat([plan.shard_segment_ids(b.key, i, b.shard)
                         for i in range(4)])
        assert seg.tolist() == [0] * 54 + [1] * 30 + [2] * 0
        seg8 = Zero1Plan(tree, 8).shard_segment_ids(b.key, 7, 11)
        assert seg8.tolist() == [1] * 7 + [2] * 4

    def test_reshard_state_across_worker_counts(self):
        tree = _tree()
        dense_state = {"m": _tree(), "v": _tree()}
        p4, p2 = Zero1Plan(tree, 4), Zero1Plan(tree, 2)
        flat4 = p4.flatten_state(dense_state)
        assert is_flat_state(flat4)
        back = p2.unflatten_state(p2.reshard_state(flat4))
        for s in dense_state:
            assert bitwise(back[s], dense_state[s])
            assert bitwise(unflatten_updater_state(flat4, tree)[s],
                           dense_state[s])

    def test_truncated_bucket_refused(self):
        tree = _tree()
        plan = Zero1Plan(tree, 2)
        flat = plan.flatten_state({"m": _tree()})
        key = plan.buckets[0].key
        flat["m"][key] = flat["m"][key][:5]
        with pytest.raises(ValueError, match="does not match"):
            plan.reshard_state(flat)


# ---------------------------------------------------------------------------
# ZeRO-1 against the dense exchange
# ---------------------------------------------------------------------------

class TestZero1Parity:
    @pytest.mark.parametrize("updater", [SGD, ADAM], ids=["sgd", "adam"])
    def test_bitwise_loss_and_param_parity(self, updater):
        jn, tn = twins(updater)
        dense, md, _ = run_wrapper(None, model=tn)
        z1, mz, _ = run_wrapper(ReduceScatterAccumulator(), updater=updater)
        assert z1 == dense
        assert bitwise(md._params, mz._params)
        # the JAX package's ZeRO-1 run on the same parameters and batches
        want = run_jax(jn, JRS())
        np.testing.assert_allclose(z1, want, rtol=1e-5, atol=1e-6)

    def test_chunked_dispatch_parity(self):
        dense, _, _ = run_wrapper(None, spd=2)
        z1, _, _ = run_wrapper(ReduceScatterAccumulator(), spd=2)
        per_step, _, _ = run_wrapper(ReduceScatterAccumulator())
        assert z1 == dense == per_step

    def test_updater_state_is_sharded_one_over_n(self):
        prof = OpProfiler.get()
        _, m, pw = run_wrapper(ReduceScatterAccumulator(), workers=4)
        total = prof.counter_value("zero1/updater_state_bytes_total")
        per = prof.counter_value("zero1/updater_state_bytes_per_replica")
        assert total > 0 and per == total // 4
        assert is_flat_state(m._updater_state)
        shard = pw._plan.buckets[0].shard
        for r in range(4):
            leaves = [t for d in pw.replica_updater_state(r).values()
                      for t in d.values()]
            assert leaves and all(t.numel() == shard for t in leaves)
            assert sum(t.numel() * t.element_size() for t in leaves) == per

    def test_kill_and_resume_parity(self, tmp_path):
        base, _, _ = run_wrapper(ReduceScatterAccumulator())
        cl = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        run_wrapper(ReduceScatterAccumulator(), listeners=[cl], crash_at=5)
        cl.close()
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        assert last is not None
        resumed, _, _ = run_wrapper(ReduceScatterAccumulator(),
                                    model=small_model(seed=17),
                                    resume_from=last)
        assert resumed == base

    def test_resume_with_changed_worker_count(self, tmp_path):
        """The on-disk updater layout is the dense tree: a ZeRO-1
        checkpoint from 4 workers restores into 2, and the ZeRO-1
        continuation equals the dense one bit for bit."""
        cl = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        run_wrapper(ReduceScatterAccumulator(), workers=4, listeners=[cl],
                    crash_at=5)
        cl.close()
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        assert last is not None
        z1, mz, _ = run_wrapper(ReduceScatterAccumulator(), workers=2,
                                model=small_model(seed=17), resume_from=last)
        dense, md, _ = run_wrapper(None, workers=2,
                                   model=small_model(seed=23),
                                   resume_from=last)
        assert z1 == dense
        assert bitwise(md._params, mz._params)
        assert mz._ckpt_workers == 4

    def test_single_device_fit_accepts_zero1_handoff(self):
        _, m, _ = run_wrapper(ReduceScatterAccumulator(), epochs=1)
        assert is_flat_state(m._updater_state)
        m.fit(make_iter(), epochs=1)
        assert not is_flat_state(m._updater_state)
        assert np.isfinite(m.score_value)

    def test_non_elementwise_updater_refused(self):
        class Whitening(GradientUpdater):
            elementwise = False

            def __init__(self):
                self.learning_rate = 0.1

            def apply(self, grads, state, params, it):
                return params, state

        m = small_model()
        m.conf.global_conf.updater = Whitening()
        pw = (ParallelWrapper.Builder(m).workers(4)
              .gradients_accumulator(ReduceScatterAccumulator()).build())
        with pytest.raises(NotImplementedError, match="elementwise"):
            pw.fit(make_iter(), epochs=1)

    def test_model_axis_composition_refused(self):
        pw = (ParallelWrapper.Builder(small_model()).workers(4)
              .model_axis(2)
              .gradients_accumulator(ReduceScatterAccumulator()).build())
        with pytest.raises(NotImplementedError, match="replicated params"):
            pw.fit(make_iter(), epochs=1)


# ---------------------------------------------------------------------------
# the encoded exchange
# ---------------------------------------------------------------------------

def placed_state(acc, n, width=3):
    st = acc.init_state({"w": torch.zeros(width)}, n_shards=n)
    return {"residual": [{"w": st["residual"]["w"][r].clone()}
                         for r in range(n)],
            **{k: v for k, v in st.items() if k != "residual"}}


def jax_exchange_harness(acc, n=2):
    """``acc.exchange`` of the JAX package inside a small shard_map."""
    mesh = jmake_mesh(data=n, devices=jax.devices()[:n])
    aspec = acc.state_specs({"w": np.zeros((3,), np.float32)})

    def call(grads_stack, state):
        def f(g, st):
            red, new_st, dens = acc.exchange(
                jax.tree.map(lambda a: a[0], g), st, "data")
            return (jax.tree.map(lambda a: a[None], red), new_st,
                    jnp.reshape(dens, (1,)))

        return shard_map(f, mesh=mesh, in_specs=(P("data"), aspec),
                         out_specs=(P("data"), aspec, P("data")),
                         check_rep=False)(grads_stack, state)

    def place(state):
        leaves, treedef = jax.tree.flatten(state)
        specs = jax.tree.flatten(
            aspec, is_leaf=lambda s: isinstance(s, P))[0]
        return jax.tree.unflatten(treedef, [
            jax.device_put(jnp.asarray(l), NamedSharding(mesh, s))
            for l, s in zip(leaves, specs)])
    return call, place


class TestEncodedExchange:
    def test_error_feedback_residual_carry(self):
        """Mass under the threshold is carried until it crosses it; then
        +-t is sent and the overshoot stays: step for step the JAX
        package's values."""
        acc = EncodedGradientsAccumulator(
            threshold_algorithm=FixedThresholdAlgorithm(
                initial_threshold=1.0))
        jacc = JEncoded(threshold_algorithm=JFixed(initial_threshold=1.0))
        call, place = jax_exchange_harness(jacc)
        jstate = place(jacc.init_state({"w": np.zeros((3,), np.float32)},
                                       n_shards=2))
        state = placed_state(acc, 2)
        g = [{"w": torch.tensor([0.4, -0.4, 0.0])} for _ in range(2)]
        jg = {"w": jnp.broadcast_to(jnp.asarray([0.4, -0.4, 0.0],
                                                jnp.float32), (2, 3))}
        for expect_res in (0.4, 0.8):
            red, state, dens = acc.exchange(g, state)
            jred, jstate, jdens = call(jg, jstate)
            assert all(torch.equal(r["w"], torch.zeros(3)) for r in red)
            assert float(dens) == 0.0 == float(jdens[0])
            for r in range(2):
                res = state["residual"][r]["w"]
                assert res[0].item() == pytest.approx(expect_res)
                assert res[1].item() == pytest.approx(-expect_res)
                np.testing.assert_array_equal(
                    res.numpy(), np.asarray(jstate["residual"]["w"])[r])
        red, state, dens = acc.exchange(g, state)
        jred, jstate, jdens = call(jg, jstate)
        for r in range(2):
            assert red[r]["w"].tolist() == [1.0, -1.0, 0.0]
            np.testing.assert_array_equal(red[r]["w"].numpy(),
                                          np.asarray(jred["w"])[r])
            np.testing.assert_array_equal(
                state["residual"][r]["w"].numpy(),
                np.asarray(jstate["residual"]["w"])[r])
        assert float(dens) == pytest.approx(2.0 / 3.0) == float(jdens[0])
        assert state["residual"][0]["w"][0].item() == pytest.approx(
            0.2, abs=1e-6)
        assert int(state["steps"]) == 3 == int(jstate["steps"])
        assert float(state["nnz_sum"]) == 4.0 == float(jstate["nnz_sum"])

    def test_fit_populates_density_and_ledger(self):
        prof = OpProfiler.get()
        losses, _, _ = run_wrapper(EncodedGradientsAccumulator(), epochs=2)
        assert all(np.isfinite(losses))
        stats = prof.collective_stats()
        assert stats["encoded_steps"] == len(losses)
        assert stats["encoded_elems_total"] > 0
        assert 0.0 <= stats["encoded_density"] <= 1.0
        assert stats["encoded_bytes_est"] <= stats[
            "encoded_dense_bytes_equiv"]

    def test_adaptive_threshold_adapts_during_fit(self):
        """Dense gradients sit far above the adaptive band, so the
        threshold rises; it rises as in the JAX package's run on the same
        parameters and batches."""
        t0 = 1e-3
        jn, tn = twins()
        losses, m, _ = run_wrapper(EncodedGradientsAccumulator(
            threshold_algorithm=AdaptiveThresholdAlgorithm(
                initial_threshold=t0)), model=tn, epochs=2)
        st = m._acc_state
        assert float(st["threshold"]) > t0
        assert int(st["steps"]) > 0
        jlosses = run_jax(jn, JEncoded(threshold_algorithm=JAdaptive(
            initial_threshold=t0)))
        jst = jax.device_get(jn._acc_state)
        assert float(st["threshold"]) == float(jst["threshold"])
        assert int(st["steps"]) == int(jst["steps"])
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-6)
        for i, d in enumerate(jst["residual"]):
            for k, v in d.items():
                np.testing.assert_allclose(
                    st["residual"][f"{i:04d}"][k].numpy(), np.asarray(v),
                    atol=1e-5)

    def test_chunked_encoded_parity(self):
        per_step, _, _ = run_wrapper(EncodedGradientsAccumulator())
        chunked, _, _ = run_wrapper(EncodedGradientsAccumulator(), spd=2)
        assert chunked == per_step

    def test_kill_and_resume_parity_encoded(self, tmp_path):
        """Residuals and threshold ride the checkpoint, so a killed and
        resumed encoded run replays the uninterrupted losses."""
        base, _, _ = run_wrapper(EncodedGradientsAccumulator())
        cl = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        run_wrapper(EncodedGradientsAccumulator(), listeners=[cl],
                    crash_at=5)
        cl.close()
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        assert last is not None
        import zipfile

        with zipfile.ZipFile(last) as zf:
            assert "accumulatorState.npz" in zf.namelist()
        resumed, _, _ = run_wrapper(EncodedGradientsAccumulator(),
                                    model=small_model(seed=17),
                                    resume_from=last)
        assert resumed == base

    def test_worker_count_change_resets_residuals(self, caplog):
        acc = EncodedGradientsAccumulator()
        m = small_model()
        pw = (ParallelWrapper.Builder(m).workers(2)
              .gradients_accumulator(acc).build())
        st = acc.init_state(m._params, n_shards=4)
        for p in leaf_paths(st["residual"]):
            get_path(st["residual"], p).add_(1.0)
        st["threshold"] = torch.tensor(0.5)
        with caplog.at_level(logging.WARNING, "deeplearning4j_tpu_torch"):
            out = pw._reshape_acc_state(st, acc)
        assert any("resetting" in r.message for r in caplog.records)
        leaves = [get_path(out["residual"], p)
                  for p in leaf_paths(out["residual"])]
        assert all(not t.any() for t in leaves)
        assert {t.shape[0] for t in leaves} == {2}
        assert float(out["threshold"]) == 0.5


# ---------------------------------------------------------------------------
# the collective ledger and the telemetry from shards
# ---------------------------------------------------------------------------

class TestLedgerAndTelemetry:
    def test_dense_vs_zero1_collective_kinds(self):
        prof = OpProfiler.get()
        run_wrapper(None, epochs=1)
        dense = prof.collective_stats()
        assert dense["psum_bytes"] > 0 and dense["steps"] > 0
        assert "reduce_scatter_bytes" not in dense
        prof.reset()
        run_wrapper(ReduceScatterAccumulator(), epochs=1)
        z1 = prof.collective_stats()
        assert z1["reduce_scatter_bytes"] > 0
        assert z1["all_gather_bytes"] == z1["reduce_scatter_bytes"]
        assert "psum_bytes" not in z1
        assert z1["zero1_updater_state_bytes_per_replica"] > 0

    def test_zero1_layer_stats_match_dense(self):
        """Per-layer norms assembled from the replicas' flat slices equal
        the dense path's (numerically: other summation order)."""
        series = {}
        for name, acc in (("dense", None),
                          ("zero1", ReduceScatterAccumulator())):
            storage = InMemoryStatsStorage()
            run_wrapper(acc, epochs=1,
                        listeners=[TelemetrySink(storage, drain_every_n=2)])
            series[name] = storage
        tags = set(series["dense"].tags())
        assert tags == set(series["zero1"].tags())
        assert any(t.startswith("grad_norm/") for t in tags)
        for tag in tags:
            d = [v for _, v in series["dense"].series(tag)]
            z = [v for _, v in series["zero1"].series(tag)]
            assert len(d) == len(z) > 0
            np.testing.assert_allclose(z, d, rtol=2e-4, atol=1e-6,
                                       err_msg=tag)

    def test_encoded_density_reaches_stats_storage(self):
        storage = InMemoryStatsStorage()
        run_wrapper(EncodedGradientsAccumulator(), epochs=1,
                    listeners=[TelemetrySink(storage, drain_every_n=2)])
        dens = [v for _, v in storage.series("exchange_density")]
        assert len(dens) > 0
        assert all(0.0 <= v <= 1.0 for v in dens)


class TestMasterRoute:
    def test_master_builder_forwards_accumulator(self):
        from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster

        master = (SharedTrainingMaster.Builder(16)
                  .gradients_accumulator(ReduceScatterAccumulator())
                  .build())
        m = small_model()
        master.fit(m, make_iter(), epochs=1)
        assert master.wrapper.accumulator.zero1
        assert is_flat_state(m._updater_state)
        assert np.isfinite(float(m._score))
