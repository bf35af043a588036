"""The port's replica-consistency check against the JAX package's
(``tests/test_integrity.py``): the fingerprint folds equal the JAX digests
bit for bit on the same bytes (float32, float64, bf16, int32 and bool
leaves, NaN payloads, -0.0), the dense tree fold equals the flat bucket
fold, the in-step verdict over the wrapper's replicas (stable across the
dense, ZeRO-1 and multi-step dispatches, on cadence, no false positives),
and a flipped bit caught and attributed. The JAX tests flip the bit
through the ``integrity/fingerprint`` fault site before a dispatch; here a
listener calls ``apply_bitflip`` at the same step boundary."""

import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.common import integrity as jinteg
from deeplearning4j_tpu.parallel.sharding import Zero1Plan as JPlan
from deeplearning4j_tpu_torch.common import integrity
from deeplearning4j_tpu_torch.common.integrity import (IntegrityListener,
                                                       ReplicaCorruptionError,
                                                       bitwise_neq,
                                                       fingerprint_flats,
                                                       fingerprint_tree,
                                                       host_fingerprint)
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu.parallel import distributed as jdist
from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               ReduceScatterAccumulator,
                                               TrainingSupervisor,
                                               Zero1Plan, classify_failure)
from deeplearning4j_tpu_torch.parallel.distributed import (CLASS_CORRUPTION,
                                                           DEFAULT_POLICIES)
from torch_parity import mln_twins, modules


@pytest.fixture(autouse=True)
def _clean():
    OpProfiler.get().reset()
    yield


def twins(sgd=False, seed=5):
    def conf(which):
        m = modules(which)
        u = m.Sgd(learning_rate=0.1) if sgd else m.Adam(learning_rate=0.05)
        return (m.NeuralNetConfiguration.builder().seed(seed).updater(u)
                .activation("tanh").list()
                .layer(m.L.DenseLayer(n_out=9))
                .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                       activation="softmax"))
                .set_input_type(m.InputType.feed_forward(4)).build())

    return mln_twins(conf("jax"), conf("torch"))


def small_model(sgd=False):
    return twins(sgd)[1]


def make_iter(n=96, batch=24):
    rng = np.random.RandomState(7)
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return NDArrayDataSetIterator(x, y, batch_size=batch, shuffle=True,
                                  seed=3)


def build_wrapper(model, workers=4, zero1=True, check_every=1,
                  policy="raise", flip=None):
    b = ParallelWrapper.Builder(model).workers(workers)
    if zero1:
        b.gradients_accumulator(ReduceScatterAccumulator())
    pw = b.build()
    lst = IntegrityListener(check_every=check_every, policy=policy)
    pre = [FlipAt(pw, **flip)] if flip else []
    pw.set_listeners(*pre, lst)
    return pw, lst


class FlipAt:
    """Flips a bit of one replica's parameters after step ``at`` (before
    step ``at`` + 1 runs, where the JAX fault site fires)."""

    def __init__(self, pw, at, **spec):
        self.pw, self.at, self.spec = pw, at, spec

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            integrity.apply_bitflip(model, self.pw.mesh, self.spec)


# ---------------------------------------------------------------------------
# fingerprint primitives
# ---------------------------------------------------------------------------

def _arrays():
    rng = np.random.RandomState(0)
    w = rng.randn(7, 5).astype(np.float32)
    w.reshape(-1)[3] = np.nan
    w.reshape(-1)[4] = -0.0
    nan2 = np.float32(np.nan).view(np.uint32) ^ np.uint32(1)
    w.reshape(-1)[5] = nan2.view(np.float32)       # another NaN payload
    return {"w": w, "b": rng.randn(11).astype(np.float32),
            "d": rng.randn(6), "n": rng.randint(-9, 9, (4,)).astype(np.int32),
            "m": np.asarray([True, False, True])}


def _jax_tree(a):
    t = {k: jnp.asarray(v) for k, v in a.items()}
    t["b"] = t["b"].astype(jnp.bfloat16)
    return t


def _torch_tree(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    t["b"] = t["b"].to(torch.bfloat16)
    return t


class TestFingerprintPrimitives:
    def test_graph_fold_matches_host_oracle(self):
        """The port's digest equals the JAX package's, in-graph and host,
        on the same bytes."""
        a = _arrays()
        jt, tt = _jax_tree(a), _torch_tree(a)
        assert jt["d"].dtype == jnp.float64      # x64 is on for the tests
        got = int(fingerprint_tree(tt))
        assert got == host_fingerprint(tt) != 0
        assert got == int(jax.jit(jinteg.fingerprint_tree)(jt)) \
            == jinteg.host_fingerprint(jt)
        for k in a:                              # each dtype on its own
            assert int(fingerprint_tree({k: tt[k]})) \
                == jinteg.host_fingerprint({k: jt[k]})
        assert int(integrity.combine_fp(fingerprint_tree(tt),
                                        torch.tensor(12345))) \
            == int(jinteg.combine_fp(jinteg.fingerprint_tree(jt),
                                     jnp.uint32(12345)))

    def test_fold_is_permutation_and_layout_invariant(self):
        tt = _torch_tree(_arrays())
        rev = {k: tt[k] for k in reversed(list(tt))}
        assert int(fingerprint_tree(tt)) == int(fingerprint_tree(
            list(rev.values())))

    def test_flat_bucket_fold_equals_dense_fold(self):
        jn, tn = twins()
        want = jinteg.host_fingerprint(jn._params)
        assert int(fingerprint_tree(tn._params)) == want
        for n_shards in (2, 4, 8):      # the padding differs per count
            for align in (1, 4):
                plan = Zero1Plan(tn._params, n_shards, shard_align=align)
                assert int(fingerprint_flats(plan, plan.flatten(
                    tn._params))) == want
            jplan = JPlan(jn._params, n_shards)
            assert int(jinteg.fingerprint_flats(
                jplan, jplan.flatten(jn._params))) == want

    def test_single_bitflip_moves_the_digest(self):
        a = _arrays()
        tt = _torch_tree(a)
        before = int(fingerprint_tree(tt))
        w = a["w"].copy()
        w.reshape(-1).view(np.uint32)[3] ^= np.uint32(1 << 12)
        tt["w"] = torch.from_numpy(w)
        after = int(fingerprint_tree(tt))
        assert after != before
        a["w"] = w
        assert after == jinteg.host_fingerprint(_jax_tree(a))

    def test_bitwise_neq_distinguishes_nan_payloads(self):
        a = np.array([1.0, np.nan], np.float32)
        b = a.copy()
        assert not bool(bitwise_neq(torch.from_numpy(a), torch.from_numpy(b)))
        b.view(np.uint32)[1] ^= np.uint32(1)
        assert bool(bitwise_neq(torch.from_numpy(a), torch.from_numpy(b)))
        assert not bool(torch.from_numpy(a)[1] == torch.from_numpy(b)[1])


# ---------------------------------------------------------------------------
# the check inside the step
# ---------------------------------------------------------------------------

class TestInGraphConsistency:
    def test_fingerprints_stable_dense_vs_zero1_vs_chunked(self):
        """The dense tree fold, the ZeRO-1 flat fold and the multi-step
        dispatch report the same fingerprints; the first is the seeded
        parameters' (the JAX package's digest of its own copy)."""
        jn, m1 = twins()
        init_fp = jinteg.host_fingerprint(jn._params)
        pw1, l1 = build_wrapper(m1, workers=4, zero1=False)
        pw1.fit(make_iter(), epochs=2)
        assert l1.divergences == []
        assert len(l1.fingerprints) == 8          # 4 steps an epoch x 2
        assert l1.fingerprints[0] == (1, init_fp)
        pw2, l2 = build_wrapper(small_model(), workers=4, zero1=True)
        pw2.fit(make_iter(), epochs=2)
        assert l2.fingerprints == l1.fingerprints
        pw3, l3 = build_wrapper(small_model(), workers=4, zero1=True)
        pw3.fit(make_iter(), epochs=2, steps_per_dispatch=2)
        assert l3.fingerprints == l1.fingerprints

    def test_iteration_zero_fingerprint_invariant_across_worker_counts(
            self):
        fps = []
        for workers in (2, 4):
            pw, lst = build_wrapper(small_model(), workers=workers)
            pw.fit(make_iter(), epochs=1)
            assert lst.divergences == []
            fps.append(lst.fingerprints[0])
        assert fps[0] == fps[1]

    def test_check_every_cadence_and_ledger(self):
        pw, lst = build_wrapper(small_model(), workers=4, check_every=4)
        pw.fit(make_iter(), epochs=3)             # 12 steps
        assert [it for it, _ in lst.fingerprints] == [1, 5, 9]
        prof = OpProfiler.get()
        assert prof.counter_value("integrity/checks") == 3
        assert prof.counter_value("integrity/divergences") == 0
        assert prof.integrity_stats()["checks"] == 3

    def test_clean_sweep_has_zero_false_positives(self):
        for zero1 in (False, True):
            OpProfiler.get().reset()
            pw, lst = build_wrapper(small_model(), workers=4, zero1=zero1)
            pw.fit(make_iter(), epochs=3)
            assert lst.divergences == []
            assert OpProfiler.get().counter_value(
                "integrity/divergences") == 0
            assert OpProfiler.get().counter_value("integrity/checks") == 12

    def test_listener_state_roundtrip(self):
        pw, lst = build_wrapper(small_model(), workers=2)
        pw.fit(make_iter(), epochs=1)
        fresh = IntegrityListener(check_every=1)
        fresh.load_state_dict(lst.state_dict())
        assert fresh.fingerprints == lst.fingerprints

    def test_model_sharded_params_refused(self):
        pw = (ParallelWrapper.Builder(small_model()).workers(2).model_axis(2)
              .build())
        pw.set_listeners(IntegrityListener(check_every=1))
        with pytest.raises(NotImplementedError, match="replicated"):
            pw.fit(make_iter(), epochs=1)


# ---------------------------------------------------------------------------
# a flipped bit: detection and attribution
# ---------------------------------------------------------------------------

class TestBitflipDetection:
    def test_flip_on_check_step_attributed_zero1(self):
        pw, lst = build_wrapper(small_model(), workers=4, zero1=True,
                                check_every=2,
                                flip=dict(at=6, replica=2, bit=12, offset=3))
        with pytest.raises(ReplicaCorruptionError) as ei:
            pw.fit(make_iter(), epochs=3)
        assert ei.value.replica == 2
        assert ei.value.iteration == 7    # caught at the step it enters
        prof = OpProfiler.get()
        assert prof.counter_value("integrity/bitflips_injected") == 1
        assert prof.counter_value("integrity/divergences") == 1
        assert lst.divergences[-1]["replica"] == 2

    def test_flip_detected_within_cadence_dense(self):
        """Dense replicas carry their own parameters, so a flipped copy
        stays divergent until the next check: found within check_every
        steps; the diverged step is discarded on every replica."""
        pw, lst = build_wrapper(small_model(sgd=True), workers=4,
                                zero1=False, check_every=4,
                                flip=dict(at=6, replica=1))
        with pytest.raises(ReplicaCorruptionError) as ei:
            pw.fit(make_iter(), epochs=3)
        assert ei.value.replica == 1
        assert ei.value.iteration == 9    # the check at step 8
        assert ei.value.iteration - 6 <= 4
        fps = [int(fingerprint_tree(pw.replica_params(r))) for r in range(4)]
        assert fps[0] == fps[2] == fps[3] != fps[1]

    def test_zero1_republish_heals_off_slice_flip(self):
        """A flip outside the replica's own slice is overwritten by the
        owner's slice at the next gather: no divergence is ever seen."""
        pw, lst = build_wrapper(small_model(), workers=4, zero1=True,
                                check_every=4,
                                flip=dict(at=5, replica=2, offset=3))
        pw.fit(make_iter(), epochs=3)
        assert lst.divergences == []
        assert OpProfiler.get().counter_value(
            "integrity/bitflips_injected") == 1

    def test_warn_policy_records_without_raising(self):
        pw, lst = build_wrapper(small_model(), workers=4, policy="warn",
                                flip=dict(at=2, replica=0))
        pw.fit(make_iter(), epochs=1)
        assert lst.divergences
        assert lst.divergences[0]["replica"] == 0

    def test_named_tensor_and_sharded_target_validation(self):
        m = small_model()
        pw, _ = build_wrapper(m, workers=2)
        pw.fit(make_iter(), epochs=1)
        with pytest.raises(ValueError, match="no param leaf"):
            integrity.apply_bitflip(m, pw.mesh, {"replica": 0,
                                                 "tensor": "nope"})
        with pytest.raises(ValueError, match="outside mesh"):
            integrity.apply_bitflip(m, pw.mesh, {"replica": 7})
        out = integrity.apply_bitflip(m, pw.mesh, {"replica": 1,
                                                   "tensor": "['b']"})
        assert out["tensor"] == "['0000']['b']"
        survivors = integrity.materialize_from_survivors(
            [pw.replica_params(r) for r in range(2)], [1])
        assert host_fingerprint(survivors) == int(
            fingerprint_tree(pw.replica_params(0)))
        assert host_fingerprint(survivors) != int(
            fingerprint_tree(pw.replica_params(1)))


# --- the checkpoint scrubber and the serving tier's publish verify ------------

def _port_checkpoints(directory, n_epochs=2):
    """Checkpoints written by the port's CheckpointListener."""
    from deeplearning4j_tpu_torch.optimize import CheckpointListener
    from deeplearning4j_tpu_torch.util import checkpoint as ckpt

    m = small_model()
    cl = CheckpointListener(str(directory), save_every_n_iterations=2,
                            keep_last=6)
    m.set_listeners(cl)
    m.fit(make_iter(), epochs=n_epochs)
    cl.close()
    paths = ckpt.committed_checkpoints(str(directory))
    assert len(paths) >= 2
    return paths


def _twin_dirs(tmp_path):
    import shutil

    paths = _port_checkpoints(tmp_path / "t")
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    return str(tmp_path / "t"), str(tmp_path / "j"), paths


def _flags(ckpt, d):
    return [(e["file"], bool(e.get("quarantined")),
             bool((e.get("scrub") or {}).get("ok")))
            for e in ckpt.read_manifest(d)]


class TestCheckpointScrubber:
    @pytest.mark.parametrize("plan", [
        [],
        [{"site": "checkpoint/scrub", "index": 0, "kind": "transient"}],
        [{"site": "checkpoint/scrub", "index": 1, "kind": "bitflip",
          "offset": 300, "bit": 2}],
        [{"site": "checkpoint/scrub", "index": 0, "kind": "transient"},
         {"site": "checkpoint/scrub", "index": 3, "kind": "bitflip",
          "offset": 77, "bit": 5}]],
        ids=["clean", "transient", "bitflip", "both"])
    def test_two_passes_equal_jax(self, tmp_path, plan):
        from deeplearning4j_tpu.common import faultinject as jfi
        from deeplearning4j_tpu.util import checkpoint as jckpt
        from deeplearning4j_tpu_torch.common import faultinject as tfi
        from deeplearning4j_tpu_torch.util import checkpoint as tckpt

        dt, dj, _ = _twin_dirs(tmp_path)
        out = []
        for fi, integ, ck, d in ((tfi, integrity, tckpt, dt),
                                 (jfi, jinteg, jckpt, dj)):
            fi.set_plan(fi.FaultPlan(plan))
            try:
                scrub = integ.CheckpointScrubber(d)
                passes = [scrub.scrub_now(), scrub.scrub_now()]
            finally:
                fi.clear_plan()
            chosen = ck.last_checkpoint(d, require_scrubbed=True)
            out.append((passes, _flags(ck, d), os.path.basename(chosen)))
        assert out[0] == out[1]

    def test_rotten_file_quarantined_not_deleted(self, tmp_path):
        from deeplearning4j_tpu_torch.common import flightrec
        from deeplearning4j_tpu_torch.util import checkpoint as ckpt

        paths = _port_checkpoints(tmp_path)
        d = str(tmp_path)
        assert ckpt.last_checkpoint(d, require_scrubbed=True) == paths[-1]
        first = integrity.CheckpointScrubber(d).scrub_now()
        assert first["verified"] == len(paths)
        integrity._flip_file_byte(paths[-1], offset=256, bit=3)
        summary = integrity.CheckpointScrubber(d).scrub_now()
        assert summary["quarantined"] == 1 and os.path.exists(paths[-1])
        entry = [e for e in ckpt.read_manifest(d)
                 if e["file"] == os.path.basename(paths[-1])][0]
        assert entry["quarantined"] and "mismatch" in \
            entry["quarantine_reason"]
        assert ckpt.last_checkpoint(d) == paths[-2]
        assert ckpt.last_checkpoint(d, require_scrubbed=True) == paths[-2]
        assert ckpt.verify_checkpoint(d, entry) is None
        assert ckpt.scan_newest_intact(d) != paths[-1]
        prof = OpProfiler.get()
        assert prof.counter_value("integrity/quarantined_checkpoints") == 1
        assert prof.counter_value("integrity/scrub_passes") == 2
        assert flightrec.events("integrity/quarantine")[-1]["attrs"][
            "file"] == os.path.basename(paths[-1])
        assert flightrec.events("integrity/scrub")[-1]["attrs"][
            "quarantined"] == 1

    def test_thread_cadence_and_stop(self, tmp_path):
        _port_checkpoints(tmp_path)
        scrub = integrity.CheckpointScrubber(str(tmp_path), interval_s=0.05)
        scrub.start()
        try:
            deadline = time.monotonic() + 5
            while scrub.passes < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert scrub.passes >= 2
        finally:
            scrub.stop()
        assert scrub._thread is None

    @pytest.mark.parametrize("offset,bit", [(0, 0), (5, 7), (10 ** 6, 3)])
    def test_flip_file_byte_equals_jax(self, tmp_path, offset, bit):
        data = bytes(range(256)) * 4
        a, b = tmp_path / "a", tmp_path / "b"
        a.write_bytes(data)
        b.write_bytes(data)
        integrity._flip_file_byte(str(a), offset, bit)
        jinteg._flip_file_byte(str(b), offset, bit)
        assert a.read_bytes() == b.read_bytes() != data


class TestServingPublishVerify:
    def _engine(self, workers=2):
        from deeplearning4j_tpu_torch.parallel import ServingEngine, SLOClass

        return (ServingEngine.Builder(small_model()).buckets((1, 2, 4))
                .input_shape((4,)).workers(workers).max_wait_ms(2.0)
                .pin_devices().devices(["cpu"] * workers)
                .slo_classes([SLOClass("gold", 1, 250.0, queue_budget=64)])
                .brownout(interval_s=60.0).build())

    def test_clean_publish_runs_the_fleet_check_and_promotes(self, tmp_path):
        path = _port_checkpoints(tmp_path)[-1]
        eng = self._engine()
        x = np.random.randn(2, 4).astype(np.float32)
        try:
            h = eng.publish_checkpoint(path, canary_window_s=0.2,
                                       confirm_window_s=0.1,
                                       check_interval_s=0.05)
            deadline = time.monotonic() + 10
            while not h.done and time.monotonic() < deadline:
                eng.output(x, slo_class="gold")
            assert h.result(timeout=10) == "promoted"
            prof = OpProfiler.get()
            assert prof.counter_value("integrity/publish_checks") == 1
            assert prof.counter_value("integrity/publish_divergences") == 0
            fps = {host_fingerprint(eng._dev_params[s][0]) for s in (0, 1)}
            assert len(fps) == 1
        finally:
            eng.shutdown()

    def test_torn_slot_is_named_in_the_rollback(self, tmp_path):
        from deeplearning4j_tpu_torch.common import flightrec
        from deeplearning4j_tpu_torch.util.checkpoint import tree_leaves

        path = _port_checkpoints(tmp_path)[-1]
        eng = self._engine()
        x = np.random.randn(2, 4).astype(np.float32)
        try:
            prior = [t.clone() for t in tree_leaves(eng._dev_params[0][0])]
            h = eng.publish_checkpoint(path, canary_window_s=0.4,
                                       confirm_window_s=0.3,
                                       check_interval_s=0.05)
            # tear slot 1's candidate copy while the canary runs: the
            # post-promote fleet digest must catch it
            with eng._lock:
                can = eng._canary
            leaf = tree_leaves(can["new"][1][0])[0]
            leaf.view(-1)[0] = leaf.view(-1)[0] + 1.0
            deadline = time.monotonic() + 10
            while not h.done and time.monotonic() < deadline:
                eng.output(x, slo_class="gold")
            assert h.result(timeout=10) == "rolled_back"
            rb = flightrec.events("serving/rollback", corr=h.corr)[0]
            assert "fingerprint mismatch on slot(s) [1]" in \
                rb["attrs"]["reason"]
            assert OpProfiler.get().counter_value(
                "integrity/publish_divergences") == 1
            after = tree_leaves(eng._dev_params[0][0])
            assert all(torch.equal(a, b) for a, b in zip(after, prior))
        finally:
            eng.shutdown()


# ---------------------------------------------------------------------------
# the supervisor's quarantine-and-continue (tests/test_integrity.py
# TestQuarantine and the classification of a corruption)
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    return leaf_paths(a) == leaf_paths(b) and all(
        torch.equal(get_path(a, p), get_path(b, p)) for p in leaf_paths(a))


def _host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


def run_to_corruption(pw, step, replica, epochs=3):
    """Fit until the injected bitflip is caught; return the live cursor,
    the generator state at the boundary and the error."""
    faultinject.set_plan(faultinject.FaultPlan(
        [{"site": "integrity/fingerprint", "index": step,
          "kind": "bitflip", "replica": replica}]))
    try:
        with pytest.raises(ReplicaCorruptionError) as ei:
            pw.fit(make_iter(), epochs=epochs)
    finally:
        faultinject.clear_plan()
    m = pw.model
    return ((m._epoch - m._fit_epoch0, m._steps_in_epoch),
            m.generator().get_state(), ei.value)


class TestQuarantine:
    def test_corruption_error_classifies_for_quarantine(self):
        exc = ReplicaCorruptionError("diverged", replica=2, iteration=9)
        assert classify_failure(exc) == CLASS_CORRUPTION
        assert DEFAULT_POLICIES[CLASS_CORRUPTION] == \
            "quarantine_and_continue"
        assert jdist.classify_failure(jinteg.ReplicaCorruptionError(
            "diverged", replica=2, iteration=9)) == CLASS_CORRUPTION

    def test_supervised_quarantine_drill_bitwise_parity(self, tmp_path):
        """A bitflip on replica 1 of 4 is caught, the supervisor
        quarantines that replica (no restart used), training completes on
        3 workers, and the final parameters are bitwise a fresh 3-worker
        run handed the majority's state."""
        m1 = small_model()
        pw, _ = build_wrapper(m1, workers=4, zero1=True)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "integrity/fingerprint", "index": 5,
              "kind": "bitflip", "replica": 1}]))
        try:
            res = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                     elastic_grow=False).fit(make_iter,
                                                             epochs=3)
        finally:
            faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 0
        assert [h["class"] for h in res.history] == ["silent_corruption"]
        assert [h["policy"] for h in res.history] \
            == ["quarantine_and_continue"]
        assert pw.workers_count == 3
        assert OpProfiler.get().counter_value("supervisor/quarantines") == 1
        q = flightrec.events("integrity/quarantine")[-1]
        assert q["attrs"]["replica"] == 1
        assert q["sev"] == "warn"

        # by hand: the same flip caught, the survivors' state, a resize
        m2 = small_model()
        pw2, _ = build_wrapper(m2, workers=4, zero1=True)
        cursor, gen, exc = run_to_corruption(pw2, step=5, replica=1)
        assert exc.replica == 1
        params = integrity.materialize_from_survivors(
            [pw2.replica_params(r) for r in range(4)], [1])
        snap = (params, _host(m2._states), _host(m2._updater_state))
        it, ep = m2._iteration, m2._epoch
        pw2.resize(3, lost_replicas=[1])
        pw2.fit(make_iter(), epochs=3, resume_cursor=cursor)
        assert _bits_equal(m1._params, m2._params)

        # a brand-new 3-worker wrapper handed the survivors' state
        m3 = small_model()
        m3._params, m3._states, m3._updater_state = snap
        m3._iteration, m3._epoch = it, ep
        m3.generator().set_state(gen)
        pw3, _ = build_wrapper(m3, workers=3, zero1=True)
        pw3.fit(make_iter(), epochs=3, resume_cursor=cursor)
        assert _bits_equal(m1._params, m3._params)
        assert _bits_equal(m1._updater_state, m3._updater_state)

    def test_survivor_materialization_skips_poisoned_shard_zero(self):
        m = small_model()
        pw, _ = build_wrapper(m, workers=4)
        pw.fit(make_iter(), epochs=1)
        clean = host_fingerprint(m._params)
        integrity.apply_bitflip(m, pw.mesh, {"replica": 0, "bit": 12})
        naive = _host(pw.replica_params(0))        # the "shard 0" read
        majority = integrity.materialize_from_survivors(
            [pw.replica_params(r) for r in range(4)], [0])
        assert host_fingerprint(naive) != clean
        assert host_fingerprint(majority) == clean

    def test_two_way_split_falls_back_to_restart(self, tmp_path):
        """N=2: the vote cannot name a side, the error carries
        replica=None, the quarantine gate refuses, and the supervisor
        restarts from a checkpoint."""
        m = small_model()
        pw, _ = build_wrapper(m, workers=2, zero1=True)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "integrity/fingerprint", "index": 9,
              "kind": "bitflip", "replica": 1}]))
        try:
            res = TrainingSupervisor(pw, checkpoint_dir=str(tmp_path),
                                     backoff_base_s=0.01,
                                     elastic_grow=False).fit(make_iter,
                                                             epochs=4)
        finally:
            faultinject.clear_plan()
        assert res.status == "completed"
        assert res.restarts == 1
        assert [h["class"] for h in res.history] == ["silent_corruption"]
        assert [h["policy"] for h in res.history] == ["restart"]
        assert pw.workers_count == 2
        assert OpProfiler.get().counter_value(
            "supervisor/quarantines") == 0
