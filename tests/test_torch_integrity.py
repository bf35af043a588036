"""The port's replica-consistency check against the JAX package's
(``tests/test_integrity.py``): the fingerprint folds equal the JAX digests
bit for bit on the same bytes (float32, float64, bf16, int32 and bool
leaves, NaN payloads, -0.0), the dense tree fold equals the flat bucket
fold, the in-step verdict over the wrapper's replicas (stable across the
dense, ZeRO-1 and multi-step dispatches, on cadence, no false positives),
and a flipped bit caught and attributed. The JAX tests flip the bit
through the ``integrity/fingerprint`` fault site before a dispatch; here a
listener calls ``apply_bitflip`` at the same step boundary."""

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
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               ReduceScatterAccumulator,
                                               Zero1Plan)
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
