"""The port's ParallelWrapper and meshes against the JAX package's
(``tests/test_parallel.py``'s ``TestMesh`` and ``TestParallelWrapper``,
``tests/test_precision.py``'s ``TestZero1Compose``), on the CPU: the port's
device pool there is the CPU device 8 times, the JAX side runs on its 8
virtual CPU devices. Parameters are copied from the JAX network; inputs are
made with numpy from a seed. Also: the JAX wrapper's dense-layout desync of
bf16 updater state beside the port's agreement (ROADMAP §C)."""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import IrisDataSetIterator as JIris
from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIter
from deeplearning4j_tpu.ndarray.rng import set_default_seed
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JScores)
from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
from deeplearning4j_tpu.parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.parallel import shard_batch as jshard_batch
from deeplearning4j_tpu_torch.common.integrity import (combine_fp,
                                                       fingerprint_tree)
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data import DataSet, IrisDataSetIterator
from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
from deeplearning4j_tpu_torch.optimize.listeners import (
    CheckpointListener, CollectScoresIterationListener)
from deeplearning4j_tpu_torch.parallel import (EncodedGradientsAccumulator,
                                               ParallelWrapper,
                                               ReduceScatterAccumulator,
                                               Zero1Plan, device_pool,
                                               make_mesh, shard_batch)
from deeplearning4j_tpu_torch.parallel.sharding import is_flat_state
from torch_parity import mln_twins, modules

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    OpProfiler.get().reset()
    yield


def small_conf(which, updater="adam", seed=1, state_dtype=None,
               fused=False, width=16):
    m = modules(which)
    u = {"adam": lambda: m.Adam(0.05), "sgd": lambda: m.Sgd(0.1),
         "adam_w": lambda: m.Adam(learning_rate=0.05)}[updater]()
    u.state_dtype = state_dtype
    b = (m.NeuralNetConfiguration.builder().seed(seed).updater(u)
         .activation("tanh"))
    if fused:
        b = b.fused_update()
    return (b.list()
            .layer(m.L.DenseLayer(n_out=width))
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())


def twins(**kw):
    return mln_twins(small_conf("jax", **kw), small_conf("torch", **kw))


def port_model(**kw):
    return twins(**kw)[1]


def np_params(tn):
    return {p: get_path(tn._params, p).detach().numpy().copy()
            for p in leaf_paths(tn._params)}


def jax_params(jn):
    return {(f"{i:04d}", k): np.asarray(v) for i, d in enumerate(jn._params)
            for k, v in d.items()}


def assert_params_close(tn, jn, atol):
    j = jax_params(jn)
    for p, v in np_params(tn).items():
        np.testing.assert_allclose(v, j[p], atol=atol, err_msg=str(p))


def bitwise(a, b) -> bool:
    return leaf_paths(a) == leaf_paths(b) and all(
        torch.equal(get_path(a, p), get_path(b, p)) for p in leaf_paths(a))


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class TestMesh:
    def test_make_mesh_shapes(self):
        pool = device_pool("cpu")
        for kw, want in (({"data": 8}, {"data": 8, "model": 1}),
                         ({"data": 4, "model": 2}, {"data": 4, "model": 2}),
                         ({"model": 2}, {"data": 4, "model": 2})):
            assert make_mesh(devices=pool, **kw).shape == want
            assert dict(jmake_mesh(**kw).shape) == want

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError, match="need 99 devices, have 8"):
            make_mesh(data=99, devices=device_pool("cpu"))
        with pytest.raises(ValueError, match="need"):
            jmake_mesh(data=99)

    def test_shard_batch_places_on_mesh(self):
        m = make_mesh(data=8, devices=device_pool("cpu"))
        x = np.arange(64, dtype=np.float32).reshape(16, 4)
        xs = shard_batch(m, x)
        assert len(xs) == 8
        assert all(p.shape == (2, 4) and p.device == CPU for p in xs)
        np.testing.assert_array_equal(torch.cat(xs).numpy(), x)
        jxs = jshard_batch(jmake_mesh(data=8), x)
        assert len(jxs.sharding.device_set) == 8
        for i, s in enumerate(sorted(jxs.addressable_shards,
                                     key=lambda s: s.index[0].start)):
            np.testing.assert_array_equal(np.asarray(s.data),
                                          xs[i].numpy())


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def xy(rng, n):
    x = rng.randn(n, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


class TestParallelWrapper:
    def test_dp_training_converges(self):
        model = port_model()
        pw = (ParallelWrapper.Builder(model).workers(8)
              .training_mode("shared_gradients").build())
        pw.fit(IrisDataSetIterator(batch_size=144), epochs=40)
        ev = model.evaluate(IrisDataSetIterator(batch_size=150))
        assert ev.accuracy() > 0.9, ev.stats()

    def test_dp_matches_single_device_math(self):
        """One 8-way step equals one single-device step on the whole batch
        (Sgd), in the port as in the JAX package, and the port's equals the
        JAX package's."""
        x, y = xy(np.random.RandomState(0), 32)
        j1, t1 = twins(updater="sgd", seed=7)
        j2, t2 = twins(updater="sgd", seed=7)
        t1.fit(DataSet(x, y))
        ParallelWrapper.Builder(t2).workers(8).build().fit(DataSet(x, y))
        for p, v in np_params(t1).items():
            np.testing.assert_allclose(np_params(t2)[p], v, atol=1e-5)
        j1.fit(JDataSet(x, y))
        JPW.Builder(j2).workers(8).build().fit(JDataSet(x, y))
        assert_params_close(t2, j2, 1e-5)
        assert_params_close(t1, j1, 1e-5)

    def test_uneven_batch_padded(self):
        model = port_model()
        pw = ParallelWrapper.Builder(model).workers(8).build()
        x, y = xy(np.random.RandomState(1), 10)   # not a multiple of 8
        pw.fit(DataSet(x, y))
        assert np.isfinite(model.score_value)
        assert OpProfiler.get().counter_value("pipeline/padded_batches") == 1

    def test_uneven_batch_matches_single_device_math(self):
        """10 real rows wrapped to 16 at 8 workers: the pad rows weigh 0
        and the loss is the mean over the 10, so one step equals the
        single-device step on the 10 (and the JAX wrapper's step)."""
        x, y = xy(np.random.RandomState(3), 10)
        j1, t1 = twins(updater="sgd", seed=7)
        j2, t2 = twins(updater="sgd", seed=7)
        t1.fit(DataSet(x, y))
        ParallelWrapper.Builder(t2).workers(8).build().fit(DataSet(x, y))
        for p, v in np_params(t1).items():
            np.testing.assert_allclose(np_params(t2)[p], v, atol=1e-5)
        np.testing.assert_allclose(t1.score_value, t2.score_value, atol=1e-5)
        JPW.Builder(j2).workers(8).build().fit(JDataSet(x, y))
        assert_params_close(t2, j2, 1e-5)
        np.testing.assert_allclose(t2.score_value, float(j2._score_dev),
                                   atol=1e-5)

    def test_averaging_mode_accepted(self):
        model = port_model()
        pw = (ParallelWrapper.Builder(model).workers(4)
              .training_mode("averaging").averaging_frequency(5).build())
        pw.fit(IrisDataSetIterator(batch_size=148), epochs=1)
        assert np.isfinite(model.score_value)

    def test_encoded_accumulator_api_compat(self):
        """The encoded exchange through the Iris pipeline, as the JAX
        package's test runs it; the two packages' losses agree."""
        jn, tn = twins()
        acc = EncodedGradientsAccumulator(parties=8)
        pw = (ParallelWrapper.Builder(tn).workers(8)
              .gradients_accumulator(acc).build())
        scores = CollectScoresIterationListener()
        pw.set_listeners(scores)
        pw.fit(IrisDataSetIterator(batch_size=144), epochs=2)
        assert np.isfinite(tn.score_value)
        assert acc.threshold_algorithm is not None
        from deeplearning4j_tpu.parallel import (
            EncodedGradientsAccumulator as JEnc)

        set_default_seed(99)
        jp = (JPW.Builder(jn).workers(8)
              .gradients_accumulator(JEnc(parties=8)).build())
        js = JScores()
        jp.set_listeners(js)
        jp.fit(JIris(batch_size=144), epochs=2)
        np.testing.assert_allclose([s for _, s in scores.scores],
                                   [float(s) for _, s in js.scores],
                                   rtol=1e-5, atol=1e-6)

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError, match="unknown training mode"):
            ParallelWrapper.Builder(port_model()).training_mode("async_chaos")


# ---------------------------------------------------------------------------
# ZeRO-1 composed with bf16 updater state (tests/test_precision.py)
# ---------------------------------------------------------------------------

class _Crash(RuntimeError):
    pass


class CrashAt:
    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, score):
        if iteration == self.at:
            raise _Crash(iteration)


def wrapper_model(state_dtype=None, seed=5):
    return port_model(updater="adam_w", seed=seed, state_dtype=state_dtype,
                      width=9)


def wrapper_iter(n=64, batch=16):
    x, y = xy(np.random.RandomState(7), n)
    return NDArrayDataSetIterator(x, y, batch_size=batch, shuffle=True,
                                  seed=3)


def run_zero1(model, workers=4, epochs=2, resume_from=None, listeners=()):
    scores = CollectScoresIterationListener()
    pw = (ParallelWrapper.Builder(model).workers(workers)
          .gradients_accumulator(ReduceScatterAccumulator()).build())
    pw.set_listeners(scores, *listeners)
    pw.fit(wrapper_iter(), epochs=epochs, resume_from=resume_from)
    return [s for _, s in scores.scores], model, pw


class TestZero1Compose:
    def test_plan_reshard_preserves_bf16_state_bitwise(self):
        rng = np.random.RandomState(1)
        params = {"0000": {"W": torch.from_numpy(rng.randn(37, 13)
                                                 .astype(np.float32)),
                           "b": torch.zeros(13)},
                  "0001": {"W": torch.from_numpy(rng.randn(13, 5)
                                                 .astype(np.float32))}}
        state = {s: {n: {k: torch.from_numpy(rng.randn(*t.shape).astype(
            np.float32)).to(torch.bfloat16) for k, t in d.items()}
            for n, d in params.items()} for s in ("m", "v")}
        p4, p2 = Zero1Plan(params, 4), Zero1Plan(params, 2)
        dense = p4.unflatten_state(p4.flatten_state(state))
        dense2 = p2.unflatten_state(p2.reshard_state(p4.flatten_state(
            state)))
        for s in state:
            assert bitwise(dense[s], state[s]) and bitwise(dense2[s],
                                                           state[s])
        assert {t.dtype for s in dense for t in
                (get_path(dense[s], p) for p in leaf_paths(dense[s]))} \
            == {torch.bfloat16}

    def test_bf16_state_is_sharded_and_half_width(self):
        prof = OpProfiler.get()
        _, m, pw = run_zero1(wrapper_model("bfloat16"), epochs=1)
        assert is_flat_state(m._updater_state)
        assert {t.dtype for d in m._updater_state.values()
                for t in d.values()} == {torch.bfloat16}
        for r in range(4):
            shards = pw.replica_updater_state(r)
            assert all(t.numel() == pw._plan.buckets[0].shard
                       for d in shards.values() for t in d.values())
        bf16_bytes = prof.counter_value(
            "precision/updater_state_bytes_bfloat16")
        run_zero1(wrapper_model(None), epochs=1)
        assert prof.counter_value(
            "precision/updater_state_bytes_bfloat16") == 0
        assert bf16_bytes * 2 == prof.counter_value(
            "precision/updater_state_bytes_float32")

    def test_bf16_kill_resume_same_count_exact(self, tmp_path):
        """The generator's stream (so the stochastic-rounding bits) rides
        the checkpoint: a resumed bf16-state ZeRO-1 fit replays the
        uninterrupted losses exactly."""
        base, _, _ = run_zero1(wrapper_model("bfloat16"))
        cl = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        with pytest.raises(_Crash):
            run_zero1(wrapper_model("bfloat16"), listeners=[cl, CrashAt(5)])
        cl.close()
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        assert last is not None
        resumed, _, _ = run_zero1(wrapper_model("bfloat16", seed=17),
                                  resume_from=last)
        assert resumed == base

    def test_bf16_reshard_4_to_2_continues(self, tmp_path):
        cl = CheckpointListener(str(tmp_path), save_every_n_iterations=3,
                                keep_last=2)
        with pytest.raises(_Crash):
            run_zero1(wrapper_model("bfloat16"), listeners=[cl, CrashAt(5)])
        cl.close()
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        scores, m, pw = run_zero1(wrapper_model("bfloat16", seed=17),
                                  workers=2, resume_from=last)
        assert all(np.isfinite(scores))
        assert {t.dtype for d in m._updater_state.values()
                for t in d.values()} == {torch.bfloat16}
        for r in range(2):
            assert all(t.numel() == pw._plan.buckets[0].shard
                       for d in pw.replica_updater_state(r).values()
                       for t in d.values())


# ---------------------------------------------------------------------------
# a fault of the reference: the dense layout's bf16 updater state desyncs
# ---------------------------------------------------------------------------

def replica_digests(pw):
    return [int(combine_fp(fingerprint_tree(pw.replica_params(r)),
                           fingerprint_tree(pw.replica_updater_state(r))))
            for r in range(pw.workers_count)]


def test_jax_bf16_dense_desync_beside_the_port():
    """The JAX wrapper folds the replica index into the key its updater
    takes (``wrapper.py:213-214``), so with bf16 state each replica rounds
    its "replicated" state differently: the device shards of one leaf
    disagree. The port shares one stream of rounding bits: its replicas
    stay bitwise identical, and two replicas on a duplicated batch land on
    the bits of one replica on the batch."""
    jn, tn = twins(updater="adam_w", seed=5, state_dtype="bfloat16",
                   fused=True, width=9)
    set_default_seed(99)
    def it(cls):
        return cls(*xy(np.random.RandomState(7), 64), batch_size=16,
                   shuffle=True, seed=3)

    JPW.Builder(jn).workers(4).build().fit(it(JIter), epochs=1)
    worst = 0.0
    for leaf in jax.tree.leaves(jn._updater_state):
        shards = [np.asarray(s.data, np.float32)
                  for s in leaf.addressable_shards]
        assert len(shards) == 4
        worst = max(worst, max(float(np.abs(s - shards[0]).max())
                               for s in shards))
    assert worst > 0.0, "the JAX replicas' bf16 state no longer differs"

    pw = ParallelWrapper.Builder(tn).workers(4).build()
    pw.fit(it(NDArrayDataSetIterator), epochs=1)
    pw._ensure_parallel_state()
    assert len(set(replica_digests(pw))) == 1

    x, y = xy(np.random.RandomState(8), 16)
    one = port_model(updater="adam_w", seed=5, state_dtype="bfloat16",
                     fused=True, width=9)
    two = port_model(updater="adam_w", seed=5, state_dtype="bfloat16",
                     fused=True, width=9)
    assert bitwise(one._params, two._params)
    p1 = ParallelWrapper.Builder(one).workers(1).build()
    p2 = ParallelWrapper.Builder(two).workers(2).build()
    p1.fit(DataSet(x, y), epochs=3)
    p2.fit(DataSet(np.concatenate([x, x]), np.concatenate([y, y])),
           epochs=3)
    assert bitwise(one._params, two._params)
    assert bitwise(p1.replica_updater_state(0), p2.replica_updater_state(1))
    assert len(set(replica_digests(p2))) == 1


def test_host_prefetch_and_staging_depth_change_nothing():
    """The batch assembly on a worker thread (``host_prefetch``) and the
    placement depth (``prefetch``) move work, not results."""
    runs = []
    for hp, depth in ((0, 2), (3, 0), (2, 1)):
        model = wrapper_model()
        scores = CollectScoresIterationListener()
        pw = (ParallelWrapper.Builder(model).workers(4)
              .gradients_accumulator(ReduceScatterAccumulator()).build())
        pw.set_listeners(scores)
        pw.fit(wrapper_iter(), epochs=2, host_prefetch=hp, prefetch=depth)
        runs.append(([s for _, s in scores.scores], model._params))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        assert bitwise(params, runs[0][1])


def test_graph_through_the_wrapper_matches_jax():
    """A residual ComputationGraph (convolutions, BatchNormalization per
    replica slice, an ElementWiseVertex) through both wrappers at two
    replicas: ZeRO-1 bitwise to dense in the port, and the port's losses
    and parameters the JAX package's within float32 rounding (scaled)."""
    from torch_parity import residual_conf, twin_graphs

    rng = np.random.RandomState(4)
    x = rng.randn(16, 4, 8, 8).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 16)]

    def confs():
        return [residual_conf(w, False, channels=8, fused_update=True,
                              updater=lambda m: m.Nesterovs(0.05, 0.9))
                for w in ("jax", "torch")]

    jg, tg = twin_graphs(*confs(), calibrate_x=x[:8])
    _, tg2 = twin_graphs(*confs(), calibrate_x=x[:8])
    losses = {}
    for name, net, acc in (("dense", tg, None),
                           ("zero1", tg2, ReduceScatterAccumulator())):
        b = ParallelWrapper.Builder(net).workers(2)
        if acc is not None:
            b.gradients_accumulator(acc)
        pw = b.build()
        scores = CollectScoresIterationListener()
        pw.set_listeners(scores)
        pw.fit(NDArrayDataSetIterator(x, y, batch_size=8), epochs=2)
        losses[name] = [s for _, s in scores.scores]
    assert losses["dense"] == losses["zero1"]
    assert bitwise(tg._params, tg2._params)
    assert bitwise(tg._states, tg2._states)
    jp = JPW.Builder(jg).workers(2).build()
    js = JScores()
    jp.set_listeners(js)
    jp.fit(JIter(x, y, batch_size=8), epochs=2)
    np.testing.assert_allclose(losses["dense"],
                               [float(s) for _, s in js.scores], rtol=1e-5)
    for n, d in jg._params.items():
        for k, v in d.items():
            v = np.asarray(v)
            np.testing.assert_allclose(
                tg._params[n][k].detach().numpy(), v,
                atol=1e-5 * max(1.0, float(np.abs(v).max())),
                err_msg=f"{n}/{k}")
    for n, d in jg._states.items():
        for k, v in d.items():
            np.testing.assert_allclose(tg._states[n][k].numpy(),
                                       np.asarray(v), rtol=1e-5, atol=1e-6,
                                       err_msg=f"{n}/{k}")


class TestSharedTrainingMaster:
    def test_fit_and_kill_resume(self, tmp_path):
        """Checkpoint, 'kill', resume from the newest: a fresh model with
        another seed is overwritten and keeps counting."""
        from deeplearning4j_tpu_torch.optimize.listeners import (
            CheckpointListener)
        from deeplearning4j_tpu_torch.parallel import SharedTrainingMaster

        model = port_model()
        master = (SharedTrainingMaster.Builder(batch_size_per_worker=18)
                  .checkpoint(str(tmp_path), every_n_iterations=1)
                  .build())
        master.fit(model, IrisDataSetIterator(batch_size=144), epochs=2)
        assert master.wrapper.workers_count == 8   # the CPU pool
        last = CheckpointListener.last_checkpoint(str(tmp_path))
        assert last is not None
        fresh = port_model(seed=99)
        resumed = master.fit(fresh, IrisDataSetIterator(batch_size=144),
                             epochs=1)
        assert resumed._iteration > 2
        # the checkpoint's weights, not the fresh seed's, went on training
        assert not torch.equal(get_path(fresh._params, ("0000", "W")),
                               get_path(port_model(seed=99)._params,
                                        ("0000", "W")))
