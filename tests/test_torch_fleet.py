"""The port's fleet training (``parallel/fleet.py``) and the member-batched
route of ``fused_update`` on the CPU, against the JAX package where the
JAX side runs here, and against its own contracts (the counterparts of
``tests/test_fleet.py``).

Against the JAX package (tolerances stated at each test):

- a port fleet built without ``hyper`` against a JAX fleet built without
  it, from the same stacked state (``util/convert.fleet_state_from_numpy``);
- each port sweep member against a JAX solo model at that member's rate
  (the JAX fleet's ``hyper`` path trips an assertion of this jax version
  inside its vmapped step, so the sweep is held to solo models);
- the member-batched plain version against the JAX Pallas kernel in
  interpret mode under ``jax.vmap`` over the members;
- a JAX ``save_member`` file restoring into the port's solo model.

The port's own contracts are bitwise: member k equals its solo twin
(``solo_twin``), an override equal to the configured value equals the
plain step, masked rows keep their bits, no stacked buffer is reallocated
by steps, culls or spawns, NaN isolation under ``"skip"`` and ``"cull"``,
and member and whole-fleet checkpoints restore exactly.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_update as jpu
from deeplearning4j_tpu.parallel import FleetTrainer as JFleet
from deeplearning4j_tpu_torch.common import flightrec
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.ops import update as tupdate
from deeplearning4j_tpu_torch.optimize import NanSentinelListener
from deeplearning4j_tpu_torch.parallel import (FleetEarlyStop,
                                               FleetStatsSink, FleetTrainer)
from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage
from deeplearning4j_tpu_torch.util.checkpoint import (read_manifest,
                                                      restore_training_state)
from deeplearning4j_tpu_torch.util.convert import fleet_state_from_numpy
from torch_parity import f32_ulp_bound, modules, numpy_tree

N_IN, N_OUT = 8, 4


def mlp_conf(which, updater=None, seed=7, l2=0.0, dropout=0.0,
             fused=False, state_dtype=None):
    m = modules(which)
    up = updater(m) if updater is not None else m.Adam(1e-3)
    if state_dtype:
        up.state_dtype = state_dtype
    b = (m.NeuralNetConfiguration.builder().seed(seed).updater(up)
         .activation("tanh").weight_init("xavier"))
    if fused:
        b = b.fused_update()
    if l2:
        b = b.l2(l2)
    if dropout:
        b = b.dropout(dropout)
    return (b.list()
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=N_OUT, loss="mse",
                                   activation="identity"))
            .set_input_type(m.InputType.feed_forward(N_IN)).build())


def mlp(updater=None, seed=7, **kw):
    m = modules("torch")
    return m.MultiLayerNetwork(mlp_conf("torch", updater, seed, **kw)).init(
        device="cpu")


def jmlp(updater=None, seed=7, **kw):
    m = modules("jax")
    return m.MultiLayerNetwork(mlp_conf("jax", updater, seed, **kw)).init()


def conv_net(fused=True, seed=3):
    """A narrow LeNet (the card path's layer kinds at small widths)."""
    m = modules("torch")
    b = (m.NeuralNetConfiguration.builder().seed(seed)
         .updater(m.Nesterovs(learning_rate=0.01, momentum=0.9))
         .activation("relu").weight_init("xavier"))
    if fused:
        b = b.fused_update()
    conf = (b.list()
            .layer(m.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(m.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.convolutional(10, 10, 1)).build())
    return m.MultiLayerNetwork(conf).init(device="cpu")


UPDATERS = {"sgd": lambda m: m.Sgd(0.05),
            "nesterovs": lambda m: m.Nesterovs(0.05),
            "adam": lambda m: m.Adam(1e-3)}


@pytest.fixture
def batch():
    rng = np.random.RandomState(0)
    return (rng.randn(16, N_IN).astype(np.float32),
            rng.randn(16, N_OUT).astype(np.float32))


@pytest.fixture(autouse=True)
def _clean():
    OpProfiler.get().reset()
    flightrec.reset()
    yield


def member_leaves(fleet, m):
    p = fleet.stacked_views()[0]
    return [get_path(p, q)[m].clone() for q in leaf_paths(p)]


def member_state(fleet, m):
    u = fleet.stacked_views()[2]
    return [get_path(u[s], q)[m].clone() for s in sorted(u)
            for q in leaf_paths(u[s])]


def solo_leaves(net):
    return [t.detach().clone() for t in net._leaves()]


def solo_state(net):
    from deeplearning4j_tpu_torch.util.model_serializer import \
        dense_updater_state

    u = dense_updater_state(net) or {}
    return [get_path(u[s], q).clone() for s in sorted(u)
            for q in leaf_paths(u[s])]


def bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def jax_stacked(jf):
    params, states = jf.stacked_state()
    return ([numpy_tree(d) for d in jax.device_get(params)],
            [numpy_tree(d) for d in jax.device_get(states)])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

class TestAgainstJax:
    @pytest.mark.parametrize("name", sorted(UPDATERS))
    def test_fleet_without_hyper_matches_jax_fleet(self, batch, name):
        """The same stacked members (and updater state) in both packages,
        three fleet steps on one batch: every member within 1e-5 (float32
        matmul and tanh differ in the last bits between the libraries)."""
        x, y = batch
        jf = JFleet(jmlp(UPDATERS[name]), 3, seed=7)
        pf = FleetTrainer(mlp(UPDATERS[name]), 3, seed=7)
        params, states = jax_stacked(jf)
        upd = {k: [numpy_tree(d) for d in jax.device_get(v)]
               for k, v in jf._updater_state.items()}
        fleet_state_from_numpy(pf, params, states, upd or None)
        for _ in range(3):
            jf.step(x, y)
            pf.step(x, y)
        want, _ = jax_stacked(jf)
        got = pf.stacked_views()[0]
        for i, d in enumerate(want):
            for k, v in d.items():
                np.testing.assert_allclose(
                    get_path(got, (f"{i:04d}", k)).numpy(), v, rtol=1e-5,
                    atol=1e-6)
        np.testing.assert_allclose(pf._score_dev.numpy(),
                                   np.asarray(jf._score_dev), rtol=1e-5)

    @pytest.mark.parametrize("member", [0, 2])
    def test_sweep_member_matches_jax_solo_at_its_rate(self, batch, member):
        """A port lr sweep (one shared init: the JAX solo model's) against
        JAX solo models configured with each member's rate: within 1e-5
        after three steps."""
        x, y = batch
        rates = [0.05, 0.1, 0.2]
        j0 = jmlp(lambda m: m.Sgd(0.05))
        p = [numpy_tree(d) for d in jax.device_get(j0._params)]
        s = [numpy_tree(d) for d in jax.device_get(j0._states)]

        def stack(tree):
            return [{k: np.stack([v] * 3) for k, v in d.items()}
                    for d in tree]

        pf = FleetTrainer.from_sweep(mlp(lambda m: m.Sgd(0.05), fused=True),
                                     {"lr": rates}, seed=7)
        fleet_state_from_numpy(pf, stack(p), stack(s))
        solo = jmlp(lambda m: m.Sgd(rates[member]))
        from deeplearning4j_tpu.data.dataset import DataSet as JDataSet

        for _ in range(3):
            pf.step(x, y)
            solo.fit(JDataSet(x, y), epochs=1)
        want = [np.asarray(v) for d in solo._params for _, v in
                sorted(d.items())]
        for g, w in zip(member_leaves(pf, member), want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("kind", ["sgd", "nesterovs", "adam"])
    def test_members_plain_matches_jax_pallas_interpret(self, kind):
        """The plain member-batched version against the JAX TPU kernel in
        interpret mode, vmapped over 3 members with their own rates: within
        2 float32 ulp (the contract between the JAX package's modes)."""
        rng = np.random.RandomState(1)
        M, N = 3, 1000
        p = rng.randn(M, N).astype(np.float32)
        g = rng.randn(M, N).astype(np.float32)
        names = tupdate.SLOTS[kind]
        slots = {s: (np.abs(rng.randn(M, N)) * 1e-3 if s == "v"
                     and kind != "nesterovs" else rng.randn(M, N) * 0.1
                     ).astype(np.float32) for s in names}
        lrs = np.asarray([0.01, 0.02, 0.05], np.float32)
        upd = {"sgd": lambda: modules("torch").Sgd(0.01),
               "nesterovs": lambda: modules("torch").Nesterovs(0.01, 0.9),
               "adam": lambda: modules("torch").Adam(0.01)}[kind]()
        sc = tupdate._scalars(upd, kind, 3)

        def one(lr, pp, gg, *ss):
            sct = (lr,) + tuple(jnp.float32(v) for v in sc[1:])
            new_p, new_s = jpu._launch_kernel(
                kind, sct, pp, gg, dict(zip(names, ss)), None, None, True)
            return (new_p,) + tuple(new_s[n] for n in names)

        jout = jax.vmap(one)(jnp.asarray(lrs), jnp.asarray(p), jnp.asarray(g),
                             *[jnp.asarray(slots[n]) for n in names])
        new_p, new_s = tupdate.fused_update_members_reference(
            kind, sc, torch.from_numpy(p), torch.from_numpy(g),
            {n: torch.from_numpy(v) for n, v in slots.items()},
            lr=torch.from_numpy(lrs))
        for got, want in zip([new_p] + [new_s[n] for n in names], jout):
            want = np.asarray(want)
            assert np.max(np.abs(got.numpy() - want)) <= f32_ulp_bound(want)

    def test_jax_save_member_restores_into_port_solo(self, batch, tmp_path):
        """A JAX fleet's member checkpoint restores into the port's solo
        network: parameters and updater state bitwise, the iteration; the
        stream (a threefry key) restarts from the seed."""
        x, y = batch
        jf = JFleet(jmlp(), 3, seed=7)
        for _ in range(2):
            jf.step(x, y)
        path = jf.save_member(1, str(tmp_path))
        solo = mlp()
        restore_training_state(solo, path)
        want = [np.asarray(v) for d in jax.device_get(jf._params)
                for _, v in sorted(d.items())]
        for g, w in zip(solo_leaves(solo), want):
            np.testing.assert_array_equal(g.numpy(), w[1])
        assert solo._iteration == 2


# ---------------------------------------------------------------------------
# the member-batched route's plain version
# ---------------------------------------------------------------------------

class TestMembersPlain:
    @pytest.mark.parametrize("kind,sd", [("sgd", None), ("nesterovs", None),
                                         ("adam", None),
                                         ("nesterovs", "bfloat16"),
                                         ("adam", "bfloat16")])
    def test_rows_bitwise_single_bucket_and_masked_rows_kept(self, kind, sd):
        """Row m of the member-batched plain version is bitwise the single
        bucket's plain update of row m with its own rate; a masked row
        keeps its parameters and moments bitwise."""
        g0 = torch.Generator().manual_seed(4)
        M, N = 4, 777
        p = torch.randn((M, N), generator=g0)
        g = torch.randn((M, N), generator=g0)
        sr = torch.bfloat16 if sd else None
        slots = {s: (torch.rand((M, N), generator=g0) * 1e-3).to(
            sr or torch.float32) for s in tupdate.SLOTS[kind]}
        bits = (torch.randint(-2 ** 31, 2 ** 31, (M, N), dtype=torch.int32,
                              generator=g0) if sd else None)
        lrs = torch.tensor([0.01, 0.03, 0.1, 0.3])
        live = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
        upd = {"sgd": modules("torch").Sgd(0.01),
               "nesterovs": modules("torch").Nesterovs(0.01, 0.9),
               "adam": modules("torch").Adam(0.01)}[kind]
        sc = tupdate._scalars(upd, kind, 2)
        new_p, new_s = tupdate.fused_update_members_reference(
            kind, sc, p, g, slots, bits, sr, lr=lrs, live=live)
        for m in range(M):
            if not live[m]:
                assert torch.equal(new_p[m], p[m])
                assert all(torch.equal(new_s[s][m], slots[s][m])
                           for s in slots)
                continue
            scm = (float(lrs[m]),) + tuple(sc[1:])
            want_p, want_s = tupdate.fused_update_reference(
                kind, scm, p[m], g[m], {s: v[m] for s, v in slots.items()},
                None if bits is None else bits[m], sr)
            assert torch.equal(new_p[m], want_p)
            assert all(torch.equal(new_s[s][m], want_s[s]) for s in slots)

    def test_cuda_wrapper_refuses_cpu_tensors(self):
        p = torch.zeros((2, 8))
        with pytest.raises(ValueError, match="CUDA"):
            tupdate.fused_update_members_cuda("sgd", (0.1,), p, p.clone(), {})


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

class TestLifecycle:
    def test_init_stacks_members_with_solo_init_bits(self):
        fleet = FleetTrainer(mlp(), 3, seed=7)
        for k, v in fleet._P.items():
            assert v.shape[0] == 3 and v.is_contiguous()
        assert bitwise(member_leaves(fleet, 1), solo_leaves(mlp(seed=8)))

    def test_member_count_validation(self):
        with pytest.raises(ValueError, match="ambiguous or missing"):
            FleetTrainer(mlp())
        with pytest.raises(ValueError, match="ambiguous or missing"):
            FleetTrainer(mlp(), 3, member_seeds=[1, 2])
        with pytest.raises(ValueError, match="at least one"):
            FleetTrainer(mlp(), 0)

    @pytest.mark.parametrize("fused", [False, True], ids=["leaf", "fused"])
    @pytest.mark.parametrize("name,sd", [("sgd", None), ("nesterovs", None),
                                         ("adam", None),
                                         ("adam", "bfloat16")])
    def test_member_vs_solo_bitwise_parity(self, batch, fused, name, sd):
        """The headline gate: member k is bitwise its solo twin (same init
        seed, same stream): parameters, updater state and loss, for every
        updater family, float32 and bfloat16 moments, per-leaf and fused."""
        x, y = batch
        fleet = FleetTrainer(mlp(UPDATERS[name], fused=fused,
                                 state_dtype=sd), 4, seed=7)
        solo = fleet.solo_twin(2)
        for _ in range(5):
            fleet.step(x, y)
            solo.fit(DataSet(x, y))
        assert bitwise(member_leaves(fleet, 2), solo_leaves(solo))
        assert bitwise(member_state(fleet, 2), solo_state(solo))
        assert float(fleet._score_dev[2]) == solo.score_value

    def test_conv_member_vs_solo_bitwise(self):
        rng = np.random.RandomState(2)
        x = rng.rand(6, 1, 10, 10).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 6)]
        fleet = FleetTrainer.from_sweep(conv_net(), {"lr": [0.01, 0.05]},
                                        seed=3)
        solo = fleet.solo_twin(1)
        for _ in range(3):
            fleet.step(x, y)
            solo.fit(DataSet(x, y))
        assert bitwise(member_leaves(fleet, 1), solo_leaves(solo))

    def test_one_build_and_one_update_per_bucket_per_step(self, batch):
        x, y = batch
        prof = OpProfiler.get()
        fleet = FleetTrainer(mlp(fused=True), 6, seed=7)
        for _ in range(4):
            fleet.step(x, y)
        assert prof.counter_value("trace/fleet_step") == 1
        assert prof.counter_value(
            "precision/fused_member_buckets_plain") == 4 * len(fleet._P)

    @pytest.mark.parametrize("fused", [False, True], ids=["leaf", "fused"])
    def test_cull_freezes_member_others_continue(self, batch, fused):
        x, y = batch
        fleet = FleetTrainer(mlp(fused=fused), 3, seed=7)
        fleet.step(x, y)
        fleet.cull(1, reason="test")
        frozen, moving = member_leaves(fleet, 1), member_leaves(fleet, 0)
        frozen_u = member_state(fleet, 1)
        fleet.step(x, y)
        fleet.step(x, y)
        assert bitwise(member_leaves(fleet, 1), frozen)
        assert bitwise(member_state(fleet, 1), frozen_u)
        assert not bitwise(member_leaves(fleet, 0), moving)
        assert fleet.alive_mask().tolist() == [1, 0, 1]
        ev = flightrec.events("fleet/cull")
        assert ev and ev[0]["attrs"] == {"member": 1, "reason": "test"}

    def test_culled_member_stream_freezes_too(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(dropout=0.2), 2, seed=7)
        fleet.cull(0)
        s0 = fleet._gens[0].get_state().clone()
        s1 = fleet._gens[1].get_state().clone()
        fleet.step(x, y)
        assert torch.equal(fleet._gens[0].get_state(), s0)
        assert not torch.equal(fleet._gens[1].get_state(), s1)

    def test_cull_and_spawn_do_not_reallocate(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(fused=True, state_dtype="bfloat16"), 3,
                             seed=7)
        fleet.set_listeners(NanSentinelListener("cull", check_every_n=2))
        fleet.step(x, y)
        ptrs = fleet.buffer_ptrs()
        fleet.cull(1)
        fleet.step(x, y)
        fleet.spawn(1)
        fleet.step(x, y)
        xs = np.broadcast_to(x, (3,) + x.shape).copy()
        xs[2] = np.nan
        fleet.step(xs, np.broadcast_to(y, (3,) + y.shape).copy(),
                   per_member=True)
        assert fleet.alive_mask().tolist() == [1, 1, 0]
        assert fleet.buffer_ptrs() == ptrs
        assert OpProfiler.get().counter_value("trace/fleet_step") == 1

    def test_cull_and_spawn_do_not_retrace(self, batch):
        """The JAX drill's steady-state region (``tests/test_fleet.py``):
        after the warmup of each path, steps, a cull and a spawn run with
        no new census generation, no trace/* move and no host sync."""
        from deeplearning4j_tpu_torch.common import tracecheck, xprof

        x, y = batch
        xprof.reset()
        fleet = FleetTrainer(mlp(fused=True), 3, seed=7)
        fleet.step(x, y)
        fleet.cull(2)
        fleet.step(x, y)
        fleet.spawn(2)
        fleet.step(x, y)
        with tracecheck.steady_state("fleet cull/spawn") as region:
            fleet.step(x, y)
            fleet.cull(1)
            fleet.step(x, y)
            fleet.spawn(1)
            fleet.step(x, y)
        assert region.compiles == 0 and region.host_syncs == 0
        e = xprof.census()["fleet/step"]
        assert e["generations"] == 1 and e["calls"] == 6

    def test_spawn_reinitializes_slice_in_place(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        for _ in range(2):
            fleet.step(x, y)
        fleet.cull(1)
        flightrec.reset()
        fleet.spawn(1, seed=99)
        assert bitwise(member_leaves(fleet, 1), solo_leaves(mlp(seed=99)))
        assert all(not torch.any(t) for t in member_state(fleet, 1))
        assert fleet.alive_mask().tolist() == [1, 1, 1]
        assert flightrec.events("fleet/spawn")
        p = member_leaves(fleet, 1)
        fleet.step(x, y)
        assert not bitwise(member_leaves(fleet, 1), p)

    def test_members_gauge_tracks_lifecycle(self):
        prof = OpProfiler.get()
        fleet = FleetTrainer(mlp(), 5, seed=7)
        assert prof.counter_value("fleet/members") == 5
        fleet.cull(0)
        fleet.cull(3)
        assert prof.counter_value("fleet/members") == 3
        fleet.spawn(0)
        assert prof.counter_value("fleet/members") == 4
        assert prof.fleet_stats()["members"] == 4

    def test_fit_broadcasts_shared_iterator(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        fleet.fit(DataSet(x, y), epochs=2)
        assert fleet._iteration == 2
        assert fleet._epoch == 2

    def test_per_member_batch_shape_validation(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        with pytest.raises(ValueError, match="leading axis"):
            fleet.step(np.stack([x, x]), np.stack([y, y]), per_member=True)

    @pytest.mark.parametrize("field", ["lr", "l2", "dropout"])
    def test_override_equal_to_configured_is_bitwise_plain_step(self, batch,
                                                                field):
        """The ``hyper`` hook of the solo step: an override equal to the
        configured value gives the plain step, bitwise."""
        x, y = batch
        kw = {"l2": {"l2": 1e-2}, "dropout": {"dropout": 0.3}}.get(field, {})
        value = {"lr": 0.05, "l2": 1e-2, "dropout": 0.3}[field]
        a = mlp(lambda m: m.Nesterovs(0.05), fused=True, **kw)
        b = mlp(lambda m: m.Nesterovs(0.05), fused=True, **kw)
        a.fit(DataSet(x, y))
        b.fit(DataSet(x, y))
        batch_t = (torch.from_numpy(x), torch.from_numpy(y), None, None, None)
        for _ in range(2):
            a._step_core(a._flat_store(), batch_t, a._iteration)
            b._step_core(b._flat_store(), batch_t, b._iteration,
                         hyper={field: value})
        assert bitwise(solo_leaves(a), solo_leaves(b))


# ---------------------------------------------------------------------------
# telemetry and NaN isolation
# ---------------------------------------------------------------------------

class TestTelemetry:
    def test_aux_carries_member_axis(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 4, seed=7, drain_every_n=100)
        fleet.set_listeners(NanSentinelListener("warn"))
        fleet.step(x, y)
        _, aux = fleet._aux_buf[0]
        assert aux["loss"].shape == (4,)
        assert aux["grad_norm"].shape == (4, 2)
        assert aux["nonfinite"].shape == (4, 2)
        assert aux["alive"].shape == (4,)

    def test_one_readback_per_drain_window(self, batch):
        x, y = batch
        prof = OpProfiler.get()
        fleet = FleetTrainer(mlp(), 4, seed=7, drain_every_n=5)
        fleet.set_listeners(NanSentinelListener("warn"))
        for _ in range(10):
            fleet.step(x, y)
        assert prof.get_statistics()["telemetry/drain"]["count"] == 2
        assert prof.counter_value("fleet/drains") == 2

    def test_stats_sink_per_member_series(self, batch):
        x, y = batch
        storage = InMemoryStatsStorage()
        fleet = FleetTrainer(mlp(), 3, seed=7, drain_every_n=2)
        fleet.set_listeners(FleetStatsSink(storage))
        for _ in range(4):
            fleet.step(x, y)
        tags = storage.tags()
        for m in range(3):
            for t in ("loss", "grad_norm", "alive"):
                assert f"fleet/{t}/m{m}" in tags
        assert len(storage.series("fleet/loss/m0")) == 4

    @pytest.mark.parametrize("fused", [False, True], ids=["leaf", "fused"])
    def test_per_member_nan_isolation_skip_policy(self, batch, fused):
        """A NaN in one member drops only that member's update while the
        others land bitwise as in a clean run; skip is transient."""
        x, y = batch

        def run(poison):
            fleet = FleetTrainer(mlp(fused=fused), 3, seed=7,
                                 drain_every_n=50)
            fleet.set_listeners(NanSentinelListener("skip"))
            fleet.step(x, y)
            pre = member_leaves(fleet, 1)
            pre_u = member_state(fleet, 1)
            xs = np.broadcast_to(x, (3,) + x.shape).copy()
            ys = np.broadcast_to(y, (3,) + y.shape).copy()
            if poison:
                xs[1] = np.nan
            fleet.step(xs, ys, per_member=True)
            kept = (bitwise(member_leaves(fleet, 1), pre)
                    and bitwise(member_state(fleet, 1), pre_u))
            fleet.step(x, y)
            return fleet, pre, kept

        clean, _, _ = run(False)
        drill, pre, kept = run(True)
        assert kept
        for m in (0, 2):
            assert bitwise(member_leaves(clean, m), member_leaves(drill, m))
        assert all(torch.isfinite(a).all() for a in member_leaves(drill, 1))
        assert not bitwise(member_leaves(drill, 1), pre)
        assert drill.alive_mask().tolist() == [1, 1, 1]

    def test_nan_cull_policy_drops_alive_bit_on_device(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(fused=True), 3, seed=7, drain_every_n=50)
        fleet.set_listeners(NanSentinelListener("cull", check_every_n=2))
        fleet.step(x, y)
        pre = member_leaves(fleet, 1)
        xs = np.broadcast_to(x, (3,) + x.shape).copy()
        ys = np.broadcast_to(y, (3,) + y.shape).copy()
        xs[1] = np.nan
        fleet.step(xs, ys, per_member=True)
        assert fleet._alive_np.tolist() == [1, 1, 1]    # host not told yet
        fleet.step(x, y)
        fleet.step(x, y)
        fleet.drain()
        assert fleet._alive_np.tolist() == [1, 0, 1]
        assert fleet.alive_mask().tolist() == [1, 0, 1]
        assert bitwise(member_leaves(fleet, 1), pre)
        ev = flightrec.events("fleet/nan_cull")
        assert len(ev) == 1 and ev[0]["attrs"]["member"] == 1
        assert OpProfiler.get().counter_value("fleet/nan_culls") == 1

    def test_solo_model_accepts_cull_policy_as_skip(self, batch):
        x, y = batch
        model = mlp()
        model.set_listeners(NanSentinelListener("cull", check_every_n=1))
        model.fit(DataSet(x, y))
        before = solo_leaves(model)
        bad = x.copy()
        bad[0] = np.nan
        model.fit(DataSet(bad, y))
        assert bitwise(solo_leaves(model), before)
        model.fit(DataSet(x, y))
        assert not bitwise(solo_leaves(model), before)

    def test_early_stop_culls_from_telemetry_bus(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(lambda m: m.Sgd(0.0)), 3, seed=7,
                             drain_every_n=3)
        fleet.set_listeners(NanSentinelListener("warn"),
                            FleetEarlyStop(patience=2))
        for _ in range(9):
            fleet.step(x, y)
        fleet.drain()
        assert fleet.alive_mask().tolist() == [0, 0, 0]
        evs = flightrec.events("fleet/cull")
        assert {e["attrs"]["reason"] for e in evs} == {"early_stop"}

    def test_spawn_resets_early_stop_history(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(lambda m: m.Sgd(0.0)), 2, seed=7,
                             drain_every_n=3)
        stopper = FleetEarlyStop(patience=2)
        fleet.set_listeners(NanSentinelListener("warn"), stopper)
        for _ in range(6):
            fleet.step(x, y)
        fleet.drain()
        assert fleet.alive_mask().tolist() == [0, 0]
        fleet.spawn(0)
        assert stopper._stale[0] == 0 and np.isinf(stopper._best[0])
        for _ in range(3):
            fleet.step(x, y)
        fleet.drain()
        assert fleet.alive_mask().tolist()[0] == 1

    def test_best_member_needs_telemetry(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 2, seed=7)
        fleet.step(x, y)
        with pytest.raises(RuntimeError, match="telemetry"):
            fleet.best_member()
        fleet.set_listeners(NanSentinelListener("warn"))
        fleet.step(x, y)
        assert fleet.best_member() in (0, 1)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

class TestSweep:
    def test_grid_validation(self):
        with pytest.raises(ValueError, match="unknown sweep field"):
            FleetTrainer.from_sweep(mlp(), {"momentum": [0.9, 0.99]})
        with pytest.raises(ValueError, match="disagree"):
            FleetTrainer.from_sweep(mlp(), {"lr": [1e-3], "l2": [0, 1]})
        with pytest.raises(ValueError, match="same hyperparameters"):
            FleetTrainer.from_sweep(mlp(), [{"lr": 1e-3}, {"l2": 0.1}])

    def test_same_init_sweep_shares_init_bits(self):
        fleet = FleetTrainer.from_sweep(mlp(), {"lr": [1e-3, 1e-2]}, seed=7)
        assert bitwise(member_leaves(fleet, 0), member_leaves(fleet, 1))

    @pytest.mark.parametrize("field,grid,kw", [
        ("lr", [0.05, 0.1, 0.2], {}),
        ("l2", [0.0, 1e-2, 3e-2], {}),
        ("dropout", [0.3, 0.5, 0.1], {"dropout": 0.3})])
    @pytest.mark.parametrize("fused", [False, True], ids=["leaf", "fused"])
    def test_sweep_member_matches_solo_twin(self, batch, field, grid, kw,
                                            fused):
        """A swept value is bitwise the solo network configured with it
        (``solo_twin`` bakes the member's hyperparameters in)."""
        x, y = batch
        fleet = FleetTrainer.from_sweep(
            mlp(lambda m: m.Nesterovs(0.05), fused=fused, **kw),
            {field: grid}, seed=7)
        twins = [fleet.solo_twin(m) for m in range(3)]
        for _ in range(3):
            fleet.step(x, y)
            for t in twins:
                t.fit(DataSet(x, y))
        for m in range(3):
            assert bitwise(member_leaves(fleet, m), solo_leaves(twins[m]))

    def test_list_of_dicts_grid(self, batch):
        x, y = batch
        fleet = FleetTrainer.from_sweep(
            mlp(), [{"lr": 1e-3, "l2": 0.0}, {"lr": 1e-2, "l2": 1e-3}])
        fleet.step(x, y)
        assert fleet.n_members == 2


# ---------------------------------------------------------------------------
# checkpoints and the serving handoff
# ---------------------------------------------------------------------------

class TestCheckpoints:
    @pytest.mark.parametrize("fused", [False, True], ids=["leaf", "fused"])
    def test_save_member_restores_into_solo_and_continues(self, batch,
                                                          tmp_path, fused):
        x, y = batch
        fleet = FleetTrainer.from_sweep(
            mlp(lambda m: m.Adam(1e-3), fused=fused, dropout=0.2,
                state_dtype="bfloat16"),
            {"lr": [1e-3, 3e-3, 1e-2]}, seed=7)
        for _ in range(3):
            fleet.step(x, y)
        path = fleet.save_member(2, str(tmp_path))
        solo = fleet.solo_twin(0)
        solo = type(solo)(fleet.member_conf(2)).init(device="cpu")
        restore_training_state(solo, path)
        assert bitwise(member_leaves(fleet, 2), solo_leaves(solo))
        assert bitwise(member_state(fleet, 2), solo_state(solo))
        assert solo._iteration == 3
        for _ in range(3):
            fleet.step(x, y)
            solo.fit(DataSet(x, y))
        assert bitwise(member_leaves(fleet, 2), solo_leaves(solo))

    def test_fleet_kill_resume_exact_parity(self, batch, tmp_path):
        x, y = batch
        run_a = FleetTrainer(mlp(fused=True, dropout=0.2), 4, seed=7)
        for _ in range(2):
            run_a.step(x, y)
        path = run_a.save(str(tmp_path))
        for _ in range(3):
            run_a.step(x, y)
        run_b = FleetTrainer(mlp(fused=True, dropout=0.2), 4, seed=7)
        ptrs = run_b.buffer_ptrs()
        run_b.restore(path)
        assert run_b._iteration == 2
        assert run_b.buffer_ptrs() == ptrs
        for _ in range(3):
            run_b.step(x, y)
        for m in range(4):
            assert bitwise(member_leaves(run_a, m), member_leaves(run_b, m))
            assert bitwise(member_state(run_a, m), member_state(run_b, m))

    def test_cull_then_resume_keeps_alive_mask(self, batch, tmp_path):
        x, y = batch
        run_a = FleetTrainer(mlp(), 3, seed=7)
        run_a.step(x, y)
        run_a.cull(0)
        path = run_a.save(str(tmp_path))
        run_b = FleetTrainer(mlp(), 3, seed=7)
        run_b.restore(path)
        assert run_b.alive_mask().tolist() == [0, 1, 1]
        frozen = member_leaves(run_b, 0)
        run_b.step(x, y)
        assert bitwise(member_leaves(run_b, 0), frozen)

    def test_manifest_carries_fleet_metadata(self, batch, tmp_path):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        fleet.step(x, y)
        fleet.save_member(1, str(tmp_path))
        fleet.save(str(tmp_path))
        metas = [e.get("fleet") for e in read_manifest(str(tmp_path))]
        assert {"member": 1, "members": 3} in metas
        assert {"members": 3} in metas

    def test_restore_refuses_wrong_shape(self, batch, tmp_path):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        fleet.step(x, y)
        member_path = fleet.save_member(0, str(tmp_path))
        fleet_path = fleet.save(str(tmp_path))
        with pytest.raises(ValueError, match="not a fleet checkpoint"):
            fleet.restore(member_path)
        with pytest.raises(ValueError, match="members"):
            FleetTrainer(mlp(), 2, seed=7).restore(fleet_path)

    def test_sweep_hyper_rides_resume(self, batch, tmp_path):
        x, y = batch
        run_a = FleetTrainer.from_sweep(mlp(lambda m: m.Sgd(0.05),
                                            fused=True),
                                        {"lr": [0.05, 0.2]}, seed=7)
        run_a.step(x, y)
        path = run_a.save(str(tmp_path))
        run_b = FleetTrainer.from_sweep(mlp(lambda m: m.Sgd(0.05),
                                            fused=True),
                                        {"lr": [0.5, 0.5]}, seed=7)
        run_b.restore(path)
        run_a.step(x, y)
        run_b.step(x, y)
        assert bitwise(member_leaves(run_a, 1), member_leaves(run_b, 1))


class TestServingHandoff:
    def test_export_member_serves_the_member_outputs(self, batch):
        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7)
        for _ in range(2):
            fleet.step(x, y)
        net = fleet.export_member(1)
        stacked = fleet.output(x, per_member=False)
        assert torch.equal(stacked[1], net.output(x))
        frozen = fleet.stacked_state()
        fleet.step(x, y)
        again = fleet.output(np.stack([x] * 3), params=frozen)
        assert torch.equal(again, stacked)

    def test_fleet_member_canaries_onto_live_engine(self, batch, tmp_path):
        from deeplearning4j_tpu_torch.parallel import ServingEngine
        from deeplearning4j_tpu_torch.util.checkpoint import \
            read_checkpoint_params
        from deeplearning4j_tpu_torch.util.model_serializer import \
            tree_leaves

        x, y = batch
        fleet = FleetTrainer(mlp(), 3, seed=7, drain_every_n=2)
        fleet.set_listeners(NanSentinelListener("warn"))
        for _ in range(4):
            fleet.step(x, y)
        best = fleet.best_member()
        path = fleet.save_member(best, str(tmp_path))
        engine = (ServingEngine.Builder(mlp(seed=123))
                  .buckets((1, 4, 16)).input_shape((N_IN,))
                  .workers(1).max_wait_ms(2.0).build())
        try:
            engine.output(x[:4])
            handle = engine.publish_checkpoint(path, canary_window_s=0.2,
                                               confirm_window_s=0.2,
                                               check_interval_s=0.05)
            deadline = time.monotonic() + 10
            while not handle.done and time.monotonic() < deadline:
                engine.output(x[:4])
            assert handle.result(timeout=10) == "promoted"
            want_p, want_s = read_checkpoint_params(
                path, engine.model._params, engine.model._states)
            got_p, got_s = engine._dev_params[0]
            got = tree_leaves(got_p) + tree_leaves(got_s)
            want = tree_leaves(want_p) + tree_leaves(want_s)
            assert bitwise(got, want)
            assert bitwise(tree_leaves(want_p), member_leaves(fleet, best))
        finally:
            engine.shutdown()
