"""The port's pipeline parallelism against the JAX package's, on the CPU.

Port counterparts of ``tests/test_parallel_extras.py``'s pipeline classes
(``TestPipelineParallel``, ``TestPipelineFromMLN``,
``TestHeterogeneousPipeline``) and of ``tests/test_pipeline_parallel.py``
(the supervisor's ``remap_and_continue`` drills in ``TestKillAStage``),
plus parity with the JAX
objects on the same parameters: the JAX side on its 8 virtual CPU devices,
the port on ``["cpu"] * n`` slots. Inputs come from numpy seeds.

Tolerances: the schedule tables equal; ``pipeline_apply`` and the
pipelines' forwards within the JAX tests' 1e-5 (1e-4 through attention
blocks), gradients 1e-4; ``PipelineTrainer``'s loss sequence against the
JAX trainer's within 1e-5 relative (the same float32 operations through
different matrix kernels); inside the port, loss sequences and parameters
bitwise across schedules, stage counts, a single-slot microbatched fit and a
remap, as the JAX contract (``pipeline.py:710-713``) states.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu_torch.common import faultinject, flightrec
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import DataSet, NDArrayDataSetIterator
from deeplearning4j_tpu_torch.parallel import (PipelineParallel,
                                               PipelineTrainer,
                                               pipeline_apply,
                                               pipeline_from_mln,
                                               schedule_meta,
                                               stack_stage_params,
                                               stage_partition)
from deeplearning4j_tpu_torch.parallel.mesh import make_pipeline_mesh
from torch_parity import mln_twins, modules

FEAT = 8
CPU = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _clean_faults():
    faultinject.clear_plan()
    yield
    faultinject.clear_plan()
    os.environ.pop(faultinject.ENV_PLAN, None)


def pmesh(S, data=1):
    return make_pipeline_mesh(data, S, devices=CPU[:data * S])


def jmesh(S):
    return JMesh(np.asarray(jax.devices()[:S]).reshape(S), ("stage",))


def dense_conf(which, n_layers=4, feat=FEAT, seed=2, lr=0.05, act="tanh",
               widths=None):
    m = modules(which)
    b = (m.NeuralNetConfiguration.builder().seed(seed)
         .updater(m.Sgd(learning_rate=lr)).list())
    for i in range(n_layers):
        w = widths[i] if widths else feat
        b.layer(m.L.DenseLayer(n_out=w, activation=act))
    return b.set_input_type(m.InputType.feed_forward(feat)).build()


def dense_stack(n_layers=4, feat=FEAT, seed=2, lr=0.05):
    m = modules("torch")
    return m.MultiLayerNetwork(dense_conf("torch", n_layers, feat, seed,
                                          lr)).init(device="cpu")


def dense_twins(n_layers=4, feat=FEAT, seed=2, lr=0.05):
    return mln_twins(dense_conf("jax", n_layers, feat, seed, lr),
                     dense_conf("torch", n_layers, feat, seed, lr))


def synth(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, FEAT)).astype(np.float32)
    return x, np.tanh(x) * 0.5


class Collect:
    def __init__(self):
        self.losses = []

    def iteration_done(self, model, iteration, score):
        self.losses.append(float(np.asarray(score)))


def flat_params(model):
    return [a.detach().numpy().copy() for k in sorted(model._params)
            for _, a in sorted(model._params[k].items())]


def params_equal(a, b):
    fa, fb = flat_params(a), flat_params(b)
    return len(fa) == len(fb) and all(np.array_equal(p, q)
                                      for p, q in zip(fa, fb))


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _jstage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _stage_params(rng, d, s):
    return [{"w": rng.standard_normal((d, d)).astype(np.float32) * 0.5,
             "b": np.zeros(d, np.float32)} for _ in range(s)]


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in tree.items()}


# --- GPipe construction (tests/test_parallel_extras.py) ---------------------------

class TestPipelineParallel:
    def test_forward_matches_sequential(self):
        S, D, B, M = 4, 8, 16, 8
        rng = np.random.default_rng(1)
        params = _stage_params(rng, D, S)
        x = rng.standard_normal((B, D)).astype(np.float32)
        pp = PipelineParallel(_stage_fn, [_t(p) for p in params], pmesh(S),
                              n_micro=M)
        got = pp.forward(x).numpy()
        ref = x
        for p in params:
            ref = np.tanh(ref @ p["w"] + p["b"])
        np.testing.assert_allclose(got, ref, atol=1e-5)

    def test_gradients_match_sequential(self):
        S, D, B, M = 4, 6, 8, 4
        rng = np.random.default_rng(2)
        params = _stage_params(rng, D, S)
        x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

        def grads(run):
            st = {k: v.requires_grad_(True) for k, v in
                  stack_stage_params([_t(p) for p in params]).items()}
            loss = torch.mean((run(st) - y) ** 2)
            loss.backward()
            return {k: v.grad.numpy() for k, v in st.items()}

        def seq(st):
            h = x
            for s in range(S):
                h = _stage_fn({k: v[s] for k, v in st.items()}, h)
            return h

        g_pipe = grads(lambda st: pipeline_apply(_stage_fn, st, x, pmesh(S),
                                                 M, "stage"))
        g_seq = grads(seq)
        for k in ("w", "b"):
            np.testing.assert_allclose(g_pipe[k], g_seq[k], atol=1e-4)

    def test_train_step_reduces_loss(self):
        S, D, B, M = 4, 8, 32, 8
        rng = np.random.default_rng(3)
        pp = PipelineParallel(_stage_fn,
                              [_t(p) for p in _stage_params(rng, D, S)],
                              pmesh(S), n_micro=M)
        x = rng.standard_normal((B, D)).astype(np.float32)
        y = np.tanh(x) * 0.5
        losses = [float(pp.train_step(x, y, lr=0.1)) for _ in range(60)]
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    def test_pipeline_apply_and_train_step_against_jax(self):
        """The port's ``pipeline_apply`` forward and gradients, and
        ``PipelineParallel.train_step``'s losses, against the JAX package's
        on the same stage parameters and inputs."""
        from deeplearning4j_tpu.parallel.pipeline import (
            PipelineParallel as JPP, pipeline_apply as jpipeline_apply,
            stack_stage_params as jstack)

        S, D, B, M = 4, 6, 8, 4
        rng = np.random.default_rng(12)
        params = _stage_params(rng, D, S)
        x = rng.standard_normal((B, D)).astype(np.float32)
        y = np.tanh(x) * 0.5

        def jloss(p):
            out = jpipeline_apply(_jstage_fn, p, jnp.asarray(x), jmesh(S), M,
                                  "stage")
            return jnp.mean((out - y) ** 2), out

        (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
            jstack(params))
        st = {k: v.requires_grad_(True) for k, v in
              stack_stage_params([_t(p) for p in params]).items()}
        out = pipeline_apply(_stage_fn, st, x, pmesh(S), M, "stage")
        loss = torch.mean((out - torch.from_numpy(y)) ** 2)
        loss.backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   atol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(st[k].grad.numpy(),
                                       np.asarray(jg[k]), atol=1e-4)
        jp = JPP(_jstage_fn, params, jmesh(S), n_micro=M)
        tp = PipelineParallel(_stage_fn, [_t(p) for p in params], pmesh(S),
                              n_micro=M)
        jls = [float(jp.train_step(x, y, lr=0.1)) for _ in range(5)]
        tls = [float(tp.train_step(x, y, lr=0.1)) for _ in range(5)]
        np.testing.assert_allclose(tls, jls, rtol=1e-5)


class TestPipelineFromMLN:
    def test_forward_matches_mln(self):
        S, D = 8, 16
        model = dense_stack(S, D)
        pp = pipeline_from_mln(model, pmesh(S), n_micro=8)
        x = np.random.default_rng(0).standard_normal((32, D)).astype(
            np.float32)
        np.testing.assert_allclose(pp.forward(x).numpy(),
                                   model.output(x).numpy(), atol=1e-5)

    def test_train_step_reduces_loss(self):
        S, D = 4, 12
        model = dense_stack(S, D, seed=9)
        pp = pipeline_from_mln(model, pmesh(S), n_micro=4)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((16, D)).astype(np.float32)
        y = np.tanh(x) * 0.3
        losses = [float(pp.train_step(x, y, lr=0.1)) for _ in range(50)]
        assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])

    def test_attention_block_stack(self):
        """Identical self-attention blocks ride the pipeline, held to the
        model and to the JAX pipeline on the same parameters."""
        from deeplearning4j_tpu.parallel import pipeline_from_mln as jfrom

        S, T, F = 4, 6, 16

        def conf(which):
            m = modules(which)
            b = (m.NeuralNetConfiguration.builder().seed(3)
                 .updater(m.Sgd(learning_rate=0.01)).list())
            for _ in range(S):
                b.layer(m.L.SelfAttentionLayer(n_out=F, n_heads=2))
            return b.set_input_type(m.InputType.recurrent(F, T)).build()

        jn, tn = mln_twins(conf("jax"), conf("torch"))
        pp = pipeline_from_mln(tn, pmesh(S), n_micro=4)
        x = np.random.default_rng(2).standard_normal((8, T, F)).astype(
            np.float32)
        got = pp.forward(x).numpy()
        np.testing.assert_allclose(got, tn.output(x).numpy(), atol=1e-4)
        jgot = np.asarray(jfrom(jn, jmesh(S), n_micro=4).forward(x))
        np.testing.assert_allclose(got, jgot, atol=1e-4)

    def test_heterogeneous_stack_refused(self):
        m = modules("torch")
        model = m.MultiLayerNetwork(dense_conf(
            "torch", 4, 16, 3, 0.01, widths=[16, 16, 16, 8])).init(
                device="cpu")
        with pytest.raises(ValueError, match="identical"):
            pipeline_from_mln(model, pmesh(4), n_micro=4)


def conv_dense_conf(which, seed=4):
    m = modules(which)
    L = m.L
    return (m.NeuralNetConfiguration.builder().seed(seed)
            .updater(m.Sgd(learning_rate=0.05)).list()
            .layer(L.ConvolutionLayer(n_out=4, kernel_size=(3, 3),
                                      activation="relu",
                                      convolution_mode="same"))
            .layer(L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(L.ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                      activation="relu",
                                      convolution_mode="same"))
            .layer(L.DenseLayer(n_out=16, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss="mcxent"))
            .set_input_type(m.InputType.convolutional(8, 8, 2)).build())


def conv_dense_model(seed=4):
    m = modules("torch")
    return m.MultiLayerNetwork(conv_dense_conf("torch", seed)).init(
        device="cpu")


class TestHeterogeneousPipeline:
    def test_conv_dense_cut_forward_and_grad_parity(self):
        model = conv_dense_model()
        rng = np.random.default_rng(0)
        x = rng.standard_normal((8, 2, 8, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        pp = pipeline_from_mln(model, pmesh(2), n_micro=4, cuts=[3],
                               example_input=x.shape)
        np.testing.assert_allclose(pp.forward(x).numpy(),
                                   model.output(x).numpy(), atol=1e-5)

        def grads(run):
            trees = [{k: {n: a.detach().clone().requires_grad_(True)
                          for n, a in v.items()} for k, v in p.items()}
                     for p in pp.params]
            loss = torch.mean((run(trees) - torch.from_numpy(y)) ** 2)
            loss.backward()
            return [a.grad.numpy() for t in trees for v in t.values()
                    for a in v.values()]

        def seq(trees):
            out = torch.from_numpy(x)
            for s in range(2):
                out = pp._stage_fns[s](trees[s], out)
            return out

        for a, b in zip(grads(lambda tr: pp._run(tr, x)), grads(seq)):
            np.testing.assert_allclose(a, b, atol=2e-5)

    def test_transformer_two_stage_split(self):
        T, F = 6, 16
        m = modules("torch")
        b = (m.NeuralNetConfiguration.builder().seed(3)
             .updater(m.Sgd(learning_rate=0.01)).list())
        for _ in range(4):
            b.layer(m.L.SelfAttentionLayer(n_out=F, n_heads=2))
        b.layer(m.L.GlobalPoolingLayer(pooling_type="avg"))
        b.layer(m.L.DenseLayer(n_out=8, activation="tanh"))
        model = m.MultiLayerNetwork(b.set_input_type(
            m.InputType.recurrent(F, T)).build()).init(device="cpu")
        x = np.random.default_rng(2).standard_normal((8, T, F)).astype(
            np.float32)
        pp = pipeline_from_mln(model, pmesh(2), n_micro=4, cuts=[2],
                               example_input=x.shape)
        np.testing.assert_allclose(pp.forward(x).numpy(),
                                   model.output(x).numpy(), atol=1e-4)

    def test_train_step_reduces_loss_het(self):
        model = conv_dense_model(seed=11)
        rng = np.random.default_rng(5)
        x = rng.standard_normal((8, 2, 8, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        pp = pipeline_from_mln(model, pmesh(2), n_micro=4, cuts=[3],
                               example_input=x.shape)
        losses = [float(pp.train_step(x, y, lr=0.5)) for _ in range(40)]
        assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])

    def test_four_stage_uneven_cuts(self):
        model = conv_dense_model(seed=8)
        x = np.random.default_rng(6).standard_normal((8, 2, 8, 8)).astype(
            np.float32)
        pp = pipeline_from_mln(model, pmesh(4), n_micro=4, cuts=[1, 3, 4],
                               example_input=x.shape)
        assert pp.in_shapes[1] == (4, 8, 8) and pp.out_shapes[-1] == (3,)
        np.testing.assert_allclose(pp.forward(x).numpy(),
                                   model.output(x).numpy(), atol=1e-5)

    def test_against_jax_heterogeneous_pipeline(self):
        """The port's cut pipeline against the JAX one built from the same
        parameters: shapes, the forward (1e-5) and three train steps'
        losses and stage parameters; the carrier copies the JAX stage
        trees in."""
        from deeplearning4j_tpu.parallel import pipeline_from_mln as jfrom
        from deeplearning4j_tpu_torch.util.convert import (
            heterogeneous_pipeline_state_from_numpy)

        jn, tn = mln_twins(conv_dense_conf("jax", 6), conv_dense_conf(
            "torch", 6))
        rng = np.random.default_rng(7)
        x = rng.standard_normal((8, 2, 8, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        jp = jfrom(jn, jmesh(2), n_micro=4, cuts=[3], example_input=x.shape)
        tp = pipeline_from_mln(tn, pmesh(2), n_micro=4, cuts=[3],
                               example_input=x.shape)
        assert tp.in_shapes == jp.in_shapes
        assert tp.out_shapes == jp.out_shapes
        np.testing.assert_allclose(tp.forward(x).numpy(),
                                   np.asarray(jp.forward(x)), atol=1e-5)
        jls = [float(jp.train_step(x, y, lr=0.5)) for _ in range(3)]
        tls = [float(tp.train_step(x, y, lr=0.5)) for _ in range(3)]
        np.testing.assert_allclose(tls, jls, rtol=1e-5)
        for s in range(2):
            jt, tt = jp.stage_params(s), tp.stage_params(s)
            for i in jt:
                for k in jt[i]:
                    np.testing.assert_allclose(tt[i][k], jt[i][k],
                                               atol=1e-5)
        fresh = pipeline_from_mln(conv_dense_model(9), pmesh(2), n_micro=4,
                                  cuts=[3], example_input=x.shape)
        heterogeneous_pipeline_state_from_numpy(
            fresh, [jp.stage_params(s) for s in range(2)])
        np.testing.assert_allclose(fresh.forward(x).numpy(),
                                   np.asarray(jp.forward(x)), atol=1e-5)

    def test_stateful_layer_refused(self):
        m = modules("torch")
        conf = (m.NeuralNetConfiguration.builder().seed(1)
                .updater(m.Sgd(learning_rate=0.1)).list()
                .layer(m.L.DenseLayer(n_out=8, activation="relu"))
                .layer(m.L.BatchNormalization())
                .layer(m.L.DenseLayer(n_out=4, activation="tanh"))
                .set_input_type(m.InputType.feed_forward(8)).build())
        model = m.MultiLayerNetwork(conf).init(device="cpu")
        with pytest.raises(ValueError, match="state"):
            pipeline_from_mln(model, pmesh(2), n_micro=2, cuts=[1],
                              example_input=(4, 8))

    def test_mismatched_cut_count_refused(self):
        with pytest.raises(ValueError, match="stages"):
            pipeline_from_mln(conv_dense_model(2), pmesh(2), n_micro=2,
                              cuts=[1, 3], example_input=(4, 2, 8, 8))

    def test_out_of_range_cuts_refused(self):
        model = conv_dense_model(3)
        for bad in ([-2], [7], [0], [5]):
            with pytest.raises(ValueError, match="cuts"):
                pipeline_from_mln(model, pmesh(2), n_micro=2, cuts=bad,
                                  example_input=(4, 2, 8, 8))


# --- the trainer (tests/test_pipeline_parallel.py) ----------------------------------

def reference_losses(n_layers, seed, x, y, batch, data_axis, n_micro,
                     steps):
    """A single-slot microbatched fit with the pipeline's accumulation:
    per data shard, per-microbatch gradients and losses added in ascending
    order, then the shards in order, then the updater. Returns (losses,
    model)."""
    from deeplearning4j_tpu_torch.learning.precision import apply_updater

    ref = dense_stack(n_layers, seed=seed)
    layer0 = ref.conf.layers[0]
    upd = ref.conf.global_conf.updater
    params = ref._params
    state = upd.init(params)
    out = []
    for i in range(steps):
        xb = torch.from_numpy(x[i * batch:(i + 1) * batch])
        yb = torch.from_numpy(y[i * batch:(i + 1) * batch])
        wb = torch.ones(batch)
        denom = torch.clamp_min(wb.sum(), 1.0)
        bl = batch // data_axis
        mb = bl // n_micro
        dp, loss = None, None
        for d in range(data_axis):
            dp_d, loss_d = None, None
            for m in range(n_micro):
                sl = slice(d * bl + m * mb, d * bl + (m + 1) * mb)
                leaves = {k: {n: a.detach().requires_grad_(True)
                              for n, a in v.items()}
                          for k, v in params.items()}
                h = xb[sl]
                for k in sorted(leaves):
                    h = layer0.apply(leaves[k], h, {}, False)[0]
                per = torch.mean(torch.square(h - yb[sl]), dim=1)
                l_m = torch.sum(per * wb[sl]) / denom
                flat = [a for k in sorted(leaves)
                        for _, a in sorted(leaves[k].items())]
                gs = iter(torch.autograd.grad(l_m, flat))
                g = {k: {n: next(gs) for n, _ in sorted(leaves[k].items())}
                     for k in sorted(leaves)}
                dp_d = g if dp_d is None else {
                    k: {n: dp_d[k][n] + g[k][n] for n in g[k]} for k in g}
                loss_d = l_m.detach() if loss_d is None else \
                    loss_d + l_m.detach()
            dp = dp_d if dp is None else {
                k: {n: dp[k][n] + dp_d[k][n] for n in dp_d[k]} for k in dp_d}
            loss = loss_d if loss is None else loss + loss_d
        with torch.no_grad():
            params, state = apply_updater(upd, dp, state, params, i,
                                          ref.generator())
        out.append(float(loss))
    ref._params = params
    return out, ref


class TestSchedules:
    def test_partition(self):
        assert stage_partition(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
        assert stage_partition(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
        with pytest.raises(ValueError, match="cut"):
            stage_partition(3, 4)

    @pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
    @pytest.mark.parametrize("S,M", [(2, 1), (3, 4), (4, 8)])
    def test_meta_invariants(self, schedule, S, M):
        meta = schedule_meta(schedule, S, M)
        fwd, bwd = meta["fwd"], meta["bwd"]
        assert meta["T"] == 2 * (M + S - 1)
        assert not (fwd & bwd).any()
        assert fwd.sum() == bwd.sum() == M * S
        assert meta["bubble_fraction"] == pytest.approx(
            (S - 1) / (M + S - 1))
        assert meta["stash"] == (min(S, M) if schedule == "1f1b" else M)
        for m in range(M):
            f = [int(np.where(fwd[:, s] & (meta["m_f"][:, s] == m))[0][0])
                 for s in range(S)]
            b = [int(np.where(bwd[:, s] & (meta["m_b"][:, s] == m))[0][0])
                 for s in range(S)]
            assert f == [f[0] + s for s in range(S)]
            assert b == [b[0] - s for s in range(S)]
            assert b[-1] > f[-1]

    @pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
    @pytest.mark.parametrize("S,M", [(2, 1), (3, 4), (4, 8), (5, 3)])
    def test_meta_tables_equal_jax(self, schedule, S, M):
        from deeplearning4j_tpu.parallel.pipeline import (
            schedule_meta as jmeta, stage_partition as jpart)

        mine, theirs = schedule_meta(schedule, S, M), jmeta(schedule, S, M)
        assert mine.keys() == theirs.keys()
        for k in mine:
            if isinstance(mine[k], np.ndarray):
                assert np.array_equal(mine[k], theirs[k]), k
            else:
                assert mine[k] == theirs[k], k
        assert stage_partition(4 * S + 1, S) == jpart(4 * S + 1, S)

    def test_schedules_bitwise_vs_reference(self):
        """1F1B and GPipe at 4 stages and 1F1B at 2: loss sequences and
        final parameters bitwise equal to each other and to the single-slot
        microbatched reference."""
        n_layers, batch, steps, D, M = 4, 32, 4, 2, 4
        x, y = synth(steps * batch)
        runs = {}
        for schedule, S in (("1f1b", 4), ("gpipe", 4), ("1f1b", 2)):
            model = dense_stack(n_layers)
            tr = PipelineTrainer(model, stages=S, n_micro=M,
                                 schedule=schedule, data=D)
            c = Collect()
            tr.set_listeners(c)
            tr.fit(NDArrayDataSetIterator(x, y, batch_size=batch),
                   epochs=1, batch_size=batch)
            runs[(schedule, S)] = (c.losses, model)
        ref_losses, ref = reference_losses(n_layers, 2, x, y, batch, D, M,
                                           steps)
        assert (runs[("1f1b", 4)][0] == runs[("gpipe", 4)][0]
                == runs[("1f1b", 2)][0] == ref_losses)
        for losses, model in runs.values():
            assert params_equal(model, ref)

    def test_padded_batch_rows_inert(self):
        x, y = synth(8)
        model = dense_stack(4)
        tr = PipelineTrainer(model, stages=4, n_micro=4, data=2)
        c = Collect()
        tr.set_listeners(c)
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        ref = dense_stack(4)
        xx = torch.from_numpy(x)
        for k in sorted(ref._params):
            xx = ref.conf.layers[0].apply(ref._params[k], xx, {}, False)[0]
        want = float(torch.sum(torch.mean(torch.square(
            xx - torch.from_numpy(y)), dim=1)) / 8.0)
        assert c.losses[0] == pytest.approx(want, rel=1e-6)

    def test_loss_sequence_against_jax_trainer(self):
        """The port's trainer against the JAX PipelineTrainer on the same
        parameters and batches (4 stages x 2 data, 1F1B): the loss sequence
        within 1e-5 relative, the final parameters within 1e-5; the carrier
        puts the JAX trainer's stacked state into a port trainer, whose
        next losses follow the JAX trainer's."""
        from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIter
        from deeplearning4j_tpu.parallel import PipelineTrainer as JPT
        from deeplearning4j_tpu_torch.util.convert import (
            pipeline_trainer_state_from_numpy)

        x, y = synth(3 * 32, seed=4)
        jn, tn = dense_twins(5, seed=6)
        jt = JPT(jn, stages=4, n_micro=4, data=2)
        tt = PipelineTrainer(tn, stages=4, n_micro=4, data=2)
        jc, tc = Collect(), Collect()
        jt.set_listeners(jc)
        tt.set_listeners(tc)
        jt.fit(JIter(x, y, batch_size=32), epochs=1, batch_size=32)
        tt.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        np.testing.assert_allclose(tc.losses, jc.losses, rtol=1e-5)
        for i, k in enumerate(sorted(tn._params)):
            for n, a in tn._params[k].items():
                np.testing.assert_allclose(
                    a.detach().numpy(), np.asarray(jn._params[i][n]),
                    atol=1e-5)
        _, fresh = dense_twins(5, seed=8)
        ft = PipelineTrainer(fresh, stages=4, n_micro=4, data=2)
        pipeline_trainer_state_from_numpy(
            ft, jax.tree.map(np.asarray, jax.device_get(jt._stk_params)))
        fresh._iteration = tn._iteration
        jc2, fc = Collect(), Collect()
        jt.set_listeners(jc2)
        ft.set_listeners(fc)
        jt.fit(JIter(x, y, batch_size=32), epochs=1, batch_size=32)
        ft.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        np.testing.assert_allclose(fc.losses, jc2.losses, rtol=1e-5)


    def test_stacked_adam_state_carried_from_jax(self):
        """The carrier with the JAX trainer's stacked Adam moments: the next
        steps' losses follow the JAX trainer's."""
        from deeplearning4j_tpu.data import NDArrayDataSetIterator as JIter
        from deeplearning4j_tpu.parallel import PipelineTrainer as JPT
        from deeplearning4j_tpu_torch.util.convert import (
            pipeline_trainer_state_from_numpy)

        def conf(which):
            m = modules(which)
            b = (m.NeuralNetConfiguration.builder().seed(3)
                 .updater(m.Adam(1e-2)).list())
            for _ in range(3):
                b.layer(m.L.DenseLayer(n_out=FEAT, activation="tanh"))
            return b.set_input_type(m.InputType.feed_forward(FEAT)).build()

        x, y = synth(2 * 16, seed=9)
        jn, tn = mln_twins(conf("jax"), conf("torch"))
        jt = JPT(jn, stages=2, n_micro=2, data=1)
        jt.fit(JIter(x[:16], y[:16], batch_size=16), epochs=1, batch_size=16)
        tt = PipelineTrainer(tn, stages=2, n_micro=2, data=1)
        pipeline_trainer_state_from_numpy(
            tt, jax.tree.map(np.asarray, jax.device_get(jt._stk_params)),
            jax.tree.map(np.asarray, jax.device_get(jt._stk_upd)))
        tn._iteration = 1
        assert set(tn._updater_state) == {"m", "v"}
        jc, tc = Collect(), Collect()
        jt.set_listeners(jc)
        tt.set_listeners(tc)
        jt.fit(JIter(x[16:], y[16:], batch_size=16), epochs=1,
               batch_size=16)
        tt.fit(NDArrayDataSetIterator(x[16:], y[16:], batch_size=16),
               epochs=1, batch_size=16)
        np.testing.assert_allclose(tc.losses, jc.losses, rtol=1e-5)


class TestFitSurface:
    def test_one_build_per_stage_count_and_schedule(self):
        prof = OpProfiler.get()
        x, y = synth(2 * 32)
        model = dense_stack(4)
        tr = PipelineTrainer(model, stages=4, n_micro=4, data=2)
        before = prof.counter_value("trace/pipeline_fit_step")
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert prof.counter_value("trace/pipeline_fit_step") == before + 1
        tr.remap(3)
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert prof.counter_value("trace/pipeline_fit_step") == before + 2
        tr.remap(4)   # grow back: the cached step and mesh
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert prof.counter_value("trace/pipeline_fit_step") == before + 2

    def test_grown_back_fit_is_steady_state(self):
        """The JAX drill's region (``tests/test_pipeline_parallel.py``):
        after a remap cycle back to a built stage count the fit builds
        nothing, adds no census generation and reads nothing back."""
        from deeplearning4j_tpu_torch.common import tracecheck, xprof

        xprof.reset()
        x, y = synth(2 * 32)
        tr = PipelineTrainer(dense_stack(4), stages=4, n_micro=4, data=2)
        for stages in (4, 3):
            if stages != 4:
                tr.remap(stages)
            tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
                   batch_size=32)
        tr.remap(4)
        with tracecheck.steady_state("pipeline steady") as region:
            tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
                   batch_size=32)
        assert region.compiles == 0 and region.counter_deltas == {}
        e = xprof.census()["pipeline/fit_step"]
        # one generation per (stage count, schedule) and batch shape
        assert e["generations"] == 2 and e["calls"] == 6

    def test_telemetry_aux(self):
        class Sink:
            wants_telemetry = True

            def __init__(self):
                self.aux = []

            def iteration_done(self, model, iteration, score):
                pass

            def telemetry_done(self, model, iteration, aux):
                self.aux.append(aux)

        x, y = synth(2 * 32)
        tr = PipelineTrainer(dense_stack(4), stages=4, n_micro=4, data=2)
        sink = Sink()
        tr.set_listeners(sink)
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert len(sink.aux) == 2
        aux = sink.aux[0]
        for k in ("loss", "grad_norm", "update_norm", "param_norm",
                  "update_ratio", "nonfinite", "nonfinite_total"):
            assert k in aux
        assert tuple(aux["grad_norm"].shape) == (4,)
        assert torch.isfinite(aux["grad_norm"]).all()
        assert (aux["grad_norm"] > 0).all()
        assert int(aux["nonfinite_total"]) == 0

    def test_labels_mask_refused(self):
        x, y = synth(32)
        ds = DataSet(x, y)
        ds.labels_mask = ds.labels
        tr = PipelineTrainer(dense_stack(4), stages=4, n_micro=4, data=2)
        with pytest.raises(ValueError, match="masks"):
            tr.fit(ds, epochs=1, batch_size=32)

    def test_model_contract_refusals(self):
        model = dense_stack(3)
        with pytest.raises(ValueError, match="layers"):
            PipelineTrainer(model, stages=4, n_micro=4)
        with pytest.raises(ValueError, match=">= 2 stages"):
            PipelineTrainer(model, stages=1, n_micro=4)
        m = modules("torch")
        b = (m.NeuralNetConfiguration.builder().seed(1)
             .updater(m.Sgd(learning_rate=0.1)).list()
             .layer(m.L.DenseLayer(n_out=FEAT, activation="tanh"))
             .layer(m.L.DenseLayer(n_out=FEAT, activation="relu")))
        mixed = m.MultiLayerNetwork(b.set_input_type(
            m.InputType.feed_forward(FEAT)).build()).init(device="cpu")
        with pytest.raises(ValueError, match="identical"):
            PipelineTrainer(mixed, stages=2, n_micro=4)


class TestKillAStage:
    def test_manual_remap_bitwise_vs_fresh_run(self):
        """An env fault plan kills stage 2 mid-epoch; after remap(3) the
        continuation's losses and final parameters are bitwise a fresh
        3-stage run's from the same state and cursor; no batch is lost."""
        n_layers, batch, D, M = 4, 32, 2, 4
        x, y = synth(6 * batch)

        def make_it():
            return NDArrayDataSetIterator(x, y, batch_size=batch)

        os.environ[faultinject.ENV_PLAN] = json.dumps(
            [{"site": "pipeline/stage", "kind": "device_loss",
              "index": 3, "stage": 2}])
        faultinject.clear_plan()
        model = dense_stack(n_layers)
        tr = PipelineTrainer(model, stages=4, n_micro=M, data=D)
        c = Collect()
        tr.set_listeners(c)
        with pytest.raises(faultinject.DeviceLostError) as ei:
            tr.fit(make_it(), epochs=2, batch_size=batch)
        assert ei.value.stage == 2
        faultinject.clear_plan()
        os.environ.pop(faultinject.ENV_PLAN)
        assert len(c.losses) == 3
        cursor = (int(model._epoch - model._fit_epoch0),
                  int(model._steps_in_epoch))
        snap_p = {k: {n: a.detach().clone() for n, a in v.items()}
                  for k, v in model._params.items()}
        it_ep = (model._iteration, model._epoch)

        removed = tr.remap(3, lost_stages=[2])
        assert len(removed) == D
        assert not (set(removed) & set(tr.mesh.devices.flat))
        tr.fit(make_it(), epochs=2, batch_size=batch, resume_cursor=cursor)
        post = c.losses[3:]
        assert len(post) == 2 * 6 - 3

        model2 = dense_stack(n_layers)
        model2._params = snap_p
        model2._updater_state = None
        model2._iteration, model2._epoch = it_ep
        tr2 = PipelineTrainer(model2, stages=3, n_micro=M, data=D)
        c2 = Collect()
        tr2.set_listeners(c2)
        tr2.fit(make_it(), epochs=2, batch_size=batch, resume_cursor=cursor)
        assert post == c2.losses
        assert params_equal(model, model2)

    def test_supervised_remap_and_continue(self, tmp_path):
        """The supervisor heals a lost stage by remap: no restart used, no
        microbatch lost, and the losses after the remap bitwise a fresh
        3-stage run's from the same state and cursor."""
        from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

        x, y = synth(4 * 32)

        def make_it():
            return NDArrayDataSetIterator(x, y, batch_size=32)

        os.environ[faultinject.ENV_PLAN] = json.dumps(
            [{"site": "pipeline/stage", "kind": "device_loss",
              "index": 2, "stage": 1}])
        faultinject.clear_plan()
        model = dense_stack(4)
        tr = PipelineTrainer(model, stages=4, n_micro=4, data=2)
        c = Collect()
        tr.set_listeners(c)
        sup = TrainingSupervisor(tr, str(tmp_path),
                                 save_every_n_iterations=2,
                                 elastic_grow=False)
        res = sup.fit(make_it, epochs=2)
        assert res.status == "completed"
        assert res.restarts == 0
        assert [h["policy"] for h in res.history] == ["remap_and_continue"]
        assert res.history[0]["class"] == "device_failure"
        assert tr.stages_count == 3
        prof = OpProfiler.get()
        assert prof.counter_value("supervisor/remaps") >= 1
        assert prof.counter_value("pipeline/remaps") >= 1
        spans = flightrec.events(prefix="pipeline/remap")
        assert any(e["ph"] == "B" and e["attrs"].get("stages_to") == 3
                   for e in spans)
        assert len(c.losses) == 2 * 4          # no step lost or doubled

        # the reference: the same kill by hand, then a fresh 3-stage run
        # handed the state and cursor at the boundary
        faultinject.clear_plan()
        os.environ.pop(faultinject.ENV_PLAN)
        ref = dense_stack(4)
        rtr = PipelineTrainer(ref, stages=4, n_micro=4, data=2)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/stage", "kind": "device_loss",
              "index": 2, "stage": 1}]))
        with pytest.raises(faultinject.DeviceLostError):
            rtr.fit(make_it(), epochs=2, batch_size=32)
        faultinject.clear_plan()
        cursor = (int(ref._epoch - ref._fit_epoch0),
                  int(ref._steps_in_epoch))
        fresh = dense_stack(4)
        fresh._params = {k: {n: a.detach().clone() for n, a in v.items()}
                         for k, v in ref._params.items()}
        fresh._updater_state = None
        fresh._iteration, fresh._epoch = ref._iteration, ref._epoch
        tr3 = PipelineTrainer(fresh, stages=3, n_micro=4, data=2)
        c3 = Collect()
        tr3.set_listeners(c3)
        tr3.fit(make_it(), epochs=2, batch_size=32, resume_cursor=cursor)
        assert c.losses[2:] == c3.losses
        assert params_equal(model, fresh)

    def test_remap_refused_falls_back_to_restart(self, tmp_path):
        """One surviving stage is below the remap gate: checkpoint-restart
        owns the recovery."""
        from deeplearning4j_tpu_torch.parallel import TrainingSupervisor

        x, y = synth(4 * 32)

        def make_it():
            return NDArrayDataSetIterator(x, y, batch_size=32)

        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/stage", "kind": "device_loss",
              "index": 2, "stage": 1}]))
        model = dense_stack(4)
        tr = PipelineTrainer(model, stages=2, n_micro=4, data=1)
        c = Collect()
        tr.set_listeners(c)
        res = TrainingSupervisor(tr, str(tmp_path),
                                 save_every_n_iterations=2,
                                 elastic_grow=False).fit(make_it, epochs=1)
        assert res.status == "completed"
        assert res.restarts == 1
        assert [h["policy"] for h in res.history] == ["restart"]
        assert tr.stages_count == 2   # never remapped
        # the healed run's losses are bitwise an uninterrupted run's
        ref = dense_stack(4)
        rtr = PipelineTrainer(ref, stages=2, n_micro=4, data=1)
        rc = Collect()
        rtr.set_listeners(rc)
        rtr.fit(make_it(), epochs=1, batch_size=32)
        assert c.losses[-4:] == rc.losses
        assert params_equal(model, ref)

    def test_slow_and_wedge_stage_kinds(self):
        x, y = synth(2 * 32)
        tr = PipelineTrainer(dense_stack(4), stages=4, n_micro=4, data=2)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/stage", "kind": "slow", "index": 0,
              "seconds": 0.01}]))
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert OpProfiler.get().counter_value(
            "faults/pipeline/stage/slow") >= 1
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "pipeline/stage", "kind": "wedge", "index": 0,
              "seconds": 0.05}]))
        with pytest.raises(faultinject.WedgeReleased):
            tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
                   batch_size=32)

    def test_probe_and_resize(self):
        tr = PipelineTrainer(dense_stack(4), stages=4, n_micro=4, data=1)
        assert tr.probe_stages() == []
        removed = tr.resize(2, lost_replicas=[3])
        assert tr.stages_count == 2 and len(removed) >= 1
        assert tr._runs == stage_partition(4, 2)


class TestCheckpoint:
    def test_kill_resume_bit_exact(self, tmp_path):
        from deeplearning4j_tpu_torch.optimize.listeners import (
            CheckpointListener)
        from deeplearning4j_tpu_torch.util import checkpoint as _ckpt

        batch, steps = 32, 6
        x, y = synth(steps * batch)

        def make_it():
            return NDArrayDataSetIterator(x, y, batch_size=batch)

        model_a = dense_stack(4)
        tr_a = PipelineTrainer(model_a, stages=4, n_micro=4, data=2)
        c_a = Collect()
        tr_a.set_listeners(c_a)
        tr_a.fit(make_it(), epochs=1, batch_size=batch)

        d = str(tmp_path)
        model_b = dense_stack(4)
        tr_b = PipelineTrainer(model_b, stages=4, n_micro=4, data=2)
        c_b = Collect()
        ckpt = CheckpointListener(d, save_every_n_iterations=2)
        tr_b.set_listeners(c_b, ckpt)
        faultinject.set_plan(faultinject.FaultPlan(
            [{"site": "train/step", "kind": "crash", "index": 4}]))
        with pytest.raises(faultinject.SimulatedCrash):
            tr_b.fit(make_it(), epochs=1, batch_size=batch)
        faultinject.clear_plan()
        ckpt.close()
        resume = _ckpt.last_checkpoint(d)
        assert resume is not None

        model_c = dense_stack(4)
        tr_c = PipelineTrainer(model_c, stages=4, n_micro=4, data=2)
        c_c = Collect()
        tr_c.set_listeners(c_c)
        tr_c.fit(make_it(), epochs=1, batch_size=batch, resume_from=resume)
        resumed_from = steps - len(c_c.losses)
        assert 0 < resumed_from <= 4
        assert c_b.losses[:resumed_from] == c_a.losses[:resumed_from]
        assert c_c.losses == c_a.losses[resumed_from:]
        assert params_equal(model_c, model_a)

    def test_cursor_records_stages(self):
        from deeplearning4j_tpu_torch.util.checkpoint import (
            snapshot_training_state)

        x, y = synth(32)
        model = dense_stack(4)
        tr = PipelineTrainer(model, stages=4, n_micro=4, data=2)
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        assert snapshot_training_state(model)["cursor"]["stages"] == 4
        tr.remap(3)
        assert snapshot_training_state(model)["cursor"]["stages"] == 3
        plain = dense_stack(2)
        assert "stages" not in snapshot_training_state(plain)["cursor"]

    def _commit(self, directory, snapshot, tag):
        from deeplearning4j_tpu_torch.util.checkpoint import (
            commit_checkpoint, serialize_snapshot)

        return commit_checkpoint(directory, tag,
                                 serialize_snapshot(snapshot),
                                 snapshot["iteration"], keep_last=3)

    def test_legacy_homogeneous_checkpoint_roundtrip(self, tmp_path):
        S = 4
        model = dense_stack(S)
        pp = pipeline_from_mln(model, pmesh(S), n_micro=4)
        assert pp.model is model
        x, y = synth(16, seed=3)
        pp.train_step(x, y, lr=0.1)
        path = self._commit(str(tmp_path), pp.snapshot(), "t1")
        l_after = [float(pp.train_step(x, y, lr=0.1)) for _ in range(2)]
        p_after = pp.params["W"].numpy().copy()
        model2 = dense_stack(S, seed=7)
        pp2 = pipeline_from_mln(model2, pmesh(S), n_micro=4)
        pp2.restore(path)
        l_replay = [float(pp2.train_step(x, y, lr=0.1)) for _ in range(2)]
        assert l_replay == l_after
        assert np.array_equal(pp2.params["W"].numpy(), p_after)

    def test_legacy_heterogeneous_checkpoint_roundtrip(self, tmp_path):
        m = modules("torch")
        b = (m.NeuralNetConfiguration.builder().seed(5)
             .updater(m.Sgd(learning_rate=0.05)).list()
             .layer(m.L.DenseLayer(n_out=12, activation="tanh"))
             .layer(m.L.DenseLayer(n_out=6, activation="tanh"))
             .layer(m.L.DenseLayer(n_out=4, activation="identity")))
        conf = b.set_input_type(m.InputType.feed_forward(FEAT)).build()
        model = m.MultiLayerNetwork(conf).init(device="cpu")
        pp = pipeline_from_mln(model, pmesh(2), n_micro=4, cuts=[2],
                               example_input=(8, FEAT))
        rng = np.random.default_rng(4)
        x = rng.standard_normal((8, FEAT)).astype(np.float32)
        y = rng.standard_normal((8, 4)).astype(np.float32)
        pp.train_step(x, y, lr=0.1)
        path = self._commit(str(tmp_path), pp.snapshot(), "t1")
        l_after = [float(pp.train_step(x, y, lr=0.1)) for _ in range(2)]
        model2 = m.MultiLayerNetwork(conf).init(seed=99, device="cpu")
        pp2 = pipeline_from_mln(model2, pmesh(2), n_micro=4, cuts=[2],
                                example_input=(8, FEAT))
        pp2.restore(path)
        l_replay = [float(pp2.train_step(x, y, lr=0.1)) for _ in range(2)]
        assert l_replay == l_after
        sp = pp2.stage_params(0)
        leaf = sp["0"]["W"]
        assert isinstance(leaf, np.ndarray)
        before = pp2.params[0]["0"]["W"].clone()
        leaf[...] = 1e9
        assert torch.equal(pp2.params[0]["0"]["W"], before)


class TestObservability:
    def test_ledger_and_stage_lanes(self, tmp_path):
        prof = OpProfiler.get()
        flightrec.reset()
        x, y = synth(2 * 32)
        S, M = 4, 4
        tr = PipelineTrainer(dense_stack(4), stages=S, n_micro=M, data=2)
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=32), epochs=1,
               batch_size=32)
        ledger = prof.pipeline_stats()
        assert ledger["stages"] == S
        assert ledger["microbatches"] >= 2 * M
        assert 0.0 < ledger["bubble_fraction"] < 1.0
        assert ("pipeline", "pipeline_stats") in OpProfiler.LEDGERS
        fwd = flightrec.events(prefix="pipeline/stage_fwd")
        bwd = flightrec.events(prefix="pipeline/stage_bwd")
        assert len(fwd) == len(bwd) == 2 * S
        assert {e["attrs"]["stage"] for e in fwd} == set(range(S))
        out = os.path.join(str(tmp_path), "trace.json")
        flightrec.export_chrome_trace(out)
        with open(out) as f:
            doc = json.load(f)
        names = {e["args"]["name"] for e in doc["traceEvents"]
                 if e["ph"] == "M"}
        assert {f"pipeline/stage{s}/{d}" for s in range(S)
                for d in ("fwd", "bwd")} <= names
        xs = [e for e in doc["traceEvents"]
              if e["ph"] == "X" and e["name"] == "pipeline/stage_fwd"]
        assert xs and all(e["dur"] > 0 for e in xs)

    def test_bubble_fraction_tracks_analytic_bound(self):
        prof = OpProfiler.get()
        x, y = synth(2 * 48)
        S, M = 4, 8
        tr = PipelineTrainer(dense_stack(4), stages=S, n_micro=M, data=1)
        busy0 = prof.counter_value("pipeline/busy_ticks")
        slots0 = prof.counter_value("pipeline/tick_slots")
        tr.fit(NDArrayDataSetIterator(x, y, batch_size=48), epochs=1,
               batch_size=48)
        busy = prof.counter_value("pipeline/busy_ticks") - busy0
        slots = prof.counter_value("pipeline/tick_slots") - slots0
        assert 1.0 - busy / slots == pytest.approx((S - 1) / (M + S - 1))
