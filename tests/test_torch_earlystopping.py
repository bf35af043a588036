"""Early stopping in the port against the JAX package, on the CPU
(``optimize/earlystopping.py``).

Both packages' trainers run from the same parameters over the same data
(made from a seed), with recording score calculators. Tolerances: every
epoch score within rtol 1e-5, the same number of epochs, best epoch and
termination reason; the best model read back from the saver bitwise the
model as it was saved.
"""

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.data as JD
import deeplearning4j_tpu.optimize.earlystopping as JE
import deeplearning4j_tpu_torch.data as TD
import deeplearning4j_tpu_torch.optimize.earlystopping as TE
from torch_parity import mln_twins, modules, numpy_tree

RTOL = 1e-5


def conf(which, lr=0.05):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(6)
            .updater(m.Nesterovs(learning_rate=lr, momentum=0.9)).list()
            .layer(m.L.DenseLayer(n_out=8, activation="tanh"))
            .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(4)).build())


def data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] + x[:, 1] > 0).astype(int)
                                    + (x[:, 2] > 1).astype(int)]
    return x, y


def recording(E):
    class Rec(E.DataSetLossCalculator):
        scores = None

        def calculate_score(self, model):
            s = super().calculate_score(model)
            self.scores = (self.scores or []) + [s]
            return s

    return Rec


CONDITIONS = {
    "max_epochs": lambda E: dict(epochs=[E.MaxEpochsTerminationCondition(3)]),
    "no_improvement": lambda E: dict(epochs=[
        E.MaxEpochsTerminationCondition(9),
        E.ScoreImprovementEpochTerminationCondition(1, min_improvement=0.5)]),
    "max_score": lambda E: dict(
        epochs=[E.MaxEpochsTerminationCondition(4)],
        iters=[E.MaxScoreIterationTerminationCondition(0.0)]),
    "every_2": lambda E: dict(epochs=[E.MaxEpochsTerminationCondition(4)],
                              every=2, save_last=True),
}


def run(E, D, net, case, saver, x, y, xt, yt):
    c = CONDITIONS[case](E)
    calc = recording(E)(D.NDArrayDataSetIterator(xt, yt, 16))
    b = (E.EarlyStoppingConfiguration.builder()
         .epoch_termination_conditions(*c["epochs"])
         .score_calculator(calc).model_saver(saver)
         .evaluate_every_n_epochs(c.get("every", 1))
         .save_last_model(c.get("save_last", False)))
    if "iters" in c:
        b = b.iteration_termination_conditions(*c["iters"])
    res = E.EarlyStoppingTrainer(b.build(), net,
                                 D.NDArrayDataSetIterator(x, y, 10)).fit()
    return res, calc.scores or []


@pytest.mark.parametrize("case", sorted(CONDITIONS))
def test_trainer_matches_jax(case):
    jn, tn = mln_twins(conf("jax"), conf("torch"))
    x, y = data(40, 0)
    xt, yt = data(32, 1)
    rj, sj = run(JE, JD, jn, case, JE.InMemoryModelSaver(), x, y, xt, yt)
    rt, st = run(TE, TD, tn, case, TE.InMemoryModelSaver(), x, y, xt, yt)
    assert (rt.termination_reason, rt.termination_details,
            rt.total_epochs, rt.best_model_epoch) == \
        (rj.termination_reason, rj.termination_details, rj.total_epochs,
         rj.best_model_epoch)
    np.testing.assert_allclose(st, sj, rtol=RTOL)
    np.testing.assert_allclose(rt.best_model_score, rj.best_model_score,
                               rtol=RTOL)
    best_t, best_j = rt.get_best_model(), rj.get_best_model()
    np.testing.assert_allclose(
        best_t.params().numpy(),
        np.asarray(best_j.params().value if hasattr(best_j.params(),
                                                    "value")
                   else best_j.params()), rtol=1e-4, atol=1e-6)


class SnapshotSaver:
    """Mixes into a saver: keeps a copy of the parameters it saved last."""

    def save_best_model(self, model, score):
        super().save_best_model(model, score)
        self.best = model.params().detach().clone()


def _graph(fused):
    m = modules("torch")
    b = m.NeuralNetConfiguration.builder().seed(3).updater(m.Adam(0.02))
    if fused:
        b = b.fused_update()
    gb = m.graph.ComputationGraphConfiguration.graph_builder(b) \
        .add_inputs("in")
    gb.add_layer("d", m.L.DenseLayer(n_out=8, activation="tanh"), "in")
    gb.add_layer("bn", m.L.BatchNormalization(), "d")
    gb.add_layer("out", m.L.OutputLayer(n_out=3, loss="mcxent",
                                        activation="softmax"), "bn")
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    return ComputationGraph(gb.set_outputs("out").set_input_types(
        m.InputType.feed_forward(4)).build()).init(device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_local_file_saver_reloads_bitwise(tmp_path, kind, fused):
    """LocalFileModelSaver through the model zip, on both networks: the
    best and the latest model read back bitwise (parameters, states,
    updater state)."""
    if kind == "mln":
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        c = conf("torch")
        c.global_conf.fused_update = fused
        net = MultiLayerNetwork(c).init(device="cpu")
    else:
        net = _graph(fused)
    saver = type("S", (SnapshotSaver, TE.LocalFileModelSaver), {})(
        tmp_path / "es")
    x, y = data(30, 2)
    cfg = (TE.EarlyStoppingConfiguration.builder()
           .epoch_termination_conditions(TE.MaxEpochsTerminationCondition(2))
           .score_calculator(TE.DataSetLossCalculator(
               TD.NDArrayDataSetIterator(x, y, 10)))
           .model_saver(saver).save_last_model(True).build())
    res = TE.EarlyStoppingTrainer(cfg, net,
                                  TD.NDArrayDataSetIterator(x, y, 10)).fit()
    best = res.get_best_model()
    assert type(best) is type(net) and best.device == net.device
    assert torch.equal(best.params(), saver.best)
    latest = saver.get_latest_model()
    assert torch.equal(latest.params(), net.params())
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths

    for a, b in ((latest._states, net._states),
                 (latest._updater_state, net._updater_state)):
        for p in leaf_paths(b or {}):
            assert torch.equal(get_path(a, p), get_path(b, p))


def test_configuration_needs_a_condition():
    for E in (JE, TE):
        with pytest.raises(ValueError, match="termination condition"):
            E.EarlyStoppingConfiguration.builder().build()


@pytest.mark.parametrize("cond", ["max_epochs", "improvement", "max_score"])
def test_conditions_match_jax(cond):
    seq = [3.0, 2.5, 2.6, 2.4, 2.45, 2.44, float("nan"), 9.0]
    out = []
    for E in (JE, TE):
        c = {"max_epochs": lambda: E.MaxEpochsTerminationCondition(4),
             "improvement": lambda: E.ScoreImprovementEpochTerminationCondition(
                 2, min_improvement=0.02),
             "max_score": lambda: E.MaxScoreIterationTerminationCondition(
                 5.0)}[cond]()
        if cond == "max_score":
            out.append(([c.terminate(s) for s in seq], str(c)))
        else:
            out.append(([c.terminate(i + 1, s) for i, s in enumerate(seq)],
                        str(c)))
    assert out[0] == out[1]
