"""Truncated BPTT and streaming inference of the port against the JAX
package, on the CPU.

- ``fit`` with ``backprop_type("TruncatedBPTT").tbptt_length(4)`` over three
  batches of T 12 (three segments each), Sgd and Adam, per-leaf and fused:
  the parameters within 1e-5 of the JAX network's scale. Adam shows that
  every segment of a batch steps at the batch's iteration; a segment whose
  gradient reached into the segments before it (a carry not detached)
  would miss the JAX parameters.
- 2-D labels with ``LastTimeStep`` (the labels serve every segment), and
  an iterator of masked batches (the serial path, masks cut per segment).
- The listeners hear one step per batch, with its last segment's loss.
- ``rnn_time_step`` in chunks equals ``output`` on the whole sequence
  (rtol 1e-5, atol 1e-6, tests/test_l6_features.py's contract) and the JAX
  network's own stream; ``rnn_clear_previous_state`` restarts it.
- The JSON round trip of the recurrent configurations, both ways, and
  ``TextGenerationLSTM``'s configuration and parameter count against the
  JAX zoo's.
- A TBPTT fit of a Bidirectional network killed and resumed from its
  checkpoint ends bitwise where the uninterrupted fit ended.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import (
    ExistingDataSetIterator as JExisting)
from deeplearning4j_tpu.optimize.listeners import (
    CollectScoresIterationListener as JCollect)
from deeplearning4j_tpu_torch.data import DataSet
from deeplearning4j_tpu_torch.data.iterators import ExistingDataSetIterator
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork as TNet
from deeplearning4j_tpu_torch.optimize import CollectScoresIterationListener
from torch_parity import assert_scaled_close, mln_twins, modules

B, T, NIN, K = 3, 12, 4, 4


def _conf(which, updater="sgd", fused=False, k=K, head="rnn",
          tbptt=True):
    m = modules(which)
    upd = m.Sgd(0.1) if updater == "sgd" else m.Adam(0.01)
    b = m.NeuralNetConfiguration.builder().seed(11).updater(upd)
    if fused:
        b = b.fused_update()
    lb = b.list().layer(m.L.LSTM(n_out=6))
    if head == "rnn":
        lb = (lb.layer(m.L.GRU(n_out=5))
              .layer(m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                        activation="softmax")))
    else:
        lb = (lb.layer(m.L.LastTimeStep(layer=m.L.GRU(n_out=5,
                                                      reset_after=True)))
              .layer(m.L.OutputLayer(n_out=3, loss="mcxent",
                                     activation="softmax")))
    if tbptt:
        lb = lb.backprop_type("TruncatedBPTT").tbptt_length(k)
    return lb.set_input_type(m.InputType.recurrent(NIN)).build()


def _batch(seed, labels_2d=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, NIN)).astype(np.float32)
    shape = (B,) if labels_2d else (B, T)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape)]


@pytest.mark.parametrize("fused", [False, True], ids=["per_leaf", "fused"])
@pytest.mark.parametrize("updater", ["sgd", "adam"])
def test_three_tbptt_batches_match_jax(updater, fused):
    jn, tn = mln_twins(_conf("jax", updater, fused),
                       _conf("torch", updater, fused))
    iterations = []
    step = tn._step

    def spy(store, batch, iteration, rnn=None):
        iterations.append(iteration)
        assert rnn is not None and all(
            not c.requires_grad for v in rnn.values()
            for c in (v if isinstance(v, tuple) else (v,)))
        return step(store, batch, iteration, rnn)

    tn._step = spy
    for seed in range(3):
        x, y = _batch(seed)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
        assert_scaled_close(np.float32(tn.score_value), np.float32(jn.score_value),
               f"loss of batch {seed}")
    # three segments a batch, each at the batch's iteration
    assert iterations == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert tn._iteration == jn._iteration == 3
    assert_scaled_close(tn.params(), np.asarray(jn.params().value), "parameters")


def test_tbptt_differs_from_full_backprop():
    """The segments do truncate: the same batch without TBPTT steps
    elsewhere (and so does the JAX network)."""
    x, y = _batch(0)
    nets = [TNet(_conf("torch", tbptt=t)).init(device="cpu")
            for t in (True, False)]
    nets[1].set_params(nets[0].params())
    for net in nets:
        net.fit(DataSet(x, y))
    assert not torch.allclose(nets[0].params(), nets[1].params())


def test_tbptt_with_2d_labels_and_last_time_step_matches_jax():
    jn, tn = mln_twins(_conf("jax", "adam", head="last"),
                       _conf("torch", "adam", head="last"))
    for seed in range(2):
        x, y = _batch(seed, labels_2d=True)
        jn.fit(JDataSet(x, y))
        tn.fit(DataSet(x, y))
    assert_scaled_close(tn.params(), np.asarray(jn.params().value), "parameters")


def test_tbptt_through_an_iterator_with_masks_matches_jax():
    """An iterator takes the serial path; the feature and label masks are
    cut per segment; the listeners hear one step per batch, with its last
    segment's loss."""
    rng = np.random.default_rng(5)
    batches = []
    for lengths in ((12, 9, 3), (6, 12, 1)):
        x, y = _batch(int(rng.integers(100)))
        m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(
            np.float32)
        batches.append((x, y, m))
    jn, tn = mln_twins(_conf("jax", "adam"), _conf("torch", "adam"))
    jl, tl = JCollect(), CollectScoresIterationListener()
    jn.set_listeners(jl)
    tn.set_listeners(tl)
    jn.fit(JExisting([JDataSet(x, y, features_mask=m, labels_mask=m)
                      for x, y, m in batches]), epochs=2)
    tn.fit(ExistingDataSetIterator([DataSet(x, y, features_mask=m,
                                            labels_mask=m)
                                    for x, y, m in batches]), epochs=2)
    assert [i for i, _ in tl.scores] == [i for i, _ in jl.scores] == \
        [1, 2, 3, 4]
    np.testing.assert_allclose([s for _, s in tl.scores],
                               [s for _, s in jl.scores], rtol=1e-5)
    assert_scaled_close(tn.params(), np.asarray(jn.params().value), "parameters")


def test_rnn_time_step_in_chunks_matches_output_and_jax():
    jn, tn = mln_twins(_conf("jax", tbptt=False), _conf("torch",
                                                        tbptt=False))
    x, _ = _batch(3)
    full = tn.output(x).numpy()
    assert_scaled_close(full, np.asarray(jn.output(x).value), "output")
    tn.rnn_clear_previous_state()
    parts = [tn.rnn_time_step(x[:, s:s + 5]).numpy() for s in range(0, T, 5)]
    np.testing.assert_allclose(np.concatenate(parts, axis=1), full,
                               rtol=1e-5, atol=1e-6)
    jparts = [np.asarray(jn.rnnTimeStep(x[:, s:s + 5]).value)
              for s in range(0, T, 5)]
    for i, (p, jp) in enumerate(zip(parts, jparts)):
        assert_scaled_close(p, jp, f"chunk {i}")
    # one step as [B, F]; the camelCase aliases; clearing restarts
    step = tn.rnnTimeStep(x[:, 0])
    assert tuple(step.shape) == (B, 1, 3)
    tn.rnnClearPreviousState()
    again = tn.rnn_time_step(x[:, :5]).numpy()
    np.testing.assert_allclose(again, parts[0], rtol=1e-6)
    assert tn.rnn_time_step(x[:, 5]).numpy()[:, 0] == pytest.approx(
        tn.output(x[:, :6]).numpy()[:, 5], rel=1e-5, abs=1e-6)


def _json_conf(which):
    m = modules(which)
    return (m.NeuralNetConfiguration.builder().seed(2).updater(m.Adam(0.01))
            .list()
            .layer(m.L.MaskingLayer(mask_value=-1.0))
            .layer(m.L.Bidirectional(layer=m.L.LSTM(n_out=4), mode="add"))
            .layer(m.L.GravesLSTM(n_out=4, activation="relu"))
            .layer(m.L.GRU(n_out=4, reset_after=True))
            .layer(m.L.SimpleRnn(n_out=4))
            .layer(m.L.Convolution1DLayer(n_out=4, kernel_size=3,
                                          convolution_mode="same"))
            .layer(m.L.LastTimeStep(layer=m.L.GRU(n_out=3)))
            .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax"))
            .backprop_type("TruncatedBPTT").tbptt_length(5)
            .set_input_type(m.InputType.recurrent(NIN, 10)).build())


def test_json_round_trip_both_ways():
    from deeplearning4j_tpu.nn.conf.builder import (
        MultiLayerConfiguration as JConf)
    from deeplearning4j_tpu_torch.nn.conf.builder import (
        MultiLayerConfiguration as TConf)

    tconf, jconf = _json_conf("torch"), _json_conf("jax")
    tj, jj = tconf.to_json(), jconf.to_json()
    assert json.loads(tj) == json.loads(jj)
    back = TConf.from_json(jj)
    assert json.loads(back.to_json()) == json.loads(jj)
    assert back.backprop_type == "TruncatedBPTT"
    assert back.tbptt_fwd_length == back.tbptt_back_length == 5
    assert type(back.layers[1].layer).__name__ == "LSTM"
    assert back.layer_output_types == tconf.layer_output_types
    assert json.loads(JConf.from_json(tj).to_json()) == json.loads(tj)
    net = TNet(back).init(device="cpu")
    assert "fwd" in net._params["0001"] and "bwd" in net._params["0001"]


def test_text_generation_lstm_matches_the_jax_zoo():
    from deeplearning4j_tpu.models.zoo import TextGenerationLSTM as JText
    from deeplearning4j_tpu_torch.models import TextGenerationLSTM

    vocab = 77
    jnet = JText(vocab).init()
    tconf = TextGenerationLSTM(vocab).conf()
    assert json.loads(tconf.to_json()) == json.loads(jnet.conf.to_json())
    tnet = TNet(tconf).init(device="cpu")
    h = 256
    want = (4 * h * (vocab + h + 1) + 4 * h * (2 * h + 1) + h * vocab
            + vocab)
    assert tnet.num_params() == jnet.num_params() == want
    assert tnet.conf.global_conf.updater.learning_rate == 2e-3


def test_tbptt_bidirectional_resume_is_bitwise(tmp_path):
    """A killed TBPTT fit of a Bidirectional network (three-level trees in
    the checkpoint, fused buckets) resumed from its middle checkpoint ends
    bitwise where the uninterrupted run ended."""
    from deeplearning4j_tpu_torch.common.tree import get_path, leaf_paths
    from deeplearning4j_tpu_torch.data import NDArrayDataSetIterator
    from deeplearning4j_tpu_torch.optimize import CheckpointListener

    m = modules("torch")
    conf = (m.NeuralNetConfiguration.builder().seed(4).updater(m.Adam(0.01))
            .fused_update().list()
            .layer(m.L.Bidirectional(layer=m.L.LSTM(n_out=4)))
            .layer(m.L.RnnOutputLayer(n_out=3, loss="mcxent",
                                      activation="softmax"))
            .backprop_type("TruncatedBPTT").tbptt_length(K)
            .set_input_type(m.InputType.recurrent(NIN)).build())
    rng = np.random.default_rng(6)
    x = rng.normal(size=(10, T, NIN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (10, T))]
    nets = []
    for resume in (False, True):
        net = TNet(conf).init(device="cpu")
        if not resume:
            net.set_listeners(CheckpointListener(
                str(tmp_path), save_every_n_iterations=2, async_write=False))
        net.fit(NDArrayDataSetIterator(x, y, batch_size=4), epochs=2,
                resume_from=str(tmp_path / "checkpoint_iter_4.zip")
                if resume else None)
        nets.append(net)
    a, b = nets
    assert a._iteration == b._iteration == 6
    assert torch.equal(a.params(), b.params())
    for slot in ("m", "v"):
        for p in leaf_paths(a._updater_state[slot]):
            assert torch.equal(get_path(a._updater_state[slot], p),
                               get_path(b._updater_state[slot], p)), p
