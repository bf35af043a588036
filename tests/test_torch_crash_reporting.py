"""The port's CrashReportingUtil and SystemInfo
(``deeplearning4j_tpu_torch/util/crash_reporting.py``,
``common/system_info.py``) against the JAX package's: the same per-layer
parameter counts and bytes in both reports of the same network, and the
same per-layer activation shapes at a given minibatch (the port reads them
off the configuration's output-type chain; the JAX package traces the
forward's shapes)."""

import json
import re

import pytest

from deeplearning4j_tpu.util import crash_reporting as jcr
from deeplearning4j_tpu_torch.common.system_info import SystemInfo
from deeplearning4j_tpu_torch.util import (CrashReportingUtil,
                                           generate_memory_status_report,
                                           write_memory_crash_dump)
from torch_parity import mln_twins, modules

_LAYER = re.compile(r"^layer (.+): ([0-9,]+) params, ([0-9.]+) MiB$")
_ACT = re.compile(r"^  activation\[(\d+) (\w+)\]: \(([0-9, ]+)\) = "
                  r"([0-9.]+) MiB$")


def _cnn(m):
    return (m.NeuralNetConfiguration.builder().seed(1)
            .updater(m.Sgd(learning_rate=0.1)).list()
            .layer(m.L.ConvolutionLayer(n_out=4, kernel_size=(3, 3)))
            .layer(m.L.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(m.L.DenseLayer(n_out=16))
            .layer(m.L.OutputLayer(n_out=3, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.convolutional(12, 12, 2)).build())


def _mlp(m):
    return (m.NeuralNetConfiguration.builder().seed(2)
            .updater(m.Sgd(learning_rate=0.1)).list()
            .layer(m.L.DenseLayer(n_out=32))
            .layer(m.L.DenseLayer(n_out=24))
            .layer(m.L.OutputLayer(n_out=5, activation="softmax",
                                   loss="mcxent"))
            .set_input_type(m.InputType.feed_forward(20)).build())


def _rnn(m):
    return (m.NeuralNetConfiguration.builder().seed(3)
            .updater(m.Sgd(learning_rate=0.1)).list()
            .layer(m.L.LSTM(n_out=6))
            .layer(m.L.RnnOutputLayer(n_out=4, activation="softmax",
                                      loss="mcxent"))
            .set_input_type(m.InputType.recurrent(5, 7)).build())


def _rows(text, pattern):
    return [pattern.match(ln).groups() for ln in text.splitlines()
            if pattern.match(ln)]


@pytest.mark.parametrize("conf", [_cnn, _mlp, _rnn],
                         ids=["cnn", "mlp", "rnn"])
@pytest.mark.parametrize("minibatch", [1, 8])
def test_report_matches_jax(conf, minibatch):
    jn, tn = mln_twins(conf(modules("jax")), conf(modules("torch")))
    want = jcr.generate_memory_status_report(jn, minibatch=minibatch)
    got = generate_memory_status_report(tn, minibatch=minibatch)
    # per-layer parameter counts and bytes
    assert _rows(got, _LAYER) == _rows(want, _LAYER)
    assert _rows(got, _LAYER)
    # per-layer activation shapes and bytes at the minibatch
    assert _rows(got, _ACT) == _rows(want, _ACT)
    total = [ln for ln in got.splitlines()
             if ln.startswith(("total parameters", "activation estimate"))]
    assert total == [ln for ln in want.splitlines()
                     if ln.startswith(("total parameters",
                                       "activation estimate"))]
    assert "memory status report" in got


def test_write_memory_crash_dump(tmp_path):
    m = modules("torch")
    net = m.MultiLayerNetwork(_cnn(m)).init(device="cpu")
    path = CrashReportingUtil.write_memory_crash_dump(
        net, str(tmp_path / "dump.txt"), minibatch=8)
    text = open(path).read()
    assert "memory status report" in text and "SystemInfo" in text
    assert "ConvolutionLayer" in text and "activation[" in text
    assert "total parameters" in text
    # the reference spelling and the module function write the same report
    for fn, name in ((CrashReportingUtil.writeMemoryCrashDump, "b.txt"),
                     (write_memory_crash_dump, "c.txt")):
        assert fn(net, str(tmp_path / name), minibatch=8) == str(
            tmp_path / name)
        assert "total parameters" in open(tmp_path / name).read()


def test_graph_report_reads_the_vertex_types():
    """A ComputationGraph: parameters by vertex, activations by node from
    the configuration's node output types (the JAX report stops at the
    parameters for a graph)."""
    from torch_parity import residual_conf

    m = modules("torch")
    g = m.graph.ComputationGraph(residual_conf("torch", fused=False,
                                               channels=8)).init(
        device="cpu")
    text = generate_memory_status_report(g, minibatch=4)
    layers = _rows(text, _LAYER)
    assert {name for name, _, _ in layers} == set(g._params)
    assert sum(int(n.replace(",", "")) for _, n, _ in layers) == \
        g.num_params()
    acts = [ln for ln in text.splitlines() if ln.startswith("  activation[")]
    assert len(acts) == len(g.conf.node_output_types) - len(
        g.conf.network_inputs)
    assert "activation estimate (fwd, minibatch 4)" in text


def test_system_info_dump():
    info = SystemInfo.gather()
    assert info["cpu_count"] >= 1 and "devices" in info
    text = SystemInfo.dump()
    assert "SystemInfo" in text and "torch:" in text
    json.dumps(info)
