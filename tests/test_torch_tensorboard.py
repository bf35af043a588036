"""The port's TensorBoard event files and the metrics bus that feeds them
(``ui/tensorboard.py``, ``ui/stats.py``, ``optimize/listeners.
PerformanceListener(storage=)``) against the JAX package's: the same events
through both writers read back the same from both files (each package's
reader on each file, framing and CRCs checked), the real ``tensorboard``
reader accepts the port's records, and ``StatsListener`` on the same
network and data writes the same series as the JAX listener."""

import glob
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import tensorboard as jtb
from deeplearning4j_tpu_torch.common import flightrec, tracecheck
from deeplearning4j_tpu_torch.optimize.listeners import PerformanceListener
from deeplearning4j_tpu_torch.ui import (FileStatsStorage,
                                         InMemoryStatsStorage, StatsListener,
                                         TensorBoardEventWriter,
                                         TensorBoardStatsStorage,
                                         read_histogram_events,
                                         read_scalar_events)
from deeplearning4j_tpu_torch.ui import stats as tstats
from deeplearning4j_tpu_torch.ui import tensorboard as ttb
from torch_parity import modules

PKGS = {"jax": jtb, "torch": ttb}


def _script(w):
    """One fixed event script: scalars, a histogram with non-finite values,
    a scalar after it."""
    rng = np.random.RandomState(0)
    for step in range(5):
        w.add_scalar("loss", 1.0 / (step + 1), step)
    w.add_scalar("acc", 0.9, 4)
    w.add_histogram("params/w", rng.randn(1000), 7)
    w.add_histogram("h", [1.0, np.nan, np.inf, 2.0], 8)
    w.add_histogram("empty", [np.nan], 9)
    w.add_scalar("loss", 0.125, 10)


@pytest.fixture
def both_files(tmp_path):
    paths = {}
    for name, mod in PKGS.items():
        w = mod.TensorBoardEventWriter(str(tmp_path / name))
        _script(w)
        w.close()
        paths[name] = w.path
    return paths


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_same_events_from_both_writers(both_files, reader):
    mod = PKGS[reader]
    scal = {w: mod.read_scalar_events(p) for w, p in both_files.items()}
    hist = {w: mod.read_histogram_events(p) for w, p in both_files.items()}
    assert scal["torch"] == scal["jax"]
    assert hist["torch"] == hist["jax"]
    losses = [(s, v) for s, t, v in scal["torch"] if t == "loss"]
    assert len(losses) == 6
    np.testing.assert_allclose(losses[0][1], 1.0, rtol=1e-6)
    np.testing.assert_allclose(losses[4][1], 0.2, rtol=1e-6)
    step, tag, h = hist["torch"][0]
    assert (step, tag) == (7, "params/w")
    assert h["num"] == 1000 and sum(h["bucket"]) == 1000
    assert len(h["bucket"]) == len(h["bucket_limit"]) == 30
    # non-finite values dropped, an all-non-finite input one zero bucket
    assert hist["torch"][1][2]["num"] == 2
    assert np.isfinite(hist["torch"][1][2]["sum"])
    assert hist["torch"][2][2]["num"] == 1


def test_files_are_byte_identical_but_for_wall_time(both_files):
    """Record framing, CRCs and payload layout are the JAX writer's: the
    files differ only in the 8-byte wall-time doubles (and their CRCs)."""
    def records(path):
        return [p for p in ttb._iter_record_payloads(path)]

    a, b = records(both_files["jax"]), records(both_files["torch"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y) and x[9:] == y[9:]   # past field 1 (time)


def test_corrupt_crc_detected(tmp_path):
    w = TensorBoardEventWriter(str(tmp_path))
    w.add_scalar("x", 1.0, 0)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-3] ^= 0xFF                 # a payload-CRC byte
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_scalar_events(w.path)
    with pytest.raises(ValueError, match="CRC"):
        jtb.read_scalar_events(w.path)


@pytest.mark.parametrize("kind", ["scalar", "histogram"])
def test_tensorboard_itself_can_read_the_file(tmp_path, kind):
    tb = pytest.importorskip("tensorboard.backend.event_processing."
                             "event_file_loader")
    w = TensorBoardEventWriter(str(tmp_path))
    if kind == "scalar":
        w.add_scalar("conformance/loss", 0.5, 7)
    else:
        w.add_histogram("conformance/h", [1.0, 2.0, 3.0], 3)
    w.close()
    events = [e for e in tb.EventFileLoader(w.path).Load()
              if e.HasField("summary")]
    assert events
    val = events[0].summary.value[0]
    if kind == "scalar":
        assert val.tag == "conformance/loss" and events[0].step == 7
        got = (val.tensor.float_val[0] if val.HasField("tensor")
               else val.simple_value)
        np.testing.assert_allclose(got, 0.5, rtol=1e-6)
        return
    assert val.tag == "conformance/h"
    if val.HasField("histo"):
        assert val.histo.num == 3 and val.histo.max == 3.0
    else:
        assert val.metadata.plugin_data.plugin_name == "histograms"
        buckets = (np.array(val.tensor.float_val) if val.tensor.float_val
                   else np.frombuffer(val.tensor.tensor_content,
                                      "<f4")).reshape(-1, 3)
        assert buckets[:, 2].sum() == 3


def test_host_histogram_is_the_jax_convention():
    vals = [3.0, np.nan, -1.0, np.inf, 2.5, 0.0]
    for bins in (1, 5, 30):
        got, want = ttb.host_histogram(vals, bins), jtb.host_histogram(
            vals, bins)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tstats.host_histogram is ttb.host_histogram


# --- storages ---------------------------------------------------------------

def test_tensorboard_storage_same_records_as_jax(tmp_path):
    out = {}
    for name, mod in (("jax", jstats), ("torch", tstats)):
        st = mod.TensorBoardStatsStorage(str(tmp_path / name))
        st.put_scalar("train", "score", 3, 0.75)
        st.put_scalar("", "lr", 3, 0.1)
        st.put_histogram("train", "param/w", 3, np.arange(10.0))
        st.close()
        path = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))[0]
        out[name] = (read_scalar_events(path), read_histogram_events(path))
    assert out["torch"] == out["jax"]
    assert [t for _, t, _ in out["torch"][0]] == ["train/score", "lr"]


def test_inmemory_and_jsonl_histograms_as_jax(tmp_path):
    rows = {}
    for name, mod in (("jax", jstats), ("torch", tstats)):
        mem = mod.InMemoryStatsStorage()
        mem.put_histogram("s", "param/w", 1, np.arange(10.0))
        path = str(tmp_path / f"{name}.jsonl")
        fs = mod.FileStatsStorage(path)
        fs.put_scalar("s", "score", 1, 0.5)
        fs.put_histogram("s", "param/w", 1, np.arange(10.0))
        fs.close()
        strip = lambda r: {k: v for k, v in r.items() if k != "time"}  # noqa
        rows[name] = ([strip(r) for r in mem.histograms],
                      [strip(r) for r in mod.FileStatsStorage.read(path)])
    assert rows["torch"] == rows["jax"]
    assert [r.get("kind") for r in rows["torch"][1]] == [None, "histogram"]


# --- StatsListener on the same network and data -----------------------------

def _mlp(m):
    return (m.NeuralNetConfiguration.builder().seed(1)
            .updater(m.Sgd(learning_rate=0.3)).activation("tanh").list()
            .layer(m.L.DenseLayer(n_out=8))
            .layer(m.L.OutputLayer(n_out=2, loss="mcxent",
                                   activation="softmax"))
            .set_input_type(m.InputType.feed_forward(3)).build())


def _fit_twins(listeners, iters=12):
    """The JAX network and its port twin (same parameters), each fit
    ``iters`` times on the same batch with its package's listener."""
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu_torch.data import DataSet as TDataSet
    from torch_parity import mln_twins

    rng = np.random.RandomState(0)
    x = rng.randn(32, 3).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    jn, tn = mln_twins(_mlp(modules("jax")), _mlp(modules("torch")))
    nets = {"jax": (jn, JDataSet(x, y)), "torch": (tn, TDataSet(x, y))}
    for pkg, listener in listeners.items():
        net, ds = nets[pkg]
        net.set_listeners(listener)
        for _ in range(iters):
            net.fit(ds, epochs=1)
    return nets


def _fit(listener, iters=12):
    return _fit_twins({"torch": listener}, iters)["torch"][0]


@pytest.mark.parametrize("hist", [False, True], ids=["norms", "histograms"])
def test_stats_listener_series_match_jax(tmp_path, hist):
    stores = {"jax": jstats.InMemoryStatsStorage(),
              "torch": tstats.InMemoryStatsStorage()}
    _fit_twins({pkg: smod.StatsListener(stores[pkg], collect_every_n=3,
                                        collect_timing=False,
                                        collect_histograms=hist)
                for pkg, smod in (("jax", jstats), ("torch", tstats))})
    j, t = stores["jax"], stores["torch"]
    assert t.tags() == j.tags()
    assert any(x.startswith("param_mean_magnitude/0_") for x in t.tags())
    for tag in j.tags():
        js, ts = j.series(tag), t.series(tag)
        assert [s for s, _ in ts] == [s for s, _ in js]
        np.testing.assert_allclose([v for _, v in ts], [v for _, v in js],
                                   rtol=2e-5, atol=1e-6)
    assert t.histogram_tags() == j.histogram_tags()
    if hist:
        assert any(x.startswith("param/1_") for x in t.histogram_tags())
        for a, b in zip(t.histograms, j.histograms):
            assert a["tag"] == b["tag"] and a["step"] == b["step"]
            assert sum(a["bucket"]) == sum(b["bucket"])
            np.testing.assert_allclose(a["bucket_limit"], b["bucket_limit"],
                                       rtol=1e-5, atol=1e-6)


def test_tensorboard_storage_end_to_end(tmp_path):
    """Loss curve and step time from a training run, readable from the
    event file (the JAX package's done-criterion)."""
    storage = TensorBoardStatsStorage(str(tmp_path))
    _fit(StatsListener(storage, collect_every_n=3, session_id="train"),
         iters=15)
    storage.close()
    files = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    assert len(files) == 1 and storage.path == files[0]
    events = read_scalar_events(files[0])
    tags = {t for _, t, _ in events}
    assert {"train/score", "train/iteration_ms", "train/epoch"} <= tags
    scores = [v for _, t, v in events if t == "train/score"]
    assert scores[-1] < scores[0]


def test_file_storage_jsonl(tmp_path):
    path = str(tmp_path / "stats.jsonl")
    storage = FileStatsStorage(path)
    _fit(StatsListener(storage, collect_every_n=5,
                       collect_param_norms=False))
    storage.close()
    assert {r["tag"] for r in FileStatsStorage.read(path)} >= {"score",
                                                                "epoch"}


class _Spy:
    def __init__(self):
        self.converted = 0

    def __float__(self):
        self.converted += 1
        return 0.5


def test_listener_does_not_sync_off_boundary():
    listener = StatsListener(InMemoryStatsStorage(), collect_every_n=10,
                             collect_param_norms=False,
                             collect_timing=False)

    class FakeModel:
        _params = []

    spy = _Spy()
    for it in range(1, 10):
        listener.iteration_done(FakeModel(), it, spy)
    assert spy.converted == 0
    listener.iteration_done(FakeModel(), 10, spy)
    assert spy.converted == 1


def test_stats_listener_single_batched_readback(monkeypatch):
    """ONE device-to-host copy of the score and every layer's figures per
    collection (one counted host sync), whatever the parameter count."""
    copies = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    m = modules("torch")
    net = m.MultiLayerNetwork(_mlp(m)).init(device="cpu")
    listener = StatsListener(InMemoryStatsStorage(), collect_every_n=1,
                             collect_timing=False, collect_histograms=True)
    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    with tracecheck.steady_state("collect", max_host_syncs=1) as region:
        listener.iteration_done(net, 1, torch.tensor(0.5))
    assert len(copies) == 1 and region.host_syncs == 1
    assert copies[0] == (1 + net.num_params(),)


# --- PerformanceListener(storage=) --------------------------------------------

@pytest.mark.parametrize("batch", [16, None], ids=["batch", "no_batch"])
def test_performance_listener_publishes(batch):
    flightrec.reset()
    stores = {}
    from deeplearning4j_tpu.optimize.listeners import \
        PerformanceListener as JPerf

    for pkg, cls in (("jax", JPerf), ("torch", PerformanceListener)):
        storage = InMemoryStatsStorage()
        listener = cls(frequency=2, storage=storage, session_id="perf")

        class FakeModel:
            pass

        model = FakeModel()
        if batch:
            model._last_batch_size = batch
        for it in (1, 2, 4):
            listener.iteration_done(model, it, 0.5)
            time.sleep(0.02)
        stores[pkg] = storage
        assert listener.last_iteration_ms > 0
    t, j = stores["torch"], stores["jax"]
    assert t.tags() == j.tags()
    assert {r["session"] for r in t.records} == {"perf"}
    assert [s for s, _ in t.series("iteration_ms")] == [2, 4]
    if batch:
        assert "samples_per_sec" in t.tags()
        np.testing.assert_allclose(t.series("samples_per_sec")[-1][1],
                                   t.series("iterations_per_sec")[-1][1]
                                   * batch, rtol=1e-6)
        rate = flightrec.events("perf/rate")
        assert rate and rate[-1]["attrs"]["samples_per_sec"] > 0
    else:
        assert "samples_per_sec" not in t.tags()
