"""The port's Keras importer (``deeplearning4j_tpu_torch/imports/
keras_import.py``, over its own HDF5 reader) against the JAX package's,
case for case, and the Keras fixtures of ``import_fixtures.py``.

Every case of ``tests/test_keras_import.py`` runs here with its
``KerasModelImport`` pointed at both packages (``torch_keras_dual``): the
same Keras-written file goes through each importer, the port's outputs are
held to the JAX package's at ``atol=1e-4, rtol=1e-3`` and to Keras's at
the case's own tolerance, and a refusal raises the same class with the
same message in both. Then: Keras ResNet-50 as the fixture writes it (the
``model_config`` against ``keras.applications.ResNet50``'s, the port
against the JAX package at batch 1 and 64x64, the fusion plan of the
served forward), the character LSTM's ``.keras`` zip, and the recurrent
layers with ``return_sequences=False`` that the port imports in
``LastTimeStep`` and the JAX package refuses (and that the port refuses too
behind a step mask).
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")
from tensorflow import keras  # noqa: E402

import import_fixtures as F  # noqa: E402
import test_keras_import as J  # noqa: E402
import torch_keras_dual as D  # noqa: E402
from deeplearning4j_tpu.imports import keras_import as jki  # noqa: E402
from deeplearning4j_tpu_torch.imports import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.imports import keras_import as tki  # noqa: E402


@pytest.mark.parametrize("cname,mname,kwargs", D.cases(J))
def test_jax_case_through_both_importers(cname, mname, kwargs, tmp_path,
                                         monkeypatch):
    D.patch(monkeypatch, J)
    D.run_case(J, cname, mname, kwargs, tmp_path)


# --- Keras ResNet-50 --------------------------------------------------------------


def _first_input_named(cfg: dict, name: str = "input_layer") -> dict:
    """Keras numbers the input layer of each model a process builds
    (``input_layer``, ``input_layer_1``, ...): rename it as the first."""
    layers = cfg["config"]["layers"] if "config" in cfg else cfg["layers"]
    old = layers[0]["name"]
    return json.loads(json.dumps(cfg).replace(f'"{old}"', f'"{name}"'))


def test_resnet50_config_is_keras_applications():
    """The fixture's ``model_config`` against ``keras.applications.
    ResNet50(weights=None).get_config()``: names in order, classes, the
    fields the importer reads and the inbound nodes."""
    want = _first_input_named(
        keras.applications.ResNet50(weights=None).get_config())
    got = F.keras_resnet50_config()
    assert [l["name"] for l in got["config"]["layers"]] == \
        [l["name"] for l in want["layers"]]
    assert len(got["config"]["layers"]) == 177
    read = ("filters", "kernel_size", "strides", "padding", "activation",
            "use_bias", "epsilon", "momentum", "center", "scale", "units",
            "pool_size", "data_format", "batch_shape", "dilation_rate")
    wl = {l["name"]: l for l in want["layers"]}
    for l in got["config"]["layers"]:
        w = wl[l["name"]]
        assert l["class_name"] == w["class_name"]
        for k in read:
            assert l["config"].get(k) == w["config"].get(k), (l["name"], k)
        assert l["inbound_nodes"] == w["inbound_nodes"], l["name"]
    assert got["config"]["input_layers"] == list(want["input_layers"])
    assert got["config"]["output_layers"] == list(want["output_layers"])


def test_resnet50_fixture_matches_keras_h5_layout(tmp_path):
    """A Keras-written ResNet-50 ``.h5`` and the fixture hold the same
    groups, datasets (shapes, dtypes) and attributes; the same
    ``model_config``."""
    path = str(tmp_path / "r50.h5")
    keras.applications.ResNet50(weights=None).save(path)
    real = hdf5.File(path)
    ours = hdf5.File(F.keras_resnet50_h5())
    assert _first_input_named(json.loads(real.attrs["model_config"])) == \
        json.loads(ours.attrs["model_config"])
    n = 0

    def walk(a, b):
        nonlocal n
        assert [k for k in a if not k.startswith("input_layer")] == \
            [k for k in b if not k.startswith("input_layer")], a.name
        assert set(a.attrs) == set(b.attrs), a.name
        for k, v in a.attrs.items():
            if k == "layer_names":
                assert list(v[1:]) == list(b.attrs[k][1:])
            elif k != "model_config":
                np.testing.assert_array_equal(v, b.attrs[k])
        for k in (k for k in a if not k.startswith("input_layer")):
            if isinstance(a[k], hdf5.Dataset):
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype)
                n += 1
            else:
                walk(a[k], b[k])

    walk(real, ours)
    assert n == 320


def _fuse(net) -> None:
    """The fused epilogue on an imported graph: the global switch and each
    BatchNormalization's (which the configuration cascades at build)."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    net.conf.global_conf.fused_epilogue = True
    for node in net.conf.nodes.values():
        if node.kind == "layer" and isinstance(node.layer,
                                               L.BatchNormalization):
            node.layer.fused_epilogue = True


def _small_resnet(tmp_path, image=64):
    path = str(tmp_path / "r50_64.h5")
    with open(path, "wb") as fh:
        fh.write(F.keras_resnet50_h5(seed=3, image=image, classes=10))
    return path


def test_resnet50_fixture_port_against_jax(tmp_path):
    """The fixture at its published widths, 64x64 and 10 classes, batch 1:
    the port (plain and with the fused epilogue) against the JAX package,
    and both against Keras loading the same file."""
    path = _small_resnet(tmp_path)
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)
                                                 ).astype(np.float32)
    jnet = jki.KerasModelImport.import_keras_model_and_weights(path)
    tnet = tki.KerasModelImport.import_keras_model_and_weights(path,
                                                               device="cpu")
    want = jnet.output(x)[0].to_numpy()
    got = tnet.output(x)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
    _fuse(tnet)
    fused = tnet.output(x)[0].numpy()
    np.testing.assert_allclose(fused, want, atol=1e-4, rtol=1e-3)
    ref = keras.models.load_model(path, compile=False).predict(x, verbose=0)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)


def test_resnet50_fusion_plan_and_epsilon(tmp_path):
    """Every block tail of the imported graph is a ``BN → Add →
    Activation(relu)`` chain the fusion plan collapses (16), and every
    BatchNormalization carries Keras's epsilon 1.001e-5."""
    from deeplearning4j_tpu_torch.nn.conf import layers as L

    net = tki.KerasModelImport.import_keras_model_and_weights(
        _small_resnet(tmp_path), device="cpu")
    _fuse(net)
    plan = net._epilogue_fusion_plan()
    assert len(plan["act"]) == 16
    assert sorted(plan["act"]) == sorted(
        l for l in net.conf.nodes if l.endswith("_out"))
    bns = [n.layer for n in net.conf.nodes.values()
           if n.kind == "layer" and isinstance(n.layer, L.BatchNormalization)]
    assert len(bns) == 53
    assert {b.eps for b in bns} == {F.KERAS_BN_EPS}


def test_resnet50_fine_tune_step_matches_jax(tmp_path):
    """One Nesterovs step of the imported graph (the softmax Dense as an
    mcxent OutputLayer in both) from the same file: the scores agree and
    so do the outputs after the step."""
    from deeplearning4j_tpu.data import DataSet as JDataSet
    from deeplearning4j_tpu.learning import Nesterovs as JNesterovs
    from deeplearning4j_tpu_torch.data import DataSet as TDataSet
    from deeplearning4j_tpu_torch.learning.updaters import Nesterovs

    path = _small_resnet(tmp_path, image=32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 4)]
    jnet = jki.KerasModelImport.import_keras_model_and_weights(path)
    tnet = tki.KerasModelImport.import_keras_model_and_weights(path,
                                                               device="cpu")
    jnet.conf.global_conf.updater = JNesterovs(learning_rate=1e-3)
    tnet.conf.global_conf.updater = Nesterovs(learning_rate=1e-3)
    tnet.conf.global_conf.fused_update = True
    np.testing.assert_allclose(tnet.score(TDataSet(x, y)),
                               jnet.score(JDataSet(x, y)), rtol=1e-4)
    jnet.fit(JDataSet(x, y))
    tnet.fit(TDataSet(x, y))
    np.testing.assert_allclose(tnet.score_value, jnet.score_value, rtol=1e-4)
    np.testing.assert_allclose(tnet.output(x)[0].numpy(),
                               jnet.output(x)[0].to_numpy(), atol=1e-4,
                               rtol=1e-3)


# --- keras-io's character LSTM -----------------------------------------------------


def test_char_lstm_fixture_matches_keras(tmp_path):
    """The fixture's ``.keras`` zip: its config is what Keras writes for
    the model, Keras loads it, and the port's import (``LSTM(128)`` in
    ``LastTimeStep``, a softmax OutputLayer) gives Keras's predictions."""
    data = F.keras_char_lstm(vocab=31, seed=2)
    path = str(tmp_path / "char.keras")
    with open(path, "wb") as fh:
        fh.write(data)
    m = keras.models.load_model(path, compile=False)
    ref_model = keras.Sequential([
        keras.layers.Input((40, 31)), keras.layers.LSTM(128),
        keras.layers.Dense(31, activation="softmax")])
    ours = json.loads(zipfile.ZipFile(io.BytesIO(data)).read("config.json"))
    assert [l["class_name"] for l in ours["config"]["layers"]] == \
        ["InputLayer", "LSTM", "Dense"]
    assert [type(l).__name__ for l in m.layers] == \
        [type(l).__name__ for l in ref_model.layers]
    x = np.random.default_rng(0).random((3, 40, 31)).astype(np.float32)
    net = tki.KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    assert type(net.layers[0]).__name__ == "LastTimeStep"
    np.testing.assert_allclose(net.output(x).numpy(),
                               m.predict(x, verbose=0), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("cell", ["LSTM", "GRU", "SimpleRNN"])
def test_last_step_recurrent_against_jax_sequences(cell, tmp_path):
    """``return_sequences=False``: the port imports the layer in
    ``LastTimeStep``; the JAX package refuses it, and its import of the
    same weights with ``return_sequences=True`` gives the port's output at
    its last step."""
    layer = getattr(keras.layers, cell)
    m = keras.Sequential([keras.layers.Input((6, 4)), layer(5)])
    path = str(tmp_path / "last.h5")
    m.save(path)
    x = np.random.default_rng(4).standard_normal((2, 6, 4)
                                                 ).astype(np.float32)
    with pytest.raises(jki.UnsupportedKerasLayerError,
                       match="return_sequences"):
        jki.KerasModelImport.import_keras_sequential_model_and_weights(path)
    net = tki.KerasModelImport.import_keras_sequential_model_and_weights(
        path, device="cpu")
    got = net.output(x).numpy()
    np.testing.assert_allclose(got, m.predict(x, verbose=0), atol=1e-4,
                               rtol=1e-3)
    seq = keras.Sequential([keras.layers.Input((6, 4)),
                            layer(5, return_sequences=True)])
    seq.set_weights(m.get_weights())
    spath = str(tmp_path / "seq.h5")
    seq.save(spath)
    jnet = jki.KerasModelImport.import_keras_sequential_model_and_weights(
        spath)
    np.testing.assert_allclose(got, jnet.output(x).to_numpy()[:, -1],
                               atol=1e-4, rtol=1e-3)


def _masked_last_step(cell, source):
    layer = getattr(keras.layers, cell)
    if source == "masking":
        return keras.Sequential([keras.layers.Input((6, 4)),
                                 keras.layers.Masking(mask_value=0.0),
                                 layer(5), keras.layers.Dense(3)])
    return keras.Sequential([keras.layers.Input((6,)),
                             keras.layers.Embedding(10, 4, mask_zero=True),
                             layer(5), keras.layers.Dense(3)])


@pytest.mark.parametrize("source", ["masking", "mask_zero"])
@pytest.mark.parametrize("cell", ["LSTM", "GRU", "SimpleRNN"])
def test_last_step_recurrent_behind_a_mask_is_refused(cell, source,
                                                      tmp_path):
    """Behind a step mask Keras skips the masked steps and returns each
    row's last valid one, which ``LastTimeStep`` over the port's recurrent
    layers does not give: the port refuses the model, naming the layer
    that masks, as the JAX package refuses ``return_sequences=False``.
    (The functional importer refuses ``Masking``, and the ``NotEqual`` node
    that Keras 3 writes for ``mask_zero``, already.)"""
    m = _masked_last_step(cell, source)
    path = str(tmp_path / "masked.h5")
    m.save(path)
    with pytest.raises(jki.UnsupportedKerasLayerError,
                       match="return_sequences=False"):
        jki.KerasModelImport.import_keras_sequential_model_and_weights(path)
    with pytest.raises(tki.UnsupportedKerasLayerError,
                       match=r"return_sequences=False behind the mask of "
                             r"'(masking|embedding)"):
        tki.KerasModelImport.import_keras_sequential_model_and_weights(
            path, device="cpu")


def test_import_from_bytes_and_default_device(tmp_path):
    """The importer takes a file's bytes as well as its path, and without
    ``device`` it wants the card (and raises where there is none)."""
    import torch

    m = keras.Sequential([keras.layers.Input((3,)), keras.layers.Dense(2)])
    path = str(tmp_path / "m.h5")
    m.save(path)
    with open(path, "rb") as fh:
        data = fh.read()
    net = tki.KerasModelImport.import_keras_model_and_weights(data,
                                                              device="cpu")
    x = np.ones((1, 3), np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               m.predict(x, verbose=0), atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tki.KerasModelImport.import_keras_model_and_weights(path)
