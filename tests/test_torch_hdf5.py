"""The port's HDF5 reader (``deeplearning4j_tpu_torch/imports/hdf5.py``)
against ``h5py``, and the fixture writer (``import_fixtures.write_hdf5``)
read back by ``h5py``.

Every file here is walked whole by both: the same members in the same
(name) order, every dataset bitwise (dtype, shape, bytes), every attribute
equal in type and value. The files: what Keras writes (Sequential and
functional ``.h5``, the ``model.weights.h5`` inside ``.keras`` zips, and
full-width ``keras.applications.ResNet50``), what h5py writes for the
corners of the subset (scalars, empty and never-written datasets, fill
values, fixed and variable-length strings, compact layouts, version-2
object headers with compact links), and what the fixture writer writes
(the Keras ResNet-50 and character LSTM, a group of 300 members under a
two-level B-tree). Files outside the subset raise naming the feature.
"""

from __future__ import annotations

import io
import zipfile

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

import import_fixtures as F  # noqa: E402
from deeplearning4j_tpu_torch.imports import hdf5  # noqa: E402


def same_tree(source) -> tuple:
    """Walk ``source`` (a path or bytes) with h5py and the port's reader;
    returns (datasets, attributes) compared."""
    hf = h5py.File(io.BytesIO(source) if isinstance(source, bytes)
                   else source, "r")
    mf = hdf5.File(source)
    n = [0, 0]

    def walk(h, m):
        assert sorted(h.attrs) == sorted(m.attrs), h.name
        for k in h.attrs:
            a, b = h.attrs[k], m.attrs[k]
            if isinstance(a, np.ndarray):
                assert isinstance(b, np.ndarray), (h.name, k)
                assert (a.dtype, a.shape) == (b.dtype, b.shape), (h.name, k)
                assert (a == b).all(), (h.name, k)
            else:
                assert type(a) is type(b) and a == b, (h.name, k, a, b)
            n[1] += 1
        if isinstance(h, h5py.Dataset):
            assert isinstance(m, hdf5.Dataset), h.name
            a, b = h[()], np.asarray(m)
            assert (a.dtype, a.shape) == (b.dtype, b.shape), h.name
            assert a.tobytes() == b.tobytes(), h.name
            n[0] += 1
            return
        assert isinstance(m, hdf5.Group), h.name
        assert list(h.keys()) == list(m.keys()), h.name
        for k in h:
            walk(h[k], m[k])

    walk(hf, mf)
    hf.close()
    return tuple(n)


# --- files Keras writes ---------------------------------------------------------------


@pytest.fixture(scope="module")
def keras():
    pytest.importorskip("tensorflow")
    from tensorflow import keras as k
    return k


def _keras_models(keras):
    L = keras.layers
    return {
        "mlp": keras.Sequential([L.Input((6,)), L.Dense(5, "relu"),
                                 L.Dense(3, activation="softmax")]),
        "cnn_bn": keras.Sequential([L.Input((8, 8, 3)), L.Conv2D(4, 3),
                                    L.BatchNormalization(), L.ReLU(),
                                    L.Flatten(), L.Dense(2)]),
        "bilstm": keras.Sequential([
            L.Input((5, 4)), L.Bidirectional(L.LSTM(3,
                                                     return_sequences=True)),
            L.GlobalAveragePooling1D()]),
    }


@pytest.mark.parametrize("name", ["mlp", "cnn_bn", "bilstm"])
@pytest.mark.parametrize("fmt", ["h5", "keras"])
def test_keras_written_files(keras, name, fmt, tmp_path):
    m = _keras_models(keras)[name]
    path = str(tmp_path / f"m.{fmt}")
    m.save(path)
    if fmt == "h5":
        n_data, n_attrs = same_tree(path)
        assert n_attrs >= 3
    else:
        weights = zipfile.ZipFile(path).read("model.weights.h5")
        n_data, _ = same_tree(weights)
    assert n_data == len(m.weights)


def test_keras_functional_with_many_layers(keras, tmp_path):
    """A functional model whose ``model_weights`` group needs several
    SNODs (more than 8 members)."""
    L = keras.layers
    inp = L.Input((6,))
    x = inp
    for i in range(12):
        x = L.Dense(4, activation="tanh", name=f"d{i:02d}")(x)
    m = keras.Model(inp, x)
    path = str(tmp_path / "f.h5")
    m.save(path)
    assert same_tree(path)[0] == 24
    # the input layer, 12 Dense layers and top_level_model_weights
    assert len(hdf5.File(path)["model_weights"]) == 14


def test_keras_resnet50_full_width(keras, tmp_path):
    """``keras.applications.ResNet50(weights=None)``: 320 datasets and the
    147k-character ``model_config`` in a global heap collection."""
    path = str(tmp_path / "r50.h5")
    keras.applications.ResNet50(weights=None).save(path)
    n_data, n_attrs = same_tree(path)
    assert n_data == 320 and n_attrs == 184
    assert len(hdf5.File(path).attrs["model_config"]) > 140_000


# --- corners of the subset, as h5py writes them ------------------------------------------


def test_h5py_corner_cases():
    b = io.BytesIO()
    with h5py.File(b, "w") as f:
        f.attrs["utf8"] = "héllo"
        f.attrs["ascii_list"] = [b"a", b"bb"]
        f.attrs["num"] = np.float32(2.5)
        f.attrs["ints"] = np.arange(4, dtype=np.int64)
        f.attrs["fixed"] = np.bytes_(b"abc")
        f.attrs["fixed_arr"] = np.array([b"ab", b"c"], dtype="S2")
        f.attrs["empty"] = np.zeros((0,), np.float64)
        f.create_dataset("empty", shape=(0,), dtype=np.float32)
        f.create_dataset("unwritten", shape=(3,), dtype=np.float32)
        f.create_dataset("filled", shape=(2,), dtype=np.int32, fillvalue=7)
        f.create_dataset("scalar", data=np.float64(1.5))
        f.create_dataset("u8", data=np.arange(5, dtype=np.uint8))
        f.create_dataset("f16", data=np.linspace(0, 1, 6, dtype=np.float16))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple((3,))
        h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_DOUBLE, space,
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                         np.arange(3.0))
        g = f.create_group("g")
        for i in range(20):
            g.create_dataset(f"d{i}", data=np.arange(i + 1, dtype=np.int16))
    assert same_tree(b.getvalue()) == (27, 7)
    np.testing.assert_array_equal(hdf5.File(b.getvalue())["filled"], [7, 7])


def test_version2_object_headers_and_compact_links():
    """``libver="latest"``: superblock 3, ``OHDR`` headers, groups of link
    messages."""
    b = io.BytesIO()
    with h5py.File(b, "w", libver="latest") as f:
        f.attrs["s"] = "x" * 100
        g = f.create_group("g")
        for i in range(3):
            g.create_dataset(f"d{i}", data=np.full((2, i + 1), i, np.float32))
            g[f"d{i}"].attrs["i"] = i
    assert same_tree(b.getvalue()) == (3, 4)


@pytest.mark.parametrize("kind,feature", [
    ("chunked", "chunked data"),
    ("gzip", "filtered data"),
    ("big_endian", "big-endian datatype"),
    ("compound", "compound datatype"),
    ("dense_links", "dense link storage"),
    ("soft_link", "soft link"),
])
def test_outside_the_subset_raises_naming_it(kind, feature):
    b = io.BytesIO()
    with h5py.File(b, "w", libver="latest" if kind == "dense_links"
                   else "earliest") as f:
        if kind == "chunked":
            f.create_dataset("x", data=np.arange(8.0), chunks=(2,))
        elif kind == "gzip":
            f.create_dataset("x", data=np.arange(8.0), compression="gzip")
        elif kind == "big_endian":
            f.create_dataset("x", data=np.arange(8.0, dtype=">f8"))
        elif kind == "compound":
            f.create_dataset("x", data=np.zeros(2, "i4,f4"))
        elif kind == "dense_links":
            g = f.create_group("x")
            for i in range(20):
                g.create_group(f"g{i}")
        else:
            f.create_group("y")
            f["x"] = h5py.SoftLink("/y")
    with pytest.raises(hdf5.UnsupportedHDF5Feature, match=feature):
        x = hdf5.File(b.getvalue())["x"]
        np.asarray(x) if isinstance(x, hdf5.Dataset) else list(x)


def test_not_an_hdf5_file():
    assert not hdf5.is_hdf5(b"PK\x03\x04 not hdf5")
    with pytest.raises(hdf5.HDF5FormatError, match="signature"):
        hdf5.File(b"\0" * 64)


# --- the fixture writer -------------------------------------------------------------------


def test_writer_files_read_back_by_h5py():
    """A tree of 300 members (two B-tree levels), attributes of every kind
    the writer takes, an empty and a float64 dataset: h5py reads what the
    port's reader reads."""
    root = F.H5Group({"config": '{"a": "é"}', "names": [b"x", b"yy"],
                      "num": np.arange(3, dtype=np.int64)})
    rng = np.random.default_rng(0)
    for i in range(300):
        g = root.group(f"model_weights/layer_{i:03d}")
        g.attrs["weight_names"] = ([f"layer_{i:03d}/kernel"] if i % 3
                                   else np.zeros((0,), np.float64))
        if i % 3:
            g.group(f"layer_{i:03d}").members["kernel"] = \
                rng.random((3, 4), dtype=np.float32)
    root.members["empty"] = np.zeros((0,), np.float32)
    root.members["f64"] = rng.random((2, 5))
    data = F.write_hdf5(root)
    assert same_tree(data) == (202, 303)
    with h5py.File(io.BytesIO(data), "r") as f:
        assert f.attrs["config"] == '{"a": "é"}'
        assert len(f["model_weights"]) == 300
        np.testing.assert_array_equal(
            f["model_weights/layer_299/layer_299/kernel"][()],
            root.group("model_weights/layer_299/layer_299")
            .members["kernel"])


def test_writer_keras_fixtures_read_back_by_h5py():
    """The full-width Keras ResNet-50 fixture (320 datasets, 25,636,712
    values) and the character LSTM's ``model.weights.h5``."""
    data = F.keras_resnet50_h5()
    assert same_tree(data) == (320, 184)
    f = hdf5.File(data)
    total = sum(np.asarray(f[f"model_weights/{l}/{l}/{k}"]).size
                for l in f["model_weights"] if l in f[f"model_weights/{l}"]
                for k in f[f"model_weights/{l}/{l}"])
    assert total == 25_636_712
    z = zipfile.ZipFile(io.BytesIO(F.keras_char_lstm(vocab=57)))
    assert same_tree(z.read("model.weights.h5")) == (5, 4)
