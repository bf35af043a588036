"""The file iterators and the normalizers' JSON in the port against the JAX
package, on the CPU (``data/iterators.py``, ``data/normalizers.py``,
``util/model_serializer.py``).

No dataset is in the repository: each iterator takes its synthetic
fallback, whose arrays must be the JAX package's bit for bit for the same
seed; the image-tree loaders read the same small trees written here. A
normalizer crosses between the packages as JSON, alone and inside a model
zip (``normalizer.json``), in both directions. Tolerance: bitwise.
"""

import json
import zipfile

import numpy as np
import pytest

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu.data.iterators as JI
import deeplearning4j_tpu_torch.data as T
import deeplearning4j_tpu_torch.data.iterators as TI
from torch_parity import lenet_conf, mln_twins


def arr(a):
    return np.asarray(a.value if hasattr(a, "value") else a)


def assert_iterators_equal(t, j):
    np.testing.assert_array_equal(t.features, arr(j.features))
    np.testing.assert_array_equal(t.labels, arr(j.labels))
    assert t.features.dtype == arr(j.features).dtype
    tb, jb = list(t), list(j)
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.features, arr(b.features))
        np.testing.assert_array_equal(a.labels, arr(b.labels))


@pytest.fixture(autouse=True)
def empty_data_dir(tmp_path, monkeypatch):
    """Both packages look in an empty data directory: the synthetic
    fallbacks."""
    d = tmp_path / "data"
    d.mkdir()
    monkeypatch.setattr(JI, "_DATA_DIR", str(d))
    monkeypatch.setattr(TI, "_DATA_DIR", str(d))
    return d


CASES = {
    "iris": lambda M: M.IrisDataSetIterator(batch_size=32),
    "iris_small": lambda M: M.IrisDataSetIterator(batch_size=10,
                                                  num_examples=60),
    "cifar_train": lambda M: M.Cifar10DataSetIterator(16, num_examples=48,
                                                      seed=1),
    "cifar_test": lambda M: M.Cifar10DataSetIterator(16, train=False,
                                                     num_examples=40),
    "emnist_letters": lambda M: M.EmnistDataSetIterator(
        "letters", 8, num_examples=32, flatten=False),
    "emnist_balanced": lambda M: M.EmnistDataSetIterator(
        "balanced", 16, train=False, num_examples=40),
    "lfw": lambda M: M.LFWDataSetIterator(8, num_examples=40, image_hw=24,
                                          n_classes=5),
    "lfw_test": lambda M: M.LFWDataSetIterator(8, num_examples=30,
                                               image_hw=16, train=False),
    "tiny_imagenet": lambda M: M.TinyImageNetDataSetIterator(
        20, num_examples=60),
    "uci_train": lambda M: M.UciSequenceDataSetIterator(32),
    "uci_test": lambda M: M.UciSequenceDataSetIterator(32, train=False,
                                                       seed=5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_fallbacks_match_jax(case):
    t, j = CASES[case](T), CASES[case](J)
    assert getattr(t, "synthetic", True) == getattr(j, "synthetic", True)
    assert t.batch() == j.batch()
    if hasattr(j, "total_examples"):
        assert t.total_examples() == j.total_examples()
    if hasattr(j, "num_classes"):
        assert t.num_classes() == j.num_classes()
    assert_iterators_equal(t, j)


def test_unknown_emnist_split_rejected():
    for M in (T, J):
        with pytest.raises(ValueError, match="unknown EMNIST split"):
            M.EmnistDataSetIterator("nope", 8)


@pytest.mark.parametrize("n,classes,hw,channels,train",
                         [(30, 4, 16, 3, True), (25, 7, 28, 1, False),
                          (12, 3, 9, 2, True)])
def test_synthetic_class_images_match_jax(n, classes, hw, channels, train):
    a = TI._synthetic_class_images(n, classes, hw, channels, 3, train)
    b = JI._synthetic_class_images(n, classes, hw, channels, 3, train)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("seed", [0, 11])
def test_stratified_split_matches_jax(train, seed):
    labels = np.random.default_rng(seed).integers(0, 5, 83)
    np.testing.assert_array_equal(
        TI._stratified_split(labels, train, seed=seed),
        JI._stratified_split(labels, train, seed=seed))


def _image_tree(root, classes=3, per=4, hw=10, nested=None):
    from PIL import Image

    rng = np.random.default_rng(6)
    for c in range(classes):
        d = root / f"person_{c}"
        if nested:
            d = d / nested
        d.mkdir(parents=True)
        for i in range(per):
            Image.fromarray(rng.integers(0, 255, (hw + c, hw, 3),
                                         dtype=np.uint8)).save(
                d / f"{i}.jpg")


@pytest.mark.parametrize("limit", [100, 5])
@pytest.mark.parametrize("nested", [None, "images"])
def test_load_image_tree_matches_jax(tmp_path, limit, nested):
    _image_tree(tmp_path / "tree", nested=nested)
    a = TI._load_image_tree(str(tmp_path / "tree"), 12, limit, nested)
    b = JI._load_image_tree(str(tmp_path / "tree"), 12, limit, nested)
    for x, y in zip(a[:2], b[:2]):
        np.testing.assert_array_equal(x, y)
    assert a[2] == b[2]


@pytest.mark.parametrize("train", [True, False])
def test_lfw_reads_local_tree_as_jax(empty_data_dir, train):
    _image_tree(empty_data_dir / "lfw", classes=4, per=5, hw=14)
    t = T.LFWDataSetIterator(4, image_hw=14, train=train)
    j = J.LFWDataSetIterator(4, image_hw=14, train=train)
    assert not t.synthetic and not j.synthetic
    assert_iterators_equal(t, j)


def _normalizers(M, feats):
    ds = M.DataSet(feats, np.zeros((len(feats), 2), np.float32))
    std, mm = M.NormalizerStandardize(), M.NormalizerMinMaxScaler(-1.0, 2.0)
    std.fit(ds)
    mm.fit(ds)
    return {"standardize": std, "minmax": mm,
            "image": M.ImagePreProcessingScaler(0.0, 1.0, 200.0)}


@pytest.mark.parametrize("shape", [(9, 4), (6, 3, 5, 5)])
@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
def test_normalizer_json_both_ways(kind, shape):
    feats = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    t, j = _normalizers(T, feats)[kind], _normalizers(J, feats)[kind]
    assert json.dumps(t.to_json()) == json.dumps(j.to_json())
    for src in (j, t):
        # each package reads the other's JSON; the two read-back
        # normalizers transform alike
        d = json.loads(json.dumps(src.to_json()))
        out = []
        for M in (T, J):
            ds = M.DataSet(feats.copy(), np.zeros((shape[0], 2), np.float32))
            M.normalizer_from_json(d).transform(ds)
            out.append(arr(ds.features))
        assert out[0].dtype == out[1].dtype
        np.testing.assert_array_equal(out[0], out[1])


def test_unknown_normalizer_type_rejected():
    for M in (T, J):
        with pytest.raises(ValueError, match="unknown normalizer"):
            M.normalizer_from_json({"type": "whiten"})


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
@pytest.mark.parametrize("direction", ["torch->jax", "jax->torch"])
def test_model_zip_normalizer_both_ways(tmp_path, kind, direction):
    from deeplearning4j_tpu.util import model_serializer as JS
    from deeplearning4j_tpu_torch.util import model_serializer as TS

    feats = np.random.default_rng(8).normal(size=(5, 1, 28, 28)).astype(
        np.float32)
    jn, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    p = str(tmp_path / "m.zip")
    if direction == "torch->jax":
        TS.write_model(tn, p, normalizer=_normalizers(T, feats)[kind])
        got = JS.restore_normalizer(p)
        want = _normalizers(J, feats)[kind]
    else:
        JS.write_model(jn, p, normalizer=_normalizers(J, feats)[kind])
        got = TS.restore_normalizer(p)
        want = _normalizers(T, feats)[kind]
    assert json.dumps(got.to_json()) == json.dumps(want.to_json())
    with zipfile.ZipFile(p) as zf:
        assert "normalizer.json" in zf.namelist()
    # the network in the zip is read by the other package as before
    loaded = (JS.restore_multi_layer_network(p) if direction == "torch->jax"
              else TS.restore_multi_layer_network(p, device="cpu"))
    assert loaded.num_params() == tn.num_params()


def test_zip_without_normalizer_restores_none(tmp_path):
    from deeplearning4j_tpu_torch.util import model_serializer as TS

    _, tn = mln_twins(lenet_conf("jax"), lenet_conf("torch"))
    p = str(tmp_path / "m.zip")
    tn.save(p)
    assert TS.restore_normalizer(p) is None
