"""The port's data modules against the JAX package's, on the CPU: DataSet,
the iterators, MNIST's synthetic fallback, the normalizers and the input
pipeline's padded batches. Everything here is numpy arithmetic in both
packages, so the comparisons are exact (bitwise), except where noted."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import iterators as jit_
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data import pipeline as jpipe
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu_torch.common.profiler import OpProfiler
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data import normalizers as tnorm
from deeplearning4j_tpu_torch.data import pipeline as tpipe
from deeplearning4j_tpu_torch.data.dataset import DataSet


def _arrays(n=10, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3, 4, 4)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)]
    fm = (rng.random((n, 4)) > 0.3).astype(np.float32)
    lm = (rng.random((n,)) > 0.2).astype(np.float32)
    return x, y, fm, lm


def _np(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.numpy()
    if hasattr(a, "to_numpy"):
        return a.to_numpy()
    return np.asarray(a)


def _same(jds, tds):
    for f in ("features", "labels", "features_mask", "labels_mask"):
        j, t = _np(getattr(jds, f)), _np(getattr(tds, f))
        if j is None:
            assert t is None, f
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


def test_synthetic_mnist_is_bitwise_the_jax_generator():
    for train, n in ((True, 200), (False, 50)):
        ji, jl = jit_._synthetic_mnist(n, 6, train)
        ti, tl = tit._synthetic_mnist(n, 6, train)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
    ji = jit_.MnistDataSetIterator(64, train=True, num_examples=300,
                                   flatten=False)
    ti = tit.MnistDataSetIterator(64, train=True, num_examples=300,
                                  flatten=False)
    assert ji.synthetic and ti.synthetic and ti.total_examples() == 300
    jb, tb = list(ji), list(ti)
    assert [b.num_examples() for b in tb] == [64, 64, 64, 64, 44]
    for j, t in zip(jb, tb):
        _same(j, t)
    flat = tit.MnistDataSetIterator(8, train=False, num_examples=8)
    assert next(iter(flat)).features.shape == (8, 784)


def test_mnist_reads_idx_files(tmp_path, monkeypatch):
    """The IDX lookup the JAX package uses (a gzip file under the data
    directory), before the synthetic fallback."""
    import gzip
    import struct

    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    lbls = rng.integers(0, 10, 5).astype(np.uint8)
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">III", 5, 28, 28)
                + imgs.tobytes())
    with open(tmp_path / "t10k-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 5)
                + lbls.tobytes())
    monkeypatch.setattr(tit, "_DATA_DIR", str(tmp_path))
    it = tit.MnistDataSetIterator(4, train=False, flatten=False)
    assert not it.synthetic and it.total_examples() == 5
    np.testing.assert_array_equal(it.features[:, 0], imgs / np.float32(255))
    np.testing.assert_array_equal(it.labels.argmax(1), lbls)


def test_dataset_split_shuffle_batch_merge():
    x, y, fm, lm = _arrays(10)
    jds, tds = JDataSet(x, y, fm, lm), DataSet(x, y, fm, lm)
    for (ja, jb), (ta, tb) in zip([jds.split_test_and_train(7)],
                                  [tds.split_test_and_train(7)]):
        _same(ja, ta)
        _same(jb, tb)
    jds.shuffle(seed=3)
    tds.shuffle(seed=3)
    _same(jds, tds)
    jbs, tbs = list(jds.batch_by(4)), list(tds.batch_by(4))
    assert [b.num_examples() for b in tbs] == [4, 4, 2]
    for j, t in zip(jbs, tbs):
        _same(j, t)
    assert [b.num_examples() for b in tds.batch_by(4, drop_remainder=True)] \
        == [4, 4]
    _same(JDataSet.merge(jbs), DataSet.merge(tbs))
    # tensors stay tensors
    tt = DataSet(torch.from_numpy(x), torch.from_numpy(y))
    tt.shuffle(seed=3)
    assert isinstance(tt.features, torch.Tensor)
    np.testing.assert_array_equal(tt.features.numpy(), _np(jds.features))
    assert DataSet(x, y).num_examples() == 10 and DataSet().num_examples() == 0


@pytest.mark.parametrize("kind", ["standardize", "minmax", "image"])
@pytest.mark.parametrize("shape", [(12, 6), (12, 3, 4, 4)])
def test_normalizers_match_jax(kind, shape):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    y = np.zeros((shape[0], 2), np.float32)
    make = {"standardize": lambda m: m.NormalizerStandardize(),
            "minmax": lambda m: m.NormalizerMinMaxScaler(-1.0, 1.0),
            "image": lambda m: m.ImagePreProcessingScaler()}[kind]
    jn, tn = make(jnorm), make(tnorm)
    jn.fit(jit_.NDArrayDataSetIterator(x, y, batch_size=5))
    tn.fit(tit.NDArrayDataSetIterator(x, y, batch_size=5))
    jds, tds = JDataSet(x, y), DataSet(x, y)
    jn.transform(jds)
    tn.transform(tds)
    np.testing.assert_array_equal(tds.features, jds.features.to_numpy())
    # reverting gives the input back (float32 rounding), also for tensors
    tn.revert(tds)
    np.testing.assert_allclose(tds.features, x, rtol=1e-5, atol=1e-5)
    tt = DataSet(torch.from_numpy(x), torch.from_numpy(y))
    tn.pre_process(tt)
    np.testing.assert_allclose(tt.features.numpy(), jds.features.to_numpy(),
                               rtol=1e-6, atol=1e-6)
    if kind == "standardize":
        np.testing.assert_array_equal(tn.revert_features(jds.features
                                                         .to_numpy()),
                                      jn.revert_features(jds.features)
                                      .to_numpy())


def test_iterator_pre_processor_and_batch_edges():
    x, y, _, _ = _arrays(10)
    it = tit.NDArrayDataSetIterator(x, y, batch_size=4)
    assert [b.num_examples() for b in it] == [4, 4, 2]
    assert it.batch() == 4
    it = tit.NDArrayDataSetIterator(x, y, batch_size=4, drop_remainder=True)
    assert [b.num_examples() for b in it] == [4, 4]
    j = jit_.NDArrayDataSetIterator(x, y, batch_size=3, shuffle=True, seed=5)
    t = tit.NDArrayDataSetIterator(x, y, batch_size=3, shuffle=True, seed=5)
    for _ in range(2):          # a new order each epoch, the JAX one
        for jb, tb in zip(list(j), list(t)):
            _same(jb, tb)
    norm = tnorm.ImagePreProcessingScaler(max_pixel=2.0)
    it = tit.NDArrayDataSetIterator(x, y, batch_size=10)
    it.set_pre_processor(norm)
    np.testing.assert_array_equal(next(iter(it)).features, x / np.float32(2))
    parts = [DataSet(x[:3], y[:3]), DataSet(x[3:], y[3:])]
    ex = tit.ExistingDataSetIterator(parts)
    assert ex.batch() == 3 and [b.num_examples() for b in ex] == [3, 7]
    me = tit.MultipleEpochsIterator(3, tit.NDArrayDataSetIterator(
        x, y, batch_size=5))
    assert me.batch() == 5 and len(list(me)) == 6


@pytest.mark.parametrize("pad,drop,batch", [(True, False, 4), (False, False, 4),
                                            (True, True, 4), (True, False, 5),
                                            (True, False, None)])
def test_stable_batches_match_jax(pad, drop, batch):
    x, y, fm, lm = _arrays(10)
    jb = list(jpipe.stable_batches(JDataSet(x, y, fm, lm), batch,
                                   pad_partial=pad, drop_remainder=drop))
    OpProfiler.get().reset()
    tb = list(tpipe.stable_batches(DataSet(x, y, fm, lm), batch,
                                   pad_partial=pad, drop_remainder=drop))
    assert len(tb) == len(jb)
    for (jds, jw, jn), (tds, tw, tn) in zip(jb, tb):
        assert tn == jn
        np.testing.assert_array_equal(tw, np.asarray(jw))
        _same(jds, tds)
    c = OpProfiler.get().get_counters()
    assert c.get("pipeline/padded_batches", 0) + c.get(
        "pipeline/dropped_batches", 0) == (1 if pad and batch == 4 else 0)


def test_resolve_batch_size_and_chunks():
    x, y, _, _ = _arrays(10)
    it = tit.NDArrayDataSetIterator(x, y, batch_size=4)
    assert tpipe.resolve_batch_size(it, 7) == 4
    assert tpipe.resolve_batch_size(DataSet(x, y), 7) == 7
    assert tpipe.resolve_batch_size(DataSet(x, y), None) is None
    assert [len(g) for g in tpipe.chunked(range(7), 3)] == [3, 3, 1]
    with pytest.raises(ValueError):
        list(tpipe.chunked(range(3), 0))
    assert [d.num_examples() for d in tpipe.iter_datasets((x, y), 4)] \
        == [4, 4, 2]
    with pytest.raises(TypeError):
        list(tpipe.iter_datasets(42))
    placed = []
    feed = tpipe.device_feed(iter(range(5)), lambda b: placed.append(b) or b,
                             depth=2)
    assert next(feed) == 0 and placed == [0, 1, 2]
    assert list(feed) == [1, 2, 3, 4]


def test_evaluation_metrics_match_jax():
    from deeplearning4j_tpu.eval.evaluation import Evaluation as JEval
    from deeplearning4j_tpu.eval.evaluation import (
        RegressionEvaluation as JReg)
    from deeplearning4j_tpu_torch.eval import Evaluation, RegressionEvaluation

    rng = np.random.default_rng(3)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 30)]
    preds = rng.random((30, 4)).astype(np.float32)
    mask = (rng.random(30) > 0.2).astype(np.float32)
    j, t = JEval(top_n=2), Evaluation(top_n=2)
    j.eval(labels[:20], preds[:20], mask[:20])
    t.eval(torch.from_numpy(labels[:20]), torch.from_numpy(preds[:20]),
           mask[:20])
    j2, t2 = JEval(top_n=2), Evaluation(top_n=2)
    j2.eval(labels[20:], preds[20:])
    t2.eval(labels[20:], preds[20:])
    j.merge(j2)
    t.merge(t2)
    np.testing.assert_array_equal(t.confusion, j.confusion)
    for name in ("accuracy", "top_n_accuracy", "precision", "recall", "f1"):
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.precision(2) == j.precision(2) and t.recall(1) == j.recall(1)
    assert t.stats() == j.stats()
    # a time series flattened with its [B, T] mask; binary MCC
    seq = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 5))]
    sp = rng.random((3, 5, 2)).astype(np.float32)
    sm = (rng.random((3, 5)) > 0.3).astype(np.float32)
    j, t = JEval(), Evaluation()
    j.eval(seq, sp, sm)
    t.eval(seq, sp, sm)
    assert t.count == j.count and t.matthews_correlation() == \
        j.matthews_correlation()
    y = rng.normal(size=(12, 2))
    p = y + rng.normal(size=(12, 2)) * 0.3
    jr, tr = JReg(), RegressionEvaluation()
    jr.eval(y, p)
    tr.eval(torch.from_numpy(y), torch.from_numpy(p))
    for name in ("mean_squared_error", "mean_absolute_error",
                 "root_mean_squared_error", "r_squared",
                 "pearson_correlation"):
        assert getattr(tr, name)(1) == getattr(jr, name)(1), name
