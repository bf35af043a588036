"""DataVec's record readers and record iterators in the port against the
JAX package, on the CPU (``data/records.py``, ``data/record_iterator.py``).

The same CSV and text files (written from a seed) are read by both
packages' readers; the record iterators assemble the same batches.
Tolerance: bitwise (records equal as Python lists, arrays with
``np.testing.assert_array_equal`` and equal dtypes).
"""

import numpy as np
import pytest

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as T


def arr(a):
    return np.asarray(a.value if hasattr(a, "value") else a)


def assert_ds_equal(t, j):
    for f in ("features", "labels", "features_mask", "labels_mask"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a, b = arr(a), arr(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def csv_dir(tmp_path):
    rng = np.random.default_rng(0)
    for k in range(3):
        rows = ["a,b,c,label"] + [
            f"{rng.normal():.6f},{rng.normal():.6f},{rng.integers(0, 9)},"
            f"{rng.integers(0, 3)}" for _ in range(7)]
        (tmp_path / f"part{k}.csv").write_text("\n".join(rows) + "\n\n")
    (tmp_path / "notes.txt").write_text("one\ntwo\n\nthree\n")
    (tmp_path / "q.tsv").write_text('1;"x;y";3\n4;5;"6"\n')
    return tmp_path


@pytest.mark.parametrize("exts", [None, [".csv"], ["CSV", "txt"]])
@pytest.mark.parametrize("recursive", [True, False])
def test_file_split_matches_jax(csv_dir, exts, recursive):
    (csv_dir / "sub").mkdir()
    (csv_dir / "sub" / "z.csv").write_text("1\n")
    t = T.FileSplit(csv_dir, allowed_extensions=exts, recursive=recursive)
    j = J.FileSplit(csv_dir, allowed_extensions=exts, recursive=recursive)
    assert t.locations() == j.locations()
    paths = [csv_dir / "q.tsv", csv_dir / "notes.txt"]
    assert T.CollectionInputSplit(paths).locations() == \
        J.CollectionInputSplit(paths).locations()


@pytest.mark.parametrize("reader", ["csv", "csv_skip", "line", "tsv"])
def test_readers_match_jax(csv_dir, reader):
    make = {"csv": lambda M: (M.CSVRecordReader(), [".csv"]),
            "csv_skip": lambda M: (M.CSVRecordReader(skip_num_lines=1),
                                   [".csv"]),
            "line": lambda M: (M.LineRecordReader(), [".txt", ".csv"]),
            "tsv": lambda M: (M.CSVRecordReader(delimiter=";"), [".tsv"])}
    out = []
    for M in (J, T):
        rr, exts = make[reader](M)
        rr.initialize(M.FileSplit(csv_dir, allowed_extensions=exts))
        first = list(rr)
        again = list(rr)         # __iter__ resets
        rr.reset()
        manual = []
        while rr.has_next():
            manual.append(rr.next())
        out.append((first, again, manual))
    assert out[0] == out[1]
    assert out[1][0] == out[1][1] == out[1][2]


def test_collection_reader_matches_jax():
    recs = [[1, "a", 2.5], [3, "b", 4.5]]
    t, j = T.CollectionRecordReader(recs), J.CollectionRecordReader(recs)
    t.initialize()
    j.initialize()
    assert list(t) == list(j) == recs


@pytest.fixture
def seq_dir(tmp_path):
    rng = np.random.default_rng(1)
    for k, n in enumerate((3, 5, 2, 4)):
        rows = [f"{rng.normal():.5f},{rng.normal():.5f},{rng.integers(0, 3)}"
                for _ in range(n)]
        (tmp_path / f"s{k}.csv").write_text("h1,h2,l\n" + "\n".join(rows))
    return tmp_path


def test_csv_sequence_reader_matches_jax(seq_dir):
    out = []
    for M in (J, T):
        rr = M.CSVSequenceRecordReader(skip_num_lines=1)
        rr.initialize(M.FileSplit(seq_dir))
        out.append((list(rr.sequences()), rr.next_sequence()
                    if rr.reset() is None and rr.has_next() else None))
    assert out[0] == out[1]


@pytest.mark.parametrize("batch", [4, 7, 21])
@pytest.mark.parametrize("mode", ["classification", "regression",
                                  "regression_range", "no_label"])
def test_record_iterator_matches_jax(csv_dir, batch, mode):
    def make(M):
        rr = M.CSVRecordReader(skip_num_lines=1)
        rr.initialize(M.FileSplit(csv_dir, allowed_extensions=[".csv"]))
        kw = {"classification": dict(label_index=3, num_classes=3),
              "regression": dict(label_index=3, regression=True),
              "regression_range": dict(label_index=1, label_index_to=2,
                                       regression=True),
              "no_label": dict(label_index=None)}[mode]
        return M.RecordReaderDataSetIterator(rr, batch, **kw)

    t, j = list(make(T)), list(make(J))
    assert len(t) == len(j) == -(-21 // batch)
    for a, b in zip(t, j):
        assert_ds_equal(a, b)
    assert make(T).batch() == batch


def test_record_iterator_label_range_error():
    recs = [["0.5", "7"], ["0.1", "1"]]
    for M in (J, T):
        it = M.RecordReaderDataSetIterator(M.CollectionRecordReader(recs), 2,
                                           label_index=1, num_classes=3)
        with pytest.raises(ValueError, match="out of range"):
            list(it)


def test_record_iterator_pre_processor_matches_jax(csv_dir):
    out = []
    for M in (J, T):
        rr = M.CSVRecordReader(skip_num_lines=1)
        rr.initialize(M.FileSplit(csv_dir, allowed_extensions=[".csv"]))
        it = M.RecordReaderDataSetIterator(rr, 5, label_index=3,
                                           num_classes=3)
        norm = M.NormalizerMinMaxScaler()
        norm.fit(it)
        it.set_pre_processor(norm)
        out.append(list(it))
    for a, b in zip(*out[::-1]):
        assert_ds_equal(a, b)


@pytest.mark.parametrize("batch", [2, 3])
@pytest.mark.parametrize("regression", [False, True])
def test_sequence_iterator_matches_jax(seq_dir, batch, regression):
    out = []
    for M in (J, T):
        rr = M.CSVSequenceRecordReader(skip_num_lines=1)
        rr.initialize(M.FileSplit(seq_dir))
        it = M.SequenceRecordReaderDataSetIterator(
            rr, batch, label_index=2, num_classes=None if regression else 3,
            regression=regression)
        out.append(list(it))
    assert len(out[0]) == len(out[1])
    for j, t in zip(*out):
        assert_ds_equal(t, j)
