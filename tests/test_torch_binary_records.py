"""The pre-decoded container in the port against the JAX package, on the
CPU (``data/binary_records.py``).

The file format is the JAX package's byte for byte: a container written by
either package is read by the other, and both packages' writers give the
same bytes for the same records (made from a seed). Tolerance: bitwise.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu.data.binary_records as JB
import deeplearning4j_tpu_torch.data as T
import deeplearning4j_tpu_torch.data.binary_records as TB

COLUMNS = [("features", (3, 4, 5), "uint8"), ("label", (), "int32"),
           ("target", (2,), "float32")]


def write(B, path, n=23, chunk=8, seed=0):
    rng = np.random.default_rng(seed)
    with B.BinaryRecordWriter(str(path), COLUMNS, chunk_records=chunk) as w:
        for i in range(n):
            w.append(rng.integers(0, 255, (3, 4, 5), dtype=np.uint8),
                     int(rng.integers(0, 7)),
                     rng.normal(size=2).astype(np.float32))


@pytest.mark.parametrize("n,chunk", [(23, 8), (16, 8), (5, 512), (1, 1)])
def test_writers_give_the_same_bytes(tmp_path, n, chunk):
    write(JB, tmp_path / "j.d4tbin", n, chunk)
    write(TB, tmp_path / "t.d4tbin", n, chunk)
    assert (tmp_path / "j.d4tbin").read_bytes() == \
        (tmp_path / "t.d4tbin").read_bytes()


@pytest.mark.parametrize("writer,reader", [(JB, TB), (TB, JB), (TB, TB)],
                         ids=["jax->torch", "torch->jax", "torch->torch"])
def test_record_reader_across_packages(tmp_path, writer, reader):
    p = tmp_path / "c.d4tbin"
    write(writer, p)
    want = JB.BinaryRecordReader(str(p))
    got = reader.BinaryRecordReader(str(p))
    assert got.n_records == want.n_records == 23
    assert got.schema_columns == want.schema_columns
    n = 0
    while want.has_next():
        a, b = got.next(), want.next()
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1] and type(a[1]) is type(b[1])
        np.testing.assert_array_equal(a[2], b[2])
        n += 1
    assert n == 23 and not got.has_next()
    got.reset()
    assert got.has_next()


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("scale,classes", [(None, None), (1 / 255, 7)])
@pytest.mark.parametrize("batch", [5, 8, 30])
def test_dataset_iterator_matches_jax(tmp_path, batch, scale, classes, raw):
    p = tmp_path / "c.d4tbin"
    write(TB, p)
    kw = dict(batch_size=batch, num_classes=classes, feature_scale=scale,
              raw_numpy=raw)
    t = TB.BinaryRecordDataSetIterator(str(p), **kw)
    j = JB.BinaryRecordDataSetIterator(str(p), **kw)
    assert t.batch() == batch and t.total_examples() == 23
    for _ in range(2):                      # iterating resets
        got, want = list(t), list(j)
        assert len(got) == len(want) == -(-23 // batch)
        for a, b in zip(got, want):
            if raw:
                xa, ya = a
                xb, yb = b
            else:
                xa, ya = a.features, a.labels
                xb, yb = np.asarray(b.features.value), np.asarray(
                    b.labels.value)
            assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_iterator_rejects_unknown_column(tmp_path):
    p = tmp_path / "c.d4tbin"
    write(TB, p)
    with pytest.raises(ValueError, match="not in container"):
        TB.BinaryRecordDataSetIterator(str(p), 4, feature_col="pixels")


@pytest.mark.parametrize("case", ["bad_magic", "truncated", "shape",
                                  "columns"])
def test_errors_match_jax(tmp_path, case):
    msgs = []
    for B in (JB, TB):
        p = tmp_path / f"{B.__name__.split('.')[0]}.d4tbin"
        try:
            if case == "bad_magic":
                p.write_bytes(b"NOPE" + bytes(100))
                B.BinaryRecordReader(str(p))
            elif case == "truncated":
                write(B, p)
                data = p.read_bytes()
                p.write_bytes(data[:-7])
                B.BinaryRecordReader(str(p))
            elif case == "shape":
                with B.BinaryRecordWriter(str(p), COLUMNS) as w:
                    w.append(np.zeros((3, 4, 4), np.uint8), 1,
                             np.zeros(2, np.float32))
            else:
                with B.BinaryRecordWriter(str(p), COLUMNS) as w:
                    w.append(np.zeros((3, 4, 5), np.uint8))
        except ValueError as e:
            msgs.append(str(e).replace(str(p), "<path>"))
    assert len(msgs) == 2 and msgs[0] == msgs[1]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_write_records_from_image_reader(tmp_path, dtype):
    """The decode-once converter over ImageRecordReader: the same
    container bytes from both packages, and the iterator reads back the
    reader's pixels (uint8 quantized by round(x * 255))."""
    from PIL import Image

    rng = np.random.default_rng(2)
    for cls in ("a", "b"):
        (tmp_path / "img" / cls).mkdir(parents=True)
        for i in range(5):
            Image.fromarray(rng.integers(0, 255, (6, 6, 3), dtype=np.uint8)
                            ).save(tmp_path / "img" / cls / f"{i}.png")
    blobs = []
    for M, B in ((J, JB), (T, TB)):
        rr = M.ImageRecordReader(height=6, width=6, channels=3)
        rr.initialize(M.FileSplit(tmp_path / "img"))
        out = tmp_path / f"{B.__name__.split('.')[0]}.d4tbin"
        n = B.write_records(rr, str(out), (3, 6, 6), features_dtype=dtype,
                            chunk_records=4)
        assert n == 10
        blobs.append(out.read_bytes())
    assert blobs[0] == blobs[1]
    rr = T.ImageRecordReader(height=6, width=6, channels=3)
    rr.initialize(T.FileSplit(tmp_path / "img"))
    pix = np.stack([r[0] for r in rr])
    x, y = next(iter(TB.BinaryRecordDataSetIterator(
        str(out), 10, raw_numpy=True)))
    want = (np.clip(np.round(pix * 255.0), 0, 255).astype(np.uint8)
            if dtype == "uint8" else pix)
    np.testing.assert_array_equal(x, want)
    np.testing.assert_array_equal(y, [0] * 5 + [1] * 5)
