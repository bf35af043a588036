"""ImageRecordReader and the image transforms in the port against the JAX
package, on the CPU (``data/image.py``).

The same image folders (PNG and JPEG, written from a seed with PIL) are
decoded by both packages' readers. Tolerance: bitwise. Random transforms
draw from one generator in both; with ``workers > 1`` the order of the
draws follows the thread schedule, so the cases with random transforms run
at ``workers=1`` and the parallel cases run without them.
"""

import numpy as np
import pytest

import deeplearning4j_tpu.data as J
import deeplearning4j_tpu_torch.data as T


@pytest.fixture
def image_dir(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    for c, cls in enumerate(("cats", "dogs", "emus")):
        d = tmp_path / cls
        d.mkdir()
        for i in range(4):
            h, w = (12, 12) if i % 2 else (16, 10)
            arr = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
            ext = "png" if (i + c) % 2 else "jpg"
            Image.fromarray(arr).save(d / f"{i}.{ext}")
    return tmp_path


def read(M, root, workers=1, transform=None, channels=3, seed=0,
         exts=(".png", ".jpg")):
    rr = M.ImageRecordReader(height=8, width=8, channels=channels,
                             transform=transform, seed=seed,
                             workers=workers)
    rr.initialize(M.FileSplit(root, allowed_extensions=list(exts)))
    return rr, list(rr)


def assert_records_equal(t, j):
    assert len(t) == len(j)
    for (ti, tl), (ji, jl) in zip(t, j):
        assert ti.dtype == ji.dtype and ti.shape == ji.shape
        np.testing.assert_array_equal(ti, ji)
        assert tl == jl


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("workers", [1, 3])
def test_decode_matches_jax(image_dir, workers, channels):
    rt, t = read(T, image_dir, workers, channels=channels)
    rj, j = read(J, image_dir, workers, channels=channels)
    assert rt.labels == rj.labels == ["cats", "dogs", "emus"]
    assert rt.num_labels() == 3
    assert_records_equal(t, j)


def _transform(M, kind):
    return {
        "flip": lambda: M.FlipImageTransform(p=0.5),
        "crop": lambda: M.CropImageTransform(9, 9),
        "rotate": lambda: M.RotateImageTransform(20.0),
        "resize": lambda: M.ResizeImageTransform(6, 7),
        "pipeline": lambda: M.PipelineImageTransform([
            M.CropImageTransform(10, 9), M.FlipImageTransform(0.5),
            M.RotateImageTransform(15.0), M.ResizeImageTransform(8, 8)]),
    }[kind]()


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", ["flip", "crop", "rotate", "resize",
                                  "pipeline"])
def test_seeded_transforms_match_jax(image_dir, kind, seed):
    _, t = read(T, image_dir, 1, _transform(T, kind), seed=seed)
    _, j = read(J, image_dir, 1, _transform(J, kind), seed=seed)
    assert_records_equal(t, j)


@pytest.mark.parametrize("kind", ["flip", "crop", "rotate", "resize"])
def test_transform_calls_match_jax(kind):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, size=(16, 14, 3), dtype=np.uint8)
    a = _transform(T, kind)(img, np.random.default_rng(5))
    b = _transform(J, kind)(img, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)


def test_crop_larger_than_image_raises():
    img = np.zeros((4, 4, 3), np.uint8)
    for M in (T, J):
        with pytest.raises(ValueError, match="exceeds"):
            M.CropImageTransform(5, 5)(img, np.random.default_rng(0))


@pytest.mark.parametrize("batch", [4, 5])
def test_image_batches_match_jax(image_dir, batch):
    out = []
    for M in (J, T):
        rr, _ = read(M, image_dir, 2)
        out.append(list(M.RecordReaderDataSetIterator(
            rr, batch, label_index=1, num_classes=3)))
    for j, t in zip(*out):
        np.testing.assert_array_equal(t.features, np.asarray(j.features
                                                             .value))
        np.testing.assert_array_equal(t.labels, np.asarray(j.labels.value))
        assert t.features.dtype == np.float32
