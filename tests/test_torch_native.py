"""The port's native helper (its own copy of ``datavec_native.cpp``, built
with g++ into ``deeplearning4j_tpu_torch/_build/``) against the JAX
package's, on the CPU.

Tolerance: none. Both run the same C++ loops on the same ids with the same
seed, so pairs and tokens must be equal bit for bit; the gates of
tests/test_native.py hold for the port's copy too.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu_torch import native as tnative



def _corpus(n_sent=300, vocab=120, seed=0):
    rng = np.random.default_rng(seed)
    sents = [rng.integers(0, vocab, size=int(rng.integers(0, 25)))
             .astype(np.int32) for _ in range(n_sent)]
    offsets = np.zeros(n_sent + 1, np.int64)
    np.cumsum([s.size for s in sents], out=offsets[1:])
    return np.concatenate(sents), offsets, vocab


@pytest.fixture(scope="module")
def both():
    if not jnative.available():
        pytest.skip("the JAX package's native helper did not build here")
    tnative.load()
    return jnative, tnative


@pytest.mark.parametrize("window,sampled,seed", [
    (5, False, 1), (5, True, 1), (1, False, 7), (10, True, 2 ** 62 + 3)])
def test_sg_pairs_bitwise_the_jax_helper(both, window, sampled, seed):
    ids, offsets, V = _corpus()
    keep = (np.random.default_rng(3).random(V) if sampled else None)
    jc, jx = jnative.sg_pairs(ids, offsets, window, keep, seed)
    tc, tx = tnative.sg_pairs(ids, offsets, window, keep, seed)
    assert tc.dtype == np.int32 and tx.dtype == np.int32
    assert tc.size > 0
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tx, jx)


@pytest.mark.parametrize("text", [
    "a  b\tc\nd\r\ne", "   ", "", "héllo wörld ünïcode", "x" * 3 + " y"])
def test_tokenize_bitwise_the_jax_helper(both, text):
    assert tnative.tokenize(text) == jnative.tokenize(text)


def test_gates_of_the_jax_helper_hold(both):
    """tests/test_native.py's gates on the port's copy: pairs stay within
    sentences and the window, subsampling drops a frequent word, a seed
    determines the stream."""
    ids = np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)
    c, x = tnative.sg_pairs(ids, np.array([0, 5, 8], np.int64), 3, None, 1)
    assert len(c) > 0 and all((a <= 5) == (b <= 5) for a, b in zip(c, x))
    ids = np.arange(1, 21, dtype=np.int32)
    c, x = tnative.sg_pairs(ids, np.array([0, 20], np.int64), 2, None, 7)
    assert (np.abs(c.astype(int) - x.astype(int)) <= 2).all()
    same = np.zeros(1000, np.int32)
    off = np.array([0, 1000], np.int64)
    sub, _ = tnative.sg_pairs(same, off, 5, np.array([0.1]), 5)
    full, _ = tnative.sg_pairs(same, off, 5, None, 5)
    assert len(sub) < len(full) * 0.15
    a = tnative.sg_pairs(np.arange(50, dtype=np.int32),
                         np.array([0, 50], np.int64), 4, None, 9)
    b = tnative.sg_pairs(np.arange(50, dtype=np.int32),
                         np.array([0, 50], np.int64), 4, None, 10)
    assert not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


def test_source_is_the_ports_own_copy():
    assert tnative.SOURCE.parent.name == "native"
    assert "deeplearning4j_tpu_torch" in str(tnative.SOURCE)
    assert "_build" in str(tnative.LIBRARY)
    jsrc = open(jnative._SRC).read()
    tsrc = tnative.SOURCE.read_text()
    # the same code below the header comment
    start = "#include <cstdint>"
    assert tsrc[tsrc.index(start):] == jsrc[jsrc.index(start):]


def test_bad_inputs_raise_before_the_native_call():
    ids = np.arange(5, dtype=np.int32)
    with pytest.raises(ValueError, match="offsets"):
        tnative.sg_pairs(ids, np.array([0, 4], np.int64), 2, None, 1)
    with pytest.raises(ValueError, match="window"):
        tnative.sg_pairs(ids, np.array([0, 5], np.int64), 0, None, 1)
    with pytest.raises(ValueError, match="keep"):
        tnative.sg_pairs(ids, np.array([0, 5], np.int64), 2, np.ones(3), 1)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "LIBRARY", tmp_path / "libbroken.so")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        tnative.load()
    assert not (tmp_path / "libbroken.so").exists()
