"""The port's WordVectorSerializer against the JAX package's, on the CPU.

Tolerance: none. Both packages run the same formatting and parsing code on
the same float32 tables, so the text and binary files are equal byte for
byte, the zips' members are equal (``tables.npz`` compared array by array:
its inner zip stamps the time of writing), and a file written by either
package reads in the other to the same arrays bit for bit.
"""

import io
import json
import zipfile

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import fasttext as jft
from deeplearning4j_tpu.nlp import glove as jg
from deeplearning4j_tpu.nlp import paragraph_vectors as jpv
from deeplearning4j_tpu.nlp import serializer as js
from deeplearning4j_tpu.nlp import text as jtext
from deeplearning4j_tpu.nlp import word2vec as jw2v
from deeplearning4j_tpu_torch.nlp import fasttext as tft
from deeplearning4j_tpu_torch.nlp import glove as tg
from deeplearning4j_tpu_torch.nlp import serializer as ts
from deeplearning4j_tpu_torch.nlp import word2vec as tw2v
from deeplearning4j_tpu_torch.util import (fasttext_state_from_numpy,
                                           glove_state_from_numpy,
                                           word2vec_state_from_numpy)
from torch_parity import one_torch_thread  # noqa: F401 (a fixture)


def _corpus(n_sent=200, sent_len=8, seed=0):
    rng = np.random.default_rng(seed)
    A = [f"a{i}" for i in range(30)] + ["é", "日本"]
    B = [f"b{i}" for i in range(30)]
    return [" ".join(rng.choice(A if rng.random() < .5 else B, size=sent_len))
            for _ in range(n_sent)]


def _counts(m):
    return [m.vocab.entry(w).count for w in m.vocab.words()]


def _w2v(hs=False):
    kw = ({"use_hierarchic_softmax": True, "negative": 0} if hs
          else {"negative": 3})
    j = jw2v.Word2Vec(min_word_frequency=2, layer_size=8, epochs=1,
                      batch_size=64, seed=1, **kw)
    j.set_sentence_iterator(_corpus())
    j.fit()
    t = tw2v.Word2Vec(layer_size=8, batch_size=64, seed=1, device="cpu",
                      min_word_frequency=2, epochs=1, **kw)
    word2vec_state_from_numpy(t, j.vocab.words(), _counts(j),
                              np.asarray(j.lookup_table.syn0),
                              None if hs else np.asarray(
                                  j.lookup_table.syn1neg),
                              np.asarray(j.lookup_table.syn1) if hs else None)
    return j, t


def _fasttext():
    j = (jft.FastText.builder().min_word_frequency(2).layer_size(8)
         .epochs(1).negative_sample(3).batch_size(64).seed(4).bucket(512)
         .iterate(_corpus()).build())
    j.fit()
    t = tft.FastText(min_word_frequency=2, layer_size=8, negative=3,
                     batch_size=64, seed=4, bucket=512, device="cpu")
    fasttext_state_from_numpy(t, j.vocab.words(), _counts(j),
                              np.asarray(j.lookup_table.syn0),
                              np.asarray(j.lookup_table.syn1neg))
    return j, t


def _glove():
    j = (jg.Glove.builder().min_word_frequency(2).layer_size(8).epochs(2)
         .seed(4).batch_size(256).iterate(_corpus()).build())
    j.fit()
    t = tg.Glove(layer_size=8, device="cpu")
    glove_state_from_numpy(t, j.vocab.words(), _counts(j), j._w, j._wc,
                           j._bias, j._bias_c)
    return j, t


MODELS = {"word2vec": _w2v, "word2vec-hs": lambda: _w2v(True),
          "fasttext": _fasttext, "glove": _glove}


@pytest.mark.parametrize("fmt", ["text", "text-noheader", "binary"])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_vector_files_bytes_equal_and_cross_read(model, fmt, tmp_path):
    j, t = MODELS[model]()
    binary = fmt == "binary"
    header = fmt != "text-noheader"
    jp, tp = tmp_path / "jax.vec", tmp_path / "port.vec"
    js.write_word_vectors(j, jp, binary=binary, header=header)
    ts.write_word_vectors(t, tp, binary=binary, header=header)
    assert tp.read_bytes() == jp.read_bytes()
    for path in (jp, tp):
        jr = js.read_word_vectors(path, binary=binary)
        tr = ts.read_word_vectors(path, binary=binary)
        assert tr.vocab.words() == jr.vocab.words() == t.vocab.words()
        np.testing.assert_array_equal(tr.lookup_table.syn0,
                                      jr.lookup_table.syn0)
        assert tr.words_nearest("a1", 5) == jr.words_nearest("a1", 5)
    want = t.get_word_vector_matrix()
    got = ts.read_word_vectors(tp, binary=binary).lookup_table.syn0
    if binary:
        np.testing.assert_array_equal(got, want)
    else:                              # six significant digits
        np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)


def _members(path):
    with zipfile.ZipFile(path) as z:
        out = {n: z.read(n) for n in z.namelist()}
    npz = np.load(io.BytesIO(out.pop("tables.npz")))
    return out, {k: npz[k] for k in npz.files}


def _pv():
    docs = _corpus(60, 12)
    labels = [f"DOC_{i}" for i in range(len(docs))]
    j = (jpv.ParagraphVectors.builder().min_word_frequency(1).layer_size(8)
         .epochs(1).negative_sample(3).batch_size(64).seed(3).dm(True)
         .iterate(jtext.LabelAwareIterator(docs, labels)).build())
    j.fit()
    return j


@pytest.mark.parametrize("model", ["word2vec", "word2vec-hs", "fasttext",
                                   "paragraph-vectors"])
def test_zip_members_equal_and_cross_read(model, tmp_path):
    jp, tp = tmp_path / "jax.zip", tmp_path / "port.zip"
    if model == "paragraph-vectors":
        j = _pv()
        js.write_paragraph_vectors(j, jp)
        t = ts.read_paragraph_vectors(jp, device="cpu")
        ts.write_paragraph_vectors(t, tp)
        back = js.read_paragraph_vectors(tp)
        assert t.nearest_labels("DOC_0", 4) == j.nearest_labels("DOC_0", 4)
        assert back._label_ids == j._label_ids == t._label_ids
        assert t.dm and t.device.type == "cpu"
    else:
        j, t = MODELS[model]()
        js.write_word2vec_model(j, jp)
        ts.write_word2vec_model(t, tp)
        back = js.read_word2vec_model(tp)
        t2 = ts.read_word2vec_model(jp, device="cpu")
        for a, b in (("syn0", "syn0"), ("syn1", "syn1"),
                     ("syn1neg", "syn1neg")):
            x = getattr(t2.lookup_table, a)
            y = getattr(j.lookup_table, b)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, np.asarray(y))
        assert t2.vocab.words() == j.vocab.words()
        assert t2.use_hs == j.use_hs and t2.algorithm == j.algorithm
    jm, ja = _members(jp)
    tm, ta = _members(tp)
    assert tm == jm                         # config, vocab (and labels)
    assert sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype
        np.testing.assert_array_equal(ta[k], ja[k])
    np.testing.assert_array_equal(np.asarray(back.lookup_table.syn0),
                                  np.asarray(j.lookup_table.syn0))
    assert back.vocab.words() == j.vocab.words()


@pytest.mark.parametrize("pv", [False, True], ids=["word2vec", "pv"])
def test_version_gate(pv, tmp_path):
    """tests/test_nlp.py's version gate, in both readers, on a file either
    package wrote."""
    p = tmp_path / "m.zip"
    if pv:
        js.write_paragraph_vectors(_pv(), p)
    else:
        ts.write_word2vec_model(_w2v()[1], p)
    bad = tmp_path / "bad.zip"
    with zipfile.ZipFile(p) as zin, zipfile.ZipFile(bad, "w") as zout:
        for n in zin.namelist():
            data = zin.read(n)
            if n == "config.json":
                cfg = json.loads(data)
                cfg["format_version"] = 99
                data = json.dumps(cfg).encode()
            zout.writestr(n, data)
    readers = ((js.read_paragraph_vectors, lambda q: ts.read_paragraph_vectors(
        q, device="cpu")) if pv else
        (js.read_word2vec_model, lambda q: ts.read_word2vec_model(
            q, device="cpu")))
    for read in readers:
        with pytest.raises(ValueError, match="format version 99"):
            read(bad)


def test_model_zip_resume_training(tmp_path):
    """tests/test_nlp.py::test_model_zip_resume_training on the port: a
    model read back keeps its vocabulary and trains on from its tables."""
    _, t = _w2v()
    p = tmp_path / "w2v.zip"
    ts.write_word2vec_model(t, p)
    m = ts.read_word2vec_model(p, device="cpu")
    restored = np.array(m.lookup_table.syn0)
    m.set_sentence_iterator(_corpus(60, sent_len=6))
    m.fit()
    assert m.vocab.words() == t.vocab.words()
    assert not np.array_equal(m.lookup_table.syn0, restored)
    assert np.isfinite(m.last_loss) and m.table_device.type == "cpu"


def test_readers_default_to_the_card(tmp_path):
    import torch

    p = tmp_path / "w2v.zip"
    ts.write_word2vec_model(_w2v()[1], p)
    if torch.cuda.is_available():
        assert ts.read_word2vec_model(p).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.read_word2vec_model(p)
