"""WordVectorSerializer: the interchange formats of word vectors.

Counterpart of ``deeplearning4j_tpu/nlp/serializer.py`` (the reference's
``loader/WordVectorSerializer``), byte for byte, so that a file written by
either package reads in the other:

- **text**: an optional ``V D`` header line, then one ``word f1 ... fD`` line
  per word, each value formatted ``{x:.6g}``;
- **binary** (word2vec.c's ``.bin``): the ASCII header ``V D\\n``, then per
  word its utf-8 bytes, a space, D little-endian float32 and ``\\n``;
- **the model zip** (``write_word2vec_model`` / ``read_word2vec_model``, and
  the ParagraphVectors pair): ``config.json``, ``vocab.json`` (words and
  counts in index order), ``tables.npz`` (syn0, syn1, syn1neg as present)
  and, for ParagraphVectors, ``labels.json``; a fit of the model read back
  resumes from its tables. The readers refuse another ``format_version``.

The tables are numpy on the host. A model read back trains on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Union

import numpy as np

from .lookup_table import InMemoryLookupTable
from .vocab import VocabCache, VocabWord, build_huffman
from .word2vec import Word2Vec, WordVectors

PathLike = Union[str, Path]

_FORMAT_VERSION = 1


# -- flat vector formats --------------------------------------------------

def write_word_vectors(model: WordVectors, path: PathLike,
                       binary: bool = False, header: bool = True) -> None:
    """``model``'s vectors as text (``header``: the ``V D`` line first) or
    word2vec.c binary. The matrix is ``get_word_vector_matrix()``: syn0, or
    FastText's subword means, or GloVe's w + w~."""
    syn0 = np.asarray(model.get_word_vector_matrix(), dtype=np.float32)
    words = model.vocab.words()
    if binary:
        with open(path, "wb") as f:
            f.write(f"{len(words)} {syn0.shape[1]}\n".encode())
            for i, w in enumerate(words):
                f.write(w.encode("utf-8") + b" ")
                f.write(syn0[i].tobytes())
                f.write(b"\n")
    else:
        with open(path, "w", encoding="utf-8") as f:
            if header:
                f.write(f"{len(words)} {syn0.shape[1]}\n")
            for i, w in enumerate(words):
                vec = " ".join(f"{x:.6g}" for x in syn0[i])
                f.write(f"{w} {vec}\n")


def read_word_vectors(path: PathLike, binary: bool = False) -> WordVectors:
    """Vectors written as text (with or without the header line) or binary,
    as a query-only :class:`WordVectors` (counts of 1)."""
    if binary:
        with open(path, "rb") as f:
            header = f.readline().decode().split()
            V, D = int(header[0]), int(header[1])
            vocab = VocabCache()
            syn0 = np.zeros((V, D), dtype=np.float32)
            for i in range(V):
                chars = []
                while True:
                    ch = f.read(1)
                    if ch == b" " or ch == b"":
                        break
                    if ch != b"\n":
                        chars.append(ch)
                word = b"".join(chars).decode("utf-8")
                syn0[i] = np.frombuffer(f.read(4 * D), dtype="<f4")
                nl = f.read(1)
                if nl not in (b"\n", b""):
                    f.seek(-1, io.SEEK_CUR)
                vocab.add(VocabWord(word, 1))
    else:
        with open(path, "r", encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        first = lines[0].split()
        if len(first) == 2 and all(tok.isdigit() for tok in first):
            V, D = int(first[0]), int(first[1])
            lines = lines[1:]
        else:
            V, D = len(lines), len(first) - 1
        vocab = VocabCache()
        syn0 = np.zeros((V, D), dtype=np.float32)
        for i, ln in enumerate(lines):
            parts = ln.split(" ")
            vocab.add(VocabWord(parts[0], 1))
            syn0[i] = np.asarray(parts[1:], dtype=np.float32)
    table = InMemoryLookupTable(len(vocab), syn0.shape[1])
    table.syn0 = syn0
    return WordVectors(vocab, table)


# -- full-model zip container ---------------------------------------------

#: the configuration keys both zips carry, then each one's own
_COMMON_KEYS = ("layer_size", "window", "learning_rate", "min_learning_rate",
                "negative", "use_hierarchic_softmax", "sampling",
                "min_word_frequency", "iterations", "epochs", "batch_size",
                "seed")
_WORD2VEC_KEYS = _COMMON_KEYS + ("algorithm",)
_PV_KEYS = _COMMON_KEYS + ("dm", "train_word_vectors")


def _write_zip(model, path: PathLike, keys, labels=None) -> None:
    """``config.json`` (``format_version`` and ``keys`` of ``model``, in
    that order), ``vocab.json``, ``labels.json`` when given, and
    ``tables.npz``."""
    config = {"format_version": _FORMAT_VERSION}
    for k in keys:
        config[k] = getattr(model, "use_hs" if k == "use_hierarchic_softmax"
                            else k)
    vocab_rows = [{"word": model.vocab.entry_at(i).word,
                   "count": model.vocab.entry_at(i).count}
                  for i in range(len(model.vocab))]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("config.json", json.dumps(config))
        z.writestr("vocab.json", json.dumps(vocab_rows))
        if labels is not None:
            z.writestr("labels.json", json.dumps(labels))
        arrays = {"syn0": np.asarray(model.lookup_table.syn0)}
        if model.lookup_table.syn1 is not None:
            arrays["syn1"] = np.asarray(model.lookup_table.syn1)
        if model.lookup_table.syn1neg is not None:
            arrays["syn1neg"] = np.asarray(model.lookup_table.syn1neg)
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        z.writestr("tables.npz", buf.getvalue())


def _read_zip(path: PathLike, make, what: str, with_labels: bool = False):
    """The model ``make(**config)`` of a zip, its vocabulary (the Huffman
    tree rebuilt from the counts under hierarchical softmax) and tables
    restored, and the labels (or None). Raises on another
    ``format_version``."""
    with zipfile.ZipFile(path, "r") as z:
        config = json.loads(z.read("config.json"))
        version = config.pop("format_version", None)
        if version != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported {what} format version {version!r} "
                f"(supported: {_FORMAT_VERSION})")
        vocab_rows = json.loads(z.read("vocab.json"))
        labels = json.loads(z.read("labels.json")) if with_labels else None
        npz = np.load(io.BytesIO(z.read("tables.npz")))
        model = make(**config)
        vocab = VocabCache()
        for row in vocab_rows:
            vocab.add(VocabWord(row["word"], row["count"]))
        model.vocab = vocab
        if model.use_hs:
            build_huffman(model.vocab)
        table = InMemoryLookupTable(len(vocab), config["layer_size"],
                                    seed=config["seed"])
        table.syn0 = npz["syn0"]
        table.syn1 = npz["syn1"] if "syn1" in npz else None
        table.syn1neg = npz["syn1neg"] if "syn1neg" in npz else None
        model.lookup_table = table
        return model, labels


def write_word2vec_model(model: Word2Vec, path: PathLike) -> None:
    """``model``'s configuration, vocabulary and tables as a model zip."""
    _write_zip(model, path, _WORD2VEC_KEYS)


def read_word2vec_model(path: PathLike, device=None) -> Word2Vec:
    """The Word2Vec of a model zip on ``device`` (the card by default); its
    next ``fit`` resumes from the tables."""
    model, _ = _read_zip(path, lambda **c: Word2Vec(device=device, **c),
                         "word2vec model")
    return model


def write_paragraph_vectors(model, path: PathLike) -> None:
    """A ParagraphVectors zip: the word2vec payload plus the PV
    configuration (dm, train_word_vectors) and the labels, so that
    :func:`read_paragraph_vectors` restores label lookups,
    ``nearest_labels`` and ``infer_vector``."""
    _write_zip(model, path, _PV_KEYS,
               [model.vocab.word_for(i) for i in model._label_ids])


def read_paragraph_vectors(path: PathLike, device=None):
    """The ParagraphVectors of a zip written by
    :func:`write_paragraph_vectors`, its labels restored, on ``device`` (the
    card by default)."""
    from .paragraph_vectors import ParagraphVectors

    model, labels = _read_zip(
        path, lambda **c: ParagraphVectors(device=device, **c),
        "paragraph-vectors", with_labels=True)
    model._label_ids = [model.vocab.index_of(lb) for lb in labels]
    model._special_tokens = labels
    return model


# reference spellings
writeParagraphVectors = write_paragraph_vectors
readParagraphVectors = read_paragraph_vectors
