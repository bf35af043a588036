"""Tokenization and sentence iteration.

Counterpart of ``deeplearning4j_tpu/nlp/text.py`` (the reference's
``TokenizerFactory``, ``DefaultTokenizer``, ``CommonPreprocessor``,
``SentenceIterator`` SPIs and ``LabelAwareIterator``), the part the
Word2Vec and ParagraphVectors paths use. Pure Python, on the host: the per-token work is trivial and never belongs on the card.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator, List, Optional, Sequence


class TokenPreProcess:
    """SPI: normalize a single token."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase and strip punctuation and digits."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """One sentence -> token stream."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = [self._pre.pre_process(t) for t in self._tokens]
        return [t for t in out if t]

    def count_tokens(self) -> int:
        return len(self.get_tokens())

    def __iter__(self) -> Iterator[str]:
        return iter(self.get_tokens())


class TokenizerFactory:
    """SPI: sentence -> Tokenizer."""

    def __init__(self) -> None:
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace split."""

    def create(self, sentence: str) -> Tokenizer:
        return Tokenizer(sentence.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Every n-gram for n in ``[min_n, max_n]``, its words joined by one
    space, after the pre-processor (the n-grams themselves are not
    pre-processed)."""

    def __init__(self, min_n: int, max_n: int):
        super().__init__()
        self.min_n, self.max_n = min_n, max_n

    def create(self, sentence: str) -> Tokenizer:
        base = Tokenizer(sentence.split(), self._pre).get_tokens()
        grams = [" ".join(base[i:i + n])
                 for n in range(self.min_n, self.max_n + 1)
                 for i in range(len(base) - n + 1)]
        return Tokenizer(grams, None)


class SentenceIterator:
    """SPI: a restartable stream of sentences. Subclasses implement
    ``__iter__``; ``reset()`` restarts the stream so the vocabulary pass and
    each training pass can scan the corpus again."""

    def __iter__(self) -> Iterator[str]:
        raise NotImplementedError

    def reset(self) -> None:  # default: __iter__ builds a fresh iterator
        pass


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        self._sentences = list(sentences)

    def __iter__(self) -> Iterator[str]:
        return iter(self._sentences)


class LineSentenceIterator(SentenceIterator):
    """One sentence per non-empty line of a UTF-8 text file."""

    def __init__(self, path: str | Path):
        self._path = Path(path)

    def __iter__(self) -> Iterator[str]:
        with open(self._path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line


class FileSentenceIterator(SentenceIterator):
    """Every file under a directory, in sorted path order, one sentence per
    non-empty line."""

    def __init__(self, root: str | Path):
        self._root = Path(root)

    def __iter__(self) -> Iterator[str]:
        for p in sorted(p for p in self._root.rglob("*") if p.is_file()):
            yield from LineSentenceIterator(p)


class LabelAwareIterator(SentenceIterator):
    """A sentence stream with a document label per sentence, for
    ParagraphVectors; the labels default to ``DOC_<i>``."""

    def __init__(self, sentences: Sequence[str],
                 labels: Optional[Sequence[str]] = None):
        if labels is not None and len(labels) != len(sentences):
            raise ValueError("labels and sentences must align")
        self._sentences = list(sentences)
        self._labels = (list(labels) if labels is not None
                        else [f"DOC_{i}" for i in range(len(sentences))])

    def __iter__(self) -> Iterator[str]:
        return iter(self._sentences)

    def labeled(self) -> Iterator[tuple]:
        return iter(zip(self._labels, self._sentences))

    @property
    def labels(self) -> List[str]:
        return list(self._labels)
