"""RecordReader SPI + file splits (DataVec core analog).

Counterpart of ``deeplearning4j_tpu/data/records.py``, copied: plain Python and
numpy, so the same inputs give the same records and arrays in both
packages.

Reference: datavec-api ``org.datavec.api.records.reader.RecordReader`` with
``CSVRecordReader`` / ``LineRecordReader`` / ``CSVSequenceRecordReader`` and
``org.datavec.api.split.{FileSplit, CollectionInputSplit}`` (SURVEY.md §2.3
DataVec core row).

A record is a plain Python list of cell values (the reference's
``List<Writable>``); a sequence record is a list of records. Readers are
restartable iterators over an input split — host-side pure Python, feeding
the vectorized DataSet assembly in ``record_iterator.py``.
"""

from __future__ import annotations

import csv
import io
from pathlib import Path
from typing import Any, Iterator, List, Optional, Sequence, Union

Record = List[Any]
SequenceRecord = List[Record]
PathLike = Union[str, Path]


class InputSplit:
    """Source-of-URIs SPI (reference: org.datavec.api.split.InputSplit)."""

    def locations(self) -> List[Path]:
        raise NotImplementedError


class FileSplit(InputSplit):
    """All files under a root (or a single file), optionally filtered by
    extension, sorted for determinism (reference: FileSplit)."""

    def __init__(self, root: PathLike,
                 allowed_extensions: Optional[Sequence[str]] = None,
                 recursive: bool = True):
        self.root = Path(root)
        self.allowed = (tuple(e.lower().lstrip(".") for e in
                              allowed_extensions)
                        if allowed_extensions else None)
        self.recursive = recursive

    def locations(self) -> List[Path]:
        if self.root.is_file():
            return [self.root]
        pattern = "**/*" if self.recursive else "*"
        files = [p for p in self.root.glob(pattern) if p.is_file()]
        if self.allowed is not None:
            files = [p for p in files
                     if p.suffix.lower().lstrip(".") in self.allowed]
        return sorted(files)


class CollectionInputSplit(InputSplit):
    def __init__(self, paths: Sequence[PathLike]):
        self._paths = [Path(p) for p in paths]

    def locations(self) -> List[Path]:
        return list(self._paths)


class RecordReader:
    """One record at a time from an input split (reference: RecordReader —
    initialize(split) / hasNext / next / reset)."""

    def initialize(self, split: InputSplit) -> None:
        self._split = split
        self.reset()

    def reset(self) -> None:
        self._iter = self._make_iter()

    def has_next(self) -> bool:
        if not hasattr(self, "_peek"):
            try:
                self._peek = next(self._iter)
            except StopIteration:
                return False
        return True

    def next(self) -> Record:
        if self.has_next():
            rec = self._peek
            del self._peek
            return rec
        raise StopIteration

    def __iter__(self) -> Iterator[Record]:
        self.reset()
        while self.has_next():
            yield self.next()

    def _make_iter(self) -> Iterator[Record]:
        raise NotImplementedError


class LineRecordReader(RecordReader):
    """One line → one single-cell record (reference: LineRecordReader)."""

    def _make_iter(self) -> Iterator[Record]:
        for path in self._split.locations():
            with open(path, "r", encoding="utf-8", errors="replace") as f:
                for line in f:
                    yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """CSV rows → records of string cells (reference: CSVRecordReader —
    skip_num_lines for headers, configurable delimiter/quote)."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ",",
                 quote: str = '"'):
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter
        self.quote = quote

    def _make_iter(self) -> Iterator[Record]:
        for path in self._split.locations():
            with open(path, "r", encoding="utf-8", newline="") as f:
                reader = csv.reader(f, delimiter=self.delimiter,
                                    quotechar=self.quote)
                for i, row in enumerate(reader):
                    if i < self.skip_num_lines or not row:
                        continue
                    yield list(row)


class SequenceRecordReader(RecordReader):
    """SPI for time-series readers: next_sequence() yields a list of
    records (reference: SequenceRecordReader)."""

    def next_sequence(self) -> SequenceRecord:
        raise NotImplementedError

    def sequences(self) -> Iterator[SequenceRecord]:
        self.reset()
        while self.has_next():
            yield self.next_sequence()


class CSVSequenceRecordReader(SequenceRecordReader):
    """One CSV file per sequence (reference: CSVSequenceRecordReader)."""

    def __init__(self, skip_num_lines: int = 0, delimiter: str = ","):
        self.skip_num_lines = skip_num_lines
        self.delimiter = delimiter

    def _make_iter(self) -> Iterator[SequenceRecord]:
        for path in self._split.locations():
            with open(path, "r", encoding="utf-8", newline="") as f:
                reader = csv.reader(f, delimiter=self.delimiter)
                seq = [list(row) for i, row in enumerate(reader)
                       if i >= self.skip_num_lines and row]
            if seq:
                yield seq

    def next_sequence(self) -> SequenceRecord:
        return self.next()


class CollectionRecordReader(RecordReader):
    """In-memory records (reference: CollectionRecordReader) — used by
    TransformProcess results and tests."""

    def __init__(self, records: Sequence[Record]):
        self._records = [list(r) for r in records]
        self.reset()

    def initialize(self, split: Optional[InputSplit] = None) -> None:
        self.reset()

    def _make_iter(self) -> Iterator[Record]:
        return iter([list(r) for r in self._records])
