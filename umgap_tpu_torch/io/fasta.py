"""FASTA reading/writing.

Record semantics match the reference (src/io/fasta.rs):

- a record is one ``>header`` line plus *all* following non-header lines
  as separate sequence items (``unwrap=True`` concatenates them into a
  single item, src/io/fasta.rs:62-64);
- the writer joins sequence items with a configurable separator, can
  hard-wrap at 70 columns, and reproduces the reference's empty-sequence
  quirks exactly (src/io/fasta.rs:158-177): an empty joined sequence
  yields ``>header\\n`` without wrap and ``>header`` (no newline!) with
  wrap.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, TextIO

FASTA_WIDTH = 70


class FastaError(ValueError):
    pass


@dataclass
class Record:
    """A FASTA record: header (without '>') and sequence items."""

    header: str
    sequence: List[str] = field(default_factory=list)

    def joined(self, separator: str = "") -> str:
        return separator.join(self.sequence)


def read_records(stream: TextIO, unwrap: bool = False) -> Iterator[Record]:
    """Stream records. ``unwrap=True`` concatenates sequence lines into a
    single item (src/io/fasta.rs:30-35,62-64)."""
    header: str | None = None
    seq: List[str] = []
    for raw in stream:
        line = raw.rstrip("\n")
        if line.endswith("\r"):
            line = line[:-1]
        if line.startswith(">"):
            if header is not None:
                yield Record(header, ["".join(seq)] if unwrap else seq)
            header = line[1:]
            seq = []
        else:
            if header is None:
                raise FastaError("Expected > at beginning of fasta header.")
            seq.append(line)
    if header is not None:
        yield Record(header, ["".join(seq)] if unwrap else seq)


def read_chunks(
    stream: TextIO, chunk_size: int, unwrap: bool = False
) -> Iterator[List[Record]]:
    """Chunked record iterator (src/io/fasta.rs:115-138)."""
    chunk: List[Record] = []
    for rec in read_records(stream, unwrap):
        chunk.append(rec)
        if len(chunk) >= chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


class Writer:
    """FASTA writer (src/io/fasta.rs:140-181)."""

    def __init__(self, stream: TextIO, separator: str = "", wrap: bool = False):
        self.stream = stream
        self.separator = separator
        self.wrap = wrap

    def write_record(self, record: Record):
        out = self.stream
        out.write(">" + record.header)
        sequence = self.separator.join(record.sequence)
        if not self.wrap:
            out.write("\n")
            out.write(sequence)
        else:
            for i in range(0, len(sequence), FASTA_WIDTH):
                out.write("\n")
                out.write(sequence[i : i + FASTA_WIDTH])
        if sequence:
            out.write("\n")

    def write_records(self, records: Iterable[Record]):
        for r in records:
            self.write_record(r)
