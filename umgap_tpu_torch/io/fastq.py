"""FASTQ reading (reference src/io/fastq.rs).

Multi-line sequences are supported; the quality must span the same
number of lines as the sequence (src/io/fastq.rs:60-77).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, TextIO


class FastqError(ValueError):
    pass


@dataclass
class Record:
    header: str  # without the leading '@'
    sequence: str
    quality: str


def _next_line(it) -> str | None:
    for raw in it:
        line = raw.rstrip("\n")
        if line.endswith("\r"):
            line = line[:-1]
        return line
    return None


def read_records(stream: TextIO) -> Iterator[Record]:
    lines = iter(stream)
    pushed: str | None = None

    def nxt() -> str | None:
        nonlocal pushed
        if pushed is not None:
            line, pushed = pushed, None
            return line
        return _next_line(lines)

    while True:
        header = nxt()
        if header is None:
            return
        if not header.startswith("@"):
            raise FastqError("Expected @ at beginning of fastq header.")
        header = header[1:]

        nseq_lines = 0
        sequence = []
        while True:
            line = nxt()
            if line is None:
                break
            if line.startswith("+"):
                pushed = line
                break
            sequence.append(line)
            nseq_lines += 1

        sep = nxt()
        if sep is not None and not sep.startswith("+"):
            raise FastqError("Expected a + as separator.")

        quality = []
        for _ in range(nseq_lines):
            line = nxt()
            if line is None:
                raise FastqError(
                    "Expected as many quality lines as sequence lines."
                )
            quality.append(line)

        yield Record(header, "".join(sequence), "".join(quality))


def interleave(iterators) -> Iterator[list]:
    """Round-robin interleave, stopping when any source is exhausted
    (reference utils::Zip, src/utils.rs:4-21)."""
    its = [iter(i) for i in iterators]
    while True:
        batch = []
        for it in its:
            try:
                batch.append(next(it))
            except StopIteration:
                return
        yield batch
