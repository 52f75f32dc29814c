"""FASTA/FASTQ readers and writers with reference-equivalent record
semantics, gzip sniffing, and (:mod:`.native`) the native ingest."""

from . import fasta, fastq  # noqa: F401


def sniff_open(path: str, mode: str = "rt"):
    """Open a possibly-gzipped file by magic-byte sniffing (the
    reference pipelines accept gzipped FASTQ, umgap-analyse.sh:159-175
    via `file --mime-type` + zcat FIFOs)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(path, mode)
    return open(path, mode)
