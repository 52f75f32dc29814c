"""FASTA/FASTQ readers and writers with reference-equivalent record
semantics."""

from . import fasta, fastq  # noqa: F401
