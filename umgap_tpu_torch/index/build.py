"""Offline index construction (a copy of ``umgap_tpu.index.build``).

The reference's three-stage build, ``splitkmers | sort | joinkmers |
buildindex`` (src/commands/splitkmers.rs, joinkmers.rs, buildindex.rs),
with the same aggregation (valid-ancestor snap of every row, tree-hybrid
with factor 0.95 over each k-mer's group, ranked snap of the result;
joinkmers.rs:62-80), writing packed hash tables instead of FSTs. The
tables are array for array those of ``umgap_tpu``, so either package
serves what the other builds.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .. import ranks
from ..agg.host import AggError, TreeMix, count as agg_count
from ..ops import encoding, kmers
from ..taxonomy import NONE, Taxonomy
from .scale import (
    JOINKMERS_FACTOR,
    join_kmers_sorted_plain,
    split_kmers_tsv_plain,
)
from .table import PeptideTable, build_kmer_table


def split_kmers(rows: Iterable[Tuple[int, str]], k: int = kmers.DEFAULT_K,
                prefix: str = "") -> Iterator[Tuple[str, int]]:
    """(taxid, protein) rows -> (kmer, taxid) rows
    (src/commands/splitkmers.rs:53-82). With ``prefix`` (one char), only
    the (k-1)-suffixes of the k-mers that start with it."""
    byte = prefix[0] if prefix else None
    for tid, seq in rows:
        if len(seq) < k:
            continue
        for i in range(len(seq) - k + 1):
            kmer = seq[i:i + k]
            if byte is not None:
                if kmer[0] == byte:
                    yield kmer[1:], tid
            else:
                yield kmer, tid


def join_kmers(rows: Iterable[Tuple[str, int]],
               tax: Taxonomy) -> Iterator[Tuple[str, int, str]]:
    """Sorted (kmer, taxid) rows grouped by kmer, each group aggregated
    with tree-hybrid f = 0.95: (kmer, snapped taxon, rank name)
    (src/commands/joinkmers.rs:53-104)."""
    ranksnap = tax.snapping(ranked_only=True)
    validsnap = tax.snapping(ranked_only=False)
    aggregator = TreeMix(tax, JOINKMERS_FACTOR)

    def emit(kmer: str, tids: List[Tuple[int, float]]):
        counts = agg_count(iter(tids))
        if not counts:
            return None
        try:
            aggregate = aggregator.aggregate(counts)
        except AggError:
            return None
        taxon = int(ranksnap[aggregate])
        return kmer, taxon, ranks.rank_name(int(tax.rank[taxon]))

    current: Optional[str] = None
    tids: List[Tuple[int, float]] = []
    for kmer, tid in rows:
        if current is not None and current != kmer:
            out = emit(current, tids)
            if out:
                yield out
            tids = []
        current = kmer
        if 0 <= tid < tax.size:
            snapped = validsnap[tid]
            if snapped != NONE:
                tids.append((int(snapped), 1.0))
    if current is not None:
        out = emit(current, tids)
        if out:
            yield out


def build_kmer_index_fast(tsv: bytes, tax: Taxonomy,
                          k: int = kmers.DEFAULT_K):
    """A k-mer index from (taxid TAB protein) TSV bytes in one pass on
    the host: the plain split and join of :mod:`.scale`
    (``buildindex-dist`` runs them on the card), a stable sort between,
    and the table build. Returns the :class:`KmerTable`."""
    packed, tids = split_kmers_tsv_plain(tsv, k=k)
    if len(packed) == 0:
        return build_kmer_table(packed, np.zeros(0, np.int32), k=k)
    order = np.argsort(packed, kind="stable")
    keys, values = join_kmers_sorted_plain(packed[order],
                                           tids[order].astype(np.int64), tax)
    return build_kmer_table(keys, values, k=k)


def build_table(rows: Iterable[Tuple[str, int]], kind: str = "auto"):
    """Sorted (string, value) rows -> a packed table (buildindex,
    src/commands/buildindex.rs:32-48). ``kind``: "kmer" (keys of one
    length <= 9, packed exactly), "peptide" (fingerprints), or "auto"
    (kmer when every key has one length <= 9). Duplicate keys are
    refused, as the reference's FST builder refuses them."""
    keys: List[str] = []
    values: List[int] = []
    for key, v in rows:
        keys.append(key)
        values.append(int(v))
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate keys in index input")
    vals = np.asarray(values, dtype=np.int32)
    if kind == "auto":
        lens = {len(s) for s in keys}
        kind = ("kmer" if len(lens) == 1 and keys and max(lens) <= 9
                else "peptide")
    if kind == "kmer":
        if not keys:
            return build_kmer_table(np.zeros(0, np.uint64), vals,
                                    k=kmers.DEFAULT_K)
        packed = np.zeros(len(keys), dtype=np.uint64)
        for i, s in enumerate(keys):
            packed[i] = kmers.pack_peptide_host(encoding.encode_aa(s))
        return build_kmer_table(packed, vals, k=len(keys[0]))
    return PeptideTable.build(keys, vals)
