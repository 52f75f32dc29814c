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
from .table import PeptideTable, build_kmer_table

JOINKMERS_FACTOR = 0.95


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


def split_kmers_tsv(tsv: bytes, k: int = kmers.DEFAULT_K):
    """(taxid TAB protein) TSV bytes -> (packed uint64 k-mers, int32
    taxids), one row a k-mer, as the JAX package's native splitter makes
    them: the taxid is the line's leading digits, the protein what
    follows the tab."""
    packed: List[np.ndarray] = []
    tids: List[np.ndarray] = []
    for line in tsv.split(b"\n"):
        if line.endswith(b"\r"):
            line = line[:-1]
        digits = len(line) - len(line.lstrip(b"0123456789"))
        tid = int(line[:digits]) if digits else 0
        rest = line[digits:]
        if rest.startswith(b"\t"):
            rest = rest[1:]
        p = kmers.pack_kmers_host(encoding.encode_aa(rest), k)
        if len(p):
            packed.append(p)
            tids.append(np.full(len(p), tid, dtype=np.int32))
    if not packed:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    return np.concatenate(packed), np.concatenate(tids)


def _tree_mix_np(utaxa: np.ndarray, ucounts: np.ndarray, valid: np.ndarray,
                 tax: Taxonomy, factor: float) -> np.ndarray:
    """Tree-hybrid over (G, K) groups of distinct taxa, vectorized
    (src/tree/mix.rs:42-64; ties at a branching node go to the smallest
    child id)."""
    G, K = utaxa.shape
    safe = np.where(valid, np.clip(utaxa, 0, tax.size - 1), 0)
    lin = tax.lineage_rows(safe.reshape(-1)).reshape(G, K, -1)
    D = lin.shape[-1]
    c = np.where(valid, ucounts, 0.0).astype(np.float32)
    x = np.full(G, tax.root, dtype=np.int64)
    base = c.sum(axis=1, dtype=np.float32)
    done = np.zeros(G, dtype=bool)
    i64max = np.iinfo(np.int64).max
    for d in range(D - 1):
        lin_d = lin[:, :, d]
        branch = lin[:, :, d + 1].astype(np.int64)
        below = valid & (branch != NONE) & (lin_d == x[:, None])
        any_below = below.any(axis=1)
        if not (any_below & ~done).any():
            break
        eq = ((branch[:, :, None] == branch[:, None, :])
              & below[:, :, None] & below[:, None, :])
        bsum = np.einsum("gij,gi->gj", eq, c).astype(np.float32)
        bsum = np.where(below, bsum, -np.inf)
        maxsum = bsum.max(axis=1)
        cand = below & (bsum == maxsum[:, None])
        best_branch = np.where(cand, branch, i64max).min(axis=1)
        bmin = np.where(below, branch, i64max).min(axis=1)
        bmax = np.where(below, branch, -1).max(axis=1)
        multi = any_below & (bmin != bmax)
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio_breaks = (maxsum / base) < np.float32(factor)
        descend = ~done & any_below & (~multi | ~ratio_breaks)
        stop = ~done & (~any_below | (multi & ratio_breaks))
        x = np.where(descend, np.where(multi, best_branch, bmin), x)
        base = np.where(descend & multi, maxsum, base).astype(np.float32)
        done |= stop
    return x


def join_kmers_sorted(packed: np.ndarray, tids: np.ndarray, tax: Taxonomy,
                      batch: int = 262_144):
    """joinkmers over ascending packed keys (duplicates form a group),
    vectorized: one lexsort of (key, snapped taxid), distinct pairs
    counted, single-taxon groups snapped directly and the others
    aggregated in batches of one width a bucket of distinct counts
    (4, 16, 64, then the widest). Returns (keys, values)."""
    if len(packed) == 0:
        return packed, np.zeros(0, np.int32)
    validsnap = tax.snapping(ranked_only=False)
    ranksnap = tax.snapping(ranked_only=True)
    in_range = (tids >= 0) & (tids < tax.size)
    snapped = np.where(in_range, validsnap[np.clip(tids, 0, tax.size - 1)],
                       NONE)
    mask = snapped != NONE
    p = packed[mask]
    s = snapped[mask].astype(np.int64)
    if len(p) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    order = np.lexsort((s, p))
    p, s = p[order], s[order]
    pair_new = np.ones(len(p), dtype=bool)
    pair_new[1:] = (p[1:] != p[:-1]) | (s[1:] != s[:-1])
    pair_starts = np.flatnonzero(pair_new)
    pair_counts = np.diff(np.append(pair_starts, len(p))).astype(np.float32)
    pk, pt = p[pair_starts], s[pair_starts]
    grp_new = np.ones(len(pk), dtype=bool)
    grp_new[1:] = pk[1:] != pk[:-1]
    gidx = np.cumsum(grp_new) - 1
    n_groups = int(gidx[-1]) + 1
    grp_starts = np.flatnonzero(grp_new)
    grp_sizes = np.diff(np.append(grp_starts, len(pk)))
    within = np.arange(len(pk)) - grp_starts[gidx]
    keys = pk[grp_starts]
    values = np.zeros(n_groups, dtype=np.int32)
    single = grp_sizes == 1
    values[single] = ranksnap[pt[grp_starts[single]]]
    caps = [4, 16, 64]
    if int(grp_sizes.max()) > caps[-1]:
        caps.append(int(grp_sizes.max()))
    prev = 1
    for cap in caps:
        sel = (grp_sizes > prev) & (grp_sizes <= cap)
        prev = cap
        g_ids = np.flatnonzero(sel)
        if len(g_ids) == 0:
            continue
        lut = np.full(n_groups, -1, dtype=np.int64)
        lut[g_ids] = np.arange(len(g_ids))
        rows_sel = sel[gidx] & (within < cap)
        r, w = lut[gidx[rows_sel]], within[rows_sel]
        utaxa = np.zeros((len(g_ids), cap), dtype=np.int64)
        ucounts = np.zeros((len(g_ids), cap), dtype=np.float32)
        uvalid = np.zeros((len(g_ids), cap), dtype=bool)
        utaxa[r, w] = pt[rows_sel]
        ucounts[r, w] = pair_counts[rows_sel]
        uvalid[r, w] = True
        for lo in range(0, len(g_ids), batch):
            sl = slice(lo, lo + batch)
            agg = _tree_mix_np(utaxa[sl], ucounts[sl], uvalid[sl], tax,
                               JOINKMERS_FACTOR)
            values[g_ids[sl]] = ranksnap[agg]
    return keys, values


def build_kmer_index_fast(tsv: bytes, tax: Taxonomy,
                          k: int = kmers.DEFAULT_K):
    """A k-mer index from (taxid TAB protein) TSV bytes in one pass:
    :func:`split_kmers_tsv`, a stable sort, :func:`join_kmers_sorted`
    and the table build. Returns the :class:`KmerTable`."""
    packed, tids = split_kmers_tsv(tsv, k=k)
    if len(packed) == 0:
        return build_kmer_table(packed, np.zeros(0, np.int32), k=k)
    order = np.argsort(packed, kind="stable")
    keys, values = join_kmers_sorted(packed[order],
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
