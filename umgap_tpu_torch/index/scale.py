"""joinkmers at scale, and the TSV split that feeds it (the counterpart
of ``umgap_tpu.index.scale`` and of ``umgap_tpu.io.native``'s
``split_kmers_tsv``).

The reference builds its index as a batch job, ``splitkmers | sort |
joinkmers | buildindex`` (scripts/build-index-phanpy.hpc.sh:1-10,
src/commands/joinkmers.rs:53-104). ``buildindex-dist``
(:mod:`~umgap_tpu_torch.index.distbuild`) runs its split and its join
here, on the card unless the caller asks for the CPU:

* :func:`split_kmers_tsv`: the chunk's bytes are parsed on the host with
  numpy over the whole buffer (newlines, the leading taxid digits, the
  tab, residues encoded by one table lookup); kernel K1P
  (:func:`~umgap_tpu_torch.ops.kmers.proteins_to_kmers`) packs every
  k-window of the proteins, in batches of one length class bounded in
  padded cells (a 35,000-residue protein pads none but its class).
  Rows come in line order, then window order, those of ``umgap_tpu``'s
  native splitter.
* :func:`join_kmers_sorted`: the exact joinkmers semantics (valid-ancestor
  snap of every row, tree-hybrid f = 0.95 over each k-mer's distinct
  taxa and counts, ranked snap of the result), one step for each of
  ``umgap_tpu``'s: the snap by a gather, a lexicographic sort of (key,
  snapped taxon) as two stable sorts (a 45-bit key and a taxon id do not
  fit one 63-bit key), distinct pairs and groups by segment diffs,
  single-taxon groups by one gather of the ranked snap, and the others as
  (G, K) rows of distinct taxa and float32 counts, bucketed 4 / 16 / 64
  / widest, through kernel K6
  (:func:`~umgap_tpu_torch.agg.device.tree_aggregate_hits`, hybrid, with
  the ranked snap at its store; past 64 distinct taxa its block path).
  Counts are integers, so K6's unordered instances sum them exactly. A
  shard too large for the card is joined in pieces split by ranges of
  the key, so that no group spans two pieces and the pieces' outputs
  follow each other in ascending key order.

:func:`split_kmers_tsv_plain` and :func:`join_kmers_sorted_plain` (numpy)
are the plain versions, which the tests and ``chip_smoke.py`` hold the
entry points to.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops import encoding, kmers
from ..taxonomy import NONE, Taxonomy

JOINKMERS_FACTOR = 0.95
# the join's buckets of distinct taxa a group (then the widest)
GROUP_CAPS = (4, 16, 64)
# slots (rows x K) of one K6 launch on the card; on the CPU K6's plain
# version builds (rows, K, K) compares, bounded by CPU_CELLS
CARD_SLOTS = 1 << 24
CPU_CELLS = 1 << 22
# a piece's rows on the card: this share of the free memory (two workers
# may share a card) at this many bytes a row
CARD_MEM_SHARE = 0.3
CARD_ROW_BYTES = 128
# the split's protein batches: at most this many proteins, and padded
# cells (proteins x widest), as CHUNK_CELLS bounds the stream commands'
SPLIT_PROTEINS = 65_536
SPLIT_CELLS = 1 << 24


# ---------------------------------------------------------------------- #
# The TSV split
# ---------------------------------------------------------------------- #

def split_kmers_tsv_plain(tsv: bytes, k: int = kmers.DEFAULT_K):
    """(taxid TAB protein) TSV bytes -> (packed uint64 k-mers, int32
    taxids), one row a k-mer, a line at a time, as ``umgap_tpu``'s native
    splitter (``umgap_tpu.io.native.split_kmers_tsv``) makes them: the
    taxid is the line's leading digits, the protein what follows one
    tab."""
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
            tids.append(np.full(len(p), np.int64(tid).astype(np.int32),
                                dtype=np.int32))
    if not packed:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    return np.concatenate(packed), np.concatenate(tids)


def parse_tsv(tsv: bytes):
    """The proteins of (taxid TAB protein) TSV bytes, on the host over the
    whole buffer: (codes, starts, lengths, tids), the AA codes of the
    buffer (one table lookup), each line's protein start and length in
    it, and its taxid (the leading digits, wrapped to int32 as the native
    splitter casts them)."""
    buf = np.frombuffer(tsv, dtype=np.uint8)
    n = len(buf)
    nl = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], nl + 1]).astype(np.int64)
    ends = np.concatenate([nl, [n]]).astype(np.int64)
    keep = starts < ends
    starts, ends = starts[keep], ends[keep]
    cr = buf[np.maximum(ends - 1, 0)] == 13
    ends = ends - cr
    tid = np.zeros(len(starts), dtype=np.int64)
    dend = starts.copy()
    on = dend < ends
    while on.any():  # a digit a step, the lines still in their digits
        c = buf[np.where(on, dend, 0)]
        on &= (c >= 48) & (c <= 57)
        with np.errstate(over="ignore"):
            tid = np.where(on, tid * 10 + (c.astype(np.int64) - 48), tid)
        dend = dend + on
        on &= dend < ends
    tab = (dend < ends) & (buf[np.minimum(dend, max(n - 1, 0))] == 9)
    pstart = dend + tab
    lengths = ends - pstart
    codes = encoding.AA_FROM_BYTE[buf]
    return codes, pstart, lengths, tid.astype(np.int32)


def _protein_batches(lengths: np.ndarray, k: int):
    """Batches of the proteins with at least k residues: by length class
    (the power of 2 at or above a protein's length, so that padding at
    most doubles a batch's cells), each at most SPLIT_PROTEINS proteins
    and SPLIT_CELLS padded cells (one protein at least). Index arrays,
    in line order within a batch."""
    idx = np.flatnonzero(lengths >= k)
    cls = np.ceil(np.log2(lengths[idx])).astype(np.int64)
    idx = idx[np.argsort(cls, kind="stable")]
    cls = np.sort(cls, kind="stable")
    batches = []
    for c in np.unique(cls):
        members = idx[cls == c]
        width = int(lengths[members].max())
        step = max(1, min(SPLIT_PROTEINS, SPLIT_CELLS // width))
        batches += [members[i:i + step] for i in range(0, len(members), step)]
    return batches


def split_kmers_tsv(tsv: bytes, k: int = kmers.DEFAULT_K, device=None):
    """(packed uint64 k-mers, int32 taxids) of (taxid TAB protein) TSV
    bytes, equal to :func:`split_kmers_tsv_plain`: the host parse
    (:func:`parse_tsv`), then K1P over batches of proteins of one length
    class (:func:`_protein_batches`), each batch's rows put at its
    proteins' places in line order, on ``device`` (the card unless the
    CPU is asked for; CPU tensors take K1P's plain version)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    codes, pstart, lengths, tids = parse_tsv(tsv)
    nwin = np.maximum(lengths - (k - 1), 0)
    first = np.cumsum(nwin) - nwin  # each protein's first row
    total = int(nwin.sum())
    packed_out = np.zeros(total, np.uint64)
    tid_out = np.zeros(total, np.int32)
    for sel in _protein_batches(lengths, k):
        L = lengths[sel]
        P = int(L.max())
        # the residues alone, scattered into the zero-padded lanes
        step = np.repeat(np.arange(len(sel)) * P - (np.cumsum(L) - L), L)
        cells = np.arange(int(L.sum()))
        aa = np.zeros((len(sel), P), np.uint8)
        aa.reshape(-1)[step + cells] = codes[
            np.repeat(pstart[sel] - (np.cumsum(L) - L), L) + cells]
        hi, lo, valid = kmers.proteins_to_kmers(
            torch.from_numpy(aa).to(dev),
            torch.from_numpy(L.astype(np.int32)).to(dev), k)
        keys = ((hi.to(torch.int64) << 25) | lo.to(torch.int64))[valid]
        # the batch's rows, protein by protein in window order
        n = nwin[sel]
        dest = np.repeat(first[sel] - (np.cumsum(n) - n), n) + np.arange(
            int(n.sum()))
        packed_out[dest] = keys.cpu().numpy().view(np.uint64)
        tid_out[dest] = np.repeat(tids[sel], n)
    return packed_out, tid_out


# ---------------------------------------------------------------------- #
# The join
# ---------------------------------------------------------------------- #

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


def join_kmers_sorted_plain(packed: np.ndarray, tids: np.ndarray,
                            tax: Taxonomy, batch: int = 262_144):
    """joinkmers over packed keys (duplicates form a group), numpy:
    one lexsort of (key, snapped taxid), distinct pairs counted,
    single-taxon groups snapped directly and the others aggregated in
    batches of one width a bucket of distinct counts (4, 16, 64, then the
    widest). Returns (keys ascending, values)."""
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
    caps = list(GROUP_CAPS)
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


def _join_piece(p, t, dtax):
    """The join of one piece's rows on their device: ``p`` int64 keys,
    ``t`` int64 taxids (any order). Returns (keys int64, values int32)
    tensors, keys ascending."""
    import torch

    from ..agg.device import tree_aggregate_hits

    dev = p.device
    size = dtax.snap_valid.shape[0]
    in_range = (t >= 0) & (t < size)
    s = torch.where(in_range, dtax.snap_valid[t.clamp(0, size - 1)], NONE)
    keep = s != NONE
    p, s = p[keep], s[keep].to(torch.int64)
    if p.numel() == 0:
        return p, torch.zeros(0, dtype=torch.int32, device=dev)
    o = torch.sort(s, stable=True).indices  # (key, taxon): two stable sorts
    p, s = p[o], s[o]
    o = torch.sort(p, stable=True).indices
    p, s = p[o], s[o]
    n = p.numel()
    pair_new = torch.ones(n, dtype=torch.bool, device=dev)
    pair_new[1:] = (p[1:] != p[:-1]) | (s[1:] != s[:-1])
    pair_starts = torch.nonzero(pair_new, as_tuple=True)[0]
    ends = torch.cat([pair_starts[1:], torch.tensor([n], device=dev)])
    pair_counts = (ends - pair_starts).to(torch.float32)
    pk, pt = p[pair_starts], s[pair_starts]
    m = pk.numel()
    grp_new = torch.ones(m, dtype=torch.bool, device=dev)
    grp_new[1:] = pk[1:] != pk[:-1]
    gidx = torch.cumsum(grp_new.to(torch.int64), 0) - 1
    grp_starts = torch.nonzero(grp_new, as_tuple=True)[0]
    n_groups = grp_starts.numel()
    gends = torch.cat([grp_starts[1:], torch.tensor([m], device=dev)])
    grp_sizes = gends - grp_starts
    within = torch.arange(m, device=dev) - grp_starts[gidx]
    keys = pk[grp_starts]
    values = torch.zeros(n_groups, dtype=torch.int32, device=dev)
    single = grp_sizes == 1
    values[single] = dtax.snap_ranked[pt[grp_starts[single]]]
    caps = list(GROUP_CAPS)
    widest = int(grp_sizes.max())
    if widest > caps[-1]:
        caps.append(widest)
    prev = 1
    for cap in caps:
        sel = (grp_sizes > prev) & (grp_sizes <= cap)
        prev = cap
        g_ids = torch.nonzero(sel, as_tuple=True)[0]
        G = g_ids.numel()
        if G == 0:
            continue
        lut = torch.full((n_groups,), -1, dtype=torch.int64, device=dev)
        lut[g_ids] = torch.arange(G, device=dev)
        # the bucket's pairs, by group (r ascending) and slot (w)
        rows = torch.nonzero(sel[gidx], as_tuple=True)[0]
        r, w = lut[gidx[rows]], within[rows]
        step = (max(1, CARD_SLOTS // cap) if dev.type == "cuda"
                else max(1, CPU_CELLS // (cap * cap)))
        # a step of groups is filled and launched at a time, so that the
        # padded (groups, cap) cells stay within one launch's
        cuts = torch.searchsorted(r, torch.arange(
            0, G + step, step, device=dev)).tolist()
        for i, lo in enumerate(range(0, G, step)):
            n = min(step, G - lo)
            a, b = cuts[i], cuts[i + 1]
            rr, ww = r[a:b] - lo, w[a:b]
            utaxa = torch.zeros((n, cap), dtype=torch.int32, device=dev)
            ucounts = torch.zeros((n, cap), dtype=torch.float32, device=dev)
            uvalid = torch.zeros((n, cap), dtype=torch.bool, device=dev)
            utaxa[rr, ww] = pt[rows[a:b]].to(torch.int32)
            ucounts[rr, ww] = pair_counts[rows[a:b]]
            uvalid[rr, ww] = True
            values[g_ids[lo:lo + n]] = tree_aggregate_hits(
                "hybrid", dtax, utaxa, ucounts, uvalid, JOINKMERS_FACTOR,
                dtax.snap_ranked)
    return keys, values


def piece_bounds(packed: np.ndarray, piece_rows: int) -> np.ndarray:
    """Ascending key bounds that cut ``packed`` into pieces of about
    ``piece_rows`` rows (quantiles of a sample): piece i holds the keys
    in [bounds[i - 1], bounds[i]), so every group lies in one piece and
    the pieces follow each other in key order."""
    n_pieces = -(-len(packed) // max(1, piece_rows))
    if n_pieces <= 1:
        return np.zeros(0, np.uint64)
    step = max(1, len(packed) // 1_000_000)
    sample = np.sort(packed[::step])
    at = (np.arange(1, n_pieces) * len(sample)) // n_pieces
    return np.unique(sample[at])


def card_piece_rows(dev) -> int:
    """Rows of one piece the card joins at once: CARD_MEM_SHARE of the
    device's free memory over CARD_ROW_BYTES a row (keys, taxids, the
    snap, the two sorts' values, indices and temporaries, the pairs), so
    that two workers on one card both fit; all of them on the CPU. The
    padded groups add at most one step's (CARD_SLOTS cells) to that."""
    import torch

    if dev.type != "cuda":
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(dev)
    return max(1 << 20, int(free * CARD_MEM_SHARE) // CARD_ROW_BYTES)


def join_kmers_sorted(packed: np.ndarray, tids: np.ndarray, tax: Taxonomy,
                      device=None, dtax=None, piece_rows: int | None = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """joinkmers over packed keys (uint64, duplicates form a group; any
    order) and their taxids: (keys ascending, values int32), array for
    array :func:`join_kmers_sorted_plain` and ``umgap_tpu``'s
    ``index.scale.join_kmers_sorted``. Runs on ``device`` (the card
    unless the CPU is asked for) through K6, with ``dtax`` (a
    :class:`~umgap_tpu_torch.agg.device.DeviceTaxonomy` of ``tax`` on
    that device) if given. Rows past ``piece_rows`` (by default what the
    card's free memory holds, :func:`card_piece_rows`) are joined in
    pieces (:func:`piece_bounds`). CPU tensors take K6's plain
    version."""
    import torch

    from ..agg.device import DeviceTaxonomy
    from ..device import resolve_device

    dev = resolve_device(device)
    if len(packed) == 0:
        return packed, np.zeros(0, np.int32)
    if dtax is None:
        dtax = DeviceTaxonomy.from_host(tax, dev)
    if piece_rows is None:
        piece_rows = card_piece_rows(dev)
    packed = np.ascontiguousarray(packed, dtype=np.uint64)
    tids = np.asarray(tids)
    bounds = piece_bounds(packed, piece_rows)
    piece = (np.searchsorted(bounds, packed, side="right")
             if len(bounds) else None)
    keys_out, vals_out = [], []
    for i in range(len(bounds) + 1):
        sel = slice(None) if piece is None else piece == i
        p = torch.from_numpy(packed[sel].view(np.int64)).to(dev)
        t = torch.from_numpy(tids[sel].astype(np.int64)).to(dev)
        k, v = _join_piece(p, t, dtax)
        keys_out.append(k.cpu().numpy().view(np.uint64))
        vals_out.append(v.cpu().numpy())
    return np.concatenate(keys_out), np.concatenate(vals_out)
