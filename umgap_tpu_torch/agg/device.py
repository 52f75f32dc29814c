"""Batched per-read aggregation: kernel K4 (``csrc/dedup_counts.cu``) for
the dedup/count and the lower-bound filter, K5 (``ops/gather.py``) for
the table gathers of the stage, K6 (``csrc/tree_aggregate.cu``) for the
tree aggregators and snap, and K9 (``csrc/rmq_aggregate.cu``, through
``agg/device_rmq.py``) for the Euler/RMQ aggregators and snap, each
beside its plain PyTorch version (``umgap_tpu.agg.device``). On the
pipeline's path K6 reads the taxonomy rows of a group's valid hits
itself (:func:`tree_aggregate_hits`), so no :class:`HitGeometry` is
built there, and a batch's tail after seed-extend is two launches: K4
with the bound, then K6 (or K9) with the snap table.

Every read in a batch carries a fixed-width list of (taxon, count) hits;
tree relations are answered by gathers from the device-resident
ancestor-at-depth table. Argmax ties break as in the JAX package and its
host oracle: greater depth, then smaller id. Ancestor incidence is an
integer gather, never a float product, so taxon ids stay exact.

Inside :func:`~umgap_tpu_torch.kernels.plain_versions` the functions of
the stage call the plain versions of K5, K6 and K9 on any device: that is
the reference the kernels are held against on the card. Outside it,
CPU tensors take the plain versions and CUDA tensors the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops import gather
from ..taxonomy import NONE, Taxonomy

I32_MAX = int(np.iinfo(np.int32).max)
WARP_DEDUP_N = 1024  # up to here one warp owns a row; above, a block
# K4's row kernel keeps a row's valid entries in up to this much shared
# memory (kSmemMax in csrc/dedup_counts.cu); a launch whose rows may
# hold more runs this many blocks (two on each of the H100's 132 SMs),
# each with a global scratch row for the rows that do
DEDUP_SMEM_MAX = 200 * 1024
DEDUP_SCRATCH_BLOCKS = 264
# K6 (csrc/tree_aggregate.cu) at K <= TREE_WIDE_K (kWideK) walks a group
# of up to TREE_THREAD_CAP valid hits with one thread (kThreadCap), a
# larger one with a warp; past TREE_WIDE_K a block takes each group (the
# block path), at most TREE_BLOCK_GRID blocks a launch (kBlockGrid). A
# block's list takes 12 bytes a slot (block_list_bytes), in its shared
# memory after a TREE_AUX_BYTES area (kAuxBytes) while both fit
# TREE_SMEM_MAX (kSmemMax), else in a global scratch of one list a block,
# at most TREE_SCRATCH_MAX bytes of it (the launch then runs as many
# blocks as it holds lists)
TREE_THREAD_CAP = 16
TREE_WIDE_K = 64
TREE_BLOCK_GRID = 528
TREE_AUX_BYTES = 2048 * 8
TREE_SMEM_MAX = 226 * 1024
TREE_SCRATCH_MAX = 1 << 28


class DeviceTaxonomy:
    """Taxonomy arrays on one device: ``depth`` (size,), ``anc`` (size, D)
    ancestor at depth, ``geom`` (size, 1 + D) = [depth | anc],
    ``snap_valid`` / ``snap_ranked`` (size,), ``seed_scores`` (size,),
    all int32, and the root id."""

    def __init__(self, depth, anc, geom, snap_valid, snap_ranked, root: int,
                 seed_scores=None):
        self.depth = depth
        self.anc = anc
        self.geom = geom
        self.snap_valid = snap_valid
        self.snap_ranked = snap_ranked
        self.root = int(root)
        self.seed_scores = (torch.zeros_like(snap_valid)
                            if seed_scores is None else seed_scores)

    @property
    def device(self) -> torch.device:
        return self.depth.device

    def to(self, device) -> "DeviceTaxonomy":
        return DeviceTaxonomy(self.depth.to(device), self.anc.to(device),
                              self.geom.to(device), self.snap_valid.to(device),
                              self.snap_ranked.to(device), self.root,
                              self.seed_scores.to(device))

    @classmethod
    def from_arrays(cls, depth, anc, snap_valid, snap_ranked, root: int,
                    seed_scores=None, device=None) -> "DeviceTaxonomy":
        from ..device import resolve_device

        dev = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)

        depth = np.asarray(depth, dtype=np.int32)
        anc = np.asarray(anc, dtype=np.int32)
        return cls(put(depth), put(anc),
                   put(np.concatenate([depth[:, None], anc], axis=1)),
                   put(snap_valid), put(snap_ranked), root,
                   None if seed_scores is None else put(seed_scores))

    @classmethod
    def from_host(cls, tax: Taxonomy, device=None) -> "DeviceTaxonomy":
        return cls.from_arrays(tax.depth, tax.anc_table, tax.snapping(False),
                               tax.snapping(True), tax.root,
                               tax.seed_scores(), device=device)


# ---------------------------------------------------------------------- #
# Per-read hit-list preparation
# ---------------------------------------------------------------------- #

def ordered_run_sums(w: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """Each run's float32 sum of ``w`` (1-D), added one weight at a time
    from the left, as the reference's agg::count adds a taxon's scores
    (src/agg/mod.rs:27-36): runs are contiguous, ``head`` marks their
    first entries (``head[0]`` set). Returns (runs,) float32. Step j adds
    the j-th weight of every run longer than j: with the runs ordered by
    length, those are a prefix, so the steps touch each weight once."""
    n = w.shape[0]
    dev = w.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    starts = torch.nonzero(head, as_tuple=True)[0]
    lens = torch.diff(starts, append=torch.tensor([n], device=dev))
    lens, order = torch.sort(lens, descending=True, stable=True)
    starts = starts[order]
    w = w.to(torch.float32)
    acc = torch.zeros(len(starts), dtype=torch.float32, device=dev)
    # active[j]: how many runs are longer than j
    active = torch.searchsorted(-lens, -torch.arange(
        int(lens[0]), device=dev), right=False).tolist()
    for j, m in enumerate(active):
        acc[:m] = acc[:m] + w[starts[:m] + j]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def first_seen_order(utaxa, ucounts, uvalid, first):
    """A weighted dedup's slots reordered by ``first`` (B, K) int32, each
    slot's first input position (I32_MAX for padding, which stays last):
    every row's taxa in first-seen order, as ``umgap_tpu``'s agg/host.py
    ``count`` keeps them."""
    perm = torch.sort(first, dim=-1, stable=True).indices
    return (torch.gather(utaxa, 1, perm), torch.gather(ucounts, 1, perm),
            torch.gather(uvalid, 1, perm))


def dedup_counts_plain(taxa: torch.Tensor, weights, k_max: int,
                       return_nuniq: bool = False,
                       lower_bound: float | None = None):
    """Plain version of K4, the JAX formulation: sort each row, mark run
    heads, compact them left with a second sort, and take run totals as
    differences of compacted weight prefixes. ``weights=None`` weighs
    every hit 1.0; given weights, a run's total is their sum in input
    order instead (:func:`ordered_run_sums`; the sort is stable), which
    the prefix differences equal only for integer weights, and the kept
    slots come in first-seen order (:func:`first_seen_order`).
    ``lower_bound`` then filters the kept runs (:func:`filter_lower_bound`)."""
    B, N = taxa.shape
    dev = taxa.device
    pos = taxa > 0
    t = torch.where(pos, taxa.to(torch.int32), I32_MAX)
    w = (pos.to(torch.float32) if weights is None
         else torch.where(pos, weights.to(torch.float32), 0.0))
    ts, order = torch.sort(t, dim=-1, stable=True)
    ws = torch.gather(w, 1, order)
    prev = torch.cat([torch.full((B, 1), -1, dtype=ts.dtype, device=dev),
                      ts[:, :-1]], dim=1)
    first = (ts != prev) & (ts != I32_MAX)
    cw = torch.cumsum(ws, dim=-1)
    ecw = cw - ws
    wtot = cw[:, -1:] if N else torch.zeros((B, 1), device=dev)
    K = min(k_max, N)
    runidx = torch.cumsum(first.to(torch.int32), dim=-1) - 1
    slotkey = torch.where(first, runidx, I32_MAX)
    sk, perm = torch.sort(slotkey, dim=-1, stable=True)
    key = torch.gather(ts, 1, perm)
    basec = torch.gather(ecw, 1, perm)
    if N < K + 1:
        extra = K + 1 - N
        sk = torch.nn.functional.pad(sk, (0, extra), value=I32_MAX)
        key = torch.nn.functional.pad(key, (0, extra))
        basec = torch.nn.functional.pad(basec, (0, extra))
    fpos = torch.gather(order, 1, perm[:, :K]).to(torch.int32)
    nxt_filled = sk[:, 1:K + 1] != I32_MAX
    nxt_base = basec[:, 1:K + 1]
    sk, key, base = sk[:, :K], key[:, :K], basec[:, :K]
    cntk = torch.where(nxt_filled, nxt_base, wtot) - base
    filled = sk != I32_MAX
    key = torch.where(filled, key, I32_MAX)
    fpos = torch.where(filled, fpos, I32_MAX)
    if k_max > N:
        extra = k_max - N
        key = torch.nn.functional.pad(key, (0, extra), value=I32_MAX)
        cntk = torch.nn.functional.pad(cntk, (0, extra))
        filled = torch.nn.functional.pad(filled, (0, extra))
        fpos = torch.nn.functional.pad(fpos, (0, extra), value=I32_MAX)
    if weights is not None:
        valid = ts != I32_MAX
        sums = ordered_run_sums(ws[valid], first[valid])
        hr, hc = first.nonzero(as_tuple=True)
        ri = runidx[hr, hc]
        kept = ri < k_max
        cntk = torch.zeros((B, k_max), dtype=torch.float32, device=dev)
        cntk[hr[kept], ri[kept]] = sums[kept]
    cntk = torch.where(filled, cntk, 0.0)
    if lower_bound is not None:
        filled = filter_lower_bound(cntk, filled, lower_bound)
    out = (key.to(torch.int32), cntk, filled)
    if weights is not None:
        out = first_seen_order(*out, fpos)
    if return_nuniq:
        return out + (first.sum(dim=-1, dtype=torch.int32),)
    return out


def dedup_counts_rows_plain(taxa: torch.Tensor, weights, k_max: int,
                            return_nuniq: bool = False,
                            lower_bound: float | None = None):
    """Plain version of K4's row kernel (``csrc/dedup_counts.cu``, rows
    past :data:`WARP_DEDUP_N` hits), its formulation rather than the
    sort of whole rows: compact every row's positive ids with their
    weights, sort those entries alone by (row, id), and take each run's
    head, its rank within its row and its summed weight; a row keeps the
    ranks below ``k_max``. Weighted counts are sums in input order
    (:func:`ordered_run_sums`; the sort is stable), as the kernel adds
    them, and the kept slots come in first-seen order
    (:func:`first_seen_order`). ``lower_bound`` filters the kept runs as
    in :func:`dedup_counts_plain`."""
    B, N = taxa.shape
    dev = taxa.device
    rows, cols = (taxa > 0).nonzero(as_tuple=True)
    ids = taxa[rows, cols].to(torch.int64)
    order = torch.sort((rows << 31) | ids, stable=True).indices
    rows, ids, cols = rows[order], ids[order], cols[order]
    w = (torch.ones(len(ids), dtype=torch.float32, device=dev)
         if weights is None
         else weights[(taxa > 0)][order].to(torch.float32))
    head = torch.ones(len(ids), dtype=torch.bool, device=dev)
    head[1:] = (ids[1:] != ids[:-1]) | (rows[1:] != rows[:-1])
    run = torch.cumsum(head.to(torch.int64), dim=0) - 1
    n_runs = int(head.sum())
    if weights is None:
        counts = torch.zeros(n_runs, dtype=torch.float32, device=dev)
        counts.index_add_(0, run, w)
    else:
        counts = ordered_run_sums(w, head)
    run_row = rows[head]
    nuniq = torch.bincount(run_row, minlength=B).to(torch.int32)
    first = torch.cumsum(nuniq.to(torch.int64), dim=0) - nuniq
    rank = torch.arange(n_runs, device=dev) - first[run_row]
    keep = rank < k_max
    utaxa = torch.full((B, k_max), I32_MAX, dtype=torch.int32, device=dev)
    ucounts = torch.zeros((B, k_max), dtype=torch.float32, device=dev)
    uvalid = torch.zeros((B, k_max), dtype=torch.bool, device=dev)
    r, c = run_row[keep], rank[keep]
    utaxa[r, c] = ids[head][keep].to(torch.int32)
    ucounts[r, c] = counts[keep]
    uvalid[r, c] = True
    if lower_bound is not None:
        uvalid = filter_lower_bound(ucounts, uvalid, lower_bound)
    out = (utaxa, ucounts, uvalid)
    if weights is not None:
        fpos = torch.full((B, k_max), I32_MAX, dtype=torch.int32, device=dev)
        fpos[r, c] = cols[head][keep].to(torch.int32)
        out = first_seen_order(*out, fpos)
    return out + (nuniq,) if return_nuniq else out


def dedup_path(N: int) -> str:
    """K4's path for rows of N hits: ``"warp"`` (one warp per row) up to
    :data:`WARP_DEDUP_N`, ``"rows"`` (one block a row over its valid
    hits alone, :data:`kernels.K4R`) above. Both do work in proportion
    to a row's valid hits."""
    return "warp" if N <= WARP_DEDUP_N else "rows"


def dedup_rows_layout(N: int, weighted: bool):
    """(cap, blocks a launch is limited to or 0, scratch bytes a block)
    of K4's row kernel at N hits a row: a block compacts the row's valid
    entries (4 bytes an id, 8 with a weight) into shared memory, whose
    room is the row's whole width up to DEDUP_SMEM_MAX bytes; past it a
    row with more valid entries than fit sorts them in the block's row of
    a global scratch, and the launch then runs DEDUP_SCRATCH_BLOCKS
    blocks over the rows in turn."""
    entry = 8 if weighted else 4
    cap = min(N, DEDUP_SMEM_MAX // entry)
    if cap == N:
        return cap, 0, 0
    return cap, DEDUP_SCRATCH_BLOCKS, N * entry


def dedup_counts(taxa: torch.Tensor, weights, k_max: int,
                 return_nuniq: bool = False,
                 lower_bound: float | None = None):
    """Per-row frequency table (agg::count plus taxa2agg's tid != 0 drop):
    taxa (B, N) int32, entries <= 0 dropped; weights (B, N) float32 or
    None for 1.0. Returns utaxa (B, k_max) int32 ascending (I32_MAX
    padding), ucounts (B, k_max) float32, uvalid (B, k_max) bool and,
    with ``return_nuniq``, the distinct count per row before truncation
    to the k_max smallest ids. With ``lower_bound``, uvalid is also the
    filter (agg::filter, :func:`filter_lower_bound`): a kept run is valid
    when its count >= the bound; ids, counts and nuniq stay as without
    it. With weights the kept slots come in first-seen order instead
    (:func:`first_seen_order`), the order in which ``umgap_tpu``'s host
    aggregators meet a row's taxa and add their scores.

    CPU tensors take the plain version; CUDA tensors launch K4 (its warp
    path up to WARP_DEDUP_N hits a row, its row kernel K4R above), which
    applies the bound at its stores."""
    if taxa.is_cpu:
        return dedup_counts_plain(taxa, weights, k_max, return_nuniq,
                                  lower_bound)
    B, N = taxa.shape
    if taxa.dtype != torch.int32:
        raise ValueError("dedup_counts: taxa must be int32")
    tensors = [taxa]
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != taxa.shape:
            raise ValueError("dedup_counts: weights must be float32 (B, N)")
        tensors.append(weights)
    kernels.check_cuda("dedup_counts", *tensors)
    dev = taxa.device
    utaxa = torch.empty((B, k_max), dtype=torch.int32, device=dev)
    ucounts = torch.empty((B, k_max), dtype=torch.float32, device=dev)
    uvalid = torch.empty((B, k_max), dtype=torch.bool, device=dev)
    nuniq = torch.empty((B,), dtype=torch.int32, device=dev)
    wptr = 0 if weights is None else weights.data_ptr()
    first = (None if weights is None else
             torch.empty((B, k_max), dtype=torch.int32, device=dev))
    fptr = 0 if first is None else first.data_ptr()
    lb = float("-inf") if lower_bound is None else float(lower_bound)
    if dedup_path(N) == "warp":
        kernels.K4.launch(taxa.data_ptr(), wptr, B, N, k_max, lb,
                          utaxa.data_ptr(), ucounts.data_ptr(),
                          uvalid.data_ptr(), nuniq.data_ptr(),
                          kernels.stream_of(taxa), fptr)
    else:
        cap, blocks, row_bytes = dedup_rows_layout(N, weights is not None)
        scratch = None
        if blocks:
            blocks = min(B, blocks)
            scratch = torch.empty(blocks * row_bytes, dtype=torch.uint8,
                                  device=dev)
        kernels.K4R.launch(taxa.data_ptr(), wptr, B, N, k_max, lb, cap,
                           utaxa.data_ptr(), ucounts.data_ptr(),
                           uvalid.data_ptr(), nuniq.data_ptr(),
                           0 if scratch is None else scratch.data_ptr(),
                           blocks, kernels.stream_of(taxa), fptr)
    out = (utaxa, ucounts, uvalid)
    if first is not None:
        out = first_seen_order(*out, first)
    return out + (nuniq,) if return_nuniq else out


def filter_lower_bound(ucounts, uvalid, lower_bound: float):
    """agg::filter (src/agg/mod.rs:39-44): keep counts >= bound."""
    return uvalid & (ucounts >= torch.tensor(lower_bound,
                                             dtype=torch.float32))


# ---------------------------------------------------------------------- #
# Shared geometry
# ---------------------------------------------------------------------- #

class HitGeometry(NamedTuple):
    lin: torch.Tensor     # (B, K, D) ancestor rows
    depth: torch.Tensor   # (B, K) depths (0 where invalid)
    # (B, K, K): [b, i, j] = taxon i anc-or-self of j; None when the
    # geometry was built without it (tree hybrid never reads it)
    is_anc: torch.Tensor | None
    valid: torch.Tensor   # (B, K)


def needs_ancestry(method: str, strategy: str) -> bool:
    """Whether the aggregation reads :attr:`HitGeometry.is_anc`."""
    return (method, strategy) in (("tree", "lca*"), ("rmq", "mrtl"))


def hit_geometry(dtax: DeviceTaxonomy, utaxa, uvalid,
                 ancestry: bool = True) -> HitGeometry:
    """One row gather of [depth | ancestors] per hit, then, with
    ``ancestry``, ``is_anc[b, i, j] = (lin[b, j, dep[b, i]] == utaxa[b, i])
    & uvalid[b, i] & uvalid[b, j]``: the JAX package's one-hot contraction
    and compare (device.py:170-199) as K5's ancestry epilogue, which
    writes the bool incidence directly (no (B, K, K) index or int32
    gather output is stored)."""
    _take, rows_of, _along, anc = gather.active()
    size = dtax.depth.shape[0]
    safe = torch.where(uvalid, utaxa.clamp(0, size - 1), 0)
    rows = rows_of(dtax.geom, safe)         # (B, K, 1 + D)
    lin = rows[..., 1:]
    dep = torch.where(uvalid, rows[..., 0], 0).clamp(min=0)
    if not ancestry:
        return HitGeometry(lin, dep, None, uvalid)
    return HitGeometry(lin, dep, anc(lin, dep, utaxa, uvalid), uvalid)


def exact_sums(c: torch.Tensor) -> bool:
    """Whether every sum of entries of a row of ``c`` is exact in float32
    whatever the order of its adds: integer values whose magnitudes add
    up to at most 2^24 a row, as the pipeline's counts are. Weighted
    counts (taxa2agg -s) need not be, and then the plain aggregators add
    as ``umgap_tpu``'s host aggregators do, over slots in first-seen
    order (:func:`np_sum`, :func:`fold_sum`), as K6's ordered instances
    do."""
    if c.numel() == 0:
        return True
    return bool((c == c.trunc()).all()) and float(
        c.abs().double().sum(dim=-1).max()) <= 2.0 ** 24


def fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in float32 one entry at a time in index
    order, from 0.0: how numpy reduces a 2-D array over axis 0, so how
    ``umgap_tpu``'s RmqRTL adds a score and RmqMix its weights, and how
    K6's ordered mrtl and ``rmq_mix_batch(..., ordered=True)`` add
    (elementwise adds, which round alike on the CPU and the card)."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        s = s + x[..., k]
    return s


def _pairwise(x: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise float32 sum of the last dim (umath's
    pairwise_sum): below 8 terms one at a time from 0.0; up to 128 eight
    accumulators over strides of 8, combined as ((r0 + r1) + (r2 + r3))
    + ((r4 + r5) + (r6 + r7)), then the tail one at a time; past 128 the
    halves split at n / 2 rounded down to a multiple of 8."""
    n = x.shape[-1]
    if n < 8:
        return fold_sum(x)
    if n <= 128:
        m = n - n % 8
        r = x[..., :8]
        for i in range(8, m, 8):
            r = r + x[..., i:i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + \
            ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(m, n):
            res = res + x[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(x[..., :n2]) + _pairwise(x[..., n2:])


def np_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last dim as numpy's ``a.sum(dtype=float32)``
    adds a 1-D array (its identity 0.0 plus :func:`_pairwise`): how
    ``umgap_tpu``'s TreeMix adds a group's counts and a branch's."""
    return torch.zeros((), dtype=x.dtype, device=x.device) + _pairwise(x)


def segment_np_sums(values: torch.Tensor, seg: torch.Tensor,
                    n_seg: int) -> torch.Tensor:
    """(n_seg,) float32: each segment's :func:`np_sum` over its entries of
    ``values`` (1-D) in their order there; ``seg`` (int64, same length)
    names each entry's segment. Segments of one length go together."""
    dev = values.device
    out = torch.zeros(n_seg, dtype=torch.float32, device=dev)
    if values.numel() == 0:
        return out
    order = torch.sort(seg, stable=True).indices
    v = values[order].to(torch.float32)
    lens = torch.bincount(seg, minlength=n_seg)
    starts = torch.cumsum(lens, 0) - lens
    for n in torch.unique(lens[lens > 0]).tolist():
        ids = torch.nonzero(lens == n, as_tuple=True)[0]
        idx = starts[ids][:, None] + torch.arange(n, device=dev)
        out[ids] = np_sum(v[idx])
    return out


def _argmax_tiebreak(utaxa, depth, valid, scores):
    """Max score, then max depth, then min taxon id."""
    s = torch.where(valid, scores, float("-inf"))
    smax = s.max(dim=-1, keepdim=True).values
    cand = valid & (s == smax)
    d = torch.where(cand, depth, -1)
    dmax = d.max(dim=-1, keepdim=True).values
    cand = cand & (d == dmax)
    return torch.where(cand, utaxa, I32_MAX).min(dim=-1).values


# ---------------------------------------------------------------------- #
# Aggregators
# ---------------------------------------------------------------------- #

def tree_lca_plain(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa):
    """Plain version of K6 for LCA* (reference src/tree/lca.rs): the
    deepest input if all inputs lie on one chain, else the LCA of all
    inputs."""
    B, K, D = geom.lin.shape
    valid = geom.valid
    dom = (geom.is_anc | ~valid[:, :, None]).all(dim=1) & valid
    any_dom = dom.any(dim=-1)
    dom_depth = torch.where(dom, geom.depth, -1)
    jstar = torch.argmax(dom_depth, dim=-1)
    chain_result = torch.gather(utaxa, 1, jstar[:, None])[:, 0]

    first_valid = torch.argmax(valid.to(torch.int32), dim=-1)
    ref = geom.lin[torch.arange(B, device=utaxa.device), first_valid]
    eq = (geom.lin == ref[:, None, :]) | ~valid[:, :, None]
    all_eq = eq.all(dim=1) & (ref != NONE)
    dpos = torch.arange(D, device=utaxa.device, dtype=torch.int32)
    dstar = torch.argmax(torch.where(all_eq, dpos[None, :], -1), dim=-1)
    lca_result = torch.gather(ref, 1, dstar[:, None])[:, 0]
    return torch.where(any_dom, chain_result, lca_result)


def rtl_plain(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts):
    """Plain version of K6 for MRTL (reference src/rmq/rtl.rs:39-57):
    score of input j = summed counts of inputs that are ancestors-or-self
    of j; argmax. Counts that are not :func:`exact_sums` are added as
    ``umgap_tpu``'s RmqRTL adds them (and K6's ordered instances): j's
    ancestors one at a time in slot order, first-seen order for a
    weighted dedup's slots (:func:`fold_sum`)."""
    c = torch.where(geom.valid, ucounts, 0.0)
    terms = torch.where(geom.is_anc, c[:, :, None], 0.0)   # (B, i, j)
    if exact_sums(c):
        scores = terms.sum(dim=1)
    else:
        scores = fold_sum(terms.transpose(1, 2))
    return _argmax_tiebreak(utaxa, geom.depth, geom.valid, scores)


def tree_mix_plain(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts,
                   factor: float):
    """Plain version of K6 for tree hybrid (reference
    src/tree/mix.rs:42-64) as a depth-bounded descent: collapse chains
    freely; at a branching node descend into the heaviest branch while
    its share of the current chain value is >= factor (ties -> smallest
    branch id). Branch sums are taken one depth at a time, a (B, K, K)
    compare each, instead of the JAX package's hoisted (B, D-1, K, K)
    tensor. Counts that are not :func:`exact_sums` are added as
    ``umgap_tpu``'s TreeMix adds them (and K6's ordered instances):
    numpy's pairwise order over the valid slots in slot order, first-seen
    order for a weighted dedup's slots, and for a branch over its slots
    below x (:func:`segment_np_sums`)."""
    B, K, D = geom.lin.shape
    dev = utaxa.device
    c = torch.where(geom.valid, ucounts, 0.0)
    if not exact_sums(c):
        return _tree_mix_ordered(dtax, geom, ucounts, factor)
    total = (lambda x: x.sum(dim=-1))
    x = torch.full((B,), dtax.root, dtype=torch.int32, device=dev)
    a_base = total(c)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    fac = torch.tensor(factor, dtype=torch.float32, device=dev)
    neg = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    for d in range(D - 1):
        lin_d = geom.lin[:, :, d]
        branch = geom.lin[:, :, d + 1]
        below = geom.valid & (branch != NONE) & (lin_d == x[:, None])
        any_below = below.any(dim=-1)
        same = branch[:, :, None] == branch[:, None, :]
        bsum = total(torch.where(same, c[:, None, :], 0.0))
        bsum = torch.where(below, bsum, neg)
        maxsum = bsum.max(dim=-1).values
        cand = below & (bsum == maxsum[:, None])
        best_branch = torch.where(cand, branch, I32_MAX).min(dim=-1).values
        bmin = torch.where(below, branch, I32_MAX).min(dim=-1).values
        bmax = torch.where(below, branch, -1).max(dim=-1).values
        multi = any_below & (bmin != bmax)
        ratio_breaks = (maxsum / a_base) < fac
        descend = ~done & any_below & (~multi | ~ratio_breaks)
        stop = ~done & (~any_below | (multi & ratio_breaks))
        nx = torch.where(descend, torch.where(multi, best_branch, bmin), x)
        a_base = torch.where(descend & multi, maxsum, a_base)
        x = nx.to(torch.int32)
        done = done | stop
    return x


def _tree_mix_ordered(dtax: DeviceTaxonomy, geom: HitGeometry, ucounts,
                      factor: float):
    """:func:`tree_mix_plain` for counts that are not exact sums, adding
    as TreeMix (umgap_tpu/agg/host.py) adds: a_base is numpy's sum of the
    valid counts in slot order, a branch's sum numpy's sum of its slots
    below x in slot order."""
    B, K, D = geom.lin.shape
    dev = ucounts.device
    rows = torch.arange(B, device=dev)[:, None].expand(B, K)
    valid = geom.valid
    a_base = segment_np_sums(ucounts[valid], rows[valid], B)
    x = torch.full((B,), dtax.root, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    fac = torch.tensor(factor, dtype=torch.float32, device=dev)
    for d in range(D - 1):
        branch = geom.lin[:, :, d + 1]
        below = valid & (branch != NONE) & (geom.lin[:, :, d] == x[:, None])
        any_below = below.any(dim=-1)
        if not (any_below & ~done).any():
            break
        pairs = torch.stack([rows[below], branch[below].long()], dim=1)
        keys, inv = torch.unique(pairs, dim=0, return_inverse=True)
        sums = segment_np_sums(ucounts[below], inv, len(keys))
        bsum = torch.full((B, K), float("-inf"), dtype=torch.float32,
                          device=dev)
        bsum[below] = sums[inv]
        maxsum = bsum.max(dim=-1).values
        cand = below & (bsum == maxsum[:, None])
        best = torch.where(cand, branch, I32_MAX).min(dim=-1).values
        bmin = torch.where(below, branch, I32_MAX).min(dim=-1).values
        bmax = torch.where(below, branch, -1).max(dim=-1).values
        multi = any_below & (bmin != bmax)
        ratio_breaks = (maxsum / a_base) < fac
        descend = ~done & any_below & (~multi | ~ratio_breaks)
        stop = ~done & (~any_below | (multi & ratio_breaks))
        x = torch.where(descend, torch.where(multi, best, bmin),
                        x).to(torch.int32)
        a_base = torch.where(descend & multi, maxsum, a_base)
        done = done | stop
    return x


TREE_STRATEGIES = {"hybrid": 0, "lca*": 1, "mrtl": 2}


def tree_aggregate_plain(strategy: str, dtax: DeviceTaxonomy,
                         geom: HitGeometry, utaxa, ucounts=None,
                         factor: float = 0.25):
    """Plain version of K6: the strategy's plain aggregator."""
    if strategy == "lca*":
        return tree_lca_plain(dtax, geom, utaxa)
    if strategy == "mrtl":
        return rtl_plain(dtax, geom, utaxa, ucounts)
    return tree_mix_plain(dtax, geom, utaxa, ucounts, factor)


def tree_path(n_valid: int, K: int) -> str:
    """K6's path for a group of ``n_valid`` valid hits among K slots: at
    K <= :data:`TREE_WIDE_K`, ``"thread"`` (one thread walks the group)
    up to :data:`TREE_THREAD_CAP`, ``"warp"`` (a warp compacts and walks
    it) above; past it ``"block"`` (a block compacts the group, and walks
    it unless the group has at most TREE_THREAD_CAP valid hits, which
    its first thread walks). The kernel chooses per group from K and its
    mask."""
    if K > TREE_WIDE_K:
        return "block"
    return "thread" if n_valid <= TREE_THREAD_CAP else "warp"


def tree_list_bytes(K: int) -> int:
    """Bytes of one block's list of K slots on K6's block path."""
    return 12 * ((K + 3) & ~3)


def tree_scratch_blocks(B: int, K: int) -> int:
    """Lists of K6's global scratch for B groups of K slots: 0 while a
    block's list fits its shared memory (and at K <= TREE_WIDE_K), else
    one a block of the launch, as many as TREE_SCRATCH_MAX bytes hold
    and at most the launch's blocks."""
    if K <= TREE_WIDE_K or TREE_AUX_BYTES + tree_list_bytes(K) \
            <= TREE_SMEM_MAX:
        return 0
    return min(B, TREE_BLOCK_GRID,
               max(1, TREE_SCRATCH_MAX // tree_list_bytes(K)))


def tree_scratch_bytes(B: int, K: int) -> int:
    """Global scratch K6 needs for B groups of K slots (see
    :func:`tree_scratch_blocks`)."""
    return tree_scratch_blocks(B, K) * tree_list_bytes(K)


def tree_aggregate(strategy: str, dtax: DeviceTaxonomy, geom: HitGeometry,
                   utaxa, ucounts=None, factor: float = 0.25):
    """The tree aggregators on a :class:`HitGeometry` (this batch's
    :func:`hit_geometry`), (B,) int32: ``strategy`` is ``"hybrid"`` (with
    ``factor``), ``"lca*"`` or ``"mrtl"``; hybrid and mrtl need
    ``ucounts``.

    CPU tensors take :func:`tree_aggregate_plain` on the geometry; CUDA
    tensors run :func:`tree_aggregate_hits` on its valid mask, which
    reads the same rows from the table."""
    if utaxa.device.type == "cpu":
        return tree_aggregate_plain(strategy, dtax, geom, utaxa, ucounts,
                                    factor)
    return tree_aggregate_hits(strategy, dtax, utaxa, ucounts, geom.valid,
                               factor)


def tree_aggregate_hits_plain(strategy: str, dtax: DeviceTaxonomy, utaxa,
                              ucounts, uvalid, factor: float = 0.25,
                              snap=None):
    """Plain version of :func:`tree_aggregate_hits`: the plain
    :func:`hit_geometry` (with the ancestry test for lca* and mrtl), then
    :func:`tree_aggregate_plain` and, with ``snap``,
    :func:`snap_taxa_plain`."""
    with kernels.plain_versions():
        geom = hit_geometry(dtax, utaxa, uvalid, strategy != "hybrid")
        agg = tree_aggregate_plain(strategy, dtax, geom, utaxa, ucounts,
                                   factor)
    return agg if snap is None else snap_taxa_plain(snap, agg, uvalid)


def tree_aggregate_wide_plain(strategy: str, dtax: DeviceTaxonomy, utaxa,
                              ucounts, uvalid, factor: float = 0.25,
                              snap=None):
    """K6's block path (groups past K = 64) as plain PyTorch, a group at
    a time, for the tests to hold that formulation to the JAX package's
    aggregators; the pipeline never calls it. Takes and returns what
    :func:`tree_aggregate_hits` does.

    lca* and mrtl: the group's distinct valid ids sorted, each with its
    summed counts (mrtl) or multiplicity (lca*) and clamped depth; id j
    scores the entries found (``torch.searchsorted``) at lin_j[d] whose
    clamped depth is d. hybrid: the descent over the valid slots, the
    branch sums of each depth taken over the slots below x, the list
    cut to x's subtree after each descent. Sums add as ``umgap_tpu``'s
    host aggregators and K6's ordered instances do: hybrid in numpy's
    pairwise order over slots (:func:`np_sum`), and mrtl, for counts
    that are not exact sums, one slot at a time in slot order over every
    valid slot (:func:`fold_sum`). ``snap`` as in
    :func:`tree_aggregate_hits_plain`."""
    if snap is not None:
        return snap_taxa_plain(snap, tree_aggregate_wide_plain(
            strategy, dtax, utaxa, ucounts, uvalid, factor), uvalid)
    geom = dtax.geom
    size, W = geom.shape
    D = W - 1
    dev = utaxa.device
    fac = torch.tensor(factor, dtype=torch.float32)
    out = []
    for b in range(utaxa.shape[0]):
        ids = utaxa[b][uvalid[b]]
        cnt = (torch.ones(len(ids), dtype=torch.float32, device=dev)
               if strategy == "lca*" else ucounts[b][uvalid[b]])
        if strategy == "hybrid":
            out.append(_wide_mix(geom, ids, cnt, dtax.root, fac))
            continue
        if len(ids) == 0:
            ref = geom[0, 1:]  # lca*: slot 0's row, table row 0
            ok = torch.nonzero(ref != NONE)
            out.append(I32_MAX if strategy == "mrtl"
                       else int(ref[int(ok[-1]) if len(ok) else 0]))
            continue
        if strategy == "mrtl" and not exact_sums(cnt[None]):
            rows = geom[ids.clamp(0, size - 1)]
            lin, dep = rows[:, 1:], rows[:, 0].clamp(min=0)
            # slot i an ancestor-or-self of slot j: lin_j[dep_i] == id_i
            anc = lin[:, dep.clamp(max=D - 1)].T == ids[:, None]
            score = fold_sum(torch.where(anc, cnt[:, None], 0.0).T)
            out.append(int(_argmax_tiebreak(ids[None], dep[None], torch.ones(
                (1, len(ids)), dtype=torch.bool, device=dev), score[None])))
            continue
        u, inv = torch.unique(ids, sorted=True, return_inverse=True)
        s = torch.zeros(len(u), dtype=torch.float32, device=dev)
        s.index_add_(0, inv, cnt)
        rows = geom[u.clamp(0, size - 1)]
        lin, dep = rows[:, 1:], rows[:, 0].clamp(min=0)
        at = torch.searchsorted(u, lin.contiguous()).clamp(max=len(u) - 1)
        found = (u[at] == lin) & (dep.clamp(max=D - 1)[at] == torch.arange(
            D, device=dev))
        score = fold_sum(torch.where(found, s[at], 0.0))
        if strategy == "mrtl":
            out.append(int(_argmax_tiebreak(u[None], dep[None], torch.ones(
                (1, len(u)), dtype=torch.bool, device=dev), score[None])))
            continue
        dom = score == len(ids)
        if dom.any():
            dd = torch.where(dom, dep, -1)
            out.append(int(u[dom & (dd == dd.max())].min()))
            continue
        ref = geom[ids[0].clamp(0, size - 1), 1:]
        agree = (lin == ref).all(dim=0) & (ref != NONE)
        ok = torch.nonzero(agree)
        out.append(int(ref[int(ok[-1]) if len(ok) else 0]))
    return torch.tensor(out, dtype=torch.int32, device=dev)


def _wide_mix(geom, ids, cnt, root: int, fac):
    """hybrid on one group's valid ids and counts (see
    :func:`tree_aggregate_wide_plain`)."""
    size, W = geom.shape
    lin = geom[ids.clamp(0, size - 1), 1:]
    x = root
    a_base = np_sum(cnt)
    for d in range(W - 2):
        br = lin[:, d + 1]
        below = (br != NONE) & (lin[:, d] == x)
        if not below.any():
            break
        bb = br[below]
        if bb.min() != bb.max():
            keys, inv = torch.unique(bb, return_inverse=True)
            # each branch's counts below x in numpy's order over slots
            sums = segment_np_sums(cnt[below], inv, len(keys))
            mx = sums.max()
            if (mx / a_base) < fac:
                break
            x = int(keys[sums == mx].min())
            a_base = mx
        else:
            x = int(bb[0])
        keep = lin[:, d + 1] == x
        lin, cnt = lin[keep], cnt[keep]
    return x


def tree_aggregate_hits(strategy: str, dtax: DeviceTaxonomy, utaxa, ucounts,
                        uvalid, factor: float = 0.25, snap=None,
                        ordered: bool = False):
    """The tree aggregators on a batch's filtered hit lists, (B,) int32:
    utaxa (B, K) int32, ucounts (B, K) float32 (unused by lca*, may be
    None) and uvalid (B, K) bool. Equal to
    ``tree_aggregate_plain(strategy, dtax, hit_geometry(dtax, utaxa,
    uvalid, strategy != "hybrid"), utaxa, ucounts, factor)``, and with
    ``snap`` (a snap table, (S,) int32: ``dtax.snap_valid`` on the
    pipeline's path) to :func:`snap_taxa_plain` of that: the group's
    taxon as taxa2agg ends.

    CPU tensors take :func:`tree_aggregate_hits_plain`; CUDA tensors
    launch K6 once, which reads the valid hits' rows of ``dtax.geom``
    itself (no (B, K, D) or (B, K, K) tensor is built) and snaps each
    result at its store. Past K = 64 a block takes each group; lists too
    wide for its shared memory (K > 17,920) go to a scratch of
    :func:`tree_scratch_bytes`. ``ordered``: counts that are not integers
    (taxa2agg -s, slots in first-seen order), which hybrid and mrtl then
    add as ``umgap_tpu``'s host aggregators and the plain versions do
    (K6's ordered instances); integer counts sum exactly in any order and
    take the main path's instances."""
    if utaxa.is_cpu:
        return tree_aggregate_hits_plain(strategy, dtax, utaxa, ucounts,
                                         uvalid, factor, snap)
    geom = dtax.geom
    size, W = geom.shape
    if utaxa.dim() != 2 or utaxa.shape[1] == 0 or W < 2:
        raise ValueError("tree_aggregate_hits: empty hit lists or "
                         "lineages")
    if geom.dtype != torch.int32 or not geom.is_contiguous():
        raise ValueError("tree_aggregate_hits: dtax.geom must be "
                         "contiguous int32")
    if ucounts is None and strategy != "lca*":
        raise ValueError(f"tree_aggregate_hits: {strategy} needs ucounts")
    B, K = utaxa.shape
    want = [(uvalid, torch.bool), (utaxa, torch.int32)]
    if ucounts is not None:
        want.append((ucounts, torch.float32))
    for t, dt in want:
        if t.dtype != dt or tuple(t.shape) != (B, K):
            raise ValueError(f"tree_aggregate_hits: {tuple(t.shape)} "
                             f"{t.dtype}, expected {(B, K)} {dt}")
    tables = [geom]
    if snap is not None:
        if snap.dtype != torch.int32 or snap.dim() != 1 or not len(snap):
            raise ValueError("tree_aggregate_hits: snap must be a "
                             "non-empty (S,) int32 table")
        tables.append(snap)
    kernels.check_cuda("tree_aggregate", *(t for t, _ in want), *tables)
    out = torch.empty((B,), dtype=torch.int32, device=utaxa.device)
    blocks = tree_scratch_blocks(B, K)
    scratch = (torch.empty(blocks * tree_list_bytes(K), dtype=torch.uint8,
                           device=utaxa.device) if blocks else None)
    kernels.K6.launch(
        TREE_STRATEGIES[strategy], geom.data_ptr(), size, W,
        0 if ucounts is None else ucounts.data_ptr(), uvalid.data_ptr(),
        utaxa.data_ptr(), B, K, dtax.root, float(factor),
        0 if scratch is None else scratch.data_ptr(), blocks,
        out.data_ptr(), 0 if snap is None else snap.data_ptr(),
        0 if snap is None else len(snap), int(ordered),
        kernels.stream_of(utaxa))
    return out


def tree_lca_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa):
    """LCA* (reference src/tree/lca.rs) through K6 (plain on the CPU)."""
    return tree_aggregate("lca*", dtax, geom, utaxa)


def rtl_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts):
    """MRTL (reference src/rmq/rtl.rs:39-57) through K6 (plain on the
    CPU)."""
    return tree_aggregate("mrtl", dtax, geom, utaxa, ucounts)


def tree_mix_batch(dtax: DeviceTaxonomy, geom: HitGeometry, utaxa, ucounts,
                   factor: float):
    """Tree hybrid (reference src/tree/mix.rs:42-64) through K6 (plain on
    the CPU)."""
    return tree_aggregate("hybrid", dtax, geom, utaxa, ucounts, factor)


def snap_batch(snapping: torch.Tensor, taxa: torch.Tensor, default: int = 0):
    """Nearest snapped ancestors (a K5 1-D take); out-of-range and
    unsnappable ids give ``default``. The pipeline snaps in K6's or K9's
    store instead."""
    take = gather.active()[0]
    size = snapping.shape[0]
    s = take(snapping, taxa.clamp(0, size - 1))
    ok = (taxa >= 0) & (taxa < size) & (s != NONE)
    return torch.where(ok, s, default)


def snap_taxa_plain(snap: torch.Tensor, agg: torch.Tensor,
                    uvalid: torch.Tensor) -> torch.Tensor:
    """The end of taxa2agg (umgap_tpu/pipeline/fused.py:122-124) as the
    plain version of K6's and K9's store: snap (S,) int32
    (``dtax.snap_valid``), agg (B,) int32, uvalid (B, K) bool -> taxon
    (B,) int32: :func:`snap_batch` with default 0 (its take's plain
    version), then 1 where a group has no valid hit."""
    with kernels.plain_versions():
        snapped = snap_batch(snap, agg, 0)
    return torch.where(uvalid.any(dim=-1), snapped, 1).to(torch.int32)


# taxa2agg's device matrix (src/commands/taxa2agg.rs:111-140); the first
# three are K6's tree aggregators
GEOMETRY_AGGREGATIONS = (("tree", "lca*"), ("tree", "hybrid"),
                         ("rmq", "mrtl"))
SUPPORTED_AGGREGATIONS = GEOMETRY_AGGREGATIONS + (("rmq", "lca*"),
                                                  ("rmq", "hybrid"))


def aggregate_batch(dtax: DeviceTaxonomy, utaxa, ucounts, uvalid,
                    method: str, strategy: str, factor: float = 0.25,
                    euler=None, snap=None, ordered: bool = False):
    """taxa2agg's dispatch over the full matrix
    (src/commands/taxa2agg.rs:111-140). ``rmq``/``lca*`` needs a
    :class:`~umgap_tpu_torch.agg.device_rmq.DeviceEuler`. The tree
    aggregators and rmq/mrtl run :func:`tree_aggregate_hits` (K6),
    rmq/lca* and rmq/hybrid
    :func:`~umgap_tpu_torch.agg.device_rmq.rmq_aggregate` (K9) on the hit
    lists, one launch each. With ``snap`` (a snap table) the result is
    snapped as taxa2agg ends, in the kernel's store. ``ordered`` for
    counts that are not integers (taxa2agg -s): their sums then follow
    ``umgap_tpu``'s order, the plain versions', on the card too."""
    key = (method, strategy)
    plain = kernels.plain_selected()
    if key in (("rmq", "lca*"), ("rmq", "hybrid")):
        from .device_rmq import rmq_aggregate, rmq_aggregate_plain

        if key == ("rmq", "lca*") and euler is None:
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        return (rmq_aggregate_plain if plain else rmq_aggregate)(
            strategy, dtax, euler, utaxa, ucounts, uvalid, factor, snap,
            ordered)
    if key not in GEOMETRY_AGGREGATIONS:
        raise ValueError(
            f"device aggregation does not support {method}/{strategy}")
    strat = "mrtl" if method == "rmq" else strategy
    if plain:
        return tree_aggregate_hits_plain(strat, dtax, utaxa, ucounts, uvalid,
                                         factor, snap)
    return tree_aggregate_hits(strat, dtax, utaxa, ucounts, uvalid, factor,
                               snap, ordered)
