"""The Euler-tour aggregators on the device (a port of
``umgap_tpu.agg.device_rmq``): rmq/lca* and rmq/hybrid.

On CUDA tensors :func:`rmq_aggregate` launches K9
(``csrc/rmq_aggregate.cu``) once a batch: the aggregate of every group
and taxa2agg's snap at its store. Its plain version,
:func:`rmq_aggregate_plain`, is the PyTorch formulation below with
:func:`~umgap_tpu_torch.agg.device.snap_taxa_plain` after it: the CPU's
path and the reference K9 is held against on the card.

``rmq_lca_batch`` reproduces the reference's Euler-tour RMQ walk with
join levels (src/rmq/lca.rs:60-90) position for position: the device
holds the same tour, block-minimum and sparse tables as the host
:class:`~umgap_tpu_torch.agg.rmq.RMQ` (block 64, the same tie rules),
and every read's walk advances in lockstep, one hit slot per step (the
JAX package's ``lax.scan`` as a Python loop of tensor ops). Hit lists
are visited in ascending taxon order, as ``dedup_counts`` emits them.

``rmq_mix_batch`` computes the LCA-closure hybrid (src/rmq/mix.rs:55-95)
in taxon space: pairwise LCAs from lineage agreement counts (a plain
depth sum, by the tree's prefix property) and the closure's weights
from two ancestor tests.

Their table reads go through K5's plain versions when
:func:`rmq_aggregate_plain` runs them (inside
:func:`~umgap_tpu_torch.kernels.plain_versions`); called alone on CUDA
tensors they take K5 (``ops/gather.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops import gather
from ..taxonomy import NONE, Taxonomy
from .device import (
    I32_MAX,
    DeviceTaxonomy,
    _argmax_tiebreak,
    fold_sum,
    snap_taxa_plain,
)
from .rmq import BLOCK, RMQ, _LOG2_BLOCK

# 2^1 .. 2^30: floor(log2(v)) of an int32 v >= 1 is the count of these <= v
_POW2 = [1 << k for k in range(1, 31)]


class DeviceEuler:
    """Euler tour and RMQ tables on one device, all int32: ``tour`` and
    ``depths`` (T,), ``first`` (size,) first occurrence (-1 when not on
    the tour), ``block_min`` (nb,) argmin per 64-block, ``sparse``
    (nlevels or 1, nb) sparse argmin table, kept flat in
    ``sparse_flat``."""

    def __init__(self, tour, depths, first, block_min, sparse,
                 nlevels: int, tour_len: int):
        self.tour = tour
        self.depths = depths
        self.first = first
        self.block_min = block_min
        self.sparse = sparse
        self.sparse_flat = sparse.reshape(-1)
        self.nlevels = int(nlevels)
        self.tour_len = int(tour_len)

    @property
    def device(self) -> torch.device:
        return self.tour.device

    def to(self, device) -> "DeviceEuler":
        return DeviceEuler(self.tour.to(device), self.depths.to(device),
                           self.first.to(device), self.block_min.to(device),
                           self.sparse.to(device), self.nlevels,
                           self.tour_len)

    @classmethod
    def from_arrays(cls, tour, depths, first, block_min, sparse,
                    nlevels: int, tour_len: int, device=None) -> "DeviceEuler":
        """From integer arrays (a host build, or the JAX package's
        ``DeviceEuler`` leaves brought back to the host)."""
        from ..device import resolve_device

        dev = resolve_device(device)

        def put(x):
            return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)

        return cls(put(tour), put(depths), put(first), put(block_min),
                   put(np.atleast_2d(sparse)), nlevels, tour_len)

    @classmethod
    def from_host(cls, tax: Taxonomy, device=None) -> "DeviceEuler":
        tour, depths, first = tax.euler_tour()
        rmq = RMQ(depths)
        nb = len(rmq.block_min)
        levels = rmq.sparse
        sparse = np.zeros((max(len(levels), 1), nb), dtype=np.int32)
        for j, lv in enumerate(levels):
            sparse[j, : len(lv)] = lv
        return cls.from_arrays(tour, depths, first, rmq.block_min, sparse,
                               len(levels), len(tour), device=device)


def _min_in_blocks(euler: DeviceEuler, bases, bounds, take):
    """Leftmost argmin of depths[left..=right] within one 64-block, for
    several (left, right) ranges that share a block: ``bases`` (B, R) the
    blocks' starts, ``bounds`` a list of (left, right) pairs of (B,)
    tensors, one per range, each inside its block. One take of the R
    blocks serves every range."""
    offs = torch.arange(BLOCK, dtype=torch.int32, device=bases.device)
    pos = bases[:, :, None] + offs                      # (B, R, 64)
    d = take(euler.depths, pos.clamp(0, euler.tour_len - 1))
    out = []
    for r, (left, right) in bounds:
        p = pos[:, r]
        inside = (p >= left[:, None]) & (p <= right[:, None])
        dr = torch.where(inside, d[:, r], I32_MAX)
        out.append(bases[:, r] + torch.argmin(dr, dim=-1).to(torch.int32))
    return out


def rmq_query_batch(euler: DeviceEuler, start, end):
    """The reference's RMQ::query position semantics, batched
    (src/rmq/mod.rs:121-156, agg.rmq.RMQ.query): start, end (B,) int32
    tour positions."""
    take = gather.active()[0]
    left = torch.minimum(start, end)
    right = torch.maximum(start, end)
    lblock = left >> _LOG2_BLOCK
    rblock = right >> _LOG2_BLOCK
    bdiff = rblock - lblock
    lbase, rbase = lblock << _LOG2_BLOCK, rblock << _LOG2_BLOCK
    l, one, r = _min_in_blocks(
        euler, torch.stack([lbase, rbase], dim=1),
        [(0, (left, lbase + (BLOCK - 1))), (0, (left, right)),
         (1, (rbase, right))], take)

    nb = euler.block_min.shape[0]
    col = (lblock + 1).clamp(0, nb - 1)
    m2 = take(euler.block_min, col)
    v = torch.clamp(bdiff - 1, min=1)
    ilog = (v[:, None] >= torch.tensor(_POW2, dtype=torch.int32,
                                       device=v.device)).sum(
        dim=-1, dtype=torch.int32)
    kk = (ilog - 1).clamp(0, max(euler.nlevels - 1, 0))
    c2 = (rblock - (1 << (kk + 1))).clamp(0, nb - 1)
    t1, t2 = take(euler.sparse_flat,
                  torch.stack([kk * nb + col, kk * nb + c2]))
    # depths of every candidate position in one take
    dl, dr, dm2, dt1, dt2 = take(euler.depths,
                                 torch.stack([l, r, m2, t1, t2]))
    tmid = torch.where(dt1 <= dt2, t1, t2)
    dtmid = torch.where(dt1 <= dt2, dt1, dt2)
    m = torch.where(bdiff == 2, m2, tmid)
    dm = torch.where(bdiff == 2, dm2, dtmid)
    ex = torch.where(dl <= dm, l, m)
    dex = torch.where(dl <= dm, dl, dm)
    multi = torch.where(dex <= dr, ex, r)
    two = torch.where(dl <= dr, l, r)
    out = torch.where(bdiff == 0, one, torch.where(bdiff == 1, two, multi))
    return torch.where(start == end, start, out)


def rmq_lca_batch(euler: DeviceEuler, utaxa, uvalid):
    """The join-level LCA walk over per-read hit lists (ascending taxon
    order, as ``dedup_counts`` emits them): (B,) int32."""
    take, _rows_of, along, _anc = gather.active()
    B, K = utaxa.shape
    size = euler.first.shape[0]
    safe = torch.where(uvalid, utaxa.clamp(0, size - 1), 0)
    # absent taxa clamp to position 0; their slots are skipped
    occ = take(euler.first, safe).clamp(min=0)
    # the walk starts from the first VALID slot: slot 0 may have been
    # filtered, and taxon 0 can be a real taxon (joining a node with
    # itself when the slot comes round again is a no-op)
    first_valid = torch.argmax(uvalid.to(torch.int32), dim=-1).to(
        torch.int32)
    consensus = along(occ, first_valid[:, None], axis=-1)[:, 0]
    join_level = torch.full((B,), -1, dtype=torch.int32, device=utaxa.device)
    for t in range(1, K):
        nxt = occ[:, t]
        rmq = rmq_query_batch(euler, consensus, nxt)
        neither = (rmq != consensus) & (rmq != nxt)
        lca = torch.where(neither, rmq,
                          torch.where(rmq == consensus, nxt, consensus))
        d_rmq, d_lca = take(euler.depths, torch.stack([rmq, lca]))
        level = torch.where(neither, d_rmq, join_level)
        # a join below the join level cannot lower it
        demote = (join_level >= 0) & (d_lca > join_level)
        lca = torch.where(demote, rmq, lca)
        skip = ~uvalid[:, t] | (consensus == nxt)
        consensus = torch.where(skip, consensus, lca)
        join_level = torch.where(skip, join_level, level)
    return take(euler.tour, consensus)


def rmq_mix_batch(dtax: DeviceTaxonomy, utaxa, ucounts, uvalid,
                  factor: float, ordered: bool = False):
    """LCA-closure hybrid in taxon space (exact: the weights depend only
    on ancestor relations): (B,) int32. ``ordered``: counts that are not
    integers (taxa2agg -s), whose sums then add the inputs one at a time
    in slot order (:func:`~umgap_tpu_torch.agg.device.fold_sum`), the
    first-seen order of a weighted dedup's slots, as ``umgap_tpu``'s
    RmqMix adds a closure taxon's weights, alike on the CPU and the card;
    integer counts sum exactly in any order."""
    take, rows_of, along, _anc = gather.active()
    B, K = utaxa.shape
    size = dtax.depth.shape[0]
    safe = torch.where(uvalid, utaxa.clamp(0, size - 1), 0)
    lin = rows_of(dtax.anc, safe)                       # (B, K, D)
    D = lin.shape[-1]
    c = torch.where(uvalid, ucounts, 0.0)

    # pairwise lineage agreement counts (prefix-closed on a tree)
    agree = torch.zeros((B, K, K), dtype=torch.int32, device=utaxa.device)
    for d in range(D):
        col = lin[:, :, d]
        agree += ((col[:, :, None] == col[:, None, :])
                  & (col != NONE)[:, :, None]).to(torch.int32)
    # pair_lca[b, i, j] = lin[b, i, agree - 1], 0 where nothing agrees
    pair_lca = torch.where(agree > 0,
                           along(lin, (agree - 1).clamp(min=0), axis=-1), 0)
    pairvalid = uvalid[:, :, None] & uvalid[:, None, :]

    # candidates = inputs + all pairwise LCAs, deduplicated to 2K slots
    cands = torch.cat([torch.where(uvalid, utaxa, I32_MAX),
                       torch.where(pairvalid, pair_lca,
                                   I32_MAX).reshape(B, K * K)], dim=1)
    cs = torch.sort(cands, dim=-1).values
    prev = torch.cat([torch.full((B, 1), -1, dtype=cs.dtype,
                                 device=cs.device), cs[:, :-1]], dim=1)
    first = (cs != prev) & (cs != I32_MAX)
    key = torch.where(first, cs, I32_MAX)
    key = torch.sort(key, dim=-1).values[:, : 2 * K]  # closure <= 2K - 1
    cvalid = key != I32_MAX

    csafe = torch.where(cvalid, key.clamp(0, size - 1), 0)
    clin = rows_of(dtax.anc, csafe)                     # (B, C, D)
    cdep = torch.where(cvalid, take(dtax.depth, csafe), 0).clamp(min=0)
    idep = torch.where(uvalid, take(dtax.depth, safe), 0).clamp(min=0)
    C = key.shape[1]

    # candidate i ancestor-or-self of input j: lin[b, j, cdep[b, i]] == key
    a = along(lin.transpose(1, 2), cdep[:, :, None].expand(B, C, K))
    c_anc_i = (a == key[:, :, None]) & cvalid[:, :, None] \
        & uvalid[:, None, :]
    # input j ancestor-or-self of candidate i: clin[b, i, idep[b, j]] == utaxa
    a2 = along(clin.transpose(1, 2), idep[:, :, None].expand(B, K, C))
    i_anc_c = (a2 == torch.where(uvalid, utaxa, -2)[:, :, None]) \
        & uvalid[:, :, None] & cvalid[:, None, :]

    lca_terms = torch.where(c_anc_i, c[:, None, :], 0.0)       # (B, C, K)
    rtl_terms = torch.where(i_anc_c, c[:, :, None], 0.0)       # (B, K, C)
    if ordered:
        lca_w = fold_sum(lca_terms)
        rtl_w = fold_sum(rtl_terms.transpose(1, 2))
    else:
        lca_w = lca_terms.sum(dim=-1)
        rtl_w = rtl_terms.sum(dim=1)
    f = torch.tensor(factor, dtype=torch.float32, device=utaxa.device)
    scores = lca_w * f + rtl_w * (1.0 - f)
    return _argmax_tiebreak(key, cdep, cvalid, scores)


# K9 (csrc/rmq_aggregate.cu): its strategy codes; hybrid at K <= RMQ_WARP_K
# (kWarpK) takes a warp a group, past it a block a group, at most
# RMQ_BLOCK_GRID blocks a launch (kMixGrid); a team's lists take
# rmq_mix_area_bytes(K) of shared memory up to RMQ_SMEM_MAX (kSmemMax),
# else of a global scratch, one area a block, at most RMQ_SCRATCH_MAX
# bytes of it (the launch then runs as many blocks as it holds areas)
RMQ_STRATEGIES = {"hybrid": 0, "lca*": 1}
RMQ_WARP_K = 64
RMQ_BLOCK_GRID = 528
RMQ_SMEM_MAX = 226 * 1024
RMQ_SCRATCH_MAX = 1 << 28


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def rmq_mix_area_bytes(K: int) -> int:
    """Bytes of one team's lists on K9's hybrid path for groups of K
    slots (``mix_area_bytes``): ids, clamped ids, depths and counts, the
    lineage order and the 3K candidates."""
    return 16 * K + 4 * _pow2_at_least(K) + 4 * _pow2_at_least(3 * K)


def rmq_scratch_blocks(B: int, K: int) -> int:
    """Areas of K9's global scratch for B hybrid groups of K slots: 0
    while a block's area fits its shared memory (and at K <=
    RMQ_WARP_K), else one a block of the launch."""
    area = rmq_mix_area_bytes(K)
    if K <= RMQ_WARP_K or area <= RMQ_SMEM_MAX:
        return 0
    return min(B, RMQ_BLOCK_GRID, max(1, RMQ_SCRATCH_MAX // area))


def rmq_aggregate_plain(strategy: str, dtax: DeviceTaxonomy, euler, utaxa,
                        ucounts, uvalid, factor: float = 0.25, snap=None,
                        ordered: bool = False):
    """Plain version of :func:`rmq_aggregate`: :func:`rmq_lca_batch` or
    :func:`rmq_mix_batch` on K5's plain versions, then, with ``snap``,
    :func:`~umgap_tpu_torch.agg.device.snap_taxa_plain`."""
    with kernels.plain_versions():
        if strategy == "lca*":
            agg = rmq_lca_batch(euler, utaxa, uvalid)
        else:
            agg = rmq_mix_batch(dtax, utaxa, ucounts, uvalid, factor,
                                ordered)
    return agg if snap is None else snap_taxa_plain(snap, agg, uvalid)


def rmq_aggregate(strategy: str, dtax: DeviceTaxonomy, euler, utaxa,
                  ucounts, uvalid, factor: float = 0.25, snap=None,
                  ordered: bool = False):
    """rmq/lca* (``strategy`` "lca*", over ``euler``, a
    :class:`DeviceEuler`) or rmq/hybrid ("hybrid", over ``dtax.geom``,
    with ``ucounts`` and ``factor``) on a batch's filtered hit lists:
    utaxa (B, K) int32, ucounts (B, K) float32 (unused by lca*, may be
    None), uvalid (B, K) bool. Returns (B,) int32, with ``snap`` (a snap
    table, (S,) int32) the group's taxon as taxa2agg ends: 1 for a group
    with no valid hit, else the aggregate's snap entry, 0 for an
    aggregate out of range or unsnappable.

    The inputs are checked on either device (ValueError). CPU tensors
    then take :func:`rmq_aggregate_plain`; CUDA tensors launch K9 once.
    Its sums add in slot order, the order ``ordered`` (counts that are
    not integers, taxa2agg -s) asks of the plain version; integer counts
    sum exactly in any order, so the launch is the same either way."""
    if strategy not in RMQ_STRATEGIES:
        raise ValueError(f"rmq_aggregate: no strategy {strategy!r}")
    if utaxa.dim() != 2 or utaxa.shape[1] == 0:
        raise ValueError("rmq_aggregate: empty hit lists")
    B, K = utaxa.shape
    want = [(uvalid, torch.bool), (utaxa, torch.int32)]
    if strategy == "hybrid":
        if ucounts is None:
            raise ValueError("rmq_aggregate: hybrid needs ucounts")
        want.append((ucounts, torch.float32))
    for t, dt in want:
        if t.dtype != dt or tuple(t.shape) != (B, K):
            raise ValueError(f"rmq_aggregate: {tuple(t.shape)} {t.dtype}, "
                             f"expected {(B, K)} {dt}")
    if strategy == "lca*":
        if euler is None:
            raise ValueError("rmq_aggregate: lca* needs a DeviceEuler")
        tables = [euler.first, euler.tour, euler.depths, euler.block_min,
                  euler.sparse_flat]
    else:
        geom = dtax.geom
        if geom.dim() != 2 or geom.shape[1] < 2:
            raise ValueError("rmq_aggregate: empty lineages")
        tables = [geom]
    for t in tables:
        if t.dtype != torch.int32 or not t.numel():
            raise ValueError("rmq_aggregate: tables must be non-empty int32")
    if snap is not None:
        if snap.dtype != torch.int32 or snap.dim() != 1 or not len(snap):
            raise ValueError("rmq_aggregate: snap must be a non-empty (S,) "
                             "int32 table")
        tables.append(snap)
    if utaxa.is_cpu:
        return rmq_aggregate_plain(strategy, dtax, euler, utaxa, ucounts,
                                   uvalid, factor, snap, ordered)
    kernels.check_cuda("rmq_aggregate", *(t for t, _ in want), *tables)
    dev = utaxa.device
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    blocks = rmq_scratch_blocks(B, K) if strategy == "hybrid" else 0
    scratch = (torch.empty(blocks * rmq_mix_area_bytes(K), dtype=torch.uint8,
                           device=dev) if blocks else None)
    if strategy == "lca*":
        e = euler
        lca = (e.first.data_ptr(), e.first.shape[0], e.tour.data_ptr(),
               e.depths.data_ptr(), e.block_min.data_ptr(),
               e.block_min.shape[0], e.sparse_flat.data_ptr(), e.nlevels)
        hyb = (0, 0, 0)
    else:
        lca = (0, 0, 0, 0, 0, 0, 0, 0)
        hyb = (geom.data_ptr(), geom.shape[0], geom.shape[1])
    kernels.K9.launch(
        RMQ_STRATEGIES[strategy], utaxa.data_ptr(),
        0 if ucounts is None or strategy == "lca*" else ucounts.data_ptr(),
        uvalid.data_ptr(), B, K, *lca, *hyb, float(factor),
        0 if snap is None else snap.data_ptr(),
        0 if snap is None else len(snap),
        0 if scratch is None else scratch.data_ptr(), blocks,
        out.data_ptr(), kernels.stream_of(utaxa))
    return out
