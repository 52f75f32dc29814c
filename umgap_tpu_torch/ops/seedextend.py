"""Seed-and-extend: kernel K3 (``csrc/seedextend_mask.cu``), as a keep
mask or as the hits it selects, and their plain PyTorch versions.

Semantics (``umgap_tpu.ops.seedextend``, reference
src/commands/seedextend.rs:96-178), with ``s`` = min seed size and ``g``
= max gap size: runs of id 0 are gaps; an extended seed is a maximal
stretch of non-zero runs joined by gaps of length <= g; it is kept iff
its longest non-zero run is >= s. The reference's order-dependent state
machine (including its leading-gap quirk and the trailing-gap trim) is
run per lane; seed pushes become +1/-1 deltas whose running sum > 0 is
the keep mask. The pipeline takes the hits (:func:`seedextend_hits`),
which K3 writes directly. :func:`apply_seedextend` is the host state
machine over one lane, for the CLI's long-record route.

The scored mode (the reference's ``seedextend -r``,
src/commands/seedextend.rs:151-164; ``PipelineConfig.ranked``) keeps only
the extended seed with the highest summed score, the last of equal ones:
each taxon scores its ``seed_scores`` entry where that is > 0, else the
penalty (gaps included). ``seedextend_hits(..., seed_scores=...)``
launches K3's scored entries; :func:`seedextend_scored_hits_plain` is the
JAX package's formulation and :func:`seedextend_scored_runs_plain` the
row kernel's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels


def seedextend_host(taxa: Sequence[int], min_seed_size: int = 2,
                    max_gap_size: int = 0) -> List[Tuple[int, int]]:
    """The reference state machine on the host
    (src/commands/seedextend.rs:96-178): the kept extended seeds as
    half-open (start, end) ranges into ``taxa``."""
    taxons = list(taxa) + [0]  # the sentinel (seedextend.rs:99)
    seeds: List[Tuple[int, int]] = []
    start, end = 0, 1
    last_tid = taxons[start]
    same_tid = 1
    same_max = 1
    while end < len(taxons):
        if last_tid == taxons[end]:
            same_tid += 1
            end += 1
            continue
        if last_tid == 0 and same_tid > max_gap_size:
            if same_max >= min_seed_size:
                seeds.append((start, end - same_tid))
            start = end
            last_tid = taxons[end]
            same_tid = 1
            same_max = 1
            end += 1
            continue
        if last_tid == 0 and (end - start) == same_tid:
            end += 1
            start = end
            continue
        if last_tid != 0:
            same_max = max(same_max, same_tid)
        last_tid = taxons[end]
        same_tid = 1
        end += 1
    if same_max >= min_seed_size:
        if last_tid == 0:
            end -= same_tid
        seeds.append((start, end))
    return seeds


def select_best_seed(taxa: Sequence[int], seeds: List[Tuple[int, int]],
                     tax, penalty: int = 5) -> List[Tuple[int, int]]:
    """The scored mode (src/commands/seedextend.rs:151-164): of ``seeds``
    only the one with the highest summed score, where a taxon scores
    ``tax.score`` and an unscored one (a gap included) the penalty. Ties
    keep the last (Rust's ``max_by_key``)."""
    if not seeds:
        return []
    taxons = list(taxa) + [0]
    best, best_score = None, None
    for s, e in seeds:
        score = 0
        for t in taxons[s:e]:
            sc = tax.score(t) if 0 <= t < tax.size else None
            score += sc if sc is not None else penalty
        if best_score is None or score >= best_score:
            best, best_score = (s, e), score
    return [best]


def apply_seedextend(taxa: Sequence[int], min_seed_size: int = 2,
                     max_gap_size: int = 0, tax=None,
                     penalty: int = 5) -> List[int]:
    """The command's output for one lane: the taxa of every kept seed,
    concatenated; with a taxonomy ``tax``, of the best-scoring seed
    alone (:func:`select_best_seed`)."""
    seeds = seedextend_host(taxa, min_seed_size, max_gap_size)
    if tax is not None:
        seeds = select_best_seed(taxa, seeds, tax, penalty)
    taxons = list(taxa) + [0]
    out: List[int] = []
    for s, e in seeds:
        out.extend(taxons[s:e])
    return out


def _scan_pushes(tx: torch.Tensor, min_seed_size: int, max_gap_size: int):
    """The state machine over (lanes, N + 1) taxa (the sentinel at N),
    every lane advancing together (``umgap_tpu``'s ``_scan_seeds``): a
    (push, start, stop) triple of (lanes,) tensors for each step, then
    the final flush's."""
    nl, N = tx.shape[0], tx.shape[1] - 1
    dev = tx.device
    start = torch.zeros(nl, dtype=torch.int64, device=dev)
    last = tx[:, 0]
    same_tid = torch.ones(nl, dtype=torch.int64, device=dev)
    same_max = torch.ones(nl, dtype=torch.int64, device=dev)
    out = []
    for end in range(1, N + 1):
        cur = tx[:, end]
        same = last == cur
        b1 = ~same & (last == 0) & (same_tid > max_gap_size)
        b2 = ~same & ~b1 & (last == 0) & ((end - start) == same_tid)
        b3 = ~same & ~b1 & ~b2
        out.append((b1 & (same_max >= min_seed_size), start,
                    end - same_tid))
        n_start = torch.where(b1, end, torch.where(b2, end + 1, start))
        n_last = torch.where(same | b2, last, cur)
        n_same_tid = torch.where(same, same_tid + 1,
                                 torch.where(b2, same_tid, 1))
        n_same_max = torch.where(
            b1, 1, torch.where(b3 & (last != 0),
                               torch.maximum(same_max, same_tid), same_max))
        start, last, same_tid, same_max = n_start, n_last, n_same_tid, \
            n_same_max
    out.append((same_max >= min_seed_size, start,
                torch.where(last == 0, N + 1 - same_tid, N + 1)))
    return out


def _with_sentinel(taxa: torch.Tensor, lengths: torch.Tensor):
    """(lanes, N + 1) int32 taxa, 0 from each lane's length on (the
    sentinel at N), and the (lanes, N) inside-the-length mask."""
    N = taxa.shape[-1]
    t = taxa.reshape(-1, N).to(torch.int32)
    ln = lengths.reshape(-1).to(torch.int64)
    inside = torch.arange(N, device=taxa.device)[None, :] < ln[:, None]
    tx = torch.cat([torch.where(inside, t, 0),
                    torch.zeros((t.shape[0], 1), dtype=torch.int32,
                                device=taxa.device)], dim=1)
    return tx, inside


def seedextend_mask_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0):
    """Plain version of K3: the state machine as a Python loop over
    positions, every lane advancing together (``_scan_seeds``)."""
    N = taxa.shape[-1]
    tx, inside = _with_sentinel(taxa, lengths)
    # column N collects pushes that fall outside [0, N)
    d = torch.zeros((tx.shape[0], N + 1), dtype=torch.int32,
                    device=taxa.device)

    def add(p, mask, v):
        col = torch.where((p >= 0) & (p < N), p, N)
        d.scatter_add_(1, col[:, None], (mask.to(torch.int32) * v)[:, None])

    for push, start, stop in _scan_pushes(tx, min_seed_size, max_gap_size):
        add(start, push, 1)
        add(stop, push, -1)
    keep = (torch.cumsum(d[:, :N], dim=1) > 0) & inside
    return keep.reshape(taxa.shape)


def _seed_score(seed_scores: torch.Tensor, t: torch.Tensor, penalty: int):
    """Each taxon's score: ``seed_scores[t]`` where 0 <= t < size and it
    is > 0, else ``penalty``."""
    size = seed_scores.shape[0]
    sc = seed_scores[t.clamp(0, size - 1).to(torch.int64)].to(torch.int64)
    return torch.where((t >= 0) & (t < size) & (sc > 0), sc, int(penalty))


def seedextend_scored_mask_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                                 seed_scores: torch.Tensor,
                                 penalty: int = 5, min_seed_size: int = 2,
                                 max_gap_size: int = 0):
    """Plain version of K3's scored entries, in the JAX package's
    formulation (``seedextend_scored_mask_batch``, then the select): the
    scan's pushes and the final flush are the candidates, a candidate
    scores ``prefix[stop] - prefix[start]`` over the per-position scores
    (the sentinel's included; a push with start > stop too), and each
    lane keeps the last maximum among its pushes, or nothing without
    one. Returns the keep mask (..., N) bool."""
    N = taxa.shape[-1]
    tx, inside = _with_sentinel(taxa, lengths)
    pushes = _scan_pushes(tx, min_seed_size, max_gap_size)
    valids = torch.stack([p for p, _a, _b in pushes], dim=1)  # (lanes, M)
    starts = torch.stack([a for _p, a, _b in pushes], dim=1)
    stops = torch.stack([b for _p, _a, b in pushes], dim=1)
    sc = _seed_score(seed_scores, tx, penalty)
    prefix = torch.cat([torch.zeros((tx.shape[0], 1), dtype=torch.int64,
                                    device=taxa.device),
                        torch.cumsum(sc, dim=1)], dim=1)  # prefix[i]: < i
    scores = torch.where(
        valids, torch.gather(prefix, 1, stops.clamp(0, N + 1))
        - torch.gather(prefix, 1, starts.clamp(0, N + 1)), -2 ** 30)
    M = scores.shape[1]
    is_max = scores == scores.max(dim=1, keepdim=True).values
    best = torch.where(is_max, torch.arange(M, device=taxa.device),
                       -1).max(dim=1).values[:, None]
    bstart = torch.gather(starts, 1, best)
    bstop = torch.gather(stops, 1, best)
    pos = torch.arange(N, device=taxa.device)[None, :]
    keep = ((pos >= bstart) & (pos < bstop) & valids.any(dim=1)[:, None]
            & inside)
    return keep.reshape(taxa.shape)


def seedextend_scored_hits_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                                 seed_scores: torch.Tensor,
                                 penalty: int = 5, min_seed_size: int = 2,
                                 max_gap_size: int = 0):
    """The kept taxa (..., N) int32 of
    :func:`seedextend_scored_mask_plain`, 0 elsewhere."""
    keep = seedextend_scored_mask_plain(taxa, lengths, seed_scores, penalty,
                                        min_seed_size, max_gap_size)
    return torch.where(keep, taxa, 0)


def seedextend_hits_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0,
                          seed_scores: Optional[torch.Tensor] = None,
                          penalty: int = 5):
    """Plain version of K3's hits epilogue: the taxa where the lane keeps
    the window, 0 elsewhere; with ``seed_scores`` of its scored entries
    (:func:`seedextend_scored_hits_plain`)."""
    if seed_scores is not None:
        return seedextend_scored_hits_plain(taxa, lengths, seed_scores,
                                            penalty, min_seed_size,
                                            max_gap_size)
    keep = seedextend_mask_plain(taxa, lengths, min_seed_size, max_gap_size)
    return torch.where(keep, taxa, 0)


def _run_candidates(taxa: torch.Tensor, lengths: torch.Tensor,
                    max_gap_size: int):
    """The row formulation's inputs: x (lanes, N + 1) int32, 0 from each
    lane's length on (the sentinel at N), the inside-the-length mask
    (lanes, N), and the candidate positions (lanes, R) in ascending
    order, N + 1 past a lane's last: the run heads and, in a lane that
    opens with 1 to g zeros, the position after b2's."""
    N = taxa.shape[-1]
    dev = taxa.device
    x, inside = _with_sentinel(taxa, lengths)
    nl = x.shape[0]
    pos = torch.arange(N + 1, device=dev)
    nz = x != 0
    z = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1), N + 1)
    b2_lane = (z >= 1) & (z <= max_gap_size)
    cand = torch.zeros((nl, N + 1), dtype=torch.bool, device=dev)
    cand[:, 1:] = x[:, 1:] != x[:, :-1]
    extra = b2_lane & (z + 1 <= N)
    cand[extra.nonzero(as_tuple=True)[0], (z + 1)[extra]] = True
    R = int(cand.sum(dim=1).max()) if nl else 0
    where_c = torch.sort(torch.where(cand, pos, N + 1), dim=1).values[:, :R]
    return x, inside, where_c


def seedextend_runs_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0,
                          hits: bool = False):
    """Plain version of K3's row kernel (``csrc/seedextend_mask.cu``,
    rows past :data:`STAGED_MAX_N` windows), its formulation rather than
    the position loop: the state machine steps only where it can change
    state, and the kept seeds are intervals, not a delta row.

    - Between two candidate positions every step is ``same`` and only
      adds to ``same_tid``, so the machine runs over the candidates
      alone: the run heads (``x[p] != x[p - 1]``) and, after the
      leading-gap branch b2 (a lane opening with 1 to g zeros; b2 keeps
      ``last = 0`` past a non-zero taxon, so the machine's runs are not
      the input's), the position after it.
    - A push of b1 or of the final flush is the interval
      [start, stop). Pushes come in order and never overlap: each b1
      restarts at ``end`` >= the interval it closed. The only push with
      start > stop is one out of b2's gap, and its negative coverage
      falls where no later interval reaches; so the scan's
      ``cumsum(deltas) > 0`` is the union of the intervals with
      start < stop, clipped to the lane's length.

    Returns the keep mask, or with ``hits`` the taxa where it keeps."""
    N = taxa.shape[-1]
    shape = taxa.shape
    dev = taxa.device
    x, inside, where_c = _run_candidates(taxa, lengths, max_gap_size)
    nl, R = where_c.shape
    g, s = int(max_gap_size), int(min_seed_size)

    start = torch.zeros(nl, dtype=torch.int64, device=dev)
    last = x[:, 0]
    same_tid = torch.ones(nl, dtype=torch.int64, device=dev)
    same_max = torch.ones(nl, dtype=torch.int64, device=dev)
    e0 = torch.ones(nl, dtype=torch.int64, device=dev)  # next step's end
    lo, hi = [], []
    for r in range(R):
        p = where_c[:, r]
        act = p <= N
        cur = torch.gather(x, 1, p.clamp(max=N)[:, None])[:, 0]
        tid = same_tid + (p - e0)  # the `same` steps since the last one
        same = last == cur
        b1 = ~same & (last == 0) & (tid > g)
        b2 = ~same & ~b1 & (last == 0) & ((p - start) == tid)
        b3 = ~same & ~b1 & ~b2
        push = act & b1 & (same_max >= s)
        lo.append(torch.where(push, start, 0))
        hi.append(torch.where(push, p - tid, 0))
        n_start = torch.where(b1, p, torch.where(b2, p + 1, start))
        n_last = torch.where(same | b2, last, cur)
        n_tid = torch.where(same, tid + 1, torch.where(b2, tid, 1))
        n_max = torch.where(b1, 1, torch.where(
            b3 & (last != 0), torch.maximum(same_max, tid), same_max))
        start = torch.where(act, n_start, start)
        last = torch.where(act, n_last, last)
        same_tid = torch.where(act, n_tid, same_tid)
        same_max = torch.where(act, n_max, same_max)
        e0 = torch.where(act, p + 1, e0)
    same_tid = same_tid + (N + 1 - e0)
    push = same_max >= s
    lo.append(torch.where(push, start, 0))
    hi.append(torch.where(push, torch.where(last == 0, N + 1 - same_tid,
                                            N + 1), 0))
    lo = torch.stack(lo, dim=1)
    hi = torch.stack(hi, dim=1).clamp(max=N)
    proper = lo < hi
    d = torch.zeros((nl, N + 1), dtype=torch.int32, device=dev)
    one = proper.to(torch.int32)
    d.scatter_add_(1, torch.where(proper, lo, N), one)
    d.scatter_add_(1, torch.where(proper, hi, N), -one)
    keep = (torch.cumsum(d[:, :N], dim=1) > 0) & inside
    keep = keep.reshape(shape)
    return torch.where(keep, taxa, 0) if hits else keep


def seedextend_scored_runs_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                                seed_scores: torch.Tensor, penalty: int = 5,
                                min_seed_size: int = 2,
                                max_gap_size: int = 0, hits: bool = True):
    """Plain version of K3's scored row kernel, its formulation: the
    machine stepped at the candidates of :func:`seedextend_runs_plain`,
    carrying three prefixes of the per-position scores instead of a
    prefix row (``csrc/seedextend_mask.cu``): at the next step's end
    (advanced over a run as run length x the run's score, the taxon
    being constant between candidates), at ``start``, and at
    end - same_tid (the stop of the next b1 push: kept by a ``same``
    step, moved on one position by b2, reset by b1 and b3). Each lane
    keeps its best push, the last of equal ones. Returns the kept taxa
    (..., N) int32, 0 elsewhere, or without ``hits`` the keep mask."""
    N = taxa.shape[-1]
    dev = taxa.device
    x, inside, where_c = _run_candidates(taxa, lengths, max_gap_size)
    nl, R = where_c.shape
    g, s = int(max_gap_size), int(min_seed_size)

    def score(t):
        return _seed_score(seed_scores, t, penalty)

    def col(p):
        return torch.gather(x, 1, p.clamp(0, N)[:, None])[:, 0]

    def zeros():
        return torch.zeros(nl, dtype=torch.int64, device=dev)

    start, same_tid, same_max, e0 = zeros(), zeros() + 1, zeros() + 1, \
        zeros() + 1
    last = x[:, 0]
    p_e0 = s_run = score(last)
    p_start, p_run = zeros(), zeros()
    best = torch.full((nl,), -2 ** 62, dtype=torch.int64, device=dev)
    bstart, bstop = zeros(), zeros()
    for r in range(R):
        p = where_c[:, r]
        act = p <= N
        cur = col(p)
        tid = same_tid + (p - e0)
        p_end = p_e0 + (p - e0) * s_run
        s_cur = score(cur)
        same = last == cur
        b1 = ~same & (last == 0) & (tid > g)
        b2 = ~same & ~b1 & (last == 0) & ((p - start) == tid)
        b3 = ~same & ~b1 & ~b2
        better = act & b1 & (same_max >= s) & (p_run - p_start >= best)
        best = torch.where(better, p_run - p_start, best)
        bstart = torch.where(better, start, bstart)
        bstop = torch.where(better, p - tid, bstop)
        n_p_start = torch.where(b1, p_end, torch.where(b2, p_end + s_cur,
                                                       p_start))
        n_p_run = torch.where(same, p_run, torch.where(
            b2, p_run + score(col(p - tid)), p_end))
        n_start = torch.where(b1, p, torch.where(b2, p + 1, start))
        n_last = torch.where(same | b2, last, cur)
        n_tid = torch.where(same, tid + 1, torch.where(b2, tid, 1))
        n_max = torch.where(b1, 1, torch.where(
            b3 & (last != 0), torch.maximum(same_max, tid), same_max))

        def upd(old, new):
            return torch.where(act, new, old)

        p_start, p_run = upd(p_start, n_p_start), upd(p_run, n_p_run)
        start, last = upd(start, n_start), upd(last, n_last)
        same_tid, same_max = upd(same_tid, n_tid), upd(same_max, n_max)
        p_e0, s_run = upd(p_e0, p_end + s_cur), upd(s_run, s_cur)
        e0 = upd(e0, p + 1)
    tail = N + 1 - e0  # the `same` steps to the sentinel
    same_tid = same_tid + tail
    f_score = torch.where(last == 0, p_run, p_e0 + tail * s_run) - p_start
    better = (same_max >= s) & (f_score >= best)
    bstart = torch.where(better, start, bstart)
    bstop = torch.where(better, torch.where(last == 0, N + 1 - same_tid,
                                            N + 1), bstop)
    pos = torch.arange(N, device=dev)[None, :]
    keep = ((pos >= bstart[:, None]) & (pos < bstop[:, None])
            & inside).reshape(taxa.shape)
    return torch.where(keep, taxa, 0) if hits else keep


def seedextend_scored_walk_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                                 seed_scores: torch.Tensor, penalty: int = 5,
                                 min_seed_size: int = 2,
                                 max_gap_size: int = 0, hits: bool = True):
    """Plain version of K3RS (``csrc/seedextend_mask.cu``,
    ``seedextend_rows_scored_kernel``), its formulation: every window's
    score looked up first (each thread's own loads), then the walk over
    the positions, stepping the machine only at the candidates as it
    finds them (a window unlike the one before it; after b2 the next
    position), the candidate's taxon and score read from those rows (the
    shuffles), the prefix at a candidate advanced as run length x the
    run's score, and b2's moved stop adding the score of taxon 0 (the
    window at the old stop lies in the lane's opening gap). Each lane
    keeps its best push, the last of equal ones. Returns the kept taxa
    (..., N) int32, 0 elsewhere, or without ``hits`` the keep mask."""
    N = taxa.shape[-1]
    dev = taxa.device
    x, inside = _with_sentinel(taxa, lengths)
    nl = x.shape[0]
    g, s = int(max_gap_size), int(min_seed_size)
    sx = _seed_score(seed_scores, x, penalty)
    s0 = _seed_score(seed_scores, torch.zeros(1, dtype=torch.int32,
                                              device=dev), penalty)

    def zeros():
        return torch.zeros(nl, dtype=torch.int64, device=dev)

    start, same_tid, same_max, e0 = zeros(), zeros() + 1, zeros() + 1, \
        zeros() + 1
    last = x[:, 0]
    p_e0 = s_run = sx[:, 0]
    p_start, p_run = zeros(), zeros()
    best = torch.full((nl,), -2 ** 62, dtype=torch.int64, device=dev)
    bstart, bstop = zeros(), zeros()
    extra = torch.zeros(nl, dtype=torch.bool, device=dev)
    for p in range(1, N + 1):
        cur = x[:, p]
        act = (cur != x[:, p - 1]) | extra
        tid = same_tid + (p - e0)
        p_end = p_e0 + (p - e0) * s_run
        s_cur = sx[:, p]
        same = last == cur
        b1 = ~same & (last == 0) & (tid > g)
        b2 = ~same & ~b1 & (last == 0) & ((p - start) == tid)
        b3 = ~same & ~b1 & ~b2
        better = act & b1 & (same_max >= s) & (p_run - p_start >= best)
        best = torch.where(better, p_run - p_start, best)
        bstart = torch.where(better, start, bstart)
        bstop = torch.where(better, p - tid, bstop)
        n_p_start = torch.where(b1, p_end, torch.where(b2, p_end + s_cur,
                                                       p_start))
        n_p_run = torch.where(same, p_run, torch.where(b2, p_run + s0,
                                                       p_end))
        n_start = torch.where(b1, p, torch.where(b2, p + 1, start))
        n_last = torch.where(same | b2, last, cur)
        n_tid = torch.where(same, tid + 1, torch.where(b2, tid, 1))
        n_max = torch.where(b1, 1, torch.where(
            b3 & (last != 0), torch.maximum(same_max, tid), same_max))

        def upd(old, new):
            return torch.where(act, new, old)

        p_start, p_run = upd(p_start, n_p_start), upd(p_run, n_p_run)
        start, last = upd(start, n_start), upd(last, n_last)
        same_tid, same_max = upd(same_tid, n_tid), upd(same_max, n_max)
        p_e0, s_run = upd(p_e0, p_end + s_cur), upd(s_run, s_cur)
        e0 = upd(e0, torch.full_like(e0, p + 1))
        extra = act & b2
    tail = N + 1 - e0  # the `same` steps to the sentinel
    same_tid = same_tid + tail
    f_score = torch.where(last == 0, p_run, p_e0 + tail * s_run) - p_start
    better = (same_max >= s) & (f_score >= best)
    bstart = torch.where(better, start, bstart)
    bstop = torch.where(better, torch.where(last == 0, N + 1 - same_tid,
                                            N + 1), bstop)
    pos = torch.arange(N, device=dev)[None, :]
    keep = ((pos >= bstart[:, None]) & (pos < bstop[:, None])
            & inside).reshape(taxa.shape)
    return torch.where(keep, taxa, 0) if hits else keep


# Rows of up to STAGED_MAX_N windows (reads up to 312 bp) take K3's
# staged tile of LANES_PER_BLOCK lanes (a sweep over 32, 64 and 128 on
# the H100; PERF.md, section 6); wider rows its row kernel, one warp a
# lane (kernels.K3R), at any width.
STAGED_MAX_N = 96
LANES_PER_BLOCK = 64


def seedextend_path(N: int) -> str:
    """K3's kernel for rows of N windows: ``"staged"`` up to
    :data:`STAGED_MAX_N`, ``"rows"`` (one warp a lane, over the runs)
    above."""
    return "staged" if N <= STAGED_MAX_N else "rows"


# K3RS walks rows from this width with a warp a lane, narrower ones with
# 16 threads a lane, two lanes a warp (a sweep on the H100: 16 faster to
# 162 windows, even at 333, slower at 4,000; PERF.md, section 6)
SCORED_WARP_MIN_N = 512


def scored_lane_threads(N: int) -> int:
    """Threads of K3RS's walk a lane of N windows: 16 below
    :data:`SCORED_WARP_MIN_N`, 32 from it."""
    return 16 if N < SCORED_WARP_MIN_N else 32


def _launch(taxa, lengths, min_seed_size, max_gap_size, hits: bool):
    N = taxa.shape[-1]
    if taxa.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or lengths.shape != taxa.shape[:-1]:
        raise ValueError("seedextend: taxa (..., N) int32 and lengths "
                         "(...) int32 expected")
    kernels.check_cuda("seedextend", taxa, lengths)
    out = torch.empty(taxa.shape, dtype=torch.int32 if hits else torch.bool,
                      device=taxa.device)
    if seedextend_path(N) == "staged":
        kernels.K3.launch(taxa.data_ptr(), lengths.data_ptr(),
                          lengths.numel(), N, int(min_seed_size),
                          int(max_gap_size), out.data_ptr(), int(hits),
                          LANES_PER_BLOCK, kernels.stream_of(taxa))
    else:
        kernels.K3R.launch(taxa.data_ptr(), lengths.data_ptr(),
                           lengths.numel(), N, int(min_seed_size),
                           int(max_gap_size), out.data_ptr(), int(hits),
                           kernels.stream_of(taxa))
    return out


def seedextend_mask_batch(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0,
                          seed_scores: Optional[torch.Tensor] = None,
                          penalty: int = 5):
    """Keep mask (..., N) bool of a padded batch of window taxa (..., N)
    int32 with valid lengths (...); with ``seed_scores`` the scored
    mode's (a lane's best-scoring seed alone). CPU tensors take the plain
    version; CUDA tensors launch K3 (its scored entries with
    ``seed_scores``) with the mask epilogue."""
    if seed_scores is not None:
        if taxa.device.type == "cpu":
            return seedextend_scored_mask_plain(taxa, lengths, seed_scores,
                                                penalty, min_seed_size,
                                                max_gap_size)
        return _launch_scored(taxa, lengths, min_seed_size, max_gap_size,
                              seed_scores, penalty, hits=False)
    if taxa.device.type == "cpu":
        return seedextend_mask_plain(taxa, lengths, min_seed_size,
                                     max_gap_size)
    return _launch(taxa, lengths, min_seed_size, max_gap_size, hits=False)


def _launch_scored(taxa, lengths, min_seed_size, max_gap_size, seed_scores,
                   penalty, hits: bool = True):
    N = taxa.shape[-1]
    if taxa.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or lengths.shape != taxa.shape[:-1] \
            or seed_scores.dtype != torch.int32 or seed_scores.dim() != 1:
        raise ValueError("seedextend: taxa (..., N) int32, lengths (...) "
                         "int32 and seed_scores (size,) int32 expected")
    kernels.check_cuda("seedextend", taxa, lengths, seed_scores)
    out = torch.empty(taxa.shape, dtype=torch.int32 if hits else torch.bool,
                      device=taxa.device)
    args = (taxa.data_ptr(), lengths.data_ptr(), lengths.numel(), N,
            int(min_seed_size), int(max_gap_size), seed_scores.data_ptr(),
            seed_scores.shape[0], int(penalty), out.data_ptr(), int(hits))
    if seedextend_path(N) == "staged":
        kernels.K3S.launch(*args, LANES_PER_BLOCK, kernels.stream_of(taxa))
    else:
        kernels.K3RS.launch(*args, scored_lane_threads(N),
                            kernels.stream_of(taxa))
    return out


def seedextend_hits(taxa: torch.Tensor, lengths: torch.Tensor,
                    min_seed_size: int = 2, max_gap_size: int = 0,
                    seed_scores: Optional[torch.Tensor] = None,
                    penalty: int = 5):
    """Hits (..., N) int32 of a padded batch of window taxa (..., N)
    int32 with valid lengths (...): the taxa inside kept extended seeds,
    0 elsewhere, i.e. ``torch.where(keep, taxa, 0)`` in one pass. With
    ``seed_scores`` (size,) int32 (``DeviceTaxonomy.seed_scores``) a lane
    keeps only its best-scoring seed, unscored taxa costing ``penalty``.
    CPU tensors take the plain version; CUDA tensors launch K3 with its
    hits epilogue, or its scored entry (the staged tile or the row kernel
    by :func:`seedextend_path`; K3RS with :func:`scored_lane_threads`
    threads a lane)."""
    if seed_scores is not None:
        if taxa.device.type == "cpu":
            return seedextend_scored_hits_plain(taxa, lengths, seed_scores,
                                                penalty, min_seed_size,
                                                max_gap_size)
        return _launch_scored(taxa, lengths, min_seed_size, max_gap_size,
                              seed_scores, penalty)
    if taxa.device.type == "cpu":
        return seedextend_hits_plain(taxa, lengths, min_seed_size,
                                     max_gap_size)
    return _launch(taxa, lengths, min_seed_size, max_gap_size, hits=True)
