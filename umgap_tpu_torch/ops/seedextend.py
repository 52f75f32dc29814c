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
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def apply_seedextend(taxa: Sequence[int], min_seed_size: int = 2,
                     max_gap_size: int = 0) -> List[int]:
    """The command's output for one lane: the taxa of every kept seed,
    concatenated (the unscored mode; no preset scores seeds)."""
    taxons = list(taxa) + [0]
    out: List[int] = []
    for s, e in seedextend_host(taxa, min_seed_size, max_gap_size):
        out.extend(taxons[s:e])
    return out


def seedextend_mask_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0):
    """Plain version of K3: the state machine as a Python loop over
    positions, every lane advancing together (``_scan_seeds``)."""
    N = taxa.shape[-1]
    lanes = taxa.shape[:-1]
    dev = taxa.device
    t = taxa.reshape(-1, N).to(torch.int32)
    ln = lengths.reshape(-1).to(torch.int64)
    nl = t.shape[0]
    pos = torch.arange(N, device=dev)
    inside = pos[None, :] < ln[:, None]
    t = torch.where(inside, t, 0)
    tx = torch.cat([t, torch.zeros((nl, 1), dtype=torch.int32, device=dev)],
                   dim=1)
    # column N collects pushes that fall outside [0, N)
    d = torch.zeros((nl, N + 1), dtype=torch.int32, device=dev)

    def add(p, mask, v):
        col = torch.where((p >= 0) & (p < N), p, N)
        d.scatter_add_(1, col[:, None], (mask.to(torch.int32) * v)[:, None])

    start = torch.zeros(nl, dtype=torch.int64, device=dev)
    last = tx[:, 0]
    same_tid = torch.ones(nl, dtype=torch.int64, device=dev)
    same_max = torch.ones(nl, dtype=torch.int64, device=dev)
    for end in range(1, N + 1):
        cur = tx[:, end]
        same = last == cur
        b1 = ~same & (last == 0) & (same_tid > max_gap_size)
        b2 = ~same & ~b1 & (last == 0) & ((end - start) == same_tid)
        b3 = ~same & ~b1 & ~b2
        push = b1 & (same_max >= min_seed_size)
        add(start, push, 1)
        add(end - same_tid, push, -1)
        n_start = torch.where(b1, end, torch.where(b2, end + 1, start))
        n_last = torch.where(same | b2, last, cur)
        n_same_tid = torch.where(same, same_tid + 1,
                                 torch.where(b2, same_tid, 1))
        n_same_max = torch.where(
            b1, 1, torch.where(b3 & (last != 0),
                               torch.maximum(same_max, same_tid), same_max))
        start, last, same_tid, same_max = n_start, n_last, n_same_tid, \
            n_same_max
    f_push = same_max >= min_seed_size
    add(start, f_push, 1)
    add(torch.where(last == 0, N + 1 - same_tid, N + 1), f_push, -1)
    keep = (torch.cumsum(d[:, :N], dim=1) > 0) & inside
    return keep.reshape(lanes + (N,))


def seedextend_hits_plain(taxa: torch.Tensor, lengths: torch.Tensor,
                          min_seed_size: int = 2, max_gap_size: int = 0):
    """Plain version of K3's hits epilogue: the taxa where the lane keeps
    the window, 0 elsewhere."""
    keep = seedextend_mask_plain(taxa, lengths, min_seed_size, max_gap_size)
    return torch.where(keep, taxa, 0)


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
    t = taxa.reshape(-1, N).to(torch.int32)
    nl = t.shape[0]
    ln = lengths.reshape(-1).to(torch.int64).clamp(0, N)
    pos = torch.arange(N + 1, device=dev)
    inside = pos[None, :N] < ln[:, None]
    x = torch.cat([torch.where(inside, t, 0),
                   torch.zeros((nl, 1), dtype=torch.int32, device=dev)],
                  dim=1)  # the sentinel at N
    g, s = int(max_gap_size), int(min_seed_size)
    nz = x != 0
    z = torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1), N + 1)
    b2_lane = (z >= 1) & (z <= g)
    cand = torch.zeros((nl, N + 1), dtype=torch.bool, device=dev)
    cand[:, 1:] = x[:, 1:] != x[:, :-1]
    extra = b2_lane & (z + 1 <= N)
    cand[extra.nonzero(as_tuple=True)[0], (z + 1)[extra]] = True
    R = int(cand.sum(dim=1).max()) if nl else 0
    where_c = torch.sort(torch.where(cand, pos, N + 1), dim=1).values[:, :R]

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
                          min_seed_size: int = 2, max_gap_size: int = 0):
    """Keep mask (..., N) bool of a padded batch of window taxa (..., N)
    int32 with valid lengths (...). CPU tensors take the plain version;
    CUDA tensors launch K3 with its mask epilogue."""
    if taxa.device.type == "cpu":
        return seedextend_mask_plain(taxa, lengths, min_seed_size,
                                     max_gap_size)
    return _launch(taxa, lengths, min_seed_size, max_gap_size, hits=False)


def seedextend_hits(taxa: torch.Tensor, lengths: torch.Tensor,
                    min_seed_size: int = 2, max_gap_size: int = 0):
    """Hits (..., N) int32 of a padded batch of window taxa (..., N)
    int32 with valid lengths (...): the taxa inside kept extended seeds,
    0 elsewhere, i.e. ``torch.where(keep, taxa, 0)`` in one pass. CPU
    tensors take the plain version; CUDA tensors launch K3 with its hits
    epilogue."""
    if taxa.device.type == "cpu":
        return seedextend_hits_plain(taxa, lengths, min_seed_size,
                                     max_gap_size)
    return _launch(taxa, lengths, min_seed_size, max_gap_size, hits=True)
