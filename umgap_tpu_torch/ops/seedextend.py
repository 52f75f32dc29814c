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


# Rows of up to STAGED_MAX_N windows (reads up to 312 bp) take K3's
# staged tile of LANES_PER_BLOCK lanes (a sweep over 32, 64 and 128 on
# the H100; PERF.md, section 6); wider rows, up to MAX_N, its direct
# kernel, whose int16 delta rows of one warp fit in shared memory; wider
# still, the direct kernel with its delta rows in a global scratch.
STAGED_MAX_N = 96
LANES_PER_BLOCK = 64
MAX_N = 3600


def seedextend_path(N: int) -> str:
    """K3's kernel for rows of N windows: ``"staged"`` up to
    :data:`STAGED_MAX_N`, ``"direct"`` up to :data:`MAX_N`, ``"global"``
    (the direct kernel, delta rows in global memory) above."""
    if N <= STAGED_MAX_N:
        return "staged"
    return "direct" if N <= MAX_N else "global"


def _launch(taxa, lengths, min_seed_size, max_gap_size, hits: bool):
    N = taxa.shape[-1]
    if taxa.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or lengths.shape != taxa.shape[:-1]:
        raise ValueError("seedextend: taxa (..., N) int32 and lengths "
                         "(...) int32 expected")
    path = seedextend_path(N)
    kernels.check_cuda("seedextend", taxa, lengths)
    out = torch.empty(taxa.shape, dtype=torch.int32 if hits else torch.bool,
                      device=taxa.device)
    scratch = (torch.empty((N, lengths.numel()), dtype=torch.int16,
                           device=taxa.device) if path == "global" else None)
    kernels.K3.launch(taxa.data_ptr(), lengths.data_ptr(),
                      lengths.numel(), N, int(min_seed_size),
                      int(max_gap_size), out.data_ptr(), int(hits),
                      int(path == "staged"), LANES_PER_BLOCK,
                      0 if scratch is None else scratch.data_ptr(),
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
