"""K-mer packing and the tryptic digest (a copy of
``umgap_tpu.ops.kmers``).

A peptide k-mer over the 5-bit AA alphabet packs into 5k bits, split at
bit 25 into two int32 lanes (``hi``, ``lo``); k <= 10.

The tryptic digest reproduces the reference's double regex pass
(src/commands/prot2tryp.rs:57-64): the cleavage pattern is applied twice
because a residue can match both as the context of one split and as the
subject of the next, then '*' splits and empty fragments are dropped.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np
import torch

MASK25 = (1 << 25) - 1
DEFAULT_K = 9
TRYPTIC_PATTERN = r"([KR])([^P])"


def pack_kmers_host(codes: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    """All overlapping k-mers of one peptide's AA codes as packed uint64
    (5 bits an AA, the first residue most significant); empty if the
    peptide is shorter than k."""
    if k > 10:
        raise ValueError("k must be <= 10 for 2x int32 packing")
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(n, dtype=np.uint64)
    c = codes.astype(np.uint64)
    for j in range(k):
        out |= c[j:j + n] << np.uint64(5 * (k - 1 - j))
    return out


def split_packed(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 packed -> (hi, lo) int32 lanes split at bit 25."""
    packed = np.asarray(packed, dtype=np.uint64)
    hi = (packed >> np.uint64(25)).astype(np.int32)
    lo = (packed & np.uint64(MASK25)).astype(np.int32)
    return hi, lo


def join_packed(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)


def pack_windows_batch(aa: torch.Tensor, pep_lengths: torch.Tensor,
                       k: int = DEFAULT_K):
    """Pack every k-window of a padded peptide batch.

    Args:
      aa: (..., P) uint8 AA codes.
      pep_lengths: (...) valid lengths.

    Returns:
      hi, lo: (..., W) int32, W = max(P - k + 1, 1); valid: (..., W)
      bool, the window lies inside the peptide. A batch with P < k is
      zero-padded to k (its one window per lane is invalid).
    """
    if k > 10:
        raise ValueError("k must be <= 10")
    P = aa.shape[-1]
    a = aa.to(torch.int32)
    if P < k:
        a = torch.nn.functional.pad(a, (0, k - P))
        P = k
    W = max(P - k + 1, 1)
    n_lo = min(k, 5)
    n_hi = k - n_lo
    hi = torch.zeros(a.shape[:-1] + (W,), dtype=torch.int32, device=a.device)
    for j in range(n_hi):
        hi = (hi << 5) | a[..., j:j + W]
    lo = torch.zeros_like(hi)
    for j in range(n_hi, k):
        lo = (lo << 5) | a[..., j:j + W]
    w = torch.arange(W, device=a.device)
    valid = w < (pep_lengths.to(torch.int64)[..., None] - (k - 1))
    return hi, lo, valid


_TRYPTIC_RE = re.compile(TRYPTIC_PATTERN)


def tryptic_digest(seq: str, pattern: str = TRYPTIC_PATTERN) -> List[str]:
    """In-silico trypsin digest of one AA string, the reference's
    realized semantics."""
    rx = _TRYPTIC_RE if pattern == TRYPTIC_PATTERN else re.compile(pattern)
    first = rx.sub(r"\1\n\2", seq)
    second = rx.sub(r"\1\n\2", first)
    return [p for p in second.replace("*", "\n").split("\n") if p]
