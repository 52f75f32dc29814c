"""K-mer packing and the tryptic digest (a copy of
``umgap_tpu.ops.kmers``), and kernel K1P (``proteins_to_kmers``, the
protein entry of ``csrc/reads_to_kmers.cu``): the window packing of
FGSpp's predicted genes, whose plain version is
:func:`pack_windows_batch`.

A peptide k-mer over the 5-bit AA alphabet packs into 5k bits, split at
bit 25 into two int32 lanes (``hi``, ``lo``); k <= 10.

The tryptic digest reproduces the reference's double regex pass
(src/commands/prot2tryp.rs:57-64): the cleavage pattern is applied twice
because a residue can match both as the context of one split and as the
subject of the next, then '*' splits and empty fragments are dropped.
"""

from __future__ import annotations

import functools
import re
from typing import List

import numpy as np
import torch

from .. import kernels
from . import encoding

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


def pack_peptide_host(codes: np.ndarray) -> int:
    """One short peptide's AA codes (at most 10) packed into an int."""
    v = np.uint64(0)
    for c in codes:
        v = (v << np.uint64(5)) | np.uint64(c)
    return int(v)


def split_packed(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 packed -> (hi, lo) int32 lanes split at bit 25."""
    packed = np.asarray(packed, dtype=np.uint64)
    hi = (packed >> np.uint64(25)).astype(np.int32)
    lo = (packed & np.uint64(MASK25)).astype(np.int32)
    return hi, lo


def join_packed(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)


def unpack_kmer(packed: int, k: int) -> str:
    """A packed k-mer back to its AA string (``printindex``)."""
    codes = [(int(packed) >> (5 * (k - 1 - j))) & 31 for j in range(k)]
    return encoding.decode_aa(np.array(codes))


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


# K1P's tiles (csrc/reads_to_kmers.cu), one a block: K1P_TILE_MAX
# windows at most (a warp packs 256; tiles of 512 and 1,024 took 0.247 ms
# on the build's TSV split, 2,048 0.256, on the H100), K1P_TILE_MIN at
# least, and sized so that a call makes at least two blocks an SM where
# it can
K1P_TILE_MAX = 1024
K1P_TILE_MIN = 256


def k1p_plan(n_out: int, sms: int):
    """(tile, blocks) of a K1P call over ``n_out`` windows on a card of
    ``sms`` SMs: the tile a multiple of 8 between K1P_TILE_MIN and
    K1P_TILE_MAX that gives at least two tiles an SM, a block a tile."""
    want = n_out // (2 * sms) // 8 * 8
    tile = min(K1P_TILE_MAX, max(K1P_TILE_MIN, want))
    return tile, -(-max(n_out, 1) // tile)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def proteins_to_kmers(aa: torch.Tensor, pep_lengths: torch.Tensor,
                      k: int = DEFAULT_K):
    """:func:`pack_windows_batch` of protein lanes: ``aa`` (N, P) uint8
    AA codes and ``pep_lengths`` (N,) int32 -> ``hi``, ``lo`` (N, W)
    int32 and ``valid`` (N, W) bool, W = max(P - k + 1, 1).

    CPU tensors take the plain version; CUDA tensors launch K1P."""
    if aa.device.type == "cpu":
        return pack_windows_batch(aa, pep_lengths, k)
    if k > 10:
        raise ValueError("k must be <= 10")
    if aa.dtype != torch.uint8 or aa.dim() != 2 or aa.shape[1] < 1:
        raise ValueError(f"proteins_to_kmers: expected (N, P) uint8, got "
                         f"{tuple(aa.shape)} {aa.dtype}")
    N, P = aa.shape
    if pep_lengths.dtype != torch.int32 or pep_lengths.shape != (N,):
        raise ValueError("proteins_to_kmers: lengths must be (N,) int32")
    kernels.check_cuda("proteins_to_kmers", aa, pep_lengths)
    W = max(P - k + 1, 1)
    hi = torch.empty((N, W), dtype=torch.int32, device=aa.device)
    lo = torch.empty_like(hi)
    valid = torch.empty((N, W), dtype=torch.bool, device=aa.device)
    tile = k1p_plan(N * W, _sm_count(aa.get_device()))[0]
    kernels.K1P.launch(aa.data_ptr(), P, pep_lengths.data_ptr(), N, k,
                       hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), W,
                       tile, kernels.stream_of(aa))
    return hi, lo, valid


_TRYPTIC_RE = re.compile(TRYPTIC_PATTERN)


def tryptic_digest(seq: str, pattern: str = TRYPTIC_PATTERN) -> List[str]:
    """In-silico trypsin digest of one AA string, the reference's
    realized semantics."""
    rx = _TRYPTIC_RE if pattern == TRYPTIC_PATTERN else re.compile(pattern)
    first = rx.sub(r"\1\n\2", seq)
    second = rx.sub(r"\1\n\2", first)
    return [p for p in second.replace("*", "\n").split("\n") if p]
