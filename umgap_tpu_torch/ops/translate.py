"""Reads to k-mer keys: 4-bit unpack, six-frame translation and window
packing, with kernel K1 (``csrc/reads_to_kmers.cu``) fusing all three.

The plain versions below mirror ``umgap_tpu.ops.encoding
.unpack_dna4_device``, ``umgap_tpu.ops.translate.translate6_batch`` and
(in :mod:`.kmers`) ``pack_windows_batch``: a 125-entry codon table
gather and an integer reverse-complement gather. Frame order follows the
reference: "1", "2", "3" forward, "1R", "2R", "3R" on the reverse
complement (src/commands/translate.rs:143-183). :func:`translate_sequence`
translates one record on the host (the CLI's host routes).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import kernels
from . import encoding
from .encoding import TranslationTable
from .kmers import pack_windows_batch

FRAME_NAMES = ("1", "2", "3", "1R", "2R", "3R")
AA_M = int(encoding.AA_FROM_BYTE[ord("M")])


def translate_sequence(seq: str, frames: Sequence[str],
                       table: TranslationTable,
                       methionine: bool = False) -> List[str]:
    """Translate one DNA string in the given frames on the host (the
    reference's ``translate`` command, src/commands/translate.rs), as AA
    strings in frame order ('-' for codons with an N). The long-record
    and host-digest routes of the CLI use it."""
    codes = encoding.encode_dna(seq)
    rev = encoding.DNA_COMPLEMENT[codes[::-1]]
    out = []
    for frame in frames:
        strand = rev if frame.endswith("R") else codes
        offset = int(frame[0]) - 1
        sub = strand[offset:] if len(strand) > offset else strand[:0]
        out.append(encoding.decode_aa(table.translate_frame(sub, methionine)))
    return out


def unpack_dna4(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of :func:`encoding.pack_dna4` along the last axis."""
    p = packed.to(torch.int32)
    out = torch.stack([(p >> 4) & 0xF, p & 0xF], dim=-1)
    out = out.reshape(*packed.shape[:-1], -1)
    return out[..., :length].to(torch.uint8)


def translate6_batch(dna: torch.Tensor, lengths: torch.Tensor,
                     table: TranslationTable, methionine: bool = False):
    """Translate a padded batch in all six frames.

    Args:
      dna: (B, L) uint8 DNA codes; codes above 4 read as N.
      lengths: (B,) read lengths, taken as clamped to [0, L].

    Returns:
      aa: (B, 6, P) uint8 AA codes, P = L // 3, AA_PAD beyond each
        frame's peptide; pep_lengths: (B, 6) int32 codons per frame.
    """
    B, L = dna.shape
    P = L // 3
    dev = dna.device
    lengths = lengths.to(torch.int64).clamp(0, L)
    d = dna.to(torch.int64)
    fwd = torch.where(d <= 4, d, encoding.DNA_N)
    pos = torch.arange(L, device=dev)
    src = (lengths[:, None] - 1 - pos[None, :]).clamp(min=0)
    rc = torch.gather(fwd, 1, src) if L else fwd
    rc = torch.where(rc < 4, 3 - rc, encoding.DNA_N)
    rc = torch.where(pos[None, :] < lengths[:, None], rc, encoding.DNA_N)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 3), value=encoding.DNA_N)

    lut = torch.as_tensor(table.aa, device=dev).to(torch.int64)
    start = torch.as_tensor(table.start, device=dev)
    j = torch.arange(P, device=dev)
    frames, plens = [], []
    for strand in (pad(fwd), pad(rc)):
        for off in range(3):
            idx = off + 3 * j
            codon = strand[:, idx] * 25 + strand[:, idx + 1] * 5 \
                + strand[:, idx + 2]
            aa = lut[codon]
            if methionine:
                aa = torch.where(start[codon], AA_M, aa)
            ncod = (lengths - off).clamp(min=0) // 3
            aa = torch.where(j[None, :] < ncod[:, None], aa, encoding.AA_PAD)
            frames.append(aa)
            plens.append(ncod)
    return (torch.stack(frames, dim=1).to(torch.uint8),
            torch.stack(plens, dim=1).to(torch.int32))


_LUTS: dict = {}


def _codon_lut(table: TranslationTable, device) -> torch.Tensor:
    """256-byte kernel table: AA per codon at [0, 125), start flags at
    [128, 253)."""
    key = (table.number, str(device))
    if key not in _LUTS:
        lut = torch.zeros(256, dtype=torch.uint8)
        lut[:125] = torch.as_tensor(table.aa)
        lut[128:253] = torch.as_tensor(table.start.astype("uint8"))
        _LUTS[key] = lut.to(device)
    return _LUTS[key]


# K1's reads per block: a sweep over R = 8..64 on the H100 (PERF.md,
# section 6); the kernel halves it for long reads.
READS_PER_BLOCK = 32
# the most dynamic shared memory one block may hold (kSmemMax)
K1_SMEM_MAX = 227 * 1024


def reads_to_kmers_path(length: int, k: int = 9, packed: bool = True) -> str:
    """K1's kernel for reads of ``length``: ``"tile"`` (a block stages
    its reads' codes and residues in shared memory, at least 4 reads a
    block) while 4 reads fit the block's shared memory, else
    ``"direct"`` (one thread an output window, from global memory): the
    kernel's smem_bytes at R = 4."""
    def align16(n):
        return (n + 15) & ~15

    row_bytes = (length + 1) // 2 if packed else length
    codes = 2 * row_bytes if packed else row_bytes
    nres = max(length // 3 - k + 1, 1) + k - 1
    smem = (align16(4 * row_bytes + 16) + 2 * 4 * 6 * 4 + 256
            + align16(4 * codes) + 4 * 6 * nres)
    return "tile" if smem <= K1_SMEM_MAX else "direct"


def reads_to_kmers_plain(reads: torch.Tensor, lengths: torch.Tensor,
                         length: int, table: TranslationTable, k: int = 9,
                         packed: bool = True, methionine: bool = False):
    """Plain version of K1: unpack -> translate6_batch -> windows."""
    dna = unpack_dna4(reads, length) if packed else reads[:, :length]
    aa, plens = translate6_batch(dna, lengths, table, methionine)
    hi, lo, valid = pack_windows_batch(aa, plens, k)
    return hi, lo, valid, plens


def reads_to_kmers(reads: torch.Tensor, lengths: torch.Tensor, length: int,
                   table: TranslationTable, k: int = 9, packed: bool = True,
                   methionine: bool = False):
    """Reads (``(N, ceil(L/2))`` packed4 or ``(N, L)`` codes, uint8) and
    lengths ``(N,)`` -> ``hi``, ``lo`` ``(N, 6, W)`` int32, ``valid``
    ``(N, 6, W)`` bool and ``plens`` ``(N, 6)`` int32, with
    ``W = max(L // 3 - k + 1, 1)``.

    CPU tensors take the plain version; CUDA tensors launch K1."""
    if reads.device.type == "cpu":
        return reads_to_kmers_plain(reads, lengths, length, table, k,
                                    packed, methionine)
    if k > 10:
        raise ValueError("k must be <= 10")
    N = reads.shape[0]
    row_bytes = (length + 1) // 2 if packed else length
    if (reads.dtype != torch.uint8 or reads.dim() != 2
            or reads.shape[1] != row_bytes):
        raise ValueError(f"reads_to_kmers: expected ({N}, {row_bytes}) "
                         f"uint8, got {tuple(reads.shape)} {reads.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (N,):
        raise ValueError("reads_to_kmers: lengths must be (N,) int32")
    kernels.check_cuda("reads_to_kmers", reads, lengths)
    dev = reads.device
    W = max(length // 3 - k + 1, 1)
    hi = torch.empty((N, 6, W), dtype=torch.int32, device=dev)
    lo = torch.empty_like(hi)
    valid = torch.empty((N, 6, W), dtype=torch.bool, device=dev)
    plens = torch.empty((N, 6), dtype=torch.int32, device=dev)
    lut = _codon_lut(table, dev)
    kernels.K1.launch(
        reads.data_ptr(), row_bytes, int(packed), lengths.data_ptr(), N,
        length, k, int(methionine), lut.data_ptr(), hi.data_ptr(),
        lo.data_ptr(), valid.data_ptr(), plens.data_ptr(), W,
        READS_PER_BLOCK, kernels.stream_of(reads))
    return hi, lo, valid, plens
