"""The index probe: ``DeviceTable`` and kernel K2
(``csrc/probe_kmer.cu``), with its plain PyTorch version.

K-mer tables are quotient-stored (see :mod:`umgap_tpu_torch.index.table`):
buckets of (30-bit remainder + probe-distance bit, value), one row
``[remainders | values]`` of ``2 * bucket`` int32 per bucket, plus a
full-key stash. The stash is kept sorted by ``(hi, lo)`` so that the
kernel can binary-search it; keys are unique, so the order changes no
result.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

M32 = 0xFFFFFFFF
MAX_STASH = 4096  # stash rows the kernel holds in shared memory
KERNEL_BUCKETS = (4, 8, 16, 64)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    leaving the int64 range."""
    lo16, hi16 = c & 0xFFFF, c >> 16
    return (x * lo16 + (((x * hi16) & 0xFFFF) << 16)) & M32


def _mx(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix_key_torch(hi: torch.Tensor, lo: torch.Tensor):
    """:func:`umgap_tpu_torch.index.table.mix_key` on tensors: int64
    results holding the uint32 (mhi, mlo)."""
    h = hi.to(torch.int64) & M32
    l = lo.to(torch.int64) & M32
    l = l ^ (_mx((h + 0x9E3779B1) & M32) & 0x1FFFFFF)
    h = h ^ (_mx((l + 0x85EBCA77) & M32) & 0xFFFFF)
    l = l ^ (_mx((h + 0xC2B2AE3D) & M32) & 0x1FFFFFF)
    return h, l


def _writable(a) -> np.ndarray:
    """A contiguous, writable int32 array (memory-mapped artifacts are
    read-only; torch refuses to wrap those without a copy)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
    return a if a.flags.writeable else a.copy()


class DeviceTable:
    """A k-mer table on one device: ``rows`` (n_buckets, 2 * bucket)
    int32, ``stash`` (S, 3) int32 [hi, lo, value] sorted by (hi, lo),
    and the probe geometry."""

    def __init__(self, rows: torch.Tensor, max_probes: int, kind: str,
                 nb_bits: int, bucket: int, stash: torch.Tensor | None = None,
                 group: int = 1):
        self.rows = rows
        self.max_probes = int(max_probes)
        self.kind = kind
        self.nb_bits = int(nb_bits)
        self.bucket = int(bucket)
        self.group = int(group)
        if stash is None:
            stash = torch.zeros((0, 3), dtype=torch.int32, device=rows.device)
        s = stash.to(torch.int64)
        keys = (s[:, 0] << 32) | (s[:, 1] & M32)
        order = torch.argsort(keys, stable=True)
        self.stash = stash[order].contiguous()
        self.stash_keys = keys[order].contiguous()

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def n_buckets(self) -> int:
        return self.rows.shape[0] // self.group

    def to(self, device) -> "DeviceTable":
        return DeviceTable(self.rows.to(device), self.max_probes, self.kind,
                           self.nb_bits, self.bucket, self.stash.to(device),
                           self.group)

    @classmethod
    def from_arrays(cls, rows, stash, max_probes: int, kind: str,
                    nb_bits: int, bucket: int, group: int = 1,
                    device=None) -> "DeviceTable":
        """From numpy arrays (a host table's rows, or the JAX package's
        device arrays brought back to the host)."""
        from ..device import resolve_device

        dev = resolve_device(device)
        rows_t = torch.from_numpy(_writable(rows))
        stash_t = torch.from_numpy(_writable(
            np.zeros((0, 3)) if stash is None else stash).reshape(-1, 3))
        return cls(rows_t.to(dev), max_probes, kind, nb_bits, bucket,
                   stash_t.to(dev), group)

    @classmethod
    def from_host(cls, table, device=None) -> "DeviceTable":
        if table.kind != "kmer":
            raise NotImplementedError(f"{table.kind} tables are not ported")
        if len(table.stash_hi):
            stash = np.stack([table.stash_hi, table.stash_lo,
                              table.stash_val], axis=1).astype(np.int32)
        else:
            stash = None
        return cls.from_arrays(table.packed_rows(), stash, table.max_probes,
                               "kmer", table.nb_bits, table.bucket,
                               device=device)


def _check_supported(table: DeviceTable) -> None:
    if table.kind != "kmer":
        raise NotImplementedError(
            f"probe of {table.kind!r} tables is not ported yet")
    if table.group != 1:
        raise NotImplementedError("grouped tables (sub) are not ported yet")


def probe_plain(table: DeviceTable, hi: torch.Tensor, lo: torch.Tensor,
                valid: torch.Tensor | None = None, default: int = 0):
    """Plain version of K2 (``umgap_tpu.ops.lookup._probe_dense``, kmer
    branch): every round gathers all queries' rows at once."""
    _check_supported(table)
    shape = hi.shape
    dev = hi.device
    hi = hi.reshape(-1).to(torch.int64)
    lo = lo.reshape(-1).to(torch.int64)
    live0 = (torch.ones(hi.shape, dtype=torch.bool, device=dev)
             if valid is None else valid.reshape(-1).to(torch.bool))
    out = torch.full(hi.shape, default, dtype=torch.int32, device=dev)
    found = torch.zeros(hi.shape, dtype=torch.bool, device=dev)
    nb, nb_bits, bk = table.n_buckets, table.nb_bits, table.bucket
    mhi, mlo = mix_key_torch(hi, lo)
    bucket = mlo & (nb - 1)
    rem = (mlo >> nb_bits) | (mhi << (25 - nb_bits))
    live = live0.clone()
    for r in range(table.max_probes + 1):
        row = table.rows[bucket]
        rr, rv = row[:, :bk], row[:, bk:2 * bk]
        hit = rr == (rem | (min(r, 1) << 30))[:, None]
        anyhit = hit.any(dim=-1)
        val = torch.where(hit, rv, 0).sum(dim=-1).to(torch.int32)
        newly = live & anyhit
        out = torch.where(newly, val, out)
        found |= newly
        live &= ~anyhit & ~(rr == -1).any(dim=-1)
        bucket = (bucket + 1) & (nb - 1)
    if table.stash.shape[0]:
        keys = (hi << 32) | (lo & M32)
        idx = torch.searchsorted(table.stash_keys, keys)
        idx = idx.clamp(max=table.stash.shape[0] - 1)
        shit = (table.stash_keys[idx] == keys) & live0
        out = torch.where(shit, table.stash[idx, 2], out)
        found |= shit
    return out.reshape(shape), found.reshape(shape)


def probe(table: DeviceTable, hi: torch.Tensor, lo: torch.Tensor,
          valid: torch.Tensor | None = None, default: int = 0):
    """Look up packed keys; returns (values int32, found bool), misses and
    invalid lanes give ``default`` (0 is the reference's ``-o``).

    CPU tensors take :func:`probe_plain`; CUDA tensors launch K2."""
    if hi.device.type == "cpu":
        return probe_plain(table, hi, lo, valid, default)
    _check_supported(table)
    if table.bucket not in KERNEL_BUCKETS:
        raise ValueError(f"probe_kmer: bucket {table.bucket} has no kernel "
                         f"instantiation ({KERNEL_BUCKETS})")
    S = table.stash.shape[0]
    if S > MAX_STASH:
        raise ValueError(f"probe_kmer: stash of {S} > {MAX_STASH} rows")
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    if (hi.dtype != torch.int32 or lo.dtype != torch.int32
            or valid.dtype != torch.bool or lo.shape != hi.shape
            or valid.shape != hi.shape):
        raise ValueError("probe_kmer: hi, lo int32 and valid bool of one "
                         "shape expected")
    kernels.check_cuda("probe_kmer", hi, lo, valid, table.rows, table.stash)
    if table.rows.data_ptr() % 16:
        raise ValueError("probe_kmer: rows must be 16-byte aligned")
    out = torch.empty(hi.shape, dtype=torch.int32, device=hi.device)
    found = torch.empty(hi.shape, dtype=torch.bool, device=hi.device)
    kernels.K2.launch(
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
        table.rows.data_ptr(), table.n_buckets, table.nb_bits, table.bucket,
        table.max_probes, table.stash.data_ptr(), S, int(default),
        out.data_ptr(), found.data_ptr(), kernels.stream_of(hi))
    return out, found
