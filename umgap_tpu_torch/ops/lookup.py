"""The index probe: ``DeviceTable``, kernels K2 (``csrc/probe_kmer.cu``,
k-mer tables) and K8 (``csrc/probe_peptide.cu``, peptide tables), with
their plain PyTorch versions.

K-mer tables are quotient-stored (see :mod:`umgap_tpu_torch.index.table`):
buckets of (30-bit remainder + probe-distance bit, value), one row
``[remainders | values]`` of ``2 * bucket`` int32 per bucket, plus a
full-key stash. The stash is kept sorted by ``(hi, lo)`` so that the
kernel can binary-search it; keys are unique, so the order changes no
result. Peptide tables have rows ``[key_hi | key_lo | values]`` of
``3 * 8`` int32, bucket :func:`hash32_torch` of the fingerprint, and no
stash.

A grouped table (``group > 1``, k-mer or peptide) holds ``group``
hash-range shards (:mod:`umgap_tpu_torch.parallel.sharded`) stacked
along the bucket axis, each of ``n_buckets`` rows, and (k-mer tables)
their stashes merged: a device's slice of an index of ``n_total``
shards, from shard ``first`` on (all of them on one device: ``first =
0``, ``n_total = group``). A query probes the sub-table its key's
:func:`~umgap_tpu_torch.parallel.sharded.owner_of` over ``n_total``
names, less ``first`` and clipped to the group, with linear probing
wrapping inside it: K2's and K8's grouped entries.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels

M32 = 0xFFFFFFFF
KERNEL_BUCKETS = (4, 8, 16, 64)
# K8's query slots a lane loads a window (a warp's window is 32 x this
# many slots, compacted to its valid queries): 1, 2 or 4; 2 from
# chip_smoke.py's sweep on the H100.
QUERIES_PER_LANE = 2


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


def hash32_torch(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """:func:`umgap_tpu_torch.index.table.hash32` on tensors: an int64
    result holding the uint32 hash (the peptide tables' bucket hash)."""
    h = (_mul32(hi.to(torch.int64) & M32, 0x9E3779B1)
         ^ _mul32(lo.to(torch.int64) & M32, 0x85EBCA77))
    h = h ^ (h >> 16)
    h = _mul32(h, 0xC2B2AE3D)
    return h ^ (h >> 13)


def _writable(a) -> np.ndarray:
    """A contiguous, writable int32 array (memory-mapped artifacts are
    read-only; torch refuses to wrap those without a copy)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
    return a if a.flags.writeable else a.copy()


class DeviceTable:
    """A table on one device: ``rows`` (group * n_buckets, 2 * bucket)
    int32 for k-mer tables, (group * n_buckets, 3 * bucket) for peptide
    tables, ``stash`` (S, 3) int32 [hi, lo, value] sorted by (hi, lo)
    (k-mer tables only), and the probe geometry: ``group`` sub-tables,
    shards ``first`` .. ``first + group - 1`` of the ``n_total`` shards
    of one index (default: all of them here)."""

    def __init__(self, rows: torch.Tensor, max_probes: int, kind: str,
                 nb_bits: int, bucket: int, stash: torch.Tensor | None = None,
                 group: int = 1, first: int = 0, n_total: int | None = None):
        self.rows = rows
        self.max_probes = int(max_probes)
        self.kind = kind
        self.nb_bits = int(nb_bits)
        self.bucket = int(bucket)
        self.group = int(group)
        self.first = int(first)
        self.n_total = self.group if n_total is None else int(n_total)
        if not 0 <= self.first <= self.n_total - self.group:
            raise ValueError(
                f"shards {self.first}..{self.first + self.group - 1} are "
                f"not a slice of {self.n_total}")
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
                           self.group, self.first, self.n_total)

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
        if table.kind == "peptide":
            return cls.from_arrays(table.packed_rows(), None,
                                   table.max_probes, "peptide", 0,
                                   table.bucket, device=device)
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
    if table.kind not in ("kmer", "peptide"):
        raise NotImplementedError(
            f"probe of {table.kind!r} tables is not ported")


def sub_tables(table: DeviceTable, hi: torch.Tensor,
               lo: torch.Tensor) -> torch.Tensor:
    """Each key's sub-table of a grouped table: its owner among the
    ``n_total`` shards less ``first``, clipped to the ``group`` held
    here (what K2's and K8's grouped entries compute;
    umgap_tpu/parallel/sharded.py:314-320)."""
    from ..parallel.sharded import owner_of

    own = owner_of(hi, lo, table.n_total, kind=table.kind)
    return (own - table.first).clamp(0, table.group - 1)


def probe_plain(table: DeviceTable, hi: torch.Tensor, lo: torch.Tensor,
                valid: torch.Tensor | None = None, default: int = 0,
                sub: torch.Tensor | None = None):
    """Plain version of K2 and K8 (``umgap_tpu.ops.lookup._probe_dense``,
    kmer and peptide branches): every round gathers all queries' rows at
    once. On a grouped table ``sub`` is each query's sub-table (default
    :func:`sub_tables` of the keys); the row is ``sub * n_buckets +
    bucket``."""
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
    if table.group > 1:
        if sub is None:
            sub = sub_tables(table, hi, lo)
        base = sub.reshape(-1).to(torch.int64) * nb
    else:
        base = 0
    peptide = table.kind == "peptide"
    if peptide:
        bucket = hash32_torch(hi, lo) & (nb - 1)
    else:
        mhi, mlo = mix_key_torch(hi, lo)
        bucket = mlo & (nb - 1)
        rem = (mlo >> nb_bits) | (mhi << (25 - nb_bits))
    live = live0.clone()
    for r in range(table.max_probes + 1):
        row = table.rows[base + bucket]
        rk = row[:, :bk]
        if peptide:
            hit = (rk == hi[:, None]) & (row[:, bk:2 * bk] == lo[:, None])
            rv = row[:, 2 * bk:3 * bk]
        else:
            hit = rk == (rem | (min(r, 1) << 30))[:, None]
            rv = row[:, bk:2 * bk]
        anyhit = hit.any(dim=-1)
        val = torch.where(hit, rv, 0).sum(dim=-1).to(torch.int32)
        newly = live & anyhit
        out = torch.where(newly, val, out)
        found |= newly
        live &= ~anyhit & ~(rk == -1).any(dim=-1)
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
    """Look up packed keys (k-mer tables) or fingerprints (peptide
    tables); returns (values int32, found bool), misses and invalid lanes
    give ``default`` (0 is the reference's ``-o``).

    CPU tensors take :func:`probe_plain`; CUDA tensors launch K2 (k-mer
    tables) or K8 (peptide tables), a grouped table through the kernel's
    grouped entry."""
    if hi.device.type == "cpu":
        return probe_plain(table, hi, lo, valid, default)
    _check_supported(table)
    if table.kind == "peptide":
        return _probe_peptide(table, hi, lo, valid, default)
    if table.bucket not in KERNEL_BUCKETS:
        raise ValueError(f"probe_kmer: bucket {table.bucket} has no kernel "
                         f"instantiation ({KERNEL_BUCKETS})")
    S = table.stash.shape[0]
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
        out.data_ptr(), found.data_ptr(), table.group, table.first,
        table.n_total, kernels.stream_of(hi))
    return out, found


def _probe_peptide(table: DeviceTable, hi, lo, valid, default: int):
    """K8's launch (its grouped entry on a grouped table): a warp
    compacts each window of 32 x ``QUERIES_PER_LANE`` slots to its valid
    queries and keeps their rows in flight together."""
    if valid is None:
        valid = torch.ones(hi.shape, dtype=torch.bool, device=hi.device)
    if (hi.dtype != torch.int32 or lo.dtype != torch.int32
            or valid.dtype != torch.bool or lo.shape != hi.shape
            or valid.shape != hi.shape):
        raise ValueError("probe_peptide: hi, lo int32 and valid bool of one "
                         "shape expected")
    if table.bucket != 8 or table.rows.shape[-1] != 24:
        raise ValueError("probe_peptide: rows must be (n_buckets, 24) int32")
    kernels.check_cuda("probe_peptide", hi, lo, valid, table.rows)
    if table.rows.data_ptr() % 16:
        raise ValueError("probe_peptide: rows must be 16-byte aligned")
    out = torch.empty(hi.shape, dtype=torch.int32, device=hi.device)
    found = torch.empty(hi.shape, dtype=torch.bool, device=hi.device)
    kernels.K8.launch(
        hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
        table.rows.data_ptr(), table.n_buckets, table.max_probes,
        int(default), out.data_ptr(), found.data_ptr(), QUERIES_PER_LANE,
        table.group, table.first, table.n_total, kernels.stream_of(hi))
    return out, found
