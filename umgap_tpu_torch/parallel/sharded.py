"""Hash-range sharded tables and the sharded analysers, at one device
(a counterpart of ``umgap_tpu.parallel.sharded``).

``buildindex-dist`` partitions the keys of an index by :func:`owner_of`
into hash-range shards and writes one table a shard, all of one
capacity. Serving such an artifact, a device holds ``group`` adjacent
shards stacked along the bucket axis (:class:`ShardedTable`), and a
query probes the sub-table its key's owner names. On one device the
group is the whole artifact and ``umgap_tpu``'s all-to-all routing of
queries to their owner device (``sharded_probe_local``) is the
identity, so it has no counterpart here: K2's grouped entry computes
each query's sub-table from its key (``ops/lookup.py``). The sharded
analyser is the port's :class:`~umgap_tpu_torch.pipeline.runner.Analyser`
over the grouped table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.table import BUCKET, MIN_NB_BITS, PeptideTable, \
    _fingerprints, _pow2_capacity, build_kmer_table, hash32
from ..ops import kmers as kmerops
from ..ops.lookup import DeviceTable, _writable, hash32_torch


def owner_of(hi, lo, n_shards: int, kind: str = "kmer"):
    """Shard owner by range-partitioning a hash's upper 16 bits: numpy
    arrays on the host, tensors on their device (int32 either way).

    ``kmer``: the k-mer probe's bucket index comes from ``mix_key``'s
    low bits, so ``hash32``'s top bits are independent of it.
    ``peptide``: the peptide probe's bucket index is ``hash32(hi, lo)``
    (low bits), so the owner mixes the swapped lanes instead."""
    if kind == "peptide":
        hi, lo = lo, hi
    if isinstance(hi, torch.Tensor):
        top = hash32_torch(hi, lo) >> 16
        return ((top * int(n_shards)) >> 16).to(torch.int32)
    top = (hash32(hi, lo) >> np.uint32(16)).astype(np.uint32)
    return ((top * np.uint32(n_shards)) >> np.uint32(16)).astype(np.int32)


def build_sharded_tables(packed: np.ndarray, values: np.ndarray, k: int,
                         n_shards: int, load_factor: float = 0.4,
                         layout: str = "bucket8s"):
    """Split keys by owner and build per-shard tables with one common
    capacity (rectangular stacked rows), as ``umgap_tpu`` does: a shard
    that fails its probe limits doubles the common capacity for itself
    and the shards after it, and shards built smaller are rebuilt at the
    end. The shards build on a thread each (numpy releases the GIL), the
    ones after a failed shard again at the doubled capacity, so the
    tables are those of the build in shard order."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    packed = np.asarray(packed).astype(np.uint64)
    values = np.asarray(values, dtype=np.int32)
    hi, lo = kmerops.split_packed(packed)
    owner = owner_of(hi, lo, n_shards)
    parts = [np.flatnonzero(owner == s) for s in range(n_shards)]
    max_n = max((len(p) for p in parts), default=1)
    cap = _pow2_capacity(max_n, load_factor, BUCKET << MIN_NB_BITS)

    def build(s, cap):
        return build_kmer_table(packed[parts[s]], values[parts[s]], k,
                                layout=layout, capacity=cap)

    def attempt(s, cap):
        try:
            return build(s, cap)
        except RuntimeError:  # past the probe limits at this capacity
            return None

    shards: list = []
    with ThreadPoolExecutor(min(n_shards, os.cpu_count() or 1)) as ex:
        while len(shards) < n_shards:
            built = list(ex.map(lambda s, c=cap: attempt(s, c),
                                range(len(shards), n_shards)))
            ok = next((j for j, t in enumerate(built) if t is None),
                      len(built))
            shards += built[:ok]
            if len(shards) < n_shards:
                cap *= 2
        stale = [i for i, t in enumerate(shards) if t.capacity != cap]
        for i, t in zip(stale, ex.map(lambda s: build(s, cap), stale)):
            shards[i] = t
    return shards


def build_sharded_peptide_tables(peptides, values: np.ndarray,
                                 n_shards: int, load_factor: float = 0.45,
                                 store_keys: bool = False):
    """Partition tryptic peptides by fingerprint owner and build
    per-shard :class:`~umgap_tpu_torch.index.table.PeptideTable`s of one
    common capacity."""
    peptides = list(peptides)
    values = np.asarray(values, dtype=np.int32)
    hi, lo = _fingerprints(peptides)
    owner = owner_of(hi, lo, n_shards, kind="peptide")
    max_n = max((int((owner == s).sum()) for s in range(n_shards)),
                default=1)
    cap = _pow2_capacity(max_n, load_factor, 64)
    return [PeptideTable.build(
        [p for p, o in zip(peptides, owner) if o == s], values[owner == s],
        capacity=cap, store_keys=store_keys) for s in range(n_shards)]


class ShardedTable:
    """The shards of one serving table on this device: ``table``, a
    :class:`~umgap_tpu_torch.ops.lookup.DeviceTable` of ``group`` stacked
    sub-tables, out of ``n_shards`` logical shards in all."""

    def __init__(self, table: DeviceTable, n_shards: int):
        self.table = table
        self.n_shards = int(n_shards)

    @property
    def group(self) -> int:
        return self.table.group

    @property
    def n_devices(self) -> int:
        return self.n_shards // self.group

    @property
    def kind(self) -> str:
        return self.table.kind

    @property
    def device(self) -> torch.device:
        return self.table.device

    @classmethod
    def from_shards(cls, shards, device=None) -> "ShardedTable":
        """Stack host shard tables onto one device (the port's world is
        one device: the multi-rank --mesh slice of ROADMAP splits them).
        The rows go into one preallocated device tensor shard by shard,
        so the host holds one shard's rows at a time (the shards may be
        memory-mapped artifacts). Shards must share one geometry."""
        from ..device import resolve_device

        n = len(shards)
        t0 = shards[0]
        b0 = getattr(t0, "bucket", None)
        for i, t in enumerate(shards):
            if (t.capacity != t0.capacity or t.kind != t0.kind
                    or getattr(t, "bucket", None) != b0
                    or t.max_probes != t0.max_probes):
                raise ValueError(
                    f"shard {i} geometry mismatch: capacity="
                    f"{t.capacity} kind={t.kind} "
                    f"bucket={getattr(t, 'bucket', None)} "
                    f"max_probes={t.max_probes} vs shard 0's "
                    f"capacity={t0.capacity} kind={t0.kind} bucket={b0} "
                    f"max_probes={t0.max_probes} "
                    "— shards of one serving table must share one "
                    "layout (mixed bucket16/bucket64s/bucket64d "
                    "artifacts in one workdir?)")
        if t0.kind not in ("kmer", "peptide"):
            raise NotImplementedError(f"{t0.kind} tables are not ported")
        dev = resolve_device(device)
        kmer = t0.kind == "kmer"
        bucket = getattr(t0, "bucket", BUCKET)
        nb, width = t0.n_buckets, (2 if kmer else 3) * bucket
        rows = torch.empty((n * nb, width), dtype=torch.int32, device=dev)
        for g, t in enumerate(shards):
            rows[g * nb:(g + 1) * nb].copy_(
                torch.from_numpy(_writable(t.packed_rows())))
        stash = [np.stack([t.stash_hi, t.stash_lo, t.stash_val], axis=1)
                 for t in shards if len(getattr(t, "stash_hi", ()))]
        stash_t = torch.from_numpy(_writable(
            np.concatenate(stash) if stash else np.zeros((0, 3))))
        table = DeviceTable(rows, max(t.max_probes for t in shards),
                            t0.kind, t0.nb_bits if kmer else 0, bucket,
                            stash_t.reshape(-1, 3).to(dev), group=n)
        return cls(table, n)


def make_sharded_stream_analyser(tax, stable: ShardedTable, config,
                                 tryptic: bool = False,
                                 batch_size: int = 16384,
                                 read_length: int = 160, ends: int = 2,
                                 dtax=None, euler=None):
    """The streaming analyser over a sharded table, as ``analyse
    --shards`` serves: the port's
    :class:`~umgap_tpu_torch.pipeline.runner.Analyser` (or
    :class:`~umgap_tpu_torch.pipeline.tryptic.TrypticAnalyser`) over the
    sharded table, a :class:`~umgap_tpu_torch.pipeline.runner.BatchStream`
    whose overflowed reads re-run through its wide program
    (``run_wide_packed``). One device holds every shard, so a batch
    needs no split."""
    from ..agg.device import DeviceTaxonomy
    from ..pipeline.runner import Analyser
    from ..pipeline.tryptic import TrypticAnalyser

    if dtax is None:
        dtax = DeviceTaxonomy.from_host(tax, stable.device)
    cls = TrypticAnalyser if tryptic else Analyser
    return cls(tax, None, config, batch_size=batch_size,
               read_length=read_length, ends=ends, dtax=dtax,
               dtable=stable.table, device=stable.device, euler=euler)
