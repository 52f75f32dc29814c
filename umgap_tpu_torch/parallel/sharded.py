"""Hash-range sharded tables over a mesh of devices and the sharded
analysers (a counterpart of ``umgap_tpu.parallel.sharded``).

``buildindex-dist`` partitions the keys of an index by :func:`owner_of`
into hash-range shards and writes one table a shard, all of one
capacity; ``analyse --mesh N`` over one index splits it the same way on
the host (:func:`build_sharded_tables`, :func:`build_sharded_peptide_tables`).
Serving, each of the mesh's N devices holds ``group`` adjacent shards
stacked along the bucket axis (:class:`ShardedTable`). Reads are data
parallel: each device runs the stages before and after the probe on its
slice of a batch, and each query goes to the device that owns its key
and its answer comes back (:func:`sharded_probe`, the all-to-all of
``umgap_tpu``'s ``sharded_probe_local``), where K2's or K8's grouped
entry picks its sub-table. The mesh is one process over a tuple of
devices (:mod:`.mesh`): the exchange is device-to-device copies, and a
mesh may repeat a device, so the whole routing runs on one card as the
JAX tests run it over virtual CPU devices. A mesh may also span the
processes of ``torch.distributed`` (:class:`~.mesh.ProcessMesh`,
:mod:`.multihost`): a process holds only its own devices' shards, and
the exchange is one ``all_to_all_single`` each way a step for the whole
process.
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
    """The shards of one serving table over a mesh: ``tables``, one
    :class:`~umgap_tpu_torch.ops.lookup.DeviceTable` a device, each of
    ``group`` stacked sub-tables (device ``d`` holds shards ``d * group``
    .. ``d * group + group - 1``), out of ``n_shards`` logical shards in
    all. Over a :class:`~.mesh.ProcessMesh` (``mesh``), ``tables`` are
    this process's devices' and ``d`` is a device's global index."""

    def __init__(self, tables, n_shards: int, mesh=None):
        self.tables = tuple(tables)
        self.n_shards = int(n_shards)
        self.mesh = mesh

    @property
    def table(self) -> DeviceTable:
        """The first device's table (at one device, the whole index)."""
        return self.tables[0]

    @property
    def group(self) -> int:
        return self.table.group

    @property
    def n_devices(self) -> int:
        """This process's devices."""
        return len(self.tables)

    @property
    def kind(self) -> str:
        return self.table.kind

    @property
    def device(self) -> torch.device:
        return self.table.device

    @property
    def devices(self) -> tuple:
        return tuple(t.device for t in self.tables)

    @classmethod
    def from_shards(cls, shards, mesh=None) -> "ShardedTable":
        """Host shard tables over the devices of ``mesh`` (a tuple of
        devices, :func:`~umgap_tpu_torch.parallel.mesh.make_mesh`; a
        single device or None is a mesh of one; or a
        :class:`~.mesh.ProcessMesh`): with N devices each holds
        ``len(shards) / N`` adjacent shards, which N must divide. A
        device's rows go into one preallocated tensor on it shard by
        shard, so the host holds one shard's rows at a time (the shards
        may be memory-mapped artifacts); its stash is its own shards'
        stashes. Over a process mesh N counts every process's devices
        and a local device holds the shards of its global index: the
        other processes' shards are checked but never read or uploaded.
        Shards must share one geometry (peptide shards all but their
        probe depth)."""
        from ..device import resolve_device
        from .mesh import ProcessMesh

        pmesh = mesh if isinstance(mesh, ProcessMesh) else None
        devices = (tuple(resolve_device(d) for d in pmesh.local) if pmesh
                   else tuple(resolve_device(d) for d in mesh)
                   if isinstance(mesh, (tuple, list))
                   else (resolve_device(mesh),))
        n = len(shards)
        n_dev = pmesh.n_devices if pmesh else len(devices)
        if n % n_dev:
            raise ValueError(
                f"{n} shards cannot be grouped onto {n_dev} devices")
        group = n // n_dev
        t0 = shards[0]
        b0 = getattr(t0, "bucket", None)
        # peptide rows hold whole fingerprints, so probing a shard past
        # its own depth finds nothing else: shards of one peptide index
        # may differ in depth and are probed to the deepest (umgap_tpu
        # refuses them, and with them its own --mesh re-split of most
        # peptide indexes); a k-mer row's distance tag is only exact
        # within its table's depth
        for i, t in enumerate(shards):
            if (t.capacity != t0.capacity or t.kind != t0.kind
                    or getattr(t, "bucket", None) != b0
                    or (t.max_probes != t0.max_probes
                        and t0.kind != "peptide")):
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
        kmer = t0.kind == "kmer"
        bucket = getattr(t0, "bucket", BUCKET)
        nb, width = t0.n_buckets, (2 if kmer else 3) * bucket
        max_probes = max(t.max_probes for t in shards)
        tables = []
        for d, dev in enumerate(devices):
            if pmesh:
                d = pmesh.global_index(d)
            mine = shards[d * group:(d + 1) * group]
            rows = torch.empty((group * nb, width), dtype=torch.int32,
                               device=dev)
            for g, t in enumerate(mine):
                rows[g * nb:(g + 1) * nb].copy_(
                    torch.from_numpy(_writable(t.packed_rows())))
            stash = [np.stack([t.stash_hi, t.stash_lo, t.stash_val], axis=1)
                     for t in mine if len(getattr(t, "stash_hi", ()))]
            stash_t = torch.from_numpy(_writable(
                np.concatenate(stash) if stash else np.zeros((0, 3))))
            tables.append(DeviceTable(
                rows, max_probes, t0.kind, t0.nb_bits if kmer else 0,
                bucket, stash_t.reshape(-1, 3).to(dev), group=group,
                first=d * group, n_total=n))
        return cls(tables, n, pmesh)


def _ranks(own: torch.Tensor, n: int) -> torch.Tensor:
    """Each query's rank among the queries of its owner, in their order:
    one scan over the (owner, query) incidence laid out owner-major, less
    the queries of the owners before (a stable sort by owner's ranks,
    without a sort and without a host sync)."""
    b = own.shape[0]
    hot = own[None, :] == torch.arange(n, device=own.device)[:, None]
    cum = hot.reshape(-1).cumsum(0)
    at = own * b + torch.arange(b, device=own.device)
    before = torch.cat([cum.new_zeros(1), cum.view(n, b)[:-1, -1]]) \
        if b else cum.new_zeros(n)
    return cum[at] - before[own] - 1


def sharded_probe(stable: ShardedTable, his, los, valids, stage=None):
    """Look up each device's queries on the device that owns them (the
    routing of ``umgap_tpu.parallel.sharded.sharded_probe_local``,
    umgap_tpu/parallel/sharded.py:264-333): ``his``, ``los``, ``valids``
    hold one tensor of queries a mesh device, on it, of any shape.
    Returns the values, a list of the same shapes; misses and invalid
    queries read 0 (no taxon id is 0).

    Per device: each query's owner device ``owner_of(key, N)`` (0 for an
    invalid one) and its rank among the device's queries of that owner,
    in their order (:func:`_ranks`); the queries go into fixed (N, B)
    send buckets filled with -1 (B the most queries a device has, so no
    step waits on the host); the exchange copies bucket e of device d
    into row d of device e's receive buffer, one copy a (source,
    destination) pair; each device probes what it received in its own
    table (K2 or K8, a grouped table through the grouped entry, whose
    sub-table is ``owner_of(key, n_shards) - first``); the answers go
    back the same way and each query reads its own at (owner, rank).
    Cross-device copies fence the two devices' current streams with
    events (``Tensor.copy_``), so the step never waits on the host; the
    receive buffers are fresh tensors, never views of the send buckets,
    so a mesh that repeats a device copies too. ``stage(name)``, when
    given, wraps the parts: "route", "exchange" (both ways), "probe",
    "unroute".

    Over a :class:`~.mesh.ProcessMesh` of more than one process the
    tensors are this process's devices' and N counts every process's
    devices (:func:`_probe_across_processes`); every process must call
    with queries of one size a device (``global_batch`` pads them so)."""
    from contextlib import nullcontext

    from .. import kernels
    from ..ops import lookup
    from .mesh import on_device

    stage = stage or (lambda _name: nullcontext())
    probe = lookup.probe_plain if kernels.plain_selected() else lookup.probe
    B = max(max(h.numel() for h in his), 1)
    if stable.mesh is not None and stable.mesh.world_size > 1:
        return _probe_across_processes(stable, his, los, valids, stage,
                                       probe, B)
    devs = stable.devices
    N = len(devs)
    valid_f, slots, send = [], [], []
    with stage("route"):
        for d, dev in enumerate(devs):
            with on_device(dev):
                hi, lo = his[d].reshape(-1), los[d].reshape(-1)
                v = valids[d].reshape(-1).to(torch.bool)
                own = torch.where(v, owner_of(hi, lo, N, kind=stable.kind),
                                  0).to(torch.int64)
                # each query's place in the (N, B) buckets
                slot = own * B + _ranks(own, N)
                buf = torch.full((3, N, B), -1, dtype=torch.int32,
                                 device=dev)
                buf.view(3, -1)[:, slot] = torch.stack(
                    [hi, lo, v.to(torch.int32)])
                valid_f.append(v)
                slots.append(slot)
                send.append(buf)
    recv = [torch.empty((3, N, B), dtype=torch.int32, device=dev)
            for dev in devs]
    with stage("exchange"):
        for e in range(N):
            for d in range(N):
                recv[e][:, d].copy_(send[d][:, e])
    vals = []
    with stage("probe"):
        for e, dev in enumerate(devs):
            with on_device(dev):
                r = recv[e]
                vals.append(probe(stable.tables[e], r[0], r[1], r[2] > 0,
                                  0)[0])
    back = [torch.empty((N, B), dtype=torch.int32, device=dev)
            for dev in devs]
    with stage("exchange"):
        for d in range(N):
            for e in range(N):
                back[d][e].copy_(vals[e][d])
    out = []
    with stage("unroute"):
        for d, dev in enumerate(devs):
            with on_device(dev):
                got = back[d].view(-1)[slots[d]]
                out.append(torch.where(valid_f[d], got, 0).reshape(
                    his[d].shape))
    return out


def _probe_across_processes(stable: ShardedTable, his, los, valids, stage,
                            probe, B: int):
    """:func:`sharded_probe` over a mesh of P processes of n devices each
    (N = P n): per local device the same owner and rank, into (P, n, 3,
    B) send buckets (destination rank, its device, hi / lo / valid) filled
    with -1; the local buckets stacked in destination-rank order, (P, n,
    n, 3, B), on the first local device, and one ``all_to_all_single``
    for the whole process sends block p to rank p (:func:`_exchange`);
    each local device takes its rows, (3, N, B) by source global device,
    and probes them in its own table; the answers, stacked (P, n, n, B)
    by the rank and device they came from, go back with one more
    ``all_to_all_single``, and each query reads its own at (owner,
    rank)."""
    from .mesh import on_device

    mesh = stable.mesh
    devs = stable.devices
    P, n, N = mesh.world_size, mesh.n_local, mesh.n_devices
    home = devs[0]
    valid_f, slots, send = [], [], []
    with stage("route"):
        for d, dev in enumerate(devs):
            with on_device(dev):
                hi, lo = his[d].reshape(-1), los[d].reshape(-1)
                v = valids[d].reshape(-1).to(torch.bool)
                own = torch.where(v, owner_of(hi, lo, N, kind=stable.kind),
                                  0).to(torch.int64)
                pos = _ranks(own, N)
                at = own * (3 * B) + pos
                buf = torch.full((N, 3, B), -1, dtype=torch.int32,
                                 device=dev)
                part = torch.arange(3, device=dev)[:, None] * B
                buf.view(-1)[at[None, :] + part] = torch.stack(
                    [hi, lo, v.to(torch.int32)])
                valid_f.append(v)
                slots.append(own * B + pos)
                send.append(buf.view(P, n, 3, B).to(home))
        with on_device(home):
            out = torch.stack(send, 2) if n > 1 else send[0][:, :, None]
    with stage("exchange"):
        got = _exchange(out, stage)
    vals = []
    with stage("probe"):
        for e, dev in enumerate(devs):
            with on_device(dev):
                # (P, n_src, 3, B) -> (3, N, B) by source global device
                r = got[:, e].to(dev).permute(2, 0, 1, 3).reshape(3, N, B)
                vals.append(probe(stable.tables[e], r[0], r[1], r[2] > 0,
                                  0)[0].view(P, n, B).to(home))
        with on_device(home):
            back = torch.stack(vals, 2) if n > 1 else vals[0][:, :, None]
    with stage("exchange"):
        back = _exchange(back, stage)
    res = []
    with stage("unroute"):
        for d, dev in enumerate(devs):
            with on_device(dev):
                ans = back[:, d].to(dev).reshape(-1)[slots[d]]
                res.append(torch.where(valid_f[d], ans, 0).reshape(
                    his[d].shape))
    return res


def _host_staged() -> bool:
    """True when the process group's collectives take host tensors only
    (gloo): CUDA tensors then go through pinned host buffers."""
    import torch.distributed as dist

    return dist.get_backend() == "gloo"


def _exchange(send: torch.Tensor, stage) -> torch.Tensor:
    """One ``all_to_all_single``: block p of ``send``'s first axis (one
    block a rank) goes to rank p, and block p of the result came from
    rank p. Under gloo a CUDA tensor goes device -> pinned host buffer
    -> gloo -> pinned host buffer -> device, each a named stage
    ("exchange/d2h", "exchange/gloo", "exchange/h2d"); under nccl it
    goes as it is."""
    import torch.distributed as dist

    if send.device.type != "cuda" or not _host_staged():
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        return recv
    with stage("exchange/d2h"):
        hsend = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        hsend.copy_(send)
    hrecv = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
    with stage("exchange/gloo"):
        dist.all_to_all_single(hrecv, hsend)
    with stage("exchange/h2d"):
        recv = hrecv.to(send.device, non_blocking=True)
    return recv


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process (``umgap_tpu``'s ``psum`` of the
    rank-frequency vector), on ``t``'s device: one ``dist.all_reduce``
    (through the host under gloo)."""
    import torch.distributed as dist

    if t.device.type == "cuda" and _host_staged():
        h = t.cpu()
        dist.all_reduce(h)
        return h.to(t.device)
    t = t.clone()
    dist.all_reduce(t)
    return t


def rank_counts(dtaxs, taxa) -> torch.Tensor:
    """The rank-frequency vector of the mesh's taxa (float32, n_ranks, on
    the first device): on each device, each of its taxa's
    ``snap_ranked`` rank (0 for an id out of range or unsnappable),
    clipped and counted, as ``umgap_tpu``'s ``_agg_tail`` does
    (umgap_tpu/parallel/sharded.py:355-360); the devices' vectors summed
    on the first (its psum). ``dtaxs`` and ``taxa`` hold one
    DeviceTaxonomy and one taxon tensor a device."""
    from ..taxonomy import NONE

    freq = None
    for dtax, taxon in zip(dtaxs, taxa):
        sr = dtax.snap_ranked
        size = sr.shape[0]
        s = sr[taxon.clamp(0, size - 1).to(torch.int64)]
        ok = (taxon >= 0) & (taxon < size) & (s != NONE)
        r = torch.where(ok, s, 0).clamp(0, size - 1).to(torch.int64)
        # index_add_, not bincount: bincount reads its range on the host
        f = torch.zeros(size, dtype=torch.float32,
                        device=taxon.device).index_add_(
            0, r, torch.ones(r.shape, dtype=torch.float32, device=r.device))
        freq = f if freq is None else freq + f.to(freq.device)
    return freq


class ShardedPipeline(torch.nn.Module):
    """One batch step over the mesh of a sharded table (a counterpart of
    ``umgap_tpu``'s ``make_sharded_pipeline`` and
    ``make_sharded_tryptic_pipeline``, umgap_tpu/parallel/sharded.py:393,
    :441): ``forward(dna4s, lens, length)`` with one slice of the batch a
    mesh device, on it: dna4 (b, E, ceil(L/2)) uint8 on the packed-4
    wire (``packed=False``: codes, (b, E, L)) and lengths (b, E) int32. Each device runs the stage before the
    probe on its reads (K1, or K7 for the tryptic presets), the queries
    go to their owners and back (:func:`sharded_probe`), and each device
    runs the stages after it on its reads (K3, K4 and K6, or K4 and K6),
    reusing the one-device pipeline's stages. Returns the taxa, a (b,)
    int32 list one a device, and with the overflow flags (taxa,
    overflow). ``umgap_tpu``'s step also returns the psum'd
    rank-frequency vector, which no stream reads: here it is
    :func:`rank_counts` of the taxa, taken where it is read."""

    # True runs every stage's plain version (as Pipeline.plain)
    plain = False

    def __init__(self, dtax, stable: ShardedTable, config, tryptic: bool,
                 with_overflow: bool, euler=None):
        super().__init__()
        from ..pipeline import fused, tryptic as tryp

        fused.check_config(config)
        if euler is None and (config.method, config.strategy) == (
                "rmq", "lca*"):
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        self.stable = stable
        self.config = config
        # umgap_tpu's sharded step runs the unscored seed-extend whatever
        # `ranked` says (umgap_tpu/parallel/sharded.py:431-432); so does
        # this one
        self.back_config = config._replace(ranked=False)
        self.with_overflow = with_overflow
        self.front, self.back = ((tryp.tryptic_front, tryp.tryptic_back)
                                 if tryptic else
                                 (fused.kmer_front, fused.kmer_back))
        self.dtaxs = [dtax.to(d) for d in stable.devices]
        self.eulers = [None if euler is None else euler.to(d)
                       for d in stable.devices]

    def forward(self, dna4s, lens, length: int, timer=None,
                packed: bool = True):
        from contextlib import nullcontext

        from .. import kernels
        from .mesh import on_device

        stage = timer or (lambda _name: nullcontext())
        devs = self.stable.devices
        cfg = self.config
        with torch.no_grad(), (kernels.plain_versions() if self.plain
                               else nullcontext()):
            queries, aux = [], []
            for d, dev in enumerate(devs):
                with on_device(dev):
                    b, E = lens[d].shape
                    reads = dna4s[d].reshape(b * E, -1).contiguous()
                    q, a = self.front(reads, lens[d], length, packed, cfg,
                                      stage)
                    queries.append(q)
                    aux.append(a)
            # '-o' (9-mer) and prot2tryp2lca's dropped misses: 0
            taxa = sharded_probe(self.stable,
                                 *(list(x) for x in zip(*queries)),
                                 stage=stage)
            out, over = [], []
            for d, dev in enumerate(devs):
                with on_device(dev):
                    res = self.back(taxa[d], aux[d], lens[d], self.dtaxs[d],
                                    self.back_config, self.with_overflow,
                                    stage, self.eulers[d])
                    out.append(res[0] if self.with_overflow else res)
                    if self.with_overflow:
                        over.append(res[1])
        return (out, over) if self.with_overflow else out


def split_to_mesh(arr: np.ndarray, devices):
    """``arr``'s rows cut into one equal slice a device (its row count a
    multiple of the mesh's), each copied to its device (from pinned
    memory, without waiting, on CUDA)."""
    n = len(arr) // len(devices)
    out = []
    for d, dev in enumerate(devices):
        t = torch.from_numpy(np.ascontiguousarray(arr[d * n:(d + 1) * n]))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out.append(t)
    return out


class ShardedAnalyser:
    """Analyse over the mesh with exact k_max-overflow handling (a
    counterpart of ``umgap_tpu``'s ``ShardedAnalyser``,
    umgap_tpu/parallel/sharded.py:494): the taxa of the stream analyser
    over the mesh (:func:`make_sharded_stream_analyser`, one batch of the
    run's rows, its overflowed groups re-run through the wide step:
    exact), and the rank-frequency vector of those taxa
    (:func:`rank_counts`), which is ``umgap_tpu``'s step vector patched
    for the re-run groups."""

    def __init__(self, dtax, stable: ShardedTable, config,
                 tryptic: bool = False, euler=None, read_length: int = 160,
                 ends: int = 2):
        if euler is None and (config.method, config.strategy) == (
                "rmq", "lca*"):
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        self.dtax = dtax
        self.stable = stable
        self.config = config
        self.tryptic = tryptic
        self.euler = euler
        self.read_length = read_length
        self.ends = ends
        self.dtaxs = [dtax.to(d) for d in stable.devices]
        self.overflow_reads = 0

    def run(self, dna: np.ndarray, lens: np.ndarray):
        """dna (B, E, L) uint8 codes, B a multiple of the mesh size, lens
        (B, E). Returns (taxa (B,), freq (n_ranks,) float32): exact."""
        if dna.shape[1] != self.ends or dna.shape[2] > self.read_length:
            raise ValueError(
                f"batch shape {dna.shape} exceeds the analyser's "
                f"(ends={self.ends}, read_length={self.read_length})")
        B = len(dna)
        an = make_sharded_stream_analyser(
            None, self.stable, self.config, tryptic=self.tryptic,
            batch_size=B, read_length=self.read_length, ends=self.ends,
            dtax=self.dtax, euler=self.euler)
        taxa = np.fromiter((t for _h, t in an.analyse_arrays(
            range(B), dna, lens)), dtype=np.int32, count=B)
        self.overflow_reads += an.overflow_reads
        freq = rank_counts(self.dtaxs, split_to_mesh(taxa,
                                                     self.stable.devices))
        return taxa, freq.cpu().numpy()


def _mesh_analyser(tryptic: bool):
    """The streaming analyser over a mesh of more than one device: the
    port's :class:`~umgap_tpu_torch.pipeline.runner.Analyser` (its
    batching, depth-2 dispatch and wide re-route) with the
    :class:`ShardedPipeline` as its step, each batch split over the
    devices."""
    from .. import kernels
    from ..pipeline.runner import Analyser, wide_batch_rows
    from ..pipeline.tryptic import TrypticAnalyser

    # the base gives the batching, dispatch and the wide program's k_max
    class MeshAnalyser(TrypticAnalyser if tryptic else Analyser):
        def __init__(self, tax, stable: ShardedTable, config,
                     batch_size: int, read_length: int, ends: int, dtax,
                     euler):
            self.stable = stable
            super().__init__(tax, None, config, batch_size=batch_size,
                             read_length=read_length, ends=ends, dtax=dtax,
                             dtable=stable.table, device=stable.device,
                             euler=euler)

        def _make_step(self, config, with_overflow: bool):
            return ShardedPipeline(self.dtax, self.stable, config, tryptic,
                                   with_overflow, self.euler)

        @property
        def _wide_batch(self) -> int:
            # umgap_tpu's max(N, (64 // N) * N) rows, each device's
            # share bounded as the one-device wide program's batch
            n = self.stable.n_devices
            per = wide_batch_rows(self.device.type, self.config.method,
                                  self.config.strategy, self._exact_kmax(),
                                  kernels.plain_selected() or self.step.plain)
            return n * max(1, min(64 // n, per))

        def _run_step(self, step, dna4, lens):
            devs = self.stable.devices
            return step(split_to_mesh(dna4, devs), split_to_mesh(lens, devs),
                        self.read_length)

        def _dispatch_packed(self, dna4, lens):
            taxa, over = self._run_step(self.step, dna4, lens)
            taxa = [self._to_host(t) for t in taxa]
            over = [self._to_host(o) for o in over]
            events = []
            if self.device.type == "cuda":
                for dev in self.stable.devices:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                    events.append(ev)
            return taxa, over, events

        def _collect(self, handle, n):
            taxa, over, events = handle
            for ev in events:
                ev.synchronize()
            taxa = torch.cat(taxa).numpy().copy()
            overflow = torch.cat(over).numpy().copy()
            overflow[n:] = False
            idx = np.nonzero(overflow)[0]
            self.overflow_reads += len(idx)
            return taxa, idx

        def run_wide_packed(self, dna4, lens):
            wide = self._wide()
            W = self._wide_batch
            out = np.empty(len(dna4), dtype=np.int32)
            for s in range(0, len(dna4), W):
                nd, nl = dna4[s:s + W], lens[s:s + W]
                m = len(nd)
                if m < W:
                    nd = np.pad(nd, ((0, W - m), (0, 0), (0, 0)),
                                constant_values=0x44)
                    nl = np.pad(nl, ((0, W - m), (0, 0)))
                taxa = self._run_step(wide, nd, nl)
                out[s:s + m] = torch.cat([t.cpu() for t in taxa]).numpy()[:m]
            return out

    return MeshAnalyser


def make_sharded_stream_analyser(tax, stable: ShardedTable, config,
                                 tryptic: bool = False,
                                 batch_size: int = 16384,
                                 read_length: int = 160, ends: int = 2,
                                 dtax=None, euler=None):
    """The streaming analyser over a sharded table, as ``analyse
    --shards`` and ``--mesh`` serve (a counterpart of ``umgap_tpu``'s,
    umgap_tpu/parallel/sharded.py:598). On one device: the port's
    :class:`~umgap_tpu_torch.pipeline.runner.Analyser` (or
    :class:`~umgap_tpu_torch.pipeline.tryptic.TrypticAnalyser`) over the
    grouped table, whose overflowed groups re-run through its wide
    program. On more: the same analyser with the mesh step
    (:class:`ShardedPipeline`), a batch split over the devices (its size
    a multiple of theirs), overflowed groups re-run through the wide mesh
    step in batches padded with N codes (0x44)."""
    from ..agg.device import DeviceTaxonomy
    from ..pipeline.runner import Analyser
    from ..pipeline.tryptic import TrypticAnalyser

    if dtax is None:
        dtax = DeviceTaxonomy.from_host(tax, stable.device)
    n_dev = stable.n_devices
    if n_dev == 1:
        cls = TrypticAnalyser if tryptic else Analyser
        return cls(tax, None, config, batch_size=batch_size,
                   read_length=read_length, ends=ends, dtax=dtax,
                   dtable=stable.table, device=stable.device, euler=euler)
    if batch_size % n_dev:
        raise ValueError(
            f"batch size {batch_size} not divisible by the {n_dev}-device "
            "mesh")
    return _mesh_analyser(tryptic)(tax, stable, config, batch_size,
                                   read_length, ends, dtax, euler)
