"""Processes across hosts (a counterpart of ``umgap_tpu.parallel.
multihost``, over ``torch.distributed`` where it has ``jax.distributed``).

``umgap_tpu`` forms one global (host, chip) mesh: the index is sharded
over every chip of every host, each host ingests only its slice of the
read groups, queries go to their owner shards with ``all_to_all`` and
come back, and the rank-frequency vectors merge with one ``psum``. Here
the same shape runs over the processes of ``torch.distributed``:

* :func:`init_distributed` joins the process group (gloo or nccl, the
  caller's choice); :func:`pod_mesh` / :func:`flat_mesh` are the global
  mesh as a :class:`~.mesh.ProcessMesh`: this process's local devices,
  global device ``rank * n_local + d``;
* :func:`per_host_groups` is a process's contiguous slice of the read
  groups, :func:`global_batch` cuts its rows over its local devices,
  padded so that every process steps with one shape;
* :func:`make_multihost_pipeline` / :func:`make_multihost_tryptic_pipeline`
  split the index on the host into one shard a global device and upload
  this process's shards only; a step routes each query to its owner
  with one ``all_to_all_single`` each way for the whole process
  (:func:`~.sharded.sharded_probe`, through K2's or K8's grouped entry)
  and sums the rank frequencies with one ``all_reduce``;
  :func:`allgather_taxa` brings every process's taxa together.

gloo takes host tensors: CUDA tensors go through pinned host buffers. nccl
takes CUDA tensors, one card a rank: two ranks on one card are refused
(NCCL itself refuses a "duplicate GPU").
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import ProcessMesh, make_mesh

BACKENDS = ("gloo", "nccl")


def _card_identity(device) -> tuple:
    """Which card ``device`` is, across hosts: (host name, card UUID)."""
    import socket

    return (socket.gethostname(),
            str(torch.cuda.get_device_properties(device).uuid))


def _init_group(backend, init_method, world_size, rank) -> None:
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def refuse_shared_cards(cards: Sequence) -> None:
    """Raise if two ranks name one card (``cards[r]``: rank r's
    :func:`_card_identity`): nccl runs one card a rank."""
    seen: dict = {}
    for r, card in enumerate(cards):
        if tuple(card) in seen:
            raise ValueError(
                f"backend 'nccl' needs one card a rank: ranks "
                f"{seen[tuple(card)]} and {r} both use card {card[1]} on "
                f"{card[0]} (NCCL refuses a duplicate GPU); give each rank "
                "its own card, or use backend='gloo'")
        seen[tuple(card)] = r


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> None:
    """Join the process group (``dist.init_process_group``): idempotent,
    and nothing at ``world_size <= 1``, as ``umgap_tpu``'s is
    (umgap_tpu/parallel/multihost.py:34-50). ``init_method`` is a
    ``tcp://host:port`` address (None: ``env://``, the ``MASTER_ADDR``
    / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` variables).

    ``backend`` is ``"gloo"`` (the default: host tensors; CUDA tensors are
    staged through pinned host memory) or ``"nccl"`` (CUDA tensors, one
    card a rank: ``device``, else the current card; two ranks on one
    card are refused before NCCL would fail on them)."""
    if world_size is not None and int(world_size) <= 1:
        return
    if dist.is_initialized():
        return
    backend = backend or "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    card = None
    if backend == "nccl":
        from ..device import resolve_device

        dev = resolve_device(device if device is not None else "cuda")
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices; use "
                             "backend='gloo' on the CPU")
        torch.cuda.set_device(dev)
        card = _card_identity(dev)
    _init_group(backend, init_method, world_size, rank)
    if card is not None:
        # a side group of gloo asks every rank for its card before any
        # NCCL communicator exists
        side = dist.new_group(backend="gloo")
        cards: list = [None] * dist.get_world_size()
        dist.all_gather_object(cards, card, group=side)
        try:
            refuse_shared_cards(cards)
        except ValueError:
            dist.destroy_process_group()
            raise


def _process_mesh(local, device, shape) -> ProcessMesh:
    local = make_mesh(None, device) if local is None else make_mesh(
        devices=local)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if world > 1:
        counts: list = [None] * world
        dist.all_gather_object(counts, len(local))
        if len(set(counts)) != 1:
            raise ValueError(f"every process needs the same number of local "
                             f"devices; the ranks have {counts}")
    return ProcessMesh(rank, world, local,
                       shape(world, len(local)))


def pod_mesh(local=None, device=None) -> ProcessMesh:
    """The global (processes, local devices) grid, host-major: row r is
    rank r's local devices (umgap_tpu/parallel/multihost.py:53).
    ``local`` is this process's tuple of devices (it may repeat one);
    None takes :func:`~.mesh.make_mesh` of ``device``: every visible
    card, or with ``device="cpu"`` one CPU entry."""
    return _process_mesh(local, device, lambda w, n: (w, n))


def flat_mesh(local=None, device=None) -> ProcessMesh:
    """Every process's devices on one flat axis, host-major
    (umgap_tpu/parallel/multihost.py:67): what the table shards and the
    read batches split over."""
    return _process_mesh(local, device, lambda w, n: (w * n,))


def per_host_groups(groups: Sequence, process_id: int,
                    num_processes: int) -> List:
    """A process's contiguous slice of the read groups, ``ceil(n / P)``
    a process, the last one short (umgap_tpu/parallel/multihost.py:77):
    each process opens and parses only its share of the input."""
    n = len(groups)
    per = (n + num_processes - 1) // num_processes
    return list(groups[process_id * per:(process_id + 1) * per])


def _collective_tensor(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the process group's collectives take it: the host
    under gloo, its device under nccl."""
    from .sharded import _host_staged

    return t.cpu() if _host_staged() else t


def global_batch(local_dna: np.ndarray, local_lengths: np.ndarray,
                 mesh: ProcessMesh, rows: Optional[int] = None):
    """This process's read groups as its part of a global batch
    (umgap_tpu/parallel/multihost.py:87): codes (b, E, L) uint8 and
    lengths (b, E) padded to ``rows`` rows (None: the most any process
    has, one ``all_reduce``), rounded up to a multiple of the local
    devices, with groups of N codes and length 0, then cut into one
    slice a local device and copied there (from pinned memory on CUDA).
    Every process so steps with one shape. Returns (dna slices, length
    slices)."""
    from ..ops import encoding
    from .sharded import split_to_mesh

    n = len(local_dna)
    if rows is None:
        rows = n
        if mesh.world_size > 1:
            t = _collective_tensor(torch.tensor([n], device=mesh.local[0]))
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            rows = int(t.item())
    rows = -(-max(int(rows), 1) // mesh.n_local) * mesh.n_local
    if n > rows:
        raise ValueError(f"{n} local groups past the batch's {rows} rows")
    dna = np.asarray(local_dna, dtype=np.uint8)
    lens = np.asarray(local_lengths, dtype=np.int32)
    if n < rows:
        dna = np.concatenate([dna, np.full((rows - n,) + dna.shape[1:],
                                           encoding.DNA_N, np.uint8)])
        lens = np.concatenate([lens, np.zeros((rows - n,) + lens.shape[1:],
                                              np.int32)])
    return split_to_mesh(dna, mesh.local), split_to_mesh(lens, mesh.local)


def allgather_taxa(taxa: torch.Tensor, mesh: ProcessMesh,
                   n: Optional[int] = None) -> np.ndarray:
    """Every process's taxa in rank order, on the host (``umgap_tpu``'s
    ``process_allgather(..., tiled=True)``); with ``n``, each process's
    first ``n`` rows (its real groups) only. Every process calls it with
    taxa of one shape."""
    if mesh.world_size == 1:
        got = taxa.cpu().numpy()
        return got if n is None else got[:n]
    t = _collective_tensor(taxa.contiguous())
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t)
    keep = [len(t)] * mesh.world_size
    if n is not None:
        c = _collective_tensor(torch.tensor([n], device=taxa.device))
        counts = [torch.empty_like(c) for _ in range(mesh.world_size)]
        dist.all_gather(counts, c)
        keep = [int(x.item()) for x in counts]
    return np.concatenate([p[:k].cpu().numpy() for p, k in zip(parts, keep)])


def _real_rows(taxa, n: Optional[int]):
    """Each local device's slice of ``taxa`` cut to the process's first
    ``n`` rows (the rest are :func:`global_batch`'s padding)."""
    if n is None:
        return taxa
    out, start = [], 0
    for t in taxa:
        out.append(t[:max(0, min(len(t), n - start))])
        start += len(t)
    return out


def make_multihost_step(dtax, stable, config, tryptic: bool = False):
    """The step over a table already sharded over a process mesh
    (``stable``: :meth:`~.sharded.ShardedTable.from_shards` over a
    :class:`~.mesh.ProcessMesh`, e.g. a ``buildindex-dist`` artifact's
    shards): ``step(dna, lengths, n=None, timer=None)`` takes
    :func:`global_batch`'s slices and returns this process's taxa (one
    tensor on its first local device; ``n``: its real rows, the rest
    padding) and the rank-frequency vector of the real rows of every
    process (umgap_tpu/parallel/sharded.py:355-361, its ``psum``).
    ``timer`` is :class:`~.sharded.ShardedPipeline`'s."""
    from .sharded import ShardedPipeline, all_reduce_sum, rank_counts

    mesh = stable.mesh
    pipe = ShardedPipeline(dtax, stable, config, tryptic=tryptic,
                           with_overflow=False)

    def step(dna, lengths, n: Optional[int] = None, timer=None):
        taxa = pipe(dna, lengths, dna[0].shape[-1], timer=timer,
                    packed=False)
        freq = rank_counts(pipe.dtaxs, _real_rows(taxa, n))
        if mesh.world_size > 1:
            freq = all_reduce_sum(freq)
        home = mesh.local[0]
        return torch.cat([t.to(home) for t in taxa]), freq

    return step


def make_multihost_pipeline(tax, packed: np.ndarray, values: np.ndarray,
                            k: int, config, mesh: Optional[ProcessMesh] = None,
                            device=None):
    """The 9-mer step over every process
    (umgap_tpu/parallel/multihost.py:99): the keys split on the host into
    one hash-range shard a global device (``build_sharded_tables``), this
    process's shards uploaded, K1 / K2's grouped entry / K3 / K4 / K6
    under :class:`~.sharded.ShardedPipeline`. ``mesh`` is
    :func:`flat_mesh` of ``device`` when None. Returns (mesh, step); see
    :func:`make_multihost_step`."""
    from ..agg.device import DeviceTaxonomy
    from .sharded import ShardedTable, build_sharded_tables

    mesh = flat_mesh(device=device) if mesh is None else mesh
    shards = build_sharded_tables(packed, values, k=k,
                                  n_shards=mesh.n_devices)
    stable = ShardedTable.from_shards(shards, mesh)
    dtax = DeviceTaxonomy.from_host(tax, mesh.local[0])
    return mesh, make_multihost_step(dtax, stable, config)


def make_multihost_tryptic_pipeline(tax, peptides, values: np.ndarray,
                                    config,
                                    mesh: Optional[ProcessMesh] = None,
                                    device=None):
    """The tryptic step over every process
    (umgap_tpu/parallel/multihost.py:118): peptide fingerprints split by
    owner into one shard a global device, this process's uploaded, K7 /
    K8's grouped entry / K4 / K6. Returns (mesh, step)."""
    from ..agg.device import DeviceTaxonomy
    from .sharded import ShardedTable, build_sharded_peptide_tables

    mesh = flat_mesh(device=device) if mesh is None else mesh
    shards = build_sharded_peptide_tables(peptides, values,
                                          n_shards=mesh.n_devices)
    stable = ShardedTable.from_shards(shards, mesh)
    dtax = DeviceTaxonomy.from_host(tax, mesh.local[0])
    return mesh, make_multihost_step(dtax, stable, config, tryptic=True)
