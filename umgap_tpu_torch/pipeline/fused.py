"""The 9-mer analysis pipeline as one chain of device stages.

The composition of the reference's preset pipelines
(scripts/umgap-analyse.sh:276-311):

    translate -a | prot2kmer2lca -m -o | seedextend -gG -sS
                 | uniq -d / | taxa2agg -lL [-m rmq -a mrtl | -a ...]

over a padded batch of read pairs. On CUDA the chain is
K1 reads_to_kmers -> K2 probe_kmer -> K3 seed-extend (the hits
epilogue: the kept taxa, with no keep mask and no select pass; with
``ranked`` its scored entry, the best-scoring seed of each frame) ->
K4 dedup_counts with the lower-bound filter at its stores -> the
aggregator with snap: one K6 tree_aggregate launch for tree/lca*,
tree/hybrid and rmq/mrtl, which reads the taxonomy rows of the valid
hits itself and writes the snapped taxon; one K9 rmq_aggregate launch
for rmq/lca* and rmq/hybrid, which walks or closes the valid hits over
the Euler tables or the taxonomy rows and snaps at its store. On
the CPU every stage runs its plain version. ``run_stages(..., plain=True)``
composes the plain versions on any device (inside
:func:`~umgap_tpu_torch.kernels.plain_versions`): it is the reference
the kernels are held against on the card, and no entry point uses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import kernels
from ..agg import device as devagg
from ..ops import encoding, lookup, seedextend, translate


class PipelineConfig(NamedTuple):
    """One preset's parameters (umgap-analyse.sh:276-311)."""

    name: str
    k: int = 9
    min_seed_size: int = 2
    max_gap_size: int = 1
    lower_bound: float = 1.0
    method: str = "rmq"
    strategy: str = "mrtl"
    factor: float = 0.25
    table_number: int = 1
    # Per-read distinct-taxa capacity of the fast program; reads with
    # more are flagged (with_overflow) and re-run by the Analyser through
    # a program wide enough to be exact.
    k_max: int = 64
    # scored seed-extend (`seedextend -r`, src/commands/seedextend.rs:
    # 151-164): a frame keeps only its best-scoring extended seed,
    # unscored taxa costing `penalty`. No preset uses it.
    ranked: bool = False
    penalty: int = 5


PRESETS = {
    "max-sensitivity": PipelineConfig(
        "max-sensitivity", min_seed_size=2, max_gap_size=1, lower_bound=1.0,
        method="rmq", strategy="mrtl"),
    "high-sensitivity": PipelineConfig(
        "high-sensitivity", min_seed_size=3, max_gap_size=1, lower_bound=1.0,
        method="tree", strategy="hybrid", factor=0.25),
    "high-precision": PipelineConfig(
        "high-precision", min_seed_size=3, max_gap_size=1, lower_bound=2.0,
        method="tree", strategy="lca*"),
    "max-precision": PipelineConfig(
        "max-precision", min_seed_size=4, max_gap_size=1, lower_bound=5.0,
        method="tree", strategy="lca*"),
}

# the first four stages' wrappers and plain versions, by name in
# _OP_MODULES, looked up at each batch
_KERNEL_OPS = ("reads_to_kmers", "probe", "seedextend_hits",
               "dedup_counts")
_PLAIN_OPS = tuple(name + "_plain" for name in _KERNEL_OPS)
_OP_MODULES = (translate, lookup, seedextend, devagg)


def check_config(config: PipelineConfig) -> None:
    """Refuse, before any batch, a method/strategy pair that taxa2agg
    cannot combine (src/commands/taxa2agg.rs:111-140)."""
    if (config.method, config.strategy) not in \
            devagg.SUPPORTED_AGGREGATIONS:
        raise ValueError(
            f"{config.method} and {config.strategy} cannot be combined")


def run_stages(reads, lengths, length: int, packed: bool,
               dtax: devagg.DeviceTaxonomy, dtable: lookup.DeviceTable,
               config: PipelineConfig, with_overflow: bool = False,
               plain: bool = False, timer=None, euler=None):
    """One batch: reads (B*E, row) uint8 (packed4 or codes), lengths
    (B, E) int32 -> taxon (B,) int32 [, overflow (B,) bool]. ``euler``
    (a :class:`~umgap_tpu_torch.agg.device_rmq.DeviceEuler`) is needed
    by rmq/lca*.

    ``timer``, when given, is a callable ``timer(name)`` returning a
    context manager around each stage (used for per-stage timings)."""
    from contextlib import nullcontext

    with kernels.plain_versions() if plain else nullcontext():
        return _stages(reads, lengths, length, packed, dtax, dtable, config,
                       with_overflow, timer or (lambda _name: nullcontext()),
                       euler)


def _ops():
    """The four stages' functions: the kernels' wrappers, or inside
    :func:`~umgap_tpu_torch.kernels.plain_versions` their plain
    versions."""
    names = _PLAIN_OPS if kernels.plain_selected() else _KERNEL_OPS
    return tuple(getattr(m, n) for m, n in zip(_OP_MODULES, names))


def kmer_front(reads, lengths, length: int, packed: bool,
               config: PipelineConfig, stage):
    """The stage before the probe: reads (B*E, row) uint8, lengths (B, E)
    -> the probe's queries (hi, lo, valid) and what
    :func:`kmer_back` needs of the reads (the protein lengths)."""
    with stage("reads_to_kmers"):
        hi, lo, wvalid, plens = _ops()[0](
            reads, lengths.reshape(-1), length,
            encoding.get_table(config.table_number), config.k,
            packed=packed)
    return (hi, lo, wvalid), plens


def kmer_back(taxa, plens, lengths, dtax, config: PipelineConfig,
              with_overflow: bool, stage, euler):
    """The stages after the probe: the probe's taxa (B*E, 6, W) int32
    (misses and invalid windows 0) -> taxon (B,) [, overflow (B,)]."""
    _r2k, _probe, seedext, dedup = _ops()
    B, E = lengths.shape
    scored = (dict(seed_scores=dtax.seed_scores, penalty=config.penalty)
              if config.ranked else {})
    with stage("seedextend"):
        W = taxa.shape[-1]
        nkmers = (plens - (config.k - 1)).clamp(min=0)
        hits = seedext(taxa, nkmers, config.min_seed_size,
                       config.max_gap_size, **scored).reshape(B, E * 6 * W)
    return aggregate_hits(hits, dtax, config, with_overflow, stage, euler,
                          dedup)


def _stages(reads, lengths, length, packed, dtax, dtable, config,
            with_overflow, stage, euler):
    (hi, lo, wvalid), plens = kmer_front(reads, lengths, length, packed,
                                         config, stage)
    with stage("probe"):
        # '-o': misses and invalid windows read 0
        taxa, _found = _ops()[1](dtable, hi, lo, wvalid, 0)
    return kmer_back(taxa, plens, lengths, dtax, config, with_overflow,
                     stage, euler)


def aggregate_hits(hits, dtax, config, with_overflow, stage, euler, dedup):
    """The stages after the probe, shared with the tryptic pipeline:
    hits (B, N) int32 (0 = none) -> taxon (B,) [, overflow (B,)]:
    ``dedup`` (K4 or its plain version) with the lower-bound filter, then
    the aggregator with snap (taxa2agg's count, filter, aggregate and
    snap; umgap_tpu/pipeline/fused.py:114-124)."""
    with stage("dedup"):
        utaxa, ucounts, uvalid, nuniq = dedup(
            hits, None, config.k_max, return_nuniq=True,
            lower_bound=config.lower_bound)
    with stage("aggregate"):
        taxon = devagg.aggregate_batch(dtax, utaxa, ucounts, uvalid,
                                       config.method, config.strategy,
                                       config.factor, euler=euler,
                                       snap=dtax.snap_valid)
    if with_overflow:
        return taxon, nuniq > config.k_max
    return taxon


def pipeline_step(dna, lengths, dtax: devagg.DeviceTaxonomy,
                  dtable: lookup.DeviceTable, config: PipelineConfig,
                  with_overflow: bool = False, euler=None):
    """One fused batch step on DNA codes.

    Args:
      dna: (B, E, L) uint8 DNA codes (E = reads per group, e.g. 2 ends).
      lengths: (B, E) int32.

    Returns:
      taxon (B,) int32, the consensus taxon per read group (1 when no hit
      survives); with ``with_overflow`` also (B,) bool marking groups
      with more than ``config.k_max`` distinct surviving taxa.
    """
    check_config(config)
    B, E, L = dna.shape
    return run_stages(dna.reshape(B * E, L).contiguous(), lengths, L, False,
                      dtax, dtable, config, with_overflow, euler=euler)


class Pipeline(nn.Module):
    """``make_pipeline``'s module: holds the device state and runs one
    batch of the 4-bit packed wire per call,
    ``forward(dna4, lengths, length)`` with dna4 (B, E, ceil(L/2)) uint8
    (:func:`encoding.pack_dna4`), lengths (B, E) int32 and the unpacked
    width L."""

    # True runs every stage's plain version (see run_stages)
    plain = False

    def __init__(self, dtax, dtable, config: PipelineConfig,
                 with_overflow: bool, euler=None):
        super().__init__()
        check_config(config)
        if euler is None and (config.method, config.strategy) == (
                "rmq", "lca*"):
            raise ValueError("rmq/lca* needs a DeviceEuler (pass euler=...)")
        self.dtax = dtax
        self.dtable = dtable
        self.euler = euler
        self.config = config
        self.with_overflow = with_overflow

    def forward(self, dna4, lengths, length: int, timer=None):
        B, E = lengths.shape
        reads = dna4.reshape(B * E, dna4.shape[-1]).contiguous()
        with torch.no_grad():
            return run_stages(reads, lengths, length, True, self.dtax,
                              self.dtable, self.config, self.with_overflow,
                              self.plain, timer, self.euler)


def make_pipeline(dtax: devagg.DeviceTaxonomy, dtable: lookup.DeviceTable,
                  config: PipelineConfig, wire: str = "packed4",
                  with_overflow: bool = False, device=None,
                  euler=None) -> Pipeline:
    """The per-batch step as a module over device-resident state, on
    ``device`` (default: the current CUDA device; state elsewhere is
    moved there). The port has the ``packed4`` wire only; DNA codes go
    through :func:`pipeline_step`. rmq/lca* needs ``euler``."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dtax.device != dev:
        dtax = dtax.to(dev)
    if dtable.device != dev:
        dtable = dtable.to(dev)
    if euler is not None and euler.device != dev:
        euler = euler.to(dev)
    if wire != "packed4":
        raise ValueError(f"unsupported wire {wire!r}: packed4 only")
    return Pipeline(dtax, dtable, config, with_overflow, euler)
