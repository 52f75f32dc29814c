"""The protein pipelines behind the FragGeneScan++ front end (a
counterpart of ``umgap_tpu.pipeline.proteins``).

When FGSpp supplies predicted proteins, the precision presets skip the
six-frame translation and run ``prot2kmer2lca | seedextend | uniq |
taxa2agg`` over the gene records (scripts/umgap-analyse.sh:299-311).
Each read group carries up to E predicted genes as lanes, where the
9-mer pipeline has 6 frames an end. On CUDA one batch is
K1P proteins_to_kmers (``csrc/reads_to_kmers.cu``'s protein entry) ->
K2 probe_kmer -> K3 seed-extend (hits) -> K4 dedup with the lower-bound
filter -> K6 with snap (K9 with snap for the Euler/RMQ aggregators),
the stages of :mod:`.fused` after translation; on the CPU every stage
runs its plain version. The tryptic presets digest the proteins on the
host (prot2tryp2lca, exact) and probe and aggregate on the device: K8,
K4, K6.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from .. import kernels
from ..agg import device as devagg
from ..device import state_device
from ..ops import encoding, kmers, lookup, seedextend
from .fused import Pipeline, PipelineConfig, aggregate_hits, check_config
from .runner import Analyser
from .tryptic import digest_protein_groups, make_tryptic_pipeline

# the first three stages' wrappers and plain versions, by name in
# _OP_MODULES, looked up at each batch
_KERNEL_OPS = ("proteins_to_kmers", "probe", "seedextend_hits",
               "dedup_counts")
_PLAIN_OPS = ("pack_windows_batch", "probe_plain", "seedextend_hits_plain",
              "dedup_counts_plain")
_OP_MODULES = (kmers, lookup, seedextend, devagg)


def run_protein_stages(aa, plens, dtax: devagg.DeviceTaxonomy,
                       dtable: lookup.DeviceTable, config: PipelineConfig,
                       with_overflow: bool = False, plain: bool = False,
                       timer=None, euler=None):
    """One batch: aa (B, E, P) uint8 AA codes, plens (B, E) int32 ->
    taxon (B,) int32 [, overflow (B,) bool], with the stage names and
    switches of :func:`~umgap_tpu_torch.pipeline.fused.run_stages`."""
    stage = timer or (lambda _name: nullcontext())
    with kernels.plain_versions() if plain else nullcontext():
        names = _PLAIN_OPS if kernels.plain_selected() else _KERNEL_OPS
        p2k, probe, seedext, dedup = (getattr(m, n)
                                      for m, n in zip(_OP_MODULES, names))
        B, E, P = aa.shape
        lanes = plens.reshape(-1)
        with stage("proteins_to_kmers"):
            hi, lo, wvalid = p2k(aa.reshape(B * E, P), lanes, config.k)
        with stage("probe"):
            # '-o': misses and invalid windows read 0
            taxa, _found = probe(dtable, hi, lo, wvalid, 0)
        with stage("seedextend"):
            nkmers = (lanes - (config.k - 1)).clamp(min=0)
            hits = seedext(taxa, nkmers, config.min_seed_size,
                           config.max_gap_size).reshape(B, -1)
        return aggregate_hits(hits, dtax, config, with_overflow, stage,
                              euler, dedup)


def protein_pipeline_step(aa, plens, dtax, dtable, config: PipelineConfig,
                          euler=None, with_overflow: bool = False):
    """The fused 9-mer pipeline minus translation: (B, E, P) AA codes
    with E gene lanes a read group -> the consensus taxon a group."""
    check_config(config)
    with torch.no_grad():
        return run_protein_stages(aa, plens, dtax, dtable, config,
                                  with_overflow, euler=euler)


class ProteinPipeline(Pipeline):
    """:class:`~umgap_tpu_torch.pipeline.fused.Pipeline` with the protein
    stages: ``forward(aa, plens, length)`` on (B, E, P) AA codes
    (``length`` is P; there is no packed wire)."""

    def forward(self, aa, plens, length: int = 0, timer=None):
        with torch.no_grad():
            return run_protein_stages(aa, plens, self.dtax, self.dtable,
                                      self.config, self.with_overflow,
                                      self.plain, timer, self.euler)


class ProteinAnalyser(Analyser):
    """The streaming :class:`~umgap_tpu_torch.pipeline.runner.Analyser`
    (batching, depth-2 dispatch, the k_max re-route) over FGSpp gene
    groups: the inputs are AA codes (B, E, P), ``ends`` the gene lanes
    and ``read_length`` the protein width bucket. AA codes need 5 bits,
    so there is no 4-bit wire (gene batches are small beside the read
    stream)."""

    def _make_step(self, config: PipelineConfig, with_overflow: bool):
        return ProteinPipeline(self.dtax, self.dtable, config, with_overflow,
                               self.euler)

    def _exact_kmax(self) -> int:
        return self.ends * max(self.read_length - 8, 1)

    # the step takes the AA codes as they are, as it takes the packed
    # wire: the packed dispatch and wide re-run serve (a wide batch's pad
    # rows have length 0, so their bytes never matter)
    def _dispatch(self, aa, lens):
        return self._dispatch_packed(aa, lens)

    def run_wide(self, aa: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Exact results for (n, E, P) AA rows through the wide program."""
        return self.run_wide_packed(aa, lens)


def encode_protein_groups(groups, ends: int, length: int):
    """(header, [proteins]) groups -> (B, E, P) AA codes + lengths (gene
    lanes beyond ``ends`` and residues beyond ``length`` clip: callers
    bucket both from the sample's maxima)."""
    B = len(groups)
    aa = np.zeros((B, ends, length), dtype=np.uint8)
    lens = np.zeros((B, ends), dtype=np.int32)
    for i, (_h, prots) in enumerate(groups):
        for e, p in enumerate(prots[:ends]):
            codes = encoding.encode_aa(p)[:length]
            aa[i, e, :len(codes)] = codes
            lens[i, e] = len(codes)
    return aa, lens


def _batch_rows(batch_size: int, n_groups: int) -> int:
    """The power of two that holds ``n_groups`` (at least 2), at most
    ``batch_size``."""
    return min(batch_size, 1 << max(1, (n_groups - 1)).bit_length())


def analyse_protein_groups(groups, tax, table, config: PipelineConfig,
                           batch_size: int = 1024, dtax=None, dtable=None,
                           analyser_cache=None, device=None):
    """FGSpp gene groups through the 9-mer precision pipeline (exact:
    lane count and width bucket from the sample's maxima; overflowing
    groups re-run in the wide program). Yields (header, taxon) in order.
    ``analyser_cache`` keeps analysers across samples with matching
    shape buckets; the device is that of ``dtable``/``dtax``, else
    ``device``. The tryptic presets' host digest of gene groups is
    :func:`~umgap_tpu_torch.pipeline.tryptic.digest_protein_groups`."""
    groups = list(groups)
    if not groups:
        return
    ends = max(1, max(len(p) for _h, p in groups))
    width = max(16, max((len(s) for _h, ps in groups for s in ps),
                        default=16))
    # powers of two, so few shapes recur
    ends = 1 << (ends - 1).bit_length()
    width = 1 << (width - 1).bit_length()
    B = _batch_rows(batch_size, len(groups))
    key = (config, B, width, ends)
    an = analyser_cache.get(key) if analyser_cache is not None else None
    if an is None:
        an = ProteinAnalyser(tax, table, config, batch_size=B,
                             read_length=width, ends=ends, dtax=dtax,
                             dtable=dtable,
                             device=state_device(dtax, dtable, device))
        if analyser_cache is not None:
            analyser_cache[key] = an
    else:
        an.reset()
    for i in range(0, len(groups), B):
        chunk = groups[i:i + B]
        aa, lens = encode_protein_groups(chunk, ends, width)
        yield from an.feed([h for h, _ in chunk], aa, lens)
    yield from an.finish()


def analyse_tryptic_protein_groups(groups, tax, table,
                                   config: PipelineConfig,
                                   batch_size: int = 1024,
                                   max_peptides: int = 128,
                                   dtax=None, dtable=None,
                                   step_cache=None, device=None):
    """FGSpp gene groups through prot2tryp2lca + taxa2agg (the digest on
    the host, the probe and aggregation on the device of
    ``dtable``/``dtax``, else ``device``). Yields (header, taxon) in
    order."""
    groups = list(groups)
    if not groups:
        return
    dev = state_device(dtax, dtable, device)
    dtax = dtax if dtax is not None \
        else devagg.DeviceTaxonomy.from_host(tax, dev)
    dtable = dtable if dtable is not None \
        else lookup.DeviceTable.from_host(table, dev)
    B = _batch_rows(batch_size, len(groups))
    step = step_cache.get(config) if step_cache is not None else None
    if step is None:
        step = make_tryptic_pipeline(dtax, dtable, config)
        if step_cache is not None:
            step_cache[config] = step
    for i in range(0, len(groups), B):
        chunk = groups[i:i + B]
        padded = chunk + [("", [])] * (B - len(chunk))
        hi, lo, valid = (torch.from_numpy(x).to(dev) for x in
                         digest_protein_groups(padded, max_peptides))
        taxa = step(hi, lo, valid).cpu().numpy()
        for (header, _), t in zip(chunk, taxa[:len(chunk)]):
            yield header, int(t)
