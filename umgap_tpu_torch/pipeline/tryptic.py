"""The tryptic presets (a counterpart of ``umgap_tpu.pipeline.tryptic``).

The reference's tryptic presets run FragGeneScan++, then
``prot2tryp2lca -l9 -L45 | uniq -d / | taxa2agg``
(scripts/umgap-analyse.sh:289-298). Here, as in ``umgap_tpu``, six-frame
translation is the protein front end. On CUDA one batch is
K7 reads_to_peptides (``csrc/reads_to_peptides.cu``: unpack, six-frame
translation, the tryptic digest and the FNV fingerprints, fused) ->
K8 probe_peptide (``csrc/probe_peptide.cu``; misses dropped, as
prot2tryp2lca without ``-o``) -> K4 dedup with the lower-bound filter ->
K6 (rmq/mrtl) with snap; on the CPU every stage runs its plain
version. :func:`analyse_tryptic_groups` is the host-digest route for
records longer than ``--read-length``: the digest on the host
(:func:`digest_groups`), the probe and the aggregation on the device.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..agg import device as devagg
from ..index import table as _table
from ..index.table import fingerprints_matrix
from ..ops import encoding, kmers, lookup, translate
from .fused import Pipeline, PipelineConfig, aggregate_hits, check_config
from .runner import Analyser

TRYPTIC_PRESETS = {
    "tryptic-sensitivity": PipelineConfig(
        "tryptic-sensitivity", lower_bound=1.0, method="rmq",
        strategy="mrtl"),
    "tryptic-precision": PipelineConfig(
        "tryptic-precision", lower_bound=5.0, method="rmq", strategy="mrtl"),
}

MIN_PEP, MAX_PEP = 9, 45

# the index's FNV constants (one definition for host and device)
_FNV_OFFSET, _FNV_OFFSET2, _FNV_PRIME = (int(c) for c in (
    _table._FNV_OFFSET, _table._FNV_OFFSET2, _table._FNV_PRIME))
_M32 = 0xFFFFFFFF
_AA_K, _AA_R, _AA_P = 10, 17, 15  # 'K', 'R', 'P' - 'A'
# K7's reads per block, one thread a (read, frame) lane (halved by the
# kernel for long reads); 64 from chip_smoke.py's sweep on the H100
READS_PER_BLOCK = 64


def digest_groups(groups: Sequence[Tuple[str, Sequence[str]]],
                  max_peptides: int, table_number: int = 1,
                  min_len: int = MIN_PEP, max_len: int = MAX_PEP):
    """Translate all six frames of each end on the host, then
    :func:`digest_protein_groups` of the peptides."""
    table = encoding.get_table(table_number)
    return digest_protein_groups(
        [(h, [pep for seq in seqs for pep in translate.translate_sequence(
            seq, translate.FRAME_NAMES, table)]) for h, seqs in groups],
        max_peptides, min_len, max_len)


def digest_protein_groups(groups, max_peptides: int,
                          min_len: int = MIN_PEP, max_len: int = MAX_PEP):
    """Host tryptic digest of (header, [proteins]) groups, as
    prot2tryp2lca -l9 -L45 does: the fragments of ``min_len..max_len``
    residues, fingerprinted. Returns numpy (hi, lo, valid) of shape
    (B, W), W the power-of-two multiple of ``max_peptides`` that holds
    the widest group's fragments: nothing is dropped."""
    B = len(groups)
    all_codes: List[np.ndarray] = []
    owners: List[Tuple[int, int]] = []
    counts = np.zeros(B, dtype=np.int64)
    for b, (_header, peps) in enumerate(groups):
        for pep in peps:
            for frag in kmers.tryptic_digest(pep):
                if min_len <= len(frag) <= max_len:
                    owners.append((b, int(counts[b])))
                    all_codes.append(encoding.encode_aa(frag))
                    counts[b] += 1
    W = max_peptides
    widest = int(counts.max()) if B else 0
    while W < widest:
        W *= 2
    hi = np.zeros((B, W), dtype=np.int32)
    lo = np.zeros((B, W), dtype=np.int32)
    valid = np.zeros((B, W), dtype=bool)
    if all_codes:
        L = max(len(c) for c in all_codes)
        mat = np.zeros((len(all_codes), L), dtype=np.uint8)
        lens = np.zeros(len(all_codes), dtype=np.int64)
        for i, c in enumerate(all_codes):
            mat[i, :len(c)] = c
            lens[i] = len(c)
        h1, h2 = fingerprints_matrix(mat, lens)
        rows, slots = np.asarray(owners).T
        hi[rows, slots] = h1
        lo[rows, slots] = h2
        valid[rows, slots] = True
    return hi, lo, valid


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding uint32 values -> int32 of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def tryptic_digest_plain(aa: torch.Tensor, plens: torch.Tensor,
                         min_len: int = MIN_PEP, max_len: int = MAX_PEP):
    """The tryptic digest with FNV fingerprints over a padded batch of
    peptides, as ``umgap_tpu.pipeline.tryptic.tryptic_digest_device``
    computes it: a fragment boundary falls after every K/R whose
    successor is a member and not P, and at every '*' (dropped);
    fragments outside ``min_len..max_len`` are dropped.

    Args:
      aa: (R, P) uint8 AA codes (anything beyond ``plens``).
      plens: (R,) valid lengths.

    Returns:
      h1, h2 (R, F) int32 and valid (R, F) bool, F = P // min_len + 1:
      the fragments left-compacted in their order, 0 in the slots after.
    """
    R, P = aa.shape
    dev = aa.device
    a = aa.to(torch.int64)
    pos = torch.arange(P, device=dev)
    member = (pos[None, :] < plens.to(torch.int64)[:, None]) & (
        a != encoding.AA_STOP)
    no = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    nxt_a = torch.cat([a[:, 1:], torch.full((R, 1), -1, device=dev)], 1)
    nxt_member = torch.cat([member[:, 1:], no], 1)
    cleave = (member & ((a == _AA_K) | (a == _AA_R)) & nxt_member
              & (nxt_a != _AA_P))
    newfrag = member & ~torch.cat([no, member[:, :-1]], 1) | (
        member & torch.cat([no, cleave[:, :-1]], 1))
    frag_end = member & (~nxt_member | cleave)
    h1 = torch.full((R,), _FNV_OFFSET, dtype=torch.int64, device=dev)
    h2 = torch.full((R,), _FNV_OFFSET2, dtype=torch.int64, device=dev)
    ln = torch.zeros(R, dtype=torch.int64, device=dev)
    e1 = torch.empty((R, P), dtype=torch.int64, device=dev)
    e2 = torch.empty_like(e1)
    elen = torch.empty_like(e1)
    for j in range(P):
        nf = newfrag[:, j]
        h1 = torch.where(nf, _FNV_OFFSET, h1)
        h2 = torch.where(nf, _FNV_OFFSET2, h2)
        ln = torch.where(nf, 0, ln)
        m = member[:, j]
        c = a[:, j]
        h1 = torch.where(m, ((h1 ^ c) * _FNV_PRIME) & _M32, h1)
        h2 = torch.where(m, ((h2 ^ (c + 0x9E37)) * _FNV_PRIME) & _M32, h2)
        ln = torch.where(m, ln + 1, ln)
        e1[:, j], e2[:, j], elen[:, j] = h1, h2, ln
    emit = frag_end & (elen >= min_len) & (elen <= max_len)
    e1 = torch.where(e1 == _M32, 0, e1)
    F = P // min_len + 1
    slot = torch.cumsum(emit.to(torch.int64), dim=1) - 1
    col = torch.where(emit & (slot < F), slot, F)  # column F is dropped
    out1 = torch.zeros((R, F + 1), dtype=torch.int64, device=dev)
    out2 = torch.zeros_like(out1)
    valid = torch.zeros((R, F + 1), dtype=torch.bool, device=dev)
    out1.scatter_(1, col, torch.where(emit, e1, 0))
    out2.scatter_(1, col, torch.where(emit, e2, 0))
    valid.scatter_(1, col, emit)
    return _as_int32(out1[:, :F]), _as_int32(out2[:, :F]), valid[:, :F]


def reads_to_peptides_plain(reads: torch.Tensor, lengths: torch.Tensor,
                            length: int, table: encoding.TranslationTable,
                            packed: bool = True):
    """Plain version of K7: unpack -> translate6_batch ->
    :func:`tryptic_digest_plain`."""
    dna = translate.unpack_dna4(reads, length) if packed \
        else reads[:, :length]
    aa, plens = translate.translate6_batch(dna, lengths, table)
    N, _six, P = aa.shape
    return tryptic_digest_plain(aa.reshape(N * 6, P), plens.reshape(-1))


def reads_to_peptides(reads: torch.Tensor, lengths: torch.Tensor,
                      length: int, table: encoding.TranslationTable,
                      packed: bool = True):
    """Reads (``(N, ceil(L/2))`` packed4 or ``(N, L)`` codes, uint8) and
    lengths ``(N,)`` -> ``h1``, ``h2`` ``(N * 6, F)`` int32 and ``valid``
    ``(N * 6, F)`` bool, F = (L // 3) // MIN_PEP + 1: each (read, frame)
    lane's tryptic fragments of MIN_PEP..MAX_PEP residues as FNV
    fingerprints, left-compacted, 0 after the last.

    CPU tensors take the plain version; CUDA tensors launch K7."""
    if reads.device.type == "cpu":
        return reads_to_peptides_plain(reads, lengths, length, table, packed)
    N = reads.shape[0]
    row_bytes = (length + 1) // 2 if packed else length
    if (reads.dtype != torch.uint8 or reads.dim() != 2
            or reads.shape[1] != row_bytes):
        raise ValueError(f"reads_to_peptides: expected ({N}, {row_bytes}) "
                         f"uint8, got {tuple(reads.shape)} {reads.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (N,):
        raise ValueError("reads_to_peptides: lengths must be (N,) int32")
    kernels.check_cuda("reads_to_peptides", reads, lengths)
    dev = reads.device
    F = (length // 3) // MIN_PEP + 1
    h1 = torch.empty((N * 6, F), dtype=torch.int32, device=dev)
    h2 = torch.empty_like(h1)
    valid = torch.empty((N * 6, F), dtype=torch.bool, device=dev)
    lut = translate._codon_lut(table, dev)
    kernels.K7.launch(
        reads.data_ptr(), row_bytes, int(packed), lengths.data_ptr(), N,
        length, lut.data_ptr(), h1.data_ptr(), h2.data_ptr(),
        valid.data_ptr(), F, MIN_PEP, MAX_PEP, READS_PER_BLOCK,
        kernels.stream_of(reads))
    return h1, h2, valid


def run_tryptic_stages(reads, lengths, length: int, packed: bool,
                       dtax: devagg.DeviceTaxonomy,
                       dtable: lookup.DeviceTable, config: PipelineConfig,
                       with_overflow: bool = False, plain: bool = False,
                       timer=None, euler=None):
    """One batch of the tryptic pipeline: reads (B*E, row) uint8 (packed4
    or codes), lengths (B, E) int32 -> taxon (B,) int32 [, overflow (B,)
    bool], with the stage names and switches of
    :func:`~umgap_tpu_torch.pipeline.fused.run_stages`."""
    stage = timer or (lambda _name: nullcontext())
    with kernels.plain_versions() if plain else nullcontext():
        queries, _ = tryptic_front(reads, lengths, length, packed, config,
                                   stage)
        probe = (lookup.probe_plain if kernels.plain_selected()
                 else lookup.probe)
        with stage("probe"):
            # misses and invalid slots read the default, 0
            taxa, _found = probe(dtable, *queries, 0)
        return tryptic_back(taxa, None, lengths, dtax, config,
                            with_overflow, stage, euler)


def tryptic_front(reads, lengths, length: int, packed: bool,
                  config: PipelineConfig, stage):
    """The stage before the probe (K7 or its plain version): reads
    (B*E, row) uint8, lengths (B, E) -> the probe's queries (h1, h2,
    valid) and None (:func:`tryptic_back` needs nothing else of the
    reads)."""
    r2p = (reads_to_peptides_plain if kernels.plain_selected()
           else reads_to_peptides)
    with stage("reads_to_peptides"):
        queries = r2p(reads, lengths.reshape(-1), length,
                      encoding.get_table(config.table_number), packed)
    return queries, None


def tryptic_back(taxa, _plens, lengths, dtax, config: PipelineConfig,
                 with_overflow: bool, stage, euler):
    """The stages after the probe: the probe's taxa (B*E*6, F) int32
    (misses and invalid slots 0) -> taxon (B,) [, overflow (B,)]."""
    dedup = (devagg.dedup_counts_plain if kernels.plain_selected()
             else devagg.dedup_counts)
    return aggregate_hits(taxa.reshape(lengths.shape[0], -1), dtax, config,
                          with_overflow, stage, euler, dedup)


def tryptic_pipeline_step(dna, lengths, dtax: devagg.DeviceTaxonomy,
                          dtable: lookup.DeviceTable, config: PipelineConfig,
                          euler=None, with_overflow: bool = False):
    """One tryptic batch on DNA codes: dna (B, E, L) uint8, lengths
    (B, E) int32 -> taxon (B,) int32 [, overflow (B,) bool: groups with
    more than ``config.k_max`` distinct hit taxa]."""
    check_config(config)
    B, E, L = dna.shape
    with torch.no_grad():
        return run_tryptic_stages(dna.reshape(B * E, L).contiguous(),
                                  lengths, L, False, dtax, dtable, config,
                                  with_overflow, euler=euler)


class TrypticPipeline(Pipeline):
    """:class:`~umgap_tpu_torch.pipeline.fused.Pipeline` with the tryptic
    stages: ``forward(dna4, lengths, length)`` on the packed-4 wire."""

    def forward(self, dna4, lengths, length: int, timer=None):
        B, E = lengths.shape
        reads = dna4.reshape(B * E, dna4.shape[-1]).contiguous()
        with torch.no_grad():
            return run_tryptic_stages(reads, lengths, length, True,
                                      self.dtax, self.dtable, self.config,
                                      self.with_overflow, self.plain, timer,
                                      self.euler)


def make_tryptic_fused(dtax, dtable, config: PipelineConfig, euler=None,
                       with_overflow: bool = False,
                       device=None) -> TrypticPipeline:
    """The tryptic per-batch step as a module over device-resident state
    on ``device`` (default: the current CUDA device). Packed-4 wire only;
    DNA codes go through :func:`tryptic_pipeline_step`."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dtax.device != dev:
        dtax = dtax.to(dev)
    if dtable.device != dev:
        dtable = dtable.to(dev)
    if euler is not None and euler.device != dev:
        euler = euler.to(dev)
    return TrypticPipeline(dtax, dtable, config, with_overflow, euler)


def make_tryptic_pipeline(dtax: devagg.DeviceTaxonomy,
                          dtable: lookup.DeviceTable,
                          config: PipelineConfig):
    """(hi, lo, valid) (B, W) tensors on the table's device -> taxon (B,):
    the probe and taxa2agg after a host digest. Exact by construction:
    the distinct-taxa capacity is the width W itself."""
    check_config(config)

    def step(hi, lo, valid):
        plain = kernels.plain_selected()
        probe = lookup.probe_plain if plain else lookup.probe
        dedup = devagg.dedup_counts_plain if plain else devagg.dedup_counts
        with torch.no_grad():
            taxa, _found = probe(dtable, hi, lo, valid, 0)
            return aggregate_hits(
                taxa, dtax, config._replace(k_max=taxa.shape[-1]), False,
                lambda _name: nullcontext(), None, dedup)

    return step


class TrypticAnalyser(Analyser):
    """The streaming :class:`~umgap_tpu_torch.pipeline.runner.Analyser`
    (batching, depth-2 dispatch, the k_max re-route) over the tryptic
    step."""

    def _make_step(self, config: PipelineConfig, with_overflow: bool):
        return make_tryptic_fused(self.dtax, self.dtable, config,
                                  euler=self.euler,
                                  with_overflow=with_overflow,
                                  device=self.device)

    def _exact_kmax(self) -> int:
        # every fragment slot its own taxon: E ends x 6 frames x F slots
        P = self.read_length // 3
        return self.ends * 6 * (P // MIN_PEP + 1)


def analyse_tryptic_device(groups, tax, table, config: PipelineConfig,
                           batch_size: int = 256, read_length: int = 160,
                           ends: int = 2, device=None):
    """The fused tryptic analysis of read groups at ``read_length``
    (records must fit it; the CLI sends longer ones through
    :func:`analyse_tryptic_groups`)."""
    analyser = TrypticAnalyser(tax, table, config, batch_size, read_length,
                               ends, device=device)
    return list(analyser.analyse_groups(groups))


def analyse_tryptic_groups(groups, tax, table, config: PipelineConfig,
                           batch_size: int = 256, max_peptides: int = 128,
                           dtax=None, dtable=None, step_cache=None,
                           device=None):
    """The host-digest route: :func:`digest_groups` on the host, the probe
    and aggregation on the device (``device``, or that of the given
    ``dtax``/``dtable``), at records of any length. A ``step_cache`` dict
    keeps the step across samples. Returns [(header, taxon)]."""
    from ..device import state_device

    dev = state_device(dtax, dtable, device)
    dtax = dtax if dtax is not None \
        else devagg.DeviceTaxonomy.from_host(tax, dev)
    dtable = dtable if dtable is not None \
        else lookup.DeviceTable.from_host(table, dev)
    step = step_cache.get(config) if step_cache is not None else None
    if step is None:
        step = make_tryptic_pipeline(dtax, dtable, config)
        if step_cache is not None:
            step_cache[config] = step
    groups = list(groups)
    out = []
    for i in range(0, len(groups), batch_size):
        chunk = groups[i:i + batch_size]
        padded = chunk + [("", [])] * (batch_size - len(chunk))
        hi, lo, valid = (torch.from_numpy(x).to(dev) for x in digest_groups(
            padded, max_peptides, config.table_number))
        taxa = step(hi, lo, valid).cpu().numpy()
        out.extend((header, int(t)) for (header, _), t in zip(chunk, taxa))
    return out
