#!/usr/bin/env python3
"""Smoke run of umgap_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Builds the CUDA kernels from ``umgap_tpu_torch/csrc``, holds each kernel
to its plain PyTorch version on the card (K1-K6 chained on a
16,384-pair batch at L = 100 and 160, K7 -> K8 on the same batch (with
the L2 flushed too; K7's reads per block and K8's queries per lane
swept), K6 through both its entries, on dense groups and at the wide program's
width, each of K1, K3, K4 and K7 on its path for rows past its
shared-memory budget, K6's block path at the wide program's widths up
to K = 32,004, and K5 at the shapes of each TPU gather kernel it
ports), drives the port's main path (the 9-mer ``analyse`` presets
through ``Analyser`` over the tracked ``.bench_data`` workload: 32,768
read pairs of 100 bp, a 2 M-key index, 20 k taxa), the wide re-route
program on one batch, scored seed-extend (``PipelineConfig.ranked``:
two ranked presets over the workload and over a batch of 420 bp reads,
K3's scored entries held to their plain versions, the first 1,024 pairs
to the JAX package's digests), the tryptic presets through
``TrypticAnalyser``
over a peptide index of the workload's own fragments, runs a 0.54 GB
card-resident bucket64s index and a 0.8 GB card-resident peptide index
of 25 M keys, runs the ``analyse`` command line in a subprocess (9-mer
and tryptic) and its ``--serve`` service in another (requests over a
Unix socket, replies byte-equal to the in-process records), runs the FragGeneScan++ protein path with a mock FGSpp
(``MOCK_FGSPP``: the library path of the four FGSpp presets, K1P alone,
and the command line with ``-c`` and ``-z``), reads FASTQ files (plain and gzipped, and reads of
100-4,096 bp) through the command line's three ingest tiers, holds its
two host routes (the host digest, the exact long-record route) to
device routes, runs the Euler/RMQ aggregations (rmq/lca*,
rmq/hybrid: K9 a batch) over the workload, and runs the reference's stream
subcommands in process (phase subcommands: two presets as their shell
chains of ``translate | prot2kmer2lca | seedextend | uniq | taxa2agg``
against ``analyse`` and the plain versions, ``seedextend -r``,
``taxa2agg -m rmq -a lca*``, ``taxa2agg -s``, ``pept2lca``, the
``prot2kmer2lca -s`` server), and runs ``buildindex-dist`` (phase
builddist: 1.6e8 synthetic rows into 16 shards, 2.15 GB, as a user runs
it; a shard's join on the card held to the plain numpy join, and
joins with groups of 65-300 and of 20,000 distinct taxa in key-range
pieces, probes of the built shards, a 40 MB TSV split through K1P held
to the plain split, card builds equal to CPU builds). Every phase always runs; the
script takes no arguments. Every comparison is exact (all outputs are
integer ids, masks and counts). Each path's launch counts are reset
before it is driven and the counts of the kernels it runs must be above
0 after. End-to-end rates are steady-state windows of a few seconds over
one stream. Any failure exits non-zero; nothing falls back to the CPU.

Output: progress on stderr; on stdout one ``{"builddist": {...}}`` line
(the build job's stages, K6's numbers on its join, K1P's on its split),
the card's name and power limit, one ``{"kernels": [...]}`` line, and
last the ``{"ok": true, ...}`` line.
The full record of the run goes to ``chip_smoke.json`` in the directory
named by ``CHIP_SMOKE_OUT`` (default ``.smoke_out/``, git-ignored).
Imports torch and numpy only (no JAX).
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, ".bench_data")
OUT_DIR = os.path.join(REPO,
                       os.environ.get("CHIP_SMOKE_OUT", ".smoke_out"))
TMP_DIR = os.path.join(REPO, ".smoke_tmp")
BATCH = 16384
# seconds of each steady-state end-to-end window
STEADY_S = 2.0
T0 = time.perf_counter()

# NVIDIA H100 SXM data-sheet rates: HBM bandwidth and the 32-bit rate
# outside the tensor cores, used for every bound.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

RESULT: dict = {"phases": {}}

# sha256 of the int32 taxa that umgap_tpu, the JAX package (on the CPU),
# gives for the first 1,024 .bench_data pairs under each preset, under
# the two Euler/RMQ aggregations (max-sensitivity's seeds,
# PipelineConfig(method="rmq", strategy=...)) and under the two tryptic
# presets; tests/test_torch_pipeline.py and tests/test_torch_tryptic.py
# recompute them with umgap_tpu. The card's output is held to them.
REFERENCE_PAIRS = 1024
REFERENCE_DIGESTS = {
    "max-sensitivity":
        "fecdd843c287302751db39dd2a60cc0243d93bf42826e910c9f027b6ffcffe5e",
    "high-sensitivity":
        "c6e4f3fd2b445ff42130bfb24626febbc861d6a227ef910fdcc2b9b3966fabe9",
    "high-precision":
        "8339e66be8a73eb0194123e7979dec6d4a96f6715a7a2851210e5a08f2b81a82",
    "max-precision":
        "4642c39fde62371e39c644be2a7dc2f925d4d37c94088d15e28f71cd444f50a1",
    "rmq/lca*":
        "fecdd843c287302751db39dd2a60cc0243d93bf42826e910c9f027b6ffcffe5e",
    "rmq/hybrid":
        "7dd2324670e01fad2d5cc44c72ac8bc5be96816f428b1e618fc8b773734a243a",
    # the tryptic presets over tryptic_workload's peptide index
    "tryptic-sensitivity":
        "c9e70c8cc08a30f1d1f6117790a68ee776cb30651f4aafaa2d4dda3b85589341",
    "tryptic-precision":
        "b1194f658f17cf5ab6af54032fbedb00ec2792f061a39c10179cf9255597c745",
    # the first 1,024 gene groups of MOCK_FGSPP over the bench pairs
    # (fgspp_records), the 9-mer presets over the bench index and the
    # tryptic ones over tryptic_workload's (tests/test_torch_proteins.py)
    "fgspp/high-precision":
        "a2b5ddf290d76656547cd64a8343aaad6eb5e6b99fce05268e05a26ac7e174ee",
    "fgspp/max-precision":
        "e927a53e8e08339b3765da80ecd06955b00315e2d30722387dbeade5a98a6fe6",
    "fgspp/tryptic-precision":
        "9c6a5c38c7d399c8ec64b5bfab741a556e1eda5115d41c24743aec9c3081d736",
    "fgspp/tryptic-sensitivity":
        "5660389d1683eb3d559bba0e741ad7fb981c7411322c36a71d5a28f45f614aa7",
    # scored seed-extend (phase scored, SCORED_CONFIGS: max-sensitivity
    # with ranked=True, penalty=5; high-sensitivity with ranked=True);
    # tests/test_torch_scored.py recomputes them with umgap_tpu
    "scored/max-sensitivity":
        "1c0089cdc3323116ea42b04f324f004c40d67db2ef7c6d74caa8587d96551f34",
    "scored/high-sensitivity":
        "c6e4f3fd2b445ff42130bfb24626febbc861d6a227ef910fdcc2b9b3966fabe9",
}
RMQ_STRATEGIES = ("lca*", "hybrid")

# A stand-in for FragGeneScan++ (phase fgspp; tests/test_torch_proteins.py
# and tests/test_torch_cli.py install it too): FASTA on stdin, FGSpp's
# flags ignored; each record's forward strand and reverse complement
# translated in frame 1 (the standard code) and split at stops, every
# stretch of 20 residues or more written as a gene record
# ">{header}_{start}_{end}_{+|-}". A read predicts 0 to a few genes.
MOCK_FGSPP = r'''#!/usr/bin/env python3
import sys

BASES = "TCAG"
AMINO = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
CODE = {a + b + c: AMINO[16 * i + 4 * j + k]
        for i, a in enumerate(BASES) for j, b in enumerate(BASES)
        for k, c in enumerate(BASES)}
COMP = str.maketrans("ACGT", "TGCA")


def genes(header, dna):
    dna = dna.upper()
    for strand, seq in (("+", dna), ("-", dna.translate(COMP)[::-1])):
        prot = "".join(CODE.get(seq[i:i + 3], "X")
                       for i in range(0, len(seq) - 2, 3))
        pos = 0
        for part in prot.split("*"):
            if len(part) >= 20:
                sys.stdout.write(f">{header}_{3 * pos + 1}_"
                                 f"{3 * (pos + len(part))}_{strand}\n"
                                 f"{part}\n")
            pos += len(part) + 1


header, seq = None, []
for line in sys.stdin:
    line = line.rstrip("\n")
    if line.startswith(">"):
        if header is not None:
            genes(header, "".join(seq))
        header, seq = line[1:], []
    else:
        seq.append(line)
if header is not None:
    genes(header, "".join(seq))
'''


def fgspp_records(reads):
    """(header, dna) records of read pairs ((n, 2, L) codes) as FGSpp
    reads them: both ends of pair i, ``s{i}/1`` then ``s{i}/2``."""
    seqs = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(reads, 4)]
    for i in range(len(reads)):
        for e in (0, 1):
            yield f"s{i}/{e + 1}", seqs[i, e].tobytes().decode()


def taxa_digest(taxa) -> str:
    import hashlib

    return hashlib.sha256(np.asarray(taxa, np.int32).tobytes()).hexdigest()


def log(msg):
    print(f"[smoke +{time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def bound(bytes_, ops):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tile_read(torch, shape, idxs, axis=-2):
    """Distinct elements of a (G, S, W) tile that take_along_axis reads
    with the (G, I, J) indices ``idxs`` (several for a loop of gathers):
    (g, idx, lane) along the rows, (g, row, idx) along the lanes. What
    this run's data needs, never more than the tile."""
    G, S, W = shape
    dev = idxs[0].device
    g = torch.arange(G, device=dev)[:, None, None]
    if axis == -2 and all(ix.stride(-1) == 0 for ix in idxs):
        # one row per (g, i) over every lane: count rows
        seen = torch.zeros(G * S, dtype=torch.bool, device=dev)
        for ix in idxs:
            seen[(g * S + ix[..., :1].long()).reshape(-1)] = True
        return int(seen.sum()) * W
    seen = torch.zeros(G * S * W, dtype=torch.bool, device=dev)
    for ix in idxs:
        if axis == -2:
            lane = torch.arange(ix.shape[-1], device=dev)
            flat = (g * S + ix.long()) * W + lane
        else:
            row = torch.arange(ix.shape[-2], device=dev)[None, :, None]
            flat = (g * S + row) * W + ix.long()
        seen[flat.reshape(-1)] = True
    return int(seen.sum())


def ancestry_bound(torch, dep, valid, D):
    """(bound ms, by, lineage elements) of the ancestry epilogue on this
    data: the lineage elements of valid (j, dep[i]) pairs (per group, its
    valid slots times its distinct depths of valid slots), dep, utaxa and
    valid read once, the (B, K, K) bool output written once; one compare
    per output."""
    B, K = dep.shape
    seen = torch.zeros((B, D), dtype=torch.int32, device=dep.device)
    seen.scatter_add_(1, dep.long(), valid.to(torch.int32))
    needed = int(((seen > 0).sum(dim=1) * valid.sum(dim=1)).sum())
    return bound(needed * 4 + B * K * 9 + B * K * K, B * K * K) + (needed,)


def main():
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device visible; chip_smoke.py runs only on a "
              "GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "umgap_tpu_torch")) or \
            not os.path.isdir(DATA):
        print("FAIL: umgap_tpu_torch/ or .bench_data/ missing next to "
              "chip_smoke.py", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        print("FAIL: chip_smoke.py takes no arguments; it always runs "
              "every phase", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.rmtree(TMP_DIR, ignore_errors=True)
    os.makedirs(TMP_DIR)
    try:
        card = phase_identify(torch)
        world = load_world(torch)
        stats = phase_kernels(torch, world)
        phase_gather(torch, world)
        launches, results = phase_main(torch, world)
        phase_wide(torch, world, results)
        scored_launches, scored_stats = phase_scored(torch, world, results)
        stats.update(scored_stats)
        tlaunches, tresults = phase_tryptic(torch, world)
        phase_resident(torch, world)
        k8_resident = phase_resident_peptide(torch, world, tresults)
        phase_cli(torch, world)
        phase_serve(torch, world)
        phase_subcommands(torch, world)
        build = phase_builddist(torch, world)
        shards_launches, stats["probe_kmer_grouped"] = phase_shards(torch,
                                                                    world)
        mesh_launches, stats["probe_peptide_grouped"] = phase_mesh(
            torch, world, tresults)
        phase_multihost(torch, world, results, tresults)
        fgspp_launches, stats["proteins_to_kmers"] = phase_fgspp(torch,
                                                                 world)
        phase_ingest(torch, world)
        long_launches = phase_long(torch, world)
        rmq_launches, stats["rmq_aggregate"] = phase_rmq(torch, world)
    finally:
        shutil.rmtree(TMP_DIR, ignore_errors=True)
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
            json.dump(RESULT, f, indent=1, default=str)

    # every number below was measured in this run: the phases above
    # raise before this point if any of them did not run to its end.
    # Launches: the 9-mer main path's, K7 and K8 the tryptic path's, K3's
    # and K4's row kernels the 12,000 bp path's, K3's scored entries the
    # scored path's (phase scored), K9 the Euler/RMQ path's (phase rmq:
    # its times and bound at the path's own K9 inputs), K1P the FGSpp
    # path's.
    # K7's time and share are its L2-flushed ones (its 8.8 MB would
    # otherwise sit in L2 across launches; the warm ones stay in its
    # stats). K8's times and bound are the resident index's with the L2
    # flushed (the bench index's, kept under "bench_index", sit in L2).
    k8 = stats["probe_peptide"]
    k8["bench_index"] = {k: k8.pop(k) for k in list(k8)
                         if k not in ("max_abs_err", "equal")}
    k8.update(k8_resident, max_abs_err=max(k8["max_abs_err"],
                                           k8_resident["max_abs_err"]))
    k8["equal"] = k8["max_abs_err"] == 0.0
    # K3's and K4's row kernels: the 12,000 bp path's launches, their
    # times and bounds on its batch (``long_rows``; every cell stays
    # under "wide_path")
    for name, cell in (("seedextend_rows", "W=3992"),
                       ("dedup_rows", "N=23952")):
        stats[name].update(stats[name]["wide_path"]["by_cell"][cell])
    kern = []
    from umgap_tpu_torch import kernels
    for k in kernels.KERNELS:
        s = stats[k.name]
        kern.append({
            "name": k.name, "route": "cuda",
            "source": f"umgap_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": (tlaunches if k.name in TRYPTIC_KERNELS
                         else scored_launches if k.name in SCORED_KERNELS
                         else long_launches if k.name in ROW_KERNELS
                         else rmq_launches if k.name in RMQ_TAIL_KERNELS
                         else fgspp_launches if k.name in PROTEIN_KERNELS
                         else launches)[k.name],
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s.get("library_ms"),
            "equal": s["equal"]})
    # K2's grouped entry: the 16-shard card-scale artifact, launches from
    # the grouped analyser's run (phase shards)
    g = stats["probe_kmer_grouped"]
    kern.append({
        "name": "probe_kmer_grouped", "route": "cuda",
        "source": "umgap_tpu_torch/csrc/probe_kmer.cu",
        "replaces": "umgap_tpu/parallel/sharded.py:314-320 with "
                    "umgap_tpu/ops/lookup.py:231 (the grouped probe)",
        "launches": shards_launches["probe_kmer"],
        "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": None,
        "equal": g["equal"]})
    # K8's grouped entry: phase mesh's tryptic run over the bench
    # peptide index in 8 shards on the four-device mesh (a group of 2 a
    # device): its launches, and each device's K8 on the queries one step
    # gives it (L2 flushed; the mean over the devices)
    g = stats["probe_peptide_grouped"]
    kern.append({
        "name": "probe_peptide_grouped", "route": "cuda",
        "source": "umgap_tpu_torch/csrc/probe_peptide.cu",
        "replaces": "umgap_tpu/parallel/sharded.py:314-320 (kind peptide) "
                    "with umgap_tpu/ops/lookup.py:265-283 (the grouped "
                    "peptide probe)",
        "launches": mesh_launches["probe_peptide"],
        "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": None,
        "equal": g["equal"]})
    # the build job's numbers (phase builddist), before the card's line
    print(json.dumps({"builddist": {
        "job": build["job"], "join_k6": {k: build["join"]["k6"][k] for k in
                                         ("launches", "device_ms",
                                          "bound_ms")},
        "split_k1p": build["split"]["k1p"],
        "wide_k6": {n: build[f"join_{n}"]["k6_block"]
                    for n in ("mid", "wide")}}}))
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------- #
# Phase 1: identify the card, build the kernels
# ---------------------------------------------------------------------- #

def phase_identify(torch):
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from umgap_tpu_torch import kernels

    info = kernels.build_all(force=True)
    regs = {}
    for name, text in info["logs"].items():
        regs[name] = [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "entry function" in ln]
    RESULT["card"] = card
    RESULT["torch"] = torch.__version__
    RESULT["cuda"] = torch.version.cuda
    RESULT["build_seconds"] = info["seconds"]
    RESULT["ptxas"] = regs
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"kernels built in {info['seconds']:.1f}s")
    for name, lines in regs.items():
        for ln in lines:
            log(f"  {name}: {ln}")
    return card


# ---------------------------------------------------------------------- #
# The .bench_data workload
# ---------------------------------------------------------------------- #

def bench_taxonomy():
    """The workload's manifest and taxonomy: (manifest, parent, snap,
    Taxonomy)."""
    from umgap_tpu_torch import ranks
    from umgap_tpu_torch.taxonomy import Taxon, Taxonomy

    with open(os.path.join(DATA, "manifest.json")) as f:
        man = json.load(f)
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    taxa = [Taxon(i, f"t{i}", ranks.NO_RANK if i % 3 else 14,
                  int(parent[i]), bool(snap[i] == i))
            for i in range(1, man["n_tax"] + 1)]
    return man, parent, snap, Taxonomy(taxa)


def load_world(torch):
    from umgap_tpu_torch.agg.device import DeviceTaxonomy
    from umgap_tpu_torch.index.table import PeptideTable, build_kmer_table
    from umgap_tpu_torch.ops.lookup import DeviceTable

    man, parent, snap, tax = bench_taxonomy()
    P, L, n_tax = man["n_pairs"], man["read_len"], man["n_tax"]
    keys = np.fromfile(os.path.join(DATA, "index_keys.bin"), np.uint64)
    vals = np.fromfile(os.path.join(DATA, "index_vals.bin"), np.int32)
    t0 = time.perf_counter()
    table = build_kmer_table(keys, vals, k=9)
    build_s = time.perf_counter() - t0
    reads = np.fromfile(os.path.join(DATA, "reads.bin"),
                        np.uint8).reshape(P, 2, L)
    t0 = time.perf_counter()
    peps, pvals = tryptic_workload(reads, n_tax)
    digest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptable = PeptideTable.build(peps, pvals)
    pbuild_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    world = dict(tax=tax, table=table, keys=keys, vals=vals, reads=reads,
                 L=L, P=P, parent=parent, snap=snap, n_tax=n_tax, dev=dev,
                 dtax=DeviceTaxonomy.from_host(tax, dev),
                 dtable=DeviceTable.from_host(table, dev),
                 ptable=ptable, pdtable=DeviceTable.from_host(ptable, dev))
    RESULT["workload"] = dict(pairs=P, read_len=L, taxa=n_tax,
                              keys=len(keys), layout="bucket8s",
                              table_rows_bytes=int(table.capacity * 8),
                              stash=int(len(table.stash_hi)),
                              host_build_s=build_s,
                              tryptic=dict(keys=len(peps),
                                           slots=ptable.capacity,
                                           max_probes=ptable.max_probes,
                                           host_digest_s=digest_s,
                                           host_build_s=pbuild_s))
    log(f"workload: {P} pairs x {L} bp, {len(keys)} keys -> bucket8s "
        f"{table.capacity * 8 / 1e6:.1f} MB rows, stash "
        f"{len(table.stash_hi)}, host build {build_s:.1f}s; tryptic index "
        f"{len(peps)} fragments in {ptable.capacity} slots (max_probes "
        f"{ptable.max_probes}), host digest {digest_s:.1f}s, build "
        f"{pbuild_s:.1f}s")
    return world


TRYPTIC_SEED = 41


def tryptic_workload(reads, n_tax, seed=TRYPTIC_SEED):
    """The tryptic index of the workload: every distinct fragment of 9-45
    residues of the host digest (``translate_sequence`` in six frames,
    then ``tryptic_digest``) of both ends of ``reads`` (P, 2, L) codes,
    less a seeded quarter (so that misses happen). Each pair draws a
    taxon of 1..n_tax; a fragment takes the taxon of the first pair it
    comes from, or a random one for a quarter of them (so that the pairs'
    hits disagree, and tryptic-precision's lower bound of 5 keeps some).
    Returns (peptides sorted, values int32); tests/test_torch_tryptic.py
    builds the same index with umgap_tpu."""
    from umgap_tpu_torch.ops import encoding, kmers, translate

    code = encoding.get_table(1)
    first = {}
    for i, pair in enumerate(reads):
        for row in pair:
            seq = encoding.decode_dna(row)
            for pep in translate.translate_sequence(
                    seq, translate.FRAME_NAMES, code):
                for f in kmers.tryptic_digest(pep):
                    if 9 <= len(f) <= 45:
                        first.setdefault(f, i)
    peps = sorted(first)
    rng = np.random.default_rng(seed)
    pair_taxon = rng.integers(1, n_tax + 1, size=len(reads))
    keep = np.sort(rng.permutation(len(peps))[:len(peps) - len(peps) // 4])
    peps = [peps[i] for i in keep]
    vals = pair_taxon[[first[p] for p in peps]]
    other = rng.random(len(peps)) < 0.25
    vals[other] = rng.integers(1, n_tax + 1, size=int(other.sum()))
    return peps, vals.astype(np.int32)


# ---------------------------------------------------------------------- #
# Phase 2: each kernel against its plain version on the card
# ---------------------------------------------------------------------- #

def cuda_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# host seconds a profiler window keeps clear of the calls on either side
# of it (see device_ms)
PROFILE_PAD_S = 0.02


def _profile_window(torch, fn, n_calls, before=None, with_calls=False):
    """A profiler window holding ``n_calls`` calls of ``fn`` alone: a
    warm-up window of the same calls first (kineto's schedule), then the
    recorded one, with PROFILE_PAD_S of host time between the warm-up's
    last call and the window's start, the window's start and its first
    call, its last call and its end. ``before`` runs ahead of each call
    and is timed too. Returns {kernel name: (device ms, count)}; with
    ``with_calls`` also the window's host-side kernel launch calls (a
    window whose kernel events number fewer missed some)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def calls():
        for _ in range(n_calls):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        calls()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        calls()
        prof.step()
    # a schedule's step annotation ("ProfilerStep#1") carries the device
    # time of every kernel in its step again: kernels and copies only
    events = prof.key_averages()
    out = {e.key: (e.self_device_time_total / 1e3, e.count)
           for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")}
    if with_calls:
        return out, sum(e.count for e in events
                        if e.key == "cudaLaunchKernel")
    return out


def _kernel_events(prof):
    """Kernel events (copies and sets aside) of a ``_profile_window``."""
    return sum(c for k, (_ms, c) in prof.items()
               if not k.startswith(("Memcpy", "Memset")))


def device_ms(torch, fn, reps=20, tries=3, by=False):
    """Device time per call of ``fn``: the profiler's CUDA kernel and copy
    time over ``reps`` calls (no host launch gaps, unlike cuda_ms), from
    ``_profile_window`` (windows opened with no warm-up and no host time
    around the calls read no device event at all for many short
    windows). The reading is held to ``events_ms`` (the same calls back
    to back behind a spin of the card): a window whose kernel events
    number fewer than its host launch calls (the profiler dropped some,
    which reads too low) is taken again, up to ``tries`` times, and one
    that reads more than 1.25 times the events' time is not taken; then
    the events' time stands. With ``by``, returns (ms, "profiler" or
    "events")."""
    fn()
    torch.cuda.synchronize()
    ev = events_ms(torch, fn, reps)
    for _ in range(tries):
        prof, calls = _profile_window(torch, fn, reps, with_calls=True)
        us = sum(v[0] for v in prof.values())
        if _kernel_events(prof) < calls:
            log(f"device_ms: the profiler saw {_kernel_events(prof)} "
                f"kernels of {calls} launch calls")
        elif us > 0:
            ms = us / reps
            if ms <= 1.25 * ev:
                return (ms, "profiler") if by else ms
            log(f"device_ms: the profiler read {ms:.4f} ms a call against "
                f"{ev:.4f} ms by CUDA events with no host gap")
    log(f"device_ms: no profiler window agreed in {tries}; CUDA events "
        f"with no host gap read {ev:.4f} ms")
    return (ev, "events") if by else ev


def events_ms(torch, fn, reps=20):
    """Event ms a call of ``fn`` with no host gap between the calls: the
    card first spins for about 20 ms (``torch.cuda._sleep``) while the
    host queues all ``reps`` calls behind it, so the events time the
    calls back to back on the card."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def cold_ms(torch, fn, reps=10):
    """Event ms a call of ``fn`` with the L2 cache flushed before each
    (a 128 MB write between launches): what a caller meets when its data
    was not touched by the previous call. Repeated calls on the same
    inputs otherwise find what they read in the 50 MB L2."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def cold_device_ms(torch, fn, kernel, reps=10, tries=3):
    """Device ms a call of ``fn`` spends in the kernels whose name holds
    ``kernel``, with the L2 cache flushed before each call as in
    cold_ms (the flush's own kernel is not counted), from
    ``_profile_window``. None (not measured) if the profiler shows no
    such kernel in ``tries`` windows."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        prof = _profile_window(torch, fn, reps, before=flush.zero_)
        us = sum(v[0] for k, v in prof.items() if kernel in k)
        if us > 0:
            return us / reps
    return None


def fmt_ms(v):
    return "not measured" if v is None else f"{v:.4f}"


def compare(torch, what, got, want):
    """Exact equality of tuples of integer/bool tensors; returns the max
    absolute difference (0.0 when equal)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"{what}: {tuple(g.shape)} {g.dtype} vs "
                f"{tuple(w.shape)} {w.dtype}")
        if g.numel():
            err = max(err, float((g.double() - w.double()).abs().max()))
    require(err == 0.0, f"{what}: kernel differs from plain (max abs "
            f"err {err})")
    return err


def _batch_reads(torch, world, width, full=False):
    """K1's input on the main path: the first 16,384 ``.bench_data``
    pairs as packed rows padded with N to ``width``, lengths kept at the
    reads' own (what the CLI does with shorter reads). ``full`` fills the
    padding with seeded random bases and sets every length to ``width``
    instead (K1 then translates every codon)."""
    from umgap_tpu_torch.ops import encoding

    L = world["L"]
    batch = world["reads"][:BATCH]
    if width > L:
        fill = (np.random.default_rng(3).integers(
            0, 4, size=(BATCH, 2, width - L)).astype(np.uint8) if full
            else np.full((BATCH, 2, width - L), encoding.DNA_N, np.uint8))
        batch = np.concatenate([batch, fill], axis=2)
    reads = torch.from_numpy(encoding.pack_dna4(batch)).to(
        world["dev"]).reshape(BATCH * 2, -1).contiguous()
    lens = torch.full((BATCH * 2,), width if full else L, dtype=torch.int32,
                      device=world["dev"])
    return reads, lens


def _chain(torch, world, width):
    """K1 -> K2 -> K3 -> K4 on the first 16,384 ``.bench_data`` pairs
    padded to ``width`` (the main path's program at that read length,
    high-sensitivity's seed parameters), each kernel held to its plain
    version on the same inputs and both timed (K1-K4 also by device
    time). Returns per-kernel stats and max abs errors."""
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate

    tt1 = encoding.get_table(1)
    stats, errs = {}, {}
    reads, lens = _batch_reads(torch, world, width)

    def r2k():
        return translate.reads_to_kmers(reads, lens, width, tt1, 9)

    k1 = r2k()
    errs["reads_to_kmers"] = compare(
        torch, f"K1 L={width}", k1,
        translate.reads_to_kmers_plain(reads, lens, width, tt1, 9))
    hi, lo, wvalid, plens = k1
    N1, W = reads.shape[0], hi.shape[-1]
    stats["reads_to_kmers"] = dict(
        ms=cuda_ms(torch, r2k), device_ms=device_ms(torch, r2k),
        plain_ms=cuda_ms(torch, lambda: translate.reads_to_kmers_plain(
            reads, lens, width, tt1, 9), reps=5),
        reads_per_block=translate.READS_PER_BLOCK)
    b1, by1 = bound(reads.numel() + 4 * N1 + N1 * 6 * (W * 9 + 4),
                    N1 * 6 * (W + 8) * 16)
    stats["reads_to_kmers"].update(bound_ms=b1, bound_by=by1)

    dtable = world["dtable"]
    k2 = lookup.probe(dtable, hi, lo, wvalid, 0)
    errs["probe_kmer"] = compare(torch, f"K2 L={width}", k2,
                                 lookup.probe_plain(dtable, hi, lo, wvalid, 0))
    n_valid = int(wvalid.sum())
    Q = hi.numel()
    row_read = 4 * dtable.bucket + 32  # remainder half + one value sector
    stats["probe_kmer"] = dict(
        ms=cuda_ms(torch, lambda: lookup.probe(dtable, hi, lo, wvalid, 0)),
        device_ms=device_ms(torch, lambda: lookup.probe(dtable, hi, lo,
                                                        wvalid, 0)),
        plain_ms=cuda_ms(torch, lambda: lookup.probe_plain(
            dtable, hi, lo, wvalid, 0), reps=3))
    b2, by2 = bound(Q * 9 + Q * 5 + n_valid * row_read, n_valid * 60)
    stats["probe_kmer"].update(bound_ms=b2, bound_by=by2, queries=Q,
                               valid=n_valid, found=int(k2[1].sum()))

    # K3 on the main path: the hits entry (seed-extend with the select
    # fused in); its mask entry beside it, alone and with the select the
    # pipeline made before the hits entry
    taxa = k2[0]
    nk = (plens - 8).clamp(min=0)

    def hits_fn():
        return seedextend.seedextend_hits(taxa, nk, 3, 1)

    def mask_fn():
        return seedextend.seedextend_mask_batch(taxa, nk, 3, 1)

    def mask_where():
        return torch.where(mask_fn(), taxa, 0)

    hits = hits_fn()
    errs["seedextend_mask"] = max(
        compare(torch, f"K3 hits L={width}", hits,
                seedextend.seedextend_hits_plain(taxa, nk, 3, 1)),
        compare(torch, f"K3 mask L={width}", mask_fn(),
                seedextend.seedextend_mask_plain(taxa, nk, 3, 1)))
    lanes = nk.numel()
    # bounds: the fused work reads the taxa and lengths once and writes
    # the int32 hits once; the mask entry writes W bools instead
    b3, by3 = bound(lanes * (W * 8 + 4), lanes * W * 20)
    bm, bym = bound(lanes * (W * 5 + 4), lanes * W * 20)
    stats["seedextend_mask"] = dict(
        ms=cuda_ms(torch, hits_fn), device_ms=device_ms(torch, hits_fn),
        plain_ms=cuda_ms(torch, lambda: seedextend.seedextend_hits_plain(
            taxa, nk, 3, 1), reps=3),
        bound_ms=b3, bound_by=by3, lanes=lanes, W=W,
        path=seedextend.seedextend_path(W),
        mask=dict(ms=cuda_ms(torch, mask_fn),
                  device_ms=device_ms(torch, mask_fn),
                  plain_ms=cuda_ms(torch, lambda: seedextend
                                   .seedextend_mask_plain(taxa, nk, 3, 1),
                                   reps=3),
                  bound_ms=bm, bound_by=bym,
                  with_where_ms=cuda_ms(torch, mask_where),
                  with_where_device_ms=device_ms(torch, mask_where)))

    hits = hits.reshape(BATCH, -1)
    k4 = devagg.dedup_counts(hits, None, 64, return_nuniq=True)
    errs["dedup_counts"] = compare(
        torch, f"K4 L={width}", k4,
        devagg.dedup_counts_plain(hits, None, 64, return_nuniq=True))
    NH = hits.shape[1]
    stats["dedup_counts"] = dict(
        ms=cuda_ms(torch, lambda: devagg.dedup_counts(hits, None, 64, True)),
        device_ms=device_ms(torch, lambda: devagg.dedup_counts(
            hits, None, 64, True)),
        plain_ms=cuda_ms(torch, lambda: devagg.dedup_counts_plain(
            hits, None, 64, True), reps=5))
    # bound: each id read once, the outputs written once, and the least
    # sorting work of each row's n valid hits (n log2 n compares, 4
    # operations each), from this batch's data
    nv = (hits > 0).sum(dim=1).cpu().numpy().astype(np.int64)
    lg = np.ceil(np.log2(np.maximum(nv, 1))).astype(np.int64)
    b4, by4 = bound(BATCH * NH * 4 + BATCH * (64 * 9 + 4),
                    int((nv * lg).sum()) * 4)
    stats["dedup_counts"].update(
        bound_ms=b4, bound_by=by4, N=NH, path=devagg.dedup_path(NH),
        valid_hits=dict(mean=float(nv.mean()),
                        p50=float(np.percentile(nv, 50)),
                        p99=float(np.percentile(nv, 99)), max=int(nv.max())))
    # K4 with the lower bound at its stores (the path's), held to its
    # plain version and to K4 then the filter; its cost beside K4 alone
    # and beside K4 + the unfused filter it replaced
    for lb in (1.0, 2.0, 5.0):
        got = devagg.dedup_counts(hits, None, 64, True, lower_bound=lb)
        errs["dedup_counts"] = max(errs["dedup_counts"], compare(
            torch, f"K4 lower bound {lb} L={width}", got,
            devagg.dedup_counts_plain(hits, None, 64, True, lower_bound=lb)))
        require(torch.equal(got[2], devagg.filter_lower_bound(
            k4[1], k4[2], lb)), f"K4 lower bound {lb}: not the filter")

    def k4_bound():
        return devagg.dedup_counts(hits, None, 64, True, lower_bound=2.0)

    def k4_filter():
        u, c, v, n = devagg.dedup_counts(hits, None, 64, True)
        return u, c, devagg.filter_lower_bound(c, v, 2.0), n

    stats["dedup_counts"]["lower_bound"] = dict(
        ms=cuda_ms(torch, k4_bound), device_ms=device_ms(torch, k4_bound),
        unfused_ms=cuda_ms(torch, k4_filter),
        unfused_device_ms=device_ms(torch, k4_filter))

    # K5 and K6 on K4's output, high-sensitivity's lower bound
    utaxa, ucounts, uvalid = devagg.dedup_counts(hits, None, 64,
                                                 lower_bound=1.0)
    (s5, e5), (s5a, e5a), (s6, e6) = _agg_chain(
        torch, world, utaxa, ucounts, uvalid, width)
    stats.update(lane_gather=s5, lane_gather_ancestry=s5a, tree_aggregate=s6)
    errs.update(lane_gather=e5, lane_gather_ancestry=e5a, tree_aggregate=e6)
    log(f"L={width} chain, kernels equal to plain: " + ", ".join(
        f"{n} {s['ms']:.3f} ms (plain {s['plain_ms']:.3f}, bound "
        f"{s['bound_ms']:.4f} {s['bound_by']})" for n, s in stats.items()))
    return stats, errs


def peptide_rows_read(torch, dtable, hi, lo, valid):
    """The peptide-table rows K8 reads for these queries: a valid query
    reads rows from its bucket on (in its sub-table of a grouped table)
    until a hit or a row with an empty slot, at most max_probes + 1; an
    invalid one reads none."""
    from umgap_tpu_torch.ops import lookup

    h = hi.reshape(-1).long()
    lq = lo.reshape(-1).long()
    live = valid.reshape(-1).clone()
    nb = dtable.n_buckets
    bucket = lookup.hash32_torch(h, lq) & (nb - 1)
    # a grouped table's sub-tables (K8's grouped entry)
    base = (lookup.sub_tables(dtable, hi.reshape(-1), lo.reshape(-1)).long()
            * nb if dtable.group > 1 else 0)
    n = 0
    for _ in range(dtable.max_probes + 1):
        n += int(live.sum())
        row = dtable.rows[base + bucket]
        hit = ((row[:, :8] == h[:, None]) & (row[:, 8:16] == lq[:, None]))
        live &= ~hit.any(dim=1) & ~(row[:, :8] == -1).any(dim=1)
        bucket = (bucket + 1) & (nb - 1)
    return n


def k8_bound(torch, dtable, hi, lo, valid):
    """K8's bound on this data: 14 bytes a query (hi, lo, valid read;
    value, found written) and 96 bytes a row read; 8 two-word compares
    a row. Returns (ms, by, rows read)."""
    rows = peptide_rows_read(torch, dtable, hi, lo, valid)
    return bound(hi.numel() * 14 + rows * 96, rows * 8 * 4) + (rows,)


def _tryptic_chain(torch, world, width):
    """K7 -> K8 on the first 16,384 ``.bench_data`` pairs padded to
    ``width`` (the tryptic path's program at that read length, the bench
    tryptic index), each held to its plain version on the same inputs
    and timed. Returns per-kernel stats and max abs errors."""
    from umgap_tpu_torch.ops import encoding, lookup
    from umgap_tpu_torch.pipeline import tryptic

    tt1 = encoding.get_table(1)
    stats, errs = {}, {}
    reads, lens = _batch_reads(torch, world, width)

    def r2p(plain=False):
        fn = (tryptic.reads_to_peptides_plain if plain
              else tryptic.reads_to_peptides)
        return fn(reads, lens, width, tt1)

    k7 = r2p()
    errs["reads_to_peptides"] = compare(torch, f"K7 L={width}", k7,
                                        r2p(True))
    N, F = reads.shape[0], k7[0].shape[-1]
    b7, by7 = bound(reads.numel() + 4 * N + N * 6 * F * 9,
                    N * 6 * (width // 3) * 16)
    # K7's 8.8-13.4 MB stay in the 50 MB L2 across repeated launches, so
    # its entry (ms, share) is taken with the L2 flushed before each
    # launch, as a new batch finds it; the warm times stay beside it
    stats["reads_to_peptides"] = dict(
        ms=cold_ms(torch, r2p),
        cold_device_ms=cold_device_ms(torch, r2p, "reads_to_peptides"),
        warm_ms=cuda_ms(torch, r2p), device_ms=device_ms(torch, r2p),
        plain_ms=cuda_ms(torch, lambda: r2p(True), reps=3), bound_ms=b7,
        bound_by=by7, F=F, fragments=int(k7[2].sum()),
        reads_per_block=tryptic.READS_PER_BLOCK)
    h1, h2, pv = k7
    dt = world["pdtable"]

    def k8(plain=False):
        fn = lookup.probe_plain if plain else lookup.probe
        return fn(dt, h1, h2, pv, 0)

    got = k8()
    errs["probe_peptide"] = compare(torch, f"K8 L={width}", got, k8(True))
    b8, by8, rows = k8_bound(torch, dt, h1, h2, pv)
    # the bench index's 12.6 MB of rows stay in the 50 MB L2 across
    # launches, so K8 can beat its HBM bound here: it takes no share on
    # this index. Its bound and share come from the resident index with
    # the L2 flushed (phase_resident_peptide).
    stats["probe_peptide"] = dict(
        ms=cuda_ms(torch, k8), device_ms=device_ms(torch, k8),
        cold_device_ms=cold_device_ms(torch, k8, "probe_peptide"),
        plain_ms=cuda_ms(torch, lambda: k8(True), reps=3), bound_ms=b8,
        bound_by=by8, queries=h1.numel(), valid=int(pv.sum()),
        found=int(got[1].sum()), rows_read=rows,
        rows_mb=dt.rows.numel() * 4 / 1e6,
        queries_per_lane=getattr(lookup, "QUERIES_PER_LANE", None))
    st = stats["reads_to_peptides"]
    st["share"] = (st["bound_ms"] / st["cold_device_ms"]
                   if st["cold_device_ms"] else None)
    st["warm_share"] = (st["bound_ms"] / st["device_ms"]
                        if st["device_ms"] else None)
    stats["probe_peptide"]["share"] = None
    log(f"L={width} tryptic chain, kernels equal to plain: " + ", ".join(
        f"{n} {s['ms']:.4f} ms (device {fmt_ms(s['device_ms'])}, L2 "
        f"flushed {fmt_ms(s['cold_device_ms'])}, plain "
        f"{s['plain_ms']:.3f}, bound {s['bound_ms']:.4f} {s['bound_by']})"
        for n, s in stats.items()))
    return stats, errs


# one codon of the standard code for each residue, to write reads whose
# first frame holds chosen peptides (as tests/test_torch_cuda.py)
_CODON = dict(A="GCT", C="TGT", D="GAT", E="GAA", F="TTT", G="GGT",
              H="CAT", I="ATT", K="AAA", L="CTT", M="ATG", N="AAT",
              P="CCT", Q="CAA", R="CGT", S="TCT", T="ACT", V="GTT",
              W="TGG", Y="TAT")
_CODON["*"] = "TAA"
# first frames of 50 residues: fragments of exactly 9, 45 and 46
# residues, only '*', no K or R, K and R before P, a K or R that ends the
# frame; and the fragments each keeps in that frame
EDGE_PEPTIDES = (
    "AAAAAAAAK" + "G" * 41,
    "A" * 44 + "K" + "G" * 5,
    "A" * 45 + "K" + "G" * 4,
    "*" * 50,
    "ACDEFGHILMNQSTVWY*ACDEFGHILMNQSTVWY*ACDEFGHILMNQST",
    "AAAAKPAAAAK" + "G" * 9 + "*" + "AARPAAAAAAR" + "C" * 18,
    "G" * 20 + "R" + "A" * 28 + "K",
    "G" * 20 + "K" + "A" * 28 + "R",
)
EDGE_FRAGMENTS = [2, 1, 0, 0, 3, 4, 2, 2]


def _edge_reads(L, reps):
    """The EDGE_PEPTIDES as reads of L >= 150 bases ('TAA' codons after
    the peptide's 150), at lengths L and 149, repeated ``reps`` times."""
    from umgap_tpu_torch.ops import encoding

    codes, lens = [], []
    for pep in EDGE_PEPTIDES:
        seq = ("".join(_CODON[a] for a in pep) + "TAA" * L)[:L]
        for ln in (L, 149):
            codes.append(encoding.encode_dna(seq))
            lens.append(ln)
    return (np.concatenate([np.stack(codes)] * reps),
            np.concatenate([np.array(lens, np.int32)] * reps))


def _chained_table(rng, n, capacity, home):
    """A PeptideTable of n random fingerprints in ``capacity`` slots, 26
    of them homed at bucket ``home`` (the last one), so they chain over
    the next rows, wrapping to bucket 0. Returns (table, hi, lo): the n
    keys, then n absent ones."""
    from umgap_tpu_torch.index import table as T

    key = np.unique(rng.integers(0, 2 ** 64 - 1, size=200_000,
                                 dtype=np.uint64))
    key = key[(key >> np.uint64(32)) != np.uint64(0xFFFFFFFF)]
    rng.shuffle(key)
    hi = (key >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = key.astype(np.uint32).view(np.int32)
    at = np.nonzero((T.hash32(hi, lo) & np.uint32(capacity // 8 - 1))
                    == home)[0][:26]
    rest = np.setdiff1d(np.arange(len(key)), at)
    order = np.concatenate([at, rest[:2 * n - 26]])
    hi, lo = hi[order], lo[order]
    tab = T.PeptideTable._from_fingerprints(
        hi[:n], lo[:n], rng.integers(1, 1000, n).astype(np.int32),
        capacity=capacity)
    return tab, hi, lo


def _tryptic_edges(torch, world, rng):
    """K7 on short, odd, N-rich and 'TAA'-repeat reads (an all-'*'
    frame), lengths 0-2 (every frame empty) and above the width, both
    wires, an unaligned span, at L = 17-1,001 (192: P = 64, 6 x F = 48
    slots a read); on reads written to hold fragments of exactly 9, 45
    and 46 residues, an all-'*' frame, a frame with no K or R, K and R
    before P and a K or R that ends a frame (L = 150-192). K8 on a small
    table at high load (max_probes >= 1) with present, absent and
    invalid queries and an all-miss batch; windows of all, no and only
    the last slot valid; keys chained over max_probes rows, wrapping
    from the last bucket to 0; the host-digest route's (B, W) queries at
    odd W. Returns (K7 err, K8 err)."""
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.ops import encoding, lookup
    from umgap_tpu_torch.ops.lookup import DeviceTable
    from umgap_tpu_torch.pipeline import tryptic

    dev = world["dev"]
    tt = encoding.get_table(1)
    e7 = 0.0
    for L2, packed in ((17, True), (100, False), (161, True), (192, True),
                       (192, False), (1001, True)):
        n = 4097 if L2 < 1001 else 300
        codes = rng.integers(0, 4, size=(n, L2)).astype(np.uint8)
        codes[rng.random((n, L2)) < 0.03] = 4
        codes[1::9] = np.resize(np.array([3, 0, 0], np.uint8), L2)
        codes[2::9, ::5] = 4
        ln = rng.integers(0, L2 + 1, size=n).astype(np.int32)
        ln[: n // 8] = rng.integers(0, 3, size=n // 8)
        ln[n // 8: n // 4] = L2 + 5
        src = encoding.pack_dna4(codes) if packed else codes
        big = torch.from_numpy(src).to(dev)
        r = big[1:] if L2 == 161 else big
        lt = torch.from_numpy(ln[1:] if L2 == 161 else ln).to(dev)
        require(L2 != 161 or r.data_ptr() % 16, "K7: span not unaligned")
        e7 = max(e7, compare(
            torch, f"K7 L={L2} packed={packed}",
            tryptic.reads_to_peptides(r, lt, L2, tt, packed),
            tryptic.reads_to_peptides_plain(r, lt, L2, tt, packed)))
    for L2 in (150, 160, 161, 192):
        codes, ln = _edge_reads(L2, 300)
        for packed in (True, False):
            src = encoding.pack_dna4(codes) if packed else codes
            flat = torch.zeros(src.size + 1, dtype=torch.uint8, device=dev)
            flat[1:] = torch.from_numpy(src.reshape(-1)).to(dev)
            lt = torch.from_numpy(ln).to(dev)
            want = tryptic.reads_to_peptides_plain(flat[1:].view(src.shape),
                                                   lt, L2, tt, packed)
            F = want[0].shape[-1]
            require(want[2].reshape(-1, 6, F)[:16:2, 0].sum(1).tolist()
                    == EDGE_FRAGMENTS, f"K7 edge reads L={L2}: fragments")
            # an aligned span and one a byte past an aligned address
            for r in (flat[:-1].view(src.shape), flat[1:].view(src.shape)):
                e7 = max(e7, compare(
                    torch, f"K7 edge peptides L={L2} packed={packed}",
                    tryptic.reads_to_peptides(r, lt, L2, tt, packed),
                    tryptic.reads_to_peptides_plain(r, lt, L2, tt,
                                                    packed)))
    n = 200_000
    key = np.unique(rng.integers(0, 2 ** 64 - 1, size=n, dtype=np.uint64))
    key = key[(key >> np.uint64(32)) != np.uint64(0xFFFFFFFF)]
    rng.shuffle(key)
    hi = (key >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = key.astype(np.uint32).view(np.int32)
    half = len(key) // 2
    tab = PeptideTable._from_fingerprints(
        hi[:half], lo[:half], rng.integers(1, 1000, half).astype(np.int32),
        capacity=1 << 17)
    require(tab.max_probes >= 1, "K8 edge table: max_probes 0")
    dt = DeviceTable.from_host(tab, dev)
    qh = torch.from_numpy(hi).to(dev)
    ql = torch.from_numpy(lo).to(dev)
    qv = torch.from_numpy(rng.random(len(hi)) < 0.9).to(dev)
    got = lookup.probe(dt, qh, ql, qv, -7)
    e8 = compare(torch, "K8 high load", got,
                 lookup.probe_plain(dt, qh, ql, qv, -7))
    require(int(got[1].sum()) > half // 2, "K8 high load: too few hits")
    got = lookup.probe(dt, qh[half:], ql[half:], None, 0)
    e8 = max(e8, compare(torch, "K8 all-miss", got, lookup.probe_plain(
        dt, qh[half:], ql[half:], None, 0)))
    require(int(got[1].sum()) == 0, "K8: all-miss batch hit")
    # windows of 32 x QUERIES_PER_LANE slots: all valid, none, the last
    W = 32 * lookup.QUERIES_PER_LANE
    m = 64 * W + 5
    pat = np.zeros(m, bool)
    pat[:16 * W] = True
    pat[32 * W - 1:48 * W:W] = True
    pat[48 * W:] = rng.random(m - 48 * W) < 0.3
    pv = torch.from_numpy(pat).to(dev)
    e8 = max(e8, compare(torch, "K8 windows", lookup.probe(
        dt, qh[:m], ql[:m], pv, -7), lookup.probe_plain(
            dt, qh[:m], ql[:m], pv, -7)))
    # chains over max_probes rows from the last bucket, wrapping to 0
    ctab, ch, cl = _chained_table(rng, 100, 1 << 7, (1 << 7) // 8 - 1)
    require(ctab.max_probes >= 3 and (ctab.key_hi.reshape(-1, 8)[:2]
                                      != -1).all(),
            "K8 chained table: no wrapped chain")
    cdt = DeviceTable.from_host(ctab, dev)
    cq = (torch.from_numpy(ch).to(dev), torch.from_numpy(cl).to(dev))
    got = lookup.probe(cdt, *cq, None, -1)
    e8 = max(e8, compare(torch, "K8 chained, wrapped", got,
                         lookup.probe_plain(cdt, *cq, None, -1)))
    require(bool(got[1][:100].all()) and not bool(got[1][100:].any()),
            "K8 chained: wrong hits")
    # the host-digest route's (B, W) queries at odd W
    groups = [(f"g{i}", [encoding.decode_dna(world["reads"][i, e])
                         for e in (0, 1)]) for i in range(512)]
    dh, dl, dv = (torch.from_numpy(x).to(dev) for x in tryptic.digest_groups(
        groups, 7))
    for Wd in (7, 13):
        q = (dh[:, :Wd].contiguous(), dl[:, :Wd].contiguous(),
             dv[:, :Wd].contiguous())
        got = lookup.probe(world["pdtable"], *q, 0)
        require(int(got[1].sum()) > 0, "K8 host-digest queries: no hit")
        e8 = max(e8, compare(torch, f"K8 host digest W={Wd}", got,
                             lookup.probe_plain(world["pdtable"], *q, 0)))
    log(f"K7 edge cases and peptides, K8 at high load (max_probes "
        f"{tab.max_probes}), all-miss, windows, chained over "
        f"{ctab.max_probes} rows with a wrap, host-digest widths: equal")
    return e7, e8


K7_SWEEP = (16, 32, 64, 128)
K8_SWEEP = (1, 2, 4)


def tryptic_sweep(torch, world):
    """K7's reads per block at L = 100 and 160 and K8's queries per lane
    on the bench index, on the main path's inputs, each result equal to
    the default's: device ms with the L2 flushed before each launch
    ("cold") and without. Also K7's warm device ms on inputs that switch
    parts of its work off (all lengths 0: load, translation and stores
    only; poly-C reads: one fragment a lane, no cleave), equal to plain.
    Returns {"K7": {width: {R: ...}}, "K8": {Q: ...}, "K7_parts":
    {...}}."""
    from umgap_tpu_torch.ops import encoding, lookup
    from umgap_tpu_torch.pipeline import tryptic

    tt1 = encoding.get_table(1)
    R0, Q0 = tryptic.READS_PER_BLOCK, lookup.QUERIES_PER_LANE
    out = {"K7": {}, "K8": {}, "K7_parts": {}}
    L = world["L"]
    reads, lens = _batch_reads(torch, world, L)
    polyc = torch.full_like(reads, 0x11)  # C on both nibbles
    for name, r, ln in (("bench", reads, lens),
                        ("lengths_0", reads, torch.zeros_like(lens)),
                        ("poly_c", polyc, lens)):
        def r2p(r=r, ln=ln):
            return tryptic.reads_to_peptides(r, ln, L, tt1)

        compare(torch, f"K7 {name}", r2p(),
                tryptic.reads_to_peptides_plain(r, ln, L, tt1))
        out["K7_parts"][name] = device_ms(torch, r2p)
    try:
        for width in (world["L"], 160):
            reads, lens = _batch_reads(torch, world, width)

            def r2p():
                return tryptic.reads_to_peptides(reads, lens, width, tt1)

            want = r2p()
            out["K7"][width] = {}
            for R in K7_SWEEP:
                tryptic.READS_PER_BLOCK = R
                compare(torch, f"K7 R={R} L={width}", r2p(), want)
                out["K7"][width][R] = dict(
                    cold_device_ms=cold_device_ms(torch, r2p,
                                                  "reads_to_peptides"),
                    device_ms=device_ms(torch, r2p))
            tryptic.READS_PER_BLOCK = R0
            if width == world["L"]:
                h1, h2, pv = want
        dt = world["pdtable"]

        def k8():
            return lookup.probe(dt, h1, h2, pv, 0)

        want = k8()
        for Q in K8_SWEEP:
            lookup.QUERIES_PER_LANE = Q
            compare(torch, f"K8 Q={Q}", k8(), want)
            out["K8"][Q] = dict(
                cold_device_ms=cold_device_ms(torch, k8, "probe_peptide"),
                device_ms=device_ms(torch, k8))
    finally:
        tryptic.READS_PER_BLOCK = R0
        lookup.QUERIES_PER_LANE = Q0
    log("K7 device ms by input: " + ", ".join(
        f"{n} {fmt_ms(t)}" for n, t in out["K7_parts"].items()))
    log("tryptic sweep, device ms (L2 flushed / warm): K7 reads per block "
        + "; ".join(f"L={w} " + ", ".join(
            f"{R}: {fmt_ms(t['cold_device_ms'])} / {fmt_ms(t['device_ms'])}"
            for R, t in d.items()) for w, d in out["K7"].items())
        + " | K8 queries per lane " + ", ".join(
            f"{Q}: {fmt_ms(t['cold_device_ms'])} / {fmt_ms(t['device_ms'])}"
            for Q, t in out["K8"].items()))
    return out


def _dense_hits(torch, dtax, B, K, lo, seed=5):
    """B groups of K slots with lo to K valid hits each (all K when lo
    == K), as dedup leaves them: distinct ids ascending, counts 1-6,
    I32_MAX in the slots after. The ids are drawn from four random
    lineages and the whole taxonomy, so groups branch and nest; made on
    the card from ``seed``, the same for any tree."""
    from umgap_tpu_torch.agg import device as devagg

    dev = dtax.geom.device
    size = dtax.geom.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = torch.randint(1, size, (B, 4), generator=g, device=dev)
    cand = torch.cat([dtax.anc[leaves].reshape(B, -1), torch.randint(
        1, size, (B, K), generator=g, device=dev, dtype=torch.int32)], 1)
    cand = cand.sort(dim=1).values
    dup = torch.zeros_like(cand, dtype=torch.bool)
    dup[:, 1:] = cand[:, 1:] == cand[:, :-1]
    cand = torch.where(dup | (cand < 1), devagg.I32_MAX, cand)
    cand = cand.sort(dim=1).values  # distinct ids first, ascending
    # K of each group's distinct ids at random, kept in ascending order
    score = torch.rand(cand.shape, generator=g, device=dev)
    score = torch.where(cand == devagg.I32_MAX, 2.0, score)
    pick = score.topk(K, dim=1, largest=False).indices.sort(dim=1).values
    utaxa = torch.gather(cand, 1, pick).contiguous()
    n = torch.randint(lo, K + 1, (B, 1), generator=g, device=dev)
    uvalid = (torch.arange(K, device=dev)[None, :] < n) & (
        utaxa != devagg.I32_MAX)
    utaxa = torch.where(uvalid, utaxa, devagg.I32_MAX)
    ucounts = torch.where(uvalid, torch.randint(
        1, 7, (B, K), generator=g, device=dev).float(), 0.0)
    return utaxa, ucounts, uvalid


def _agg_chain(torch, world, utaxa, ucounts, uvalid, width):
    """K5 (hit_geometry's row and ancestry gathers, snap's take) and K6
    (hybrid, lca*, mrtl; its hits entry, the main path's, with and
    without the snap table, and its HitGeometry entry, which runs the
    same launch) on one batch's deduplicated hits, each held to its
    plain version and timed, K6 also by device time, with its bound, its
    floor (no slot valid) and on groups of 17-64 and of 64 valid hits;
    K6 also on the first 1,024 rows padded to the wide program's width
    at this read length."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.ops import gather

    dtax = world["dtax"]
    geom = devagg.hit_geometry(dtax, utaxa, uvalid)
    with kernels.plain_versions():
        want = devagg.hit_geometry(dtax, utaxa, uvalid)
    e5 = compare(torch, f"K5 hit_geometry L={width}", tuple(geom),
                 tuple(want))
    B, K, D = geom.lin.shape
    lin, dep = geom.lin, geom.depth
    # K5 on the main path: the taxonomy row gather (one index per row of
    # [depth | ancestors]), beside one index_select on the same rows;
    # bytes of the distinct rows read, the ids and the output
    safe = torch.where(uvalid, utaxa.clamp(0, dtax.depth.shape[0] - 1), 0)
    safe64 = safe.reshape(-1).to(torch.int64)
    e5 = max(e5, compare(torch, f"K5 row gather L={width}",
                         gather.gather_rows(dtax.geom, safe),
                         gather.take_plain(dtax.geom, safe)))
    row_w = dtax.geom.shape[1]
    rb, rby = bound((int(torch.unique(safe).numel()) * row_w
                     + B * K + B * K * row_w) * 4, 0)
    s5 = dict(
        ms=cuda_ms(torch, lambda: gather.gather_rows(dtax.geom, safe)),
        device_ms=device_ms(torch, lambda: gather.gather_rows(dtax.geom,
                                                              safe)),
        plain_ms=cuda_ms(torch, lambda: gather.take_plain(dtax.geom, safe)),
        library_ms=cuda_ms(torch, lambda: torch.index_select(
            dtax.geom, 0, safe64)),
        bound_ms=rb, bound_by=rby, shape=[B, K, row_w])
    # K5's rows mode at the shape of the ancestry gather
    # a[b, i, j] = lin[b, j, dep[b, i]] that hit_geometry ran before the
    # epilogue (16,384 transposed (26, 64) tiles, staged), beside one
    # torch.gather; bytes: the lineage elements the depths pick, the
    # depths as stored, the output
    lin_t = lin.transpose(1, 2)
    idx = dep[:, :, None].expand(B, K, K)
    idx64 = dep.to(torch.int64)[:, :, None].expand(B, K, K)
    e5 = max(e5, compare(torch, f"K5 ancestry gather L={width}",
                         gather.lane_gather(lin_t, idx),
                         gather.lane_gather_plain(lin_t, idx)))
    read5 = tile_read(torch, (B, D, K), [idx])
    b5, by5 = bound(read5 * 4 + B * K * 4 + B * K * K * 4, 0)
    s5["ancestry_gather"] = dict(
        ms=cuda_ms(torch, lambda: gather.lane_gather(lin_t, idx)),
        device_ms=device_ms(torch, lambda: gather.lane_gather(lin_t, idx)),
        plain_ms=cuda_ms(torch, lambda: gather.lane_gather_plain(lin_t,
                                                                 idx)),
        library_ms=cuda_ms(torch, lambda: torch.gather(lin_t, 1, idx64)),
        bound_ms=b5, bound_by=by5, shape=[B, D, K],
        tile_elements_read=read5)

    # K5's ancestry epilogue: is_anc with the compare and masks fused in,
    # beside the unfused gather, compare and masks it replaced. Bound,
    # from this batch's data: the lineage elements of valid (j, dep[i])
    # pairs, dep, utaxa and valid once, and the (B, K, K) bool output
    uv = uvalid
    e5a = compare(torch, f"K5 ancestry L={width}",
                  gather.ancestry(lin, dep, utaxa, uv),
                  gather.ancestry_plain(lin, dep, utaxa, uv))

    def unfused():
        a = gather.lane_gather(lin_t, idx)
        return (a == utaxa[:, :, None]) & uv[:, :, None] & uv[:, None, :]

    s5a = dict(
        ms=cuda_ms(torch, lambda: gather.ancestry(lin, dep, utaxa, uv)),
        device_ms=device_ms(torch, lambda: gather.ancestry(lin, dep, utaxa,
                                                           uv)),
        plain_ms=cuda_ms(torch, lambda: gather.ancestry_plain(lin, dep,
                                                              utaxa, uv)),
        library_ms=None, shape=[B, K, D],
        unfused_ms=cuda_ms(torch, unfused),
        unfused_device_ms=device_ms(torch, unfused))
    s5a.update(zip(("bound_ms", "bound_by", "needed_lineage_elements"),
                   ancestry_bound(torch, dep, uv, D)))

    # K6 through both entries: tree_aggregate_hits (the main path's: the
    # kernel reads the valid hits' taxonomy rows itself) and
    # tree_aggregate on the HitGeometry above (on the card, the same
    # launch on its valid mask); each held to its plain version and the
    # two entries to each other, also with every slot valid (I32_MAX ids
    # too), with none (the floor) and on the dense batches of
    # chain_device_ms (every group on the warp path)
    s6, e6 = {}, 0.0
    res, snapped = {}, {}
    snapping = dtax.snap_valid
    every, none = torch.ones_like(uvalid), torch.zeros_like(uvalid)
    dense = {n: _dense_hits(torch, dtax, B, K, lo)
             for n, lo in (("dense", 17), ("full", K))}
    for strat in ("hybrid", "lca*", "mrtl"):
        def hits(plain=False, strat=strat, v=uvalid, f=0.25, h=None,
                 snap=None):
            fn = (devagg.tree_aggregate_hits_plain if plain
                  else devagg.tree_aggregate_hits)
            u, c, v = h or (utaxa, ucounts, v)
            return fn(strat, dtax, u, c, v, f, snap=snap)

        def on_geom(plain=False, strat=strat):
            fn = (devagg.tree_aggregate_plain if plain
                  else devagg.tree_aggregate)
            return fn(strat, dtax, geom, utaxa, ucounts, 0.25)

        res[strat] = hits()
        e6 = max(e6, compare(torch, f"K6 {strat} hits L={width}",
                             res[strat], hits(True)),
                 compare(torch, f"K6 {strat} geometry L={width}", on_geom(),
                         on_geom(True)),
                 compare(torch, f"K6 {strat} every slot valid L={width}",
                         hits(v=every), hits(True, v=every)),
                 compare(torch, f"K6 {strat} no slot valid L={width}",
                         hits(v=none), hits(True, v=none)),
                 *(compare(torch, f"K6 {strat} {n} L={width}", hits(h=h),
                           hits(True, h=h)) for n, h in dense.items()))
        require(torch.equal(on_geom(), res[strat]),
                f"K6 {strat} L={width}: the entries differ")
        # with the snap table (the path's): every case again, and the
        # launch equal to K6 then the plain snap
        sn = dict(snap=snapping)
        snapped[strat] = hits(**sn)
        e6 = max(e6, compare(torch, f"K6 {strat} snap L={width}",
                             snapped[strat], hits(True, **sn)),
                 compare(torch, f"K6 {strat} snap every slot valid "
                         f"L={width}", hits(v=every, **sn),
                         hits(True, v=every, **sn)),
                 compare(torch, f"K6 {strat} snap no slot valid L={width}",
                         hits(v=none, **sn), hits(True, v=none, **sn)),
                 *(compare(torch, f"K6 {strat} snap {n} L={width}",
                           hits(h=h, **sn), hits(True, h=h, **sn))
                   for n, h in dense.items()))
        require(torch.equal(snapped[strat], devagg.snap_taxa_plain(
            snapping, res[strat], uvalid)),
            f"K6 {strat} L={width}: snap differs from K6 then snap")
        for f in ((0.5, 1.0) if strat == "hybrid" else ()):
            e6 = max(e6, compare(torch, f"K6 hybrid f={f} L={width}",
                                 hits(f=f), hits(True, f=f)))
        s6[strat] = dict(
            ms=cuda_ms(torch, hits), device_ms=device_ms(torch, hits),
            plain_ms=cuda_ms(torch, lambda: hits(True), reps=5),
            floor_device_ms=device_ms(torch, lambda: hits(v=none)),
            **{n + "_device_ms": device_ms(torch, lambda h=h: hits(h=h))
               for n, h in dense.items()},
            snap_ms=cuda_ms(torch, lambda: hits(**sn)),
            snap_device_ms=device_ms(torch, lambda: hits(**sn)),
            full_snap_device_ms=device_ms(
                torch, lambda: hits(h=dense["full"], **sn)))
    got = devagg.snap_batch(dtax.snap_valid, res["hybrid"])
    with kernels.plain_versions():
        want = devagg.snap_batch(dtax.snap_valid, res["hybrid"])
    e5 = max(e5, compare(torch, f"K5 snap L={width}", got, want))
    # snap's 1-D take, beside one torch.take on the same ids
    snapping = dtax.snap_valid
    ids = res["hybrid"].clamp(0, snapping.shape[0] - 1)
    ids64 = ids.to(torch.int64)
    sb, sby = bound((int(torch.unique(ids).numel()) + 2 * B) * 4, 0)
    s5["snap"] = dict(
        ms=cuda_ms(torch, lambda: gather.take(snapping, ids)),
        device_ms=device_ms(torch, lambda: gather.take(snapping, ids)),
        plain_ms=cuda_ms(torch, lambda: gather.take_plain(snapping, ids)),
        library_ms=cuda_ms(torch, lambda: torch.take(snapping, ids64)),
        bound_ms=sb, bound_by=sby, shape=[int(snapping.shape[0]), B])
    # bounds, from this batch's data: what the valid slots need, each
    # read once, the valid mask read whole and (B,) written once.
    # Operations: hybrid tests and compares once per valid slot a step
    # (its result's depth + 1 steps, at most D - 1); mrtl adds once per
    # valid x valid pair and tests it; lca* tests each pair. Bytes: the
    # ids (and counts, but for lca*) of the valid slots and one row of
    # [depth | ancestors] per distinct valid id.
    nv = uvalid.sum(dim=-1).long()
    steps = (gather.take_plain(dtax.depth, res["hybrid"]) + 1).clamp(
        max=D - 1).long()
    pairs, nvalid = int((nv * nv).sum()), int(nv.sum())
    distinct = int(torch.unique(utaxa[uvalid]).numel())
    fixed = B * K + B * 4
    ops = {"hybrid": int((steps * nv).sum()) * 2, "lca*": pairs,
           "mrtl": 2 * pairs}
    for strat, nop in ops.items():
        nbytes = (fixed + nvalid * (4 if strat == "lca*" else 8)
                  + distinct * (D + 1) * 4)
        s6[strat].update(zip(("bound_ms", "bound_by"), bound(nbytes, nop)))
    paths = [devagg.tree_path(n, K) for n in nv.tolist()]
    s6["groups_by_path"] = {p: paths.count(p)
                            for p in ("thread", "warp", "block")}
    s6["dense_valid_per_group"] = {
        n: float(h[2].sum(dim=-1).float().mean()) for n, h in dense.items()}

    # the wide program's width: the first 1,024 rows padded to it
    kw = 2 * 6 * ((width + 2) // 3)
    n = min(1024, B)
    pad = kw - K
    uw = torch.cat([utaxa[:n], torch.full((n, pad), devagg.I32_MAX,
                                          dtype=torch.int32,
                                          device=utaxa.device)], 1)
    cw = torch.cat([ucounts[:n], ucounts.new_zeros((n, pad))], 1)
    vw = torch.cat([uvalid[:n], uvalid.new_zeros((n, pad))], 1)
    gw = devagg.hit_geometry(dtax, uw, vw)
    with kernels.plain_versions():
        want = devagg.hit_geometry(dtax, uw, vw)
    e5a = max(e5a, compare(torch, f"K5 hit_geometry K={kw}", tuple(gw),
                           tuple(want)))
    # the epilogue at the wide width

    def wide_anc():
        return gather.ancestry(gw.lin, gw.depth, uw, vw)

    wa = {"K": kw, "rows": n, "ms": cuda_ms(torch, wide_anc),
          "device_ms": device_ms(torch, wide_anc)}
    wa.update(zip(("bound_ms", "bound_by", "needed_lineage_elements"),
                  ancestry_bound(torch, gw.depth, vw, D)))
    s5a["wide"] = wa
    wide = {"K": kw, "rows": n}
    for strat in ("hybrid", "lca*", "mrtl"):
        def wh(plain=False, strat=strat):
            fn = (devagg.tree_aggregate_hits_plain if plain
                  else devagg.tree_aggregate_hits)
            return fn(strat, dtax, uw, cw, vw, 0.25)

        def wg(strat=strat):
            return devagg.tree_aggregate(strat, dtax, gw, uw, cw, 0.25)

        got = wh()
        e6 = max(e6, compare(torch, f"K6 {strat} hits K={kw}", got,
                             wh(True)),
                 compare(torch, f"K6 {strat} geometry K={kw}", wg(),
                         devagg.tree_aggregate_plain(strat, dtax, gw, uw,
                                                     cw, 0.25)))
        require(torch.equal(got, res[strat][:n]) and torch.equal(wg(), got),
                f"K6 {strat}: width {kw} differs from width {K}")
        require(torch.equal(devagg.tree_aggregate_hits(
            strat, dtax, uw, cw, vw, 0.25, snap=snapping),
            snapped[strat][:n]),
            f"K6 {strat} snap: width {kw} differs from width {K}")
        wide[strat] = dict(ms=cuda_ms(torch, wh, reps=5),
                           device_ms=device_ms(torch, wh))
    s6["wide"] = wide
    h = s6["hybrid"]
    s6.update(ms=h["ms"], device_ms=h["device_ms"], plain_ms=h["plain_ms"],
              bound_ms=h["bound_ms"], bound_by=h["bound_by"],
              floor_device_ms=h["floor_device_ms"], library_ms=None,
              shape=[B, K, D])
    return (s5, e5), (s5a, e5a), (s6, e6)


K1_SWEEP = (8, 16, 32, 64)
K3_SWEEP = (32, 64, 128)


def block_sweep(torch, world):
    """Device ms of K1 over reads per block and of K3's hits entry over
    lanes per block, on the main path's inputs at L = 100 and 160 (each
    result equal to the default block's). Returns ({width: {R: ms}},
    {width: {T: ms}})."""
    from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate

    tt1 = encoding.get_table(1)
    k1, k3 = {}, {}
    R0, T0 = translate.READS_PER_BLOCK, seedextend.LANES_PER_BLOCK
    try:
        for width in (world["L"], 160):
            reads, lens = _batch_reads(torch, world, width)
            want = translate.reads_to_kmers(reads, lens, width, tt1, 9)
            taxa = lookup.probe(world["dtable"], *want[:3], 0)[0]
            nk = (want[3] - 8).clamp(min=0)
            hits = seedextend.seedextend_hits(taxa, nk, 3, 1)
            k1[width], k3[width] = {}, {}
            for R in K1_SWEEP:
                translate.READS_PER_BLOCK = R
                compare(torch, f"K1 R={R} L={width}", translate.reads_to_kmers(
                    reads, lens, width, tt1, 9), want)
                k1[width][R] = device_ms(torch, lambda: translate
                                         .reads_to_kmers(reads, lens, width,
                                                         tt1, 9))
            translate.READS_PER_BLOCK = R0
            for T in K3_SWEEP:
                seedextend.LANES_PER_BLOCK = T
                compare(torch, f"K3 T={T} L={width}",
                        seedextend.seedextend_hits(taxa, nk, 3, 1), hits)
                k3[width][T] = device_ms(torch, lambda: seedextend
                                         .seedextend_hits(taxa, nk, 3, 1))
            seedextend.LANES_PER_BLOCK = T0
    finally:
        translate.READS_PER_BLOCK = R0
        seedextend.LANES_PER_BLOCK = T0
    log("block sweep, device ms: K1 reads per block " + "; ".join(
        f"L={w} " + ", ".join(f"{R}: {fmt_ms(t)}" for R, t in d.items())
        for w, d in k1.items()) + " | K3 lanes per block " + "; ".join(
        f"L={w} " + ", ".join(f"{T}: {fmt_ms(t)}" for T, t in d.items())
        for w, d in k3.items()))
    return k1, k3


def fused_tail(devagg) -> bool:
    """Whether a tree's K4 takes the lower bound and its K6 the snap
    table (the tail after K3 in two launches)."""
    import inspect

    return "lower_bound" in inspect.signature(devagg.dedup_counts).parameters


def _k6_bound(torch, dtax, res, utaxa, uvalid, D):
    """K6's bounds on this data, by strategy (see _agg_chain): the valid
    slots' ids (and counts, but for lca*), a row of [depth | ancestors]
    per distinct valid id, the mask read whole and (B,) written;
    operations per valid slot a hybrid step and, at K <= 64 (the thread
    and warp walks), per valid pair; past K = 64 (the block path, which
    scores each distinct id by a search of its D ancestors among the
    group's sorted ids), lca* and mrtl take ceil(log2 n) compares per
    (slot, depth) and mrtl one add more."""
    from umgap_tpu_torch.ops import gather

    B, K = utaxa.shape
    nv = uvalid.sum(dim=-1).long()
    steps = (gather.take_plain(dtax.depth, res["hybrid"]) + 1).clamp(
        max=D - 1).long()
    pairs, nvalid = int((nv * nv).sum()), int(nv.sum())
    distinct = int(torch.unique(utaxa[uvalid]).numel())
    ops = {"hybrid": int((steps * nv).sum()) * 2, "lca*": pairs,
           "mrtl": 2 * pairs}
    if K > 64:
        lg = torch.ceil(torch.log2(nv.clamp(min=1).double())).long()
        search = int((nv * D * lg).sum())
        ops.update({"lca*": search, "mrtl": search + nvalid * D})
    return {strat: bound(B * K + B * 4 + nvalid * (4 if strat == "lca*"
                                                   else 8)
                         + distinct * (D + 1) * 4, nop)
            for strat, nop in ops.items()}


# K6 at the wide program's widths, 2 x 6 x floor((L + 2) / 3) for paired
# reads of L = 100, 160, 1,024, 2,048, 4,096 and 8,000 bp (the last past a
# block's shared memory: the global scratch), on K6_GROUPS groups each
K6_WIDE = (408, 648, 4104, 8196, 16392, 32004)
K6_WIDE_MAIN = 16392  # the ladder sample's wide program
K6_GROUPS = 8


def k6_wide(torch, world, check=True):
    """K6 (tree_aggregate_hits) for each strategy on K6_GROUPS
    ``_dense_hits`` groups of 65 to K valid distinct taxa at each K of
    K6_WIDE, by this code on any tree: device ms, event ms, the bound
    from this run's data and the share. With ``check``, each result held
    to tree_aggregate_hits_plain (whose (B, K, K) tensors take 4 groups
    a call, 1 past K = 16,392) and the plain version timed.
    Returns ({K: stats}, max abs err)."""
    from umgap_tpu_torch.agg import device as devagg

    dtax = world["dtax"]
    D = dtax.geom.shape[1] - 1
    out, err = {}, 0.0
    for K in K6_WIDE:
        u, c, v = _dense_hits(torch, dtax, K6_GROUPS, K, 65, seed=11)
        row, res = {}, {}
        step = 4 if K <= K6_WIDE_MAIN else 1
        for strat in ("hybrid", "lca*", "mrtl"):
            def k6(strat=strat):
                return devagg.tree_aggregate_hits(strat, dtax, u, c, v, 0.25)

            def plain(strat=strat):
                return torch.cat([devagg.tree_aggregate_hits_plain(
                    strat, dtax, u[i:i + step], c[i:i + step],
                    v[i:i + step], 0.25) for i in range(0, K6_GROUPS, step)])

            res[strat] = k6()
            if check:
                err = max(err, compare(torch, f"K6 {strat} K={K}",
                                       res[strat], plain()))
            dm, by = device_ms(torch, k6, reps=2, by=True)
            row[strat] = dict(ms=cuda_ms(torch, k6, reps=2), device_ms=dm,
                              device_ms_by=by)
            if check:
                row[strat]["plain_ms"] = cuda_ms(torch, plain, reps=1)
            if fused_tail(devagg):  # the same launch with the snap table
                def k6s(strat=strat):
                    return devagg.tree_aggregate_hits(
                        strat, dtax, u, c, v, 0.25, snap=dtax.snap_valid)

                if check:
                    err = max(err, compare(
                        torch, f"K6 {strat} snap K={K}", k6s(),
                        devagg.snap_taxa_plain(dtax.snap_valid, res[strat],
                                               v)))
                row[strat]["snap_device_ms"] = device_ms(torch, k6s, reps=2)
        for strat, (b, by) in _k6_bound(torch, dtax, res, u, v, D).items():
            dm = row[strat]["device_ms"]
            row[strat].update(bound_ms=b, bound_by=by,
                              share=b / dm if dm else None)
        row.update(valid_per_group=v.sum(dim=1).tolist(),
                   scratch_bytes=devagg.tree_scratch_bytes(K6_GROUPS, K))
        out[K] = row
    log("K6 wide, device ms (bound): " + "; ".join(
        f"K={K} " + ", ".join(
            f"{s} {fmt_ms(r[s]['device_ms'])} ({r[s]['bound_ms']:.5f})"
            for s in ("hybrid", "lca*", "mrtl"))
        for K, r in out.items()))
    return out, err


def _ladder_paths(world):
    """Writes the ladder sample (``_ladder_reads``) as R1/R2 FASTQ under
    TMP_DIR; returns the two paths and the lengths."""
    codes, lens = _ladder_reads(world["reads"], LADDER_GROUPS)
    paths = [os.path.join(TMP_DIR, f"ladder_R{e + 1}.fq") for e in (0, 1)]
    lut = np.frombuffer(b"ACGTN", np.uint8)
    for e in (0, 1):
        with open(paths[e], "wb") as f:
            for i in range(LADDER_GROUPS):
                seq = lut[codes[i, e, :lens[i, e]]].tobytes()
                f.write(b"@l%d/%d\n%s\n+\n%s\n" % (
                    i, e + 1, seq, b"I" * len(seq)))
    return paths, lens


def ladder_wide(torch, run):
    """Where the ladder sample's time goes, by this code on any tree:
    ``run()`` (the sample through the CLI's tiers, its programs built)
    once with the wide program timed (``Analyser.run_wide_packed``, a
    sync on each side) and its K6 calls past K = 64 recorded (valid
    slots of each overflow group, batches, rows a batch), then under the
    profiler (``_profile_window``) for the device ms of K6's kernels and
    of all."""
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.pipeline import runner

    rec = dict(wide_calls=0, groups=0, batches=0, rows=[], valid=[],
               wide_s=0.0)
    left = [0]
    hits0, wide0 = devagg.tree_aggregate_hits, runner.Analyser.run_wide_packed

    def hits(strategy, dtax, utaxa, ucounts, uvalid, *rest):
        if utaxa.shape[1] > 64:
            m = min(left[0], utaxa.shape[0])
            left[0] -= m
            rec["batches"] += 1
            rec["rows"].append(int(utaxa.shape[0]))
            rec["valid"] += uvalid[:m].sum(dim=1).tolist()
        return hits0(strategy, dtax, utaxa, ucounts, uvalid, *rest)

    def wide(self, dna4, lens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        left[0] = len(dna4)
        try:
            return wide0(self, dna4, lens)
        finally:
            torch.cuda.synchronize()
            rec["wide_s"] += time.perf_counter() - t0
            rec["wide_calls"] += 1
            rec["groups"] += len(dna4)

    devagg.tree_aggregate_hits, runner.Analyser.run_wide_packed = hits, wide
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        devagg.tree_aggregate_hits = hits0
        runner.Analyser.run_wide_packed = wide0
    prof = _profile_window(torch, run, 1)
    k6 = [v for k, v in prof.items() if "tree_" in k]
    rec.update(device_ms=sum(v[0] for v in prof.values()),
               k6_device_ms=sum(v[0] for v in k6),
               k6_launches=sum(v[1] for v in k6))
    v = rec["valid"]
    log(f"ladder split: wall {rec['wall_s']:.3f} s, wide program "
        f"{rec['wide_s']:.3f} s ({rec['groups']} groups in {rec['batches']} "
        f"batches of {rec['rows'][:1]} rows), device {rec['device_ms']:.1f} "
        f"ms of which K6 {rec['k6_device_ms']:.1f} ms in "
        f"{rec['k6_launches']} launches; valid slots a group "
        f"{min(v) if v else 0}-{max(v) if v else 0}")
    return rec


# The width ladder's rungs past K3's staged tile and K4's warp path:
# paired reads of 512 to 4,096 bp, W = L // 3 - 8 windows a lane and
# N = 12 W hits a row (W = 162, 333, 674, 1,357; N = 1,944 to 16,284)
LADDER_RUNGS = (512, 1024, 2048, 4096)


def _row_inputs(torch, world, codes, L):
    """K3's and K4's inputs on real hits: (B, E, L) read codes through K1
    and K2 and, for K4, K3 at high-sensitivity's seeds (s = 3, g = 1), as
    the pipeline's stages pass them. Returns (taxa (B E, 6, W), nkmers
    (B E, 6), hits (B, 6 E W))."""
    from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate

    B, E, _l = codes.shape
    dna4 = torch.from_numpy(encoding.pack_dna4(np.ascontiguousarray(
        codes))).to(world["dev"]).reshape(B * E, -1)
    lens = torch.full((B * E,), L, dtype=torch.int32, device=world["dev"])
    hi, lo, wvalid, plens = translate.reads_to_kmers(
        dna4, lens, L, encoding.get_table(1), 9)
    taxa = lookup.probe(world["dtable"], hi, lo, wvalid, 0)[0]
    nk = (plens - 8).clamp(min=0)
    hits = seedextend.seedextend_hits(taxa, nk, 3, 1).reshape(B, -1)
    return taxa, nk, hits.contiguous()


def _rung_codes(world, L):
    """The reads of rung L: B read pairs (the batch the CLI's chunked tier
    runs at width L for a sample of many batches) whose ends are each L
    bp of consecutive bench reads of that end (as ``_ladder_reads``
    builds them)."""
    from umgap_tpu_torch import cli

    B = cli._pow2_bucket(1 << 30, 64, max(64, BATCH * 160 // L))
    reads = world["reads"]
    P, _e, L0 = reads.shape
    pieces = -(-L // L0)
    idx = (np.arange(B)[:, None] * pieces + np.arange(pieces)) % P
    codes = reads[idx].transpose(0, 2, 1, 3).reshape(B, 2, pieces * L0)
    return codes[:, :, :L]


def _k3_synthetic(torch, dev, seed=29):
    """1,536 lanes of 4,000 windows: runs with gaps, lengths 0..N."""
    rng = np.random.default_rng(seed)
    NW, nl = 4000, 1536
    runs = rng.choice(np.array([0, 0, 0, 5, 6, 7], np.int32), size=(nl, NW))
    rep = rng.random((nl, NW)) < 0.6
    for j in range(1, NW):
        runs[:, j] = np.where(rep[:, j], runs[:, j - 1], runs[:, j])
    lr = rng.integers(0, NW + 1, size=nl).astype(np.int32)
    lr[::7] = NW
    return torch.from_numpy(runs).to(dev), torch.from_numpy(lr).to(dev)


def _k4_synthetic(torch, dev, seed=30):
    """600 rows of 24,576 hits, 0-100% valid, ids from small and large
    pools, and integer weights 0-3."""
    rng = np.random.default_rng(seed)
    NH, rows = 24576, 600
    ids = rng.integers(-1, 2000, size=(rows, NH)).astype(np.int32)
    ids[rng.random((rows, NH)) >= rng.random((rows, 1))] = 0
    ids[::3] = np.where(ids[::3] > 0, ids[::3] % 7 + 1, ids[::3])
    wt = rng.integers(0, 4, size=(rows, NH)).astype(np.float32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(wt).to(dev)


def k3_cell(torch, taxa, nk, check, what):
    """K3 on one input at high-sensitivity's seeds, by this code on any
    tree: its path, event ms, device ms, the bound from the shape (each
    window's taxon read and its hit written once, bytes) and, with
    ``check``, the hits held to both plain versions (the position loop
    and ``seedextend_runs_plain``) and the mask (s = 2, g = 0) to the
    position loop's, the position loop's one run timed (host clock,
    synced). Returns (stats, err)."""
    from umgap_tpu_torch.ops import seedextend

    NW = taxa.shape[-1]
    nl = nk.numel()

    def k3():
        return seedextend.seedextend_hits(taxa, nk, 3, 1)

    ms, by = device_ms(torch, k3, reps=5, by=True)
    b, bb = bound(nl * (NW * 8 + 4), nl * NW * 20)
    st = dict(path=seedextend.seedextend_path(NW), shape=[nl, NW],
              ms=cuda_ms(torch, k3, reps=5), device_ms=ms, device_ms_by=by,
              bound_ms=b, bound_by=bb, library_ms=None)
    err = 0.0
    if check:
        got = k3()
        # the position loop's one run is both the check and its time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = seedextend.seedextend_hits_plain(taxa, nk, 3, 1)
        torch.cuda.synchronize()
        st["plain_ms"] = (time.perf_counter() - t0) * 1e3
        err = max(compare(torch, f"K3 {what} hits", got, plain),
                  compare(torch, f"K3 {what} hits (runs plain)", got,
                          seedextend.seedextend_runs_plain(taxa, nk, 3, 1,
                                                           hits=True)),
                  compare(torch, f"K3 {what} mask",
                          seedextend.seedextend_mask_batch(taxa, nk, 2, 0),
                          seedextend.seedextend_mask_plain(taxa, nk, 2, 0)))
    return st, err


def k4_cell(torch, hits, weights, k_max, check, what):
    """K4 on one input, by this code on any tree: its path, event ms,
    device ms, the bound from this run's data (the row read and the
    output written once, bytes; a sort of each row's valid hits,
    operations) and, with ``check``, the result held to both plain
    versions (``dedup_counts_plain`` and ``dedup_counts_rows_plain``),
    with and without the weights given, the first timed. Returns
    (stats, err)."""
    from umgap_tpu_torch.agg import device as devagg

    rows, NH = hits.shape

    def k4():
        return devagg.dedup_counts(hits, None, k_max, True)

    def k4_bound():
        return devagg.dedup_counts(hits, None, k_max, True, lower_bound=2.0)

    ms, by = device_ms(torch, k4, reps=5, by=True)
    nv = (hits > 0).sum(dim=1).cpu().numpy().astype(np.int64)
    lg = np.ceil(np.log2(np.maximum(nv, 1))).astype(np.int64)
    b, bb = bound(rows * NH * 4 + rows * (k_max * 9 + 4),
                  int((nv * lg).sum()) * 4)
    st = dict(path=devagg.dedup_path(NH), shape=[rows, NH], k_max=k_max,
              valid_per_row=[int(nv.min()), float(nv.mean()), int(nv.max())],
              ms=cuda_ms(torch, k4, reps=5), device_ms=ms, device_ms_by=by,
              bound_ms=b, bound_by=bb, library_ms=None)
    if fused_tail(devagg):
        st["lower_bound_device_ms"] = device_ms(torch, k4_bound, reps=5)
    err = 0.0
    if check and fused_tail(devagg):
        err = compare(torch, f"K4 {what} lower bound", k4_bound(),
                      devagg.dedup_counts_plain(hits, None, k_max, True,
                                                lower_bound=2.0))
    if check:
        for w in (None, weights):
            got = devagg.dedup_counts(hits, w, k_max, True)
            tag = f"K4 {what}" + (" weighted" if w is not None else "")
            err = max(err, compare(torch, tag, got, devagg.dedup_counts_plain(
                hits, w, k_max, True)), compare(
                torch, tag + " (rows plain)", got,
                devagg.dedup_counts_rows_plain(hits, w, k_max, True)))
        st["plain_ms"] = cuda_ms(
            torch, lambda: devagg.dedup_counts_plain(hits, None, k_max, True),
            reps=2)
    return st, err


def long_rows(torch, world, check=True):
    """K3 and K4 past the main path's variants, by this code on any
    tree: at each rung of LADDER_RUNGS on the rung's real hits (K3 at
    W = 162-1,357 windows a lane, K4 at N = 1,944-16,284 hits a row, the
    CLI's batch there), on the 12,000 bp path's batch (12,288 lanes of
    3,992 windows, 2,048 rows of 23,952 hits: the row kernels' entries
    on the kernels line) and on the synthetic rows (K3 1,536 lanes of
    4,000 windows, K4 600 rows of 24,576 hits); ``k3_cell`` and
    ``k4_cell`` each. Returns ((K3 stats, err), (K4 stats, err)), the
    stats by cell name with the 4,000 / 24,576 cell's numbers on top."""
    dev = world["dev"]
    k3, k4, e3, e4 = {}, {}, 0.0, 0.0
    samples = [(L, f"rung {L} bp", lambda L=L: _rung_codes(world, L))
               for L in LADDER_RUNGS]
    samples.append((LONG12K_BP, "the 12,000 bp batch",
                    lambda: _long_sample(world)[0]))
    for L, what, codes in samples:
        taxa, nk, hits = _row_inputs(torch, world, codes(), L)
        W = taxa.shape[-1]
        t0 = time.perf_counter()
        k3[f"W={W}"], e = k3_cell(torch, taxa, nk, check, what)
        k3[f"W={W}"]["cell_s"] = time.perf_counter() - t0
        e3 = max(e3, e)
        wt = torch.from_numpy(np.random.default_rng(L).integers(
            0, 4, size=tuple(hits.shape)).astype(np.float32)).to(dev)
        t0 = time.perf_counter()
        k4[f"N={hits.shape[1]}"], e = k4_cell(torch, hits, wt, 64, check,
                                              what)
        k4[f"N={hits.shape[1]}"]["cell_s"] = time.perf_counter() - t0
        e4 = max(e4, e)
        del taxa, nk, hits, wt
    tr, lt = _k3_synthetic(torch, dev)
    t0 = time.perf_counter()
    k3["W=4000"], e = k3_cell(torch, tr, lt, check, "W=4000")
    k3["W=4000"]["cell_s"] = time.perf_counter() - t0
    e3 = max(e3, e)
    tx, wt = _k4_synthetic(torch, dev)
    t0 = time.perf_counter()
    k4["N=24576"], e = k4_cell(torch, tx, wt, 64, check, "N=24576")
    k4["N=24576"]["cell_s"] = time.perf_counter() - t0
    e4 = max(e4, e)
    log("long rows, seconds a cell (checks and timings): K3 " + ", ".join(
        f"{c} {v['cell_s']:.1f}" for c, v in k3.items()) + "; K4 " +
        ", ".join(f"{c} {v['cell_s']:.1f}" for c, v in k4.items()))
    log("long rows, device ms (bound): K3 " + ", ".join(
        f"{c} {fmt_ms(v['device_ms'])} ({v['bound_ms']:.4f})"
        for c, v in k3.items()) + "; K4 " + ", ".join(
        f"{c} {fmt_ms(v['device_ms'])} ({v['bound_ms']:.4f})"
        for c, v in k4.items()))
    s3 = dict(k3["W=4000"], by_cell=k3)
    s4 = dict(k4["N=24576"], by_cell=k4)
    return (s3, e3), (s4, e4)


def wide_paths(torch, world):
    """Each kernel's path for rows past its shared-memory budget, at the
    widths of the card tests, held to its plain version and timed, with
    its bound from this run's data: K1's direct kernel on reads of
    20,000 bp, K3's and K4's row kernels at each rung of the width
    ladder and at 4,000 windows a lane and 24,576 hits a row
    (``long_rows``), K6's block path at each width
    of K6_WIDE (``k6_wide``: the wide program of paired reads of 100 to
    4,096 bp, and at K = 32,004 its global scratch) on groups of 65 to K
    valid distinct taxa, and K7's direct kernel on reads of 70,001 bp.
    Returns {kernel: (stats, max abs err)}."""
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.ops import encoding, translate

    dev = world["dev"]
    rng = np.random.default_rng(29)
    out = {}

    # K1: 64 reads of up to 20,000 bp, N codes included
    L, n = 20000, 64
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.02] = 4
    ln = rng.integers(L // 2, L + 1, size=n).astype(np.int32)
    ln[0] = L
    reads = torch.from_numpy(encoding.pack_dna4(codes)).to(dev)
    lens = torch.from_numpy(ln).to(dev)
    tt1 = encoding.get_table(1)

    def k1(plain=False):
        fn = (translate.reads_to_kmers_plain if plain
              else translate.reads_to_kmers)
        return fn(reads, lens, L, tt1, 9)

    got = k1()
    e1 = compare(torch, f"K1 direct L={L}", got, k1(True))
    W = got[0].shape[-1]
    b, by = bound(reads.numel() + 4 * n + n * 6 * (W * 9 + 4),
                  n * 6 * (W + 8) * 16)
    out["reads_to_kmers"] = (dict(
        path=translate.reads_to_kmers_path(L), shape=[n, L],
        ms=cuda_ms(torch, k1, reps=5), device_ms=device_ms(torch, k1, reps=5),
        plain_ms=cuda_ms(torch, lambda: k1(True), reps=2), bound_ms=b,
        bound_by=by), e1)

    # K7: 16 reads of up to 70,001 bp (past the tile at one read a
    # block): the direct kernel
    from umgap_tpu_torch.pipeline import tryptic

    L7, n7 = 70001, 16
    codes = rng.integers(0, 4, size=(n7, L7)).astype(np.uint8)
    codes[rng.random((n7, L7)) < 0.02] = 4
    ln = rng.integers(L7 // 2, L7 + 1, size=n7).astype(np.int32)
    ln[0] = L7
    reads7 = torch.from_numpy(encoding.pack_dna4(codes)).to(dev)
    lens7 = torch.from_numpy(ln).to(dev)

    def k7(plain=False):
        fn = (tryptic.reads_to_peptides_plain if plain
              else tryptic.reads_to_peptides)
        return fn(reads7, lens7, L7, tt1)

    got = k7()
    e7 = compare(torch, f"K7 direct L={L7}", got, k7(True))
    F = got[0].shape[-1]
    b, by = bound(reads7.numel() + 4 * n7 + n7 * 6 * F * 9,
                  n7 * 6 * (L7 // 3) * 16)
    out["reads_to_peptides"] = (dict(
        path="direct", shape=[n7, L7], ms=cuda_ms(torch, k7, reps=3),
        device_ms=device_ms(torch, k7, reps=3),
        plain_ms=cuda_ms(torch, lambda: k7(True), reps=1), bound_ms=b,
        bound_by=by), e7)

    # K3 and K4's row kernels: at each rung of the width ladder on the
    # rung's own hits, and on the synthetic rows past the parent's
    # shared-memory paths
    out["seedextend_rows"], out["dedup_rows"] = long_rows(torch, world,
                                                          check=True)

    # K6: 8 groups of 65 to K valid distinct taxa at each of the wide
    # program's widths (K6_WIDE), each held to its plain version
    by_k, e6 = k6_wide(torch, world, check=True)
    K = K6_WIDE_MAIN
    s6 = dict(by_k[K])
    h = s6["hybrid"]
    s6.update(by_K=by_k, path=devagg.tree_path(K, K), shape=[K6_GROUPS, K],
              ms=h["ms"], device_ms=h["device_ms"], plain_ms=h["plain_ms"],
              bound_ms=h["bound_ms"], bound_by=h["bound_by"])
    out["tree_aggregate"] = (s6, e6)
    log("wide paths, kernels equal to plain: " + ", ".join(
        f"{k} {st['path']} {st['shape']} {st['ms']:.3f} ms (device "
        f"{fmt_ms(st['device_ms'])}, plain {st['plain_ms']:.1f}, bound "
        f"{st['bound_ms']:.4f} {st['bound_by']})"
        for k, (st, _e) in out.items()))
    return out


def phase_kernels(torch, world):
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.index import table as T
    from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate
    from umgap_tpu_torch.ops.lookup import DeviceTable

    dev = world["dev"]
    rng = np.random.default_rng(7)
    t_phase = time.perf_counter()

    # ---- main-path shapes: one 16,384-pair batch at L = 100 and 160 --- #
    # (the main phase's program, and the CLI's default --read-length)
    stats, errs = _chain(torch, world, world["L"])
    stats160, errs160 = _chain(torch, world, 160)
    for n, s in stats160.items():
        errs[n] = max(errs[n], errs160[n])
        stats[n]["L160"] = s

    # the tryptic path's K7 -> K8 at the same two widths
    tstats, terrs = _tryptic_chain(torch, world, world["L"])
    tstats160, terrs160 = _tryptic_chain(torch, world, 160)
    for n, s in tstats160.items():
        terrs[n] = max(terrs[n], terrs160[n])
        tstats[n]["L160"] = s
    stats.update(tstats)
    errs.update(terrs)
    e7, e8 = _tryptic_edges(torch, world, rng)
    errs["reads_to_peptides"] = max(errs["reads_to_peptides"], e7)
    errs["probe_peptide"] = max(errs["probe_peptide"], e8)
    # K7's reads per block and K8's queries per lane, swept
    sweep = tryptic_sweep(torch, world)
    stats["reads_to_peptides"]["sweep"] = sweep["K7"]
    stats["reads_to_peptides"]["by_input"] = sweep["K7_parts"]
    stats["probe_peptide"]["sweep"] = sweep["K8"]

    # the block sizes of K1 (reads) and K3 (lanes), swept
    stats["reads_to_kmers"]["sweep"], stats["seedextend_mask"]["sweep"] = \
        block_sweep(torch, world)

    # ---- K1 edge cases: short/odd reads, N codes, tables 1/4/11, read
    # counts no multiple of the block's reads, an unaligned span ------- #
    for L2, packed, tno, meth in ((160, True, 1, False), (160, True, 11, False),
                                  (160, True, 4, True), (100, False, 1, False),
                                  (17, True, 1, False), (161, True, 1, True)):
        n = 2 * BATCH + 1 if L2 == 160 else 4097
        codes = rng.integers(0, 4, size=(n, L2)).astype(np.uint8)
        codes[rng.random((n, L2)) < 0.03] = 4
        ln = rng.integers(0, L2 + 1, size=n).astype(np.int32)
        ln[: n // 8] = rng.integers(0, 27, size=n // 8)
        ln[n // 8: n // 4] = L2 + 5  # clamped to L2
        src = encoding.pack_dna4(codes) if packed else codes
        big = torch.from_numpy(src).to(dev)
        # L = 161: the rows from the second on, whose span starts off a
        # 16-byte boundary
        r = big[1:] if L2 == 161 else big
        lt = torch.from_numpy(ln[1:] if L2 == 161 else ln).to(dev)
        require(L2 != 161 or r.data_ptr() % 16, "K1: span not unaligned")
        tt = encoding.get_table(tno)
        errs["reads_to_kmers"] = max(errs["reads_to_kmers"], compare(
            torch, f"K1 L={L2} packed={packed} table={tno} met={meth}",
            translate.reads_to_kmers(r, lt, L2, tt, 9, packed, meth),
            translate.reads_to_kmers_plain(r, lt, L2, tt, 9, packed, meth)))

    # ---- K2 edge cases: bucket widths, stash, max_probes 1, all-miss -- #
    keys, vals = world["keys"], world["vals"]
    sub = rng.choice(len(keys), size=200_000, replace=False)
    skeys, svals = keys[sub], vals[sub]
    tables = {
        "bucket16": T.build_kmer_table(skeys, svals, 9, layout="bucket16"),
        "bucket64s": T.build_kmer_table(skeys, svals, 9, layout="bucket64s"),
        "bucket8s_stash": _stash_table(T, skeys[:150_000], svals[:150_000]),
        "bucket8_probes1": _probes1_table(T, skeys[:150_000],
                                          svals[:150_000]),
    }
    absent = rng.integers(0, 2 ** 45, size=1_500_000, dtype=np.uint64)
    absent = absent[~np.isin(absent, keys)][:1_000_000]
    for name, tab in tables.items():
        dt = DeviceTable.from_host(tab, dev)
        present, _ = _table_keys(T, tab)
        nq = 1_000_000
        q = np.concatenate([
            rng.choice(present, size=nq // 2),
            absent[: nq - nq // 2]])
        if len(tab.stash_hi):
            st = T.kmers.join_packed(tab.stash_hi, tab.stash_lo)
            q[: nq // 10] = rng.choice(st, size=nq // 10)
        qh, ql = T.kmers.split_packed(q)
        hq = torch.from_numpy(qh).to(dev)
        lq = torch.from_numpy(ql).to(dev)
        vq = torch.from_numpy(rng.random(nq) < 0.9).to(dev)
        got = lookup.probe(dt, hq, lq, vq, -7)
        errs["probe_kmer"] = max(errs["probe_kmer"], compare(
            torch, f"K2 {name}", got, lookup.probe_plain(dt, hq, lq, vq, -7)))
        require(int(got[1].sum()) > nq // 3, f"K2 {name}: too few hits")
        miss = (torch.from_numpy(T.kmers.split_packed(absent)[0]).to(dev),
                torch.from_numpy(T.kmers.split_packed(absent)[1]).to(dev))
        got = lookup.probe(dt, miss[0], miss[1], None, 0)
        errs["probe_kmer"] = max(errs["probe_kmer"], compare(
            torch, f"K2 {name} all-miss", got,
            lookup.probe_plain(dt, miss[0], miss[1], None, 0)))
        require(int(got[1].sum()) == 0, f"K2 {name}: all-miss batch hit")
        log(f"K2 {name}: bucket {tab.bucket}, max_probes {tab.max_probes}, "
            f"stash {len(tab.stash_hi)}: equal")

    # ---- K3 edge cases: min seed 2..4, gap 0..2, random runs, all-zero
    # lanes, lengths 0 and W; W = 45 (a template width), 52 (an even
    # width: the padded tile stride) and 120 (past the tile: the direct
    # kernel); lane counts no multiple of the block's lanes ------------ #
    nl = 100_001
    for NW in (45, 52, 120):
        runs = rng.choice(np.array([0, 0, 0, 5, 6, 7], np.int32),
                          size=(nl, NW))
        rep = rng.random((nl, NW)) < 0.6
        for j in range(1, NW):
            runs[:, j] = np.where(rep[:, j], runs[:, j - 1], runs[:, j])
        runs[: nl // 20] = 0
        lr = rng.integers(0, NW + 1, size=nl).astype(np.int32)
        lr[nl // 2::9], lr[nl // 2 + 1::9] = 0, NW
        tr = torch.from_numpy(runs).to(dev)
        lt = torch.from_numpy(lr).to(dev)
        for s in (2, 3, 4):
            for g in (0, 1, 2):
                what = (f"K3 W={NW} ({seedextend.seedextend_path(NW)}) "
                        f"s={s} g={g}")
                errs["seedextend_mask"] = max(
                    errs["seedextend_mask"],
                    compare(torch, what + " hits",
                            seedextend.seedextend_hits(tr, lt, s, g),
                            seedextend.seedextend_hits_plain(tr, lt, s, g)),
                    compare(torch, what + " mask",
                            seedextend.seedextend_mask_batch(tr, lt, s, g),
                            seedextend.seedextend_mask_plain(tr, lt, s, g)))

    # ---- K4 edge cases: k_max below and above N, weights -------------- #
    # (dense rows: the warp path's shared-memory sort; sparse rows: its
    # register sort; N = 2,048: the block path)
    for NH2, kmax, weighted, density in (
            (540, 16, False, 1.0), (540, 600, False, 1.0),
            (540, 64, True, 1.0), (37, 8, False, 1.0), (300, 64, False, 0.1),
            (300, 64, True, 0.1), (2048, 64, False, 1.0),
            (2048, 64, True, 0.05)):
        ids = rng.integers(-1, 60, size=(4096, NH2))
        ids[rng.random((4096, NH2)) >= density] = 0
        tx = torch.from_numpy(ids.astype(np.int32)).to(dev)
        w = (torch.from_numpy(rng.integers(0, 4, size=(4096, NH2)).astype(
            np.float32)).to(dev) if weighted else None)
        errs["dedup_counts"] = max(errs["dedup_counts"], compare(
            torch, f"K4 N={NH2} k_max={kmax} w={weighted} "
            f"density={density} ({devagg.dedup_path(NH2)} path)",
            devagg.dedup_counts(tx, w, kmax, True),
            devagg.dedup_counts_plain(tx, w, kmax, True)))

    # ---- the wide paths: rows past each kernel's shared-memory budget -- #
    for n, (s, e) in wide_paths(torch, world).items():
        errs[n] = max(errs.get(n, 0.0), e)
        stats.setdefault(n, {})["wide_path"] = s

    for n, e in errs.items():
        stats[n]["max_abs_err"] = e
        stats[n]["equal"] = e == 0.0
    RESULT["phases"]["kernels"] = dict(seconds=time.perf_counter() - t_phase,
                                       stats=stats)
    log("phase kernels: every kernel equal to its plain version")
    return stats


# The TPU gather kernels K5 ports, at their own shapes: (row, source,
# mode, shape). Modes: "rows" take_along_axis on axis 0 of G (S, 128)
# tiles with (I, 128) indices ("bcast": one row index per row, expanded
# over the lanes; "shift": the index is idx >> 7, applied by the
# caller); "take" 1-D; "repeat" the repeat-and-sum loop on axis 0 or 1.
GATHER_ROWS = (
    ("#2", "scripts/exp_pallas_dma.py:171 dyngather_case", "rows",
     dict(S=1024, I=1024, bcast=True)),
    ("#3", "scripts/exp_pallas_gather.py:47 k1", "take", dict(S=8192, I=4096)),
    ("#4", "scripts/exp_pallas_gather.py:62 k2", "rows", dict(S=8192, I=32)),
    ("#5", "scripts/exp_pallas_gather.py:77 k3", "rows",
     dict(S=8192, I=32, shift=True)),
    ("#6 axis 0 x1", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=0, repeat=1)),
    ("#6 axis 0 x16", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=0, repeat=16)),
    ("#6 axis 0 x64", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=0, repeat=64)),
    ("#6 axis 1 x1", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=1, repeat=1)),
    ("#6 axis 1 x16", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=1, repeat=16)),
    ("#6 axis 1 x64", "scripts/exp_dyngather.py:37 make", "repeat",
     dict(S=4096, axis=1, repeat=64)),
    ("#7 S=512", "scripts/exp_probe_primitives.py:66 f3", "rows",
     dict(S=512, I=512)),
    ("#7 S=2048", "scripts/exp_probe_primitives.py:66 f3", "rows",
     dict(S=2048, I=2048)),
    ("#7 S=8192", "scripts/exp_probe_primitives.py:66 f3", "rows",
     dict(S=8192, I=8192)),
    ("#8", "scripts/exp_probe_primitives.py:96 f4", "rows",
     dict(G=64, S=512, I=512)),
    ("#9 (512, 128)", "scripts/exp_probe2.py:75, :87", "rows",
     dict(S=512, I=512)),
    ("#9 (4096, 128)", "scripts/exp_probe2.py:112", "rows",
     dict(S=4096, I=4096)),
)


def gather_cases(torch, dev, seed=17):
    """K5, its plain version and one library call at the shapes of each
    TPU gather kernel it ports (GATHER_ROWS), with the bytes each needs:
    yields (name, source, mode, shape, k5, plain, library, bytes)."""
    from umgap_tpu_torch.ops import gather

    rng = np.random.default_rng(seed)
    for name, source, mode, p in GATHER_ROWS:
        G, S, W = p.get("G", 1), p["S"], 128
        if mode == "take":
            tab = torch.from_numpy(rng.integers(0, 100, size=S).astype(
                np.int32)).to(dev)
            idx = torch.from_numpy(rng.integers(0, S, size=p["I"]).astype(
                np.int32)).to(dev)
            idx64 = idx.to(torch.int64)

            def k5(tab=tab, idx=idx):
                return gather.take(tab, idx)

            def plain(tab=tab, idx=idx):
                return gather.take_plain(tab, idx)

            def library(tab=tab, idx64=idx64):
                return torch.take(tab, idx64)
            nbytes = tile_read(torch, (1, S, 1), [idx.view(1, -1, 1)]) * 4 \
                + p["I"] * 8
        elif mode == "rows":
            I = p["I"]
            tab = torch.from_numpy(rng.integers(0, 2 ** 31 - 1,
                                                size=(G, S, W)).astype(
                np.int32)).to(dev)
            hi = S * 128 if p.get("shift") else S
            if p.get("bcast"):
                stored = torch.from_numpy(rng.integers(
                    0, hi, size=(G, I, 1)).astype(np.int32)).to(dev)
                idx = stored.expand(G, I, W)
            else:
                stored = idx = torch.from_numpy(rng.integers(
                    0, hi, size=(G, I, W)).astype(np.int32)).to(dev)
            if p.get("shift"):
                stored = idx = idx >> 7
            idx64 = stored.to(torch.int64).expand(G, I, W)

            def k5(tab=tab, idx=idx):
                return gather.lane_gather(tab, idx)

            def plain(tab=tab, idx=idx):
                return gather.lane_gather_plain(tab, idx)

            def library(tab=tab, idx64=idx64):
                return torch.gather(tab, 1, idx64)
            nbytes = (tile_read(torch, (G, S, W), [idx]) * 4
                      + stored.numel() * 4 + G * I * W * 4)
        else:  # repeat: acc += take_along_axis(x, idx); idx = (idx+1) % n
            axis, rep = p["axis"], p["repeat"]
            n = S if axis == 0 else W
            tab = torch.from_numpy(rng.integers(0, 1 << 30, size=(S, W)).astype(
                np.int32)).to(dev)
            idx = torch.from_numpy(rng.integers(0, n, size=(S, W)).astype(
                np.int32)).to(dev)

            def loop(fn, tab=tab, idx=idx, axis=axis, rep=rep, n=n):
                acc = torch.zeros_like(tab)
                for _ in range(rep):
                    acc = acc + fn(tab, idx, axis - 2)
                    idx = (idx + 1) % n
                return acc

            def k5(loop=loop):
                return loop(gather.lane_gather)

            def plain(loop=loop):
                return loop(gather.lane_gather_plain)

            def library(loop=loop):
                return loop(lambda t, i, ax: torch.gather(t, ax, i.long()))
            steps = [(idx + k) % n for k in range(rep)]
            nbytes = (tile_read(torch, (1, S, W), [x[None] for x in steps],
                                axis - 2) * 4 + 2 * S * W * 4)
        yield name, source, mode, p, k5, plain, library, nbytes


def host_us(torch, fn, reps=200):
    """Host time per call of ``fn``: ``reps`` calls with no
    synchronisation, on the host clock (what a call costs the Python
    thread that issues it), after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


# Whole (S, 128) int32 tiles of 8-96 KB for the staging sweep
SWEEP_ROWS = (16, 32, 64, 96, 128, 192)
SWEEP_GROUPS = 1024


def phase_gather(torch, world):
    """K5 at the shapes of each TPU gather kernel it ports, held exactly
    to its plain version and timed beside one torch.gather call (the
    library yardstick; the port never calls it on the card) and its bytes
    bound: the tile elements this run's indices pick, the indices as
    stored and the output, once each. Then the host time a call costs,
    for K5 and the library call; and the staging sweep: rows mode on
    1,024 whole (S, 128) tiles of 8-96 KB, staged and direct."""
    from umgap_tpu_torch.ops import gather

    dev = world["dev"]
    t_phase = time.perf_counter()
    rows = {}
    for name, source, mode, p, k5, plain, library, nbytes in gather_cases(
            torch, dev):
        err = compare(torch, f"K5 {name}", k5(), plain())
        b, by = bound(nbytes, 0)
        rows[name] = dict(
            source=source, mode=mode, shape=p, max_abs_err=err,
            ms=cuda_ms(torch, k5, reps=50),
            plain_ms=cuda_ms(torch, plain, reps=50),
            library_ms=cuda_ms(torch, library, reps=50),
            device_ms=device_ms(torch, k5),
            library_device_ms=device_ms(torch, library),
            host_us=host_us(torch, k5), library_host_us=host_us(torch, library),
            bound_ms=b, bound_by=by)
        r = rows[name]
        log(f"K5 {name} ({source}): equal; {r['ms']:.4f} ms "
            f"(device {fmt_ms(r['device_ms'])}, host {r['host_us']:.1f} us), "
            f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
            f"(device {fmt_ms(r['library_device_ms'])}, host "
            f"{r['library_host_us']:.1f} us), bound {b:.5f} ({by})")

    # where a small call's host time goes, at Pallas #4's shape
    from umgap_tpu_torch import kernels

    rng = np.random.default_rng(23)
    tab = torch.from_numpy(rng.integers(0, 1 << 30, size=(8192, 128)).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, 8192, size=(32, 128)).astype(
        np.int32)).to(dev)
    idx64 = idx.long()
    out = idx.new_empty(idx.shape)
    args = (-2, tab.data_ptr(), 1, 8192, 128, 0, 128, 1, idx.data_ptr(), 32,
            128, 0, 128, 1, out.data_ptr(), gather.STAGE_BYTES,
            kernels.stream_of(tab))
    host = dict(
        wrapper_us=host_us(torch, lambda: gather.lane_gather(tab, idx)),
        launch_us=host_us(torch, lambda: kernels.K5.launch(*args)),
        empty_us=host_us(torch, lambda: idx.new_empty(idx.shape)),
        library_us=host_us(torch, lambda: torch.gather(tab, 0, idx64)))
    host["checks_us"] = (host["wrapper_us"] - host["launch_us"]
                         - host["empty_us"])
    log("K5 host time per call at #4's shape: " + ", ".join(
        f"{k} {v:.1f}" for k, v in host.items()))

    G, W = SWEEP_GROUPS, 128
    sweep = {}
    for S in SWEEP_ROWS:
        tab = torch.from_numpy(rng.integers(0, 1 << 30, size=(G, S, W)).astype(
            np.int32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, S, size=(G, S, W)).astype(
            np.int32)).to(dev)
        want = gather.lane_gather_plain(tab, idx)
        row = {"tile_kb": S * W * 4 / 1024}
        for pname, limit in (("staged", 1 << 20), ("direct", 0)):
            def run(limit=limit):
                return gather.lane_gather_staging(tab, idx, -2, limit)
            compare(torch, f"K5 sweep S={S} {pname}", run(), want)
            row[pname + "_ms"] = cuda_ms(torch, run)
            row[pname + "_device_ms"] = device_ms(torch, run)
        b, _by = bound(G * S * W * 12, 0)
        row["bound_ms"] = b
        sweep[S] = row
        log(f"K5 staging sweep, {G} tiles of ({S}, {W}) = "
            f"{row['tile_kb']:.0f} KB: staged {fmt_ms(row['staged_device_ms'])}"
            f" ms, direct {fmt_ms(row['direct_device_ms'])} ms of device time "
            f"(bound {b:.4f})")
        del tab, idx, want
    RESULT["phases"]["gather"] = dict(rows=rows, staging_sweep=sweep,
                                      host_breakdown=host,
                                      stage_bytes=gather.STAGE_BYTES,
                                      seconds=time.perf_counter() - t_phase)


def _table_keys(T, tab):
    """(packed keys stored in the rows, their values) of a host table."""
    rem = tab.rem
    occ = np.nonzero(rem != -1)[0]
    tag = rem[occ].astype(np.uint32)
    dist = (tag >> np.uint32(30)).astype(np.int64)
    r = tag & np.uint32((1 << 30) - 1)
    nb_bits, nb = tab.nb_bits, tab.n_buckets
    home = ((occ // tab.bucket) - dist) % nb
    mlo = (home.astype(np.uint32)
           | ((r & np.uint32((1 << (25 - nb_bits)) - 1))
              << np.uint32(nb_bits))) & T.MASK25
    mhi = (r >> np.uint32(25 - nb_bits)) & T.MASK20
    # invert the Feistel rounds of mix_key
    lo = mlo ^ (T._mx(mhi + T._C3) & T.MASK25)
    hi = mhi ^ (T._mx(lo + T._C2) & T.MASK20)
    lo = lo ^ (T._mx(hi + T._C1) & T.MASK25)
    return T.kmers.join_packed(hi.astype(np.int32), lo.astype(np.int32)), \
        tab.values[occ]


def _stash_table(T, keys, vals):
    """A tight single-round bucket8s table, so hundreds of keys land in
    the stash."""
    for cap in (8 << 15, 8 << 16):
        try:
            return T.KmerTable.build(keys, vals, 9, capacity=cap, bucket=8,
                                     max_probe_limit=0, stash_cap=4096)
        except RuntimeError:
            continue
    raise SystemExit("FAIL: could not build the stash test table")


def _probes1_table(T, keys, vals):
    """A two-round (max_probes == 1) bucket-8 table, placed round by
    round at load ~0.57."""
    hi, lo = T.kmers.split_packed(keys)
    mhi, mlo = T.mix_key(hi, lo)
    cap = 8 << 15
    nb_bits = int(np.log2(cap // 8))
    b0 = (mlo & np.uint32((1 << nb_bits) - 1)).astype(np.int64)
    rem = ((mlo >> np.uint32(nb_bits))
           | (mhi << np.uint32(25 - nb_bits))).astype(np.int32)
    (ra, va), mp, left = T._insert_bucketized(
        b0, [rem, np.asarray(vals, np.int32)], cap, tag_distance=True,
        bucket=8, max_round=1)
    require(mp == 1 and len(left) <= 4096,
            f"probes-1 table: max_probes {mp}, leftover {len(left)}")
    return T.KmerTable(ra, va, mp, len(keys),
                       {"k": 9, "nb_bits": nb_bits, "bucket": 8},
                       stash_hi=hi[left], stash_lo=lo[left],
                       stash_val=np.asarray(vals, np.int32)[left])


# ---------------------------------------------------------------------- #
# Phase 3: the main path, all four presets
# ---------------------------------------------------------------------- #

TRYPTIC_KERNELS = {"reads_to_peptides", "probe_peptide"}
NINEMER_KERNELS = {"reads_to_kmers", "probe_kmer", "seedextend_mask"}
# K3's and K4's row kernels: launched only by rows past the staged tile
# (96 windows) and the warp path (1,024 hits), i.e. reads from 312 bp
# (the ladder sample's wider rungs, the 12,000 bp path); K3's staged tile
# and K4's warp path, the main path's, launch only on narrower rows
ROW_KERNELS = {"seedextend_rows", "dedup_rows"}
NARROW_ROW_KERNELS = {"seedextend_mask", "dedup_counts"}


# K3's scored entries: launched only by a ranked configuration (phase
# scored), in place of the hits entries
SCORED_ENTRY = {"seedextend_mask": "seedextend_scored",
                "seedextend_rows": "seedextend_rows_scored"}
SCORED_KERNELS = set(SCORED_ENTRY.values())


def _scored_entries(names, config):
    if config.ranked and not is_tryptic(config):
        return {SCORED_ENTRY.get(n, n) for n in names}
    return names


def long_path_kernels(config):
    """``path_kernels`` of a configuration whose rows are all past K3's
    staged tile and K4's warp path: the row kernels in their place."""
    return _scored_entries(path_kernels(config._replace(ranked=False))
                           - NARROW_ROW_KERNELS | ROW_KERNELS, config)


def is_tryptic(config) -> bool:
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    return config.name in TRYPTIC_PRESETS


# the tail after K4 on the Euler/RMQ aggregators (rmq/lca*, rmq/hybrid):
# K9, the aggregate and its snap in one launch; K6 on the others
RMQ_TAIL_KERNELS = {"rmq_aggregate"}
# K1's protein entry: launched only on the FGSpp path (phase fgspp)
PROTEIN_KERNELS = {"proteins_to_kmers"}


def path_kernels(config):
    """Names of the kernels a configuration's path launches at 100-160
    bp: K1-K3 on the 9-mer path (K3's scored entry with ``ranked``), K7
    and K8 on the tryptic one, K3's and K4's row kernels and K1's protein
    entry on none (ROW_KERNELS, PROTEIN_KERNELS), K4 with the lower bound on
    all; K6 (which reads the taxonomy rows itself and snaps) for the
    tree aggregators and rmq/mrtl, K9 (which walks or closes the hits
    and snaps) for rmq/lca* and rmq/hybrid; no path launches K5 (its
    row gather and ancestry epilogue serve hit_geometry, its take the
    plain versions)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg import device as devagg

    names = {k.name for k in kernels.KERNELS} - {"lane_gather",
                                                 "lane_gather_ancestry"}
    names -= ROW_KERNELS | PROTEIN_KERNELS | SCORED_KERNELS
    names -= NINEMER_KERNELS if is_tryptic(config) else TRYPTIC_KERNELS
    if (config.method, config.strategy) in devagg.GEOMETRY_AGGREGATIONS:
        names -= RMQ_TAIL_KERNELS
    else:
        names.discard("tree_aggregate")
    return _scored_entries(names, config)


def batch_launches(torch, world, an):
    """Launch counts of one 16,384-pair batch step of an Analyser."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.ops import encoding

    dev, L = world["dev"], world["L"]
    b = torch.from_numpy(encoding.pack_dna4(world["reads"][:BATCH])).to(dev)
    lens = torch.full((BATCH, 2), L, dtype=torch.int32, device=dev)
    kernels.reset_launches()
    an.step(b, lens, L)
    torch.cuda.synchronize()
    return kernels.launch_counts()


def batch_cuda_launches(torch, world, an, tries=3, inputs=None):
    """Every CUDA kernel one 16,384-pair batch step of an Analyser runs
    (or one step on ``inputs``, the step's (batch, lengths, width)
    arguments on the card), PyTorch's own included, by this code on any
    tree: the profiler over
    one step (its inputs already on the card), recorded after a warm-up
    window with host time around it as ``_profile_window`` does, taken
    again (up to ``tries`` windows) until the card's kernel events
    number the host's launch calls. Returns {"kernels": n (device-side
    kernel events), "launch_calls": n (host-side cudaLaunchKernel
    calls), "copies": n (memcpy and memset), "by_name": {kernel:
    count}, "windows": windows taken}."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from umgap_tpu_torch.ops import encoding

    dev, L = world["dev"], world["L"]
    if inputs is None:
        inputs = (torch.from_numpy(encoding.pack_dna4(
            world["reads"][:BATCH])).to(dev),
            torch.full((BATCH, 2), L, dtype=torch.int32, device=dev), L)

    def step():
        an.step(*inputs)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)

    step()
    for k in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            step()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            step()
            prof.step()
        by_name, copies, calls = {}, 0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.key.startswith(("Memcpy", "Memset")):
                    copies += e.count
                elif not e.key.startswith("ProfilerStep"):
                    by_name[e.key] = e.count
            elif e.key == "cudaLaunchKernel":
                calls += e.count
        out = dict(kernels=sum(by_name.values()), launch_calls=calls,
                   copies=copies, by_name=by_name, windows=k)
        if out["kernels"] == calls:
            break
    return out


def _analyser(world, config, dtable=None, batch_size=BATCH, read_length=None,
              plain=False, euler=None):
    """An ``Analyser`` (a ``TrypticAnalyser`` for the tryptic presets,
    over the tryptic index) over the world's device state; ``plain`` runs
    every stage's plain version on the card (the reference the kernel
    path is held to), in the fast and in the wide program alike."""
    from umgap_tpu_torch.pipeline.runner import Analyser
    from umgap_tpu_torch.pipeline.tryptic import TrypticAnalyser

    base = TrypticAnalyser if is_tryptic(config) else Analyser
    if dtable is None:
        dtable = world["pdtable" if is_tryptic(config) else "dtable"]

    class PlainAnalyser(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.step.plain = True

        def _wide(self):
            step = super()._wide()
            step.plain = True
            return step

    cls = PlainAnalyser if plain else base
    return cls(None, None, config, batch_size=batch_size,
               read_length=read_length or world["L"], ends=2,
               dtax=world["dtax"], dtable=dtable, device=world["dev"],
               euler=euler)


def _run_analyser(an, world):
    reads = world["reads"]
    P, L = world["P"], world["L"]
    lens = np.full((P, 2), L, dtype=np.int32)
    headers = [f"r{i}" for i in range(P)]
    out = np.array([t for _h, t in an.analyse_arrays(headers, reads, lens)],
                   dtype=np.int64)
    return out


def _stream_rate(an, world, min_s=STEADY_S):
    """End-to-end pairs/s at steady state: the workload fed again and
    again into one stream (depth-2 dispatch never drains between
    passes) until ``min_s`` seconds have gone, then drained; total pairs
    over total time, every taxon brought back to the host."""
    reads = world["reads"]
    P, L = world["P"], world["L"]
    lens = np.full((P, 2), L, dtype=np.int32)
    headers = [f"r{i}" for i in range(P)]
    an.reset()
    got = passes = 0
    t0 = time.perf_counter()
    while passes == 0 or time.perf_counter() - t0 < min_s:
        for _ in an.feed(headers, reads, lens):
            got += 1
        passes += 1
    for _ in an.finish():
        got += 1
    wall = time.perf_counter() - t0
    require(got == passes * P, f"stream returned {got} of {passes * P}")
    return dict(pairs_per_s=got / wall, pairs=got, seconds=wall,
                batches=got // BATCH)


def phase_main(torch, world):
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    P = world["P"]
    analysers = {name: _analyser(world, cfg)
                 for name, cfg in PRESETS.items()}
    # warm the allocator and every program shape once, outside the count
    for an in analysers.values():
        _run_analyser(an, world)
    kernels.reset_launches()
    results = {}
    for name, an in analysers.items():
        an.overflow_reads = 0
        results[name] = _run_analyser(an, world)
    launches = kernels.launch_counts()
    RESULT["main_launches"] = launches
    log(f"main path launches: {launches}")
    for n in set().union(*(path_kernels(c) for c in PRESETS.values())):
        require(launches[n] > 0,
                f"kernel {n} was not launched on the main path")
    # one batch of each tree aggregator: after K3 one K4 launch (with the
    # lower bound) and one K6 launch (with snap): no K5 (no snap take, no
    # row gather, no ancestry epilogue) and no K9
    from umgap_tpu_torch.agg import device as devagg

    per_batch, cuda_batch = {}, {}
    for name, cfg in PRESETS.items():
        per_batch[name] = c = batch_launches(torch, world, analysers[name])
        if (cfg.method, cfg.strategy) in devagg.GEOMETRY_AGGREGATIONS:
            require(c["tree_aggregate"] == 1 and c["dedup_counts"] == 1
                    and c["lane_gather"] == 0 and c["rmq_aggregate"] == 0
                    and c["lane_gather_ancestry"] == 0,
                    f"{name}: one batch launched {c}")
        cuda_batch[name] = batch_cuda_launches(torch, world, analysers[name])
    RESULT["batch_launches"] = per_batch
    RESULT["batch_cuda_launches"] = cuda_batch
    log("CUDA kernels in one batch step (profiler): " + ", ".join(
        f"{n} {c['kernels']} ({c['launch_calls']} launch calls)"
        for n, c in cuda_batch.items()))

    phase = {"presets": {}}
    for name, cfg in PRESETS.items():
        plain = _run_analyser(_analyser(world, cfg, plain=True), world)
        require(np.array_equal(results[name], plain),
                f"main path {name}: kernel taxa differ from plain taxa in "
                f"{int((results[name] != plain).sum())} of {P} groups")
        require(results[name].shape == (P,) and (results[name] >= 1).all(),
                f"main path {name}: bad output")
        require(taxa_digest(results[name][:REFERENCE_PAIRS])
                == REFERENCE_DIGESTS[name],
                f"main path {name}: the first {REFERENCE_PAIRS} groups "
                "differ from the JAX package's reference taxa")
        overflow = analysers[name].overflow_reads
        e2e = _stream_rate(analysers[name], world)
        phase["presets"][name] = dict(
            e2e=e2e, overflow_reads=overflow,
            checksum=int(results[name].sum()),
            distinct_taxa=int(len(np.unique(results[name]))),
            unassigned=int((results[name] == 1).sum()))
        log(f"main {name}: kernel == plain on {P} groups, == reference on "
            f"{REFERENCE_PAIRS}; e2e {e2e['pairs_per_s']:.0f} pairs/s "
            f"({e2e['batches']} batches in {e2e['seconds']:.2f} s), "
            f"overflow {overflow}")

    # device-resident rate, per-stage times and peak card memory of one
    # tree/hybrid, one tree/lca* and the rmq/mrtl preset
    for name in STAGE_PRESETS:
        phase[name.replace("-", "_")] = stage_table(torch, world,
                                                    analysers[name])
    an = analysers["high-sensitivity"]
    # device busy share of a steady end-to-end stream, from the
    # profiler's kernel and copy times (the profiler's own overhead
    # inflates the wall time, so idle is an upper bound)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = _stream_rate(an, world, min_s=1.0)
    wall = profiled["seconds"]
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
    phase["high_sensitivity"].update(
        e2e_pairs_per_s=phase["presets"]["high-sensitivity"]["e2e"][
            "pairs_per_s"],
        profiled_pairs=profiled["pairs"], profiled_wall_s=wall,
        profiled_device_s=dev_us / 1e6,
        profiled_busy_share=(dev_us / 1e6) / wall if dev_us else None,
        profile_top=[(e.key, e.self_device_time_total / 1e3, e.count)
                     for e in top])
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["main"] = phase
    log(f"high-sensitivity: profiled busy {dev_us / 1e6:.3f} s of "
        f"{wall:.3f} s")
    return launches, results


STAGE_PRESETS = ("high-sensitivity", "high-precision", "max-sensitivity")


def stage_table(torch, world, an, inputs=None):
    """One preset's Analyser on the workload's batches already on the
    card (or on ``inputs``, a list of the step's (batch, lengths, width)
    arguments on the card): device-resident pairs/s (read groups a
    second), the per-stage CUDA-event times (median of 5 x the batches;
    each stage ends in a host sync) and the peak card memory of one batch
    step above what was allocated before it."""
    import contextlib

    from umgap_tpu_torch.ops import encoding

    dev, L = world["dev"], world["L"]
    if inputs is None:
        lens = torch.full((BATCH, 2), L, dtype=torch.int32, device=dev)
        inputs = [(torch.from_numpy(encoding.pack_dna4(
            world["reads"][i * BATCH:(i + 1) * BATCH])).to(dev), lens, L)
            for i in range(world["P"] // BATCH)]
    P = sum(x[1].shape[0] for x in inputs)

    def resident():
        for args in inputs:
            an.step(*args)

    ms = cuda_ms(torch, resident, reps=5)
    stage_ms = {}

    def timer(name):
        @contextlib.contextmanager
        def cm():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            b.synchronize()
            stage_ms.setdefault(name, []).append(a.elapsed_time(b))
        return cm()

    for _ in range(5):
        for args in inputs:
            an.step(*args, timer=timer)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    an.step(*inputs[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out = dict(device_resident_pairs_per_s=P / (ms / 1e3),
               batch_ms=ms / len(inputs),
               stage_ms={k: float(np.median(v)) for k, v in stage_ms.items()},
               step_peak_gb=peak / 1e9, step_above_base_gb=(peak - base) / 1e9)
    log(f"{an.config.name}: device-resident {out['device_resident_pairs_per_s']:.0f}"
        f" pairs/s ({out['batch_ms']:.3f} ms per {inputs[0][1].shape[0]}-"
        "group batch); stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in out["stage_ms"].items())
        + f"; step peak {peak / 1e9:.3f} GB, {(peak - base) / 1e9:.3f} GB "
        "above its inputs")
    return out


# ---------------------------------------------------------------------- #
# Phase 3b: the wide re-route program on one batch
# ---------------------------------------------------------------------- #

def phase_wide(torch, world, results):
    """The bench workload re-routes no group, so the wide program (k_max
    = every window slot, 300 at 100 bp) is driven directly on the first
    256 pairs per preset: its own launch counts, kernel taxa equal to
    the plain path's and to the main path's on the same pairs."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    n, L = 256, world["L"]
    dna = world["reads"][:n]
    lens = np.full((n, 2), L, dtype=np.int32)
    phase = {}
    for name, cfg in PRESETS.items():
        an = _analyser(world, cfg)
        kernels.reset_launches()
        got = an.run_wide(dna, lens)
        launches = kernels.launch_counts()
        for k in path_kernels(cfg):
            require(launches[k] > 0, f"wide {name}: kernel {k} was not "
                    "launched")
        want = _analyser(world, cfg, plain=True).run_wide(dna, lens)
        require(np.array_equal(got, want),
                f"wide {name}: kernel taxa differ from plain taxa")
        require(np.array_equal(got, results[name][:n]),
                f"wide {name}: taxa differ from the main program's")
        phase[name] = dict(k_max=an._exact_kmax(), batch=an._wide_batch,
                           launches=launches)
        log(f"wide {name}: k_max {an._exact_kmax()}, {n} pairs in batches "
            f"of {an._wide_batch}, kernel == plain == main; launches "
            f"{launches}")
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["wide"] = phase


# ---------------------------------------------------------------------- #
# Phase 3b': scored seed-extend (PipelineConfig.ranked)
# ---------------------------------------------------------------------- #

# the two ranked configurations phase scored runs, by their digest names
SCORED_CONFIGS = {
    "scored/max-sensitivity": ("max-sensitivity", dict(ranked=True,
                                                       penalty=5)),
    "scored/high-sensitivity": ("high-sensitivity", dict(ranked=True)),
}
# reads past 312 bp: 132 windows a frame, K3's scored row kernel (and
# K4's row kernel: 1,584 hits a row)
SCORED_WIDTH = 420


def scored_configs():
    from umgap_tpu_torch.pipeline.fused import PRESETS

    return {name: PRESETS[p]._replace(**kw)
            for name, (p, kw) in SCORED_CONFIGS.items()}


def k3s_cell(torch, world, taxa, nk, what):
    """K3's scored entry alone on the lanes a batch gives it (max-
    sensitivity's seeds, s = 2, g = 1, penalty 5; the bench taxonomy's
    seed scores): held to the plain version (and to the row formulation
    past the staged tile), event and device ms, the bound (each window's
    taxon read and its hit written once, each lane's length and the
    score table read once: bytes) and the plain ms. Returns (stats,
    err)."""
    from umgap_tpu_torch.ops import seedextend

    sc = world["dtax"].seed_scores
    NW, nl = taxa.shape[-1], nk.numel()

    def k3s():
        return seedextend.seedextend_hits(taxa, nk, 2, 1, seed_scores=sc,
                                          penalty=5)

    def plain():
        return seedextend.seedextend_scored_hits_plain(taxa, nk, sc, 5, 2, 1)

    got = k3s()
    err = compare(torch, f"K3 scored {what}", got, plain())
    if seedextend.seedextend_path(NW) == "rows":
        err = max(err, compare(
            torch, f"K3 scored {what} (runs plain)", got,
            seedextend.seedextend_scored_runs_plain(taxa, nk, sc, 5, 2, 1)))
    ms, by = device_ms(torch, k3s, by=True)
    b, bb = bound(nl * (NW * 8 + 4) + sc.numel() * 4, nl * NW * 24)
    return dict(path=seedextend.seedextend_path(NW), shape=[nl, NW],
                ms=cuda_ms(torch, k3s), device_ms=ms, device_ms_by=by,
                plain_ms=cuda_ms(torch, plain, reps=2), bound_ms=b,
                bound_by=bb, bound_share=b / ms, library_ms=None,
                kept=int((got != 0).sum()), max_abs_err=err,
                equal=err == 0.0), err


def phase_scored(torch, world, results):
    """Scored seed-extend (``PipelineConfig.ranked``; the reference's
    ``seedextend -r``): max-sensitivity with ranked=True, penalty=5 and
    high-sensitivity with ranked=True through ``Analyser`` over all
    32,768 bench pairs (K3's scored staged tile) and over one batch of
    the CLI's size at SCORED_WIDTH (4,096 pairs of 420 bp ends of
    consecutive bench reads: its scored row kernel), launches counted
    over both; kernel taxa equal to the plain path's
    (``run_stages(..., plain=True)``) on both, the first 1,024 bench
    pairs equal to umgap_tpu's digests; the wide program under ranked on
    256 pairs (kernel = plain = the main program's taxa); and K3's two
    scored entries alone on the lanes K1 -> K2 give them at L = 100 and
    at 420 bp (``k3s_cell``: the kernels line's entries). Returns
    (launches of the scored runs, {entry: stats})."""
    from umgap_tpu_torch import kernels

    t_phase = time.perf_counter()
    P, L = world["P"], world["L"]
    cfgs = scored_configs()
    wcodes = np.ascontiguousarray(_rung_codes(world, SCORED_WIDTH))
    nw = len(wcodes)
    wlens = np.full((nw, 2), SCORED_WIDTH, np.int32)
    wheaders = [f"w{i}" for i in range(nw)]

    def run_wide_batch(an):
        return np.array([t for _h, t in an.analyse_arrays(
            wheaders, wcodes, wlens)], dtype=np.int64)

    ans = {n: (_analyser(world, c), _analyser(
        world, c, batch_size=nw, read_length=SCORED_WIDTH))
        for n, c in cfgs.items()}
    for an, wan in ans.values():  # every program shape once, uncounted
        _run_analyser(an, world)
        run_wide_batch(wan)
    kernels.reset_launches()
    got, wgot = {}, {}
    for n, (an, wan) in ans.items():
        got[n] = _run_analyser(an, world)
        wgot[n] = run_wide_batch(wan)
    launches = kernels.launch_counts()
    RESULT["scored_launches"] = launches
    need = set().union(*(path_kernels(c) | long_path_kernels(c)
                         for c in cfgs.values()))
    for k in need:
        require(launches[k] > 0, f"scored: kernel {k} was not launched")
    require(launches["seedextend_mask"] == launches["seedextend_rows"] == 0,
            f"scored: K3's unscored entries launched: {launches}")
    phase = {"width": SCORED_WIDTH, "wide_pairs": nw, "launches": launches}
    for n, cfg in cfgs.items():
        plain = _run_analyser(_analyser(world, cfg, plain=True), world)
        require(np.array_equal(got[n], plain), f"{n}: kernel taxa differ "
                f"from plain taxa in {int((got[n] != plain).sum())} of {P}")
        wplain = run_wide_batch(_analyser(
            world, cfg, batch_size=nw, read_length=SCORED_WIDTH, plain=True))
        require(np.array_equal(wgot[n], wplain), f"{n} at {SCORED_WIDTH} "
                f"bp: kernel taxa differ from plain taxa in "
                f"{int((wgot[n] != wplain).sum())} of {nw}")
        require(taxa_digest(got[n][:REFERENCE_PAIRS])
                == REFERENCE_DIGESTS[n], f"{n}: the first {REFERENCE_PAIRS} "
                "groups differ from the JAX package's reference taxa")
        base = cfg.name
        phase[n] = dict(
            differ_from_unscored=int((got[n] != results[base]).sum()),
            unassigned=int((got[n] == 1).sum()),
            wide_unassigned=int((wgot[n] == 1).sum()),
            overflow_reads=ans[n][0].overflow_reads)
        # the wide program under ranked (k_max = every window slot)
        dna, lens = world["reads"][:256], np.full((256, 2), L, np.int32)
        an = _analyser(world, cfg)
        before = kernels.K3S.launches
        wide = an.run_wide(dna, lens)
        require(kernels.K3S.launches > before,
                f"{n}: the wide program launched no scored K3")
        require(np.array_equal(wide, _analyser(world, cfg, plain=True)
                               .run_wide(dna, lens)),
                f"{n}: the wide program's kernel taxa differ from plain")
        require(np.array_equal(wide, got[n][:256]),
                f"{n}: the wide program's taxa differ from the main's")
        log(f"{n}: kernel == plain on {P} pairs and {nw} pairs of "
            f"{SCORED_WIDTH} bp, == reference on {REFERENCE_PAIRS}; "
            f"{phase[n]['differ_from_unscored']} groups differ from the "
            f"unscored preset's; the wide program == plain == main")
    log(f"scored launches: {launches}")

    # the scored entries alone on a batch's lanes
    stats, errs = {}, {}
    for name, codes, width in (
            ("seedextend_scored", world["reads"][:BATCH], L),
            ("seedextend_rows_scored", wcodes, SCORED_WIDTH)):
        taxa, nk, _hits = _row_inputs(torch, world, codes, width)
        stats[name], errs[name] = k3s_cell(torch, world, taxa, nk,
                                           f"{width} bp")
        st = stats[name]
        log(f"{name} at {width} bp ({st['path']}, {st['shape']}): "
            f"{st['ms']:.4f} ms event, {st['device_ms']:.4f} device, bound "
            f"{st['bound_ms']:.4f} ({st['bound_share']:.0%}), plain "
            f"{st['plain_ms']:.3f}")
        del taxa, nk, _hits
    phase["kernels"] = stats
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["scored"] = phase
    return launches, stats


# ---------------------------------------------------------------------- #
# Phase 3c: the tryptic presets
# ---------------------------------------------------------------------- #

def phase_tryptic(torch, world):
    """Both tryptic presets through ``TrypticAnalyser`` over all 32,768
    pairs and the bench tryptic index: the path's launch counts (K7, K8,
    K4, K6, K5 above 0, no 9-mer kernel), kernel taxa equal to plain
    taxa, the first 1,024 equal to umgap_tpu's digests, a steady
    end-to-end rate, a stage table with device-resident pairs/s, and the
    wide program (k_max = E x 6 x F) on the first 256 pairs against the
    plain wide program and the fast program's taxa. Returns (launches,
    taxa by preset)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    t_phase = time.perf_counter()
    P, L = world["P"], world["L"]
    analysers = {name: _analyser(world, cfg)
                 for name, cfg in TRYPTIC_PRESETS.items()}
    for an in analysers.values():
        _run_analyser(an, world)
    kernels.reset_launches()
    results = {}
    for name, an in analysers.items():
        an.overflow_reads = 0
        results[name] = _run_analyser(an, world)
    launches = kernels.launch_counts()
    log(f"tryptic path launches: {launches}")
    for n in set().union(*(path_kernels(c)
                           for c in TRYPTIC_PRESETS.values())):
        require(launches[n] > 0,
                f"kernel {n} was not launched on the tryptic path")
    for n in NINEMER_KERNELS:
        require(launches[n] == 0, f"the tryptic path launched {n}")
    phase = {"launches": launches, "presets": {}}
    n, dna = 256, world["reads"][:256]
    lens = np.full((n, 2), L, dtype=np.int32)
    for name, cfg in TRYPTIC_PRESETS.items():
        an = analysers[name]
        taxa = results[name]
        plain = _run_analyser(_analyser(world, cfg, plain=True), world)
        require(np.array_equal(taxa, plain),
                f"tryptic {name}: kernel taxa differ from plain taxa in "
                f"{int((taxa != plain).sum())} of {P} groups")
        require(taxa.shape == (P,) and (taxa >= 1).all(),
                f"tryptic {name}: bad output")
        require(taxa_digest(taxa[:REFERENCE_PAIRS])
                == REFERENCE_DIGESTS[name],
                f"tryptic {name}: the first {REFERENCE_PAIRS} groups differ "
                "from the JAX package's reference taxa")
        overflow = an.overflow_reads
        e2e = _stream_rate(an, world)
        stages = stage_table(torch, world, an)
        cuda_batch = batch_cuda_launches(torch, world, an)
        c = batch_launches(torch, world, an)
        require(c["tree_aggregate"] == 1 and c["dedup_counts"] == 1
                and c["lane_gather"] == 0 and c["rmq_aggregate"] == 0,
                f"tryptic {name}: one batch launched {c}")
        kernels.reset_launches()
        wide = an.run_wide(dna, lens)
        wl = kernels.launch_counts()
        for k in path_kernels(cfg):
            require(wl[k] > 0, f"tryptic wide {name}: kernel {k} was not "
                    "launched")
        want = _analyser(world, cfg, plain=True).run_wide(dna, lens)
        require(np.array_equal(wide, want),
                f"tryptic wide {name}: kernel taxa differ from plain taxa")
        require(np.array_equal(wide, taxa[:n]),
                f"tryptic wide {name}: taxa differ from the main program's")
        phase["presets"][name] = dict(
            e2e=e2e, overflow_reads=overflow, stages=stages,
            batch_cuda_launches=cuda_batch,
            checksum=int(taxa.sum()), distinct_taxa=int(len(np.unique(taxa))),
            unassigned=int((taxa == 1).sum()),
            wide=dict(k_max=an._exact_kmax(), batch=an._wide_batch,
                      launches=wl))
        log(f"tryptic {name}: kernel == plain on {P} groups, == reference "
            f"on {REFERENCE_PAIRS}; e2e {e2e['pairs_per_s']:.0f} pairs/s, "
            f"overflow {overflow}; wide (k_max {an._exact_kmax()}) on {n} "
            f"pairs == plain == main; {cuda_batch['kernels']} CUDA kernels "
            "a batch step")
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["tryptic"] = phase
    return launches, results


# ---------------------------------------------------------------------- #
# Phase 4b: a 0.8 GB card-resident peptide index
# ---------------------------------------------------------------------- #

# cut from 50 M keys in 2^27 slots (1.61 GB, a 40 s host build) to keep
# the script in its time
PEPTIDE_RESIDENT_KEYS = 25_000_000
PEPTIDE_RESIDENT_LOG2_SLOTS = 26  # 2^23 rows of 8 slots x 12 B = 0.81 GB


def _workload_fingerprints(torch, world):
    """Every valid fingerprint K7 makes of the workload's pairs, as
    uint64 keys (h1 << 32 | h2)."""
    from umgap_tpu_torch.ops import encoding
    from umgap_tpu_torch.pipeline import tryptic

    L, keys = world["L"], []
    for i in range(world["P"] // BATCH):
        reads = torch.from_numpy(encoding.pack_dna4(
            world["reads"][i * BATCH:(i + 1) * BATCH])).to(
                world["dev"]).reshape(2 * BATCH, -1).contiguous()
        lens = torch.full((2 * BATCH,), L, dtype=torch.int32,
                          device=world["dev"])
        h1, h2, v = tryptic.reads_to_peptides(reads, lens, L,
                                              encoding.get_table(1))
        keys.append(_u64(h1[v].cpu().numpy(), h2[v].cpu().numpy()))
    return np.unique(np.concatenate(keys))


def _u64(hi, lo):
    return ((hi.astype(np.uint32).astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint32).astype(np.uint64))


def resident_fingerprints(world, n_total, avoid, seed=13):
    """The bench tryptic index's (fingerprint, taxon) rows plus seeded
    filler up to ``n_total``: f(i) = i * C + D mod 2^64 (C odd) is a
    bijection, so the filler keys are distinct; those with an h1 of -1
    (EMPTY) or equal to a key in ``avoid`` (every fingerprint of the
    workload's queries) or in the bench index are skipped. Each filler
    key gets a seeded taxon."""
    t = world["ptable"]
    used = t.key_hi != -1
    bh, bl, bv = t.key_hi[used], t.key_lo[used], t.values[used]
    n_fill = n_total - len(bh)
    rng = np.random.default_rng(seed)
    c = int(rng.integers(1 << 62, 1 << 63)) | 1
    C, D = np.uint64(c), np.uint64(int(rng.integers(0, 1 << 63)))
    n_idx = n_fill + n_fill // 100
    keep = np.ones(n_idx, dtype=bool)
    with np.errstate(over="ignore"):
        # the indices whose image is a key to avoid: f^-1(k)
        taken = (np.concatenate([avoid, _u64(bh, bl)]) - D) * np.uint64(
            pow(c, -1, 1 << 64))
        keep[taken[taken < np.uint64(n_idx)].astype(np.int64)] = False
        cand = np.arange(n_idx, dtype=np.uint64) * C + D
    keep &= (cand >> np.uint64(32)) != np.uint64(0xFFFFFFFF)
    fill = cand[keep][:n_fill]
    require(len(fill) == n_fill, "resident peptide filler: too few keys")
    fh = (fill >> np.uint64(32)).astype(np.uint32).view(np.int32)
    fl = fill.astype(np.uint32).view(np.int32)
    fv = rng.integers(1, world["n_tax"] + 1, size=n_fill).astype(np.int32)
    return (np.concatenate([bh, fh]), np.concatenate([bl, fl]),
            np.concatenate([bv, fv]))


def resident_peptide_table(torch, world):
    """The 0.81 GB resident peptide index on the card: (DeviceTable,
    build record)."""
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.ops.lookup import DeviceTable

    t0 = time.perf_counter()
    avoid = _workload_fingerprints(torch, world)
    hi, lo, vals = resident_fingerprints(world, PEPTIDE_RESIDENT_KEYS, avoid)
    keys_s = time.perf_counter() - t0
    tab = PeptideTable._from_fingerprints(
        hi, lo, vals, capacity=1 << PEPTIDE_RESIDENT_LOG2_SLOTS)
    del hi, lo, vals
    build_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dt = DeviceTable.from_host(tab, world["dev"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rows_gb = dt.rows.numel() * 4 / 1e9
    log(f"resident peptide table: {tab.n} keys, {tab.n_buckets} rows, "
        f"max_probes {tab.max_probes}, {rows_gb:.2f} GB; host build "
        f"{build_s:.1f}s, to the card {load_s:.1f}s")
    return dt, dict(rows_gb=rows_gb, keys=PEPTIDE_RESIDENT_KEYS,
                    slots=1 << PEPTIDE_RESIDENT_LOG2_SLOTS,
                    host_build_s=build_s, host_keys_s=keys_s,
                    max_probes=dt.max_probes, host_to_device_s=load_s)


def resident_k8(torch, world, dt, sweep=True):
    """K8 on one batch's K7 output (L = 100) against the resident index:
    held to its plain version; event and device ms with and without the
    L2 flushed before each launch, the bound on this data; with
    ``sweep``, the flushed device ms at each of K8_SWEEP's queries per
    lane (each result equal to the default's). Returns (the kernels
    line's entry, the record, the batch's (reads, lens))."""
    from umgap_tpu_torch.ops import encoding, lookup
    from umgap_tpu_torch.pipeline import tryptic

    L = world["L"]
    reads, lens = _batch_reads(torch, world, L)
    h1, h2, pv = tryptic.reads_to_peptides(reads, lens, L,
                                           encoding.get_table(1))

    def k8(plain=False):
        fn = lookup.probe_plain if plain else lookup.probe
        return fn(dt, h1, h2, pv, 0)

    got = k8()
    err = compare(torch, "K8 resident", got, k8(True))
    probe_ms = cuda_ms(torch, k8)
    probe_dev = device_ms(torch, k8)
    # the same launch with the L2 flushed before it, as a new batch finds
    # a real index: its rows (and queries) are DRAM fetches, so the HBM
    # bound holds. K8's entry in the kernels line is this one.
    probe_cold = cold_ms(torch, k8)
    probe_cold_dev = cold_device_ms(torch, k8, "probe_peptide")
    plain_cold = cold_ms(torch, lambda: k8(True), reps=3)
    pb, pby, rows = k8_bound(torch, dt, h1, h2, pv)
    entry = dict(
        ms=probe_cold, device_ms=probe_cold_dev, plain_ms=plain_cold,
        bound_ms=pb, bound_by=pby, max_abs_err=err,
        share=pb / probe_cold_dev if probe_cold_dev else None)
    sweep_ms = {}
    if sweep:
        q0 = lookup.QUERIES_PER_LANE
        try:
            for Q in K8_SWEEP:
                lookup.QUERIES_PER_LANE = Q
                compare(torch, f"K8 resident Q={Q}", k8(), got)
                sweep_ms[Q] = cold_device_ms(torch, k8, "probe_peptide")
        finally:
            lookup.QUERIES_PER_LANE = q0
    record = dict(
        probe_ms=probe_ms, probe_device_ms=probe_dev,
        probe_cold_ms=probe_cold, probe_cold_device_ms=probe_cold_dev,
        probe_plain_cold_ms=plain_cold, probe_share=entry["share"],
        probe_bound_ms=pb, probe_bound_by=pby, probe_rows_read=rows,
        probe_queries=h1.numel(), probe_max_abs_err=err,
        probe_found=int(got[1].sum()),
        queries_per_lane_cold_device_ms=sweep_ms)
    log(f"resident peptide K8 equal to plain: {probe_ms:.4f} ms (device "
        f"{fmt_ms(probe_dev)}), L2 flushed {probe_cold:.4f} (device "
        f"{fmt_ms(probe_cold_dev)}, plain {plain_cold:.3f}), bound "
        f"{pb:.4f}; flushed device ms by queries per lane: " + ", ".join(
            f"{Q}: {fmt_ms(t)}" for Q, t in sweep_ms.items()))
    return entry, record, (reads, lens)


def phase_resident_peptide(torch, world, tryptic_results):
    """A peptide index of 25,000,000 fingerprints in 2^26 slots
    (8,388,608 rows of 96 B, 0.81 GB) on the card: the bench fragments
    with their taxa plus seeded filler. K8 held to its plain version on
    one batch's K7 output (and swept over its queries per lane with the
    L2 flushed); tryptic-sensitivity over the workload through it:
    launch counts, kernel taxa equal to the tryptic phase's (the filler
    matches no query), device-resident and end-to-end pairs/s, peak card
    memory."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.pipeline import tryptic

    t_phase = time.perf_counter()
    L = world["L"]
    dt, built = resident_peptide_table(torch, world)
    kernel_entry, k8_record, (reads, lens) = resident_k8(torch, world, dt)

    torch.cuda.reset_peak_memory_stats()
    cfg = tryptic.TRYPTIC_PRESETS["tryptic-sensitivity"]
    an = _analyser(world, cfg, dtable=dt)
    _run_analyser(an, world)
    kernels.reset_launches()
    taxa = _run_analyser(an, world)
    launches = kernels.launch_counts()
    for n in path_kernels(cfg):
        require(launches[n] > 0, f"kernel {n} was not launched on the "
                "resident peptide path")
    require(np.array_equal(taxa, tryptic_results["tryptic-sensitivity"]),
            "resident peptide: taxa differ from the bench index's in "
            f"{int((taxa != tryptic_results['tryptic-sensitivity']).sum())}"
            " groups")
    e2e = _stream_rate(an, world)
    bt = reads.reshape(BATCH, 2, -1)
    bl = lens.reshape(BATCH, 2)
    ms = cuda_ms(torch, lambda: an.step(bt, bl, L), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    RESULT["phases"]["resident_peptide"] = dict(
        **built, **k8_record, batch_ms=ms,
        device_resident_pairs_per_s=BATCH / (ms / 1e3), e2e=e2e,
        launches=launches, max_memory_allocated_gb=peak_gb,
        seconds=time.perf_counter() - t_phase)
    log(f"resident peptide {built['rows_gb']:.2f} GB: "
        f"tryptic-sensitivity {BATCH / (ms / 1e3):.0f} pairs/s resident, "
        f"{e2e['pairs_per_s']:.0f} e2e, taxa == bench index's; peak "
        f"{peak_gb:.2f} GB")
    del dt, an
    torch.cuda.empty_cache()
    return kernel_entry


# ---------------------------------------------------------------------- #
# Phase 4: a 0.54 GB card-resident bucket64s index
# ---------------------------------------------------------------------- #

# 2^20 rows x 64 slots x 8 B = 0.54 GB at load 0.5 (33.5 M keys), cut
# to keep the script in its time: 2^21 (1.07 GB) took the host's numpy
# build 51 s, 2^22 (2.1 GB) 92-100 s, 2^23 (4.3 GB) 155-222 s; phase
# shards splits the same keys into its 16-shard artifact (1.07 GB)
RESIDENT_LOG2_ROWS = 20


def resident_keys(keys, vals, n_total, n_tax, seed=11):
    """The bench keys plus seeded filler: f(i) = (i * C + D) mod 2^45 is
    a bijection, so the filler is unique, and indices whose image is a
    bench key are skipped, so it is disjoint from the bench keys."""
    rng = np.random.default_rng(seed)
    mask = np.uint64((1 << 45) - 1)
    C = np.uint64(int(rng.integers(1 << 40, 1 << 44)) | 1)
    D = np.uint64(int(rng.integers(0, 1 << 45)))
    Cinv = np.uint64(pow(int(C), -1, 1 << 45))
    n_fill = n_total - len(keys)
    n_idx = n_fill + len(keys)
    with np.errstate(over="ignore"):
        taken = ((keys - D) * Cinv) & mask
        free = np.ones(n_idx, dtype=bool)
        free[taken[taken < np.uint64(n_idx)].astype(np.int64)] = False
        i = np.flatnonzero(free)[:n_fill].astype(np.uint64)
        fill = (i * C + D) & mask
    fvals = rng.integers(1, n_tax + 1, size=n_fill).astype(np.int32)
    return np.concatenate([keys, fill]), np.concatenate([vals, fvals])


def phase_resident(torch, world):
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.index.table import build_kmer_table
    from umgap_tpu_torch.ops import encoding, lookup, translate
    from umgap_tpu_torch.ops.lookup import DeviceTable
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    dev = world["dev"]
    slots = 64 << RESIDENT_LOG2_ROWS
    n_total = slots // 2
    t0 = time.perf_counter()
    keys, vals = resident_keys(world["keys"], world["vals"], n_total,
                               world["n_tax"])
    tab = build_kmer_table(keys, vals, 9, layout="bucket64s", capacity=slots)
    # phase shards splits the same key set into 16 shards
    world["resident_kv"] = (keys, vals)
    del keys, vals
    build_s = time.perf_counter() - t0
    log(f"resident table: {tab.n} keys, {tab.n_buckets} rows of "
        f"{tab.bucket} slots, stash {len(tab.stash_hi)}, host build "
        f"{build_s:.1f}s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dt = DeviceTable.from_host(tab, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rows_gb = dt.rows.numel() * 4 / 1e9
    del tab

    L = world["L"]
    reads, lens = _batch_reads(torch, world, L)
    hi, lo, wvalid, _ = translate.reads_to_kmers(reads, lens, L,
                                                 encoding.get_table(1), 9)
    got = lookup.probe(dt, hi, lo, wvalid, 0)
    err = compare(torch, "K2 resident", got,
                  lookup.probe_plain(dt, hi, lo, wvalid, 0))
    world["resident_probe"] = got  # phase shards' grouped K2 equals it
    probe_ms = cuda_ms(torch, lambda: lookup.probe(dt, hi, lo, wvalid, 0))
    probe_dev = device_ms(torch, lambda: lookup.probe(dt, hi, lo, wvalid, 0),
                          by=True)
    n_valid = int(wvalid.sum())
    pb, pby = bound(hi.numel() * 14 + n_valid * (4 * 64 + 32), n_valid * 60)

    # peak from here on: the resident table plus the pipeline's working
    # set (the plain probe above gathers whole rows and is not the path)
    torch.cuda.reset_peak_memory_stats()
    cfg = PRESETS["high-sensitivity"]
    an = _analyser(world, cfg, dtable=dt)
    _run_analyser(an, world)
    an.overflow_reads = 0
    kernels.reset_launches()
    taxa = _run_analyser(an, world)
    launches = kernels.launch_counts()
    for n in path_kernels(cfg):
        require(launches[n] > 0, f"kernel {n} was not launched on the "
                "resident path")
    overflow = an.overflow_reads
    e2e = _stream_rate(an, world)
    bt = reads.reshape(BATCH, 2, -1)
    bl = lens.reshape(BATCH, 2)
    ms = cuda_ms(torch, lambda: an.step(bt, bl, L), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = _run_analyser(_analyser(world, cfg, dtable=dt, plain=True), world)
    P = world["P"]
    require(np.array_equal(taxa, plain),
            f"resident: kernel taxa differ from plain taxa in "
            f"{int((taxa != plain).sum())} of {P} groups")
    world["resident_taxa"] = taxa
    RESULT["phases"]["resident"] = dict(
        rows_gb=rows_gb, keys=n_total, host_build_s=build_s,
        host_to_device_s=load_s, probe_ms=probe_ms,
        probe_device_ms=probe_dev, probe_bound_ms=pb,
        probe_bound_by=pby, probe_max_abs_err=err,
        probe_found=int(got[1].sum()),
        device_resident_pairs_per_s=BATCH / (ms / 1e3),
        e2e=e2e, overflow_reads=overflow, launches=launches,
        max_memory_allocated_gb=peak_gb, seconds=time.perf_counter() - t_phase)
    log(f"resident {rows_gb:.2f} GB: K2 equal to plain, probe "
        f"{probe_ms:.3f} ms (bound {pb:.3f}); high-sensitivity "
        f"{BATCH / (ms / 1e3):.0f} pairs/s resident, "
        f"{e2e['pairs_per_s']:.0f} e2e, kernel taxa == plain; launches "
        f"{launches}; "
        f"peak {peak_gb:.2f} GB")
    del dt, an
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #
# Phase 5: the command line in a subprocess
# ---------------------------------------------------------------------- #

def _cli_files(world):
    """The command line's taxonomy TSV and packed index under
    .smoke_tmp/, written once."""
    from umgap_tpu_torch import ranks

    taxtsv = os.path.join(TMP_DIR, "taxons.tsv")
    index = os.path.join(TMP_DIR, "nine.npz")
    if not os.path.exists(taxtsv):
        parent, snap = world["parent"], world["snap"]
        with open(taxtsv, "w") as f:
            f.write("1\troot\tno rank\t1\t\x01\n")
            for i in range(2, world["n_tax"] + 1):
                rank = "no rank" if i % 3 else ranks.rank_name(14)
                valid = "\x01" if snap[i] == i else "\x00"
                f.write(f"{i}\tt{i}\t{rank}\t{int(parent[i])}\t{valid}\n")
    if not os.path.exists(index):
        world["table"].save(index, packed=True)
    return taxtsv, index


def _cli_session(world, read_length=160, tables=None):
    """A ``cli.AnalyseSession`` over the world's device state, as
    ``cmd_analyse`` loads one: ``tables`` ({tryptic: (table, device
    table)}, default both of the world's families) at ``read_length``,
    BATCH groups a batch, the six-frame front end (``--fgspp never``, as
    phase cli passes it)."""
    import argparse

    from umgap_tpu_torch import cli

    args = argparse.Namespace(read_length=read_length, batch_size=BATCH,
                              fgspp="never", configdir=None)
    if tables is None:
        tables = {False: (world["table"], world["dtable"]),
                  True: (world["ptable"], world["pdtable"])}
    return cli.AnalyseSession(args, world["tax"], tables, world["dtax"],
                              world["dev"])


def phase_cli(torch, world):
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    n = 4096
    reads = world["reads"][:n]
    L = world["L"]
    lut = np.frombuffer(b"ACGTN", np.uint8)
    paths = [os.path.join(TMP_DIR, f"A{e + 1}.fq") for e in (0, 1)]
    for e, path in enumerate(paths):
        seqs = lut[np.minimum(reads[:, e], 4)]
        with open(path, "wb") as f:
            for i in range(n):
                f.write(b"@s%d/%d\n%s\n+\n%s\n" % (
                    i, e + 1, seqs[i].tobytes(), b"I" * L))
    taxtsv, index = _cli_files(world)
    # --fgspp never: a card machine with FragGeneScan++ under its config
    # dir runs the same six-frame path (the port refuses FGSpp's presets
    # there under the default, auto)
    cmd = [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
           taxtsv, "--index", index, "--fgspp", "never"]
    for preset in PRESETS:  # one sample per preset, one process
        cmd += ["-t", preset, "-1", paths[0], "-2", paths[1], "-o",
                os.path.join(TMP_DIR, f"{preset}.fa")]
    # tryptic-sensitivity over a peptide index, and a 9-mer index under a
    # tryptic preset, which the command line refuses
    pindex = os.path.join(TMP_DIR, "tryptic.npz")
    world["ptable"].save(pindex)
    tout = os.path.join(TMP_DIR, "tryptic-sensitivity.fa")
    base = [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
            taxtsv, "-t", "tryptic-sensitivity", "-1", paths[0], "-2",
            paths[1], "--fgspp", "never"]
    # the three command lines side by side (no time of theirs is kept),
    # while this process runs the programs they are held to
    procs = _start_all({"9-mer": cmd,
                        "tryptic": base + ["--index", pindex, "-o", tout],
                        "refused": base + ["--index", index, "-o",
                                           tout + ".x"]})
    try:
        launches = _cli_checks(world, procs)
    finally:
        _stop_all(procs)
    RESULT["phases"]["cli"] = dict(
        groups=n, presets=list(PRESETS) + ["tryptic-sensitivity"],
        launches_L160=launches, seconds=time.perf_counter() - t_phase)
    log(f"CLI: {len(PRESETS)} 9-mer presets and tryptic-sensitivity x {n} "
        "groups, records equal to the Analyser's at read length 160, whose "
        "kernel taxa equal plain; a 9-mer index under a tryptic preset "
        "exits 1")


def _start_all(cmds):
    """Each command line in a subprocess of its own, all started at once:
    {name: (Popen, start time)} (stdout and stderr to files under
    TMP_DIR)."""
    out = {}
    for name, cmd in cmds.items():
        fo = open(os.path.join(TMP_DIR, f"proc_{name}.out"), "w")
        fe = open(os.path.join(TMP_DIR, f"proc_{name}.err"), "w")
        out[name] = (subprocess.Popen(cmd, cwd=REPO, stdout=fo, stderr=fe),
                     time.perf_counter(), fo, fe)
    return out


def _wait(procs, name, timeout=600):
    """(exit code, stderr text, seconds from its start to its end) of one
    of ``_start_all``'s processes."""
    p, t0, fo, fe = procs[name]
    rc = p.wait(timeout=timeout)
    secs = time.perf_counter() - t0
    fo.close()
    fe.close()
    with open(os.path.join(TMP_DIR, f"proc_{name}.err")) as f:
        return rc, f.read(), secs


def _stop_all(procs):
    """Kill what is still running of ``_start_all``'s processes."""
    for p, _t0, fo, fe in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        fo.close()
        fe.close()


def _cli_checks(world, procs):
    """Phase cli's checks: the CLI's program (--read-length 160) in this
    process for each 9-mer preset and tryptic-sensitivity, kernel path
    with its own launch counts, held to the plain path; then, once they
    end, the command lines' records held to it and the refused one's
    exit. Returns the launch counts by preset."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    n = 4096
    reads = world["reads"][:n]
    L = world["L"]
    lens = np.full((n, 2), L, dtype=np.int32)
    headers = [str(i) for i in range(n)]
    kw = dict(batch_size=n, read_length=160)
    launches, want = {}, {}
    configs = dict(PRESETS, **{
        "tryptic-sensitivity": TRYPTIC_PRESETS["tryptic-sensitivity"]})
    for preset, cfg in configs.items():
        an = _analyser(world, cfg, **kw)
        kernels.reset_launches()
        taxa = [t for _h, t in an.analyse_arrays(headers, reads, lens)]
        launches[preset] = kernels.launch_counts()
        for k in path_kernels(cfg):
            require(launches[preset][k] > 0, f"CLI {preset}: kernel {k} was "
                    "not launched at read length 160")
        plain = [t for _h, t in _analyser(
            world, cfg, plain=True, **kw).analyse_arrays(headers, reads,
                                                         lens)]
        require(taxa == plain, f"CLI {preset}: kernel taxa differ from "
                f"plain taxa at read length 160")
        want[preset] = "".join(f">s{h}\n{t}\n"
                               for h, t in zip(headers, taxa))
    for name in ("9-mer", "tryptic"):
        rc, err, _s = _wait(procs, name)
        require(rc == 0, f"CLI {name} exit {rc}: {err[-2000:]}")
    for preset in configs:
        with open(os.path.join(TMP_DIR, f"{preset}.fa")) as f:
            got = f.read()
        require(got == want[preset],
                f"CLI {preset}: records differ from the Analyser's")
        require(got.count(">") == n, f"CLI {preset}: {got.count('>')} "
                f"records for {n} groups")
    rc, err, _s = _wait(procs, "refused")
    require(rc == 1 and "needs a peptide" in err,
            f"CLI: a 9-mer index under a tryptic preset gave exit "
            f"{rc}: {err[-500:]}")
    return launches


# ---------------------------------------------------------------------- #
# Phase 5s: a buildindex-dist artifact served on the card
# ---------------------------------------------------------------------- #

SHARDS = 16  # buildindex-dist's default shard count
SHARDS_LAYOUT = "bucket64s"  # and its default layout


def _serve_request(path, line, timeout=600):
    """One request to the service at the socket ``path``: its reply."""
    import socket

    c = socket.socket(socket.AF_UNIX)
    c.settimeout(timeout)
    with c:
        c.connect(path)
        c.sendall((line + "\n").encode())
        c.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = c.recv(1 << 20)
            if not b:
                return b"".join(chunks).decode()
            chunks.append(b)


def phase_serve(torch, world):
    """``python -m umgap_tpu_torch analyse --serve SOCK`` on the card in a
    subprocess, with no initial sample, over the bench index at
    --read-length 100 (phase cli's files): two identical high-sensitivity
    requests over the bench pairs as FASTQ (one copy, 32,768 pairs) with
    -o, one without (the FASTA streamed back), a bad preset, a tryptic
    request against the pinned 9-mer index, then ``quit``. Requires
    ``ok 32768`` twice, the three outputs byte-equal to each other and to
    ``cli.run_sample``'s records of the same sample in this process, the
    two error lines, ``bye``, the socket gone and exit 0. Records each
    request's wall seconds and the service's start to its first reply
    (its kernels come from the build cache this process filled)."""
    import io

    from umgap_tpu_torch import cli

    t_phase = time.perf_counter()
    L, P = world["L"], world["P"]
    taxtsv, index = _cli_files(world)
    fq = [os.path.join(TMP_DIR, f"serve_R{e + 1}.fq") for e in (0, 1)]
    for e in (0, 1):
        with open(fq[e], "wb") as f:
            f.write(_fastq_text(world["reads"], e, b"s"))
    preset = "high-sensitivity"
    buf = io.StringIO()
    cli.write_batches(buf, cli.run_sample(
        _cli_session(world, read_length=L),
        dict(type=preset, first=fq[0], second=fq[1], output=None,
             compress=False)))
    want = buf.getvalue()
    require(want.count(">") == P, "serve: run_sample's records")
    # a short relative socket path (AF_UNIX paths are at most 107 bytes;
    # the checkout's may be longer): the service runs in TMP_DIR
    sock_abs = os.path.join(TMP_DIR, "serve.sock")
    sock = os.path.relpath(sock_abs)
    if len(sock) > len(sock_abs):
        sock = sock_abs
    outs = [os.path.join(TMP_DIR, f"serve_{i}.fa") for i in range(2)]
    env = dict(os.environ, PYTHONPATH=REPO)
    err_path = os.path.join(TMP_DIR, "serve.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--serve",
             "serve.sock", "--taxons", taxtsv, "--index", index,
             "--read-length", str(L)], cwd=TMP_DIR, env=env,
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        while not os.path.exists(sock_abs):
            require(proc.poll() is None and time.perf_counter() - t0 < 300,
                    "serve: the service did not come up: "
                    + open(err_path).read()[-2000:])
            time.sleep(0.05)
        listening_s = time.perf_counter() - t0
        sample = f"-t {preset} -1 {fq[0]} -2 {fq[1]}"
        replies, walls = [], []
        for line in (f"{sample} -o {outs[0]}", f"{sample} -o {outs[1]}",
                     sample, f"-t bogus-preset -1 {fq[0]} -o {outs[0]}x",
                     f"-t tryptic-sensitivity -1 {fq[0]} -2 {fq[1]} "
                     f"-o {outs[0]}x"):
            t1 = time.perf_counter()
            replies.append(_serve_request(sock, line))
            walls.append(time.perf_counter() - t1)
            if len(replies) == 1:
                first_reply_s = time.perf_counter() - t0
        bye = _serve_request(sock, "quit")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stderr = open(err_path).read()
    require(rc == 0, f"serve: exit {rc}: {stderr[-2000:]}")
    require(replies[0] == replies[1] == f"ok {P}\n",
            f"serve: replies {replies[:2]}")
    texts = [open(o).read() for o in outs]
    require(texts[0] == texts[1] == replies[2] == want,
            "serve: the outputs differ from each other, from the streamed "
            "reply or from run_sample's records")
    require(replies[3].startswith("error unknown preset 'bogus-preset'"),
            f"serve: bad preset: {replies[3]!r}")
    require(replies[4] == f"error index {index} is a kmer index but the "
            "preset needs a peptide (tryptic) index\n",
            f"serve: tryptic request: {replies[4]!r}")
    require(bye == "bye\n" and not os.path.exists(sock_abs),
            f"serve: quit answered {bye!r}")
    phase = dict(listening_s=listening_s, first_reply_s=first_reply_s,
                 request_s=dict(first=walls[0], second=walls[1],
                                streamed=walls[2], bad_preset=walls[3],
                                tryptic=walls[4]),
                 pairs=P, seconds=time.perf_counter() - t_phase)
    RESULT["phases"]["serve"] = phase
    log(f"serve: listening after {listening_s:.1f} s, first reply after "
        f"{first_reply_s:.1f} s; requests {walls[0]:.2f} / {walls[1]:.2f} s "
        f"(-o, first / second), streamed {walls[2]:.2f} s; bad preset and "
        f"tryptic errors, bye, exit 0; outputs == run_sample's records")


class _HostMemPeak:
    """Peak resident host memory of this process above its level at the
    start, read from /proc/self/smaps in a loop, split by mapping:
    "files" the pages of mappings of files under ``root`` (memory-mapped
    shards: page cache, shared with the file system), "anon" those of
    mappings with no file (the heap, numpy's arrays, staging buffers),
    "other" the rest (libraries, device files)."""

    KINDS = ("files", "anon", "other")

    def __init__(self, root):
        import threading

        self.root = os.path.abspath(root) + os.sep
        self.base = self.read()
        self.peak = dict(self.base)
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def read(self):
        out = dict.fromkeys(self.KINDS, 0)
        kind = "other"
        with open("/proc/self/smaps") as f:
            for line in f:
                if line.startswith("Rss:"):
                    out[kind] += int(line.split()[1]) * 1024
                elif not line[0].isupper():  # a mapping's header line
                    parts = line.split(None, 5)
                    path = parts[5].strip() if len(parts) == 6 else ""
                    kind = ("files" if path.startswith(self.root)
                            else "anon" if not path or path.startswith("[")
                            else "other")
        return out

    def _sample(self):
        for k, v in self.read().items():
            self.peak[k] = max(self.peak[k], v)
        self.samples += 1

    def _run(self):
        while not self._stop.wait(0.002):
            self._sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    def gb(self):
        return {k: (self.peak[k] - self.base[k]) / 1e9 for k in self.KINDS}


# ---------------------------------------------------------------------- #
# Phase 5u: the stream subcommands on the card
# ---------------------------------------------------------------------- #

SUB_PAIRS = 4096
SUB_PRESETS = ("high-sensitivity", "max-sensitivity")
# pairs of SCORED_WIDTH bp ends for `seedextend -r` (132 windows a frame:
# K3's scored row kernel)
SUB_SCORED_PAIRS = 512
SUB_PEPTIDES = 8  # peptides a pept2lca record
SUB_PATH_KERNELS = ("proteins_to_kmers", "probe_kmer", "seedextend_mask",
                    "dedup_counts", "tree_aggregate")
# taxa2agg -s: non-dyadic scores, the scored cases, and the wide rows (past
# 64 distinct taxa and 1,024 entries) drawn from SUB_WIDE_POOL taxa
SUB_SCORES = (0.1, 0.3, 0.7, 1.1, 0.2, 2.5)
SUB_SCORED_CASES = ((("tree", "hybrid"), ["-r", "-l", "0.7"]),
                    (("rmq", "hybrid"), ["-f", "0.3"]),
                    (("rmq", "mrtl"), ["-r"]))
SUB_WIDE_ROWS = 64
SUB_WIDE_POOL = 400


def _sub_run(argv, stdin):
    """One subcommand of ``python -m umgap_tpu_torch`` in this process:
    (stdout, wall seconds); a non-zero exit fails the phase."""
    import contextlib
    import io

    from umgap_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv, stdin=io.StringIO(stdin), stdout=out)
    dt = time.perf_counter() - t0
    require(rc == 0, f"subcommands: {argv[0]} exit {rc}: "
            f"{err.getvalue()[-1000:]}")
    return out.getvalue(), dt


def _sub_chain(preset, fasta_in, taxtsv, index, stages=None):
    """The preset as the reference's shell pipeline (umgap-analyse.sh:
    276-311): translate -a | prot2kmer2lca -o | seedextend | uniq -d / |
    taxa2agg, each stage in this process. Returns each stage's output;
    ``stages`` gets each one's wall s, records and records/s."""
    from umgap_tpu_torch.pipeline.fused import PRESETS

    cfg = PRESETS[preset]
    steps = (("translate", ["translate", "-a"]),
             ("prot2kmer2lca", ["prot2kmer2lca", "-o", index]),
             ("seedextend", ["seedextend", f"-g{cfg.max_gap_size}",
                             f"-s{cfg.min_seed_size}"]),
             ("uniq", ["uniq", "-d", "/"]),
             ("taxa2agg", ["taxa2agg", "-l", str(int(cfg.lower_bound)),
                           "-m", cfg.method, "-a", cfg.strategy, "-f",
                           str(cfg.factor), taxtsv]))
    outs, s = {}, fasta_in
    for name, argv in steps:
        s, dt = _sub_run(argv, s)
        outs[name] = s
        if stages is not None:
            n = s.count(">")
            stages[name] = dict(seconds=dt, records=n, records_per_s=n / dt)
    return outs


def _sub_fasta(codes, prefix):
    """Read pairs (n, 2, L) as FASTA, ends named <prefix><i>/1 and /2."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    seqs = lut[np.minimum(codes, 4)]
    return "".join(f">{prefix}{i}/{e + 1}\n{seqs[i, e].tobytes().decode()}\n"
                   for i in range(len(codes)) for e in (0, 1))


def _sock_roundtrip(path, data, timeout=300):
    """One stream to the server at ``path``, sent from a thread while the
    reply is read (neither side waits on a full socket buffer): (reply,
    wall seconds)."""
    import socket
    import threading

    t0 = time.perf_counter()
    c = socket.socket(socket.AF_UNIX)
    c.settimeout(timeout)
    with c:
        c.connect(path)

        def send():
            c.sendall(data.encode())
            c.shutdown(socket.SHUT_WR)

        th = threading.Thread(target=send)
        th.start()
        chunks = []
        while True:
            b = c.recv(1 << 20)
            if not b:
                break
            chunks.append(b)
        th.join()
    return b"".join(chunks).decode(), time.perf_counter() - t0


def _sub_socket(index, proteins, want):
    """``python -m umgap_tpu_torch prot2kmer2lca -o -s SOCK`` on the card
    in a subprocess (its kernels from the build cache this process
    filled): two connections of the proteins, the records of each equal
    to ``want``, then the server is stopped. Returns the seconds from the
    start to the socket (the process's start and the index's load onto
    the card), the two connections' wall seconds and the server's log
    lines."""
    # a short relative socket path (AF_UNIX paths are at most 107 bytes)
    sock_abs = os.path.join(TMP_DIR, "prot2kmer2lca.sock")
    sock = os.path.relpath(sock_abs, TMP_DIR)
    if os.path.exists(sock_abs):  # the server binds a new socket
        os.unlink(sock_abs)
    log_path = os.path.join(TMP_DIR, "prot2kmer2lca.log")
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "umgap_tpu_torch", "prot2kmer2lca", "-o",
             "-s", sock, os.path.abspath(index)], cwd=TMP_DIR, env=env,
            stdout=logf, stderr=subprocess.STDOUT)
    times = []
    try:
        while not os.path.exists(sock_abs):
            require(proc.poll() is None and time.perf_counter() - t0 < 300,
                    "subcommands: the prot2kmer2lca server did not start: "
                    + open(log_path).read()[-2000:])
            time.sleep(0.05)
        listening_s = time.perf_counter() - t0
        for i in range(2):
            got, dt = _sock_roundtrip(sock_abs, proteins)
            require(got == want, f"subcommands: socket connection {i + 1} "
                    "wrote other records than prot2kmer2lca on stdin")
            times.append(dt)
        require(proc.poll() is None, "subcommands: the server stopped")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    lines = open(log_path).read().splitlines()
    require(lines.count("Connection finished succesfully.") == 2,
            f"subcommands: server log {lines[-20:]}")
    return dict(listening_s=listening_s, first_s=times[0],
                repeat_s=times[1], log=lines)


def _scored_device_ms(torch, world, texts):
    """Device ms of taxa2agg -s's instances on the phase's records (a row
    a record, (B, N) padded): K4's weighted call (the kernel and the
    first-seen ordering of its slots) with the bound 0.7, and K6's ordered
    hybrid and mrtl on its output beside the unordered instances on the
    same inputs, each against its bound (_k6_bound); K6's ordered results
    equal to its plain versions."""
    from umgap_tpu_torch.agg import device as devagg

    dtax, dev = world["dtax"], world["dev"]
    D = dtax.geom.shape[1] - 1
    out = {}
    for kind, text in texts.items():
        rows = [[x.split("=") for x in r.split("\n")[1:] if x]
                for r in text.split(">")[1:]]
        B, N = len(rows), max(1, max(len(r) for r in rows))
        taxa = np.zeros((B, N), np.int32)
        w = np.zeros((B, N), np.float32)
        for i, r in enumerate(rows):
            taxa[i, :len(r)] = [int(a) for a, _b in r]
            w[i, :len(r)] = [float(b) for _a, b in r]
        t, x = torch.from_numpy(taxa).to(dev), torch.from_numpy(w).to(dev)
        k_max = int(devagg.dedup_counts(t, x, 64, True)[3].max())
        k_max = max(k_max, 1) if kind == "wide" else 64
        k4 = device_ms(torch, lambda: devagg.dedup_counts(
            t, x, k_max, True, lower_bound=0.7), reps=10)
        u, c, v, _n = devagg.dedup_counts(t, x, k_max, True, lower_bound=0.7)
        cell = dict(rows=B, N=N, K=k_max, k4_weighted_call_ms=k4)
        bounds = _k6_bound(torch, dtax, {"hybrid": devagg.tree_aggregate_hits(
            "hybrid", dtax, u, c, v, 0.25, ordered=True)}, u, v, D)
        for strat in ("hybrid", "mrtl"):
            res = devagg.tree_aggregate_hits(strat, dtax, u, c, v, 0.25,
                                             ordered=True)
            compare(torch, f"K6 ordered {strat} ({kind})", res,
                    devagg.tree_aggregate_hits_plain(strat, dtax, u, c, v,
                                                     0.25))
            cell[f"k6_{strat}"] = dict(
                ordered_ms=device_ms(torch, lambda s=strat: (
                    devagg.tree_aggregate_hits(s, dtax, u, c, v, 0.25,
                                               ordered=True)), reps=10),
                unordered_ms=device_ms(torch, lambda s=strat: (
                    devagg.tree_aggregate_hits(s, dtax, u, c, v, 0.25)),
                    reps=10),
                bound_ms=bounds[strat][0])
        out[kind] = cell
        log(f"subcommands: taxa2agg -s device ms ({kind}, B={B}, N={N}, "
            f"K={k_max}): K4 weighted call {k4:.4f}; " + ", ".join(
                f"K6 {s} ordered {cell['k6_' + s]['ordered_ms']:.4f} / "
                f"unordered {cell['k6_' + s]['unordered_ms']:.4f} (bound "
                f"{cell['k6_' + s]['bound_ms']:.4f})"
                for s in ("hybrid", "mrtl")))
    return out


def phase_subcommands(torch, world):
    """The reference's stream subcommands on the card, in this process
    (``cli.main``), over SUB_PAIRS bench pairs as FASTA and the bench
    index (phase cli's files): the high-sensitivity and max-sensitivity
    chains (``_sub_chain``; each stage's wall s and records/s), their
    records equal to ``analyse`` on the same pairs and equal under
    ``kernels.plain_versions()`` stage by stage, each chain launching K1P,
    K2, K3, K4 and K6; ``seedextend -r`` on the lanes of SUB_SCORED_PAIRS
    pairs of SCORED_WIDTH bp ends launching K3RS (= plain);
    ``taxa2agg -m rmq -a lca*`` launching K9 (= plain = ``--device
    cpu``);
    ``taxa2agg -s`` with non-dyadic scores (SUB_SCORED_CASES: tree/hybrid,
    rmq/hybrid, rmq/mrtl) on the grouped records and on SUB_WIDE_ROWS
    rows past 64 distinct taxa, launching K4 (its warp path, its row
    kernel) and K6 (K9 for rmq/hybrid, also = ``--device cpu``), = plain;
    ``pept2lca -o`` on the bench peptide index launching K8 (= plain);
    and one ``prot2kmer2lca -o -s`` server in a subprocess, connected
    twice, each connection writing the records of the command on stdin
    (``_sub_socket``). Returns the launches of each path."""
    from umgap_tpu_torch import kernels

    t_phase = time.perf_counter()
    taxtsv, index = _cli_files(world)
    fasta_in = _sub_fasta(world["reads"][:SUB_PAIRS], "s")
    paths = [os.path.join(TMP_DIR, f"sub{e + 1}.fq") for e in (0, 1)]
    lut = np.frombuffer(b"ACGTN", np.uint8)
    for e, path in enumerate(paths):
        seqs = lut[np.minimum(world["reads"][:SUB_PAIRS, e], 4)]
        with open(path, "wb") as f:
            for i in range(SUB_PAIRS):
                f.write(b"@s%d/%d\n%s\n+\n%s\n" % (
                    i, e + 1, seqs[i].tobytes(), b"I" * world["L"]))
    phase = {"pairs": SUB_PAIRS, "chains": {}, "launches": {}}
    outs = {}
    for preset in SUB_PRESETS:
        stages = {}
        kernels.reset_launches()
        outs[preset] = _sub_chain(preset, fasta_in, taxtsv, index, stages)
        launches = kernels.launch_counts()
        for k in SUB_PATH_KERNELS:
            require(launches[k] > 0, f"subcommands {preset}: kernel {k} was "
                    "not launched")
        ana, ana_s = _sub_run(["analyse", "-t", preset, "-1", paths[0], "-2",
                               paths[1], "--taxons", taxtsv, "--index", index,
                               "--fgspp", "never"], "")
        require(outs[preset]["taxa2agg"] == ana and
                ana.count(">") == SUB_PAIRS, f"subcommands {preset}: the "
                "chain's records differ from analyse's")
        with kernels.plain_versions():
            plain = _sub_chain(preset, fasta_in, taxtsv, index)
        for stage, text in outs[preset].items():
            require(plain[stage] == text, f"subcommands {preset}: {stage}'s "
                    "kernel records differ from the plain versions'")
        chain_s = sum(st["seconds"] for st in stages.values())
        phase["chains"][preset] = dict(stages=stages, chain_s=chain_s,
                                       analyse_s=ana_s)
        phase["launches"][preset] = launches
        log(f"subcommands {preset}: chain {chain_s:.2f}s ("
            + ", ".join(f"{n} {st['seconds']:.2f}s "
                        f"{st['records_per_s']:.0f} rec/s"
                        for n, st in stages.items())
            + f"), analyse {ana_s:.2f}s; records == analyse == plain")

    # seedextend -r on lanes past the staged tile: K3RS
    wcodes = _rung_codes(world, SCORED_WIDTH)[:SUB_SCORED_PAIRS]
    lookups, _dt = _sub_run(["prot2kmer2lca", "-o", index], _sub_run(
        ["translate", "-a"], _sub_fasta(wcodes, "w"))[0])
    argv = ["seedextend", "-r", taxtsv, "-g1", "-s2", "-p", "5"]
    kernels.reset_launches()
    scored, scored_s = _sub_run(argv, lookups)
    launches = kernels.launch_counts()
    require(launches["seedextend_rows_scored"] > 0 and
            launches["seedextend_rows"] == 0, f"subcommands: seedextend -r "
            f"at {SCORED_WIDTH} bp launched {launches}")
    with kernels.plain_versions():
        require(_sub_run(argv, lookups)[0] == scored, "subcommands: "
                "seedextend -r kernel records differ from plain")
    phase["launches"]["seedextend -r"] = launches
    phase["seedextend_ranked"] = dict(
        pairs=SUB_SCORED_PAIRS, width=SCORED_WIDTH, seconds=scored_s,
        records=scored.count(">"))

    # taxa2agg -m rmq -a lca*: K9, no K5
    argv = ["taxa2agg", "-m", "rmq", "-a", "lca*", "-l", "1", taxtsv]
    grouped = outs["high-sensitivity"]["uniq"]
    kernels.reset_launches()
    rmq, rmq_s = _sub_run(argv, grouped)
    launches = kernels.launch_counts()
    for k in ("dedup_counts", "rmq_aggregate"):
        require(launches[k] > 0, f"subcommands: taxa2agg rmq/lca* launched "
                f"no {k}: {launches}")
    require(launches["lane_gather"] == 0, f"subcommands: taxa2agg rmq/lca* "
            f"launched K5: {launches}")
    with kernels.plain_versions():
        require(_sub_run(argv, grouped)[0] == rmq, "subcommands: taxa2agg "
                "rmq/lca* kernel records differ from plain")
    require(_sub_run(argv + ["--device", "cpu"], grouped)[0] == rmq,
            "subcommands: taxa2agg rmq/lca* card records differ from "
            "--device cpu")
    phase["launches"]["taxa2agg rmq/lca*"] = launches
    phase["taxa2agg_rmq_lca"] = dict(seconds=rmq_s)

    # taxa2agg -s: K4's weighted instances and K6's ordered ones (K9 for
    # rmq/hybrid) on the grouped records with non-dyadic
    # scores (K4's warp path, K6's thread and warp paths) and on wide rows
    # (K4's row kernel, the wide pass, K6's block path)
    rng = np.random.default_rng(29)
    narrow = "".join(
        ">" + r.split("\n", 1)[0] + "\n" + "".join(
            f"{t}={rng.choice(SUB_SCORES)}\n"
            for t in r.split("\n")[1:] if t)
        for r in grouped.split(">")[1:])
    tax = world["tax"]
    pool = rng.choice(np.flatnonzero(tax.present & (tax.depth >= 1)),
                      size=SUB_WIDE_POOL, replace=False)
    wide = "".join(f">w{i}\n" + "".join(
        f"{int(t)}={rng.choice(SUB_SCORES)}\n"
        for t in rng.choice(pool, size=1100 + 7 * i))
        for i in range(SUB_WIDE_ROWS))
    phase["taxa2agg_scored"] = {}
    for (method, strategy), flags in SUB_SCORED_CASES:
        key = f"taxa2agg -s {method}/{strategy}"
        argv = ["taxa2agg", "-s", "-m", method, "-a", strategy, *flags,
                taxtsv]
        want = (("rmq_aggregate",) if method == "rmq" and
                strategy == "hybrid" else ("tree_aggregate",))
        for kind, stdin, k4 in (("narrow", narrow, "dedup_counts"),
                                ("wide", wide, "dedup_rows")):
            kernels.reset_launches()
            out, dt = _sub_run(argv, stdin)
            launches = kernels.launch_counts()
            for k in (k4, *want):
                require(launches[k] > 0, f"subcommands: {key} ({kind}) "
                        f"launched no {k}: {launches}")
            with kernels.plain_versions():
                plain, plain_s = _sub_run(argv, stdin)
            require(plain == out and out.count(">") == stdin.count(">"),
                    f"subcommands: {key} ({kind}): kernel records differ "
                    "from plain")
            if method == "rmq" and strategy == "hybrid":
                require(_sub_run(argv + ["--device", "cpu"], stdin)[0]
                        == out, f"subcommands: {key} ({kind}): card "
                        "records differ from --device cpu")
            phase["launches"][f"{key} {kind}"] = launches
            phase["taxa2agg_scored"][f"{key} {kind}"] = dict(
                records=out.count(">"), seconds=dt, plain_seconds=plain_s)

    phase["scored_device_ms"] = _scored_device_ms(torch, world,
                                                   {"narrow": narrow,
                                                    "wide": wide})

    # pept2lca -o on the bench peptide index: K8
    pindex = os.path.join(TMP_DIR, "tryptic.npz")
    if not os.path.exists(pindex):
        world["ptable"].save(pindex)
    rng = np.random.default_rng(23)
    keys = world["ptable"].raw_keys
    picks = rng.integers(0, len(keys), size=SUB_PAIRS * SUB_PEPTIDES)
    peps = [keys[i] if i % 5 else keys[i][::-1] for i in picks]
    pin = "".join(f">p{r}\n" + "".join(
        f"{p}\n" for p in peps[r * SUB_PEPTIDES:(r + 1) * SUB_PEPTIDES])
        for r in range(SUB_PAIRS))
    kernels.reset_launches()
    pout, pept_s = _sub_run(["pept2lca", "-o", pindex], pin)
    launches = kernels.launch_counts()
    require(launches["probe_peptide"] > 0, f"subcommands: pept2lca on the "
            f"peptide index launched {launches}")
    with kernels.plain_versions():
        require(_sub_run(["pept2lca", "-o", pindex], pin)[0] == pout,
                "subcommands: pept2lca kernel records differ from plain")
    hits = sum(1 for ln in pout.splitlines() if ln[:1] != ">" and ln != "0")
    phase["launches"]["pept2lca"] = launches
    phase["pept2lca"] = dict(peptides=len(peps), found=hits, seconds=pept_s)

    # prot2kmer2lca -s: the index on the card once, two connections
    hs = outs["high-sensitivity"]
    phase["socket"] = _sub_socket(index, hs["translate"],
                                  hs["prot2kmer2lca"])
    sk = phase["socket"]
    log(f"subcommands: seedextend -r at {SCORED_WIDTH} bp {scored_s:.2f}s "
        f"(K3RS {phase['launches']['seedextend -r']['seedextend_rows_scored']}"
        f" launches), taxa2agg rmq/lca* {rmq_s:.2f}s, pept2lca "
        f"{len(peps)} peptides {pept_s:.2f}s ({hits} found), taxa2agg -s "
        + ", ".join(f"{k} {v['seconds']:.2f}s"
                    for k, v in phase["taxa2agg_scored"].items())
        + ", socket "
        f"server up {sk['listening_s']:.2f}s, connection 1 "
        f"{sk['first_s']:.2f}s, connection 2 {sk['repeat_s']:.2f}s; all "
        "== plain")
    phase["card"] = RESULT.get("card")
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["subcommands"] = phase
    return phase["launches"]


# ---------------------------------------------------------------------- #
# Phase 5b: buildindex-dist, its join and split on the card
# ---------------------------------------------------------------------- #

BUILD_ROWS = "1.6e8"  # synthetic rows: about 10^8 keys, 2.15 GB of shards
BUILD_SHARDS = 16
BUILD_WORKERS = 2
BUILD_PROBES = 1_000_000
BUILD_TSV_BYTES = 40 << 20
BUILD_SMALL_ROWS = 300_000
BUILD_K6_CHECK = 65_536  # groups of each K6 launch held to K6's plain
BUILD_PLAIN_PROCS = 6  # the plain join of shard 0 in this many key ranges
# the wide joins: shard rows beside groups of 65-300 distinct taxa (in
# BUILD_PIECES key-range pieces) and beside one group of BUILD_WIDE_TAXA,
# past K6's shared memory (17,920), in two
BUILD_MID_ROWS = 1_000_000
BUILD_MID_WIDTHS = (65, 97, 160, 233, 300)
BUILD_PIECES = 3
BUILD_WIDE_ROWS = 100_000
BUILD_WIDE_TAXA = 20_000
BUILD_WIDE_DEPTH = 4  # the member that the hybrid walk reaches

# the plain join (numpy) of one .npz of rows, in a process of its own
PLAIN_JOIN = (
    "import sys, numpy as np; sys.path.insert(0, sys.argv[1]); "
    "from umgap_tpu_torch.index.scale import join_kmers_sorted_plain; "
    "from umgap_tpu_torch.taxonomy import Taxonomy, read_taxa_file; "
    "z = np.load(sys.argv[3]); "
    "k, v = join_kmers_sorted_plain(z['keys'], z['tids'], "
    "Taxonomy(read_taxa_file(sys.argv[2]))); "
    "np.savez(sys.argv[4], keys=k, values=v)")


def _build_tsv(path, n_bytes, seed=37):
    """A seeded (taxid TAB protein) TSV of about ``n_bytes``: proteins of
    9-35,000 residues (most below 2,000), taxids of the synthetic
    taxonomy (1-200,000)."""
    rng = np.random.default_rng(seed)
    aas = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    lines, size = [], 0
    while size < n_bytes:
        n = int(rng.integers(9, 35_001)) if rng.random() < 0.01 else \
            int(rng.integers(9, 2_000))
        line = b"%d\t%s\n" % (int(rng.integers(1, 200_001)),
                              aas[rng.integers(0, 20, size=n)].tobytes())
        lines.append(line)
        size += len(line)
    with open(path, "wb") as f:
        f.write(b"".join(lines))
    return path


def _taxa_group(tax, rng, n, deep=None):
    """One random key's rows over ``n`` distinct taxa that are their own
    valid ancestor, 1-3 rows each, under the depth-2 node with the most
    of them; with ``deep``, a member at that depth takes 19 times the
    others' rows, so that hybrid f = 0.95 walks down to it. Returns
    (uint64 keys, int64 taxids)."""
    ids = np.flatnonzero(tax.present & (tax.snapping(ranked_only=False)
                                        == np.arange(tax.size)))
    ids = ids[tax.depth[ids] > 2]
    top = tax.anc_table[ids, 2]
    ids = ids[top == np.bincount(top).argmax()]
    require(len(ids) >= n, f"builddist: {len(ids)} taxa under one node, "
            f"fewer than {n}")
    members = rng.choice(ids, size=n, replace=False)
    reps = rng.integers(1, 4, size=n)
    if deep is not None:
        at = np.flatnonzero(tax.depth[members] == deep)
        require(len(at) > 0, f"builddist: no member at depth {deep}")
        reps[at[0]] = 19 * int(reps.sum())
    key = np.uint64(rng.integers(0, 1 << 45))
    return (np.full(int(reps.sum()), key, np.uint64),
            np.repeat(members, reps).astype(np.int64))


def _inprocess_drive(work, device, **kw):
    """distbuild.drive with each stage's tasks run in this process (the
    workers' own code, worker_main), on ``device``."""
    from umgap_tpu_torch.index import distbuild

    def run_stage(workdir, task, pending, workers, dev=None):
        distbuild.worker_main(workdir, task, ",".join(map(str, pending)),
                              device=device)
        return []

    saved = distbuild._run_stage
    distbuild._run_stage = run_stage
    try:
        return distbuild.drive(work, device=device, **kw)
    finally:
        distbuild._run_stage = saved


def _same_workdir(a, b):
    """Both build directories hold the same files, .npz arrays equal."""
    rel = lambda w: sorted(os.path.relpath(os.path.join(r, n), w)
                           for r, _d, ns in os.walk(w) for n in ns)
    fa = [f for f in rel(a) if f != "manifest.json"]
    require(fa == [f for f in rel(b) if f != "manifest.json"],
            f"builddist: {a} and {b} hold other files")
    for f in fa:
        if f.endswith(".npz"):
            za, zb = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
            require(sorted(za.files) == sorted(zb.files) and all(
                za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                for k in za.files), f"builddist: {f} differs")


def _k6_spy(devagg):
    """Replace tree_aggregate_hits by a wrapper that keeps each call's
    arguments; returns (calls, restore)."""
    calls, k6 = [], devagg.tree_aggregate_hits

    def spy(*args, **kw):
        calls.append(args)
        return k6(*args, **kw)

    devagg.tree_aggregate_hits = spy
    return calls, lambda: setattr(devagg, "tree_aggregate_hits", k6)


def _builddist_on_card(torch, dev, work, tax, dtax, calls, inputs, packed,
                       keys, vals, rng):
    """Phase builddist's card work while the plain joins run: K6's calls
    of shard 0's join timed (device ms, bound) and their first
    BUILD_K6_CHECK groups held to K6's plain version; the mid and wide
    rows joined on the card in key-range pieces; BUILD_PROBES keys of the
    shard probed through the grouped table against the card join's
    values. Returns (K6 cells, K6 device ms, K6 bound ms, {name: ((keys,
    values), stats)} of the wide joins, the probe's stats)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.index import distbuild, scale
    from umgap_tpu_torch.ops import kmers, lookup
    from umgap_tpu_torch.parallel import ShardedTable

    D = dtax.geom.shape[1] - 1
    k6 = devagg.tree_aggregate_hits
    k6_cells, k6_ms, k6_bound = [], 0.0, 0.0
    for args in calls:
        u, c, v = args[2:5]
        fn = (lambda a=args: k6(*a))
        res = k6("hybrid", dtax, u, c, v, args[5])
        b, _by = _k6_bound(torch, dtax, {"hybrid": res}, u, v, D)["hybrid"]
        ms = device_ms(torch, fn, reps=5)
        n = min(BUILD_K6_CHECK, u.shape[0])
        sl = [a[:n] if torch.is_tensor(a) and a.dim() == 2 else a
              for a in args]
        compare(torch, f"K6 on the join's (G={u.shape[0]}, K={u.shape[1]})",
                k6(*sl), devagg.tree_aggregate_hits_plain(*sl))
        k6_cells.append(dict(groups=u.shape[0], K=u.shape[1],
                             device_ms=ms, bound_ms=b))
        k6_ms += ms
        k6_bound += b

    # the wide joins on the card, in key-range pieces
    wide_out = {}
    for name, pieces in (("mid", BUILD_PIECES), ("wide", 2)):
        k, t = inputs[name]
        rows = -(-len(k) // pieces)
        require(len(scale.piece_bounds(k, rows)) >= 1,
                f"builddist: the {name} rows were not cut in pieces")
        wcalls, restore = _k6_spy(devagg)
        try:
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = scale.join_kmers_sorted(k, t, tax, device=dev, dtax=dtax,
                                          piece_rows=rows)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            n_k6 = kernels.launch_counts()["tree_aggregate"]
        finally:
            restore()
        widths = sorted({int(a[2].shape[1]) for a in wcalls})
        require(n_k6 == len(wcalls) > 0, f"builddist: the {name} join "
                f"launched K6 {n_k6} times, {len(wcalls)} calls")
        # K6's block path (K > 64): each such launch's device ms and bound
        block = [dict(groups=int(a[2].shape[0]), K=int(a[2].shape[1]),
                      device_ms=device_ms(torch, lambda a=a: k6(*a), reps=5),
                      bound_ms=_k6_bound(torch, dtax, {"hybrid": k6(*a)},
                                         a[2], a[4], D)["hybrid"][0])
                 for a in wcalls if a[2].shape[1] > 64]
        wide_out[name] = (got, dict(rows=len(k), pieces=pieces,
                                    keys=len(got[0]), seconds=secs,
                                    k6_launches=n_k6, k6_widths=widths,
                                    k6_block=block))
    require(any(64 < w <= 300 for w in wide_out["mid"][1]["k6_widths"]),
            "builddist: no K6 launch took the groups of 65-300 taxa")
    require(max(wide_out["wide"][1]["k6_widths"]) >= BUILD_WIDE_TAXA
            and devagg.tree_scratch_bytes(1, BUILD_WIDE_TAXA) > 0,
            "builddist: no K6 launch took the wide group in its scratch")

    # BUILD_PROBES keys of shard 0's rows through the grouped table
    stable = ShardedTable.from_shards(distbuild.load_shards(work, mmap=True),
                                      dev)
    q = packed[rng.integers(0, len(packed), size=BUILD_PROBES)]
    hi, lo = kmers.split_packed(q)
    at = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    hit = keys[at] == q
    want = np.where(hit, vals[at], 0).astype(np.int32)
    kernels.reset_launches()
    got, found = lookup.probe(stable.table,
                              torch.from_numpy(hi).to(dev),
                              torch.from_numpy(lo).to(dev), None, 0)
    require(kernels.K2.launches > 0, "builddist: the probe launched no K2")
    require(np.array_equal(got.cpu().numpy(), want) and np.array_equal(
        found.cpu().numpy(), hit), "builddist: probed values differ from "
            "the card join's")
    probe = dict(keys=BUILD_PROBES, found=int(hit.sum()), group=stable.group)
    del stable
    torch.cuda.empty_cache()
    return k6_cells, k6_ms, k6_bound, wide_out, probe



def phase_builddist(torch, world):
    """``python -m umgap_tpu_torch buildindex-dist --synthetic 1.6e8
    --shards 16 --workers 2`` on the card in a subprocess, as users run it
    (each stage's seconds, the artifact's GB, the host's peak resident
    memory of its processes), with nothing else running. Then in this
    process, on shard 0 of it: the card join (sort, K6) equal to the
    worker's and, once the job is over, to the plain (numpy) join run in
    BUILD_PLAIN_PROCS processes over key ranges of the shard; K6's
    launches, device ms against their bound, each launch's first
    BUILD_K6_CHECK groups equal to K6's plain version; the card join of
    shard rows beside groups of 65-300 distinct taxa (in BUILD_PIECES
    key-range pieces) and beside one group of BUILD_WIDE_TAXA (K6's
    global scratch, in two pieces), each equal to the plain join;
    BUILD_PROBES keys drawn from the shard's rows probed through
    ShardedTable.from_shards (K2's grouped entry) equal to the plain
    join's values; a seeded TSV of ~40 MB (proteins of 9-35,000
    residues) split on the card (K1P's launches and device ms against
    their bound) equal to the plain split; and builds of BUILD_SMALL_ROWS
    synthetic rows and of a TSV on the card equal to --device cpu builds,
    array for array."""
    import glob

    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.index import distbuild, scale
    from umgap_tpu_torch.ops import kmers
    from umgap_tpu_torch.taxonomy import Taxonomy, read_taxa_file

    t_phase = time.perf_counter()
    dev = world["dev"]
    root = os.path.join(TMP_DIR, "builddist")
    os.makedirs(root)
    work = os.path.join(root, "work")
    phase = {}

    # the job in a subprocess; a wrapper reports its processes' peak RSS
    wrapper = ("import resource, subprocess, sys; "
               "rc = subprocess.call(sys.argv[1:]); "
               "print('MAXRSS_KB', resource.getrusage("
               "resource.RUSAGE_CHILDREN).ru_maxrss, file=sys.stderr); "
               "sys.exit(rc)")
    cmd = [sys.executable, "-c", wrapper, sys.executable, "-m",
           "umgap_tpu_torch", "buildindex-dist", "--workdir", work,
           "--synthetic", BUILD_ROWS, "--shards", str(BUILD_SHARDS),
           "--workers", str(BUILD_WORKERS)]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    with open(os.path.join(root, "job.out"), "w") as fo, \
            open(os.path.join(root, "job.err"), "w") as fe:
        proc = subprocess.run(cmd, cwd=REPO, env=env, stdout=fo, stderr=fe)
    job_s = time.perf_counter() - t0
    err = open(os.path.join(root, "job.err")).read()
    require(proc.returncode == 0, f"builddist: the job exit "
            f"{proc.returncode}: {err[-2000:]}")
    job = json.loads(open(os.path.join(root, "job.out")).read())
    maxrss = [ln for ln in err.splitlines() if ln.startswith("MAXRSS_KB")]
    shard_bytes = sum(os.path.getsize(os.path.join(work, "shards", f))
                      for f in os.listdir(os.path.join(work, "shards"))
                      if f.endswith(".npz"))
    phase["job"] = dict(
        command=" ".join(cmd[3:]), seconds=job_s, n_keys=job["n_keys"],
        capacity=job["capacity"], stages_s=job["timings_s"],
        artifact_gb=shard_bytes / 1e9,
        host_peak_rss_gb=int(maxrss[-1].split()[1]) * 1024 / 1e9)
    log(f"builddist: {job['n_keys']} keys in {BUILD_SHARDS} shards "
        f"({shard_bytes / 1e9:.2f} GB) in {job_s:.1f}s, stages "
        f"{job['timings_s']}; host peak RSS "
        f"{phase['job']['host_peak_rss_gb']:.2f} GB (largest process)")

    # shard 0 in this process: the card join against the worker's
    taxons = os.path.join(work, "taxons.tsv")
    tax = Taxonomy(read_taxa_file(taxons))
    dtax = devagg.DeviceTaxonomy.from_host(tax, dev)
    parts = [np.load(p) for p in sorted(
        glob.glob(os.path.join(work, "part", "c*_s000.npz")))]
    packed = np.concatenate([z["keys"] for z in parts])
    tids = np.concatenate([z["tids"] for z in parts]).astype(np.int64)
    calls, restore = _k6_spy(devagg)
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keys, vals = scale.join_kmers_sorted(packed, tids, tax, device=dev,
                                             dtax=dtax)
        torch.cuda.synchronize()
        join_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        restore()
    require(launches["tree_aggregate"] == len(calls) > 0, f"builddist: the "
            f"join launched K6 {launches['tree_aggregate']} times, "
            f"{len(calls)} calls")
    wz = np.load(os.path.join(work, "joined", "s000.npz"))
    require(np.array_equal(wz["keys"], keys) and np.array_equal(
        wz["values"], vals), "builddist: the worker's join of shard 0 "
            "differs from this process's")

    # the plain joins, each in a process of its own, while the card
    # works below: shard 0 in key ranges (no group spans two), and the
    # rows of the wide joins
    rng = np.random.default_rng(43)
    mid = [_taxa_group(tax, rng, w) for w in BUILD_MID_WIDTHS]
    wide = _taxa_group(tax, rng, BUILD_WIDE_TAXA, deep=BUILD_WIDE_DEPTH)
    inputs = {
        "mid": (np.concatenate([packed[:BUILD_MID_ROWS]]
                               + [g[0] for g in mid]),
                np.concatenate([tids[:BUILD_MID_ROWS]]
                               + [g[1] for g in mid])),
        "wide": (np.concatenate([packed[-BUILD_WIDE_ROWS:], wide[0]]),
                 np.concatenate([tids[-BUILD_WIDE_ROWS:], wide[1]]))}
    cut = np.quantile(packed[::16], np.arange(1, BUILD_PLAIN_PROCS)
                      / BUILD_PLAIN_PROCS).astype(np.uint64)
    piece = np.searchsorted(cut, packed, side="right")
    for i in range(BUILD_PLAIN_PROCS):
        inputs[f"s000_{i}"] = (packed[piece == i], tids[piece == i])
    del piece
    plains = {}
    for name, (k, t) in inputs.items():
        src = os.path.join(root, f"rows_{name}.npz")
        np.savez(src, keys=k, tids=t)
        out = os.path.join(root, f"plain_{name}.npz")
        plains[name] = (out, subprocess.Popen(
            [sys.executable, "-c", PLAIN_JOIN, REPO, taxons, src, out],
            cwd=REPO, env=env))

    try:
        stats = _builddist_on_card(torch, dev, work, tax, dtax, calls,
                                   inputs, packed, keys, vals, rng)
        t0 = time.perf_counter()
        for name, (out, p) in plains.items():
            require(p.wait() == 0,
                    f"builddist: the plain join of {name} failed")
        plain_wait_s = time.perf_counter() - t0
    finally:
        for _out, p in plains.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    k6_cells, k6_ms, k6_bound, wide_out, phase["probe"] = stats

    # the plain joins' results
    pz = [np.load(plains[f"s000_{i}"][0]) for i in range(BUILD_PLAIN_PROCS)]
    pk = np.concatenate([z["keys"] for z in pz])
    require(np.array_equal(keys, pk) and keys.dtype == pk.dtype
            and np.array_equal(vals, np.concatenate([z["values"]
                                                     for z in pz])),
            "builddist: the card join of shard 0 differs from the plain "
            "join")
    for name, ((gk, gv), st) in wide_out.items():
        z = np.load(plains[name][0])
        require(np.array_equal(gk, z["keys"]) and gk.dtype == z["keys"].dtype
                and np.array_equal(gv, z["values"]), f"builddist: the card "
                f"join of the {name} rows differs from the plain join")
        phase[f"join_{name}"] = st
    phase["join"] = dict(
        rows=len(packed), keys=len(keys), seconds=join_s,
        plain_wait_s=plain_wait_s,
        k6=dict(launches=launches["tree_aggregate"], device_ms=k6_ms,
                bound_ms=k6_bound, cells=k6_cells))
    log(f"builddist: shard 0's join on the card ({len(packed)} rows -> "
        f"{len(keys)} keys) {join_s:.2f}s = plain = the worker's; K6 "
        f"{launches['tree_aggregate']} launches, {k6_ms:.4f} ms device "
        f"against {k6_bound:.4f} ms bound; with groups of 65-300 taxa "
        f"{phase['join_mid']} and of {BUILD_WIDE_TAXA} "
        f"{phase['join_wide']}, = plain (waited {plain_wait_s:.1f}s)")

    # a seeded TSV split on the card against the plain split
    tsv = _build_tsv(os.path.join(root, "prot.tsv"), BUILD_TSV_BYTES)
    p2k, k1p_calls = kmers.proteins_to_kmers, []

    def k1p_spy(*args, **kw):
        k1p_calls.append(args)
        return p2k(*args, **kw)

    kmers.proteins_to_kmers = k1p_spy
    try:
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = distbuild.read_tsv_chunk(tsv, 0, os.path.getsize(tsv), 9, dev)
        split_s = time.perf_counter() - t0
        k1p_launches = kernels.K1P.launches
    finally:
        kmers.proteins_to_kmers = p2k
    with open(tsv, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    prow = scale.split_kmers_tsv_plain(data)
    plain_split_s = time.perf_counter() - t0
    require(k1p_launches == len(k1p_calls) > 0, "builddist: the split "
            "launched no K1P")
    require(all(np.array_equal(a, b) and a.dtype == b.dtype
                for a, b in zip(rows, prow)), "builddist: the card split "
            "differs from the plain split")
    k1p_ms = k1p_bound = 0.0
    for aa, ln, *rest in k1p_calls:
        N, P = aa.shape
        W = max(P - 8, 1)
        k1p_ms += device_ms(torch, lambda a=aa, n=ln: p2k(a, n), reps=5)
        k1p_bound += bound(N * P + 4 * N + N * W * 9, N * W * 9 * 2)[0]
    phase["split"] = dict(
        bytes=len(data), rows=len(prow[0]), seconds=split_s,
        plain_seconds=plain_split_s,
        k1p=dict(launches=k1p_launches, device_ms=k1p_ms,
                 bound_ms=k1p_bound))
    log(f"builddist: TSV of {len(data) / 1e6:.1f} MB split on the card in "
        f"{split_s:.2f}s ({len(prow[0])} rows = plain, {plain_split_s:.2f}s)"
        f"; K1P {k1p_launches} launches, {k1p_ms:.4f} ms device against "
        f"{k1p_bound:.4f} ms bound")

    # small builds on the card = --device cpu builds
    small_tsv = os.path.join(root, "small.tsv")
    with open(small_tsv, "wb") as f:
        f.write(data[:data.index(b"\n", min(330_000, len(data) - 1)) + 1])
    small = {}
    for kind, kw in (("synthetic", dict(tsv=None, taxons=taxons,
                                        synthetic_rows=BUILD_SMALL_ROWS)),
                     ("tsv", dict(tsv=small_tsv, taxons=taxons))):
        ws = {}
        for d in ("card", "cpu"):
            ws[d] = os.path.join(root, f"small_{kind}_{d}")
            t0 = time.perf_counter()
            m = _inprocess_drive(ws[d], None if d == "card" else "cpu",
                                 n_shards=4, workers=1, **kw)
            small[f"{kind}_{d}_s"] = time.perf_counter() - t0
        _same_workdir(ws["card"], ws["cpu"])
        small[f"{kind}_keys"] = m["n_keys"]
    phase["small_builds"] = small
    log(f"builddist: small builds on the card = --device cpu: {small}")
    shutil.rmtree(root, ignore_errors=True)
    phase["card"] = RESULT.get("card")
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["builddist"] = phase
    return phase


def _write_shards(shards, work, taxons):
    """A buildindex-dist workdir: each shard packed and uncompressed as
    ``shards/shard_{s:03d}.npz``, its probe depth stamped to the
    layout's, and the manifest."""
    from umgap_tpu_torch.index import distbuild

    os.makedirs(os.path.join(work, "shards"), exist_ok=True)
    for i, t in enumerate(shards):
        t.max_probes = max(t.max_probes,
                           distbuild.PROBE_LIMITS[SHARDS_LAYOUT])
        t.save(os.path.join(work, "shards", f"shard_{i:03d}.npz"),
               packed=True)
    with open(os.path.join(work, "manifest.json"), "w") as f:
        json.dump(dict(n_shards=len(shards), k=9, layout=SHARDS_LAYOUT,
                       capacity=shards[0].capacity, taxons=taxons,
                       n_keys=int(sum(t.n for t in shards))), f)


def _trace_kernels(tdir):
    """Names of the CUDA kernels in the Chrome trace under ``tdir``."""
    import glob

    names = set()
    for path in glob.glob(os.path.join(tdir, "*.pt.trace.json")):
        with open(path) as f:
            for e in json.load(f).get("traceEvents", []):
                if e.get("cat") == "kernel":
                    names.add(e.get("name", ""))
    return names


def phase_shards(torch, world):
    """The resident phase's 33.5 M keys split by the port's owner_of into
    a 16-shard bucket64s buildindex-dist artifact, written, put on the
    card by ShardedTable.from_shards read into memory (a control) and
    memory-mapped, the host's memory split by mapping during each load; K2's grouped entry
    held to its plain version and to the resident single table's K2 on
    the bench batch's queries, timed; high-sensitivity through
    make_sharded_stream_analyser (taxa = plain = the resident phase's,
    launches, CUDA kernels a step, rates); then the command line over a
    bench-scale 16-shard artifact: --shards (the workdir and its
    shards/), --mesh 1 --index and --trace-dir, against phase cli's
    --index bytes. Returns (launches, K2 grouped's stats)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.index import distbuild
    from umgap_tpu_torch.ops import encoding, lookup, translate
    from umgap_tpu_torch.parallel import (
        ShardedTable,
        build_sharded_tables,
        make_sharded_stream_analyser,
    )
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    dev, L, P = world["dev"], world["L"], world["P"]
    work = os.path.join(TMP_DIR, "shards_work")
    keys, vals = world.pop("resident_kv")
    t0 = time.perf_counter()
    shards = build_sharded_tables(keys, vals, 9, SHARDS, load_factor=0.5,
                                  layout=SHARDS_LAYOUT)
    build_s = time.perf_counter() - t0
    n_keys = len(keys)
    del keys, vals
    cap = shards[0].capacity
    stash = sum(len(t.stash_hi) for t in shards)
    t0 = time.perf_counter()
    _write_shards(shards, work, None)
    write_s = time.perf_counter() - t0
    del shards
    log(f"shards: {n_keys} keys in {SHARDS} {SHARDS_LAYOUT} shards of "
        f"{cap} slots ({cap * 8 * SHARDS / 1e9:.2f} GB rows), stash "
        f"{stash}; host build {build_s:.1f}s, write {write_s:.1f}s")

    # the host's memory during the load, the shards read into memory
    # (the control) and memory-mapped (what --shards does); the table of
    # the second is the one served
    host = {}
    for mmap in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _HostMemPeak(work) as mem:
            t0 = time.perf_counter()
            stable = ShardedTable.from_shards(
                distbuild.load_shards(work, mmap=mmap), dev)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        tag = "mmap" if mmap else "read"
        host[tag] = dict(mem.gb(), disk_to_card_s=load_s,
                         samples=mem.samples)
        log(f"shards ({tag}): disk -> card {load_s:.1f}s; host peak above "
            f"start: " + ", ".join(f"{k} {v:.3f} GB"
                                   for k, v in mem.gb().items())
            + f" ({mem.samples} samples)")
        if not mmap:
            del stable
    world["shards_work"] = work  # phase mesh loads it again, then drops it
    dt = stable.table
    rows_gb = dt.rows.numel() * 4 / 1e9
    require(stable.group == SHARDS and dt.stash.shape[0] == stash,
            f"shards: group {stable.group}, stash {dt.stash.shape[0]}")
    load_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"shards: {rows_gb / load_s:.2f} GB/s to the card memory-mapped; "
        f"card peak {load_peak_gb:.2f} GB")

    # K2's grouped entry on the bench batch's queries
    reads, lens = _batch_reads(torch, world, L)
    hi, lo, wvalid, _ = translate.reads_to_kmers(reads, lens, L,
                                                 encoding.get_table(1), 9)

    def k2():
        return lookup.probe(dt, hi, lo, wvalid, 0)

    before = kernels.K2.launches
    got = k2()
    require(kernels.K2.launches == before + 1, "K2 grouped: one launch")
    err = compare(torch, "K2 grouped", got,
                  lookup.probe_plain(dt, hi, lo, wvalid, 0))
    err = max(err, compare(torch, "K2 grouped vs the resident single "
                           "table's K2", got, world.pop("resident_probe")))
    Q, n_valid = hi.numel(), int(wvalid.sum())
    pb, pby = bound(Q * 14 + n_valid * (4 * 64 + 32), n_valid * 70)
    k2_ms = cuda_ms(torch, k2)
    k2_dev, k2_by = device_ms(torch, k2, by=True)
    k2_stats = dict(
        ms=k2_ms, device_ms=k2_dev, device_ms_by=k2_by,
        back_to_back_ms=events_ms(torch, k2),
        plain_ms=cuda_ms(torch, lambda: lookup.probe_plain(
            dt, hi, lo, wvalid, 0), reps=3),
        bound_ms=pb, bound_by=pby, bound_share=pb / k2_dev,
        max_abs_err=err, equal=err == 0.0, queries=Q, valid=n_valid,
        found=int(got[1].sum()), group=stable.group)
    log(f"K2 grouped: equal to plain and to the single table's K2 on {Q} "
        f"queries ({n_valid} valid); {k2_ms:.4f} ms events, {k2_dev:.4f} "
        f"ms device, bound {pb:.4f} ({pb / k2_dev:.0%})")

    # the grouped analyser
    cfg = PRESETS["high-sensitivity"]
    torch.cuda.reset_peak_memory_stats()
    an = make_sharded_stream_analyser(world["tax"], stable, cfg,
                                      batch_size=BATCH, read_length=L,
                                      dtax=world["dtax"])
    _run_analyser(an, world)
    an.overflow_reads = 0
    kernels.reset_launches()
    taxa = _run_analyser(an, world)
    launches = kernels.launch_counts()
    for n in path_kernels(cfg):
        require(launches[n] > 0, f"kernel {n} was not launched on the "
                "sharded path")
    cuda_batch = batch_cuda_launches(torch, world, an)
    want_kernels = RESULT["batch_cuda_launches"]["high-sensitivity"][
        "kernels"]
    require(cuda_batch["kernels"] == want_kernels,
            f"shards: {cuda_batch['kernels']} CUDA kernels a batch step, "
            f"the main path's high-sensitivity step {want_kernels}")
    e2e = _stream_rate(an, world)
    bt = reads.reshape(BATCH, 2, -1)
    bl = lens.reshape(BATCH, 2)
    batch_ms = cuda_ms(torch, lambda: an.step(bt, bl, L), reps=5)
    # the table plus the path's working set (the plain run below gathers
    # whole rows and is not the path)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    plain = _run_analyser(_analyser(world, cfg, dtable=dt, plain=True), world)
    require(np.array_equal(taxa, plain), f"shards: kernel taxa differ from "
            f"plain taxa in {int((taxa != plain).sum())} of {P} groups")
    require(np.array_equal(taxa, world.pop("resident_taxa")),
            "shards: taxa differ from the resident single table's")
    world["shards_taxa"] = taxa
    log(f"shards high-sensitivity: kernel taxa == plain == resident on {P} "
        f"groups; launches {launches}; {cuda_batch['kernels']} CUDA kernels "
        f"a step; {BATCH / (batch_ms / 1e3):.0f} pairs/s resident, "
        f"{e2e['pairs_per_s']:.0f} e2e; peak {peak_gb:.2f} GB")
    del an, stable, dt
    torch.cuda.empty_cache()

    # the command line over a bench-scale artifact
    cli_work = os.path.join(TMP_DIR, "cli_shards")
    taxtsv, index = _cli_files(world)
    _write_shards(build_sharded_tables(world["keys"], world["vals"], 9,
                                       SHARDS, load_factor=0.5,
                                       layout=SHARDS_LAYOUT),
                  cli_work, taxtsv)
    paths = [os.path.join(TMP_DIR, f"A{e + 1}.fq") for e in (0, 1)]
    with open(os.path.join(TMP_DIR, "high-sensitivity.fa"), "rb") as f:
        want = f.read()
    tdir = os.path.join(TMP_DIR, "trace")
    runs = {"shards_workdir": ["--shards", cli_work],
            "shards_dir": ["--shards", os.path.join(cli_work, "shards"),
                           "--trace-dir", tdir],
            "mesh_index": ["--mesh", "1", "--index", index]}
    # the three command lines side by side: each one's seconds are from
    # its start to its end with the others running
    procs = _start_all({tag: [
        sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
        taxtsv, "-t", "high-sensitivity", "-1", paths[0], "-2", paths[1],
        "--fgspp", "never", "-o", os.path.join(TMP_DIR, f"shards-{tag}.fa"),
        *flags] for tag, flags in runs.items()})
    cli_s = {}
    try:
        for tag in runs:
            rc, err, cli_s[tag] = _wait(procs, tag)
            require(rc == 0, f"CLI {tag} exit {rc}: {err[-2000:]}")
            with open(os.path.join(TMP_DIR, f"shards-{tag}.fa"), "rb") as f:
                require(f.read() == want, f"CLI {tag}: records differ from "
                        "phase cli's --index run")
    finally:
        _stop_all(procs)
    traced = _trace_kernels(tdir)
    require(any("probe_kernel" in n for n in traced),
            f"--trace-dir: no probe_kmer kernel among {sorted(traced)}")
    shutil.rmtree(cli_work)
    RESULT["phases"]["shards"] = dict(
        keys=n_keys, shards=SHARDS, layout=SHARDS_LAYOUT, capacity=cap,
        rows_gb=rows_gb, stash=stash, host_build_s=build_s,
        host_write_s=write_s, disk_to_card_s=load_s, host_load=host,
        card_peak_after_load_gb=load_peak_gb, k2_grouped=k2_stats,
        launches=launches, batch_cuda_launches=cuda_batch,
        batch_ms=batch_ms, device_resident_pairs_per_s=BATCH / (
            batch_ms / 1e3), e2e=e2e, max_memory_allocated_gb=peak_gb,
        cli_seconds=cli_s, trace_kernels=sorted(traced),
        seconds=time.perf_counter() - t_phase)
    probes = sorted(n for n in traced if "probe" in n)
    log(f"shards CLI: --shards (workdir, shards/), --mesh 1 --index equal "
        f"to --index; the trace names {probes}")
    return launches, k2_stats


# ---------------------------------------------------------------------- #
# Phase 5m: the artifact over a four-device mesh on the one card
# ---------------------------------------------------------------------- #

MESH_DEVICES = 4
# K8's grouped entry on one device: the bench peptide index in this many
# shards (the kernels line's entry is timed at 16)
PEPTIDE_GROUPS = (2, 4, 16, 64)


def _mesh_inputs(torch, world, devices):
    """The workload's 16,384-pair batches cut over the mesh's devices, on
    the card: a (dna4 slices, length slices, width) step argument a
    batch."""
    from umgap_tpu_torch.ops import encoding
    from umgap_tpu_torch.parallel.sharded import split_to_mesh

    L = world["L"]
    lens = np.full((BATCH, 2), L, dtype=np.int32)
    out = [(split_to_mesh(encoding.pack_dna4(
        world["reads"][i * BATCH:(i + 1) * BATCH]), devices),
        split_to_mesh(lens, devices), L)
        for i in range(world["P"] // BATCH)]
    torch.cuda.synchronize()
    return out


def _split_timer(torch, ms):
    """A step's ``timer(name)``: each part's event ms added into ``ms``,
    the part ending in a sync (nested parts, "exchange/gloo", within
    their parent)."""
    import contextlib

    def timer(name):
        @contextlib.contextmanager
        def cm():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            b.synchronize()
            ms[name] = ms.get(name, 0.0) + a.elapsed_time(b)
        return cm()
    return timer


def _mesh_split(torch, an, inputs, reps=5):
    """A mesh step's event ms by part, each part ending in a host sync:
    the stages before the probe, "route", "exchange" (both ways),
    "probe" (every device's), "unroute", the stages after; the sum over
    a step, median over ``reps`` x the batches. Returns (ms by part, ms
    a step)."""
    steps = []
    for _ in range(reps):
        for args in inputs:
            ms: dict = {}
            an.step(*args, timer=_split_timer(torch, ms))
            steps.append(ms)
    parts = {k: float(np.median([s.get(k, 0.0) for s in steps]))
             for k in steps[0]}
    return parts, float(np.median([sum(s.values()) for s in steps]))


def _k8_mesh_queries(torch, step, args, tables):
    """What each device's K8 is given in one mesh step: its table and
    the (hi, lo, valid) of its receive buffer (the routed queries in
    their (N, B) buckets, most of them -1 fill), recorded by wrapping
    ``lookup.probe`` for that step; in device order."""
    from umgap_tpu_torch.ops import lookup

    seen = []
    real = lookup.probe

    def spy(table, hi, lo, valid=None, default=0):
        if any(table is t for t in tables):
            seen.append((table, hi.clone(), lo.clone(), valid.clone()))
        return real(table, hi, lo, valid, default)

    lookup.probe = spy
    try:
        step(*args)
    finally:
        lookup.probe = real
    torch.cuda.synchronize()
    require(len(seen) == len(tables)
            and all(a[0] is t for a, t in zip(seen, tables)),
            f"mesh: K8 was given {len(seen)} of {len(tables)} device "
            "tables in one step")
    return seen


def _k8_mesh_stats(torch, an, args, stable, err):
    """K8's grouped entry on each device's table of ``stable``, at the
    queries one step of ``an`` gives it (:func:`_k8_mesh_queries`): held
    to its plain version, timed with the L2 flushed (event and device
    ms), its plain version's ms and its bound on this data. Returns the
    kernels line's figures (the mean over the devices) with the devices'
    own; ``err`` is the sweep's max abs error, folded in."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.ops import lookup

    by_device = []
    for d, (t, h, lo, v) in enumerate(_k8_mesh_queries(
            torch, an.step, args, stable.tables)):
        before = kernels.K8.launches
        got = lookup.probe(t, h, lo, v, 0)
        require(kernels.K8.launches == before + 1,
                f"K8 grouped d={d}: one launch")
        err = max(err, compare(torch, f"K8 grouped d={d} on the mesh "
                               "step's queries", got,
                               lookup.probe_plain(t, h, lo, v, 0)))

        def fn(t=t, h=h, lo=lo, v=v):
            return lookup.probe(t, h, lo, v, 0)

        pb, pby, rows = k8_bound(torch, t, h, lo, v)
        by_device.append(dict(
            first=t.first, group=t.group, n_total=t.n_total,
            depth=t.max_probes, queries=h.numel(), valid=int(v.sum()),
            rows_read=rows, ms=cold_ms(torch, fn),
            device_ms=cold_device_ms(torch, fn, "probe_peptide"),
            warm_ms=cuda_ms(torch, fn),
            plain_ms=cuda_ms(torch, lambda t=t, h=h, lo=lo, v=v:
                             lookup.probe_plain(t, h, lo, v, 0), reps=3),
            bound_ms=pb, bound_by=pby))
    require([(s["first"], s["n_total"]) for s in by_device]
            == [(d * stable.group, stable.n_shards)
                for d in range(stable.n_devices)],
            "mesh: K8 grouped slices out of order")
    dev = [s["device_ms"] for s in by_device]

    def mean(k):
        return float(np.mean([s[k] for s in by_device]))

    return dict(ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by=max(by_device, key=lambda s: s["bound_ms"])[
                    "bound_by"],
                device_ms=None if None in dev else float(np.mean(dev)),
                max_abs_err=err, equal=err == 0.0, by_device=by_device)


def phase_mesh(torch, world, tryptic_taxa):
    """Phase shards' 16-shard artifact on a four-device mesh that repeats
    the card (4 shards a device; the exchange is copies within the one
    card): the load; K2's slice entry of each device held to its plain
    version on the bench batch's queries (a device finds only the keys
    it owns); high-sensitivity through make_sharded_stream_analyser over
    all pairs (taxa = phase shards' one-device taxa = plain, launches,
    CUDA kernels a step, ms a batch and its split, the exchange's share,
    rates); K8's grouped entry on the bench peptide index in 2-64 shards
    on one device held to plain and to the one table's K8 (a side
    table); the bench peptide index split 4 ways (the command line's
    --mesh 4 split, one shard a device) and 8 ways (two a device: K8's
    grouped entry) through tryptic-sensitivity, taxa = phase tryptic's =
    plain, and at 8 ways each device's K8 grouped entry held to plain
    and timed (L2 flushed) on the queries one mesh step gives it: the
    kernels line's entry, its ms, plain ms and bound the mean over the
    devices. Returns (launches of the 8-way tryptic run, K8 grouped's
    stats)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.index import distbuild
    from umgap_tpu_torch.ops import encoding, lookup, translate
    from umgap_tpu_torch.parallel import (
        ShardedTable,
        build_sharded_peptide_tables,
        make_mesh,
        make_sharded_stream_analyser,
        owner_of,
    )
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import (
        TRYPTIC_PRESETS,
        reads_to_peptides,
    )

    t_phase = time.perf_counter()
    dev, L, P = world["dev"], world["L"], world["P"]
    work = world.pop("shards_work")
    mesh = make_mesh(devices=(dev,) * MESH_DEVICES)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stable = ShardedTable.from_shards(distbuild.load_shards(work, mmap=True),
                                      mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    world["shards_work"] = work  # phase multihost loads it, then drops it
    group = SHARDS // MESH_DEVICES
    require(stable.n_devices == MESH_DEVICES and stable.group == group
            and [(t.first, t.n_total) for t in stable.tables]
            == [(d * group, SHARDS) for d in range(MESH_DEVICES)],
            f"mesh: {stable.n_devices} devices of {stable.group} shards")
    log(f"mesh: {SHARDS} shards on {MESH_DEVICES} devices of the one card "
        f"({group} a device), disk -> card {load_s:.1f}s")

    # K2's slice entry on each device, every query of the bench batch
    reads, lens = _batch_reads(torch, world, L)
    hi, lo, wvalid, _ = translate.reads_to_kmers(reads, lens, L,
                                                 encoding.get_table(1), 9)
    own = owner_of(hi, lo, MESH_DEVICES)
    slices, err = [], 0.0
    for d, t in enumerate(stable.tables):
        before = kernels.K2.launches
        got = lookup.probe(t, hi, lo, wvalid, 0)
        require(kernels.K2.launches == before + 1, f"K2 slice {d}: one "
                "launch")
        err = max(err, compare(torch, f"K2 slice d={d}", got,
                               lookup.probe_plain(t, hi, lo, wvalid, 0)))
        require(not bool((got[1] & (own != d)).any()),
                f"K2 slice d={d}: found a key another device owns")

        def k2(t=t):
            return lookup.probe(t, hi, lo, wvalid, 0)

        # every valid query fetches a row of its (clipped) sub-table, as
        # the grouped entry's bound in phase shards counts it
        Q, n_valid = hi.numel(), int(wvalid.sum())
        b, bb = bound(Q * 14 + n_valid * (4 * 64 + 32), n_valid * 70)
        dms, dby = device_ms(torch, k2, reps=10, by=True)
        slices.append(dict(
            first=t.first, group=t.group, n_total=t.n_total,
            found=int(got[1].sum()), owned=int((wvalid & (own == d)).sum()),
            ms=cuda_ms(torch, k2), device_ms=dms, device_ms_by=dby,
            bound_ms=b, bound_by=bb, bound_share=b / dms))
    log("mesh K2 slices: equal to plain on " + ", ".join(
        f"d={d} {s['found']} of {s['owned']} owned found, {s['ms']:.4f} ms "
        f"({s['device_ms']:.4f} device, bound {s['bound_ms']:.4f}, "
        f"{s['bound_share']:.0%})" for d, s in enumerate(slices)))
    del hi, lo, wvalid, own

    # high-sensitivity through the stream analyser over the mesh
    cfg = PRESETS["high-sensitivity"]
    an = make_sharded_stream_analyser(world["tax"], stable, cfg,
                                      batch_size=BATCH, read_length=L,
                                      dtax=world["dtax"])
    _run_analyser(an, world)
    an.overflow_reads = 0
    kernels.reset_launches()
    taxa = _run_analyser(an, world)
    launches = kernels.launch_counts()
    for n in path_kernels(cfg):
        require(launches[n] > 0, f"kernel {n} was not launched on the mesh "
                "path")
    n_batches = P // BATCH
    require(an.overflow_reads or launches["probe_kmer"]
            == MESH_DEVICES * n_batches, f"mesh: {launches['probe_kmer']} "
            f"K2 launches for {n_batches} batches on {MESH_DEVICES} devices")
    require(np.array_equal(taxa, world.pop("shards_taxa")),
            "mesh: taxa differ from phase shards' one-device taxa")
    world["mesh_taxa"] = taxa
    pan = make_sharded_stream_analyser(world["tax"], stable, cfg,
                                       batch_size=BATCH, read_length=L,
                                       dtax=world["dtax"])
    pan.step.plain = True
    pan._wide().plain = True
    plain = _run_analyser(pan, world)
    del pan
    require(np.array_equal(taxa, plain), f"mesh: kernel taxa differ from "
            f"plain taxa in {int((taxa != plain).sum())} of {P} groups")
    inputs = _mesh_inputs(torch, world, stable.devices)
    cuda_batch = batch_cuda_launches(torch, world, an, inputs=inputs[0])
    batch_ms = cuda_ms(torch, lambda: an.step(*inputs[0]), reps=5)
    parts, step_ms = _mesh_split(torch, an, inputs)
    share = parts.get("exchange", 0.0) / step_ms
    e2e = _stream_rate(an, world)
    log(f"mesh high-sensitivity: taxa == shards == plain on {P} groups; "
        f"launches {launches}; {cuda_batch['kernels']} CUDA kernels and "
        f"{cuda_batch['copies']} copies a step; {batch_ms:.3f} ms a batch, "
        f"{BATCH / (batch_ms / 1e3):.0f} pairs/s resident, "
        f"{e2e['pairs_per_s']:.0f} e2e; split (synced) " + ", ".join(
            f"{k} {v:.3f}" for k, v in parts.items())
        + f" ms: the exchange (copies within the one card) {share:.1%} of "
        f"{step_ms:.3f} ms")
    del an, stable
    torch.cuda.empty_cache()

    # K8's grouped entry on the bench peptide index, one device
    ptab = world["ptable"]
    h1, h2, pv = reads_to_peptides(reads, lens, L, encoding.get_table(1))
    one = lookup.probe(world["pdtable"], h1, h2, pv, 0)
    k8, err8 = {}, 0.0
    for g in PEPTIDE_GROUPS:
        st = ShardedTable.from_shards(build_sharded_peptide_tables(
            ptab.raw_keys, ptab.raw_values, g), dev)
        dt = st.table
        before = kernels.K8.launches
        got = lookup.probe(dt, h1, h2, pv, 0)
        require(kernels.K8.launches == before + 1, f"K8 grouped {g}: one "
                "launch")
        err8 = max(err8, compare(torch, f"K8 grouped g={g}", got,
                                 lookup.probe_plain(dt, h1, h2, pv, 0)))
        err8 = max(err8, compare(torch, f"K8 grouped g={g} vs the one "
                                 "table's K8", got, one))
        k8[g] = dict(ms=cuda_ms(torch, lambda dt=dt: lookup.probe(
            dt, h1, h2, pv, 0)), depth=dt.max_probes,
            rows_gb=dt.rows.numel() * 4 / 1e9)
    log("mesh K8 grouped, one device: equal to plain and to the one "
        "table's K8 at groups " + ", ".join(
            f"{g} ({v['ms']:.4f} ms warm)" for g, v in k8.items()))
    del reads, lens, h1, h2, pv, one

    # tryptic-sensitivity over the mesh, the index split 4 and 8 ways
    tname = "tryptic-sensitivity"
    tcfg = TRYPTIC_PRESETS[tname]
    tryptic = {}
    for n_shards in (MESH_DEVICES, 2 * MESH_DEVICES):
        t0 = time.perf_counter()
        shards = build_sharded_peptide_tables(ptab.raw_keys,
                                              ptab.raw_values, n_shards)
        build_s = time.perf_counter() - t0
        st = ShardedTable.from_shards(shards, mesh)
        tan = make_sharded_stream_analyser(world["tax"], st, tcfg,
                                           tryptic=True, batch_size=BATCH,
                                           read_length=L,
                                           dtax=world["dtax"])
        _run_analyser(tan, world)
        kernels.reset_launches()
        ttaxa = _run_analyser(tan, world)
        tl = kernels.launch_counts()
        for n in path_kernels(tcfg):
            require(tl[n] > 0, f"kernel {n} was not launched on the "
                    f"{n_shards}-shard tryptic mesh path")
        require(np.array_equal(ttaxa, tryptic_taxa[tname]),
                f"mesh {tname} ({n_shards} shards): taxa differ from phase "
                "tryptic's")
        if n_shards == 2 * MESH_DEVICES:
            # K8's grouped entry held and timed on what the step gives it
            grouped_launches = tl
            k8_stats = _k8_mesh_stats(torch, tan, inputs[0], st, err8)
            k8_stats["by_group"] = k8
        tan.step.plain = True
        tan._wide().plain = True
        require(np.array_equal(ttaxa, _run_analyser(tan, world)),
                f"mesh {tname} ({n_shards} shards): kernel taxa differ from "
                "plain taxa")
        tryptic[n_shards] = dict(
            group=st.group, depths=[t.max_probes for t in shards],
            host_split_s=build_s, launches=tl)
        del tan, st
    del inputs
    log(f"mesh {tname}: taxa == phase tryptic == plain with the index in "
        f"{MESH_DEVICES} and {2 * MESH_DEVICES} shards (probe depths "
        + " / ".join(str(v["depths"]) for v in tryptic.values())
        + f"); K8 grouped launches {grouped_launches['probe_peptide']}; "
        "on one step's routed queries (L2 flushed) " + ", ".join(
            f"d={d} {v['ms']:.4f} ms ({fmt_ms(v['device_ms'])} device, "
            f"bound {v['bound_ms']:.4f}, plain {v['plain_ms']:.4f})"
            for d, v in enumerate(k8_stats["by_device"])))
    RESULT["phases"]["mesh"] = dict(
        devices=MESH_DEVICES, shards=SHARDS, group=group,
        disk_to_card_s=load_s, k2_slices=slices, launches=launches,
        batch_cuda_launches=cuda_batch, batch_ms=batch_ms,
        device_resident_pairs_per_s=BATCH / (batch_ms / 1e3), e2e=e2e,
        split_ms=parts, split_step_ms=step_ms, exchange_share=share,
        k8_grouped=k8_stats, tryptic=tryptic,
        seconds=time.perf_counter() - t_phase)
    return grouped_launches, k8_stats


# ---------------------------------------------------------------------- #
# Phase 5h: processes across hosts, two ranks on the one card
# ---------------------------------------------------------------------- #

MULTIHOST_RANKS = 2
MULTIHOST_LOCAL = 2  # each rank's devices: (cuda:0, cuda:0)
MULTIHOST_REPS = 3  # timed passes over a cell's batches
MULTIHOST_TIMEOUT_S = 300
MULTIHOST_PEPTIDE_SHARDS = 8  # K8's grouped entry, 2 a global device


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multihost_cell(torch, step, mesh, reads, lens, batch):
    """Drive ``step`` over this rank's share (``per_host_groups``) of the
    read groups in global batches of ``batch`` (``batch / world`` rows a
    rank): once with the launches counted, giving every rank's taxa
    gathered and the summed frequency vector; then MULTIHOST_REPS timed
    passes: wall ms a step (synced) and its split (event ms by part, each
    part synced), medians; the all_to_all_single calls a step and the
    bytes this rank sent in them (to the other ranks)."""
    import torch.distributed as dist

    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.parallel import (
        allgather_taxa,
        global_batch,
        per_host_groups,
    )

    W = mesh.world_size
    mine = per_host_groups(range(len(reads)), mesh.rank, W)
    per = -(-len(reads) // W)  # every rank steps as often
    rows = batch // W
    inputs = []
    for s in range(0, per, rows):
        sel = mine[s:s + rows]
        inputs.append(global_batch(reads[sel], lens[sel], mesh, rows=rows)
                      + (len(sel),))
    torch.cuda.synchronize()
    sent = []
    real = dist.all_to_all_single

    def counted(out, inp, *a, **k):
        sent.append(inp.numel() * inp.element_size())
        return real(out, inp, *a, **k)

    dist.all_to_all_single = counted
    try:
        kernels.reset_launches()
        taxa, freq = [], None
        for d, ln, n in inputs:
            t, f = step(d, ln, n=n)
            taxa.append(t)
            freq = f if freq is None else freq + f
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        calls, sent_bytes = len(sent) / len(inputs), sum(sent) / len(inputs)
        walls, splits = [], []
        for _ in range(MULTIHOST_REPS):
            for d, ln, n in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(d, ln, n=n)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            for d, ln, n in inputs:
                ms: dict = {}
                step(d, ln, n=n, timer=_split_timer(torch, ms))
                splits.append(ms)
    finally:
        dist.all_to_all_single = real
    gathered = allgather_taxa(torch.cat(taxa), mesh, n=len(mine))
    return dict(
        taxa=gathered, freq=freq.cpu().numpy(), launches=launches,
        steps=len(inputs), rank_rows=rows, step_ms=float(np.median(walls)),
        step_ms_range=[min(walls), max(walls)],
        split_ms={k: float(np.median([s.get(k, 0.0) for s in splits]))
                  for k in splits[0]},
        split_step_ms=float(np.median([
            sum(v for k, v in s.items() if "/" not in k) for s in splits])),
        all_to_all_calls_a_step=calls,
        exchange_buffer_bytes_a_step=sent_bytes,
        bytes_sent_a_step=sent_bytes * (W - 1) / W)


def _multihost_rank(rank, port, work, inputs, out):
    """One rank of phase multihost (a spawned process): gloo at
    ``port``, local devices (cuda:0, cuda:0) of a four-device mesh over
    two processes; loads its 8 shards of the 16-shard artifact at
    ``work`` and drives high-sensitivity over it, tryptic-sensitivity
    over the bench peptide index (``inputs``) in 8 shards and
    high-sensitivity over the bench index in 4 shards
    (:func:`_multihost_cell` each). Writes its report to ``out``.json
    and the cells' gathered taxa and frequencies to ``out``.npz."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg.device import DeviceTaxonomy
    from umgap_tpu_torch.index import distbuild
    from umgap_tpu_torch.parallel import (
        ShardedTable,
        build_sharded_peptide_tables,
        flat_mesh,
        init_distributed,
        make_multihost_pipeline,
        make_multihost_step,
        pod_mesh,
    )
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kernels.build_all()  # the libraries the parent built: bound, not built
    init_distributed(f"tcp://127.0.0.1:{port}", MULTIHOST_RANKS, rank,
                     backend="gloo")
    local = (dev,) * MULTIHOST_LOCAL
    mesh = flat_mesh(local=local)
    pod = pod_mesh(local=local)
    require(pod.shape == (MULTIHOST_RANKS, MULTIHOST_LOCAL)
            and pod.grid()[rank].tolist() == [
                mesh.global_index(d) for d in range(MULTIHOST_LOCAL)],
            f"multihost rank {rank}: pod grid {pod.grid().tolist()}")
    man, _parent, _snap, tax = bench_taxonomy()
    P, L = man["n_pairs"], man["read_len"]
    reads = np.fromfile(os.path.join(DATA, "reads.bin"),
                        np.uint8).reshape(P, 2, L)
    lens = np.full((P, 2), L, dtype=np.int32)
    dtax = DeviceTaxonomy.from_host(tax, dev)
    report = dict(rank=rank, pid=os.getpid(), start_s=time.perf_counter()
                  - t0)
    cells = {}

    t1 = time.perf_counter()
    stable = ShardedTable.from_shards(distbuild.load_shards(work, mmap=True),
                                      mesh)
    torch.cuda.synchronize()
    report["artifact_load_s"] = time.perf_counter() - t1
    group = SHARDS // mesh.n_devices
    require([(t.first, t.group, t.n_total) for t in stable.tables] == [
        (mesh.global_index(d) * group, group, SHARDS)
        for d in range(MULTIHOST_LOCAL)],
        f"multihost rank {rank}: artifact slices out of order")
    report["artifact_rows_gb"] = sum(t.rows.numel() * 4
                                     for t in stable.tables) / 1e9
    cfg = PRESETS["high-sensitivity"]
    cells["artifact"] = _multihost_cell(
        torch, make_multihost_step(dtax, stable, cfg), mesh, reads, lens,
        BATCH)
    del stable
    torch.cuda.empty_cache()

    z = np.load(inputs)
    peps = z["peptides"].tobytes().decode().split("\n")
    t1 = time.perf_counter()
    tstable = ShardedTable.from_shards(build_sharded_peptide_tables(
        peps, z["pvalues"], MULTIHOST_PEPTIDE_SHARDS), mesh)
    report["peptide_split_s"] = time.perf_counter() - t1
    cells["tryptic"] = _multihost_cell(
        torch, make_multihost_step(dtax, tstable, TRYPTIC_PRESETS[
            "tryptic-sensitivity"], tryptic=True), mesh, reads, lens, BATCH)
    del tstable

    keys = np.fromfile(os.path.join(DATA, "index_keys.bin"), np.uint64)
    vals = np.fromfile(os.path.join(DATA, "index_vals.bin"), np.int32)
    t1 = time.perf_counter()
    _mesh, bstep = make_multihost_pipeline(tax, keys, vals, 9, cfg,
                                           mesh=mesh)
    report["bench_split_s"] = time.perf_counter() - t1
    cells["bench"] = _multihost_cell(torch, bstep, mesh, reads, lens, BATCH)
    report["seconds"] = time.perf_counter() - t0
    arrays = {}
    for name, c in cells.items():
        arrays[name + "_taxa"] = c.pop("taxa")
        arrays[name + "_freq"] = c.pop("freq")
    np.savez(out + ".npz", **arrays)
    with open(out + ".json", "w") as f:
        json.dump(dict(report, cells=cells), f)
    dist.destroy_process_group()


def phase_multihost(torch, world, main_results, tryptic_taxa):
    """Processes across hosts on the one card: two spawned processes, each
    a gloo rank (tcp://127.0.0.1) over local devices (cuda:0, cuda:0), a
    four-device mesh across processes (:func:`_multihost_rank`). Over
    phase shards' 16-shard artifact (4 shards a global device, each rank
    uploads its 8) high-sensitivity over all pairs, split by
    per_host_groups, in 16,384-pair global batches: taxa gathered =
    phase mesh's (= plain there), the summed frequency vector = the rank
    counts of those taxa; tryptic-sensitivity over the bench peptide
    index in 8 shards: taxa = phase tryptic's; the bench index in 4
    shards: taxa = phase main's, the first 1,024 = REFERENCE_DIGESTS.
    Each rank's launches by kernel (all non-zero), ms a step and its
    split (route, exchange: device -> host, gloo, host -> device, probe,
    unroute), the all_to_all_single calls a step and the bytes it sent.
    nccl is not shown: it refuses two ranks on one card."""
    import torch.multiprocessing as mp

    from umgap_tpu_torch.parallel.sharded import rank_counts

    t_phase = time.perf_counter()
    work = world.pop("shards_work")
    mesh_taxa = world.pop("mesh_taxa")
    inputs = os.path.join(TMP_DIR, "multihost_inputs.npz")
    ptab = world["ptable"]
    np.savez(inputs, peptides=np.frombuffer(
        "\n".join(ptab.raw_keys).encode(), np.uint8),
        pvalues=ptab.raw_values)
    outs = [os.path.join(TMP_DIR, f"multihost_rank{r}")
            for r in range(MULTIHOST_RANKS)]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_multihost_rank,
                         args=(r, port, work, inputs, outs[r]))
             for r in range(MULTIHOST_RANKS)]
    try:
        for p in procs:
            p.start()
        deadline = time.perf_counter() + MULTIHOST_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.perf_counter()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        require(not late, f"multihost: ranks {late} still running after "
                f"{MULTIHOST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.pid is not None:  # started
                if p.is_alive():
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    require(codes == [0] * MULTIHOST_RANKS, f"multihost: rank exit codes "
            f"{codes}")
    shutil.rmtree(work)
    reports = []
    for o in outs:
        with open(o + ".json") as f:
            reports.append(json.load(f))
    got = dict(np.load(outs[0] + ".npz"))
    dev, P = world["dev"], world["P"]
    want = {"artifact": mesh_taxa,
            "tryptic": tryptic_taxa["tryptic-sensitivity"],
            "bench": main_results["high-sensitivity"]}
    for name, w in want.items():
        t = got[name + "_taxa"]
        require(t.shape == (P,) and np.array_equal(t, w),
                f"multihost {name}: gathered taxa differ from the "
                f"one-process run's in {int((t != w).sum())} of {P} groups"
                if t.shape == w.shape else f"multihost {name}: {t.shape} "
                "taxa gathered")
        freq = rank_counts([world["dtax"]], [torch.from_numpy(t).to(dev)])
        require(np.array_equal(got[name + "_freq"], freq.cpu().numpy()),
                f"multihost {name}: the summed frequency vector is not the "
                "rank counts of the gathered taxa")
    require(taxa_digest(got["bench_taxa"][:REFERENCE_PAIRS])
            == REFERENCE_DIGESTS["high-sensitivity"],
            f"multihost bench: the first {REFERENCE_PAIRS} groups differ "
            "from the JAX package's digest")
    kinds = {"artifact": NINEMER_KERNELS | {"dedup_counts",
                                             "tree_aggregate"},
             "bench": NINEMER_KERNELS | {"dedup_counts", "tree_aggregate"},
             "tryptic": TRYPTIC_KERNELS | {"dedup_counts",
                                           "tree_aggregate"}}
    for rep in reports:
        for name, need in kinds.items():
            c = rep["cells"][name]
            zero = sorted(k for k in need if c["launches"][k] == 0)
            require(not zero, f"multihost rank {rep['rank']} {name}: "
                    f"kernels {zero} not launched")
            require(c["all_to_all_calls_a_step"] == 2,
                    f"multihost rank {rep['rank']} {name}: "
                    f"{c['all_to_all_calls_a_step']} all_to_all_single "
                    "calls a step, not one each way")
    for rep in reports:
        log(f"multihost rank {rep['rank']}: up in {rep['start_s']:.1f}s, "
            f"its {rep['artifact_rows_gb']:.2f} GB of the artifact loaded "
            f"in {rep['artifact_load_s']:.1f}s; " + "; ".join(
                f"{name} {c['step_ms']:.1f} ms a step ({c['steps']} steps "
                f"of {c['rank_rows']} rows), launches " + ", ".join(
                    f"{k} {v}" for k, v in c["launches"].items() if v)
                + f"; split " + ", ".join(
                    f"{k} {v:.2f}" for k, v in c["split_ms"].items())
                + f" ms; sent {c['bytes_sent_a_step'] / 1e6:.1f} MB a step"
                for name, c in rep["cells"].items())
            + f"; {rep['seconds']:.1f}s in all")
    log("multihost: NCCL is not shown here: it refuses two ranks on one GPU "
        "(duplicate GPU), so the ranks ran gloo, the exchange staged "
        "through pinned host memory")
    log(f"multihost: {MULTIHOST_RANKS} ranks x {MULTIHOST_LOCAL} devices: "
        f"taxa == phase mesh's (the 16-shard artifact), == phase tryptic's "
        f"(8 peptide shards), == phase main's and the digest (the bench "
        f"index in 4 shards) on {P} groups; frequencies == rank counts")
    RESULT["phases"]["multihost"] = dict(
        ranks=MULTIHOST_RANKS, local_devices=MULTIHOST_LOCAL,
        backend="gloo", shards=SHARDS,
        peptide_shards=MULTIHOST_PEPTIDE_SHARDS, reports=reports,
        nccl="not shown: NCCL refuses two ranks on one GPU",
        seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------- #
# Phase 5a: the FragGeneScan++ protein path (MOCK_FGSPP)
# ---------------------------------------------------------------------- #

FGSPP_ORDER = ("high-precision", "max-precision", "tryptic-precision",
               "tryptic-sensitivity")
# the protein step's batch (analyse_protein_groups' cap)
GENE_BATCH = 1024


def _fgspp_config_dir(world):
    """A config dir under .smoke_tmp/ as umgap-setup lays one out: the
    mock as FGSpp/FGSpp with an empty FGSpp/train/, and a data version of
    symlinks to the command line's taxonomy, 9-mer index and the phase
    tryptic peptide index."""
    conf = os.path.join(TMP_DIR, "fgspp_conf")
    fg = os.path.join(conf, "FGSpp")
    os.makedirs(os.path.join(fg, "train"))
    with open(os.path.join(fg, "FGSpp"), "w") as f:
        f.write(MOCK_FGSPP)
    os.chmod(os.path.join(fg, "FGSpp"), 0o755)
    taxtsv, index = _cli_files(world)
    pindex = os.path.join(TMP_DIR, "tryptic.npz")
    if not os.path.exists(pindex):
        world["ptable"].save(pindex)
    version = os.path.join(conf, "2026-10")
    os.makedirs(version)
    for name, target in (("taxons.tsv", taxtsv), ("ninemer.npz", index),
                         ("tryptic.npz", pindex)):
        os.symlink(target, os.path.join(version, name))
    return conf


def fgspp_path_kernels(config):
    """The kernels of a preset's FGSpp path: K1P, K2, K3 (hits), K4 and
    K6 for the 9-mer presets (all tree/lca*); K8, K4 and K6 (rmq/mrtl)
    after the host digest for the tryptic ones."""
    if is_tryptic(config):
        return {"probe_peptide", "dedup_counts", "tree_aggregate"}
    return {"proteins_to_kmers", "probe_kmer", "seedextend_mask",
            "dedup_counts", "tree_aggregate"}


# K1P's launch floor: a call on this many lanes of the gene batch (one
# block's lanes in the first design, 32 lanes a block)
K1P_FLOOR_LANES = 32


def _k1p_stats(torch, world, an, groups):
    """K1P on one gene batch (the first GENE_BATCH groups at the
    analyser's lanes and width) against its plain version: event, device
    and plain ms, and its bound (the lanes' residues and lengths read
    once, hi, lo and valid written once; a shift and an or a residue of
    each window)."""
    from umgap_tpu_torch.ops import kmers
    from umgap_tpu_torch.pipeline.proteins import encode_protein_groups

    aa, lens = encode_protein_groups(groups[:GENE_BATCH], an.ends,
                                     an.read_length)
    N, P = aa.shape[0] * aa.shape[1], aa.shape[2]
    a = torch.from_numpy(aa.reshape(N, P)).to(world["dev"])
    ln = torch.from_numpy(lens.reshape(N)).to(world["dev"])
    err = compare(torch, f"K1P ({N}, {P})", kmers.proteins_to_kmers(a, ln),
                  kmers.pack_windows_batch(a, ln))
    # P < 9, 7 and 8 windows a lane (the byte and the register fold),
    # unaligned lanes (by 3: the byte fold; by 8: the register fold) at
    # the batch's lane count; a few lanes of 30,000 residues
    for n, Pe, off in ((N, 5, 0), (N, 9, 0), (N, 15, 0), (N, 16, 0),
                       (N, P, 3), (N, P, 8), (5, 30000, 0)):
        big = torch.randint(0, 32, (n * Pe + off,), dtype=torch.uint8,
                            device=world["dev"])
        ae = big[off:].view(n, Pe)
        le = torch.randint(0, Pe + 2, (n,), dtype=torch.int32,
                           device=world["dev"])
        err = max(err, compare(torch, f"K1P ({n}, {Pe}) offset {off}",
                               kmers.proteins_to_kmers(ae, le),
                               kmers.pack_windows_batch(ae, le)))
    W = max(P - 8, 1)

    def k1p():
        return kmers.proteins_to_kmers(a, ln)

    def floor():  # one block's lanes of the first design: the launch floor
        return kmers.proteins_to_kmers(a[:K1P_FLOOR_LANES],
                                       ln[:K1P_FLOOR_LANES])

    b, by = bound(N * P + 4 * N + N * W * 9, N * W * 9 * 2)
    return dict(ms=cuda_ms(torch, k1p, reps=50),
                device_ms=device_ms(torch, k1p, reps=50),
                floor_device_ms=device_ms(torch, floor, reps=50),
                floor_lanes=K1P_FLOOR_LANES,
                plain_ms=cuda_ms(torch, lambda: kmers.pack_windows_batch(
                    a, ln), reps=20),
                bound_ms=b, bound_by=by, library_ms=None, lanes=N, width=P,
                max_abs_err=err, equal=err == 0.0)


def phase_fgspp(torch, world):
    """The FGSpp protein path, as a user with FGSpp installed runs it,
    with MOCK_FGSPP in its place: the 32,768 bench pairs (headers s{i}/1
    and s{i}/2) through ``predict_genes`` and ``group_genes``, then the
    two 9-mer FGSpp presets through ``ProteinAnalyser`` and the two
    tryptic ones through ``analyse_tryptic_protein_groups``; the kernel
    path held to the plain path and the first 1,024 groups to umgap_tpu's
    digests, launch counts reset before the run; the protein step's CUDA
    kernels a batch and stage table; K1P alone on one gene batch; and the
    command line with ``-c`` (no --taxons, no --index) and ``-z``, equal
    to the library path. Returns (launches, K1P's stats)."""
    from umgap_tpu_torch import fgspp, kernels
    from umgap_tpu_torch.pipeline import proteins
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    t_phase = time.perf_counter()
    conf = _fgspp_config_dir(world)
    fg = fgspp.find_fgspp(conf)
    require(fg is not None, f"fgspp: no FGSpp found under {conf}")
    t0 = time.perf_counter()
    groups = list(fgspp.group_genes(fgspp.predict_genes(
        *fg, fgspp_records(world["reads"]))))
    mock_s = time.perf_counter() - t0
    genes = sum(len(p) for _h, p in groups)
    require(REFERENCE_PAIRS < len(groups) < world["P"],
            f"fgspp: {len(groups)} gene groups from {world['P']} pairs")
    headers = [h for h, _p in groups]
    cache = {}

    def run(preset):
        if preset in TRYPTIC_PRESETS:
            res = proteins.analyse_tryptic_protein_groups(
                groups, None, None, TRYPTIC_PRESETS[preset],
                batch_size=GENE_BATCH, dtax=world["dtax"],
                dtable=world["pdtable"], step_cache=cache)
        else:
            res = proteins.analyse_protein_groups(
                groups, None, None, PRESETS[preset], batch_size=GENE_BATCH,
                dtax=world["dtax"], dtable=world["dtable"],
                analyser_cache=cache)
        out = [(h, t) for h, t in res]
        require([h for h, _t in out] == headers,
                f"fgspp {preset}: headers out of order")
        return np.array([t for _h, t in out], dtype=np.int64)

    for preset in FGSPP_ORDER:  # warm: analysers built, kernels loaded
        run(preset)
    torch.cuda.synchronize()
    kernels.reset_launches()
    taxa, walls = {}, {}
    for preset in FGSPP_ORDER:
        t0 = time.perf_counter()
        taxa[preset] = run(preset)
        walls[preset] = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"fgspp path launches: {launches}")
    phase = dict(pairs=world["P"], groups=len(groups), genes=genes,
                 mock_s=mock_s, launches=launches, presets={})
    for preset in FGSPP_ORDER:
        cfg = (TRYPTIC_PRESETS if preset in TRYPTIC_PRESETS
               else PRESETS)[preset]
        for k in fgspp_path_kernels(cfg):
            require(launches[k] > 0,
                    f"fgspp {preset}: kernel {k} was not launched")
        with kernels.plain_versions():
            plain = run(preset)
        got = taxa[preset]
        require(np.array_equal(got, plain),
                f"fgspp {preset}: kernel taxa differ from plain taxa in "
                f"{int((got != plain).sum())} of {len(got)} groups")
        require((got >= 1).all(), f"fgspp {preset}: bad output")
        require(taxa_digest(got[:REFERENCE_PAIRS])
                == REFERENCE_DIGESTS[f"fgspp/{preset}"],
                f"fgspp {preset}: the first {REFERENCE_PAIRS} groups differ "
                "from the JAX package's reference taxa")
        phase["presets"][preset] = dict(
            wall_s=walls[preset], records_per_s=len(groups) / walls[preset],
            records_per_s_with_mock=len(groups) / (walls[preset] + mock_s),
            checksum=int(got.sum()), distinct_taxa=int(len(np.unique(got))),
            unassigned=int((got == 1).sum()))
        log(f"fgspp {preset}: kernel == plain on {len(groups)} groups, == "
            f"reference on {REFERENCE_PAIRS}; {walls[preset]:.3f} s "
            f"({len(groups) / walls[preset]:.0f} records/s; the mock took "
            f"{mock_s:.3f} s more)")
    for k in ("proteins_to_kmers", "probe_kmer", "seedextend_mask",
              "dedup_counts", "tree_aggregate", "probe_peptide"):
        require(launches[k] > 0, f"fgspp: kernel {k} was not launched")
    require(launches["reads_to_kmers"] == 0
            and launches["reads_to_peptides"] == 0,
            "fgspp: the protein path translated reads")

    # the protein step on one gene batch: its CUDA kernels and stages
    an = next(a for a in cache.values()
              if isinstance(a, proteins.ProteinAnalyser)
              and a.config.name == "high-precision")
    inputs = []
    for i in range(0, len(groups) - GENE_BATCH + 1, GENE_BATCH):
        aa, lens = proteins.encode_protein_groups(
            groups[i:i + GENE_BATCH], an.ends, an.read_length)
        inputs.append((torch.from_numpy(aa).to(world["dev"]),
                       torch.from_numpy(lens).to(world["dev"]),
                       an.read_length))
    phase.update(analyser=dict(batch=an.batch_size, lanes=an.ends,
                               width=an.read_length,
                               k_max_wide=an._exact_kmax(),
                               overflow_reads=an.overflow_reads),
                 batch_cuda_launches=batch_cuda_launches(
                     torch, world, an, inputs=inputs[0]),
                 stages=stage_table(torch, world, an, inputs=inputs))
    k1p = _k1p_stats(torch, world, an, groups)
    log(f"K1P: {k1p['lanes']} lanes x {k1p['width']} equal to plain; "
        f"{k1p['ms']:.4f} ms ({k1p['device_ms']:.4f} device; floor on "
        f"{k1p['floor_lanes']} lanes {k1p['floor_device_ms']:.4f}), bound "
        f"{k1p['bound_ms']:.5f} ({k1p['bound_by']}), plain "
        f"{k1p['plain_ms']:.4f}; {phase['batch_cuda_launches']['kernels']} "
        "CUDA kernels a protein step")

    # the command line: -c discovery, FGSpp under it, -z
    paths = [os.path.join(TMP_DIR, f"F{e + 1}.fq") for e in (0, 1)]
    ends = iter(fgspp_records(world["reads"]))
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for (h1, s1), (h2, s2) in zip(ends, ends):  # s{i}/1, s{i}/2
            f1.write(f"@{h1}\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@{h2}\n{s2}\n+\n{'I' * len(s2)}\n")
    outs = {"high-precision": os.path.join(TMP_DIR, "fgspp-hp.fa"),
            "tryptic-precision": os.path.join(TMP_DIR, "fgspp-tp.fa.gz")}
    cmd = [sys.executable, "-m", "umgap_tpu_torch", "analyse", "-c", conf,
           "-t", "high-precision", "-1", paths[0], "-2", paths[1], "-o",
           outs["high-precision"], "-t", "tryptic-precision", "-1",
           paths[0], "-2", paths[1], "-z", "-o", outs["tryptic-precision"]]
    t0 = time.perf_counter()
    # VERBOSE: the CLI says on stderr that FGSpp predicted the genes
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, VERBOSE="1"))
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"fgspp CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    require("gene prediction via FGSpp" in proc.stderr,
            "fgspp CLI: FGSpp was not run")
    import gzip

    for preset, out in outs.items():
        with (gzip.open(out, "rt") if out.endswith(".gz")
              else open(out)) as f:
            got = f.read()
        want = "".join(f">{h}\n{t}\n" for h, t in zip(headers,
                                                      taxa[preset]))
        require(got == want,
                f"fgspp CLI {preset}: records differ from the library's")
    phase.update(k1p=k1p, cli_s=cli_s,
                 seconds=time.perf_counter() - t_phase)
    RESULT["phases"]["fgspp"] = phase
    log(f"fgspp: {len(groups)} groups of {genes} genes from {world['P']} "
        f"pairs (mock {mock_s:.2f} s); CLI -c / -z records equal to the "
        f"library's in {cli_s:.1f} s")
    return launches, k1p


# ---------------------------------------------------------------------- #
# Phase 5b: file ingest through the three tiers of the command line
# ---------------------------------------------------------------------- #

INGEST_COPIES = 8  # 262,144 pairs, about 114 MB of FASTQ
INGEST_PRESET = "high-sensitivity"
# max-sensitivity's seeds of 2 keep more than 64 distinct taxa in the
# ladder's 4,096 bp groups (high-sensitivity's seeds of 3 keep fewer)
LADDER_PRESET = "max-sensitivity"
LADDER_GROUPS = 128


def _fastq_text(reads, e, prefix):
    """One end's FASTQ bytes of (P, 2, L) code rows, headers
    ``@{prefix}{i}/{e + 1}``."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    seqs = lut[np.minimum(reads[:, e], 4)]
    qual = b"I" * seqs.shape[1]
    return b"".join(b"@%s%d/%d\n%s\n+\n%s\n" % (prefix, i, e + 1,
                                                  seqs[i].tobytes(), qual)
                    for i in range(len(seqs)))


def _ladder_reads(reads, n, seed=31):
    """``n`` read pairs of 100 to 4,096 bp, each end the concatenation of
    consecutive bench reads of that end (so a 4,096 bp group carries the
    planted taxa of 41 bench pairs a end, more than 64 distinct), cut to
    its length: a quarter up to 160 bp, a quarter up to 256, a quarter
    up to 1,024, the rest up to 4,095, and every eighth group at 4,096
    on both ends. Returns (P, 2, 4096) codes (N-padded) and lengths."""
    rng = np.random.default_rng(seed)
    P, _e, L0 = reads.shape
    pieces = -(-4096 // L0)
    idx = (np.arange(n)[:, None] * pieces + np.arange(pieces)) % P
    codes = reads[idx].transpose(0, 2, 1, 3).reshape(n, 2, pieces * L0)
    codes = np.ascontiguousarray(codes[:, :, :4096])
    tops = np.array([160, 256, 1024, 4095])[np.arange(n) * 4 // n]
    lens = np.stack([rng.integers(100, tops + 1),
                     rng.integers(100, tops + 1)], axis=1).astype(np.int32)
    lens[::8] = 4096
    codes[np.arange(4096)[None, None, :] >= lens[:, :, None]] = 4
    return codes, lens


class _TimedFile:
    """A text file whose writes are timed (the host split's "write")."""

    def __init__(self, f, acc):
        self.f, self.acc = f, acc

    def write(self, text):
        t0 = time.perf_counter()
        self.f.write(text)
        self.acc["write"] += time.perf_counter() - t0


def phase_ingest(torch, world):
    """FASTQ files to records through the command line's three ingest
    tiers (``cli.run_sample_ring``, ``run_sample_stream``,
    ``run_sample_fallback``), driven in this process as the CLI drives
    them, high-sensitivity at the CLI's defaults (--read-length 160,
    16,384-pair batches): records byte-equal across the tiers and to
    ``Analyser.analyse_arrays``, gzip equal to plain, the ladder sample
    (100-4,096 bp, the wide program at K = 16,392, 64 groups a batch)
    with kernel records equal to plain records and where its time goes
    (``ladder_wide``); file-to-records pairs/s of the ring (plain,
    gzip) and of the Python tier, the host split and the device-busy
    share of a ring window; and the command line in a subprocess on
    gzipped pairs."""
    import gzip
    import io
    import statistics
    import threading

    from umgap_tpu_torch import cli, kernels
    from umgap_tpu_torch.io import native
    from umgap_tpu_torch.pipeline import runner
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    reads, P, L = world["reads"], world["P"], world["L"]
    t0 = time.perf_counter()
    native.ensure_built()
    build_s = time.perf_counter() - t0

    # ---- inputs: one copy (32,768 pairs) and eight, plain and gzipped - #
    paths = {}
    texts = [[_fastq_text(reads, e, b"c%d_" % c) for e in (0, 1)]
             for c in range(INGEST_COPIES)]
    for tag, copies in (("one", 1), ("all", INGEST_COPIES)):
        paths[tag] = [os.path.join(TMP_DIR, f"{tag}_R{e + 1}.fq")
                      for e in (0, 1)]
        paths[tag + "_gz"] = [p + ".gz" for p in paths[tag]]
        for e in (0, 1):
            with open(paths[tag][e], "wb") as f:
                for c in range(copies):
                    f.write(texts[c][e])

    def gz(src, dst):
        with open(src, "rb") as f, gzip.open(dst, "wb", compresslevel=6) as g:
            shutil.copyfileobj(f, g, 1 << 22)

    jobs = [threading.Thread(target=gz, args=(s, d))
            for tag in ("one", "all")
            for s, d in zip(paths[tag], paths[tag + "_gz"])]
    t0 = time.perf_counter()
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    gzip_s = time.perf_counter() - t0
    del texts
    paths["ladder"], ladder_lens = _ladder_paths(world)
    sizes = {k: sum(os.path.getsize(p) for p in v) for k, v in paths.items()}

    session = _cli_session(world)

    def sample(tag, preset=INGEST_PRESET):
        return dict(type=preset, first=paths[tag][0],
                    second=paths[tag][1], output=None)

    def records(tier, tag, preset=INGEST_PRESET):
        buf = io.StringIO()
        n = cli.write_batches(buf, tier(session, sample(tag, preset)))
        return n, buf.getvalue()

    def launched(tier, tag):
        kernels.reset_launches()
        n, text = records(tier, tag)
        torch.cuda.synchronize()
        return n, text, kernels.launch_counts()

    cfg = PRESETS[INGEST_PRESET]
    need = path_kernels(cfg)
    phase = dict(host_library_build_s=build_s, gzip_write_s=gzip_s,
                 file_bytes=sizes, preset=INGEST_PRESET)

    # ---- the three tiers on one copy: byte-equal, = analyse_arrays ---- #
    records(cli.run_sample_ring, "one")  # warm the programs
    got, launches = {}, {}
    for name, tier in (("ring", cli.run_sample_ring),
                       ("chunk", cli.run_sample_stream),
                       ("python", cli.run_sample_fallback)):
        n, text, launches[name] = launched(tier, "one")
        require(n == P, f"ingest {name}: {n} records for {P} pairs")
        for k in need:
            require(launches[name][k] > 0,
                    f"ingest {name}: kernel {k} was not launched")
        got[name] = text
    require(got["ring"] == got["chunk"] == got["python"],
            "ingest: the tiers' records differ")
    headers = [f"c0_{i}" for i in range(P)]
    an = _analyser(world, cfg, read_length=160)
    want = "".join(f">{h}\n{t}\n" for h, t in an.analyse_arrays(
        headers, reads, np.full((P, 2), L, np.int32)))
    require(got["ring"] == want,
            "ingest: records differ from Analyser.analyse_arrays")
    n, text = records(cli.run_sample_ring, "one_gz")
    require(text == got["ring"], "ingest: gzip records differ from plain")
    phase["launches"] = launches

    # ---- eight copies: gzip equal to plain (digests) ------------------ #
    import hashlib

    digest = {}
    for tag in ("all", "all_gz"):
        n, text = records(cli.run_sample_ring, tag)
        require(n == P * INGEST_COPIES, f"ingest {tag}: {n} records")
        digest[tag] = hashlib.sha256(text.encode()).hexdigest()
    require(digest["all"] == digest["all_gz"],
            "ingest: gzip records differ from plain (eight copies)")
    phase["records_sha256"] = digest["all"]

    # ---- the ladder sample: 100-4,096 bp, kernel records = plain ------ #
    kernels.reset_launches()
    lad = sample("ladder", LADDER_PRESET)
    lbuf = io.StringIO()
    nl_ = cli.write_batches(lbuf, cli.run_sample(session, lad))
    torch.cuda.synchronize()
    lad_launch = kernels.launch_counts()
    widest = max(session.analysers.values(), key=lambda a: a.read_length)
    require(nl_ == LADDER_GROUPS, f"ladder: {nl_} records")
    require(widest.read_length == 4096 and widest._exact_kmax() == 16392,
            "ladder: no program at 4,096 bp with a wide K of 16,392")
    overflow = widest.overflow_reads
    require(overflow > 0, "ladder: no group re-routed to the wide program")
    # the sample is one chunk, so the ladder runs it at 4,096 bp alone
    for k in long_path_kernels(PRESETS[LADDER_PRESET]):
        require(lad_launch[k] > 0, f"ladder: kernel {k} was not launched")
    with kernels.plain_versions():
        pbuf = io.StringIO()
        cli.write_batches(pbuf, cli.run_sample(session, lad))
    require(lbuf.getvalue() == pbuf.getvalue(),
            "ladder: kernel records differ from plain records")
    _n, py_text = records(cli.run_sample_fallback, "ladder", LADDER_PRESET)
    require(py_text == lbuf.getvalue(),
            "ladder: the Python tier's records differ")
    phase["ladder"] = dict(preset=LADDER_PRESET, groups=LADDER_GROUPS,
                           width=widest.read_length,
                           wide_k=widest._exact_kmax(),
                           wide_batch=widest._wide_batch,
                           overflow_groups=overflow, launches=lad_launch,
                           lens=dict(min=int(ladder_lens.min()),
                                     max=int(ladder_lens.max())),
                           split=ladder_wide(torch, lambda: cli.write_batches(
                               io.StringIO(), cli.run_sample(session, lad))))
    require(widest._wide_batch == runner.WIDE_BATCH,
            f"ladder: the wide program takes {widest._wide_batch} groups a "
            f"batch at 4,096 bp, not {runner.WIDE_BATCH}")
    log(f"ingest ladder ({LADDER_PRESET}): {LADDER_GROUPS} groups of "
        f"100-4,096 bp at width {widest.read_length}, {overflow} through the "
        f"wide program (K = {widest._exact_kmax()}), kernel "
        f"records == plain == Python tier; launches {lad_launch}")

    # ---- file-to-records pairs/s: median of three windows -------------- #
    out_path = os.path.join(TMP_DIR, "ingest_out.fa")

    def window(tier, tag, min_s=STEADY_S):
        n = passes = 0
        t0 = time.perf_counter()
        while passes == 0 or time.perf_counter() - t0 < min_s:
            with open(out_path, "w") as h:
                n += cli.write_batches(h, tier(session, sample(tag)))
            passes += 1
        wall = time.perf_counter() - t0
        return dict(pairs_per_s=n / wall, pairs=n, seconds=wall,
                    passes=passes)

    wins = {name: [window(tier, tag) for _ in range(3)]
            for name, tier, tag in (
                ("ring_plain", cli.run_sample_ring, "all"),
                ("ring_gzip", cli.run_sample_ring, "all_gz"),
                ("python_plain", cli.run_sample_fallback, "one"))}
    rates = {name: dict(pairs_per_s=statistics.median(
        w["pairs_per_s"] for w in ws), windows=ws)
        for name, ws in wins.items()}
    # tryptic-sensitivity through the ring tier over the peptide index
    rates["ring_plain_tryptic_sensitivity"] = tryptic_ring_rate(
        world, paths["all"], out_path)
    phase["rates"] = rates
    log("ingest file-to-records pairs/s (median of 3 windows): " + ", ".join(
        f"{k} {v['pairs_per_s']:.0f}" for k, v in rates.items()))

    # ---- the host split of one ring window ----------------------------- #
    acc = dict(next=0.0, dispatch=0.0, drain=0.0, format=0.0, write=0.0)

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapper

    patches = [(native.NativeBatchStream, "next", "next"),
               (runner.Analyser, "_dispatch_packed", "dispatch"),
               (runner.Analyser, "_finalize_packed", "drain"),
               (native, "format_output", "format")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _k in patches]
    try:
        for obj, attr, key in patches:
            setattr(obj, attr, timed(getattr(obj, attr), key))
        n = passes = 0
        t0 = time.perf_counter()
        while passes == 0 or time.perf_counter() - t0 < STEADY_S:
            with open(out_path, "w") as h:
                n += cli.write_batches(_TimedFile(h, acc), cli.run_sample_ring(
                    session, sample("all")))
            passes += 1
        wall = time.perf_counter() - t0
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    split = {k: v for k, v in acc.items()}
    split["other"] = wall - sum(acc.values())
    phase["host_split"] = dict(seconds=split, wall_s=wall, pairs=n,
                               pairs_per_s=n / wall,
                               share={k: v / wall for k, v in split.items()})
    log(f"ingest ring window host split ({n} pairs in {wall:.2f} s): "
        + ", ".join(f"{k} {v:.3f} s ({v / wall:.0%})"
                    for k, v in split.items()))

    # ---- the device-busy share of one ring window ---------------------- #
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_w = window(cli.run_sample_ring, "all", min_s=2.0)
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    phase["profiled"] = dict(
        window=prof_w, device_s=dev_us / 1e6,
        busy_share=(dev_us / 1e6) / prof_w["seconds"] if dev_us else None,
        top=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top])
    log(f"ingest ring window profiled: device busy {dev_us / 1e6:.3f} s of "
        f"{prof_w['seconds']:.3f} s")

    # ---- the command line in a subprocess on the gzipped pair --------- #
    taxtsv, index = _cli_files(world)
    cli_out = os.path.join(TMP_DIR, "ingest_cli.fa")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
         taxtsv, "--index", index, "-t", INGEST_PRESET, "-1",
         paths["one_gz"][0], "-2", paths["one_gz"][1], "-o", cli_out,
         "--fgspp", "never"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"ingest CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(cli_out) as f:
        require(f.read() == got["ring"],
                "ingest CLI: gzipped records differ from the plain run's")
    phase["cli_gzip_s"] = cli_s
    phase["host_routes"] = _host_routes(torch, world)
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["ingest"] = phase
    log(f"ingest: three tiers byte-equal and equal to analyse_arrays on "
        f"{P} pairs, gzip == plain on {P * INGEST_COPIES}; CLI on gzip in "
        f"{cli_s:.1f} s; phase {phase['seconds']:.1f} s")


def tryptic_ring_rate(world, paths, out_path):
    """tryptic-sensitivity through the ring tier (``ring_rate``) over the
    bench tryptic index."""
    return ring_rate(world, paths, out_path, "tryptic-sensitivity")


def ring_rate(world, paths, out_path, preset):
    """``preset`` from the R1/R2 FASTQ ``paths`` to records through the
    command line's ring tier at its defaults (width 160, 16,384-pair
    batches) over the bench index of its family: the median pairs/s of
    three windows of at least STEADY_S, after one warm pass."""
    import statistics

    from umgap_tpu_torch import cli

    session = _cli_session(world)
    smp = dict(type=preset, first=paths[0], second=paths[1], output=None)

    def window(min_s=STEADY_S):
        n = passes = 0
        t0 = time.perf_counter()
        while passes == 0 or time.perf_counter() - t0 < min_s:
            with open(out_path, "w") as h:
                n += cli.write_batches(h, cli.run_sample_ring(session, smp))
            passes += 1
        wall = time.perf_counter() - t0
        return dict(pairs_per_s=n / wall, pairs=n, seconds=wall,
                    passes=passes)

    window(0.0)  # warm the program
    ws = [window() for _ in range(3)]
    return dict(pairs_per_s=statistics.median(w["pairs_per_s"] for w in ws),
                windows=ws)


# ---------------------------------------------------------------------- #
# Phase 5c: the 12,000 bp device width
# ---------------------------------------------------------------------- #

LONG12K_BP = 12000
LONG12K_RECORDS = 2048
LONG12K_ENDS = 120  # .bench_data read ends (100 bp) a record
LONG12K_SEED = 43  # the seeded permutations that draw them
LONG12K_PRESET = "high-sensitivity"
LONG12K_PLAIN = 8  # records also run through every stage's plain version


def _long_sample(world):
    """The 12,000 bp sample: LONG12K_RECORDS single-end records, each the
    concatenation of LONG12K_ENDS ``.bench_data`` read ends drawn in the
    order of seeded permutations (LONG12K_SEED) of all 65,536 ends, so that
    the planted 9-mer runs keep the bench's hit density. Returns codes
    (n, 1, 12,000) and lengths (n, 1)."""
    reads = world["reads"]
    P, E, L0 = reads.shape
    require(LONG12K_ENDS * L0 == LONG12K_BP,
            "long sample: the ends do not fill a record")
    ends = reads.reshape(P * E, L0)
    need = LONG12K_RECORDS * LONG12K_ENDS
    rng = np.random.default_rng(LONG12K_SEED)
    order = np.concatenate([rng.permutation(P * E)
                            for _ in range(-(-need // (P * E)))])[:need]
    codes = ends[order].reshape(LONG12K_RECORDS, 1, LONG12K_BP)
    return codes, np.full((LONG12K_RECORDS, 1), LONG12K_BP, np.int32)


def long_path(torch, world, check=True):
    """The 12,000 bp device width, by this code on any tree: the sample
    (``_long_sample``) through an ``Analyser`` (LONG12K_PRESET, single-end,
    read_length 12,000, the batch the CLI's ring tier runs for a sample
    of one batch, 2,048 here, the wide re-route on): one warm run, then
    a timed run (wall s, records/s) between a reset and a read of the
    launch counts, then a profiled run (device ms of K3, K4, K6 and of
    all kernels), one batch step's stage table and step peak memory.
    With ``check`` (this tree's script) also: the first LONG12K_PLAIN
    records held to every stage's plain version (the wide program's
    too), and ``python -m umgap_tpu_torch analyse`` on the sample as a
    FASTA file, its records equal to the Analyser's. (``long_rows``
    holds K3 and K4 to their plain versions on this batch.)"""
    import contextlib

    from umgap_tpu_torch import cli, kernels
    from umgap_tpu_torch.ops import encoding
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.runner import Analyser

    dev = world["dev"]
    codes, lens = _long_sample(world)
    n = len(codes)
    headers = [f"l{i}" for i in range(n)]
    B = cli._pow2_bucket(n, 64, max(64, BATCH))  # run_sample_ring's rule
    cfg = PRESETS[LONG12K_PRESET]

    def analyser(batch=B):
        return Analyser(None, None, cfg, batch_size=batch,
                        read_length=LONG12K_BP, ends=1, dtax=world["dtax"],
                        dtable=world["dtable"], device=dev)

    an = analyser()

    def run(a=an, k=n):
        a.reset()
        a.overflow_reads = 0
        return np.array([t for _h, t in a.analyse_arrays(
            headers[:k], codes[:k], lens[:k])], dtype=np.int64)

    run()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    overflow = an.overflow_reads
    prof = _profile_window(torch, run, 1)

    def kern(sub):
        ms = sum(v[0] for k, v in prof.items() if sub in k)
        return dict(device_ms=ms, launches=sum(v[1] for k, v in prof.items()
                                               if sub in k))

    out = dict(records=n, batch=B, width=LONG12K_BP,
               k_max_wide=an._exact_kmax(),
               wide_batch=an._wide_batch, overflow=overflow, wall_s=wall,
               records_per_s=n / wall, launches=launches,
               device_ms=sum(v[0] for v in prof.values()),
               k3=kern("seedextend"), k4=kern("dedup"), k6=kern("tree_"),
               top=sorted(((k, v[0], v[1]) for k, v in prof.items()),
                          key=lambda x: -x[1])[:10],
               checksum=int(got.sum()), distinct=int(len(np.unique(got))),
               unassigned=int((got == 1).sum()))
    wide_batches = -(-overflow // an._wide_batch)
    out["batches"] = 1 + wide_batches
    for k in ("k3", "k4", "k6"):
        out[k]["ms_per_launch"] = (out[k]["device_ms"] / out[k]["launches"]
                                   if out[k]["launches"] else None)

    # one batch step: stage table, peak memory, and K3's and K4's inputs
    dna4 = torch.from_numpy(encoding.pack_dna4(codes[:B])).to(dev)
    ln = torch.from_numpy(lens[:B]).to(dev)
    stage_ms = {}

    def timer(name):
        @contextlib.contextmanager
        def cm():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            b.synchronize()
            stage_ms.setdefault(name, []).append(a.elapsed_time(b))
        return cm()

    for _ in range(3):
        an.step(dna4, ln, LONG12K_BP, timer=timer)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    an.step(dna4, ln, LONG12K_BP)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out.update(stage_ms={k: float(np.median(v)) for k, v in stage_ms.items()},
               step_peak_gb=peak / 1e9, step_above_base_gb=(peak - base) / 1e9)
    log(f"12,000 bp path ({LONG12K_PRESET}): {n} records in batches of {B}, "
        f"{overflow} through the wide program (K = {an._exact_kmax()}, "
        f"{an._wide_batch} a batch): wall {wall:.3f} s, "
        f"{n / wall:.0f} records/s; device {out['device_ms']:.2f} ms, K3 "
        f"{out['k3']['device_ms']:.3f} ms / "
        f"{launches.get('seedextend_rows', 0)}"
        f", K4 {out['k4']['device_ms']:.3f} ms / "
        f"{launches.get('dedup_rows', 0)}, K6 {out['k6']['device_ms']:.3f} ms"
        f" / {launches['tree_aggregate']} launches; stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["stage_ms"].items())
        + f" ms; step peak {peak / 1e9:.2f} GB")
    if not check:
        return out

    # the first records through every stage's plain version (the wide
    # program's batch then follows the plain versions' (B, K, K) bound)
    with kernels.plain_versions():
        want = run(analyser(batch=64), LONG12K_PLAIN)
    require(np.array_equal(got[:LONG12K_PLAIN], want),
            f"12,000 bp path: kernel records differ from plain records in "
            f"{int((got[:LONG12K_PLAIN] != want).sum())} of {LONG12K_PLAIN}")
    require(got.shape == (n,) and (got >= 1).all() and out["distinct"] > 1,
            "12,000 bp path: bad output")

    # the command line on the sample as a FASTA file
    taxtsv, index = _cli_files(world)
    fa = os.path.join(TMP_DIR, "long.fa")
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(fa, "wb") as f:
        for i in range(n):
            f.write(b">l%d\n%s\n" % (i, lut[codes[i, 0]].tobytes()))
    cli_out = os.path.join(TMP_DIR, "long_cli.fa")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
         taxtsv, "--index", index, "-t", LONG12K_PRESET, "--read-length",
         str(LONG12K_BP), "-1", fa, "-o", cli_out, "--fgspp", "never"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    out["cli_s"] = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"12,000 bp CLI exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(cli_out) as f:
        require(f.read() == "".join(f">{h}\n{t}\n"
                                    for h, t in zip(headers, got.tolist())),
                "12,000 bp CLI: records differ from the Analyser's")
    log(f"12,000 bp path: kernel records == plain on the first "
        f"{LONG12K_PLAIN}; CLI records == Analyser's ({out['cli_s']:.1f} s)")
    return out


def phase_long(torch, world):
    """The 12,000 bp device width (``long_path``): its launch counts must
    show K3's and K4's row kernels and every kernel of the preset's
    path. Returns the launch counts."""
    from umgap_tpu_torch.pipeline.fused import PRESETS

    t_phase = time.perf_counter()
    out = long_path(torch, world, check=True)
    launches = out["launches"]
    for k in long_path_kernels(PRESETS[LONG12K_PRESET]):
        require(launches[k] > 0,
                f"12,000 bp path: kernel {k} was not launched")
    require(out["overflow"] > 0,
            "12,000 bp path: no record took the wide program")
    out["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["long"] = out
    return launches


HOST_ROUTE_GROUPS = 2048  # the tryptic sample
LONG_GROUPS = 512  # the 9-mer sample: one group of 6,000 bp among them
LONG_BP = 6000


def _long_reads(reads, n, length, offset):
    """``n`` ends of ``length`` bp, each the concatenation of consecutive
    bench reads of end 1 from ``offset`` on."""
    P, _e, L0 = reads.shape
    pieces = -(-length // L0)
    idx = (offset + np.arange(n)[:, None] * pieces + np.arange(pieces)) % P
    return reads[idx, 0].reshape(n, -1)[:, :length]


def _host_routes(torch, world):
    """The command line's two host routes against device routes, in
    process through ``cli.run_sample``: a tryptic-sensitivity sample with
    records beyond --read-length (the host-digest route) against the same
    sample at a --read-length that holds them (the device digest), and a
    high-sensitivity sample with one 6,000 bp group at the defaults (the
    exact long-record route) against the same sample at --read-length
    8,192 (the device, K = 32,772 wide program). Records must be equal;
    returns the routes' rates."""
    import io

    from umgap_tpu_torch import cli
    from umgap_tpu_torch.pipeline.fused import PRESETS

    lut = np.frombuffer(b"ACGTN", np.uint8)
    reads = world["reads"]

    def write(tag, ends):
        paths = [os.path.join(TMP_DIR, f"{tag}_R{e + 1}.fq") for e in (0, 1)]
        for e, path in enumerate(paths):
            with open(path, "wb") as f:
                for i, seq in enumerate(ends[e]):
                    s_ = lut[seq].tobytes()
                    f.write(b"@h%d/%d\n%s\n+\n%s\n" % (
                        i, e + 1, s_, b"I" * len(s_)))
        return paths

    def run(table, dtable, read_length, tag, preset, tier=None):
        session = _cli_session(world, read_length,
                               {cli._is_tryptic(preset): (table, dtable)})
        smp = dict(type=preset, first=paths[tag][0], second=paths[tag][1],
                   output=None)
        buf = io.StringIO()
        t0 = time.perf_counter()
        n = cli.write_batches(buf, (tier or cli.run_sample)(session, smp))
        return n, buf.getvalue(), time.perf_counter() - t0

    out, paths = {}, {}
    # tryptic: every 16th group's end 1 is 200 bp
    n = HOST_ROUTE_GROUPS
    ends = [list(reads[:n, 0]), list(reads[:n, 1])]
    for i in range(0, n, 16):
        ends[0][i] = np.concatenate([reads[i, 0], reads[i + 1, 0]])
    paths["tryptic"] = write("route_tryptic", ends)
    pt, pdt = world["ptable"], world["pdtable"]
    preset = "tryptic-sensitivity"
    got_n, host, _s = run(pt, pdt, 160, "tryptic", preset)
    require(got_n == n, f"host-digest route: {got_n} records for {n}")
    _n, host2, host_s = run(pt, pdt, 160, "tryptic", preset,
                            cli.run_sample_fallback)
    _n, dev_text, dev_s = run(pt, pdt, 256, "tryptic", preset)
    require(host == host2 == dev_text, "host-digest route: records differ "
            "from the device digest's at --read-length 256")
    out["tryptic_host_digest"] = dict(
        groups=n, long_groups=len(range(0, n, 16)), seconds=host_s,
        groups_per_s=n / host_s, device_route_s=dev_s)
    # 9-mer: one 6,000 bp group among 100 bp ones
    n = LONG_GROUPS
    ends = [list(reads[:n, 0]), list(reads[:n, 1])]
    ends[0][n // 3] = _long_reads(reads, 1, LONG_BP, 1000)[0]
    paths["ninemer"] = write("route_ninemer", ends)
    t, dt = world["table"], world["dtable"]
    preset = "high-sensitivity"
    got_n, host, host_s = run(t, dt, 160, "ninemer", preset)
    require(got_n == n, f"long-record route: {got_n} records for {n}")
    _n, dev_text, dev_s = run(t, dt, 8192, "ninemer", preset)
    require(host == dev_text, "long-record route: records differ from the "
            "device's at --read-length 8192")
    # the route's own rate: 8 groups of 6,000 bp a end
    code = [list(x) for x in zip(_long_reads(reads, 8, LONG_BP, 5000),
                                 _long_reads(reads, 8, LONG_BP, 9000))]
    groups = [[lut[e].tobytes().decode() for e in g] for g in code]
    cache = {}
    t0 = time.perf_counter()
    taxa = [cli._analyse_long_group_host(g, PRESETS[preset], 2, world["tax"],
                                         t, cache) for g in groups]
    route_s = time.perf_counter() - t0
    out["ninemer_long_record"] = dict(
        groups=n, sample_seconds=host_s, device_route_s=dev_s,
        route_groups=len(groups), route_seconds=route_s,
        groups_per_s=len(groups) / route_s, route_taxa=taxa)
    log(f"host routes: tryptic host digest {out['tryptic_host_digest']['groups_per_s']:.0f} "
        f"groups/s (records == the device digest's at 256 bp); 9-mer long "
        f"record {len(groups) / route_s:.2f} groups/s of 2 x {LONG_BP} bp "
        "(records == the device's at 8,192 bp)")
    return out


# ---------------------------------------------------------------------- #
# Phase 6: the Euler/RMQ aggregations
# ---------------------------------------------------------------------- #

# K9 past the main path's width: K9_GROUPS ``_dense_hits`` groups of 65 to
# K valid hits at each K (the wide program's at 100 and 160 bp, and
# 4,104 of 2,048 bp reads)
K9_WIDE = (408, 648, 4104)
K9_GROUPS = 8


def _k9_inputs(torch, world, an):
    """K9's arguments on the path: one 16,384-pair batch step of the
    Analyser ``an`` with ``rmq_aggregate`` wrapped to keep its call.
    Returns (strategy, dtax, euler, utaxa, ucounts, uvalid, factor,
    snap, ordered)."""
    from umgap_tpu_torch.agg import device_rmq as prmq

    calls, k9 = [], prmq.rmq_aggregate

    def spy(*args, **kw):
        calls.append(args)
        return k9(*args, **kw)

    prmq.rmq_aggregate = spy
    try:
        batch_launches(torch, world, an)
    finally:
        prmq.rmq_aggregate = k9
    require(len(calls) == 1 and len(calls[0]) == 9,
            f"K9 inputs: {len(calls)} calls a batch step")
    return calls[0]


def _k9_bound(torch, dtax, strategy, utaxa, uvalid):
    """K9's bound on this data, bytes: the mask read whole, the valid
    slots' ids (and counts for hybrid), the table entries each distinct
    valid (clamped) id needs once (its ``first`` entry for lca*, its row
    of [depth | ancestors] for hybrid), 4 bytes written a group."""
    B, K = utaxa.shape
    size = dtax.geom.shape[0]
    nvalid = int(uvalid.sum())
    distinct = int(torch.unique(utaxa[uvalid].clamp(0, size - 1)).numel())
    row = 4 if strategy == "lca*" else 4 * dtax.geom.shape[1]
    return bound(B * K + nvalid * (4 if strategy == "lca*" else 8)
                 + distinct * row + B * 4, 0)


def k9_cells(torch, world, euler, inputs, check=True):
    """K9 on each strategy's own inputs from the path (``inputs``: the
    arguments ``_k9_inputs`` kept, one batch's K4 output at K = 64) and
    on K9_GROUPS ``_dense_hits`` groups at each K of K9_WIDE: event ms,
    device ms, the bound from this run's data and the share; at the path
    shape also without the snap table, with no slot valid (the floor)
    and on the dense batches of 17-64 and of 64 valid hits. With
    ``check`` each result is held to rmq_aggregate_plain (also every
    slot valid) and the plain version timed. Returns {strategy: stats,
    "wide": {K: {strategy: stats}}, "max_abs_err": e}."""
    from umgap_tpu_torch.agg import device_rmq as prmq

    dtax = world["dtax"]
    out, err = {}, 0.0
    for strat in RMQ_STRATEGIES:
        _s, _d, _e, u, c, v, f, snap, ordered = inputs[strat]
        B, K = u.shape
        every, none = torch.ones_like(v), torch.zeros_like(v)
        dense = {n: _dense_hits(torch, dtax, B, K, lo)
                 for n, lo in (("dense", 17), ("full", K))}

        def k9(h=None, vv=None, sn=snap, plain=False, strat=strat, u=u,
               c=c, v=v, f=f):
            fn = prmq.rmq_aggregate_plain if plain else prmq.rmq_aggregate
            uu, cc, v2 = h or (u, c, v)
            return fn(strat, dtax, euler, uu, cc, v2 if vv is None else vv,
                      f, sn)

        if check:
            err = max(err, compare(torch, f"K9 {strat} path", k9(),
                                   k9(plain=True)),
                      compare(torch, f"K9 {strat} path, no snap",
                              k9(sn=None), k9(sn=None, plain=True)),
                      compare(torch, f"K9 {strat} every slot valid",
                              k9(vv=every), k9(vv=every, plain=True)),
                      compare(torch, f"K9 {strat} no slot valid",
                              k9(vv=none), k9(vv=none, plain=True)),
                      *(compare(torch, f"K9 {strat} {n}", k9(h=h),
                                k9(h=h, plain=True))
                        for n, h in dense.items()))
        dm = device_ms(torch, k9)
        b, by = _k9_bound(torch, dtax, strat, u, v)
        out[strat] = dict(
            ms=cuda_ms(torch, k9), device_ms=dm, bound_ms=b, bound_by=by,
            share=b / dm if dm else None, shape=[B, K],
            valid_per_group=float(v.sum(dim=1).float().mean()),
            bare_device_ms=device_ms(torch, lambda: k9(sn=None)),
            floor_device_ms=device_ms(torch, lambda: k9(vv=none)),
            **{n + "_device_ms": device_ms(torch, lambda h=h: k9(h=h))
               for n, h in dense.items()},
            plain_ms=(cuda_ms(torch, lambda: k9(plain=True), reps=2)
                      if check else None), library_ms=None)
    wide = {}
    for K in K9_WIDE:
        u, c, v = _dense_hits(torch, dtax, K9_GROUPS, K, 65, seed=11)
        row = {"valid_per_group": v.sum(dim=1).tolist()}
        for strat in RMQ_STRATEGIES:
            def k9w(plain=False, strat=strat):
                fn = prmq.rmq_aggregate_plain if plain else \
                    prmq.rmq_aggregate
                return fn(strat, dtax, euler, u, c, v, 0.25, dtax.snap_valid)

            if check:
                err = max(err, compare(torch, f"K9 {strat} K={K}", k9w(),
                                       k9w(True)))
            dm, dby = device_ms(torch, k9w, reps=2, by=True)
            b, by = _k9_bound(torch, dtax, strat, u, v)
            row[strat] = dict(ms=cuda_ms(torch, k9w, reps=2), device_ms=dm,
                              device_ms_by=dby, bound_ms=b, bound_by=by,
                              share=b / dm if dm else None)
        wide[K] = row
    out.update(wide=wide, max_abs_err=err)
    log("K9 device ms (bound): " + "; ".join(
        f"{s} {fmt_ms(out[s]['device_ms'])} ({out[s]['bound_ms']:.5f}), "
        f"floor {fmt_ms(out[s]['floor_device_ms'])}" for s in RMQ_STRATEGIES)
        + "; wide " + "; ".join(
            f"K={K} " + ", ".join(f"{s} {fmt_ms(r[s]['device_ms'])}"
                                  for s in RMQ_STRATEGIES)
            for K, r in wide.items()))
    return out


def _rmq_batches(torch, world):
    """The workload as packed batches on the card and their lengths."""
    from umgap_tpu_torch.ops import encoding

    dev, P, L = world["dev"], world["P"], world["L"]
    batches = [torch.from_numpy(encoding.pack_dna4(
        world["reads"][i * BATCH:(i + 1) * BATCH])).to(dev)
        for i in range(P // BATCH)]
    return batches, torch.full((BATCH, 2), L, dtype=torch.int32, device=dev)


def _rmq_resident_ms(torch, world, an, batches, blens, reps=3):
    """ms a device-resident batch step of ``an`` over ``batches``."""
    def resident():
        for b in batches:
            an.step(b, blens, world["L"])

    return cuda_ms(torch, resident, reps=reps) / len(batches)


def phase_rmq(torch, world):
    """rmq/lca* and rmq/hybrid (PipelineConfig's seeds) through the
    Analyser over all 32,768 pairs: K1-K4 and K9 launched (one K9 and
    no K5 or K6 a batch), kernel taxa equal to the plain path's, the
    first 1,024 equal to umgap_tpu's digests; device-resident and steady
    end-to-end pairs/s, CUDA kernels a batch step; K9 on the path's own
    inputs and past it (``k9_cells``). Returns (the launch counts of both
    runs summed, K9's entry of the kernels line: lca*'s numbers at the
    path's shape, hybrid's beside them)."""
    from umgap_tpu_torch import kernels
    from umgap_tpu_torch.agg.device_rmq import DeviceEuler
    from umgap_tpu_torch.pipeline.fused import PipelineConfig

    t_phase = time.perf_counter()
    P = world["P"]
    euler = DeviceEuler.from_host(world["tax"], world["dev"])
    batches, blens = _rmq_batches(torch, world)
    phase = {"tour_len": euler.tour_len}
    total, inputs = {}, {}
    for strat in RMQ_STRATEGIES:
        key = f"rmq/{strat}"
        cfg = PipelineConfig(f"rmq-{strat}", method="rmq", strategy=strat)
        an = _analyser(world, cfg, euler=euler)
        _run_analyser(an, world)
        an.overflow_reads = 0
        kernels.reset_launches()
        taxa = _run_analyser(an, world)
        launches = kernels.launch_counts()
        for k in path_kernels(cfg):
            require(launches[k] > 0, f"{key}: kernel {k} was not launched")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        c = batch_launches(torch, world, an)
        require(c["rmq_aggregate"] == 1 and c["dedup_counts"] == 1
                and c["tree_aggregate"] == 0 and c["lane_gather"] == 0,
                f"{key}: one batch launched {c}")
        plain = _run_analyser(_analyser(world, cfg, plain=True, euler=euler),
                              world)
        require(np.array_equal(taxa, plain),
                f"{key}: kernel taxa differ from plain taxa in "
                f"{int((taxa != plain).sum())} of {P} groups")
        require(taxa.shape == (P,) and (taxa >= 1).all(), f"{key}: bad output")
        require(taxa_digest(taxa[:REFERENCE_PAIRS]) == REFERENCE_DIGESTS[key],
                f"{key}: the first {REFERENCE_PAIRS} groups differ from the "
                "JAX package's reference taxa")
        inputs[strat] = _k9_inputs(torch, world, an)
        ms = _rmq_resident_ms(torch, world, an, batches, blens)
        e2e = _stream_rate(an, world)
        phase[key] = dict(
            launches=launches, overflow_reads=an.overflow_reads,
            batch_cuda_launches=batch_cuda_launches(torch, world, an),
            device_resident_pairs_per_s=BATCH / (ms / 1e3),
            batch_ms=ms, e2e=e2e, checksum=int(taxa.sum()),
            distinct_taxa=int(len(np.unique(taxa))),
            stages=stage_table(torch, world, an))
        log(f"{key}: kernel == plain on {P} groups, == reference on "
            f"{REFERENCE_PAIRS}; device-resident {BATCH / (ms / 1e3):.0f} "
            f"pairs/s ({ms:.3f} ms per batch), e2e "
            f"{e2e['pairs_per_s']:.0f} pairs/s; "
            f"{phase[key]['batch_cuda_launches']['kernels']} CUDA kernels a "
            f"batch step; launches {launches}")
    k9 = k9_cells(torch, world, euler, inputs)
    phase["k9"] = k9
    phase["seconds"] = time.perf_counter() - t_phase
    RESULT["phases"]["rmq"] = phase
    entry = dict(k9["lca*"], max_abs_err=k9["max_abs_err"],
                 equal=k9["max_abs_err"] == 0.0, hybrid=k9["hybrid"],
                 wide=k9["wide"])
    return total, entry


def rmq_ab(torch, world):
    """The Euler/RMQ presets by the same code on any tree: each
    strategy's device-resident batch ms over the workload, steady e2e
    pairs/s, CUDA kernels a batch step, its stage table and the taxa's
    checksum (the trees' taxa must agree)."""
    from umgap_tpu_torch.agg.device_rmq import DeviceEuler
    from umgap_tpu_torch.pipeline.fused import PipelineConfig

    euler = DeviceEuler.from_host(world["tax"], world["dev"])
    batches, blens = _rmq_batches(torch, world)
    out = {}
    for strat in RMQ_STRATEGIES:
        cfg = PipelineConfig(f"rmq-{strat}", method="rmq", strategy=strat)
        an = _analyser(world, cfg, euler=euler)
        taxa = _run_analyser(an, world)
        out[strat] = dict(
            batch_ms=_rmq_resident_ms(torch, world, an, batches, blens),
            e2e=_stream_rate(an, world),
            batch_cuda_launches=batch_cuda_launches(torch, world, an),
            stages=stage_table(torch, world, an),
            checksum=int(taxa.sum()),
            digest=taxa_digest(taxa[:REFERENCE_PAIRS]))
    return out


def k9_ab(torch, world):
    """K9's cells (``k9_cells``, checked against the plain version) on
    this tree's kernel: for sweeps of its compile-time sizes."""
    from umgap_tpu_torch.agg.device_rmq import DeviceEuler
    from umgap_tpu_torch.pipeline.fused import PipelineConfig

    euler = DeviceEuler.from_host(world["tax"], world["dev"])
    inputs = {}
    for strat in RMQ_STRATEGIES:
        cfg = PipelineConfig(f"rmq-{strat}", method="rmq", strategy=strat)
        inputs[strat] = _k9_inputs(torch, world,
                                   _analyser(world, cfg, euler=euler))
    return k9_cells(torch, world, euler, inputs)


# ---------------------------------------------------------------------- #
# Two trees in turns on one card
# ---------------------------------------------------------------------- #

AB_WORKER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("smoke_ab", sys.argv[1])
d = importlib.util.module_from_spec(spec)
spec.loader.exec_module(d)
d.ab_worker(*sys.argv[2:])
"""


def _instance_name(mangled):
    """A kernel instance's name and template arguments from its mangled
    name, without its namespaces (an anonymous namespace's name differs
    between builds) and parameters: "probe_kernel<Li8ELb0ELb1E>"."""
    import re

    rest = mangled[3:] if mangled.startswith("_ZN") else mangled
    name = mangled
    while rest[:1].isdigit():
        n = re.match(r"\d+", rest).group()
        name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
    if rest.startswith("I") and "EEv" in rest:
        return f"{name}<{rest[1:rest.index('EEv')]}>"
    return name


def sass_compare(before, source="umgap_tpu_torch/csrc/probe_kmer.cu",
                 new_arg=None, old_arg=None):
    """Each kernel instance's SASS in ``source`` on this tree against the
    same file in the tree at ``before`` (the parent): both built by nvcc
    to a cubin with the kernels' flags, disassembled by cuobjdump, each
    instance's instructions compared with addresses and encodings
    stripped. Instances are matched by their template arguments (a new
    argument changes a mangled name, not an instance); ``new_arg``, a
    template argument this tree appends (e.g. "Lb0E", a new ``false``),
    is dropped from this tree's names first; ``old_arg``, (kernel, a
    template argument the parent appended to that kernel's instances and
    this tree dropped), from the parent's. Writes ``sass_<stem>.json``
    under CHIP_SMOKE_OUT and returns {instance: "identical (n
    instructions)" or "differs: ..."}."""
    import re
    import tempfile

    from umgap_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")

    def instances(tree):
        with tempfile.TemporaryDirectory() as tmp:
            cubin = os.path.join(tmp, "k.cubin")
            subprocess.run([nvcc, *flags, "-cubin", "-o", cubin,
                            os.path.join(tree, source)], check=True)
            text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                                  capture_output=True, text=True).stdout
        out, cur = {}, None
        for line in text.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = _instance_name(m.group(1))
                out[cur] = []
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if m and cur is not None:
                out[cur].append(re.sub(r"\s+", " ", m.group(1)))
        return out

    old, new = instances(before), instances(REPO)
    if new_arg:
        new = {k.replace(new_arg + ">", ">"): v for k, v in new.items()}
    if old_arg:
        kern, arg = old_arg
        old = {(k.replace(arg + ">", ">") if k.startswith(kern + "<") else k):
               v for k, v in old.items()}
    res = {}
    for key in sorted(set(old) | set(new)):
        a, b = old.get(key), new.get(key)
        if a is None or b is None:
            res[key] = "only in " + ("this tree" if a is None else "parent")
        elif a == b:
            res[key] = f"identical ({len(a)} instructions)"
        else:
            res[key] = (f"differs: {len(a)} -> {len(b)} instructions, "
                        f"{sum(x != y for x, y in zip(a, b))} of the "
                        "first differ")
        print(f"{key}: {res[key]}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"sass_{os.path.basename(source)}"
                           ".json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def compare_trees(before, after, order="BAAB", mode="full"):
    """Time two checkouts of the port in turns on one card (before,
    after, after, before), each in its own process that imports its own
    ``umgap_tpu_torch`` and runs its own ``chip_smoke.py``'s identify,
    kernels and gather phases, then this file's per-stage tables (three
    presets), K1-K4 device times (``chain_device_ms``) and K5 host times
    at the Pallas rows' shapes, so both trees are measured by the same
    code. ``mode`` "tryptic" runs this file's ``tryptic_ab`` instead
    (the tree's identify and world only), "wide" this file's
    ``wide_ab`` (K6 at the wide widths, the ladder sample's split),
    "long" its ``long_ab`` (K3 and K4 past the main path's variants at
    each rung of the width ladder and on the synthetic long rows, the
    main path's kernels, the 12,000 bp path, the ladder sample), "tail"
    its ``tail_ab`` (the tail after K3: CUDA kernels a batch, stage
    tables, the tail's device ms, the ring, the 12,000 bp path), "stash"
    its ``stash_ab`` (K2 at stashes of STASH_ROWS rows), "redesign" its
    ``redesign_ab`` (K1P's and K3RS's cells, K1, K3's staged tile and
    unscored row kernel beside them), "rmq" its ``rmq_ab`` (the Euler/RMQ
    presets' batch: device-resident ms, e2e, CUDA kernels a step, stage
    tables, the taxa's checksum), "chains" this
    file's ``chain_device_ms`` alone at L = 100 and 160 (K1-K4 and K6).
    Writes ``ab.json`` (or ``ab_<mode>.json``) under OUT_DIR.

        python3 -c "import chip_smoke; chip_smoke.compare_trees(P, A)"
    """
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: compare_trees runs only on a GPU")
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = []
    for k, tag in enumerate(order):
        tree = os.path.abspath(before if tag == "B" else after)
        out = os.path.join(OUT_DIR, f"ab_{k}_{tag}.json")
        log(f"A/B run {k} ({'before' if tag == 'B' else 'after'}): {tree}")
        proc = subprocess.run([sys.executable, "-c", AB_WORKER,
                               os.path.abspath(__file__), tree, out, mode],
                              cwd=tree, timeout=1500)
        require(proc.returncode == 0, f"A/B run {k} on {tree} failed")
        with open(out) as f:
            runs.append(dict(tag=tag, **json.load(f)))
    name = "ab.json" if mode == "full" else f"ab_{mode}.json"
    with open(os.path.join(OUT_DIR, name), "w") as f:
        json.dump(runs, f, indent=1, default=str)

    def tail(t):
        # the stages after seed-extend, whichever a tree has: dedup,
        # hit_geometry (the filter) and snap before the fused tail
        names = ("dedup", "hit_geometry", "aggregate", "snap")
        ms = [t["stage_ms"][n] for n in names if n in t["stage_ms"]]
        return (" + ".join(n for n in names if n in t["stage_ms"])
                + " " + " + ".join(f"{v:.3f}" for v in ms)
                + f" = {sum(ms):.3f}")

    if mode == "wide":
        for k, r in enumerate(runs):
            log(f"run {k} {r['tag']}: K6 device ms " + "; ".join(
                f"K={K} " + ", ".join(f"{s} {fmt_ms(st[s]['device_ms'])}"
                                      for s in ("hybrid", "lca*", "mrtl"))
                for K, st in r["wide"]["k6"].items())
                + f"; ladder wide program {r['wide']['ladder']['wide_s']:.3f}"
                f" s, K6 {r['wide']['ladder']['k6_device_ms']:.1f} ms")
    if mode == "long":
        for k, r in enumerate(runs):
            lg = r["long"]
            log(f"run {k} {r['tag']}: device ms K3 " + ", ".join(
                f"{c} {fmt_ms(v['device_ms'])}" for c, v in lg["k3"].items())
                + "; K4 " + ", ".join(f"{c} {fmt_ms(v['device_ms'])}"
                                      for c, v in lg["k4"].items())
                + "; main " + "; ".join(
                    f"L={w} K3 {fmt_ms(m['seedextend'])} K4 "
                    f"{fmt_ms(m['dedup_counts'])}"
                    for w, m in lg["main"].items())
                + f"; 12,000 bp wall {lg['long']['wall_s']:.3f} s, K3 "
                f"{lg['long']['k3']['device_ms']:.3f} K4 "
                f"{lg['long']['k4']['device_ms']:.3f} K6 "
                f"{lg['long']['k6']['device_ms']:.3f} ms; ladder wall "
                f"{lg['ladder']['wall_s']:.3f} s")
    if mode == "tail":
        for k, r in enumerate(runs):
            t = r["tail"]
            log(f"run {k} {r['tag']}: CUDA kernels a batch " + ", ".join(
                f"{n} {c['kernels']}" for n, c in t["cuda_launches"].items())
                + "; " + "; ".join(
                    f"{n} {s['batch_ms']:.3f} ms/batch ({tail(s)})"
                    for n, s in t["stages"].items())
                + f"; ring {t['ring_high_sensitivity']['pairs_per_s']:.0f}"
                f" pairs/s; 12,000 bp wall {t['long']['wall_s']:.3f} s")
    if mode == "stash":
        for k, r in enumerate(runs):
            st = dict(r["stash"])
            main = st.pop("main")
            log(f"run {k} {r['tag']}: K2 device ms, main " + ", ".join(
                f"L = {w} {c['device_ms']:.4f}" for w, c in main.items())
                + "; by stash rows " + "; ".join(
                    f"{S}: grouped {c['grouped']['device_ms']:.4f}, single "
                    f"{c['single']['device_ms']:.4f}"
                    for S, c in st.items()))
    if mode == "chains":
        for k, r in enumerate(runs):
            log(f"run {k} {r['tag']}: device ms " + "; ".join(
                f"L={w} " + ", ".join(f"{n} {fmt_ms(v)}" for n, v in c.items()
                                      if not n.endswith("event_ms"))
                for w, c in r["chain_device_ms"].items()))
    if mode == "redesign":
        for k, r in enumerate(runs):
            d = r["redesign"]
            log(f"run {k} {r['tag']}: K1P gene "
                f"{fmt_ms(d['k1p']['gene']['device_ms'])}, floor "
                f"{fmt_ms(d['k1p']['floor']['device_ms'])}, split "
                f"{d['k1p']['split']['device_ms']:.4f} device ms; K3RS "
                f"{fmt_ms(d['k3rs']['device_ms'])}; K3R " + ", ".join(
                    f"{c} {fmt_ms(v['device_ms'])}"
                    for c, v in d["k3r"].items()) + "; chain " + ", ".join(
                    f"{n} {fmt_ms(v)}" for n, v in d["chain"].items()
                    if not n.endswith("event_ms")))
    if mode == "rmq":
        for k, r in enumerate(runs):
            log(f"run {k} {r['tag']}: " + "; ".join(
                f"rmq/{st} {c['batch_ms']:.3f} ms a batch, e2e "
                f"{c['e2e']['pairs_per_s']:.0f} pairs/s, "
                f"{c['batch_cuda_launches']['kernels']} CUDA kernels, "
                f"checksum {c['checksum']}"
                for st, c in r["rmq"].items()))
        require(len({json.dumps({s: (c["checksum"], c["digest"])
                                 for s, c in r["rmq"].items()})
                     for r in runs}) == 1, "rmq A/B: the trees' taxa differ")
    if mode != "full":
        return

    for k, r in enumerate(runs):
        log(f"run {k} {r['tag']}: device ms " + "; ".join(
            f"L={w} " + ", ".join(f"{n} {fmt_ms(v)}" for n, v in c.items())
            for w, c in r["chain_device_ms"].items())
            + "; stages " + "; ".join(
                f"{n} {t['batch_ms']:.3f} ms/batch ({tail(t)}, peak +"
                f"{t['step_above_base_gb']:.3f} GB)"
                for n, t in r["stages"].items()))


def chain_device_ms(torch, world, width):
    """Device ms of K1-K4 and of the tree aggregators' work on one batch
    (the first 16,384 pairs padded to ``width``, high-sensitivity's seeds
    and lower bound), by the same code for any tree. "seedextend" is the
    seed-extend stage's work: the hits entry where the tree has one, else
    the mask kernel and the select after it. "aggregate_<strategy>" is
    K6's hits entry where the tree has one, else hit_geometry (with the
    ancestry epilogue for lca* and mrtl) and K6 on it. At L = 160 also
    K1 on reads that fill the width ("reads_to_kmers_full"). At
    L = 100 also the aggregators' work on groups of 17-64 valid hits
    ("aggregate_<strategy>_dense") and of 64 ("_full"): every group on
    K6's warp path."""
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate

    tt1 = encoding.get_table(1)
    reads, lens = _batch_reads(torch, world, width)
    hi, lo, wvalid, plens = translate.reads_to_kmers(reads, lens, width,
                                                     tt1, 9)
    taxa = lookup.probe(world["dtable"], hi, lo, wvalid, 0)[0]
    nk = (plens - 8).clamp(min=0)
    if hasattr(seedextend, "seedextend_hits"):
        def seed():
            return seedextend.seedextend_hits(taxa, nk, 3, 1)
    else:
        def seed():
            return torch.where(seedextend.seedextend_mask_batch(
                taxa, nk, 3, 1), taxa, 0)
    hits = seed().reshape(BATCH, -1).contiguous()
    out = dict(
        reads_to_kmers=device_ms(torch, lambda: translate.reads_to_kmers(
            reads, lens, width, tt1, 9)),
        probe_kmer=device_ms(torch, lambda: lookup.probe(
            world["dtable"], hi, lo, wvalid, 0)),
        seedextend=device_ms(torch, seed),
        dedup_counts=device_ms(torch, lambda: devagg.dedup_counts(
            hits, None, 64, True)))
    dtax = world["dtax"]
    utaxa, ucounts, uvalid = devagg.dedup_counts(hits, None, 64)
    uvalid = devagg.filter_lower_bound(ucounts, uvalid, 1.0)
    batches = {"": (utaxa, ucounts, uvalid)}
    if width == world["L"]:
        batches.update({"_" + n: _dense_hits(torch, dtax, BATCH, 64, lo)
                        for n, lo in (("dense", 17), ("full", 64))})
    for tag, (u, c, v) in batches.items():
        for strat in ("hybrid", "lca*", "mrtl"):
            if hasattr(devagg, "tree_aggregate_hits"):
                def agg(strat=strat, u=u, c=c, v=v):
                    return devagg.tree_aggregate_hits(strat, dtax, u, c, v,
                                                      0.25)
            else:
                def agg(strat=strat, u=u, c=c, v=v):
                    geom = devagg.hit_geometry(dtax, u, v, strat != "hybrid")
                    return devagg.tree_aggregate(strat, dtax, geom, u, c,
                                                 0.25)
            out[f"aggregate_{strat}{tag}"] = device_ms(torch, agg)
    for strat in ("hybrid", "lca*", "mrtl"):
        tail = _tail_fn(torch, dtax, hits, strat)
        out[f"tail_{strat}"] = device_ms(torch, tail)
        out[f"tail_{strat}_event_ms"] = cuda_ms(torch, tail)
    if width > world["L"]:
        full, flens = _batch_reads(torch, world, width, full=True)
        out["reads_to_kmers_full"] = device_ms(
            torch, lambda: translate.reads_to_kmers(full, flens, width, tt1,
                                                    9))
    return out


def _tail_fn(torch, dtax, hits, strategy, lower_bound=1.0, k_max=64):
    """The pipeline's work after seed-extend on one batch of hits, as a
    tree runs it (``aggregate_hits``): K4 with the bound, then K6 with
    the snap table, where the tree has the fused tail; else K4, the
    filter, the aggregator, snap's take and its selects. Both end in
    the overflow compare."""
    from umgap_tpu_torch.agg import device as devagg

    method = "rmq" if strategy == "mrtl" else "tree"
    if fused_tail(devagg):
        def tail():
            u, c, v, n = devagg.dedup_counts(hits, None, k_max, True,
                                             lower_bound=lower_bound)
            return devagg.aggregate_batch(
                dtax, u, c, v, method, strategy, 0.25,
                snap=dtax.snap_valid), n > k_max
    else:
        def tail():
            u, c, v, n = devagg.dedup_counts(hits, None, k_max, True)
            v = devagg.filter_lower_bound(c, v, lower_bound)
            agg = devagg.aggregate_batch(dtax, u, c, v, method, strategy,
                                         0.25)
            return torch.where(v.any(dim=-1), devagg.snap_batch(
                dtax.snap_valid, agg, 0), 1).to(torch.int32), n > k_max
    return tail


def tail_ab(torch, world):
    """The tail after K3 and what it moves, by this code on any tree:
    CUDA kernels in one batch step (``batch_cuda_launches``) for all six
    presets; the three presets' stage tables (device-resident pairs/s,
    stages); K1-K4, K6 and the tail's device and event ms at L = 100
    and 160 (``chain_device_ms``, whose ``tail_<strategy>`` is
    ``_tail_fn``); high-sensitivity from FASTQ through the ring tier (8
    copies of the workload, median of three windows); the 12,000 bp
    path (``long_path`` unchecked)."""
    from umgap_tpu_torch.agg import device as devagg
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    out = dict(fused=fused_tail(devagg), cuda_launches={}, stages={})
    for name, cfg in {**PRESETS, **TRYPTIC_PRESETS}.items():
        an = _analyser(world, cfg)
        out["cuda_launches"][name] = batch_cuda_launches(torch, world, an)
        if name in STAGE_PRESETS:
            out["stages"][name] = stage_table(torch, world, an)
    out["chain"] = {w: chain_device_ms(torch, world, w)
                    for w in (world["L"], 160)}
    os.makedirs(TMP_DIR, exist_ok=True)
    paths = [os.path.join(TMP_DIR, f"ab_R{e + 1}.fq") for e in (0, 1)]
    for e in (0, 1):
        text = _fastq_text(world["reads"], e, b"c0_")
        with open(paths[e], "wb") as f:
            for _ in range(INGEST_COPIES):
                f.write(text)
    out["ring_high_sensitivity"] = ring_rate(
        world, paths, os.path.join(TMP_DIR, "ab_out.fa"), INGEST_PRESET)
    out["long"] = long_path(torch, world, check=False)
    log("tail A/B: CUDA kernels a batch " + ", ".join(
        f"{n} {c['kernels']}" for n, c in out["cuda_launches"].items())
        + "; batch ms " + ", ".join(
            f"{n} {t['batch_ms']:.3f}" for n, t in out["stages"].items())
        + "; tail device ms " + "; ".join(
            f"L={w} " + ", ".join(f"{s} {fmt_ms(c['tail_' + s])}"
                                  for s in ("hybrid", "lca*", "mrtl"))
            for w, c in out["chain"].items())
        + f"; ring {out['ring_high_sensitivity']['pairs_per_s']:.0f} "
        f"pairs/s; 12,000 bp wall {out['long']['wall_s']:.3f} s")
    return out


def sweep_constant(constant, values,
                   source="umgap_tpu_torch/csrc/tree_aggregate.cu",
                   mode="chain"):
    """Device ms of ``chain_device_ms`` at L = 100 (``mode`` "chain"), of
    ``wide_ab`` ("wide") or of ``long_rows`` ("rows": K3's and K4's
    cells past the main path's variants) on copies of this checkout that
    differ only
    in one ``constexpr int`` of a CUDA source, each in its own process,
    in turns (the values, then again in reverse order); ``mode``
    "scored" times K3's scored entry (``scored_ab``), "k9" K9's cells
    (``k9_ab``, each variant held to the plain version). Writes
    ``sweep_<constant>.json`` under OUT_DIR.

        python3 -c "import chip_smoke; chip_smoke.sweep_constant(
            'kBlockWarps', (4, 8, 16))"
    """
    import re

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: sweep_constant runs only on a GPU")
    os.makedirs(OUT_DIR, exist_ok=True)
    pattern = re.compile(rf"(constexpr int {constant} = )\d+;")
    runs = []
    for k, v in enumerate(list(values) + list(values)[::-1]):
        tree = os.path.join(TMP_DIR, "variants", f"{constant}_{v}")
        if not os.path.isdir(tree):
            shutil.copytree(os.path.join(REPO, "umgap_tpu_torch"),
                            os.path.join(tree, "umgap_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(__file__, tree)
            os.symlink(DATA, os.path.join(tree, ".bench_data"))
            path = os.path.join(tree, source)
            with open(path) as f:
                text, hits = pattern.subn(rf"\g<1>{v};", f.read())
            require(hits == 1, f"{constant} not found once in {source}")
            with open(path, "w") as f:
                f.write(text)
        out = os.path.join(OUT_DIR, f"sweep_{k}_{v}.json")
        proc = subprocess.run([sys.executable, "-c", AB_WORKER,
                               os.path.abspath(__file__), tree, out,
                               mode], cwd=tree, timeout=900)
        require(proc.returncode == 0, f"sweep run {constant} = {v} failed")
        with open(out) as f:
            r = json.load(f)
        if mode == "rows":
            runs.append(dict(value=v, rows=r["rows"]))
            log(f"{constant} = {v}: device ms " + "; ".join(
                f"{k} " + ", ".join(f"{c} {fmt_ms(st['device_ms'])}"
                                    for c, st in cells.items())
                for k, cells in r["rows"].items()))
            continue
        if mode == "k9":
            runs.append(dict(value=v, k9=r["k9"]))
            log(f"{constant} = {v}: K9 device ms " + ", ".join(
                f"{st} {fmt_ms(r['k9'][st]['device_ms'])} (floor "
                f"{fmt_ms(r['k9'][st]['floor_device_ms'])}, full "
                f"{fmt_ms(r['k9'][st]['full_device_ms'])})"
                for st in RMQ_STRATEGIES) + "; wide " + "; ".join(
                f"K={K} " + ", ".join(f"{st} {fmt_ms(c[st]['device_ms'])}"
                                      for st in RMQ_STRATEGIES)
                for K, c in r["k9"]["wide"].items()))
            continue
        if mode == "scored":
            runs.append(dict(value=v, scored=r["scored"]))
            log(f"{constant} = {v}: K3 scored device ms " + ", ".join(
                f"{c} {fmt_ms(st['device_ms'])}"
                for c, st in r["scored"].items()))
            continue
        if mode == "wide":
            runs.append(dict(value=v, wide=r["wide"]))
            log(f"{constant} = {v}: K6 device ms " + "; ".join(
                f"K={K} " + ", ".join(f"{s} {fmt_ms(st[s]['device_ms'])}"
                                      for s in ("hybrid", "lca*", "mrtl"))
                for K, st in r["wide"]["k6"].items()))
            continue
        runs.append(dict(value=v, chain_device_ms=r["chain_device_ms"]))
        log(f"{constant} = {v}: device ms " + ", ".join(
            f"{n} {fmt_ms(t)}" for n, t in r["chain_device_ms"].items()
            if n.startswith("aggregate")))
    with open(os.path.join(OUT_DIR, f"sweep_{constant}.json"), "w") as f:
        json.dump(runs, f, indent=1, default=str)


def tryptic_ab(torch, world):
    """The tryptic path's numbers, by this code on any tree: K7 -> K8 at
    L = 100 and 160 (``_tryptic_chain``: event, device and L2-flushed
    times, plain, bound), K8 on the resident 0.81 GB index with the L2
    flushed, both tryptic presets' stage tables (device-resident pairs/s)
    and end-to-end pairs/s from arrays, and tryptic-sensitivity's ring
    tier from FASTQ (8 copies of the workload)."""
    from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

    out = dict(chain={w: _tryptic_chain(torch, world, w)[0]
                      for w in (world["L"], 160)})
    dt, built = resident_peptide_table(torch, world)
    out["resident"] = dict(built, **resident_k8(torch, world, dt,
                                                sweep=False)[1])
    del dt
    torch.cuda.empty_cache()
    out["stages"], out["e2e"] = {}, {}
    for name, cfg in TRYPTIC_PRESETS.items():
        an = _analyser(world, cfg)
        _run_analyser(an, world)
        out["stages"][name] = stage_table(torch, world, an)
        out["e2e"][name] = _stream_rate(an, world)
    os.makedirs(TMP_DIR, exist_ok=True)
    paths = [os.path.join(TMP_DIR, f"ab_R{e + 1}.fq") for e in (0, 1)]
    for e in (0, 1):
        text = _fastq_text(world["reads"], e, b"c0_")
        with open(paths[e], "wb") as f:
            for _ in range(INGEST_COPIES):
                f.write(text)
    out["ring_tryptic_sensitivity"] = tryptic_ring_rate(
        world, paths, os.path.join(TMP_DIR, "ab_out.fa"))
    log("tryptic A/B: " + "; ".join(
        f"L={w} " + ", ".join(
            f"{n} L2 flushed {fmt_ms(s['cold_device_ms'])} device "
            f"{fmt_ms(s['device_ms'])}" for n, s in c.items())
        for w, c in out["chain"].items())
        + f"; resident K8 flushed {fmt_ms(out['resident']['probe_cold_device_ms'])}"
        + "; batch ms " + ", ".join(
            f"{n} {t['batch_ms']:.3f}" for n, t in out["stages"].items())
        + "; e2e " + ", ".join(
            f"{n} {t['pairs_per_s']:.0f}" for n, t in out["e2e"].items())
        + f"; ring {out['ring_tryptic_sensitivity']['pairs_per_s']:.0f}")
    return out


def wide_ab(torch, world):
    """The wide program's numbers, by this code on any tree: ``k6_wide``
    (unchecked: the tree's own script holds K6 to plain) and the ladder
    sample's split (``ladder_wide``, max-sensitivity through the CLI's
    ring tier at its defaults, after one warm run)."""
    out = dict(k6=k6_wide(torch, world, check=False)[0])
    out["ladder"] = _ladder_split(torch, world)
    return out


def _ladder_split(torch, world):
    """The ladder sample's split (``ladder_wide``): max-sensitivity
    through the CLI's ring tier at its defaults, after one warm run."""
    import io

    from umgap_tpu_torch import cli

    os.makedirs(TMP_DIR, exist_ok=True)
    paths, _lens = _ladder_paths(world)
    session = _cli_session(world)
    lad = dict(type=LADDER_PRESET, first=paths[0], second=paths[1],
               output=None)

    def run():
        return cli.write_batches(io.StringIO(), cli.run_sample(session, lad))

    run()
    out = ladder_wide(torch, run)
    out["wide_batch"] = max(session.analysers.values(),
                            key=lambda a: a.read_length)._wide_batch
    return out


def rows_ab(torch, world):
    """``long_rows`` unchecked, by this code on any tree: K3's and K4's
    cells by name."""
    (s3, _e3), (s4, _e4) = long_rows(torch, world, check=False)
    return dict(k3=s3["by_cell"], k4=s4["by_cell"])


def long_ab(torch, world):
    """K3's and K4's long-row numbers, by this code on any tree:
    ``long_rows`` unchecked (each tree's own script holds both kernels
    to plain), the main path's K1-K4 and tree aggregators at L = 100
    and 160 (``chain_device_ms``: K3's staged tile and K4's warp path),
    the 12,000 bp path (``long_path`` unchecked) and the ladder sample's
    split (``_ladder_split``)."""
    out = rows_ab(torch, world)
    out["main"] = {w: chain_device_ms(torch, world, w)
                   for w in (world["L"], 160)}
    out["long"] = long_path(torch, world, check=False)
    out["ladder"] = _ladder_split(torch, world)
    return out


def _k1p_gene_batch(torch, dev, seed=19):
    """K1P at the FGSpp path's gene batch shape (GENE_BATCH groups x 4
    lanes of 64 residues): AA codes 0-24, lengths 0-64. K1P's time does
    not depend on the codes."""
    rng = np.random.default_rng(seed)
    N, P = GENE_BATCH * 4, 64
    aa = rng.integers(0, 25, size=(N, P)).astype(np.uint8)
    ln = rng.integers(0, P + 1, size=N).astype(np.int32)
    return torch.from_numpy(aa).to(dev), torch.from_numpy(ln).to(dev)


def _split_batches(torch, dev):
    """K1P's inputs on phase builddist's TSV split (``_build_tsv``'s 40 MB
    of proteins): each length-class batch's (aa, lengths) as
    ``split_kmers_tsv`` hands them to K1P, captured by wrapping it."""
    from umgap_tpu_torch.index import scale
    from umgap_tpu_torch.ops import kmers

    os.makedirs(TMP_DIR, exist_ok=True)
    tsv = _build_tsv(os.path.join(TMP_DIR, "k1p_split.tsv"), BUILD_TSV_BYTES)
    with open(tsv, "rb") as f:
        data = f.read()
    p2k, calls = kmers.proteins_to_kmers, []

    def spy(*args, **kw):
        calls.append(args[:2])
        return p2k(*args, **kw)

    kmers.proteins_to_kmers = spy
    try:
        scale.split_kmers_tsv(data, device=dev)
    finally:
        kmers.proteins_to_kmers = p2k
    return calls


def _k1p_bound(n, p):
    w = max(p - 8, 1)
    return bound(n * p + 4 * n + n * w * 9, n * w * 9 * 2)[0]


def k1p_cells(torch, world, gene=None, calls=None, split_ms=None):
    """K1P's numbers by this code on any tree: the gene batch (event and
    device ms), its floor (K1P_FLOOR_LANES lanes) and the TSV split's
    length-class batches (device ms each and summed; ``split_ms`` times
    them instead, e.g. ``events_ms``), each with its bound (bytes)."""
    from umgap_tpu_torch.ops import kmers

    a, ln = gene or _k1p_gene_batch(torch, world["dev"])
    calls = calls if calls is not None else _split_batches(torch,
                                                           world["dev"])
    N, P = a.shape

    def k1p():
        return kmers.proteins_to_kmers(a, ln)

    def floor():
        return kmers.proteins_to_kmers(a[:K1P_FLOOR_LANES],
                                       ln[:K1P_FLOOR_LANES])

    out = dict(gene=dict(shape=[N, P], ms=cuda_ms(torch, k1p, reps=50),
                         device_ms=device_ms(torch, k1p, reps=50),
                         bound_ms=_k1p_bound(N, P)),
               floor=dict(lanes=K1P_FLOOR_LANES,
                          device_ms=device_ms(torch, floor, reps=50)))
    per = [dict(shape=list(x.shape), bound_ms=_k1p_bound(*x.shape),
                device_ms=(split_ms or device_ms)(
                    torch, lambda x=x, n=n: kmers.proteins_to_kmers(x, n),
                    reps=5))
           for x, n in calls]
    out["split"] = dict(launches=len(per),
                        device_ms=sum(c["device_ms"] for c in per),
                        bound_ms=sum(c["bound_ms"] for c in per),
                        batches=per)
    return out


def k3rs_cell(torch, world, inputs=None):
    """K3's scored entry at SCORED_WIDTH, by this code on any tree: the
    lanes the 420 bp batch gives it (K1 -> K2; 49,152 x 132), max-
    sensitivity's seeds and penalty (s = 2, g = 1, 5), event and device
    ms, the bound (bytes, as ``k3s_cell``)."""
    from umgap_tpu_torch.ops import seedextend

    taxa, nk = inputs or _row_inputs(
        torch, world, _rung_codes(world, SCORED_WIDTH), SCORED_WIDTH)[:2]
    sc = world["dtax"].seed_scores
    nl, NW = nk.numel(), taxa.shape[-1]

    def k3rs():
        return seedextend.seedextend_hits(taxa, nk, 2, 1, seed_scores=sc,
                                          penalty=5)

    return dict(shape=[nl, NW], ms=cuda_ms(torch, k3rs),
                device_ms=device_ms(torch, k3rs),
                bound_ms=bound(nl * (NW * 8 + 4) + sc.numel() * 4,
                               nl * NW * 24)[0])


def scored_ab(torch, world):
    """K3's scored entry past the staged tile, by this code on any tree:
    ``k3rs_cell`` at SCORED_WIDTH and at 512 bp, and on the synthetic
    rows of 4,000 windows."""
    out = {}
    for L in (SCORED_WIDTH, 512):
        taxa, nk, _h = _row_inputs(torch, world, _rung_codes(world, L), L)
        out[f"N={taxa.shape[-1]}"] = k3rs_cell(torch, world, (taxa, nk))
        del taxa, nk, _h
    out["N=4000"] = k3rs_cell(torch, world, _k3_synthetic(torch,
                                                          world["dev"]))
    return out


def redesign_ab(torch, world):
    """K1P's and K3RS's numbers, by this code on any tree (``k1p_cells``,
    ``k3rs_cell``), with what shares their sources: K1 and K3's staged
    tile (``chain_device_ms`` at the workload's width) and K3's unscored
    row kernel on rung 512's lanes and the synthetic 4,000-window rows
    (``k3_cell`` unchecked)."""
    out = dict(k1p=k1p_cells(torch, world), k3rs=k3rs_cell(torch, world),
               chain=chain_device_ms(torch, world, world["L"]))
    taxa, nk, _h = _row_inputs(torch, world, _rung_codes(world, 512), 512)
    out["k3r"] = {"W=162": k3_cell(torch, taxa, nk, False, "rung 512")[0]}
    del taxa, nk, _h
    tr, lt = _k3_synthetic(torch, world["dev"])
    out["k3r"]["W=4000"] = k3_cell(torch, tr, lt, False, "W=4000")[0]
    k = out["k1p"]
    log(f"redesign A/B: K1P gene {fmt_ms(k['gene']['device_ms'])} device "
        f"({k['gene']['ms']:.4f} event), floor "
        f"{fmt_ms(k['floor']['device_ms'])}, split {k['split']['launches']} "
        f"launches {k['split']['device_ms']:.4f} (bound "
        f"{k['split']['bound_ms']:.4f}); K3RS {out['k3rs']['shape']} "
        f"{fmt_ms(out['k3rs']['device_ms'])} ({out['k3rs']['ms']:.4f} "
        f"event); K3R " + ", ".join(f"{c} {fmt_ms(v['device_ms'])}"
                                    for c, v in out["k3r"].items()))
    return out


# K1P's largest tile and K3RS's threads a lane, swept (``redesign_sweep``)
K1P_SWEEP = (512, 1024, 2048)
K3RS_SWEEP = ("staged", 16, 32)
K3RS_SWEEP_WIDTHS = (330, 420, 512, 1024)  # N = 102, 132, 162, 333


def redesign_sweep():
    """The redesigned kernels' sizes, swept on this tree in one process
    on one card: K1P's largest tile (K1P_TILE_MAX) on the gene batch and
    the TSV split (its batches by ``events_ms``), and the scored mode
    past 96 windows on the lanes K1 -> K2 give at K3RS_SWEEP_WIDTHS bp:
    the staged tile (K3S) or K3RS with 16 or 32 threads a lane, each
    held to the row formulation; K3RS also on the synthetic rows of
    4,000 windows. Every value in
    turns (the values, then in reverse); device ms. Writes
    ``sweep_redesign.json`` under OUT_DIR.

        python3 -c "import chip_smoke; chip_smoke.redesign_sweep()"
    """
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: redesign_sweep runs only on a GPU")
    sys.path.insert(0, REPO)
    os.makedirs(OUT_DIR, exist_ok=True)
    from umgap_tpu_torch.ops import kmers, seedextend

    card = phase_identify(torch)
    world = load_world(torch)
    dev = world["dev"]
    gene, calls = _k1p_gene_batch(torch, dev), _split_batches(torch, dev)
    out = dict(card=card, k1p=[], k3rs={})
    keep = kmers.K1P_TILE_MAX
    for v in K1P_SWEEP + K1P_SWEEP[::-1]:
        kmers.K1P_TILE_MAX = v
        c = k1p_cells(torch, world, gene, calls, split_ms=events_ms)
        out["k1p"].append(dict(value=v, gene=c["gene"]["device_ms"],
                               floor=c["floor"]["device_ms"],
                               split=c["split"]["device_ms"],
                               batches=[b["device_ms"]
                                        for b in c["split"]["batches"]]))
        log(f"K1P tiles of up to {v} windows: gene "
            f"{fmt_ms(c['gene']['device_ms'])}, split "
            f"{c['split']['device_ms']:.4f} device ms (" + ", ".join(
                f"{b['device_ms']:.4f}" for b in c["split"]["batches"])
            + ")")
    kmers.K1P_TILE_MAX = keep
    sc = world["dtax"].seed_scores
    keep = seedextend.STAGED_MAX_N, seedextend.scored_lane_threads
    for L in K3RS_SWEEP_WIDTHS:
        taxa, nk, _h = _row_inputs(torch, world, _rung_codes(world, L), L)
        N = taxa.shape[-1]
        want = seedextend.seedextend_scored_runs_plain(taxa, nk, sc, 5, 2, 1)
        cells = []
        for v in K3RS_SWEEP + K3RS_SWEEP[::-1]:
            # "staged": seedextend_path moved past N for this call
            seedextend.STAGED_MAX_N = N if v == "staged" else keep[0]
            seedextend.scored_lane_threads = (lambda _n, v=v: v)
            compare(torch, f"K3 scored N={N} {v}", seedextend.seedextend_hits(
                taxa, nk, 2, 1, seed_scores=sc, penalty=5), want)
            cells.append(dict(value=v, device_ms=k3rs_cell(
                torch, world, (taxa, nk))["device_ms"]))
            log(f"K3 scored N={N} ({nk.numel()} lanes) {v}: "
                f"{fmt_ms(cells[-1]['device_ms'])} device ms")
        out["k3rs"][f"N={N}"] = dict(lanes=nk.numel(), cells=cells)
        del taxa, nk, _h, want
    tr, lt = _k3_synthetic(torch, dev)  # 1,536 lanes of 4,000 windows
    want = seedextend.seedextend_scored_runs_plain(tr, lt, sc, 5, 2, 1)
    cells = []
    seedextend.STAGED_MAX_N = keep[0]
    for v in K3RS_SWEEP[1:] + K3RS_SWEEP[:0:-1]:
        seedextend.scored_lane_threads = (lambda _n, v=v: v)
        compare(torch, f"K3 scored N=4000 {v}", seedextend.seedextend_hits(
            tr, lt, 2, 1, seed_scores=sc, penalty=5), want)
        cells.append(dict(value=v, device_ms=k3rs_cell(
            torch, world, (tr, lt))["device_ms"]))
        log(f"K3 scored N=4000 (1536 lanes) {v}: "
            f"{fmt_ms(cells[-1]['device_ms'])} device ms")
    out["k3rs"]["N=4000"] = dict(lanes=lt.numel(), cells=cells)
    seedextend.STAGED_MAX_N, seedextend.scored_lane_threads = keep
    with open(os.path.join(OUT_DIR, "sweep_redesign.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return out


# stash rows of the stash comparison: none, sizes up to the 48 KB that
# fits a block's default shared memory (4,096 rows), and past the 227 KB
# a block may opt in to
STASH_ROWS = (0, 256, 1024, 2048, 4096, 20000)


def stash_ab(torch, world):
    """K2 with a stash of each size in STASH_ROWS on the bench batch's
    4.9 M queries: its grouped entry over the bench keys in 16 bucket64s
    shards, and its one-table entry over the bench table (bucket8s). Half
    of a stash's rows are keys of the batch, half keys of no read. Then
    ("main") the main path's K2 as it is, the bench table with its own
    stash, at L = 100 and 160. Each launch is held to the plain version,
    then device and event ms. The same code for any tree
    (``compare_trees(..., mode="stash")``)."""
    from umgap_tpu_torch.ops import encoding, lookup, translate
    from umgap_tpu_torch.parallel import ShardedTable, build_sharded_tables

    dev, L = world["dev"], world["L"]
    reads, lens = _batch_reads(torch, world, L)
    hi, lo, valid, _ = translate.reads_to_kmers(reads, lens, L,
                                                encoding.get_table(1), 9)
    grouped = ShardedTable.from_shards(build_sharded_tables(
        world["keys"], world["vals"], 9, SHARDS, load_factor=0.5,
        layout=SHARDS_LAYOUT), dev).table
    q = torch.unique(((hi.to(torch.int64) << 25) | lo.to(torch.int64))[
        valid]).cpu().numpy()
    rng = np.random.default_rng(23)
    out = {"main": {}}
    dt = world["dtable"]
    for width in (L, 160):
        r, n = _batch_reads(torch, world, width)
        args = translate.reads_to_kmers(r, n, width, encoding.get_table(1),
                                        9)[:3]

        def fn(args=args):
            return lookup.probe(dt, *args, 0)

        err = compare(torch, f"K2 main, L = {width}", fn(),
                      lookup.probe_plain(dt, *args, 0))
        out["main"][width] = dict(device_ms=device_ms(torch, fn),
                                  ms=cuda_ms(torch, fn), max_abs_err=err,
                                  stash=dt.stash.shape[0])
        log(f"main K2, L = {width}, stash {dt.stash.shape[0]}: "
            f"{out['main'][width]['device_ms']:.4f} ms device, "
            f"{out['main'][width]['ms']:.4f} events")
    for S in STASH_ROWS:
        own = rng.choice(q, size=S // 2, replace=False)
        other = np.setdiff1d(rng.integers(0, 2 ** 45, size=2 * S + 16,
                                          dtype=np.int64), q)
        sk = np.concatenate([own, rng.permutation(other)[:S - S // 2]])
        require(len(np.unique(sk)) == S, f"stash of {S}: keys repeat")
        stash = torch.from_numpy(np.stack(
            [(sk >> 25).astype(np.int32), (sk & ((1 << 25) - 1)).astype(
                np.int32), rng.integers(1, world["n_tax"] + 1, size=S).astype(
                    np.int32)], axis=1).reshape(-1, 3)).to(dev)
        cells = {}
        for name, base in (("grouped", grouped), ("single", world["dtable"])):
            dt = lookup.DeviceTable(base.rows, base.max_probes, "kmer",
                                    base.nb_bits, base.bucket, stash,
                                    group=base.group)

            def fn(dt=dt):
                return lookup.probe(dt, hi, lo, valid, 0)

            err = compare(torch, f"K2 {name}, stash {S}", fn(),
                          lookup.probe_plain(dt, hi, lo, valid, 0))
            cells[name] = dict(device_ms=device_ms(torch, fn),
                               ms=cuda_ms(torch, fn), max_abs_err=err,
                               found=int(fn()[1].sum()))
        out[S] = cells
        log(f"stash {S}: " + "; ".join(
            f"{n} {c['device_ms']:.4f} ms device, {c['ms']:.4f} events"
            for n, c in cells.items()))
    return out


def ab_worker(tree, out, mode="full"):
    """One A/B run: ``tree``'s package and ``chip_smoke.py`` phases, then
    this file's stage tables and host times; writes JSON to ``out``.
    ``mode`` "chain" runs ``chain_device_ms`` at the workload's read
    length alone, "chains" at it and at 160, "tryptic" this file's ``tryptic_ab``, "wide" its
    ``wide_ab``, "long" its ``long_ab``, "rows" its ``rows_ab``, "tail"
    its ``tail_ab``, "stash" its ``stash_ab``, "redesign" its
    ``redesign_ab``, "scored" its ``scored_ab``, "rmq" its ``rmq_ab``,
    "k9" its ``k9_ab``."""
    import importlib.util

    import torch

    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "tree_smoke", os.path.join(tree, "chip_smoke.py"))
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)
    card = t.phase_identify(torch)
    world = t.load_world(torch)
    if mode == "chain":
        with open(out, "w") as f:
            json.dump(dict(tree=tree, card=card, chain_device_ms=(
                chain_device_ms(torch, world, world["L"]))), f, default=str)
        return
    if mode == "chains":
        with open(out, "w") as f:
            json.dump(dict(tree=tree, card=card, chain_device_ms={
                width: chain_device_ms(torch, world, width)
                for width in (world["L"], 160)}), f, default=str)
        return
    if mode in ("tryptic", "wide", "long", "rows", "tail", "stash",
                "redesign", "scored", "rmq", "k9"):
        fn = dict(tryptic=tryptic_ab, wide=wide_ab, long=long_ab,
                  rows=rows_ab, tail=tail_ab, stash=stash_ab,
                  redesign=redesign_ab, scored=scored_ab, rmq=rmq_ab,
                  k9=k9_ab)[mode]
        with open(out, "w") as f:
            json.dump({"tree": tree, "card": card,
                       "ptxas": t.RESULT.get("ptxas"),
                       mode: fn(torch, world)}, f, default=str)
        return
    t.phase_kernels(torch, world)
    t.phase_gather(torch, world)
    from umgap_tpu_torch.pipeline.fused import PRESETS

    stages = {name: stage_table(torch, world, _analyser(world, PRESETS[name]))
              for name in STAGE_PRESETS}
    chain = {width: chain_device_ms(torch, world, width)
             for width in (world["L"], 160)}
    host = {name: dict(host_us=host_us(torch, k5),
                       library_host_us=host_us(torch, library))
            for name, _s, _m, _p, k5, _pl, library, _b in gather_cases(
                torch, world["dev"])}
    with open(out, "w") as f:
        json.dump(dict(tree=tree, card=card, result=t.RESULT, stages=stages,
                       host=host, chain_device_ms=chain), f, default=str)


if __name__ == "__main__":
    sys.exit(main())
