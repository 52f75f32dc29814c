"""``python -m umgap_tpu_torch``: ``analyse``, the 9-mer and tryptic
preset pipelines on the GPU, with the JAX CLI's flag names for the
subset this port runs, and the reference's stream subcommands
(:mod:`~umgap_tpu_torch.subcommands`: ``translate``, ``prot2kmer2lca``,
``seedextend``, ``uniq``, ``taxa2agg`` and the others, whose lookups,
seed-extend and aggregation run on the card).

Output records are the same FASTA as ``umgap_tpu analyse`` (one
``>header`` / consensus-taxon record per read group, header stripped at
the paired-end delimiter, input order). The run is on the current CUDA
device unless ``--device`` says otherwise; without a card it fails and
says how to ask for the CPU. ``--index`` is one file: a 9-mer index for
the 9-mer presets, a peptide index for the tryptic ones. Without
``--taxons`` or ``--index`` the data comes from the newest data version
under the config dir (``-c``, else the XDG default;
:mod:`~umgap_tpu_torch.configdir`), one index a family, so one run may
mix 9-mer and tryptic samples. ``-z`` gzips the next sample's output.

A sample goes through three ingest tiers, as in ``umgap_tpu``: the
native ring stream (:func:`run_sample_ring`: a C++ thread parses, gzip
included, and packs batches on the 4-bit wire), the native chunked
stream (:func:`run_sample_stream`: the width ladder, read widths grow
along 256, 512, ... 4,096 bp; the tryptic presets stay at
``--read-length``), and the Python reader (:func:`run_sample_fallback`:
any FASTQ the readers take). A tier hands the sample to the next only on
records that are not strictly 4-line FASTQ or on a record wider than its
width, says why on stderr under VERBOSE, and the next tier skips the
records already written. stderr is ``umgap_tpu``'s: its notes (the
host routes, FGSpp, the read-length bucket, each sample's records/s, the
analysers' stream timings) only with VERBOSE or DEBUG set
(:mod:`~umgap_tpu_torch.utils.logging`). Records of any length run: in the Python tier a 9-mer group
with a record beyond the top width takes the exact host route
(:func:`_analyse_long_group_host`), and a tryptic sample with records
beyond ``--read-length`` the host-digest route
(:func:`~umgap_tpu_torch.pipeline.tryptic.analyse_tryptic_groups`).

The precision and tryptic presets send the reads through FragGeneScan++
when it is installed under the config dir (``--fgspp auto``, the default
as in ``umgap_tpu``; ``require`` exits 1 without it, ``never`` skips it):
:func:`run_sample_fgspp` feeds FGSpp the raw records and runs the
predicted genes through :mod:`~umgap_tpu_torch.pipeline.proteins`. An
FGSpp that fails ends the run with exit 1.

``--mesh N`` serves the index over a mesh of N devices
(:func:`~umgap_tpu_torch.parallel.mesh.make_mesh`: one process over
``cuda:0`` .. ``cuda:N-1``, ``auto`` every visible card; more cards than
are visible is an error, never emulated; with ``--device cpu`` N
entries of the CPU, ``auto`` one): one ``--index`` is split on the host
into N hash-range shards, one a device, as ``umgap_tpu`` splits it
(at N = 1 it is served as it is: the records are the same), reads are
data parallel in batches rounded up to a multiple of N, and each query
goes to the device that owns its key and back
(:mod:`~umgap_tpu_torch.parallel.sharded`). ``--shards DIR`` serves a
``buildindex-dist`` artifact (the workdir or its ``shards/``; it implies
``--mesh auto``): the shards, memory-mapped, go onto the devices, each
device a group of adjacent shards
(:class:`~umgap_tpu_torch.parallel.sharded.ShardedTable`), after
``umgap_tpu``'s checks of the manifest, of the shard count against the
mesh and of the least free device memory over the mesh. Under ``--mesh``
the FGSpp presets run six-frame translation (``--fgspp require`` is
refused), and under ``--shards`` a record beyond the top device width
is an error, as in ``umgap_tpu``. ``--trace-dir`` writes a
``torch.profiler`` Chrome trace of the run.

``--serve SOCKET`` keeps the run going after its samples (there may be
none) as ``umgap_tpu``'s service does (:func:`_serve_analyse`): each
connection to the Unix socket sends one request line of
``-t/-1/-2/-z/-o`` tokens and gets ``ok <n>`` a written sample, or the
FASTA streamed back without ``-o``, or ``error <msg>``; ``quit`` stops
it. The taxonomy, the indexes (each loaded at its family's first use) and
the analysers stay on the device across requests.
"""

from __future__ import annotations

import argparse
import itertools
import sys

import numpy as np

from .pipeline.fused import PRESETS
from .pipeline.tryptic import TRYPTIC_PRESETS
from .utils import log, verbose


class CliError(Exception):
    pass


class _SampleAction(argparse.Action):
    """Records option order so ``analyse`` can rebuild per-sample groups
    (umgap-analyse.sh's repeated -1/-2/-t/-z/-o series)."""

    def __call__(self, parser, namespace, values, option_string=None):
        seq = getattr(namespace, "_sequence", None)
        if seq is None:
            seq = []
            setattr(namespace, "_sequence", seq)
        seq.append((self.dest, values))
        if self.dest != "compress":
            setattr(namespace, self.dest, values)


def _samples(args, allow_empty: bool = False):
    """Each ``-o`` closes a sample and resets type, inputs and ``-z`` to
    their defaults (umgap-analyse.sh:208-213); without ``-o`` the whole
    invocation is one stdout sample. ``--serve`` may have none."""
    return _samples_from_seq(getattr(args, "_sequence", []) or [],
                             allow_empty)


def _samples_from_seq(seq, allow_empty: bool = False):
    samples = []
    fresh = dict(type="high-precision", first=None, second=None,
                 compress=False, output=None)
    cur = dict(fresh)
    for key, val in seq:
        if key == "compress":
            cur["compress"] = True
        elif key == "output":
            if cur["first"] is None:
                raise CliError(
                    "Encountered an output file without input files.")
            cur["output"] = val
            samples.append(cur)
            cur = dict(fresh)
        else:
            cur[key] = val
    if cur["first"] is not None and not samples:
        samples.append(cur)
    elif cur["first"] is not None:
        raise CliError("Trailing input files without an output file.")
    if not samples and not allow_empty:
        raise CliError("No samples given (need at least -1 <reads>).")
    return samples


def build_parser() -> argparse.ArgumentParser:
    from .subcommands import add_parsers

    p = argparse.ArgumentParser(
        prog="umgap-tpu-torch",
        description="UMGAP analyse pipelines in PyTorch on an NVIDIA GPU")
    sub = p.add_subparsers(dest="command", required=True)
    add_parsers(sub)
    sp = sub.add_parser("analyse", help="run a preset pipeline")
    sp.add_argument("-t", "--type", action=_SampleAction,
                    default="high-precision",
                    choices=list(PRESETS) + list(TRYPTIC_PRESETS))
    sp.add_argument("-1", "--first", action=_SampleAction,
                    help="FASTQ end 1 (or single-end FASTA)")
    sp.add_argument("-2", "--second", action=_SampleAction, default=None,
                    help="FASTQ end 2")
    sp.add_argument("-o", "--output", action=_SampleAction, default=None,
                    help="output file ('-' = stdout); closes a sample group")
    sp.add_argument("-z", "--compress", action=_SampleAction, nargs=0,
                    help="gzip-compress the next output file")
    sp.add_argument("--taxons", default=None,
                    help="taxon TSV file (default: config-dir discovery, "
                         "umgap-analyse.sh:233-241)")
    sp.add_argument("--index", default=None,
                    help="index .npz: 9-mer for the 9-mer presets, "
                         "peptide for the tryptic ones (default: "
                         "config-dir discovery)")
    sp.add_argument("-c", "--configdir", default=None,
                    help="config directory for data discovery and FGSpp")
    sp.add_argument("--batch-size", type=int, default=16384,
                    help="max read groups per device batch")
    sp.add_argument("--read-length", type=int, default=160,
                    help="device read width; longer records climb the "
                         "width ladder up to 4,096 bp, then take the exact "
                         "host route (tryptic presets: the host digest)")
    sp.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain PyTorch path)")
    sp.add_argument("--fgspp", choices=["auto", "never", "require"],
                    default="auto",
                    help="FragGeneScan++ gene-prediction front end for "
                         "the precision and tryptic presets "
                         "(umgap-analyse.sh:248-251): 'auto' uses "
                         "<configdir>/FGSpp when installed, else six-frame "
                         "translation")
    sp.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler (Chrome) trace of the run "
                         "here (also UMGAP_TRACE_DIR)")
    sp.add_argument("--mesh", nargs="?", const="auto", default=None,
                    metavar="N",
                    help="serve the index split into N hash-range shards "
                         "over an N-device mesh (auto: every visible card; "
                         "with --device cpu, N entries of the CPU)")
    sp.add_argument("--shards", default=None, metavar="DIR",
                    help="serve a buildindex-dist artifact: DIR is the "
                         "build workdir (or its shards/ directory); the "
                         "shard count must be a multiple of the mesh size. "
                         "Implies --mesh auto. 9-mer presets only")
    sp.add_argument("--serve", default=None, metavar="SOCKET",
                    help="after any initial samples, keep serving: each "
                         "Unix-socket connection sends one request line "
                         "(-t TYPE -1 R1 [-2 R2] [-z] [-o OUT], "
                         "repeatable) and gets 'ok <n>' per written output "
                         "(or the FASTA streamed back without -o); the "
                         "taxonomy, indexes and analysers stay on the "
                         "device across requests ('quit' stops it)")
    sp.set_defaults(func=cmd_analyse)
    return p


# Top device width (covers full Illumina and long amplicon ranges). A
# group with a record beyond it is not clipped: it takes the exact host
# route (_analyse_long_group_host).
ANALYSE_WIDTH_CAP = 4096


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n within [lo, hi] (hi rounded down to a
    power of two), so tiny samples run small batches."""
    hi = max(lo, 1 << (max(hi, 1).bit_length() - 1))
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def _analyse_width_ladder(read_length: int):
    ladder = [read_length]
    w = 256
    while w <= ANALYSE_WIDTH_CAP:
        if w > ladder[-1]:
            ladder.append(w)
        w *= 2
    return ladder


class _SampleReroute(Exception):
    """A tier met a record it cannot handle exactly; the sample restarts
    in the next tier (the emitted-prefix skip keeps already-written
    records intact)."""


class _LongNinemerSample(_SampleReroute):
    """The sample holds records beyond the tier's width."""


class _LongTrypticSample(_SampleReroute):
    """A tryptic sample holds records beyond --read-length: the Python
    tier sends it through the host-digest route."""


def _is_tryptic(preset: str) -> bool:
    return preset in TRYPTIC_PRESETS


def _analyse_long_group_host(seqs, config, ends: int, tax, table,
                             aux_cache: dict) -> int:
    """Consensus taxon of ONE read group with records beyond the top
    device width, on the host: six-frame translation, the table's host
    probe, seed-extend and taxa2agg, the exact composition of the
    reference pipeline (translate -a | prot2kmer2lca -o | seedextend |
    uniq | taxa2agg) at any record length."""
    from .agg import host as agg_host
    from .ops import encoding
    from .ops import kmers as kmerops
    from .ops import translate
    from .ops.seedextend import apply_seedextend
    from .taxonomy import NONE

    code = encoding.get_table(config.table_number)
    hits = []
    for seq in seqs[:ends]:
        for pep in translate.translate_sequence(seq, translate.FRAME_NAMES,
                                                code):
            if len(pep) < config.k:
                continue  # prot2kmer2lca skips records shorter than k
            packed = kmerops.pack_kmers_host(encoding.encode_aa(pep),
                                             config.k)
            hi, lo = kmerops.split_packed(packed)
            vals, found = table.probe_host(hi, lo)
            taxa = [int(v) if f else 0 for v, f in zip(vals, found)]
            hits.extend(apply_seedextend(taxa, config.min_seed_size,
                                         config.max_gap_size))
    counts = agg_host.count((t, 1.0) for t in hits if t != 0)
    counts = agg_host.filter_counts(counts, config.lower_bound)
    if not counts:
        return 1
    key = ("host_agg", config.method, config.strategy, config.factor)
    aggregator = aux_cache.get(key)
    if aggregator is None:
        aggregator = aux_cache[key] = agg_host.make_aggregator(
            tax, config.method, config.strategy, config.factor)
    snapping = aux_cache.get(("host_snap",))
    if snapping is None:
        snapping = aux_cache[("host_snap",)] = tax.snapping(False)
    snapped = snapping[aggregator.aggregate(counts)]
    if snapped == NONE:
        raise CliError("Unsnappable taxon in long-record path")
    return int(snapped)


def _hand_on(tier, reason) -> None:
    verbose(f"{tier.__name__} hands the sample on: {reason}")


def _config_dir(args) -> str:
    from . import configdir

    return args.configdir or configdir.default_config_dir()


def _data_paths(args, tryptic: bool):
    """(taxonomy TSV, index) of a family: ``--taxons`` and ``--index``
    where given, the rest from the newest data version under the config
    dir that links the family's files (umgap-analyse.sh:233-241)."""
    from . import configdir

    taxons, index = args.taxons, args.index
    if taxons is None or index is None:
        conf = _config_dir(args)
        version = configdir.discover_version(conf, tryptic=tryptic,
                                             ninemer=not tryptic)
        if version is None:
            raise CliError("No data version found valid for all samples. "
                           "Please run umgap-tpu setup.")
        if taxons is None:
            taxons = configdir.resolve(conf, version, "taxons.tsv")
        if index is None:
            index = configdir.resolve(
                conf, version, "tryptic.npz" if tryptic else "ninemer.npz")
    return taxons, index


def _mesh_arg(args):
    """The ``--mesh`` argument: a device count or "auto" (``--shards``
    implies ``auto``), or None when the run is not sharded."""
    mesh = getattr(args, "mesh", None)
    if mesh is None and getattr(args, "shards", None) is not None:
        mesh = "auto"
    if mesh is None or mesh == "auto":
        return mesh
    try:
        return int(mesh)
    except ValueError:
        raise CliError(f"--mesh takes a device count or 'auto', not "
                       f"{mesh!r}") from None


def _device_bytes(mesh) -> int | None:
    """The device memory the HBM guard holds an artifact to:
    ``UMGAP_HBM_BYTES`` where set, else the least free memory over the
    mesh's cards; None on the CPU."""
    import os

    import torch

    env = os.environ.get("UMGAP_HBM_BYTES")
    if env:
        return int(float(env))
    cards = {d for d in mesh if d.type == "cuda"}
    if cards:
        return min(int(torch.cuda.mem_get_info(d)[0]) for d in cards)
    return None


def _shards_workdir(args, mesh):
    """``umgap_tpu``'s checks of a ``--shards`` artifact before it is
    read (umgap_tpu/cli.py:1287-1343): the workdir (or its ``shards/``)
    with a manifest, a shard count the mesh divides, and shard rows that
    fit 0.95 of each device's memory. Returns (workdir, manifest)."""
    import json
    import os

    workdir = os.path.normpath(args.shards)
    if os.path.basename(workdir) == "shards":
        workdir = os.path.dirname(workdir)
    man_path = os.path.join(workdir, "manifest.json")
    if not os.path.exists(man_path):
        raise CliError(
            f"no manifest.json under {workdir}; --shards takes a "
            "buildindex-dist workdir (or its shards/ directory)")
    with open(man_path) as f:
        manifest = json.load(f)
    S, n_dev = manifest["n_shards"], len(mesh)
    if S % n_dev:
        raise CliError(f"{S} shards cannot be grouped onto the "
                       f"{n_dev}-device mesh (must divide evenly)")
    per_dev_bytes = manifest.get("capacity", 0) * 8 * (S // n_dev)
    limit = _device_bytes(mesh)
    if limit and per_dev_bytes > 0.95 * limit:
        need = -(-S * manifest.get("capacity", 0) * 8 // int(0.95 * limit))
        # a valid mesh holds whole shards: the next divisor of n_shards
        feasible = [d for d in range(need, S + 1) if S % d == 0]
        if feasible:
            advice = (f"serve this artifact on a mesh of >= {feasible[0]} "
                      "devices")
        else:
            advice = (f"even one shard per device exceeds it — rebuild "
                      f"with more shards (>= {need}) via buildindex-dist "
                      "--shards")
        raise CliError(
            f"each device would hold {per_dev_bytes / 1e9:.1f} GB of "
            f"shard rows but has ~{limit / 1e9:.1f} GB; {advice}")
    return workdir, manifest


def _shards_taxons(args, manifest) -> str:
    """The taxonomy of a ``--shards`` run: ``--taxons``, else the
    manifest's when that file exists, else config-dir discovery."""
    import os

    from . import configdir

    if args.taxons is not None:
        return args.taxons
    man = manifest.get("taxons")
    if man and os.path.exists(man):
        return man
    conf = _config_dir(args)
    version = configdir.discover_version(conf)
    if version is None:
        raise CliError("No taxonomy found: pass --taxons (the shards "
                       "manifest has no usable path)")
    return configdir.resolve(conf, version, "taxons.tsv")


class AnalyseSession:
    """What one ``analyse`` invocation shares across its samples (and
    ``--serve`` requests): the parsed arguments, the mesh of a ``--mesh``
    or ``--shards`` run (None otherwise), the taxonomy on the host and on
    the device, one index a family (``tables[tryptic]``: host table, or
    None for a ``--shards`` artifact, and device table, or None where a
    mesh of more than one device serves it; :meth:`device_table`), the
    sharded tables of such a mesh (``stables[tryptic]``), and one
    analyser per (preset, batch, width, ends). A family's data is loaded
    at its first use (:meth:`load_family`)."""

    def __init__(self, args, tax, tables, dtax, device, mesh=None,
                 stables=None):
        self.args = args
        self.tax, self.dtax = tax, dtax
        self.tables = tables
        self.stables = stables or {}
        self.device = device
        self.mesh = mesh
        self.analysers: dict = {}
        # host aggregators, the host-digest step and the protein
        # analysers, kept across samples
        self.aux_cache: dict = {}

    @property
    def sharded(self) -> bool:
        """A ``--mesh`` or ``--shards`` run."""
        return self.mesh is not None

    @classmethod
    def load(cls, args, samples, device=None) -> "AnalyseSession":
        """The mesh, then the data of each family the samples need, in
        their order (:meth:`load_family`)."""
        from .device import resolve_device
        from .parallel import make_mesh

        device = resolve_device(args.device) if device is None else device
        mesh_arg = _mesh_arg(args)
        mesh = None if mesh_arg is None else make_mesh(mesh_arg, device)
        session = cls(args, None, {}, None, device, mesh)
        for s in samples:
            session.load_family(_is_tryptic(s["type"]))
        return session

    def load_family(self, tryptic: bool) -> None:
        """The taxonomy (that of the first family loaded, as
        ``umgap_tpu`` loads it) and the family's index, unless loaded; an
        index of the wrong family is refused with ``umgap_tpu``'s message.
        Under ``--shards`` the 9-mer presets take the artifact, a group of
        shards a device, after ``umgap_tpu``'s checks; under ``--mesh``
        over more than one device an index is split on the host into one
        shard a device (``umgap_tpu``'s re-split: a tryptic index needs
        stored keys); at one device it is served as it is."""
        from .index.table import load_table
        from .ops.lookup import DeviceTable

        if tryptic in self.tables:
            return
        args, mesh = self.args, self.mesh
        split = mesh is not None and len(mesh) > 1
        if mesh is not None and getattr(args, "shards", None) is not None \
                and not tryptic:
            from .index import distbuild
            from .parallel import ShardedTable

            workdir, manifest = _shards_workdir(args, mesh)
            try:
                stable = ShardedTable.from_shards(
                    distbuild.load_shards(workdir, mmap=True), mesh)
            except (FileNotFoundError, RuntimeError, ValueError) as e:
                raise CliError(str(e))
            self._set_taxonomy(_shards_taxons(args, manifest))
            if split:
                self.stables[False] = stable
                self.tables[False] = (None, None)
            else:
                self.tables[False] = (None, stable.table)
            return
        taxons, index = _data_paths(args, tryptic)
        self._set_taxonomy(taxons)
        table = load_table(index, mmap=True)
        if (table.kind == "peptide") != tryptic:
            # an index of the wrong family would probe garbage and give
            # taxon 1 everywhere
            need = "peptide (tryptic)" if tryptic else "9-mer"
            raise CliError(f"index {index} is a {table.kind} index but the "
                           f"preset needs a {need} index")
        if mesh is not None and tryptic and table.raw_keys is None:
            raise CliError(
                "--mesh tryptic serving needs an index built with stored "
                "keys (the default buildindex output)")
        if split:
            self.stables[tryptic] = _split_index(table, mesh)
            self.tables[tryptic] = (table, None)
        else:
            self.tables[tryptic] = (table, DeviceTable.from_host(
                table, self.device))

    def _set_taxonomy(self, taxons: str) -> None:
        from .agg.device import DeviceTaxonomy
        from .taxonomy import Taxonomy, read_taxa_file

        if self.tax is None:
            self.tax = Taxonomy(read_taxa_file(taxons))
            self.dtax = DeviceTaxonomy.from_host(self.tax, self.device)

    def device_table(self, tryptic: bool):
        """The family's index as one table on the session's device: what
        the host-digest route probes (made at first use where a mesh of
        more than one device serves the index)."""
        from .ops.lookup import DeviceTable

        table, dtable = self.tables[tryptic]
        if dtable is None:
            dtable = DeviceTable.from_host(table, self.device)
            self.tables[tryptic] = (table, dtable)
        return dtable

    def get_analyser(self, preset: str, B: int, L: int, ends: int):
        """The analyser of (preset, B, L, ends), B rounded up to a
        multiple of the mesh's devices (umgap_tpu/cli.py:1428-1431)."""
        from .parallel import make_sharded_stream_analyser
        from .pipeline.runner import Analyser
        from .pipeline.tryptic import TrypticAnalyser

        tryptic = _is_tryptic(preset)
        if tryptic in self.stables:
            n_dev = self.stables[tryptic].n_devices
            B = -(-B // n_dev) * n_dev
        key = (preset, B, L, ends)
        an = self.analysers.get(key)
        if an is None:
            config = (TRYPTIC_PRESETS if tryptic else PRESETS)[preset]
            if tryptic in self.stables:
                an = make_sharded_stream_analyser(
                    self.tax, self.stables[tryptic], config,
                    tryptic=tryptic, batch_size=B, read_length=L, ends=ends,
                    dtax=self.dtax)
            else:
                cls = TrypticAnalyser if tryptic else Analyser
                table, dtable = self.tables[tryptic]
                an = cls(self.tax, table, config, batch_size=B,
                         read_length=L, ends=ends, dtax=self.dtax,
                         dtable=dtable, device=self.device)
            self.analysers[key] = an
        else:
            an.reset()
        return an

    def batch_cap(self, L: int) -> int:
        # batches shrink as the width grows (a bounded device batch)
        return max(64, (self.args.batch_size * self.args.read_length) // L)

    def reset(self) -> None:
        for an in self.analysers.values():
            an.reset()


def _split_index(table, mesh):
    """One index split on the host into one hash-range shard a mesh
    device (umgap_tpu/cli.py:1264-1285 ``_build_stable``): a k-mer
    table's keys from its slots and stash, a peptide table's from its
    stored keys."""
    from .parallel import (
        ShardedTable,
        build_sharded_peptide_tables,
        build_sharded_tables,
    )

    if table.kind == "peptide":
        shards = build_sharded_peptide_tables(
            table.raw_keys, table.raw_values, n_shards=len(mesh))
    else:
        packed, values = table.items()
        shards = build_sharded_tables(packed, values, k=table.k,
                                      n_shards=len(mesh))
    return ShardedTable.from_shards(shards, mesh)


def run_sample_ring(session: AnalyseSession, sample):
    """The fastest tier: the C++ producer thread parses, encodes and
    4-bit packs reads into device batches (GIL-free); this loop only
    dispatches and drains. Yields ((header blob, offsets), taxa)
    batches, formatted natively on the output side. Records beyond
    --read-length hand the sample to the chunked tier."""
    from .io.native import NativeBatchStream

    args = session.args
    paired = bool(sample["second"])
    ends = 2 if paired else 1
    fmt = "fastq" if paired else "fasta"
    L = args.read_length
    B = max(64, args.batch_size)
    stream = NativeBatchStream(sample["first"], sample["second"], fmt, L, B)
    try:
        first = stream.next()
        if first is None:
            return
        second = stream.next()  # is the sample one batch long?
        B_an = (_pow2_bucket(first[0], 64, B)
                if second is None and first[0] < B else B)
        analyser = session.get_analyser(sample["type"], B_an, L, ends)
        B_an = analyser.batch_size  # a mesh rounds it up

        def fit(dna4, lens):
            if B_an <= dna4.shape[0]:
                return dna4[:B_an], lens[:B_an]
            pad = B_an - dna4.shape[0]
            return (np.pad(dna4, ((0, pad), (0, 0), (0, 0)),
                           constant_values=0x44),
                    np.pad(lens, ((0, pad), (0, 0))))

        batches = itertools.chain(
            [first] if second is None else [first, second],
            iter(stream.next, None))
        for n, dna4, lens, blob, offs, tmax in batches:
            if tmax > L:
                long = (_LongTrypticSample if _is_tryptic(sample["type"])
                        else _LongNinemerSample)
                raise long(f"a record of {tmax} bp is longer than "
                           f"--read-length {L}")
            d4, ln = fit(dna4, lens)
            yield from analyser.feed_packed((blob, offs), d4, ln, n)
        yield from analyser.finish_batches()
    finally:
        stream.close()


def run_sample_stream(session: AnalyseSession, sample):
    """The chunked native tier with the width ladder (tryptic presets: no
    ladder, the device digest stays at --read-length); yields (headers,
    taxa) batches in input order. Records beyond the top rung hand the
    sample to the Python tier."""
    from .pipeline.runner import stream_paired_chunks, stream_single_chunks

    args = session.args
    paired = bool(sample["second"])
    ends = 2 if paired else 1
    tryptic = _is_tryptic(sample["type"])
    ladder = ([args.read_length] if tryptic
              else _analyse_width_ladder(args.read_length))
    if paired:
        chunks = iter(stream_paired_chunks(
            sample["first"], sample["second"], args.read_length,
            width_ladder=ladder))
    else:
        chunks = iter(stream_single_chunks(
            sample["first"], args.read_length, "fasta",
            width_ladder=ladder))

    # pre-buffer up to one full batch to size the batch bucket
    buffered = []
    total = 0
    exhausted = False
    while total < args.batch_size:
        try:
            ch = next(chunks)
        except StopIteration:
            exhausted = True
            break
        buffered.append(ch)
        total += len(ch[0])
    n_hint = total if exhausted else 1 << 60

    analyser = None
    for headers, dna, lens, tmax in itertools.chain(buffered, chunks):
        Lw = dna.shape[-1]
        if tmax > ladder[-1]:
            raise (_LongTrypticSample if tryptic else _LongNinemerSample)(
                f"a record of {tmax} bp is longer than the top width "
                f"{ladder[-1]}")
        if analyser is None or Lw > analyser.read_length:
            if analyser is not None:
                verbose(f"read-length bucket {analyser.read_length} -> "
                        f"{Lw}: draining and recompiling")
                yield from analyser.finish_batches()
            B = _pow2_bucket(n_hint, 64, session.batch_cap(Lw))
            analyser = session.get_analyser(sample["type"], B, Lw, ends)
        yield from analyser.feed_batches(headers, dna, lens)
    if analyser is not None:
        yield from analyser.finish_batches()


def run_sample_fallback(session: AnalyseSession, sample):
    """The Python-reader tier (any record shape the readers take, gzip
    sniffed): the whole sample at the ladder's width that fits its
    longest record. 9-mer groups beyond the top width take the exact host
    route, merged back in input order; a tryptic sample with records
    beyond --read-length takes the host-digest route."""
    from .pipeline.runner import (
        encode_batch,
        read_groups_fasta,
        read_groups_fastq,
    )
    from .pipeline.tryptic import analyse_tryptic_groups

    args = session.args
    preset = sample["type"]
    if sample["second"]:
        groups = list(read_groups_fastq([sample["first"],
                                         sample["second"]]))
        ends = 2
    else:
        groups = list(read_groups_fasta(sample["first"]))
        ends = 1
    B = min(args.batch_size, 1024)
    if _is_tryptic(preset):
        maxlen = max((len(s) for _h, ss in groups for s in ss), default=0)
        if maxlen > args.read_length:
            verbose("tryptic sample has records beyond --read-length; "
                    "using the host-digest path (full-length digest)")
            res = analyse_tryptic_groups(
                groups, session.tax, session.tables[True][0],
                TRYPTIC_PRESETS[preset], batch_size=B, dtax=session.dtax,
                dtable=session.device_table(True),
                step_cache=session.aux_cache)
            yield from _batchify(res, B)
            return
    ladder = _analyse_width_ladder(args.read_length)
    cap = ladder[-1]
    long_idx = [i for i, (_h, ss) in enumerate(groups)
                if max((len(s) for s in ss), default=0) > cap]
    if long_idx and session.tables[False][0] is None:
        raise CliError(
            "records beyond the device width cap need the host table for "
            "the exact long-read path; --shards mode cannot serve them "
            "(pass --index instead)")
    if long_idx:
        verbose(f"{len(long_idx)} record group(s) beyond {cap} bp: exact "
                "host path")
    long_results = {i: _analyse_long_group_host(
        groups[i][1], PRESETS[preset], ends, session.tax,
        session.tables[False][0], session.aux_cache) for i in long_idx}
    short = [g for i, g in enumerate(groups) if i not in long_results]
    maxlen = max((len(s) for _h, ss in short for s in ss), default=0)
    L = next((w for w in ladder if w >= maxlen), cap)
    B = _pow2_bucket(len(short), 64, session.batch_cap(L))
    analyser = session.get_analyser(preset, B, L, ends)

    def short_batches():
        for s in range(0, len(short), B):
            chunk = short[s:s + B]
            dna, lens = encode_batch([g[1] for g in chunk], ends, L)
            yield from analyser.feed_batches([g[0] for g in chunk], dna,
                                             lens)
        yield from analyser.finish_batches()

    if not long_results:
        yield from short_batches()
        return
    # merge the host route's results back in input order
    short_taxa = (t for _hs, ts in short_batches() for t in ts.tolist())
    yield from _batchify(
        ((header, long_results[i] if i in long_results else next(short_taxa))
         for i, (header, _seqs) in enumerate(groups)), B)


def _batchify(records, n: int):
    """(header, taxon) records as (headers, taxa) batches of ``n``."""
    hs: list = []
    ts: list = []
    for h, t in records:
        hs.append(h)
        ts.append(t)
        if len(hs) == n:
            yield hs, np.asarray(ts, dtype=np.int32)
            hs, ts = [], []
    if hs:
        yield hs, np.asarray(ts, dtype=np.int32)


def raw_read_records(sample):
    """(full header, dna) records for the FGSpp front end: headers keep
    their /1 and /2 end markers, so ``uniq -d /`` merges the gene records
    of both ends later; single-end FASTA is unwrapped."""
    from .io import fasta, fastq, sniff_open

    if sample["second"]:
        handles = [sniff_open(p) for p in (sample["first"],
                                           sample["second"])]
        try:
            for group in fastq.interleave(
                    [fastq.read_records(h) for h in handles]):
                for rec in group:
                    yield rec.header, rec.sequence
        finally:
            for h in handles:
                h.close()
    else:
        with sniff_open(sample["first"]) as f:
            for rec in fasta.read_records(f, unwrap=True):
                yield rec.header, rec.sequence[0] if rec.sequence else ""


def run_sample_fgspp(session: AnalyseSession, sample, fg):
    """The gene-prediction front end: reads -> the FGSpp subprocess ->
    protein records grouped by read -> prot2kmer2lca or prot2tryp2lca
    and taxa2agg on the device (umgap-analyse.sh:299-311). Reads FGSpp
    predicts no gene for give no record, as in the reference. Yields
    (headers, taxa) batches."""
    from . import fgspp
    from .pipeline.proteins import (
        analyse_protein_groups,
        analyse_tryptic_protein_groups,
    )

    preset = sample["type"]
    tryptic = _is_tryptic(preset)
    genes = fgspp.predict_genes(fg[0], fg[1], raw_read_records(sample))
    groups = fgspp.group_genes(genes)
    table, dtable = session.tables[tryptic][0], session.device_table(tryptic)
    B = min(session.args.batch_size, 1024)
    if tryptic:
        res = analyse_tryptic_protein_groups(
            groups, session.tax, table, TRYPTIC_PRESETS[preset],
            batch_size=B, dtax=session.dtax, dtable=dtable,
            step_cache=session.aux_cache)
    else:
        res = analyse_protein_groups(
            groups, session.tax, table, PRESETS[preset], batch_size=B,
            dtax=session.dtax, dtable=dtable,
            analyser_cache=session.aux_cache)
    yield from _batchify(res, B)


TIERS = (run_sample_ring, run_sample_stream, run_sample_fallback)


def run_sample(session: AnalyseSession, sample):
    """The sample through FGSpp when its preset runs it and it is
    installed (:func:`run_sample_fgspp`), else through the tiers: a tier
    that meets input it cannot handle exactly raises, and the next tier
    restarts the sample. Reads already emitted were analysed correctly
    (the trigger lies after them in the stream), and every tier is
    order-preserving and per-read deterministic, so the rerun skips that
    prefix."""
    from . import fgspp
    from .io.native import StreamUnsupported, ensure_built

    session.load_family(_is_tryptic(sample["type"]))
    if sample["type"] in fgspp.FGSPP_PRESETS and \
            session.args.fgspp != "never":
        if session.sharded:
            # the FGSpp protein path probes the single-device table; a
            # sharded run uses six-frame translation (umgap_tpu/cli.py:
            # 1705-1712)
            if session.args.fgspp == "require":
                raise CliError(
                    "--fgspp require is not supported with --mesh; run "
                    "without --mesh or with --fgspp auto")
            fg = None
        else:
            fg = fgspp.find_fgspp(_config_dir(session.args))
        if fg is None and session.args.fgspp == "require":
            raise CliError(
                "FGSpp requested but not installed under the config dir "
                "(expected FGSpp/FGSpp + FGSpp/train).")
        if fg is not None:
            verbose(f"gene prediction via FGSpp at {fg[0]}")
            yield from run_sample_fgspp(session, sample, fg)
            return
    ensure_built()  # a failed build raises: no quiet switch of tier
    emitted = 0
    for i, tier in enumerate(TIERS):
        last = i == len(TIERS) - 1
        skip = emitted
        try:
            for hs, ts in tier(session, sample):
                n = len(ts)
                if skip >= n:
                    skip -= n
                    continue
                if skip:
                    # blob-header batches come from the first tier only,
                    # so a partial skip always slices header lists
                    hs, ts = hs[skip:], ts[skip:]
                    skip = 0
                    n = len(ts)
                emitted += n
                yield hs, ts
            return
        except (StreamUnsupported, _SampleReroute) as e:
            if last:
                raise
            _hand_on(tier, e)
            session.reset()


def write_batches(handle, batches) -> int:
    """Write (headers, taxa) batches as ``>header\ntaxon\n`` records;
    ring batches, whose headers are a (blob, offsets) pair, are
    formatted natively in one call. Returns the record count."""
    from .io import native

    n = 0
    for hs, ts in batches:
        if isinstance(hs, tuple):
            blob, offs = hs
            handle.write(native.format_output(blob, offs, ts).decode())
        else:
            handle.write("".join(
                f">{h}\n{t}\n" for h, t in zip(hs, ts.tolist())))
        n += len(ts)
    return n


def process_sample(session: AnalyseSession, sample, default_out,
                   label: str = "1") -> int:
    """One sample end to end, written to its ``-o`` file (gzipped with
    ``-z``) or to ``default_out``; returns its record count. Under
    VERBOSE it says how many records took how long, as ``umgap_tpu``
    does (``label``: the sample's number, ``srv-<n>`` for the n-th
    served one)."""
    import time

    t0 = time.perf_counter()
    out = sample["output"]
    if out in (None, "-"):
        n = write_batches(default_out, run_sample(session, sample))
    else:
        if sample["compress"]:
            import gzip

            handle = gzip.open(out, "wt")
        else:
            handle = open(out, "w")
        with handle:
            n = write_batches(handle, run_sample(session, sample))
    dt = time.perf_counter() - t0
    verbose(f"analyse sample {label}: {n} records in {dt:.3f}s "
            f"({n / max(dt, 1e-9):.0f} records/s)")
    return n


def cmd_analyse(args, stdin, stdout):
    from .device import resolve_device
    from .utils.profiling import device_trace

    samples = _samples(args, allow_empty=bool(args.serve))
    device = resolve_device(args.device)
    # the trace holds the index's way to the device too, as umgap_tpu's
    # does (its samples load their data lazily)
    with device_trace(args.trace_dir, device):
        session = AnalyseSession.load(args, samples, device)
        for i, sample in enumerate(samples):
            process_sample(session, sample, stdout, str(i + 1))
        if args.serve:
            _serve_analyse(args.serve, session)


def _serve_analyse(socket_path: str, session: AnalyseSession) -> None:
    """The sample service on a Unix socket (umgap_tpu/cli.py:1827-1909,
    byte for byte in its replies): one request line a connection, read
    with a 30 s timeout (cleared before the pipeline runs), split as a
    shell would into ``-t/-1/-2/-z/-o`` tokens
    (:func:`_parse_analyse_request`). A sample with ``-o`` answers
    ``ok <n>`` once written; without, its FASTA streams back. A failed
    request answers ``error <msg>`` (even mid-stream: FASTA replies hold
    only '>' headers and digit lines) and the service goes on; ``quit``
    answers ``bye`` and stops it. The socket is removed on exit."""
    import os
    import shlex
    import socket

    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    srv = socket.socket(socket.AF_UNIX)
    srv.bind(socket_path)
    srv.listen(8)
    log(f"analyse service listening on {socket_path}")
    count = 0
    try:
        while True:
            conn, _addr = srv.accept()
            # a silent client must not wedge the service (the request
            # line only); makefile() handles keep the socket open past
            # conn.close(), so they are closed too, and the peer sees EOF
            conn.settimeout(30)
            rfile = conn.makefile("r")
            wfile = conn.makefile("w")
            stop = False
            try:
                line = rfile.readline()
                conn.settimeout(None)
                if line and line.strip() == "quit":
                    wfile.write("bye\n")
                    wfile.flush()
                    stop = True
                elif line:
                    try:
                        for sample in _parse_analyse_request(
                                shlex.split(line)):
                            count += 1
                            n = process_sample(session, sample, wfile,
                                               f"srv-{count}")
                            if sample["output"] not in (None, "-"):
                                wfile.write(f"ok {n}\n")
                        wfile.flush()
                    except BrokenPipeError:
                        pass
                    except Exception as e:  # noqa: BLE001 — keep serving
                        try:
                            wfile.write(f"error {e}\n")
                            wfile.flush()
                        except OSError:
                            pass
            except OSError:
                pass  # the client went away mid-handshake
            finally:
                for h in (wfile, rfile):
                    try:
                        h.close()
                    except OSError:
                        pass
                conn.close()
            if stop:
                break
    finally:
        srv.close()
        try:
            os.unlink(socket_path)
        except FileNotFoundError:
            pass


def _parse_analyse_request(tokens):
    """A request's tokens -> samples, as the command line's repeated
    ``-1/-2/-t/-z/-o`` groups make them (umgap_tpu/cli.py:1912-1941)."""
    flags = {"-t": "type", "--type": "type", "-1": "first",
             "--first": "first", "-2": "second", "--second": "second",
             "-o": "output", "--output": "output"}
    presets = set(PRESETS) | set(TRYPTIC_PRESETS)
    seq = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok in ("-z", "--compress"):
            seq.append(("compress", None))
            i += 1
        elif tok in flags:
            if i + 1 >= len(tokens):
                raise CliError(f"missing value for {tok}")
            val = tokens[i + 1]
            if flags[tok] == "type" and val not in presets:
                raise CliError(
                    f"unknown preset {val!r} (choose from "
                    f"{', '.join(sorted(presets))})")
            seq.append((flags[tok], val))
            i += 2
        else:
            raise CliError(f"unknown request token {tok!r}")
    return _samples_from_seq(seq)


def main(argv=None, stdin=None, stdout=None) -> int:
    from .agg.host import AggError

    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    try:
        args = build_parser().parse_args(argv)
        args.func(args, stdin, stdout)
    except BrokenPipeError:
        return 0
    except (CliError, AggError, ValueError, OSError, NotImplementedError,
            RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
