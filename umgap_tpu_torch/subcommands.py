"""The reference's stream subcommands (``umgap_tpu``'s, src/main.rs:40-63)
with the same flags, stream formats, output quirks, exit codes and error
lines, so the shell pipelines of ``umgap-analyse.sh`` compose as they do
there. Index files are the packed ``.npz`` tables.

The text commands (``translate``, ``fastq2fasta``, ``prot2kmer``,
``prot2tryp``, ``filter``, ``uniq``, ``bestof``, ``taxa2freq``,
``snaptaxon``, ``taxonomy``, ``splitkmers``, ``joinkmers``,
``buildindex``, ``printindex``) run on the host. The commands whose work
is a batched probe, a seed-extend or an aggregation run it on the
current CUDA device (``--device`` says otherwise; without a card and
without ``--device cpu`` they exit 1 and say how to ask for the CPU):

- ``prot2kmer2lca``: a chunk's proteins through K1P (the protein entry
  of ``csrc/reads_to_kmers.cu``) and K2 (``csrc/probe_kmer.cu``); with
  ``-s`` the reference's Unix-socket server, the table on the card once;
- ``pept2lca`` and ``prot2tryp2lca`` (its digest on the host): the
  peptides of a chunk through K2 (k-mer index, peptides of its length
  packed on the host) or K8 (``csrc/probe_peptide.cu``, peptide index,
  fingerprints made on the host);
- ``seedextend``: one lane a record through K3's mask epilogue (its
  scored entries under ``-r``);
- ``taxa2agg``: (B, N) rows a chunk through K4 (weights added in input
  order under ``-s``, the lower bound at its stores), then K6 with the
  snap table, or K9 for the Euler/RMQ aggregators with it; a
  row with more than ``TAXA2AGG_KMAX`` distinct taxa runs again at its
  exact width.

``buildindex-dist`` runs the index build job
(:mod:`~umgap_tpu_torch.index.distbuild`): its TSV split through K1P and
its join (the sort, then K6's tree hybrid) on the card, the same flag
rule for ``--device``. ``setup`` installs the data (local files, or the
data server's), ``visualize`` and ``taxa2tree`` ask the Unipept API;
their network calls go through ``urllib.request.urlopen``.

They read stdin in chunks of up to ``CHUNK_RECORDS`` records (fewer
where the padded chunk would pass ``CHUNK_CELLS`` cells), launch once a
chunk, and write in input order. Inside
:func:`~umgap_tpu_torch.kernels.plain_versions` their device steps call
the kernels' plain versions on any device, as the pipeline's stages do:
the reference the kernels are held to on the card. A record that ends the run with an
error (a bad taxon id, an unknown taxon) ends it after the records
before it are written, as in ``umgap_tpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from . import ranks
from .agg import host as agg_host
from .cli import CliError
from .io import fasta, fastq
from .ops import encoding
from .ops import kmers as kmerops
from .ops import translate as transmod
from .taxonomy import NONE, Taxonomy, read_taxa_file

CHUNK_RECORDS = 16384
CHUNK_CELLS = 1 << 24
# taxa2agg's distinct taxa a row in the first pass (the presets' k_max)
TAXA2AGG_KMAX = 64


# ---------------------------------------------------------------------- #
# helpers
# ---------------------------------------------------------------------- #

def _load_taxonomy(path, with_unknown: bool = False) -> Taxonomy:
    return Taxonomy(read_taxa_file(path), with_unknown=with_unknown)


def _load_table(path, in_memory: bool = True):
    """``in_memory=False`` memory-maps the artifact (the reference's
    default mode; ``-m`` loads it into RAM, src/commands/pept2lca.rs:
    74-79); a compressed artifact is read whole."""
    from .index.table import load_table

    return load_table(path, mmap=not in_memory)


def _parse_rank(name: str) -> int:
    try:
        return ranks.rank_index(name)
    except KeyError:
        raise CliError(f"Unknown rank: {name}")


def _device(args):
    from .device import resolve_device

    return resolve_device(args.device)


def _plain() -> bool:
    from . import kernels

    return kernels.plain_selected()


def _chunks(records, width, max_records: int = CHUNK_RECORDS,
            max_cells: int = CHUNK_CELLS):
    """(records, error) chunks of ``records``: up to ``max_records``, and
    fewer where ``len * max(width)`` would pass ``max_cells`` (a chunk
    holds one record at least). An error the reader raises on bad input
    comes with the records before it, in the last chunk."""
    chunk: list = []
    wmax = 0
    it = iter(records)
    while True:
        try:
            rec = next(it)
        except StopIteration:
            break
        except (ValueError, OSError) as e:  # raised after its chunk
            yield chunk, e
            return
        w = max(wmax, width(rec))
        if chunk and (len(chunk) >= max_records
                      or (len(chunk) + 1) * w > max_cells):
            yield chunk, None
            chunk, w = [], width(rec)
        chunk.append(rec)
        wmax = w
    if chunk:
        yield chunk, None


def _parse_each(chunk, parse):
    """``parse`` of each record of a chunk, in order: (parsed, error),
    the error the first record that fails raised, the records after it
    dropped."""
    out = []
    for rec in chunk:
        try:
            out.append(parse(rec))
        except (CliError, ValueError) as e:  # raised after the others
            return out, e
    return out, None


def _lines(values) -> str:
    """Integers as the reference prints them, one a line."""
    return "".join(f"{v}\n" for v in values)


# ---------------------------------------------------------------------- #
# stream commands on the host
# ---------------------------------------------------------------------- #

def cmd_translate(args, stdin, stdout):
    try:
        table = encoding.get_table(int(args.table))
    except ValueError:
        raise CliError(f"Unknown table: {args.table}")
    frames = list(transmod.FRAME_NAMES) if args.all_frames else args.frame
    if args.show_table:
        print(table.show(), file=stdout)
        return
    writer = fasta.Writer(stdout, "", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        seq = rec.sequence[0] if rec.sequence else ""
        peptides = transmod.translate_sequence(seq, frames, table,
                                               args.methionine)
        for frame, pep in zip(frames, peptides):
            header = rec.header + "|" + frame if args.append_name \
                else rec.header
            writer.write_record(fasta.Record(header, [pep]))


def cmd_fastq2fasta(args, stdin, stdout):
    writer = fasta.Writer(stdout, "", False)
    handles = [open(p) for p in args.input]
    try:
        readers = [fastq.read_records(h) for h in handles]
        for group in fastq.interleave(readers):
            for rec in group:
                writer.write_record(fasta.Record(rec.header, [rec.sequence]))
    finally:
        for h in handles:
            h.close()


def cmd_prot2kmer(args, stdin, stdout):
    k = args.length
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        seq = rec.sequence[0]
        if len(seq) < k:
            continue
        writer.write_record(fasta.Record(
            rec.header, [seq[i:i + k] for i in range(len(seq) - k + 1)]))


def cmd_prot2tryp(args, stdin, stdout):
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=True):
        writer.write_record(fasta.Record(
            rec.header, kmerops.tryptic_digest(rec.sequence[0],
                                               args.pattern)))


def cmd_filter(args, stdin, stdout):
    contains = set(args.contains)
    lacks = set(args.lacks)
    writer = fasta.Writer(stdout, "\n", False)
    for rec in fasta.read_records(stdin, unwrap=False):
        kept = []
        for seq in rec.sequence:
            if not (args.minlen <= len(seq) <= args.maxlen):
                continue
            chars = set(seq)
            if contains <= chars and not (lacks & chars):
                kept.append(seq)
        writer.write_record(fasta.Record(rec.header, kept))


def cmd_uniq(args, stdin, stdout):
    sep = args.separator.replace("\\n", "\n")
    writer = fasta.Writer(stdout, sep, args.wrap)
    last: Optional[fasta.Record] = None
    for rec in fasta.read_records(stdin, unwrap=False):
        if args.delimiter is not None:
            idx = rec.header.find(args.delimiter)
            if idx != -1:
                rec.header = rec.header[:idx]
        if last is not None and last.header == rec.header:
            last.sequence.extend(rec.sequence)
        else:
            if last is not None:
                writer.write_record(last)
            last = rec
    if last is not None:
        writer.write_record(last)


def cmd_bestof(args, stdin, stdout):
    writer = fasta.Writer(stdout, "\n", False)

    def score(rec: fasta.Record) -> int:
        n = 0
        for item in rec.sequence:
            try:
                t = int(item)
            except ValueError:
                t = 0
            if t not in (0, 1):
                n += 1
        return n

    chunk: List[fasta.Record] = []
    for rec in fasta.read_records(stdin, unwrap=False):
        if len(chunk) < args.frames - 1:
            chunk.append(rec)
        else:
            # the frames-th record triggers the choice and is dropped
            # (src/commands/bestof.rs:57-76)
            best = None
            best_score = -1
            for r in chunk:
                s = score(r)
                if s >= best_score:  # max_by_key keeps the last maximum
                    best, best_score = r, s
            if best is not None:
                writer.write_record(best)
            chunk = []


# ---------------------------------------------------------------------- #
# seedextend: K3 on one lane a record
# ---------------------------------------------------------------------- #

def _lane_ids(flat: list, size: int) -> np.ndarray:
    """int32 lane ids of a chunk's taxa for the state machine: each value
    where it fits (0 <= v < 2^31 - 1; under ``-r`` v < size, which the
    scores read) and a distinct id past those for each other distinct
    value, so that what the machine reads of a taxon (equal or not, 0 or
    not, its score) is kept."""
    lim = size if size else 2 ** 31 - 1
    try:
        vals = np.array(flat, dtype=np.int64)
        if ((vals >= 0) & (vals < lim)).all():
            return vals.astype(np.int32)
    except OverflowError:  # an id past int64
        pass
    base = max([v + 1 for v in flat if 0 <= v < lim] + [size, 1])
    other: dict = {}
    out = [v if 0 <= v < lim else other.setdefault(v, base + len(other))
           for v in flat]
    if base + len(other) >= 2 ** 31:
        raise CliError("too many distinct taxon ids in one chunk")
    return np.array(out, dtype=np.int32)


def _seedextend_chunk(lanes, dev, args, seed_scores):
    """Keep masks of a chunk's lanes (lists of ints), K3 on the device."""
    import torch

    from .ops import seedextend as se

    R = len(lanes)
    N = max(1, max(len(t) for t in lanes))
    lens = np.array([len(t) for t in lanes], dtype=np.int32)
    size = 0 if seed_scores is None else int(seed_scores.shape[0])
    ids = _lane_ids([v for t in lanes for v in t], size)
    taxa = np.zeros((R, N), dtype=np.int32)
    rows = np.repeat(np.arange(R), lens)
    cols = np.arange(len(ids)) - np.repeat(np.cumsum(lens) - lens, lens)
    taxa[rows, cols] = ids
    tx, ln = torch.from_numpy(taxa).to(dev), torch.from_numpy(lens).to(dev)
    s, g = args.min_seed_size, args.max_gap_size
    if not _plain():
        keep = se.seedextend_mask_batch(tx, ln, s, g, seed_scores=seed_scores,
                                        penalty=args.penalty)
    elif seed_scores is None:
        keep = se.seedextend_mask_plain(tx, ln, s, g)
    else:
        keep = se.seedextend_scored_mask_plain(tx, ln, seed_scores,
                                               args.penalty, s, g)
    return keep.cpu().numpy()


def cmd_seedextend(args, stdin, stdout):
    seed_scores = None
    dev = _device(args)
    if args.ranked is not None:
        import torch

        tax = _load_taxonomy(args.ranked, with_unknown=True)
        seed_scores = torch.from_numpy(tax.seed_scores()).to(dev)
    writer = fasta.Writer(stdout, "\n", False)

    def parse(rec):
        try:
            return [int(s) for s in rec.sequence]
        except ValueError as e:
            raise CliError(str(e))

    records = fasta.read_records(stdin, unwrap=False)
    for chunk, err in _chunks(records, lambda r: len(r.sequence)):
        lanes, perr = _parse_each(chunk, parse)
        if lanes:
            keep = _seedextend_chunk(lanes, dev, args, seed_scores)
            for rec, taxa, kp in zip(chunk, lanes, keep):
                writer.write_record(fasta.Record(
                    rec.header, [str(t) for t, k in zip(taxa, kp) if k]))
        if perr is not None:
            raise perr
        if err is not None:
            raise err


# ---------------------------------------------------------------------- #
# lookups: K1P -> K2, K2, K8
# ---------------------------------------------------------------------- #

class _Lookup:
    """An index on the device for the lookup commands: ``kmer`` tables
    probed by K2, ``peptide`` tables by K8."""

    def __init__(self, table, dev):
        from .ops.lookup import DeviceTable

        self.table = table
        self.dev = dev
        self.dtable = DeviceTable.from_host(table, dev)

    def peptides(self, peptides: List[str]):
        """(values, found) int32 / bool numpy arrays for whole peptides:
        on a k-mer index those of its length, packed on the host (the
        others miss); on a peptide index their fingerprints."""
        import torch

        from .index.table import _fingerprints
        from .ops import lookup

        n = len(peptides)
        if self.table.kind == "kmer":
            k = self.table.k
            right_len = np.array([len(p) == k for p in peptides], dtype=bool)
            packed = np.zeros(n, dtype=np.uint64)
            if right_len.any():
                idx = np.flatnonzero(right_len)
                blob = "".join(peptides[i] for i in idx)
                codes = encoding.encode_aa(blob).reshape(len(idx), k)
                pk = np.zeros(len(idx), dtype=np.uint64)
                for j in range(k):
                    pk |= codes[:, j].astype(np.uint64) << np.uint64(
                        5 * (k - 1 - j))
                packed[idx] = pk
            hi, lo = kmerops.split_packed(packed)
            valid = right_len
        else:
            hi, lo = _fingerprints(list(peptides))
            valid = np.ones(n, dtype=bool)
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
             for a in (hi, lo, valid)]
        probe = lookup.probe_plain if _plain() else lookup.probe
        vals, found = probe(self.dtable, *t, default=0)
        return vals.cpu().numpy(), found.cpu().numpy()

    def proteins(self, prots: List[np.ndarray], k: int):
        """(values, found) (R, W) numpy arrays of every k-mer window of
        each protein (AA codes, each at least k long): K1P packs the
        windows, K2 probes them."""
        import torch

        from .ops import kmers, lookup

        R = len(prots)
        lens = np.array([len(p) for p in prots], dtype=np.int32)
        aa = np.zeros((R, int(lens.max())), dtype=np.uint8)
        for i, p in enumerate(prots):
            aa[i, :len(p)] = p
        p2k, probe = ((kmers.pack_windows_batch, lookup.probe_plain)
                      if _plain() else (kmers.proteins_to_kmers, lookup.probe))
        hi, lo, valid = p2k(torch.from_numpy(aa).to(self.dev),
                            torch.from_numpy(lens).to(self.dev), k)
        vals, found = probe(self.dtable, hi, lo, valid, 0)
        return vals.cpu().numpy(), found.cpu().numpy()


def _hits_text(vals, found, default_zero: bool) -> str:
    """A record's lookups as lines: the found values, and with ``-o`` a
    0 for each miss."""
    if default_zero:
        return _lines(np.where(found, vals, 0).tolist())
    return _lines(vals[found].tolist())


def cmd_pept2lca(args, stdin, stdout):
    dev = _device(args)
    look = _Lookup(_load_table(args.fst_file, in_memory=args.in_memory), dev)
    records = fasta.read_records(stdin, unwrap=False)
    for chunk, err in _chunks(records, lambda r: max(1, len(r.sequence))):
        peps = [p for rec in chunk for p in rec.sequence]
        vals, found = (look.peptides(peps) if peps
                       else (np.zeros(0, np.int32), np.zeros(0, bool)))
        out, at = [], 0
        for rec in chunk:
            n = len(rec.sequence)
            out.append(f">{rec.header}\n")
            out.append(_hits_text(vals[at:at + n], found[at:at + n],
                                  args.one_on_one))
            at += n
        stdout.write("".join(out))
        if err is not None:
            raise err


def _stream_prot2kmer2lca(look: _Lookup, k: int, default_zero: bool, stdin,
                          stdout):
    """prot2kmer2lca over one stream: records shorter than k print no
    header (src/commands/prot2kmer2lca.rs:170-172)."""
    records = fasta.read_records(stdin, unwrap=True)
    if k > 10:  # K1P packs up to 10 residues, as the host packing does
        for rec in records:
            if len(rec.sequence[0]) >= k:
                stdout.write(f">{rec.header}\n")
                raise ValueError("k must be <= 10 for 2x int32 packing")
        return
    for chunk, err in _chunks(records, lambda r: len(r.sequence[0])):
        chunk = [r for r in chunk if len(r.sequence[0]) >= k]
        if chunk:
            vals, found = look.proteins(
                [encoding.encode_aa(r.sequence[0]) for r in chunk], k)
            out = []
            for i, rec in enumerate(chunk):
                w = len(rec.sequence[0]) - k + 1
                out.append(f">{rec.header}\n")
                out.append(_hits_text(vals[i, :w], found[i, :w],
                                      default_zero))
            stdout.write("".join(out))
        if err is not None:
            raise err


def serve_prot2kmer2lca(look: _Lookup, k: int, default_zero: bool,
                        path: str) -> None:
    """The reference's ``prot2kmer2lca -s`` server
    (src/commands/prot2kmer2lca.rs:120-140): one stream a connection on
    the Unix socket ``path``, the index on the device throughout; a
    connection that fails is reported and the server goes on. Serves
    until the process is stopped."""
    import socket as socketlib

    server = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
    server.bind(path)
    server.listen()
    print("Socket created, listening for connections.", flush=True)
    try:
        while True:
            conn, _ = server.accept()
            print("Connection accepted. Processing...", flush=True)
            try:
                with conn.makefile("r") as rf, conn.makefile("w") as wf:
                    _stream_prot2kmer2lca(look, k, default_zero, rf, wf)
                print("Connection finished succesfully.", flush=True)
            except Exception as e:  # noqa: BLE001 — keep serving
                print(f"Connection died with an error: {e}", flush=True)
            finally:
                conn.close()
    finally:
        server.close()


def cmd_prot2kmer2lca(args, stdin, stdout):
    dev = _device(args)
    table = _load_table(args.fst_file, in_memory=args.in_memory)
    if table.kind != "kmer":
        raise CliError("prot2kmer2lca requires a k-mer index")
    look = _Lookup(table, dev)
    if args.socket:
        serve_prot2kmer2lca(look, args.length, args.one_on_one, args.socket)
    else:
        _stream_prot2kmer2lca(look, args.length, args.one_on_one, stdin,
                              stdout)


def cmd_prot2tryp2lca(args, stdin, stdout):
    dev = _device(args)
    look = _Lookup(_load_table(args.fst_file, in_memory=args.in_memory), dev)
    contains = set(args.keep)
    lacks = set(args.drop)

    def peptides(seq):
        return [p for p in kmerops.tryptic_digest(seq, args.pattern)
                if args.minlen <= len(p) <= args.maxlen
                and ((not contains and not lacks)
                     or (contains <= set(p) and not (lacks & set(p))))]

    records = fasta.read_records(stdin, unwrap=False)
    for chunk, err in _chunks(records, lambda r: 1):
        per = [[peptides(seq) for seq in rec.sequence] for rec in chunk]
        flat = [p for seqs in per for ps in seqs for p in ps]
        vals, found = (look.peptides(flat) if flat
                       else (np.zeros(0, np.int32), np.zeros(0, bool)))
        out, at = [], 0
        for rec, seqs in zip(chunk, per):
            n = sum(len(ps) for ps in seqs)
            out.append(f">{rec.header}\n")
            out.append(_hits_text(vals[at:at + n], found[at:at + n],
                                  args.one_on_one))
            at += n
        stdout.write("".join(out))
        if err is not None:
            raise err


# ---------------------------------------------------------------------- #
# taxa2agg: K4 -> K6 (K9 for the Euler/RMQ aggregators)
# ---------------------------------------------------------------------- #

def _f32_at_least(x: float) -> float:
    """The least float32 >= x, so that ``count >= it`` in float32 is
    ``count >= x`` as the host compares (a float32 count with a float64
    bound)."""
    f = np.float32(x)
    if np.isfinite(f) and float(f) < x:
        f = np.nextafter(f, np.float32(np.inf))
    return float(f)


class _Taxa2Agg:
    """taxa2agg's state on the device and its chunk step."""

    def __init__(self, args, dev):
        from .agg.device import DeviceTaxonomy

        self.args = args
        self.dev = dev
        self.tax = _load_taxonomy(args.taxon_file)
        self.dtax = DeviceTaxonomy.from_host(self.tax, dev)
        self.snap = self.dtax.snap_ranked if args.ranked \
            else self.dtax.snap_valid
        self.euler = None
        if (args.method, args.aggregate) == ("rmq", "lca*"):
            from .agg.device_rmq import DeviceEuler

            self.euler = DeviceEuler.from_host(self.tax, dev)
        self.lower_bound = _f32_at_least(args.lower_bound)
        t = self.tax
        # the ids the host aggregators take (the others raise
        # UnknownTaxonError); 0 is no hit
        self.known = t.present & (t.depth != NONE)

    def parse(self, rec):
        """A record's (taxon, score) pairs, taxa2agg's parse."""
        pairs = []
        for item in rec.sequence:
            if self.args.scored:
                parts = item.split("=")
                if len(parts) != 2:
                    raise CliError("Taxon without score")
                pairs.append((int(parts[0]), float(parts[1])))
            else:
                pairs.append((int(item), 1.0))
        return pairs

    def _is_known(self, t: int) -> bool:
        return 0 <= t < self.tax.size and bool(self.known[t])

    def _unknown_error(self, pairs):
        """The error the host aggregator raises for a row with an unknown
        taxon among its filtered counts, or None: the first unknown in
        first-seen order (rmq/lca*: the smallest)."""
        counts = agg_host.filter_counts(
            agg_host.count(p for p in pairs if p[0] != 0),
            self.args.lower_bound)
        bad = [t for t in counts if not self._is_known(t)]
        if not bad:
            return None
        if (self.args.method, self.args.aggregate) == ("rmq", "lca*"):
            return agg_host.UnknownTaxonError(min(bad))
        return agg_host.UnknownTaxonError(bad[0])

    def _run(self, taxa: np.ndarray, weights, k_max: int, snap: bool = True):
        """Rows (B, N) int32 (0 = none) and their weights through the
        dedup and the aggregator: numpy taxa (B,), distinct taxa (B,) and
        whether a row kept a valid hit (B,)."""
        import torch

        from .agg.device import (
            aggregate_batch,
            dedup_counts,
            dedup_counts_plain,
        )

        dedup = dedup_counts_plain if _plain() else dedup_counts
        t = torch.from_numpy(taxa).to(self.dev)
        w = None if weights is None else torch.from_numpy(weights).to(
            self.dev)
        utaxa, ucounts, uvalid, nuniq = dedup(
            t, w, k_max, return_nuniq=True, lower_bound=self.lower_bound)
        a = self.args
        out = aggregate_batch(self.dtax, utaxa, ucounts, uvalid, a.method,
                              a.aggregate, a.factor, euler=self.euler,
                              snap=self.snap if snap else None,
                              ordered=weights is not None)
        return out.cpu().numpy(), nuniq.cpu().numpy(), \
            uvalid.any(dim=-1).cpu().numpy()

    def chunk(self, rows):
        """The taxa of a chunk's parsed rows, in order, and the error of
        the first row that ends the run (None): an unknown taxon among its
        filtered counts, or an unsnappable aggregate. Results past that
        row are not computed."""
        from .pipeline.runner import wide_batch_rows

        lens = np.array([len(p) for p in rows], dtype=np.int64)
        flat = [t for pairs in rows for t, _ in pairs]
        try:
            ids = np.array(flat, dtype=np.int64)
        except OverflowError:  # an id past int64 is unknown
            ids = np.array([t if -2 ** 63 <= t < 2 ** 63 else -1
                            for t in flat], dtype=np.int64)
        size = self.tax.size
        ok = (ids == 0) | ((ids > 0) & (ids < size)
                           & self.known[np.clip(ids, 0, size - 1)])
        row_of = np.repeat(np.arange(len(rows)), lens)
        stop, stop_err = len(rows), None
        for i in np.unique(row_of[~ok]):
            err = self._unknown_error(rows[i])
            if err is not None:
                stop, stop_err = int(i), err
                break
        if stop == 0:
            return [], stop_err
        B = stop
        n = int(lens[:B].sum())
        N = max(1, int(lens[:B].max()))
        cols = np.arange(n) - np.repeat(np.cumsum(lens[:B]) - lens[:B],
                                        lens[:B])
        # the unknown ids left in these rows all fall to the lower bound:
        # they leave the rows as they leave the host's filtered counts
        taxa = np.zeros((B, N), dtype=np.int32)
        taxa[row_of[:n], cols] = np.where(ok[:n], ids[:n], 0)
        weights = None
        if self.args.scored:
            weights = np.zeros((B, N), dtype=np.float32)
            weights[row_of[:n], cols] = np.array(
                [sc for pairs in rows[:B] for _, sc in pairs],
                dtype=np.float64)
        out, nuniq, any_valid = self._run(taxa, weights, TAXA2AGG_KMAX)
        wide = np.flatnonzero(nuniq > TAXA2AGG_KMAX)
        if len(wide):
            K = int(nuniq[wide].max())
            step = wide_batch_rows(self.dev.type, self.args.method,
                                   self.args.aggregate, K)
            for s in range(0, len(wide), step):
                idx = wide[s:s + step]
                res, _n, anyv = self._run(
                    taxa[idx], None if weights is None else weights[idx], K)
                out[idx], any_valid[idx] = res, anyv
        bad = np.flatnonzero((out == 0) & any_valid)
        if len(bad) and not self.tax.present[0]:
            # K6 / K9 write 0 for an aggregate with no snapped
            # ancestor: name it as the host does
            i = int(bad[0])
            K = max(TAXA2AGG_KMAX, int(nuniq[i]))
            agg, _n, _v = self._run(
                taxa[i:i + 1], None if weights is None else weights[i:i + 1],
                K, snap=False)
            return out[:i].tolist(), CliError(
                f"Unsnappable taxon: {int(agg[0])}")
        return out.tolist(), stop_err


def cmd_taxa2agg(args, stdin, stdout):
    from .agg.device import SUPPORTED_AGGREGATIONS

    if (args.method, args.aggregate) not in SUPPORTED_AGGREGATIONS:
        _load_taxonomy(args.taxon_file)  # its errors come first there
        raise ValueError(f"{args.method} and {args.aggregate} cannot be "
                         "combined")
    agg = _Taxa2Agg(args, _device(args))
    if args.method == "rmq" and args.aggregate == "hybrid":
        print("Warning: this is a hybrid between LCA/MRTL, not LCA*/MRTL",
              file=sys.stderr)
    writer = fasta.Writer(stdout, "\n", False)
    records = fasta.read_records(stdin, unwrap=False)
    for chunk, err in _chunks(records, lambda r: len(r.sequence)):
        rows, perr = _parse_each(chunk, agg.parse)
        taxa, aerr = agg.chunk(rows)
        for rec, t in zip(chunk, taxa):
            writer.write_record(fasta.Record(rec.header, [str(t)]))
        for e in (aerr, perr, err):
            if e is not None:
                raise e


# ---------------------------------------------------------------------- #
# taxonomy commands
# ---------------------------------------------------------------------- #

def format_freq_csv(tax, counts, col_names, min_frequency: int) -> str:
    """The taxa2freq CSV (src/commands/taxa2freq.rs:104-149): the header
    row, then the rows whose sum is above ``min_frequency``, by
    descending total, ties by ascending taxon id."""
    out = ["taxon id,taxon name" + "".join("," + n for n in col_names)
           + "\n"]
    for tid, row in sorted(counts.items(), key=lambda p: (-sum(p[1]), p[0])):
        taxon = tax.get(tid)
        if taxon is None:
            raise CliError("LCA taxon id not in taxon list. Check "
                           "compatibility with index.")
        if sum(row) > min_frequency:
            out.append(f"{taxon.id},{taxon.name},"
                       + ",".join(str(c) for c in row) + "\n")
    return "".join(out)


def cmd_taxa2freq(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    rank = _parse_rank(args.rank)
    if rank == ranks.NO_RANK:
        raise CliError("Snap to an actual rank.")
    snapping = tax.rank_snapping(rank)
    numfiles = len(args.input_files)
    counts: dict[int, List[int]] = {}

    def count_stream(stream, index: int, width: int):
        for line in stream:
            line = line.rstrip("\n")
            try:
                t = int(line)
            except ValueError:
                continue  # skipped silently (taxa2freq.rs:160)
            if t < 0:
                continue
            snapped = (int(snapping[t])
                       if t < tax.size and snapping[t] != NONE else 0)
            counts.setdefault(snapped, [0] * width)[index] += 1

    if numfiles == 0:
        count_stream(stdin, 0, 1)
    else:
        for i, path in enumerate(args.input_files):
            with open(path) as f:
                count_stream(f, i, numfiles)
    col_names = args.input_files if numfiles else ["stdin"]
    stdout.write(format_freq_csv(tax, counts, col_names, args.frequency))


def cmd_snaptaxon(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    rank = _parse_rank(args.rank) if args.rank is not None else None
    if rank == ranks.NO_RANK:
        raise CliError("Snap to an actual rank.")
    snapping = tax.rank_snapping(rank, taxa=args.taxons,
                                 require_valid=not args.invalid)
    for line in stdin:
        line = line.rstrip("\n")
        if line.startswith(">"):
            stdout.write(line + "\n")
            continue
        try:
            t = int(line)
        except ValueError:
            raise CliError(f"Invalid taxon ID: {line}")
        if t < 0:
            raise CliError(f"Invalid taxon ID: {line}")
        snapped = snapping[t] if t < tax.size else NONE
        stdout.write(f"{0 if snapped == NONE else int(snapped)}\n")


def cmd_taxonomy(args, stdin, stdout):
    tax = _load_taxonomy(args.taxon_file)
    if not args.no_header:
        stdout.write("taxon_id\ttaxon_name\ttaxon_rank")
        if args.all:
            for rname in ranks.NAMED_RANKS:
                rn = rname.replace(" ", "_")
                stdout.write(f"\t{rn}_id\t{rn}_name")
        stdout.write("\n")
    for line in stdin:
        line = line.rstrip("\n")
        if line.startswith(">"):
            stdout.write(line + "\n")
            continue
        tid = int(line)
        taxon = tax.get(tid)
        if taxon is None:
            raise CliError(f"Unknown Taxon ID: {tid}")
        stdout.write(f"{taxon.id}\t{taxon.name}\t"
                     f"{ranks.rank_name(taxon.rank)}")
        if args.all:
            lineage = tax.lineage(tid)
            for r in range(1, ranks.RANK_COUNT):
                lt = lineage[r]
                if lt != NONE:
                    t2 = tax.get(int(lt))
                    stdout.write(f"\t{t2.id}\t{t2.name}")
                else:
                    stdout.write("\t\t")
        stdout.write("\n")


# ---------------------------------------------------------------------- #
# index commands
# ---------------------------------------------------------------------- #

def _tsv_rows(stdin, convert):
    for line in stdin:
        line = line.rstrip("\n")
        if not line:
            continue
        parts = line.split("\t")
        if len(parts) < 2:
            raise CliError(f"Invalid TSV row: {line!r}")
        yield convert(parts)


def cmd_splitkmers(args, stdin, stdout):
    from .index.build import split_kmers

    rows = _tsv_rows(stdin, lambda p: (int(p[0]), p[1]))
    for kmer, tid in split_kmers(rows, args.length, args.prefix):
        stdout.write(f"{kmer}\t{tid}\n")


def cmd_joinkmers(args, stdin, stdout):
    from .index.build import join_kmers

    tax = _load_taxonomy(args.taxon_file)
    rows = _tsv_rows(stdin, lambda p: (p[0], int(p[1])))
    for kmer, taxon, rank in join_kmers(rows, tax):
        stdout.write(f"{kmer}\t{taxon}\t{rank}\n")


def cmd_buildindex(args, stdin, stdout):
    import io as iomod

    from .index.build import build_table

    table = build_table(_tsv_rows(stdin, lambda p: (p[0], int(p[1]))),
                        kind=args.kind)
    buf = iomod.BytesIO()
    table.save(buf)
    getattr(stdout, "buffer", stdout).write(buf.getvalue())


def _write_kmer_items(stdout, packed, values, k: int) -> None:
    order = np.argsort(packed)
    for p, v in zip(packed[order], values[order]):
        stdout.write(f"{kmerops.unpack_kmer(int(p), k)}\t{int(v)}\n")


def cmd_printindex(args, stdin, stdout):
    if os.path.isdir(args.fst_file):
        # a buildindex-dist workdir: its shards merged into one
        # key-sorted stream, as the FST prints
        from .index import distbuild

        shards = distbuild.load_shards(args.fst_file)
        items = [t.items() for t in shards]
        packed = (np.concatenate([p for p, _ in items]) if items
                  else np.zeros(0, np.uint64))
        values = (np.concatenate([v for _, v in items]) if items
                  else np.zeros(0, np.int32))
        _write_kmer_items(stdout, packed, values,
                          shards[0].k if shards else 9)
        return
    table = _load_table(args.fst_file)
    if table.kind == "kmer":
        packed, values = table.items()
        _write_kmer_items(stdout, packed, values, table.k)
        return
    if table.raw_keys is None:
        raise CliError("index was built without stored keys")
    for key, v in sorted(zip(table.raw_keys, table.raw_values)):
        stdout.write(f"{key}\t{int(v)}\n")


def cmd_buildindex_dist(args, stdin, stdout):
    """The distributed index build with checkpoints and resume
    (:mod:`~umgap_tpu_torch.index.distbuild`; the reference's cluster
    job, scripts/build-index-phanpy.hpc.sh:1-10): its split and join on
    the card unless ``--device cpu``. The same command again resumes
    after a killed worker or driver."""
    import json

    from .index import distbuild

    if args.task:
        distbuild.worker_main(args.workdir, args.task, args.index,
                              device=args.device)
        return
    if args.repack:
        n = distbuild.repack_shards(
            args.workdir, log=lambda s: print(s, file=sys.stderr))
        stdout.write(json.dumps({"repacked": n}) + "\n")
        return
    if args.densify:
        n = distbuild.densify_shards(
            args.workdir, log=lambda s: print(s, file=sys.stderr))
        stdout.write(json.dumps({"densified": n}) + "\n")
        return
    if args.synthetic is None and (args.tsv is None or args.taxons is None):
        raise CliError("need --tsv and --taxons (or --synthetic N)")
    manifest = distbuild.drive(
        args.workdir, args.tsv, args.taxons, n_shards=args.shards,
        workers=args.workers, k=args.k,
        synthetic_rows=(int(float(args.synthetic))
                        if args.synthetic is not None else None),
        seed=args.seed, layout=args.layout, reclaim=args.reclaim,
        reclaim_input=args.reclaim_input, device=args.device)
    stdout.write(json.dumps({
        "n_keys": manifest["n_keys"],
        "n_shards": manifest["n_shards"],
        "capacity": manifest["capacity"],
        "timings_s": manifest["timings"],
        "shards_dir": os.path.join(args.workdir, "shards"),
    }) + "\n")


# ---------------------------------------------------------------------- #
# setup, visualize and taxa2tree (the data server and the Unipept API)
# ---------------------------------------------------------------------- #

TAXA2TREE_API = "http://api.unipept.ugent.be/api/v1/taxa2tree"


def cmd_taxa2tree(args, stdin, stdout):
    """The taxa of a FASTA stream counted and sent to the Unipept API's
    taxa2tree; its HTML, or with ``-u`` the URL of its gist. Needs the
    network (``urllib.request.urlopen``)."""
    import json
    from urllib import request

    taxa: dict[int, int] = {}
    for rec in fasta.read_records(stdin, unwrap=False):
        t = int(rec.sequence[0])
        taxa[t] = taxa.get(t, 0) + 1
    payload = json.dumps(
        {"counts": {str(k): v for k, v in taxa.items()},
         "link": str(args.url).lower()}).encode()
    req = request.Request(TAXA2TREE_API, data=payload,
                          headers={"Content-Type": "application/json"})
    try:
        with request.urlopen(req, timeout=30) as res:
            body = res.read().decode()
    except Exception as e:
        raise CliError(f"taxa2tree request failed: {e}")
    if args.url:
        gist = json.loads(body).get("gist", "")
        stdout.write(gist.replace("https://gist.github.com/",
                                  "https://bl.ocks.org/") + "\n")
    else:
        stdout.write(body)


def cmd_setup(args, stdin, stdout):
    """umgap-setup.sh: the config and data directories, the data version
    (asked of the server unless given), the artifacts installed from the
    server (``-y``) or from local files (``--taxons``, ``--tryptic``,
    ``--ninemer``, which need ``--version``) and symlinked into the
    config directory, then each artifact's state."""
    from . import configdir as cfg

    conf = args.configdir or cfg.default_config_dir()
    data = args.datadir or cfg.default_data_dir()
    server = args.server or cfg.DATASERVER
    local = {}
    if args.taxons:
        local["taxons.tsv"] = args.taxons
    if args.tryptic:
        local["tryptic.npz"] = args.tryptic
    if args.ninemer:
        local["ninemer.npz"] = args.ninemer
    version = args.version
    if version is None:
        if local:
            raise CliError(
                "Installing local files requires an explicit --version")
        stdout.write("Checking the latest version on the server.\n")
        try:
            version = cfg.latest_server_version(server)
        except Exception as e:
            raise CliError(f"Could not retrieve version from server: {e}")
        stdout.write(f"Latest version is {version}.\n")
    if local:
        cfg.install(conf, data, version, local,
                    log=lambda m: stdout.write(m + "\n"))
    elif args.yes:
        sources = {}
        for name, remote in (("taxons.tsv", "taxons.tsv"),
                             ("tryptic.npz", "tryptic.fst"),
                             ("ninemer.npz", "ninemer.fst")):
            if not os.path.islink(os.path.join(conf, version, name)):
                sources[name] = f"{server}/{version}/{remote}"
        if sources:
            cfg.install(conf, data, version, sources,
                        log=lambda m: stdout.write(m + "\n"))
    for name in cfg.FILES:
        link = os.path.join(conf, version, name)
        state = "available" if os.path.islink(link) else "missing"
        stdout.write(f"{name} ({version}): {state}\n")


def cmd_visualize(args, stdin, stdout):
    """umgap-visualize.sh:122-154: ``-t`` a CSV frequency table at a rank
    (taxa2freq over the inputs, its header stripped of directory names),
    ``-w`` HTML and ``-u`` a URL through taxa2tree. Gzipped inputs are
    recognised by their magic bytes."""
    import argparse
    import io
    import re
    import tempfile

    from . import configdir as cfg

    if args.taxa_rank is not None:
        taxons = args.taxons
        if taxons is None:
            conf = args.configdir or cfg.default_config_dir()
            version = cfg.discover_version(conf)
            if version is None:
                raise CliError("No taxon table found for frequency counting. "
                               "Please run umgap-tpu setup.")
            taxons = cfg.resolve(conf, version, "taxons.tsv")
        with tempfile.TemporaryDirectory() as tmp:
            # decompressed into files named as the reference's FIFOs (the
            # basename, characters other than [0-9A-Za-z.-] as '_',
            # umgap-visualize.sh:141)
            paths = []
            for p in args.input_files:
                name = re.sub(r"[^0-9A-Za-z.-]", "_", os.path.basename(p))
                dst = os.path.join(tmp, name)
                with cfg.sniff_open(p) as fsrc, open(dst, "w") as fdst:
                    fdst.write(fsrc.read())
                paths.append(dst)
            out = io.StringIO()
            ns = argparse.Namespace(rank=args.taxa_rank, frequency=1,
                                    taxon_file=taxons, input_files=paths)
            cmd_taxa2freq(ns, stdin, out)
        lines = out.getvalue().split("\n")
        if lines:
            lines[0] = re.sub(r",[^,]*/", ",", lines[0])
        stdout.write("\n".join(lines))
        return
    ns = argparse.Namespace(url=bool(args.url))
    for path in args.input_files:
        with cfg.sniff_open(path) as f:
            text = f.read()
        cmd_taxa2tree(ns, io.StringIO(text), stdout)


# ---------------------------------------------------------------------- #
# argument parsing
# ---------------------------------------------------------------------- #

_DEVICE_HELP = ("torch device (default: the current CUDA device; 'cpu' "
                "runs the plain PyTorch path)")


def add_parsers(sub) -> None:
    """The subcommands' parsers, with ``umgap_tpu``'s flags and defaults
    (umgap_tpu/cli.py:635-830); the commands that run on the device also
    take ``--device``."""
    sp = sub.add_parser("translate",
                        help="Translate DNA into amino acid sequences")
    sp.add_argument("-m", "--methionine", action="store_true")
    sp.add_argument("-a", "--all-frames", action="store_true")
    sp.add_argument("-f", "--frame", action="append", default=[],
                    choices=list(transmod.FRAME_NAMES))
    sp.add_argument("-n", "--append-name", action="store_true")
    sp.add_argument("-t", "--table", default="1")
    sp.add_argument("-s", "--show-table", action="store_true")
    sp.set_defaults(func=cmd_translate)

    sp = sub.add_parser("fastq2fasta",
                        help="Interleave FASTQ files into FASTA")
    sp.add_argument("input", nargs="+")
    sp.set_defaults(func=cmd_fastq2fasta)

    sp = sub.add_parser("prot2kmer", help="Split peptides into k-mers")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.set_defaults(func=cmd_prot2kmer)

    sp = sub.add_parser("prot2tryp",
                        help="Split peptides at tryptic cleavage sites")
    sp.add_argument("-p", "--pattern", default=kmerops.TRYPTIC_PATTERN)
    sp.set_defaults(func=cmd_prot2tryp)

    sp = sub.add_parser("filter", help="Filter peptides by length and content")
    sp.add_argument("-m", "--minlen", type=int, default=5)
    sp.add_argument("-M", "--maxlen", type=int, default=50)
    sp.add_argument("-c", "--contains", default="")
    sp.add_argument("-l", "--lacks", default="")
    sp.set_defaults(func=cmd_filter)

    sp = sub.add_parser("uniq",
                        help="Join consecutive records with equal headers")
    sp.add_argument("-s", "--separator", default="\n")
    sp.add_argument("-w", "--wrap", action="store_true")
    sp.add_argument("-d", "--delimiter", default=None)
    sp.set_defaults(func=cmd_uniq)

    sp = sub.add_parser("bestof", help="Select the best frame of each group")
    sp.add_argument("-f", "--frames", type=int, default=6)
    sp.set_defaults(func=cmd_bestof)

    sp = sub.add_parser("seedextend", help="Select promising taxon regions")
    sp.add_argument("-s", "--min-seed-size", type=int, default=2)
    sp.add_argument("-g", "--max-gap-size", type=int, default=0)
    sp.add_argument("-r", "--ranked", default=None)
    sp.add_argument("-p", "--penalty", type=int, default=5)
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    sp.set_defaults(func=cmd_seedextend)

    sp = sub.add_parser("pept2lca", help="Look up peptides in an index")
    sp.add_argument("-o", "--one-on-one", action="store_true")
    sp.add_argument("-m", "--in-memory", action="store_true",
                    help="load the index into RAM instead of "
                         "memory-mapping it")
    sp.add_argument("-c", "--chunksize", type=int, default=240,
                    help="compatibility no-op (lookups are batched)")
    sp.add_argument("fst_file")
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    sp.set_defaults(func=cmd_pept2lca)

    sp = sub.add_parser("prot2kmer2lca", help="Look up all peptide k-mers")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.add_argument("-o", "--one-on-one", action="store_true")
    sp.add_argument("-m", "--in-memory", action="store_true")
    sp.add_argument("-c", "--chunksize", type=int, default=240)
    sp.add_argument("-s", "--socket", default=None)
    sp.add_argument("fst_file")
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    sp.set_defaults(func=cmd_prot2kmer2lca)

    sp = sub.add_parser("prot2tryp2lca",
                        help="Digest and look up tryptic peptides")
    sp.add_argument("-o", "--one-on-one", action="store_true")
    sp.add_argument("-m", "--in-memory", action="store_true")
    sp.add_argument("-c", "--chunksize", type=int, default=240)
    sp.add_argument("-p", "--pattern", default=kmerops.TRYPTIC_PATTERN)
    sp.add_argument("-l", "--minlen", type=int, default=5)
    sp.add_argument("-L", "--maxlen", type=int, default=50)
    sp.add_argument("-k", "--keep", default="")
    sp.add_argument("-d", "--drop", default="")
    sp.add_argument("fst_file")
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    sp.set_defaults(func=cmd_prot2tryp2lca)

    sp = sub.add_parser("taxa2agg", help="Aggregate taxon lists per read")
    sp.add_argument("-s", "--scored", action="store_true")
    sp.add_argument("-r", "--ranked", action="store_true")
    sp.add_argument("-m", "--method", default="tree", choices=["tree", "rmq"])
    sp.add_argument("-a", "--aggregate", default="hybrid",
                    choices=["lca*", "hybrid", "mrtl"])
    sp.add_argument("-f", "--factor", type=float, default=0.25)
    sp.add_argument("-l", "--lower-bound", type=float, default=0)
    sp.add_argument("taxon_file")
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    sp.set_defaults(func=cmd_taxa2agg)

    sp = sub.add_parser("taxa2freq", help="Frequency table at a target rank")
    sp.add_argument("-r", "--rank", default="species",
                    choices=list(ranks.NAMED_RANKS))
    sp.add_argument("-f", "--frequency", type=int, default=1)
    sp.add_argument("taxon_file")
    sp.add_argument("input_files", nargs="*")
    sp.set_defaults(func=cmd_taxa2freq)

    sp = sub.add_parser("snaptaxon", help="Snap taxa to a rank or taxon set")
    sp.add_argument("-r", "--rank", default=None,
                    choices=list(ranks.NAMED_RANKS))
    sp.add_argument("-t", "--taxons", type=int, action="append", default=[])
    sp.add_argument("-i", "--invalid", action="store_true")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_snaptaxon)

    sp = sub.add_parser("taxonomy",
                        help="Annotate taxon IDs with name and rank")
    sp.add_argument("-a", "--all", action="store_true")
    sp.add_argument("-H", "--no-header", action="store_true")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_taxonomy)

    sp = sub.add_parser("splitkmers",
                        help="Split proteins into (kmer, taxid) rows")
    sp.add_argument("-k", "--length", type=int, default=9)
    sp.add_argument("-p", "--prefix", default="")
    sp.set_defaults(func=cmd_splitkmers)

    sp = sub.add_parser("joinkmers",
                        help="Aggregate sorted (kmer, taxid) rows")
    sp.add_argument("taxon_file")
    sp.set_defaults(func=cmd_joinkmers)

    sp = sub.add_parser("buildindex",
                        help="Build a packed index from sorted TSV")
    sp.add_argument("--kind", default="auto",
                    choices=["auto", "kmer", "peptide"])
    sp.set_defaults(func=cmd_buildindex)

    sp = sub.add_parser("printindex",
                        help="Print the key/value pairs in an index")
    sp.add_argument("fst_file")
    sp.set_defaults(func=cmd_printindex)

    sp = sub.add_parser(
        "buildindex-dist",
        help="Distributed multi-process index build with checkpoint/"
             "resume, its split and join on the card")
    sp.add_argument("--workdir", required=True,
                    help="shared work directory (checkpoints + artifacts)")
    sp.add_argument("--tsv", default=None,
                    help="(taxid TAB protein) input TSV")
    sp.add_argument("--taxons", default=None)
    sp.add_argument("--shards", type=int, default=16,
                    help="hash-range shards (= serving-mesh shard count)")
    sp.add_argument("--workers", type=int, default=2,
                    help="parallel worker processes")
    sp.add_argument("-k", type=int, default=9)
    sp.add_argument("--synthetic", default=None,
                    help="generate N synthetic input rows instead of "
                         "--tsv (benchmark / scale-test mode)")
    sp.add_argument("--layout", default="bucket64s",
                    choices=["bucket64s", "bucket64d", "bucket16",
                             "bucket8s"],
                    help="shard table geometry: bucket64s (default) = one "
                         "512 B row a probe (~16-32 B/key); bucket64d = "
                         "the same rows conveyor-placed at up to ~0.9 "
                         "load (~9-10 B/key) at a 2-row probe; bucket16 "
                         "= <= 2 rows at up to 0.6 load; bucket8s = one "
                         "row, small tables")
    sp.add_argument("--seed", type=int, default=7)
    sp.add_argument("--reclaim", action="store_true",
                    help="disk-bounded build: delete each stage's "
                         "consumed inputs once its outputs are "
                         "checkpointed (spills after join, joined "
                         "arrays after table build)")
    sp.add_argument("--reclaim-input", action="store_true",
                    help="treat the input --tsv as scratch: punch holes "
                         "in each consumed chunk's byte range as it is "
                         "partitioned (the file's content is destroyed; "
                         "offsets stay valid for resume)")
    sp.add_argument("--densify", action="store_true",
                    help="relayout an existing workdir's bucket64s "
                         "shards into the dense bucket64d geometry in "
                         "place (atomic per shard, re-runnable)")
    sp.add_argument("--repack", action="store_true",
                    help="relayout an existing workdir's shards into "
                         "the packed row format in place (atomic per "
                         "shard, re-runnable)")
    sp.add_argument("--device", default=None, help=_DEVICE_HELP)
    # internal: a worker's invocation
    sp.add_argument("--task", default=None,
                    choices=["partition", "join", "build"],
                    help=argparse.SUPPRESS)
    sp.add_argument("--index", default="0", help=argparse.SUPPRESS)
    # accepted as umgap_tpu's workers take it; the port's join is the card's
    sp.add_argument("--join-threads", type=int, default=1,
                    help=argparse.SUPPRESS)
    sp.set_defaults(func=cmd_buildindex_dist)

    sp = sub.add_parser("taxa2tree", help="Visualize taxa via the Unipept API")
    sp.add_argument("-u", "--url", action="store_true")
    sp.set_defaults(func=cmd_taxa2tree)

    sp = sub.add_parser(
        "setup",
        help="Install/verify taxonomy + index data (umgap-setup.sh "
             "equivalent)")
    sp.add_argument("-c", "--configdir", default=None,
                    help="config directory (XDG discovery by default)")
    sp.add_argument("-d", "--datadir", default=None,
                    help="data directory (XDG discovery by default)")
    sp.add_argument("-v", "--version", default=None,
                    help="data version (default: ask the data server)")
    sp.add_argument("-s", "--server", default=None,
                    help="data server base URL")
    sp.add_argument("--taxons", default=None,
                    help="local taxons.tsv to install (offline setup)")
    sp.add_argument("--tryptic", default=None,
                    help="local tryptic .npz index to install")
    sp.add_argument("--ninemer", default=None,
                    help="local 9-mer .npz index to install")
    sp.add_argument("-y", "--yes", action="store_true",
                    help="non-interactive: install everything requested")
    sp.set_defaults(func=cmd_setup)

    sp = sub.add_parser(
        "visualize",
        help="Visualize analysis results (umgap-visualize.sh equivalent)")
    grp = sp.add_mutually_exclusive_group(required=True)
    grp.add_argument("-t", "--taxa-rank", default=None,
                     help="CSV frequency table at this rank")
    grp.add_argument("-w", "--web", action="store_true",
                     help="HTML visualization via the Unipept API")
    grp.add_argument("-u", "--url", action="store_true",
                     help="print a shareable URL via the Unipept API")
    sp.add_argument("-c", "--configdir", default=None)
    sp.add_argument("--taxons", default=None,
                    help="taxonomy TSV (default: config-dir discovery)")
    sp.add_argument("input_files", nargs="+")
    sp.set_defaults(func=cmd_visualize)
