"""The port's stream subcommands (``python -m umgap_tpu_torch <cmd>``, on
the CPU with ``--device cpu`` where the command runs on the card) write
the bytes, exit code and stderr lines of ``umgap_tpu``'s for the same
argv and stdin: the cases of ``tests/test_cli.py``, both index kinds,
``-o`` and dropped misses, scored seed-extend on lanes past the staged
tile's 96 windows, taxa2agg over its five method x strategy pairs with
``-r``, ``-l``, ``-s`` (non-dyadic scores) and ``-f`` on rows past
k_max distinct taxa and past 1,024 entries, the socket server, and the
preset chains against ``umgap_tpu``'s chain and the port's ``analyse``.
Every comparison is exact."""

import contextlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from umgap_tpu import ranks
from umgap_tpu.agg import host as jhost
from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index import build as jbuild
from umgap_tpu.index import distbuild as jdist
from umgap_tpu.index.table import (
    CuckooKmerTable,
    PeptideTable,
    build_kmer_table,
    load_table as jload_table,
)
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.taxonomy import Taxon, Taxonomy, fixture_taxa
from umgap_tpu_torch import device as pdevice
from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.index import build as pbuild
from umgap_tpu_torch.pipeline.fused import PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AAS = "ACDEFGHIKLMNPQRSTVWY"
DEVICE_COMMANDS = ("prot2kmer2lca", "pept2lca", "prot2tryp2lca", "seedextend",
                   "taxa2agg")


def run(main, argv, stdin=""):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv, stdin=io.StringIO(stdin), stdout=out)
    return rc, out.getvalue(), err.getvalue()


def same(argv, stdin="", device=False):
    """Runs both packages' CLIs; asserts equal (rc, stdout, stderr) and
    returns it."""
    want = run(jax_cli, argv, stdin)
    got = run(port_cli, argv + (["--device", "cpu"] if device else []),
              stdin)
    assert got == want, (argv, got[0], want[0], got[2], want[2])
    return want


def _tsv(path, taxa):
    with open(path, "w") as f:
        for t in taxa:
            f.write(f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t"
                    f"{t.parent}\t{chr(1) if t.valid else chr(0)}\n")
    return str(path)


def _taxa(rng):
    """A taxonomy of ~100 taxa: ranked and unranked levels, invalid
    species, and one taxon present but not under the root (9999 below an
    absent 8888), which the aggregators refuse."""
    R = ranks.rank_index
    taxa = [Taxon(1, "root", ranks.NO_RANK, 1, True)]
    for sk in (2, 3):
        taxa.append(Taxon(sk, f"sk{sk}", R("superkingdom"), 1, True))
    for ph in range(20, 24):
        taxa.append(Taxon(ph, f"ph{ph}", R("phylum"), 2 + ph % 2, True))
    taxa.append(Taxon(50, "clade50", ranks.NO_RANK, 20, True))
    for g in range(100, 108):
        parent = 50 if g < 102 else 20 + g % 4
        taxa.append(Taxon(g, f"g{g}", R("genus"), parent, g != 105))
    for s in range(1000, 1080):
        taxa.append(Taxon(s, f"sp{s}", R("species"), 100 + s % 8,
                          bool(rng.random() < 0.85)))
    taxa.append(Taxon(1100, "strainish", ranks.NO_RANK, 1003, True))
    taxa.append(Taxon(9999, "orphan", R("species"), 8888, True))
    return taxa


def _to_dna(pep, rng):
    t1 = jenc.get_table(1)
    codons = {}
    for idx in range(125):
        a, b, c = idx // 25, (idx // 5) % 5, idx % 5
        if 4 not in (a, b, c):
            codons.setdefault(int(t1.aa[idx]), []).append((a, b, c))
    codes = []
    for ch in pep:
        opts = codons[int(jenc.AA_FROM_BYTE[ord(ch)])]
        codes.extend(opts[int(rng.integers(len(opts)))])
    return jenc.decode_dna(np.array(codes, np.uint8))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("subcommands")
    rng = np.random.default_rng(2026)
    taxa = _taxa(rng)
    taxfile = _tsv(tmp / "taxons.tsv", taxa)
    fixture = _tsv(tmp / "fixture.tsv", fixture_taxa())
    species = [t.id for t in taxa if 1000 <= t.id < 1080] + [1100]
    prots = {s: "".join(rng.choice(list(AAS), size=90)) for s in species}
    for a, b in ((1000, 1008), (1001, 1017), (1002, 1100)):
        prots[b] = prots[a][:30] + prots[b][30:]  # shared k-mers
    # a 9-mer index: each k-mer once, the taxon of one protein holding it
    kv = {}
    for s, p in prots.items():
        for i in range(len(p) - 8):
            kv.setdefault(p[i:i + 9], s)
    keys = np.array([jkmers.pack_peptide_host(jenc.encode_aa(k))
                     for k in kv], np.uint64)
    vals = np.array(list(kv.values()), np.int32)
    keep = rng.random(len(keys)) < 0.8
    kmer_idx = str(tmp / "nine.npz")
    build_kmer_table(keys[keep], vals[keep], k=9).save(kmer_idx)
    # a peptide index of the proteins' tryptic fragments
    frags = {}
    for s, p in prots.items():
        for f in jkmers.tryptic_digest(p):
            if 5 <= len(f) <= 50:
                frags.setdefault(f, s)
    pep_idx = str(tmp / "tryptic.npz")
    PeptideTable.build(list(frags), np.array(list(frags.values()),
                                             np.int32)).save(pep_idx)
    cuckoo = str(tmp / "cuckoo.npz")
    CuckooKmerTable.build(keys[:200], vals[:200], k=9).save(cuckoo)
    return dict(tmp=tmp, rng=rng, taxa=taxa, taxfile=taxfile,
                fixture=fixture, prots=prots, kmer_idx=kmer_idx,
                pep_idx=pep_idx, cuckoo=cuckoo, frags=frags)


def _proteins_fasta(world, n=80, seed=1):
    """Protein records: stretches of the indexed proteins, with noise,
    records shorter than 9, wrapped lines, stops and odd letters."""
    rng = np.random.default_rng(seed)
    prots = list(world["prots"].values())
    out = []
    for i in range(n):
        p = prots[int(rng.integers(len(prots)))]
        a = int(rng.integers(0, 60))
        s = p[a:a + int(rng.integers(3, 120))]
        if i % 7 == 3:
            s = "".join(rng.choice(list(AAS), size=len(s)))
        if i % 11 == 5:
            s = s[:5] + "*X" + s[5:]
        if i % 13 == 0:
            s = s[:4] + "B" + s[4:].lower()[:3] + s[7:]
        lines = [s[j:j + 37] for j in range(0, len(s), 37)] or [""]
        out.append(f">prot{i}|x\n" + "\n".join(lines) + "\n")
    return "".join(out)


# ---------------------------------------------------------------------- #
# host commands: tests/test_cli.py's cases and more
# ---------------------------------------------------------------------- #

FASTA_DNA = (">header1\nGATTACAAA\n>h2 desc\nATGGCATTACGGCTAGCTANNACG\n"
             "TTTAAC\n>h3\n\n>h4\nAC\n")
HOST_CASES = [
    (["translate", "-f", "1"], ">header1\nGATTACAAA\n"),
    (["translate", "-f", "1", "-f", "1R", "-n"], ">header1\nGATTACAAA\n"),
    (["translate", "-t", "11", "-s"], ""),
    (["translate", "-t", "4", "-s"], ""),
    (["translate", "-t", "7"], FASTA_DNA),
    (["translate", "-a"], FASTA_DNA),
    (["translate", "-a", "-m", "-n"], FASTA_DNA),
    (["translate", "-f", "2R", "-t", "11"], FASTA_DNA),
    (["prot2kmer"], ">header1\nDAIGDVAKAYKKAG*S\n"),
    (["prot2kmer"], ">h\nSHORT\n"),
    (["prot2kmer", "-k", "3"], ">h\nSHORTER\nAB\n>g\n\n"),
    (["prot2tryp"], ">header1\nAYKKAGVSGHVWQSDGITNCLLRGLTRVKEAVANRDSGNGYINKV"
                    "YYWTVDKRATTRDALDAGVDGIMTNYPDVITDVLN\n"),
    (["prot2tryp", "-p", "([KR])([^P])"], ">a\nKPKRRK*PR\n>b\n\n"),
    (["filter"], ">header1\nAYKKAGVSGHVWQSDGITNCLLRGLTRVKEAVANRDSGNGYINKVYY"
                 "WTVDKRATTRDALDAGVDGIMTNYPDVITDVLN\nAYK\nK\nAGVSGHVWQSDGI"
                 "TNCLLR\nGLTR\nVK\nEAVANR\nDSGNGYINK\n"),
    (["filter", "-m", "0", "-c", "R", "-l", "K"],
     ">header1\nAGVSGHVWQSDGITNCLLR\nGLTR\nVK\nEAVANR\nDSGNGYINK\n"),
    (["filter", "-M", "3"], ">all-dropped\nAAAAAA\nCCCCCC\n>b\nAK\n"),
    (["uniq", "-d", "/"],
     ">header1/1\n147206\n240495\n>header1/2\n1883\n1\n1883\n1883\n"),
    (["uniq", "-s", ","], ">a\n1\n>a\n2\n3\n>b\n4\n>a\n5\n"),
    (["uniq", "-s", "\\n", "-w"], ">a\n" + "7" * 150 + "\n>a\n8\n>b\n\n"),
    (["uniq", "-w"], ">a\n\n>b\n1\n"),
    (["bestof"], ">h|1\n9606\n9606\n2759\n9606\n8287\n>h|2\n2026807\n888268"
                 "\n186802\n1598\n1883\n>h|3\n1883\n>h|1R\n27342\n2759\n155619"
                 "\n1133106\n38033\n2\n>h|2R\n>h|3R\n2951\n"),
    (["bestof", "-f", "2"], ">a\n1\n>b\n2\n>c\n0\n>d\nx\n3\n>e\n5\n"),
    (["splitkmers", "-k", "5"], "654924\tMNAKYDTDQ\n"),
    (["splitkmers", "-k", "5", "-p", "M"], "654924\tMNAKYDTDQM\n"),
    (["splitkmers"], "1\tSHORT\n\n2\tMNAKYDTDQMNAK\n"),
    (["splitkmers"], "bad row\n"),
]


@pytest.mark.parametrize("argv,stdin", HOST_CASES,
                         ids=[f"{i}-{c[0][0]}" for i, c in
                              enumerate(HOST_CASES)])
def test_host_command_matches_jax(argv, stdin):
    same(argv, stdin)


TAX_CASES = [
    (["taxa2freq", "-r", "family", "{fx}"], "185751\n185751\n185751\n12884\n"
                                            "1\n"),
    (["taxa2freq", "-r", "family", "-f", "2", "{fx}"], "185751\n185751\n12884"
                                                       "\n"),
    (["taxa2freq", "-r", "species", "{tx}"], "1000\n1001\nfoo\n-4\n1000\n"
                                             "99999\n1100\n1100\n"),
    (["taxa2freq", "-r", "genus", "-f", "0", "{tx}"], "1\n1005\n1013\n"),
    (["snaptaxon", "-r", "superkingdom", "{fx}"], ">header1\n185751\n12884\n"
                                                  "1\n"),
    (["snaptaxon", "-t", "12884", "{fx}"], "185752\n2\n"),
    (["snaptaxon", "-r", "genus", "{tx}"], ">a\n1000\n1005\n1100\n77777\n"),
    (["snaptaxon", "-r", "genus", "-i", "{tx}"], "1005\n1013\n1100\n"),
    (["snaptaxon", "-t", "50", "-t", "3", "{tx}"], "1000\n1001\n3\n"),
    (["snaptaxon", "{tx}"], "1000\nnotanumber\n"),
    (["snaptaxon", "-r", "genus", "{tx}"], "-3\n"),
    (["taxonomy", "{fx}"], "185751\n2\n"),
    (["taxonomy", "-a", "{fx}"], ">x\n185751\n"),
    (["taxonomy", "-a", "-H", "{tx}"], "1000\n1100\n9999\n"),
    (["taxonomy", "{fx}"], "999999\n"),
    (["joinkmers", "{fx}"], "AAAAA\t185751\nAAAAA\t185752\nAAAAA\t12884\n"
                            "BBBBB\t185751\n"),
    (["joinkmers", "{tx}"], "AAAAA\t1000\nAAAAA\t1008\nAAAAA\t1016\nCCCCC\t"
                            "1005\nDDDDD\t9999\nEEEEE\t1100\nEEEEE\t1001\n"),
]


@pytest.mark.parametrize("argv,stdin", TAX_CASES,
                         ids=[f"{i}-{c[0][0]}" for i, c in
                              enumerate(TAX_CASES)])
def test_taxonomy_command_matches_jax(world, argv, stdin):
    argv = [a.replace("{fx}", world["fixture"]).replace("{tx}",
                                                        world["taxfile"])
            for a in argv]
    same(argv, stdin)


def test_fastq2fasta_matches_jax(tmp_path):
    f1, f2 = tmp_path / "a.fq", tmp_path / "b.fq"
    f1.write_text("@r1/1\nAAAA\n+\nIIII\n@r2/1\nCCCC\n+\nIIII\n@r3/1\nA\n+\n"
                  "I\n")
    f2.write_text("@r1/2\nGGGG\n+\nIIII\n@r2/2\nTTTT\n+\nIIII\n")
    same(["fastq2fasta", str(f1), str(f2)])
    same(["fastq2fasta", str(f1)])
    same(["fastq2fasta", str(tmp_path / "missing.fq")])


# ---------------------------------------------------------------------- #
# index build and printindex
# ---------------------------------------------------------------------- #

def _build_both(tsv, kind, tmp_path):
    """buildindex of both packages: (rc, loaded table) each."""
    out = []
    for main, tag in ((jax_cli, "jax"), (port_cli, "port")):
        raw = io.BytesIO()
        wrap = io.TextIOWrapper(raw)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["buildindex", "--kind", kind], stdin=io.StringIO(tsv),
                      stdout=wrap)
        wrap.flush()
        path = tmp_path / f"{tag}.npz"
        path.write_bytes(raw.getvalue())
        out.append((rc, err.getvalue(), path))
    return out


def _arrays_equal(a, b):
    assert a.kind == b.kind
    names = (("rem", "values", "stash_hi", "stash_lo", "stash_val")
             if a.kind == "kmer" else ("key_hi", "key_lo", "values"))
    for name in names:
        assert np.array_equal(np.asarray(getattr(a, name)),
                              np.asarray(getattr(b, name))), name
    assert a.max_probes == b.max_probes and a.n == b.n
    assert dict(a.meta) == dict(b.meta)


@pytest.mark.parametrize("kind", ["auto", "kmer", "peptide"])
def test_buildindex_loads_in_jax_and_equals_its_table(world, tmp_path, kind):
    if kind == "peptide":
        rows = sorted(world["frags"].items())
    else:
        rows = sorted({p[i:i + 9]: s for s, p in world["prots"].items()
                       for i in range(len(p) - 8)}.items())
    tsv = "".join(f"{k}\t{v}\n" for k, v in rows)
    (jrc, jerr, jpath), (prc, perr, ppath) = _build_both(tsv, kind, tmp_path)
    assert (prc, perr) == (jrc, jerr) == (0, "")
    _arrays_equal(jload_table(str(ppath)), jload_table(str(jpath)))
    if kind == "peptide":
        assert jload_table(str(ppath)).raw_keys == [k for k, _ in rows]
    # printindex of either package's artifact
    same(["printindex", str(ppath)])
    assert same(["printindex", str(jpath)])[1] == \
        "".join(f"{k}\t{v}\n" for k, v in rows)


def test_buildindex_refuses_duplicate_keys_and_bad_rows(tmp_path):
    for tsv in ("AAAAAAAAA\t2\nAAAAAAAAA\t3\n", "AAAAA\n", "AAAAA\tx\n"):
        (jrc, jerr, _), (prc, perr, _) = _build_both(tsv, "auto", tmp_path)
        assert (prc, perr) == (jrc, jerr)
        assert prc == 1


def test_build_kmer_index_fast_matches_jax(world):
    tsv = "".join(f"{s}\t{p}\n" for s, p in world["prots"].items())
    tsv += "1005\tSHORT\n9999\t" + world["prots"][1000][:40] + "\r\n"
    jtax = Taxonomy(world["taxa"])
    from umgap_tpu_torch.taxonomy import Taxonomy as PTaxonomy
    from umgap_tpu_torch.taxonomy import read_taxa_file

    ptax = PTaxonomy(read_taxa_file(world["taxfile"]))
    want = jbuild.build_kmer_index_fast(tsv.encode(), jtax, k=9)
    got = pbuild.build_kmer_index_fast(tsv.encode(), ptax, k=9)
    _arrays_equal(got, want)
    # and joinkmers' host oracle, k-mer for k-mer
    rows = sorted(pbuild.split_kmers(world["prots"].items(), k=9))
    expect = {k: t for k, t, _r in pbuild.join_kmers(rows, ptax)}
    assert expect == {k: t for k, t, _r in jbuild.join_kmers(
        sorted(jbuild.split_kmers(world["prots"].items(), k=9)), jtax)}
    packed, values = got.items()
    assert {jkmers.unpack_kmer(int(p), 9): int(v)
            for p, v in zip(packed, values)} == expect


def test_printindex_of_a_buildindex_dist_workdir(world, tmp_path):
    tsv = tmp_path / "proteins.tsv"
    tsv.write_text("".join(f"{s}\t{p}\n" for s, p in
                           list(world["prots"].items())[:12]))
    work = tmp_path / "work"
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO  # the build's worker processes
    try:
        jdist.drive(str(work), str(tsv), world["taxfile"], n_shards=2,
                    workers=1, layout="bucket16")
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    rc, out, _err = same(["printindex", str(work)])
    assert rc == 0 and out.count("\n") > 300
    same(["printindex", str(tmp_path / "nowhere")])


# ---------------------------------------------------------------------- #
# lookups on the device path (the CPU's plain versions here)
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("flags", [[], ["-o"], ["-m"], ["-o", "-m"],
                                   ["-k", "8"], ["-k", "10", "-o"]])
def test_prot2kmer2lca_matches_jax(world, flags):
    stdin = _proteins_fasta(world)
    rc, out, _err = same(["prot2kmer2lca", *flags, world["kmer_idx"]], stdin,
                         device=True)
    assert rc == 0
    if flags in ([], ["-o"]):
        assert out.count(">") > 40 and out.count("\n") > 1000


def test_prot2kmer2lca_edge_streams(world):
    for stdin in ("", ">h\nSHORT\n", ">h\nDAIGDVAKAXX\n", "no header\n",
                  ">a\n" + world["prots"][1000] + "\nbad\n>b\nx\n"):
        same(["prot2kmer2lca", "-o", world["kmer_idx"]], stdin, device=True)
    # k past 10: the header of the first record long enough, then the error
    same(["prot2kmer2lca", "-k", "11", world["kmer_idx"]],
         ">a\nSHORT\n>b\n" + world["prots"][1000] + "\n", device=True)


def test_prot2kmer2lca_refuses_other_indexes(world):
    same(["prot2kmer2lca", world["pep_idx"]], ">a\nAAAAAAAAAA\n",
         device=True)
    rc, out, err = run(port_cli, ["prot2kmer2lca", world["cuckoo"],
                                  "--device", "cpu"], ">a\nAAAAAAAAAA\n")
    assert rc == 1 and out == "" and "cuckoo" in err


def _peptide_fasta(world, seed=3):
    rng = np.random.default_rng(seed)
    frags = list(world["frags"])
    nine = [p[i:i + 9] for p in world["prots"].values()
            for i in range(0, len(p) - 8, 13)]
    recs = []
    for i in range(60):
        items = []
        for _ in range(int(rng.integers(0, 12))):
            r = rng.random()
            if r < 0.35:
                items.append(frags[int(rng.integers(len(frags)))])
            elif r < 0.7:
                items.append(nine[int(rng.integers(len(nine)))])
            elif r < 0.8:
                items.append("".join(rng.choice(list(AAS), size=9)))
            else:
                items.append("".join(rng.choice(
                    list(AAS), size=int(rng.integers(1, 30)))))
        recs.append(f">pep{i}\n" + "".join(x + "\n" for x in items))
    return "".join(recs)


@pytest.mark.parametrize("index", ["kmer_idx", "pep_idx"])
@pytest.mark.parametrize("flags", [[], ["-o"], ["-m", "-c", "7"]])
def test_pept2lca_matches_jax(world, index, flags):
    rc, out, _err = same(["pept2lca", *flags, world[index]],
                         _peptide_fasta(world), device=True)
    assert rc == 0 and out.count(">") == 60
    same(["pept2lca", *flags, world[index]], ">h\n>g\n\nAAAAAAAAA\n",
         device=True)


@pytest.mark.parametrize("index", ["kmer_idx", "pep_idx"])
@pytest.mark.parametrize("flags", [[], ["-o"], ["-l", "9", "-L", "9"],
                                   ["-k", "K", "-d", "C"], ["-d", "W", "-o"],
                                   ["-p", "([KR])([^P])", "-l", "3"]])
def test_prot2tryp2lca_matches_jax(world, index, flags):
    stdin = _proteins_fasta(world, n=50, seed=4).replace("\n>", "\nAK\n>")
    rc, out, _err = same(["prot2tryp2lca", *flags, world[index]], stdin,
                         device=True)
    assert rc == 0


# ---------------------------------------------------------------------- #
# seedextend
# ---------------------------------------------------------------------- #

def _lanes_fasta(rng, n, lo, hi, ids, zero=0.4, runs=True):
    recs = []
    for i in range(n):
        L = int(rng.integers(lo, hi + 1))
        vals = []
        while len(vals) < L:
            t = 0 if rng.random() < zero else int(rng.choice(ids))
            vals.extend([t] * (int(rng.integers(1, 5)) if runs else 1))
        recs.append(f">lane{i}\n" + "".join(f"{v}\n" for v in vals[:L]))
    return "".join(recs)


@pytest.mark.parametrize("s,g", [(1, 0), (2, 0), (2, 1), (3, 1), (4, 2),
                                 (0, 1)])
def test_seedextend_matches_jax(world, s, g):
    rng = np.random.default_rng(10 * s + g)
    ids = [1000, 1001, 1003, 105, 20, 2]
    stdin = _lanes_fasta(rng, 70, 0, 140, ids)
    rc, out, _err = same(["seedextend", "-s", str(s), "-g", str(g)], stdin,
                         device=True)
    assert rc == 0


@pytest.mark.parametrize("s,g,p", [(2, 1, 5), (3, 0, 1), (1, 2, 12)])
def test_seedextend_ranked_matches_jax(world, s, g, p):
    """Scored seed-extend (``-r``): lanes of up to 420 windows, past the
    staged tile's 96, with unknown and out-of-range ids."""
    rng = np.random.default_rng(7 * s + g + p)
    ids = [1000, 1001, 1003, 1100, 105, 50, 20, 2, 1, 9999, 123456]
    stdin = _lanes_fasta(rng, 50, 0, 420, ids, zero=0.3)
    rc, out, _err = same(["seedextend", "-r", world["taxfile"], "-s", str(s),
                          "-g", str(g), "-p", str(p)], stdin, device=True)
    assert rc == 0 and out.count(">") == 50


def test_seedextend_odd_ids_and_errors(world):
    same(["seedextend", "-s", "1"],
         ">a\n-5\n-5\n0\n99999999999999999999\n99999999999999999999\n7\n"
         ">b\n2147483647\n2147483647\n-1\n", device=True)
    same(["seedextend", "-r", world["taxfile"]],
         ">a\n-5\n-5\n0\n1000\n1000\n", device=True)
    same(["seedextend"], ">a\n1\n1\n>b\n1\nx\n>c\n2\n2\n", device=True)
    same(["seedextend", "-r", str(world["tmp"] / "none.tsv")], ">a\n1\n",
         device=True)


# ---------------------------------------------------------------------- #
# taxa2agg
# ---------------------------------------------------------------------- #

PAIRS = [("tree", "hybrid"), ("tree", "lca*"), ("rmq", "mrtl"),
         ("rmq", "lca*"), ("rmq", "hybrid")]
SCORES = (0.1, 0.3, 0.7, 1.1, 0.2, 2.5)


def _taxa_records(rng, n, known, lo=0, hi=40, scored=False):
    recs = []
    for i in range(n):
        items = []
        for _ in range(int(rng.integers(lo, hi + 1))):
            t = 0 if rng.random() < 0.15 else int(rng.choice(known))
            items.append(f"{t}={rng.choice(SCORES)}" if scored else str(t))
        recs.append(f">r{i}\n" + "".join(x + "\n" for x in items))
    return "".join(recs)


def _known(world):
    return [t.id for t in world["taxa"] if t.id != 9999]


@pytest.mark.parametrize("method,strategy", PAIRS)
@pytest.mark.parametrize("flags", [[], ["-r"], ["-l", "2"],
                                   ["-s", "-l", "0.7"],
                                   ["-s", "-r", "-f", "0.3"]])
def test_taxa2agg_matches_jax(world, method, strategy, flags):
    rng = np.random.default_rng(len(flags) * 10 + PAIRS.index(
        (method, strategy)))
    stdin = _taxa_records(rng, 60, _known(world), scored="-s" in flags)
    argv = ["taxa2agg", "-m", method, "-a", strategy, *flags,
            world["taxfile"]]
    rc, out, err = same(argv, stdin, device=True)
    assert rc == 0 and out.count(">") == 60


@pytest.mark.parametrize("method,strategy", PAIRS)
def test_taxa2agg_wide_rows_match_jax(world, method, strategy):
    """Rows past k_max = 64 distinct taxa and past 1,024 entries, with
    non-dyadic scores: the wide pass, and K4's rows in input order."""
    rng = np.random.default_rng(99)
    known = _known(world)
    narrow = _taxa_records(rng, 6, known, 0, 30, scored=True)
    wide = _taxa_records(rng, 4, known, 1100, 1500, scored=True)
    assert len(known) > 64
    for flags in (["-s"], ["-s", "-l", "3.3", "-f", "0.1"]):
        same(["taxa2agg", "-m", method, "-a", strategy, *flags,
              world["taxfile"]], narrow + wide + narrow, device=True)
    same(["taxa2agg", "-m", method, "-a", strategy, world["taxfile"]],
         _taxa_records(rng, 3, known, 1030, 1100), device=True)


@pytest.mark.parametrize("method,strategy", PAIRS)
def test_taxa2agg_errors_match_jax(world, method, strategy):
    """An unknown taxon ends the run after the records before it unless
    the lower bound drops it; so do bad ids and scores."""
    tf = world["taxfile"]
    base = ["taxa2agg", "-m", method, "-a", strategy]
    ok = ">a\n1000\n1001\n"
    for stdin in (ok + ">b\n1000\n9999\n1001\n" + ok,
                  ok + ">b\n77777\n-4\n1000\n",
                  ok + ">b\n-4\n77777\n" + ok,
                  ok + ">b\n1000\nx\n"):
        same(base + [tf], stdin, device=True)
    # the bound drops the unknown taxa: no error
    same(base + ["-l", "2", tf], ">a\n1000\n1000\n9999\n77777\n-4\n",
         device=True)
    for stdin in (">a\n1000=0.5\n1001\n", ">a\n1000=x\n", ">a\n1000=1=2\n"):
        same(base + ["-s", tf], ok.replace("\n1", "=1\n1").replace(
            "1001\n", "1001=0.25\n") + stdin, device=True)


def test_taxa2agg_fixture_cases_and_bad_pairs(world):
    fx = world["fixture"]
    for argv, stdin in (
            ([fx], ">header1\n185751\n185751\n12884\n12884\n1\n12884\n"),
            ([fx], ">h\n0\n0\n"),
            ([fx], ">h\n"),
            (["-m", "rmq", "-a", "mrtl", "-l", "1", fx],
             ">h\n185751\n12884\n185751\n"),
            (["-a", "lca*", fx], ">h\n185751\n185752\n"),
            (["-s", fx], ">h\n185751=0.9\n185752=0.1\n"),
            (["-m", "tree", "-a", "mrtl", fx], ">h\n1\n"),
            ([str(world["tmp"] / "none.tsv")], ">h\n1\n")):
        same(["taxa2agg", *argv], stdin, device=True)


def test_weighted_dedup_adds_in_input_order():
    """K4's plain versions add a taxon's weights in float32 in input
    order, as agg::count does, where prefix differences would round
    otherwise."""
    rng = np.random.default_rng(5)
    B, N = 24, 1200
    taxa = rng.integers(0, 6, size=(B, N)).astype(np.int32)
    w = rng.choice(np.array(SCORES, np.float32), size=(B, N))
    want = []
    for b in range(B):
        c = jhost.count((int(t), float(x)) for t, x in zip(taxa[b], w[b])
                        if t != 0)
        want.append(c)
    for fn in (pagg.dedup_counts_plain, pagg.dedup_counts_rows_plain):
        u, c, v = fn(torch.from_numpy(taxa), torch.from_numpy(w), 8)
        for b in range(B):
            got = {int(t): float(x) for t, x, ok in
                   zip(u[b].tolist(), c[b].tolist(), v[b].tolist()) if ok}
            assert got == want[b], fn.__name__


def _ordered_reference(geom, root, strategy, ids, cnt, factor):
    """hybrid or mrtl on one group's valid ids and float32 counts in slot
    order, adding as ``umgap_tpu``'s TreeMix and RmqRTL add over a
    group in first-seen order: hybrid's a_base and branch sums with
    numpy's float32 sums (of the slots below x for a branch), mrtl's
    scores one ancestor at a time in slot order from 0."""
    f32 = np.float32
    size = len(geom)
    cnt = np.asarray(cnt, f32)
    lin = geom[np.clip(ids, 0, size - 1), 1:]
    D = lin.shape[1]
    n = len(ids)
    if strategy == "hybrid":
        a_base = cnt.sum(dtype=f32)
        x = root
        for d in range(D - 1):
            below = (lin[:, d + 1] != -1) & (lin[:, d] == x)
            if not below.any():
                break
            branches = sorted({int(b) for b in lin[below, d + 1]})
            if len(branches) == 1:
                x = branches[0]
                continue
            sums = {br: cnt[below & (lin[:, d + 1] == br)].sum(dtype=f32)
                    for br in branches}
            mx = max(sums.values())
            best = min(b for b in branches if sums[b] == mx)
            if f32(mx) / f32(a_base) < f32(factor):
                break
            x, a_base = best, mx
        return x
    dep = np.maximum(geom[np.clip(ids, 0, size - 1), 0], 0)
    at = np.minimum(dep, D - 1)
    best = None
    for j in range(n):
        acc = f32(0)
        for i in range(n):
            if lin[j, at[i]] == ids[i]:
                acc = f32(acc + cnt[i])
        key = (acc, int(dep[j]), -int(ids[j]))
        if best is None or key > best:
            best = key
    return -best[2]


@pytest.mark.parametrize("strategy", ["hybrid", "mrtl"])
@pytest.mark.parametrize("K", [16, 64, 300])
def test_plain_aggregators_add_in_k6s_order(world, strategy, K):
    """With non-dyadic counts (taxa2agg -s), whose sums across taxa round
    by the order of their adds, the plain aggregators (the reference K6
    is held to on the card) and the block path's plain formulation add
    in ``umgap_tpu``'s order (K6's ordered instances), past 128 slots
    too, where numpy's sums split in halves."""
    from umgap_tpu_torch.taxonomy import Taxon as PTaxon
    from umgap_tpu_torch.taxonomy import Taxonomy as PTaxonomy

    tax = PTaxonomy([PTaxon(t.id, t.name, t.rank, t.parent, t.valid)
                     for t in world["taxa"]])
    dtax = pagg.DeviceTaxonomy.from_host(tax, "cpu")
    geom = dtax.geom.numpy()
    ids = np.array([i for i in _known(world) if tax.depth[i] >= 1])
    rng = np.random.default_rng(K)
    weights = np.array(SCORES[:5], np.float32)
    B = 40
    u = np.full((B, K), pagg.I32_MAX, np.int32)
    c = np.zeros((B, K), np.float32)
    v = np.zeros((B, K), bool)
    for b in range(B):
        m = min(K, len(ids), (1, 2, 3, 5, 17, K, int(rng.integers(1, K + 1)))[
            b % 7])
        sel = np.sort(rng.choice(ids, size=m, replace=False))
        u[b, :m] = sel
        for e in range(m):  # a few weights added in float32, as K4 does
            acc = np.float32(0)
            for x in rng.choice(weights, size=int(rng.integers(1, 4))):
                acc = np.float32(acc + x)
            c[b, e] = acc
        v[b, :m] = True
        if b % 4 == 3:
            v[b] &= rng.random(K) < 0.7
            v[b, 0] = True
    ut, ct, vt = torch.from_numpy(u), torch.from_numpy(c), torch.from_numpy(v)
    assert not pagg.exact_sums(ct)
    for factor in (0.25, 0.5, 0.7, 1.0) if strategy == "hybrid" else (0.25,):
        want = [_ordered_reference(geom, dtax.root, strategy, u[b][v[b]],
                                   c[b][v[b]], factor) for b in range(B)]
        got = pagg.tree_aggregate_hits_plain(strategy, dtax, ut, ct, vt,
                                             factor)
        assert got.tolist() == want, factor
        wide = pagg.tree_aggregate_wide_plain(strategy, dtax, ut, ct, vt,
                                              factor)
        assert wide.tolist() == want, factor


def test_ordered_sums_leave_integer_counts_as_they_were(world):
    """Integer counts sum exactly in any order: ``exact_sums`` holds, and
    the Euler/RMQ hybrid's ordered sums give what its reductions give."""
    from umgap_tpu_torch.agg import device_rmq as prmq
    from umgap_tpu_torch.taxonomy import Taxon as PTaxon
    from umgap_tpu_torch.taxonomy import Taxonomy as PTaxonomy

    tax = PTaxonomy([PTaxon(t.id, t.name, t.rank, t.parent, t.valid)
                     for t in world["taxa"]])
    dtax = pagg.DeviceTaxonomy.from_host(tax, "cpu")
    rng = np.random.default_rng(3)
    ids = np.array([i for i in _known(world) if tax.depth[i] >= 1])
    B, K = 50, 24
    u = np.sort(np.stack([rng.choice(ids, size=K, replace=False)
                          for _ in range(B)]), axis=1).astype(np.int32)
    c = rng.integers(1, 9, size=(B, K)).astype(np.float32)
    v = rng.random((B, K)) < 0.6
    ut, ct, vt = torch.from_numpy(u), torch.from_numpy(c), torch.from_numpy(v)
    assert pagg.exact_sums(ct) and not pagg.exact_sums(ct * 0.1)
    x = torch.tensor([[0.1, 0.2, 0.3], [1.0, 2.0, 3.0]])
    assert pagg.fold_sum(x).tolist() == [
        float(np.float32(np.float32(np.float32(0.1) + np.float32(0.2))
                         + np.float32(0.3))), 6.0]
    for factor in (0.25, 0.6):
        assert torch.equal(
            prmq.rmq_mix_batch(dtax, ut, ct, vt, factor, ordered=True),
            prmq.rmq_mix_batch(dtax, ut, ct, vt, factor))


def test_device_commands_refuse_without_a_card(world):
    assert not torch.cuda.is_available()
    for cmd, extra in (("prot2kmer2lca", [world["kmer_idx"]]),
                       ("pept2lca", [world["pep_idx"]]),
                       ("prot2tryp2lca", [world["pep_idx"]]),
                       ("seedextend", []),
                       ("taxa2agg", [world["taxfile"]])):
        assert cmd in DEVICE_COMMANDS
        rc, out, err = run(port_cli, [cmd, *extra], ">a\n1\n")
        assert rc == 1 and out == "", cmd
        assert pdevice.CPU_HINT in err, cmd


# ---------------------------------------------------------------------- #
# the socket server
# ---------------------------------------------------------------------- #

def _serve(cmd, sock, env):
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    t0 = time.time()
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() - t0 > 60:
            proc.kill()
            raise AssertionError(f"server did not start: "
                                 f"{proc.communicate()[1][-2000:]}")
        time.sleep(0.05)
    return proc


def _connect(sock, data):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(60)
        c.connect(sock)
        c.sendall(data.encode())
        c.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = c.recv(65536)
            if not b:
                break
            chunks.append(b)
    return b"".join(chunks).decode()


def test_prot2kmer2lca_socket_server_matches_jax(world, tmp_path):
    """``-s``: one stream a connection, a connection that fails leaves
    the server serving, the same stdout lines; each server is its own
    process, stopped at the end."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    stdin = _proteins_fasta(world, n=30, seed=8)
    streams = (stdin, "no header\n", stdin, "")
    replies, logs = [], []
    for pkg, extra in (("umgap_tpu", []),
                       ("umgap_tpu_torch", ["--device", "cpu"])):
        sock = str(tmp_path / f"{pkg}.sock")
        proc = _serve([sys.executable, "-m", pkg, "prot2kmer2lca", "-o",
                       "-s", sock, world["kmer_idx"], *extra], sock, env)
        try:
            replies.append([_connect(sock, s) for s in streams])
        finally:
            proc.terminate()
            out, _err = proc.communicate(timeout=60)
        logs.append(out)
    assert replies[1] == replies[0]
    assert replies[0][0] == replies[0][2] != ""
    assert replies[0][1] == "" and replies[0][3] == ""
    assert logs[1] == logs[0]
    assert "Connection died with an error" in logs[0]
    want = run(jax_cli, ["prot2kmer2lca", "-o", world["kmer_idx"]], stdin)
    assert replies[1][0] == want[1]


def test_prot2kmer2lca_server_serves_until_killed(world, tmp_path):
    """The port's server (without ``-o``) in a process of its own: three
    connections, the second failing, each good one writing the records
    of the command on stdin; the server serves on until it is killed."""
    env = dict(os.environ, PYTHONPATH=REPO)
    sock = str(tmp_path / "t.sock")
    stdin = _proteins_fasta(world, n=20, seed=9)
    proc = _serve([sys.executable, "-m", "umgap_tpu_torch", "prot2kmer2lca",
                   "-s", sock, world["kmer_idx"], "--device", "cpu"], sock,
                  env)
    try:
        first = _connect(sock, stdin)
        assert _connect(sock, "no header\n") == ""
        assert _connect(sock, stdin) == first
        assert proc.poll() is None
    finally:
        proc.kill()
        out, _err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert first == run(jax_cli, ["prot2kmer2lca", world["kmer_idx"]],
                        stdin)[1]
    assert out.count("Connection finished succesfully.") == 2
    assert out.count("Connection died with an error") == 1


# ---------------------------------------------------------------------- #
# the preset chains
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def reads(world):
    rng = np.random.default_rng(17)
    prots = list(world["prots"].values())
    out = []
    for i in range(40):
        p = prots[i % len(prots)]
        a = int(rng.integers(0, 40))
        r1 = _to_dna(p[a:a + int(rng.integers(12, 30))], rng)
        r2 = _to_dna(p[a + 10:a + 10 + int(rng.integers(12, 30))], rng)
        if i % 6 == 0:
            r1 = "".join(rng.choice(list("ACGT"), size=len(r1)))
        out.append((f"read{i}", r1, r2))
    return out


def _chain(main, preset, world, fasta_in, extra=()):
    cfg = PRESETS[preset]
    steps = [["translate", "-a"],
             ["prot2kmer2lca", "-o", world["kmer_idx"], *extra],
             ["seedextend", f"-g{cfg.max_gap_size}", f"-s{cfg.min_seed_size}",
              *extra],
             ["uniq", "-d", "/"],
             ["taxa2agg", "-l", str(int(cfg.lower_bound)), "-m", cfg.method,
              "-a", cfg.strategy, "-f", str(cfg.factor), world["taxfile"],
              *extra]]
    s = fasta_in
    for argv in steps:
        rc, s, err = run(main, [a for a in argv if a != ""], s)
        assert rc == 0, (argv, err)
    return s


@pytest.mark.parametrize("preset", ["max-sensitivity", "high-sensitivity",
                                    "high-precision", "max-precision"])
def test_chain_matches_jax_chain_and_analyse(world, reads, tmp_path, preset):
    fasta_in = "".join(f">{h}/1\n{a}\n>{h}/2\n{b}\n" for h, a, b in reads)
    want = _chain(jax_cli, preset, world, fasta_in)
    got = _chain(port_cli, preset, world, fasta_in, ("--device", "cpu"))
    assert got == want and got.count(">") == len(reads)
    paths = [tmp_path / "R1.fq", tmp_path / "R2.fq"]
    for e, path in enumerate(paths):
        path.write_text("".join(f"@{h}/{e + 1}\n{r[e]}\n+\n{'I' * len(r[e])}"
                                f"\n" for h, *r in reads))
    rc, out, err = run(port_cli, [
        "analyse", "-t", preset, "-1", str(paths[0]), "-2", str(paths[1]),
        "--taxons", world["taxfile"], "--index", world["kmer_idx"],
        "--device", "cpu", "--fgspp", "never"])
    assert rc == 0, err
    assert out == got
