"""Parity of the port's tryptic presets (plain PyTorch on the CPU) with
``umgap_tpu``: the host digest, the FNV fingerprints and ``hash32``, the
peptide table (build, host probe, ``.npz`` both ways), the digest of K7's
plain version, the peptide probe of K8's plain version, the tryptic
pipeline step and ``TrypticAnalyser`` (both presets, one and two ends,
the k_max re-route), the host-digest route, ``chip_smoke.py``'s tryptic
index and digests, and the command line. Exact equality, inputs made
with numpy from seeds."""

import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from umgap_tpu import cli as jcli
from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.index import table as jtable
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.ops import translate as jtrans
from umgap_tpu.pipeline import tryptic as jtryp
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu_torch import cli as pcli
from umgap_tpu_torch import convert
from umgap_tpu_torch import taxonomy as ptax
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding as penc
from umgap_tpu_torch.ops import kmers as pkmers
from umgap_tpu_torch.ops import lookup as plookup
from umgap_tpu_torch.pipeline import tryptic as ptryp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, ".bench_data")
L = 64
PRESETS = list(ptryp.TRYPTIC_PRESETS)


def _taxa(n=300, seed=3):
    """A random tree of n taxa (id 1 the root): (JAX, port) taxonomies
    and the rows."""
    rng = np.random.default_rng(seed)
    parent = [1, 1] + [int(rng.integers(1, i)) for i in range(2, n + 1)]
    rows = [(i, f"t{i}", 14 if i % 3 == 0 else jranks.NO_RANK, parent[i],
             i % 17 != 5) for i in range(1, n + 1)]
    return (JTaxonomy([JTaxon(*r) for r in rows]),
            ptax.Taxonomy([ptax.Taxon(*r) for r in rows]), rows)


def _aa_string(rng, n):
    """An AA string rich in K, R, P and '*' (and '-')."""
    return "".join(rng.choice(list("KKRRPP**-ACDEFGHILMNQSTVWY"), size=n))


def _host_fragments(seqs):
    out = set()
    for seq in seqs:
        for pep in jtrans.translate_sequence(seq, jtrans.FRAME_NAMES,
                                             jenc.get_table(1)):
            out.update(f for f in jkmers.tryptic_digest(pep)
                       if 9 <= len(f) <= 45)
    return sorted(out)


def test_tryptic_digest_matches_jax():
    rng = np.random.default_rng(1)
    cases = ["", "K", "KP", "KPK", "RRRR", "*", "**K*R*", "AKPRKRAKA*P",
             "MKR*PKRGG"]
    cases += [_aa_string(rng, int(n)) for n in rng.integers(0, 120, 400)]
    for seq in cases:
        assert pkmers.tryptic_digest(seq) == jkmers.tryptic_digest(seq)


def test_fingerprints_and_hash32_match_jax():
    rng = np.random.default_rng(2)
    peps = [_aa_string(rng, int(n)) for n in rng.integers(0, 50, 500)]
    for p in peps[:50]:
        codes = jenc.encode_aa(p)
        assert ptable.fingerprint_host(codes) == jtable.fingerprint_host(codes)
    got = ptable._fingerprints(peps)
    want = jtable._fingerprints(peps)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    codes = [jenc.encode_aa(p) for p in peps]
    got = ptable._fingerprints(codes, chunk=64)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    hi = rng.integers(-2 ** 31, 2 ** 31, 10_000).astype(np.int32)
    lo = rng.integers(-2 ** 31, 2 ** 31, 10_000).astype(np.int32)
    want = jtable.hash32(hi, lo)
    assert np.array_equal(ptable.hash32(hi, lo), want)
    got = plookup.hash32_torch(torch.from_numpy(hi), torch.from_numpy(lo))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n,load", [(3000, 0.9), (20_000, 0.45)])
def test_peptide_table_build_matches_jax(n, load, tmp_path):
    """Rows array for array (20,000 keys: umgap_tpu places them with its
    native insertion, slot-identical to the numpy one), the host probe,
    and each package reading the other's ``.npz``."""
    rng = np.random.default_rng(n)
    peps = sorted({_aa_string(rng, int(k)).replace("*", "A")
                   for k in rng.integers(9, 46, n)})
    vals = rng.integers(1, 300, len(peps)).astype(np.int32)
    jt = jtable.PeptideTable.build(peps, vals, load_factor=load)
    pt = ptable.PeptideTable.build(peps, vals, load_factor=load)
    for a in ("key_hi", "key_lo", "values"):
        assert np.array_equal(getattr(pt, a), getattr(jt, a))
    assert pt.max_probes == jt.max_probes and pt.n == jt.n
    q = peps[::3] + [_aa_string(rng, 12) for _ in range(500)]
    for got, want in zip(pt.lookup_peptides_host(q, -1),
                         jt.lookup_peptides_host(q, -1)):
        assert np.array_equal(got, want)
    jt.save(tmp_path / "j.npz")
    pt.save(tmp_path / "p.npz")
    for path in ("j.npz", "p.npz"):
        a = ptable.load_table(tmp_path / path, mmap=True)
        b = jtable.load_table(tmp_path / path)
        assert a.kind == b.kind == "peptide"
        assert a.raw_keys == b.raw_keys == peps
        for k in ("key_hi", "key_lo", "values", "raw_values"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
    d = plookup.DeviceTable.from_host(pt, device="cpu")
    assert np.array_equal(d.rows.numpy(),
                          np.asarray(jlookup.pack_rows(jt)))


def test_peptide_table_refuses_collisions(monkeypatch):
    peps = ["AAAAAAAAAK", "CCCCCCCCCK", "AAAAAAAAAK"]
    # identical duplicates pass through
    ptable._check_fingerprint_collisions(
        peps, np.array([1, 2, 1], np.int32), np.array([3, 4, 3], np.int32))
    with pytest.raises(ptable.FingerprintCollision):
        ptable._check_fingerprint_collisions(
            peps[:2], np.array([1, 1], np.int32), np.array([3, 3], np.int32))


@pytest.mark.parametrize("P", [33, 53, 100])
def test_tryptic_digest_plain_matches_jax(P):
    rng = np.random.default_rng(P)
    R = 600
    aa = rng.choice(np.array([10, 17, 15, 26, 27, 0, 3, 5, 8, 12], np.uint8),
                    size=(R, P))
    aa[::3] = rng.integers(0, 26, size=aa[::3].shape)
    aa[5::7, :] = 26  # all-'*' rows
    plens = rng.integers(0, P + 1, size=R).astype(np.int32)
    plens[::11] = P
    plens[1::13] = 0
    want = [np.asarray(x) for x in jtryp.tryptic_digest_device(aa, plens)]
    got = [x.numpy() for x in ptryp.tryptic_digest_plain(
        torch.from_numpy(aa), torch.from_numpy(plens))]
    assert got[2].shape == want[2].shape == (R, P // 9 + 1)
    assert np.array_equal(got[2], want[2]) and want[2].sum() > R // 4
    v = want[2]
    assert np.array_equal(got[0][v], want[0][v])
    assert np.array_equal(got[1][v], want[1][v])
    assert not got[0][~v].any() and not got[1][~v].any()


@pytest.fixture(scope="module")
def world():
    """Random reads (groups of two ends, lengths 10-64, N bases
    included), a random 300-taxon tree, and a peptide index of the reads'
    own fragments less every fourth, built by umgap_tpu; its device state
    carried to the port by ``convert``."""
    rng = np.random.default_rng(21)
    n = 96
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lens = rng.integers(10, L + 1, size=(n, 2)).astype(np.int32)
    lens[::5] = L
    jt, pt, rows = _taxa()
    # a group's fragments point at its taxon, its parent or a random one
    value = {}
    for i in range(n):
        t = int(rng.integers(2, 301))
        seqs = [jenc.decode_dna(codes[i, e, :lens[i, e]]) for e in (0, 1)]
        for p in _host_fragments(seqs):
            pick = rng.random()
            value.setdefault(p, t if pick < 0.6 else int(jt.parent[t])
                             if pick < 0.8 else int(rng.integers(2, 301)))
    peps = [p for i, p in enumerate(sorted(value)) if i % 4]
    vals = np.array([value[p] for p in peps], np.int32)
    table = jtable.PeptideTable.build(peps, vals)
    dt = jlookup.DeviceTable.from_host(table)
    dx = jagg.DeviceTaxonomy.from_host(jt)
    ptab = convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu")
    pdx = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    return dict(codes=codes, lens=lens, n=n, jt=jt, pt=pt, rows=rows,
                table=table, dt=dt, dx=dx, ptab=ptab, pdx=pdx, peps=peps,
                vals=vals)


def test_probe_plain_peptide_matches_jax(world):
    """A small table at high load (max_probes >= 1), present, absent and
    invalid queries."""
    rng = np.random.default_rng(4)
    peps = sorted({_aa_string(rng, int(k)).replace("*", "A")
                   for k in rng.integers(9, 46, 900)})
    vals = rng.integers(1, 300, len(peps)).astype(np.int32)
    t = jtable.PeptideTable.build(peps, vals, load_factor=0.95)
    assert t.max_probes >= 1
    dt = jlookup.DeviceTable.from_host(t)
    pd = convert.table_from_arrays(np.asarray(dt.rows), np.asarray(dt.stash),
                                   dt.max_probes, dt.kind, dt.nb_bits,
                                   dt.bucket, dt.group, device="cpu")
    hi, lo = jtable._fingerprints(peps + [_aa_string(rng, 15)
                                          for _ in range(300)])
    hi, lo = hi.reshape(-1, 6), lo.reshape(-1, 6)
    valid = rng.random(hi.shape) < 0.85
    for default in (0, -5):
        want = jlookup.probe(dt, hi, lo, valid=valid, default=default)
        got = plookup.probe_plain(pd, torch.from_numpy(hi),
                                  torch.from_numpy(lo),
                                  torch.from_numpy(valid), default)
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].sum() > hi.size // 2
        # the port's entry point on CPU tensors is the plain version
        again = plookup.probe(pd, torch.from_numpy(hi), torch.from_numpy(lo),
                              torch.from_numpy(valid), default)
        assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("ends", [1, 2])
def test_tryptic_pipeline_step_matches_jax(world, preset, ends):
    dna = world["codes"][:, :ends]
    lens = world["lens"][:, :ends]
    want, wov = jtryp.tryptic_pipeline_step(
        dna, lens, world["dx"], world["dt"], jtryp.TRYPTIC_PRESETS[preset],
        with_overflow=True)
    got, gov = ptryp.tryptic_pipeline_step(
        torch.from_numpy(dna), torch.from_numpy(lens), world["pdx"],
        world["ptab"], ptryp.TRYPTIC_PRESETS[preset], with_overflow=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gov.numpy(), np.asarray(wov))
    if preset == "tryptic-sensitivity":  # precision needs 5 equal hits
        assert (got.numpy() > 1).sum() > world["n"] // (4 if ends == 2
                                                        else 10)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("ends,k_max", [(2, 64), (1, 64), (2, 2)])
def test_tryptic_analyser_matches_jax(world, preset, ends, k_max):
    """``TrypticAnalyser`` on the packed-4 wire against umgap_tpu's;
    k_max = 2 sends most groups through the wide program (k_max =
    E x 6 x F, every fragment slot its own taxon)."""
    n = world["n"]
    dna = np.ascontiguousarray(world["codes"][:, :ends])
    lens = np.ascontiguousarray(world["lens"][:, :ends])
    headers = [f"g{i}" for i in range(n)]
    jcfg = jtryp.TRYPTIC_PRESETS[preset]._replace(k_max=k_max)
    ja = jtryp.TrypticAnalyser(world["jt"], world["table"], jcfg,
                               batch_size=64, read_length=L, ends=ends)
    want = list(ja.analyse_arrays(headers, dna, lens))
    pa = ptryp.TrypticAnalyser(
        world["pt"], None, ptryp.TRYPTIC_PRESETS[preset]._replace(
            k_max=k_max), batch_size=64, read_length=L, ends=ends,
        dtax=world["pdx"], dtable=world["ptab"], device="cpu")
    assert pa._exact_kmax() == ja._exact_kmax() == ends * 6 * (L // 3 // 9
                                                              + 1)
    got = list(pa.analyse_arrays(headers, dna, lens))
    assert got == want
    assert pa.overflow_reads == ja.overflow_reads
    if k_max == 2:
        assert pa.overflow_reads > 0


@pytest.mark.parametrize("preset", PRESETS)
def test_analyse_tryptic_groups_matches_jax(world, preset):
    """The host-digest route on groups of up to 400 bp (past the device
    width), through the port's own host table."""
    rng = np.random.default_rng(8)
    groups = [(f"g{i}", [jenc.decode_dna(world["codes"][i, e,
                                                       :world["lens"][i, e]])
                         for e in (0, 1)]) for i in range(world["n"])]
    for i in range(0, world["n"], 9):
        long = jenc.decode_dna(rng.integers(0, 4, 400).astype(np.uint8))
        groups[i] = (groups[i][0], [long + groups[i][1][0], ""])
    want = jtryp.analyse_tryptic_groups(
        groups, world["jt"], world["table"], jtryp.TRYPTIC_PRESETS[preset],
        batch_size=32, max_peptides=8)
    pt_table = ptable.PeptideTable.build(world["peps"], world["vals"])
    got = ptryp.analyse_tryptic_groups(
        groups, world["pt"], pt_table, ptryp.TRYPTIC_PRESETS[preset],
        batch_size=32, max_peptides=8, device="cpu")
    assert got == want
    for a, b in zip(ptryp.digest_groups(groups[:40], 8),
                    jtryp.digest_groups(groups[:40], 8)):
        assert a.shape == b.shape and np.array_equal(a, b)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench_tryptic(smoke):
    """chip_smoke.py's tryptic index over all 32,768 bench pairs, built
    with umgap_tpu's PeptideTable; the first 1,024 pairs and the bench
    taxonomy."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        man = json.load(f)
    P, Lb = man["n_pairs"], man["read_len"]
    reads = np.fromfile(os.path.join(DATA, "reads.bin"),
                        np.uint8).reshape(P, 2, Lb)
    peps, vals = smoke.tryptic_workload(reads, man["n_tax"])
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    tax = JTaxonomy([JTaxon(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                            int(parent[i]), bool(snap[i] == i))
                     for i in range(1, man["n_tax"] + 1)])
    n = smoke.REFERENCE_PAIRS
    return dict(peps=peps, vals=vals, tax=tax, reads=reads[:n], L=Lb, n=n,
                table=jtable.PeptideTable.build(peps, vals))


def test_chip_smoke_tryptic_index_matches_jax(smoke, bench_tryptic):
    """The smoke's index holds every distinct 9-45-residue fragment of
    the host digest of the bench reads less a quarter; the port's build
    of it equals umgap_tpu's row for row."""
    peps = bench_tryptic["peps"]
    assert peps == sorted(set(peps)) and len(peps) > 300_000
    assert all(9 <= len(p) <= 45 for p in peps[::997])
    pt = ptable.PeptideTable.build(peps, bench_tryptic["vals"],
                                   store_keys=False)
    jt = bench_tryptic["table"]
    for a in ("key_hi", "key_lo", "values"):
        assert np.array_equal(getattr(pt, a), getattr(jt, a))


@pytest.mark.parametrize("preset", PRESETS)
def test_chip_smoke_tryptic_digests(smoke, bench_tryptic, preset):
    """chip_smoke.py holds the card's tryptic taxa of the first 1,024
    pairs to these digests; recompute them with umgap_tpu."""
    n, Lb = bench_tryptic["n"], bench_tryptic["L"]
    ja = jtryp.TrypticAnalyser(bench_tryptic["tax"], bench_tryptic["table"],
                               jtryp.TRYPTIC_PRESETS[preset], batch_size=n,
                               read_length=Lb, ends=2)
    want = [t for _h, t in ja.analyse_arrays(
        [str(i) for i in range(n)], bench_tryptic["reads"],
        np.full((n, 2), Lb, np.int32))]
    assert len(set(want)) > 20
    assert smoke.taxa_digest(want) == smoke.REFERENCE_DIGESTS[preset]


def _cli_both(argv):
    """The same analyse command through umgap_tpu and the port, both with
    VERBOSE=1 (their notes are written only then); returns the port's
    exit code and stderr."""
    jargs = [a.replace("{tag}", "jax") for a in argv]
    pargs = [a.replace("{tag}", "port") for a in argv]
    err = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VERBOSE", "1")
        assert jcli.main(jargs + ["--fgspp", "never"], stdin=io.StringIO(""),
                         stdout=io.StringIO()) == 0
        old, sys.stderr = sys.stderr, err
        try:
            rc = pcli.main(pargs + ["--device", "cpu"])
        finally:
            sys.stderr = old
    return rc, err.getvalue()


@pytest.fixture(scope="module")
def cli_files(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tryptic_cli")
    with open(tmp / "taxons.tsv", "w") as f:
        for i, name, rank, parent, valid in world["rows"]:
            f.write(f"{i}\t{name}\t{jranks.rank_name(rank)}\t{parent}\t"
                    f"{chr(1) if valid else chr(0)}\n")
    world["table"].save(tmp / "tryptic.npz")
    return tmp


def _write_pairs(paths, groups):
    for e, path in enumerate(paths):
        with open(path, "w") as f:
            for i, g in enumerate(groups):
                f.write(f"@r{i}/{e + 1}\n{g[e]}\n+\n{'I' * len(g[e])}\n")


@pytest.mark.parametrize("long", [False, True])
def test_cli_tryptic_matches_jax(world, cli_files, long):
    """Both tryptic presets through the command line on a FASTQ pair; with
    ``long``, some records exceed --read-length and the sample takes the
    host-digest route (said on stderr). The records equal
    ``umgap_tpu analyse``'s."""
    tmp = cli_files
    rng = np.random.default_rng(30 + long)
    groups = [[jenc.decode_dna(world["codes"][i, e, :world["lens"][i, e]])
               for e in (0, 1)] for i in range(world["n"])]
    if long:
        for i in range(3, world["n"], 10):
            groups[i][0] += jenc.decode_dna(
                rng.integers(0, 4, 150).astype(np.uint8))
    tag = "long" if long else "short"
    fq = [tmp / f"{tag}_R1.fq", tmp / f"{tag}_R2.fq"]
    _write_pairs(fq, groups)
    argv = ["analyse", "--taxons", str(tmp / "taxons.tsv"), "--index",
            str(tmp / "tryptic.npz"), "--read-length", str(L),
            "--batch-size", "64"]
    for p in PRESETS:
        argv += ["-t", p, "-1", str(fq[0]), "-2", str(fq[1]), "-o",
                 str(tmp / f"{{tag}}-{tag}-{p}.fa")]
    rc, err = _cli_both(argv)
    assert rc == 0, err
    for p in PRESETS:
        got = (tmp / f"port-{tag}-{p}.fa").read_bytes()
        assert got == (tmp / f"jax-{tag}-{p}.fa").read_bytes()
        assert got.count(b">") == world["n"]
    assert ("host-digest path" in err) == long


def test_cli_tryptic_single_end_fasta_matches_jax(world, cli_files):
    """Single-end FASTA wrapped over lines (the Python tier), with and
    without a record beyond --read-length: the records equal
    ``umgap_tpu analyse``'s for both tryptic presets."""
    tmp = cli_files
    rng = np.random.default_rng(33)
    seqs = [jenc.decode_dna(world["codes"][i, 0, :world["lens"][i, 0]])
            for i in range(world["n"])]
    for long in (False, True):
        if long:
            seqs[5] += jenc.decode_dna(rng.integers(0, 4, 300).astype(
                np.uint8))
        fa = tmp / f"se{long}.fa"
        fa.write_text("".join(f">r{i}/1\n{x[:30]}\n{x[30:]}\n"
                              for i, x in enumerate(seqs)))
        argv = ["analyse", "--taxons", str(tmp / "taxons.tsv"), "--index",
                str(tmp / "tryptic.npz"), "--read-length", str(L)]
        for p in PRESETS:
            argv += ["-t", p, "-1", str(fa), "-o",
                     str(tmp / f"{{tag}}-se{long}-{p}.fa")]
        rc, err = _cli_both(argv)
        assert rc == 0, err
        for p in PRESETS:
            got = (tmp / f"port-se{long}-{p}.fa").read_bytes()
            assert got == (tmp / f"jax-se{long}-{p}.fa").read_bytes()
            assert got.count(b">") == world["n"]
        assert ("host-digest path" in err) == long


def test_cli_index_family_must_match_preset(world, cli_files, tmp_path):
    """A 9-mer index under a tryptic preset, and a peptide index under a
    9-mer preset, exit 1 before reading any input."""
    nine = tmp_path / "nine.npz"
    keys = np.arange(1, 5000, dtype=np.uint64)
    ptable.build_kmer_table(keys, np.ones(len(keys), np.int32), 9).save(nine)
    fq = tmp_path / "x.fq"
    fq.write_text("@x/1\nACGT\n+\nIIII\n")
    for index, preset, need in ((nine, "tryptic-sensitivity", "peptide"),
                                (cli_files / "tryptic.npz",
                                 "high-precision", "9-mer")):
        err = io.StringIO()
        old, sys.stderr = sys.stderr, err
        try:
            rc = pcli.main(["analyse", "--taxons",
                            str(cli_files / "taxons.tsv"), "--index",
                            str(index), "-t", preset, "-1", str(fq), "-2",
                            str(fq), "--device", "cpu"])
        finally:
            sys.stderr = old
        assert rc == 1 and f"needs a {need}" in err.getvalue()


def test_reads_to_peptides_plain_shapes(world):
    """K7's plain version on the packed wire equals it on codes, with
    (N * 6, F) outputs, F = (L // 3) // 9 + 1."""
    N = world["n"] * 2
    codes = world["codes"].reshape(N, L)
    lens = torch.from_numpy(world["lens"].reshape(N))
    t = penc.get_table(1)
    a = ptryp.reads_to_peptides(torch.from_numpy(penc.pack_dna4(codes)),
                                lens, L, t)
    b = ptryp.reads_to_peptides(torch.from_numpy(codes), lens, L, t,
                                packed=False)
    F = (L // 3) // 9 + 1
    for x, y in zip(a, b):
        assert x.shape == (N * 6, F) and torch.equal(x, y)
    assert a[2].dtype == torch.bool and a[0].dtype == torch.int32


@pytest.mark.parametrize("Le", [150, 160, 161, 192])
@pytest.mark.parametrize("packed", [True, False])
def test_reads_to_peptides_plain_edge_fragments_match_jax(smoke, Le,
                                                          packed):
    """K7's plain version equals umgap_tpu's translate -> digest chain on
    the reads chip_smoke.py and the card tests write to hold fragments
    of exactly 9, 45 and 46 residues, an all-'*' frame, a frame without
    K or R, K and R before P and a K or R that ends a frame; the first
    frame keeps the designed fragments, as the host digest finds them."""
    codes, lens = smoke._edge_reads(Le, 1)
    t = jenc.get_table(1)
    aa, plens = jtrans.translate6_batch(codes, lens, t)
    P = aa.shape[-1]
    want = [np.asarray(x) for x in jtryp.tryptic_digest_device(
        np.asarray(aa).reshape(-1, P), np.asarray(plens).reshape(-1))]
    src = penc.pack_dna4(codes) if packed else codes
    got = [x.numpy() for x in ptryp.reads_to_peptides_plain(
        torch.from_numpy(src), torch.from_numpy(lens), Le,
        penc.get_table(1), packed)]
    F = P // 9 + 1
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(got[0][want[2]], want[0][want[2]])
    assert np.array_equal(got[1][want[2]], want[1][want[2]])
    assert not got[0][~want[2]].any() and not got[1][~want[2]].any()
    first = got[2].reshape(-1, 6, F)[:, 0]
    assert first[::2].sum(axis=1).tolist() == smoke.EDGE_FRAGMENTS
    for i, pep in enumerate(smoke.EDGE_PEPTIDES):
        frags = [f for f in jkmers.tryptic_digest(pep) if 9 <= len(f) <= 45]
        hi, lo = jtable._fingerprints(frags) if frags else ([], [])
        row = got[0].reshape(-1, 6, F)[2 * i, 0]
        assert row[:len(frags)].tolist() == [int(h) for h in hi]
        row = got[1].reshape(-1, 6, F)[2 * i, 0]
        assert row[:len(frags)].tolist() == [int(x) for x in lo]


def test_chip_smoke_chained_table_matches_jax(smoke):
    """The smoke's chained peptide table (26 keys homed at the last
    bucket chain over max_probes rows and wrap to bucket 0) equals
    umgap_tpu's build of the same fingerprints, and the port's plain
    probe of its present and absent keys equals umgap_tpu's probe."""
    rng = np.random.default_rng(5)
    tab, hi, lo = smoke._chained_table(rng, 100, 1 << 7, (1 << 7) // 8 - 1)
    assert tab.max_probes >= 3
    assert (tab.key_hi.reshape(-1, 8)[:2] != -1).all()
    vals = np.arange(1, 101, dtype=np.int32)
    # umgap_tpu's PeptideTable.build, from the fingerprints on
    bucket0 = (jtable.hash32(hi[:100], lo[:100])
               & np.uint32(16 - 1)).astype(np.int64)
    (kh, kl, kv), mp, _ = jtable._insert_bucketized(
        bucket0, [hi[:100], lo[:100], vals], 1 << 7)
    jt = jtable.PeptideTable(kh, kl, kv, mp, 100)
    pt = ptable.PeptideTable._from_fingerprints(hi[:100], lo[:100], vals,
                                                capacity=1 << 7)
    for a in ("key_hi", "key_lo", "values"):
        assert np.array_equal(getattr(jt, a), getattr(pt, a))
    assert np.array_equal(pt.key_hi, tab.key_hi)
    assert jt.max_probes == pt.max_probes == tab.max_probes
    dt = jlookup.DeviceTable.from_host(jt)
    pd = plookup.DeviceTable.from_host(pt, device="cpu")
    want = jlookup.probe(dt, hi, lo, default=-1)
    got = plookup.probe_plain(pd, torch.from_numpy(hi), torch.from_numpy(lo),
                              None, -1)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1][:100].all() and not got[1][100:].any()


def test_device_taxonomy_from_host_matches_carried(world):
    """The port's own device state of the world's taxonomy equals the one
    carried from umgap_tpu, so the CLI's runs use the same tables."""
    own = DeviceTaxonomy.from_host(world["pt"], device="cpu")
    assert torch.equal(own.snap_valid, world["pdx"].snap_valid)
