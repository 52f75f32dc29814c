"""The port's exact host route for 9-mer records longer than the top
device width, held to ``umgap_tpu``: six-frame translation, k-mer
packing, the k-mer table's host probe (stash and ``max_probes`` >= 1
included), the host seed-extend, the host aggregators of
``agg/host.py``, ``cli._analyse_long_group_host`` for every 9-mer preset,
and the command line on a sample with a 5,000 bp group. Exact equality,
inputs made with numpy from seeds."""

import io
import sys

import numpy as np
import pytest

from umgap_tpu import cli as jcli
from umgap_tpu import ranks as jranks
from umgap_tpu.agg import host as jhost
from umgap_tpu.index.table import KmerTable as JKmerTable
from umgap_tpu.index.table import build_kmer_table as jbuild
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import seedextend as jseed
from umgap_tpu.ops import translate as jtrans
from umgap_tpu.pipeline import PRESETS as JPRESETS
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu_torch import cli as pcli
from umgap_tpu_torch import taxonomy as ptax
from umgap_tpu_torch.agg import host as phost
from umgap_tpu_torch.index.table import load_table
from umgap_tpu_torch.ops import encoding as penc
from umgap_tpu_torch.ops import kmers as pkmers
from umgap_tpu_torch.ops import seedextend as pseed
from umgap_tpu_torch.ops import translate as ptrans
from umgap_tpu_torch.pipeline.fused import PRESETS

AGGREGATIONS = [("rmq", "mrtl"), ("rmq", "lca*"), ("rmq", "hybrid"),
                ("tree", "lca*"), ("tree", "hybrid")]


def _dna(rng, n):
    """A DNA string of n bases, N and lower case included."""
    s = rng.choice(list("ACGTACGTACGTNacgt"), size=n)
    return "".join(s)


def _taxa(n=300, seed=3):
    """A random tree of n taxa (id 1 the root), every third ranked, a
    few invalid: (JAX taxonomy, port taxonomy)."""
    rng = np.random.default_rng(seed)
    parent = [1, 1] + [int(rng.integers(1, i)) for i in range(2, n + 1)]
    rows = []
    for i in range(1, n + 1):
        rank = 14 if i % 3 == 0 else jranks.NO_RANK
        rows.append((i, f"t{i}", rank, parent[i], i % 17 != 5))
    jt = JTaxonomy([JTaxon(*r) for r in rows])
    pt = ptax.Taxonomy([ptax.Taxon(*r) for r in rows])
    return jt, pt


@pytest.mark.parametrize("table,methionine", [(1, False), (4, True),
                                              (11, False)])
def test_translate_sequence_matches_jax(table, methionine):
    rng = np.random.default_rng(table)
    for n in (0, 1, 2, 3, 4, 5, 17, 100, 301):
        seq = _dna(rng, n)
        want = jtrans.translate_sequence(seq, jtrans.FRAME_NAMES,
                                         jenc.get_table(table), methionine)
        got = ptrans.translate_sequence(seq, ptrans.FRAME_NAMES,
                                        penc.get_table(table), methionine)
        assert got == want


def test_pack_kmers_host_matches_jax():
    rng = np.random.default_rng(5)
    for n, k in ((0, 9), (8, 9), (9, 9), (50, 9), (40, 5), (30, 10)):
        codes = rng.integers(0, 32, size=n).astype(np.uint8)
        want = jkmers.pack_kmers_host(codes, k)
        got = pkmers.pack_kmers_host(codes, k)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for seq in ("MKVLA*TRP", "", "ACDEFGHIKLMNPQRSTVWY-*X"):
        assert np.array_equal(penc.encode_aa(seq), jenc.encode_aa(seq))
        assert penc.decode_aa(penc.encode_aa(seq)) == jenc.decode_aa(
            jenc.encode_aa(seq))


@pytest.mark.parametrize("layout", ["bucket8s", "bucket8_probes1",
                                    "bucket16"])
def test_kmer_probe_host_matches_jax(layout, tmp_path):
    """Tables built by umgap_tpu, read by the port's load_table: the
    stash (bucket8s at high load), ``max_probes`` >= 1 (the 2-round
    build) and a 16-slot layout."""
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 2 ** 45, size=150_000).astype(
        np.uint64))
    vals = rng.integers(1, 300, size=len(keys)).astype(np.int32)
    if layout == "bucket8s":
        t = jbuild(keys, vals, 9, capacity=1 << 18, stash_cap=4096)
        assert len(t.stash_hi)
    elif layout == "bucket8_probes1":
        t = JKmerTable.build(keys, vals, 9, load_factor=0.9)
        assert t.max_probes >= 1
    else:
        t = jbuild(keys, vals, 9, layout="bucket16")
    t.save(tmp_path / "t.npz")
    pt = load_table(tmp_path / "t.npz")
    absent = rng.integers(0, 2 ** 45, size=5000).astype(np.uint64)
    q = np.concatenate([keys[::30], absent])
    if len(t.stash_hi):
        q[:len(t.stash_hi)] = jkmers.join_packed(t.stash_hi, t.stash_lo)
    hi, lo = jkmers.split_packed(q)
    want = t.probe_host(hi, lo, -3)
    got = pt.probe_host(hi, lo, -3)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert want[1].sum() >= len(keys[::30])


def test_apply_seedextend_matches_jax():
    rng = np.random.default_rng(9)
    for _ in range(300):
        n = int(rng.integers(0, 40))
        taxa = rng.choice([0, 0, 0, 5, 6, 7], size=n)
        rep = rng.random(n) < 0.6
        for j in range(1, n):
            if rep[j]:
                taxa[j] = taxa[j - 1]
        taxa = [int(t) for t in taxa]
        for s in (1, 2, 3, 4):
            for g in (0, 1, 2):
                assert pseed.seedextend_host(taxa, s, g) == \
                    jseed.seedextend_host(taxa, s, g)
                assert pseed.apply_seedextend(taxa, s, g) == \
                    jseed.apply_seedextend(taxa, s, g)


def test_count_and_filter_match_jax():
    rng = np.random.default_rng(10)
    pairs = [(int(t), float(c)) for t, c in zip(
        rng.integers(1, 20, size=200), rng.random(200) * 3)]
    want = jhost.count(pairs)
    got = phost.count(pairs)
    assert list(got.items()) == list(want.items())
    for lb in (0.0, 1.0, 5.0, 20.0):
        assert phost.filter_counts(got, lb) == jhost.filter_counts(want, lb)


@pytest.mark.parametrize("method,strategy", AGGREGATIONS)
def test_host_aggregators_match_jax(method, strategy):
    jt, pt = _taxa()
    ja = jhost.make_aggregator(jt, method, strategy, 0.25)
    pa = phost.make_aggregator(pt, method, strategy, 0.25)
    assert type(pa).__name__ == type(ja).__name__
    rng = np.random.default_rng(11)
    for _ in range(120):
        k = int(rng.integers(1, 9))
        ids = rng.choice(np.arange(1, 301), size=k, replace=False)
        counts = {int(t): float(rng.integers(1, 5)) for t in ids}
        assert pa.aggregate(counts) == ja.aggregate(counts)
    with pytest.raises(phost.EmptyInputError):
        pa.aggregate({})
    with pytest.raises(phost.UnknownTaxonError):
        pa.aggregate({10_000: 1.0})


def _long_world(seed=12):
    """A taxonomy, reads of 200-5,000 bp and a 9-mer index of half their
    own k-mers (one taxon a read's frame), built by umgap_tpu and read
    by the port."""
    rng = np.random.default_rng(seed)
    jt, pt = _taxa(seed=seed)
    seqs = [_dna(rng, int(n)) for n in rng.integers(200, 5000, size=6)]
    keys, vals = [], []
    for i, seq in enumerate(seqs):
        for f, pep in enumerate(jtrans.translate_sequence(
                seq, jtrans.FRAME_NAMES, jenc.get_table(1))):
            packed = jkmers.pack_kmers_host(jenc.encode_aa(pep), 9)[::2]
            keys.append(packed)
            vals.append(np.full(len(packed), 2 + (7 * i + 3 * f) % 290))
    keys, first = np.unique(np.concatenate(keys), return_index=True)
    vals = np.concatenate(vals)[first].astype(np.int32)
    return jt, pt, seqs, jbuild(keys, vals, 9)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_long_group_host_matches_jax(preset, tmp_path):
    jt, pt, seqs, table = _long_world()
    table.save(tmp_path / "nine.npz")
    ptable = load_table(tmp_path / "nine.npz")
    jcache, pcache = {}, {}
    for i in range(0, len(seqs) - 1):
        group = [seqs[i], seqs[i + 1]]
        for ends in (1, 2):
            want = jcli._analyse_long_group_host(
                group, JPRESETS[preset], ends, jt, table, jcache)
            got = pcli._analyse_long_group_host(
                group, PRESETS[preset], ends, pt, ptable, pcache)
            assert got == want


def test_cli_long_group_matches_jax(tmp_path, monkeypatch):
    """A paired sample with one 5,000 bp group among 100 bp ones, at the
    CLI's defaults: the Python tier sends that group through the exact
    host route (said on stderr under VERBOSE) and merges it back in input
    order; the records equal ``umgap_tpu analyse``'s."""
    monkeypatch.setenv("VERBOSE", "1")
    rng = np.random.default_rng(13)
    jt, _pt, seqs, table = _long_world()
    table.save(tmp_path / "nine.npz")
    with open(tmp_path / "taxons.tsv", "w") as f:
        for i in range(1, jt.size):
            rank = jranks.rank_name(int(jt.rank[i]))
            valid = "\x01" if jt.valid[i] else "\x00"
            f.write(f"{i}\tt{i}\t{rank}\t{int(jt.parent[i])}\t{valid}\n")
    n = 40
    pairs = [[s[:100], s[100:200]] for s in
             (seqs[i % len(seqs)][7 * i:] for i in range(n))]
    pairs[17] = [_dna(rng, 5000), seqs[2][:4990]]
    for e in (0, 1):
        with open(tmp_path / f"R{e + 1}.fq", "w") as f:
            for i, p in enumerate(pairs):
                f.write(f"@r{i}/{e + 1}\n{p[e]}\n+\n{'I' * len(p[e])}\n")
    base = ["analyse", "--taxons", str(tmp_path / "taxons.tsv"), "--index",
            str(tmp_path / "nine.npz"), "-1", str(tmp_path / "R1.fq"), "-2",
            str(tmp_path / "R2.fq")]
    for preset in ("max-sensitivity", "high-precision"):
        jout, pout = tmp_path / "jax.fa", tmp_path / "port.fa"
        assert jcli.main(base + ["-t", preset, "-o", str(jout), "--fgspp",
                                 "never"], stdin=io.StringIO(""),
                         stdout=io.StringIO()) == 0
        err = io.StringIO()
        old, sys.stderr = sys.stderr, err
        try:
            rc = pcli.main(base + ["-t", preset, "-o", str(pout),
                                   "--device", "cpu"])
        finally:
            sys.stderr = old
        assert rc == 0, err.getvalue()
        got = pout.read_bytes()
        assert got == jout.read_bytes()
        assert got.count(b">") == n
        assert "1 record group(s) beyond 4096 bp: exact host path" in \
            err.getvalue()
