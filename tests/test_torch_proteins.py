"""Parity of the port's protein path (plain PyTorch on the CPU) with
``umgap_tpu``: K1P's plain version (the window packing of protein lanes),
the protein pipeline step of the four 9-mer presets, the protein
``Analyser`` with its k_max re-route, the host digest of gene groups and
the tryptic protein route, FGSpp's wrapper and gene grouping driven by
``chip_smoke.py``'s mock binary, and the mock's digests that
``chip_smoke.py`` holds the card to. Exact equality (the outputs are
integers); inputs made with numpy from seeds."""

import importlib.util
import json
import os
import stat

import numpy as np
import pytest
import torch

from umgap_tpu import fgspp as jfgspp
from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.index import table as jtable
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.pipeline import PRESETS as JPRESETS
from umgap_tpu.pipeline import proteins as jprot
from umgap_tpu.pipeline.tryptic import TRYPTIC_PRESETS as JTRYPTIC
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa as jfixture_taxa
from umgap_tpu_torch import convert, fgspp
from umgap_tpu_torch import taxonomy as ptaxonomy
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import kmers as pkmers
from umgap_tpu_torch.pipeline import proteins
from umgap_tpu_torch.pipeline.fused import PRESETS
from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, ".bench_data")
IDS = np.array([2, 10239, 12884, 185751, 185752], np.int32)
AAS = list("ACDEFGHIKLMNPQRSTVWY")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _install(path, text):
    path.write_text(text)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture(scope="module")
def mock(smoke, tmp_path_factory):
    """(binary, train dir) of chip_smoke.py's mock FGSpp."""
    d = tmp_path_factory.mktemp("fgspp")
    (d / "train").mkdir()
    return _install(d / "FGSpp", smoke.MOCK_FGSPP), str(d / "train")


# ---------------------------------------------------------------------- #
# K1P's plain version
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("P", [1, 5, 8, 9, 10, 16, 64, 1000, 8000, 30000])
def test_pack_windows_batch_matches_jax(P):
    """Random bytes (AA codes and beyond), lengths from 0 to P with 0,
    one below 9, 9 and P among them; P < 9 pads to one invalid window;
    a few wide lanes at the widths K1P's tiles cut inside a lane."""
    rng = np.random.default_rng(P)
    N = 97 if P <= 64 else 5
    aa = rng.integers(0, 256, size=(N, P)).astype(np.uint8)
    aa[: N // 2] %= 32
    lens = rng.integers(0, P + 1, size=N).astype(np.int32)
    lens[:4] = (0, min(9, P), P, min(5, P))
    want = jkmers.pack_windows_batch(aa, lens, 9)
    got = pkmers.pack_windows_batch(torch.from_numpy(aa),
                                    torch.from_numpy(lens), 9)
    kern = pkmers.proteins_to_kmers(torch.from_numpy(aa),
                                    torch.from_numpy(lens), 9)
    for w, g, k in zip(want, got, kern):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, k)  # on the CPU the wrapper is the plain path
    assert got[0].shape == (N, max(P - 8, 1))


def _k1p_tiles(n_lanes, P, k, tile):
    """K1P's tiles as its blocks take them (``csrc/reads_to_kmers.cu``):
    (first window, end window, first residue, end residue) rows, windows
    flattened as lane * W + w and residues as lane * P + i; a block
    stages residues [first, end)."""
    W = max(P - k + 1, 1)
    n_out = n_lanes * W
    o0 = np.arange(0, n_out, tile, dtype=np.int64)
    o1 = np.minimum(o0 + tile, n_out)
    last = o1 - 1
    first = o0 // W * P + o0 % W
    end = last // W * P + last % W + min(k, P)
    return np.stack([o0, o1, first, end], axis=1)


def _k1p_stage_bytes(tile, W, k):
    """The kernel's ``k1p_stage_bytes``: a tile's run of residues at most,
    its 16-byte alignment head and the register fold's read past it."""
    n = tile - 1 + (k - 1) * ((tile - 1) // W + 1) + k + 15 + 32
    return (n + 15) & ~15


@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("N,P,k", [(4096, 64, 9), (32, 64, 9), (1, 2056, 9),
                                   (3, 2057, 9), (8392, 1999, 9),
                                   (5, 30000, 9), (23, 34974, 9),
                                   (33, 5, 9), (40, 12, 9), (40, 15, 9),
                                   (20, 40, 5), (20, 40, 10), (7, 3, 1)])
def test_k1p_plan_covers_every_window_once(N, P, k, sms):
    """K1P's host plan: the tile a multiple of 8 within its bounds, at
    least two tiles an SM where the call has the windows, a block a tile;
    the tiles cover every window exactly once, and each tile's run of
    residues holds every residue of its windows, fits its stage buffer
    and, for the register fold, starts each thread's run of 4 windows on
    a 4-byte word."""
    W = max(P - k + 1, 1)
    n_out = N * W
    tile, blocks = pkmers.k1p_plan(n_out, sms)
    assert tile % 8 == 0 and pkmers.K1P_TILE_MIN <= tile <= \
        pkmers.K1P_TILE_MAX
    tiles = _k1p_tiles(N, P, k, tile)
    assert blocks == len(tiles)
    if n_out >= 2 * sms * pkmers.K1P_TILE_MIN and \
            n_out <= 2 * sms * pkmers.K1P_TILE_MAX:
        assert len(tiles) >= 2 * sms
    o0, o1, first, end = tiles.T
    assert o0[0] == 0 and o1[-1] == n_out and (o0[1:] == o1[:-1]).all()
    assert ((o1 - o0) <= tile).all() and (o0 % 8 == 0).all()
    cover = np.zeros(n_out, np.int64)
    stage = _k1p_stage_bytes(tile, W, k)
    for a, b, f, e in tiles:
        o = np.arange(a, b)
        cover[o] += 1
        r0 = o // W * P + o % W
        assert (r0 >= f).all() and (r0 + min(k, P) <= e).all()
        assert e - f + 15 + 32 <= stage
        if k == 9 and W >= 4:  # the register fold: 4-byte aligned reads
            assert f % 8 == 0 and ((r0[::4] - f) % 4 == 0).all()
    assert (cover == 1).all()


# ---------------------------------------------------------------------- #
# The protein step and Analyser# ---------------------------------------------------------------------- #
# The protein step and Analyser
# ---------------------------------------------------------------------- #

def _groups(rng, n, E, P):
    """n groups of 0..E random proteins of 0..P residues."""
    groups = []
    for i in range(n):
        prots = ["".join(rng.choice(AAS, size=int(rng.integers(0, P + 1))))
                 for _ in range(int(rng.integers(0, E + 1)))]
        groups.append((f"g{i}", prots))
    return groups


def _world(groups, seed):
    """A 9-mer index of most of the groups' own k-mers (one taxon a gene,
    a tenth at random), the fixture taxonomy; both packages' state."""
    rng = np.random.default_rng(seed)
    keys, vals = [], []
    for i, (_h, prots) in enumerate(groups):
        for j, p in enumerate(prots):
            packed = jkmers.pack_kmers_host(jenc.encode_aa(p), 9)
            v = np.full(len(packed), IDS[(i + j) % 5])
            noise = rng.random(len(packed)) < 0.1
            v[noise] = rng.choice(IDS, size=int(noise.sum()))
            keys.append(packed)
            vals.append(v)
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    keys, first = np.unique(keys, return_index=True)
    keep = rng.random(len(keys)) < 0.8
    table = jtable.build_kmer_table(keys[keep], vals[first][keep], k=9)
    jtax = JTaxonomy(jfixture_taxa())
    dt = jlookup.DeviceTable.from_host(table)
    dx = jagg.DeviceTaxonomy.from_host(jtax)
    pt = convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu")
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    return dict(table=table, jtax=jtax, dt=dt, dx=dx, pt=pt, px=px,
                ptax=ptaxonomy.Taxonomy(ptaxonomy.fixture_taxa()))


@pytest.fixture(scope="module")
def protein_worlds():
    out = {}
    for E in (1, 2, 4):
        for P in (16, 64):
            rng = np.random.default_rng(E * 100 + P)
            groups = _groups(rng, 200, E, P)
            out[E, P] = (groups, _world(groups, E + P))
    return out


@pytest.mark.parametrize("P", [16, 64])
@pytest.mark.parametrize("E", [1, 2, 4])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_protein_pipeline_step_matches_jax(protein_worlds, preset, E, P):
    groups, w = protein_worlds[E, P]
    aa, lens = jprot.encode_protein_groups(groups, E, P)
    paa, plens = proteins.encode_protein_groups(groups, E, P)
    assert np.array_equal(aa, paa) and np.array_equal(lens, plens)
    for k_max in (64, 3, 1):
        want, wov = jprot.protein_pipeline_step(
            aa, lens, w["dx"], w["dt"],
            JPRESETS[preset]._replace(k_max=k_max), with_overflow=True)
        got, gov = proteins.protein_pipeline_step(
            torch.from_numpy(aa), torch.from_numpy(lens), w["px"], w["pt"],
            PRESETS[preset]._replace(k_max=k_max), with_overflow=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    assert (got.numpy() != 1).sum() > 5  # seeds survived
    if E > 1:
        assert gov.numpy().any()  # and > 1 taxon in some groups


@pytest.mark.parametrize("preset", list(PRESETS))
def test_analyse_protein_groups_matches_jax(protein_worlds, preset):
    """The Analyser route, batches of 64, k_max = 3: groups with more
    distinct taxa re-run in the wide program, exact."""
    groups, w = protein_worlds[4, 64]
    groups = groups + [("empty", [])]
    jcfg = JPRESETS[preset]._replace(k_max=3)
    want = list(jprot.analyse_protein_groups(
        groups, w["jtax"], w["table"], jcfg, batch_size=64))
    cache = {}
    got = list(proteins.analyse_protein_groups(
        groups, w["ptax"], None, PRESETS[preset]._replace(k_max=3),
        batch_size=64, dtax=w["px"], dtable=w["pt"], analyser_cache=cache))
    assert got == want
    (an,) = cache.values()
    assert isinstance(an, proteins.ProteinAnalyser)
    assert (an.batch_size, an.read_length, an.ends) == (64, 64, 4)
    assert an.overflow_reads > 0
    assert an._exact_kmax() == 4 * 56
    # the cached analyser serves a second sample
    again = list(proteins.analyse_protein_groups(
        groups, w["ptax"], None, PRESETS[preset]._replace(k_max=3),
        batch_size=64, dtax=w["px"], dtable=w["pt"], analyser_cache=cache))
    assert again == want and len(cache) == 1


# ---------------------------------------------------------------------- #
# The tryptic protein route
# ---------------------------------------------------------------------- #

def _tryptic_world(seed=7):
    """150 groups of 0..3 proteins rich in K, R, P and '*', and a peptide
    index of most of their fragments (one taxon a group, a tenth at
    random)."""
    rng = np.random.default_rng(seed)
    groups = []
    owner = {}
    for i in range(150):
        prots = ["".join(rng.choice(AAS + ["K", "R", "K", "R", "P", "*"],
                                    size=int(rng.integers(0, 400))))
                 for _ in range(int(rng.integers(0, 4)))]
        groups.append((f"g{i}", prots))
        for p in prots:
            for f in jkmers.tryptic_digest(p):
                if 9 <= len(f) <= 45:
                    owner.setdefault(f, IDS[i % 5])
    keep = [f for f in sorted(owner) if rng.random() < 0.8]
    vals = np.array([owner[f] if rng.random() < 0.9 else rng.choice(IDS)
                     for f in keep], dtype=np.int32)
    return groups, keep, vals


def test_digest_protein_groups_matches_jax():
    groups, _peps, _vals = _tryptic_world()
    for width in (8, 128):
        want = jprot.digest_protein_groups(groups, width)
        got = proteins.digest_protein_groups(groups, width)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert want[2].sum() > 100


@pytest.mark.parametrize("preset", list(TRYPTIC_PRESETS))
def test_analyse_tryptic_protein_groups_matches_jax(preset):
    groups, peps, vals = _tryptic_world()
    jt = jtable.PeptideTable.build(peps, vals)
    want = list(jprot.analyse_tryptic_protein_groups(
        groups, JTaxonomy(jfixture_taxa()), jt, JTRYPTIC[preset],
        batch_size=64, max_peptides=8))
    cache = {}
    got = list(proteins.analyse_tryptic_protein_groups(
        groups, ptaxonomy.Taxonomy(ptaxonomy.fixture_taxa()),
        ptable.PeptideTable.build(peps, vals), TRYPTIC_PRESETS[preset],
        batch_size=64, max_peptides=8, step_cache=cache, device="cpu"))
    assert got == want
    assert sum(t != 1 for _h, t in got) > 20
    assert list(proteins.analyse_tryptic_protein_groups(
        [], None, None, TRYPTIC_PRESETS[preset], device="cpu")) == []


# ---------------------------------------------------------------------- #
# FGSpp's wrapper and the gene groups
# ---------------------------------------------------------------------- #

def test_fgspp_command_matches_jax():
    assert fgspp.fgspp_command("b", "t") == jfgspp.fgspp_command("b", "t")
    assert fgspp.fgspp_command("b", "t", threads=8) == \
        jfgspp.fgspp_command("b", "t", threads=8)
    assert fgspp.FGSPP_PRESETS == jfgspp.FGSPP_PRESETS


def _reads(n, seed=5):
    """n (header, dna) paired records with /1 and /2 end markers, N bases
    and short reads among them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        for e in (1, 2):
            seq = "".join(rng.choice(list("ACGTACGTACGTN"),
                                     size=int(rng.integers(0, 160))))
            out.append((f"r{i}/{e}", seq))
    return out


def test_predict_and_group_genes_with_mock_match_jax(mock):
    records = _reads(300)
    want = list(jfgspp.predict_genes(*mock, iter(records)))
    got = list(fgspp.predict_genes(*mock, iter(records)))
    assert got == want and len(got) > 100
    groups = list(fgspp.group_genes(iter(got)))
    assert groups == list(jfgspp.group_genes(iter(want)))
    # reads with no gene give no group; both ends merge into one
    assert 0 < len(groups) < 300
    assert max(len(p) for _h, p in groups) >= 3
    assert all("/" not in h and "_" not in h for h, _p in groups)
    # single-end headers without the delimiter keep FGSpp's suffix
    single = [(h.split("/")[0], s) for h, s in records[::2]]
    genes = list(fgspp.predict_genes(*mock, iter(single)))
    sgroups = list(fgspp.group_genes(iter(genes)))
    assert sgroups == list(jfgspp.group_genes(iter(genes)))
    assert all(h.endswith(("_+", "_-")) for h, _p in sgroups)


def test_predict_genes_failure_raises(tmp_path):
    binary = _install(tmp_path / "FGSpp", "#!/bin/sh\ncat > /dev/null\n"
                      "echo '>x_1_2_+'\necho MKV\nexit 3\n")
    records = _reads(20)
    with pytest.raises(RuntimeError, match="status 3"):
        list(fgspp.predict_genes(binary, str(tmp_path), iter(records)))
    with pytest.raises(RuntimeError, match="status 3"):
        list(jfgspp.predict_genes(binary, str(tmp_path), iter(records)))


def test_predict_genes_reader_error_and_abandon(mock):
    """A reader error reaches the caller (FGSpp's stdin is closed, so
    nothing waits); a consumer that stops early ends the process."""
    def broken():
        yield "r0/1", "ACGT" * 30
        raise ValueError("bad record")

    with pytest.raises(ValueError, match="bad record"):
        list(fgspp.predict_genes(*mock, broken()))
    gen = fgspp.predict_genes(*mock, iter(_reads(200)))
    next(gen)
    gen.close()


def test_find_fgspp(tmp_path, mock):
    assert fgspp.find_fgspp(str(tmp_path)) is None
    d = tmp_path / "FGSpp"
    d.mkdir()
    _install(d / "FGSpp", "#!/bin/sh\n")
    assert fgspp.find_fgspp(str(tmp_path)) is None  # no train dir
    (d / "train").mkdir()
    assert fgspp.find_fgspp(str(tmp_path)) == \
        jfgspp.find_fgspp(str(tmp_path)) == (str(d / "FGSpp"),
                                             str(d / "train"))


# ---------------------------------------------------------------------- #
# chip_smoke.py's digests of the FGSpp path
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def bench_fgspp(smoke, mock):
    """The mock's gene groups of the first bench pairs (the first 1,024
    groups), the bench taxonomy, 9-mer index and chip_smoke.py's peptide
    index, built with umgap_tpu."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        man = json.load(f)
    P, L = man["n_pairs"], man["read_len"]
    reads = np.fromfile(os.path.join(DATA, "reads.bin"),
                        np.uint8).reshape(P, 2, L)
    n = smoke.REFERENCE_PAIRS
    genes = jfgspp.predict_genes(*mock, smoke.fgspp_records(reads[:2 * n]))
    groups = list(jfgspp.group_genes(genes))[:n]
    assert len(groups) == n
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    tax = JTaxonomy([JTaxon(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                            int(parent[i]), bool(snap[i] == i))
                     for i in range(1, man["n_tax"] + 1)])
    keys = np.fromfile(os.path.join(DATA, "index_keys.bin"), np.uint64)
    vals = np.fromfile(os.path.join(DATA, "index_vals.bin"), np.int32)
    peps, pvals = smoke.tryptic_workload(reads, man["n_tax"])
    return dict(groups=groups, tax=tax,
                table=jtable.build_kmer_table(keys, vals, k=9),
                ptable=jtable.PeptideTable.build(peps, pvals))


@pytest.mark.parametrize("preset", sorted(jfgspp.FGSPP_PRESETS))
def test_chip_smoke_fgspp_digests(smoke, bench_fgspp, preset):
    """chip_smoke.py holds the card's taxa of the first 1,024 gene groups
    of the mock to these digests; recompute them with umgap_tpu."""
    b = bench_fgspp
    if preset in JTRYPTIC:
        taxa = [t for _h, t in jprot.analyse_tryptic_protein_groups(
            b["groups"], b["tax"], b["ptable"], JTRYPTIC[preset])]
    else:
        taxa = [t for _h, t in jprot.analyse_protein_groups(
            b["groups"], b["tax"], b["table"], JPRESETS[preset])]
    assert len(set(taxa)) > 10
    assert smoke.taxa_digest(taxa) == \
        smoke.REFERENCE_DIGESTS[f"fgspp/{preset}"]
