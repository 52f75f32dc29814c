"""Scored seed-extend (``PipelineConfig.ranked``, the reference's
``seedextend -r``) in the port against ``umgap_tpu``: the plain version
(``seedextend_scored_hits_plain``) and the row kernel's formulation
(``seedextend_scored_runs_plain``) and K3RS's
(``seedextend_scored_walk_plain``) against ``seedextend_scored_mask_batch``
and its select, the host route's ``apply_seedextend(tax=...)``, the
``Analyser`` of the four 9-mer presets with ``ranked=True`` at 100 bp
(the staged tile's widths) and 420 bp (the row kernel's), the wide
program included, and the protein and sharded steps, which ignore
``ranked`` in both packages. The inputs are made from seeds; every
output is integers and equality is exact."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.index import table as jtable
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.ops import seedextend as jseed
from umgap_tpu.parallel import make_mesh as jmake_mesh
from umgap_tpu.parallel import sharded as jsharded
from umgap_tpu.pipeline import proteins as jprot
from umgap_tpu.pipeline.fused import PRESETS as JPRESETS
from umgap_tpu.pipeline.runner import Analyser as JAnalyser
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa as jfixture_taxa
from umgap_tpu_torch import convert
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding, kmers, seedextend, translate
from umgap_tpu_torch.parallel import make_mesh
from umgap_tpu_torch.parallel import sharded as psharded
from umgap_tpu_torch.pipeline import proteins
from umgap_tpu_torch.pipeline.fused import PRESETS
from umgap_tpu_torch.pipeline.runner import Analyser
from umgap_tpu_torch.taxonomy import Taxonomy, fixture_taxa

# taxa 0-8 of the lanes' score table (0: no score); 11 lies past it
SEED_SCORES = np.array([0, 12, 0, 3, 12, 12, 0, 5, 12], np.int32)
IDS = [2, 10239, 12884, 185751, 185752, 1]
# the taxa of a pair's blocks: two families and their superkingdom, or
# two superkingdoms (fixture_taxa)
LINEAGES = ([12884, 185751, 185752, 185751], [2, 2, 10239, 2])


def _lanes(rng, n, N, g):
    """n lanes of N windows: runs of 1-5 equal taxa (gaps, scored,
    unscored and out-of-table ones), lanes opening with 1..g zeros (b2,
    whose push may have start > stop), lanes of two equal seeds (a tie),
    all-zero lanes (no push), lengths 0..N with a third at N."""
    t = np.zeros((n, N), np.int32)
    pool = np.array([0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 11], np.int32)
    for i in range(n):
        p = int(rng.integers(1, g + 1)) if g and i % 4 == 1 else 0
        while p < N:
            run = int(rng.integers(1, 6))
            t[i, p:p + run] = rng.choice(pool)
            p += run
    t[::9] = 0
    t[2::9] = 0
    t[2::9, 1:5] = t[2::9, N - 5:N - 1] = 4  # a tie of equal seeds
    lens = rng.integers(0, N + 1, size=n).astype(np.int32)
    lens[::3] = N
    lens[2::9] = N
    return t, lens


@pytest.mark.parametrize("penalty", [0, 5, 9])
@pytest.mark.parametrize("g", [0, 1, 2])
@pytest.mark.parametrize("s", [2, 3, 4])
def test_scored_plain_matches_jax(s, g, penalty):
    """Both formulations and the CPU wrapper equal umgap_tpu's scored
    mask and select, on both sides of the staged tile's 96 windows."""
    rng = np.random.default_rng(100 * s + 10 * g + penalty)
    sc = torch.from_numpy(SEED_SCORES)
    for N in (30, 96, 97, 130):
        t, lens = _lanes(rng, 90, N, g)
        keep = jseed.seedextend_scored_mask_batch(
            jnp.asarray(t), jnp.asarray(lens), jnp.asarray(SEED_SCORES),
            penalty, s, g)
        want = np.where(np.asarray(keep), t, 0)
        tt, ln = torch.from_numpy(t), torch.from_numpy(lens)
        for got in (seedextend.seedextend_scored_hits_plain(
                        tt, ln, sc, penalty, s, g),
                    seedextend.seedextend_scored_runs_plain(
                        tt, ln, sc, penalty, s, g),
                    seedextend.seedextend_hits(tt, ln, s, g, seed_scores=sc,
                                               penalty=penalty),
                    seedextend.seedextend_hits_plain(
                        tt, ln, s, g, seed_scores=sc, penalty=penalty)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()


def test_scored_plain_edge_lanes_match_jax():
    """A lane whose only push is b2's (start > stop: a negative score),
    one where it competes with a later seed, a tie (the last is kept),
    lanes shorter than N and (lanes, 6, W) batches as the step passes
    them."""
    N = 30
    t = np.zeros((6, N), np.int32)
    t[:2, 1] = 5  # g = 1: b2 at 1, the flush pushes [2, 1)
    t[1, 6:9] = 7
    t[2, 2:6] = t[2, 12:16] = 4  # equal seeds
    t[3, 2:6], t[3, 12:15] = 4, 8  # the first one scores more
    t[4, :20] = 3
    t[5, 3:25] = 7
    lens = np.array([N, N, N, N, 10, 0], np.int32)
    sc = torch.from_numpy(SEED_SCORES)
    for s, g, penalty in ((1, 1, 5), (2, 1, 0), (3, 2, 9)):
        keep = jseed.seedextend_scored_mask_batch(
            jnp.asarray(t), jnp.asarray(lens), jnp.asarray(SEED_SCORES),
            penalty, s, g)
        want = np.where(np.asarray(keep), t, 0)
        for fn in (seedextend.seedextend_scored_hits_plain,
                   seedextend.seedextend_scored_runs_plain):
            got = fn(torch.from_numpy(t), torch.from_numpy(lens), sc,
                     penalty, s, g)
            np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0].any() and want[2, 12:16].all()
    rng = np.random.default_rng(3)
    t, lens = _lanes(rng, 6 * 20, 45, 1)
    keep = jseed.seedextend_scored_mask_batch(
        jnp.asarray(t.reshape(20, 6, 45)), jnp.asarray(lens.reshape(20, 6)),
        jnp.asarray(SEED_SCORES), 5, 3, 1)
    got = seedextend.seedextend_hits(
        torch.from_numpy(t.reshape(20, 6, 45)),
        torch.from_numpy(lens.reshape(20, 6)), 3, 1, seed_scores=sc)
    np.testing.assert_array_equal(
        got.numpy(), np.where(np.asarray(keep), t.reshape(20, 6, 45), 0))


def _walk_lanes(rng, N, g, n=24):
    """``_lanes`` plus the walk's edges: lanes opening with g zeros and
    g - 1 (b2 at g or g - 1, its next position at a G-window edge when g
    is 31 or 127), lengths 0, 1 and N."""
    t, lens = _lanes(rng, n, N, g)
    for i, z in enumerate((g, max(g - 1, 0))):
        if z < N - 4:
            t[i, :z] = 0
            t[i, z:z + 3] = 5
            t[i, z + 3:z + 5] = 0
            lens[i] = N
    lens[-3:] = (0, 1, N)
    t[-2, 0] = 4
    if g:  # b2's push (start > stop) tied by a later seed of 4 unscored
        t[2] = 0
        t[2, 1] = 5
        t[2, g + 4:g + 8] = 2
        lens[2] = N
    return t, lens


# umgap_tpu's scored mask, compiled once a shape (s, g and the penalty
# traced) rather than dispatched op by op
_jscored = jax.jit(jseed.seedextend_scored_mask_batch)


def _hold_walk(t, lens, scores, penalty, s, g):
    keep = _jscored(jnp.asarray(t), jnp.asarray(lens), jnp.asarray(scores),
                    penalty, s, g)
    want = np.where(np.asarray(keep), t, 0)
    tt, ln = torch.from_numpy(t), torch.from_numpy(lens)
    sc = torch.from_numpy(scores)
    for hits in (True, False)[:1 if t.shape[-1] > 160 else 2]:
        got = seedextend.seedextend_scored_walk_plain(tt, ln, sc, penalty, s,
                                                      g, hits=hits)
        np.testing.assert_array_equal(
            got.numpy(), want if hits else np.asarray(keep))
    np.testing.assert_array_equal(seedextend.seedextend_scored_runs_plain(
        tt, ln, sc, penalty, s, g).numpy(), want)
    return want


@pytest.mark.parametrize("penalty", [0, 5])
@pytest.mark.parametrize("g", [0, 1, 2])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_scored_walk_plain_matches_jax(s, g, penalty):
    """K3RS's formulation (``seedextend_scored_walk_plain``: scores looked
    up first, candidates found as the walk goes, b2's stop adding taxon
    0's score) and the row formulation equal umgap_tpu's scored mask and
    select at the row kernel's widths, past the staged tile to 4,000
    windows; with ties, unscored and out-of-table ids, a table with a
    negative score, and lengths 0, 1 and N."""
    rng = np.random.default_rng(1000 * s + 10 * g + penalty)
    neg = SEED_SCORES.copy()
    neg[5] = -4
    for N in (97, 128, 129, 132, 160, 420, 4000):
        t, lens = _walk_lanes(rng, N, g, n=24 if N < 4000 else 8)
        want = _hold_walk(t, lens, SEED_SCORES if N % 2 else neg, penalty,
                          s, g)
        assert want.any()


@pytest.mark.parametrize("penalty", [-3, -1])
@pytest.mark.parametrize("g", [1, 2, 31])
def test_scored_walk_plain_negative_penalty_matches_jax(g, penalty):
    """With a negative penalty a push out of b2's gap (start > stop, a
    score of minus the taxon at b2's) can be the best, or tie a later
    seed of unscored taxa (which the later one wins): b2's moved stop
    must add the gap's score (taxon 0's)."""
    rng = np.random.default_rng(50 + g - penalty)
    for N in (97, 132, 160):
        t, lens = _walk_lanes(rng, N, g)
        for s in (1, 2):
            _hold_walk(t, lens, SEED_SCORES, penalty, s, g)


@pytest.mark.parametrize("g", [31, 32, 127, 128])
def test_scored_walk_plain_chunk_edges_match_jax(g):
    """b2 and the position after it on both sides of a 32- and a
    128-window edge (lanes opening with g and g - 1 zeros)."""
    rng = np.random.default_rng(g)
    for N, s, penalty in ((132, 2, 5), (160, 1, 0), (300, 3, 5)):
        t, lens = _walk_lanes(rng, N, g)
        _hold_walk(t, lens, SEED_SCORES, penalty, s, g)


@pytest.mark.parametrize("penalty", [0, 5, 9])
def test_apply_seedextend_scored_matches_jax(penalty):
    """The host state machine with a taxonomy keeps the best seed as
    umgap_tpu's does, and as the batched plain version over the
    taxonomy's seed scores."""
    jtax, ptax = JTaxonomy(jfixture_taxa()), Taxonomy(fixture_taxa())
    rng = np.random.default_rng(penalty)
    ids = np.array([0, 0, 0] + IDS + [99999], np.int32)
    scores = torch.from_numpy(ptax.seed_scores())
    for n in range(200):
        N = int(rng.integers(1, 60))
        t = np.repeat(rng.choice(ids, size=N), rng.integers(1, 4, size=N))
        for s, g in ((2, 0), (3, 1), (1, 2)):
            want = jseed.apply_seedextend(t.tolist(), s, g, jtax, penalty)
            got = seedextend.apply_seedextend(t.tolist(), s, g, ptax,
                                              penalty)
            assert got == want
            assert seedextend.apply_seedextend(t.tolist(), s, g) == \
                jseed.apply_seedextend(t.tolist(), s, g)
            hits = seedextend.seedextend_scored_hits_plain(
                torch.from_numpy(t[None]), torch.tensor([len(t)]), scores,
                penalty, s, g)[0]
            assert [int(x) for x in hits if x] == [x for x in want if x]


def _reads_world(L, n, seed):
    """n read pairs of width L and a 9-mer index of most of their own
    k-mers in blocks of 7 windows (a taxon of the pair's lineage a block;
    every third block left out: seeds of several taxa, lengths and scores
    a frame), both packages' state of one table built by each one's
    ``KmerTable.build``."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    lens = rng.integers(L // 2, L + 1, size=(n, 2)).astype(np.int32)
    lens[::4] = L
    code = encoding.get_table(1)
    kmap = {}
    for i in range(n):
        for e in range(2):
            seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
            for j, pep in enumerate(translate.translate_sequence(
                    seq, translate.FRAME_NAMES, code)):
                ac = encoding.encode_aa(pep)
                for w in range(len(ac) - 8):
                    b = (w + i) // 7
                    if b % 3 != 2 and ac[w:w + 9].max() < 20:
                        kmap.setdefault(int(kmers.pack_kmers_host(
                            ac[w:w + 9], 9)[0]),
                            LINEAGES[i % 2][(i + j + b) % 4])
    packed = np.array(sorted(kmap), np.uint64)
    values = np.array([kmap[k] for k in sorted(kmap)], np.int32)
    jt = jtable.KmerTable.build(packed, values, k=9)
    pt = ptable.KmerTable.build(packed, values, k=9)
    return dict(codes=codes, lens=lens, jt=jt, pt=pt, L=L,
                jtax=JTaxonomy(jfixture_taxa()),
                ptax=Taxonomy(fixture_taxa()),
                headers=[f"g{i}" for i in range(n)])


@pytest.fixture(scope="module")
def worlds():
    return {100: _reads_world(100, 96, 1), 420: _reads_world(420, 40, 2)}


@pytest.mark.parametrize("L", [100, 420])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_analyser_ranked_matches_jax(worlds, preset, L):
    """``Analyser`` with ``ranked=True`` (k_max 2, so that the wide
    program re-runs most groups) gives umgap_tpu's taxa; at 420 bp a
    frame has 132 windows, the row kernel's width on the card."""
    w = worlds[L]
    assert (seedextend.seedextend_path((L + 2) // 3 - 8) == "staged") == \
        (L == 100)
    out = {}
    for ranked in (True, False):
        jcfg = JPRESETS[preset]._replace(ranked=ranked, k_max=2)
        pcfg = PRESETS[preset]._replace(ranked=ranked, k_max=2)
        assert tuple(pcfg) == tuple(jcfg)
        ja = JAnalyser(w["jtax"], w["jt"], jcfg, batch_size=32,
                       read_length=L, ends=2)
        want = list(ja.analyse_arrays(w["headers"], w["codes"], w["lens"]))
        pa = Analyser(w["ptax"], w["pt"], pcfg, batch_size=32,
                      read_length=L, ends=2, device="cpu")
        got = list(pa.analyse_arrays(w["headers"], w["codes"], w["lens"]))
        assert got == want
        assert pa.overflow_reads == ja.overflow_reads > 0
        out[ranked] = [t for _h, t in got]
    if preset == "max-sensitivity":  # seeds from 2 windows, every hit
        assert out[True] != out[False]  # counts: scoring moves some groups
    assert sum(t != 1 for t in out[True]) > 5


def test_pipeline_config_field_order_matches_jax():
    """``PRESETS[p]._replace(ranked=True)`` means the same in both
    packages: the same fields in the same order."""
    assert PRESETS["max-sensitivity"]._fields == \
        JPRESETS["max-sensitivity"]._fields
    for p in PRESETS:
        assert tuple(PRESETS[p]._replace(ranked=True, penalty=7)) == \
            tuple(JPRESETS[p]._replace(ranked=True, penalty=7))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_protein_step_ignores_ranked_as_jax(preset):
    """umgap_tpu's protein step runs the unscored seed-extend whatever
    ``ranked`` says (umgap_tpu/pipeline/proteins.py:37), and so does the
    port's."""
    rng = np.random.default_rng(11)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    groups = [(f"g{i}", ["".join(rng.choice(list(aas), size=int(
        rng.integers(0, 60)))) for _ in range(int(rng.integers(0, 3)))])
        for i in range(80)]
    keys, vals = [], []
    for i, (_h, prots) in enumerate(groups):
        for j, p in enumerate(prots):
            packed = kmers.pack_kmers_host(encoding.encode_aa(p), 9)
            keys.append(packed)
            vals.append(np.full(len(packed), IDS[(i + j) % 5]))
    keys, first = np.unique(np.concatenate(keys), return_index=True)
    vals = np.concatenate(vals)[first].astype(np.int32)
    table = jtable.build_kmer_table(keys, vals, k=9)
    dt = jlookup.DeviceTable.from_host(table)
    dx = jagg.DeviceTaxonomy.from_host(JTaxonomy(jfixture_taxa()))
    pt = convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu")
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    aa, lens = jprot.encode_protein_groups(groups, 2, 64)
    want = jprot.protein_pipeline_step(
        aa, lens, dx, dt, JPRESETS[preset]._replace(ranked=True))
    got = proteins.protein_pipeline_step(
        torch.from_numpy(aa), torch.from_numpy(lens), px, pt,
        PRESETS[preset]._replace(ranked=True))
    plain = proteins.protein_pipeline_step(
        torch.from_numpy(aa), torch.from_numpy(lens), px, pt,
        PRESETS[preset])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("preset", ["max-sensitivity", "high-sensitivity"])
def test_sharded_step_ignores_ranked_as_jax(worlds, preset):
    """umgap_tpu's sharded step runs the unscored seed-extend whatever
    ``ranked`` says (umgap_tpu/parallel/sharded.py:431); so does the
    port's, over a 4-device mesh of the index split in 4."""
    w = worlds[100]
    packed, values = w["jt"].items()
    js = jsharded.build_sharded_tables(packed, values, 9, 4)
    ps = [ptable.KmerTable(t.rem, t.values, t.max_probes, t.n, t.meta,
                           t.stash_hi, t.stash_lo, t.stash_val) for t in js]
    mesh = jmake_mesh(4)
    jcfg = JPRESETS[preset]._replace(ranked=True)
    pcfg = PRESETS[preset]._replace(ranked=True)
    jdx = jagg.DeviceTaxonomy.from_host(w["jtax"])
    step = jsharded.make_sharded_pipeline(
        jdx, jsharded.ShardedTable.from_shards(js, mesh), jcfg, mesh,
        with_overflow=True)
    codes, lens = w["codes"][:64], w["lens"][:64]
    jt = np.asarray(step(jnp.asarray(codes), jnp.asarray(lens))[0])
    stable = psharded.ShardedTable.from_shards(ps, make_mesh(4, "cpu"))
    pdx = DeviceTaxonomy.from_host(w["ptax"], "cpu")
    cut = psharded.split_to_mesh
    got = {}
    for cfg in (pcfg, PRESETS[preset]):
        pstep = psharded.ShardedPipeline(pdx, stable, cfg, False, True)
        taxa, _over = pstep(cut(encoding.pack_dna4(codes), stable.devices),
                            cut(lens, stable.devices), w["L"])
        got[cfg.ranked] = torch.cat(taxa).numpy()
    np.testing.assert_array_equal(got[True], jt)
    np.testing.assert_array_equal(got[True], got[False])
    assert (jt != 1).sum() > 5


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["scored/max-sensitivity",
                                  "scored/high-sensitivity"])
def test_chip_smoke_scored_digests(name):
    """chip_smoke.py holds the card's scored taxa of the first 1,024
    ``.bench_data`` pairs to digests of umgap_tpu's; recompute them here
    with umgap_tpu's Analyser at the same batch and width."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    data = os.path.join(REPO, ".bench_data")
    with open(os.path.join(data, "manifest.json")) as f:
        man = json.load(f)
    P, L = man["n_pairs"], man["read_len"]
    parent = np.fromfile(os.path.join(data, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(data, "snap.bin"), np.int32)
    tax = JTaxonomy([JTaxon(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                            int(parent[i]), bool(snap[i] == i))
                     for i in range(1, man["n_tax"] + 1)])
    keys = np.fromfile(os.path.join(data, "index_keys.bin"), np.uint64)
    vals = np.fromfile(os.path.join(data, "index_vals.bin"), np.int32)
    table = jtable.build_kmer_table(keys, vals, k=9)
    n = smoke.REFERENCE_PAIRS
    reads = np.fromfile(os.path.join(data, "reads.bin"),
                        np.uint8).reshape(P, 2, L)[:n]
    preset, kw = smoke.SCORED_CONFIGS[name]
    cfg = JPRESETS[preset]._replace(**kw)
    assert cfg.ranked
    ja = JAnalyser(tax, table, cfg, batch_size=n, read_length=L, ends=2)
    want = [t for _h, t in ja.analyse_arrays(
        [str(i) for i in range(n)], reads, np.full((n, 2), L, np.int32))]
    assert smoke.taxa_digest(want) == smoke.REFERENCE_DIGESTS[name]
