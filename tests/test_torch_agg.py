"""Parity of the port's aggregation (the plain versions of K4 dedup, K5
gathers and K6 tree aggregators, through the dispatch the kernels take
on the CPU, and the Euler/RMQ aggregators) with ``umgap_tpu.agg``, on the
reference fixture taxonomy and on the tracked ``.bench_data`` taxonomy.
All outputs are integers or masks: exact equality throughout."""

import os

import numpy as np
import pytest
import torch

from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.agg import device_rmq as jrmq
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa as jfixture
from umgap_tpu_torch import convert, kernels
from umgap_tpu_torch import taxonomy as ptaxonomy
from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.agg import device_rmq as prmq

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_data")


def _first_seen(taxa, out):
    """umgap_tpu's dedup_counts output (ids ascending) with each row's
    slots put in first-seen order, as a weighted dedup of the port hands
    them over (agg/device.py first_seen_order): by each id's first
    position in the row, padding last."""
    ut, uc, uv = (np.asarray(a) for a in out[:3])
    key = np.full(ut.shape, np.iinfo(np.int32).max, np.int64)
    for b in range(ut.shape[0]):
        pos = {}
        for i, t in enumerate(taxa[b].tolist()):
            if t > 0:
                pos.setdefault(t, i)
        for k, t in enumerate(ut[b].tolist()):
            if t in pos and t != np.iinfo(np.int32).max:
                key[b, k] = pos[t]
    perm = np.argsort(key, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, perm, axis=1)
    return (take(ut), take(uc), take(uv)) + tuple(out[3:])


@pytest.mark.parametrize("k_max,weighted", [(4, False), (16, False),
                                            (40, True), (200, False)])
def test_dedup_counts_matches_jax(k_max, weighted):
    rng = np.random.default_rng(k_max)
    B, N = 64, 60
    taxa = rng.integers(-2, 30, size=(B, N)).astype(np.int32)
    taxa[:4] = 0  # rows without hits
    w = (rng.integers(0, 4, size=(B, N)).astype(np.float32) if weighted
         else np.ones((B, N), np.float32))
    want = jagg.dedup_counts(taxa, w, k_max, return_nuniq=True)
    if weighted:
        want = _first_seen(taxa, want)
    got = pagg.dedup_counts(torch.from_numpy(taxa),
                            torch.from_numpy(w) if weighted else None,
                            k_max, return_nuniq=True)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def _hit_rows(rng, B, N, n_valid):
    """(B, N) rows with ``n_valid`` positive ids each (few distinct, as
    seed-extend leaves them) among zeros and negatives."""
    taxa = rng.integers(-3, 1, size=(B, N)).astype(np.int32)
    for b in range(B):
        pos = rng.choice(N, size=n_valid[b], replace=False)
        taxa[b, pos] = rng.integers(1, 1 + int(rng.integers(1, 40)),
                                    size=n_valid[b])
    return taxa


@pytest.mark.parametrize("N", [300, 540])
@pytest.mark.parametrize("many", [False, True])
def test_dedup_counts_bench_widths_match_jax(N, many):
    """The main path's row widths (100 and 160 bp), rows of few valid
    hits (0-40, the bench's range) and of many (up to N)."""
    rng = np.random.default_rng(N + many)
    B = 48
    n_valid = rng.integers(0, N + 1 if many else 41, size=B)
    n_valid[:3] = (0, 1, 33)
    taxa = _hit_rows(rng, B, N, n_valid)
    for k_max, weighted in ((64, False), (8, True)):
        w = (rng.integers(0, 4, size=(B, N)).astype(np.float32) if weighted
             else np.ones((B, N), np.float32))
        want = jagg.dedup_counts(taxa, w, k_max, return_nuniq=True)
        if weighted:
            want = _first_seen(taxa, want)
        got = pagg.dedup_counts(torch.from_numpy(taxa),
                                torch.from_numpy(w) if weighted else None,
                                k_max, return_nuniq=True)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_dedup_path_by_row_width():
    """K4's path is chosen by N alone: one warp a row up to 1,024 hits,
    one block a row over the row's valid hits above (no width is
    refused)."""
    assert pagg.dedup_path(300) == "warp"
    assert pagg.dedup_path(540) == "warp"
    assert pagg.dedup_path(pagg.WARP_DEDUP_N) == "warp"
    assert pagg.dedup_path(pagg.WARP_DEDUP_N + 1) == "rows"
    assert pagg.dedup_path(16384) == "rows"
    assert pagg.dedup_path(16385) == "rows"
    assert pagg.dedup_path(2 * 6 * 4000) == "rows"


def _bench_taxonomies():
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    n = len(parent) - 1

    def taxa(cls):
        return [cls(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                    int(parent[i]), bool(snap[i] == i))
                for i in range(1, n + 1)]

    return JTaxonomy(taxa(JTaxon)), ptaxonomy.Taxonomy(taxa(ptaxonomy.Taxon))


def _fixture_taxonomies():
    return (JTaxonomy(jfixture()),
            ptaxonomy.Taxonomy(ptaxonomy.fixture_taxa()))


def _carried(jtax):
    dx = jagg.DeviceTaxonomy.from_host(jtax)
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    return dx, px


@pytest.mark.parametrize("world", ["fixture", "bench"])
def test_port_taxonomy_matches_jax(world):
    jtax, ptax = (_fixture_taxonomies() if world == "fixture"
                  else _bench_taxonomies())
    np.testing.assert_array_equal(ptax.depth, jtax.depth)
    np.testing.assert_array_equal(ptax.anc_table, jtax.anc_table)
    for ranked in (False, True):
        np.testing.assert_array_equal(ptax.snapping(ranked),
                                      jtax.snapping(ranked))
    np.testing.assert_array_equal(ptax.seed_scores(), jtax.seed_scores())
    dx, _ = _carried(jtax)
    mine = pagg.DeviceTaxonomy.from_host(ptax, device="cpu")
    np.testing.assert_array_equal(mine.geom.numpy(), np.asarray(dx.geom))


def _hit_lists(rng, ids, B, K):
    utaxa = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    ucounts = np.zeros((B, K), np.float32)
    uvalid = np.zeros((B, K), bool)
    for b in range(B):
        m = int(rng.integers(0, K + 1))
        sel = np.sort(rng.choice(ids, size=min(m, len(ids)), replace=False))
        utaxa[b, : len(sel)] = sel
        ucounts[b, : len(sel)] = rng.integers(1, 7, size=len(sel))
        uvalid[b, : len(sel)] = True
    return utaxa, ucounts, uvalid


def _world_hits(world, K, seed):
    jtax, _ = (_fixture_taxonomies() if world == "fixture"
               else _bench_taxonomies())
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(jtax.present & (jtax.depth >= 0))
    if world == "bench":  # hits along a few lineages, so trees branch
        leaves = rng.choice(ids, size=max(12, K // 4), replace=False)
        ids = np.unique(jtax.anc_table[leaves][jtax.anc_table[leaves] > 0])
    return jtax, _hit_lists(rng, ids, 48, K)


@pytest.mark.parametrize("world", ["fixture", "bench"])
@pytest.mark.parametrize("method,strategy", [("tree", "lca*"),
                                             ("tree", "hybrid"),
                                             ("rmq", "mrtl"),
                                             ("rmq", "lca*"),
                                             ("rmq", "hybrid")])
def test_aggregate_filter_snap_match_jax(world, method, strategy):
    jtax, (utaxa, ucounts, uvalid) = _world_hits(world, 12,
                                                 len(world) + len(strategy))
    dx, px = _carried(jtax)
    je = pe = None
    if (method, strategy) == ("rmq", "lca*"):
        je = jrmq.DeviceEuler.from_host(jtax)
        pe = convert.euler_from_arrays(
            np.asarray(je.tour), np.asarray(je.depths),
            np.asarray(je.first), np.asarray(je.block_min),
            np.asarray(je.sparse), je.nlevels, je.tour_len, device="cpu")
    for bound in (1.0, 3.0):
        fv = np.asarray(jagg.filter_lower_bound(ucounts, uvalid, bound))
        pv = pagg.filter_lower_bound(torch.from_numpy(ucounts),
                                     torch.from_numpy(uvalid), bound)
        np.testing.assert_array_equal(pv.numpy(), fv)
        want = np.asarray(jagg.aggregate_batch(dx, utaxa, ucounts, fv,
                                               method, strategy, 0.25,
                                               euler=je))
        got = pagg.aggregate_batch(px, torch.from_numpy(utaxa),
                                   torch.from_numpy(ucounts), pv, method,
                                   strategy, 0.25, euler=pe)
        np.testing.assert_array_equal(got.numpy(), want)
        for snapping in ("snap_valid", "snap_ranked"):
            np.testing.assert_array_equal(
                pagg.snap_batch(getattr(px, snapping), got, 0).numpy(),
                np.asarray(jagg.snap_batch(getattr(dx, snapping), want, 0)))
    # out-of-range and unsnappable ids take the default
    odd = np.array([-5, 0, jtax.size, jtax.size + 9], np.int32)
    np.testing.assert_array_equal(
        pagg.snap_batch(px.snap_valid, torch.from_numpy(odd), 7).numpy(),
        np.asarray(jagg.snap_batch(dx.snap_valid, odd, 7)))


@pytest.mark.parametrize("world,K", [("fixture", 4), ("bench", 4),
                                     ("bench", 64), ("bench", 300)])
def test_hit_geometry_matches_jax(world, K):
    jtax, (utaxa, ucounts, uvalid) = _world_hits(world, K, K)
    dx, px = _carried(jtax)
    want = jagg.hit_geometry(dx, utaxa, uvalid)
    got = pagg.hit_geometry(px, torch.from_numpy(utaxa),
                            torch.from_numpy(uvalid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.is_anc.any()
    # the plain reference is the same function
    with kernels.plain_versions():
        ref = pagg.hit_geometry(px, torch.from_numpy(utaxa),
                                torch.from_numpy(uvalid))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    # without the ancestry test (tree hybrid): the same rows, no is_anc
    lean = pagg.hit_geometry(px, torch.from_numpy(utaxa),
                             torch.from_numpy(uvalid), ancestry=False)
    assert lean.is_anc is None
    for name in ("lin", "depth", "valid"):
        assert torch.equal(getattr(lean, name), getattr(got, name))
    assert not pagg.needs_ancestry("tree", "hybrid")
    assert pagg.needs_ancestry("tree", "lca*")
    assert pagg.needs_ancestry("rmq", "mrtl")


@pytest.mark.parametrize("world,K", [("fixture", 4), ("bench", 4),
                                     ("bench", 64), ("bench", 300)])
@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
def test_tree_strategies_match_jax(world, K, strategy):
    jtax, (utaxa, ucounts, uvalid) = _world_hits(world, K, K + 7)
    dx, px = _carried(jtax)
    jg = jagg.hit_geometry(dx, utaxa, uvalid)
    pg = pagg.hit_geometry(px, torch.from_numpy(utaxa),
                           torch.from_numpy(uvalid))
    u, c = torch.from_numpy(utaxa), torch.from_numpy(ucounts)
    for factor in (0.25, 0.6):
        if strategy == "hybrid":
            want = jagg.tree_mix_batch(dx, jg, utaxa, ucounts, factor)
            got = pagg.tree_mix_batch(px, pg, u, c, factor)
        elif strategy == "lca*":
            want = jagg.tree_lca_batch(dx, jg, utaxa)
            got = pagg.tree_lca_batch(px, pg, u)
        else:
            want = jagg.rtl_batch(dx, jg, utaxa, ucounts)
            got = pagg.rtl_batch(px, pg, u, c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            pagg.tree_aggregate(strategy, px, pg, u, c, factor).numpy(),
            got.numpy())
    snapped = pagg.snap_batch(px.snap_valid, got, 0)
    np.testing.assert_array_equal(
        snapped.numpy(), np.asarray(jagg.snap_batch(dx.snap_valid, want, 0)))


@pytest.mark.parametrize("world,K", [("fixture", 4), ("fixture", 64),
                                     ("bench", 4), ("bench", 64)])
def test_ancestry_epilogue_matches_jax(world, K):
    """K5's ancestry epilogue as hit_geometry dispatches it (its plain
    version on the CPU) against the JAX package's is_anc, from the same
    rows, depths, ids and valid mask."""
    from umgap_tpu_torch.ops import gather

    jtax, (utaxa, _ucounts, uvalid) = _world_hits(world, K, 3 * K)
    dx, px = _carried(jtax)
    want = np.asarray(jagg.hit_geometry(dx, utaxa, uvalid).is_anc)
    geom = pagg.hit_geometry(px, torch.from_numpy(utaxa),
                             torch.from_numpy(uvalid), ancestry=False)
    anc = gather.active()[3]
    got = anc(geom.lin, geom.depth, torch.from_numpy(utaxa), geom.valid)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.ancestry(geom.lin, geom.depth, torch.from_numpy(utaxa),
                        geom.valid).numpy(), want)
    assert want.any()


def _chain_taxonomies(n=30):
    """Every taxon on one path: taxon i's parent is i - 1."""
    def taxa(cls):
        return [cls(i, f"t{i}", jranks.NO_RANK, max(1, i - 1), True)
                for i in range(1, n + 1)]

    return JTaxonomy(taxa(JTaxon)), ptaxonomy.Taxonomy(taxa(ptaxonomy.Taxon))


def _filtered_hits(jtax, B, K, seed):
    """Hit lists as the pipeline hands them to the aggregator: ascending
    distinct ids with I32_MAX padding, groups of 0, 1, 2, 3, all K (as far
    as the taxonomy has ids) and a random count of valid slots; in every
    third group some slots are filtered out (invalid, id kept)."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(jtax.present & (jtax.depth >= 0))
    leaves = rng.choice(ids, size=min(len(ids), 12), replace=False)
    lineage = np.unique(jtax.anc_table[leaves][jtax.anc_table[leaves] > 0])
    utaxa = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    ucounts = np.zeros((B, K), np.float32)
    uvalid = np.zeros((B, K), bool)
    for b in range(B):
        m = (0, 1, 2, 3, K, int(rng.integers(0, K + 1)))[b % 6]
        pool = lineage if m <= len(lineage) else ids
        sel = np.sort(rng.choice(pool, size=min(m, len(pool)),
                                 replace=False))
        utaxa[b, :len(sel)] = sel
        ucounts[b, :len(sel)] = rng.integers(1, 7, size=len(sel))
        uvalid[b, :len(sel)] = True
        if b % 3 == 2:
            uvalid[b] &= rng.random(K) < 0.7
    return utaxa, ucounts, uvalid


_WORLDS = {"fixture": _fixture_taxonomies, "bench": _bench_taxonomies,
           "chain": _chain_taxonomies}


@pytest.mark.parametrize("world", ["fixture", "bench", "chain"])
@pytest.mark.parametrize("K", [4, 64, 408])
@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
def test_tree_aggregate_hits_matches_jax(world, K, strategy):
    """K6's hits entry (its plain version on the CPU) against the JAX
    aggregator over the JAX hit_geometry, with empty groups and groups
    whose every slot is valid; the dispatch and the HitGeometry entry
    give the same taxa."""
    jtax, _ = _WORLDS[world]()
    B = 12 if K > 64 else 48
    utaxa, ucounts, uvalid = _filtered_hits(jtax, B, K, K + len(world))
    assert not uvalid[0].any() and uvalid[4, :min(K, 3)].all()
    dx, px = _carried(jtax)
    jg = jagg.hit_geometry(dx, utaxa, uvalid)
    u, c, v = (torch.from_numpy(x) for x in (utaxa, ucounts, uvalid))
    for factor in ((0.25, 0.5, 1.0) if strategy == "hybrid" else (0.25,)):
        if strategy == "hybrid":
            want = jagg.tree_mix_batch(dx, jg, utaxa, ucounts, factor)
        elif strategy == "lca*":
            want = jagg.tree_lca_batch(dx, jg, utaxa)
        else:
            want = jagg.rtl_batch(dx, jg, utaxa, ucounts)
        got = pagg.tree_aggregate_hits(strategy, px, u, c, v, factor)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        method = "rmq" if strategy == "mrtl" else "tree"
        assert torch.equal(pagg.aggregate_batch(px, u, c, v, method,
                                                strategy, factor), got)
        pg = pagg.hit_geometry(px, u, v, strategy != "hybrid")
        assert torch.equal(pagg.tree_aggregate(strategy, px, pg, u, c,
                                               factor), got)


def test_tree_path_by_valid_count():
    """K6 at K <= 64 walks a group of up to TREE_THREAD_CAP valid hits
    with one thread (the bench's 1-3 among them) and a larger one with a
    warp; past K = 64 a block takes every group (the block path), its
    list in shared memory up to K = 17,920 and in a global scratch of
    at most TREE_BLOCK_GRID lists above. The limits are the kernel's
    own."""
    import re
    from pathlib import Path

    src = (Path(pagg.__file__).parents[1] / "csrc" /
           "tree_aggregate.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+)", src)[1])

    cap = const("kThreadCap")
    assert pagg.TREE_THREAD_CAP == cap
    assert pagg.TREE_WIDE_K == const("kWideK") == 64
    assert pagg.TREE_BLOCK_GRID == const("kBlockGrid")
    assert pagg.TREE_AUX_BYTES == const("kHashSlots") * 8
    assert pagg.TREE_SMEM_MAX == 226 * 1024
    assert "kSmemMax = 226 * 1024;" in src
    for n in (0, 1, 3, cap):
        assert pagg.tree_path(n, 64) == "thread"
    assert pagg.tree_path(cap + 1, 64) == "warp"
    assert pagg.tree_path(64, 64) == "warp"
    for n in (0, 1, cap, cap + 1, 65, 648):
        assert pagg.tree_path(n, 648) == "block"
    assert pagg.tree_path(0, 65) == "block"
    # the block's list: 12 bytes a slot, in shared memory through
    # K = 17,920 (16,392, the wide program of 4,096 bp reads, included)
    assert pagg.tree_list_bytes(16392) == 12 * 16392
    for K in (4, 64, 65, 408, 16392, 17920):
        assert pagg.tree_scratch_bytes(600, K) == 0
    assert pagg.tree_scratch_blocks(8, 17921) == 8
    assert pagg.tree_scratch_blocks(600, 32004) == pagg.TREE_BLOCK_GRID
    assert pagg.tree_scratch_bytes(600, 32004) == \
        pagg.TREE_BLOCK_GRID * 12 * 32004
    # past TREE_SCRATCH_MAX bytes of lists, fewer blocks, never none
    assert pagg.tree_scratch_blocks(600, 1 << 22) == \
        pagg.TREE_SCRATCH_MAX // (12 << 22)
    assert pagg.tree_scratch_blocks(600, 1 << 25) == 1


@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
def test_tree_aggregate_hits_edge_cases_match_jax(strategy):
    """The fused entry's edge cases on the fixture taxonomy (root 1;
    2, 10239, 12884 below it; 185751, 185752 below 12884): no valid slot
    (hybrid gives the root, mrtl I32_MAX, lca* its fallback on slot 0's
    row, table row 0), filtered-out slots that keep real ids, siblings
    that all end at the same depth (ties to the smallest branch), one
    valid slot."""
    jtax, _ = _fixture_taxonomies()
    dx, px = _carried(jtax)
    big = np.iinfo(np.int32).max
    rows = [([big] * 4, [0] * 4, [False] * 4),
            ([2, 10239, 12884, big], [3, 2, 1, 0], [False] * 4),
            ([2, 10239, 12884, big], [1, 1, 1, 0], [True] * 3 + [False]),
            ([185751, 185752, big, big], [2, 2, 0, 0],
             [True, True, False, False]),
            ([12884, 185751, 185752, big], [1, 3, 3, 0], [True] * 3 + [False]),
            ([10239, big, big, big], [4, 0, 0, 0], [True] + [False] * 3)]
    utaxa = np.array([r[0] for r in rows], np.int32)
    ucounts = np.array([r[1] for r in rows], np.float32)
    uvalid = np.array([r[2] for r in rows], bool)
    jg = jagg.hit_geometry(dx, utaxa, uvalid)
    u, c, v = (torch.from_numpy(x) for x in (utaxa, ucounts, uvalid))
    for factor in (0.25, 0.5, 1.0):
        if strategy == "hybrid":
            want = jagg.tree_mix_batch(dx, jg, utaxa, ucounts, factor)
        elif strategy == "lca*":
            want = jagg.tree_lca_batch(dx, jg, utaxa)
        else:
            want = jagg.rtl_batch(dx, jg, utaxa, ucounts)
        got = pagg.tree_aggregate_hits(strategy, px, u, c, v, factor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if strategy == "hybrid":
            assert got[0] == got[1] == jtax.root
            assert got[2] == (2 if factor <= 1 / 3 else jtax.root)
            assert got[3] == (185751 if factor <= 0.5 else 12884)
        elif strategy == "mrtl":
            assert got[0] == got[1] == big
        assert got[5] == 10239


# ---------------------------------------------------------------------- #
# The fused tail: K4 with the lower bound, K6 and K9 with snap,
# against umgap_tpu's dedup -> filter -> aggregate -> snap -> where
# ---------------------------------------------------------------------- #

def _jax_tail(dx, utaxa, ucounts, uvalid, bound, method, strategy, snap,
              factor=0.25, euler=None):
    """umgap_tpu's pipeline_step after the dedup (fused.py:117-124)."""
    fv = jagg.filter_lower_bound(ucounts, uvalid, bound)
    agg = jagg.aggregate_batch(dx, utaxa, ucounts, fv, method, strategy,
                               factor, euler=euler)
    return np.asarray(np.where(np.asarray(fv).any(axis=-1),
                               np.asarray(jagg.snap_batch(snap, agg, 0)),
                               1).astype(np.int32))


@pytest.mark.parametrize("N", [300, 540, 2048])
@pytest.mark.parametrize("bound", [1.0, 2.0, 5.0])
def test_dedup_lower_bound_matches_jax(N, bound):
    """K4's plain versions with the bound (the warp path's formulation
    and the row kernel's) against umgap_tpu's dedup_counts then
    filter_lower_bound: ids, counts and nuniq as without the bound,
    uvalid filtered; with and without integer weights (then in
    first-seen order), k_max above and below the distinct count."""
    rng = np.random.default_rng(int(N + 10 * bound))
    B = 40
    n_valid = rng.integers(0, min(N, 400) + 1, size=B)
    n_valid[:3] = (0, 1, 60)
    taxa = _hit_rows(rng, B, N, n_valid)
    for k_max, weighted in ((64, False), (64, True), (8, False)):
        w = (rng.integers(0, 4, size=(B, N)).astype(np.float32) if weighted
             else np.ones((B, N), np.float32))
        ju, jc, jv, jn = jagg.dedup_counts(taxa, w, k_max, return_nuniq=True)
        want = (ju, jc, jagg.filter_lower_bound(jc, jv, bound), jn)
        if weighted:
            want = _first_seen(taxa, want)
        tw = torch.from_numpy(w) if weighted else None
        for fn in (pagg.dedup_counts_plain, pagg.dedup_counts_rows_plain,
                   pagg.dedup_counts):
            got = fn(torch.from_numpy(taxa), tw, k_max, return_nuniq=True,
                     lower_bound=bound)
            for g, wnt in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
        # the bound filters some kept runs and leaves others
        assert np.asarray(jv).sum() > np.asarray(want[2]).sum() > 0 or \
            bound == 1.0 and not weighted


@pytest.mark.parametrize("world", ["fixture", "bench", "chain"])
@pytest.mark.parametrize("K", [4, 64, 408])
@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
def test_tree_aggregate_hits_snap_matches_jax(world, K, strategy):
    """K6's hits entry with the snap table (its plain version, the CPU
    dispatch, aggregate_batch and, past K = 64, the block path's
    formulation) against umgap_tpu's filter -> aggregate -> snap_batch
    -> where, at the bounds 1, 2 and 5."""
    jtax, _ = _WORLDS[world]()
    B = 12 if K > 64 else 48
    utaxa, ucounts, uvalid = _filtered_hits(jtax, B, K, 3 * K + len(world))
    dx, px = _carried(jtax)
    u, c = torch.from_numpy(utaxa), torch.from_numpy(ucounts)
    method = "rmq" if strategy == "mrtl" else "tree"
    for bound in (1.0, 2.0, 5.0):
        want = _jax_tail(dx, utaxa, ucounts, uvalid, bound, method,
                         strategy, dx.snap_valid)
        v = pagg.filter_lower_bound(c, torch.from_numpy(uvalid), bound)
        got = pagg.tree_aggregate_hits_plain(strategy, px, u, c, v, 0.25,
                                             snap=px.snap_valid)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(pagg.tree_aggregate_hits(
            strategy, px, u, c, v, 0.25, snap=px.snap_valid), got)
        assert torch.equal(pagg.aggregate_batch(
            px, u, c, v, method, strategy, 0.25, snap=px.snap_valid), got)
        if K > 64:
            assert torch.equal(pagg.tree_aggregate_wide_plain(
                strategy, px, u, c, v, 0.25, snap=px.snap_valid), got)
        assert (got == 1).any() and (got != 1).any()


@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
def test_tail_edge_rows_match_jax(strategy):
    """Rows at the edges of snap, on the fixture taxonomy with a snap
    table whose entry for 12884 is NONE: no valid slot (-> 1); every slot
    below the bound (-> 1); an aggregate of 12884 (-> 0); ids absent from
    the taxonomy, at and past the table's end (mrtl's aggregate is then
    that id -> 0)."""
    from umgap_tpu_torch.taxonomy import NONE

    jtax, _ = _fixture_taxonomies()
    dx, px = _carried(jtax)
    big, size = np.iinfo(np.int32).max, jtax.size
    rows = [([big] * 4, [0] * 4, [False] * 4),
            ([2, 10239, 12884, big], [1, 1, 1, 0], [True] * 3 + [False]),
            ([12884, big, big, big], [3, 0, 0, 0], [True] + [False] * 3),
            ([185751, 185752, big, big], [2, 2, 0, 0],
             [True] * 2 + [False] * 2),
            ([3, big, big, big], [4, 0, 0, 0], [True] + [False] * 3),
            ([size, big, big, big], [4, 0, 0, 0], [True] + [False] * 3),
            ([size + 7, big, big, big], [4, 0, 0, 0], [True] + [False] * 3),
            ([10239, big, big, big], [4, 0, 0, 0], [True] + [False] * 3)]
    utaxa = np.array([r[0] for r in rows], np.int32)
    ucounts = np.array([r[1] for r in rows], np.float32)
    uvalid = np.array([r[2] for r in rows], bool)
    snap = np.asarray(dx.snap_valid).copy()
    snap[12884] = NONE
    method = "rmq" if strategy == "mrtl" else "tree"
    u, c = torch.from_numpy(utaxa), torch.from_numpy(ucounts)
    for bound in (1.0, 2.0):
        want = _jax_tail(dx, utaxa, ucounts, uvalid, bound, method, strategy,
                         snap)
        v = pagg.filter_lower_bound(c, torch.from_numpy(uvalid), bound)
        got = pagg.tree_aggregate_hits_plain(strategy, px, u, c, v, 0.25,
                                             snap=torch.from_numpy(snap))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[0] == 1 and got[7] == 10239
        assert got[2] == 0  # snap[12884] is NONE
        assert got[1] == (1 if bound == 2.0 else got[1])
    if strategy == "mrtl":  # the aggregates 3, size and size + 7
        assert got[4] == got[5] == got[6] == 0
    # the plain snap on the aggregates themselves: in range, NONE, at and
    # past the end, negative, I32_MAX; rows with and without a valid slot
    agg = np.array([1, 12884, 3, size, size + 7, -1, big, 185752], np.int32)
    valid = np.ones((8, 4), bool)
    valid[[0, 7], :] = False
    want = np.where(valid.any(-1), np.asarray(jagg.snap_batch(
        snap, agg, 0)), 1).astype(np.int32)
    got = pagg.snap_taxa_plain(torch.from_numpy(snap), torch.from_numpy(agg),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [1, 0, 0, 0, 0, 0, 0, 1]


@pytest.mark.parametrize("world", ["fixture", "bench"])
@pytest.mark.parametrize("strategy", ["lca*", "hybrid"])
def test_snap_taxa_plain_matches_jax_on_rmq(world, strategy):
    """The Euler/RMQ aggregators end in K9's store: its plain version
    (and K9's wrapper and aggregate_batch with the snap table, on the
    CPU the same) against umgap_tpu's filter -> rmq aggregate ->
    snap_batch -> where."""
    jtax, (utaxa, ucounts, uvalid) = _world_hits(world, 12,
                                                 7 * len(world) + 1)
    dx, px = _carried(jtax)
    je = pe = None
    if strategy == "lca*":
        je = jrmq.DeviceEuler.from_host(jtax)
        pe = convert.euler_from_arrays(
            np.asarray(je.tour), np.asarray(je.depths),
            np.asarray(je.first), np.asarray(je.block_min),
            np.asarray(je.sparse), je.nlevels, je.tour_len, device="cpu")
    u, c = torch.from_numpy(utaxa), torch.from_numpy(ucounts)
    for bound in (1.0, 2.0, 5.0):
        want = _jax_tail(dx, utaxa, ucounts, uvalid, bound, "rmq", strategy,
                         dx.snap_valid, euler=je)
        v = pagg.filter_lower_bound(c, torch.from_numpy(uvalid), bound)
        agg = pagg.aggregate_batch(px, u, c, v, "rmq", strategy, 0.25,
                                   euler=pe)
        got = pagg.snap_taxa_plain(px.snap_valid, agg, v)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(prmq.rmq_aggregate(strategy, px, pe, u, c, v,
                                              0.25, snap=px.snap_valid), got)
        assert torch.equal(pagg.aggregate_batch(
            px, u, c, v, "rmq", strategy, 0.25, euler=pe,
            snap=px.snap_valid), got)
        assert (got == 1).any() and (got != 1).any()
