"""Parity of the port's Euler/RMQ aggregation (``umgap_tpu_torch.agg.rmq``,
``Taxonomy.euler_tour`` and ``agg.device_rmq``, plain K5 on the CPU) with
``umgap_tpu``'s, the Euler tables carried across by
``convert.euler_from_arrays``. All outputs are integer positions and
taxon ids: every comparison is exact."""

import numpy as np
import pytest
import torch

from umgap_tpu.agg import device as jagg
from umgap_tpu.agg import device_rmq as jrmq
from umgap_tpu.agg.rmq import RMQ as JRMQ
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa as jfixture
from umgap_tpu_torch import convert
from umgap_tpu_torch import taxonomy as ptaxonomy
from umgap_tpu_torch.agg import device_rmq as prmq
from umgap_tpu_torch.agg.rmq import RMQ

from test_torch_agg import _bench_taxonomies, _carried, _hit_lists


def _worlds(world):
    if world == "fixture":
        return (JTaxonomy(jfixture()),
                ptaxonomy.Taxonomy(ptaxonomy.fixture_taxa()))
    return _bench_taxonomies()


def _euler_carried(jtax):
    je = jrmq.DeviceEuler.from_host(jtax)
    pe = convert.euler_from_arrays(
        np.asarray(je.tour), np.asarray(je.depths), np.asarray(je.first),
        np.asarray(je.block_min), np.asarray(je.sparse), je.nlevels,
        je.tour_len, device="cpu")
    return je, pe


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200, 4099])
def test_rmq_host_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 9, size=n)
    mine, ref = RMQ(a), JRMQ(a)
    np.testing.assert_array_equal(mine.block_min, ref.block_min)
    assert len(mine.sparse) == len(ref.sparse)
    for x, y in zip(mine.sparse, ref.sparse):
        np.testing.assert_array_equal(x, y)
    for s, e in rng.integers(0, n, size=(300, 2)):
        assert mine.query(int(s), int(e)) == ref.query(int(s), int(e))


@pytest.mark.parametrize("world", ["fixture", "bench"])
def test_euler_tour_and_tables_match_jax(world):
    jtax, ptax = _worlds(world)
    for x, y in zip(ptax.euler_tour(), jtax.euler_tour()):
        np.testing.assert_array_equal(x, y)
    je, _ = _euler_carried(jtax)
    mine = prmq.DeviceEuler.from_host(ptax, device="cpu")
    for name in ("tour", "depths", "first", "block_min", "sparse"):
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(je, name)))
    assert (mine.nlevels, mine.tour_len) == (je.nlevels, je.tour_len)


@pytest.mark.parametrize("world", ["fixture", "bench"])
def test_rmq_query_batch_matches_jax(world):
    jtax, _ = _worlds(world)
    je, pe = _euler_carried(jtax)
    rng = np.random.default_rng(3)
    T = je.tour_len
    se = rng.integers(0, T, size=(2, 2000)).astype(np.int32)
    # near pairs too: same block, neighbouring blocks, equal ends
    se[1, :500] = np.clip(se[0, :500] + rng.integers(-70, 70, size=500),
                          0, T - 1)
    se[1, 500:600] = se[0, 500:600]
    want = np.asarray(jrmq.rmq_query_batch(je, se[0], se[1]))
    got = prmq.rmq_query_batch(pe, torch.from_numpy(se[0]),
                               torch.from_numpy(se[1]))
    np.testing.assert_array_equal(got.numpy(), want)
    host = JRMQ(np.asarray(je.depths))
    assert [host.query(int(s), int(e)) for s, e in se.T[:300]] == \
        got.numpy()[:300].tolist()


def _hits(jtax, world, K, seed):
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(jtax.present & (jtax.depth >= 0))
    if world == "bench":  # hits along a few lineages, so trees branch
        leaves = rng.choice(ids, size=max(12, K), replace=False)
        ids = np.unique(jtax.anc_table[leaves][jtax.anc_table[leaves] > 0])
    utaxa, ucounts, uvalid = _hit_lists(rng, ids, 24, K)
    uvalid[:, 0] &= rng.random(24) < 0.7  # filtered first slots
    return utaxa, ucounts, uvalid


@pytest.mark.parametrize("world,K", [("fixture", 4), ("bench", 12),
                                     ("bench", 64)])
def test_rmq_lca_batch_matches_jax(world, K):
    jtax, _ = _worlds(world)
    je, pe = _euler_carried(jtax)
    utaxa, _c, uvalid = _hits(jtax, world, K, K)
    want = np.asarray(jrmq.rmq_lca_batch(je, utaxa, uvalid))
    got = prmq.rmq_lca_batch(pe, torch.from_numpy(utaxa),
                             torch.from_numpy(uvalid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("world,K", [("fixture", 4), ("bench", 12),
                                     ("bench", 40)])
@pytest.mark.parametrize("factor", [0.0, 0.5, 1.0])
def test_rmq_mix_batch_matches_jax(world, K, factor):
    jtax, _ = _worlds(world)
    dx, px = _carried(jtax)
    utaxa, ucounts, uvalid = _hits(jtax, world, K, K + 1)
    want = np.asarray(jrmq.rmq_mix_batch(dx, utaxa, ucounts, uvalid, factor))
    got = prmq.rmq_mix_batch(px, torch.from_numpy(utaxa),
                             torch.from_numpy(ucounts),
                             torch.from_numpy(uvalid), factor)
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatch gives the same
    np.testing.assert_array_equal(
        np.asarray(jagg.aggregate_batch(dx, utaxa, ucounts, uvalid, "rmq",
                                        "hybrid", factor)), want)


# ---------------------------------------------------------------------- #
# K9 (csrc/rmq_aggregate.cu): its plain version, the CPU's path through
# rmq_aggregate, against umgap_tpu's aggregator -> snap_batch -> where
# ---------------------------------------------------------------------- #

def _k9_hits(jtax, world, K, seed, B=24):
    """K4's hit lists (ascending ids from a few lineages, filtered
    slots) with the edge rows: no valid hit, a valid taxon 0 (absent,
    its lineage row empty, off the Euler tour), ids absent from the
    taxonomy (negative, at and past its end, and for the fixture taxa
    that are not present), and a row of one valid hit."""
    utaxa, ucounts, uvalid = _hits(jtax, world, K, seed)
    utaxa, ucounts, uvalid = (np.resize(x, (B, K)).copy()
                              for x in (utaxa, ucounts, uvalid))
    rng = np.random.default_rng(seed)
    absent = np.flatnonzero(~jtax.present | (jtax.depth < 0))
    odd = [0, -1, jtax.size, jtax.size + 7, int(absent[-1])]
    uvalid[0] = False
    for b, t in zip(range(1, B, 4), odd):
        k = int(rng.integers(0, K))
        utaxa[b, k], ucounts[b, k], uvalid[b, k] = t, 2.0, True
    uvalid[2, :] = False
    uvalid[2, K - 1] = True
    return utaxa, ucounts, uvalid


def _jax_rmq_tail(jtax, je, dx, strategy, utaxa, ucounts, uvalid, factor,
                  snap):
    """umgap_tpu's Euler/RMQ aggregator, then (with ``snap``) its
    snap_batch and the where over uvalid.any (umgap_tpu/pipeline/
    fused.py:118-124)."""
    if strategy == "lca*":
        agg = np.asarray(jrmq.rmq_lca_batch(je, utaxa, uvalid))
    else:
        agg = np.asarray(jrmq.rmq_mix_batch(dx, utaxa, ucounts, uvalid,
                                            factor))
    if snap is None:
        return agg
    return np.where(uvalid.any(axis=-1), np.asarray(jagg.snap_batch(
        snap, agg, 0)), 1).astype(np.int32)


@pytest.mark.parametrize("world", ["fixture", "bench"])
@pytest.mark.parametrize("K", [1, 64, 408])
@pytest.mark.parametrize("strategy", ["lca*", "hybrid"])
def test_rmq_aggregate_plain_matches_jax(world, K, strategy):
    """K9's plain version (rmq_aggregate on CPU tensors) with and
    without the snap table against umgap_tpu's aggregator, snap_batch
    and the where: exactly equal, at the main width, the wide program's
    and one slot."""
    jtax, _ = _worlds(world)
    je, pe = _euler_carried(jtax)
    dx, px = _carried(jtax)
    utaxa, ucounts, uvalid = _k9_hits(jtax, world, K, 3 * K + len(world))
    snap = np.asarray(dx.snap_valid).copy()
    snap[int(np.flatnonzero(snap > 0)[0])] = -1  # an unsnappable taxon
    u, c, v = (torch.from_numpy(x) for x in (utaxa, ucounts, uvalid))
    for factor in ((0.25,) if strategy == "lca*" else (0.0, 0.25, 1.0)):
        for sn in (None, snap):
            want = _jax_rmq_tail(jtax, je, dx, strategy, utaxa, ucounts,
                                 uvalid, factor, sn)
            got = prmq.rmq_aggregate(strategy, px, pe, u, c, v, factor,
                                     None if sn is None
                                     else torch.from_numpy(sn))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    if snap is not None:
        assert got[0] == 1 and (got != 1).any()


@pytest.mark.parametrize("K", [12, 64, 200])
def test_rmq_aggregate_ordered_matches_host_rmqmix(K):
    """rmq/hybrid with ``ordered`` on counts that are not integers
    (taxa2agg -s, slots in first-seen order): each group's taxon equals
    umgap_tpu's host RmqMix over the group's valid slots in slot order,
    as taxa2agg -s runs it."""
    from umgap_tpu.agg.host import RmqMix

    jtax, _ = _worlds("bench")
    dx, px = _carried(jtax)
    rng = np.random.default_rng(K)
    ids = np.flatnonzero(jtax.present & (jtax.depth >= 1))
    leaves = rng.choice(ids, size=20, replace=False)
    pool = np.unique(jtax.anc_table[leaves][jtax.anc_table[leaves] > 0])
    B = 40
    u = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    c = np.zeros((B, K), np.float32)
    v = np.zeros((B, K), bool)
    for b in range(B):
        n = int(rng.integers(1, min(K, len(pool)) + 1))
        u[b, :n] = rng.choice(pool, size=n, replace=False)  # first-seen
        c[b, :n] = rng.choice(np.float32([0.1, 0.3, 0.7, 1.1, 0.2, 2.5]),
                              size=n)
        v[b, :n] = True
        v[b, 1:n] &= rng.random(n - 1) < 0.8
    ut, ct, vt = (torch.from_numpy(x) for x in (u, c, v))
    for factor in (0.25, 0.3, 0.7):
        host = RmqMix(jtax, factor)
        want = [host.aggregate({int(t): float(w) for t, w in
                                zip(u[b][v[b]], c[b][v[b]])})
                for b in range(B)]
        got = prmq.rmq_aggregate("hybrid", px, None, ut, ct, vt, factor,
                                 ordered=True)
        assert got.tolist() == want, factor


def test_rmq_aggregate_refuses_bad_inputs_on_cpu():
    """K9's wrapper checks its inputs on CPU tensors as on the card, before
    the plain version: an unknown strategy, empty hit lists, a mask or
    ids of the wrong type or shape, hybrid without counts, lca* without
    Euler tables, a snap table of the wrong type or empty."""
    jtax, _ = _worlds("fixture")
    _je, pe = _euler_carried(jtax)
    _dx, px = _carried(jtax)
    utaxa, ucounts, uvalid = _k9_hits(jtax, "fixture", 8, 1)
    u, c, v = (torch.from_numpy(x) for x in (utaxa, ucounts, uvalid))
    k9 = prmq.rmq_aggregate
    bad = [("mrtl", pe, u, c, v, None), ("lca*", None, u, c, v, None),
           ("hybrid", pe, u, None, v, None),
           ("hybrid", pe, u, c.double(), v, None),
           ("lca*", pe, u.long(), c, v, None),
           ("lca*", pe, u, c, v.to(torch.int32), None),
           ("hybrid", pe, u[:-1], c, v, None),
           ("lca*", pe, u[:, :0], c[:, :0], v[:, :0], None),
           ("lca*", pe, u, c, v, px.snap_valid.long()),
           ("hybrid", pe, u, c, v, px.snap_valid[:0])]
    for strategy, e, uu, cc, vv, snap in bad:
        with pytest.raises(ValueError):
            k9(strategy, px, e, uu, cc, vv, 0.25, snap)
    for strategy in ("lca*", "hybrid"):
        assert torch.equal(
            k9(strategy, px, pe, u, c, v, 0.25, px.snap_valid),
            prmq.rmq_aggregate_plain(strategy, px, pe, u, c, v, 0.25,
                                     px.snap_valid))
