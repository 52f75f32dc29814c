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
