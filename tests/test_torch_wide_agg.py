"""K6's block path (groups past K = 64, the wide program's widths) as
its plain PyTorch formulation, ``tree_aggregate_wide_plain`` (sorted
distinct ids, ``torch.searchsorted`` and the depth check; per-depth
branch sums over a subtree list), and the plain version the kernel is
held to on the card, ``tree_aggregate_hits_plain``, both against the JAX
package's ``tree_mix_batch`` / ``rtl_batch`` / ``tree_lca_batch`` over
its ``hit_geometry``, on the CPU. Outputs are taxon ids: exact
equality."""

import os

import jax
import numpy as np
import pytest
import torch

from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu_torch import convert
from umgap_tpu_torch.agg import device as pagg

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_data")
BIG = np.iinfo(np.int32).max


def _bench():
    """The tracked .bench_data taxonomy (20,000 taxa, depth 25)."""
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    return JTaxonomy([JTaxon(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                             int(parent[i]), bool(snap[i] == i))
                      for i in range(1, len(parent))])


def _chain(n=30):
    """Every taxon on one path: taxon i's parent is i - 1."""
    return JTaxonomy([JTaxon(i, f"t{i}", jranks.NO_RANK, max(1, i - 1), True)
                      for i in range(1, n + 1)])


_WORLDS = {"bench": _bench, "chain": _chain}


def _carried(jtax):
    dx = jagg.DeviceTaxonomy.from_host(jtax)
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    return dx, px


def _groups(jtax, K, seed):
    """One group of K slots for each case, (B, K) ids, counts, mask:
    no valid slot; 17 ascending distinct ids of a few lineages (as K4
    hands them over); every slot valid; a random count of them unsorted
    with repeats; ids below 0 and at or past the table's size among
    them; siblings of one depth with equal counts (ties); four branches
    of equal weight under one node (each share exactly 0.25); one long
    chain, and the chain with one slot off it; slots filtered out of a
    full group (invalid, ids kept)."""
    rng = np.random.default_rng(seed)
    size = len(jtax.depth)
    ids = np.flatnonzero(jtax.present & (jtax.depth >= 1))
    parent = np.asarray(jtax.anc_table)[np.arange(size),
                                         np.maximum(jtax.depth - 1, 0)]
    kids = {}
    for i in ids:
        kids.setdefault(int(parent[i]), []).append(int(i))
    deep = int(ids[np.argmax(jtax.depth[ids])])
    chain = jtax.anc_table[deep][jtax.anc_table[deep] > 0]
    leaves = rng.choice(ids, size=min(len(ids), 8), replace=False)
    lineage = np.unique(jtax.anc_table[leaves][jtax.anc_table[leaves] > 0])

    rows = []

    def add(sel, counts=None, keep=None):
        sel = np.asarray(sel, np.int64)[:K]
        u = np.full(K, BIG, np.int32)
        c = np.zeros(K, np.float32)
        v = np.zeros(K, bool)
        u[:len(sel)] = sel
        c[:len(sel)] = (rng.integers(1, 7, size=len(sel)) if counts is None
                        else np.asarray(counts)[:len(sel)])
        v[:len(sel)] = True if keep is None else keep[:len(sel)]
        rows.append((u, c, v))

    add([])
    add(np.sort(rng.choice(lineage, size=min(17, len(lineage)),
                           replace=False)))
    add(np.sort(rng.choice(ids, size=K, replace=K > len(ids))))
    n = int(rng.integers(17, K + 1))
    add(rng.choice(lineage, size=n))  # unsorted, repeats
    odd = rng.choice(lineage, size=n)
    odd[rng.choice(n, size=6, replace=False)] = [-1, -7, 0, size, size + 3,
                                                 size - 1]
    add(odd)
    fan = [v for v in kids.values() if len(v) >= 2] or [[deep, deep]]
    sib = max(fan, key=len)
    add(np.resize(sib, max(17, len(sib))), counts=np.full(K, 3.0))
    four = [v for v in kids.values() if len(v) >= 4]
    if four:
        add(np.repeat(four[0][:4], 5), counts=np.ones(K))
    add(chain)
    off = np.concatenate([np.repeat(chain, 2), [rng.choice(ids)]])
    rng.shuffle(off)
    add(off, counts=np.ones(K))
    add(rng.choice(ids, size=K), keep=rng.random(K) < 0.7)
    return (np.stack(r) for r in zip(*rows))


@pytest.mark.parametrize("strategy", ["hybrid", "lca*", "mrtl"])
@pytest.mark.parametrize("K", [65, 408, 1024, 2048])
@pytest.mark.parametrize("world", ["bench", "chain"])
def test_wide_formulations_match_jax(world, K, strategy):
    """Both PyTorch formulations equal the JAX aggregator on every case
    of ``_groups`` (hybrid at factors 0.25 and 0.5: the four equal
    branches descend at 0.25 and stop at 0.5)."""
    jtax = _WORLDS[world]()
    dx, px = _carried(jtax)
    utaxa, ucounts, uvalid = _groups(jtax, K, K + len(world))
    n = uvalid.sum(axis=1)
    assert n[0] == 0 and (n[1:] >= 17).all() and n.max() == K
    jg = jax.jit(jagg.hit_geometry)(dx, utaxa, uvalid)
    u, c, v = (torch.from_numpy(x) for x in (utaxa, ucounts, uvalid))
    for factor in ((0.25, 0.5) if strategy == "hybrid" else (0.25,)):
        if strategy == "hybrid":
            want = jax.jit(jagg.tree_mix_batch, static_argnums=4)(
                dx, jg, utaxa, ucounts, factor)
        elif strategy == "lca*":
            want = jax.jit(jagg.tree_lca_batch)(dx, jg, utaxa)
        else:
            want = jax.jit(jagg.rtl_batch)(dx, jg, utaxa, ucounts)
        want = np.asarray(want)
        wide = pagg.tree_aggregate_wide_plain(strategy, px, u, c, v, factor)
        assert wide.dtype == torch.int32
        np.testing.assert_array_equal(wide.numpy(), want)
        plain = pagg.tree_aggregate_hits_plain(strategy, px, u, c, v, factor)
        np.testing.assert_array_equal(plain.numpy(), want)
        # the plain dispatch on CPU tensors takes the same plain version
        assert torch.equal(pagg.tree_aggregate_hits(strategy, px, u, c, v,
                                                    factor), plain)
