"""Each CUDA kernel against its plain PyTorch version on the card, at
small shapes. Needs an NVIDIA GPU and nvcc, so it skips here on the CPU.
On the GPU machine (which has no JAX, so without the conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from umgap_tpu_torch import kernels, ranks
from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.agg import device_rmq as prmq
from umgap_tpu_torch.index.table import build_kmer_table
from umgap_tpu_torch.ops import encoding, gather, lookup, seedextend, \
    translate
from umgap_tpu_torch.taxonomy import Taxon, Taxonomy

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _eq(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("L,packed", [(100, True), (61, True), (48, False)])
def test_reads_to_kmers_kernel(dev, L, packed):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 5, size=(300, L)).astype(np.uint8)
    lens = torch.from_numpy(rng.integers(0, L + 1, size=300).astype(
        np.int32)).to(dev)
    src = encoding.pack_dna4(codes) if packed else codes
    r = torch.from_numpy(src).to(dev)
    t = encoding.get_table(11)
    _eq(translate.reads_to_kmers(r, lens, L, t, 9, packed),
        translate.reads_to_kmers_plain(r, lens, L, t, 9, packed))


@pytest.mark.parametrize("layout", ["bucket8s", "bucket16", "bucket64s"])
def test_probe_kernel(dev, layout):
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 2 ** 45, size=5000, dtype=np.uint64))
    vals = rng.integers(1, 100, size=len(keys)).astype(np.int32)
    dt = lookup.DeviceTable.from_host(
        build_kmer_table(keys, vals, 9, layout=layout), dev)
    q = np.concatenate([keys[:2000], rng.integers(0, 2 ** 45, size=2000,
                                                  dtype=np.uint64)])
    hi = torch.from_numpy((q >> np.uint64(25)).astype(np.int32)).to(dev)
    lo = torch.from_numpy((q & np.uint64((1 << 25) - 1)).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(len(q)) < 0.9).to(dev)
    _eq(lookup.probe(dt, hi, lo, valid, 0),
        lookup.probe_plain(dt, hi, lo, valid, 0))


@pytest.mark.parametrize("s,g", [(2, 0), (3, 1), (4, 2)])
def test_seedextend_kernel(dev, s, g):
    rng = np.random.default_rng(s)
    taxa = torch.from_numpy(rng.choice(np.array([0, 0, 3, 4], np.int32),
                                       size=(500, 40))).to(dev)
    lens = torch.from_numpy(rng.integers(0, 41, size=500).astype(
        np.int32)).to(dev)
    _eq((seedextend.seedextend_mask_batch(taxa, lens, s, g),),
        (seedextend.seedextend_mask_plain(taxa, lens, s, g),))


@pytest.mark.parametrize("k_max", [8, 400])
def test_dedup_kernel(dev, k_max):
    rng = np.random.default_rng(k_max)
    taxa = torch.from_numpy(rng.integers(-1, 50, size=(64, 300)).astype(
        np.int32)).to(dev)
    _eq(pagg.dedup_counts(taxa, None, k_max, True),
        pagg.dedup_counts_plain(taxa, None, k_max, True))


@pytest.mark.parametrize("G,S,W,I", [(512, 26, 64, 64), (1, 8192, 128, 32),
                                     (64, 512, 128, 512), (3, 7, 5, 9)])
def test_lane_gather_kernel(dev, G, S, W, I):
    rng = np.random.default_rng(G + S)
    tab = torch.from_numpy(rng.integers(-5, 1 << 30, size=(G, S, W)).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, S, size=(G, I, W)).astype(
        np.int32)).to(dev)
    _eq((gather.lane_gather(tab, idx),), (gather.lane_gather_plain(tab, idx),))
    # a row index expanded over the lanes, a transposed table
    rows = idx[:, :, :1].expand(G, I, W)
    tt = tab.transpose(1, 2).contiguous().transpose(1, 2)
    _eq((gather.lane_gather(tt, rows),),
        (gather.lane_gather_plain(tt, rows),))
    lidx = torch.from_numpy(rng.integers(0, W, size=(G, S, 7)).astype(
        np.int32)).to(dev)
    _eq((gather.lane_gather(tab, lidx, axis=-1),),
        (gather.lane_gather_plain(tab, lidx, axis=-1),))
    flat = tab.reshape(-1)
    q = torch.from_numpy(rng.integers(0, flat.numel(), size=(33, 5)).astype(
        np.int32)).to(dev)
    _eq((gather.take(flat, q),), (gather.take_plain(flat, q),))


def _random_tree(n, seed):
    rng = np.random.default_rng(seed)
    parent = [1, 1] + [int(rng.integers(max(1, i // 3), i))
                       for i in range(2, n + 1)]
    return Taxonomy([Taxon(i, f"t{i}", ranks.NO_RANK, parent[i], True)
                     for i in range(1, n + 1)])


@pytest.mark.parametrize("K", [4, 64, 300])
def test_tree_aggregate_kernel(dev, K):
    tax = _random_tree(3000, K)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    rng = np.random.default_rng(K)
    B = 256
    leaves = rng.choice(np.arange(2, 3001), size=40, replace=False)
    ids = np.unique(tax.anc_table[leaves][tax.anc_table[leaves] > 0])
    utaxa = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    ucounts = np.zeros((B, K), np.float32)
    uvalid = np.zeros((B, K), bool)
    for b in range(B):
        sel = np.sort(rng.choice(ids, size=min(int(rng.integers(0, K + 1)),
                                                len(ids)), replace=False))
        utaxa[b, :len(sel)] = sel
        ucounts[b, :len(sel)] = rng.integers(1, 7, size=len(sel))
        uvalid[b, :len(sel)] = True
    u, c, v = (torch.from_numpy(x).to(dev) for x in (utaxa, ucounts, uvalid))
    geom = pagg.hit_geometry(dtax, u, v)
    with kernels.plain_versions():
        _eq(geom, pagg.hit_geometry(dtax, u, v))
    for strategy in ("hybrid", "lca*", "mrtl"):
        for factor in (0.0, 0.25, 0.9):
            _eq((pagg.tree_aggregate(strategy, dtax, geom, u, c, factor),),
                (pagg.tree_aggregate_plain(strategy, dtax, geom, u, c,
                                           factor),))
    euler = prmq.DeviceEuler.from_host(tax, dev)
    got = (prmq.rmq_lca_batch(euler, u[:, :16], v[:, :16]),
           prmq.rmq_mix_batch(dtax, u[:, :16], c[:, :16], v[:, :16], 0.5))
    with kernels.plain_versions():
        _eq(got, (prmq.rmq_lca_batch(euler, u[:, :16], v[:, :16]),
                  prmq.rmq_mix_batch(dtax, u[:, :16], c[:, :16], v[:, :16],
                                     0.5)))


def test_lane_gather_kernel_64bit_counters(dev):
    """Outputs of 2^30 elements or more take K5's 64-bit loop counters:
    the 1-D take (rows mode, direct), the lanes mode and the staged
    rows mode (several GB each; compared on a strided sample and on
    sums)."""
    n = (1 << 30) + 77
    tab = torch.arange(7, dtype=torch.int32, device=dev)
    idx = (torch.arange(n, device=dev) % 7).to(torch.int32)
    got = gather.take(tab, idx)
    assert torch.equal(got, idx)
    del got, idx
    G, I = 1, 1 << 15
    tab = torch.arange(I * 8, dtype=torch.int32, device=dev).view(1, I, 8)
    lidx = (torch.arange(I * (I + 1), device=dev) % 8).to(
        torch.int32).view(1, I, I + 1)
    got = gather.lane_gather(tab, lidx, axis=-1)
    want = lidx + (torch.arange(I, dtype=torch.int32, device=dev) * 8
                   )[None, :, None]
    assert torch.equal(got, want)
    del got, want, lidx
    G, S, W, I = 1 << 16, 8, 128, 128
    tab = torch.arange(G * S * W, dtype=torch.int32, device=dev).view(G, S, W)
    rows = (torch.arange(G * I, device=dev) % S).to(torch.int32).view(G, I, 1)
    got = gather.lane_gather(tab, rows.expand(G, I, W))
    want = (torch.arange(G, device=dev)[:, None, None] * (S * W)
            + rows.long() * W + torch.arange(W, device=dev)).to(torch.int32)
    assert torch.equal(got, want)
