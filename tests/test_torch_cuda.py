"""Each CUDA kernel against its plain PyTorch version on the card, at
small shapes. Needs an NVIDIA GPU and nvcc, so it skips here on the CPU.
On the GPU machine (which has no JAX, so without the conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.index.table import build_kmer_table
from umgap_tpu_torch.ops import encoding, lookup, seedextend, translate

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
