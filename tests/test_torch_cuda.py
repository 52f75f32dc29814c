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
from umgap_tpu_torch.ops import encoding, gather, kmers, lookup, \
    seedextend, translate
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


def _k1_reads(rng, n, L, packed):
    """n random reads of width L (codes above 4 included), lengths 0,
    below 27, odd, equal to L, above L and negative (both clamped)."""
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.05] = 4
    codes[rng.random((n, L)) < 0.01] = 9  # reads as N
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    special = np.array([0, 5, 26, L, L + 7, -3, L | 1, 27], np.int32)
    m = min(n, len(special))
    lens[:m] = special[:m]
    lens[len(special):len(special) + n // 4] |= 1  # odd
    src = encoding.pack_dna4(codes) if packed else codes
    return src, lens


def _k1_check(dev, src, lens, L, table, packed, methionine=False):
    r = torch.from_numpy(src).to(dev) if isinstance(src, np.ndarray) \
        else src
    ln = torch.from_numpy(lens).to(dev)
    t = encoding.get_table(table)
    before = kernels.K1.launches
    _eq(translate.reads_to_kmers(r, ln, L, t, 9, packed, methionine),
        translate.reads_to_kmers_plain(r, ln, L, t, 9, packed, methionine))
    assert kernels.K1.launches == before + 1


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("L", [17, 20, 48, 61, 100, 160, 161, 300, 1001])
def test_reads_to_kmers_kernel(dev, L, packed):
    """K1 at the main widths (100, 160: the template instances), odd and
    short ones, a long one (1001: fewer reads a block), on both wires,
    with read counts that are no multiple of the block's reads."""
    rng = np.random.default_rng(L + packed)
    for n in (1, 7, 300):
        src, lens = _k1_reads(rng, n, L, packed)
        _k1_check(dev, src, lens, L, 11, packed)


@pytest.mark.parametrize("table,methionine", [(1, False), (1, True),
                                              (4, True), (11, True)])
def test_reads_to_kmers_kernel_tables(dev, table, methionine):
    """Tables 1, 4 and 11, the methionine start flag, 16,385 reads."""
    rng = np.random.default_rng(table)
    for L in (100, 160):
        src, lens = _k1_reads(rng, 16385, L, True)
        _k1_check(dev, src, lens, L, table, True, methionine)


@pytest.mark.parametrize("L,packed", [(100, True), (161, True),
                                      (161, False)])
@pytest.mark.parametrize("offset", [1, 3, 7])
def test_reads_to_kmers_kernel_unaligned(dev, L, packed, offset):
    """A reads tensor whose span starts off a 16-byte boundary (a row
    slice of a larger tensor): the ragged head and tail take byte
    loads."""
    rng = np.random.default_rng(offset)
    src, lens = _k1_reads(rng, 300 + offset, L, packed)
    big = torch.from_numpy(src).to(dev)
    part = big[offset:]
    assert part.is_contiguous() and part.data_ptr() % 16
    _k1_check(dev, part, lens[offset:], L, 1, packed)


def _k1p_check(dev, aa, lens):
    a = aa if isinstance(aa, torch.Tensor) else torch.from_numpy(aa).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    before = kernels.K1P.launches
    _eq(kmers.proteins_to_kmers(a, ln, 9), kmers.pack_windows_batch(a, ln, 9))
    assert kernels.K1P.launches == before + 1


def _k1p_lanes(rng, n, P):
    """n random lanes of P residues (codes above 31 too), lengths 0, 9, P
    and beyond P among them."""
    aa = rng.integers(0, 32, size=(n, P)).astype(np.uint8)
    aa[rng.random(aa.shape) < 0.02] = 200
    lens = rng.integers(0, P + 1, size=n).astype(np.int32)
    special = np.array([0, 9, P, P + 5, 8], np.int32)
    m = min(n, len(special))
    lens[:m] = special[:m]
    return aa, lens


@pytest.mark.parametrize("P", [1, 5, 8, 9, 15, 16, 17, 33, 64, 1000, 1999,
                               8000, 30000, 40000])
def test_proteins_to_kmers_kernel(dev, P):
    """K1P against its plain version: P < 9 (one zero-padded, invalid
    window a lane), exactly 9, 15 and 16 (7 and 8 windows a lane: the
    byte fold and the register fold), the gene widths 16-64 (64 at the
    CLI's gene batch of 1,024 groups x 4 lanes), the split's length
    classes (1,999; 30,000 and 40,000 past the first design's tile),
    lane counts that fill no whole tile."""
    rng = np.random.default_rng(P)
    for n in (1, 7, 4096 if P <= 64 else 20):
        _k1p_check(dev, *_k1p_lanes(rng, n, P))


@pytest.mark.parametrize("tile_max", [256, 1024, 2048])
@pytest.mark.parametrize("n,P", [(37, 64), (293, 64), (4096, 64),
                                 (1, 2056), (3, 2057), (8392, 1999),
                                 (5, 32767), (50, 12), (50, 13)])
def test_proteins_to_kmers_kernel_tiles(dev, monkeypatch, n, P, tile_max):
    """K1P's tiles at their edges: windows a call that fill a tile
    exactly (1 x 2,048) or one past it (3 x 2,049), tiles that end inside
    a lane and lanes that end inside a tile, tiles of 256 to 2,048
    windows (a warp's 256 whole or cut), the split's largest batch, and 4
    and 5 windows a lane (a lane edge in most runs of 4)."""
    monkeypatch.setattr(kmers, "K1P_TILE_MAX", tile_max)
    monkeypatch.setattr(kmers, "K1P_TILE_MIN", min(256, tile_max))
    rng = np.random.default_rng(n + P)
    _k1p_check(dev, *_k1p_lanes(rng, n, P))


@pytest.mark.parametrize("P", [33, 64, 1999])
@pytest.mark.parametrize("offset", [1, 3, 4, 7, 8])
def test_proteins_to_kmers_kernel_unaligned(dev, P, offset):
    """Lanes whose span starts off a 16-byte boundary (a row slice of a
    larger tensor): the ragged head and tail take byte loads, an 8-byte
    aligned batch the register fold, any other the byte fold."""
    rng = np.random.default_rng(offset)
    aa, lens = _k1p_lanes(rng, 300, P)
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.uint8), aa.reshape(-1)])).to(dev)
    part = flat[offset:].view(300, P)
    assert part.is_contiguous() and part.data_ptr() % 16
    _k1p_check(dev, part, lens)


@pytest.mark.parametrize("preset", ["high-precision", "max-precision",
                                    "high-sensitivity", "max-sensitivity"])
def test_protein_stages_launch_each_kernel_once(dev, preset):
    """The protein step on the card: one K1P, K2, K3, K4 and K6 launch a
    batch, no K1; taxa equal to the plain path's."""
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.proteins import run_protein_stages

    tax = _random_tree(3000, 4)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    rng = np.random.default_rng(9)
    B, E, P = 256, 4, 64
    aa = rng.integers(0, 20, size=(B, E, P)).astype(np.uint8)
    lens = rng.integers(0, P + 1, size=(B, E)).astype(np.int32)
    hi, lo, wv = kmers.pack_windows_batch(torch.from_numpy(aa),
                                          torch.from_numpy(lens), 9)
    keys = ((hi.numpy().astype(np.uint64) << np.uint64(25))
            | lo.numpy().astype(np.uint64))
    per_lane = rng.integers(2, 3001, size=(B, E, 1)).astype(np.int32)
    hit = wv.numpy() & (rng.random((B, E, 1)) < 0.7)
    keys, first = np.unique(keys[hit], return_index=True)
    vals = np.broadcast_to(per_lane, hi.shape)[hit][first]
    dtable = lookup.DeviceTable.from_host(build_kmer_table(keys, vals, 9),
                                          dev)
    cfg = PRESETS[preset]
    a, lt = torch.from_numpy(aa).to(dev), torch.from_numpy(lens).to(dev)
    before = kernels.launch_counts()
    got = run_protein_stages(a, lt, dtax, dtable, cfg)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    for k in ("proteins_to_kmers", "probe_kmer", "seedextend_mask",
              "dedup_counts", "tree_aggregate"):
        assert after[k] - before[k] == 1, k
    assert after["reads_to_kmers"] == before["reads_to_kmers"]
    want = run_protein_stages(a, lt, dtax, dtable, cfg, plain=True)
    assert torch.equal(got, want)
    assert (got != 1).any()


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


def _unmix_key(mhi, mlo):
    """The inverse of ``index.table.mix_key``: keys with chosen home
    buckets."""
    from umgap_tpu_torch.index import table as T

    h = np.asarray(mhi).astype(np.uint32)
    l = np.asarray(mlo).astype(np.uint32)
    l = l ^ (T._mx(h + T._C3) & T.MASK25)
    h = h ^ (T._mx(l + T._C2) & T.MASK20)
    l = l ^ (T._mx(h + T._C1) & T.MASK25)
    return h, l


def _grouped_table(rng, group, bucket, probes, spread=300, first=0,
                   n_total=None):
    """Rows of ``group`` sub-tables (shards ``first`` .. ``first + group -
    1`` of ``n_total``, default all of one artifact, 2^15 buckets each)
    placed in ``probes + 1`` rounds, each holding its owner's share of
    keys crowded into 8 home buckets (so rounds overflow and keys are
    left out) and of keys spread over it; keys of other shards are left
    out. Returns (rows, keys, values, placed)."""
    from umgap_tpu_torch.index import table as T
    from umgap_tpu_torch.parallel.sharded import owner_of

    n_total = group if n_total is None else n_total
    nb_bits = T.MIN_NB_BITS
    nb = 1 << nb_bits
    cap = bucket * nb
    n_crowd = n_total * 8 * bucket * 3 // 2
    mlo = ((rng.integers(0, 1 << (25 - nb_bits), size=n_crowd,
                         dtype=np.uint32) << np.uint32(nb_bits))
           | rng.integers(0, 8, size=n_crowd, dtype=np.uint32))
    mhi = rng.integers(0, 1 << 20, size=n_crowd, dtype=np.uint32)
    chi, clo = _unmix_key(mhi, mlo)
    keys = np.unique(np.concatenate([
        kmers.join_packed(chi.astype(np.int32), clo.astype(np.int32)),
        rng.integers(0, 2 ** 45, size=n_total * spread, dtype=np.uint64)]))
    hi, lo = kmers.split_packed(keys)
    vals = rng.integers(1, 10 ** 6, size=len(keys)).astype(np.int32)
    own = owner_of(hi, lo, n_total) - first
    rows = []
    placed = np.zeros(len(keys), bool)
    for sh in range(group):
        sel = np.flatnonzero(own == sh)
        mh, ml = T.mix_key(hi[sel], lo[sel])
        b0 = (ml & np.uint32(nb - 1)).astype(np.int64)
        rem = ((ml >> np.uint32(nb_bits))
               | (mh << np.uint32(25 - nb_bits))).astype(np.int32)
        (ra, va), _mp, left = T._insert_bucketized(
            b0, [rem, vals[sel]], cap, tag_distance=True, bucket=bucket,
            max_round=probes)
        ok = np.ones(len(sel), bool)
        ok[left] = False
        placed[sel[ok]] = True
        rows.append(np.concatenate([ra.reshape(nb, bucket),
                                    va.reshape(nb, bucket)], axis=1))
    return np.concatenate(rows), keys, vals, placed


def _grouped_cases(dev, rng, group, bucket, probes, first=0, n_total=None,
                   stashes=(0, 256, 257, 4096, 4097, 20000)):
    """(DeviceTable, hi, lo, valid) with stashes of 0, 256 (the most the
    kernel copies to shared memory), 257 (searched in global memory),
    4,096 (48 KB, the most the parent's kernel held), 4,097 and 20,000
    rows (240 KB, past the shared memory a block may opt in to) of keys
    the rows do not hold; queries: placed keys, keys left out (other
    shards' among them), stash keys and misses."""
    rows, keys, vals, placed = _grouped_table(rng, group, bucket, probes,
                                              first=first, n_total=n_total)
    rows_t = torch.from_numpy(rows).to(dev)
    extra = np.setdiff1d(np.unique(rng.integers(
        0, 2 ** 45, size=20500, dtype=np.uint64)), keys)[:20000]
    for n_stash in stashes:
        sk = extra[:n_stash]
        shi, slo = kmers.split_packed(sk)
        stash = np.stack([shi, slo, rng.integers(1, 99, size=len(sk)).astype(
            np.int32)], axis=1).astype(np.int32).reshape(-1, 3)
        dt = lookup.DeviceTable(rows_t, probes, "kmer", 15, bucket,
                                torch.from_numpy(stash).to(dev),
                                group=group, first=first, n_total=n_total)
        q = np.concatenate([keys[placed][:4000], keys[~placed][:300],
                            sk[:3000], rng.integers(0, 2 ** 45, size=700,
                                                    dtype=np.uint64)])
        rng.shuffle(q)
        qh, ql = kmers.split_packed(q)
        yield (dt, torch.from_numpy(qh).to(dev), torch.from_numpy(ql).to(dev),
               torch.from_numpy(rng.random(len(q)) < 0.9).to(dev))


@pytest.mark.parametrize("probes", [0, 1])
@pytest.mark.parametrize("bucket", [8, 16, 64])
@pytest.mark.parametrize("group", [1, 2, 16, 64])
def test_probe_kernel_grouped(dev, group, bucket, probes):
    """K2's grouped entry (its ungrouped one at group 1) against the
    plain version, each query's sub-table from its key, at every stash
    size; each probe is one K2 launch."""
    rng = np.random.default_rng(group * 100 + bucket + probes)
    for dt, hi, lo, valid in _grouped_cases(dev, rng, group, bucket,
                                            probes):
        before = kernels.K2.launches
        got = lookup.probe(dt, hi, lo, valid, 7)
        torch.cuda.synchronize()
        assert kernels.K2.launches == before + 1
        want = lookup.probe_plain(dt, hi, lo, valid, 7)
        _eq(got, want)
        assert int(want[1].sum()) > 100


@pytest.mark.parametrize("bucket", [8, 64])
@pytest.mark.parametrize("n_dev,group", [(2, 1), (4, 4), (8, 2), (2, 32)])
def test_probe_kernel_slice(dev, n_dev, group, bucket):
    """K2's slice entry: each device d's table of a mesh (shards d *
    group .. of n_dev * group) against the plain version, every query
    probed there (the others' keys clipped into a sub-table and missed);
    at group 1 the one-table entry serves the slice."""
    n_total = n_dev * group
    for d in range(n_dev):
        rng = np.random.default_rng(d * 100 + n_total + bucket)
        for dt, hi, lo, valid in _grouped_cases(
                dev, rng, group, bucket, 1, first=d * group,
                n_total=n_total, stashes=(0, 300)):
            before = kernels.K2.launches
            got = lookup.probe(dt, hi, lo, valid, 7)
            torch.cuda.synchronize()
            assert kernels.K2.launches == before + 1
            want = lookup.probe_plain(dt, hi, lo, valid, 7)
            _eq(got, want)
            assert int(want[1].sum()) > 50


def _peptide_slice(dev, rng, group, first, n_total, capacity=1 << 12):
    """(DeviceTable, hi, lo): the sub-tables of shards first .. first +
    group - 1 of n_total of random fingerprints, full enough that keys
    chain (max_probes >= 1), and queries of every shard's keys and
    absent ones."""
    from umgap_tpu_torch.index import table as T
    from umgap_tpu_torch.parallel.sharded import owner_of

    n = int(capacity * 0.85) * n_total
    key = np.unique(rng.integers(0, 2 ** 64 - 1, size=2 * n, dtype=np.uint64))
    key = key[(key >> np.uint64(32)) != np.uint64(0xFFFFFFFF)]
    rng.shuffle(key)
    hi = (key >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = key.astype(np.uint32).view(np.int32)
    own = owner_of(hi[:n], lo[:n], n_total, kind="peptide") - first
    tabs = [T.PeptideTable._from_fingerprints(
        hi[:n][own == g], lo[:n][own == g],
        rng.integers(1, 1000, int((own == g).sum())).astype(np.int32),
        capacity=capacity) for g in range(group)]
    depth = max(t.max_probes for t in tabs)
    rows = np.concatenate([t.packed_rows() for t in tabs])
    dt = lookup.DeviceTable(torch.from_numpy(rows).to(dev), depth, "peptide",
                            0, 8, group=group, first=first, n_total=n_total)
    q = np.concatenate([np.arange(n), n + np.arange(n // 4)])
    return (dt, torch.from_numpy(hi[q].copy()).to(dev),
            torch.from_numpy(lo[q].copy()).to(dev), depth)


@pytest.mark.parametrize("Q", [1, 2, 4])
@pytest.mark.parametrize("group,n_total", [(2, 2), (4, 16), (16, 16),
                                           (64, 64), (2, 8)])
def test_probe_peptide_kernel_grouped(dev, group, n_total, Q, monkeypatch):
    """K8's grouped entry (every slice of n_total shards) against its
    plain version, each query's sub-table the owner of its swapped
    lanes, at every queries-per-lane setting; one K8 launch a probe."""
    monkeypatch.setattr(lookup, "QUERIES_PER_LANE", Q)
    for first in range(0, n_total, group):
        rng = np.random.default_rng(group * 1000 + n_total + first + Q)
        dt, hi, lo, depth = _peptide_slice(dev, rng, group, first, n_total,
                                           capacity=1 << 11)
        assert depth >= 1
        valid = torch.from_numpy(rng.random(hi.shape[0]) < 0.9).to(dev)
        before = kernels.K8.launches
        got = lookup.probe(dt, hi, lo, valid, -2)
        torch.cuda.synchronize()
        assert kernels.K8.launches == before + 1
        want = lookup.probe_plain(dt, hi, lo, valid, -2)
        _eq(got, want)
        assert int(want[1].sum()) > 500


def test_mesh_of_repeated_card_matches_one_device(dev):
    """A four-device mesh that repeats the card: the 16 shards of an
    index, 4 a device, through the stream analyser (routing, K2's slice
    entry, the exchange as same-card copies) give the one-device
    Analyser's taxa over the whole index; each batch launches K1, K2
    (once a device) and the tail."""
    from umgap_tpu_torch.agg.device import DeviceTaxonomy
    from umgap_tpu_torch.parallel import ShardedTable, build_sharded_tables
    from umgap_tpu_torch.parallel import make_mesh
    from umgap_tpu_torch.parallel import make_sharded_stream_analyser
    from umgap_tpu_torch.pipeline.fused import PRESETS
    from umgap_tpu_torch.pipeline.runner import Analyser

    rng = np.random.default_rng(12)
    tax = _random_tree(3000, 9)
    B, L = 256, 100
    codes = rng.integers(0, 4, size=(B, 2, L)).astype(np.uint8)
    lens = rng.integers(40, L + 1, size=(B, 2)).astype(np.int32)
    hi, lo, v, _ = translate.reads_to_kmers_plain(
        torch.from_numpy(codes.reshape(B * 2, L)), torch.from_numpy(
            lens.reshape(-1)), L, encoding.get_table(1), 9, packed=False)
    # one taxon a (read, frame): runs of equal hits that seed-extend
    # keeps, a dozen taxa a group (so k_max 8 overflows)
    ids = np.flatnonzero(tax.depth >= 1)
    lane = rng.choice(ids, size=(B * 2, 6))[:, :, None] + 0 * v.numpy()
    packed = kmers.join_packed(hi[v].numpy(), lo[v].numpy())
    planted, first = np.unique(packed, return_index=True)
    extra = np.setdiff1d(rng.integers(0, 2 ** 45, size=20000,
                                      dtype=np.uint64), planted)
    keys = np.concatenate([planted, extra])
    vals = np.concatenate([lane[v.numpy()][first], rng.choice(
        ids, size=len(extra))]).astype(np.int32)
    order = np.argsort(keys)
    keys, vals = keys[order], vals[order]
    mesh = make_mesh(devices=(dev,) * 4)
    stable = ShardedTable.from_shards(build_sharded_tables(keys, vals, 9, 16),
                                      mesh)
    assert stable.n_devices == 4 and stable.group == 4
    dtax = DeviceTaxonomy.from_host(tax, dev)
    headers = [str(i) for i in range(B)]
    for preset in ("high-sensitivity", "max-sensitivity"):
        cfg = PRESETS[preset]._replace(k_max=8)
        an = make_sharded_stream_analyser(tax, stable, cfg, batch_size=64,
                                          read_length=L, dtax=dtax)
        kernels.reset_launches()
        got = [t for _h, t in an.analyse_arrays(headers, codes, lens)]
        n = kernels.launch_counts()
        assert an.overflow_reads > 0 and n["probe_kmer"] >= 4 * 4
        assert n["reads_to_kmers"] >= 4 and n["dedup_counts"] >= 4
        want = [t for _h, t in Analyser(
            tax, build_kmer_table(keys, vals, 9), cfg, batch_size=64,
            read_length=L, dtax=dtax, device=dev).analyse_arrays(
                headers, codes, lens)]
        assert got == want and sum(t != 1 for t in got) > 20


def test_mesh_past_the_cards_refused(dev, tmp_path):
    """``--mesh`` past the visible cards exits 1 with umgap_tpu's
    message; nothing is emulated on a card."""
    import subprocess
    import sys

    n = torch.cuda.device_count() + 1
    (tmp_path / "r.fa").write_text(">a\nACGT\n")
    proc = subprocess.run(
        [sys.executable, "-m", "umgap_tpu_torch", "analyse", "-t",
         "max-sensitivity", "-1", str(tmp_path / "r.fa"), "--taxons",
         str(tmp_path / "none.tsv"), "--index", str(tmp_path / "none.npz"),
         "--mesh", str(n)], capture_output=True, text=True)
    assert proc.returncode == 1
    assert proc.stderr == f"Error: need {n} devices, have {n - 1}\n"


def _k2_entries():
    """The library's two C entries, unpacked: probe_kmer (the one-table
    entry, as before the grouped entry existed) and probe_kmer_grouped."""
    import ctypes

    kernels.build_all()
    lib = ctypes.CDLL(str(kernels.K2.lib_path(kernels.find_nvcc())))
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    head = [P, P, P, LL, P, LL, I, I, I, P, I, I, P, P]
    lib.probe_kmer.argtypes = head + [P]
    lib.probe_kmer_grouped.argtypes = head + [I, I, I, P]
    lib.probe_kmer.restype = lib.probe_kmer_grouped.restype = I
    return lib


@pytest.mark.parametrize("probes", [0, 1])
@pytest.mark.parametrize("bucket", [8, 16, 64])
def test_probe_kernel_group1_entries_agree(dev, bucket, probes):
    """At group 1 the wrapper's launch (the ungrouped entry), the
    ungrouped C entry called directly and the grouped instantiation
    forced at group 1 give bit-identical outputs."""
    lib = _k2_entries()
    rng = np.random.default_rng(bucket + probes)
    for dt, hi, lo, valid in _grouped_cases(dev, rng, 1, bucket, probes):
        want = lookup.probe(dt, hi, lo, valid, 5)
        args = (hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), hi.numel(),
                dt.rows.data_ptr(), dt.n_buckets, dt.nb_bits, dt.bucket,
                dt.max_probes, dt.stash.data_ptr(), dt.stash.shape[0], 5)
        for entry, extra in ((lib.probe_kmer, ()),
                             (lib.probe_kmer_grouped, (1, 0, 1))):
            out = torch.full_like(want[0], -9)
            found = torch.ones_like(want[1])
            rc = entry(*args, out.data_ptr(), found.data_ptr(), *extra,
                       kernels.stream_of(hi))
            torch.cuda.synchronize()
            assert rc == 0
            _eq((out, found), want)


def _seed_lanes(rng, lanes, N):
    """Runs of equal taxa with gaps, all-zero lanes, lengths 0, N and
    above N."""
    t = rng.choice(np.array([0, 0, 0, 5, 6, 7], np.int32), size=(lanes, N))
    rep = rng.random((lanes, N)) < 0.6
    for j in range(1, N):
        t[:, j] = np.where(rep[:, j], t[:, j - 1], t[:, j])
    t[: lanes // 10] = 0
    lens = rng.integers(0, N + 1, size=lanes).astype(np.int32)
    lens[lanes // 2::7] = 0
    lens[lanes // 2 + 1::7] = N
    lens[lanes // 2 + 2::7] = N + 3
    return t, lens


def _k3_check(dev, taxa, lens, s, g):
    tx = taxa if isinstance(taxa, torch.Tensor) else \
        torch.from_numpy(taxa).to(dev)
    ln = lens if isinstance(lens, torch.Tensor) else \
        torch.from_numpy(lens).to(dev)
    _eq((seedextend.seedextend_hits(tx, ln, s, g),
         seedextend.seedextend_mask_batch(tx, ln, s, g)),
        (seedextend.seedextend_hits_plain(tx, ln, s, g),
         seedextend.seedextend_mask_plain(tx, ln, s, g)))


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [0, 1, 2])
def test_seedextend_kernel(dev, s, g):
    """K3's hits and mask entries at the main widths (25, 45: template
    instances), even widths (40, 52: the padded tile stride) and one past
    the staged tile (120: the row kernel), with lane counts that are
    no multiple of the block's lanes."""
    rng = np.random.default_rng(10 * s + g)
    for N in (25, 40, 45, 52, 120):
        for lanes in (1, 63, 1001):
            _k3_check(dev, *_seed_lanes(rng, lanes, N), s, g)
    assert seedextend.seedextend_path(120) == "rows"


def test_seedextend_kernel_shapes_and_alignment(dev):
    """(B, 6, W) lanes as the pipeline passes them, and taxa starting off
    a 16-byte boundary (the tile's scalar loads)."""
    rng = np.random.default_rng(5)
    taxa, lens = _seed_lanes(rng, 6 * 700, 45)
    _k3_check(dev, torch.from_numpy(taxa.reshape(700, 6, 45)).to(dev),
              torch.from_numpy(lens.reshape(700, 6)).to(dev), 3, 1)
    for N in (25, 42):
        taxa, lens = _seed_lanes(rng, 501, N)
        big = torch.from_numpy(taxa).to(dev)
        part = big[1:]
        assert part.data_ptr() % 16
        _k3_check(dev, part, torch.from_numpy(lens[1:]).to(dev), 2, 1)


@pytest.mark.parametrize("k_max", [8, 400])
def test_dedup_kernel(dev, k_max):
    rng = np.random.default_rng(k_max)
    taxa = torch.from_numpy(rng.integers(-1, 50, size=(64, 300)).astype(
        np.int32)).to(dev)
    _eq(pagg.dedup_counts(taxa, None, k_max, True),
        pagg.dedup_counts_plain(taxa, None, k_max, True))


def _dedup_rows(N, seed):
    """Rows of N hits with 0, 1, 31, 32, 33, 64, 65 and N valid (> 0)
    entries at random positions, ids from small and large pools, rows
    where every valid id is equal, and rows with more distinct ids than
    any k_max tried."""
    rng = np.random.default_rng(seed)
    rows = []
    for n_valid in (0, 1, 31, 32, 33, 64, 65, N):
        for pool in (3, 40, 1 << 30):
            for equal in (False, True):
                r = rng.integers(-3, 1, size=N).astype(np.int32)  # <= 0
                pos = rng.choice(N, size=n_valid, replace=False)
                ids = rng.integers(1, pool + 1, size=n_valid)
                r[pos] = ids[0] if equal and n_valid else ids
                rows.append(r)
    return np.stack(rows)


@pytest.mark.parametrize("N", [300, 540, 2048])
@pytest.mark.parametrize("k_max", [4, 64, 700])
def test_dedup_kernel_valid_hit_counts(dev, N, k_max):
    """Both K4 paths (warp for N = 300 and 540, the row kernel for 2,048)
    against the plain version, with and without weights."""
    assert pagg.dedup_path(N) == ("warp" if N <= 1024 else "rows")
    taxa = torch.from_numpy(_dedup_rows(N, N + k_max)).to(dev)
    _eq(pagg.dedup_counts(taxa, None, k_max, True),
        pagg.dedup_counts_plain(taxa, None, k_max, True))
    rng = np.random.default_rng(k_max)
    w = torch.from_numpy(rng.integers(0, 5, size=tuple(taxa.shape)).astype(
        np.float32)).to(dev)
    _eq(pagg.dedup_counts(taxa, w, k_max, True),
        pagg.dedup_counts_plain(taxa, w, k_max, True))
    # a row width that is no multiple of 4 takes the scalar loads
    odd = taxa[:, : N - 3].contiguous()
    _eq(pagg.dedup_counts(odd, None, k_max, True),
        pagg.dedup_counts_plain(odd, None, k_max, True))


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


@pytest.mark.parametrize("B,K,D", [(512, 64, 26), (200, 408, 26),
                                   (200, 648, 26), (300, 40, 7)])
def test_ancestry_kernel(dev, B, K, D):
    """K5's ancestry epilogue against the plain gather, compare and masks
    (its 16-byte-load path where K % 16 == 0, its row-walking path
    elsewhere); lin as hit_geometry passes it (a view of the [depth | lin]
    rows) and transposed in memory, dep/utaxa/valid as strided views."""
    rng = np.random.default_rng(B + K)
    rows = rng.integers(-1, 60, size=(B, K, 1 + D)).astype(np.int32)
    rows_t = torch.from_numpy(rows).to(dev)
    dep = torch.from_numpy(rng.integers(0, D, size=(B, K)).astype(
        np.int32)).to(dev)
    valid = torch.from_numpy(rng.random((B, K)) < 0.6).to(dev)
    valid[: B // 4, K // 2:] = False
    # utaxa that often equal a lineage entry at their own depth
    pick = torch.from_numpy(rng.integers(0, K, size=(B, K))).to(dev)
    lin = rows_t[..., 1:]
    utaxa = torch.gather(lin, 1, pick[:, :, None].expand(B, K, D)).gather(
        2, dep.long()[:, :, None])[..., 0].contiguous()
    want = gather.ancestry_plain(lin, dep, utaxa, valid)
    assert want.any()
    for tab in (lin, lin.transpose(1, 2).contiguous().transpose(1, 2)):
        got = gather.ancestry(tab, dep, utaxa, valid)
        assert got.dtype == torch.bool and torch.equal(got, want)
    wide = torch.cat([dep, utaxa], 1)
    got = gather.ancestry(lin, wide[:, :K], wide[:, K:], valid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [16, 32, 64, 96, 128, 192])
def test_lane_gather_staged_and_direct(dev, S):
    """The rows mode on whole (S, 128) tiles of 8-96 KB, staged (limit
    above the tile) and direct (limit 0), with stored and expanded
    indices, lanes and rows minor in memory."""
    G, W = 256, 128
    rng = np.random.default_rng(S)
    tab = torch.from_numpy(rng.integers(0, 1 << 30, size=(G, S, W)).astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, S, size=(G, S, W)).astype(
        np.int32)).to(dev)
    for t in (tab, tab.transpose(1, 2).contiguous().transpose(1, 2)):
        for ix in (idx, idx[:, :, :1].expand(G, S, W)):
            want = gather.lane_gather_plain(t, ix)
            for limit in (0, 1 << 20):
                got = gather.lane_gather_staging(t, ix, -2, limit)
                assert torch.equal(got, want)


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


def _bench_tree():
    """The tracked .bench_data taxonomy (20,000 taxa, depth 25)."""
    import os

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_data")
    parent = np.fromfile(os.path.join(data, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(data, "snap.bin"), np.int32)
    return Taxonomy([Taxon(i, f"t{i}", ranks.NO_RANK if i % 3 else 14,
                           int(parent[i]), bool(snap[i] == i))
                     for i in range(1, len(parent))])


def _chain_tree(n=40):
    """Every taxon on one path (taxon i's parent is i - 1)."""
    return Taxonomy([Taxon(i, f"t{i}", ranks.NO_RANK, max(1, i - 1), True)
                     for i in range(1, n + 1)])


_K6_TREES = {"random": lambda: _random_tree(3000, 9), "bench": _bench_tree,
             "chain": _chain_tree}


def _k6_hits(tax, B, K, seed):
    """Filtered hit lists: groups of 0, 1, 2, 3, 16 and 17 (the thread
    path's limit and one past it), all K and a random count of valid
    slots, ids ascending from a few lineages (so trees branch) with
    I32_MAX in the unused slots; every third group has slots filtered out
    (invalid, id kept), every fifth a repeated id."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(tax.depth >= 1)
    leaves = rng.choice(ids, size=min(len(ids), 12), replace=False)
    lineage = np.unique(tax.anc_table[leaves][tax.anc_table[leaves] > 0])
    utaxa = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    ucounts = np.zeros((B, K), np.float32)
    uvalid = np.zeros((B, K), bool)
    for b in range(B):
        m = min(K, (0, 1, 2, 3, 16, 17, K, int(rng.integers(0, K + 1)))[b % 8])
        pool = lineage if m <= len(lineage) else ids
        sel = np.sort(rng.choice(pool, size=min(m, len(pool)),
                                 replace=False))
        utaxa[b, :len(sel)] = sel
        ucounts[b, :len(sel)] = rng.integers(1, 7, size=len(sel))
        uvalid[b, :len(sel)] = True
        if b % 3 == 2:
            uvalid[b] &= rng.random(K) < 0.7
        if b % 5 == 4 and len(sel) > 2:
            utaxa[b, 1] = utaxa[b, 2]
    return utaxa, ucounts, uvalid


def _k6_check(dtax, u, c, v, factors=(0.25, 0.5, 1.0)):
    """Both K6 entries, all strategies, against their plain versions;
    one launch a call."""
    geom = pagg.hit_geometry(dtax, u, v)
    for strategy in ("hybrid", "lca*", "mrtl"):
        for factor in factors if strategy == "hybrid" else factors[:1]:
            before = kernels.K6.launches
            got = pagg.tree_aggregate_hits(strategy, dtax, u, c, v, factor)
            assert kernels.K6.launches == before + 1
            want = pagg.tree_aggregate_hits_plain(strategy, dtax, u, c, v,
                                                  factor)
            assert got.dtype == torch.int32 and torch.equal(got, want)
            on_geom = pagg.tree_aggregate(strategy, dtax, geom, u, c, factor)
            assert torch.equal(on_geom, pagg.tree_aggregate_plain(
                strategy, dtax, geom, u, c, factor))
            assert torch.equal(on_geom, got)


@pytest.mark.parametrize("world", ["random", "bench", "chain"])
@pytest.mark.parametrize("K", [4, 64, 408, 648])
def test_tree_aggregate_hits_kernel(dev, world, K):
    """K6's hits entry and its HitGeometry entry at the main width, the
    wide program's (408, 648) and a small one, for all three strategies
    and factors 0.25 / 0.5 / 1.0, over two seeds: groups of 0, 1, 2-3,
    16-17 and all valid slots, I32_MAX ids in invalid slots."""
    tax = _K6_TREES[world]()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    B = 300 if K > 64 else 1000
    for seed in (K, K + 1):
        u, c, v = (torch.from_numpy(x).to(dev)
                   for x in _k6_hits(tax, B, K, seed))
        assert not v[0].any() and v[6].sum() >= min(K, 18)
        _k6_check(dtax, u, c, v)


@pytest.mark.parametrize("K,B,full", [(64, 777, False), (64, 100, True),
                                      (648, 65, False), (2000, 40, False)])
def test_tree_aggregate_thread_mapping(dev, K, B, full):
    """Every path of the thread mapping: at K = 64 hybrid's walk in
    registers (up to 4 valid hits), the thread path (up to 16), the warp
    path (17 and more) with a block's larger groups dealt out to its
    warps, in blocks of mixed groups and in blocks whose every group is
    full, and group counts no multiple of a block's 32; past K = 64 (648,
    2000) the block path, a block a group, whose groups of up to 16
    valid hits take the same walks on the block's first thread."""
    tax = _bench_tree()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    if full:
        rng = np.random.default_rng(B)
        ids = np.flatnonzero(tax.depth >= 1)
        hits = (np.sort(rng.choice(ids, size=(B, K)), axis=1).astype(
            np.int32), rng.integers(1, 7, size=(B, K)).astype(np.float32),
            np.ones((B, K), bool))
    else:
        hits = _k6_hits(tax, B, K, K + B)
    u, c, v = (torch.from_numpy(x).to(dev) for x in hits)
    _k6_check(dtax, u, c, v, factors=(0.25, 1.0))


def test_tree_aggregate_hits_allocates_only_its_output(dev):
    """The hits entry builds no (B, K, D) rows and no (B, K, K)
    incidence: the only allocation is the (B,) result."""
    tax = _bench_tree()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    B, K = 16384, 64
    u, c, v = (torch.from_numpy(x).to(dev) for x in _k6_hits(tax, B, K, 3))
    for strategy in ("hybrid", "lca*", "mrtl"):
        pagg.tree_aggregate_hits(strategy, dtax, u, c, v)  # build, warm
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = pagg.tree_aggregate_hits(strategy, dtax, u, c, v)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base <= 4 * B + 512
        del out


@pytest.mark.parametrize("preset", ["high-sensitivity", "high-precision",
                                    "max-precision", "max-sensitivity"])
def test_tree_presets_launch_k6_once_a_batch(dev, preset):
    """run_stages of the tree aggregators on the card: after seed-extend
    one K4 launch (with the lower bound) and one K6 launch (with snap) a
    batch, no K5 (no take, no ancestry epilogue) and no K9; taxa equal to
    the plain path's."""
    from umgap_tpu_torch.pipeline.fused import PRESETS, run_stages

    tax = _random_tree(3000, 4)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    rng = np.random.default_rng(8)
    B, E, L = 96, 2, 100
    codes = rng.integers(0, 4, size=(B * E, L)).astype(np.uint8)
    lens = np.full((B, E), L, np.int32)
    hi, lo, wv, _ = translate.reads_to_kmers_plain(
        torch.from_numpy(codes), torch.from_numpy(lens.reshape(-1)), L,
        encoding.get_table(1), 9, packed=False)
    # every 9-mer of two reads in three maps to one taxon of its read, so
    # seeds form and groups hold one or two taxa
    keys = ((hi.numpy().astype(np.uint64) << np.uint64(25))
            | lo.numpy().astype(np.uint64))
    per_read = rng.integers(2, 3001, size=(B * E, 1, 1)).astype(np.int32)
    hit = wv.numpy() & (np.arange(B * E) % 3 != 0)[:, None, None]
    keys, first = np.unique(keys[hit], return_index=True)
    vals = np.broadcast_to(per_read, hi.shape)[hit][first]
    dtable = lookup.DeviceTable.from_host(build_kmer_table(keys, vals, 9),
                                          dev)
    cfg = PRESETS[preset]
    reads = torch.from_numpy(codes).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    before = kernels.launch_counts()
    for _ in range(2):
        got = run_stages(reads, lt, L, False, dtax, dtable, cfg)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["tree_aggregate"] - before["tree_aggregate"] == 2
    assert after["dedup_counts"] - before["dedup_counts"] == 2
    for k in ("lane_gather", "lane_gather_ancestry", "rmq_aggregate"):
        assert after[k] == before[k], k
    want = run_stages(reads, lt, L, False, dtax, dtable, cfg, plain=True)
    assert torch.equal(got, want)
    assert (got != 1).any()  # some groups were assigned


def test_tree_aggregate_refuses_bad_inputs(dev):
    """The wrappers refuse what the kernel cannot take: hit lists that do
    not match the geometry, wrong dtypes; hit lists too wide for one
    warp's list in shared memory are no longer refused."""
    tax = _random_tree(300, 2)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    u, c, v = (torch.from_numpy(x).to(dev)
               for x in _k6_hits(tax, 40, 8, 1))
    geom = pagg.hit_geometry(dtax, u, v)
    with pytest.raises(ValueError):
        pagg.tree_aggregate("hybrid", dtax, geom, u[:, :7].contiguous(),
                            c[:, :7].contiguous())
    with pytest.raises(ValueError):
        pagg.tree_aggregate_hits("mrtl", dtax, u, c.double(), v)
    with pytest.raises(ValueError):
        pagg.tree_aggregate_hits("hybrid", dtax, u, None, v)
    # hit lists too wide for a block's list in shared memory run from
    # a global scratch, exactly
    wide = torch.zeros((2, 17921), dtype=torch.int32, device=dev)
    every = torch.ones_like(wide, dtype=torch.bool)
    assert pagg.tree_scratch_bytes(2, 12000) == 0
    assert pagg.tree_scratch_bytes(2, 17921) > 0
    assert torch.equal(
        pagg.tree_aggregate_hits("lca*", dtax, wide, None, every),
        pagg.tree_aggregate_hits_plain("lca*", dtax, wide, None, every))


# ---------------------------------------------------------------------- #
# The wide paths: rows past each kernel's shared-memory budget
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("packed", [True, False])
def test_reads_to_kmers_direct_kernel(dev, packed):
    """K1 at 20,000 bp, past the tile's shared memory at 4 reads a
    block: the direct kernel, one thread a window."""
    L = 20000
    assert translate.reads_to_kmers_path(L, 9, packed) == "direct"
    assert translate.reads_to_kmers_path(4096, 9, packed) == "tile"
    rng = np.random.default_rng(20 + packed)
    for n in (1, 9):
        src, lens = _k1_reads(rng, n, L, packed)
        _k1_check(dev, src, lens, L, 11, packed, methionine=True)


# the width ladder's rungs (paired reads of 512 to 4,096 bp: W windows a
# lane, N = 12 W hits a row) and the wide paths' widths
LADDER_W = (162, 333, 674, 1357)


@pytest.mark.parametrize("N", LADDER_W + (4000,))
def test_seedextend_kernel_global_deltas(dev, N):
    """K3's row kernel at each rung of the width ladder (162 to 1,357
    windows a lane) and at 4,000 windows (past 3,600, where the parent's
    kernel kept its delta rows in global memory): hits and mask against
    the position loop and against ``seedextend_runs_plain``, one launch
    of K3R an entry and none of the staged tile."""
    assert seedextend.seedextend_path(N) == "rows"
    rng = np.random.default_rng(N)
    taxa, lens = _seed_lanes(rng, 131, N)
    taxa[1, :2] = 0  # a leading gap of 2 (b2 at g = 2) before a run
    taxa[1, 2:5] = 7
    taxa[2] = np.arange(N) % 3  # one-window runs
    before = kernels.K3R.launches, kernels.K3.launches
    for s, g in ((2, 0), (3, 1), (1, 2)):
        _k3_check(dev, taxa, lens, s, g)
        tx = torch.from_numpy(taxa).to(dev)
        ln = torch.from_numpy(lens).to(dev)
        assert torch.equal(
            seedextend.seedextend_hits(tx, ln, s, g).cpu(),
            seedextend.seedextend_runs_plain(tx, ln, s, g, hits=True).cpu())
    assert kernels.K3R.launches == before[0] + 9
    assert kernels.K3.launches == before[1]


# seed scores of taxa 0-8 (0: no score, the penalty instead); taxon 11
# lies past the table and scores the penalty too
SEED_SCORES = np.array([0, 12, 0, 3, 12, 12, 0, 5, 12], np.int32)


def _scored_lanes(rng, lanes, N):
    """``_seed_lanes`` with a taxon past the score table, lanes opening
    with a gap of 1 and 2 windows (b2's push with start > stop) and a
    lane of two equal seeds (a tie: the last one is kept)."""
    taxa, lens = _seed_lanes(rng, lanes, N)
    taxa[(taxa == 6) & (rng.random(taxa.shape) < 0.3)] = 11
    if lanes >= 4 and N >= 20:
        taxa[1, :1], taxa[1, 1:6] = 0, 5
        taxa[2, :2], taxa[2, 2:6] = 0, 7
        taxa[3] = 0
        taxa[3, 2:6] = taxa[3, N - 6:N - 2] = 4
        lens[1:4] = N
    return taxa, lens


def _k3s_check(dev, taxa, lens, s, g, penalty, runs=False):
    """K3's scored entry against the plain version (and against the row
    formulation with ``runs``); one launch of the entry its width takes."""
    tx = taxa if isinstance(taxa, torch.Tensor) else \
        torch.from_numpy(taxa).to(dev)
    ln = lens if isinstance(lens, torch.Tensor) else \
        torch.from_numpy(lens).to(dev)
    sc = torch.from_numpy(SEED_SCORES).to(dev)
    k = (kernels.K3S if seedextend.seedextend_path(tx.shape[-1]) == "staged"
         else kernels.K3RS)
    before = k.launches, kernels.K3.launches, kernels.K3R.launches
    got = seedextend.seedextend_hits(tx, ln, s, g, seed_scores=sc,
                                     penalty=penalty)
    assert (k.launches, kernels.K3.launches, kernels.K3R.launches) == (
        before[0] + 1, before[1], before[2])
    _eq((got,), (seedextend.seedextend_scored_hits_plain(
        tx, ln, sc, penalty, s, g),))
    if runs:
        _eq((got,), (seedextend.seedextend_scored_runs_plain(
            tx, ln, sc, penalty, s, g),))
        _eq((got,), (seedextend.seedextend_scored_walk_plain(
            tx, ln, sc, penalty, s, g),))
    return got


@pytest.mark.parametrize("penalty", [0, 5, 9])
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [0, 1, 2])
def test_seedextend_scored_kernel(dev, s, g, penalty):
    """K3's scored entries on both sides of the staged tile's edge: the
    template widths (25, 45), an even one (52), 96 (the tile's last) and
    97, 130 (the row kernel), lane counts no multiple of a block's."""
    rng = np.random.default_rng(100 * penalty + 10 * s + g)
    for N in (25, 45, 52, 96, 97, 130):
        for lanes in (1, 63, 1001):
            _k3s_check(dev, *_scored_lanes(rng, lanes, N), s, g, penalty,
                       runs=N > 96)


def test_seedextend_scored_kernel_shapes_and_alignment(dev):
    """(B, 6, W) lanes as the pipeline passes them, taxa off a 16-byte
    boundary, and a lane whose only push is b2's (start > stop, a
    negative score) next to one with no push."""
    rng = np.random.default_rng(6)
    taxa, lens = _scored_lanes(rng, 6 * 700, 45)
    _k3s_check(dev, torch.from_numpy(taxa.reshape(700, 6, 45)).to(dev),
               torch.from_numpy(lens.reshape(700, 6)).to(dev), 3, 1, 5)
    for N in (25, 42, 121):  # rows of 100, 168, 484 bytes
        taxa, lens = _scored_lanes(rng, 501, N)
        big = torch.from_numpy(taxa).to(dev)
        assert big[1:].data_ptr() % 16
        _k3s_check(dev, big[1:], torch.from_numpy(lens[1:]).to(dev), 2, 1,
                   5)
    taxa = np.zeros((3, 30), np.int32)
    taxa[:2, 1] = 5  # g = 1: b2 at position 1; the flush pushes [2, 1)
    taxa[1, 6:9] = 7  # b1 pushes [2, 1), the flush [6, 9)
    got = _k3s_check(dev, taxa, np.full(3, 30, np.int32), 1, 1, 5)
    assert not got[0].any() and not got[2].any() and got[1, 6:9].all()


@pytest.mark.parametrize("lane_threads", [16, 32])
@pytest.mark.parametrize("N", (97, 128, 129, 132, 160, 255, 256, 257) +
                         LADDER_W + (4000,))
def test_seedextend_scored_rows_kernel(dev, monkeypatch, N, lane_threads):
    """K3's scored row kernel (K3RS) with 16 and 32 threads a lane, at
    widths on both sides of its 16-, 32-, 144- and 256-window edges, at
    each rung of the width ladder and at 4,000 windows, against the
    plain version and both row formulations; b2 at a chunk edge (lanes
    opening with 31, 32, 127 and 128 zeros, g = 128), and a negative
    penalty (b2's push tied by a later unscored seed)."""
    monkeypatch.setattr(seedextend, "scored_lane_threads",
                        lambda _n: lane_threads)
    rng = np.random.default_rng(N + 1)
    taxa, lens = _scored_lanes(rng, 131, N)
    taxa[5] = np.arange(N) % 3  # one-window runs
    for i, z in enumerate((31, 32, 127, 128)):
        if z + 8 < N:
            taxa[6 + i] = 0
            taxa[6 + i, z:z + 2] = 5
            taxa[6 + i, z + 4:z + 7] = 7
            lens[6 + i] = N
    taxa[10] = 0
    taxa[10, 1] = 5  # b2 at 1; 4 unscored windows after a gap of 4
    taxa[10, 6:10] = 2
    lens[10] = N
    for s, g, penalty in ((2, 0, 5), (3, 1, 0), (1, 2, 9), (1, 1, -3),
                          (2, 128, 5)):
        _k3s_check(dev, taxa, lens, s, g, penalty, runs=True)


@pytest.mark.parametrize("N", tuple(12 * w for w in LADDER_W) + (24576,))
@pytest.mark.parametrize("k_max", [64, 30000])
def test_dedup_kernel_global_path(dev, N, k_max):
    """K4's row kernel at each rung of the width ladder (N = 1,944 to
    16,284 hits a row) and at 24,576 (past 16,384, the parent's global
    path), with and without weights, against the plain version and
    ``dedup_counts_rows_plain``; one launch of K4R a call and none of
    the warp path."""
    assert pagg.dedup_path(N) == "rows"
    rows = _dedup_rows(N, k_max)
    taxa = torch.from_numpy(rows).to(dev)
    w = torch.from_numpy(np.random.default_rng(k_max).integers(
        0, 5, size=rows.shape).astype(np.float32)).to(dev)
    before = kernels.K4R.launches, kernels.K4.launches
    for wt in (None, w):
        got = pagg.dedup_counts(taxa, wt, k_max, True)
        _eq(got, pagg.dedup_counts_plain(taxa, wt, k_max, True))
        _eq(got, pagg.dedup_counts_rows_plain(taxa, wt, k_max, True))
    assert kernels.K4R.launches == before[0] + 2
    assert kernels.K4.launches == before[1]


def test_dedup_kernel_scratch_rows(dev, monkeypatch):
    """K4's row kernel where a row's valid entries overflow its shared
    room (cut to 8 KB here; 200 KB on the main path): those rows sort in
    the block's global scratch row, on more rows than the launch runs
    blocks (each block takes several rows)."""
    monkeypatch.setattr(pagg, "DEDUP_SMEM_MAX", 8192)
    N = 3000
    rows = np.tile(_dedup_rows(N, 11), (12, 1))
    assert len(rows) > pagg.DEDUP_SCRATCH_BLOCKS
    taxa = torch.from_numpy(rows).to(dev)
    w = torch.from_numpy(np.random.default_rng(12).integers(
        0, 5, size=rows.shape).astype(np.float32)).to(dev)
    for wt in (None, w):
        cap, blocks, _ = pagg.dedup_rows_layout(N, wt is not None)
        assert cap < N and blocks == pagg.DEDUP_SCRATCH_BLOCKS
        _eq(pagg.dedup_counts(taxa, wt, 64, True),
            pagg.dedup_counts_plain(taxa, wt, 64, True))


@pytest.mark.parametrize("K,B", [(408, 600), (4104, 40), (8196, 24),
                                 (16392, 24), (32004, 16)])
def test_tree_aggregate_wide_lists(dev, K, B, monkeypatch):
    """K6's block path at the wide program's widths (K = 408 to 16,392:
    paired reads of 100 to 4,096 bp) and past a block's shared memory
    (K = 32,004, 8,000 bp: the global scratch, cut here to 3 lists so
    that each block takes several groups): groups of 0-17, more than 64
    and all K valid distinct taxa, repeated ids in every fifth group,
    every fourth group's slots shuffled (ids unsorted, valid slots
    spread over the row), more groups than the launch's blocks at
    K = 408; all three strategies against their plain versions (whose
    (B, K, K) tensors take 4 groups a call, 1 past K = 16,392), one
    launch a call."""
    assert pagg.tree_path(65, K) == "block"
    if K > 17920:
        assert pagg.tree_scratch_blocks(B, K) == B
        monkeypatch.setattr(pagg, "TREE_SCRATCH_MAX",
                            3 * pagg.tree_list_bytes(K))
        assert pagg.tree_scratch_blocks(B, K) == 3
    else:
        assert pagg.tree_scratch_bytes(B, K) == 0
    assert K != 408 or B > pagg.TREE_BLOCK_GRID
    tax = _bench_tree()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    hits = _k6_hits(tax, B, K, 7)
    rng = np.random.default_rng(K)
    for b in range(3, B, 4):
        p = rng.permutation(K)
        for x in hits:
            x[b] = x[b][p]
    u, c, v = (torch.from_numpy(x).to(dev) for x in hits)
    n_valid = v.sum(dim=1)
    assert (n_valid > 64).sum() >= 4 and int(n_valid.max()) == min(
        K, len(np.flatnonzero(tax.depth >= 1)))
    step = 4 if K <= 16392 else 1
    for strategy in ("hybrid", "lca*", "mrtl"):
        before = kernels.K6.launches
        got = pagg.tree_aggregate_hits(strategy, dtax, u, c, v)
        assert kernels.K6.launches == before + 1
        want = torch.cat([pagg.tree_aggregate_hits_plain(
            strategy, dtax, u[s:s + step], c[s:s + step], v[s:s + step])
            for s in range(0, B, step)])
        assert got.dtype == torch.int32 and torch.equal(got, want)


def _star_tree(n=3000):
    """A root with n - 1 children and 400 grandchildren under 40 of them:
    hybrid's first branching point has more branches than its table
    takes in one pass."""
    parent = [1, 1] + [1] * (n - 1) + [2 + i % 40 for i in range(400)]
    return Taxonomy([Taxon(i, f"t{i}", ranks.NO_RANK, parent[i], True)
                     for i in range(1, n + 401)])


@pytest.mark.parametrize("world", ["random", "bench", "chain", "star"])
def test_tree_block_path_matches_wide_plain(dev, world):
    """The block path against tree_aggregate_wide_plain, its formulation
    in PyTorch (held to the JAX package in test_torch_wide_agg.py), and
    against tree_aggregate_hits_plain, at K = 65, 408 and 4,104: groups
    with no valid slot, unsorted ids with repeats, ids below 0 and past
    the table's size, a chain with one slot off it, and (star) a
    thousand branches and more under one node, one of them heavy."""
    tax = {"random": lambda: _random_tree(3000, 9), "bench": _bench_tree,
           "chain": _chain_tree, "star": _star_tree}[world]()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    size = int(dtax.geom.shape[0])
    ids = np.flatnonzero(tax.depth >= 1)
    deep = int(ids[np.argmax(tax.depth[ids])])
    chain = tax.anc_table[deep][tax.anc_table[deep] > 0]
    for K in (65, 408, 4104):
        rng = np.random.default_rng(K + len(world))
        B = 12
        u = np.full((B, K), np.iinfo(np.int32).max, np.int32)
        c = np.zeros((B, K), np.float32)
        v = np.zeros((B, K), bool)
        for b in range(1, B):
            n = int(rng.integers(17, K + 1))
            sel = rng.choice(ids, size=n)
            if b % 4 == 1:
                sel[rng.choice(n, size=5, replace=False)] = [
                    -1, -9, 0, size, size + 2]
            if b % 4 == 2:
                sel = np.concatenate([np.repeat(chain, 2),
                                      rng.choice(ids, size=1)])[:K]
                rng.shuffle(sel)
            if world == "star" and b % 4 == 3:
                sel[: n // 3] = ids[0]  # one branch holds a third
            u[b, :len(sel)] = sel
            c[b, :len(sel)] = rng.integers(1, 7, size=len(sel))
            v[b, :len(sel)] = True
        ut, ct, vt = (torch.from_numpy(x).to(dev) for x in (u, c, v))
        for strategy in ("hybrid", "lca*", "mrtl"):
            for factor in ((0.0, 0.25) if strategy == "hybrid" else (0.25,)):
                got = pagg.tree_aggregate_hits(strategy, dtax, ut, ct, vt,
                                               factor)
                assert torch.equal(got, pagg.tree_aggregate_wide_plain(
                    strategy, dtax, ut, ct, vt, factor))
                want = torch.cat([pagg.tree_aggregate_hits_plain(
                    strategy, dtax, ut[s:s + 4], ct[s:s + 4], vt[s:s + 4],
                    factor) for s in range(0, B, 4)])
                assert torch.equal(got, want)


def _k7_reads(rng, n, L):
    """n random reads of width L: N-rich reads (unknown residues are
    members), 'TAA' repeats (an all-'*' forward frame), reads of length
    0-2 (every frame empty), lengths below 27 (no 9-residue fragment),
    L and above L (clamped)."""
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.03] = 4
    codes[1::9] = np.resize(np.array([3, 0, 0], np.uint8), L)  # TAA...
    codes[2::9, ::5] = 4
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    special = np.array([0, 1, 2, 26, L, L + 5, L - 1, 3], np.int32)
    m = min(n, len(special))
    lens[:m] = special[:m]
    lens[1::9] = L
    return codes, lens


def _k7_check(dev, codes, lens, L, packed=True):
    from umgap_tpu_torch.pipeline import tryptic

    src = encoding.pack_dna4(codes) if packed else codes
    r = torch.from_numpy(src).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    t = encoding.get_table(1)
    before = kernels.K7.launches
    got = tryptic.reads_to_peptides(r, ln, L, t, packed)
    want = tryptic.reads_to_peptides_plain(r, ln, L, t, packed)
    assert kernels.K7.launches == before + 1
    _eq(got, want)
    return want


@pytest.mark.parametrize("L", [17, 64, 100, 160, 161, 192, 195, 1001])
@pytest.mark.parametrize("packed", [True, False])
def test_reads_to_peptides_kernel(dev, L, packed):
    """K7 at the main widths (100, 160), odd and short ones, 192 and 195
    (6 x F = 48 slots a read, P = 64 and 65 residues a frame) and a long
    one (fewer reads a block), on both wires, read counts no multiple of
    the block's reads; every slot compared, the empty ones 0."""
    rng = np.random.default_rng(L + packed)
    for n in (1, 7, 300, 16385):
        if n == 16385 and L not in (100, 160):
            continue
        codes, lens = _k7_reads(rng, n, L)
        want = _k7_check(dev, codes, lens, L, packed)
        if n == 16385:
            assert int(want[2].sum()) > n  # fragments were emitted


# one codon of the standard code for each residue, to write reads whose
# first frame holds chosen peptides
_CODON = dict(A="GCT", C="TGT", D="GAT", E="GAA", F="TTT", G="GGT",
              H="CAT", I="ATT", K="AAA", L="CTT", M="ATG", N="AAT",
              P="CCT", Q="CAA", R="CGT", S="TCT", T="ACT", V="GTT",
              W="TGG", Y="TAT")
_CODON["*"] = "TAA"
# first frames of 50 residues: fragments of exactly 9, 45 and 46
# residues, only '*', no K or R, K and R before P, a K or R that ends
# the frame
EDGE_PEPTIDES = (
    "AAAAAAAAK" + "G" * 41,
    "A" * 44 + "K" + "G" * 5,
    "A" * 45 + "K" + "G" * 4,
    "*" * 50,
    "ACDEFGHILMNQSTVWY*ACDEFGHILMNQSTVWY*ACDEFGHILMNQST",
    "AAAAKPAAAAK" + "G" * 9 + "*" + "AARPAAAAAAR" + "C" * 18,
    "G" * 20 + "R" + "A" * 28 + "K",
    "G" * 20 + "K" + "A" * 28 + "R",
)
EDGE_FRAGMENTS = [2, 1, 0, 0, 3, 4, 2, 2]


def _edge_reads(L):
    """The EDGE_PEPTIDES as reads of L >= 150 bases (the peptide's 150,
    then 'TAA' stop codons), each at length L and at 149 (the last
    residue drops out of the first frame)."""
    codes, lens = [], []
    for pep in EDGE_PEPTIDES:
        seq = "".join(_CODON[a] for a in pep)
        seq = (seq + "TAA" * L)[:L]
        for ln in (L, 149):
            codes.append(encoding.encode_dna(seq))
            lens.append(ln)
    return np.stack(codes), np.array(lens, np.int32)


@pytest.mark.parametrize("L", [150, 160, 161, 192])
@pytest.mark.parametrize("packed", [True, False])
def test_reads_to_peptides_kernel_fragment_edges(dev, L, packed):
    """K7 on reads written to hold fragments of exactly 9, 45 and 46
    residues (the last one dropped), an all-'*' frame, a frame with no K
    or R, K and R before P (no cleave) and a K or R that ends a frame,
    each repeated past a block's reads, and from an unaligned span."""
    codes, lens = _edge_reads(L)
    reps = 40
    codes = np.concatenate([codes] * reps)
    lens = np.concatenate([lens] * reps)
    want = _k7_check(dev, codes, lens, L, packed)
    F = (L // 3) // 9 + 1
    frame1 = want[2].reshape(-1, 6, F)[:, 0].sum(axis=1)
    # fragments kept in the first frame of each peptide's full read
    assert frame1[0:16:2].tolist() == EDGE_FRAGMENTS
    from umgap_tpu_torch.pipeline import tryptic

    src = encoding.pack_dna4(codes) if packed else codes
    flat = torch.zeros(src.size + 1, dtype=torch.uint8, device=dev)
    flat[1:] = torch.from_numpy(src.reshape(-1)).to(dev)
    r = flat[1:].view(src.shape)  # one byte past an aligned address
    ln = torch.from_numpy(lens).to(dev)
    t = encoding.get_table(1)
    assert r.data_ptr() % 16
    before = kernels.K7.launches
    _eq(tryptic.reads_to_peptides(r, ln, L, t, packed), want)
    assert kernels.K7.launches == before + 1


@pytest.mark.parametrize("R", [1, 3, 8, 16, 64, 128])
def test_reads_to_peptides_kernel_reads_per_block(dev, R, monkeypatch):
    """K7's output does not depend on its reads per block."""
    from umgap_tpu_torch.pipeline import tryptic

    monkeypatch.setattr(tryptic, "READS_PER_BLOCK", R)
    rng = np.random.default_rng(R)
    for L in (100, 160):
        codes, lens = _k7_reads(rng, 1001, L)
        _k7_check(dev, codes, lens, L)


def test_reads_to_peptides_kernel_direct(dev):
    """Reads too long for K7's tile even at one read a block (about 3.5
    bytes of shared memory a base): the direct kernel, one thread a
    lane."""
    rng = np.random.default_rng(70)
    L = 70_001
    codes, lens = _k7_reads(rng, 5, L)
    lens[3] = L - 2
    _k7_check(dev, codes, lens, L)


def test_probe_peptide_kernel(dev):
    """K8 against its plain version on a small table at high load
    (max_probes >= 1): present, absent and invalid queries, defaults 0
    and -7, one query and none."""
    from umgap_tpu_torch.index.table import PeptideTable, _fingerprints

    rng = np.random.default_rng(8)
    alpha = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(alpha, size=int(k)))
                   for k in rng.integers(9, 46, 3000)})
    vals = rng.integers(1, 300, len(peps)).astype(np.int32)
    pt = PeptideTable.build(peps, vals, load_factor=0.95)
    assert pt.max_probes >= 1
    dt = lookup.DeviceTable.from_host(pt, dev)
    hi, lo = _fingerprints(peps + ["".join(rng.choice(alpha, size=12))
                                   for _ in range(1000)])
    hi = torch.from_numpy(hi).to(dev).reshape(-1, 4)
    lo = torch.from_numpy(lo).to(dev).reshape(-1, 4)
    valid = torch.from_numpy(rng.random(tuple(hi.shape)) < 0.9).to(dev)
    before = kernels.K8.launches
    for default in (0, -7):
        got = lookup.probe(dt, hi, lo, valid, default)
        _eq(got, lookup.probe_plain(dt, hi, lo, valid, default))
        assert got[0].shape == hi.shape
        assert int(got[1].sum()) > len(peps) // 2
    _eq(lookup.probe(dt, hi, lo, None, 0),
        lookup.probe_plain(dt, hi, lo, None, 0))
    for n in (1, 0):
        _eq(lookup.probe(dt, hi.reshape(-1)[:n], lo.reshape(-1)[:n]),
            lookup.probe_plain(dt, hi.reshape(-1)[:n], lo.reshape(-1)[:n]))
    assert kernels.K8.launches == before + 5


def _k8_table(dev, n, capacity, seed, home=None):
    """A peptide table of n random fingerprints in ``capacity`` slots;
    with ``home``, 3 x 8 + 2 more keys whose bucket is ``home`` (they
    chain over the next three rows, wrapping past the last). Returns
    (DeviceTable, PeptideTable, hi, lo) with the keys present first, then
    as many absent ones."""
    from umgap_tpu_torch.index import table as ptable

    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, 2 ** 64 - 1, size=3 * n + 50_000,
                                 dtype=np.uint64))
    key = key[(key >> np.uint64(32)) != np.uint64(0xFFFFFFFF)]
    rng.shuffle(key)
    hi = (key >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = key.astype(np.uint32).view(np.int32)
    nb = capacity // 8
    if home is not None:
        b = ptable.hash32(hi, lo) & np.uint32(nb - 1)
        at = np.nonzero(b == home)[0][:26]
        assert len(at) == 26
        rest = np.setdiff1d(np.arange(len(key)), at)
        order = np.concatenate([at, rest[:n - 26], rest[n - 26:2 * n]])
    else:
        order = np.arange(2 * n)
    hi, lo = hi[order], lo[order]
    tab = ptable.PeptideTable._from_fingerprints(
        hi[:n], lo[:n], rng.integers(1, 1000, n).astype(np.int32),
        capacity=capacity)
    return lookup.DeviceTable.from_host(tab, dev), tab, hi, lo


def _k8_check(dt, hi, lo, valid, default=0):
    before = kernels.K8.launches
    got = lookup.probe(dt, hi, lo, valid, default)
    assert kernels.K8.launches == before + 1
    want = lookup.probe_plain(dt, hi, lo, valid, default)
    _eq(got, want)
    return want


@pytest.mark.parametrize("Q", [1, 2, 4])
def test_probe_peptide_kernel_windows(dev, Q, monkeypatch):
    """K8 over windows of 32 x Q slots where every query is valid, none
    is, and only the last slot is, and a slot count no multiple of the
    window, at each queries-per-lane setting."""
    monkeypatch.setattr(lookup, "QUERIES_PER_LANE", Q)
    dt, _tab, hi, lo = _k8_table(dev, 6000, 1 << 14, 80 + Q)
    W = 32 * Q
    n = 40 * W + 7
    h = torch.from_numpy(hi[:n].copy()).to(dev)
    l = torch.from_numpy(lo[:n].copy()).to(dev)
    pattern = np.zeros(n, bool)
    pattern[:10 * W] = True                   # windows of valid queries
    pattern[20 * W - 1:30 * W:W] = True       # only each last slot
    pattern[30 * W:] = np.random.default_rng(Q).random(n - 30 * W) < 0.3
    v = torch.from_numpy(pattern).to(dev)
    want = _k8_check(dt, h, l, v, -3)
    assert int(want[1][:10 * W].sum()) > 0
    assert (want[0][10 * W:20 * W - 1] == -3).all()
    _k8_check(dt, h, l, torch.zeros_like(v))
    _k8_check(dt, h, l, torch.ones_like(v))
    _k8_check(dt, h[:1], l[:1], v[:1])


def test_probe_peptide_kernel_chains_and_wrap(dev, monkeypatch):
    """K8 on keys that chain over max_probes rows from the last bucket,
    wrapping to bucket 0, present and absent, on a table full enough
    that other keys chain too."""
    dt, tab, hi, lo = _k8_table(dev, 100, 1 << 7, 90,
                                home=(1 << 7) // 8 - 1)
    assert tab.max_probes >= 3
    assert (tab.key_hi.reshape(-1, 8)[:2] != -1).all()  # wrapped rows
    h = torch.from_numpy(hi[:200].copy()).to(dev)
    l = torch.from_numpy(lo[:200].copy()).to(dev)
    for Q in (1, 2, 4):
        monkeypatch.setattr(lookup, "QUERIES_PER_LANE", Q)
        want = _k8_check(dt, h, l, None, -1)
        assert want[1][:100].all() and not want[1][100:].any()


def test_probe_peptide_kernel_host_digest_width(dev):
    """K8 on the host-digest route's (B, W) queries cut to odd widths W
    (rows of W slots, so no row starts on a window's boundary)."""
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.ops import kmers
    from umgap_tpu_torch.pipeline import tryptic

    rng = np.random.default_rng(11)
    groups = [(f"g{i}", ["".join(rng.choice(list("ACGT"), size=int(n)))
                         for n in rng.integers(30, 400, 2)])
              for i in range(300)]
    hi, lo, valid = tryptic.digest_groups(groups, 7)
    peps = set()
    for _h, seqs in groups[::2]:
        for seq in seqs:
            for pep in translate.translate_sequence(
                    seq, translate.FRAME_NAMES, encoding.get_table(1)):
                peps.update(f for f in kmers.tryptic_digest(pep)
                            if 9 <= len(f) <= 45)
    table = PeptideTable.build(sorted(peps), rng.integers(
        2, 50, len(peps)).astype(np.int32))
    dt = lookup.DeviceTable.from_host(table, dev)
    h, l, v = (torch.from_numpy(x).to(dev) for x in (hi, lo, valid))
    for W in (7, 13):
        want = _k8_check(dt, h[:, :W].contiguous(), l[:, :W].contiguous(),
                         v[:, :W].contiguous())
        assert want[0].shape == (300, W) and int(want[1].sum()) > 0


@pytest.mark.parametrize("preset", ["tryptic-sensitivity",
                                    "tryptic-precision"])
def test_tryptic_stages_kernels_equal_plain(dev, preset):
    """One tryptic batch through K7, K8, K4 (with the bound) and K6 (with
    snap) equals the plain stages on the card, and launches each kernel
    once and K5 not at all."""
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.ops import kmers
    from umgap_tpu_torch.pipeline import tryptic

    rng = np.random.default_rng(9)
    tax = Taxonomy([Taxon(1, "root", ranks.NO_RANK, 1, True)] + [
        Taxon(i, f"t{i}", ranks.NO_RANK, int(rng.integers(1, i)), True)
        for i in range(2, 200)])
    B, L = 512, 100
    codes = rng.integers(0, 4, size=(B, 2, L)).astype(np.uint8)
    frags = set()
    for row in codes.reshape(-1, L):
        for pep in translate.translate_sequence(
                encoding.decode_dna(row), translate.FRAME_NAMES,
                encoding.get_table(1)):
            frags.update(f for f in kmers.tryptic_digest(pep)
                         if 9 <= len(f) <= 45)
    peps = sorted(frags)[::2]
    table = PeptideTable.build(peps, rng.integers(
        2, 200, len(peps)).astype(np.int32))
    cfg = tryptic.TRYPTIC_PRESETS[preset]
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    dtable = lookup.DeviceTable.from_host(table, dev)
    reads = torch.from_numpy(encoding.pack_dna4(codes)).to(dev).reshape(
        2 * B, -1)
    lens = torch.full((B, 2), L, dtype=torch.int32, device=dev)
    kernels.reset_launches()
    got = tryptic.run_tryptic_stages(reads, lens, L, True, dtax, dtable, cfg,
                                     True)
    counts = kernels.launch_counts()
    want = tryptic.run_tryptic_stages(reads, lens, L, True, dtax, dtable,
                                      cfg, True, plain=True)
    _eq(got, want)
    for k in ("reads_to_peptides", "probe_peptide", "dedup_counts",
              "tree_aggregate"):
        assert counts[k] == 1, counts
    assert counts["reads_to_kmers"] == counts["probe_kmer"] == 0
    assert counts["lane_gather"] == counts["rmq_aggregate"] == 0


# ---------------------------------------------------------------------- #
# The fused tail: K4's bound, K6's and K9's snap
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("N", [300, 540, 2048])
@pytest.mark.parametrize("k_max", [4, 64, 700])
def test_dedup_kernel_lower_bound(dev, N, k_max):
    """Both K4 paths (warp at 300 and 540, the row kernel at 2,048) with
    the bounds 1, 2 and 5 against the plain versions with the bound,
    with and without weights (0-4, so some counts are 0); uvalid is
    filtered, ids, counts and nuniq are those without the bound."""
    taxa = torch.from_numpy(_dedup_rows(N, 3 * N + k_max)).to(dev)
    w = torch.from_numpy(np.random.default_rng(N).integers(
        0, 5, size=tuple(taxa.shape)).astype(np.float32)).to(dev)
    for wt in (None, w):
        free = pagg.dedup_counts(taxa, wt, k_max, True)
        for bound in (1.0, 2.0, 5.0):
            got = pagg.dedup_counts(taxa, wt, k_max, True, lower_bound=bound)
            _eq(got, pagg.dedup_counts_plain(taxa, wt, k_max, True,
                                             lower_bound=bound))
            if N > 1024:
                _eq(got, pagg.dedup_counts_rows_plain(
                    taxa, wt, k_max, True, lower_bound=bound))
            _eq((got[0], got[1], got[3]), (free[0], free[1], free[3]))
            assert torch.equal(got[2], free[2] & (free[1] >= bound))
            assert (got[2] != free[2]).any() or bound == 1.0 and wt is None


def _snap_table(dtax, every=7):
    """dtax.snap_valid with every 7th entry NONE, so some aggregates
    snap to nothing."""
    snap = dtax.snap_valid.clone()
    snap[::every] = -1
    return snap


def _snap_check(dtax, u, c, v, snap, wide=False):
    """K6 with ``snap`` against the plain version with it (the block
    path's formulation past K = 64: the (B, K, K) plain tensors of wide
    lists are too large), one launch a call, for all three strategies;
    the same launch without snap, snapped by the plain version,
    agrees."""
    for strategy in ("hybrid", "lca*", "mrtl"):
        before = kernels.K6.launches
        got = pagg.tree_aggregate_hits(strategy, dtax, u, c, v, 0.25,
                                       snap=snap)
        assert kernels.K6.launches == before + 1
        plain = (pagg.tree_aggregate_wide_plain if wide
                 else pagg.tree_aggregate_hits_plain)
        want = plain(strategy, dtax, u, c, v, 0.25, snap=snap)
        assert got.dtype == torch.int32 and torch.equal(got, want)
        bare = pagg.tree_aggregate_hits(strategy, dtax, u, c, v, 0.25)
        assert torch.equal(got, pagg.snap_taxa_plain(snap, bare, v))
        assert (got[~v.any(dim=1)] == 1).all()


@pytest.mark.parametrize("world", ["random", "bench", "chain"])
@pytest.mark.parametrize("K", [4, 64, 408, 16392, 32004])
def test_tree_aggregate_snap_kernel(dev, world, K):
    """K6 with snap on every path: the thread path (groups of 0-16
    valid), the warp path (17-64), the block path (K = 408, 16,392) and
    the block path's global scratch (K = 32,004); with the pipeline's
    snap table and with one whose every 7th entry is NONE."""
    tax = _K6_TREES[world]()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    B = {4: 1000, 64: 1000, 408: 100}.get(K, 16)
    u, c, v = (torch.from_numpy(x).to(dev)
               for x in _k6_hits(tax, B, K, K + 5))
    if K > 17920:
        assert pagg.tree_scratch_blocks(B, K) > 0
    for snap in (dtax.snap_valid, _snap_table(dtax)):
        _snap_check(dtax, u, c, v, snap, wide=K > 64)


@pytest.mark.parametrize("K", [4, 64, 408])
def test_tree_aggregate_snap_edge_rows(dev, K):
    """K6's store on the rows at snap's edges: no valid slot (1), ids
    absent from the taxonomy and at and past the table's end (mrtl's
    aggregate is that id: 0), an aggregate whose snap entry is NONE
    (0), a table shorter than the taxonomy (ids past it: 0)."""
    tax = _random_tree(300, 3)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    size, big = dtax.geom.shape[0], np.iinfo(np.int32).max
    ids = np.flatnonzero(tax.depth >= 1)
    rows = [[], [size], [size + 7], [-1], [int(ids[5])], [int(ids[6])],
            [int(ids[7]), int(ids[8])], list(ids[:min(K, 20)])]
    B = 8 * 4
    utaxa = np.full((B, K), big, np.int32)
    ucounts = np.zeros((B, K), np.float32)
    uvalid = np.zeros((B, K), bool)
    for b in range(B):
        r = rows[b % 8][:K]
        utaxa[b, :len(r)] = r
        ucounts[b, :len(r)] = 1 + b % 3
        uvalid[b, :len(r)] = b % 4 != 3  # a quarter: no slot valid
    u, c, v = (torch.from_numpy(x).to(dev)
               for x in (utaxa, ucounts, uvalid))
    snap = dtax.snap_valid.clone()
    snap[int(ids[5])] = -1
    for table in (dtax.snap_valid, snap, snap[:int(ids[6])].contiguous()):
        _snap_check(dtax, u, c, v, table, wide=K > 64)
    got = pagg.tree_aggregate_hits("mrtl", dtax, u, c, v, snap=snap)
    assert (got[1::8][:3] == 0).all() and (got[2::8][:3] == 0).all()
    assert (got[3::4] == 1).all()


def _k9_plain(strategy, dtax, euler, u, c, v, factor=0.25, snap=None,
              ordered=False):
    """K9's plain version in row chunks whose (B, K, K) tensors stay
    near 2^28 elements."""
    step = max(1, (1 << 28) // (u.shape[1] ** 2))
    return torch.cat([prmq.rmq_aggregate_plain(
        strategy, dtax, euler, u[s:s + step], c[s:s + step], v[s:s + step],
        factor, snap, ordered) for s in range(0, u.shape[0], step)])


def _k9_check(dtax, euler, u, c, v, snaps, factors=(0.25,), ordered=False):
    """K9 for both strategies, with each table of ``snaps`` (None: no
    snap) and each factor (hybrid), against its plain version; one launch
    a call; the snapped launch equals the bare one snapped by the plain
    snap."""
    for strategy in ("lca*", "hybrid"):
        for factor in factors if strategy == "hybrid" else factors[:1]:
            bare = None
            for snap in snaps:
                before = kernels.K9.launches
                got = prmq.rmq_aggregate(strategy, dtax, euler, u, c, v,
                                         factor, snap, ordered)
                assert kernels.K9.launches == before + 1
                want = _k9_plain(strategy, dtax, euler, u, c, v, factor,
                                 snap, ordered)
                assert got.dtype == torch.int32 and torch.equal(got, want), \
                    (strategy, factor, int((got != want).sum()))
                if snap is None:
                    bare = got
                elif bare is not None:
                    assert torch.equal(got, pagg.snap_taxa_plain(snap, bare,
                                                                 v))


_K9_TREES = dict(_K6_TREES, star=lambda: _star_tree())


def _k9_wide_hits(tax, size, K, B, seed):
    """B groups of K slots past K = 64: the first with no valid slot, the
    others of 17 to K slots (90% valid) drawn with repeats, a quarter
    with ids below 0 and past the table, a quarter a chain with one slot
    off it, shuffled."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(tax.depth >= 1)
    deep = int(ids[np.argmax(tax.depth[ids])])
    chain = tax.anc_table[deep][tax.anc_table[deep] > 0]
    u = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    c = np.zeros((B, K), np.float32)
    v = np.zeros((B, K), bool)
    for b in range(1, B):
        n = int(rng.integers(17, K + 1))
        sel = rng.choice(ids, size=n)
        if b % 4 == 1:
            sel[rng.choice(n, size=5, replace=False)] = [
                -1, -9, 0, size, size + 2]
        if b % 4 == 2:
            sel = np.concatenate([np.repeat(chain, 2),
                                  rng.choice(ids, size=1)])[:K]
            rng.shuffle(sel)
        u[b, :len(sel)] = sel
        c[b, :len(sel)] = rng.integers(1, 7, size=len(sel))
        v[b, :len(sel)] = rng.random(len(sel)) < 0.9
    return u, c, v


@pytest.mark.parametrize("world", ["random", "bench", "chain", "star"])
@pytest.mark.parametrize("K", [64, 408, 4104])
def test_rmq_aggregate_kernel(dev, world, K):
    """K9 against rmq_aggregate_plain at the main width (64: hybrid's
    warp path), the wide program's (408: the block path) and past it
    (4,104): groups of 0-3, 16, 17, K and a random count of valid slots,
    filtered slots, repeated ids (K6's hit lists), and past K = 64
    ``_k9_wide_hits``; with and without the pipeline's snap table and
    (to K = 408) one whose every 7th entry is NONE."""
    tax = _K9_TREES[world]()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    euler = prmq.DeviceEuler.from_host(tax, dev)
    size = int(dtax.geom.shape[0])
    if K == 64:
        u, c, v = _k6_hits(tax, 1000, K, K + len(world))
    else:
        u, c, v = _k9_wide_hits(tax, size, K, 12, K + len(world))
        assert prmq.rmq_scratch_blocks(12, K) == 0
    u, c, v = (torch.from_numpy(x).to(dev) for x in (u, c, v))
    snaps = ((None, dtax.snap_valid, _snap_table(dtax)) if K <= 408
             else (None, dtax.snap_valid))
    _k9_check(dtax, euler, u, c, v, snaps, (0.0, 0.25, 0.9))


@pytest.mark.parametrize("world", ["bench", "chain"])
def test_rmq_lca_kernel_at_16392(dev, world):
    """K9's lca* walk at K = 16,392 (the wide program of 4,096 bp reads):
    against the plain version (a Python loop over the 16,392 slots, run
    once), and with the snap table against the plain snap of that.
    hybrid's plain (B, K, K) tensors are 1 GB a group here; its block
    path and scratch are held at K = 4,104 and 8,196."""
    tax = _K9_TREES[world]()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    euler = prmq.DeviceEuler.from_host(tax, dev)
    K = 16392
    u, c, v = (torch.from_numpy(x).to(dev) for x in _k9_wide_hits(
        tax, int(dtax.geom.shape[0]), K, 4, K + len(world)))
    want = _k9_plain("lca*", dtax, euler, u, c, v)
    before = kernels.K9.launches
    assert torch.equal(prmq.rmq_aggregate("lca*", dtax, euler, u, c, v),
                       want)
    got = prmq.rmq_aggregate("lca*", dtax, euler, u, c, v,
                             snap=dtax.snap_valid)
    assert kernels.K9.launches == before + 2
    assert torch.equal(got, pagg.snap_taxa_plain(dtax.snap_valid, want, v))


def test_rmq_aggregate_kernel_global_scratch(dev):
    """K9's hybrid past a block's shared memory (K = 8,196: its lists in
    the global scratch), and with the scratch cut to one area (the grid
    strides over the batch), against the plain version."""
    tax = _random_tree(3000, 9)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    rng = np.random.default_rng(3)
    K, B = 8196, 5
    ids = np.flatnonzero(tax.depth >= 1)
    u = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    c = np.zeros((B, K), np.float32)
    v = np.zeros((B, K), bool)
    for b, n in enumerate((0, 1, 70, 900, 2500)):
        u[b, :n] = np.sort(rng.choice(ids, size=n, replace=False))
        c[b, :n] = rng.integers(1, 7, size=n)
        v[b, :n] = True
    u, c, v = (torch.from_numpy(x).to(dev) for x in (u, c, v))
    assert prmq.rmq_scratch_blocks(B, K) == B
    want = _k9_plain("hybrid", dtax, None, u, c, v)
    assert torch.equal(prmq.rmq_aggregate("hybrid", dtax, None, u, c, v),
                       want)
    old = prmq.RMQ_SCRATCH_MAX
    try:
        prmq.RMQ_SCRATCH_MAX = prmq.rmq_mix_area_bytes(K)
        assert prmq.rmq_scratch_blocks(B, K) == 1
        assert torch.equal(prmq.rmq_aggregate("hybrid", dtax, None, u, c,
                                              v), want)
    finally:
        prmq.RMQ_SCRATCH_MAX = old


@pytest.mark.parametrize("K", [1, 13, 16, 64, 408])
@pytest.mark.parametrize("B", [1, 777, 16384])
def test_rmq_aggregate_store_kernel(dev, K, B):
    """K9's store (the snap that was snap_taxa's launch) against its
    plain version, on groups whose aggregate is a chosen id: one valid
    slot of an id in range, of one whose snap entry is NONE, at and past
    the table's end, negative (hybrid's aggregate is that id), I32_MAX;
    masks with no, one (first or last slot) and many valid slots; a
    table shorter than the taxonomy; rows of odd widths and a mask that
    starts off a 16-byte boundary; one launch a call."""
    rng = np.random.default_rng(K * B)
    tax = _random_tree(3000, 5)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    euler = prmq.DeviceEuler.from_host(tax, dev)
    snap = _snap_table(dtax, 5)
    S = len(snap)
    agg = rng.integers(0, S, size=B).astype(np.int32)
    odd = np.array([-1, S, S + 7, np.iinfo(np.int32).max, 0, -5], np.int32)
    agg[:min(B, 6)] = odd[:min(B, 6)]
    u = np.full((B + 1, K), np.iinfo(np.int32).max, np.int32)
    valid = rng.random((B + 1, K)) < rng.choice([0.0, 0.02, 0.5], (B + 1, 1))
    valid[1::5] = False
    valid[2::5, -1] = True
    valid[3::5, 0] = True
    ids = np.flatnonzero(tax.depth >= 1)
    u[:] = rng.choice(ids, size=(B + 1, K))
    one = np.flatnonzero(valid.sum(axis=1) == 1)
    u[one, valid[one].argmax(axis=1)] = np.resize(agg, B + 1)[one]
    c = rng.integers(1, 5, size=(B + 1, K)).astype(np.float32)
    ut, ct, full = (torch.from_numpy(x).to(dev) for x in (u, c, valid))
    # the same mask 8 bytes past a 16-byte boundary, and the next rows
    shifted = torch.empty(B * K + 8, dtype=torch.bool, device=dev)[8:]
    shifted = shifted.view(B, K)
    shifted.copy_(full[:B])
    assert shifted.data_ptr() % 16 == 8
    for rows, v in ((slice(0, B), full[:B]), (slice(0, B), shifted),
                    (slice(1, B + 1), full[1:])):
        uu, cc = ut[rows].contiguous(), ct[rows].contiguous()
        _k9_check(dtax, euler, uu, cc, v,
                  (None, snap, snap[:S // 2].contiguous()))
        got = prmq.rmq_aggregate("hybrid", dtax, euler, uu, cc, v, snap=snap)
        assert (got[~v.any(dim=1)] == 1).all()


def test_rmq_stages_launch_k9_once_a_batch(dev):
    """rmq/hybrid's and rmq/lca*'s batch: K4 with the bound, then one K9
    launch (the aggregate and its snap); no K5, no K6; taxa equal to the
    plain path's."""
    from umgap_tpu_torch.pipeline.fused import PipelineConfig, run_stages

    tax = _random_tree(3000, 4)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    euler = prmq.DeviceEuler.from_host(tax, dev)
    rng = np.random.default_rng(6)
    B, E, L = 64, 2, 100
    codes = rng.integers(0, 4, size=(B * E, L)).astype(np.uint8)
    lens = np.full((B, E), L, np.int32)
    hi, lo, wv, _ = translate.reads_to_kmers_plain(
        torch.from_numpy(codes), torch.from_numpy(lens.reshape(-1)), L,
        encoding.get_table(1), 9, packed=False)
    keys = ((hi.numpy().astype(np.uint64) << np.uint64(25))
            | lo.numpy().astype(np.uint64))
    per_read = rng.integers(2, 3001, size=(B * E, 1, 1)).astype(np.int32)
    keys, first = np.unique(keys[wv.numpy()], return_index=True)
    vals = np.broadcast_to(per_read, hi.shape)[wv.numpy()][first]
    dtable = lookup.DeviceTable.from_host(build_kmer_table(keys, vals, 9),
                                          dev)
    reads = torch.from_numpy(codes).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    for strategy in ("hybrid", "lca*"):
        cfg = PipelineConfig(f"rmq-{strategy}", method="rmq",
                             strategy=strategy, lower_bound=2.0)
        kernels.reset_launches()
        got = run_stages(reads, lt, L, False, dtax, dtable, cfg,
                         euler=euler)
        counts = kernels.launch_counts()
        assert counts["rmq_aggregate"] == counts["dedup_counts"] == 1, counts
        assert counts["tree_aggregate"] == counts["lane_gather"] == 0
        want = run_stages(reads, lt, L, False, dtax, dtable, cfg,
                          plain=True, euler=euler)
        assert torch.equal(got, want) and (got != 1).any()


def test_snap_wrappers_refuse_bad_inputs(dev):
    """A snap table, mask or table on the CPU beside CUDA tensors, or of
    the wrong type or shape, is refused by K6's and K9's wrappers: a
    CUDA tensor never reaches a plain version through a wrapper."""
    tax = _random_tree(300, 2)
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    euler = prmq.DeviceEuler.from_host(tax, dev)
    u, c, v = (torch.from_numpy(x).to(dev)
               for x in _k6_hits(tax, 40, 8, 1))
    cpu_snap = dtax.snap_valid.cpu()
    with pytest.raises(ValueError):
        pagg.tree_aggregate_hits("hybrid", dtax, u, c, v, snap=cpu_snap)
    with pytest.raises(ValueError):
        pagg.tree_aggregate_hits("lca*", dtax, u, c, v,
                                 snap=dtax.snap_valid.long())
    k9 = prmq.rmq_aggregate
    for strategy in ("lca*", "hybrid"):
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u, c, v, snap=cpu_snap)
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u, c, v.cpu(), snap=dtax.snap_valid)
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u[:-1], c, v)
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u, c, v, snap=dtax.snap_valid[:0])
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u, c, v, snap=dtax.snap_valid.long())
        with pytest.raises(ValueError):
            k9(strategy, dtax, euler, u[:, :0], c[:, :0], v[:, :0])
    with pytest.raises(ValueError):
        k9("lca*", dtax, None, u, c, v)
    with pytest.raises(ValueError):
        k9("hybrid", dtax, euler, u, None, v)
    with pytest.raises(ValueError):
        k9("hybrid", dtax, euler, u, c.double(), v)
    with pytest.raises(ValueError):
        k9("mrtl", dtax, euler, u, c, v)
    with pytest.raises(ValueError):
        k9("lca*", dtax, euler.to("cpu"), u, c, v)
    before = kernels.K9.launches
    assert torch.equal(k9("hybrid", dtax, euler, u, c, v,
                          snap=dtax.snap_valid),
                       prmq.rmq_aggregate_plain("hybrid", dtax, euler, u, c,
                                                v, snap=dtax.snap_valid))
    assert kernels.K9.launches == before + 1


def test_multihost_two_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks, each over (cuda:0, cuda:0): a four-device mesh
    across processes on the one card (the exchange staged through pinned
    host buffers). max-sensitivity and tryptic-sensitivity over 64 groups
    give taxa equal to the one-device step's plain versions, frequencies
    summing to 64; each rank launches K1, K2, K3, K4, K6 (9-mer) and K7,
    K8, K4, K6 (tryptic)."""
    import os
    import sys

    from umgap_tpu_torch.agg.device import DeviceTaxonomy
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.pipeline.fused import PRESETS, pipeline_step
    from umgap_tpu_torch.pipeline.tryptic import (
        TRYPTIC_PRESETS,
        tryptic_pipeline_step,
    )
    from umgap_tpu_torch.taxonomy import fixture_taxa

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_multihost import run_ranks

    rng = np.random.default_rng(21)
    tax = Taxonomy(fixture_taxa())
    ids = np.array([2, 10239, 12884, 185751, 185752], np.int32)
    n, L = 64, 100
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    lens = rng.integers(40, L + 1, size=(n, 2)).astype(np.int32)
    hi, lo, v, _ = translate.reads_to_kmers_plain(
        torch.from_numpy(codes.reshape(n * 2, L)), torch.from_numpy(
            lens.reshape(-1)), L, encoding.get_table(1), 9, packed=False)
    keys = np.unique(kmers.join_packed(hi[v].numpy(), lo[v].numpy()))[::3]
    keys = np.union1d(keys, rng.integers(0, 2 ** 45, size=2000,
                                         dtype=np.uint64))
    vals = rng.choice(ids, size=len(keys)).astype(np.int32)
    peps = sorted({f for i in range(n) for e in range(2)
                   for p in translate.translate_sequence(
                       encoding.decode_dna(codes[i, e, :lens[i, e]]),
                       translate.FRAME_NAMES, encoding.get_table(1))
                   for f in kmers.tryptic_digest(p) if 9 <= len(f) <= 45})
    pvals = rng.choice(ids, size=len(peps)).astype(np.int32)
    data = tmp_path / "world.npz"
    np.savez(data, packed=keys, values=vals, dna=codes, lengths=lens,
             peptides=np.array(peps), pvalues=pvals)
    got = run_ranks("step-cuda", 2, 2, data, tmp_path, groups=n)

    dtax = DeviceTaxonomy.from_host(tax, dev)
    dna, lt = torch.from_numpy(codes).to(dev), torch.from_numpy(lens).to(dev)
    with kernels.plain_versions():
        want = pipeline_step(dna, lt, dtax, lookup.DeviceTable.from_host(
            build_kmer_table(keys, vals, 9), dev),
            PRESETS["max-sensitivity"]._replace(k_max=32)).cpu().numpy()
        twant = tryptic_pipeline_step(
            dna, lt, dtax, lookup.DeviceTable.from_host(
                PeptideTable.build(peps, pvals), dev),
            TRYPTIC_PRESETS["tryptic-sensitivity"]._replace(
                k_max=16)).cpu().numpy()
    assert np.array_equal(got["taxa"], want) and (want != 1).sum() > 20
    assert np.array_equal(got["ttaxa"], twant) and (twant != 1).sum() > 5
    assert got["freq"].sum() == got["tfreq"].sum() == n
    for tag, names in (("", ("reads_to_kmers", "probe_kmer",
                             "seedextend_mask", "dedup_counts",
                             "tree_aggregate")),
                       ("t", ("reads_to_peptides", "probe_peptide",
                              "dedup_counts", "tree_aggregate"))):
        counts = {k: int(c) for k, c in got[tag + "launches"]}
        assert all(counts[k] > 0 for k in names), counts


SCORE_WEIGHTS = np.array([0.1, 0.3, 0.7, 1.1, 0.2, 2.5], np.float32)


def _ordered_counts(taxa, w):
    """Each row's {id: count} with a taxon's weights added in float32 in
    input order (agg::count's order)."""
    out = []
    for t, x in zip(taxa, w):
        c = {}
        for a, b in zip(t.tolist(), x.tolist()):
            if a > 0:
                c[a] = np.float32(c.get(a, np.float32(0)) + np.float32(b))
        out.append(c)
    return out


@pytest.mark.parametrize("N", [300, 540, 1003, 2048, 24576])
def test_dedup_kernel_weights_in_input_order(dev, N, monkeypatch):
    """K4 with non-dyadic weights (taxa2agg -s): each taxon's weights
    added in input order, on the warp path, scalar loads (N = 1,003),
    the row kernel, and its scratch rows (shared room cut to 8 KB), with
    few distinct ids a row so that runs are long; against both plain
    versions and a sequential sum on the host; the kept slots in
    first-seen order."""
    rng = np.random.default_rng(N)
    B = 40
    taxa = rng.integers(0, 7, size=(B, N)).astype(np.int32)
    taxa[1] = 3
    taxa[2, ::2] = 0
    w = rng.choice(SCORE_WEIGHTS, size=(B, N))
    want = _ordered_counts(taxa, w)
    t, x = torch.from_numpy(taxa).to(dev), torch.from_numpy(w).to(dev)
    for smem in (pagg.DEDUP_SMEM_MAX, 8192):
        monkeypatch.setattr(pagg, "DEDUP_SMEM_MAX", smem)
        got = pagg.dedup_counts(t, x, 8, True, lower_bound=2.0)
        _eq(got, pagg.dedup_counts_plain(t, x, 8, True, lower_bound=2.0))
        _eq(got, pagg.dedup_counts_rows_plain(t, x, 8, True,
                                              lower_bound=2.0))
        u, c, _v, _n = (a.cpu().numpy() for a in got)
        for b in range(B):
            assert {int(i): np.float32(v) for i, v in zip(u[b], c[b])
                    if i != pagg.I32_MAX} == want[b]
            # the kept ids (the 8 smallest) in first-seen order
            kept = sorted(want[b])[:8]
            assert [int(i) for i in u[b] if i != pagg.I32_MAX] == [
                t for t in want[b] if t in kept]


@pytest.mark.parametrize("N", [25, 45, 52, 96, 97, 128, 129, 132, 160, 420,
                               4000])
def test_seedextend_scored_mask_kernel(dev, N):
    """K3's scored entries with the mask epilogue (``seedextend -r``):
    the keep mask against the plain version and the row formulation,
    one launch of the entry the width takes, and the hits entry equal to
    the taxa where the mask keeps."""
    rng = np.random.default_rng(N + 7)
    taxa, lens = _scored_lanes(rng, 301, N)
    tx, ln = torch.from_numpy(taxa).to(dev), torch.from_numpy(lens).to(dev)
    sc = torch.from_numpy(SEED_SCORES).to(dev)
    k = (kernels.K3S if seedextend.seedextend_path(N) == "staged"
         else kernels.K3RS)
    for s, g, penalty in ((2, 0, 5), (3, 1, 0), (1, 2, 9)):
        before = k.launches
        keep = seedextend.seedextend_mask_batch(tx, ln, s, g, seed_scores=sc,
                                                penalty=penalty)
        assert k.launches == before + 1 and keep.dtype == torch.bool
        _eq((keep,), (seedextend.seedextend_scored_mask_plain(
            tx, ln, sc, penalty, s, g),))
        _eq((keep,), (seedextend.seedextend_scored_runs_plain(
            tx, ln, sc, penalty, s, g, hits=False),))
        hits = seedextend.seedextend_hits(tx, ln, s, g, seed_scores=sc,
                                          penalty=penalty)
        _eq((hits,), (torch.where(keep, tx, 0),))


def _ordered_hits(tax, B, K, seed):
    """Filtered hit lists as K4 hands them over for taxa2agg -s: distinct
    ids, in first-seen order (every other group shuffled; drawn from a
    few lineages while they last, so that
    branch and ancestry sums meet), counts that are a few non-dyadic
    weights added in float32; groups of 1-5 (the walk in registers and
    the thread path), 16-17, K and a random count of valid slots, every
    third with slots filtered out."""
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(tax.depth >= 1)
    leaves = rng.choice(ids, size=min(len(ids), 12), replace=False)
    lineage = np.unique(tax.anc_table[leaves][tax.anc_table[leaves] > 0])
    u = np.full((B, K), np.iinfo(np.int32).max, np.int32)
    c = np.zeros((B, K), np.float32)
    v = np.zeros((B, K), bool)
    for b in range(B):
        m = min(K, (1, 2, 3, 4, 5, 16, 17, K, int(rng.integers(1, K + 1)))[
            b % 9])
        pool = lineage if m <= len(lineage) else ids
        sel = np.sort(rng.choice(pool, size=min(m, len(pool)), replace=False))
        if b % 2:  # first-seen order, as K4's weighted slots come
            rng.shuffle(sel)
        u[b, :len(sel)] = sel
        for e in range(len(sel)):
            acc = np.float32(0)
            for x in rng.choice(SCORE_WEIGHTS, size=int(rng.integers(1, 4))):
                acc = np.float32(acc + x)
            c[b, e] = acc
        v[b, :len(sel)] = True
        if b % 3 == 2:
            v[b] &= rng.random(K) < 0.7
    return u, c, v


@pytest.mark.parametrize("K,B", [(64, 900), (648, 72), (2000, 36)])
@pytest.mark.parametrize("strategy", ["hybrid", "mrtl"])
def test_tree_aggregate_ordered_matches_plain(dev, strategy, K, B):
    """K6's ordered instances (``ordered=True``, taxa2agg -s) on
    non-dyadic counts, whose sums across taxa round by the order of
    their adds: every path (hybrid's walk in registers, the thread path,
    the warp path, the block path and its first thread's walk) equal to
    the plain version, which adds in the same order, with and without
    the snap; one launch a call."""
    tax = _bench_tree()
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    u, c, v = (torch.from_numpy(x).to(dev)
               for x in _ordered_hits(tax, B, K, K + B))
    assert not pagg.exact_sums(c)
    for factor in (0.25, 0.5, 0.7, 1.0) if strategy == "hybrid" else (0.25,):
        for snap in (None, dtax.snap_ranked):
            before = kernels.K6.launches
            got = pagg.tree_aggregate_hits(strategy, dtax, u, c, v, factor,
                                           snap, ordered=True)
            assert kernels.K6.launches == before + 1
            want = pagg.tree_aggregate_hits_plain(strategy, dtax, u, c, v,
                                                  factor, snap)
            assert torch.equal(got, want), (factor, int((got != want).sum()))


def test_rmq_mix_ordered_on_the_card_equals_the_cpu(dev):
    """The Euler/RMQ hybrid with ``ordered=True`` on non-dyadic counts:
    its sums are elementwise adds in slot order, which round alike on
    the card and the CPU, through K5, through its plain version and
    through K9."""
    tax = _bench_tree()
    B, K = 300, 48
    u, c, v = _ordered_hits(tax, B, K, 5)
    cpu = pagg.DeviceTaxonomy.from_host(tax, "cpu")
    dtax = pagg.DeviceTaxonomy.from_host(tax, dev)
    ut, ct, vt = (torch.from_numpy(x) for x in (u, c, v))
    for factor in (0.25, 0.6):
        want = prmq.rmq_mix_batch(cpu, ut, ct, vt, factor, ordered=True)
        args = (dtax, ut.to(dev), ct.to(dev), vt.to(dev), factor)
        before = kernels.K5.launches
        got = prmq.rmq_mix_batch(*args, ordered=True)
        assert kernels.K5.launches > before
        assert torch.equal(got.cpu(), want)
        with kernels.plain_versions():
            assert torch.equal(prmq.rmq_mix_batch(*args, ordered=True).cpu(),
                               want)
        # K9 adds in slot order, the order of the plain version's folds
        before = kernels.K9.launches
        got = prmq.rmq_aggregate("hybrid", dtax, None, *args[1:4], factor,
                                 ordered=True)
        assert kernels.K9.launches == before + 1
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("method,strategy", [
    ("tree", "hybrid"), ("tree", "lca*"), ("rmq", "mrtl"), ("rmq", "lca*"),
    ("rmq", "hybrid")])
def test_taxa2agg_scored_on_the_card_equals_the_cpu(dev, tmp_path, method,
                                                    strategy):
    """``taxa2agg -s`` with non-dyadic scores on the card writes the
    bytes of ``--device cpu``: narrow rows and rows past 64 distinct taxa
    and 1,024 entries (K4's row kernel, the wide pass), with -r, -l and
    -f; K4 and K6 (or K9) launched."""
    import contextlib
    import io
    import os

    from umgap_tpu_torch.cli import main

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".bench_data")
    parent = np.fromfile(os.path.join(data, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(data, "snap.bin"), np.int32)
    tsv = str(tmp_path / "t.tsv")
    with open(tsv, "w") as f:
        for i in range(1, len(parent)):
            f.write(f"{i}\tt{i}\t{'no rank' if i % 3 else 'species'}\t"
                    f"{int(parent[i])}\t{chr(1) if snap[i] == i else chr(0)}"
                    "\n")
    tax = _bench_tree()
    rng = np.random.default_rng(17)
    ids = np.flatnonzero(tax.depth >= 1)
    leaves = rng.choice(ids, size=40, replace=False)
    pool = np.unique(tax.anc_table[leaves][tax.anc_table[leaves] > 0])
    wide_pool = rng.choice(ids, size=300, replace=False)
    recs = {"narrow": [], "wide": []}
    for i in range(700):
        n, src = ((1100 + i % 300, wide_pool) if i % 97 == 0
                  else (i % 60, pool))
        rec = f">r{i}\n" + "".join(
            f"{int(t)}={w}\n" for t, w in zip(
                rng.choice(src, size=n), rng.choice(SCORE_WEIGHTS, size=n)))
        recs["wide"].append(rec)
        if i % 97:
            recs["narrow"].append(rec)
    want = (("rmq_aggregate",) if (method, strategy) in (
        ("rmq", "lca*"), ("rmq", "hybrid")) else ("tree_aggregate",))
    for kind, rows in recs.items():
        # a chunk's width picks K4's entry: the warp path, the row kernel
        k4 = "dedup_counts" if kind == "narrow" else "dedup_rows"
        for flags in (["-s", "-r", "-l", "0.7"], ["-s", "-f", "0.3"]):
            argv = ["taxa2agg", "-m", method, "-a", strategy, *flags, tsv]
            outs = []
            for extra in ([], ["--device", "cpu"]):
                kernels.reset_launches()
                o, e = io.StringIO(), io.StringIO()
                with contextlib.redirect_stderr(e):
                    rc = main(argv + extra, stdin=io.StringIO("".join(rows)),
                              stdout=o)
                outs.append((rc, o.getvalue(), e.getvalue()))
                if not extra:
                    lc = kernels.launch_counts()
            assert outs[0] == outs[1] and outs[0][0] == 0, (kind, flags)
            assert outs[0][1].count(">") == len(rows)
            assert all(lc[k] > 0 for k in (k4, *want)), (kind, lc)
