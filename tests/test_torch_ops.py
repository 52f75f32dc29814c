"""Parity of the port's device ops (plain PyTorch on the CPU) with the
JAX package: hashing, reads to k-mer keys (K1's plain version), the
index probe (K2's) and seed-extend (K3's). Integer outputs: every
comparison is exact equality."""

import numpy as np
import pytest
import torch

from umgap_tpu.index import table as jtable
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.ops import seedextend as jseed
from umgap_tpu.ops import translate as jtrans
from umgap_tpu_torch import convert
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding as penc
from umgap_tpu_torch.ops import lookup as plookup
from umgap_tpu_torch.ops import seedextend as pseed
from umgap_tpu_torch.ops import translate as ptrans


def test_mix_key_and_hash32_bit_exact():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 45, size=100_000, dtype=np.uint64)
    hi, lo = jkmers.split_packed(keys)
    jh, jl = jtable.mix_key(hi, lo)
    ph, pl = ptable.mix_key(hi, lo)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pl, jl)
    th, tl = plookup.mix_key_torch(torch.from_numpy(hi), torch.from_numpy(lo))
    np.testing.assert_array_equal(th.numpy(), jh.astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), jl.astype(np.int64))
    # hash32 over arbitrary int32 lanes (negative values included)
    a = rng.integers(-2 ** 31, 2 ** 31, size=100_000).astype(np.int32)
    b = rng.integers(-2 ** 31, 2 ** 31, size=100_000).astype(np.int32)
    want = jtable.hash32(a, b)
    np.testing.assert_array_equal(ptable.hash32(a, b), want)


def _random_reads(rng, n, L):
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    codes[rng.random((n, L)) < 0.04] = 4  # N codes
    lens = rng.integers(0, L + 1, size=n).astype(np.int32)
    lens[: n // 4] = rng.integers(0, 27, size=n // 4)  # shorter than 27
    lens[n // 4: n // 2] |= 1  # odd lengths
    lens = np.minimum(lens, L)
    return codes, lens


@pytest.mark.parametrize("table_no,L,methionine",
                         [(1, 61, False), (4, 48, True), (11, 100, False),
                          (1, 20, False), (1, 160, False), (1, 161, True)])
def test_reads_to_kmers_matches_jax(table_no, L, methionine):
    rng = np.random.default_rng(table_no * 1000 + L)
    codes, lens = _random_reads(rng, 96, L)
    jt = jenc.get_table(table_no)
    aa, plens = jtrans.translate6_batch(codes, lens, jt, methionine)
    whi, wlo, wvalid = jkmers.pack_windows_batch(aa, plens, 9)
    pt = penc.get_table(table_no)

    # the wire: the port's unpack inverts the shared 4-bit packing
    packed = penc.pack_dna4(codes)
    np.testing.assert_array_equal(packed, jenc.pack_dna4(codes))
    np.testing.assert_array_equal(
        ptrans.unpack_dna4(torch.from_numpy(packed), L).numpy(),
        np.asarray(jenc.unpack_dna4_device(packed, L)))

    paa, pplens = ptrans.translate6_batch(torch.from_numpy(codes),
                                          torch.from_numpy(lens), pt,
                                          methionine)
    np.testing.assert_array_equal(paa.numpy(), np.asarray(aa))
    np.testing.assert_array_equal(pplens.numpy(), np.asarray(plens))
    for wire, src in (("packed4", packed), ("codes", codes)):
        hi, lo, valid, pl = ptrans.reads_to_kmers(
            torch.from_numpy(src), torch.from_numpy(lens), L, pt, 9,
            packed=wire == "packed4", methionine=methionine)
        np.testing.assert_array_equal(hi.numpy(), np.asarray(whi))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(wlo))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
        np.testing.assert_array_equal(pl.numpy(), np.asarray(plens))


def _port_table(jt):
    """The JAX package's device table leaves, carried across."""
    dt = jlookup.DeviceTable.from_host(jt)
    return convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu"), dt


def _layout_table(layout, keys, vals):
    if layout == "stash":  # tight single-round table: many stashed keys
        return jtable.KmerTable.build(keys, vals, 9, capacity=8 << 15,
                                      bucket=8, max_probe_limit=0,
                                      stash_cap=4096)
    if layout == "probes1":  # the dense two-round (conveyor) build
        return jtable.KmerTable.build(keys, vals, 9, capacity=8 << 15,
                                      bucket=8, max_probe_limit=1)
    return jtable.build_kmer_table(keys, vals, 9, layout=layout)


@pytest.mark.parametrize("layout", ["bucket8s", "bucket16", "bucket64s",
                                    "stash", "probes1"])
def test_probe_matches_jax(layout):
    rng = np.random.default_rng(42)
    n = 150_000 if layout in ("stash", "probes1") else 20_000
    keys = np.unique(rng.integers(0, 2 ** 45, size=n + 1000,
                                  dtype=np.uint64))[:n]
    rng.shuffle(keys)
    vals = rng.integers(1, 1 << 20, size=n).astype(np.int32)
    jt = _layout_table(layout, keys, vals)
    if layout == "stash":
        assert len(jt.stash_hi) > 100
    if layout == "probes1":
        assert jt.max_probes == 1
    pt, dt = _port_table(jt)

    nq = 30_000
    q = np.concatenate([rng.choice(keys, size=nq // 2),
                        rng.integers(0, 2 ** 45, size=nq - nq // 2,
                                     dtype=np.uint64)])
    if len(jt.stash_hi):
        stash = jkmers.join_packed(jt.stash_hi, jt.stash_lo)
        q[: nq // 10] = rng.choice(stash, size=nq // 10)
    hi, lo = jkmers.split_packed(q)
    valid = rng.random(nq) < 0.9
    want_v, want_f = jlookup.probe(dt, hi, lo, valid=valid, default=-3)
    got_v, got_f = plookup.probe(pt, torch.from_numpy(hi),
                                 torch.from_numpy(lo),
                                 torch.from_numpy(valid), -3)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f.numpy().sum() > nq // 3


@pytest.mark.parametrize("layout", ["bucket8s", "bucket16", "bucket64s"])
def test_port_build_is_slot_identical(layout, tmp_path):
    """The port's index build lays out the same rows and stash as the JAX
    package's, and both read each other's artifacts."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 2 ** 45, size=30_000,
                                  dtype=np.uint64))[:25_000]
    vals = rng.integers(1, 5000, size=len(keys)).astype(np.int32)
    jt = jtable.build_kmer_table(keys, vals, 9, layout=layout)
    pt = ptable.build_kmer_table(keys, vals, 9, layout=layout)
    np.testing.assert_array_equal(pt.packed_rows(), jlookup.pack_rows(jt))
    assert pt.max_probes == jt.max_probes and pt.meta == jt.meta
    np.testing.assert_array_equal(pt.stash_hi, jt.stash_hi)
    np.testing.assert_array_equal(pt.stash_val, jt.stash_val)
    for packed in (False, True):
        path = tmp_path / f"t{int(packed)}.npz"
        pt.save(path, packed=packed)
        back = jtable.load_table(path)
        np.testing.assert_array_equal(jlookup.pack_rows(back),
                                      jlookup.pack_rows(jt))
        jpath = tmp_path / f"j{int(packed)}.npz"
        jt.save(jpath, packed=packed)
        for mmap in (False, True):
            mine = ptable.load_table(jpath, mmap=mmap)
            np.testing.assert_array_equal(mine.packed_rows(),
                                          pt.packed_rows())
            np.testing.assert_array_equal(mine.stash_lo, pt.stash_lo)


def _runs(rng, lanes, N):
    t = rng.choice(np.array([0, 0, 0, 5, 6, 7], np.int32), size=(lanes, N))
    rep = rng.random((lanes, N)) < 0.6
    for j in range(1, N):
        t[:, j] = np.where(rep[:, j], t[:, j - 1], t[:, j])
    return t


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [0, 1, 2])
def test_seedextend_matches_jax_and_host(s, g):
    rng = np.random.default_rng(10 * s + g)
    lanes, N = 400, 30
    taxa = _runs(rng, lanes, N)
    lens = rng.integers(0, N + 1, size=lanes).astype(np.int32)
    want = np.asarray(jseed.seedextend_mask_batch(taxa, lens, s, g))
    got = pseed.seedextend_mask_batch(torch.from_numpy(taxa),
                                      torch.from_numpy(lens), s, g).numpy()
    np.testing.assert_array_equal(got, want)
    for i in range(0, lanes, 7):  # the reference state machine, per lane
        ref = np.zeros(N, bool)
        for a, b in jseed.seedextend_host(taxa[i, : lens[i]], s, g):
            ref[a:min(b, lens[i])] = True
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("g", [0, 1, 2])
def test_seedextend_hits_matches_jax(s, g):
    """The hits entry equals the JAX program's select over its keep mask
    (umgap_tpu/pipeline/fused.py: jnp.where(keep, taxa, 0)), lengths 0
    and N and all-zero lanes included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(100 + 10 * s + g)
    lanes, N = 300, 45
    taxa = _runs(rng, lanes, N)
    taxa[:20] = 0
    lens = rng.integers(0, N + 1, size=lanes).astype(np.int32)
    lens[20:30], lens[30:40] = 0, N
    want = np.asarray(jnp.where(
        jseed.seedextend_mask_batch(taxa, lens, s, g), taxa, 0))
    got = pseed.seedextend_hits(torch.from_numpy(taxa),
                                torch.from_numpy(lens), s, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_seedextend_path():
    """K3's kernel by row width: the main widths (25, 45) and rows up to
    96 windows take the staged tile, every wider row the row kernel (one
    warp a lane; no width is refused)."""
    assert [pseed.seedextend_path(n) for n in (1, 25, 45, 96, 97, 3600)] \
        == ["staged"] * 4 + ["rows"] * 2
    assert pseed.seedextend_path(3601) == "rows"
    assert pseed.seedextend_path(6661) == "rows"


def test_scored_lane_threads():
    """K3RS's threads a lane by row width (past the staged tile's 96
    windows, where the scored staged tile took longer on the H100): 16
    on the short rows, a warp from 512 windows."""
    assert [pseed.seedextend_path(n) for n in (96, 97)] == ["staged", "rows"]
    assert [pseed.scored_lane_threads(n) for n in (97, 132, 333, 511)] \
        == [16] * 4
    assert [pseed.scored_lane_threads(n) for n in (512, 3992)] == [32] * 2
