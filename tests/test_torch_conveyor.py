"""The port's conveyor build (``umgap_tpu_torch.index.table``) against
``umgap_tpu.index.table``: the placement itself (its vectorised path and
the sequential sweep), ``KmerTable.build`` with the defaults array by
array, and K2's plain probe over such a table against the JAX package's
host probe. Exact equality."""

import numpy as np
import pytest
import torch

from umgap_tpu.index import table as jtable
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import lookup as plookup


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2 ** 45, size=n + n // 50 + 100,
                                  dtype=np.uint64))[:n]
    rng.shuffle(keys)
    vals = rng.integers(1, 1 << 20, size=n).astype(np.int32)
    return keys, vals


def _payloads(n, seed):
    rng = np.random.default_rng(seed)
    rem = rng.integers(0, 1 << 30, size=n).astype(np.int32)
    val = rng.integers(1, 1 << 20, size=n).astype(np.int32)
    return [rem, val]


def _same(got, want):
    (gouts, gmp, gstash), (wouts, wmp, wstash) = got, want
    assert gmp == wmp
    np.testing.assert_array_equal(gstash, wstash)
    assert len(gouts) == len(wouts)
    for g, w in zip(gouts, wouts):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bucket", [16, 64])
@pytest.mark.parametrize("load", [0.5, 0.7, 0.8, 0.9])
def test_insert_conveyor_matches_jax(bucket, load):
    nb = 1 << 10
    cap = nb * bucket
    n = int(cap * load)
    rng = np.random.default_rng(int(load * 100) + bucket)
    bucket0 = rng.integers(0, nb, size=n).astype(np.int64)
    payloads = _payloads(n, bucket)
    got = ptable._insert_conveyor(bucket0, payloads, cap, bucket=bucket)
    want = jtable._insert_conveyor(bucket0, payloads, cap, bucket=bucket,
                                   use_native=False)
    _same(got, want)
    if load >= 0.8:
        assert got[1] == 1  # keys were carried into the next bucket


@pytest.mark.parametrize("bucket", [16, 64])
@pytest.mark.parametrize("hot", [0, 7, 1023])
def test_insert_conveyor_slow_path_matches_jax(bucket, hot):
    """A bucket whose carry exceeds a whole bucket sends the placement
    through the sequential sweep (``_insert_conveyor_slow``), the wrap
    from the last bucket to bucket 0 included (``hot`` = 1023)."""
    nb = 1 << 10
    cap = nb * bucket
    rng = np.random.default_rng(hot + bucket)
    n = int(cap * 0.6)
    bucket0 = rng.integers(0, nb, size=n).astype(np.int64)
    bucket0[: 4 * bucket] = hot  # one bucket far over its size
    payloads = _payloads(n, hot)
    cnt = np.bincount(bucket0, minlength=nb) - bucket
    s = np.cumsum(cnt)
    carry = np.maximum(s - np.minimum(np.minimum.accumulate(s), 0), 0)
    assert carry.max() > bucket  # the slow path's trigger
    got = ptable._insert_conveyor(bucket0, payloads, cap, bucket=bucket)
    want = jtable._insert_conveyor(bucket0, payloads, cap, bucket=bucket,
                                   use_native=False)
    _same(got, want)
    assert len(got[2]) > 0  # the hot bucket overflowed into the stash
    # the sweep on its own, as both packages call it
    outs = [np.full(cap, ptable.EMPTY, np.int32), np.zeros(cap, np.int32)]
    jouts = [o.copy() for o in outs]
    _same(ptable._insert_conveyor_slow(bucket0, payloads, cap, bucket,
                                       outs),
          jtable._insert_conveyor_slow(bucket0, payloads, cap, bucket,
                                       jouts))


def _assert_same_table(pt, jt):
    np.testing.assert_array_equal(pt.rem, jt.rem)
    np.testing.assert_array_equal(pt.values, jt.values)
    np.testing.assert_array_equal(pt.stash_hi, jt.stash_hi)
    np.testing.assert_array_equal(pt.stash_lo, jt.stash_lo)
    np.testing.assert_array_equal(pt.stash_val, jt.stash_val)
    assert pt.max_probes == jt.max_probes
    assert pt.capacity == jt.capacity
    assert pt.n == jt.n
    assert pt.meta == jt.meta


@pytest.mark.parametrize("n", [5_000, 200_000])
def test_kmer_table_build_defaults_match_jax(n):
    """The same call, ``KmerTable.build(packed, values, k=9)``, builds the
    same table in both packages: the JAX package's default is the dense
    conveyor (``max_probe_limit=1``)."""
    keys, vals = _keys(n, n)
    jt = jtable.KmerTable.build(keys, vals, k=9)
    pt = ptable.KmerTable.build(keys, vals, k=9)
    _assert_same_table(pt, jt)
    if n == 200_000:  # dense enough that keys were carried
        assert pt.max_probes == 1 and pt.capacity == 524_288


@pytest.mark.parametrize("bucket,load", [(8, 0.45), (16, 0.8), (64, 0.9)])
def test_kmer_table_build_conveyor_layouts_match_jax(bucket, load):
    keys, vals = _keys(60_000, bucket)
    jt = jtable.KmerTable.build(keys, vals, 9, load_factor=load,
                                bucket=bucket)
    pt = ptable.KmerTable.build(keys, vals, 9, load_factor=load,
                                bucket=bucket)
    _assert_same_table(pt, jt)


@pytest.mark.parametrize("bucket", [8, 16])
def test_probe_plain_over_conveyor_table_matches_jax(bucket):
    """K2's plain version over the port's own conveyor table gives the
    JAX package's host probe of its table: hits, misses and stashed
    keys."""
    keys, vals = _keys(150_000, 7 + bucket)
    jt = jtable.KmerTable.build(keys, vals, 9, bucket=bucket,
                                capacity=bucket << 15, stash_cap=4096)
    pt = ptable.KmerTable.build(keys, vals, 9, bucket=bucket,
                                capacity=bucket << 15, stash_cap=4096)
    _assert_same_table(pt, jt)
    assert pt.max_probes == 1
    rng = np.random.default_rng(bucket)
    nq = 20_000
    q = np.concatenate([rng.choice(keys, size=nq // 2),
                        rng.integers(0, 2 ** 45, size=nq - nq // 2,
                                     dtype=np.uint64)])
    if len(pt.stash_hi):
        stash = jkmers.join_packed(pt.stash_hi, pt.stash_lo)
        q[:100] = rng.choice(stash, size=100)
    hi, lo = jkmers.split_packed(q)
    want_v, want_f = jt.probe_host(hi, lo, default=0)
    dt = plookup.DeviceTable.from_host(pt, device="cpu")
    got_v, got_f = plookup.probe_plain(dt, torch.from_numpy(hi),
                                       torch.from_numpy(lo))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    assert want_f.sum() > nq // 3
