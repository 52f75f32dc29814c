"""The port's mesh of several devices against ``umgap_tpu``'s over its 8
virtual CPU devices: ``KmerTable.items``, the routing (each query to the
device that owns its key and back) against ``sharded_probe_local`` and
the host probe, the plain versions of K2's slice entry and K8's grouped
entry against ``umgap_tpu``'s probe with ``sub``, the 9-mer and tryptic
sharded steps (taxa, rank frequencies, overflow flags),
``ShardedAnalyser`` with its overflow re-run, the stream analyser, the
mesh's rank counts, and ``analyse --mesh N`` / ``--shards DIR --mesh N``
through the command line with ``--device cpu`` (the port's mesh is N
entries of the CPU). Every output is integers: equality is exact."""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from umgap_tpu import ranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.agg import device_rmq as jrmq
from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index import distbuild as jdist
from umgap_tpu.index import table as jtable
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.parallel import freq as jfreq
from umgap_tpu.parallel import make_mesh as jmake_mesh
from umgap_tpu.parallel import sharded as jsharded
from umgap_tpu.pipeline.fused import PRESETS as JPRESETS
from umgap_tpu.pipeline.tryptic import TRYPTIC_PRESETS as JTRYPTIC
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.agg.device_rmq import DeviceEuler
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding, kmers, lookup, translate
from umgap_tpu_torch.parallel import freq as pfreq
from umgap_tpu_torch.parallel import make_mesh
from umgap_tpu_torch.parallel import sharded as psharded
from umgap_tpu_torch.pipeline.fused import PRESETS
from umgap_tpu_torch.pipeline.runner import Analyser
from umgap_tpu_torch.pipeline.tryptic import TRYPTIC_PRESETS
from umgap_tpu_torch.taxonomy import Taxonomy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 64
N_READS = 64
IDS = [2, 10239, 12884, 185751, 185752, 1, 10, 11]
ALL_PRESETS = list(PRESETS) + list(TRYPTIC_PRESETS)


def _split(keys):
    return kmers.split_packed(np.asarray(keys, np.uint64))


def _port_kmer(t):
    """umgap_tpu's k-mer table as the port's (the same rows and stash)."""
    return ptable.KmerTable(
        None, None, t.max_probes, t.n, dict(t.meta), t.stash_hi, t.stash_lo,
        t.stash_val, rows_packed=np.asarray(jlookup.pack_rows(t)))


def _port_peptide(t):
    return ptable.PeptideTable(t.key_hi, t.key_lo, t.values, t.max_probes,
                               t.n)


def _peptide_shards(peps, vals, n):
    """umgap_tpu's ``n`` peptide shards, their probe depth stamped to the
    deepest (the shards of one table share one geometry)."""
    shards = jsharded.build_sharded_peptide_tables(peps, vals, n)
    depth = max(t.max_probes for t in shards)
    for t in shards:
        t.max_probes = depth
    return shards


# ---------------------------------------------------------------------- #
# The mesh and KmerTable.items
# ---------------------------------------------------------------------- #

def test_make_mesh_cpu_and_given_devices():
    cpu = torch.device("cpu")
    assert make_mesh(4, "cpu") == (cpu,) * 4
    assert make_mesh("auto", "cpu") == make_mesh(None, "cpu") == (cpu,)
    assert make_mesh(1, "cpu") == (cpu,)
    assert make_mesh(devices=["cpu"] * 3) == (cpu,) * 3
    with pytest.raises(ValueError, match="need at least one device"):
        make_mesh(0, "cpu")


def test_make_mesh_cuda_refused_past_device_count(monkeypatch):
    """On CUDA the mesh is cuda:0..N-1, auto every card, and N past the
    cards is refused with umgap_tpu's message (never emulated)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert make_mesh(2, "cuda") == make_mesh("auto", None) == tuple(cuda)
    assert make_mesh(1, None) == (cuda[0],)
    with pytest.raises(ValueError) as e:
        make_mesh(3, None)
    with pytest.raises(ValueError) as w:
        jmake_mesh(9)
    assert str(e.value) == "need 3 devices, have 2"
    assert str(w.value) == "need 9 devices, have 8"


def _crowded_keys(rng, n_shards, bucket, n_spread=3000):
    """Keys of ``n_shards`` owners crowded into the first 8 home buckets
    of a minimum-size table (so that they overflow to the stash) and
    keys spread over it."""
    nb_bits = jtable.MIN_NB_BITS
    n_crowd = n_shards * 8 * bucket * 3
    mlo = ((rng.integers(0, 1 << (25 - nb_bits), size=n_crowd,
                         dtype=np.uint32) << np.uint32(nb_bits))
           | rng.integers(0, 8, size=n_crowd, dtype=np.uint32))
    mhi = rng.integers(0, 1 << 20, size=n_crowd, dtype=np.uint32)
    hi, lo = jtable.unmix_key(mhi, mlo)
    crowd = (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)
    return np.unique(np.concatenate([
        crowd, rng.integers(0, 2 ** 45, size=n_shards * n_spread,
                            dtype=np.uint64)]))


@pytest.mark.parametrize("layout,bucket,probes", [
    ("bucket8s", 8, 0), ("bucket16", 16, 1), ("bucket64s", 64, 0)])
def test_items_match_jax(layout, bucket, probes):
    """The port's KmerTable.items (slot order, stash last) and its
    bucket_range form give umgap_tpu's pairs, on tables with a stash,
    flat and packed."""
    rng = np.random.default_rng(bucket)
    keys = _crowded_keys(rng, 1, bucket, 20000)
    vals = rng.integers(1, 10 ** 6, size=len(keys)).astype(np.int32)
    jt = jtable.KmerTable.build(keys, vals, 9, capacity=bucket << 15,
                                bucket=bucket, max_probe_limit=probes,
                                stash_cap=1 << 20)
    assert len(jt.stash_hi) > 0
    flat = ptable.KmerTable(jt.rem, jt.values, jt.max_probes, jt.n,
                            dict(jt.meta), jt.stash_hi, jt.stash_lo,
                            jt.stash_val)
    for pt in (flat, _port_kmer(jt)):
        for rng_ in (None, (0, 5), (100, 4000), (jt.n_buckets - 3,
                                                 jt.n_buckets)):
            got, want = pt.items(rng_), jt.items(rng_)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])
    packed, values = flat.items()
    order = np.argsort(packed)
    assert np.array_equal(packed[order], keys)
    assert np.array_equal(values[order], vals)
    assert np.array_equal(ptable.unmix_key(*ptable.mix_key(*_split(keys)))[
        0], _split(keys)[0].astype(np.uint32))


# ---------------------------------------------------------------------- #
# The routing and the grouped probes
# ---------------------------------------------------------------------- #

def _jax_routed(jst, mesh, hi, lo, valid):
    """umgap_tpu's sharded_probe_local under shard_map over ``mesh``."""
    from jax import shard_map

    def local(h, lo_, v, rows, stash):
        return jsharded.sharded_probe_local(
            h, lo_, v, rows[0], jst.max_probes, "x", default=0,
            kind=jst.kind, nb_bits=jst.nb_bits, bucket=jst.bucket,
            shard_stash=stash[0], group=jst.group)

    fn = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P("x"),) * 3 + (P("x", None, None),) * 2,
        out_specs=(P("x"), P("x")), check_vma=False))
    out, found = fn(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
                    jst.rows, jst.stash)
    return np.asarray(out), np.asarray(found)


def _port_routed(stable, hi, lo, valid):
    n = stable.n_devices

    def cut(a):
        return list(torch.from_numpy(a).reshape(n, -1))

    out = torch.cat(psharded.sharded_probe(stable, cut(hi), cut(lo),
                                           cut(valid))).numpy()
    # every value is a taxon id of 1 or more: 0 reads as not found
    return out, (out != 0) & valid


def _kmer_case(n_dev, group, seed):
    """umgap_tpu's shards of crowded and spread keys (stashes on every
    device), and queries: present keys (a third skewed onto device 0's
    owner range), stash keys, absent keys, a tenth invalid."""
    rng = np.random.default_rng(seed)
    n = n_dev * group
    keys = _crowded_keys(rng, n, 16, 400)
    vals = rng.integers(1, 10 ** 6, size=len(keys)).astype(np.int32)
    shards = jsharded.build_sharded_tables(keys, vals, 9, n,
                                           layout="bucket16")
    stash = np.concatenate([kmers.join_packed(t.stash_hi, t.stash_lo)
                            for t in shards])
    own = jsharded.owner_of(*_split(keys), n_dev)
    skew = keys[own == 0]
    q = np.concatenate([rng.choice(keys, 1500), rng.choice(skew, 800),
                        stash[:600], rng.integers(0, 2 ** 45, size=700,
                                                  dtype=np.uint64)])
    q = q[rng.permutation(len(q))][:len(q) // n_dev * n_dev]
    hi, lo = _split(q)
    valid = rng.random(len(q)) < 0.9
    return shards, keys, vals, hi, lo, valid, len(stash)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_routing_matches_jax(n_dev, group):
    """The routed probe over an N-device mesh (N entries of the CPU, and
    the JAX package's N virtual devices) of ``group`` shards a device:
    values and found flags equal sharded_probe_local's and, for every
    valid query, the host probe of its owner shard; stash keys found on
    whichever device holds their shard; invalid queries read 0."""
    shards, keys, vals, hi, lo, valid, n_stash = _kmer_case(
        n_dev, group, n_dev * 10 + group)
    assert n_stash > 0
    mesh = jmake_mesh(n_dev)
    jst = jsharded.ShardedTable.from_shards(shards, mesh)
    want = _jax_routed(jst, mesh, hi, lo, valid)
    stable = psharded.ShardedTable.from_shards(
        [_port_kmer(t) for t in shards], make_mesh(n_dev, "cpu"))
    assert stable.n_devices == n_dev and stable.group == group
    assert [t.first for t in stable.tables] == list(range(0, n_dev * group,
                                                          group))
    got = _port_routed(stable, hi, lo, valid)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    own = jsharded.owner_of(hi, lo, n_dev * group)
    host = np.zeros(len(hi), np.int32)
    hfound = np.zeros(len(hi), bool)
    for s, t in enumerate(shards):
        m = own == s
        host[m], hfound[m] = t.probe_host(hi[m], lo[m])
    assert np.array_equal(got[1], hfound & valid)
    assert np.array_equal(got[0], np.where(valid, host, 0))
    assert (~valid & (got[0] != 0)).sum() == 0 and got[1].sum() > 2000


@pytest.mark.parametrize("n_dev,group", [(2, 2), (4, 1), (8, 2)])
def test_routing_peptides_matches_jax(n_dev, group):
    """The routing of peptide fingerprints (the swapped lanes' owner) to
    K8's grouped entry's plain version, against sharded_probe_local."""
    rng = np.random.default_rng(n_dev + group)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(aa, rng.integers(9, 30)))
                   for _ in range(4000)})
    vals = rng.integers(1, 100, size=len(peps)).astype(np.int32)
    shards = _peptide_shards(peps, vals, n_dev * group)
    hi, lo = jtable._fingerprints(peps + ["".join(rng.choice(aa, 12))
                                          for _ in range(1000)])
    order = rng.permutation(len(hi))[:len(hi) // n_dev * n_dev]
    hi, lo = hi[order], lo[order]
    valid = rng.random(len(hi)) < 0.9
    mesh = jmake_mesh(n_dev)
    want = _jax_routed(jsharded.ShardedTable.from_shards(shards, mesh), mesh,
                       hi, lo, valid)
    stable = psharded.ShardedTable.from_shards(
        [_port_peptide(t) for t in shards], make_mesh(n_dev, "cpu"))
    got = _port_routed(stable, hi, lo, valid)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[1].sum() > 2000


def _jax_slice_probe(jst, d, hi, lo, valid):
    """umgap_tpu's local probe on device d of a sharded table, each
    query's sub-table owner_of(key, N * group) - d * group, clipped
    (umgap_tpu/parallel/sharded.py:314-322)."""
    table = jlookup.DeviceTable(jst.rows[d], jst.max_probes, jst.kind,
                                jst.nb_bits, jst.bucket, stash=jst.stash[d],
                                group=jst.group)
    own = jsharded.owner_of(jnp.asarray(hi), jnp.asarray(lo), jst.n_shards,
                            kind=jst.kind)
    sub = jnp.clip(own - d * jst.group, 0, jst.group - 1)
    out, found = jlookup.probe(table, jnp.asarray(hi), jnp.asarray(lo),
                               valid=jnp.asarray(valid), default=0, sub=sub)
    return np.asarray(out), np.asarray(found)


@pytest.mark.parametrize("kind", ["kmer", "peptide"])
def test_slice_entries_plain_match_jax(kind):
    """The plain versions of K2's slice entry and K8's grouped entry: each
    device's table of a 4 x 4 mesh probed with every query (the ones it
    owns found, the others clipped into a sub-table and missed) equals
    umgap_tpu's probe with ``sub``, with the sub-tables from the keys and
    given."""
    n_dev, group = 4, 4
    if kind == "kmer":
        shards, _k, _v, hi, lo, valid, _s = _kmer_case(n_dev, group, 5)
        port = [_port_kmer(t) for t in shards]
    else:
        rng = np.random.default_rng(6)
        aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
        peps = sorted({"".join(rng.choice(aa, rng.integers(9, 30)))
                       for _ in range(6000)})
        shards = _peptide_shards(
            peps, rng.integers(1, 100, size=len(peps)).astype(np.int32),
            n_dev * group)
        port = [_port_peptide(t) for t in shards]
        hi, lo = jtable._fingerprints(peps)
        valid = rng.random(len(hi)) < 0.9
    jst = jsharded.ShardedTable.from_shards(shards, jmake_mesh(n_dev))
    stable = psharded.ShardedTable.from_shards(port, make_mesh(n_dev, "cpu"))
    args = [torch.from_numpy(x) for x in (hi, lo, valid)]
    own = psharded.owner_of(args[0], args[1], n_dev, kind=kind).numpy()
    for d, t in enumerate(stable.tables):
        assert (t.group, t.first, t.n_total) == (group, d * group, 16)
        want = _jax_slice_probe(jst, d, hi, lo, valid)
        for got in (lookup.probe(t, *args, 0),
                    lookup.probe_plain(t, *args, 0, sub=lookup.sub_tables(
                        t, args[0], args[1]))):
            assert np.array_equal(got[0].numpy(), want[0])
            assert np.array_equal(got[1].numpy(), want[1])
        assert want[1][own == d].sum() > 100 and want[1][own != d].sum() == 0


# ---------------------------------------------------------------------- #
# The sharded steps and analysers
# ---------------------------------------------------------------------- #

def _taxons_tsv(path):
    with open(path, "w") as f:
        for t in fixture_taxa():
            valid = "\x01" if t.valid else "\x00"
            f.write(f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t"
                    f"{t.parent}\t{valid}\n")


def _write_fastq(paths, codes, lens):
    for e, path in enumerate(paths):
        with open(path, "w") as f:
            for i in range(len(codes)):
                seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
                f.write(f"@read{i}/{e + 1}\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Paired reads, the fixture taxonomy, a 9-mer index of the reads' own
    k-mers (a taxon a (group, frame), so groups see several taxa) with
    random extra keys, a peptide index of most of their tryptic fragments
    (stored keys; mostly a taxon a pair), both in a config dir's data
    version, the FASTQ files, and a 4-shard buildindex-dist artifact of
    the reads' proteins."""
    tmp = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(21)
    codes = rng.integers(0, 4, size=(N_READS, 2, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lens = rng.integers(20, L + 1, size=(N_READS, 2)).astype(np.int32)
    code = encoding.get_table(1)
    kmap, pmap = {}, {}
    for i in range(N_READS):
        for e in range(2):
            seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
            for j, pep in enumerate(translate.translate_sequence(
                    seq, translate.FRAME_NAMES, code)):
                taxon = IDS[(i + j) % 5]
                ac = encoding.encode_aa(pep)
                for w in range(len(ac) - 8):
                    if 0 <= ac[w:w + 9].max() < 20:
                        kmap.setdefault(int(kmers.pack_kmers_host(
                            ac[w:w + 9], 9)[0]), taxon)
                for frag in kmers.tryptic_digest(pep):
                    if 9 <= len(frag) <= 45 and rng.random() < 0.95:
                        # mostly the pair's taxon (tryptic-precision's
                        # bound of 5 keeps some), else any (overflow)
                        pmap.setdefault(frag, IDS[i % 5] if rng.random()
                                        < 0.6 else IDS[rng.integers(0, 8)])
    extra = rng.integers(0, 2 ** 45, size=3000, dtype=np.uint64)
    for k in extra.tolist():
        kmap.setdefault(k, IDS[rng.integers(0, len(IDS))])
    packed = np.array(sorted(kmap), np.uint64)
    values = np.array([kmap[k] for k in sorted(kmap)], np.int32)
    peps = sorted(pmap)
    pvals = np.array([pmap[p] for p in peps], np.int32)
    conf = tmp / "conf"
    ver = conf / "1"
    ver.mkdir(parents=True)
    data = tmp / "data"
    data.mkdir()
    _taxons_tsv(data / "taxons.tsv")
    ptable.build_kmer_table(packed, values, 9).save(data / "ninemer.npz")
    ptable.PeptideTable.build(peps, pvals).save(data / "tryptic.npz")
    for name in ("taxons.tsv", "ninemer.npz", "tryptic.npz"):
        os.symlink(data / name, ver / name)
    fq = [tmp / "R1.fq", tmp / "R2.fq"]
    _write_fastq(fq, codes, lens)
    tsv = tmp / "proteins.tsv"
    with open(tsv, "w") as f:
        for i in range(0, N_READS, 2):
            for e in range(2):
                seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
                for j, pep in enumerate(translate.translate_sequence(
                        seq, translate.FRAME_NAMES, code)):
                    for part in pep.split("*"):
                        if len(part) >= 9 and "X" not in part:
                            f.write(f"{IDS[(i + j) % 5]}\t{part}\n")
    work = tmp / "work"
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO  # drive's worker processes
    try:
        jdist.drive(str(work), str(tsv), str(data / "taxons.tsv"),
                    n_shards=4, workers=1, layout="bucket64s")
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    return dict(tmp=tmp, codes=codes, lens=lens, packed=packed,
                values=values, peps=peps, pvals=pvals, conf=conf, fq=fq,
                taxons=data / "taxons.tsv", work=str(work))


@pytest.fixture(scope="module")
def taxa():
    jtax = JTaxonomy(fixture_taxa())
    ptax = Taxonomy(fixture_taxa())
    return dict(jtax=jtax, ptax=ptax,
                jdtax=jagg.DeviceTaxonomy.from_host(jtax),
                pdtax=DeviceTaxonomy.from_host(ptax, "cpu"),
                jeuler=jrmq.DeviceEuler.from_host(jtax),
                peuler=DeviceEuler.from_host(ptax, "cpu"))


def _shards(world, n, tryptic):
    """umgap_tpu's ``n`` shards of the world's index and the port's."""
    if tryptic:
        js = _peptide_shards(world["peps"], world["pvals"], n)
        return js, [_port_peptide(t) for t in js]
    js = jsharded.build_sharded_tables(world["packed"], world["values"], 9,
                                       n)
    return js, [_port_kmer(t) for t in js]


def _config(preset, k_max=None):
    tryptic = preset in TRYPTIC_PRESETS
    j = (JTRYPTIC if tryptic else JPRESETS)[preset]
    p = (TRYPTIC_PRESETS if tryptic else PRESETS)[preset]
    if k_max is not None:
        j, p = j._replace(k_max=k_max), p._replace(k_max=k_max)
    return tryptic, j, p


@pytest.mark.parametrize("n_dev,group", [(4, 1), (8, 2)])
@pytest.mark.parametrize("preset", ALL_PRESETS)
def test_sharded_step_matches_jax(world, taxa, preset, n_dev, group):
    """One batch through the mesh step: taxa, the psum'd rank
    frequencies and the k_max overflow flags (k_max 3: many groups
    overflow) equal umgap_tpu's sharded program's."""
    tryptic, jcfg, pcfg = _config(preset, k_max=3)
    mesh = jmake_mesh(n_dev)
    js, ps = _shards(world, n_dev * group, tryptic)
    maker = (jsharded.make_sharded_tryptic_pipeline if tryptic
             else jsharded.make_sharded_pipeline)
    step = maker(taxa["jdtax"], jsharded.ShardedTable.from_shards(js, mesh),
                 jcfg, mesh, with_overflow=True)
    codes, lens = world["codes"], world["lens"]
    jt, jf, jo = (np.asarray(x) for x in step(jnp.asarray(codes),
                                              jnp.asarray(lens)))
    stable = psharded.ShardedTable.from_shards(ps, make_mesh(n_dev, "cpu"))
    pstep = psharded.ShardedPipeline(taxa["pdtax"], stable, pcfg, tryptic,
                                     True)
    cut = psharded.split_to_mesh
    pt, po = pstep(cut(encoding.pack_dna4(codes), stable.devices),
                   cut(lens, stable.devices), L)
    pf = psharded.rank_counts(pstep.dtaxs, pt)
    assert np.array_equal(torch.cat(pt).numpy(), jt)
    assert np.array_equal(pf.numpy(), jf) and pf.dtype == torch.float32
    assert np.array_equal(torch.cat(po).numpy(), jo)
    assert (jt != 1).sum() > 5
    assert jo.sum() > 3 or pcfg.lower_bound >= 5  # a bound of 5 keeps few


@pytest.mark.parametrize("preset,strategy", [
    ("high-sensitivity", None), ("tryptic-sensitivity", None),
    ("max-sensitivity", "lca*")])
def test_sharded_analyser_matches_jax(world, taxa, preset, strategy):
    """ShardedAnalyser on a 4-device mesh of 8 shards: taxa and the
    frequency vector with the overflowed groups re-run through the wide
    program (exact), equal to umgap_tpu's; rmq/lca* with its Euler
    tables."""
    tryptic, jcfg, pcfg = _config(preset, k_max=3)
    euler = {}
    if strategy:
        jcfg = jcfg._replace(method="rmq", strategy=strategy)
        pcfg = pcfg._replace(method="rmq", strategy=strategy)
        euler = dict(j=taxa["jeuler"], p=taxa["peuler"])
    mesh = jmake_mesh(4)
    js, ps = _shards(world, 8, tryptic)
    ja = jsharded.ShardedAnalyser(
        taxa["jdtax"], jsharded.ShardedTable.from_shards(js, mesh), jcfg,
        mesh, tryptic=tryptic, euler=euler.get("j"), read_length=L)
    pa = psharded.ShardedAnalyser(
        taxa["pdtax"], psharded.ShardedTable.from_shards(
            ps, make_mesh(4, "cpu")), pcfg, tryptic=tryptic,
        euler=euler.get("p"), read_length=L)
    jt, jf = ja.run(world["codes"], world["lens"])
    pt, pf = pa.run(world["codes"], world["lens"])
    assert pa.overflow_reads == ja.overflow_reads > 0
    assert np.array_equal(pt, jt) and np.array_equal(pf, jf)


@pytest.mark.parametrize("preset", ["max-precision", "tryptic-precision"])
def test_stream_analyser_over_mesh(world, taxa, preset):
    """The stream analyser over a 4-device mesh (k_max 3, overflow
    re-routed in wide batches padded with 0x44) gives the one-device
    Analyser's taxa over the unsplit index, through the code and the
    packed feeds, and refuses a batch the mesh does not divide."""
    tryptic, _j, pcfg = _config(preset, k_max=3)
    _js, ps = _shards(world, 4, tryptic)
    stable = psharded.ShardedTable.from_shards(ps, make_mesh(4, "cpu"))
    an = psharded.make_sharded_stream_analyser(
        taxa["ptax"], stable, pcfg, tryptic=tryptic, batch_size=32,
        read_length=L, dtax=taxa["pdtax"])
    assert isinstance(an, Analyser) and an.stable is stable
    headers = [str(i) for i in range(N_READS)]
    got = [t for _h, t in an.analyse_arrays(headers, world["codes"],
                                            world["lens"])]
    assert an.overflow_reads > 0
    an.reset()
    dna4 = encoding.pack_dna4(world["codes"])
    packed = [t for b in range(0, N_READS, 32) for t in list(
        an.feed_packed(None, dna4[b:b + 32], world["lens"][b:b + 32], 32))
        for t in t[1]]
    packed += [t for _h, ts in an.finish_batches() for t in ts]
    table = (ptable.PeptideTable.build(world["peps"], world["pvals"])
             if tryptic else ptable.build_kmer_table(world["packed"],
                                                     world["values"], 9))
    cls = Analyser
    if tryptic:
        from umgap_tpu_torch.pipeline.tryptic import TrypticAnalyser as cls
    want = [t for _h, t in cls(
        taxa["ptax"], table, pcfg, batch_size=32, read_length=L,
        device="cpu").analyse_arrays(headers, world["codes"],
                                     world["lens"])]
    assert got == want == [int(t) for t in packed]
    with pytest.raises(ValueError, match="not divisible by the 4-device"):
        psharded.make_sharded_stream_analyser(
            taxa["ptax"], stable, pcfg, tryptic=tryptic, batch_size=30,
            read_length=L, dtax=taxa["pdtax"])


def test_peptide_shards_of_other_depths_served(world, taxa):
    """Peptide shards that realize different probe depths (what most
    re-splits of a peptide index give) are served, each probed to the
    deepest: the same answers as the one table's; umgap_tpu refuses
    them (its geometry check), and with them its own --mesh re-split."""
    rng = np.random.default_rng(17)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(aa, rng.integers(9, 30)))
                   for _ in range(20000)})
    vals = rng.integers(1, 100, size=len(peps)).astype(np.int32)
    shards = next(sh for n in (4, 8, 16) for sh in [
        psharded.build_sharded_peptide_tables(peps, vals, n, 0.9)]
        if len({t.max_probes for t in sh}) > 1)
    n = len(shards)
    with pytest.raises(ValueError, match="geometry mismatch"):
        jsharded.ShardedTable.from_shards(shards, jmake_mesh(4))
    stable = psharded.ShardedTable.from_shards(shards, make_mesh(4, "cpu"))
    assert stable.table.max_probes == max(t.max_probes for t in shards)
    hi, lo = jtable._fingerprints(peps + ["".join(rng.choice(aa, 12))
                                          for _ in range(1000)])
    cut = len(hi) // 4 * 4
    hi, lo = hi[:cut], lo[:cut]
    out, found = _port_routed(stable, hi, lo, np.ones(cut, bool))
    one = ptable.PeptideTable.build(peps, vals)
    want = one.probe_host(hi, lo)
    assert np.array_equal(out, want[0]) and np.array_equal(found, want[1])
    assert found[:len(peps)].all() and n > 1


def test_sharded_rank_counts_match_jax(taxa):
    """The mesh's rank counts and the taxa2freq CSV over 4 devices equal
    umgap_tpu's (taxa out of range, negative and unknown included)."""
    rng = np.random.default_rng(3)
    ids = np.array([t.id for t in fixture_taxa()])
    files = [np.concatenate([rng.choice(ids, 50), [-1, 0, 10 ** 7]]),
             rng.choice(ids, 7), np.zeros(0, np.int64)]
    names = ["a", "b", "c"]
    tnames = {t.id: t.name for t in fixture_taxa()}
    for rank in (ranks.rank_index("superkingdom"),
                 ranks.rank_index("family")):
        want = jfreq.sharded_rank_counts(taxa["jtax"], rank, files,
                                         jmake_mesh(4))
        got = pfreq.sharded_rank_counts(taxa["ptax"], rank, files,
                                        make_mesh(4, "cpu"))
        assert np.array_equal(got, want)
        clean = [f[(f > 0) & (f < 10 ** 7)] for f in files]
        csv = pfreq.sharded_taxa2freq_csv(
            taxa["ptax"], tnames, rank, clean, names, make_mesh(4, "cpu"),
            min_frequency=2)
        assert csv == jfreq.sharded_taxa2freq_csv(
            taxa["jtax"], rank, clean, names, jmake_mesh(4),
            min_frequency=2)
        assert csv.count("\n") > 2
        # column 0 (no snap, out of range) names no taxon: both refuse
        with pytest.raises(Exception, match="not in taxon list") as e:
            pfreq.sharded_taxa2freq_csv(taxa["ptax"], tnames, rank, files,
                                        names, make_mesh(4, "cpu"))
        with pytest.raises(Exception, match="not in taxon list") as w:
            jfreq.sharded_taxa2freq_csv(taxa["jtax"], rank, files, names,
                                        jmake_mesh(4))
        assert str(e.value) == str(w.value)


# ---------------------------------------------------------------------- #
# The command line
# ---------------------------------------------------------------------- #

def _run(cli, argv):
    """(rc, stderr) of one CLI call."""
    err = io.StringIO()
    old = sys.stderr
    sys.stderr = err
    try:
        if cli is jax_cli:
            rc = jax_cli(argv, stdin=io.StringIO(""), stdout=io.StringIO())
        else:
            rc = port_cli(argv, stdout=io.StringIO())
    finally:
        sys.stderr = old
    return rc, err.getvalue()


def _all_samples(world, out, tag):
    args = []
    for p in ALL_PRESETS:
        args += ["-t", p, "-1", str(world["fq"][0]), "-2",
                 str(world["fq"][1]), "-o", str(out / f"{tag}-{p}.fa")]
    return args


def _count_routes(monkeypatch):
    """Counts the routed probes' meshes (sharded_probe's calls)."""
    seen = []
    real = psharded.sharded_probe

    def spy(stable, *a, **kw):
        seen.append((stable.n_devices, stable.group))
        return real(stable, *a, **kw)

    monkeypatch.setattr(psharded, "sharded_probe", spy)
    return seen


@pytest.mark.parametrize("n_dev", [4, 8])
def test_cli_mesh_matches_jax(world, tmp_path, monkeypatch, n_dev):
    """``analyse --mesh N --device cpu`` over the config dir's 9-mer and
    peptide indexes (each split on the host into N shards, the queries
    routed over N devices), the six presets in one run at --batch-size
    30 (rounded up to a multiple of N), gives umgap_tpu's --mesh N
    bytes."""
    base = ["analyse", "-c", str(world["conf"]), "--batch-size", "30",
            "--read-length", str(L), "--fgspp", "never", "--mesh",
            str(n_dev)]
    assert _run(jax_cli, base + _all_samples(world, tmp_path, "jax"))[0] == 0
    seen = _count_routes(monkeypatch)
    rc, err = _run(port_cli, base + ["--device", "cpu"]
                   + _all_samples(world, tmp_path, "port"))
    assert rc == 0, err
    assert seen and set(seen) == {(n_dev, 1)}
    for p in ALL_PRESETS:
        want = (tmp_path / f"jax-{p}.fa").read_bytes()
        assert (tmp_path / f"port-{p}.fa").read_bytes() == want
        assert want.count(b">") == N_READS


@pytest.mark.parametrize("n_dev", [2, 4])
def test_cli_shards_mesh_matches_jax(world, tmp_path, monkeypatch, n_dev):
    """``analyse --shards DIR --mesh N`` (4 shards, a group of 4 / N a
    device) gives umgap_tpu's bytes for the four 9-mer presets."""
    base = ["analyse", "--taxons", str(world["taxons"]), "--shards",
            world["work"], "--mesh", str(n_dev), "--batch-size", "32",
            "--read-length", str(L), "--fgspp", "never"]
    samples = []
    for p in PRESETS:
        samples += ["-t", p, "-1", str(world["fq"][0]), "-2",
                    str(world["fq"][1]), "-o", "{}-" + p + ".fa"]

    def outs(tag):
        return [str(tmp_path / a.format(tag)) if "{}" in a else a
                for a in samples]

    assert _run(jax_cli, base + outs("jax"))[0] == 0
    seen = _count_routes(monkeypatch)
    rc, err = _run(port_cli, base + ["--device", "cpu"] + outs("port"))
    assert rc == 0, err
    assert seen and set(seen) == {(n_dev, 4 // n_dev)}
    for p in PRESETS:
        want = (tmp_path / f"jax-{p}.fa").read_bytes()
        assert (tmp_path / f"port-{p}.fa").read_bytes() == want
        assert want.count(b">") == N_READS


def test_cli_mesh_not_a_divisor_fails_as_jax(world):
    argv = ["analyse", "-t", "max-sensitivity", "-1", str(world["fq"][0]),
            "-2", str(world["fq"][1]), "--taxons", str(world["taxons"]),
            "--shards", world["work"], "--mesh", "3", "--fgspp", "never"]
    jrc, jerr = _run(jax_cli, argv)
    rc, err = _run(port_cli, argv + ["--device", "cpu"])
    assert jrc == rc == 1
    assert err == jerr == ("Error: 4 shards cannot be grouped onto the "
                           "3-device mesh (must divide evenly)\n")


def test_cli_mesh_past_cards_fails_as_jax(world, monkeypatch):
    """On CUDA, --mesh past the visible cards exits 1 with umgap_tpu's
    message before any data is read."""
    argv = ["analyse", "-t", "max-sensitivity", "-1", str(world["fq"][0]),
            "--taxons", str(world["taxons"]), "--shards", world["work"],
            "--fgspp", "never", "--mesh"]
    jrc, jerr = _run(jax_cli, argv + ["9"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    rc, err = _run(port_cli, argv + ["9"])
    assert jrc == rc == 1 and err == jerr == "Error: need 9 devices, have 8\n"
