"""The port's sharded serving against ``umgap_tpu``'s on the CPU:
``owner_of``, ``build_sharded_tables`` and the peptide split, the grouped
probe (K2's grouped entry's plain version) on shards of the three
``buildindex-dist`` layouts, the stream analyser over the grouped table
(overflow re-routed) against ``umgap_tpu``'s ``ShardedAnalyser``, and
``analyse --shards`` / ``--mesh`` through the command line, with
``umgap_tpu``'s failure messages (the mesh of several devices:
``tests/test_torch_mesh.py``). Every output is integers: equality is
exact."""

import glob
import io
import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umgap_tpu import ranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index import distbuild as jdist
from umgap_tpu.index import table as jtable
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.parallel import make_mesh as jmake_mesh
from umgap_tpu.parallel import sharded as jsharded
from umgap_tpu.pipeline.fused import PRESETS as JPRESETS
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.index import distbuild as pdist
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding, lookup, translate
from umgap_tpu_torch.parallel import sharded as psharded
from umgap_tpu_torch.pipeline.fused import PRESETS
from umgap_tpu_torch.taxonomy import Taxonomy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 64
IDS = [2, 10239, 12884, 185751, 185752, 1, 10, 11]
LAYOUTS = ("bucket64s", "bucket64d", "bucket16")
# shards a layout's artifact: both group sizes of the grouped probe
LAYOUT_SHARDS = {"bucket64s": 2, "bucket64d": 2, "bucket16": 16}


def _keys(rng, n):
    return np.unique(rng.integers(0, 2 ** 45, size=n, dtype=np.uint64))


def _split(keys):
    return ((keys >> np.uint64(25)).astype(np.int32),
            (keys & np.uint64((1 << 25) - 1)).astype(np.int32))


# ---------------------------------------------------------------------- #
# owner_of and the shard builders
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["kmer", "peptide"])
@pytest.mark.parametrize("n", [1, 2, 16, 64])
def test_owner_of_matches_jax(n, kind):
    rng = np.random.default_rng(n)
    if kind == "kmer":
        hi, lo = _split(_keys(rng, 20000))
    else:
        hi = rng.integers(-2 ** 31, 2 ** 31, size=20000).astype(np.int32)
        lo = rng.integers(-2 ** 31, 2 ** 31, size=20000).astype(np.int32)
    want = jsharded.owner_of(hi, lo, n, kind=kind)
    assert np.array_equal(psharded.owner_of(hi, lo, n, kind=kind), want)
    dev = np.asarray(jsharded.owner_of(jnp.asarray(hi), jnp.asarray(lo), n,
                                       kind=kind))
    got = psharded.owner_of(torch.from_numpy(hi), torch.from_numpy(lo), n,
                            kind=kind)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), dev) and np.array_equal(dev, want)
    assert want.min() >= 0 and want.max() < n


def _same_kmer_table(got, want):
    assert got.capacity == want.capacity
    assert got.max_probes == want.max_probes and got.bucket == want.bucket
    assert np.array_equal(got.packed_rows(), jlookup.pack_rows(want))
    for a in ("stash_hi", "stash_lo", "stash_val"):
        assert np.array_equal(getattr(got, a), getattr(want, a))


@pytest.mark.parametrize("layout,n_shards,load", [
    ("bucket8s", 4, 0.4), ("bucket8s", 2, 0.95), ("bucket64s", 2, 0.4),
    ("bucket16", 4, 0.4)])
def test_build_sharded_tables_matches_jax(layout, n_shards, load):
    """Same capacity, rows and stash a shard, the common capacity grown
    (load 0.95 overflows bucket8s' stash at the first capacity)."""
    rng = np.random.default_rng(5)
    n = 400_000 if load > 0.9 else 30_000
    keys = _keys(rng, n)
    vals = rng.integers(1, 5000, size=len(keys)).astype(np.int32)
    got = psharded.build_sharded_tables(keys, vals, 9, n_shards,
                                        load_factor=load, layout=layout)
    want = jsharded.build_sharded_tables(keys, vals, 9, n_shards,
                                         load_factor=load, layout=layout)
    assert len(got) == len(want) == n_shards
    for g, w in zip(got, want):
        _same_kmer_table(g, w)
    if load > 0.9:
        assert got[0].capacity > jtable._pow2_capacity(
            len(keys) // n_shards, load, 8 << jtable.MIN_NB_BITS)


def test_build_sharded_peptide_tables_matches_jax():
    rng = np.random.default_rng(8)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(aa, rng.integers(9, 30)))
                   for _ in range(3000)})
    vals = rng.integers(1, 100, size=len(peps)).astype(np.int32)
    got = psharded.build_sharded_peptide_tables(peps, vals, 4)
    want = jsharded.build_sharded_peptide_tables(peps, vals, 4)
    for g, w in zip(got, want):
        assert g.capacity == w.capacity and g.max_probes == w.max_probes
        for a in ("key_hi", "key_lo", "values"):
            assert np.array_equal(getattr(g, a), getattr(w, a))


# ---------------------------------------------------------------------- #
# The grouped probe
# ---------------------------------------------------------------------- #

GEOMETRY = {"bucket64s": (64, 0), "bucket64d": (64, 1), "bucket16": (16, 1)}


def _crowded_shards(layout, group, seed):
    """``group`` shards of one layout (``umgap_tpu``'s builder at the
    minimum capacity), each holding its owner's share of keys crowded
    into the first 8 home buckets (so hundreds overflow to its stash)
    and of keys spread over the table."""
    bucket, probes = GEOMETRY[layout]
    cap = bucket << jtable.MIN_NB_BITS
    nb_bits = jtable.MIN_NB_BITS
    rng = np.random.default_rng(seed)
    n_crowd = group * 8 * bucket * 3
    mlo = ((rng.integers(0, 1 << (25 - nb_bits), size=n_crowd,
                         dtype=np.uint32) << np.uint32(nb_bits))
           | rng.integers(0, 8, size=n_crowd, dtype=np.uint32))
    mhi = rng.integers(0, 1 << 20, size=n_crowd, dtype=np.uint32)
    hi, lo = jtable.unmix_key(mhi, mlo)
    crowd = (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)
    keys = np.unique(np.concatenate([crowd, _keys(rng, group * 3000)]))
    vals = rng.integers(1, 10 ** 6, size=len(keys)).astype(np.int32)
    owner = jsharded.owner_of(*_split(keys), group)
    shards = []
    for s in range(group):
        t = jtable.KmerTable.build(keys[owner == s], vals[owner == s], 9,
                                   capacity=cap, bucket=bucket,
                                   max_probe_limit=probes, stash_cap=1 << 20)
        t.max_probes = max(t.max_probes, probes)
        shards.append(t)
    return shards, keys, vals


def _queries(rng, keys, n_miss=3000):
    q = np.concatenate([keys, _keys(rng, n_miss)])
    rng.shuffle(q)
    hi, lo = _split(q)
    valid = rng.random(len(q)) < 0.9
    return hi, lo, valid


def _jax_grouped_probe(shards, hi, lo, valid):
    """``umgap_tpu``'s grouped probe on a one-device mesh: the
    ShardedTable's block and merged stash, each query's sub-table from
    ``owner_of`` (sharded_probe_local's local probe)."""
    st = jsharded.ShardedTable.from_shards(shards, jmake_mesh(1))
    table = jlookup.DeviceTable(st.rows[0], st.max_probes, st.kind,
                                st.nb_bits, st.bucket, stash=st.stash[0],
                                group=st.group)
    sub = jsharded.owner_of(jnp.asarray(hi), jnp.asarray(lo), st.group,
                            kind=st.kind)
    out, found = jlookup.probe(table, jnp.asarray(hi), jnp.asarray(lo),
                               valid=jnp.asarray(valid), default=0, sub=sub)
    return np.asarray(out), np.asarray(found)


def _port_sharded(shards, tmp_path):
    """The shards written as ``buildindex-dist`` writes them, read back by
    the port's reader and stacked."""
    work = tmp_path / "work"
    (work / "shards").mkdir(parents=True)
    for s, t in enumerate(shards):
        t.save(work / "shards" / f"shard_{s:03d}.npz", packed=True)
    (work / "manifest.json").write_text(json.dumps(
        {"n_shards": len(shards), "k": 9, "capacity": shards[0].capacity}))
    return psharded.ShardedTable.from_shards(
        pdist.load_shards(str(work), mmap=True), "cpu")


def _held_to_jax(stable, shards, hi, lo, valid):
    want = _jax_grouped_probe(shards, hi, lo, valid)
    t = stable.table
    args = (torch.from_numpy(hi), torch.from_numpy(lo),
            torch.from_numpy(valid))
    for got in (lookup.probe(t, *args, 0), lookup.probe_plain(t, *args, 0),
                lookup.probe_plain(t, *args, 0, sub=lookup.sub_tables(
                    t, args[0], args[1]))):
        assert np.array_equal(got[0].numpy(), want[0])
        assert np.array_equal(got[1].numpy(), want[1])
    return want


@pytest.mark.parametrize("group", [2, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_grouped_probe_matches_jax(layout, group, tmp_path):
    """K2's grouped entry's plain version, the sub-table of every query
    from its key, against umgap_tpu's probe with ``sub`` on the stacked
    shards and merged stash; every indexed key is found with its value,
    also where the hash that picks the sub-table is mix_key's (a wrong
    hash misses most keys of a group of 2 or more)."""
    shards, keys, vals = _crowded_shards(layout, group, seed=group)
    stable = _port_sharded(shards, tmp_path)
    assert stable.group == group and stable.n_shards == group
    assert stable.n_devices == 1
    S = stable.table.stash.shape[0]
    assert S == sum(len(t.stash_hi) for t in shards) > 0
    rng = np.random.default_rng(1)
    hi, lo, valid = _queries(rng, keys)
    out, found = _held_to_jax(stable, shards, hi, lo, valid)
    q = (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)
    idx = np.searchsorted(keys, q).clip(0, len(keys) - 1)
    indexed = (keys[idx] == q) & valid
    assert np.array_equal(found, indexed)
    assert np.array_equal(out[indexed], vals[idx][indexed])
    # a sub-table picked by the wrong hash misses most keys
    wrong = lookup.probe_plain(
        stable.table, torch.from_numpy(hi), torch.from_numpy(lo),
        torch.from_numpy(valid), 0,
        sub=torch.from_numpy(((lo.astype(np.int64) >> 3) % group).astype(
            np.int32)))
    assert int(wrong[1].sum()) < int(found.sum())


def test_grouped_peptide_table_refused():
    """A grouped peptide table (the shards of a peptide index on one
    device) is no longer refused: its probe (K8's grouped entry's plain
    version, each query's sub-table the owner of its swapped lanes)
    equals umgap_tpu's grouped probe and finds every stored peptide."""
    rng = np.random.default_rng(9)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(aa, rng.integers(9, 30)))
                   for _ in range(3000)})
    vals = rng.integers(1, 100, size=len(peps)).astype(np.int32)
    shards = jsharded.build_sharded_peptide_tables(peps, vals, 4)
    depth = max(t.max_probes for t in shards)
    for t in shards:
        t.max_probes = depth
    st = psharded.ShardedTable.from_shards(
        [ptable.PeptideTable(t.key_hi, t.key_lo, t.values, t.max_probes,
                             t.n) for t in shards], "cpu")
    assert st.group == 4 and st.kind == "peptide"
    hi, lo = jtable._fingerprints(peps + ["".join(rng.choice(aa, 12))
                                          for _ in range(500)])
    valid = rng.random(len(hi)) < 0.9
    out, found = _jax_grouped_probe(shards, hi, lo, valid)
    got = lookup.probe_plain(st.table, torch.from_numpy(hi),
                             torch.from_numpy(lo), torch.from_numpy(valid))
    assert np.array_equal(got[0].numpy(), out)
    assert np.array_equal(got[1].numpy(), found)
    assert np.array_equal(found[:len(peps)], valid[:len(peps)])
    assert np.array_equal(out[:len(peps)][found[:len(peps)]],
                          vals[found[:len(peps)]])


def test_from_shards_geometry_mismatch_matches_jax():
    rng = np.random.default_rng(4)
    keys = _keys(rng, 5000)
    vals = np.ones(len(keys), np.int32)
    a = psharded.build_sharded_tables(keys, vals, 9, 2, layout="bucket16")
    b = psharded.build_sharded_tables(keys, vals, 9, 2, layout="bucket8s")
    with pytest.raises(ValueError) as e:
        psharded.ShardedTable.from_shards([a[0], b[1]], "cpu")
    with pytest.raises(ValueError) as w:
        jsharded.ShardedTable.from_shards([a[0], b[1]], jmake_mesh(1))
    assert str(e.value) == str(w.value)


# ---------------------------------------------------------------------- #
# buildindex-dist artifacts
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


def _protein_tsv(path, codes, lens, rng):
    """(taxid TAB protein) rows of the reads' six-frame stretches
    between stops (half the groups), one taxon a (group, frame), some
    stretches twice with two taxa (the join takes their LCA)."""
    code = encoding.get_table(1)
    with open(path, "w") as f:
        for i in range(0, len(codes), 2):
            for e in range(2):
                seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
                peps = translate.translate_sequence(
                    seq, translate.FRAME_NAMES, code)
                for j, pep in enumerate(peps):
                    for part in pep.split("*"):
                        if len(part) >= 9 and "X" not in part:
                            f.write(f"{IDS[(i + j) % 5]}\t{part}\n")
                            if rng.random() < 0.2:
                                f.write(f"{IDS[rng.integers(0, 5)]}\t"
                                        f"{part}\n")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Paired FASTQ reads (one pair past the top device width in a
    second sample), the fixture taxonomy, a protein TSV of the reads'
    own stretches and one ``buildindex-dist`` workdir a layout built
    from it by ``umgap_tpu.index.distbuild.drive``, and one merged index
    of the same keys."""
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(13)
    n = 96
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lens = rng.integers(20, L + 1, size=(n, 2)).astype(np.int32)
    fq = [tmp / "R1.fq", tmp / "R2.fq"]
    _write_fastq(fq, codes, lens)
    taxons = tmp / "taxons.tsv"
    _taxons_tsv(taxons)
    tsv = tmp / "proteins.tsv"
    _protein_tsv(tsv, codes, lens, rng)
    works = {}
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO  # drive's worker processes
    try:
        for layout in LAYOUTS:
            work = tmp / layout
            jdist.drive(str(work), str(tsv), str(taxons),
                        n_shards=LAYOUT_SHARDS[layout], workers=1,
                        layout=layout)
            works[layout] = str(work)
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    merged = tmp / "merged.npz"
    items = [t.items() for t in jdist.load_shards(works["bucket16"])]
    keys = np.concatenate([k for k, _v in items])
    vals = np.concatenate([v for _k, v in items])
    order = np.argsort(keys)
    ptable.build_kmer_table(keys[order], vals[order], 9).save(merged)
    long_fq = [tmp / "long1.fq", tmp / "long2.fq"]
    seq = encoding.decode_dna(rng.integers(0, 4, size=5000).astype(np.uint8))
    for e, path in enumerate(long_fq):
        path.write_text(f"@x/{e + 1}\n{seq}\n+\n{'I' * len(seq)}\n"
                        f"@y/{e + 1}\n{seq[:40]}\n+\n{'I' * 40}\n")
    return dict(tmp=tmp, fq=fq, codes=codes, lens=lens, taxons=taxons,
                works=works, merged=merged, keys=keys[order],
                vals=vals[order], long_fq=long_fq, n=n)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_distbuild_artifact_probe_matches_jax(world, layout, tmp_path):
    """The port's reader and grouped probe over umgap_tpu's own
    artifacts: every key of the build found with its value, as
    umgap_tpu's grouped probe finds it."""
    work = world["works"][layout]
    man = json.load(open(os.path.join(work, "manifest.json")))
    assert man["layout"] == layout and man["n_shards"] == LAYOUT_SHARDS[
        layout]
    shards = pdist.load_shards(work, mmap=True)
    stable = psharded.ShardedTable.from_shards(shards, "cpu")
    assert stable.group == man["n_shards"]
    assert stable.table.bucket == jdist.BUCKETS[layout] == pdist.BUCKETS[
        layout]
    assert stable.table.max_probes == pdist.PROBE_LIMITS[layout]
    rng = np.random.default_rng(2)
    hi, lo, valid = _queries(rng, world["keys"])
    out, found = _held_to_jax(stable, jdist.load_shards(work), hi, lo,
                              valid)
    q = (hi.astype(np.uint64) << np.uint64(25)) | lo.astype(np.uint64)
    idx = np.searchsorted(world["keys"], q).clip(0, len(world["keys"]) - 1)
    indexed = (world["keys"][idx] == q) & valid
    assert np.array_equal(found, indexed) and indexed.sum() > 1000
    assert np.array_equal(out[indexed], world["vals"][idx][indexed])


def test_sharded_analyser_matches_jax(world):
    """The stream analyser over the grouped table at a k_max that
    overflows many groups: its taxa (overflowed reads re-run through the
    wide program) equal umgap_tpu's ShardedAnalyser's on a one-device
    mesh, with as many reads re-routed."""
    work = world["works"]["bucket16"]
    jtax = JTaxonomy(fixture_taxa())
    ptax = Taxonomy(fixture_taxa())
    codes, lens = world["codes"], world["lens"]
    mesh = jmake_mesh(1)
    jst = jsharded.ShardedTable.from_shards(jdist.load_shards(work), mesh)
    pst = psharded.ShardedTable.from_shards(pdist.load_shards(work), "cpu")
    pdtax = DeviceTaxonomy.from_host(ptax, "cpu")
    headers = [str(i) for i in range(world["n"])]
    for preset in ("high-sensitivity", "max-sensitivity"):
        jcfg = JPRESETS[preset]._replace(k_max=3)
        pcfg = PRESETS[preset]._replace(k_max=3)
        ja = jsharded.ShardedAnalyser(jagg.DeviceTaxonomy.from_host(jtax),
                                      jst, jcfg, mesh, read_length=L)
        pa = psharded.make_sharded_stream_analyser(
            ptax, pst, pcfg, batch_size=world["n"], read_length=L,
            dtax=pdtax)
        jt, _jf = ja.run(codes, lens)
        pt = np.array([t for _h, t in pa.analyse_arrays(headers, codes,
                                                          lens)])
        assert pa.overflow_reads == ja.overflow_reads > 0
        assert np.array_equal(pt, jt) and (pt != 1).sum() > 10


def test_sharded_step_and_stream_analyser(world):
    """The stream analyser is the port's Analyser over the grouped table,
    equal to the plain Analyser over the merged index and to the fused
    step over the grouped table."""
    from umgap_tpu_torch.pipeline.fused import make_pipeline
    from umgap_tpu_torch.pipeline.runner import Analyser

    work = world["works"]["bucket64s"]
    ptax = Taxonomy(fixture_taxa())
    pst = psharded.ShardedTable.from_shards(pdist.load_shards(work), "cpu")
    dtax = DeviceTaxonomy.from_host(ptax, "cpu")
    cfg = PRESETS["high-precision"]
    step = make_pipeline(dtax, pst.table, cfg, device="cpu")
    dna4 = torch.from_numpy(encoding.pack_dna4(world["codes"]))
    taxa = step(dna4, torch.from_numpy(world["lens"]), L)
    an = psharded.make_sharded_stream_analyser(ptax, pst, cfg, batch_size=32,
                                               read_length=L, dtax=dtax)
    assert isinstance(an, Analyser) and an.dtable is pst.table
    headers = [str(i) for i in range(world["n"])]
    got = [t for _h, t in an.analyse_arrays(headers, world["codes"],
                                            world["lens"])]
    merged = ptable.load_table(str(world["merged"]))
    want = [t for _h, t in Analyser(
        ptax, merged, cfg, batch_size=32, read_length=L,
        device="cpu").analyse_arrays(headers, world["codes"], world["lens"])]
    assert got == want == taxa.tolist()


# ---------------------------------------------------------------------- #
# The command line
# ---------------------------------------------------------------------- #

def _run(cli, argv, **kw):
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


def _samples(world, out_dir, tag, fq=None):
    r1, r2 = fq or world["fq"]
    args = []
    for p in PRESETS:
        args += ["-t", p, "-1", str(r1), "-2", str(r2), "-o",
                 str(out_dir / f"{tag}-{p}.fa")]
    return args


@pytest.fixture(scope="module")
def jax_shards_out(world):
    """umgap_tpu analyse --shards (one-device mesh) over each artifact,
    the four 9-mer presets in one run."""
    out = world["tmp"] / "jax_out"
    out.mkdir()
    for layout, work in world["works"].items():
        argv = ["analyse", "--taxons", str(world["taxons"]), "--shards",
                work, "--mesh", "1", "--batch-size", "64", "--read-length",
                str(L), "--fgspp", "never"] + _samples(world, out, layout)
        assert _run(jax_cli, argv)[0] == 0
    return out


@pytest.mark.parametrize("preset", list(PRESETS))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_shards_matches_jax_and_index(world, jax_shards_out, layout,
                                          preset, tmp_path):
    """``analyse --shards`` (the workdir, and its shards/ directory) gives
    umgap_tpu's bytes, and the port's bytes over the merged index with
    --index, for each layout and 9-mer preset."""
    work = world["works"][layout]
    base = ["analyse", "--taxons", str(world["taxons"]), "--batch-size",
            "64", "--read-length", str(L), "--device", "cpu", "-t", preset,
            "-1", str(world["fq"][0]), "-2", str(world["fq"][1]), "-o"]
    outs = {}
    for tag, extra in (("work", ["--shards", work]),
                       ("dir", ["--shards", os.path.join(work, "shards")]),
                       ("index", ["--index", str(world["merged"])])):
        path = tmp_path / f"{tag}.fa"
        rc, err = _run(port_cli, base + [str(path)] + extra)
        assert rc == 0, err
        outs[tag] = path.read_bytes()
    want = (jax_shards_out / f"{layout}-{preset}.fa").read_bytes()
    assert outs["work"] == outs["dir"] == outs["index"] == want
    assert want.count(b">") == world["n"]
    assert len(set(want.split(b"\n")[1::2])) > 2


def test_cli_mesh_index_matches_jax(world, tmp_path):
    """``--mesh`` and ``--mesh 1`` over one --index (served as it is on
    the one device) give the bytes of the run without --mesh and of
    umgap_tpu's --mesh 1 (its index re-split into one shard), the four
    9-mer presets in one run."""
    base = ["analyse", "--taxons", str(world["taxons"]), "--index",
            str(world["merged"]), "--batch-size", "64", "--read-length",
            str(L)]
    assert _run(jax_cli, base + ["--mesh", "1", "--fgspp", "never"]
                + _samples(world, tmp_path, "jax"))[0] == 0
    for tag, extra in (("plain", []), ("auto", ["--mesh"]),
                       ("one", ["--mesh", "1"])):
        rc, err = _run(port_cli, base + ["--device", "cpu", *extra]
                       + _samples(world, tmp_path, tag))
        assert rc == 0, err
    for p in PRESETS:
        want = (tmp_path / f"jax-{p}.fa").read_bytes()
        for tag in ("plain", "auto", "one"):
            assert (tmp_path / f"{tag}-{p}.fa").read_bytes() == want


def test_cli_mesh_tryptic(world, tmp_path):
    """A tryptic preset under --mesh serves the peptide index on the one
    device (K8 stays ungrouped) and gives the bytes of the run without
    --mesh; an index without stored keys is refused with umgap_tpu's
    message."""
    from umgap_tpu_torch.index.table import PeptideTable

    rng = np.random.default_rng(6)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    peps = sorted({"".join(rng.choice(aa, rng.integers(9, 20)))
                   for _ in range(500)})
    pt = PeptideTable.build(peps, rng.integers(2, 20, size=len(peps)).astype(
        np.int32))
    pindex = tmp_path / "tryptic.npz"
    pt.save(pindex)
    base = ["analyse", "--taxons", str(world["taxons"]), "--index",
            str(pindex), "-t", "tryptic-sensitivity", "-1",
            str(world["fq"][0]), "-2", str(world["fq"][1]), "--read-length",
            str(L), "--device", "cpu", "--fgspp", "never", "-o"]
    for tag, extra in (("plain", []), ("mesh", ["--mesh"])):
        rc, err = _run(port_cli, base + [str(tmp_path / f"{tag}.fa"),
                                         *extra])
        assert rc == 0, err
    assert (tmp_path / "mesh.fa").read_bytes() == \
        (tmp_path / "plain.fa").read_bytes()
    pt.raw_keys = None
    pt.save(pindex)
    rc, err = _run(port_cli, base + [str(tmp_path / "x.fa"), "--mesh"])
    jbase = [a for a in base if a not in ("--device", "cpu")]
    jrc, jerr = _run(jax_cli, jbase + [str(tmp_path / "y.fa"), "--mesh",
                                       "1"])
    assert rc == jrc == 1
    assert err == jerr and "stored keys" in err


# ---------------------------------------------------------------------- #
# Failure modes, as tests/test_shards_failures.py drives umgap_tpu's
# ---------------------------------------------------------------------- #

def _both_fail(world, work, extra=(), jax_extra=("--mesh", "1"), fq=None):
    """The same failing --shards run through umgap_tpu and the port:
    both exit 1 with the same error line (the port's stderr may also say
    which ingest tier handed the sample on)."""
    r1, r2 = fq or world["fq"]
    argv = ["analyse", "-t", "max-sensitivity", "-1", str(r1), "-2",
            str(r2), "--taxons", str(world["taxons"]), "--shards", str(work),
            "--batch-size", "16", "--read-length", str(L), *extra]
    jrc, jerr = _run(jax_cli, argv + list(jax_extra) + ["--fgspp", "never"])
    rc, err = _run(port_cli, argv + ["--device", "cpu"])
    assert jrc == rc == 1, (jerr, err)
    assert err.splitlines()[-1] == jerr.splitlines()[-1]
    assert err.splitlines()[-1].startswith("Error: ")
    return err


def _clone(world, tmp_path, layout="bucket16"):
    dst = tmp_path / "w"
    shutil.copytree(world["works"][layout], dst)
    return dst


def test_fail_missing_shard(world, tmp_path):
    work = _clone(world, tmp_path)
    os.remove(work / "shards" / "shard_003.npz")
    err = _both_fail(world, work)
    assert "shard artifact missing" in err and "shard_003.npz" in err
    assert "re-run buildindex-dist" in err


def test_fail_truncated_shard(world, tmp_path):
    work = _clone(world, tmp_path)
    path = work / "shards" / "shard_002.npz"
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)
    jrc, jerr = _run(jax_cli, ["analyse", "-t", "max-sensitivity", "-1",
                               str(world["fq"][0]), "--taxons",
                               str(world["taxons"]), "--shards", str(work),
                               "--mesh", "1", "--fgspp", "never"])
    rc, err = _run(port_cli, ["analyse", "-t", "max-sensitivity", "-1",
                              str(world["fq"][0]), "--taxons",
                              str(world["taxons"]), "--shards", str(work),
                              "--device", "cpu"])
    assert jrc == rc == 1
    # the reader's own exception text follows the path; the rest is
    # umgap_tpu's message
    head = f"Error: shard artifact unreadable (truncated or corrupt): {path}:"
    tail = (f"; delete it and its .done marker, then re-run "
            f"buildindex-dist --workdir {work}\n")
    for e in (err, jerr):
        assert e.startswith(head) and e.endswith(tail)


def _rebuild_shard(work, s, **kw):
    path = work / "shards" / f"shard_{s:03d}.npz"
    keys, vals = jtable.load_table(str(path)).items()
    jtable.KmerTable.build(keys.astype(np.uint64), vals, k=9,
                           stash_cap=256, **kw).save(path, packed=True)


def test_fail_mixed_layouts(world, tmp_path):
    work = _clone(world, tmp_path)
    cap = json.load(open(work / "manifest.json"))["capacity"]
    _rebuild_shard(work, 5, bucket=64, max_probe_limit=0, capacity=cap)
    err = _both_fail(world, work)
    assert "geometry mismatch" in err and "shard 5" in err
    assert "bucket=64" in err and "bucket=16" in err


def test_fail_capacity_mismatch(world, tmp_path):
    work = _clone(world, tmp_path)
    cap = json.load(open(work / "manifest.json"))["capacity"]
    _rebuild_shard(work, 1, bucket=16, max_probe_limit=1, capacity=2 * cap)
    err = _both_fail(world, work)
    assert "geometry mismatch" in err and "shard 1" in err


def test_fail_hbm_guard_rebuild(world, monkeypatch):
    monkeypatch.setenv("UMGAP_HBM_BYTES", "100000")
    err = _both_fail(world, world["works"]["bucket16"])
    assert "rebuild with more shards" in err


def test_fail_hbm_guard_divisor_advice(world, monkeypatch):
    """A raw need of 3 devices on a 16-shard artifact rounds up to the
    divisor 4."""
    cap = json.load(open(os.path.join(world["works"]["bucket16"],
                                      "manifest.json")))["capacity"]
    monkeypatch.setenv("UMGAP_HBM_BYTES", str(int(16 * cap * 8 / 2.5 /
                                                  0.95)))
    err = _both_fail(world, world["works"]["bucket16"])
    assert "serve this artifact on a mesh of >= 4 devices" in err


def test_fail_no_manifest(world, tmp_path):
    (tmp_path / "empty").mkdir()
    err = _both_fail(world, tmp_path / "empty")
    assert "no manifest.json" in err


def test_fail_mesh_not_a_divisor(world):
    """--mesh 5 over 16 shards (umgap_tpu on its 8 test devices)."""
    err = _both_fail(world, world["works"]["bucket16"], ("--mesh", "5"),
                     jax_extra=())
    assert "16 shards cannot be grouped onto the 5-device mesh" in err


def test_fail_records_past_width_cap(world):
    err = _both_fail(world, world["works"]["bucket16"], fq=world["long_fq"])
    assert "--shards mode cannot serve them" in err


def test_mesh_of_more_devices_refused(world, monkeypatch):
    """On CUDA a mesh of more devices than the visible cards is refused
    with umgap_tpu's message (a mesh of 8 on its 8 test devices would
    run; 9 would not), before any data is read: nothing is emulated on a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["analyse", "-t", "max-sensitivity", "-1", str(world["fq"][0]),
            "--taxons", str(world["taxons"]), "--shards",
            world["works"]["bucket16"], "--mesh", "2"]
    rc, err = _run(port_cli, argv)
    assert rc == 1 and err == "Error: need 2 devices, have 1\n"
    jrc, jerr = _run(jax_cli, argv[:-1] + ["9", "--fgspp", "never"])
    assert jrc == 1 and jerr == "Error: need 9 devices, have 8\n"


def _mock_fgspp():
    """chip_smoke.py's mock FGSpp (frame 1 of each strand split at stops,
    stretches of 20 residues or more as genes)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.MOCK_FGSPP


@pytest.mark.parametrize("mode", ["auto", "require"])
def test_cli_mesh_fgspp(world, tmp_path, monkeypatch, mode):
    """Under --mesh an FGSpp preset translates six frames with FGSpp
    installed (auto: the bytes of --fgspp never) and refuses require
    with umgap_tpu's message."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    d = tmp_path / "unipept" / "FGSpp"
    (d / "train").mkdir(parents=True)
    (d / "FGSpp").write_text(_mock_fgspp())
    (d / "FGSpp").chmod(0o755)
    base = ["analyse", "--taxons", str(world["taxons"]), "--shards",
            world["works"]["bucket64s"], "-t", "high-precision", "-1",
            str(world["fq"][0]), "-2", str(world["fq"][1]),
            "--read-length", str(L), "--fgspp", mode, "-o"]
    rc, err = _run(port_cli, base + [str(tmp_path / "p.fa"), "--device",
                                     "cpu"])
    jrc, jerr = _run(jax_cli, base + [str(tmp_path / "j.fa"), "--mesh",
                                      "1"])
    if mode == "require":
        assert rc == jrc == 1 and err == jerr
        assert "--fgspp require is not supported with --mesh" in err
        return
    assert rc == jrc == 0, err
    assert "FGSpp" not in err
    got = (tmp_path / "p.fa").read_bytes()
    assert got == (tmp_path / "j.fa").read_bytes()
    assert got.count(b">") == world["n"]


def test_cli_trace_dir_cpu(world, tmp_path, monkeypatch):
    """--trace-dir (and UMGAP_TRACE_DIR) on the CPU write a Chrome trace
    of the run."""
    for how in ("flag", "env"):
        tdir = tmp_path / how
        extra = ["--trace-dir", str(tdir)] if how == "flag" else []
        if how == "env":
            monkeypatch.setenv("UMGAP_TRACE_DIR", str(tdir))
        rc, err = _run(port_cli, [
            "analyse", "--taxons", str(world["taxons"]), "--shards",
            world["works"]["bucket16"], "-t", "high-sensitivity", "-1",
            str(world["fq"][0]), "-2", str(world["fq"][1]),
            "--read-length", str(L), "--device", "cpu", "-o",
            str(tmp_path / f"{how}.fa"), *extra])
        assert rc == 0, err
        traces = glob.glob(str(tdir / "*.pt.trace.json"))
        assert len(traces) == 1
        events = json.load(open(traces[0]))["traceEvents"]
        assert any(e.get("name", "").startswith("aten::") for e in events)
