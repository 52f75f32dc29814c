"""Parity of the port's fused pipeline and Analyser (plain PyTorch on the
CPU) with ``umgap_tpu.pipeline``: all four 9-mer presets and the two
Euler/RMQ aggregations (rmq/lca*, rmq/hybrid) on a toy world, the first
1,024 ``.bench_data`` pairs with the state carried across by
``convert``, and the k_max overflow re-route. Exact equality."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.agg import device_rmq as jrmq
from umgap_tpu.index.table import build_kmer_table as jbuild
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import lookup as jlookup
from umgap_tpu.ops import translate as jtrans
from umgap_tpu.pipeline import PRESETS as JPRESETS
from umgap_tpu.pipeline.fused import PipelineConfig as JPipelineConfig
from umgap_tpu.pipeline.fused import make_pipeline as jmake
from umgap_tpu.pipeline.fused import pipeline_step as jstep
from umgap_tpu.pipeline.runner import Analyser as JAnalyser
from umgap_tpu.taxonomy import Taxon, Taxonomy, fixture_taxa
from umgap_tpu_torch import convert, kernels
from umgap_tpu_torch import taxonomy as ptaxonomy
from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.agg import device_rmq as prmq
from umgap_tpu_torch.ops import encoding as penc
from umgap_tpu_torch.ops import gather
from umgap_tpu_torch.ops import seedextend as pseedextend
from umgap_tpu_torch.ops import translate as ptranslate
from umgap_tpu_torch.pipeline.fused import PRESETS, make_pipeline, \
    pipeline_step, run_stages
from umgap_tpu_torch.pipeline.runner import Analyser

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_data")


def carry(dt, dx):
    """The JAX package's device state as the port's, via ``convert``."""
    pt = convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu")
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    return pt, px


@pytest.fixture(scope="module")
def toy():
    """Fixture taxonomy, random reads (B=8, E=2, L=48) and a table holding
    random keys plus some of the reads' own k-mers, so that hits occur."""
    rng = np.random.default_rng(0)
    tax = Taxonomy(fixture_taxa())
    B, E, L = 8, 2, 48
    dna = rng.integers(0, 4, size=(B, E, L)).astype(np.uint8)
    lengths = rng.integers(20, L + 1, size=(B, E)).astype(np.int32)
    lengths[0] = L
    aa, pl = jtrans.translate6_batch(dna.reshape(B * E, L),
                                     lengths.reshape(-1), jenc.get_table(1))
    hi, lo, v = (np.asarray(x) for x in jkmers.pack_windows_batch(aa, pl, 9))
    ids = np.array([2, 10239, 12884, 185751, 185752], dtype=np.int32)
    # the k-mers of one (read group, frame) point at one taxon (long runs
    # of equal hits, as real reads give; several taxa per group), random
    # extra keys at random taxa
    group = ((np.arange(B * E) // E)[:, None, None]
             + np.arange(6)[None, :, None] + 0 * v)
    planted, first = np.unique(jkmers.join_packed(hi[v], lo[v]),
                               return_index=True)
    extra = np.setdiff1d(rng.integers(0, 2 ** 45, size=512).astype(
        np.uint64), planted)
    packed = np.concatenate([planted, extra])
    values = np.concatenate([ids[group[v][first] % len(ids)],
                             rng.choice(ids, size=len(extra))]).astype(
        np.int32)
    table = jbuild(packed, values, k=9)
    dt = jlookup.DeviceTable.from_host(table)
    dx = jagg.DeviceTaxonomy.from_host(tax)
    return dict(tax=tax, table=table, dt=dt, dx=dx, dna=dna,
                lengths=lengths, state=carry(dt, dx))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_pipeline_step_presets_match_jax(toy, preset):
    pt, px = toy["state"]
    for k_max in (64, 3):
        want, wov = jstep(toy["dna"], toy["lengths"], toy["dx"], toy["dt"],
                          JPRESETS[preset]._replace(k_max=k_max),
                          with_overflow=True)
        got, gov = pipeline_step(torch.from_numpy(toy["dna"]),
                                 torch.from_numpy(toy["lengths"]), px, pt,
                                 PRESETS[preset]._replace(k_max=k_max),
                                 with_overflow=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    assert gov.numpy().any()  # hits survived: > 3 taxa in some groups


def test_packed_wire_agrees_with_codes(toy):
    pt, px = toy["state"]
    cfg = PRESETS["high-sensitivity"]
    dna, lengths = toy["dna"], toy["lengths"]
    a = pipeline_step(torch.from_numpy(dna), torch.from_numpy(lengths), px,
                      pt, cfg)
    b = make_pipeline(px, pt, cfg, device="cpu")(
        torch.from_numpy(penc.pack_dna4(dna)), torch.from_numpy(lengths),
        dna.shape[-1])
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _run_stages(toy, cfg, plain):
    pt, px = toy["state"]
    dna, lengths = toy["dna"], toy["lengths"]
    B, E, L = dna.shape
    return run_stages(torch.from_numpy(dna.reshape(B * E, L)),
                      torch.from_numpy(lengths), L, False, px, pt, cfg,
                      plain=plain)


def test_plain_stages_call_no_wrapper(toy, monkeypatch):
    """run_stages(plain=True) reaches the plain versions only, through the
    one switch, and leaves it off; the kernel path calls the wrappers:
    K4 with the lower bound, then the tree aggregator through its hits
    entry, which builds no geometry (no row gather, no ancestry
    epilogue) and snaps (no take); the Euler/RMQ aggregators are one
    call of K9's wrapper, which snaps too."""
    calls = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("take", "gather_rows", "lane_gather", "ancestry"):
        spy(gather, name)
    spy(ptranslate, "reads_to_kmers")
    spy(pseedextend, "seedextend_hits")
    spy(pseedextend, "seedextend_mask_batch")
    spy(pagg, "tree_aggregate_hits")
    spy(pagg, "tree_aggregate")
    spy(pagg, "dedup_counts")
    spy(prmq, "rmq_aggregate")
    cfg = PRESETS["max-sensitivity"]
    want = _run_stages(toy, cfg, plain=False)
    assert {"reads_to_kmers", "seedextend_hits", "dedup_counts",
            "tree_aggregate_hits"} <= set(calls)
    assert calls.count("tree_aggregate_hits") == 1
    assert calls.count("dedup_counts") == 1
    # the hits come from the one entry: no keep mask on the kernel path
    assert "seedextend_mask_batch" not in calls
    # K4 filters, K6 reads the rows itself and snaps: no geometry and no
    # snap between them
    assert not {"take", "gather_rows", "ancestry", "tree_aggregate",
                "rmq_aggregate"} & set(calls)
    calls.clear()
    got = _run_stages(toy, cfg, plain=True)
    assert calls == [] and not kernels.plain_selected()
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # rmq/hybrid: one call of K9's wrapper (its plain version on the
    # CPU reaches K5's plain versions only, through the switch)
    hyb = cfg._replace(strategy="hybrid")
    calls.clear()
    want = _run_stages(toy, hyb, plain=False)
    assert calls.count("rmq_aggregate") == 1
    assert not {"take", "tree_aggregate_hits"} & set(calls)
    calls.clear()
    got = _run_stages(toy, hyb, plain=True)
    assert calls == [] and not kernels.plain_selected()
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_hybrid_skips_the_ancestry_gather(toy, monkeypatch):
    """Tree hybrid never reads is_anc, so its step makes no (B, K, K)
    ancestry gather or epilogue; its taxa are those of the full
    geometry. Its aggregator is one call of the hits entry."""
    calls = []
    for name in ("lane_gather", "ancestry"):
        fn = getattr(gather, name)
        monkeypatch.setattr(gather, name, lambda *a, fn=fn, **kw: (
            calls.append(1), fn(*a, **kw))[1])
    hits = []
    fn = pagg.tree_aggregate_hits
    monkeypatch.setattr(pagg, "tree_aggregate_hits", lambda *a, **kw: (
        hits.append(a[0]), fn(*a, **kw))[1])
    cfg = PRESETS["high-sensitivity"]
    got = _run_stages(toy, cfg, plain=False)
    assert calls == []
    assert hits == ["hybrid"]
    pt, px = toy["state"]
    dna, lengths = toy["dna"], toy["lengths"]
    want = jstep(dna, lengths, toy["dx"], toy["dt"], JPRESETS[cfg.name])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def bench():
    """The first 1,024 .bench_data pairs, its taxonomy and 2 M-key index."""
    with open(os.path.join(DATA, "manifest.json")) as f:
        man = json.load(f)
    P, L = man["n_pairs"], man["read_len"]
    parent = np.fromfile(os.path.join(DATA, "parent.bin"), np.int32)
    snap = np.fromfile(os.path.join(DATA, "snap.bin"), np.int32)
    tax = Taxonomy([Taxon(i, f"t{i}", jranks.NO_RANK if i % 3 else 14,
                          int(parent[i]), bool(snap[i] == i))
                    for i in range(1, man["n_tax"] + 1)])
    keys = np.fromfile(os.path.join(DATA, "index_keys.bin"), np.uint64)
    vals = np.fromfile(os.path.join(DATA, "index_vals.bin"), np.int32)
    table = jbuild(keys, vals, k=9)
    n = 1024
    reads = np.fromfile(os.path.join(DATA, "reads.bin"),
                        np.uint8).reshape(P, 2, L)[:n]
    return dict(tax=tax, table=table, reads=reads, L=L, n=n,
                lengths=np.full((n, 2), L, dtype=np.int32))


def test_bench_data_first_1024_pairs_high_sensitivity(bench):
    dt = jlookup.DeviceTable.from_host(bench["table"])
    dx = jagg.DeviceTaxonomy.from_host(bench["tax"])
    pt, px = carry(dt, dx)
    L, lengths = bench["L"], bench["lengths"]
    dna4 = jenc.pack_dna4(bench["reads"])
    cfg = JPRESETS["high-sensitivity"]
    want, wov = jmake(dx, dt, cfg, wire="packed4",
                      with_overflow=True)(dna4, lengths, L)
    got, gov = make_pipeline(px, pt, PRESETS["high-sensitivity"],
                             wire="packed4", with_overflow=True,
                             device="cpu")(torch.from_numpy(dna4),
                                           torch.from_numpy(lengths), L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    assert len(np.unique(got.numpy())) > 50


@pytest.mark.parametrize("preset", ["max-sensitivity", "high-sensitivity"])
def test_analyser_wide_reroute_matches_jax(toy, preset):
    """k_max=2 sends most groups through the wide (exact) program."""
    rng = np.random.default_rng(5)
    n, L = 150, 48
    dna = np.concatenate([np.tile(toy["dna"], (n // 8 + 1, 1, 1))[:n - 20],
                          rng.integers(0, 4, size=(20, 2, L)).astype(
                              np.uint8)])
    lens = np.concatenate([np.tile(toy["lengths"], (n // 8 + 1, 1))[:n - 20],
                           rng.integers(0, L + 1, size=(20, 2)).astype(
                               np.int32)])
    headers = [f"g{i}" for i in range(n)]
    cfg = JPRESETS[preset]._replace(k_max=2)
    ja = JAnalyser(toy["tax"], toy["table"], cfg, batch_size=64,
                   read_length=L, ends=2)
    want = list(ja.analyse_arrays(headers, dna, lens))
    pt, px = toy["state"]
    pa = Analyser(None, None, PRESETS[preset]._replace(k_max=2),
                  batch_size=64, read_length=L, ends=2, dtax=px, dtable=pt,
                  device="cpu")
    got = list(pa.analyse_arrays(headers, dna, lens))
    assert got == want
    assert pa.overflow_reads == ja.overflow_reads > 0


@pytest.mark.parametrize("method,strategy", [
    ("tree", "hybrid"), ("tree", "lca*"), ("rmq", "mrtl"), ("rmq", "lca*"),
    ("rmq", "hybrid")])
def test_wide_batch_rows(toy, method, strategy):
    """The wide program's batch: (1 << 28) // K^2 groups (the JAX
    package's bound, umgap_tpu/pipeline/runner.py) where the step builds
    (B, K, K) tensors, the plain versions (on the CPU, or on the card
    within kernels.plain_versions()); up to 64 on the card, where a
    row's buffers grow with K (64 groups a batch at 4,096 bp,
    K = 16,392, and at 8,000 bp, K = 32,004), rmq/hybrid too since K9
    builds no (B, K, K) tensor."""
    from umgap_tpu_torch.pipeline import runner

    def old(K):
        return max(1, min(64, (1 << 28) // (K * K)))

    for K in (48, 408, 4104, 16392, 32004):
        assert runner.wide_batch_rows("cpu", method, strategy, K) == old(K)
        assert runner.wide_batch_rows("cuda", method, strategy, K) == 64
        assert runner.wide_batch_rows("cuda", method, strategy, K,
                                      plain=True) == old(K)
    assert runner.wide_batch_rows("cpu", method, strategy, 16392) == 1
    # a row's buffers past 4 MB take fewer groups, never none
    assert runner.wide_batch_rows("cuda", "tree", "lca*", 1 << 20) == 10
    assert runner.wide_batch_rows("cuda", "tree", "lca*", 1 << 24) == 1
    pt, px = toy["state"]
    pa = Analyser(None, None, PRESETS["max-sensitivity"], read_length=4096,
                  dtax=px, dtable=pt, device="cpu")
    assert pa._exact_kmax() == 16392
    assert pa._wide_batch == old(16392) == 1
    with kernels.plain_versions():
        assert pa._wide_batch == 1


@pytest.mark.parametrize("preset", ["max-sensitivity", "high-precision"])
def test_analyser_feed_packed_matches_jax(toy, preset):
    """Batches already on the 4-bit wire (what the native ring stream
    gives: the last one padded with 0x44 rows) through ``feed_packed``,
    with k_max=2 so that most groups re-route from their packed rows:
    the JAX package's ``feed_packed`` taxa, and ``analyse_arrays``'."""
    rng = np.random.default_rng(6)
    n, L, B = 150, 47, 64
    dna = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    dna[:n // 2] = np.tile(toy["dna"][:, :, :L], (n // 16 + 1, 1, 1))[:n // 2]
    lens = rng.integers(0, L + 1, size=(n, 2)).astype(np.int32)
    dna[np.arange(L)[None, None, :] >= lens[:, :, None]] = penc.DNA_N
    headers = [f"g{i}" for i in range(n)]
    dna4 = penc.pack_dna4(dna)
    cfg = JPRESETS[preset]._replace(k_max=2)
    ja = JAnalyser(toy["tax"], toy["table"], cfg, batch_size=B,
                   read_length=L, ends=2)
    pt, px = toy["state"]
    pa = Analyser(None, None, PRESETS[preset]._replace(k_max=2),
                  batch_size=B, read_length=L, ends=2, dtax=px, dtable=pt,
                  device="cpu")

    def run(an):
        out = []
        for s in range(0, n, B):
            d4 = np.full((B, 2, dna4.shape[-1]), 0x44, np.uint8)
            ln = np.zeros((B, 2), np.int32)
            m = min(B, n - s)
            d4[:m], ln[:m] = dna4[s:s + m], lens[s:s + m]
            out += [(h, int(t)) for hs, ts in an.feed_packed(
                headers[s:s + m], d4, ln, m) for h, t in zip(hs, ts)]
        return out + [(h, int(t)) for hs, ts in an.finish_batches()
                      for h, t in zip(hs, ts)]

    got = run(pa)
    assert got == run(ja)
    assert pa.overflow_reads == ja.overflow_reads > 0
    pa.reset()
    assert got == list(pa.analyse_arrays(headers, dna, lens))


def _carry_euler(jtax):
    je = jrmq.DeviceEuler.from_host(jtax)
    return je, convert.euler_from_arrays(
        np.asarray(je.tour), np.asarray(je.depths), np.asarray(je.first),
        np.asarray(je.block_min), np.asarray(je.sparse), je.nlevels,
        je.tour_len, device="cpu")


@pytest.mark.parametrize("strategy", ["lca*", "hybrid"])
def test_pipeline_step_euler_aggregators_match_jax(toy, strategy):
    pt, px = toy["state"]
    je, pe = _carry_euler(toy["tax"])
    for k_max in (64, 3):
        jcfg = JPRESETS["max-sensitivity"]._replace(strategy=strategy,
                                                     k_max=k_max)
        want, wov = jstep(toy["dna"], toy["lengths"], toy["dx"], toy["dt"],
                          jcfg, euler=je, with_overflow=True)
        got, gov = pipeline_step(
            torch.from_numpy(toy["dna"]), torch.from_numpy(toy["lengths"]),
            px, pt, PRESETS["max-sensitivity"]._replace(strategy=strategy,
                                                        k_max=k_max),
            with_overflow=True, euler=pe)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gov.numpy(), np.asarray(wov))
    assert gov.numpy().any()  # hits survived: > 3 taxa in some groups


@pytest.mark.parametrize("strategy,euler", [("lca*", "carried"),
                                            ("lca*", "built"),
                                            ("hybrid", None)])
def test_analyser_euler_aggregators_match_jax(toy, strategy, euler):
    """rmq/lca* and rmq/hybrid through the Analyser, k_max=2 so that most
    groups also go through the wide program; the port's Euler tables are
    either carried from the JAX package or built from its own
    taxonomy."""
    n, L = 120, 48
    dna = np.tile(toy["dna"], (n // 8, 1, 1))
    lens = np.tile(toy["lengths"], (n // 8, 1))
    headers = [f"g{i}" for i in range(n)]
    jcfg = JPRESETS["max-sensitivity"]._replace(strategy=strategy, k_max=2)
    ja = JAnalyser(toy["tax"], toy["table"], jcfg, batch_size=64,
                   read_length=L, ends=2)
    want = list(ja.analyse_arrays(headers, dna, lens))
    pt, px = toy["state"]
    kw = {}
    if euler == "carried":
        kw["euler"] = _carry_euler(toy["tax"])[1]
    ptax = ptaxonomy.Taxonomy(ptaxonomy.fixture_taxa())
    pa = Analyser(ptax, None, PRESETS["max-sensitivity"]._replace(
        strategy=strategy, k_max=2), batch_size=64, read_length=L, ends=2,
        dtax=px, dtable=pt, device="cpu", **kw)
    assert (pa.euler is not None) == (strategy == "lca*")
    got = list(pa.analyse_arrays(headers, dna, lens))
    assert got == want
    assert pa.overflow_reads == ja.overflow_reads > 0


@pytest.mark.parametrize("preset", list(PRESETS) + ["rmq/lca*",
                                                    "rmq/hybrid"])
def test_chip_smoke_reference_digests(bench, preset):
    """chip_smoke.py holds the card's output to digests of umgap_tpu's
    taxa; recompute them here with umgap_tpu."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(DATA), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, L = bench["n"], bench["L"]
    assert smoke.REFERENCE_PAIRS == n
    headers = [str(i) for i in range(n)]
    if preset in PRESETS:
        cfg = JPRESETS[preset]
    else:  # what chip_smoke.py's rmq phase runs
        strategy = preset.split("/")[1]
        assert strategy in smoke.RMQ_STRATEGIES
        cfg = JPipelineConfig(f"rmq-{strategy}", method="rmq",
                              strategy=strategy)
    ja = JAnalyser(bench["tax"], bench["table"], cfg,
                   batch_size=n, read_length=L, ends=2)
    want = [t for _h, t in ja.analyse_arrays(headers, bench["reads"],
                                             bench["lengths"])]
    assert smoke.taxa_digest(want) == smoke.REFERENCE_DIGESTS[preset]
