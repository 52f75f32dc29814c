"""The formulations of K3's and K4's row kernels (rows past the main
path's variants: more than 96 windows a lane, more than 1,024 hits a
row), held to ``umgap_tpu``: ``seedextend_runs_plain`` (the state machine
stepped only where it can change state, kept seeds as intervals) against
the JAX scan and the host state machine, ``dedup_counts_rows_plain``
(each row's valid hits compacted, sorted and counted alone) against the
JAX dedup, on seeded numpy rows and hypothesis cases; and a few 12,000 bp
records through the port's ``Analyser`` on the CPU against
``umgap_tpu``'s at the same read length and its exact host route. Exact
equality throughout."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from umgap_tpu import cli as jcli
from umgap_tpu import ranks as jranks
from umgap_tpu.agg import device as jagg
from umgap_tpu.index.table import build_kmer_table as jbuild
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import seedextend as jseed
from umgap_tpu.ops import translate as jtrans
from umgap_tpu.pipeline import PRESETS as JPRESETS
from umgap_tpu.pipeline.runner import Analyser as JAnalyser
from umgap_tpu.taxonomy import Taxon as JTaxon
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu_torch import convert
from umgap_tpu_torch.agg import device as pagg
from umgap_tpu_torch.ops import seedextend as pseed
from umgap_tpu_torch.pipeline.fused import PRESETS
from umgap_tpu_torch.pipeline.runner import Analyser

SETTINGS = settings(max_examples=25, deadline=None, derandomize=True)


def _lanes(rng, lanes, N):
    """Runs of equal taxa with gaps, and the cases the machine treats
    apart: an all-zero lane, leading gaps of 1-3 windows before a run
    (the b2 branch at g >= the gap), a one-window taxon after a leading
    gap, trailing gaps, one-window runs, a lane of one long run; lengths
    0, N, above N and random."""
    t = rng.choice(np.array([0, 0, 0, 5, 6, 7], np.int32), size=(lanes, N))
    rep = rng.random((lanes, N)) < 0.6
    for j in range(1, N):
        t[:, j] = np.where(rep[:, j], t[:, j - 1], t[:, j])
    t[0] = 0
    for i, z in ((1, 1), (2, 2), (3, 3)):
        t[i, :z] = 0
        t[i, z:z + 4] = 9
    t[4, :2] = 0
    t[4, 2] = 9  # one window of 9 after the gap, then 0 or 5
    t[4, 3] = 0
    t[5, N - 7:] = 0  # a trailing gap
    t[6] = np.arange(N) % 3  # one-window runs
    t[7] = 4
    lens = rng.integers(0, N + 1, size=lanes).astype(np.int32)
    lens[8], lens[9], lens[10] = 0, N, N + 5
    lens[:8] = N
    lens[5] = N - 3
    return t, lens


@pytest.mark.parametrize("N,s,g", [
    (n, s, g) for n in (97, 162, 1357) for s, g in ((1, 0), (2, 0), (3, 1),
                                                     (2, 2), (4, 3))]
    + [(4100, 1, 0), (4100, 3, 1), (4100, 2, 2)])
def test_seedextend_runs_plain_matches_jax(N, s, g):
    """The run-level machine at widths from the tile's end (97) through
    the width ladder's rungs (162, 1,357) to past 4,096 windows, mask and
    hits, against the JAX scan and the host state machine."""
    rng = np.random.default_rng(N + 10 * s + g)
    taxa, lens = _lanes(rng, 40, N)
    want = np.asarray(jseed.seedextend_mask_batch(taxa, lens, s, g))
    tt, tl = torch.from_numpy(taxa), torch.from_numpy(lens)
    got = pseed.seedextend_runs_plain(tt, tl, s, g)
    np.testing.assert_array_equal(got.numpy(), want)
    hits = pseed.seedextend_runs_plain(tt, tl, s, g, hits=True)
    assert hits.dtype == torch.int32
    np.testing.assert_array_equal(hits.numpy(), np.where(want, taxa, 0))
    for i in range(12):  # the reference state machine, per lane
        ref = np.zeros(N, bool)
        n = min(int(lens[i]), N)
        for a, b in jseed.seedextend_host(taxa[i, :n], s, g):
            ref[a:min(b, n)] = True
        np.testing.assert_array_equal(got[i].numpy(), ref)


@SETTINGS
@given(st.integers(97, 4100), st.integers(1, 5), st.integers(0, 4),
       st.integers(0, 2 ** 32 - 1), st.floats(0.0, 0.95))
def test_seedextend_runs_plain_cases(N, s, g, seed, stick):
    """Random widths 97-4,100, seeds 1-5, gaps 0-4, runs of any length
    (``stick`` the chance a window repeats its left neighbour), against
    the host state machine of ``umgap_tpu``."""
    rng = np.random.default_rng(seed)
    lanes = 6
    t = rng.choice(np.array([0, 0, 3, 8], np.int32), size=(lanes, N))
    rep = rng.random((lanes, N)) < stick
    for j in range(1, N):
        t[:, j] = np.where(rep[:, j], t[:, j - 1], t[:, j])
    t[0, :int(rng.integers(0, g + 2))] = 0
    lens = rng.integers(0, N + 2, size=lanes).astype(np.int32)
    lens[1] = N
    got = pseed.seedextend_runs_plain(torch.from_numpy(t),
                                      torch.from_numpy(lens), s, g).numpy()
    for i in range(lanes):
        ref = np.zeros(N, bool)
        n = min(int(lens[i]), N)
        for a, b in jseed.seedextend_host(t[i, :n], s, g):
            ref[a:min(b, n)] = True
        np.testing.assert_array_equal(got[i], ref)


def _hit_rows(rng, B, N):
    """Rows of N hits: all invalid, ids < 0 and 0 among valid ones, 1 to
    N valid entries, pools of 3 to 2^30 distinct ids (more than any
    k_max tried), one id repeated over a whole row."""
    taxa = rng.integers(-3, 1, size=(B, N)).astype(np.int32)
    n_valid = rng.integers(0, N + 1, size=B)
    n_valid[:4] = (0, 1, 33, N)
    for b in range(B):
        pos = rng.choice(N, size=n_valid[b], replace=False)
        pool = (3, 60, 5000, 1 << 30)[b % 4]
        taxa[b, pos] = rng.integers(1, pool + 1, size=n_valid[b])
    taxa[4] = 7
    return taxa


def _first_seen(taxa, out):
    """umgap_tpu's dedup_counts output (ids ascending) with each row's
    slots put in first-seen order, as a weighted dedup of the port hands
    them over (agg/device.py first_seen_order): by each id's first
    position in the row, padding last."""
    ut, uc, uv = (np.asarray(a) for a in out[:3])
    key = np.full(ut.shape, np.iinfo(np.int32).max, np.int64)
    for b in range(ut.shape[0]):
        pos = {}
        for i, t in enumerate(taxa[b].tolist()):
            if t > 0:
                pos.setdefault(t, i)
        for k, t in enumerate(ut[b].tolist()):
            if t in pos and t != np.iinfo(np.int32).max:
                key[b, k] = pos[t]
    perm = np.argsort(key, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, perm, axis=1)
    return (take(ut), take(uc), take(uv)) + tuple(out[3:])


@pytest.mark.parametrize("N", [1025, 1944, 3996, 16284, 24576])
@pytest.mark.parametrize("k_max,weighted", [(64, False), (64, True),
                                            (30000, False), (5, True)])
def test_dedup_counts_rows_plain_matches_jax(N, k_max, weighted):
    """Compact-then-count from just past the warp path (1,025 hits)
    through the width ladder's rungs to 24,576, with integer weights
    (0-3) and without, k_max below and above the distinct count."""
    rng = np.random.default_rng(N + k_max + weighted)
    B = 10
    taxa = _hit_rows(rng, B, N)
    w = (rng.integers(0, 4, size=(B, N)).astype(np.float32) if weighted
         else np.ones((B, N), np.float32))
    want = jagg.dedup_counts(taxa, w, k_max, return_nuniq=True)
    if weighted:
        want = _first_seen(taxa, want)
    got = pagg.dedup_counts_rows_plain(
        torch.from_numpy(taxa), torch.from_numpy(w) if weighted else None,
        k_max, return_nuniq=True)
    for a, b in zip(got, want):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@SETTINGS
@given(st.sampled_from([1025, 1100, 2048]), st.sampled_from([1, 64, 2000]),
       st.booleans(), st.integers(0, 2 ** 32 - 1), st.floats(0.0, 1.0),
       st.sampled_from([2, 40, 1 << 20]))
def test_dedup_counts_rows_plain_cases(N, k_max, weighted, seed, density,
                                       pool):
    """Random densities of valid hits and pools of ids, with and without
    integer weights, against the JAX dedup."""
    rng = np.random.default_rng(seed)
    B = 3
    taxa = rng.integers(-pool, pool + 1, size=(B, N)).astype(np.int32)
    taxa[rng.random((B, N)) >= density] = 0
    w = (rng.integers(0, 4, size=(B, N)).astype(np.float32) if weighted
         else np.ones((B, N), np.float32))
    want = jagg.dedup_counts(taxa, w, k_max, return_nuniq=True)
    if weighted:
        want = _first_seen(taxa, want)
    got = pagg.dedup_counts_rows_plain(
        torch.from_numpy(taxa), torch.from_numpy(w) if weighted else None,
        k_max, return_nuniq=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


LONG_BP = 12000


def _long_records(seed=21):
    """A taxonomy of 300 taxa, four single-end records at the 12,000 bp
    device width (one of 11,003 bp, N-padded) and a 9-mer index of the
    k-mers of two of every three 2,000 bp stretches of each record, one
    taxon for each stretch of a frame (so a record's groups stay within
    k_max = 64 distinct taxa and the fast program answers them), a few
    k-mers of each stretch moved to its next frame's taxon (seeds
    broken by gaps and other taxa)."""
    rng = np.random.default_rng(seed)
    n = 300
    parent = [1, 1] + [int(rng.integers(1, i)) for i in range(2, n + 1)]
    rows = [(i, f"t{i}", 14 if i % 3 == 0 else jranks.NO_RANK, parent[i],
             i % 17 != 5) for i in range(1, n + 1)]
    tax = JTaxonomy([JTaxon(*r) for r in rows])
    lens = [LONG_BP, LONG_BP, 11003, LONG_BP]
    seqs = ["".join(rng.choice(list("ACGT"), size=m)) for m in lens]
    keys, vals = [], []
    for i, seq in enumerate(seqs):
        for a in range(0, len(seq), 2000):
            if (a // 2000 + i) % 3 == 2:
                continue
            part = seq[a:a + 2000]
            for f, pep in enumerate(jtrans.translate_sequence(
                    part, jtrans.FRAME_NAMES, jenc.get_table(1))):
                packed = jkmers.pack_kmers_host(jenc.encode_aa(pep), 9)
                def taxon(f):
                    return 2 + (31 * i + 7 * (a // 2000) + 3 * f) % (n - 2)

                v = np.full(len(packed), taxon(f))
                v[rng.random(len(packed)) < 0.05] = taxon((f + 1) % 6)
                keep = rng.random(len(packed)) < 0.9
                keys.append(packed[keep])
                vals.append(v[keep])
    keys, first = np.unique(np.concatenate(keys), return_index=True)
    vals = np.concatenate(vals)[first].astype(np.int32)
    return tax, seqs, jbuild(keys, vals, 9)


def test_analyser_12000bp_matches_jax():
    """Four records at the 12,000 bp device width through the port's
    ``Analyser`` on the CPU (K3's rows of 3,992 windows and K4's of 23,952
    hits in their plain versions) against ``umgap_tpu``'s ``Analyser`` at
    the same read length and against its exact host route
    (``umgap_tpu.cli._analyse_long_group_host``), high-sensitivity; the
    rows the two kernels' formulations take equal the pipeline's."""
    from umgap_tpu.agg.device import DeviceTaxonomy as JDeviceTaxonomy
    from umgap_tpu.ops.lookup import DeviceTable as JDeviceTable

    tax, seqs, table = _long_records()
    cfg = "high-sensitivity"
    codes = np.full((len(seqs), 1, LONG_BP), jenc.DNA_N, np.uint8)
    lens = np.zeros((len(seqs), 1), np.int32)
    for i, s in enumerate(seqs):
        codes[i, 0, :len(s)] = jenc.encode_dna(s)
        lens[i, 0] = len(s)
    headers = [f"c{i}" for i in range(len(seqs))]
    ja = JAnalyser(tax, table, JPRESETS[cfg], batch_size=4,
                   read_length=LONG_BP, ends=1)
    want = list(ja.analyse_arrays(headers, codes, lens))
    host = [jcli._analyse_long_group_host([s], JPRESETS[cfg], 1, tax, table,
                                          {}) for s in seqs]
    assert [t for _h, t in want] == host
    dt, dx = JDeviceTable.from_host(table), JDeviceTaxonomy.from_host(tax)
    pt = convert.table_from_arrays(
        np.asarray(dt.rows), np.asarray(dt.stash), dt.max_probes, dt.kind,
        dt.nb_bits, dt.bucket, dt.group, device="cpu")
    px = convert.taxonomy_from_arrays(
        np.asarray(dx.depth), np.asarray(dx.anc), np.asarray(dx.snap_valid),
        np.asarray(dx.snap_ranked), dx.root, np.asarray(dx.seed_scores),
        device="cpu")
    pa = Analyser(None, None, PRESETS[cfg], batch_size=4,
                  read_length=LONG_BP, ends=1, dtax=px, dtable=pt,
                  device="cpu")
    seen = {}
    hits0, dedup0 = pseed.seedextend_hits_plain, pagg.dedup_counts_plain

    def hits(taxa, lengths, s, g):
        out = hits0(taxa, lengths, s, g)
        assert torch.equal(out, pseed.seedextend_runs_plain(
            taxa, lengths, s, g, hits=True))
        seen["hits"] = tuple(taxa.shape)
        return out

    def dedup(taxa, weights, k_max, return_nuniq=False, lower_bound=None):
        out = dedup0(taxa, weights, k_max, return_nuniq, lower_bound)
        for a, b in zip(out, pagg.dedup_counts_rows_plain(
                taxa, weights, k_max, return_nuniq, lower_bound)):
            assert torch.equal(a, b)
        seen["dedup"] = tuple(taxa.shape)
        return out

    pseed.seedextend_hits_plain, pagg.dedup_counts_plain = hits, dedup
    try:
        got = list(pa.analyse_arrays(headers, codes, lens))
    finally:
        pseed.seedextend_hits_plain, pagg.dedup_counts_plain = hits0, dedup0
    assert got == want
    assert seen == {"hits": (4, 6, 3992), "dedup": (4, 23952)}
    assert pa.overflow_reads == ja.overflow_reads == 0
    assert len({t for _h, t in got}) > 1
