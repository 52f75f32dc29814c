"""The port's joinkmers and TSV split (``umgap_tpu_torch/index/scale.py``)
against ``umgap_tpu``'s: the join on the CPU (plain torch ops and K6's
plain version) equal to ``umgap_tpu.index.scale.join_kmers_sorted``
(its numpy path and its native path where that builds) array for array,
and the split (K1P's plain version over the host parse) equal to the
native splitter, on seeded rows."""

import numpy as np
import pytest

from umgap_tpu.index import distbuild as jdist
from umgap_tpu.index import scale as jscale
from umgap_tpu.io import native as jnative
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import read_taxa_file as jread
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.index import build as pbuild
from umgap_tpu_torch.index import scale as pscale
from umgap_tpu_torch.taxonomy import Taxonomy as PTaxonomy
from umgap_tpu_torch.taxonomy import read_taxa_file as pread

AAS = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def taxa(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("scale") / "taxons.tsv")
    jdist.write_synthetic_taxonomy(path, 4000, 11)
    jtax = JTaxonomy(jread(path))
    ptax = PTaxonomy(pread(path))
    return jtax, ptax, DeviceTaxonomy.from_host(ptax, "cpu")


def _rows(seed, n_tax=4000):
    """Synthetic rows with groups of 1 distinct taxon (most), 2-64 and
    65-300, ids out of range and of invalid taxa among them."""
    packed, tids = jdist.synthetic_chunk(seed, 0, 60_000, n_tax)
    rng = np.random.default_rng(seed)
    extra_k, extra_t = [], []
    for width in (2, 3, 5, 16, 17, 40, 64, 65, 130, 300):
        key = rng.integers(0, 2 ** 45, dtype=np.uint64)
        ids = rng.choice(np.arange(1, n_tax + 1), size=width, replace=False)
        reps = rng.integers(1, 4, size=width)
        extra_k.append(np.full(int(reps.sum()), key, np.uint64))
        extra_t.append(np.repeat(ids, reps).astype(np.int32))
    packed = np.concatenate([packed, *extra_k])
    tids = np.concatenate([tids, *extra_t])
    tids[rng.random(len(tids)) < 0.01] = -5
    tids[rng.random(len(tids)) < 0.01] = n_tax + 10
    order = rng.permutation(len(packed))
    return packed[order], tids[order].astype(np.int64)


def _jax_join(packed, tids, jtax, native):
    order = np.argsort(packed, kind="stable")
    return jscale.join_kmers_sorted(packed[order], tids[order], jtax,
                                    use_native=native)


def _equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [1, 2])
def test_join_matches_jax(taxa, seed):
    jtax, ptax, dtax = taxa
    packed, tids = _rows(seed)
    want = _jax_join(packed, tids, jtax, native=False)
    assert len(want[0]) > 30_000
    _equal(pscale.join_kmers_sorted(packed, tids, ptax, device="cpu",
                                    dtax=dtax), want)
    # the plain version, on the JAX package's sorted rows
    order = np.argsort(packed, kind="stable")
    _equal(pscale.join_kmers_sorted_plain(packed[order], tids[order], ptax),
           want)
    try:
        native = _jax_join(packed, tids, jtax, native=True)
    except (RuntimeError, OSError):  # no C++ toolchain: numpy only
        return
    _equal(native, want)


@pytest.mark.parametrize("piece_rows", [1, 5_000, 40_000])
def test_join_in_pieces_matches_jax(taxa, piece_rows):
    """Rows cut into pieces by key ranges (a shard larger than the card):
    groups never span two pieces and the output is in key order."""
    jtax, ptax, dtax = taxa
    packed, tids = _rows(3)
    want = _jax_join(packed, tids, jtax, native=False)
    bounds = pscale.piece_bounds(packed, max(piece_rows, 2_000))
    assert len(bounds) >= (0 if piece_rows == 40_000 else 3)
    _equal(pscale.join_kmers_sorted(packed, tids, ptax, device="cpu",
                                    dtax=dtax,
                                    piece_rows=max(piece_rows, 2_000)),
           want)


@pytest.mark.parametrize("cells", [1 << 10, 1 << 14])
def test_join_in_steps_matches_jax(taxa, monkeypatch, cells):
    """Each bucket's groups filled and aggregated a step at a time (the
    padded cells of one launch bounded): steps of one group up to
    hundreds, the same values."""
    jtax, ptax, dtax = taxa
    packed, tids = _rows(4)
    want = _jax_join(packed, tids, jtax, native=False)
    monkeypatch.setattr(pscale, "CPU_CELLS", cells)
    _equal(pscale.join_kmers_sorted(packed, tids, ptax, device="cpu",
                                    dtax=dtax), want)


def test_join_edge_cases_match_jax(taxa):
    """Empty input, every row invalid, one row, one wide group."""
    jtax, ptax, dtax = taxa
    empty = np.zeros(0, np.uint64)
    for packed, tids in (
            (empty, np.zeros(0, np.int64)),
            (np.arange(5, dtype=np.uint64), np.full(5, -1, np.int64)),
            (np.arange(5, dtype=np.uint64), np.full(5, 99_999, np.int64)),
            (np.array([7], np.uint64), np.array([3], np.int64)),
            (np.full(900, 12345, np.uint64),
             np.arange(1, 901, dtype=np.int64))):
        want = _jax_join(packed, tids, jtax, native=False)
        got = pscale.join_kmers_sorted(packed, tids, ptax, device="cpu",
                                       dtax=dtax)
        _equal(got, want)


def test_join_needs_a_card_or_the_cpu(taxa, monkeypatch):
    """No card and no device='cpu': the join refuses (no quiet plain
    path on the host)."""
    import torch

    from umgap_tpu_torch.device import NoCudaDevice

    _jtax, ptax, _dtax = taxa
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice, match="--device cpu"):
        pscale.join_kmers_sorted(np.arange(3, dtype=np.uint64),
                                 np.ones(3, np.int64), ptax)
    with pytest.raises(NoCudaDevice):
        pscale.split_kmers_tsv(b"1\tACDEFGHIKL\n")


def _tsv(rng, n, lo=0, hi=400):
    lines = []
    for i in range(n):
        L = int(rng.integers(lo, hi))
        prot = "".join(rng.choice(list(AAS + "XBZUO*"), size=L))
        tid = int(rng.integers(0, 5000))
        form = i % 7
        if form == 0:
            lines.append(f"{tid}\t{prot}\r")  # CRLF
        elif form == 1:
            lines.append(f"{tid}{prot}")  # no tab
        elif form == 2:
            lines.append(f"\t{prot}")  # no taxid
        elif form == 3:
            lines.append(f"{tid}\t{prot}\textra\tcolumns")
        elif form == 4:
            lines.append("")
        else:
            lines.append(f"{tid}\t{prot}")
    return ("\n".join(lines)).encode()


@pytest.mark.parametrize("seed,k", [(1, 9), (2, 9), (3, 5), (4, 10)])
def test_split_matches_native(seed, k):
    rng = np.random.default_rng(seed)
    data = _tsv(rng, 400)
    if not seed % 2:
        data += b"\n"
    want = jnative.split_kmers_tsv(data, k=k)
    got = pscale.split_kmers_tsv(data, k=k, device="cpu")
    _equal(got, want)
    _equal(pscale.split_kmers_tsv_plain(data, k=k), want)
    assert len(want[0]) > 1_000


def test_split_long_proteins_in_bounded_batches(monkeypatch):
    """Proteins of 9-35,000 residues: batches of one length class bounded
    in padded cells (a batch's widest at most twice its narrowest), a
    35,000-residue protein alone in its batch, rows in line order."""
    rng = np.random.default_rng(9)
    lines = []
    for L in (9, 35_000, 12, 800, 35_000, 9, 8, 3_000):
        prot = "".join(rng.choice(list(AAS), size=L))
        lines.append(f"{L}\t{prot}")
    data = ("\n".join(lines) + "\n").encode()
    monkeypatch.setattr(pscale, "SPLIT_CELLS", 40_000)
    _codes, _start, lengths, _tids = pscale.parse_tsv(data)
    batches = pscale._protein_batches(lengths, 9)
    assert all(len(b) == 1 or len(b) * lengths[b].max() <= 40_000
               for b in batches)
    assert all(lengths[b].max() < 2 * lengths[b].min() for b in batches)
    assert all(list(b) == sorted(b) for b in batches)
    assert sorted(i for b in batches for i in b) == [0, 1, 2, 3, 4, 5, 7]
    assert [len(b) for b in batches if 35_000 in lengths[b]] == [1, 1]
    _equal(pscale.split_kmers_tsv(data, 9, device="cpu"),
           jnative.split_kmers_tsv(data, k=9))


def test_split_edge_cases_match_native():
    for data in (b"", b"\n", b"\n\n", b"123", b"123\t", b"12\tACDEFGHI",
                 b"12\tACDEFGHIK", b"\r\n", b"99999999999999\tACDEFGHIKLM\n",
                 b"7\tACDEFGHIKLMN\r\n8\tMMMMMMMMM"):
        want = jnative.split_kmers_tsv(data, k=9)
        _equal(pscale.split_kmers_tsv(data, 9, device="cpu"), want)


def test_build_index_fast_uses_the_plain_versions(taxa):
    """``index.build`` names the plain split and join of ``scale``."""
    assert pbuild.split_kmers_tsv_plain is pscale.split_kmers_tsv_plain
    assert pbuild.join_kmers_sorted_plain is pscale.join_kmers_sorted_plain
