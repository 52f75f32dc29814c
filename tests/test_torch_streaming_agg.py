"""The port's streaming aggregators (``umgap_tpu_torch/agg/streaming.py``,
host code that no command uses) against ``umgap_tpu``'s on the fixture
taxonomy and on seeded records over a synthetic one: the same yields,
and the same errors at the same record."""

import numpy as np
import pytest

from umgap_tpu.agg import streaming as jstream
from umgap_tpu.index import distbuild as jdist
from umgap_tpu.taxonomy import Taxonomy as JTaxonomy
from umgap_tpu.taxonomy import fixture_taxa as jfixture
from umgap_tpu.taxonomy import read_taxa_file as jread
from umgap_tpu_torch.agg import streaming as pstream
from umgap_tpu_torch.taxonomy import Taxonomy as PTaxonomy
from umgap_tpu_torch.taxonomy import fixture_taxa as pfixture
from umgap_tpu_torch.taxonomy import read_taxa_file as pread


def _outcome(agg, records, tax):
    """Everything the iterator yields, then the error that ends it."""
    out = []
    try:
        for item in agg(records, tax):
            out.append(item)
    except ValueError as e:
        return out, (type(e).__name__, str(e))
    return out, None


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stream") / "t.tsv")
    jdist.write_synthetic_taxonomy(path, 600, 5)
    return {"fixture": (JTaxonomy(jfixture()), PTaxonomy(pfixture())),
            "synthetic": (JTaxonomy(jread(path)), PTaxonomy(pread(path)))}


def _records(rng, ids, n=300, bad=()):
    recs = []
    for g in range(n):
        for _ in range(int(rng.integers(1, 5))):
            t = int(rng.choice(ids))
            if bad and rng.random() < 0.01:
                t = int(rng.choice(bad))
            recs.append((f"s{g % 40}" if g % 3 else f"q{g}", t))
    return recs


@pytest.mark.parametrize("world", ["fixture", "synthetic"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_aggregator_matches_jax(worlds, world, seed):
    jtax, ptax = worlds[world]
    rng = np.random.default_rng(seed)
    ids = np.flatnonzero(jtax.present)
    recs = _records(rng, ids, bad=(-1, jtax.size + 3) if seed == 2 else ())
    want = _outcome(jstream.RankAggregator, recs, jtax)
    assert want[0]
    assert _outcome(pstream.RankAggregator, recs, ptax) == want


@pytest.mark.parametrize("world", ["fixture", "synthetic"])
def test_lineage_aggregator_matches_jax(worlds, world):
    jtax, ptax = worlds[world]
    recs = _records(np.random.default_rng(7), np.flatnonzero(jtax.present),
                    n=50)
    assert list(pstream.LineageAggregator(recs, ptax)) == list(
        jstream.LineageAggregator(recs, jtax)) == []


def test_fixture_cases_match_jax(worlds):
    jtax, ptax = worlds["fixture"]
    for recs in ([("s1", 185751), ("s1", 185752), ("s2", 2)],
                 [("s1", 185751), ("s1", 12884)],
                 [("a", 2), ("b", 10239)], [], [("x", 999_999_999)]):
        assert _outcome(pstream.RankAggregator, recs, ptax) == \
            _outcome(jstream.RankAggregator, recs, jtax)


def test_peekable():
    p = pstream._peekable(iter([1, 2]))
    assert (p.peek(), p.peek(), p.next(), p.next(), p.peek(), p.next()) == \
        (1, 1, 1, 2, None, None)
