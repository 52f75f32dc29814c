"""Taxonomy model as dense arrays (a copy of ``umgap_tpu.taxonomy``).

Dense, id-indexed numpy vectors (parent, rank, valid, depth, snapping)
are built once on the host and moved to the device, so every per-read
tree operation becomes a gather. The 5-column taxon TSV
(``id\\tname\\trank\\tparent\\t\\x01|\\x00``) parses exactly like the
reference's ``Taxon::from_str`` (src/taxon.rs:89-113).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from . import ranks


class TaxonomyError(ValueError):
    """Raised for malformed taxon files or unknown taxa."""


@dataclass(frozen=True)
class Taxon:
    id: int
    name: str
    rank: int  # index into ranks.RANK_NAMES
    parent: int
    valid: bool


def parse_taxon_line(line: str) -> Taxon:
    """Parse one taxon TSV line (reference src/taxon.rs:89-113).

    Trailing whitespace is trimmed first; exactly five tab-separated fields
    are required; the valid byte must be \\x01 (true) or \\x00 (false).
    """
    fields = line.rstrip().split("\t")
    if len(fields) != 5:
        raise TaxonomyError("Taxon requires five fields")
    sid, name, rank_str, sparent, valid_byte = fields
    try:
        tid = int(sid)
        parent = int(sparent)
    except ValueError as e:
        raise TaxonomyError(f"Invalid taxon ID: {e}") from e
    if tid < 0 or parent < 0:
        raise TaxonomyError("Invalid taxon ID: negative")
    try:
        rank = ranks.rank_index(rank_str)
    except KeyError:
        raise TaxonomyError(f"Unknown rank: {rank_str}") from None
    if valid_byte == "\x01":
        valid = True
    elif valid_byte == "\x00":
        valid = False
    else:
        raise TaxonomyError("Couldn't parse the valid byte")
    return Taxon(tid, name, rank, parent, valid)


def read_taxa_file(path) -> list[Taxon]:
    """Read a taxon TSV file, one taxon per line (src/taxon.rs:119-128)."""
    taxa = []
    with open(path, "r", encoding="utf-8", newline="") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            taxa.append(parse_taxon_line(line))
    return taxa


# Sentinel for "no taxon" in int arrays (None in the reference).
NONE = -1


class Taxonomy:
    """Dense array view of a taxon list, indexed by taxon id (length
    ``max_id + 1``). ``with_unknown`` adds taxon 0, "unknown", when the
    list lacks it (TaxonList::new_with_unknown, src/taxon.rs:149-155)."""

    def __init__(self, taxa: Sequence[Taxon], with_unknown: bool = False):
        if not taxa:
            raise TaxonomyError("empty taxonomy")
        n = max(t.id for t in taxa) + 1
        self.size = n
        self.present = np.zeros(n, dtype=bool)
        self.parent = np.full(n, NONE, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)
        self.valid = np.zeros(n, dtype=bool)
        self.names: list[str | None] = [None] * n
        # children in input order, as TaxonTree::new pushes them
        # (src/taxon.rs:224-247); the Euler tour visits them in this order
        self._children: dict[int, list[int]] = {}

        roots = set(t.id for t in taxa)
        for t in taxa:
            i = t.id
            self.present[i] = True
            self.parent[i] = t.parent
            self.rank[i] = t.rank
            self.valid[i] = t.valid
            self.names[i] = t.name
            if t.id != t.parent:
                self._children.setdefault(t.parent, []).append(t.id)
                roots.discard(t.id)
        if with_unknown and not self.present[0]:
            self.present[0] = True
            self.parent[0] = 0
            self.rank[0] = ranks.NO_RANK
            self.valid[0] = False
            self.names[0] = "unknown"
        if len(roots) > 1:
            raise TaxonomyError("More than one root!")
        if not roots:
            raise TaxonomyError("There's no root!")
        self.root = next(iter(roots))

        # Depth of every node reachable from the root through present
        # parents; unreachable/absent nodes keep depth NONE. Level-by-level
        # relaxation (at most max-depth passes).
        depth = np.full(n, NONE, dtype=np.int64)
        depth[self.root] = 0
        ids = np.nonzero(self.present)[0]
        parents = self.parent[ids]
        parent_ok = (parents >= 0) & (parents < n)
        for _ in range(n):
            pd = np.where(parent_ok, depth[np.clip(parents, 0, n - 1)], NONE)
            newd = np.where(
                (depth[ids] == NONE) & (pd != NONE) & (ids != self.root),
                pd + 1,
                depth[ids],
            )
            if np.array_equal(newd, depth[ids]):
                break
            depth[ids] = newd
        self.depth = depth
        self.max_depth = int(depth.max(initial=0))

    def get(self, tid: int) -> Taxon | None:
        """TaxonList::get (src/taxon.rs:166-172): None for absent ids."""
        if tid < 0 or tid >= self.size or not self.present[tid]:
            return None
        return Taxon(tid, self.names[tid] or "", int(self.rank[tid]),
                     int(self.parent[tid]), bool(self.valid[tid]))

    def lineage(self, tid: int) -> list[int]:
        """The 32-slot lineage: the taxon id at each rank, NONE elsewhere
        (src/taxon.rs:194-209). Raises TaxonomyError on unknown taxa and
        on a cyclic ancestry."""
        arr = [NONE] * ranks.RANK_COUNT
        next_id, prev_id = tid, None
        seen = 0
        while next_id != prev_id:
            if not (0 <= next_id < self.size) or not self.present[next_id]:
                raise TaxonomyError(f"Unknown Taxon ID: {next_id}")
            r = int(self.rank[next_id])
            if r != ranks.NO_RANK:
                arr[r] = next_id
            prev_id = next_id
            next_id = int(self.parent[next_id])
            seen += 1
            if seen > self.size:
                raise TaxonomyError(f"Taxon {tid} has a cyclic ancestry")
        return arr

    def filter_ancestors(self, keep: np.ndarray) -> np.ndarray:
        """For every node reachable from the root, the nearest ancestor-or-
        self passing ``keep``; the root maps to itself even when it fails
        the filter (TaxonTree::filter_ancestors, src/taxon.rs:251-281).
        Unreachable slots are NONE."""
        snap = np.full(self.size, NONE, dtype=np.int64)
        snap[self.root] = self.root
        depth = self.depth
        for d in range(1, int(depth.max()) + 1):
            ids = np.flatnonzero(depth == d)
            if len(ids):
                snap[ids] = np.where(keep[ids], ids, snap[self.parent[ids]])
        return snap

    def snapping(self, ranked_only: bool) -> np.ndarray:
        """Nearest valid (and optionally ranked) ancestor per node
        (TaxonTree::snapping, src/taxon.rs:294-301)."""
        keep = self.present & self.valid
        if ranked_only:
            keep &= self.rank != ranks.NO_RANK
        return self.filter_ancestors(keep)

    def rank_snapping(self, rank: int | None, taxa: Iterable[int] = (),
                      require_valid: bool = False) -> np.ndarray:
        """Snapping to an exact rank and/or an explicit taxon set:
        snaptaxon (src/commands/snaptaxon.rs:82-90) passes
        ``require_valid=not invalid`` and its listed taxa, whether present
        or not; taxa2freq (src/commands/taxa2freq.rs:96-97) no taxa and
        no validity check."""
        if rank is None:
            keep = np.zeros(self.size, dtype=bool)
        else:
            keep = self.present & (self.rank == rank)
            if require_valid:
                keep &= self.valid
        for t in taxa:
            if 0 <= t < self.size:
                keep[t] = True
        return self.filter_ancestors(keep)

    def seed_scores(self) -> np.ndarray:
        """Vectorized TaxonList::score (src/taxon.rs:181-191): the rank
        score of each node's nearest ranked ancestor-or-self; 0 encodes
        "no score"."""
        keep = self.present & (self.rank != ranks.NO_RANK)
        anc = self.filter_ancestors(keep)
        out = np.zeros(self.size, dtype=np.int32)
        ok = anc != NONE
        out[ok] = ranks.RANK_SCORES[self.rank[anc[ok]]]
        return out

    def score(self, tid: int, default: int | None = None) -> int | None:
        """Rank score after walking to the first ranked ancestor
        (TaxonList::score, src/taxon.rs:181-191); ``default`` when the
        walk ends on an unknown taxon or the score is None."""
        current, seen = tid, 0
        while 0 <= current < self.size and self.present[current]:
            if self.parent[current] == current or \
                    self.rank[current] != ranks.NO_RANK:
                s = int(ranks.RANK_SCORES[self.rank[current]])
                return s if s != 0 else default
            current = int(self.parent[current])
            seen += 1
            if seen > self.size:
                break
        return default

    def euler_tour(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Euler tour from the root: a node is emitted before each child's
        subtree and once after the last, so it appears child count + 1
        times (EulerIterator, src/taxon.rs:309-392). Returns (tour ids,
        tour depths, first occurrence per id with NONE for ids not on the
        tour), all int64."""
        tour: list[int] = []
        depths: list[int] = []
        first = np.full(self.size, NONE, dtype=np.int64)
        # iterative DFS; the stack holds (node, next child index, depth)
        stack = [(self.root, 0, 0)]
        while stack:
            node, ci, d = stack.pop()
            if first[node] == NONE:
                first[node] = len(tour)
            tour.append(node)
            depths.append(d)
            kids = self._children.get(node, ())
            if ci < len(kids):
                stack.append((node, ci + 1, d))
                stack.append((kids[ci], 0, d + 1))
        return (np.asarray(tour, dtype=np.int64),
                np.asarray(depths, dtype=np.int64), first)

    def ancestor_table(self) -> np.ndarray:
        """``anc[i, d]`` = ancestor of node i at depth d (NONE above the
        node's own depth or for unreachable nodes), int32, shape
        ``(size, max_depth + 1)``."""
        D = self.max_depth + 1
        anc = np.full((self.size, D), NONE, dtype=np.int32)
        anc[self.root, 0] = self.root
        depth = self.depth
        for d in range(1, D):
            ids = np.flatnonzero(depth == d)
            if len(ids):
                anc[ids, :d] = anc[self.parent[ids], :d]
                anc[ids, d] = ids
        return anc

    @property
    def anc_table(self) -> np.ndarray:
        """Cached ``ancestor_table``."""
        if not hasattr(self, "_anc_table"):
            self._anc_table = self.ancestor_table()
        return self._anc_table

    def lineage_rows(self, ids: np.ndarray) -> np.ndarray:
        """Rows of the ancestor-at-depth table for the given taxon ids,
        ``(len(ids), max_depth + 1)``, NONE above each node's depth."""
        return self.anc_table[np.asarray(ids, dtype=np.int64)]


def fixture_taxa() -> list[Taxon]:
    """The 6-taxon test taxonomy of the reference's unit tests
    (src/fixtures.rs:4-21)."""
    S = ranks.rank_index("superkingdom")
    F = ranks.rank_index("family")
    N = ranks.NO_RANK
    return [
        Taxon(1, "root", N, 1, True),
        Taxon(2, "Bacteria", S, 1, True),
        Taxon(10239, "Viruses", S, 1, True),
        Taxon(12884, "Viroids", S, 1, True),
        Taxon(185751, "Pospiviroidae", F, 12884, True),
        Taxon(185752, "Avsunviroidae", F, 12884, True),
    ]
