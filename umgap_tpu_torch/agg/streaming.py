"""Streaming (sequence, taxon) aggregators (a copy of
``umgap_tpu.agg.streaming``), host code.

The reference's two streaming aggregators, which no command uses (in the
reference, in ``umgap_tpu`` and here), with their realized semantics:

- :class:`RankAggregator` (reference src/agg/rank.rs): groups
  consecutive records with equal sequence and merges their taxa by
  raising both sides to a common comparison rank and, on disagreement,
  walking both up the ranked-snapping chain until they join.
- :class:`LineageAggregator` (reference src/agg/lineage.rs): the
  reference implementation's iterator *always yields nothing*
  (src/agg/lineage.rs:52-59) — reproduced faithfully.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

from .. import ranks
from ..taxonomy import NONE, Taxonomy


class RankAggregator:
    """Iterator over (sequence, taxon) pairs, aggregating runs of equal
    sequences (reference src/agg/rank.rs:10-91)."""

    def __init__(self, records: Iterable[Tuple[str, int]], tax: Taxonomy):
        self._records = _peekable(records)
        self.tax = tax
        self._snap = tax.snapping(ranked_only=True)

    def _rank(self, tid: int) -> Optional[int]:
        """Rank of tid (including NO_RANK), None only for absent taxa
        (mirrors the reference's Option<Rank> vec)."""
        if not (0 <= tid < self.tax.size) or not self.tax.present[tid]:
            return None
        return int(self.tax.rank[tid])

    def _with_rank(self, tid: int) -> Tuple[int, int]:
        r = self._rank(tid)
        if r is not None:
            return tid, r
        anc = int(self._snap[tid]) if 0 <= tid < self.tax.size else NONE
        if anc == NONE:
            raise ValueError(f"Unknown Taxon ID: {tid}")
        r = self._rank(anc)
        if r is None:
            raise ValueError(f"Unranked ancestor for: {tid}")
        return anc, r

    @staticmethod
    def _lt(a: int, b: int) -> bool:
        """Rank partial order: NoRank is incomparable -> `<` is False
        (reference src/rank.rs:111-119)."""
        if a == ranks.NO_RANK or b == ranks.NO_RANK:
            return False
        return a < b

    def _ranked_parent(self, tid: int) -> int:
        """Nearest ranked strict ancestor (root maps to itself)."""
        if tid == self.tax.root:
            return tid
        if tid == NONE or not (0 <= tid < self.tax.size):
            # a NONE from an unreachable taxon must not wrap into
            # parent[-1] and walk an unrelated chain
            raise ValueError(f"taxon {tid} has no ranked ancestor chain")
        return int(self._snap[int(self.tax.parent[tid])])

    def _raise_to_rank(self, tid: int, target: int) -> int:
        # reference: walk while rank is absent OR target < rank (partial);
        # stepping via the ranked parent (see the join-walk note below).
        anc = tid
        while anc != NONE:
            r = self._rank(anc)
            if not (r is None or self._lt(target, r)):
                break
            if anc == self.tax.root:
                break
            anc = self._ranked_parent(anc)
        return anc

    def __iter__(self) -> Iterator[Tuple[str, int]]:
        while True:
            head = self._records.next()
            if head is None:
                return
            sequence, initial = head
            join_rank: Optional[int] = None
            aggregate, aggregate_rank = self._with_rank(initial)
            while True:
                peek = self._records.peek()
                if peek is None or peek[0] != sequence:
                    break
                _, nxt = self._records.next()
                next_taxon, next_rank = self._with_rank(nxt)
                compare = min(next_rank,
                              join_rank if join_rank is not None else aggregate_rank)
                ra = self._raise_to_rank(aggregate, compare)
                rn = self._raise_to_rank(next_taxon, compare)
                if ra != rn:
                    # The reference walks `ancestors[ra]` here, but its
                    # snapping maps ranked nodes to *themselves*, so the
                    # loop would never terminate on diverging taxa (one
                    # reason this aggregator is dead code). We step via
                    # the parent's snap so the join actually happens.
                    while ra != rn:
                        ra = self._ranked_parent(ra)
                        rn = self._ranked_parent(rn)
                    aggregate = ra
                    aggregate_rank = self._rank(aggregate)
                    join_rank = aggregate_rank
                elif join_rank is None and compare != next_rank:
                    aggregate = next_taxon
                    aggregate_rank = next_rank
            yield sequence, aggregate


class LineageAggregator:
    """Faithful port of the reference's dead streaming aggregator: its
    ``next()`` consumes a record and always returns None
    (src/agg/lineage.rs:52-59), so iteration yields nothing."""

    def __init__(self, records: Iterable[Tuple[str, int]], tax: Taxonomy):
        self._records = iter(records)
        self.tax = tax

    def __iter__(self):
        for _sequence, _tid in self._records:
            # the reference computes the lineage and discards it
            try:
                self.tax.lineage(_tid)
            except Exception:
                pass
        return
        yield  # pragma: no cover


class _peekable:
    def __init__(self, it):
        self._it = iter(it)
        self._buf = None
        self._has = False

    def peek(self):
        if not self._has:
            try:
                self._buf = next(self._it)
                self._has = True
            except StopIteration:
                return None
        return self._buf

    def next(self):
        if self._has:
            self._has = False
            return self._buf
        try:
            return next(self._it)
        except StopIteration:
            return None
