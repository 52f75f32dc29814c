"""Exact host-side aggregators (a copy of ``umgap_tpu.agg.host``).

These reproduce the realized semantics of the reference's five aggregator
configurations (src/commands/taxa2agg.rs:111-140). The CLI's long-record
route aggregates with them.

Where the reference is nondeterministic (argmax ties resolved by Rust
HashMap iteration order — explicitly accepted in its tests, e.g.
src/rmq/rtl.rs:89-92), we use a deterministic tie-break:
highest score, then greatest depth, then smallest taxon id. Where results
depend on HashMap *iteration* order (the rmq-lca join-level walk,
src/rmq/lca.rs:60-90), we visit hits in ascending
taxon-id order (the documented pin; see RmqLCA.aggregate and the
device walk in agg/device_rmq.py, which must agree).

Counts are accumulated in float32 to match the reference's f32 sums.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np

from ..taxonomy import NONE, Taxonomy
from .rmq import RMQ


class AggError(Exception):
    """Base class for aggregation errors."""


class EmptyInputError(AggError):
    def __init__(self):
        super().__init__("Aggregation called on an empty list")


class UnknownTaxonError(AggError):
    def __init__(self, tid: int):
        super().__init__(f"Unknown Taxon ID: {tid}")
        self.tid = tid


def count(pairs: Iterable[Tuple[int, float]]) -> Dict[int, float]:
    """Frequency table in first-seen order (reference agg::count,
    src/agg/mod.rs:27-36; f32 accumulation)."""
    counts: Dict[int, float] = {}
    for tid, c in pairs:
        counts[tid] = float(np.float32(counts.get(tid, np.float32(0.0)) + np.float32(c)))
    return counts


def filter_counts(counts: Dict[int, float], lower_bound: float) -> Dict[int, float]:
    """Drop entries strictly below the bound (src/agg/mod.rs:39-44: keeps
    freq >= lower_bound)."""
    return {t: c for t, c in counts.items() if c >= lower_bound}


class HostAggregator:
    """Base: validates inputs and provides the lineage-matrix helpers."""

    def __init__(self, tax: Taxonomy):
        self.tax = tax

    # -- reference API ------------------------------------------------- #

    def aggregate(self, counts: Dict[int, float]) -> int:
        raise NotImplementedError

    def counting_aggregate(self, taxa: Sequence[int]) -> int:
        return self.aggregate(count((t, 1.0) for t in taxa))

    # -- helpers ------------------------------------------------------- #

    def _check_known(self, ids: Sequence[int]):
        for t in ids:
            if t < 0 or t >= self.tax.size or not self.tax.present[t] or self.tax.depth[t] == NONE:
                raise UnknownTaxonError(t)

    def _lineages(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(lineage rows, depths, is_anc) for the given unique taxon ids.

        ``is_anc[i, j]`` is True iff ids[i] is an ancestor-or-self of
        ids[j].
        """
        lin = self.tax.lineage_rows(ids)  # (k, D)
        depths = self.tax.depth[ids]  # (k,)
        # anc_of_j_at_depth_of_i[j, i] = lin[j, depths[i]]
        a = lin[:, depths]  # a[j, i] = ancestor of ids[j] at depth of ids[i]
        is_anc = a.T == ids[:, None]  # is_anc[i, j] = ids[i] anc-or-self of ids[j]
        return lin, depths, is_anc


class TreeLCA(HostAggregator):
    """LCA*: induced-tree collapse (reference src/tree/lca.rs:33-41).

    Realized semantics: if all input taxa lie on one root-to-leaf chain,
    the deepest input; otherwise the LCA of all inputs (the first node
    with >=2 children in the induced tree).
    """

    def aggregate(self, counts: Dict[int, float]) -> int:
        if not counts:
            raise EmptyInputError()
        ids = np.fromiter(counts.keys(), dtype=np.int64)
        self._check_known(ids)
        lin, depths, is_anc = self._lineages(ids)
        dominated = is_anc.all(axis=0)  # j with every input an ancestor-or-self
        if dominated.any():
            cand = np.where(dominated)[0]
            return int(ids[cand[np.argmax(depths[cand])]])
        # LCA of all inputs: deepest depth where all lineages agree.
        eq = (lin == lin[0]) & (lin[0] != NONE)
        all_eq = eq.all(axis=0)
        d = int(np.max(np.where(all_eq)[0]))
        return int(lin[0, d])


class TreeMix(HostAggregator):
    """Hybrid LCA*/MRTL (reference src/tree/mix.rs:42-64): collapse the
    induced tree, compute subtree sums, and descend into the heaviest
    branch while its share of the current chain value is >= factor."""

    def __init__(self, tax: Taxonomy, factor: float):
        super().__init__(tax)
        self.factor = np.float32(factor)

    def aggregate(self, counts: Dict[int, float]) -> int:
        if not counts:
            raise EmptyInputError()
        ids = np.fromiter(counts.keys(), dtype=np.int64)
        self._check_known(ids)
        c = np.fromiter(counts.values(), dtype=np.float32)
        lin = self.tax.lineage_rows(ids)
        depths = self.tax.depth[ids]
        D = lin.shape[1]

        x = self.tax.root
        a_base = np.float32(c.sum(dtype=np.float32))
        d = 0
        while d + 1 < D:
            below = (depths > d) & (lin[:, d] == x)
            if not below.any():
                break
            branches = lin[below, d + 1]
            uniq = np.unique(branches)
            if len(uniq) == 1:
                # single child: chain, collapse without a factor test
                x = int(uniq[0])
                d += 1
                continue
            sums = np.array(
                [c[below][branches == b].sum(dtype=np.float32) for b in uniq],
                dtype=np.float32,
            )
            best = int(np.argmax(sums))  # ties -> first = smallest branch id
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = sums[best] / a_base
            # Reference: `if max.value / base.value < self.factor { break }`;
            # NaN/inf comparisons behave the same in numpy as in Rust f32.
            if ratio < self.factor:
                break
            x = int(uniq[best])
            a_base = sums[best]
            d += 1
        return int(x)


class RmqRTL(HostAggregator):
    """MRTL (reference src/rmq/rtl.rs:39-57): each taxon's score is its
    own count plus the counts of all its ancestors present in the input;
    returns the argmax (deterministic tie-break, see module docstring)."""

    def aggregate(self, counts: Dict[int, float]) -> int:
        if not counts:
            raise EmptyInputError()
        ids = np.fromiter(counts.keys(), dtype=np.int64)
        self._check_known(ids)
        c = np.fromiter(counts.values(), dtype=np.float32)
        _, depths, is_anc = self._lineages(ids)
        scores = (is_anc.astype(np.float32) * c[:, None]).sum(axis=0, dtype=np.float32)
        return int(_argmax_tiebreak(ids, depths, scores))


class RmqLCA(HostAggregator):
    """The reference's RMQ/Euler-tour LCA aggregate walk with join levels
    (src/rmq/lca.rs:60-90), iterating in input first-seen order."""

    def __init__(self, tax: Taxonomy):
        super().__init__(tax)
        tour, depths, first = tax.euler_tour()
        self.tour = tour
        self.depths = depths
        self.first = first
        self.rmq = RMQ(depths)

    def _first_occ(self, tid: int) -> int:
        if tid < 0 or tid >= self.tax.size or self.first[tid] == NONE:
            raise UnknownTaxonError(tid)
        return int(self.first[tid])

    def lca(self, a: int, b: int) -> int:
        """Pairwise LCA (src/rmq/lca.rs:42-47)."""
        return int(self.tour[self.rmq.query(self._first_occ(a), self._first_occ(b))])

    def aggregate(self, counts: Dict[int, float]) -> int:
        if not counts:
            raise EmptyInputError()
        # The reference iterates HashMap order (random per process); we
        # canonicalize to ascending taxon id so host and device agree.
        indices = [self._first_occ(t) for t in sorted(counts.keys())]
        consensus = indices[0]
        join_level = None
        for nxt in indices[1:]:
            if consensus == nxt:
                continue
            rmq = self.rmq.query(consensus, nxt)
            if rmq != consensus and rmq != nxt:
                lca, level = rmq, int(self.depths[rmq])
            elif rmq == consensus:
                lca, level = nxt, join_level
            else:
                lca, level = consensus, join_level
            if join_level is not None and self.depths[lca] > join_level:
                lca = rmq
            consensus = lca
            join_level = level
        return int(self.tour[consensus])


class RmqMix(HostAggregator):
    """Hybrid LCA/MRTL over the pairwise-LCA closure
    (src/rmq/mix.rs:55-95). For each taxon in the closure, weight.lca is
    the summed count of inputs descending from it (incl. itself) and
    weight.rtl the summed count of inputs it descends from (incl.
    itself); argmax of lca*f + rtl*(1-f)."""

    def __init__(self, tax: Taxonomy, factor: float):
        super().__init__(tax)
        self.factor = np.float32(factor)
        self._lca = RmqLCA(tax)

    def aggregate(self, counts: Dict[int, float]) -> int:
        if not counts:
            raise EmptyInputError()
        weights: Dict[int, Tuple[np.float32, np.float32]] = {}
        queue = deque(counts.keys())
        while queue:
            left = queue.popleft()
            if left in weights:
                continue
            for right, c in counts.items():
                lca = self._lca.lca(left, right)
                if lca == left or lca == right:
                    w = weights.setdefault(left, (np.float32(0.0), np.float32(0.0)))
                    wl, wr = w
                    if lca == left:
                        wl = np.float32(wl + np.float32(c))
                    if lca == right:
                        wr = np.float32(wr + np.float32(c))
                    weights[left] = (wl, wr)
                else:
                    queue.append(lca)
        if not weights:
            raise EmptyInputError()
        ids = np.fromiter(weights.keys(), dtype=np.int64)
        f = self.factor
        scores = np.array(
            [np.float32(wl * f + wr * (np.float32(1.0) - f)) for wl, wr in weights.values()],
            dtype=np.float32,
        )
        depths = self.tax.depth[ids]
        return int(_argmax_tiebreak(ids, depths, scores))


def _argmax_tiebreak(ids: np.ndarray, depths: np.ndarray, scores: np.ndarray) -> int:
    """Argmax by score; ties broken by greater depth, then smaller id.

    The reference's ties are HashMap-order nondeterministic; this is our
    deterministic choice (documented in the module docstring).
    """
    best = scores == scores.max()
    cand = np.where(best)[0]
    dmax = depths[cand].max()
    cand = cand[depths[cand] == dmax]
    return int(ids[cand].min())


def make_aggregator(
    tax: Taxonomy, method: str, strategy: str, factor: float = 0.25
) -> HostAggregator:
    """The method×strategy dispatch of taxa2agg
    (src/commands/taxa2agg.rs:111-140)."""
    key = (method, strategy)
    if key == ("rmq", "mrtl"):
        return RmqRTL(tax)
    if key == ("rmq", "lca*"):
        return RmqLCA(tax)
    if key == ("rmq", "hybrid"):
        return RmqMix(tax, factor)
    if key == ("tree", "lca*"):
        return TreeLCA(tax)
    if key == ("tree", "hybrid"):
        return TreeMix(tax, factor)
    raise ValueError(f"{method} and {strategy} cannot be combined")
