"""NCBI taxonomic ranks.

Array-oriented port of the reference's rank model (reference:
``src/rank.rs:9-119``): 32 ranks where index 0 is "no rank",
a seed-extension score per rank band, and a partial order in which "no rank"
is incomparable.

Ranks are plain ``int`` indices here (0..31) so that whole-taxonomy rank
vectors are dense ``int8`` arrays usable on device.
"""

from __future__ import annotations

import numpy as np

# Index 0 is NO_RANK; the remaining 31 are the named ranks in canonical order
# (reference src/rank.rs:10-41).
RANK_NAMES: tuple[str, ...] = (
    "no rank",
    "superkingdom",
    "domain",
    "realm",
    "kingdom",
    "subkingdom",
    "superphylum",
    "phylum",
    "subphylum",
    "superclass",
    "class",
    "subclass",
    "infraclass",
    "superorder",
    "order",
    "suborder",
    "infraorder",
    "parvorder",
    "superfamily",
    "family",
    "subfamily",
    "tribe",
    "subtribe",
    "genus",
    "subgenus",
    "species group",
    "species subgroup",
    "species",
    "subspecies",
    "varietas",
    "forma",
    "strain",
)

RANK_COUNT = 32
NO_RANK = 0

_RANK_INDEX = {name: i for i, name in enumerate(RANK_NAMES)}

# Named ranks only, in order (reference src/rank.rs:46-78 RANKS).
NAMED_RANKS: tuple[str, ...] = RANK_NAMES[1:]


def rank_index(name: str) -> int:
    """Parse a rank name into its index. Raises KeyError for unknown ranks."""
    return _RANK_INDEX[name]


def rank_name(index: int) -> str:
    return RANK_NAMES[index]


def _score_of(index: int) -> int:
    """Seed score of a rank, or 0 for None (reference src/rank.rs:86-99).

    Faithfully reproduced quirk: the reference's cascade compares with `<`
    under an order where a smaller index is a *shallower* rank, so the first
    branch (`self < Species` => Some(12)) subsumes every later one. The
    realized behavior is therefore: any named rank shallower than species
    scores 12; species and deeper score None; "no rank" is incomparable and
    also scores None. We encode None as 0 (seedextend substitutes the gap
    penalty for it, reference src/commands/seedextend.rs:159).
    """
    if NO_RANK < index < _RANK_INDEX["species"]:
        return 12
    return 0


# RANK_SCORES[i] == 0 means "no score" (None in the reference); used by
# seedextend's scored mode where None falls back to the gap penalty.
RANK_SCORES: np.ndarray = np.array(
    [_score_of(i) for i in range(RANK_COUNT)], dtype=np.int32
)
