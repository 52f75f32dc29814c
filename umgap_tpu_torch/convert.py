"""State carried across from the JAX package, given as numpy arrays.

The tests call these on ``np.asarray(...)`` of ``umgap_tpu``'s
``DeviceTable``, ``DeviceTaxonomy`` and ``DeviceEuler`` leaves, so that both packages
compute on the very same index rows and taxonomy tables. Nothing here
imports the JAX package.
"""

from __future__ import annotations

from .agg.device import DeviceTaxonomy
from .agg.device_rmq import DeviceEuler
from .ops.lookup import DeviceTable


def table_from_arrays(rows, stash, max_probes: int, kind: str, nb_bits: int,
                      bucket: int, group: int = 1, device=None) -> DeviceTable:
    """``rows`` (group * n_buckets, 2 * bucket) int32 for a k-mer table,
    (n_buckets, 3 * bucket) ``[key_hi | key_lo | values]`` for a peptide
    table (``kind="peptide"``, ``nb_bits`` 0, no stash: ``stash`` empty
    or None); ``stash`` (S, 3) int32 [hi, lo, value] (any order; sorted
    here)."""
    if kind == "peptide" and stash is not None and len(stash):
        raise ValueError("peptide tables have no stash")
    return DeviceTable.from_arrays(rows, stash, max_probes, kind, nb_bits,
                                   bucket, group=group, device=device)


def taxonomy_from_arrays(depth, anc, snap_valid, snap_ranked, root: int,
                         seed_scores=None, device=None) -> DeviceTaxonomy:
    """``depth`` (size,), ``anc`` (size, D), the two snappings (size,) and
    the per-taxon seed scores, all integer arrays."""
    return DeviceTaxonomy.from_arrays(depth, anc, snap_valid, snap_ranked,
                                      root, seed_scores, device=device)


def euler_from_arrays(tour, depths, first, block_min, sparse, nlevels: int,
                      tour_len: int, device=None) -> DeviceEuler:
    """The Euler tour ``tour``, ``depths`` (T,), ``first`` (size,), the
    RMQ's ``block_min`` (nb,) and ``sparse`` (levels, nb), all integer
    arrays, with the level count and the tour length."""
    return DeviceEuler.from_arrays(tour, depths, first, block_min, sparse,
                                   nlevels, tour_len, device=device)
