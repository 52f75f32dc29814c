"""Range-minimum query over an integer array, on the host (a copy of
``umgap_tpu.agg.rmq``).

The reference's block/sparse RMQ (src/rmq/mod.rs) with the same
position semantics, because the RMQ-LCA walk (src/rmq/lca.rs:60-90)
branches on the returned position, not only on the value:

- within one block: leftmost occurrence of the minimum;
- across blocks: the leftmost minimum of the left partial block, the
  block-table minimum of the middle blocks (ties prefer the later block
  and the first occurrence within a block), and the leftmost minimum of
  the right partial block, combined preferring the left on ties.

The block is the reference's machine word, 64. Construction is
vectorised numpy; :meth:`RMQ.query` is O(1) Python.
"""

from __future__ import annotations

import numpy as np

BLOCK = 64
_LOG2_BLOCK = 6


def _intlog2(n: int) -> int:
    return n.bit_length() - 1


class RMQ:
    """RMQ over ``array`` returning argmin positions (reference semantics)."""

    def __init__(self, array):
        a = np.asarray(array, dtype=np.int64)
        if a.ndim != 1 or a.size == 0:
            raise ValueError("RMQ needs a non-empty 1-D array")
        self.array = a
        n = a.size
        nblocks = (n + BLOCK - 1) // BLOCK
        # per-block position of the first minimum
        pad = np.full(nblocks * BLOCK - n, np.iinfo(np.int64).max,
                      dtype=np.int64)
        blocks = np.concatenate([a, pad]).reshape(nblocks, BLOCK)
        self.block_min = blocks.argmin(axis=1) + np.arange(nblocks) * BLOCK
        # sparse[j][i] = argmin over blocks i .. i + 2^(j+1) - 1, ties
        # preferring the later entry (aggregate_minima takes the left one
        # only if strictly smaller, src/rmq/mod.rs:73-83)
        self.sparse: list[np.ndarray] = []
        length = _intlog2(nblocks) if nblocks > 1 else 0
        prev = self.block_min
        for j in range(length):
            shift = 1 << j
            left, right = prev[:-shift], prev[shift:]
            merged = np.where(a[left] < a[right], left, right)
            self.sparse.append(merged)
            prev = merged

    def _min_in_block(self, left: int, right: int) -> int:
        """Leftmost position of the minimum of array[left..=right], both in
        one block (src/rmq/mod.rs:89-118)."""
        seg = self.array[left: right + 1]
        return left + int(seg.argmin())

    def query(self, start: int, end: int) -> int:
        """Position of the minimum of array[min..=max]
        (src/rmq/mod.rs:121-156)."""
        if start == end:
            return start
        left, right = (start, end) if start < end else (end, start)
        a = self.array
        lblock = left >> _LOG2_BLOCK
        rblock = right >> _LOG2_BLOCK
        block_diff = rblock - lblock
        if block_diff == 0:
            return self._min_in_block(left, right)
        l = self._min_in_block(left, (lblock << _LOG2_BLOCK) + BLOCK - 1)
        r = self._min_in_block(rblock << _LOG2_BLOCK, right)
        if block_diff == 1:
            return l if a[l] <= a[r] else r
        if block_diff == 2:
            m = int(self.block_min[lblock + 1])
        else:
            k = _intlog2(block_diff - 1) - 1
            t1 = int(self.sparse[k][lblock + 1])
            t2 = int(self.sparse[k][rblock - (1 << (k + 1))])
            m = t1 if a[t1] <= a[t2] else t2
        ex = l if a[l] <= a[m] else m
        return ex if a[ex] <= a[r] else r
