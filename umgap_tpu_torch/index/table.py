"""The index tables and their ``.npz`` format (a copy of the k-mer and
peptide parts of ``umgap_tpu.index.table``).

``KmerTable``: keys are 45-bit packed 9-mers split into (20-bit, 25-bit)
int32 lanes. An invertible 3-round Feistel mix (:func:`mix_key`) whitens
the key; its low ``nb_bits`` bits select a bucket row of ``bucket`` slots
and only the remaining <= 30 bits are stored, with bit 30 tagging the
probe distance, so a slot is 8 bytes (remainder, value) and exact. Keys
that do not fit within the probe-distance limit go to a small full-key
stash.

``PeptideTable``: variable-length peptides keyed by two independent
32-bit FNV-1a fingerprints (64 bits, stored in full: 12 bytes a slot) in
8-slot buckets chosen by :func:`hash32`. Every build checks that no two
distinct peptides share a fingerprint.

Artifacts are the same ``.npz`` files as the JAX package writes and
reads: for k-mer tables flat ``rem``/``values`` or the packed device row
layout ``rows``; for peptide tables ``key_hi``/``key_lo``/``values`` and
the raw keys.
"""

from __future__ import annotations

import numpy as np

from ..ops import encoding, kmers

EMPTY = np.int32(-1)
BUCKET = 8

MASK20 = np.uint32((1 << 20) - 1)
MASK25 = np.uint32((1 << 25) - 1)

_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)
_C3 = np.uint32(0xC2B2AE3D)

_FNV_OFFSET = np.uint32(0x811C9DC5)
_FNV_PRIME = np.uint32(0x01000193)
_FNV_OFFSET2 = np.uint32(0xCBF29CE4)

MIN_NB_BITS = 15
BUCKET8S_MAX_KEYS = 30_000_000
MAX_NB_BITS = 25


def _mx(x):
    """32-bit finalizer over numpy uint32 arrays."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x


def mix_key(hi, lo):
    """Invertible 45-bit whitening of a (20-bit, 25-bit) packed k-mer via
    a 3-round Feistel network; returns uint32 (mhi, mlo)."""
    h = np.asarray(hi).astype(np.uint32)
    l = np.asarray(lo).astype(np.uint32)
    l = l ^ (_mx(h + _C1) & MASK25)
    h = h ^ (_mx(l + _C2) & MASK20)
    l = l ^ (_mx(h + _C3) & MASK25)
    return h, l


def unmix_key(mhi, mlo):
    """The inverse of :func:`mix_key`: uint32 (hi, lo) of whitened
    (mhi, mlo)."""
    h = np.asarray(mhi).astype(np.uint32)
    l = np.asarray(mlo).astype(np.uint32)
    l = l ^ (_mx(h + _C3) & MASK25)
    h = h ^ (_mx(l + _C2) & MASK20)
    l = l ^ (_mx(h + _C1) & MASK25)
    return h, l


def hash32(hi, lo) -> np.ndarray:
    """32-bit mix of two key lanes (the peptide-table bucket hash and the
    shard-ownership hash of the JAX package)."""
    h = ((np.asarray(hi).astype(np.uint32) * _C1)
         ^ (np.asarray(lo).astype(np.uint32) * _C2))
    h ^= h >> np.uint32(16)
    h *= _C3
    h ^= h >> np.uint32(13)
    return h


def fingerprint_host(codes: np.ndarray) -> tuple[np.uint32, np.uint32]:
    """Two independent FNV-1a style hashes over one peptide's AA codes.
    h1 avoids the all-ones pattern so that EMPTY stays unambiguous."""
    h1 = _FNV_OFFSET
    h2 = _FNV_OFFSET2
    with np.errstate(over="ignore"):
        for c in codes.astype(np.uint32):
            h1 = (h1 ^ c) * _FNV_PRIME
            h2 = (h2 ^ (c + np.uint32(0x9E37))) * _FNV_PRIME
    if h1 == np.uint32(0xFFFFFFFF):
        h1 = np.uint32(0)
    return h1, h2


def fingerprints_matrix(codes: np.ndarray, lengths: np.ndarray):
    """:func:`fingerprint_host` over padded AA-code rows, one numpy pass
    a column. Returns (h1, h2) int32."""
    n, L = codes.shape
    h1 = np.full(n, _FNV_OFFSET, dtype=np.uint32)
    h2 = np.full(n, _FNV_OFFSET2, dtype=np.uint32)
    with np.errstate(over="ignore"):
        for j in range(L):
            live = j < lengths
            c = codes[:, j].astype(np.uint32)
            h1 = np.where(live, (h1 ^ c) * _FNV_PRIME, h1)
            h2 = np.where(live, (h2 ^ (c + np.uint32(0x9E37))) * _FNV_PRIME,
                          h2)
    h1 = np.where(h1 == np.uint32(0xFFFFFFFF), np.uint32(0), h1)
    return h1.astype(np.int32), h2.astype(np.int32)


def _fingerprints(peptides, chunk: int = 2_000_000):
    """Fingerprint many peptides (strings or code arrays): one blob encode
    and a padded-matrix FNV, chunked to bound the padded allocation (real
    tryptic indexes hold tens of millions of keys)."""
    n = len(peptides)
    hi = np.zeros(n, dtype=np.int32)
    lo = np.zeros(n, dtype=np.int32)
    for s in range(0, n, chunk):
        part = peptides[s:s + chunk]
        if part and isinstance(part[0], (str, bytes)):
            blob = "".join(p if isinstance(p, str) else p.decode()
                           for p in part)
            codes = encoding.encode_aa(blob)
            lens = np.fromiter((len(p) for p in part), np.int64,
                               count=len(part))
        else:
            arrs = [np.asarray(p, dtype=np.uint8) for p in part]
            codes = (np.concatenate(arrs) if arrs
                     else np.zeros(0, np.uint8))
            lens = np.fromiter((len(a) for a in arrs), np.int64,
                               count=len(arrs))
        L = int(lens.max()) if len(lens) and lens.max() > 0 else 1
        mat = np.zeros((len(part), L), dtype=np.uint8)
        if len(codes):
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            rows = np.repeat(np.arange(len(part)), lens)
            cols = np.arange(len(codes)) - np.repeat(starts, lens)
            mat[rows, cols] = codes
        h1, h2 = fingerprints_matrix(mat, lens)
        hi[s:s + len(part)] = h1
        lo[s:s + len(part)] = h2
    return hi, lo


def _insert_bucketized(bucket0: np.ndarray, payloads, cap: int,
                       tag_distance: bool = False, bucket: int = BUCKET,
                       max_round: int | None = None):
    """Place keys into ``bucket``-wide rows with bucket-level linear
    probing, round by round (slot-identical to the JAX package's numpy
    path). The first payload gets EMPTY fill (and, with
    ``tag_distance``, ``min(r, 1) << 30`` at round r), the rest 0 fill.
    Keys still unplaced after ``max_round`` are returned. Returns
    (outputs, max_probes, leftover_indices)."""
    n = len(bucket0)
    n_buckets = max(cap // bucket, 1)
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(payloads))]
    occupancy = np.zeros(n_buckets, dtype=np.int64)
    pending = np.arange(n)
    r = 0
    max_probes = 0
    while len(pending):
        if max_round is not None and r > max_round:
            break
        if r > n_buckets:
            raise RuntimeError("table capacity exhausted")
        b = (bucket0[pending] + r) % n_buckets
        order = np.argsort(b, kind="stable")
        bs = b[order]
        starts = np.concatenate([[0], np.nonzero(np.diff(bs))[0] + 1])
        group_start = np.repeat(
            starts, np.diff(np.concatenate([starts, [len(bs)]])))
        rank = np.arange(len(bs)) - group_start
        free = bucket - occupancy[bs]
        place = rank < free
        slot = bs[place] * bucket + occupancy[bs[place]] + rank[place]
        idx = pending[order][place]
        for i, (out, payload) in enumerate(zip(outs, payloads)):
            if i == 0 and tag_distance:
                out[slot] = payload[idx] | np.int32(min(r, 1) << 30)
            else:
                out[slot] = payload[idx]
        placed_buckets, placed_counts = np.unique(bs[place],
                                                  return_counts=True)
        occupancy[placed_buckets] += placed_counts
        if place.any():
            max_probes = max(max_probes, r)
        pending = pending[order][~place]
        r += 1
    return outs, max_probes, pending


def _insert_conveyor(bucket0: np.ndarray, payloads, cap: int,
                     bucket: int = 16):
    """Distance-<=1 placement that maximises occupancy (the JAX package's
    numpy conveyor, umgap_tpu/index/table.py:261, slot for slot).

    Round-based placement (:func:`_insert_bucketized`) fills every home
    bucket first and only then pushes leftovers one bucket right, so a
    key carried from bucket b - 1 competes with b's own arrivals after
    they took the slots. Here carried keys take priority in their
    overflow bucket and the home arrivals they displace become the next
    bucket's carry: a key reaches the stash only when its home bucket's
    carry-in alone fills the bucket. The probe is unchanged (distance
    tags 0/1; a bucket with an empty slot never has displaced or stashed
    keys). Returns (outputs, max_probes, stash_indices) as
    :func:`_insert_bucketized` with ``tag_distance=True``."""
    n = len(bucket0)
    nb = max(cap // bucket, 1)
    outs = [np.full(cap, EMPTY if i == 0 else 0, dtype=np.int32)
            for i in range(len(payloads))]
    cnt = np.bincount(bucket0, minlength=nb).astype(np.int64)
    # water-filling carry: c(b) = max(c(b-1) + cnt(b) - bucket, 0)
    s = np.cumsum(cnt - bucket)
    runmin = np.minimum.accumulate(s)
    carry = np.maximum(s - np.minimum(runmin, 0), 0)
    if n and carry.max() > bucket:
        # one bucket's carry exceeds a whole bucket (only far beyond any
        # sized load): the exact sequential sweep
        return _insert_conveyor_slow(bucket0, payloads, cap, bucket, outs)
    c_in = np.concatenate([[0], carry[:-1]])
    placed_home = cnt - carry
    order = np.argsort(bucket0, kind="stable")  # stable within buckets
    b_sorted = bucket0[order]
    starts = np.searchsorted(b_sorted, np.arange(nb))
    rank = np.arange(n, dtype=np.int64) - starts[b_sorted]
    home = rank < placed_home[b_sorted]
    slot = np.empty(n, dtype=np.int64)
    slot[home] = (b_sorted[home] * bucket + c_in[b_sorted[home]]
                  + rank[home])
    pushed_pos = np.nonzero(~home)[0]  # sorted positions of pushed keys
    pr = rank[pushed_pos] - placed_home[b_sorted[pushed_pos]]
    tgt = (b_sorted[pushed_pos] + 1) % nb
    pslot = tgt * bucket + pr
    keep = np.ones(n, dtype=bool)
    # the wrap: the last bucket's carry takes bucket 0's leftover room
    # (bucket 0 holds its placed home arrivals; c_in[0] == 0)
    wrap = tgt == 0
    if wrap.any():
        base0 = min(int(cnt[0]), bucket)
        room0 = bucket - base0
        stash_w = pr[wrap] >= room0
        pslot[wrap] = np.where(stash_w, 0, base0 + pr[wrap])
        keep[pushed_pos[wrap]] = ~stash_w
    slot[pushed_pos] = pslot
    idx = order[keep]
    slots_kept = slot[keep]
    tags = np.zeros(n, dtype=np.int32)
    tags[pushed_pos] = 1
    tags_kept = tags[keep]
    for i, (out, payload) in enumerate(zip(outs, payloads)):
        if i == 0:
            out[slots_kept] = payload[idx] | (tags_kept << 30)
        else:
            out[slots_kept] = payload[idx]
    max_probes = 1 if len(pushed_pos) else 0
    stash_idx = np.sort(order[~keep])
    return outs, max_probes, stash_idx


def _insert_conveyor_slow(bucket0, payloads, cap, bucket, outs):
    """The exact sequential conveyor sweep (clamped carry, two laps for
    the wrap): the backstop of :func:`_insert_conveyor` for loads where
    one bucket's carry exceeds a bucket."""
    n = len(bucket0)
    nb = max(cap // bucket, 1)
    order = np.argsort(bucket0, kind="stable")
    b_sorted = bucket0[order]
    starts = np.searchsorted(b_sorted, np.arange(nb + 1))
    occ = np.zeros(nb, dtype=np.int64)
    slot = np.empty(n, dtype=np.int64)
    tag = np.zeros(n, dtype=np.int32)
    stash: list = []
    carry: list = []
    max_probes = 0
    for lap in range(2):
        for b in range(nb):
            room = bucket - occ[b]
            take = min(len(carry), room)
            for j in range(take):
                k = carry[j]
                slot[k] = b * bucket + occ[b] + j
                tag[k] = 1
                max_probes = 1
            occ[b] += take
            stash.extend(carry[take:])
            carry = []
            if lap == 0:
                ks = order[starts[b]:starts[b + 1]]
                room = bucket - occ[b]
                placed = ks[:room] if room > 0 else ks[:0]
                for j, k in enumerate(placed):
                    slot[k] = b * bucket + occ[b] + j
                occ[b] += len(placed)
                carry = list(ks[len(placed):])
        if lap == 0 and not carry:
            break
        if lap == 1:
            stash.extend(carry)
            carry = []
    placed_mask = np.ones(n, dtype=bool)
    placed_mask[np.array(stash, dtype=np.int64)] = False
    for i, (out, payload) in enumerate(zip(outs, payloads)):
        if i == 0:
            out[slot[placed_mask]] = (payload[placed_mask]
                                      | (tag[placed_mask] << 30))
        else:
            out[slot[placed_mask]] = payload[placed_mask]
    return outs, max_probes, np.array(sorted(stash), dtype=np.int64)


class TableGeometryError(ValueError):
    """A layout cannot represent the requested capacity (the 25-bit
    bucket-index cap)."""


def _pow2_capacity(n: int, load_factor: float, min_cap: int) -> int:
    cap = min_cap
    while cap * load_factor < max(n, 1):
        cap *= 2
    return cap


class KmerTable:
    """Fixed-k packed-kmer table, quotient-stored: 8 bytes per slot, plus
    an optional full-key stash for keys beyond the probe-distance limit.
    ``rows_packed`` is the (n_buckets, 2 * bucket) device row layout
    ``[remainders | values]``; a packed artifact stores only that."""

    kind = "kmer"

    def __init__(self, rem, values, max_probes: int, n: int, meta=None,
                 stash_hi=None, stash_lo=None, stash_val=None,
                 rows_packed=None):
        if rem is None and rows_packed is None:
            raise ValueError("KmerTable needs rem/values or rows_packed")
        self._rem = rem
        self._values = values
        self.rows_packed = rows_packed
        self.max_probes = int(max_probes)
        self.n = int(n)
        self.meta = dict(meta or {})
        z = np.zeros(0, dtype=np.int32)
        self.stash_hi = z if stash_hi is None else np.asarray(stash_hi)
        self.stash_lo = z if stash_lo is None else np.asarray(stash_lo)
        self.stash_val = z if stash_val is None else np.asarray(stash_val)

    @property
    def rem(self):
        if self._rem is None:
            bk = self.bucket
            self._rem = np.ascontiguousarray(
                self.rows_packed[:, :bk]).reshape(-1)
        return self._rem

    @property
    def values(self):
        if self._values is None:
            bk = self.bucket
            self._values = np.ascontiguousarray(
                self.rows_packed[:, bk:2 * bk]).reshape(-1)
        return self._values

    @property
    def capacity(self) -> int:
        if self._values is None:
            return self.rows_packed.shape[0] * self.bucket
        return len(self._values)

    @property
    def bucket(self) -> int:
        return int(self.meta.get("bucket", BUCKET))

    @property
    def n_buckets(self) -> int:
        return max(self.capacity // self.bucket, 1)

    @property
    def nb_bits(self) -> int:
        return int(self.meta["nb_bits"])

    @property
    def k(self) -> int:
        return self.meta.get("k", kmers.DEFAULT_K)

    def packed_rows(self) -> np.ndarray:
        """The (n_buckets, 2 * bucket) int32 device row layout."""
        if self.rows_packed is not None:
            return self.rows_packed
        nb, bk = self.n_buckets, self.bucket
        return np.concatenate([self.rem.reshape(nb, bk),
                               self.values.reshape(nb, bk)],
                              axis=1).astype(np.int32)

    @classmethod
    def build(cls, packed: np.ndarray, values: np.ndarray, k: int,
              load_factor: float = 0.45, capacity: int | None = None,
              max_probe_limit: int = 1, bucket: int = BUCKET,
              stash_cap: int = 128) -> "KmerTable":
        """The JAX package's build, array for array: with
        ``max_probe_limit=1`` (the default) the dense two-round conveyor
        (:func:`_insert_conveyor`), else round-based placement with at
        most ``max_probe_limit`` extra rounds. Overflow goes to the stash
        (up to ``stash_cap`` keys) and the table doubles only when the
        stash would overflow too. Keys must be unique."""
        if k > 9:
            raise TableGeometryError(
                "exact quotient k-mer tables support k <= 9")
        packed = np.asarray(packed).astype(np.uint64)
        values = np.asarray(values, dtype=np.int32)
        hi, lo = kmers.split_packed(packed)
        mhi, mlo = mix_key(hi, lo)
        cap = capacity or _pow2_capacity(
            len(values), load_factor, bucket << MIN_NB_BITS)
        cap = max(cap, bucket << MIN_NB_BITS)
        while True:
            nb_bits = int(np.log2(max(cap // bucket, 1)))
            if nb_bits > MAX_NB_BITS:
                raise TableGeometryError(
                    "table too large for 25-bit bucket index")
            bucket0 = (mlo & np.uint32((1 << nb_bits) - 1)).astype(np.int64)
            rem = ((mlo >> np.uint32(nb_bits))
                   | (mhi << np.uint32(25 - nb_bits))).astype(np.int32)
            if max_probe_limit == 1:
                (rem_arr, val_arr), max_probes, leftover = \
                    _insert_conveyor(bucket0, [rem, values], cap,
                                     bucket=bucket)
            else:
                (rem_arr, val_arr), max_probes, leftover = \
                    _insert_bucketized(
                        bucket0, [rem, values], cap, tag_distance=True,
                        bucket=bucket, max_round=max_probe_limit)
            if len(leftover) <= stash_cap:
                return cls(rem_arr, val_arr, max_probes, len(values),
                           {"k": k, "nb_bits": nb_bits, "bucket": bucket},
                           stash_hi=hi[leftover].astype(np.int32),
                           stash_lo=lo[leftover].astype(np.int32),
                           stash_val=values[leftover])
            if capacity is not None:
                raise RuntimeError(
                    f"{len(leftover)} keys exceed the probe-distance limit "
                    "at the requested capacity; use a larger capacity")
            cap *= 2

    def items(self, bucket_range: tuple[int, int] | None = None):
        """(packed key, value) pairs in slot order, stash last: the
        distance tag makes the key exact (home bucket = slot bucket -
        distance). ``bucket_range=(b0, b1)`` reads only buckets [b0, b1),
        without the stash and without the whole slot arrays (keys
        displaced into the range from bucket b0 - 1 appear, keys displaced
        out of it do not)."""
        if bucket_range is not None:
            b0, b1 = bucket_range
            bk = self.bucket
            if self.rows_packed is not None:
                sl = np.asarray(self.rows_packed[b0:b1])
                rem_s = np.ascontiguousarray(sl[:, :bk]).reshape(-1)
                val_s = np.ascontiguousarray(sl[:, bk:2 * bk]).reshape(-1)
            else:
                rem_s = self.rem[b0 * bk:b1 * bk]
                val_s = self.values[b0 * bk:b1 * bk]
            occ = np.nonzero(rem_s != EMPTY)[0]
            return self._items_from(occ + b0 * bk, rem_s[occ], val_s[occ])
        occ = np.nonzero(self.rem != EMPTY)[0]
        return self._items_from(occ, self.rem[occ], self.values[occ],
                                with_stash=True)

    def _items_from(self, occ, rem_occ, val_occ, with_stash: bool = False):
        tag = rem_occ.astype(np.uint32)
        dist = (tag >> np.uint32(30)).astype(np.int64)
        rem = tag & np.uint32((1 << 30) - 1)
        nb_bits, nb = self.nb_bits, self.n_buckets
        home = ((occ // self.bucket) - dist) % nb
        mlo = (home.astype(np.uint32)
               | ((rem & np.uint32((1 << (25 - nb_bits)) - 1))
                  << np.uint32(nb_bits))) & MASK25
        mhi = (rem >> np.uint32(25 - nb_bits)) & MASK20
        hi, lo = unmix_key(mhi, mlo)
        packed = kmers.join_packed(hi.astype(np.int32), lo.astype(np.int32))
        values = val_occ
        if with_stash and len(self.stash_hi):
            packed = np.concatenate(
                [packed, kmers.join_packed(self.stash_hi, self.stash_lo)])
            values = np.concatenate([values, self.stash_val])
        return packed, values

    def probe_host(self, hi: np.ndarray, lo: np.ndarray,
                   default: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Look keys up on the host: up to ``max_probes + 1`` bucket rows
        from the key's home bucket (stopping at a row with an empty
        slot), then the stash. Returns (values int32, found bool)."""
        hi = np.asarray(hi, dtype=np.int32)
        lo = np.asarray(lo, dtype=np.int32)
        nb = self.n_buckets
        nb_bits = self.nb_bits
        mhi, mlo = mix_key(hi, lo)
        bucket = (mlo & np.uint32(nb - 1)).astype(np.int64)
        rem = ((mlo >> np.uint32(nb_bits))
               | (mhi << np.uint32(25 - nb_bits))).astype(np.int32)
        kr = self.rem.reshape(nb, self.bucket)
        kv = self.values.reshape(nb, self.bucket)
        out = np.full(hi.shape, default, dtype=np.int32)
        found = np.zeros(hi.shape, dtype=bool)
        live = np.ones(hi.shape, dtype=bool)
        for r in range(self.max_probes + 1):
            if not live.any():
                break
            rr = kr[bucket]
            rv = kv[bucket]
            tag = rem | np.int32(min(r, 1) << 30)
            hit = rr == tag[..., None]
            anyhit = hit.any(axis=-1)
            val = np.take_along_axis(
                rv, np.argmax(hit, axis=-1)[..., None], axis=-1)[..., 0]
            newly = live & anyhit
            out[newly] = val[newly]
            found |= newly
            live = live & ~anyhit & ~(rr == EMPTY).any(axis=-1)
            bucket = (bucket + 1) % nb
        if len(self.stash_hi):
            eq = ((hi[..., None] == self.stash_hi)
                  & (lo[..., None] == self.stash_lo))
            shit = eq.any(axis=-1)
            sval = np.take(self.stash_val, np.argmax(eq, axis=-1))
            out = np.where(shit, sval, out)
            found |= shit
        return out, found

    def save(self, path, compress: bool = True, packed: bool = False):
        """Write the JAX package's ``.npz`` format: flat ``rem``/``values``
        (deflated unless ``compress=False``) or, with ``packed=True``,
        the device row layout ``rows`` uncompressed."""
        common = dict(
            kind=np.bytes_(self.kind),
            max_probes=np.int64(self.max_probes),
            n=np.int64(self.n),
            stash_hi=self.stash_hi,
            stash_lo=self.stash_lo,
            stash_val=self.stash_val,
            **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
        )
        if packed:
            np.savez(path, rows=self.packed_rows(), **common)
            return
        saver = np.savez_compressed if compress else np.savez
        saver(path, rem=self.rem, values=self.values, **common)


def build_kmer_table(packed: np.ndarray, values: np.ndarray, k: int,
                     layout: str = "bucket8s", **kw) -> KmerTable:
    """Build a single-round k-mer table:

    - ``bucket8s`` (default): 8-slot buckets (64 B rows), stash of 256;
      beyond ``BUCKET8S_MAX_KEYS`` keys (or the 25-bit bucket cap) it
      builds ``bucket64s`` instead, as the JAX package does;
    - ``bucket64s``: 64-slot buckets (512 B rows) at load <= 0.5;
    - ``bucket16``: 16-slot buckets (128 B rows).
    """
    if layout == "bucket8s":
        if len(values) <= BUCKET8S_MAX_KEYS:
            kw8 = dict(kw)
            kw8.setdefault("stash_cap", 256)
            try:
                return KmerTable.build(packed, values, k, bucket=8,
                                       max_probe_limit=0, **kw8)
            except TableGeometryError:
                pass
        return build_kmer_table(packed, values, k, layout="bucket64s", **kw)
    if layout == "bucket64s":
        kw.setdefault("stash_cap", 256)
        kw.setdefault("load_factor", 0.5)
        return KmerTable.build(packed, values, k, bucket=64,
                               max_probe_limit=0, **kw)
    if layout == "bucket16":
        return KmerTable.build(packed, values, k, bucket=16,
                               max_probe_limit=0, **kw)
    raise ValueError(f"unsupported k-mer table layout for this port: {layout}")


class FingerprintCollision(ValueError):
    """Two distinct indexed peptides share a 64-bit fingerprint. Every
    build checks, so lookups of indexed keys are exact like the
    reference's FST; a query of a peptide that is not indexed keeps the
    ~n/2^64 false-positive bound (PARITY.md)."""


def _check_fingerprint_collisions(peptides, hi: np.ndarray,
                                  lo: np.ndarray) -> None:
    """Abort the build if two distinct key strings share a fingerprint
    (identical duplicates pass through unchanged)."""
    if len(peptides) < 2:
        return
    key = ((hi.view(np.uint32).astype(np.uint64) << np.uint64(32))
           | lo.view(np.uint32).astype(np.uint64))
    order = np.argsort(key, kind="stable")
    dup = np.flatnonzero(key[order][1:] == key[order][:-1])
    if not len(dup):
        return

    def as_str(p):
        if isinstance(p, str):
            return p
        if isinstance(p, bytes):
            return p.decode()
        return encoding.decode_aa(np.asarray(p, dtype=np.uint8))

    bad = []
    for i in dup:
        a, b = order[i], order[i + 1]
        pa, pb = as_str(peptides[a]), as_str(peptides[b])
        if pa != pb:
            bad.append((pa, pb))
    if bad:
        raise FingerprintCollision(
            f"{len(bad)} fingerprint collision(s) between distinct "
            f"peptides, first: {bad[0][0]!r} vs {bad[0][1]!r}; the "
            "index would return wrong taxa for these keys")


class PeptideTable:
    """Variable-length peptide table keyed by 64-bit fingerprints: flat
    ``key_hi``, ``key_lo``, ``values`` of ``capacity`` slots in rows of
    ``BUCKET``, EMPTY in ``key_hi`` marking a free slot. With
    ``store_keys`` (the default) the key strings are kept for
    ``printindex``."""

    kind = "peptide"
    bucket = BUCKET

    def __init__(self, key_hi, key_lo, values, max_probes: int, n: int,
                 meta=None):
        self.key_hi = key_hi
        self.key_lo = key_lo
        self.values = values
        self.max_probes = int(max_probes)
        self.n = int(n)
        self.meta = dict(meta or {})
        self.raw_keys = None
        self.raw_values = None

    @property
    def capacity(self) -> int:
        return len(self.values)

    @property
    def n_buckets(self) -> int:
        return max(self.capacity // BUCKET, 1)

    def packed_rows(self) -> np.ndarray:
        """The (n_buckets, 3 * BUCKET) int32 device row layout
        ``[key_hi | key_lo | values]``."""
        nb = self.n_buckets
        return np.concatenate([self.key_hi.reshape(nb, BUCKET),
                               self.key_lo.reshape(nb, BUCKET),
                               self.values.reshape(nb, BUCKET)],
                              axis=1).astype(np.int32)

    @classmethod
    def build(cls, peptides, values: np.ndarray,
              load_factor: float = 0.45, store_keys: bool = True,
              capacity: int | None = None) -> "PeptideTable":
        """``capacity`` pins the table size (a power of two)."""
        peptides = list(peptides)
        hi, lo = _fingerprints(peptides)
        _check_fingerprint_collisions(peptides, hi, lo)
        t = cls._from_fingerprints(hi, lo, values, load_factor, capacity)
        if store_keys:
            t.raw_keys = [p if isinstance(p, str) else encoding.decode_aa(p)
                          for p in peptides]
            t.raw_values = np.asarray(values, dtype=np.int32)
        return t

    @classmethod
    def _from_fingerprints(cls, hi: np.ndarray, lo: np.ndarray, values,
                           load_factor: float = 0.45,
                           capacity: int | None = None) -> "PeptideTable":
        """Place (hi, lo, value) rows whose fingerprints are already made
        (and distinct) into the buckets, as :meth:`build` does."""
        values = np.asarray(values, dtype=np.int32)
        cap = capacity or _pow2_capacity(len(values), load_factor, 64)
        n_buckets = max(cap // BUCKET, 1)
        bucket0 = (hash32(hi, lo) & np.uint32(n_buckets - 1)).astype(np.int64)
        (kh, kl, kv), max_probes, _ = _insert_bucketized(
            bucket0, [np.asarray(hi, np.int32), np.asarray(lo, np.int32),
                      values], cap)
        return cls(kh, kl, kv, max_probes, len(values))

    def probe_host(self, hi: np.ndarray, lo: np.ndarray,
                   default: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Look fingerprints up on the host: up to ``max_probes + 1`` rows
        from the :func:`hash32` bucket, stopping at a row with an empty
        slot. Returns (values int32, found bool)."""
        hi = np.asarray(hi, dtype=np.int32)
        lo = np.asarray(lo, dtype=np.int32)
        nb = self.n_buckets
        kh = self.key_hi.reshape(nb, BUCKET)
        kl = self.key_lo.reshape(nb, BUCKET)
        kv = self.values.reshape(nb, BUCKET)
        bucket = (hash32(hi, lo) & np.uint32(nb - 1)).astype(np.int64)
        out = np.full(hi.shape, default, dtype=np.int32)
        found = np.zeros(hi.shape, dtype=bool)
        live = np.ones(hi.shape, dtype=bool)
        for _ in range(self.max_probes + 1):
            if not live.any():
                break
            rh = kh[bucket]
            hit = (rh == hi[..., None]) & (kl[bucket] == lo[..., None])
            anyhit = hit.any(axis=-1)
            val = np.take_along_axis(
                kv[bucket], np.argmax(hit, axis=-1)[..., None],
                axis=-1)[..., 0]
            newly = live & anyhit
            out[newly] = val[newly]
            found |= newly
            live = live & ~anyhit & ~(rh == EMPTY).any(axis=-1)
            bucket = (bucket + 1) % nb
        return out, found

    def lookup_peptides_host(self, peptides, default: int = 0):
        hi, lo = _fingerprints(list(peptides))
        return self.probe_host(hi, lo, default)

    def save(self, path):
        extra = {}
        if self.raw_keys is not None:
            extra["raw_keys"] = np.frombuffer(
                "\n".join(self.raw_keys).encode(), dtype=np.uint8)
            extra["raw_values"] = self.raw_values
        np.savez_compressed(
            path, kind=np.bytes_(self.kind), key_hi=self.key_hi,
            key_lo=self.key_lo, values=self.values,
            max_probes=np.int64(self.max_probes), n=np.int64(self.n),
            **{f"meta_{k}": np.int64(v) for k, v in self.meta.items()},
            **extra)

    @staticmethod
    def load(path):
        return load_table(path)


def mmap_npz(path) -> dict:
    """Memory-map the members of an UNCOMPRESSED ``.npz`` in place
    (``np.load`` ignores ``mmap_mode`` for ``.npz``). Raises ValueError on
    deflated members."""
    import zipfile

    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{info.filename} is deflated; mmap needs an "
                    "uncompressed npz")
            f.seek(info.header_offset)
            hdr = f.read(30)
            nlen = int.from_bytes(hdr[26:28], "little")
            elen = int.from_bytes(hdr[28:30], "little")
            f.seek(info.header_offset + 30 + nlen + elen)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = \
                    np.lib.format.read_array_header_2_0(f)
            if dtype.hasobject:
                raise ValueError("object arrays cannot be mmapped")
            name = info.filename
            if name.endswith(".npy"):
                name = name[: -len(".npy")]
            out[name] = np.memmap(path, dtype=dtype, mode="r",
                                  offset=f.tell(), shape=shape,
                                  order="F" if fortran else "C")
    return out


def load_table(path, mmap: bool = False):
    """Load a k-mer (flat or packed rows) or peptide table artifact.
    ``mmap=True`` maps uncompressed artifacts instead of reading them."""
    z = None
    if mmap:
        try:
            z = mmap_npz(path)
        except ValueError:
            z = None
    if z is None:
        with np.load(path, allow_pickle=False) as f:
            z = {name: f[name] for name in f.files}
    kind = bytes(z["kind"]).decode()
    meta = {k[len("meta_"):]: int(z[k]) for k in z if k.startswith("meta_")}
    if kind == "peptide":
        t = PeptideTable(z["key_hi"], z["key_lo"], z["values"],
                         int(z["max_probes"]), int(z["n"]), meta)
        if "raw_keys" in z:
            blob = np.asarray(z["raw_keys"]).tobytes().decode()
            t.raw_keys = blob.split("\n") if blob else []
            t.raw_values = z["raw_values"]
        return t
    if kind != "kmer":
        raise NotImplementedError(
            f"{kind} tables are not ported (k-mer and peptide tables only)")
    stash = dict(stash_hi=z.get("stash_hi"), stash_lo=z.get("stash_lo"),
                 stash_val=z.get("stash_val"))
    if "rows" in z:
        return KmerTable(None, None, int(z["max_probes"]), int(z["n"]), meta,
                         rows_packed=z["rows"], **stash)
    return KmerTable(z["rem"], z["values"], int(z["max_probes"]), int(z["n"]),
                     meta, **stash)
