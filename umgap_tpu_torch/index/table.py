"""The quotiented k-mer hash table and its ``.npz`` format (a copy of the
k-mer part of ``umgap_tpu.index.table``).

Keys are 45-bit packed 9-mers split into (20-bit, 25-bit) int32 lanes.
An invertible 3-round Feistel mix (:func:`mix_key`) whitens the key; its
low ``nb_bits`` bits select a bucket row of ``bucket`` slots and only the
remaining <= 30 bits are stored, with bit 30 tagging the probe distance,
so a slot is 8 bytes (remainder, value) and exact. Keys that do not fit
within the probe-distance limit go to a small full-key stash.

Artifacts are the same ``.npz`` files as the JAX package writes and
reads: flat ``rem``/``values`` or the packed device row layout ``rows``.
"""

from __future__ import annotations

import numpy as np

from ..ops import kmers

EMPTY = np.int32(-1)
BUCKET = 8

MASK20 = np.uint32((1 << 20) - 1)
MASK25 = np.uint32((1 << 25) - 1)

_C1 = np.uint32(0x9E3779B1)
_C2 = np.uint32(0x85EBCA77)
_C3 = np.uint32(0xC2B2AE3D)

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


def hash32(hi, lo) -> np.ndarray:
    """32-bit mix of two key lanes (the peptide-table bucket hash and the
    shard-ownership hash of the JAX package)."""
    h = ((np.asarray(hi).astype(np.uint32) * _C1)
         ^ (np.asarray(lo).astype(np.uint32) * _C2))
    h ^= h >> np.uint32(16)
    h *= _C3
    h ^= h >> np.uint32(13)
    return h


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
              max_probe_limit: int = 0, bucket: int = BUCKET,
              stash_cap: int = 128) -> "KmerTable":
        """Round-based placement with at most ``max_probe_limit`` extra
        rounds; overflow goes to the stash (up to ``stash_cap`` keys) and
        the table doubles only when the stash would overflow too. Keys
        must be unique. ``max_probe_limit=1`` is the JAX package's dense
        conveyor build, which this port does not have yet (its tables
        are read and probed all the same)."""
        if k > 9:
            raise TableGeometryError(
                "exact quotient k-mer tables support k <= 9")
        if max_probe_limit == 1:
            raise NotImplementedError(
                "the max_probe_limit=1 conveyor build is not ported yet; "
                "build such tables with umgap_tpu and load the .npz")
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
            (rem_arr, val_arr), max_probes, leftover = _insert_bucketized(
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


def load_table(path, mmap: bool = False) -> KmerTable:
    """Load a k-mer table artifact (flat or packed rows). ``mmap=True``
    maps uncompressed artifacts instead of reading them."""
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
    if kind != "kmer":
        raise NotImplementedError(
            f"{kind} tables are not ported yet (9-mer tables only)")
    meta = {k[len("meta_"):]: int(z[k]) for k in z if k.startswith("meta_")}
    stash = dict(stash_hi=z.get("stash_hi"), stash_lo=z.get("stash_lo"),
                 stash_val=z.get("stash_val"))
    if "rows" in z:
        return KmerTable(None, None, int(z["max_probes"]), int(z["n"]), meta,
                         rows_packed=z["rows"], **stash)
    return KmerTable(z["rem"], z["values"], int(z["max_probes"]), int(z["n"]),
                     meta, **stash)
