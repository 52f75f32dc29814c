"""Host-side streaming runner: batches of read groups in, one consensus
taxon per group out, in input order.

:class:`BatchStream` (a copy of the JAX package's backend-neutral
batcher) keeps up to ``depth`` batches in flight: batch i + 1 is encoded,
copied and launched before batch i is brought back to the host, so host
work overlaps device work. It takes code chunks (``feed``) or batches
already on the 4-bit packed wire (``feed_packed``, what the native ring
stream gives). :class:`Analyser` holds the taxonomy and the index on the
device and runs the fused pipeline over the packed wire, from pinned
host buffers with non-blocking copies. Groups with more distinct taxa
than ``k_max`` are re-run through a program wide enough to be exact,
never truncated.
:func:`stream_paired_chunks` and :func:`stream_single_chunks` read files
through the native chunked parser, with the width ladder.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..agg import device as devagg
from ..device import resolve_device
from ..io import fastq, sniff_open
from ..ops import encoding, lookup
from ..taxonomy import Taxonomy
from ..utils import StageTimer, verbose
from .fused import PipelineConfig, make_pipeline


WIDE_BATCH = 64  # most groups a batch of the wide program
# bytes the wide program's batch may allocate in its per-row buffers
WIDE_STEP_BYTES = 1 << 28


def wide_batch_rows(device_type: str, method: str, strategy: str, K: int,
                    plain: bool = False) -> int:
    """Groups a batch of the wide program at k_max = K. Where the step
    builds (B, K, K) aggregation tensors (the plain versions, on the CPU
    or, with ``plain``, on the card), WIDE_STEP_BYTES bounds their
    B * K * K; the steps on the card allocate per row what grows with K,
    K4's hits and its (id, count, valid) output (``dedup_counts``) and
    K6's block list (``tree_list_bytes``), which bound B the same way;
    K9's hybrid lists take a block's shared memory, or a scratch of at
    most ``RMQ_SCRATCH_MAX`` bytes whatever B. At most WIDE_BATCH either
    way."""
    if device_type != "cuda" or plain:
        per_row = K * K
    else:
        per_row = 4 * K + 9 * K + devagg.tree_list_bytes(K)
    return max(1, min(WIDE_BATCH, WIDE_STEP_BYTES // max(per_row, 1)))


def encode_batch(groups: Sequence[Sequence[str]], ends: int, length: int):
    """Encode read groups into (B, E, L) codes + lengths. A record longer
    than ``length`` is an error: callers pick a width that fits (the
    CLI's width ladder) and nothing is clipped."""
    B = len(groups)
    dna = np.full((B, ends, length), encoding.DNA_N, dtype=np.uint8)
    lens = np.zeros((B, ends), dtype=np.int32)
    for i, group in enumerate(groups):
        for e, seq in enumerate(group[:ends]):
            codes = encoding.encode_dna(seq)
            if len(codes) > length:
                raise ValueError(
                    f"record of {len(codes)} bp exceeds the batch width "
                    f"{length}; records are never clipped")
            dna[i, e, : len(codes)] = codes
            lens[i, e] = len(codes)
    return dna, lens


def read_groups_fastq(paths: Sequence[str], delimiter: str = "/"):
    """Yield (header, [sequences...]) groups from paired FASTQ files,
    header stripped at the delimiter (uniq -d semantics); stops at the
    shorter file. Gzipped inputs are detected by magic bytes
    (umgap-analyse.sh:159-175)."""
    handles = [sniff_open(p) for p in paths]
    try:
        readers = [fastq.read_records(h) for h in handles]
        for group in fastq.interleave(readers):
            header = group[0].header
            idx = header.find(delimiter)
            if idx != -1:
                header = header[:idx]
            yield header, [rec.sequence for rec in group]
    finally:
        for h in handles:
            h.close()


def read_groups_fasta(path: str, delimiter: str = "/"):
    """Single-end FASTA ingest, gzip sniffed: one group per record."""
    from ..io import fasta

    with sniff_open(path) as f:
        for rec in fasta.read_records(f, unwrap=True):
            header = rec.header
            idx = header.find(delimiter)
            if idx != -1:
                header = header[:idx]
            yield header, [rec.sequence[0] if rec.sequence else ""]


class BatchStream:
    """Order-preserving streaming batcher with depth-bounded pipelining.

    Subclasses provide ``_dispatch(dna, lens)`` (launch one padded
    (B, E, L) batch asynchronously, return a handle) and
    ``_finalize(handle, dna, lens, n)`` (bring the handle back as a
    per-group result array of length >= n), and their twins
    ``_dispatch_packed`` / ``_finalize_packed`` for batches already on
    the 4-bit packed wire. ``timer`` adds up the host's time by stage
    (dispatch, materialize, overflow_fallback; the analyser's
    device_state_load), written to stderr under VERBOSE at each drain as
    ``umgap_tpu``'s stream does."""

    depth = 2

    def __init__(self, batch_size: int, read_length: int, ends: int):
        self.batch_size = batch_size
        self.read_length = read_length
        self.ends = ends
        self.timer = StageTimer()
        self._pend: List[Tuple[List[str], np.ndarray, np.ndarray]] = []
        self._pend_n = 0
        self._inflight: List = []

    def _dispatch(self, dna: np.ndarray, lens: np.ndarray):
        raise NotImplementedError

    def _finalize(self, handle, dna, lens, n) -> np.ndarray:
        raise NotImplementedError

    # The native ring stream delivers batches already on the 4-bit wire,
    # so the host loop is just dispatch and drain: no per-record Python,
    # no numpy pack.

    def _dispatch_packed(self, dna4: np.ndarray, lens: np.ndarray):
        raise NotImplementedError

    def _finalize_packed(self, handle, dna4, lens, n) -> np.ndarray:
        raise NotImplementedError

    def feed_packed(self, headers, dna4: np.ndarray, lens: np.ndarray,
                    n: int):
        """Queue ONE pre-packed batch of ``batch_size`` rows (rows from
        ``n`` on are padding). ``headers`` may be any token carried
        through to the output side (the CLI passes a (blob, offsets)
        pair for native formatting). Yields completed (headers,
        taxa[:n]) batches."""
        with self.timer.stage("dispatch"):
            handle = self._dispatch_packed(dna4, lens)
        self._inflight.append((headers, dna4, lens, n, handle, True))
        while len(self._inflight) > self.depth:
            yield self._emit_batch(self._inflight.pop(0))

    def _norm(self, dna: np.ndarray, lens: np.ndarray):
        L = self.read_length
        if dna.shape[-1] > L:
            raise ValueError(
                f"chunk width {dna.shape[-1]} exceeds read_length {L}")
        if dna.shape[-1] < L:
            dna = np.pad(dna, ((0, 0), (0, 0), (0, L - dna.shape[-1])),
                         constant_values=encoding.DNA_N)
        return dna, np.minimum(lens, L)

    def _emit_batch(self, item):
        headers, dna, lens, n, handle, packed = item
        fin = self._finalize_packed if packed else self._finalize
        return headers, fin(handle, dna, lens, n)[:n]

    def _launch(self, headers, dna, lens):
        n = len(headers)
        B = self.batch_size
        if n < B:
            dna = np.pad(dna, ((0, B - n), (0, 0), (0, 0)),
                         constant_values=encoding.DNA_N)
            lens = np.pad(lens, ((0, B - n), (0, 0)))
        with self.timer.stage("dispatch"):
            handle = self._dispatch(dna, lens)
        self._inflight.append((headers, dna, lens, n, handle, False))

    def _take_batch(self):
        B = self.batch_size
        hs: List[str] = []
        ds: List[np.ndarray] = []
        ls: List[np.ndarray] = []
        need = B
        while need:
            bh, bd, bl = self._pend[0]
            if len(bh) <= need:
                self._pend.pop(0)
                hs.extend(bh)
                ds.append(bd)
                ls.append(bl)
                need -= len(bh)
            else:
                hs.extend(bh[:need])
                ds.append(bd[:need])
                ls.append(bl[:need])
                self._pend[0] = (bh[need:], bd[need:], bl[need:])
                need = 0
        self._pend_n -= B
        return hs, np.concatenate(ds), np.concatenate(ls)

    def reset(self):
        self._pend, self._pend_n, self._inflight = [], 0, []

    def feed_batches(self, headers: List[str], dna: np.ndarray,
                     lens: np.ndarray):
        """Queue one chunk; yields completed (headers, taxa) batches."""
        if len(headers):
            dna, lens = self._norm(np.asarray(dna), np.asarray(lens))
            self._pend.append((list(headers), dna, lens))
            self._pend_n += len(headers)
        while self._pend_n >= self.batch_size:
            self._launch(*self._take_batch())
            while len(self._inflight) > self.depth:
                yield self._emit_batch(self._inflight.pop(0))

    def feed(self, headers: List[str], dna: np.ndarray, lens: np.ndarray):
        for hs, ts in self.feed_batches(headers, dna, lens):
            for h, t in zip(hs, ts):
                yield h, int(t)

    def finish_batches(self):
        """Flush the partial tail batch and drain everything in flight."""
        if self._pend_n:
            hs, ds, ls = [], [], []
            for bh, bd, bl in self._pend:
                hs.extend(bh)
                ds.append(bd)
                ls.append(bl)
            self._pend, self._pend_n = [], 0
            self._launch(hs, np.concatenate(ds), np.concatenate(ls))
        while self._inflight:
            yield self._emit_batch(self._inflight.pop(0))
        verbose("stream timings:\n" + self.timer.report())

    def finish(self):
        for hs, ts in self.finish_batches():
            for h, t in zip(hs, ts):
                yield h, int(t)

    def analyse_groups(self, groups):
        """groups: iterable of (header, [seq...]). Yields (header, taxon)."""
        buf_h: List[str] = []
        buf_s: List[Sequence[str]] = []
        for header, seqs in groups:
            buf_h.append(header)
            buf_s.append(seqs)
            if len(buf_h) == self.batch_size:
                dna, lens = encode_batch(buf_s, self.ends, self.read_length)
                yield from self.feed(buf_h, dna, lens)
                buf_h, buf_s = [], []
        if buf_h:
            dna, lens = encode_batch(buf_s, self.ends, self.read_length)
            yield from self.feed(buf_h, dna, lens)
        yield from self.finish()


class Analyser(BatchStream):
    """Device-resident taxonomy and index across samples, the analogue of
    the reference's socket index service. Runs on the current CUDA device
    unless ``device`` says otherwise (``device="cpu"`` for the plain
    path); pass prebuilt ``dtax`` / ``dtable`` / ``euler`` to share device
    state. rmq/lca* builds its Euler tables from ``tax`` when no
    ``euler`` is given."""

    def __init__(self, tax: Taxonomy | None, table, config: PipelineConfig,
                 batch_size: int = 1024, read_length: int = 160,
                 ends: int = 2, dtax=None, dtable=None, device=None,
                 euler=None):
        super().__init__(batch_size, read_length, ends)
        self.config = config
        self.device = resolve_device(device)
        with self.timer.stage("device_state_load"):
            self.dtax = (dtax if dtax is not None else
                         devagg.DeviceTaxonomy.from_host(tax, self.device))
            self.dtable = (dtable if dtable is not None else
                           lookup.DeviceTable.from_host(table, self.device))
            if euler is None and tax is not None and (
                    config.method, config.strategy) == ("rmq", "lca*"):
                from ..agg.device_rmq import DeviceEuler

                euler = DeviceEuler.from_host(tax, self.device)
        self.euler = euler
        self.step = self._make_step(config, with_overflow=True)
        self._wide_step = None
        self.overflow_reads = 0
        verbose(f"{type(self).__name__} ready: preset={config.name} "
                f"batch={batch_size} ends={ends}")

    def _make_step(self, config: PipelineConfig, with_overflow: bool):
        """The per-batch module on the packed-4 wire (overridden by
        :class:`~umgap_tpu_torch.pipeline.tryptic.TrypticAnalyser`)."""
        return make_pipeline(self.dtax, self.dtable, config, wire="packed4",
                             with_overflow=with_overflow, device=self.device,
                             euler=self.euler)

    def _exact_kmax(self) -> int:
        # >= hit slots (windows per frame) for any padded protein length
        return self.ends * 6 * max((self.read_length + 2) // 3, 1)

    @property
    def _wide_batch(self) -> int:
        return wide_batch_rows(self.device.type, self.config.method,
                               self.config.strategy, self._exact_kmax(),
                               kernels.plain_selected())

    def _wide(self):
        if self._wide_step is None:
            cfg = self.config._replace(k_max=self._exact_kmax())
            self._wide_step = self._make_step(cfg, with_overflow=False)
        return self._wide_step

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    def _dispatch(self, dna, lens):
        return self._dispatch_packed(encoding.pack_dna4(dna), lens)

    def _dispatch_packed(self, dna4, lens):
        taxon, overflow = self.step(self._to_device(dna4),
                                    self._to_device(lens), self.read_length)
        handle = (self._to_host(taxon), self._to_host(overflow), None)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            handle = handle[:2] + (ev,)
        return handle

    def _collect(self, handle, n):
        """A dispatched batch's taxa and the rows of its first ``n`` that
        overflowed k_max (to re-run through the wide program)."""
        taxon, overflow, ev = handle
        if ev is not None:
            ev.synchronize()
        taxa = taxon.numpy().copy()
        overflow = overflow.numpy().copy()
        overflow[n:] = False
        idx = np.nonzero(overflow)[0]
        self.overflow_reads += len(idx)
        return taxa, idx

    def _finalize(self, handle, dna, lens, n):
        with self.timer.stage("materialize"):
            taxa, idx = self._collect(handle, n)
        if len(idx):
            with self.timer.stage("overflow_fallback"):
                taxa[idx] = self.run_wide(dna[idx], lens[idx])
        return taxa

    def _finalize_packed(self, handle, dna4, lens, n):
        with self.timer.stage("materialize"):
            taxa, idx = self._collect(handle, n)
        if len(idx):
            with self.timer.stage("overflow_fallback"):
                taxa[idx] = self.run_wide_packed(dna4[idx], lens[idx])
        return taxa

    def run_wide(self, dna: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """Exact results for (n, E, L) code rows through the wide
        program, in fixed batches of ``_wide_batch`` rows."""
        return self.run_wide_packed(encoding.pack_dna4(dna), lens)

    def run_wide_packed(self, dna4: np.ndarray,
                        lens: np.ndarray) -> np.ndarray:
        """:meth:`run_wide` on packed rows (n, E, ceil(L/2)): packing is
        per row, so rows of a packed batch feed the wide program
        directly; pad rows are two N codes a byte (0x44)."""
        wide = self._wide()
        W = self._wide_batch
        out = np.empty(len(dna4), dtype=np.int32)
        for s in range(0, len(dna4), W):
            nd = dna4[s:s + W]
            nl = lens[s:s + W]
            m = len(nd)
            if m < W:
                nd = np.pad(nd, ((0, W - m), (0, 0), (0, 0)),
                            constant_values=0x44)
                nl = np.pad(nl, ((0, W - m), (0, 0)))
            res = wide(self._to_device(nd), self._to_device(nl),
                       self.read_length)
            out[s:s + m] = res[:m].cpu().numpy()
        return out

    def analyse_arrays(self, headers, dna: np.ndarray, lens: np.ndarray):
        """Pre-encoded groups: dna (N, E, L) codes, lens (N, E)."""
        yield from self.feed(list(headers), dna, lens)
        yield from self.finish()


def _pad_width(codes: np.ndarray, w: int) -> np.ndarray:
    if codes.shape[-1] >= w:
        return codes
    pad = [(0, 0)] * (codes.ndim - 1) + [(0, w - codes.shape[-1])]
    return np.pad(codes, pad, constant_values=encoding.DNA_N)


def stream_paired_chunks(fastq1: str, fastq2: str, read_length: int,
                         delimiter: str = "/", chunk_bytes: int = 32 << 20,
                         width_ladder=None):
    """Aligned paired-end chunks from two FASTQ files via the native
    streaming parser: yields (headers, dna (n, 2, L), lens (n, 2),
    true_max).  Stops at the shorter file (utils::Zip semantics);
    headers come from file 1, stripped at ``delimiter``.  L grows along
    ``width_ladder`` when longer reads appear (never shrinks)."""
    from ..io import native

    streams = [
        native.stream_parse(p, "fastq", read_length, chunk_bytes,
                            width_ladder=width_ladder)
        for p in (fastq1, fastq2)
    ]
    bufs: List[List] = [[], []]  # per-file queues of (headers, codes, lens)
    counts = [0, 0]
    done = [False, False]

    def pull(i) -> bool:
        try:
            h, c, l, tmax = next(streams[i])
        except StopIteration:
            done[i] = True
            return False
        bufs[i].append((h, c, l, tmax))
        counts[i] += len(h)
        return True

    def take(i, n):
        hs: List[str] = []
        cs = []
        ls = []
        tmax = 0
        while n:
            bh, bc, bl, bt = bufs[i][0]
            tmax = max(tmax, bt)
            if len(bh) <= n:
                bufs[i].pop(0)
                hs.extend(bh)
                cs.append(bc)
                ls.append(bl)
                n -= len(bh)
            else:
                hs.extend(bh[:n])
                cs.append(bc[:n])
                ls.append(bl[:n])
                bufs[i][0] = (bh[n:], bc[n:], bl[n:], bt)
                n = 0
        counts[i] -= len(hs)
        w = max(c.shape[-1] for c in cs)
        cs = [_pad_width(c, w) for c in cs]
        return (hs, np.concatenate(cs) if len(cs) > 1 else cs[0],
                np.concatenate(ls) if len(ls) > 1 else ls[0], tmax)

    while True:
        while counts[0] == 0 and not done[0]:
            pull(0)
        while counts[1] == 0 and not done[1]:
            pull(1)
        n = min(counts[0], counts[1])
        if n == 0:
            return  # one side exhausted: Zip stops at the shortest
        h1, c1, l1, t1 = take(0, n)
        _h2, c2, l2, t2 = take(1, n)
        headers = []
        for h in h1:
            idx = h.find(delimiter)
            headers.append(h[:idx] if idx != -1 else h)
        w = max(c1.shape[-1], c2.shape[-1])
        dna = np.stack([_pad_width(c1, w), _pad_width(c2, w)], axis=1)
        lens = np.stack([np.minimum(l1, w), np.minimum(l2, w)], axis=1)
        yield headers, dna, lens, max(t1, t2)


def stream_single_chunks(path: str, read_length: int, fmt: str = "fasta",
                         delimiter: str = "/", chunk_bytes: int = 32 << 20,
                         width_ladder=None):
    """Single-end chunks: yields (headers, dna (n, 1, L), lens (n, 1),
    true_max) via the native streaming parser."""
    from ..io import native

    for h, c, l, tmax in native.stream_parse(
            path, fmt, read_length, chunk_bytes, width_ladder=width_ladder):
        headers = []
        for hd in h:
            idx = hd.find(delimiter)
            headers.append(hd[:idx] if idx != -1 else hd)
        yield headers, c[:, None, :], l[:, None], tmax
