"""ctypes bindings for the port's native host ingest library
(``umgap_tpu_torch/native/``): FASTQ/FASTA parsing into padded code
rows, the chunked streaming parser with its width ladder, the C++
producer thread that writes 4-bit packed device batches into a ring
(:class:`NativeBatchStream`), and the output formatter.

The library is built with ``g++`` at first use, into ``_build/`` next to
the package (git-ignored), and cached by a hash of its sources and the
command, as :mod:`umgap_tpu_torch.kernels` caches the CUDA builds. A
failed build or load raises :class:`NativeBuildError` with the
compiler's output: nothing here switches quietly to the Python readers.
Callers hand a sample to the Python reader only on
:class:`StreamUnsupported` (records that are not strictly 4-line FASTQ).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE / "native"
SOURCES = ("umgap_parse.cpp", "umgap_stream.cpp")
BUILD_DIR = PACKAGE / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]
LINK = ["-lz", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The host library did not build or load."""


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeBuildError(
            "g++ not found (set CXX); the host ingest library is built "
            "from umgap_tpu_torch/native at first use")
    return cxx


def build_command(out: Path, cxx: Optional[str] = None) -> list:
    """The compiler command that builds the library into ``out``."""
    return [cxx or find_cxx(), *CXX_FLAGS, "-o", str(out),
            *(str(SOURCE_DIR / s) for s in SOURCES), *LINK]


def lib_path(cxx: Optional[str] = None) -> Path:
    """Where the library of these sources and this command lives."""
    cxx = cxx or find_cxx()
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((SOURCE_DIR / s).read_bytes())
    h.update(" ".join(build_command(Path("out"), cxx)).encode())
    return BUILD_DIR / f"libumgap_host-{h.hexdigest()[:16]}.so"


def _bind(lib: ctypes.CDLL) -> None:
    for name in ("umgap_parse_fastq", "umgap_parse_fasta"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long,
        ]
    lib.umgap_stream_open.restype = ctypes.c_void_p
    lib.umgap_stream_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char,
    ]
    lib.umgap_stream_next.restype = ctypes.c_longlong
    lib.umgap_stream_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_longlong)),
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.umgap_stream_close.restype = None
    lib.umgap_stream_close.argtypes = [ctypes.c_void_p]
    lib.umgap_format_output.restype = ctypes.c_longlong
    lib.umgap_format_output.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.c_char_p, ctypes.c_longlong,
    ]


def ensure_built() -> bool:
    """Build the library if no cached build of these sources exists, and
    load it. Returns True; raises :class:`NativeBuildError` otherwise."""
    global _lib
    if _lib is not None:
        return True
    cxx = find_cxx()
    out = lib_path(cxx)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        proc = subprocess.run(build_command(tmp, cxx), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"building the host ingest library failed:\n{proc.stdout}"
                f"{proc.stderr}")
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
        _bind(lib)
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"loading {out} failed: {e}") from e
    _lib = lib
    return True


def available() -> bool:
    """True once the library is built and loaded (it raises otherwise)."""
    return _lib is not None or ensure_built()


def _parse(fn_name: str, data: bytes, max_len: int, cap_reads: int):
    """Returns (headers, codes, clipped lens, true max length). The
    native parser reports TRUE sequence lengths; codes rows are clipped
    at ``max_len`` — callers can re-parse at a wider bucket when
    ``true_max > max_len`` instead of silently truncating."""
    fn = getattr(_lib, fn_name)
    codes = np.full((cap_reads, max_len), 4, dtype=np.uint8)  # N
    lens = np.zeros(cap_reads, dtype=np.int32)
    hs = np.zeros(cap_reads, dtype=np.int64)
    he = np.zeros(cap_reads, dtype=np.int64)
    n = fn(
        data, len(data),
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_len,
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        he.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        cap_reads,
    )
    if n < 0:
        raise ValueError(f"malformed input for {fn_name}")
    headers = [data[hs[i]:he[i]].decode() for i in range(n)]
    lens = lens[:n]
    true_max = int(lens.max()) if n else 0
    return headers, codes[:n], np.minimum(lens, max_len), true_max


def _parse_all(fn_name: str, data: bytes, max_len: int, cap: int):
    cap = max(cap, 16)
    while True:
        headers, codes, lens, tmax = _parse(fn_name, data, max_len, cap)
        if len(headers) < cap:
            return headers, codes, lens, tmax
        cap *= 4


class StreamUnsupported(ValueError):
    """The input's shape defeats chunked native parsing (e.g. multi-line
    FASTQ records); callers hand the sample to the Python reader."""


def _fastq_cut(buf: bytes, eof: bool) -> int:
    """Byte offset of the last complete-FASTQ-record boundary.

    Valid ONLY for strict 4-line records (all real-world FASTQ; the
    readers also accept multi-line records, src/io/fastq.rs:60-77), so
    the 4-line shape is verified vectorized — every record's line 0
    must start '@' and line 2 must start '+' — and violations raise
    :class:`StreamUnsupported` rather than silently mis-cutting."""
    a = np.frombuffer(buf, np.uint8)
    nl = np.flatnonzero(a == 10)
    if eof:
        m = len(nl) + (1 if len(buf) and buf[-1] != 0x0A else 0)
        if m % 4:
            raise StreamUnsupported("fastq line count not a multiple of 4")
        cut = len(buf)
    else:
        m = (len(nl) // 4) * 4
        if m == 0:
            return 0
        cut = int(nl[m - 1]) + 1
    starts = np.concatenate([np.zeros(1, np.int64), nl + 1])
    if not ((a[starts[0:m:4]] == ord("@")).all()
            and (a[starts[2:m:4]] == ord("+")).all()):
        raise StreamUnsupported("fastq records are not strictly 4-line")
    return cut


def _fasta_cut(buf: bytes, eof: bool) -> int:
    """Cut before the last header line ('\\n>') so every parsed record
    is complete; 0 when the chunk holds at most one record start."""
    if eof:
        return len(buf)
    i = buf.rfind(b"\n>")
    return i + 1 if i >= 0 else 0


def stream_parse(path: str, fmt: str, max_len: int = 160,
                 chunk_bytes: int = 32 << 20,
                 width_ladder: Optional[list] = None):
    """Yield (headers, codes, lens, true_max) per chunk of a (possibly
    gzipped) FASTQ/FASTA file, holding O(chunk_bytes) on the host.

    ``lens`` are clipped to the chunk's code width; ``true_max`` is the
    widest sequence actually seen in the chunk.  With a ``width_ladder``
    (ascending widths, first >= ``max_len``), a chunk containing a
    record longer than the current width is re-parsed at the smallest
    ladder width that fits, and all later chunks use that width too —
    code widths only grow over a stream.  Records longer than the TOP
    ladder width stay clipped (true_max tells the caller to re-route)."""
    from . import sniff_open

    ensure_built()
    fn = {"fastq": "umgap_parse_fastq", "fasta": "umgap_parse_fasta"}[fmt]
    cut = {"fastq": _fastq_cut, "fasta": _fasta_cut}[fmt]

    def n_records(buf: bytes) -> int:
        """Exact record count of a complete-records buffer, so the
        (records x width) codes allocation never overshoots."""
        if fmt == "fastq":
            nl = buf.count(b"\n")
            if buf and not buf.endswith(b"\n"):
                nl += 1
            return nl // 4
        return buf.count(b"\n>") + (1 if buf.startswith(b">") else 0)

    width = max_len
    tail = b""
    with sniff_open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            eof = len(data) < chunk_bytes
            buf = tail + data if tail else data
            if not buf:
                return
            at = cut(buf, eof)
            if at == 0:  # no boundary yet: keep growing the buffer
                tail = buf
                continue
            buf, tail = buf[:at], buf[at:]
            if buf:
                cap_hint = n_records(buf) + 1
                out = _parse_all(fn, buf, width, cap_hint)
                if width_ladder and out[3] > width:
                    new_w = next((w for w in width_ladder if w >= out[3]),
                                 width_ladder[-1])
                    if new_w > width:
                        width = new_w
                        out = _parse_all(fn, buf, width, cap_hint)
                yield out
            if eof and not tail:
                return


class NativeBatchStream:
    """C++-threaded batch assembly: the producer parses (possibly
    gzipped) FASTQ/FASTA, encodes and 4-bit packs reads straight into a
    ring of pre-allocated device-wire batches; ``next()`` blocks with
    the GIL released (ctypes) until a batch is ready. Python never
    touches a record, only whole-batch numpy views and one header blob
    per batch.

    ``next()`` gives (n, dna4 (B, E, pw), lens (B, E), hdr_blob bytes,
    hoff int64 array, true_max); rows from ``n`` on are padding (0x44,
    two N codes a byte). The arrays are copies (the slot recycles on the
    next call; in-flight device copies and overflow re-routes outlive
    it)."""

    def __init__(self, path1: str, path2: Optional[str], fmt: str,
                 read_length: int, batch: int, n_slots: int = 4,
                 delimiter: str = "/"):
        ensure_built()
        self.ends = 2 if path2 else 1
        self.batch = batch
        self.read_length = read_length
        self.pw = (read_length + 1) // 2
        self._h = _lib.umgap_stream_open(
            path1.encode(), path2.encode() if path2 else None,
            {"fastq": 0, "fasta": 1}[fmt], read_length, batch,
            self.ends, n_slots, delimiter.encode())
        if not self._h:
            raise RuntimeError("native stream open failed")

    def next(self):
        """One batch, or None at clean EOF. Raises StreamUnsupported
        (the caller hands the sample on) or OSError."""
        dna = ctypes.POINTER(ctypes.c_ubyte)()
        lens = ctypes.POINTER(ctypes.c_int32)()
        hdr = ctypes.c_char_p()
        hoff = ctypes.POINTER(ctypes.c_longlong)()
        hlen = ctypes.c_longlong()
        tmax = ctypes.c_int()
        n = _lib.umgap_stream_next(
            self._h, ctypes.byref(dna), ctypes.byref(lens),
            ctypes.byref(hdr), ctypes.byref(hoff), ctypes.byref(hlen),
            ctypes.byref(tmax))
        if n == 0:
            return None
        if n == -2:
            raise StreamUnsupported(
                "input shape defeats the native batch stream")
        if n < 0:
            raise OSError("native stream read error")
        B, E, pw = self.batch, self.ends, self.pw
        dna4 = np.ctypeslib.as_array(dna, shape=(B, E, pw)).copy()
        ln = np.ctypeslib.as_array(lens, shape=(B, E)).copy()
        blob = ctypes.string_at(hdr, hlen.value) if hlen.value else b""
        offs = np.ctypeslib.as_array(hoff, shape=(int(n) + 1,)).astype(
            np.int64)
        return int(n), dna4, ln, blob, offs, int(tmax.value)

    def close(self):
        if self._h:
            _lib.umgap_stream_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def format_output(blob: bytes, hoff: np.ndarray,
                  taxa: np.ndarray) -> bytes:
    """(header blob, offsets, taxa) -> b'>hdr\\ntaxon\\n' per record."""
    ensure_built()
    n = len(hoff) - 1
    taxa = np.ascontiguousarray(taxa, dtype=np.int32)
    hoff = np.ascontiguousarray(hoff, dtype=np.int64)
    cap = int(hoff[-1]) + n * 14
    out = ctypes.create_string_buffer(cap)
    w = _lib.umgap_format_output(
        blob, hoff.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        taxa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out, cap)
    if w > cap:
        raise RuntimeError("formatter capacity miscomputed")
    return out.raw[: int(w)]
