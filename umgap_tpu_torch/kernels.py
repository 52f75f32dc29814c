"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``: no
PyTorch headers are compiled, so a build takes seconds. The libraries
are built at first use, all sources at once (one ``nvcc`` process each,
started together), into ``_build/`` next to this file (git-ignored), and
are cached by a hash of the source and the flags.

Every C entry point launches on the stream it is given (PyTorch's
current stream), allocates nothing, does not synchronise, and returns
``cudaGetLastError()``; :meth:`Kernel.launch` raises on a non-zero code
and counts the launch only when it went through. A launch packs its
arguments into one block of 8-byte slots (``struct``) and hands ctypes
a single pointer, to each entry's ``*_packed`` twin
(``csrc/packed_args.cuh``), which costs the host far less than a dozen
converted ctypes arguments. Nothing here runs at import time: the CPU
tests import every module without a compiler.

:func:`plain_versions` is the one switch between the kernels and their
plain PyTorch versions: the stages read it to pick which they call, and
no wrapper reads it (a wrapper takes the plain version only for a CPU
tensor).
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def find_nvcc() -> str:
    cand = os.environ.get("NVCC") or shutil.which("nvcc")
    if cand is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        cand = "/usr/local/cuda/bin/nvcc"
    if cand is None:
        raise KernelBuildError(
            "nvcc not found (set NVCC or put the CUDA toolkit on PATH); "
            "the CUDA kernels are built from umgap_tpu_torch/csrc at first use")
    return cand


class Kernel:
    """One CUDA source, its C entry point and its launch count.
    ``argtypes`` are the C entry's parameter types, in order: each is
    packed as an int64 slot, a float as a double."""

    def __init__(self, name: str, source: str, argtypes, replaces: str):
        self.name = name
        self.source = source
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._pack = struct.Struct("=" + "".join(
            "d" if t is F else "q" for t in argtypes)).pack
        self._fn = None
        self._err = None

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def lib_path(self, nvcc: str) -> Path:
        h = hashlib.sha256()
        h.update(self.path.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join([nvcc] + NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.path.stem}-{h.hexdigest()[:16]}.so"

    def _bind(self, lib_path: Path):
        lib = ctypes.CDLL(str(lib_path))
        fn = getattr(lib, self.name + "_packed")
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = I
        err = lib.umgap_cuda_error_string
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def launch(self, *args) -> None:
        fn = self._fn
        if fn is None:
            build_all()
            fn = self._fn
        rc = fn(self._pack(*args))
        if rc:
            msg = self._err(rc).decode()
            raise KernelLaunchError(f"{self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


K1 = Kernel(
    "reads_to_kmers", "reads_to_kmers.cu",
    [P, I, I, P, I, I, I, I, P, P, P, P, P, I, I, P],
    "umgap_tpu/ops/encoding.py:57 unpack_dna4_device + "
    "umgap_tpu/ops/translate.py:88 translate6_batch + "
    "umgap_tpu/ops/kmers.py:76 pack_windows_batch")
# K1's protein entry: FGSpp's genes (AA codes) to 9-mer keys
K1P = Kernel(
    "proteins_to_kmers", "reads_to_kmers.cu",
    [P, I, P, I, I, P, P, P, I, I, P],
    "umgap_tpu/ops/kmers.py:76 pack_windows_batch "
    "(umgap_tpu/pipeline/proteins.py:33)")
# the entry of one table and, for group > 1, the grouped entry (a
# device's slice of a buildindex-dist artifact: its group of shards)
K2 = Kernel(
    "probe_kmer", "probe_kmer.cu",
    [P, P, P, LL, P, LL, I, I, I, P, I, I, P, P, I, I, I, P],
    "umgap_tpu/ops/lookup.py:198 _probe_dense (kmer branch); "
    "scripts/exp_pallas_dma.py:31 make_kernel; grouped: "
    "umgap_tpu/parallel/sharded.py:314-320 with "
    "umgap_tpu/ops/lookup.py:231")
K3 = Kernel(
    "seedextend_mask", "seedextend_mask.cu",
    [P, P, LL, I, I, I, P, I, I, P],
    "umgap_tpu/ops/seedextend.py:118 seedextend_mask_batch "
    "(lax.scan of _scan_seeds, :173) + "
    "umgap_tpu/pipeline/fused.py:107-109 jnp.where(keep, taxa, 0)")
# K3's row kernel (one warp a lane) for rows past the staged tile
K3R = Kernel(
    "seedextend_rows", "seedextend_mask.cu",
    [P, P, LL, I, I, I, P, I, P], K3.replaces)
# K3's scored entries (a lane keeps its best-scoring seed alone, with the
# select after it, umgap_tpu/pipeline/fused.py:109, fused in): the staged
# tile and the row kernel
K3S = Kernel(
    "seedextend_scored", "seedextend_mask.cu",
    [P, P, LL, I, I, I, P, I, I, P, I, I, P],
    "umgap_tpu/ops/seedextend.py:221 seedextend_scored_mask_batch")
K3RS = Kernel(
    "seedextend_rows_scored", "seedextend_mask.cu",
    [P, P, LL, I, I, I, P, I, I, P, I, I, P], K3S.replaces)
K4 = Kernel(
    "dedup_counts", "dedup_counts.cu",
    [P, P, I, I, I, F, P, P, P, P, P, P],
    "umgap_tpu/agg/device.py:79 dedup_counts + "
    "umgap_tpu/agg/device.py:154 filter_lower_bound")
# K4's row kernel (one block a row) for rows past the warp path
K4R = Kernel(
    "dedup_rows", "dedup_counts.cu",
    [P, P, I, I, I, F, I, P, P, P, P, P, I, P, P], K4.replaces)
K5 = Kernel(
    "lane_gather", "lane_gather.cu",
    [I, P, LL, LL, LL, LL, LL, LL, P, LL, LL, LL, LL, LL, P, LL, P],
    "scripts/exp_pallas_dma.py:171 dyngather_case; "
    "scripts/exp_pallas_gather.py:47 k1, :62 k2, :77 k3; "
    "scripts/exp_dyngather.py:37 make; "
    "scripts/exp_probe_primitives.py:66 f3, :96 f4; "
    "scripts/exp_probe2.py:75, :87, :112; "
    "umgap_tpu/agg/device.py:173 hit_geometry row gather")
K5A = Kernel(
    "lane_gather_ancestry", "lane_gather.cu",
    [P, LL, LL, LL, LL, LL, P, P, P, P, P],
    "umgap_tpu/agg/device.py:170 hit_geometry one-hot contraction "
    "(:191) and compare (:194)")
K6 = Kernel(
    "tree_aggregate", "tree_aggregate.cu",
    [I, P, I, I, P, P, P, I, I, I, F, P, I, P, P, I, I, P],
    "umgap_tpu/agg/device.py:219 tree_lca_batch, :243 rtl_batch, "
    ":253 tree_mix_batch, with :170 hit_geometry's row gather and "
    "ancestry test and :308 snap_batch (+ "
    "umgap_tpu/pipeline/fused.py:122-124) fused in")
# the Euler/RMQ aggregators (rmq/lca*, rmq/hybrid) with the snap at the
# store
K9 = Kernel(
    "rmq_aggregate", "rmq_aggregate.cu",
    [I, P, P, P, I, I, P, I, P, P, P, I, P, I, P, I, I, F, P, I, P, I, P, P],
    "umgap_tpu/agg/device_rmq.py:120 rmq_lca_batch (lax.scan :154 of "
    "rmq_query_batch :85), :158 rmq_mix_batch (einsums :208, :216), "
    "with umgap_tpu/agg/device.py:308 snap_batch + "
    "umgap_tpu/pipeline/fused.py:122-124 fused in")

K7 = Kernel(
    "reads_to_peptides", "reads_to_peptides.cu",
    [P, I, I, P, I, I, P, P, P, P, I, I, I, I, P],
    "umgap_tpu/ops/encoding.py:57 unpack_dna4_device + "
    "umgap_tpu/ops/translate.py:88 translate6_batch + "
    "umgap_tpu/pipeline/tryptic.py:89 tryptic_digest_device")
# the entry of one table and, for group > 1, the grouped entry (a
# device's slice of a sharded peptide index)
K8 = Kernel(
    "probe_peptide", "probe_peptide.cu",
    [P, P, P, LL, P, LL, I, I, P, P, I, I, I, I, P],
    "umgap_tpu/ops/lookup.py:265-283 _probe_dense (peptide branch); "
    "grouped: umgap_tpu/parallel/sharded.py:314-320 (kind peptide)")

KERNELS = (K1, K1P, K2, K3, K3R, K3S, K3RS, K4, K4R, K5, K5A, K6, K9,
           K7, K8)

# build seconds and ptxas reports of the last build_all() in this process
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


_PLAIN = contextvars.ContextVar("umgap_plain_versions", default=False)


@contextlib.contextmanager
def plain_versions():
    """Within the block the pipeline's stages call their kernels' plain
    versions on any device: the reference the kernels are held against
    on the card (``run_stages(..., plain=True)`` enters it). No entry
    point does."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_selected() -> bool:
    """True inside :func:`plain_versions`."""
    return _PLAIN.get()


def build_all(force: bool = False) -> dict:
    """Compile every source that has no cached library (all ``nvcc``
    processes started together), then bind all kernels. Returns
    ``{"seconds": ..., "built": [...], "logs": {source: ptxas text}}``."""
    if not force and all(k._fn is not None for k in KERNELS):
        return BUILD_INFO
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for k in {k.source: k for k in KERNELS}.values():  # one per source
        out = k.lib_path(nvcc)
        if out.exists() and not force:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.path)]
        procs.append((k, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs = {}
    failed = []
    for k, out, tmp, proc in procs:
        text = proc.communicate()[0].decode(errors="replace")
        logs[k.source] = text
        if proc.returncode != 0:
            failed.append(f"{k.source}:\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    for k in KERNELS:
        out = k.lib_path(nvcc)
        if k.source not in logs and out.with_suffix(".log").exists():
            logs[k.source] = out.with_suffix(".log").read_text()
        k._bind(out)
    BUILD_INFO.clear()
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      built=[k.source for k, *_ in procs], logs=logs)
    return BUILD_INFO


def stream_of(t) -> int:
    """PyTorch's current stream on the CUDA device of tensor ``t``, as a
    raw handle (no stream object is built)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_cuda(name: str, *tensors) -> None:
    """Wrapper-side checks shared by the kernels: every tensor on one
    CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
