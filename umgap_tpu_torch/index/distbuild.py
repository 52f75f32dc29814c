"""The ``buildindex-dist`` job (the counterpart of
``umgap_tpu.index.distbuild``): a supervisor and worker subprocesses over
a shared work directory, each task checkpointed with an atomic ``.done``
marker, so that a killed worker, or a killed driver, resumes where it
stopped. The runnable form of the reference's cluster build
(scripts/build-index-phanpy.hpc.sh:1-10, ``splitkmers | sort | joinkmers
| buildindex`` over the UniProt TSV):

  1. **partition** (a task an input chunk): rows -> (packed u64 k-mer, i32
     taxid) spills, hash-range partitioned by the serving tables'
     :func:`~umgap_tpu_torch.parallel.sharded.owner_of`. A TSV chunk is
     split on the card (:func:`~umgap_tpu_torch.index.scale.split_kmers_tsv`,
     kernel K1P).
  2. **join** (a task a shard): the shard's spills -> the join on the card
     (:func:`~umgap_tpu_torch.index.scale.join_kmers_sorted`: the sort, then
     kernel K6's tree hybrid f = 0.95 and the ranked snap).
  3. **build** (a task a shard): a packed k-mer table at one capacity
     common to all shards -> ``shards/shard_NNN.npz``.

The work directory's files (``manifest.json``, ``capacity.json``, the
spills ``part/cCCCCC_sSSS.npz``, the joined arrays ``joined/sSSS.npz``
with their ``.count`` sidebands, the shards and every ``.done`` marker)
have ``umgap_tpu``'s names and contents, so either package resumes,
serves or prints what the other built. Workers are ``python -m
umgap_tpu_torch buildindex-dist --task ...`` subprocesses handed the
driver's ``--device``; each takes its own CUDA context.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import sys
import time
from typing import List, Optional, Tuple

import numpy as np


class ShardArtifactError(ValueError):
    """A shard artifact is unreadable (truncated or corrupt): a
    ValueError, so the command line prints the remedy instead of a
    traceback."""


# bucket64s (the default): 64-slot buckets resolved by one full-row
# gather, sized at load <= 0.5 so that the single round's overflow stays
# within the stash; bucket64d: the same rows conveyor-placed at up to
# ~0.88 load, a two-row probe; bucket16: <= 2 gathers at up to 0.6 load;
# bucket8s: one round, its stash absorbing all bucket overflow. A shard
# writer stamps max(realized, PROBE_LIMITS) so that every shard of one
# layout shares one probe depth.
LOAD_FACTORS = {"bucket64s": 0.50, "bucket64d": 0.88,
                "bucket16": 0.60, "bucket8s": 0.60}
BUCKETS = {"bucket64s": 64, "bucket64d": 64, "bucket16": 16, "bucket8s": 8}
PROBE_LIMITS = {"bucket64s": 0, "bucket64d": 1, "bucket16": 1, "bucket8s": 0}
LOAD_FACTOR = 0.60
LAYOUT = "bucket64s"


def _done(path: str) -> str:
    return path + ".done"


def _mark(path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("ok")
    os.replace(tmp, _done(path))


def _is_done(path: str) -> bool:
    return os.path.exists(_done(path))


def _save_atomic(path: str, **arrays) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# Input descriptions
# ---------------------------------------------------------------------- #

def tsv_chunks(path: str, chunk_bytes: int = 256 << 20) -> List[Tuple[int, int]]:
    """Byte ranges covering the TSV; a worker aligns to newlines (it
    starts after the first newline past ``start`` unless start == 0, and
    finishes the line spanning ``end``)."""
    size = os.path.getsize(path)
    return [(s, min(s + chunk_bytes, size))
            for s in range(0, size, chunk_bytes)]


def read_tsv_chunk(path: str, start: int, end: int, k: int, device=None):
    """One newline-aligned chunk's rows: the split on ``device``
    (:func:`~umgap_tpu_torch.index.scale.split_kmers_tsv`, K1P on the
    card)."""
    from .scale import split_kmers_tsv

    with open(path, "rb") as f:
        if start:
            f.seek(start - 1)
            f.readline()  # the partial first line is the previous chunk's
            start = f.tell()
        if start >= end:
            # one line spans the whole range: the chunk where it starts
            # parses it
            return np.zeros(0, np.uint64), np.zeros(0, np.int32)
        data = f.read(end - start)
        if not data.endswith(b"\n"):
            data += f.readline()
    return split_kmers_tsv(data, k=k, device=device)


def synthetic_chunk(seed: int, chunk: int, rows: int, n_tax: int):
    """Deterministic synthetic rows: ~70% singleton groups and hot taxa,
    the group structure of UniProt-derived corpora
    (scripts/bench_index_build.py)."""
    rng = np.random.default_rng([seed, chunk])
    n_base = int(rows / 1.6)
    keys = rng.integers(0, 2 ** 45, size=n_base, dtype=np.uint64)
    extra_mask = rng.random(n_base) < 0.3
    extra_counts = rng.integers(1, 8, size=int(extra_mask.sum()))
    packed = np.concatenate([keys, np.repeat(keys[extra_mask], extra_counts)])
    tids = rng.integers(1, n_tax + 1, size=len(packed)).astype(np.int32)
    hot = rng.random(len(packed)) < 0.5
    tids[hot] = rng.integers(1, min(2000, n_tax), size=int(hot.sum()))
    return packed, tids


def write_synthetic_taxonomy(path: str, n_tax: int, seed: int) -> None:
    """Random NCBI-shaped taxonomy TSV shared by all workers."""
    from .. import ranks

    rng = np.random.default_rng([seed, 999])
    parent = np.ones(n_tax + 1, dtype=np.int64)
    parent[2:] = (rng.random(n_tax - 1)
                  * (np.arange(2, n_tax + 1) - 1)).astype(np.int64) + 1
    rk = rng.integers(0, ranks.RANK_COUNT, size=n_tax + 1)
    vd = rng.random(n_tax + 1) > 0.1
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("1\troot\tno rank\t1\t\x01\n")
        for i in range(2, n_tax + 1):
            valid = "\x01" if vd[i] else "\x00"
            f.write(f"{i}\tt{i}\t{ranks.rank_name(int(rk[i]))}"
                    f"\t{int(parent[i])}\t{valid}\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------- #
# Worker tasks
# ---------------------------------------------------------------------- #

def _punch_hole(path: str, start: int, length: int) -> bool:
    """Best-effort FALLOC_FL_PUNCH_HOLE: frees the byte range's blocks
    and keeps the file's size and offsets (the manifest's chunk ranges
    stay valid for a resume). False where unsupported; the reclaim is
    then skipped."""
    if length <= 0 or not hasattr(ctypes, "CDLL"):
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        fd = os.open(path, os.O_RDWR)
        try:
            # PUNCH_HOLE (0x2) requires KEEP_SIZE (0x1)
            rc = libc.fallocate(fd, ctypes.c_int(0x3),
                                ctypes.c_longlong(start),
                                ctypes.c_longlong(length))
        finally:
            os.close(fd)
        return rc == 0
    except (OSError, AttributeError):
        return False


# a chunk's parse reads up to one line past each boundary, so reclaiming
# a finished chunk leaves its edge bytes for the neighbours
_PUNCH_MARGIN = 1 << 20


def task_partition(workdir: str, manifest: dict, chunk: int,
                   device=None) -> None:
    from ..ops import kmers as kmerops
    from ..parallel.sharded import owner_of

    part = os.path.join(workdir, "part")
    stamp = os.path.join(part, f"c{chunk:05d}")
    if _is_done(stamp):
        return
    n_shards = manifest["n_shards"]
    if manifest["input"] == "synthetic":
        rows = min(manifest["rows_per_chunk"],
                   manifest["total_rows"]
                   - chunk * manifest["rows_per_chunk"])
        packed, tids = synthetic_chunk(
            manifest["seed"], chunk, rows, manifest["n_tax"])
    else:
        start, end = manifest["chunks"][chunk]
        packed, tids = read_tsv_chunk(manifest["tsv"], start, end,
                                      manifest["k"], device)
    hi, lo = kmerops.split_packed(packed.astype(np.uint64))
    owner = owner_of(hi, lo, n_shards)
    order = np.argsort(owner, kind="stable")
    packed = packed[order]
    tids = tids[order]
    owner = owner[order]
    bounds = np.searchsorted(owner, np.arange(n_shards + 1))
    for s in range(n_shards):
        a, b = bounds[s], bounds[s + 1]
        if a == b:
            continue
        _save_atomic(os.path.join(part, f"c{chunk:05d}_s{s:03d}.npz"),
                     keys=packed[a:b], tids=tids[a:b])
    _mark(stamp)
    if manifest.get("reclaim_input") and manifest["input"] == "tsv":
        # the input is scratch: free this chunk's bytes, so that the
        # TSV's disk shrinks as partitioning advances
        start, end = manifest["chunks"][chunk]
        _punch_hole(manifest["tsv"], start + _PUNCH_MARGIN,
                    (end - _PUNCH_MARGIN) - (start + _PUNCH_MARGIN))


def task_join(workdir: str, manifest: dict, shard: int, device=None,
              tax=None, dtax=None) -> None:
    """The shard's spills joined on ``device``; ``tax`` and ``dtax`` (its
    :class:`~umgap_tpu_torch.agg.device.DeviceTaxonomy`) are loaded
    when not given."""
    from ..taxonomy import Taxonomy, read_taxa_file
    from .scale import join_kmers_sorted

    joined = os.path.join(workdir, "joined")
    stamp = os.path.join(joined, f"s{shard:03d}")
    if _is_done(stamp):
        return
    part_files = sorted(glob.glob(
        os.path.join(workdir, "part", f"c*_s{shard:03d}.npz")))
    keys: List[np.ndarray] = []
    tids: List[np.ndarray] = []
    for p in part_files:
        z = np.load(p)
        keys.append(z["keys"])
        tids.append(z["tids"])
    if keys:
        packed = np.concatenate(keys)
        tid = np.concatenate(tids).astype(np.int64)
    else:
        packed = np.zeros(0, np.uint64)
        tid = np.zeros(0, np.int64)
    if tax is None:
        tax = Taxonomy(read_taxa_file(manifest["taxons"]))
    # the join sorts the rows itself (on the card), by key and taxon
    out_keys, out_vals = join_kmers_sorted(packed, tid, tax, device=device,
                                           dtax=dtax)
    _save_atomic(os.path.join(joined, f"s{shard:03d}.npz"),
                 keys=out_keys, values=out_vals)
    # the key count's sideband: the final accounting reads no arrays
    with open(stamp + ".count.tmp", "w") as f:
        f.write(str(len(out_keys)))
    os.replace(stamp + ".count.tmp", stamp + ".count")
    _mark(stamp)
    if manifest.get("reclaim"):
        # the shard's spills are consumed: no later stage reads them
        for p in part_files:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass


def common_capacity(workdir: str, manifest: dict) -> int:
    """After the join: one capacity, so that shard rows stack
    rectangular (``ShardedTable.from_shards``). bucket8s resolves every
    probe with one row gather, so keys past a full home bucket must fit
    the 256-slot stash: the capacity grows until the largest shard's real
    bucket histogram overflows by at most half the stash."""
    from ..ops import kmers as kmerops
    from .table import MIN_NB_BITS, _pow2_capacity, mix_key

    cap_path = os.path.join(workdir, "capacity.json")
    if os.path.exists(cap_path):
        with open(cap_path) as f:
            return json.load(f)["capacity"]
    max_n, max_s = 1, 0
    for s in range(manifest["n_shards"]):
        n = _shard_key_count(workdir, s)
        if n > max_n:
            max_n, max_s = n, s
    bucket = BUCKETS.get(manifest["layout"], 16)
    load = LOAD_FACTORS.get(manifest["layout"], LOAD_FACTOR)
    cap = _pow2_capacity(max_n, load, bucket << MIN_NB_BITS)
    joined_path = os.path.join(workdir, "joined", f"s{max_s:03d}.npz")
    if manifest["layout"] == "bucket8s" and os.path.exists(joined_path):
        z = np.load(joined_path)
        keys = z["keys"].astype(np.uint64)
        if len(keys):
            hi, lo = kmerops.split_packed(keys)
            _mhi, mlo = mix_key(hi, lo)
            while True:
                nb = max(cap // 8, 1)
                cnt = np.bincount(
                    (mlo & np.uint32(nb - 1)).astype(np.int64),
                    minlength=nb)
                if int(np.maximum(cnt - 8, 0).sum()) <= 128:
                    break
                cap *= 2
    _write_json(cap_path, {"capacity": cap, "max_keys": max_n})
    return cap


def _write_json(path: str, obj) -> None:
    """``path`` written whole, through a temporary of this process's own:
    every build worker computes the common capacity at once, and a
    temporary name they shared would be renamed away under one of them
    (``umgap_tpu``'s build workers share one and race on it)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _shard_key_count(workdir: str, shard: int) -> int:
    """Key count of one joined shard, from the sideband written at join
    time (it outlives ``--reclaim``'s deletion of the arrays)."""
    cpath = os.path.join(workdir, "joined", f"s{shard:03d}.count")
    if os.path.exists(cpath):
        with open(cpath) as f:
            return int(f.read().strip())
    z = np.load(os.path.join(workdir, "joined", f"s{shard:03d}.npz"))
    return len(z["keys"])


def bump_capacity(workdir: str) -> int:
    """For a shard whose stash still overflowed at the sized capacity:
    double it and invalidate the built shards. A built shard whose joined
    arrays were reclaimed is renamed (``.old.npz``), and
    :func:`task_build` takes its keys from ``items()``."""
    cap_path = os.path.join(workdir, "capacity.json")
    with open(cap_path) as f:
        meta = json.load(f)
    meta["capacity"] *= 2
    _write_json(cap_path, meta)
    for p in glob.glob(os.path.join(workdir, "shards", "shard_*.npz")):
        if p.endswith(".old.npz"):
            continue
        shard = os.path.splitext(os.path.basename(p))[0]  # shard_NNN
        joined = os.path.join(workdir, "joined", f"s{shard[6:]}.npz")
        if os.path.exists(joined):
            os.remove(p)
        else:
            os.replace(p, p[: -len(".npz")] + ".old.npz")
    for p in glob.glob(os.path.join(workdir, "shards", "shard_*.done")):
        os.remove(p)
    return meta["capacity"]


def task_build(workdir: str, manifest: dict, shard: int) -> None:
    from .table import KmerTable, load_table

    shards_dir = os.path.join(workdir, "shards")
    stamp = os.path.join(shards_dir, f"shard_{shard:03d}")
    if _is_done(stamp):
        return
    cap = common_capacity(workdir, manifest)
    joined_path = os.path.join(workdir, "joined", f"s{shard:03d}.npz")
    old_path = os.path.join(shards_dir, f"shard_{shard:03d}.old.npz")
    if os.path.exists(joined_path):
        z = np.load(joined_path)
        keys = z["keys"].astype(np.uint64)
        values = z["values"].astype(np.int32)
    else:
        # the joined arrays were reclaimed and a capacity bump renamed
        # the previous build: its items() are the shard's keys and values
        keys, values = load_table(old_path).items()
        keys = keys.astype(np.uint64)
    # the layout's geometry, explicitly: every shard must share one row
    # shape for the stacked serving table
    bucket = BUCKETS.get(manifest["layout"], 16)
    probes = PROBE_LIMITS.get(manifest["layout"], 1)
    table = KmerTable.build(keys, values.astype(np.int32),
                            k=manifest["k"], bucket=bucket,
                            max_probe_limit=probes, stash_cap=256,
                            capacity=cap)
    # one probe depth for every shard of the layout: the build records the
    # realized depth, which can differ between shards; probing an
    # undisplaced table a round deeper is exact
    table.max_probes = max(table.max_probes, probes)
    # the packed row layout, uncompressed: serving maps it straight into
    # the host-to-device copy
    table.save(os.path.join(shards_dir, f"shard_{shard:03d}.npz"),
               packed=True)
    _mark(stamp)
    if os.path.exists(old_path):
        os.remove(old_path)
    if manifest.get("reclaim") and os.path.exists(joined_path):
        os.remove(joined_path)


# ---------------------------------------------------------------------- #
# Supervisor
# ---------------------------------------------------------------------- #

def _spawn(workdir: str, task: str, indexes: List[int], device=None):
    cmd = [sys.executable, "-m", "umgap_tpu_torch", "buildindex-dist",
           "--workdir", workdir, "--task", task,
           "--index", ",".join(str(i) for i in indexes)]
    if device is not None:
        cmd += ["--device", str(device)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ,
               PYTHONPATH=root if not path else root + os.pathsep + path)
    return subprocess.Popen(cmd, env=env)


def _run_stage(workdir: str, task: str, pending: List[int],
               workers: int, device=None) -> List[Tuple[int, int]]:
    """A stage's tasks over worker subprocesses, a strided slice of them
    each (one interpreter and one CUDA context a worker, not a task).
    Returns (index, exit code) of the tasks of failed slices (the
    ``.done`` markers keep a resume's granularity a task)."""
    from ..utils.logging import log

    slices = [pending[w::workers] for w in range(workers)]
    slices = [s for s in slices if s]
    running = {tuple(s): _spawn(workdir, task, s, device)
               for s in slices}
    failed: List[Tuple[int, int]] = []
    while running:
        done_key = None
        for key, proc in running.items():
            rc = proc.poll()
            if rc is not None:
                done_key = key
                if rc != 0:
                    log(f"buildindex-dist: {task} worker for tasks "
                        f"{list(key)[:6]}... failed (exit {rc}); "
                        "finished tasks are checkpointed, re-run to "
                        "resume the rest")
                    failed.extend((i, rc) for i in key
                                  if not _is_done(_task_stamp(
                                      workdir, task, i)))
                break
        if done_key is not None:
            running.pop(done_key)
        else:
            time.sleep(0.05)
    return failed


def _task_stamp(workdir: str, task: str, index: int) -> str:
    if task == "partition":
        return os.path.join(workdir, "part", f"c{index:05d}")
    if task == "join":
        return os.path.join(workdir, "joined", f"s{index:03d}")
    return os.path.join(workdir, "shards", f"shard_{index:03d}")


def drive(workdir: str, tsv: Optional[str], taxons: Optional[str],
          n_shards: int = 16, workers: int = 2, k: int = 9,
          synthetic_rows: Optional[int] = None, seed: int = 7,
          n_tax: int = 200_000, chunk_bytes: int = 256 << 20,
          rows_per_chunk: int = 20_000_000, layout: str = LAYOUT,
          reclaim: bool = False, reclaim_input: bool = False,
          device=None) -> dict:
    """Run (or resume) the whole job; returns the manifest with the
    stages' seconds and the key count. Idempotent: finished tasks are
    skipped by their ``.done`` markers. ``device`` is resolved first (no
    card and no ``"cpu"``: :class:`~umgap_tpu_torch.device.NoCudaDevice`)
    and handed to the workers; on the card the kernels are built here,
    before any worker starts."""
    from ..device import resolve_device
    from ..utils.logging import log

    dev = resolve_device(device)
    if dev.type == "cuda":
        from .. import kernels

        kernels.build_all()
    workdir = os.path.abspath(workdir)  # workers may run elsewhere
    os.makedirs(workdir, exist_ok=True)
    for sub in ("part", "joined", "shards"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)

    man_path = os.path.join(workdir, "manifest.json")
    if os.path.exists(man_path):
        with open(man_path) as f:
            manifest = json.load(f)
    else:
        if synthetic_rows is not None:
            n_chunks = max(1, -(-synthetic_rows // rows_per_chunk))
            taxons_path = os.path.abspath(
                taxons or os.path.join(workdir, "taxons.tsv"))
            manifest = dict(input="synthetic", seed=seed, n_tax=n_tax,
                            rows_per_chunk=rows_per_chunk,
                            total_rows=synthetic_rows,
                            n_chunks=n_chunks, taxons=taxons_path,
                            n_shards=n_shards, k=k, layout=layout,
                            reclaim=reclaim)
        else:
            chunks = tsv_chunks(tsv, chunk_bytes)
            manifest = dict(input="tsv", tsv=os.path.abspath(tsv),
                            chunks=chunks, n_chunks=len(chunks),
                            taxons=os.path.abspath(taxons),
                            n_shards=n_shards, k=k, layout=layout,
                            reclaim=reclaim, reclaim_input=reclaim_input)
        with open(man_path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(man_path + ".tmp", man_path)

    if manifest["input"] == "synthetic" and \
            not os.path.exists(manifest["taxons"]):
        log("buildindex-dist: generating synthetic taxonomy")
        write_synthetic_taxonomy(manifest["taxons"], manifest["n_tax"],
                                 manifest["seed"])

    timings = {}
    stages = [
        ("partition", [c for c in range(manifest["n_chunks"])
                       if not _is_done(os.path.join(workdir, "part",
                                                    f"c{c:05d}"))]),
        ("join", [s for s in range(manifest["n_shards"])
                  if not _is_done(os.path.join(workdir, "joined",
                                               f"s{s:03d}"))]),
        ("build", [s for s in range(manifest["n_shards"])
                   if not _is_done(os.path.join(workdir, "shards",
                                                f"shard_{s:03d}"))]),
    ]
    for task, pending in stages:
        t0 = time.perf_counter()
        attempts = 0
        while pending:
            log(f"buildindex-dist: stage {task}: {len(pending)} task(s) "
                f"over {workers} worker(s)")
            failed = _run_stage(workdir, task, pending, workers, device)
            if not failed:
                break
            # exit code 3: a stash overflow at the sized capacity; double
            # it and rebuild the whole stage
            if task == "build" and all(rc == 3 for _i, rc in failed) \
                    and attempts < 3:
                cap = bump_capacity(workdir)
                log(f"buildindex-dist: capacity bumped to {cap}; "
                    "rebuilding shards")
                pending = list(range(manifest["n_shards"]))
                attempts += 1
                continue
            raise RuntimeError(
                f"stage {task}: {len(failed)} task(s) failed "
                f"({failed[:8]}...); re-run the same command to resume")
        timings[task] = round(time.perf_counter() - t0, 2)

    manifest["timings"] = timings
    manifest["capacity"] = common_capacity(workdir, manifest)
    n_keys = sum(_shard_key_count(workdir, s)
                 for s in range(manifest["n_shards"]))
    manifest["n_keys"] = n_keys
    with open(man_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(man_path + ".tmp", man_path)
    log(f"buildindex-dist: complete — {n_keys} keys in "
        f"{manifest['n_shards']} shards under {workdir}/shards "
        f"(timings {timings})")
    return manifest


def load_shards(workdir: str, mmap: bool = False):
    """The built shard tables of ``workdir``, in shard order, ready for
    :meth:`~umgap_tpu_torch.parallel.sharded.ShardedTable.from_shards`.
    ``mmap`` maps the rows instead of reading them."""
    from .table import load_table

    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    shards = []
    for s in range(manifest["n_shards"]):
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"shard artifact missing: {path} — the manifest names "
                f"{manifest['n_shards']} shards; re-run buildindex-dist "
                f"--workdir {workdir} to resume the build")
        try:
            shards.append(load_table(path, mmap=mmap))
        except Exception as e:
            raise ShardArtifactError(
                f"shard artifact unreadable (truncated or corrupt): "
                f"{path}: {e}; delete it and its .done marker, then "
                f"re-run buildindex-dist --workdir {workdir}") from e
    return shards


def repack_shards(workdir: str, log=lambda s: None) -> int:
    """Rewrite the workdir's shards in the packed row format
    (``KmerTable.save(packed=True)``) in place, atomic a shard, packed
    shards skipped, safe to re-run. Returns the shards rewritten."""
    shards = load_shards(workdir, mmap=True)
    n = 0
    for s, t in enumerate(shards):
        if t.kind != "kmer" or t.rows_packed is not None:
            continue
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        tmp = path + ".repack.npz"
        t.save(tmp, packed=True)
        os.replace(tmp, path)
        n += 1
        log(f"repacked shard {s}")
    return n


def densify_shards(workdir: str, log=lambda s: None) -> int:
    """Rewrite the workdir's 64-slot shards in the dense ``bucket64d``
    geometry in place, atomic a shard, safe to re-run (shards at the
    dense capacity are skipped): ``items()`` gives each shard's keys and
    values, conveyor-placed again at up to ~0.88 load. Returns the
    shards rewritten."""
    from .table import MIN_NB_BITS, KmerTable, _pow2_capacity

    man_path = os.path.join(workdir, "manifest.json")
    with open(man_path) as f:
        manifest = json.load(f)
    shards = load_shards(workdir, mmap=True)
    if any(t.kind != "kmer" or t.bucket != 64 for t in shards):
        raise ValueError(
            "--densify relayouts 64-slot-bucket k-mer shards "
            "(bucket64s); rebuild other layouts with --layout bucket64d")
    cap = _pow2_capacity(max(t.n for t in shards),
                         LOAD_FACTORS["bucket64d"], 64 << MIN_NB_BITS)
    n = 0
    for s, t in enumerate(shards):
        if t.capacity == cap and t.max_probes == PROBE_LIMITS["bucket64d"]:
            continue
        keys, values = t.items()
        try:
            dense = KmerTable.build(
                keys.astype(np.uint64), values.astype(np.int32),
                k=t.k, bucket=64,
                max_probe_limit=PROBE_LIMITS["bucket64d"],
                stash_cap=256, capacity=cap)
        except RuntimeError as e:
            raise RuntimeError(
                f"shard {s} will not densify at capacity {cap} ({e}); "
                "its realized load exceeds the conveyor ceiling — "
                "rebuild with more shards instead") from e
        dense.max_probes = max(dense.max_probes,
                               PROBE_LIMITS["bucket64d"])
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        tmp = path + ".densify.npz"
        dense.save(tmp, packed=True)
        os.replace(tmp, path)
        n += 1
        log(f"densified shard {s}: {t.capacity} -> {cap} slots "
            f"(load {t.n / cap:.2f})")
    manifest["layout"] = "bucket64d"
    manifest["capacity"] = cap
    with open(man_path + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(man_path + ".tmp", man_path)
    return n


def worker_main(workdir: str, task: str, indexes, device=None) -> None:
    """One or more tasks (comma-separated indexes) in this process, on
    ``device``; the taxonomy (and on the join its device copy) loads
    once."""
    from ..device import resolve_device

    dev = resolve_device(device)
    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    if isinstance(indexes, int):
        indexes = [indexes]
    elif isinstance(indexes, str):
        indexes = [int(x) for x in indexes.split(",") if x != ""]
    tax = dtax = None
    for index in indexes:
        if task == "partition":
            task_partition(workdir, manifest, index, dev)
        elif task == "join":
            if tax is None:
                from ..agg.device import DeviceTaxonomy
                from ..taxonomy import Taxonomy, read_taxa_file

                tax = Taxonomy(read_taxa_file(manifest["taxons"]))
                dtax = DeviceTaxonomy.from_host(tax, dev)
            task_join(workdir, manifest, index, dev, tax, dtax)
        elif task == "build":
            try:
                task_build(workdir, manifest, index)
            except RuntimeError:
                sys.exit(3)  # a stash overflow at the common capacity:
                #              the driver doubles it and rebuilds
        else:
            raise ValueError(f"unknown task {task}")
