"""``buildindex-dist`` resumed across the two packages: a port driver
killed mid-job (its TSV split through K1P's plain version on the CPU,
``--reclaim-input`` punching the consumed chunks) finished by
``umgap_tpu``'s driver, and a ``umgap_tpu`` build whose join worker died
before its marker finished by the port's, each equal to a build by one
package alone, files and TSV bytes."""

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

from umgap_tpu.index import distbuild as jdist
from umgap_tpu_torch.index import distbuild as pdist

from test_torch_distbuild import REPO, assert_same_workdir

AAS = "ACDEFGHIKLMNPQRSTVWY"
CHUNK = (5 << 20) // 2


def _tsv(path, seed=8, target=5 << 20):
    rng = np.random.default_rng(seed)
    lines, size = [], 0
    while size < target:
        L = int(rng.integers(9, 3000))
        line = f"{int(rng.integers(1, 1200))}\t" + "".join(
            rng.choice(list(AAS), size=L)) + "\n"
        lines.append(line)
        size += len(line)
    with open(path, "w") as f:
        f.write("".join(lines))
    return path


def _wait_for(path, proc, timeout=240):
    t0 = time.time()
    while not os.path.exists(path):
        assert proc.poll() is None, "the driver ended before the kill"
        assert time.time() - t0 < timeout
        time.sleep(0.05)


def test_killed_port_driver_resumed_by_jax(tmp_path):
    taxons = str(tmp_path / "taxons.tsv")
    jdist.write_synthetic_taxonomy(taxons, 1200, 4)
    tsvs = {}
    for name in ("killed", "alone"):
        os.makedirs(tmp_path / name)
        tsvs[name] = str(tmp_path / name / "prot.tsv")
    _tsv(tsvs["killed"])
    shutil.copyfile(tsvs["killed"], tsvs["alone"])
    # the port's driver, killed once the first chunk is partitioned
    w = str(tmp_path / "killed" / "w")
    code = (f"from umgap_tpu_torch.index import distbuild as d; "
            f"d.drive({w!r}, {tsvs['killed']!r}, {taxons!r}, n_shards=4, "
            f"workers=1, chunk_bytes={CHUNK}, reclaim_input=True, "
            f"device='cpu')")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            env=dict(os.environ, PYTHONPATH=REPO),
                            start_new_session=True,
                            stderr=subprocess.DEVNULL)
    try:
        _wait_for(os.path.join(w, "part", "c00000.done"), proc)
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    assert not os.path.exists(os.path.join(w, "shards", "shard_000.done"))
    # umgap_tpu's driver resumes it from the manifest
    m = jdist.drive(w, None, None)
    want = jdist.drive(str(tmp_path / "alone" / "w"), tsvs["alone"], taxons,
                       n_shards=4, workers=1, chunk_bytes=CHUNK,
                       reclaim_input=True)
    assert m["n_keys"] == want["n_keys"] > 100_000
    assert_same_workdir(w, str(tmp_path / "alone" / "w"))
    with open(tsvs["killed"], "rb") as a, open(tsvs["alone"], "rb") as b:
        assert a.read() == b.read()


def test_dead_jax_worker_resumed_by_the_port(tmp_path):
    """A join worker of umgap_tpu's build died after a partial write and
    before its marker (and the build stage never ran): the port's driver
    redoes that shard and the build, equal to the finished build."""
    ref = str(tmp_path / "ref")
    jdist.drive(ref, None, None, n_shards=4, workers=2,
                synthetic_rows=20_000, n_tax=1500)
    w = str(tmp_path / "w")
    shutil.copytree(ref, w)
    for p in ("joined/s001.done", "joined/s001.count", "capacity.json"):
        os.remove(os.path.join(w, p))
    shutil.rmtree(os.path.join(w, "shards"))
    os.makedirs(os.path.join(w, "shards"))
    with open(os.path.join(w, "joined", "s001.npz.tmp.npz"), "wb") as f:
        f.write(b"PK\x03\x04 partial")
    pdist.drive(w, None, None, device="cpu")
    assert_same_workdir(ref, w)
