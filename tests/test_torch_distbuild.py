"""``buildindex-dist`` of the port (``umgap_tpu_torch/index/distbuild.py``,
its split and join on the CPU here) against ``umgap_tpu``'s on the same
synthetic rows and TSV: the same files in the work directory, equal
array for array (``.npz`` archives carry zip timestamps, so bytes are not
compared), manifests equal apart from the timings and the paths that
name the workdir; each package prints what the other built."""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index import distbuild as jdist
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.device import CPU_HINT
from umgap_tpu_torch.index import distbuild as pdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AAS = "ACDEFGHIKLMNPQRSTVWY"
N_TAX = 3000


def run_cli(pkg, args, cwd):
    """``python -m pkg buildindex-dist ARGS``: (rc, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-m", pkg, "buildindex-dist", *args],
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    return p.returncode, p.stdout, p.stderr


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv, stdin=io.StringIO(""), stdout=out)
    return rc, out.getvalue(), err.getvalue()


def files_of(workdir):
    out = set()
    for root, _dirs, names in os.walk(workdir):
        for n in names:
            out.add(os.path.relpath(os.path.join(root, n), workdir))
    return out


def _manifest(path, workdir):
    with open(path) as f:
        m = json.load(f)
    m.pop("timings", None)
    for key in ("taxons", "tsv"):  # a copied workdir names its source
        if key in m:
            m[key] = os.path.basename(m[key])
    return m


def assert_same_workdir(a, b, ignore=()):
    """The same files, .npz arrays equal (dtype too), JSON equal apart
    from the timings and the workdir paths, other files byte-equal."""
    fa, fb = files_of(a) - set(ignore), files_of(b) - set(ignore)
    assert fa == fb, (sorted(fa ^ fb))
    for rel in sorted(fa):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (rel, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        elif rel == "manifest.json":
            assert _manifest(pa, a) == _manifest(pb, b)
        else:
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), rel


def write_tsv(path, seed, n=240):
    """A seeded (taxid TAB protein) TSV of proteins of 9-1,500 residues
    (a few of 0-8), taxids of the synthetic taxonomy and past it."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            L = int(rng.integers(0, 9)) if i % 17 == 0 else \
                int(rng.integers(9, 1500))
            tid = int(rng.integers(1, N_TAX + 40))
            f.write(f"{tid}\t{''.join(rng.choice(list(AAS), size=L))}\n")
    return path


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Both packages' synthetic builds (drive in process, its workers
    each package's command line)."""
    tmp = tmp_path_factory.mktemp("synth")
    wj, wp = str(tmp / "jax"), str(tmp / "port")
    mj = jdist.drive(wj, None, None, n_shards=4, workers=2,
                     synthetic_rows=24_000, n_tax=N_TAX)
    mp = pdist.drive(wp, None, None, n_shards=4, workers=2,
                     synthetic_rows=24_000, n_tax=N_TAX, device="cpu")
    return wj, wp, mj, mp


def test_synthetic_build_matches_jax(synth):
    wj, wp, mj, mp = synth
    assert mp["n_keys"] == mj["n_keys"] > 10_000
    assert mp["capacity"] == mj["capacity"]
    assert_same_workdir(wj, wp)


def test_printindex_across_packages(synth):
    """printindex over either workdir prints the same in either
    package."""
    wj, wp, _mj, _mp = synth
    want = run_main(jax_cli, ["printindex", wj])
    assert want[0] == 0 and want[1].count("\n") > 10_000
    for w in (wj, wp):
        assert run_main(port_cli, ["printindex", w]) == want
        assert run_main(jax_cli, ["printindex", w]) == want


def test_without_a_card_the_job_exits_1(tmp_path, monkeypatch):
    """No card and no --device cpu: the driver and a worker exit 1 with
    the hint, and nothing runs its plain path in their place."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = str(tmp_path / "w")
    rc, out, err = run_main(port_cli, ["buildindex-dist", "--workdir", w,
                                       "--synthetic", "1000"])
    assert rc == 1 and out == "" and CPU_HINT in err
    assert not os.path.exists(w)
    # a worker resolves its device before it reads the workdir
    for task in ("partition", "join", "build"):
        rc, _out, err = run_main(port_cli, [
            "buildindex-dist", "--workdir", w, "--task", task,
            "--index", "0"])
        assert rc == 1 and CPU_HINT in err


def test_build_errors_match_jax(tmp_path):
    """A missing input: the same error line in both packages."""
    w = str(tmp_path / "w")
    want = run_main(jax_cli, ["buildindex-dist", "--workdir", w])
    got = run_main(port_cli, ["buildindex-dist", "--workdir", w,
                              "--device", "cpu"])
    assert got == want and want[0] == 1


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst, symlinks=True)
    return dst


@pytest.mark.parametrize("op", ["--densify", "--repack"])
def test_densify_and_repack_match_jax(synth, tmp_path, op):
    """--densify and --repack on copies of either package's build: the
    same JSON line and the same shards in both packages."""
    wj, wp, _mj, _mp = synth
    outs = []
    for src, main in ((wj, jax_cli), (wp, port_cli), (wp, jax_cli),
                      (wj, port_cli)):
        w = _copy(src, str(tmp_path / f"w{len(outs)}"))
        if op == "--repack":  # the flat (unpacked) format of older builds
            from umgap_tpu.index.table import load_table

            for path in glob.glob(os.path.join(w, "shards", "*.npz")):
                load_table(path).save(path)
        argv = ["buildindex-dist", "--workdir", w, op]
        rc, out, _err = run_main(main, argv + (
            ["--device", "cpu"] if main is port_cli else []))
        assert rc == 0
        outs.append((w, out))
    assert len({o for _w, o in outs}) == 1
    for w, _o in outs[1:]:
        assert_same_workdir(outs[0][0], w)
    assert json.loads(outs[0][1]) == {
        {"--densify": "densified", "--repack": "repacked"}[op]: 4}
    if op == "--densify":
        # the dense shards serve the same keys and values
        assert run_main(port_cli, ["printindex", outs[1][0]]) == \
            run_main(jax_cli, ["printindex", wj])
