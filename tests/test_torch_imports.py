"""The port stands alone and never runs on the CPU by accident:
``umgap_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package, entry points refuse to run without a card unless the CPU is
asked for, and the smoke script fails without a card or without the
rest of the repository."""

import ast
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from umgap_tpu_torch import device as pdevice
from umgap_tpu_torch.agg.device import DeviceTaxonomy
from umgap_tpu_torch.index.table import build_kmer_table
from umgap_tpu_torch.ops.lookup import DeviceTable
from umgap_tpu_torch.pipeline.fused import PRESETS, make_pipeline
from umgap_tpu_torch.pipeline.runner import Analyser
from umgap_tpu_torch.taxonomy import Taxonomy, fixture_taxa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "umgap_tpu")


def _port_sources():
    for root, _dirs, files in os.walk(os.path.join(REPO, "umgap_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_package_import(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_walk_covers_the_subcommands():
    """The stream subcommands and the index build are among the sources
    the import check walks."""
    walked = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("umgap_tpu_torch/subcommands.py",
                "umgap_tpu_torch/index/build.py", "umgap_tpu_torch/cli.py"):
        assert rel in walked


def test_walk_covers_the_build_job_and_setup():
    """The build job, its join and split, setup's config dir and the
    streaming aggregators are walked, and import without a compiler or a
    card (a kernel is built inside the call that launches it)."""
    import importlib

    walked = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in ("index.scale", "index.distbuild", "agg.streaming",
                "configdir"):
        rel = "umgap_tpu_torch/" + mod.replace(".", "/") + ".py"
        assert rel in walked
        importlib.import_module("umgap_tpu_torch." + mod)


def test_build_job_needs_a_card_or_an_explicit_cpu(no_card, tmp_path):
    """buildindex-dist exits 1 with the hint without a card; setup and
    visualize, host commands, run."""
    import contextlib
    import io

    from umgap_tpu_torch.cli import main as port_cli

    tsv = tmp_path / "t.tsv"
    tsv.write_text("1\troot\tno rank\t1\t\x01\n")
    cases = ((["buildindex-dist", "--workdir", str(tmp_path / "w"),
               "--synthetic", "100"], 1),
             (["buildindex-dist", "--workdir", str(tmp_path / "w"),
               "--tsv", str(tsv), "--taxons", str(tsv)], 1),
             (["setup", "-c", str(tmp_path / "c"), "-d", str(tmp_path / "d"),
               "-v", "1", "--taxons", str(tsv)], 0),
             (["visualize", "-t", "species", "--taxons", str(tsv),
               str(tsv)], 0))
    for argv, rc_want in cases:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = port_cli(argv, stdin=io.StringIO(""), stdout=out)
        assert rc == rc_want, (argv, err.getvalue())
        assert (pdevice.CPU_HINT in err.getvalue()) == (rc_want == 1)


def test_subcommands_need_a_card_or_an_explicit_cpu(no_card, tmp_path):
    """The subcommands that run on the card exit 1 with the hint without
    one; the host ones run."""
    import contextlib
    import io

    from umgap_tpu_torch.cli import main as port_cli

    tsv = tmp_path / "t.tsv"
    tsv.write_text("1\troot\tno rank\t1\t\x01\n")
    for argv in (["seedextend"], ["taxa2agg", str(tsv)],
                 ["pept2lca", "i.npz"], ["prot2tryp2lca", "i.npz"],
                 ["prot2kmer2lca", "i.npz"]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stderr(err):
            assert port_cli(argv, stdin=io.StringIO(">a\n1\n"),
                            stdout=out) == 1, argv
        assert out.getvalue() == "" and pdevice.CPU_HINT in err.getvalue()
    out = io.StringIO()
    assert port_cli(["uniq"], stdin=io.StringIO(">a\n1\n"),
                    stdout=out) == 0
    assert out.getvalue() == ">a\n1\n"


def _port_files():
    """Every source of the port (Python, C++, CUDA) and chip_smoke.py."""
    for root, _dirs, files in os.walk(os.path.join(REPO, "umgap_tpu_torch")):
        if os.path.basename(root) in ("_build", "__pycache__"):
            continue
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_builds_or_loads_the_repo_native_library():
    """No source names the repository's native/ directory or its
    libumgap_native.so, and the host library's build command compiles
    only the port's own sources into the port's build directory."""
    repo_native = os.path.join(REPO, "native") + os.sep
    for path in _port_files():
        text = open(path, encoding="utf-8").read()
        assert "libumgap_native" not in text, path
        assert "umgap_native.cpp" not in text, path
        own = text.replace("umgap_tpu_torch/native/", "")
        assert not re.search(r"(?<![\w.])native/", own), path
    from umgap_tpu_torch.io import native

    out = native.lib_path()
    cmd = native.build_command(out)
    for arg in cmd:
        assert not os.path.abspath(arg).startswith(repo_native), arg
    assert str(out).startswith(os.path.join(REPO, "umgap_tpu_torch",
                                            "_build"))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def world():
    tax = Taxonomy(fixture_taxa())
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 2 ** 45, size=600, dtype=np.uint64))
    vals = rng.choice([2, 10239, 12884], size=len(keys)).astype(np.int32)
    return tax, build_kmer_table(keys, vals, 9)


def test_entry_points_need_a_card_or_an_explicit_cpu(no_card, world):
    tax, table = world
    with pytest.raises(pdevice.NoCudaDevice, match="device='cpu'"):
        pdevice.resolve_device()
    with pytest.raises(pdevice.NoCudaDevice):
        pdevice.resolve_device("cuda")
    cfg = PRESETS["high-sensitivity"]
    with pytest.raises(pdevice.NoCudaDevice):
        Analyser(tax, table, cfg)
    with pytest.raises(pdevice.NoCudaDevice):
        DeviceTable.from_host(table)
    with pytest.raises(pdevice.NoCudaDevice):
        DeviceTaxonomy.from_host(tax)
    dtax = DeviceTaxonomy.from_host(tax, device="cpu")
    dtable = DeviceTable.from_host(table, device="cpu")
    with pytest.raises(pdevice.NoCudaDevice):
        make_pipeline(dtax, dtable, cfg)
    from umgap_tpu_torch.index.table import PeptideTable
    from umgap_tpu_torch.pipeline import tryptic

    ptable = PeptideTable.build(["AAAAAAAAAK"], np.array([2], np.int32))
    tcfg = tryptic.TRYPTIC_PRESETS["tryptic-sensitivity"]
    with pytest.raises(pdevice.NoCudaDevice):
        tryptic.TrypticAnalyser(tax, ptable, tcfg)
    with pytest.raises(pdevice.NoCudaDevice):
        tryptic.analyse_tryptic_groups([("a", ["ACGT"])], tax, ptable, tcfg)
    with pytest.raises(pdevice.NoCudaDevice):
        tryptic.make_tryptic_fused(dtax, DeviceTable.from_host(
            ptable, device="cpu"), tcfg)
    # the sharded serving path: the mesh, the stacked shards, the CLI
    from umgap_tpu_torch.parallel import ShardedTable, make_mesh

    with pytest.raises(pdevice.NoCudaDevice):
        make_mesh()
    with pytest.raises(pdevice.NoCudaDevice):
        make_mesh("auto")
    with pytest.raises(pdevice.NoCudaDevice):
        ShardedTable.from_shards([table, table])
    assert make_mesh(1, "cpu") == (torch.device("cpu"),)
    from umgap_tpu_torch.cli import main as port_cli

    for flags in (["--shards", "/nonexistent"], ["--mesh"]):
        assert port_cli(["analyse", "-1", "x.fq", "--taxons", "t.tsv",
                         "--index", "i.npz", *flags]) == 1
    # asked for explicitly, the CPU runs the plain path
    an = Analyser(tax, table, cfg, batch_size=4, read_length=30,
                  device="cpu")
    assert an.device == torch.device("cpu")
    out = list(an.analyse_groups([("a", ["ACGT" * 7, "TTGCA" * 6])]))
    assert out == [("a", 1)]


def test_unported_options_refuse(world):
    tax, table = world
    # peptide tables are ported: their rows are [key_hi | key_lo | values]
    # of 8 slots each (tests/test_torch_tryptic.py holds them to umgap_tpu)
    from umgap_tpu_torch.index.table import PeptideTable

    pt = PeptideTable.build(["AAAAAAAAAK", "CCCCCCCCCR", "DDDDDDDDDE"],
                            np.array([2, 10239, 12884], np.int32))
    dt = DeviceTable.from_host(pt, device="cpu")
    assert dt.kind == "peptide" and dt.rows.shape == (pt.n_buckets, 24)
    nb = pt.n_buckets
    assert np.array_equal(dt.rows.numpy(), np.concatenate(
        [pt.key_hi.reshape(nb, 8), pt.key_lo.reshape(nb, 8),
         pt.values.reshape(nb, 8)], axis=1))
    with pytest.raises(NotImplementedError):
        DeviceTable.from_host(types.SimpleNamespace(kind="cuckoo"),
                              device="cpu")
    # grouped k-mer and peptide tables are served
    # (tests/test_torch_sharded.py, tests/test_torch_mesh.py); a group
    # that is no slice of its index's shards is refused
    with pytest.raises(ValueError, match="not a slice"):
        DeviceTable(dt.rows, 0, "peptide", 0, 8, group=2, first=1,
                    n_total=2)
    # taxa2agg cannot combine tree with mrtl: refused as by the reference
    with pytest.raises(ValueError, match="cannot be combined"):
        Analyser(tax, table, PRESETS["max-sensitivity"]._replace(
            method="tree"), device="cpu")
    # rmq/lca* without a taxonomy to build its Euler tables from
    dtax = DeviceTaxonomy.from_host(tax, device="cpu")
    dtable = DeviceTable.from_host(table, device="cpu")
    with pytest.raises(ValueError, match="DeviceEuler"):
        Analyser(None, None, PRESETS["max-sensitivity"]._replace(
            strategy="lca*"), dtax=dtax, dtable=dtable, device="cpu")
    # the dense conveyor build (max_probe_limit=1, the default as in
    # umgap_tpu) is ported: tests/test_torch_conveyor.py holds it to
    # umgap_tpu array by array
    from umgap_tpu_torch.index.table import KmerTable
    from umgap_tpu_torch.ops.kmers import split_packed

    keys = np.arange(1, 5000, dtype=np.uint64)
    kt = KmerTable.build(keys, np.ones(len(keys), np.int32), 9,
                         max_probe_limit=1)
    _vals, found = kt.probe_host(*split_packed(keys))
    assert found.all()


def _smoke(cwd, env=None):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _smoke(REPO, env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
