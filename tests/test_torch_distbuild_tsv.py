"""``buildindex-dist`` of the port on a TSV (its split through K1P's
plain version and its join on the CPU here) against ``umgap_tpu``'s
command line on the same input: the same JSON line and the same files,
equal array for array; either package prints the other's build. And a
``--reclaim`` build of each package, whose spills and joined arrays are
gone, equal to the other's."""

import json
import os

import pytest

from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index import distbuild as jdist
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.index import distbuild as pdist

from test_torch_distbuild import (
    assert_same_workdir,
    run_cli,
    run_main,
    write_tsv,
    N_TAX,
)


@pytest.fixture(scope="module")
def tsv_pair(tmp_path_factory):
    """Both packages' command lines on one TSV (the port's split and
    join with --device cpu)."""
    tmp = tmp_path_factory.mktemp("tsv")
    tsv = write_tsv(str(tmp / "prot.tsv"), 5)
    taxons = str(tmp / "taxons.tsv")
    jdist.write_synthetic_taxonomy(taxons, N_TAX, 3)
    args = ["--tsv", tsv, "--taxons", taxons, "--shards", "4",
            "--workers", "2", "--layout", "bucket64s"]
    j = run_cli("umgap_tpu", ["--workdir", "wj", *args], tmp)
    p = run_cli("umgap_tpu_torch", ["--workdir", "wp", *args,
                                    "--device", "cpu"], tmp)
    return str(tmp / "wj"), str(tmp / "wp"), j, p


def test_tsv_build_matches_jax(tsv_pair):
    wj, wp, j, p = tsv_pair
    assert j[0] == p[0] == 0, (j[2], p[2])
    oj, op = json.loads(j[1]), json.loads(p[1])
    for o in (oj, op):
        o.pop("timings_s")
        o.pop("shards_dir")
    assert oj == op and oj["n_keys"] > 1_000
    assert_same_workdir(wj, wp)


def test_tsv_printindex_across_packages(tsv_pair):
    wj, wp, _j, _p = tsv_pair
    want = run_main(jax_cli, ["printindex", wj])
    assert run_main(port_cli, ["printindex", wp]) == want
    assert run_main(jax_cli, ["printindex", wp]) == want


def test_reclaim_matches_jax(tmp_path):
    wj, wp = str(tmp_path / "j"), str(tmp_path / "p")
    jdist.drive(wj, None, None, n_shards=3, workers=2, synthetic_rows=12_000,
                n_tax=800, reclaim=True)
    pdist.drive(wp, None, None, n_shards=3, workers=2, synthetic_rows=12_000,
                n_tax=800, reclaim=True, device="cpu")
    assert not os.listdir(os.path.join(wp, "part")) or all(
        f.endswith(".done") for f in os.listdir(os.path.join(wp, "part")))
    assert not any(f.endswith(".npz")
                   for f in os.listdir(os.path.join(wp, "joined")))
    assert_same_workdir(wj, wp)
