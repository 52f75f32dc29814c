"""``buildindex-dist`` layouts of the port against ``umgap_tpu``'s: the
build stage of each layout (bucket64s, bucket64d, bucket16, bucket8s)
run again by each package on copies of both packages' joined shards, the
same shards, capacity and manifest."""

import json
import os
import shutil

import pytest

from umgap_tpu.index import distbuild as jdist
from umgap_tpu_torch.index import distbuild as pdist

from test_torch_distbuild import assert_same_workdir


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layouts")
    wj, wp = str(tmp / "jax"), str(tmp / "port")
    jdist.drive(wj, None, None, n_shards=4, workers=2, synthetic_rows=20_000,
                n_tax=1500)
    pdist.drive(wp, None, None, n_shards=4, workers=2, synthetic_rows=20_000,
                n_tax=1500, device="cpu")
    return tmp, wj, wp


def _relayout(src, dst, layout):
    """A copy of ``src`` whose build stage is to run again at
    ``layout``."""
    shutil.copytree(src, dst)
    shutil.rmtree(os.path.join(dst, "shards"))
    os.makedirs(os.path.join(dst, "shards"))
    os.remove(os.path.join(dst, "capacity.json"))
    path = os.path.join(dst, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m["layout"] = layout
    with open(path, "w") as f:
        json.dump(m, f)
    return dst


def test_the_two_builds_are_equal(built):
    _tmp, wj, wp = built
    assert_same_workdir(wj, wp)


@pytest.mark.parametrize("layout", ["bucket64d", "bucket16", "bucket8s"])
def test_layouts_match_jax(built, layout):
    tmp, wj, wp = built
    a = _relayout(wj, str(tmp / f"j_{layout}"), layout)
    b = _relayout(wp, str(tmp / f"p_{layout}"), layout)
    mj = jdist.drive(a, None, None, workers=1)
    mp = pdist.drive(b, None, None, workers=1, device="cpu")
    assert mj["capacity"] == mp["capacity"]
    assert_same_workdir(a, b)


def test_build_workers_share_the_capacity_file(built, tmp_path):
    """Build workers compute the common capacity at once: each writes
    capacity.json through a temporary of its own, so a temporary another
    worker renamed (here a directory in the way of a shared name) breaks
    none of them; the file is umgap_tpu's."""
    _tmp, wj, wp = built
    w = shutil.copytree(wp, str(tmp_path / "w"))
    os.remove(os.path.join(w, "capacity.json"))
    os.makedirs(os.path.join(w, "capacity.json.tmp"))
    with open(os.path.join(w, "manifest.json")) as f:
        manifest = json.load(f)
    assert pdist.common_capacity(w, manifest) == manifest["capacity"]
    with open(os.path.join(w, "capacity.json")) as a, \
            open(os.path.join(wj, "capacity.json")) as b:
        assert json.load(a) == json.load(b)
    assert sorted(os.listdir(w)) == sorted(os.listdir(wp) + [
        "capacity.json.tmp"])
