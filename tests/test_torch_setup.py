"""``setup``, ``visualize`` and ``taxa2tree`` of the port against
``umgap_tpu``'s: the same stdout bytes, exit codes and stderr, the same
files and links installed, with the network replaced by a stub of
``urllib.request.urlopen`` (as tests/test_golden.py replaces it)."""

import contextlib
import gzip
import io
import json
import os
import urllib.request

import pytest

from umgap_tpu.cli import main as jax_cli
from umgap_tpu_torch import configdir as pcfg
from umgap_tpu_torch.cli import main as port_cli

FIXTURE_TSV = (
    "1\troot\tno rank\t1\t\x01\n"
    "2\tBacteria\tsuperkingdom\t1\t\x01\n"
    "10239\tViruses\tsuperkingdom\t1\t\x01\n"
    "12884\tViroids\tsuperkingdom\t1\t\x01\n"
    "185751\tPospiviroidae\tfamily\t12884\t\x01\n"
    "185752\tAvsunviroidae\tfamily\t12884\t\x01\n"
    "1000\tsome species\tspecies\t185751\t\x01\n"
    "1001\tan invalid one\tspecies\t185752\t\x00\n"
)
TAXA_FASTA = "".join(f">r{i}\n{t}\n" for i, t in enumerate(
    [1000, 1000, 185751, 2, 1, 1001, 12884, 1000, 10239, 2]))


def run(main, argv, stdin=""):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv, stdin=io.StringIO(stdin), stdout=out)
    return rc, out.getvalue(), err.getvalue()


class _Response:
    def __init__(self, body: bytes):
        self.body = body

    def read(self, n=-1):
        data, self.body = (self.body, b"") if n < 0 else (
            self.body[:n], self.body[n:])
        return data

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture
def network(monkeypatch):
    """urlopen replaced: the data server's /latest and artifacts, and the
    Unipept API's taxa2tree (its HTML, or a gist for -u); every call
    recorded."""
    calls = []

    def urlopen(req, timeout=None):
        if isinstance(req, str):
            calls.append(("GET", req))
            if req.endswith("/down/latest"):
                raise OSError("server down")
            if req.endswith("/latest"):
                return _Response(b"2026-09\n")
            return _Response(f"artifact {os.path.basename(req)}".encode())
        payload = json.loads(req.data.decode())
        calls.append(("POST", req.full_url, payload))
        if payload["link"] == "true":
            return _Response(json.dumps(
                {"gist": "https://gist.github.com/abc123"}).encode())
        return _Response(("<html>" + json.dumps(payload["counts"],
                                                sort_keys=True)
                          + "</html>").encode())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return calls


def both(tmp_path, argv_of, stdin=""):
    """Runs ``argv_of(root)`` in two fresh roots, one a package; returns
    both results and roots."""
    out = []
    for name, main in (("jax", jax_cli), ("port", port_cli)):
        root = tmp_path / name
        root.mkdir(parents=True)
        out.append((run(main, argv_of(root), stdin), root))
    return out


def tree_of(root):
    """Every file and link under root: (path, link target or bytes)."""
    out = {}
    for dirpath, dirs, names in os.walk(root):
        for n in dirs + names:
            p = os.path.join(dirpath, n)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("link", os.path.relpath(os.readlink(p), root))
            elif os.path.isfile(p):
                with open(p, "rb") as f:
                    out[rel] = ("file", f.read(), oct(os.stat(p).st_mode))
    return out


def _local_files(tmp_path):
    src = tmp_path / "taxons.tsv"
    src.write_text(FIXTURE_TSV)
    idx = tmp_path / "n.npz"
    idx.write_bytes(b"an index")
    return str(src), str(idx)


def test_setup_local_install_matches_jax(tmp_path, network):
    src, idx = _local_files(tmp_path)
    for extra in (["--taxons", src], ["--taxons", src, "--ninemer", idx,
                                      "--tryptic", idx]):
        (a, ra), (b, rb) = both(tmp_path / str(len(extra)), lambda r: [
            "setup", "-c", str(r / "conf"), "-d", str(r / "data"),
            "-v", "2026-08", *extra])
        assert a[0] == 0 and a[1].replace(str(ra), "R") == \
            b[1].replace(str(rb), "R") and a[2] == b[2]
        assert tree_of(ra) == tree_of(rb)
    assert network == []  # the local route needs no network


def test_setup_local_requires_a_version(tmp_path, network):
    src, _idx = _local_files(tmp_path)
    (a, _), (b, _) = both(tmp_path, lambda r: [
        "setup", "-c", str(r / "c"), "-d", str(r / "d"), "--taxons", src])
    assert a == b and a[0] == 1


def test_setup_from_the_server_matches_jax(tmp_path, network):
    """-y: the version from /latest, the three artifacts downloaded; a
    second run finds them and downloads nothing; a server that fails."""
    (a, ra), (b, rb) = both(tmp_path, lambda r: [
        "setup", "-y", "-c", str(r / "conf"), "-d", str(r / "data"),
        "-s", "https://example.org/umgap"])
    assert a[0] == 0 and "Latest version is 2026-09." in a[1]
    assert a[1].replace(str(ra), "R") == b[1].replace(str(rb), "R")
    assert a[2] == b[2] and tree_of(ra) == tree_of(rb)
    half = len(network) // 2
    assert network[:half] == network[half:] and half == 4
    network.clear()
    for main, r in ((jax_cli, ra), (port_cli, rb)):
        rc, out, _ = run(main, ["setup", "-y", "-c", str(r / "conf"), "-d",
                                str(r / "data"), "-v", "2026-09"])
        assert rc == 0 and out.count("available") == 3
    assert network == []
    (a, _), (b, _) = both(tmp_path / "down", lambda r: [
        "setup", "-c", str(r / "c"), "-d", str(r / "d"),
        "-s", "https://example.org/down"])
    assert a == b and a[0] == 1 and "Could not retrieve" in a[2]


@pytest.mark.parametrize("url", [False, True])
def test_taxa2tree_matches_jax(network, url):
    argv = ["taxa2tree"] + (["-u"] if url else [])
    want = run(jax_cli, argv, TAXA_FASTA)
    got = run(port_cli, argv, TAXA_FASTA)
    assert got == want and want[0] == 0
    assert network[0] == network[1]
    assert (want[1] == "https://bl.ocks.org/abc123\n") == url


def test_taxa2tree_errors_match_jax(monkeypatch):
    def refuse(req, timeout=None):
        raise OSError("no network here")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    want = run(jax_cli, ["taxa2tree"], TAXA_FASTA)
    assert run(port_cli, ["taxa2tree"], TAXA_FASTA) == want
    assert want[0] == 1 and "no network here" in want[2]


def _samples(tmp_path):
    """Two taxa files, one gzipped, in a directory (the CSV header
    strips directory names)."""
    d = tmp_path / "in dir"
    d.mkdir()
    a = d / "sample-A.txt"
    a.write_text("".join(f"{t}\n" for t in
                         (1000, 1000, 185751, 2, 1001, 12884, "x", -3)))
    b = d / "sample B.txt.gz"
    with gzip.open(b, "wt") as f:
        f.write("1000\n2\n2\n10239\n185752\n")
    return [str(a), str(b)]


@pytest.mark.parametrize("rank", ["species", "family", "superkingdom"])
def test_visualize_csv_matches_jax(tmp_path, rank):
    taxons = tmp_path / "t.tsv"
    taxons.write_text(FIXTURE_TSV)
    files = _samples(tmp_path)
    argv = ["visualize", "-t", rank, "--taxons", str(taxons), *files]
    want = run(jax_cli, argv)
    assert run(port_cli, argv) == want and want[0] == 0
    assert want[1].startswith("taxon id,taxon name,sample-A.txt,")


def test_visualize_csv_from_the_config_dir(tmp_path, monkeypatch):
    """-t without --taxons finds the taxonomy as setup installed it (by
    either package), or fails alike."""
    files = _samples(tmp_path)
    conf = tmp_path / "conf"
    want = run(jax_cli, ["visualize", "-t", "species", "-c", str(conf),
                         *files])
    assert run(port_cli, ["visualize", "-t", "species", "-c", str(conf),
                          *files]) == want and want[0] == 1
    src = tmp_path / "taxons.tsv"
    src.write_text(FIXTURE_TSV)
    pcfg.install(str(conf), str(tmp_path / "data"), "2026-08",
                 {"taxons.tsv": str(src)})
    argv = ["visualize", "-t", "family", "-c", str(conf), *files]
    want = run(jax_cli, argv)
    assert run(port_cli, argv) == want and want[0] == 0


@pytest.mark.parametrize("flag", ["-w", "-u"])
def test_visualize_web_and_url_match_jax(tmp_path, network, flag):
    d = tmp_path / "s"
    d.mkdir()
    plain = d / "a.fa"
    plain.write_text(TAXA_FASTA)
    packed = d / "b.fa.gz"
    with gzip.open(packed, "wt") as f:
        f.write(TAXA_FASTA[: TAXA_FASTA.index(">r5")])
    argv = ["visualize", flag, str(plain), str(packed)]
    want = run(jax_cli, argv)
    got = run(port_cli, argv)
    assert got == want and want[0] == 0
    assert network[:2] == network[2:]


def test_sniff_open_reads_gzip_and_plain(tmp_path):
    p, g = tmp_path / "p.txt", tmp_path / "g.txt.gz"
    p.write_text("plain\n")
    with gzip.open(g, "wt") as f:
        f.write("packed\n")
    with pcfg.sniff_open(str(p)) as f:
        assert f.read() == "plain\n"
    with pcfg.sniff_open(str(g)) as f:
        assert f.read() == "packed\n"
