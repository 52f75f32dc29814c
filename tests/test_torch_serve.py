"""``analyse --serve`` of the port (``--device cpu``) against
``umgap_tpu``'s, each run in a thread of this process: the same requests
get the same reply bytes (``ok <n>``, the FASTA streamed back without
``-o``, the error lines, ``bye``) and write the same files, on one device
and under ``--mesh 4``. A repeated request builds no analyser and loads no
table; a client that closes at once does not wedge the service; a config
dir's peptide index is loaded at the first tryptic request. The reads are
made from a seed."""

import io
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest

from umgap_tpu import ranks
from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index.table import KmerTable
from umgap_tpu.taxonomy import fixture_taxa
from umgap_tpu_torch import cli as pcli
from umgap_tpu_torch.index import table as ptable
from umgap_tpu_torch.ops import encoding, kmers, translate
from umgap_tpu_torch.pipeline import runner as prunner

L = 100
N_READS = 150
IDS = [2, 10239, 12884, 185751, 185752, 1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Paired FASTQ of seeded reads, the fixture taxonomy as a TSV, a
    9-mer index of the reads' own k-mers (a taxon a (group, frame)) built
    by ``umgap_tpu``'s ``KmerTable.build`` with its defaults, a peptide
    index of their tryptic fragments, and a config dir's data version
    linking all three."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(15)
    codes = rng.integers(0, 4, size=(N_READS, 2, L)).astype(np.uint8)
    lens = rng.integers(40, L + 1, size=(N_READS, 2)).astype(np.int32)
    code = encoding.get_table(1)
    kmap, pmap = {}, {}
    fq = [tmp / "R1.fq", tmp / "R2.fq"]
    handles = [open(p, "w") for p in fq]
    for i in range(N_READS):
        for e in range(2):
            seq = encoding.decode_dna(codes[i, e, :lens[i, e]])
            handles[e].write(f"@read{i}/{e + 1}\n{seq}\n+\n"
                             f"{'I' * len(seq)}\n")
            for j, pep in enumerate(translate.translate_sequence(
                    seq, translate.FRAME_NAMES, code)):
                ac = encoding.encode_aa(pep)
                for w in range(len(ac) - 8):
                    if ac[w:w + 9].max() < 20 and rng.random() < 0.8:
                        kmap.setdefault(int(kmers.pack_kmers_host(
                            ac[w:w + 9], 9)[0]), IDS[(i + j) % 5])
                for frag in kmers.tryptic_digest(pep):
                    if 9 <= len(frag) <= 45:
                        pmap.setdefault(frag, IDS[i % 5])
    for h in handles:
        h.close()
    packed = np.array(sorted(kmap), np.uint64)
    values = np.array([kmap[k] for k in sorted(kmap)], np.int32)
    data = tmp / "data"
    data.mkdir()
    with open(data / "taxons.tsv", "w") as f:
        for t in fixture_taxa():
            valid = "\x01" if t.valid else "\x00"
            f.write(f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t"
                    f"{t.parent}\t{valid}\n")
    KmerTable.build(packed, values, k=9).save(data / "ninemer.npz")
    peps = sorted(pmap)
    ptable.PeptideTable.build(
        peps, np.array([pmap[p] for p in peps], np.int32)).save(
            data / "tryptic.npz")
    ver = tmp / "conf" / "1"
    ver.mkdir(parents=True)
    for name in ("taxons.tsv", "ninemer.npz", "tryptic.npz"):
        os.symlink(data / name, ver / name)
    return dict(tmp=tmp, fq=[str(p) for p in fq], conf=str(tmp / "conf"),
                taxons=str(data / "taxons.tsv"),
                index=str(data / "ninemer.npz"))


def _connect(sock_path: str) -> socket.socket:
    deadline = time.time() + 120
    while time.time() < deadline:
        c = socket.socket(socket.AF_UNIX)
        try:
            c.connect(sock_path)
            return c
        except (FileNotFoundError, ConnectionRefusedError):
            c.close()
            time.sleep(0.05)
    raise TimeoutError("the service never came up")


def _request(sock_path: str, line: str) -> str:
    with _connect(sock_path) as c:
        c.sendall((line + "\n").encode())
        c.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            b = c.recv(65536)
            if not b:
                return b"".join(chunks).decode()
            chunks.append(b)


class _Service:
    """One package's ``analyse --serve`` in a thread."""

    def __init__(self, port: bool, argv):
        self.rc = None
        if port:
            run = lambda: pcli.main(argv + ["--device", "cpu"],  # noqa: E731
                                    stdout=io.StringIO())
        else:
            run = lambda: jax_cli(argv, stdin=io.StringIO(""),  # noqa: E731
                                  stdout=io.StringIO())

        def body():
            self.rc = run()

        self.thread = threading.Thread(target=body, daemon=True)
        self.thread.start()

    def stop(self, sock_path):
        reply = _request(sock_path, "quit")
        self.thread.join(timeout=120)
        return reply


def _drive(world, tmp, tag, port, mesh=None, counts=None):
    sock = str(tmp / f"{tag}.sock")
    argv = ["analyse", "--serve", sock, "--taxons", world["taxons"],
            "--index", world["index"], "--read-length", str(L)]
    if mesh:
        argv += ["--mesh", str(mesh)]
    svc = _Service(port, argv)
    r1, r2 = world["fq"]
    sample = f"-t max-sensitivity -1 {r1} -2 {r2}"
    outs = [tmp / f"{tag}-{k}.fa" for k in range(4)]
    rep = []
    rep.append(_request(sock, f"{sample} -o {outs[0]}"))
    if counts is not None:
        counts["after_first"] = dict(counts)
    rep.append(_request(sock, f"{sample} -o {outs[1]}"))
    if counts is not None:
        counts["after_second"] = {k: v for k, v in counts.items()
                                  if not k.startswith("after")}
    rep.append(_request(sock, sample))  # no -o: the FASTA streams back
    rep.append(_request(sock, f"-t bogus-preset -1 nope.fq -o {outs[3]}"))
    c = socket.socket(socket.AF_UNIX)  # connects and closes at once
    c.connect(sock)
    c.close()
    rep.append(_request(sock, f"-t tryptic-sensitivity -1 {r1} -2 {r2} "
                              f"-o {outs[3]}"))
    # two samples in one request, the second gzipped
    rep.append(_request(sock, f"{sample} -o {outs[2]} -t high-sensitivity "
                              f"-1 {r1} -2 {r2} -z -o {outs[3]}"))
    rep.append(svc.stop(sock))
    assert svc.rc == 0
    assert not os.path.exists(sock)
    import gzip

    files = [outs[0].read_bytes(), outs[1].read_bytes(),
             outs[2].read_bytes(), gzip.decompress(outs[3].read_bytes())]
    return rep, files


def _counting(monkeypatch):
    """Counts the port's analysers built, tables loaded and taxonomies
    read."""
    counts = {"analysers": 0, "tables": 0, "taxonomies": 0}

    def wrap(obj, name, key):
        real = getattr(obj, name)

        def spy(*a, **kw):
            counts[key] += 1
            return real(*a, **kw)

        monkeypatch.setattr(obj, name, spy)

    real_init = prunner.Analyser.__init__

    def init(self, *a, **kw):
        counts["analysers"] += 1
        real_init(self, *a, **kw)

    monkeypatch.setattr(prunner.Analyser, "__init__", init)
    import umgap_tpu_torch.taxonomy as ptaxonomy

    wrap(ptable, "load_table", "tables")
    wrap(ptaxonomy, "read_taxa_file", "taxonomies")
    return counts


def _check(jrep, jfiles, prep, pfiles):
    assert prep == jrep
    assert pfiles == jfiles
    ok = f"ok {N_READS}\n"
    assert jrep[0] == jrep[1] == ok
    assert jrep[2].encode() == jfiles[0] == jfiles[1] == jfiles[2]
    assert jfiles[0].count(b">") == N_READS
    assert jrep[3].startswith("error unknown preset 'bogus-preset'")
    assert jrep[4].startswith("error index ") and \
        "needs a peptide (tryptic) index" in jrep[4]
    assert jrep[5] == ok + ok
    assert jrep[6] == "bye\n"


def test_serve_matches_jax(world, tmp_path, monkeypatch):
    jrep, jfiles = _drive(world, tmp_path, "jax", port=False)
    counts = _counting(monkeypatch)
    prep, pfiles = _drive(world, tmp_path, "port", port=True, counts=counts)
    _check(jrep, jfiles, prep, pfiles)
    # the second identical request built no analyser, loaded no table and
    # read no taxonomy
    first, second = counts["after_first"], counts["after_second"]
    assert first["analysers"] >= 1 and first["tables"] == 1
    assert first["taxonomies"] == 1
    assert second == first


def test_serve_mesh_matches_jax(world, tmp_path):
    """The same requests under ``--mesh 4`` (umgap_tpu over 4 of its
    virtual CPU devices, the port over 4 entries of the CPU)."""
    jrep, jfiles = _drive(world, tmp_path, "jax", port=False, mesh=4)
    prep, pfiles = _drive(world, tmp_path, "port", port=True, mesh=4)
    _check(jrep, jfiles, prep, pfiles)


def test_serve_loads_peptide_index_at_first_tryptic_request(
        world, tmp_path, monkeypatch):
    """No initial sample, data from a config dir with both families: the
    first request loads the taxonomy and the 9-mer index only, the first
    tryptic request the peptide index; the replies are umgap_tpu's."""
    r1, r2 = world["fq"]
    lines = [f"-t high-sensitivity -1 {r1} -2 {r2}",
             f"-t tryptic-sensitivity -1 {r1} -2 {r2}",
             f"-t tryptic-sensitivity -1 {r1} -2 {r2}"]
    replies = {}
    loaded = []
    real = ptable.load_table

    def spy(path, *a, **kw):
        loaded.append(os.path.basename(str(path)))
        return real(path, *a, **kw)

    for tag in ("jax", "port"):
        if tag == "port":
            monkeypatch.setattr(ptable, "load_table", spy)
        sock = str(tmp_path / f"{tag}.sock")
        svc = _Service(tag == "port", [
            "analyse", "--serve", sock, "-c", world["conf"],
            "--read-length", str(L), "--fgspp", "never"])
        replies[tag] = []
        for i, line in enumerate(lines):
            replies[tag].append(_request(sock, line))
            if tag == "port":
                assert loaded == (["ninemer.npz"] if i == 0
                                  else ["ninemer.npz", "tryptic.npz"])
        replies[tag].append(svc.stop(sock))
        assert svc.rc == 0
    assert replies["port"] == replies["jax"]
    assert replies["jax"][1] == replies["jax"][2]
    assert replies["jax"][1].count(">") == N_READS
    assert replies["jax"][0].count(">") == N_READS


def test_serve_argument_errors_match_jax(world, tmp_path):
    """Request lines the parser refuses: a missing value, an unknown
    token, an output without inputs; the service answers each with
    umgap_tpu's error line and keeps serving."""
    r1 = world["fq"][0]
    lines = ["-t", "--frobnicate x", f"-o {tmp_path / 'x.fa'}",
             f"-1 {r1} -o {tmp_path / 'a.fa'} -1 {r1}"]
    replies = {}
    for tag in ("jax", "port"):
        sock = str(tmp_path / f"{tag}.sock")
        svc = _Service(tag == "port", [
            "analyse", "--serve", sock, "--taxons", world["taxons"],
            "--index", world["index"], "--read-length", str(L)])
        replies[tag] = [_request(sock, line) for line in lines]
        replies[tag].append(svc.stop(sock))
        assert svc.rc == 0
    assert replies["port"] == replies["jax"]
    assert all(r.startswith("error ") for r in replies["jax"][:-1])
    assert replies["jax"][-1] == "bye\n"


def test_serve_shards_mesh_trace_matches_jax(world, tmp_path):
    """``--serve`` over a ``buildindex-dist`` artifact of the reads'
    proteins (4 shards) on a mesh of 2 (umgap_tpu's virtual CPU devices,
    the port's CPU entries), the port with ``--trace-dir`` too: the same
    replies, and the port's trace written when the service stops."""
    from umgap_tpu.index import distbuild as jdist

    tsv = tmp_path / "proteins.tsv"
    code = encoding.get_table(1)
    with open(tsv, "w") as f, open(world["fq"][0]) as fq:
        for i, line in enumerate(fq):
            if i % 4 != 1:
                continue
            for j, pep in enumerate(translate.translate_sequence(
                    line.strip(), translate.FRAME_NAMES, code)):
                for part in pep.split("*"):
                    if len(part) >= 9 and "X" not in part:
                        f.write(f"{IDS[(i // 4 + j) % 5]}\t{part}\n")
    work = tmp_path / "work"
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))  # drive's worker processes
    try:
        jdist.drive(str(work), str(tsv), world["taxons"], n_shards=4,
                    workers=1, layout="bucket64s")
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    r1, r2 = world["fq"]
    lines = [f"-t high-sensitivity -1 {r1} -2 {r2}",
             f"-t max-precision -1 {r1} -2 {r2} -o {{}}",
             f"-t high-sensitivity -1 {r1} -2 {r2}"]
    replies, files = {}, {}
    trace = tmp_path / "trace"
    for tag in ("jax", "port"):
        sock = str(tmp_path / f"{tag}.sock")
        argv = ["analyse", "--serve", sock, "--taxons", world["taxons"],
                "--shards", str(work), "--mesh", "2", "--read-length",
                str(L), "--fgspp", "never"]
        if tag == "port":
            argv += ["--trace-dir", str(trace)]
        svc = _Service(tag == "port", argv)
        out = tmp_path / f"{tag}.fa"
        replies[tag] = [_request(sock, line.format(out)) for line in lines]
        replies[tag].append(svc.stop(sock))
        assert svc.rc == 0
        files[tag] = out.read_bytes()
    assert replies["port"] == replies["jax"]
    assert replies["jax"][1] == f"ok {N_READS}\n"
    assert replies["jax"][0] == replies["jax"][2]
    assert replies["jax"][0].count(">") == N_READS
    assert files["port"] == files["jax"]
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(trace))


def test_serve_without_samples_or_flag_refuses():
    """Without ``--serve`` a run still needs a sample."""
    err = io.StringIO()
    old, sys.stderr = sys.stderr, err
    try:
        rc = pcli.main(["analyse", "--device", "cpu"], stdout=io.StringIO())
    finally:
        sys.stderr = old
    assert rc == 1 and "No samples given" in err.getvalue()
