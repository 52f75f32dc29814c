"""The port's native host ingest (``umgap_tpu_torch.io.native``, built from
``umgap_tpu_torch/native``) against the JAX package's: the chunked parser
with its width ladder, the ring of packed batches, the output formatter,
gzip; and the build, which lands in the port's ``_build/`` and leaves the
repository's ``native/`` untouched."""

import gzip
import hashlib
import io
import os
import shutil
import sys

import numpy as np
import pytest

from umgap_tpu.io import native as jnative
from umgap_tpu_torch.io import native
from umgap_tpu_torch.io import sniff_open
from umgap_tpu_torch.ops import encoding
from umgap_tpu_torch.pipeline import runner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library "
                                       "is unavailable")


def _seqs(rng, n, lo, hi):
    lut = np.frombuffer(b"ACGTNacgt", np.uint8)
    out = []
    for _ in range(n):
        m = int(rng.integers(lo, hi + 1))
        out.append(lut[rng.choice(9, size=m, p=[.22, .22, .22, .22, .04,
                                                .02, .02, .02, .02])]
                   .tobytes().decode())
    return out


def _fastq(path, seqs, tag="r", end=1, gz=False):
    text = "".join(f"@{tag}{i}/{end} x\n{s}\n+\n{'I' * len(s)}\n"
                   for i, s in enumerate(seqs))
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        f.write(text)
    return str(path)


def _fasta(path, seqs, wrap=None):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            lines = ([s[j:j + wrap] for j in range(0, len(s), wrap)]
                     if wrap and s else [s])
            f.write(f">{i} desc/1\n" + "".join(x + "\n" for x in lines))
    return str(path)


def _chunks_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert g[1].dtype == w[1].dtype and np.array_equal(g[1], w[1])
        assert np.array_equal(g[2], w[2])
        assert g[3] == w[3]
    return got


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(3)
    s1 = _seqs(rng, 300, 0, 170)
    s2 = _seqs(rng, 290, 1, 170)  # one file shorter: zip stops there
    return dict(
        tmp=tmp, s1=s1, s2=s2,
        r1=_fastq(tmp / "R1.fq", s1), r2=_fastq(tmp / "R2.fq", s2, end=2),
        g1=_fastq(tmp / "R1.fq.gz", s1, gz=True),
        g2=_fastq(tmp / "R2.fq.gz", s2, end=2, gz=True),
        fa=_fasta(tmp / "x.fa", s1, wrap=60))


@pytest.mark.parametrize("chunk_bytes", [100, 1 << 10, 1 << 22])
@pytest.mark.parametrize("kind", ["r1", "g1", "fa"])
def test_stream_parse_matches_jax(files, kind, chunk_bytes):
    """Headers, codes, lens and true_max of every chunk equal the JAX
    package's, plain and gzipped, FASTQ and wrapped FASTA, at chunk
    sizes that cut records apart."""
    fmt = "fasta" if kind == "fa" else "fastq"
    got = _chunks_equal(
        native.stream_parse(files[kind], fmt, 100, chunk_bytes),
        jnative.stream_parse(files[kind], fmt, 100, chunk_bytes))
    assert sum(len(c[0]) for c in got) == len(files["s1"])
    assert max(c[3] for c in got) > 100  # clipped rows report true_max


def test_stream_parse_gzip_equals_plain(files):
    plain = list(native.stream_parse(files["r1"], "fastq", 160, 777))
    _chunks_equal(native.stream_parse(files["g1"], "fastq", 160, 777),
                  plain)


@pytest.mark.parametrize("chunk_bytes", [60, 1 << 20])
def test_stream_parse_width_ladder(tmp_path, chunk_bytes):
    """A long record mid-stream bumps the code width to the smallest
    ladder entry that fits; later chunks stay wide; as the JAX
    package's (tests/test_streaming_cli.py's cases)."""
    p = _fasta(tmp_path / "x.fa", ["A" * 50, "C" * 50, "G" * 300, "T" * 40])
    ladder = [100, 256, 512]
    got = _chunks_equal(
        native.stream_parse(p, "fasta", 100, chunk_bytes,
                            width_ladder=ladder),
        jnative.stream_parse(p, "fasta", 100, chunk_bytes,
                             width_ladder=ladder))
    widths = [c[1].shape[-1] for c in got]
    assert widths == sorted(widths) and max(widths) == 512
    if chunk_bytes == 60:
        assert widths[0] == 100
    (_h, c, l, tmax), = list(native.stream_parse(
        _fasta(tmp_path / "y.fa", ["A" * 70, "C" * 10]), "fasta", 32))
    assert list(l) == [32, 10] and tmax == 70


def test_stream_parse_ladder_rungs(tmp_path):
    """Widths climb 64 -> 256 -> 512 -> 1,024 as longer reads appear,
    and records beyond the top rung stay clipped with their true_max."""
    seqs = ["A" * 60] * 3 + ["C" * 200] * 3 + ["G" * 500] * 3 + \
        ["T" * 600] * 3 + ["A" * 1500]
    p = _fastq(tmp_path / "l.fq", seqs)
    ladder = [64, 256, 512, 1024]
    got = _chunks_equal(
        native.stream_parse(p, "fastq", 64, 400, width_ladder=ladder),
        jnative.stream_parse(p, "fastq", 64, 400, width_ladder=ladder))
    widths = [c[1].shape[-1] for c in got]
    assert sorted(set(widths)) == ladder and widths == sorted(widths)
    assert got[-1][3] == 1500 and got[-1][2].max() == 1024


def test_stream_parse_multiline_fastq_unsupported(tmp_path):
    p = tmp_path / "m.fq"
    p.write_text("@r1\nACGT\nACGT\n+\nIIII\nIIII\n@r2\nAC\n+\nII\n")
    for mod in (native, jnative):
        with pytest.raises(mod.StreamUnsupported):
            list(mod.stream_parse(str(p), "fastq", 100))


def test_paired_chunks_match_jax(files):
    """stream_paired_chunks zips the two files (stopping at the shorter)
    with the JAX package's headers, codes and lengths."""
    from umgap_tpu.pipeline import runner as jrunner

    ladder = [100, 256]
    got = list(runner.stream_paired_chunks(
        files["g1"], files["r2"], 100, chunk_bytes=5000,
        width_ladder=ladder))
    want = list(jrunner.stream_paired_chunks(
        files["g1"], files["r2"], 100, chunk_bytes=5000,
        width_ladder=ladder))
    _chunks_equal(got, want)
    assert sum(len(c[0]) for c in got) == len(files["s2"])


def _ring(mod, files, r1, r2, fmt, L, B):
    s = mod.NativeBatchStream(r1, r2, fmt, L, B)
    try:
        return list(iter(s.next, None))
    finally:
        s.close()


@pytest.mark.parametrize("L,B", [(160, 64), (101, 7), (40, 300)])
def test_batch_stream_matches_jax(files, L, B):
    """The ring's batches (dna4, lens, header blob, offsets, true_max)
    equal the JAX package's, gzip and plain, and its dna4 equals
    pack_dna4 of the Python reader's codes, clipped at L."""
    got = _ring(native, files, files["g1"], files["r2"], "fastq", L, B)
    want = _ring(jnative, files, files["r1"], files["g2"], "fastq", L, B)
    assert len(got) == len(want) == -(-len(files["s2"]) // B)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3] and g[5] == w[5]
        for a, b in ((g[1], w[1]), (g[2], w[2]), (g[4], w[4])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    groups = list(runner.read_groups_fastq([files["g1"], files["r2"]]))
    dna = np.full((len(groups), 2, L), encoding.DNA_N, np.uint8)
    lens = np.zeros((len(groups), 2), np.int32)
    for i, (_h, seqs) in enumerate(groups):
        for e, sq in enumerate(seqs):
            c = encoding.encode_dna(sq.upper())[:L]
            dna[i, e, :len(c)] = c
            lens[i, e] = len(c)
    packed = encoding.pack_dna4(dna)
    for k, (n, d4, ln, blob, offs, tmax) in enumerate(got):
        rows = slice(k * B, k * B + n)
        assert np.array_equal(d4[:n], packed[rows])
        # padding rows read as N; row n may keep the end-1 read of a
        # group that the shorter file cut off (never analysed)
        assert (d4[n + 1:] == 0x44).all() and (ln[n + 1:] == 0).all()
        assert np.array_equal(ln[:n], lens[rows])
        hs = [blob[offs[i]:offs[i + 1]].decode() for i in range(n)]
        assert hs == [h for h, _ in groups[rows]]
        assert tmax == max(len(sq) for _h, ss in groups[rows] for sq in ss)


def test_batch_stream_fasta_and_multiline(files, tmp_path):
    got = _ring(native, files, files["fa"], None, "fasta", 120, 50)
    want = _ring(jnative, files, files["fa"], None, "fasta", 120, 50)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3] and g[5] == w[5]
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[4], w[4])
    p = tmp_path / "m.fq"
    p.write_text("@r1\nACGT\nACGT\n+\nIIII\nIIII\n")
    with pytest.raises(native.StreamUnsupported):
        _ring(native, files, str(p), str(p), "fastq", 100, 4)


def test_format_output_matches_jax():
    rng = np.random.default_rng(5)
    hs = [f"read{i}" * int(rng.integers(0, 3)) for i in range(500)]
    blob = "".join(hs).encode()
    offs = np.concatenate([[0], np.cumsum([len(h) for h in hs])])
    taxa = rng.integers(-5, 2 ** 31 - 1, size=500).astype(np.int32)
    taxa[:3] = (0, 1, -2 ** 31 + 1)
    got = native.format_output(blob, offs, taxa)
    assert got == jnative.format_output(blob, offs, taxa)
    assert got.decode() == "".join(f">{h}\n{t}\n" for h, t in
                                   zip(hs, taxa.tolist()))


def test_sniff_open_reads_gzip(files):
    with sniff_open(files["g1"]) as a, open(files["r1"]) as b:
        assert a.read() == b.read()


def _tree_digest(path):
    h = hashlib.sha256()
    for root, _dirs, names in sorted(os.walk(path)):
        for name in sorted(names):
            p = os.path.join(root, name)
            h.update(p.encode())
            with open(p, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_build_lands_in_port_build_dir(monkeypatch, tmp_path):
    """A fresh build of the sources compiles only the port's own files
    into its build directory, and the repository's native/ is left as it
    was."""
    repo_native = os.path.join(REPO, "native")
    before = _tree_digest(repo_native)
    out = native.lib_path()
    assert out.parent == native.PACKAGE / "_build"
    cmd = native.build_command(out)
    sources = [a for a in cmd if a.endswith(".cpp")]
    assert sorted(os.path.basename(s) for s in sources) == sorted(
        native.SOURCES)
    assert all(os.path.dirname(s) == str(native.PACKAGE / "native")
               for s in sources)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.ensure_built()
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [
        native.lib_path().name]
    assert _tree_digest(repo_native) == before


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile raises NativeBuildError carrying
    the compiler's message, and the CLI exits non-zero with it instead
    of switching to the Python reader."""
    src = tmp_path / "src"
    shutil.copytree(native.SOURCE_DIR, src)
    with open(src / "umgap_stream.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="umgap_stream.cpp"):
        native.ensure_built()

    from umgap_tpu_torch import ranks
    from umgap_tpu_torch.cli import main as port_cli
    from umgap_tpu_torch.index.table import build_kmer_table
    from umgap_tpu_torch.taxonomy import fixture_taxa

    taxons = tmp_path / "taxons.tsv"
    taxons.write_text("".join(
        f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t{t.parent}\t"
        f"{chr(1) if t.valid else chr(0)}\n" for t in fixture_taxa()))
    index = tmp_path / "nine.npz"
    build_kmer_table(np.arange(1, 50, dtype=np.uint64),
                     np.full(49, 2, np.int32), 9).save(index)
    fq = _fastq(tmp_path / "r.fq", ["ACGT" * 10])
    err, out = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    rc = port_cli(["analyse", "--taxons", str(taxons), "--index",
                   str(index), "-1", fq, "-2", fq, "--device", "cpu"],
                  stdout=out)
    assert rc == 1 and out.getvalue() == ""
    assert "building the host ingest library failed" in err.getvalue()
