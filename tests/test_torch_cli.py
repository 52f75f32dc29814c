"""``python -m umgap_tpu_torch analyse`` (on the CPU) writes the same bytes
as ``umgap_tpu analyse`` for the four 9-mer presets, on plain and
gzipped pairs, on reads that climb the width ladder and on multi-line
FASTQ (the Python tier), on a group past the top width (the exact host
route), through a mock FragGeneScan++ under the config dir, with the
data found by config-dir discovery (``-c``) and with ``-z``, and refuses
what it does not support yet instead of clipping or guessing."""

import gzip
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from umgap_tpu import ranks
from umgap_tpu.cli import main as jax_cli
from umgap_tpu.index.table import build_kmer_table
from umgap_tpu.ops import encoding as jenc
from umgap_tpu.ops import kmers as jkmers
from umgap_tpu.ops import translate as jtrans
from umgap_tpu.taxonomy import fixture_taxa
from umgap_tpu_torch.cli import main as port_cli
from umgap_tpu_torch.pipeline.fused import PRESETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L = 64


def _index(path, codes, lens):
    """A 9-mer index holding the reads' own k-mers (every other one),
    one taxon per (group, frame)."""
    n, E, W = codes.shape
    aa, pl = jtrans.translate6_batch(codes.reshape(n * E, W),
                                     lens.reshape(-1), jenc.get_table(1))
    hi, lo, v = (np.asarray(x) for x in jkmers.pack_windows_batch(aa, pl, 9))
    ids = np.array([2, 10239, 12884, 185751, 185752], np.int32)
    slot = (np.arange(n * E) // E)[:, None, None] + \
        np.arange(6)[None, :, None]
    keys, first = np.unique(jkmers.join_packed(hi[v], lo[v]),
                            return_index=True)
    vals = ids[(slot + 0 * v)[v][first] % 5]
    build_kmer_table(keys[::2], vals[::2], k=9).save(path)


def _write_fastq(paths, codes, lens, lines=1):
    """R1/R2 FASTQ of the code rows, the sequence and quality split over
    ``lines`` lines (1: strict 4-line records)."""
    for e, path in enumerate(paths):
        with open(path, "w") as f:
            for i in range(len(codes)):
                seq = jenc.decode_dna(codes[i, e, : lens[i, e]])
                cut = -(-len(seq) // lines) if seq else 1
                sl = [seq[j:j + cut] for j in range(0, len(seq), cut)]
                f.write(f"@read{i}/{e + 1}\n" + "".join(
                    x + "\n" for x in sl) + "+\n" + "".join(
                    "I" * len(x) + "\n" for x in sl))


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A paired FASTQ sample (varied lengths, odd ones and N bases
    included), the fixture taxonomy as a TSV and a 9-mer index holding
    the reads' own k-mers, one taxon per (group, frame); the pairs also
    gzipped."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(11)
    n = 90
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lens = rng.integers(10, L + 1, size=(n, 2)).astype(np.int32)
    index = tmp / "ninemer.npz"
    _index(index, codes, lens)
    taxons = tmp / "taxons.tsv"
    with open(taxons, "w") as f:
        for t in fixture_taxa():
            valid = "\x01" if t.valid else "\x00"
            f.write(f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t"
                    f"{t.parent}\t{valid}\n")
    fq = [tmp / "R1.fq", tmp / "R2.fq"]
    _write_fastq(fq, codes, lens)
    gz = [tmp / "R1.fq.gz", tmp / "R2.fq.gz"]
    for src, dst in zip(fq, gz):
        with gzip.open(dst, "wb") as f:
            f.write(src.read_bytes())

    def argv(out_dir, tag):
        args = ["analyse", "--taxons", str(taxons), "--index", str(index),
                "--batch-size", "64", "--read-length", str(L)]
        for p in PRESETS:
            for kind, (r1, r2) in (("", fq), ("gz-", gz)):
                args += ["-t", p, "-1", str(r1), "-2", str(r2), "-o",
                         str(out_dir / f"{tag}-{kind}{p}.fa")]
        return args

    assert jax_cli(argv(tmp, "jax") + ["--fgspp", "never"],
                   stdin=io.StringIO(""), stdout=io.StringIO()) == 0
    assert port_cli(argv(tmp, "port") + ["--device", "cpu"]) == 0
    return dict(tmp=tmp, fq=fq, gz=gz, taxons=taxons, index=index, n=n)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_cli_output_byte_equal(sample, preset):
    want = (sample["tmp"] / f"jax-{preset}.fa").read_bytes()
    got = (sample["tmp"] / f"port-{preset}.fa").read_bytes()
    assert got == want
    assert got.count(b">") == sample["n"]


@pytest.mark.parametrize("preset", list(PRESETS))
def test_cli_gzip_byte_equal(sample, preset):
    """Gzipped pairs (the ring tier reads them through zlib) give the
    JAX package's bytes, and the plain pairs' bytes."""
    got = (sample["tmp"] / f"port-gz-{preset}.fa").read_bytes()
    assert got == (sample["tmp"] / f"jax-gz-{preset}.fa").read_bytes()
    assert got == (sample["tmp"] / f"port-{preset}.fa").read_bytes()


def _both(argv):
    """The same analyse command through umgap_tpu and the port, both with
    VERBOSE=1 (their notes are written only then); returns the port's
    stderr."""
    jargs = [a.replace("{tag}", "jax") for a in argv]
    pargs = [a.replace("{tag}", "port") for a in argv]
    err = io.StringIO()
    old = sys.stderr
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VERBOSE", "1")
        assert jax_cli(jargs + ["--fgspp", "never"], stdin=io.StringIO(""),
                       stdout=io.StringIO()) == 0
        sys.stderr = err
        try:
            assert port_cli(pargs + ["--device", "cpu"]) == 0
        finally:
            sys.stderr = old
    return err.getvalue()


@pytest.fixture(scope="module")
def ladder(sample, tmp_path_factory):
    """Three paired samples at --read-length 64 whose longest records
    (200, 500 and 600 bp) need the ladder's rungs 256, 512 and 1,024,
    through one command, against one index of their reads."""
    tmp = tmp_path_factory.mktemp("ladder")
    rng = np.random.default_rng(12)
    n, W = 24, 600
    tops = (200, 500, 600)
    codes = rng.integers(0, 4, size=(3 * n, 2, W)).astype(np.uint8)
    lens = np.concatenate([rng.integers(20, t + 1, size=(n, 2))
                           for t in tops]).astype(np.int32)
    lens[::n, 0] = tops
    index = tmp / "ninemer.npz"
    _index(index, codes, lens)
    argv = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(index), "--batch-size", "64", "--read-length", str(L)]
    for s, top in enumerate(tops):
        fq = [tmp / f"L{top}_R1.fq", tmp / f"L{top}_R2.fq"]
        _write_fastq(fq, codes[s * n:(s + 1) * n], lens[s * n:(s + 1) * n])
        argv += ["-t", "high-sensitivity", "-1", str(fq[0]), "-2",
                 str(fq[1]), "-o", str(tmp / f"{{tag}}-{top}.fa")]
    err = _both(argv)
    return dict(tmp=tmp, tops=tops, n=n, err=err)


@pytest.mark.parametrize("top", [200, 500, 600])
def test_cli_ladder_byte_equal(ladder, top):
    """Records longer than --read-length climb the width ladder (never
    clipped), after the ring tier hands the sample on and says why."""
    got = (ladder["tmp"] / f"port-{top}.fa").read_bytes()
    assert got == (ladder["tmp"] / f"jax-{top}.fa").read_bytes()
    assert got.count(b">") == ladder["n"]
    assert "run_sample_ring hands the sample on" in ladder["err"]
    assert f"{top} bp is longer than --read-length {L}" in ladder["err"]


def test_cli_multiline_fastq_byte_equal(sample, tmp_path):
    """Multi-line FASTQ records: both native tiers hand the sample on
    (StreamUnsupported) and the Python tier gives the JAX package's
    bytes."""
    rng = np.random.default_rng(13)
    n = 40
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    lens = rng.integers(20, L + 1, size=(n, 2)).astype(np.int32)
    fq = [tmp_path / "M1.fq", tmp_path / "M2.fq"]
    _write_fastq(fq, codes, lens, lines=3)
    assert fq[0].read_text().count("\n") > 4 * n
    argv = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "--batch-size", "64", "--read-length",
            str(L), "-t", "max-sensitivity", "-1", str(fq[0]), "-2",
            str(fq[1]), "-o", str(tmp_path / "{tag}.fa")]
    err = _both(argv)
    got = (tmp_path / "port.fa").read_bytes()
    assert got == (tmp_path / "jax.fa").read_bytes()
    assert got.count(b">") == n
    for tier in ("run_sample_ring", "run_sample_stream"):
        assert f"{tier} hands the sample on" in err


def _port(sample, *extra, reads=None):
    r1, r2 = reads or sample["fq"]
    err = io.StringIO()
    args = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "-1", str(r1), "-2", str(r2),
            "--read-length", str(L), *extra]
    old = sys.stderr
    sys.stderr = err
    try:
        rc = port_cli(args, stdout=io.StringIO())
    finally:
        sys.stderr = old
    return rc, err.getvalue()


def _stderr_runs(sample, tmp):
    """Three runs whose notes differ: the sample under two presets (one
    analyser each), a pair whose records climb the width ladder (the
    ring tier hands it on, a second analyser) and a pair with a group
    beyond the top width (the exact host route); as argv with {tag}."""
    rng = np.random.default_rng(17)
    ladder = [tmp / "lad_R1.fq", tmp / "lad_R2.fq"]
    _write_fastq(ladder, rng.integers(0, 4, size=(40, 2, 300)).astype(
        np.uint8), rng.integers(20, 300, size=(40, 2)).astype(np.int32))
    long = [tmp / "long_R1.fq", tmp / "long_R2.fq"]
    seq = "ACGT" * 1025
    for path in long:
        path.write_text(f"@x/1\n{seq}\n+\n{'I' * len(seq)}\n@y/1\n"
                        f"{seq[:40]}\n+\n{'I' * 40}\n")
    base = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "--batch-size", "64", "--read-length",
            str(L)]
    r1, r2 = sample["fq"]
    runs = [base + ["-t", "high-sensitivity", "-1", str(r1), "-2", str(r2),
                    "-o", str(tmp / "{tag}-a.fa"), "-t", "max-precision",
                    "-1", str(r1), "-2", str(r2), "-o",
                    str(tmp / "{tag}-b.fa")]]
    for name, (f1, f2) in (("ladder", ladder), ("long", long)):
        runs.append(base + ["-1", str(f1), "-2", str(f2), "-o",
                            str(tmp / f"{{tag}}-{name}.fa")])
    return runs


def _stderr_both(argv):
    """stderr of ``umgap_tpu analyse`` and of the port's on ``argv``."""
    jerr, perr = io.StringIO(), io.StringIO()
    old = sys.stderr
    try:
        sys.stderr = jerr
        assert jax_cli([a.replace("{tag}", "jax") for a in argv]
                       + ["--fgspp", "never"], stdin=io.StringIO(""),
                       stdout=io.StringIO()) == 0
        sys.stderr = perr
        assert port_cli([a.replace("{tag}", "port") for a in argv]
                        + ["--device", "cpu"]) == 0
    finally:
        sys.stderr = old
    return jerr.getvalue(), perr.getvalue()


def test_cli_stderr_quiet_equals_jax(sample, tmp_path, monkeypatch):
    """Without VERBOSE or DEBUG the port writes to stderr what umgap_tpu
    analyse writes, byte for byte (here nothing), also where a tier
    hands the sample on and where a group takes the exact host route."""
    monkeypatch.delenv("VERBOSE", raising=False)
    monkeypatch.delenv("DEBUG", raising=False)
    for argv in _stderr_runs(sample, tmp_path):
        jerr, perr = _stderr_both(argv)
        assert perr == jerr


def _notes(text, drop_hand_on=False):
    """The VERBOSE notes of a run with their clock stamps and measured
    numbers taken out (timings, records/s); with ``drop_hand_on``
    without the port's own notes that a tier hands the sample on."""
    out = []
    for line in text.splitlines():
        if drop_hand_on and " hands the sample on: " in line:
            continue
        line = re.sub(r"^\[\d\d:\d\d:\d\d\] ", "", line)
        line = re.sub(r" *\d+\.\d+", " #", line)
        out.append(re.sub(r"\(\d+ records/s\)", "(# records/s)", line))
    return out


def test_cli_stderr_verbose_holds_jax_notes(sample, tmp_path, monkeypatch):
    """With VERBOSE=1 the port writes umgap_tpu analyse's notes, in its
    order: each analyser's "ready" line, the stream timings by stage
    (device_state_load, dispatch, materialize) at each drain, the exact
    host route and each sample's records/s; beside them it says when a
    tier hands the sample on."""
    monkeypatch.setenv("VERBOSE", "1")
    monkeypatch.delenv("DEBUG", raising=False)
    for argv in _stderr_runs(sample, tmp_path):
        jerr, perr = _stderr_both(argv)
        assert _notes(perr, drop_hand_on=True) == _notes(jerr)
        assert "stream timings:" in perr or "exact host path" in perr
        assert re.search(r"analyse sample 1: \d+ records in ", perr)
    assert "run_sample_ring hands the sample on" in perr
    assert "ms/call" in _stderr_both(_stderr_runs(sample, tmp_path)[0])[1]


@pytest.mark.parametrize("env", [{}, {"VERBOSE": "1"}, {"VERBOSE": "0"},
                                 {"VERBOSE": "false"}, {"DEBUG": "yes"},
                                 {"VERBOSE": "", "DEBUG": "False"}])
def test_logging_gates_as_jax(env, monkeypatch, capsys):
    """log / verbose / debug write what umgap_tpu's do under each
    VERBOSE / DEBUG setting (clock stamps aside); the stage timer's
    report is umgap_tpu's, line for line."""
    from umgap_tpu import utils as jutils
    from umgap_tpu_torch import utils as putils

    for var in ("VERBOSE", "DEBUG"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    out = []
    for mod in (jutils, putils):
        mod.log("a")
        mod.verbose("b")
        mod.debug("c")
        out.append(re.sub(r"\d\d:\d\d:\d\d", "T", capsys.readouterr().err))
    assert out[0] == out[1]
    timers = [mod.StageTimer() for mod in (jutils, putils)]
    for t in timers:
        for name, dt in (("dispatch", 0.5), ("materialize", 0.25),
                         ("dispatch", 0.125)):
            t.totals[name] = t.totals.get(name, 0.0) + dt
            t.counts[name] = t.counts.get(name, 0) + 1
    assert timers[0].report() == timers[1].report()


def test_cli_refuses_unsupported_input(sample, tmp_path):
    # a group beyond the top width 4,096 is never clipped: it takes the
    # exact host route, as in umgap_tpu
    long_fq = [tmp_path / "long_R1.fq", tmp_path / "long_R2.fq"]
    seq = "ACGT" * 1025
    for path in long_fq:
        path.write_text(f"@x/1\n{seq}\n+\n{'I' * len(seq)}\n@y/1\n"
                        f"{seq[:40]}\n+\n{'I' * 40}\n")
    argv = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "-1", str(long_fq[0]), "-2",
            str(long_fq[1]), "--read-length", str(L), "-o",
            str(tmp_path / "{tag}.fa")]
    err = _both(argv)
    assert "1 record group(s) beyond 4096 bp: exact host path" in err
    got = (tmp_path / "port.fa").read_bytes()
    assert got == (tmp_path / "jax.fa").read_bytes()
    assert got.count(b">") == 2
    # a tryptic preset needs a peptide index: the 9-mer one is refused
    rc, err = _port(sample, "--device", "cpu", "-t", "tryptic-sensitivity")
    assert rc == 1 and "needs a peptide (tryptic) index" in err
    # a mesh of no device is refused; --mesh 2 on the CPU is a mesh of
    # two CPU entries and gives the records of the run without --mesh
    # (past the visible cards on CUDA it is refused:
    # tests/test_torch_mesh.py)
    rc, err = _port(sample, "--device", "cpu", "--mesh", "0")
    assert rc == 1 and "--mesh 0" in err
    for tag, extra in (("mesh", ["--mesh", "2"]), ("one", [])):
        rc, err = _port(sample, "--device", "cpu", "-o",
                        str(tmp_path / f"{tag}.fa"), *extra)
        assert rc == 0, err
    assert (tmp_path / "mesh.fa").read_bytes() == \
        (tmp_path / "one.fa").read_bytes()


def test_cli_module_entry_without_card_fails(sample):
    """``python -m umgap_tpu_torch`` with no visible card and no --device
    exits non-zero and says how to ask for the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "umgap_tpu_torch", "analyse", "--taxons",
         str(sample["taxons"]), "--index", str(sample["index"]), "-1",
         str(sample["fq"][0]), "-2", str(sample["fq"][1])],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# chip_smoke.py's mock FGSpp: frame 1 of each strand split at stops,
# stretches of 20 residues or more as genes (0 to a few a read)
MOCK_FGSPP = _smoke().MOCK_FGSPP


def _install_fgspp(conf, text=MOCK_FGSPP):
    """An executable FGSpp (the mock by default) and its train/ dir under
    the config dir ``conf``; returns the binary's path."""
    d = conf / "FGSpp"
    (d / "train").mkdir(parents=True)
    (d / "FGSpp").write_text(text)
    (d / "FGSpp").chmod(0o755)
    return str(d / "FGSpp")


def _config_home(tmp_path, monkeypatch, with_fgspp):
    """XDG_CONFIG_HOME at tmp_path, with the mock FGSpp installed under
    its config dir (unipept/FGSpp/FGSpp + train/) or with none."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    if with_fgspp:
        return _install_fgspp(tmp_path / "unipept")
    return None


def _analyse_both(sample, tmp_path, preset, *flags):
    """``analyse -t preset`` through umgap_tpu and the port with the same
    flags and no --fgspp of their own; returns (port rc, port stderr,
    port bytes, umgap_tpu bytes)."""
    argv = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "-t", preset, "-1", str(sample["fq"][0]),
            "-2", str(sample["fq"][1]), "--read-length", str(L), *flags,
            "-o"]
    assert jax_cli(argv + [str(tmp_path / "jax.fa")], stdin=io.StringIO(""),
                   stdout=io.StringIO()) == 0
    err = io.StringIO()
    old = sys.stderr
    sys.stderr = err
    try:
        rc = port_cli(argv + [str(tmp_path / "port.fa"), "--device", "cpu"])
    finally:
        sys.stderr = old
    port = tmp_path / "port.fa"
    return (rc, err.getvalue(), port.read_bytes() if port.exists() else None,
            (tmp_path / "jax.fa").read_bytes())


def test_cli_fgspp_auto_without_fgspp_matches_jax(sample, tmp_path,
                                                  monkeypatch):
    """``--fgspp auto``, the default of both, with no FGSpp under the
    config dir: high-precision translates six frames in both, byte for
    byte."""
    _config_home(tmp_path, monkeypatch, with_fgspp=False)
    rc, _err, got, want = _analyse_both(sample, tmp_path, "high-precision")
    assert rc == 0 and got == want
    assert got.count(b">") == sample["n"]


@pytest.fixture(scope="module")
def fgspp_sample(sample, tmp_path_factory):
    """Pairs of 20-150 bp (N bases among them) whose frame-1 translations
    hold stretches the mock takes for genes, a 9-mer index of their own
    k-mers, a peptide index of most of the mock's genes' tryptic
    fragments (one taxon a pair), and a config dir holding both in a
    data version (symlinks, as umgap-setup lays them out)."""
    tmp = tmp_path_factory.mktemp("fgspp")
    rng = np.random.default_rng(21)
    n, W = 48, 150
    codes = rng.integers(0, 4, size=(n, 2, W)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.005] = 4
    lens = rng.integers(20, W + 1, size=(n, 2)).astype(np.int32)
    fq = [tmp / "F1.fq", tmp / "F2.fq"]
    _write_fastq(fq, codes, lens)
    index = tmp / "ninemer.npz"
    _index(index, codes, lens)
    from umgap_tpu import fgspp as jfgspp
    from umgap_tpu.index.table import PeptideTable

    binary = _install_fgspp(tmp / "mock")
    records = [(f"read{i}/{e + 1}", jenc.decode_dna(codes[i, e, :lens[i, e]]))
               for i in range(n) for e in (0, 1)]
    ids = [2, 10239, 12884, 185751, 185752]
    owner = {}
    for h, prot in jfgspp.predict_genes(binary, str(tmp / "mock" / "FGSpp"
                                                    / "train"), records):
        for f in jkmers.tryptic_digest(prot):
            if 9 <= len(f) <= 45 and hash(f) % 5:
                owner.setdefault(f, ids[int(h[4:h.index("/")]) % 5])
    peps = sorted(owner)
    pindex = tmp / "tryptic.npz"
    PeptideTable.build(peps, np.array([owner[p] for p in peps],
                                      np.int32)).save(str(pindex))
    confs = {}
    for with_fgspp in (False, True):
        conf = tmp / f"conf-{with_fgspp}"
        (conf / "2026-08").mkdir(parents=True)
        for name, target in (("taxons.tsv", sample["taxons"]),
                             ("ninemer.npz", index),
                             ("tryptic.npz", pindex)):
            os.symlink(target, conf / "2026-08" / name)
        # an older version and a stray entry lose to 2026-08
        (conf / "2020-01").mkdir()
        os.symlink(sample["index"], conf / "2020-01" / "ninemer.npz")
        (conf / "notes").mkdir()
        if with_fgspp:
            _install_fgspp(conf)
        confs[with_fgspp] = conf
    return dict(fq=fq, n=n, index=index, pindex=pindex, confs=confs,
                taxons=sample["taxons"])


def _run_both(argv, tmp_path, env_home=None, monkeypatch=None):
    """``argv`` (with {tag}) through umgap_tpu and the port (on the CPU);
    returns (umgap_tpu rc, port rc, port stderr)."""
    jerr, perr = io.StringIO(), io.StringIO()
    old = sys.stderr
    try:
        sys.stderr = jerr
        jrc = jax_cli([a.replace("{tag}", "jax") for a in argv],
                      stdin=io.StringIO(""), stdout=io.StringIO())
        sys.stderr = perr
        prc = port_cli([a.replace("{tag}", "port") for a in argv]
                       + ["--device", "cpu"])
    finally:
        sys.stderr = old
    return jrc, prc, jerr.getvalue(), perr.getvalue()


@pytest.mark.parametrize("preset", ["high-precision", "max-precision",
                                    "tryptic-precision"])
@pytest.mark.parametrize("mode", ["auto", "require"])
def test_cli_fgspp_found_matches_jax(fgspp_sample, tmp_path, monkeypatch,
                                     mode, preset):
    """With the mock FGSpp under the config dir (XDG_CONFIG_HOME), both
    send the preset's reads through it, under the default auto and under
    require, and write the same bytes: a record for each pair the mock
    predicts a gene for (said on stderr under VERBOSE)."""
    monkeypatch.setenv("VERBOSE", "1")
    _config_home(tmp_path, monkeypatch, with_fgspp=True)
    s = fgspp_sample
    index = s["pindex"] if "tryptic" in preset else s["index"]
    argv = ["analyse", "--taxons", str(s["taxons"]), "--index", str(index),
            "-t", preset, "-1", str(s["fq"][0]), "-2", str(s["fq"][1]),
            *(["--fgspp", mode] if mode == "require" else []),
            "-o", str(tmp_path / "{tag}.fa")]
    jrc, prc, _jerr, perr = _run_both(argv, tmp_path)
    assert jrc == prc == 0
    assert "gene prediction via FGSpp" in perr
    got = (tmp_path / "port.fa").read_bytes()
    assert got == (tmp_path / "jax.fa").read_bytes()
    records = got.split(b"\n")[1::2]
    assert 0 < len(records) < s["n"]  # pairs without a gene give none
    if preset != "max-precision":
        assert any(t != b"1" for t in records)


def test_cli_fgspp_failing_exits_1(fgspp_sample, tmp_path, monkeypatch):
    """An FGSpp that exits non-zero ends the run with exit 1 and its
    status; nothing falls back to six frames."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    _install_fgspp(tmp_path / "unipept",
                   "#!/bin/sh\ncat > /dev/null\nexit 3\n")
    s = fgspp_sample
    err = io.StringIO()
    old = sys.stderr
    sys.stderr = err
    try:
        rc = port_cli(["analyse", "--taxons", str(s["taxons"]), "--index",
                       str(s["index"]), "-1", str(s["fq"][0]), "-2",
                       str(s["fq"][1]), "-o", str(tmp_path / "out.fa"),
                       "--device", "cpu"])
    finally:
        sys.stderr = old
    assert rc == 1 and "FGSpp exited with status 3" in err.getvalue()
    assert (tmp_path / "out.fa").read_bytes() == b""


@pytest.mark.parametrize("with_fgspp", [False, True])
def test_cli_configdir_discovery_matches_jax(fgspp_sample, tmp_path,
                                             monkeypatch, with_fgspp):
    """``-c`` with no --taxons and no --index: the newest data version
    gives the taxonomy and each family's index, so one run mixes a 9-mer
    and a tryptic preset; FGSpp is found under the same dir (said on
    stderr under VERBOSE). Byte-equal to umgap_tpu, sample by sample."""
    monkeypatch.setenv("VERBOSE", "1")
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "elsewhere"))
    s = fgspp_sample
    argv = ["analyse", "-c", str(s["confs"][with_fgspp])]
    for preset in ("high-precision", "tryptic-precision"):
        argv += ["-t", preset, "-1", str(s["fq"][0]), "-2", str(s["fq"][1]),
                 "-o", str(tmp_path / f"{{tag}}-{preset}.fa")]
    jrc, prc, _jerr, perr = _run_both(argv, tmp_path)
    assert jrc == prc == 0
    assert ("gene prediction via FGSpp" in perr) == with_fgspp
    for preset in ("high-precision", "tryptic-precision"):
        got = (tmp_path / f"port-{preset}.fa").read_bytes()
        assert got == (tmp_path / f"jax-{preset}.fa").read_bytes()
        n = got.count(b">")
        assert (0 < n < s["n"]) if with_fgspp else n == s["n"]


def test_cli_configdir_no_version_exits_1(fgspp_sample, tmp_path):
    """A config dir with no data version for the family: both exit 1 with
    umgap_tpu's message, also when only the taxonomy is linked."""
    s = fgspp_sample
    (tmp_path / "conf" / "2026-08").mkdir(parents=True)
    os.symlink(s["taxons"], tmp_path / "conf" / "2026-08" / "taxons.tsv")
    for conf in (tmp_path / "none", tmp_path / "conf"):
        argv = ["analyse", "-c", str(conf), "-t", "high-sensitivity", "-1",
                str(s["fq"][0]), "-2", str(s["fq"][1]), "-o",
                str(tmp_path / "{tag}.fa")]
        jrc, prc, jerr, perr = _run_both(argv, tmp_path)
        assert jrc == prc == 1
        for err in (jerr, perr):
            assert "No data version found valid for all samples" in err


def test_configdir_matches_jax(tmp_path, monkeypatch):
    """The port's discovery against umgap_tpu.configdir: XDG and home
    fallbacks, and GNU sort -n order over version names (leading numbers,
    names without one first, links required)."""
    from umgap_tpu import configdir as jcfg
    from umgap_tpu_torch import configdir as pcfg

    home = tmp_path / "home"
    (home / ".config").mkdir(parents=True)
    monkeypatch.setenv("HOME", str(home))
    for xdg in (None, str(tmp_path / "x")):
        for var in ("XDG_CONFIG_HOME", "XDG_DATA_HOME"):
            if xdg is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, xdg)
        assert pcfg.default_config_dir() == jcfg.default_config_dir()
        assert pcfg.default_data_dir() == jcfg.default_data_dir()
    assert pcfg.system_config_dir() == jcfg.system_config_dir()
    conf = tmp_path / "conf"
    target = tmp_path / "f"
    target.write_text("x")
    names = ["2020-12-07", "9", "10", "abc", "2021.5", "-3", "zz"]
    assert pcfg.discover_version(str(conf)) is None
    conf.mkdir()
    for i, name in enumerate(names):
        (conf / name).mkdir()
        os.symlink(target, conf / name / "taxons.tsv")
        if i % 2:
            os.symlink(target, conf / name / "ninemer.npz")
        if i % 3 == 0:
            (conf / name / "tryptic.npz").write_text("a file, not a link")
    (conf / "3000").write_text("not a directory")
    for kw in ({}, {"ninemer": True}, {"tryptic": True},
               {"tryptic": True, "ninemer": True}):
        assert pcfg.discover_version(str(conf), **kw) == \
            jcfg.discover_version(str(conf), **kw)
    assert pcfg.discover_version(str(conf)) == "2021.5"
    assert pcfg.discover_version(str(conf), ninemer=True) == "9"
    assert pcfg.resolve("c", "v", "n") == jcfg.resolve("c", "v", "n")


def test_cli_compress_matches_jax(sample, tmp_path):
    """``-z`` gzips the next output only (each -o resets it): the
    gunzipped bytes equal umgap_tpu -z's, and the next sample is plain."""
    argv = ["analyse", "--taxons", str(sample["taxons"]), "--index",
            str(sample["index"]), "--read-length", str(L), "--fgspp",
            "never"]
    for preset, z in (("high-sensitivity", True), ("max-precision", False),
                      ("high-precision", True)):
        argv += ["-t", preset, "-1", str(sample["fq"][0]), "-2",
                 str(sample["fq"][1]), *(["-z"] if z else []), "-o",
                 str(tmp_path / f"{{tag}}-{preset}.fa")]
    jrc, prc, _jerr, _perr = _run_both(argv, tmp_path)
    assert jrc == prc == 0
    for preset, z in (("high-sensitivity", True), ("max-precision", False),
                      ("high-precision", True)):
        raw = [(tmp_path / f"{tag}-{preset}.fa").read_bytes()
               for tag in ("port", "jax")]
        assert (raw[0][:2] == b"\x1f\x8b") == z
        got, want = (gzip.decompress(r) if z else r for r in raw)
        assert got == want and got.count(b">") == sample["n"]
        assert got == (sample["tmp"] / f"jax-{preset}.fa").read_bytes()


def test_cli_fgspp_require_without_fgspp_refuses(sample, tmp_path,
                                                 monkeypatch):
    _config_home(tmp_path, monkeypatch, with_fgspp=False)
    rc, err = _port(sample, "--device", "cpu", "-t", "high-precision",
                    "--fgspp", "require")
    assert rc == 1 and "FGSpp requested but not installed" in err


def test_cli_fgspp_other_presets_ignore_it(sample, tmp_path, monkeypatch):
    """high-sensitivity is not an FGSpp preset: with the mock installed,
    under auto and under require, both packages translate six frames and
    agree byte for byte."""
    _config_home(tmp_path, monkeypatch, with_fgspp=True)
    for flags in ((), ("--fgspp", "require")):
        rc, _err, got, want = _analyse_both(sample, tmp_path,
                                            "high-sensitivity", *flags)
        assert rc == 0 and got == want
        assert got.count(b">") == sample["n"]
