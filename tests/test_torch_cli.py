"""``python -m umgap_tpu_torch analyse`` (on the CPU) writes the same bytes
as ``umgap_tpu analyse --fgspp never`` for the four 9-mer presets, and
refuses what it does not support yet instead of clipping or guessing."""

import gzip
import io
import os
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


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """A paired FASTQ sample (varied lengths, odd ones and N bases
    included), the fixture taxonomy as a TSV and a 9-mer index holding
    the reads' own k-mers, one taxon per (group, frame)."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(11)
    n = 90
    codes = rng.integers(0, 4, size=(n, 2, L)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    lens = rng.integers(10, L + 1, size=(n, 2)).astype(np.int32)
    aa, pl = jtrans.translate6_batch(codes.reshape(2 * n, L), lens.reshape(-1),
                                     jenc.get_table(1))
    hi, lo, v = (np.asarray(x) for x in jkmers.pack_windows_batch(aa, pl, 9))
    ids = np.array([2, 10239, 12884, 185751, 185752], np.int32)
    slot = (np.arange(2 * n) // 2)[:, None, None] + np.arange(6)[None, :, None]
    keys, first = np.unique(jkmers.join_packed(hi[v], lo[v]),
                            return_index=True)
    vals = ids[(slot + 0 * v)[v][first] % 5]
    index = tmp / "ninemer.npz"
    build_kmer_table(keys[::2], vals[::2], k=9).save(index)
    taxons = tmp / "taxons.tsv"
    with open(taxons, "w") as f:
        for t in fixture_taxa():
            valid = "\x01" if t.valid else "\x00"
            f.write(f"{t.id}\t{t.name}\t{ranks.rank_name(t.rank)}\t"
                    f"{t.parent}\t{valid}\n")
    fq = [tmp / "R1.fq", tmp / "R2.fq"]
    for e in (0, 1):
        with open(fq[e], "w") as f:
            for i in range(n):
                seq = jenc.decode_dna(codes[i, e, : lens[i, e]])
                f.write(f"@read{i}/{e + 1}\n{seq}\n+\n{'I' * len(seq)}\n")

    def argv(out_dir, tag):
        args = ["analyse", "--taxons", str(taxons), "--index", str(index),
                "--batch-size", "64", "--read-length", str(L)]
        for p in PRESETS:
            args += ["-t", p, "-1", str(fq[0]), "-2", str(fq[1]), "-o",
                     str(out_dir / f"{tag}-{p}.fa")]
        return args

    assert jax_cli(argv(tmp, "jax") + ["--fgspp", "never"],
                   stdin=io.StringIO(""), stdout=io.StringIO()) == 0
    assert port_cli(argv(tmp, "port") + ["--device", "cpu"]) == 0
    return dict(tmp=tmp, fq=fq, taxons=taxons, index=index, n=n)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_cli_output_byte_equal(sample, preset):
    want = (sample["tmp"] / f"jax-{preset}.fa").read_bytes()
    got = (sample["tmp"] / f"port-{preset}.fa").read_bytes()
    assert got == want
    assert got.count(b">") == sample["n"]


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


def test_cli_refuses_unsupported_input(sample, tmp_path):
    long_fq = tmp_path / "long.fq"
    seq = "ACGT" * 20  # 80 bp > --read-length 64: never clipped
    long_fq.write_text(f"@x/1\n{seq}\n+\n{'I' * len(seq)}\n")
    rc, err = _port(sample, "--device", "cpu", reads=(long_fq, long_fq))
    assert rc == 1 and "read-length" in err
    gz = tmp_path / "R1.fq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(sample["fq"][0].read_bytes())
    rc, err = _port(sample, "--device", "cpu", reads=(gz, sample["fq"][1]))
    assert rc == 1 and "gzip" in err
    rc, err = _port(sample, "--device", "cpu", "-t", "tryptic-sensitivity")
    assert rc == 1 and "tryptic" in err
    rc, err = _port(sample, "--device", "cpu", "--fgspp", "auto")
    assert rc == 1 and "FragGeneScan" in err
    rc, err = _port(sample, "--device", "cpu", "--mesh", "2")
    assert rc == 1 and "--mesh" in err


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
