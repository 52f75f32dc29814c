"""``python -m umgap_tpu_torch analyse``: the 9-mer preset pipelines on
the GPU, with the JAX CLI's flag names for the subset this port runs.

Output records are the same FASTA as ``umgap_tpu analyse`` (one
``>header`` / consensus-taxon record per read group, header stripped at
the paired-end delimiter, input order). The run is on the current CUDA
device unless ``--device`` says otherwise; without a card it fails and
says how to ask for the CPU.

Not in this port yet, each refused with a clear error rather than run
differently: records longer than ``--read-length`` (no length ladder or
long-read host route), gzipped input, FragGeneScan++ (the precision
presets always use six-frame translation, as ``--fgspp never``), the
tryptic presets, ``--mesh``, ``--shards`` and ``--serve``.
"""

from __future__ import annotations

import argparse
import sys

from .pipeline.fused import PRESETS

TRYPTIC_PRESETS = ("tryptic-sensitivity", "tryptic-precision")


class CliError(Exception):
    pass


class _SampleAction(argparse.Action):
    """Records option order so ``analyse`` can rebuild per-sample groups
    (umgap-analyse.sh's repeated -1/-2/-t/-o series)."""

    def __call__(self, parser, namespace, values, option_string=None):
        seq = getattr(namespace, "_sequence", None)
        if seq is None:
            seq = []
            setattr(namespace, "_sequence", seq)
        seq.append((self.dest, values))
        setattr(namespace, self.dest, values)


def _samples(args):
    """Each ``-o`` closes a sample and resets type and inputs to their
    defaults (umgap-analyse.sh:208-213); without ``-o`` the whole
    invocation is one stdout sample."""
    seq = getattr(args, "_sequence", []) or []
    samples = []
    fresh = dict(type="high-precision", first=None, second=None, output=None)
    cur = dict(fresh)
    for key, val in seq:
        if key == "output":
            if cur["first"] is None:
                raise CliError(
                    "Encountered an output file without input files.")
            cur["output"] = val
            samples.append(cur)
            cur = dict(fresh)
        else:
            cur[key] = val
    if cur["first"] is not None and not samples:
        samples.append(cur)
    elif cur["first"] is not None:
        raise CliError("Trailing input files without an output file.")
    if not samples:
        raise CliError("No samples given (need at least -1 <reads>).")
    return samples


class _Unsupported(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        raise CliError(f"{option_string} is not supported by umgap_tpu_torch "
                       "yet")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="umgap-tpu-torch",
        description="UMGAP analyse pipelines in PyTorch on an NVIDIA GPU")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("analyse", help="run a 9-mer preset pipeline")
    sp.add_argument("-t", "--type", action=_SampleAction,
                    default="high-precision",
                    choices=list(PRESETS) + list(TRYPTIC_PRESETS))
    sp.add_argument("-1", "--first", action=_SampleAction,
                    help="FASTQ end 1 (or single-end FASTA)")
    sp.add_argument("-2", "--second", action=_SampleAction, default=None,
                    help="FASTQ end 2")
    sp.add_argument("-o", "--output", action=_SampleAction, default=None,
                    help="output file ('-' = stdout); closes a sample group")
    sp.add_argument("--taxons", required=True, help="taxon TSV file")
    sp.add_argument("--index", required=True, help="9-mer index .npz")
    sp.add_argument("--batch-size", type=int, default=16384,
                    help="max read groups per device batch")
    sp.add_argument("--read-length", type=int, default=160,
                    help="device read width; longer records are refused")
    sp.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs the plain PyTorch path)")
    sp.add_argument("--fgspp", choices=["never", "auto", "require"],
                    default="never",
                    help="only 'never' (six-frame translation) is supported")
    for flag in ("--mesh", "--shards", "--serve"):
        sp.add_argument(flag, action=_Unsupported, nargs="?",
                        help=argparse.SUPPRESS)
    return p


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n within [lo, hi] (hi rounded down to a
    power of two), so tiny samples run small batches."""
    hi = max(lo, 1 << (max(hi, 1).bit_length() - 1))
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def cmd_analyse(args, stdout):
    import itertools

    from .index.table import load_table
    from .agg.device import DeviceTaxonomy
    from .device import resolve_device
    from .ops.lookup import DeviceTable
    from .pipeline.runner import (
        Analyser,
        encode_batch,
        read_groups_fasta,
        read_groups_fastq,
    )
    from .taxonomy import Taxonomy, read_taxa_file

    if args.fgspp != "never":
        raise CliError("FragGeneScan++ is not supported by umgap_tpu_torch "
                       "yet (use --fgspp never)")
    samples = _samples(args)
    for s in samples:
        if s["type"] in TRYPTIC_PRESETS:
            raise CliError(f"preset {s['type']} (tryptic) is not supported "
                           "by umgap_tpu_torch yet")
    device = resolve_device(args.device)
    tax = Taxonomy(read_taxa_file(args.taxons))
    table = load_table(args.index, mmap=True)
    dtax = DeviceTaxonomy.from_host(tax, device)
    dtable = DeviceTable.from_host(table, device)
    analysers: dict = {}

    for sample in samples:
        paired = bool(sample["second"])
        ends = 2 if paired else 1
        groups = (read_groups_fastq([sample["first"], sample["second"]])
                  if paired else read_groups_fasta(sample["first"]))
        L = args.read_length
        head = list(itertools.islice(groups, args.batch_size))
        B = (_pow2_bucket(len(head), 64, args.batch_size)
             if len(head) < args.batch_size else args.batch_size)
        key = (sample["type"], B, ends)
        an = analysers.get(key)
        if an is None:
            an = Analyser(tax, table, PRESETS[sample["type"]], batch_size=B,
                          read_length=L, ends=ends, dtax=dtax, dtable=dtable,
                          device=device)
            analysers[key] = an
        else:
            an.reset()

        def batches():
            chunk = head
            while chunk:
                dna, lens = encode_batch([g[1] for g in chunk], ends, L)
                yield from an.feed_batches([g[0] for g in chunk], dna, lens)
                chunk = list(itertools.islice(groups, B))
            yield from an.finish_batches()

        out = sample["output"]
        handle = stdout if out in (None, "-") else open(out, "w")
        try:
            for hs, ts in batches():
                handle.write("".join(
                    f">{h}\n{t}\n" for h, t in zip(hs, ts.tolist())))
        finally:
            if handle is not stdout:
                handle.close()


def main(argv=None, stdout=None) -> int:
    stdout = stdout if stdout is not None else sys.stdout
    try:
        args = build_parser().parse_args(argv)
        if args.command == "analyse":
            cmd_analyse(args, stdout)
    except BrokenPipeError:
        return 0
    except (CliError, ValueError, OSError, NotImplementedError,
            RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
