"""FragGeneScan++ gene-prediction front end (an optional external binary;
the port's own copy of ``umgap_tpu``'s wrapper).

The reference's four precision presets pipe reads through FGSpp when it
is installed under the config dir (scripts/umgap-analyse.sh:248-251,
276-311). This wrapper runs the reference's exact command,
``<configdir>/FGSpp/FGSpp -s stdin -o stdout -w 0 -r
<configdir>/FGSpp/train -t illumina_10 -p 4 -c 2``, feeds the sample as
FASTA on its stdin and reads the predicted protein records from its
stdout; :func:`group_genes` merges them into read groups for
:mod:`~umgap_tpu_torch.pipeline.proteins`. Without the binary the
presets translate six frames.
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Iterable, Iterator, List, Optional, Tuple

# Presets whose reference pipeline runs FGSpp (umgap-analyse.sh cases)
FGSPP_PRESETS = frozenset({
    "tryptic-sensitivity", "tryptic-precision",
    "high-precision", "max-precision",
})


def find_fgspp(configdir: str) -> Optional[Tuple[str, str]]:
    """(binary, train dir) when FGSpp is installed under the config dir
    the way umgap-setup lays it out; None otherwise."""
    binary = os.path.join(configdir, "FGSpp", "FGSpp")
    train = os.path.join(configdir, "FGSpp", "train")
    if os.path.isfile(binary) and os.access(binary, os.X_OK) \
            and os.path.isdir(train):
        return binary, train
    return None


def fgspp_command(binary: str, train: str, train_type: str = "illumina_10",
                  threads: int = 4, chunk: int = 2) -> List[str]:
    """The reference's exact invocation (umgap-analyse.sh:249-251)."""
    return [binary, "-s", "stdin", "-o", "stdout", "-w", "0",
            "-r", train, "-t", train_type, "-p", str(threads),
            "-c", str(chunk)]


def predict_genes(binary: str, train: str,
                  records: Iterable[Tuple[str, str]],
                  **kw) -> Iterator[Tuple[str, str]]:
    """Run reads through FGSpp: ``records`` are (header, dna) pairs
    (headers with their /1 or /2 end markers); yields (header, protein)
    gene records in FGSpp's output order. Reads without a predicted gene
    yield nothing, as in the reference, whose later stages see only the
    records FGSpp writes. A non-zero exit raises ``RuntimeError``."""
    proc = subprocess.Popen(
        fgspp_command(binary, train, **kw),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL)
    feed_error: List[BaseException] = []

    def feed():
        try:
            for header, dna in records:
                proc.stdin.write(f">{header}\n{dna}\n".encode())
        except BrokenPipeError:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised below
            feed_error.append(e)
        finally:
            # always close stdin: a reader error must end FGSpp's input,
            # or it (and so this generator) would wait forever
            try:
                proc.stdin.close()
            except OSError:
                pass

    writer = threading.Thread(target=feed, daemon=True)
    writer.start()
    header = None
    seq: List[str] = []
    done = False
    try:
        for raw in proc.stdout:
            line = raw.decode().rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(seq)
                header = line[1:]
                seq = []
            elif header is not None:
                seq.append(line)
        if header is not None:
            yield header, "".join(seq)
        done = True
    finally:
        if not done:
            # the consumer abandoned the generator (a later error, or
            # GeneratorExit): end FGSpp so neither it nor the writer
            # thread lingers
            proc.kill()
        writer.join()
        proc.stdout.close()
        rc = proc.wait()
    if feed_error:
        raise feed_error[0]
    if rc != 0:
        raise RuntimeError(f"FGSpp exited with status {rc}")


def group_genes(records: Iterable[Tuple[str, str]], delimiter: str = "/"):
    """``uniq -d /`` over FGSpp's records: consecutive records whose
    header, cut at the delimiter (which drops FGSpp's _start_end_strand
    suffix with the end marker), agree merge into one (header, [proteins])
    group. A header without the delimiter (single-end input) keeps its
    suffix and merges with nothing, as the reference's ``uniq -d /``
    cuts only at '/' (umgap-analyse.sh:303)."""
    cur: Optional[str] = None
    seqs: List[str] = []
    for header, protein in records:
        idx = header.find(delimiter)
        key = header[:idx] if idx != -1 else header
        if cur is None:
            cur, seqs = key, [protein]
        elif key == cur:
            seqs.append(protein)
        else:
            yield cur, seqs
            cur, seqs = key, [protein]
    if cur is not None:
        yield cur, seqs
