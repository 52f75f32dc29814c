"""taxa2freq over the mesh: rank-snapped taxon counts a file, each device
counting its slice of the taxa over the whole taxon id space and the
devices' vectors summed on the first (a counterpart of
``umgap_tpu.parallel.freq``, whose devices merge with a ``psum``).

The CSV comes from :func:`format_freq_csv`, a copy of ``umgap_tpu``'s
host formatter (umgap_tpu/cli.py:344), so the mesh's output is that of
the host command byte for byte.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence

import numpy as np
import torch

from ..taxonomy import NONE, Taxonomy


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    return np.pad(x, (0, n - len(x)), constant_values=fill) \
        if len(x) < n else x


def sharded_rank_counts(tax: Taxonomy, rank: int,
                        files_taxa: Sequence[np.ndarray],
                        mesh) -> np.ndarray:
    """Rank-snapped taxa counted a file over the mesh
    (umgap_tpu/parallel/freq.py:32): ``files_taxa`` holds one int array
    of taxon ids a file. Returns (n_files, tax.size) int64 counts; column
    0 holds taxa that snap to nothing and taxa beyond the table, and
    negative taxa are not counted (taxa2freq.rs:154-169)."""
    from .sharded import split_to_mesh

    n = len(mesh)
    snapping = tax.filter_ancestors(tax.present & (tax.rank == rank))
    snaps = [torch.from_numpy(np.where(snapping == NONE, 0, snapping)).to(d)
             for d in mesh]
    size = tax.size
    out = np.zeros((len(files_taxa), size), dtype=np.int64)
    for i, taxa in enumerate(files_taxa):
        taxa = np.asarray(taxa, dtype=np.int64)
        padded = max(-(-len(taxa) // n) * n, n)
        t = _pad_to(np.clip(taxa, 0, size - 1), padded, 0)
        v = _pad_to((taxa >= 0) & (taxa < size), padded, False)
        counts = None
        for d, (td, vd) in enumerate(zip(split_to_mesh(t, mesh),
                                         split_to_mesh(v, mesh))):
            c = torch.bincount(torch.where(vd, snaps[d][td], 0),
                               weights=vd.to(torch.float64), minlength=size)
            counts = c if counts is None else counts + c.to(mesh[0])
        out[i] = counts.cpu().numpy().astype(np.int64)
        out[i, 0] += int((taxa >= size).sum())
    return out


def format_freq_csv(names: Mapping[int, str], counts, col_names,
                    min_frequency: int) -> str:
    """The taxa2freq CSV body (``umgap_tpu``'s ``format_freq_csv``,
    src/commands/taxa2freq.rs:104-149): the header, then the rows whose
    sum is above ``min_frequency``, by descending total (ties by
    ascending taxon id). ``names`` maps taxon ids to names."""
    out = ["taxon id,taxon name" + "".join("," + n for n in col_names)
           + "\n"]
    for tid, row in sorted(counts.items(), key=lambda p: (-sum(p[1]), p[0])):
        if tid not in names:
            raise ValueError("LCA taxon id not in taxon list. Check "
                             "compatibility with index.")
        if sum(row) > min_frequency:
            out.append(f"{tid},{names[tid]},"
                       + ",".join(str(c) for c in row) + "\n")
    return "".join(out)


def sharded_taxa2freq_csv(tax: Taxonomy, names: Mapping[int, str],
                          rank: int, files_taxa: Sequence[np.ndarray],
                          col_names: List[str], mesh,
                          min_frequency: int = 1) -> str:
    """taxa2freq over the mesh: :func:`sharded_rank_counts`, then the
    host's CSV (umgap_tpu/parallel/freq.py:87)."""
    mat = sharded_rank_counts(tax, rank, files_taxa, mesh)
    counts = {int(t): [int(mat[f, t]) for f in range(len(files_taxa))]
              for t in np.flatnonzero(mat.sum(axis=0))}
    return format_freq_csv(names, counts, col_names, min_frequency)
