"""The reader of ``buildindex-dist`` artifacts (a counterpart of the
serving side of ``umgap_tpu.index.distbuild``).

A workdir holds ``manifest.json`` (``n_shards``, ``k``, ``layout``,
``capacity``, ``taxons``, ...) and ``shards/shard_{s:03d}.npz``: one
k-mer table a hash-range shard
(:func:`~umgap_tpu_torch.parallel.sharded.owner_of`), all of one
capacity, saved packed and uncompressed so that serving memory-maps
them. The build job itself (partition, join, build, repack, densify)
is ``umgap_tpu``'s and is not ported.
"""

from __future__ import annotations

import json
import os


class ShardArtifactError(ValueError):
    """A shard artifact is unreadable (truncated or corrupt): a
    ValueError, so the command line prints the remedy instead of a
    traceback."""


# slots a bucket row and probe rounds beyond the first of each layout
# the build writes; a shard writer stamps max(realized, PROBE_LIMITS)
# so that every shard of one layout shares one probe depth
BUCKETS = {"bucket64s": 64, "bucket64d": 64, "bucket16": 16, "bucket8s": 8}
PROBE_LIMITS = {"bucket64s": 0, "bucket64d": 1, "bucket16": 1, "bucket8s": 0}


def load_shards(workdir: str, mmap: bool = False):
    """The built shard tables of ``workdir``, in shard order, ready for
    :meth:`~umgap_tpu_torch.parallel.sharded.ShardedTable.from_shards`.
    ``mmap`` maps the rows instead of reading them."""
    from .table import load_table

    with open(os.path.join(workdir, "manifest.json")) as f:
        manifest = json.load(f)
    shards = []
    for s in range(manifest["n_shards"]):
        path = os.path.join(workdir, "shards", f"shard_{s:03d}.npz")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"shard artifact missing: {path} — the manifest names "
                f"{manifest['n_shards']} shards; re-run buildindex-dist "
                f"--workdir {workdir} to resume the build")
        try:
            shards.append(load_table(path, mmap=mmap))
        except Exception as e:
            raise ShardArtifactError(
                f"shard artifact unreadable (truncated or corrupt): "
                f"{path}: {e}; delete it and its .done marker, then "
                f"re-run buildindex-dist --workdir {workdir}") from e
    return shards
