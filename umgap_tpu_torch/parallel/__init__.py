"""Sharded serving over a mesh of devices: hash-range shards of one
index, the tables, the routing and the analysers (:mod:`.sharded`), the
mesh itself (:mod:`.mesh`: one process over a tuple of devices) and the
mesh's rank counts (:mod:`.freq`)."""

from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedAnalyser,
    ShardedPipeline,
    ShardedTable,
    build_sharded_peptide_tables,
    build_sharded_tables,
    make_sharded_stream_analyser,
    owner_of,
    sharded_probe,
)
