"""Sharded serving: hash-range shards of one index, the grouped table
and its analyser (:mod:`.sharded`) and the port's world of devices
(:mod:`.mesh`). The port serves on one device; the multi-rank mesh is
not ported yet."""

from .mesh import make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedTable,
    build_sharded_peptide_tables,
    build_sharded_tables,
    make_sharded_stream_analyser,
    owner_of,
)
