"""Sharded serving over a mesh of devices: hash-range shards of one
index, the tables, the routing and the analysers (:mod:`.sharded`), the
mesh itself (:mod:`.mesh`: one process over a tuple of devices, or a
:class:`~.mesh.ProcessMesh` over several processes), processes across
hosts (:mod:`.multihost`, over ``torch.distributed``) and the mesh's
rank counts (:mod:`.freq`)."""

from .mesh import ProcessMesh, make_mesh  # noqa: F401
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
from .multihost import (  # noqa: F401
    allgather_taxa,
    flat_mesh,
    global_batch,
    init_distributed,
    make_multihost_pipeline,
    make_multihost_step,
    make_multihost_tryptic_pipeline,
    per_host_groups,
    pod_mesh,
)
from .freq import sharded_rank_counts, sharded_taxa2freq_csv  # noqa: F401
