"""Multi-GPU counting: one process per device, rank-local tables and a
hash-sharded exchange (``torch.distributed``)."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharded import EpochShardedTable, ShardedTable, count_sharded

__all__ = [
    "EpochShardedTable",
    "Mesh",
    "ShardedTable",
    "count_sharded",
    "init_distributed",
    "make_mesh",
]
