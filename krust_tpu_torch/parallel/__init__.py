"""Multi-GPU counting: one process over every local GPU (or one process per
GPU, ``torch.distributed``), a table per device and a hash-sharded
exchange."""

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
