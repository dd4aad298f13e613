"""Multi-GPU counting: one process over every local GPU, or the ranks of a
``torch.distributed`` group each over its share of its host's GPUs; a table
per device and one hash-sharded exchange."""

from .mesh import Mesh, init_distributed, make_mesh
from .sharded import CapacityOverflow, EpochShardedTable, ShardedTable, count_sharded

__all__ = [
    "CapacityOverflow",
    "EpochShardedTable",
    "Mesh",
    "ShardedTable",
    "count_sharded",
    "init_distributed",
    "make_mesh",
]
