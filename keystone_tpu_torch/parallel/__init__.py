"""Parallel substrate: device meshes, sharding helpers, linear algebra
(port of ``keystone_tpu/parallel/__init__.py``; one process or several)."""

from . import mesh
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedRows,
    default_mesh,
    init_distributed,
    make_hybrid_mesh,
    make_mesh,
    pad_rows,
    process_allgather,
    replicate,
    set_default_mesh,
    shard_local_rows,
    shard_rows,
    use_mesh,
)
