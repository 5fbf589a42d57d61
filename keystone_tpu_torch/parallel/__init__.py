"""Parallel substrate: device meshes, sharding helpers, linear algebra
(port of ``keystone_tpu/parallel/__init__.py``; one host)."""

from . import mesh
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ShardedRows,
    default_mesh,
    make_mesh,
    pad_rows,
    replicate,
    set_default_mesh,
    shard_rows,
    use_mesh,
)
