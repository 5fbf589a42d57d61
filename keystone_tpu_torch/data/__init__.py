"""Data plane: the Dataset abstraction, data loaders and the
compressed-resident COO tier (port of ``keystone_tpu/data/__init__.py``;
the out-of-core shard tier comes with a later slice)."""

from .dataset import Dataset, LabeledData, one_hot_pm1
from .resident import (
    COMPRESSED_BYTES_PER_NNZ,
    CompressedCOOChunks,
    compressible_dim,
    raw_chunk_tiles,
)

__all__ = [
    "COMPRESSED_BYTES_PER_NNZ", "CompressedCOOChunks", "Dataset", "LabeledData",
    "compressible_dim", "one_hot_pm1", "raw_chunk_tiles",
]
