"""Data plane: the Dataset abstraction, data loaders, the
compressed-resident COO tier and the out-of-core shard and prefetch tier
(disk-backed Datasets streamed through the solvers), checksummed,
atomically written and retry-wrapped (port of
``keystone_tpu/data/__init__.py``)."""

from .dataset import Dataset, LabeledData, one_hot_pm1
from .durable import CheckpointSpec, ShardCorrupted
from .images import (
    EncodedImageSource,
    SyntheticEncodedImages,
    images_to_disk_shards,
    load_images,
)
from .prefetch import (
    COOShardSource,
    DenseShardSource,
    DenseShardView,
    PairedDenseSource,
    Prefetcher,
    PrefetchStats,
    ResidentDenseSource,
    ShardSource,
    iter_segments,
)
from .resident import (
    COMPRESSED_BYTES_PER_NNZ,
    CompressedCOOChunks,
    compressible_dim,
    raw_chunk_tiles,
)
from .runtime import DataPlaneRuntime, default_runtime
from .shards import DiskCOOShards, DiskDenseShards, DiskDenseShardWriter

__all__ = [
    "COMPRESSED_BYTES_PER_NNZ",
    "COOShardSource",
    "CheckpointSpec",
    "CompressedCOOChunks",
    "DataPlaneRuntime",
    "Dataset",
    "DenseShardSource",
    "DenseShardView",
    "DiskCOOShards",
    "DiskDenseShardWriter",
    "DiskDenseShards",
    "EncodedImageSource",
    "LabeledData",
    "PairedDenseSource",
    "PrefetchStats",
    "Prefetcher",
    "ResidentDenseSource",
    "ShardCorrupted",
    "ShardSource",
    "SyntheticEncodedImages",
    "compressible_dim",
    "default_runtime",
    "images_to_disk_shards",
    "iter_segments",
    "load_images",
    "one_hot_pm1",
    "raw_chunk_tiles",
]
