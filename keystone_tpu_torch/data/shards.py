"""Disk-backed chunk shards for the streamed solvers (port of
``keystone_tpu/data/shards.py``, whole; the on-disk format is the
reference's, so a shard directory written by either package loads in the
other).

The reference streams from storage by construction (``CsvDataLoader`` is
a lazy ``textFile``, CsvDataLoader.scala:10-31; image loaders decode per
partition, ImageLoaderUtils.scala:21-94), so its fits are bounded by disk,
not RAM. Here pre-tiled shards live in ``.npy`` files, are opened
memory-mapped, and feed the segmented folds one segment at a time: peak
host residency is the page cache (evictable) plus a segment's copy
buffers, whatever the dataset's size.

Durability contract:

  - **Meta is written last, atomically** (temp name + ``os.replace``,
    arrays fsync'd first): a killed writer leaves a directory with no (or
    the previous) metadata, never one that parses as a valid but short
    dataset. Writers also delete stale metadata before touching array
    files.
  - **Per-tile/chunk checksums** ride in the metadata and are verified on
    every ``segment_source`` read: torn or bit-flipped bytes raise
    :class:`~keystone_tpu_torch.data.durable.ShardCorrupted` instead of
    feeding garbage into a fit. Directories written without them (no
    ``checksums`` key) still load, unverified.
  - **Retrying reads**: a transient ``OSError`` during a segment read is
    retried with bounded exponential backoff
    (:class:`~keystone_tpu_torch.utils.faults.RetryPolicy`); exhaustion
    re-raises. The ``shard.load`` fault site makes both paths testable.

A segment read returns views of the read-only memory map where no padding
is needed; consumers that hand a segment to torch copy it first
(``prefetch.stage_segment``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from keystone_tpu_torch.data.durable import (
    ShardCorrupted,
    atomic_write_json,
    checksum_algo,
    corrupted,
    crc_of_array,
    fsync_file,
    verify_array,
)
from keystone_tpu_torch.utils import faults

_META = "shards.json"
_FILES = {"indices": "indices.npy", "values": "values.npy", "labels": "labels.npy"}


def _chunk_checksums(arr, num: int) -> List[int]:
    """Per-leading-index digests of ``arr[:num]`` (one CRC per chunk or
    tile — the verification granularity of a segment read)."""
    return [int(crc_of_array(arr[i])) for i in range(num)]


def _read_verified(arr, lo: int, hi: int, *, what: str, key: str,
                   checksums: Optional[List[int]], algo: str,
                   retry) -> np.ndarray:
    """THE durable read protocol, shared by both shard formats: copy
    units [lo, hi) out of the mmap with transient-retry (recovered
    retries reported to the consuming fit's stats via
    ``faults.observe_retry``) and per-unit checksum verification. The
    ``shard.load`` fault site fires once per read attempt; corruption
    injections land AFTER the copy so the checksum layer (not the mmap)
    is what catches them."""
    def read():
        faults.maybe_fail(faults.SITE_SHARD_LOAD)
        return np.asarray(arr[lo:hi])

    seg = retry.call(
        read, key=key,
        on_retry=lambda _a, delay_s, _e: faults.observe_retry(delay_s),
    )
    seg = faults.corrupt_array(faults.SITE_SHARD_LOAD, seg)
    if checksums is not None:
        t0 = time.perf_counter()
        for i in range(lo, hi):
            verify_array(seg[i - lo], checksums[i], algo, f"{what} {i}")
        # The `verify` site of the per-site overlap report: CRC time is
        # attributed to the consuming fit through the same thread-local
        # observer the retry counters ride.
        faults.observe_busy("verify", time.perf_counter() - t0)
    return seg


# Write-path checksum convention: ingestion loops digest each tile/chunk
# from the memmap IMMEDIATELY after writing it — the pages are still
# dirty in the page cache, so the digest is a RAM-speed read of exactly
# the file's bytes, and sealing a multi-GB shard directory never has to
# read the dataset back off disk. The read-back in seal()/_final_meta
# remains only as the fallback for externally-filled memmaps
# (DiskCOOShards.create + caller fill), where write order is unknown.


def _meta_checksums(meta: dict) -> Tuple[Optional[Dict[str, List[int]]], str]:
    return meta.get("checksums"), meta.get("checksum_algo", "crc32")


class DiskCOOShards:
    """Pre-tiled padded-COO chunks on disk, mmap-read per segment.

    Layout on disk (one directory):
      indices.npy  (num_chunks, chunk_rows, w)  int16/int32  (-1 = inactive)
      values.npy   (num_chunks, chunk_rows, w)  f32/bf16-as-u16 is NOT used;
                   values keep their numpy dtype (float32 or float16-like)
      labels.npy   (num_chunks, chunk_rows, k)
      shards.json  {n_true, d, num_chunks, chunk_rows, checksum_algo,
                    checksums: {indices: [per chunk], values: [...],
                    labels: [...]}}

    ``write`` builds the files with ``open_memmap`` so the full dataset
    never needs to exist in RAM either at write time (callers may fill
    chunk ranges incrementally via the memmaps :meth:`create` returns —
    then :meth:`seal` computes the checksums and publishes the final
    metadata atomically; loading an unsealed directory raises
    :class:`ShardCorrupted`, never silently short data).
    """

    def __init__(self, directory: str, verify: bool = True,
                 retry_policy=None):
        self.directory = os.path.abspath(directory)
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        if meta.get("building"):
            raise corrupted(
                f"{self.directory}: shard directory was never sealed "
                f"(writer killed mid-build, or DiskCOOShards.seal() not "
                f"called after an incremental fill)"
            )
        self.n_true = int(meta["n_true"])
        self.d = int(meta["d"])
        self.num_chunks = int(meta["num_chunks"])
        self.chunk_rows = int(meta["chunk_rows"])
        self._checksums, self._algo = _meta_checksums(meta)
        if not verify:
            self._checksums = None
        self._retry = retry_policy or faults.default_retry_policy()
        self._idx = np.load(
            os.path.join(directory, _FILES["indices"]), mmap_mode="r"
        )
        self._val = np.load(
            os.path.join(directory, _FILES["values"]), mmap_mode="r"
        )
        self._y = np.load(
            os.path.join(directory, _FILES["labels"]), mmap_mode="r"
        )

    # ------------------------------------------------------------------
    @staticmethod
    def write(
        directory: str,
        indices: np.ndarray,
        values: np.ndarray,
        labels: np.ndarray,
        chunk_rows: int,
        n_true: int = None,
        d: int = None,
    ) -> "DiskCOOShards":
        """Tile row-major (n, w) COO + (n, k) labels into on-disk chunks.

        Rows past the last full chunk are padded with inactive (-1)
        lanes / zero labels. For datasets too big to hold even once,
        build the memmaps with :meth:`create`, fill ranges, then
        :meth:`seal`.
        """
        n, w = indices.shape
        k = labels.shape[1]
        n_true = n if n_true is None else int(n_true)
        d = int(indices.max()) + 1 if d is None else int(d)
        num_chunks = -(-n // chunk_rows)
        mm_i, mm_v, mm_y = DiskCOOShards.create(
            directory, num_chunks, chunk_rows, w, k,
            idx_dtype=indices.dtype, val_dtype=values.dtype,
            y_dtype=labels.dtype, n_true=n_true, d=d,
        )
        sums: Dict[str, List[int]] = {
            "indices": [], "values": [], "labels": []
        }
        for c in range(num_chunks):
            lo, hi = c * chunk_rows, min((c + 1) * chunk_rows, n)
            m = hi - lo
            mm_i[c, :m] = indices[lo:hi]
            mm_v[c, :m] = values[lo:hi]
            mm_y[c, :m] = labels[lo:hi]
            # Digest while the chunk's pages are hot (see convention
            # note above) — no read-back pass at seal time.
            sums["indices"].append(int(crc_of_array(mm_i[c])))
            sums["values"].append(int(crc_of_array(mm_v[c])))
            sums["labels"].append(int(crc_of_array(mm_y[c])))
        for mm in (mm_i, mm_v, mm_y):
            mm.flush()
        del mm_i, mm_v, mm_y
        return DiskCOOShards.seal(directory, _precomputed=sums)

    @staticmethod
    def create(
        directory: str,
        num_chunks: int,
        chunk_rows: int,
        w: int,
        k: int,
        idx_dtype=np.int32,
        val_dtype=np.float32,
        y_dtype=np.float32,
        n_true: int = 0,
        d: int = 0,
    ) -> Tuple[np.memmap, np.memmap, np.memmap]:
        """Allocate the on-disk chunk files and return writable memmaps
        (indices prefilled with -1, values/labels with 0). The metadata
        written here carries ``building: true`` — the directory will not
        LOAD until :meth:`seal` publishes the final meta (atomically,
        with checksums), so a writer killed mid-fill leaves a directory
        that fails loudly instead of parsing as short-but-valid data."""
        os.makedirs(directory, exist_ok=True)
        # Stale final meta from a previous complete build must not pair
        # with the new (partially filled) arrays.
        try:
            os.unlink(os.path.join(directory, _META))
        except OSError:
            pass
        shape2 = (num_chunks, chunk_rows)
        mm_i = np.lib.format.open_memmap(
            os.path.join(directory, _FILES["indices"]), mode="w+",
            dtype=idx_dtype, shape=shape2 + (w,),
        )
        mm_i[...] = -1
        mm_v = np.lib.format.open_memmap(
            os.path.join(directory, _FILES["values"]), mode="w+",
            dtype=val_dtype, shape=shape2 + (w,),
        )
        mm_y = np.lib.format.open_memmap(
            os.path.join(directory, _FILES["labels"]), mode="w+",
            dtype=y_dtype, shape=shape2 + (k,),
        )
        atomic_write_json(
            os.path.join(directory, _META),
            {"n_true": int(n_true), "d": int(d),
             "num_chunks": int(num_chunks),
             "chunk_rows": int(chunk_rows),
             "building": True},
        )
        return mm_i, mm_v, mm_y

    @staticmethod
    def seal(directory: str, _precomputed=None) -> "DiskCOOShards":
        """Finish a build: fsync the array files, compute per-chunk
        checksums (read-back — callers that filled the memmaps
        themselves are the only ones who must pay it; ``write`` digests
        during its fill and passes them in), and atomically replace the
        ``building`` metadata with the final one — meta last, so the
        directory becomes loadable only once everything it describes is
        durably on disk."""
        with open(os.path.join(directory, _META)) as f:
            meta = json.load(f)
        sums: Dict[str, List[int]] = {}
        for field, fname in _FILES.items():
            path = os.path.join(directory, fname)
            fsync_file(path)
            if _precomputed is not None:
                sums[field] = list(_precomputed[field])
            else:
                arr = np.load(path, mmap_mode="r")
                sums[field] = _chunk_checksums(arr, int(meta["num_chunks"]))
                del arr
        meta.pop("building", None)
        meta["checksum_algo"] = checksum_algo()
        meta["checksums"] = sums
        atomic_write_json(os.path.join(directory, _META), meta)
        return DiskCOOShards(directory)

    # ------------------------------------------------------------------
    def _read_chunks(self, arr, lo: int, hi: int, field: str) -> np.ndarray:
        return _read_verified(
            arr, lo, hi,
            what=f"{self.directory}/{_FILES[field]} chunk",
            key=f"{self.directory}:{field}:{lo}",
            checksums=(
                None if self._checksums is None
                else self._checksums.get(field)
            ),
            algo=self._algo, retry=self._retry,
        )

    def segment_source(self, cid0: int, seg: int):
        """The ``segment_source`` contract of ``run_lbfgs_gram_streamed``:
        materialize ONLY chunks [cid0, cid0+seg) as host arrays (phantom
        chunks past the end are inactive/-1 padded — the fold masks them
        by absolute id anyway)."""
        hi = min(cid0 + seg, self.num_chunks)
        idx = self._read_chunks(self._idx, cid0, hi, "indices")
        val = self._read_chunks(self._val, cid0, hi, "values")
        y = self._read_chunks(self._y, cid0, hi, "labels")
        pad = seg - (hi - cid0)
        if pad:
            idx = np.concatenate(
                [idx, np.full((pad,) + idx.shape[1:], -1, idx.dtype)]
            )
            val = np.concatenate(
                [val, np.zeros((pad,) + val.shape[1:], val.dtype)]
            )
            y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        return idx, val, y

    @property
    def is_memory_mapped(self) -> bool:
        return all(
            isinstance(a, np.memmap) for a in (self._idx, self._val, self._y)
        )

    @property
    def is_checksummed(self) -> bool:
        return self._checksums is not None

    def as_source(self, chunks_per_segment: int):
        """This shard set as a prefetchable ShardSource of
        ``chunks_per_segment``-chunk segments (the
        ``run_lbfgs_gram_streamed`` operand contract)."""
        from .prefetch import COOShardSource

        return COOShardSource(self, chunks_per_segment)


class DiskDenseShards:
    """Pre-tiled DENSE rows on disk, mmap-read per segment — the dense
    analog of :class:`DiskCOOShards`, feeding
    ``parallel.streaming.streaming_bcd_fit_segments``.

    Layout: ``x.npy`` (num_tiles, tile_rows, d_in), ``y.npy``
    (num_tiles, tile_rows, k), ``dense_shards.json``
    {n_true, tile_rows, num_tiles, tiles_per_segment, checksum_algo,
    checksums: {x: [per tile], y: [per tile]}}.
    """

    _META = "dense_shards.json"

    def __init__(self, directory: str, verify: bool = True,
                 retry_policy=None):
        self.directory = os.path.abspath(directory)
        with open(os.path.join(directory, self._META)) as f:
            meta = json.load(f)
        self.n_true = int(meta["n_true"])
        self.tile_rows = int(meta["tile_rows"])
        self.num_tiles = int(meta["num_tiles"])
        self.tiles_per_segment = int(meta["tiles_per_segment"])
        self._checksums, self._algo = _meta_checksums(meta)
        if not verify:
            self._checksums = None
        self._retry = retry_policy or faults.default_retry_policy()
        self._x = np.load(os.path.join(directory, "x.npy"), mmap_mode="r")
        self._y = np.load(os.path.join(directory, "y.npy"), mmap_mode="r")

    @property
    def num_segments(self) -> int:
        return -(-self.num_tiles // self.tiles_per_segment)

    @staticmethod
    def _final_meta(directory: str, n_true: int, tile_rows: int,
                    num_tiles: int, tiles_per_segment: int,
                    checksums: Optional[Dict[str, List[int]]] = None,
                    ) -> None:
        """Fsync the arrays, then publish metadata LAST and atomically —
        the commit point of a dense shard build. Checksums cover the
        tiles the metadata claims (capacity tiles past ``num_tiles``,
        e.g. an overshooting writer's sparse tail, are not claimed and
        not digested); both writers digest tiles hot during the fill and
        pass them here, so the read-back below is only a fallback."""
        sums: Dict[str, List[int]] = {}
        for field in ("x", "y"):
            path = os.path.join(directory, f"{field}.npy")
            fsync_file(path)
            if checksums is not None:
                sums[field] = list(checksums[field])
            else:
                arr = np.load(path, mmap_mode="r")
                sums[field] = _chunk_checksums(arr, num_tiles)
                del arr
        atomic_write_json(
            os.path.join(directory, DiskDenseShards._META),
            {"n_true": int(n_true), "tile_rows": int(tile_rows),
             "num_tiles": int(num_tiles),
             "tiles_per_segment": int(tiles_per_segment),
             "checksum_algo": checksum_algo(),
             "checksums": sums},
        )

    @staticmethod
    def write(
        directory: str,
        X: np.ndarray,
        Y: np.ndarray,
        tile_rows: int,
        tiles_per_segment: int,
    ) -> "DiskDenseShards":
        """Tile (n, d_in) rows + (n, k) labels into on-disk tiles (the
        ragged tail is zero-padded; n_true masks it at fold time)."""
        n, d_in = X.shape
        k = Y.shape[1]
        num_tiles = -(-n // tile_rows)
        os.makedirs(directory, exist_ok=True)
        # A stale meta from a previous build must never describe the new
        # partially-written arrays (kill-mid-write would otherwise load
        # as a valid-but-wrong dataset).
        try:
            os.unlink(os.path.join(directory, DiskDenseShards._META))
        except OSError:
            pass
        mm_x = np.lib.format.open_memmap(
            os.path.join(directory, "x.npy"), mode="w+", dtype=X.dtype,
            shape=(num_tiles, tile_rows, d_in),
        )
        mm_y = np.lib.format.open_memmap(
            os.path.join(directory, "y.npy"), mode="w+", dtype=Y.dtype,
            shape=(num_tiles, tile_rows, k),
        )
        # open_memmap('w+') creates the file zero-filled via ftruncate
        # (sparse allocation) — the ragged tail needs no explicit pass.
        sums: Dict[str, List[int]] = {"x": [], "y": []}
        for t in range(num_tiles):
            lo, hi = t * tile_rows, min((t + 1) * tile_rows, n)
            mm_x[t, : hi - lo] = X[lo:hi]
            mm_y[t, : hi - lo] = Y[lo:hi]
            # Digest while the tile's pages are hot (convention note at
            # the top of the module).
            sums["x"].append(int(crc_of_array(mm_x[t])))
            sums["y"].append(int(crc_of_array(mm_y[t])))
        mm_x.flush(); mm_y.flush()
        del mm_x, mm_y
        DiskDenseShards._final_meta(
            directory, n, tile_rows, num_tiles, tiles_per_segment,
            checksums=sums,
        )
        return DiskDenseShards(directory)

    def segment_source(self, s: int):
        """``streaming_bcd_fit_segments`` contract: materialize ONLY this
        segment's tiles (phantom tiles past the end are zero-padded and
        masked by valid_rows=0)."""
        X_seg, valid_rows = self.segment_source_x(s)
        Y_seg, _ = self.segment_source_y(s)
        return X_seg, Y_seg, valid_rows

    def _segment_field(self, arr, s: int, field: str):
        tps = self.tiles_per_segment
        lo, hi = s * tps, min((s + 1) * tps, self.num_tiles)
        seg = _read_verified(
            arr, lo, hi,
            what=f"{self.directory}/{field}.npy tile",
            key=f"{self.directory}:{field}:{lo}",
            checksums=(
                None if self._checksums is None
                else self._checksums.get(field)
            ),
            algo=self._algo, retry=self._retry,
        )
        pad = tps - (hi - lo)
        if pad:
            seg = np.concatenate(
                [seg, np.zeros((pad,) + seg.shape[1:], seg.dtype)]
            )
        valid_rows = max(
            min(self.n_true - lo * self.tile_rows, tps * self.tile_rows), 0
        )
        return seg, valid_rows

    def segment_source_x(self, s: int):
        """(X_seg, valid_rows) only — pairings that bring their own
        resident labels skip the on-disk label read entirely."""
        return self._segment_field(self._x, s, "x")

    def segment_source_y(self, s: int):
        """(Y_seg, valid_rows) only — label views (e.g. the cost-model
        sample collector) skip the much wider row read."""
        return self._segment_field(self._y, s, "y")

    @property
    def is_memory_mapped(self) -> bool:
        return isinstance(self._x, np.memmap) and isinstance(
            self._y, np.memmap
        )

    @property
    def is_checksummed(self) -> bool:
        return self._checksums is not None

    def as_source(self):
        """This shard set as a prefetchable ShardSource delivering the
        (X_seg, Y_seg, valid_rows) segments
        ``streaming_bcd_fit_segments`` folds."""
        from .prefetch import DenseShardSource

        return DenseShardSource(self)

    def as_labeled_data(self):
        """(data, labels) shard-backed Datasets over these files — the
        typed-pipeline entry point: both Datasets view ONE set of disk
        shards, so ``Pipeline.fit`` can route the pair through the
        capacity selector with no resident copy ever existing."""
        from .dataset import Dataset, LabeledData
        from .prefetch import DenseShardView

        paired = self.as_source()
        return LabeledData(
            Dataset(DenseShardView(paired, "x")),
            Dataset(DenseShardView(paired, "y")),
        )


class DiskDenseShardWriter:
    """Incremental row-appending writer for :class:`DiskDenseShards`.

    Loaders stream rows in (one CSV file / archive member batch at a
    time) and the writer fills on-disk tiles in place — host residency is
    the incoming block, never the dataset. ``capacity_rows`` may OVERSHOOT
    the true count (e.g. a newline-count upper bound): unwritten tail
    tiles stay sparse zero-fill on disk and the metadata written at
    ``close`` records only the rows actually appended.

    Crash safety: any previous metadata is deleted at open, and the new
    metadata (with per-tile checksums) is written atomically, LAST, at
    :meth:`close` — a writer killed mid-append leaves a directory that
    refuses to load rather than one that silently truncates the data.
    """

    def __init__(
        self,
        directory: str,
        capacity_rows: int,
        d_in: int,
        k: int,
        tile_rows: int,
        tiles_per_segment: int = 4,
        x_dtype=np.float32,
        y_dtype=np.float32,
    ):
        if capacity_rows <= 0:
            raise ValueError("capacity_rows must be positive")
        self.directory = directory
        self.tile_rows = int(tile_rows)
        self.tiles_per_segment = int(tiles_per_segment)
        cap_tiles = -(-int(capacity_rows) // self.tile_rows)
        os.makedirs(directory, exist_ok=True)
        try:
            os.unlink(os.path.join(directory, DiskDenseShards._META))
        except OSError:
            pass
        self._mm_x = np.lib.format.open_memmap(
            os.path.join(directory, "x.npy"), mode="w+", dtype=x_dtype,
            shape=(cap_tiles, self.tile_rows, int(d_in)),
        )
        self._mm_y = np.lib.format.open_memmap(
            os.path.join(directory, "y.npy"), mode="w+", dtype=y_dtype,
            shape=(cap_tiles, self.tile_rows, int(k)),
        )
        self._rows = 0
        self._closed = False
        # Tiles digested so far (hot, as appends complete them — the
        # module's write-path checksum convention).
        self._sums: Dict[str, List[int]] = {"x": [], "y": []}

    def append(self, X_block: np.ndarray, Y_block: np.ndarray) -> None:
        X_block = np.asarray(X_block)
        Y_block = np.asarray(Y_block)
        if Y_block.ndim == 1:
            Y_block = Y_block[:, None]
        m = X_block.shape[0]
        if Y_block.shape[0] != m:
            raise ValueError(
                f"rows disagree: X {m} vs Y {Y_block.shape[0]}"
            )
        if self._rows + m > self._mm_x.shape[0] * self.tile_rows:
            raise ValueError(
                f"writer capacity {self._mm_x.shape[0] * self.tile_rows} "
                f"rows exceeded at {self._rows + m}"
            )
        flat_x = self._mm_x.reshape(-1, self._mm_x.shape[-1])
        flat_y = self._mm_y.reshape(-1, self._mm_y.shape[-1])
        flat_x[self._rows : self._rows + m] = X_block
        flat_y[self._rows : self._rows + m] = Y_block
        self._rows += m
        # Digest tiles this block COMPLETED while their pages are hot.
        for t in range(len(self._sums["x"]), self._rows // self.tile_rows):
            self._sums["x"].append(int(crc_of_array(self._mm_x[t])))
            self._sums["y"].append(int(crc_of_array(self._mm_y[t])))

    def close(self) -> "DiskDenseShards":
        """Flush + fsync the arrays, write checksummed metadata for the
        rows actually appended (atomically, last), and reopen read-only
        as :class:`DiskDenseShards`."""
        if self._closed:
            raise RuntimeError("writer already closed")
        self._closed = True
        if self._rows == 0:
            raise ValueError("no rows were appended")
        num_tiles = -(-self._rows // self.tile_rows)
        # Digest the trailing partial tile (its zero tail reads straight
        # from the sparse file's hole pages — no disk IO).
        for t in range(len(self._sums["x"]), num_tiles):
            self._sums["x"].append(int(crc_of_array(self._mm_x[t])))
            self._sums["y"].append(int(crc_of_array(self._mm_y[t])))
        self._mm_x.flush(); self._mm_y.flush()
        del self._mm_x, self._mm_y
        DiskDenseShards._final_meta(
            self.directory, self._rows, self.tile_rows, num_tiles,
            self.tiles_per_segment, checksums=self._sums,
        )
        return DiskDenseShards(self.directory)
