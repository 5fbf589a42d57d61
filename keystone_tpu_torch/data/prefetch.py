"""Out-of-core ingestion: the ShardSource protocol and the double-buffered
prefetcher (port of ``keystone_tpu/data/prefetch.py``).

  - :class:`ShardSource`: the protocol unifying in-RAM segment sources and
    the memory-mapped :class:`~keystone_tpu_torch.data.shards.DiskCOOShards`
    / :class:`~keystone_tpu_torch.data.shards.DiskDenseShards` files:
    ordered segments of ready host buffers, delivered one at a time.
  - :class:`Prefetcher`: loads segment k+1 on the data-plane runtime's
    ``read`` lane (:mod:`keystone_tpu_torch.data.runtime`) while the
    consumer's host-to-device copy and device fold of segment k are in
    flight. At most ``depth`` load tasks are outstanding at once
    (backpressure: host staging memory is bounded by depth segments), and
    the lane's single worker completes them in submission order.

Differences from the reference:

  - a load task may also *stage* its payload (``stage=``, run on the
    reader thread after the load): :func:`stage_segment` copies the
    segment's arrays into page-locked host tensors when the consumer's
    device is a card, so the consumer's copy to the card is a
    non-blocking one on a side stream (:func:`to_device_segment`) and
    overlaps the fold of the previous segment. On the CPU it copies them
    into owned tensors: a memory-mapped shard tile is read-only and is
    never handed to torch as it is; the mesh ingestion
    (``iter_mesh_segments``) takes the same ``stage=``, one a device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import runtime as runtime_mod
from keystone_tpu_torch.obs.metrics import (
    METRIC_PREFETCH_BACKOFF_S,
    METRIC_PREFETCH_LOAD_S,
    METRIC_PREFETCH_RETRIES,
    METRIC_PREFETCH_SEGMENTS,
    METRIC_PREFETCH_WAIT_S,
    METRIC_SITE_BUSY_S,
    METRIC_SITE_WAIT_S,
)
from keystone_tpu_torch.utils import faults


class ShardSource:
    """Ordered segments of ready host buffers feeding a streamed fold.

    The contract every streamed consumer (``streaming_bcd_fit_segments``,
    ``run_lbfgs_gram_streamed``, the shard-backed ``Dataset``) reads:

      - ``num_segments``: how many segments exist,
      - ``n_true``: the true (unpadded) example count across all segments,
      - ``load(s)``: materialize only segment ``s`` as host numpy buffers
        (the same shape for every s: ragged tails are padded by the source).

    ``load`` must be safe to call from a background thread: it may touch
    the filesystem and numpy, and does no device work.
    """

    num_segments: int
    n_true: int

    # True when load() already retries transient IO itself (the disk-shard
    # views: shards.py's RetryPolicy at the shard.load site). The
    # Prefetcher then does not wrap load in its own retry: nesting two
    # policies would multiply attempts and compound backoff.
    load_retries_transients: bool = False

    def load(self, s: int):
        raise NotImplementedError

    # -- capacity metadata (the cost model prices the disk tier on these) --

    @property
    def row_bytes(self) -> Optional[float]:
        """Approximate host bytes a row (None when unknown)."""
        return None

    @property
    def segment_bytes(self) -> Optional[float]:
        """Approximate host bytes one staged segment occupies."""
        return None

    def materialize(self) -> Any:
        """Concatenate every segment into resident arrays (small sources
        only: the escape hatch that keeps shard-backed Datasets usable by
        resident solvers when they do fit)."""
        raise NotImplementedError


class DenseShardSource(ShardSource):
    """:class:`~keystone_tpu_torch.data.shards.DiskDenseShards` as a
    ShardSource: ``load(s) -> (X_seg (T, tile_rows, d_in), Y_seg
    (T, tile_rows, k), valid_rows)``, the ``segment_source`` contract of
    ``streaming_bcd_fit_segments``."""

    load_retries_transients = True  # shards.py retries at shard.load

    def __init__(self, shards):
        self.shards = shards

    @property
    def num_segments(self) -> int:
        return self.shards.num_segments

    @property
    def n_true(self) -> int:
        return self.shards.n_true

    @property
    def tile_rows(self) -> int:
        return self.shards.tile_rows

    @property
    def d_in(self) -> int:
        return int(self.shards._x.shape[-1])

    @property
    def k(self) -> int:
        return int(self.shards._y.shape[-1])

    @property
    def row_bytes(self) -> Optional[float]:
        return float(
            self.d_in * self.shards._x.dtype.itemsize
            + self.k * self.shards._y.dtype.itemsize
        )

    @property
    def segment_bytes(self) -> Optional[float]:
        return self.row_bytes * self.shards.tiles_per_segment * self.tile_rows

    def load(self, s: int):
        return self.shards.segment_source(s)

    def materialize(self):
        """(X (n_true, d_in), Y (n_true, k)) resident."""
        xs, ys = [], []
        for s in range(self.num_segments):
            X_seg, Y_seg, _ = self.load(s)
            xs.append(X_seg.reshape(-1, X_seg.shape[-1]))
            ys.append(Y_seg.reshape(-1, Y_seg.shape[-1]))
        X = np.concatenate(xs)[: self.n_true]
        Y = np.concatenate(ys)[: self.n_true]
        return X, Y


class DenseShardView(ShardSource):
    """One field (rows or labels) of a :class:`DenseShardSource`, flattened
    to per-row form: what a shard-backed ``Dataset`` wraps, so the typed
    Pipeline API can carry (data, labels) as two Datasets that share one
    set of disk files. ``load(s)`` returns the (seg_rows, width) slice of
    the field; the paired (X, Y, valid) form the solvers fold lives on
    ``.paired`` (the underlying :class:`DenseShardSource`)."""

    load_retries_transients = True  # shards.py retries at shard.load

    def __init__(self, paired: DenseShardSource, field: str):
        if field not in ("x", "y"):
            raise ValueError(f"field must be 'x' or 'y', got {field!r}")
        self.paired = paired
        self.field = field

    @property
    def num_segments(self) -> int:
        return self.paired.num_segments

    @property
    def n_true(self) -> int:
        return self.paired.n_true

    @property
    def width(self) -> int:
        return self.paired.d_in if self.field == "x" else self.paired.k

    @property
    def row_bytes(self) -> Optional[float]:
        sh = self.paired.shards
        arr = sh._x if self.field == "x" else sh._y
        return float(self.width * arr.dtype.itemsize)

    @property
    def segment_bytes(self) -> Optional[float]:
        sh = self.paired.shards
        return self.row_bytes * sh.tiles_per_segment * sh.tile_rows

    def load(self, s: int):
        """Field-only segment read: the row view never pays the label read
        and the label view never pays the much wider row read (the
        cost-model sampler loads label segments)."""
        sh = self.paired.shards
        seg, _ = (
            sh.segment_source_x(s) if self.field == "x"
            else sh.segment_source_y(s)
        )
        return seg.reshape(-1, seg.shape[-1])

    def materialize(self):
        segs = [self.load(s) for s in range(self.num_segments)]
        return np.concatenate(segs)[: self.n_true]


class ResidentDenseSource(ShardSource):
    """In-RAM (X, Y) presented through the ShardSource protocol: the same
    fold and prefetch machinery runs whether segments come from
    memory-mapped disk files or live arrays."""

    def __init__(self, X, Y, tile_rows: int, tiles_per_segment: int):
        self.X = np.asarray(X)
        self.Y = np.asarray(Y)
        self.tile_rows = int(tile_rows)
        self.tiles_per_segment = int(tiles_per_segment)
        self.n_true = int(self.X.shape[0])
        self.num_tiles = -(-self.n_true // self.tile_rows)

    @property
    def num_segments(self) -> int:
        return -(-self.num_tiles // self.tiles_per_segment)

    @property
    def d_in(self) -> int:
        return int(self.X.shape[-1])

    @property
    def k(self) -> int:
        return int(self.Y.shape[-1])

    @property
    def row_bytes(self) -> Optional[float]:
        return float(
            self.X.shape[-1] * self.X.dtype.itemsize
            + self.Y.shape[-1] * self.Y.dtype.itemsize
        )

    def load(self, s: int):
        tps, tr = self.tiles_per_segment, self.tile_rows
        lo_row = s * tps * tr
        hi_row = min(lo_row + tps * tr, self.n_true)
        m = hi_row - lo_row
        X_seg = np.zeros((tps * tr, self.X.shape[-1]), self.X.dtype)
        Y_seg = np.zeros((tps * tr, self.Y.shape[-1]), self.Y.dtype)
        X_seg[:m] = self.X[lo_row:hi_row]
        Y_seg[:m] = self.Y[lo_row:hi_row]
        return (
            X_seg.reshape(tps, tr, -1),
            Y_seg.reshape(tps, tr, -1),
            max(m, 0),
        )

    def materialize(self):
        return self.X, self.Y


class PairedDenseSource(ShardSource):
    """(X_seg, Y_seg, valid_rows) segments assembled from a shard-backed
    rows view plus labels that live either in the same disk shards (the
    common spill-path case: no extra reads) or as a small resident array
    sliced per segment (labels usually fit host RAM even when rows do
    not)."""

    load_retries_transients = True  # shards.py retries at shard.load

    def __init__(self, data_view: DenseShardView, labels=None):
        if data_view.field != "x":
            # A y-view as data would silently fit labels against labels.
            raise ValueError(
                "PairedDenseSource needs the rows ('x') view as data, "
                f"got the {data_view.field!r} view"
            )
        self.paired = data_view.paired
        if labels is None:
            self._labels = None
        else:
            Y = np.asarray(labels)
            if Y.ndim == 1:
                Y = Y[:, None]
            if Y.shape[0] != self.paired.n_true:
                raise ValueError(
                    f"labels rows {Y.shape[0]} != shard rows {self.paired.n_true}"
                )
            self._labels = Y

    @property
    def num_segments(self) -> int:
        return self.paired.num_segments

    @property
    def n_true(self) -> int:
        return self.paired.n_true

    @property
    def tile_rows(self) -> int:
        return self.paired.tile_rows

    @property
    def d_in(self) -> int:
        return self.paired.d_in

    @property
    def k(self) -> int:
        if self._labels is not None:
            return int(self._labels.shape[-1])
        return self.paired.k

    def load(self, s: int):
        if self._labels is None:
            return self.paired.load(s)
        # Resident labels: read only the X tiles from disk (the shard
        # labels would be discarded) and slice the label rows host-side.
        sh = self.paired.shards
        X_seg, valid = sh.segment_source_x(s)
        tps, tr = sh.tiles_per_segment, sh.tile_rows
        lo = s * tps * tr
        hi = min(lo + tps * tr, self.n_true)
        Yp = np.zeros((tps * tr, self._labels.shape[-1]), self._labels.dtype)
        Yp[: hi - lo] = self._labels[lo:hi]
        return X_seg, Yp.reshape(tps, tr, -1), valid


class COOShardSource(ShardSource):
    """:class:`~keystone_tpu_torch.data.shards.DiskCOOShards` grouped into
    fixed-width segments: ``load(s) -> (idx, val, y)`` for chunks
    [s·cps, (s+1)·cps), the per-segment operand contract of
    ``run_lbfgs_gram_streamed(segment_source=...)``."""

    load_retries_transients = True  # shards.py retries at shard.load

    def __init__(self, shards, chunks_per_segment: int):
        self.shards = shards
        self.chunks_per_segment = int(chunks_per_segment)

    @property
    def num_segments(self) -> int:
        return -(-self.shards.num_chunks // self.chunks_per_segment)

    @property
    def n_true(self) -> int:
        return self.shards.n_true

    @property
    def num_chunks(self) -> int:
        return self.shards.num_chunks

    @property
    def d(self) -> int:
        return self.shards.d

    def load(self, s: int):
        return self.shards.segment_source(
            s * self.chunks_per_segment, self.chunks_per_segment
        )


class FunctionSource(ShardSource):
    """A plain ``load_fn(s)`` (plus counts) as a ShardSource: lets the
    prefetcher drive callable segment sources unchanged."""

    def __init__(self, load_fn: Callable[[int], Any], num_segments: int,
                 n_true: int = 0):
        self._fn = load_fn
        self.num_segments = int(num_segments)
        self.n_true = int(n_true)

    def load(self, s: int):
        return self._fn(s)


def is_shard_source(obj: Any) -> bool:
    return isinstance(obj, ShardSource)


class PrefetchStats:
    """Where the ingestion time went, for the overlap accounting
    (``utils.profiling.prefetch_overlap_fraction``): ``load_s`` sums time
    spent inside ``source.load`` and the staging copy (reader thread),
    ``wait_s`` sums time the consumer blocked waiting on a load (latency
    the prefetch failed to hide). ``prefetched`` records whether a
    background reader ran: a serial (depth-0) pass fills load_s with no
    waits, which must read as zero overlap, not full.

    Reliability counters (``utils.profiling.prefetch_retry_counters``):
    ``retries`` counts transient read failures the reader recovered from,
    ``backoff_s`` sums the backoff it slept.

    Per-site accounting (``site_busy_s`` / ``site_wait_s``, read by
    ``utils.profiling.overlap_report``): busy seconds a named phase spent
    working (``read`` on an IO worker, ``verify`` inside the shard
    checksum pass, ``checkpoint`` on the write-behind worker, ``compute``
    on the consumer's copy and fold dispatch) and the seconds the
    consumer was blocked waiting on that phase. Thread-safe: IO workers
    and the consumer thread both report.

    The store is a :class:`~keystone_tpu_torch.obs.metrics.MetricsRegistry`;
    the attribute surface (``stats.load_s += dt`` and friends) is kept as
    properties over the registered counters."""

    def __init__(self):
        self.registry = obs.MetricsRegistry()
        self._load_s = self.registry.counter(METRIC_PREFETCH_LOAD_S)
        self._wait_s = self.registry.counter(METRIC_PREFETCH_WAIT_S)
        self._segments = self.registry.counter(METRIC_PREFETCH_SEGMENTS)
        self._retries = self.registry.counter(METRIC_PREFETCH_RETRIES)
        self._backoff_s = self.registry.counter(METRIC_PREFETCH_BACKOFF_S)
        self.prefetched = False

    @property
    def load_s(self) -> float:
        return self._load_s.value

    @load_s.setter
    def load_s(self, v: float) -> None:
        self._load_s.set_(v)

    @property
    def wait_s(self) -> float:
        return self._wait_s.value

    @wait_s.setter
    def wait_s(self, v: float) -> None:
        self._wait_s.set_(v)

    @property
    def segments(self) -> int:
        return int(self._segments.value)

    @segments.setter
    def segments(self, v: int) -> None:
        self._segments.set_(v)

    @property
    def retries(self) -> int:
        return int(self._retries.value)

    @retries.setter
    def retries(self, v: int) -> None:
        self._retries.set_(v)

    @property
    def backoff_s(self) -> float:
        return self._backoff_s.value

    @backoff_s.setter
    def backoff_s(self, v: float) -> None:
        self._backoff_s.set_(v)

    @property
    def site_busy_s(self) -> dict:
        """``{site: seconds}`` view of the labelled busy counters."""
        return self.registry.values_by_label(METRIC_SITE_BUSY_S, "site")

    @property
    def site_wait_s(self) -> dict:
        return self.registry.values_by_label(METRIC_SITE_WAIT_S, "site")

    def add_busy(self, site: str, seconds: float) -> None:
        self.registry.counter(METRIC_SITE_BUSY_S, site=site).add(float(seconds))

    def add_wait(self, site: str, seconds: float) -> None:
        self.registry.counter(METRIC_SITE_WAIT_S, site=site).add(float(seconds))


class _Cancelled:
    """Sentinel a load task returns when close() raced its start."""


class Prefetcher:
    """Double-buffered background segment reader with bounded depth.

    Iterating yields ``(s, payload)`` in strict segment order. Loads run
    as tasks on the data-plane runtime's ``read`` lane (one pooled worker
    a lane; ``source.load`` and ``stage`` do host work only); at most
    ``depth`` load tasks are outstanding at once, and the lane's FIFO
    makes segment order structural. Closing (or breaking out of or
    raising inside the consuming loop) cancels every queued load and
    waits out the in-flight one: no task of this pass survives close().
    Load exceptions re-raise in the consumer at the segment that failed.

    Transient read failures (``OSError``) retry on the IO worker with
    bounded exponential backoff (``retry_policy``, default
    :func:`keystone_tpu_torch.utils.faults.default_retry_policy`);
    exhaustion re-raises consumer-side, and retry and backoff totals go
    into :class:`PrefetchStats`. The ``prefetch.read`` fault site fires
    once per load attempt.

    ``stage``: a function of the loaded payload, run on the reader thread
    after the load and timed with it (e.g. :func:`stage_segment`'s copy
    into page-locked memory).
    """

    def __init__(self, source: ShardSource, depth: int = 2,
                 stats: Optional[PrefetchStats] = None,
                 retry_policy=None, runtime=None, segment_offset: int = 0,
                 lane: Optional[str] = None,
                 stage: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.source = source
        self.depth = int(depth)
        self.lane = lane or runtime_mod.LANE_READ
        # Trace-label offset only (a resumed fit hands over a source
        # rebased to its checkpoint cursor): spans name absolute segments.
        self.segment_offset = int(segment_offset)
        self.stats = stats if stats is not None else PrefetchStats()
        self.retry_policy = retry_policy or faults.default_retry_policy()
        # None -> the process-wide shared runtime, resolved at iteration.
        self.runtime = runtime
        self.stage = stage
        self._pending: "deque" = deque()  # outstanding load futures
        self._stop = threading.Event()
        self._started = False

    # -- reader side (runs on the runtime's `read` worker) -----------------

    def _load_segment(self, s: int):
        """One load task: the retry-wrapped ``source.load`` (and the
        staging copy) with busy and retry accounting into this pass's
        stats."""
        if self._stop.is_set():
            return _Cancelled()
        try:
            # The span covers exactly the region the busy counter covers.
            with faults.observing_retries(self.stats), \
                    obs.span("prefetch.read", segment=s + self.segment_offset):
                t0 = time.perf_counter()
                payload = self._load_with_retry(s)
                if self.stage is not None:
                    payload = self.stage(payload)
                dt = time.perf_counter() - t0
        except BaseException:
            # A load that exhausted its retries kills the pass: queued
            # siblings short-circuit instead of burning their own retry
            # budgets against the same dead disk.
            self._stop.set()
            raise
        self.stats.load_s += dt
        self.stats.add_busy("read", dt)
        return payload

    def _load_with_retry(self, s: int):
        def on_retry(_attempt, delay_s, _exc):
            self.stats.retries += 1
            self.stats.backoff_s += delay_s

        if getattr(self.source, "load_retries_transients", False):
            # The shard layer already owns disk retries (shard.load site);
            # the outer policy covers only this site's injected faults.
            self.retry_policy.call(
                lambda: faults.maybe_fail(faults.SITE_PREFETCH_READ),
                key=f"prefetch:{s}", on_retry=on_retry,
            )
            return self.source.load(s)

        def attempt():
            faults.maybe_fail(faults.SITE_PREFETCH_READ)
            return self.source.load(s)

        return self.retry_policy.call(attempt, key=f"prefetch:{s}", on_retry=on_retry)

    # -- consumer side -----------------------------------------------------

    def __iter__(self) -> Iterator[Tuple[int, Any]]:
        # Single use: after close() every task would return the cancel
        # sentinel and silently truncate the stream, so fail loud.
        if self._started or self._stop.is_set():
            raise RuntimeError(
                "Prefetcher is single-use (and unusable once closed); "
                "create a new one per pass"
            )
        self._started = True
        self.stats.prefetched = True
        rt = self.runtime or runtime_mod.default_runtime()
        num = self.source.num_segments
        next_submit = 0
        try:
            while next_submit < min(self.depth, num):
                self._pending.append(rt.submit(self.lane, self._load_segment, next_submit))
                next_submit += 1
            for s in range(num):
                fut = self._pending.popleft()
                t0 = time.perf_counter()
                with obs.span("prefetch.wait", segment=s + self.segment_offset):
                    payload = fut.result()  # re-raises the load's error
                dt = time.perf_counter() - t0
                self.stats.wait_s += dt
                self.stats.add_wait("read", dt)
                if isinstance(payload, _Cancelled):  # close() raced us
                    return
                if next_submit < num and not self._stop.is_set():
                    self._pending.append(
                        rt.submit(self.lane, self._load_segment, next_submit)
                    )
                    next_submit += 1
                self.stats.segments += 1
                yield s, payload
        finally:
            self.close()

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def staged_count(self) -> int:
        """Outstanding load tasks (staged or in flight): zero after close()."""
        return len(self._pending)

    def close(self) -> None:
        """Stop the pass: cancel every queued load, wait out the (at most
        one) in-flight load, and release every staged payload. Idempotent;
        called when the consuming loop exits for any reason. The runtime's
        pooled worker outlives the pass by design."""
        self._stop.set()
        while self._pending:
            fut = self._pending.popleft()
            if not fut.cancel():
                # Already running or done: bound the wait by one load; its
                # error belongs to the pass that died, so it is swallowed.
                try:
                    fut.result(timeout=30.0)
                except Exception:
                    pass


def iter_segments(
    source,
    num_segments: Optional[int] = None,
    prefetch_depth: int = 2,
    stats: Optional[PrefetchStats] = None,
    start: int = 0,
    stage: Optional[Callable[[Any], Any]] = None,
) -> Iterator[Tuple[int, Any]]:
    """Uniform segment iteration for the streamed folds: ``source`` is a
    :class:`ShardSource` or a plain ``load_fn(s)`` callable (then
    ``num_segments`` is required). ``prefetch_depth >= 1`` runs the
    double-buffered background reader; ``0`` loads serially on the
    consumer thread (the same order and payloads by construction).
    ``start`` skips the first segments and yields absolute ids from
    ``start`` on: the checkpoint-resume entry point. ``stage`` is applied
    to each payload after its load, on the reader thread or inline."""
    if not is_shard_source(source):
        if num_segments is None:
            raise ValueError("callable segment sources need num_segments")
        source = FunctionSource(source, num_segments)
    elif num_segments is not None and num_segments < source.num_segments:
        # An explicit cap folds a prefix of the source; the rebox keeps the
        # retry-ownership flag, or the Prefetcher would nest a second
        # policy over shard loads.
        inner = source
        source = FunctionSource(inner.load, num_segments, inner.n_true)
        source.load_retries_transients = inner.load_retries_transients
    if start:
        if start >= source.num_segments:
            return
        base = source
        source = FunctionSource(
            lambda s: base.load(s + start), base.num_segments - start, base.n_true,
        )
        source.load_retries_transients = base.load_retries_transients
    if prefetch_depth and source.num_segments > 1:
        for s, payload in Prefetcher(source, depth=prefetch_depth, stats=stats,
                                     segment_offset=start, stage=stage):
            yield s + start, payload
        return
    for s in range(source.num_segments):
        t0 = time.perf_counter()
        if stats is not None:
            # The serial leg: the same span name as the prefetched reader.
            with faults.observing_retries(stats), \
                    obs.span("prefetch.read", segment=s + start, serial=True):
                payload = source.load(s)
                if stage is not None:
                    payload = stage(payload)
            dt = time.perf_counter() - t0
            stats.load_s += dt
            # Inline loads are fully waited on: busy == wait, so the
            # per-site report reads 0 overlap.
            stats.add_busy("read", dt)
            stats.add_wait("read", dt)
            stats.segments += 1
        else:
            payload = source.load(s)
            if stage is not None:
                payload = stage(payload)
        yield s + start, payload


# -- staging: host buffers to the consumer's device ---------------------------


def stage_segment(payload, device) -> Any:
    """A segment payload's arrays as host tensors the consumer can move to
    ``device``: page-locked (pinned) copies when ``device`` is a card, so
    the copy there can be asynchronous; owned copies on the CPU (a shard
    read may be a read-only view of a memory-mapped file). Ints and other
    non-array members pass through. Runs on the reader thread."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def one(a):
        if not isinstance(a, np.ndarray):
            return a
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        t = torch.empty(a.shape, dtype=dtype, pin_memory=pin)
        t.numpy()[...] = a
        return t

    if isinstance(payload, tuple):
        return tuple(one(a) for a in payload)
    return one(payload)


def to_device_segment(staged, device, copy_stream=None):
    """The staged payload's tensors on ``device``. On a card, the copies
    are non-blocking ones issued on ``copy_stream`` (a side stream), and
    the current stream waits for them before it uses the tensors: the
    copy of segment k+1 overlaps the fold of segment k, and the fold
    reads the same bytes as a blocking copy would give it."""
    device = torch.device(device)
    if device.type != "cuda" or copy_stream is None:
        def plain(a):
            return a.to(device) if isinstance(a, torch.Tensor) else a
        return tuple(plain(a) for a in staged) if isinstance(staged, tuple) else plain(staged)
    compute = torch.cuda.current_stream(device)
    # The copy need not wait for the compute stream: its source is a fresh
    # page-locked buffer and its destination fresh memory.
    with torch.cuda.stream(copy_stream):
        def move(a):
            return a.to(device, non_blocking=True) if isinstance(a, torch.Tensor) else a
        out = tuple(move(a) for a in staged) if isinstance(staged, tuple) else move(staged)
    compute.wait_stream(copy_stream)
    for a in (out if isinstance(out, tuple) else (out,)):
        if isinstance(a, torch.Tensor):
            # Allocated on the copy stream, freed after the fold: the
            # allocator must not hand its memory to the next copy before
            # the compute stream is done with it.
            a.record_stream(compute)
    return out


# -- mesh ingestion: one read lane a device -----------------------------------


def mesh_read_lane(device: int) -> str:
    """The per-device read lane name (``read.d<k>``) that mesh ingestion
    submits device ``k``'s loads on: the data-plane runtime makes the lane
    (its own pooled worker and bounded queue) on first submit."""
    return f"{runtime_mod.LANE_READ}.d{int(device)}"


def iter_mesh_segments(
    sources,
    prefetch_depth: int = 2,
    stats: Optional[PrefetchStats] = None,
    stage: Optional[Sequence[Callable[[Any], Any]]] = None,
) -> Iterator[Tuple[int, list]]:
    """Lock-step iteration over per-device segment sources.

    ``sources[k]`` is device k's :class:`ShardSource` (or a
    ``(load_fn, num_segments)`` pair); segment ``s`` of every device loads
    concurrently, each on its own runtime lane (``read.d<k>``:
    :func:`mesh_read_lane`), each lane's outstanding loads bounded by
    ``prefetch_depth``. Yields ``(s, [payload_0, ..., payload_{m-1}])`` in
    strict segment order. All sources must agree on ``num_segments`` (pad
    ragged device tails source-side: the mesh fold masks phantom chunks
    dead). ``prefetch_depth=0`` loads serially in device order, the same
    payloads. ``stage[k]``, when given, runs on device k's payload after
    its load (on its lane, or inline).
    """
    boxed = []
    for src in sources:
        if not is_shard_source(src):
            load_fn, num = src
            src = FunctionSource(load_fn, num)
        boxed.append(src)
    if not boxed:
        raise ValueError("iter_mesh_segments needs at least one source")
    nums = {s.num_segments for s in boxed}
    if len(nums) != 1:
        raise ValueError(
            f"per-device sources disagree on num_segments: {sorted(nums)} "
            f"— pad ragged device tails source-side"
        )
    num = nums.pop()
    stages = list(stage) if stage is not None else [None] * len(boxed)
    if prefetch_depth and num > 0:
        readers = [
            Prefetcher(src, depth=prefetch_depth, stats=stats,
                       lane=mesh_read_lane(k), stage=stages[k])
            for k, src in enumerate(boxed)
        ]
        try:
            for rows in zip(*readers):
                yield rows[0][0], [payload for _, payload in rows]
        finally:
            for r in readers:
                r.close()
        return
    for s in range(num):
        payloads = []
        for src, st in zip(boxed, stages):
            payload = src.load(s)
            payloads.append(st(payload) if st is not None else payload)
        yield s, payloads
