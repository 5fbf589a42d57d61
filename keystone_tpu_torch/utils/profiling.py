"""Tracing / profiling utilities (port of ``keystone_tpu/utils/profiling.py``).

  - ``PhaseTimer`` — named phase accumulation with a log summary. Given a
    CUDA ``device`` it times each phase with CUDA events on the current
    stream and synchronizes at the phase's end, so a phase's seconds are
    the card's, not the launch queue's; without one it reads the host's
    clock.
  - ``trace`` — context manager around ``torch.profiler`` writing a
    Chrome trace (host and, on the card, CUDA activity) into a
    directory, the deep-dive tool.
  - ``prefetch_overlap_fraction`` / ``overlap_report`` /
    ``prefetch_retry_counters`` — the achieved ingestion-overlap share
    and retry accounting of a prefetched streamed fit, from its stats
    object's metrics registry (or the bare attributes of a plain object).
  - ``RequestSpan`` / ``SpanLog`` — per-request serving spans (queue wait /
    pad fraction / execution time) recorded by the online micro-batcher
    (:mod:`keystone_tpu_torch.serving.batcher`), bounded so a long-lived
    server never grows its profiling state without limit.

The reference's ``compiled_cost`` reads XLA's cost analysis of a compiled
program; it has no counterpart here yet.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger("keystone_tpu_torch.profiling")


class PhaseTimer:
    """Accumulate seconds per named phase.

    >>> t = PhaseTimer("krr", device=X.device)
    >>> with t.phase("kernel_gen"):
    ...     do_work()
    >>> t.log_summary()

    With a CUDA ``device`` each phase is bracketed by two CUDA events on
    the current stream and ends in a synchronize of its end event: the
    phase's seconds are the card's time between the events. Otherwise
    (no device, or a CPU one) the host's ``perf_counter``.
    """

    def __init__(self, name: str = "", device: Any = None):
        self.name = name
        self.device = device
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    def _on_card(self) -> bool:
        import torch

        return self.device is not None and torch.device(self.device).type == "cuda"

    @contextlib.contextmanager
    def phase(self, phase_name: str):
        if self._on_card():
            import torch

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                end.synchronize()
                self._add(phase_name, start.elapsed_time(end) / 1e3)
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(phase_name, time.perf_counter() - t0)

    def _add(self, phase_name: str, dt: float) -> None:
        self.totals[phase_name] = self.totals.get(phase_name, 0.0) + dt
        self.counts[phase_name] = self.counts.get(phase_name, 0) + 1

    def total(self, phase_name: str) -> float:
        return self.totals.get(phase_name, 0.0)

    def summary(self) -> str:
        parts = [
            f"{k}={v:.3f}s/{self.counts[k]}x" for k, v in self.totals.items()
        ]
        prefix = f"{self.name}: " if self.name else ""
        return prefix + ", ".join(parts) if parts else prefix + "(no phases)"

    def log_summary(self, level: int = logging.INFO) -> None:
        logger.log(level, "%s", self.summary())


def prefetch_overlap_fraction(stats) -> Optional[float]:
    """Achieved ingestion-overlap fraction of one prefetched streamed fit.

    ``stats`` is the ``PrefetchStats`` the
    fit's Prefetcher filled: ``load_s`` is total time inside
    ``source.load`` (reader thread — disk + staging copies), ``wait_s`` is
    total time the CONSUMER blocked on the queue (latency the prefetch
    failed to hide). The hidden share is

        (load_s − wait_s) / load_s        clamped to [0, 1]

    — 1.0 means every second of disk→host ingestion ran behind device
    compute; 0.0 means fully serial (every load was waited on). Unlike the
    bench's two-leg A/B (``(wall_off − wall_on) / load_s``), this needs
    ONE run, so any streamed fit can report it (pass ``prefetch_stats`` to
    ``streaming_bcd_fit_segments`` / ``run_lbfgs_gram_streamed``). Returns
    None when no load time was recorded; a serial ``prefetch_depth=0``
    pass (``stats.prefetched`` False — loads ran inline on the consumer,
    nothing overlapped) reports 0.0.
    """
    load_s = float(getattr(stats, "load_s", 0.0) or 0.0)
    if load_s <= 0.0:
        return None
    if not getattr(stats, "prefetched", False):
        return 0.0
    wait_s = float(getattr(stats, "wait_s", 0.0) or 0.0)
    return min(max((load_s - wait_s) / load_s, 0.0), 1.0)


def overlap_report(stats) -> Dict[str, Dict[str, Optional[float]]]:
    """Per-SITE overlap report of one streamed fit:
    the per-phase form of :func:`prefetch_overlap_fraction`, built from
    the ``site_busy_s`` / ``site_wait_s`` accounting the data-plane
    runtime's consumers fill in one
    ``PrefetchStats``:

      - ``read`` — segment loads on the runtime's ``read`` worker
        (busy) vs consumer queue waits (wait);
      - ``verify`` — the shard layer's CRC pass (rides inside read's
        wall, attributed via ``faults.observe_busy``);
      - ``checkpoint`` — write-behind snapshot writes (busy, worker
        side) vs the fold-blocking sync+submit share (wait);
      - ``decode`` / ``augment`` — the image tier's per-segment decode
        and seeded augmentation (ride inside the read lane's wall,
        attributed via ``faults.observe_busy`` from
        ``EncodedImageSource.load``);
      - ``compute`` — the consumer's transfer + fold dispatch + device
        throttle, the denominator phase everything else hides behind.

    Per site: ``busy_s`` (wall the phase worked), ``wait_s`` (wall the
    CONSUMER blocked on it), ``hidden_s = max(busy − wait, 0)`` and
    ``overlap = hidden/busy`` (None when the site did no work) — 1.0
    means the phase ran entirely behind compute, 0.0 fully serial. A
    serial ``prefetch_depth=0`` leg records busy == wait for ``read``,
    so the oracle path reads 0 overlap by construction. This is what
    makes a fold-floor claim (the Amazon 131.4 s) auditable per phase:
    wall − compute.busy must be accounted for by the visible waits.

    Reads the ``MetricsRegistry`` a real ``PrefetchStats`` carries (the registry is the
    single store); plain objects exposing ``site_busy_s``/``site_wait_s``
    dicts still work through a deprecated attribute shim."""
    busy, wait = _site_dicts(stats)
    report: Dict[str, Dict[str, Optional[float]]] = {}
    for site in sorted(set(busy) | set(wait)):
        b = float(busy.get(site, 0.0))
        w = float(wait.get(site, 0.0))
        hidden = max(b - w, 0.0)
        report[site] = {
            "busy_s": b,
            "wait_s": w,
            "hidden_s": hidden,
            "overlap": (min(hidden / b, 1.0) if b > 0.0 else None),
        }
    return report


def _site_dicts(stats):
    """(busy, wait) per-site dicts: from the stats object's
    ``MetricsRegistry`` when it carries one (the PrefetchStats form —
    the single store), else the deprecated bare-attribute shim for
    plain objects (kept so pre-registry callers and tests keep
    working)."""
    reg = getattr(stats, "registry", None)
    if reg is not None and hasattr(reg, "values_by_label"):
        from keystone_tpu_torch.obs.metrics import (
            METRIC_SITE_BUSY_S,
            METRIC_SITE_WAIT_S,
        )

        return (
            reg.values_by_label(METRIC_SITE_BUSY_S, "site"),
            reg.values_by_label(METRIC_SITE_WAIT_S, "site"),
        )
    _warn_legacy_stats("overlap_report")
    return (
        dict(getattr(stats, "site_busy_s", {}) or {}),
        dict(getattr(stats, "site_wait_s", {}) or {}),
    )


def _warn_legacy_stats(fn_name: str) -> None:
    import warnings

    warnings.warn(
        f"{fn_name}: reading bare stats attributes is deprecated — pass "
        "a PrefetchStats (whose MetricsRegistry is the single metrics "
        "store, keystone_tpu/obs) instead of a plain object",
        DeprecationWarning, stacklevel=3,
    )


def prefetch_retry_counters(stats) -> Dict[str, float]:
    """Reliability accounting of one streamed fit's ingestion
    (docs/reliability.md): how many transient read failures the retry
    layer absorbed (``retries``) and the backoff wall it paid for them
    (``backoff_s``), from the fit's
    ``PrefetchStats``. Zero/zero on a
    healthy run — the steady-state cost of the retry layer is nothing
    but the counters themselves. Nonzero values mean the fit SUCCEEDED
    over flaky IO; alert on them before they become exhaustions.

    Reads the stats object's ``MetricsRegistry`` when it carries one;
    bare attributes remain as a deprecated shim."""
    reg = getattr(stats, "registry", None)
    if reg is not None and hasattr(reg, "snapshot"):
        from keystone_tpu_torch.obs.metrics import (
            METRIC_PREFETCH_BACKOFF_S,
            METRIC_PREFETCH_RETRIES,
        )

        snap = reg.snapshot()
        return {
            "retries": int(snap.get(METRIC_PREFETCH_RETRIES, 0) or 0),
            "backoff_s": float(
                snap.get(METRIC_PREFETCH_BACKOFF_S, 0.0) or 0.0
            ),
        }
    _warn_legacy_stats("prefetch_retry_counters")
    return {
        "retries": int(getattr(stats, "retries", 0) or 0),
        "backoff_s": float(getattr(stats, "backoff_s", 0.0) or 0.0),
    }


@dataclass(frozen=True)
class RequestSpan:
    """Where one served request's latency went (the serving analog of a
    PhaseTimer breakdown): ``queue_wait_s`` is time spent queued before
    its batch dispatched, ``exec_s`` the batch's execution wall (shared
    by every request coalesced into it), ``batch_size`` the real
    requests in the batch, ``bucket`` the padded shape it ran at, and
    ``pad_fraction`` the share of bucket rows that were padding — the
    amortization price the micro-batcher paid for a warm compile-cache
    hit."""

    queue_wait_s: float
    exec_s: float
    batch_size: int
    bucket: int
    pad_fraction: float
    # Which replica of a replicated serving plane executed the batch
    # (None on a standalone MicroBatchServer) — per-replica span
    # attribution for serving/replicas.py's aggregate stats.
    replica: Optional[int] = None


class SpanLog:
    """Bounded, thread-safe log of :class:`RequestSpan` records.

    The micro-batcher records one span per request from its worker
    thread while ``stats()`` readers snapshot from submitter threads;
    the lock keeps the snapshot consistent and ``maxlen`` bounds a
    long-lived server's profiling memory."""

    def __init__(self, maxlen: int = 4096):
        self._spans: "deque[RequestSpan]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self.recorded = 0  # spans ever recorded: a mark for since()

    def record(self, span: RequestSpan) -> None:
        with self._lock:
            self._spans.append(span)
            self.recorded += 1

    def snapshot(self) -> List[RequestSpan]:
        with self._lock:
            return list(self._spans)

    def since(self, mark: int) -> List[RequestSpan]:
        """The retained spans recorded after ``recorded`` read ``mark``."""
        with self._lock:
            n = min(self.recorded - mark, len(self._spans))
            return list(self._spans)[len(self._spans) - n:] if n > 0 else []

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def summary(self) -> Dict[str, float]:
        """Mean queue wait / exec / pad fraction over the retained window
        (empty dict when nothing has been served)."""
        return summarize_spans(self.snapshot())


def summarize_spans(spans: Sequence["RequestSpan"]) -> Dict[str, float]:
    """The one summary shape for a span collection (SpanLog.summary, the
    per-replica blocks, and callers holding an already-snapshotted list
    — no second ring copy). Empty dict for no spans — EXPLICITLY: the
    empty case is a contract, not a numpy mean-of-empty-slice warning
    . Non-finite span fields raise ValueError naming
    the field: a NaN queue wait silently poisons every mean downstream,
    and numpy would only warn."""
    spans = list(spans)
    if not spans:
        return {}
    n = float(len(spans))
    sums = {"mean_queue_wait_s": 0.0, "mean_exec_s": 0.0,
            "mean_batch_size": 0.0, "mean_pad_fraction": 0.0}
    for i, s in enumerate(spans):
        for key, v in (
            ("mean_queue_wait_s", s.queue_wait_s),
            ("mean_exec_s", s.exec_s),
            ("mean_batch_size", s.batch_size),
            ("mean_pad_fraction", s.pad_fraction),
        ):
            v = float(v)
            if v != v or v in (float("inf"), float("-inf")):
                raise ValueError(
                    f"summarize_spans: span {i} has non-finite "
                    f"{key.replace('mean_', '')} ({v}) — refusing to "
                    "fold it into the means"
                )
            sums[key] += v
    return {"num_spans": len(spans),
            **{k: v / n for k, v in sums.items()}}


def latency_percentiles(
    latencies_s: Sequence[float], qs: Sequence[float] = (50.0, 99.0)
) -> Optional[Dict[str, float]]:
    """p-th percentile latencies in SECONDS keyed ``p50``/``p99``/...;
    None for an empty sample (a server that has completed nothing has no
    percentiles — callers must not report zeros as measurements).

    Edge cases are explicit contracts, not numpy warnings: a single
    sample IS every percentile (p50 == p99 == the sample — documented,
    tested); an out-of-range ``q`` raises ValueError naming it (numpy's own message names neither the value
    nor the caller); a NaN/inf sample raises ValueError instead of
    propagating NaN percentiles under a RuntimeWarning; an empty ``qs``
    raises rather than returning a vacuous ``{}`` that reads as "no
    latency problem". Accepts any iterable (a generator no longer
    TypeErrors on ``len``)."""
    import math

    import numpy as np

    samples = [float(v) for v in latencies_s]
    if not samples:
        return None
    qs = list(qs)
    if not qs:
        raise ValueError(
            "latency_percentiles: qs is empty — an empty percentile "
            "request is a caller bug, not a measurement"
        )
    for q in qs:
        if not 0.0 <= float(q) <= 100.0:
            raise ValueError(
                f"latency_percentiles: q={q!r} outside [0, 100]"
            )
    bad = [v for v in samples if not math.isfinite(v)]
    if bad:
        raise ValueError(
            f"latency_percentiles: {len(bad)} non-finite sample(s) "
            f"(first: {bad[0]!r}) — percentiles over NaN/inf are not "
            "measurements"
        )
    arr = np.asarray(samples, dtype=np.float64)
    return {f"p{int(q) if float(q).is_integer() else q}": float(v)
            for q, v in zip(qs, np.percentile(arr, list(qs)))}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of everything run inside the
    context and write it as a Chrome trace, ``log_dir/trace.json``
    (``chrome://tracing`` or ui.perfetto.dev load it). CUDA activity is
    recorded when a card is present. No-op, with a warning, if the
    profiler cannot start (e.g. a second concurrent profiler).

    This is the device-timeline leg of the obs plane: ``obs.tracing(dir,
    xla_profile=True)`` wraps the traced block in it, writing under
    ``dir/xla`` beside the span trace, so the deep-dive device view and
    the host-side span view come from ONE activation."""
    import os

    import torch
    from torch import profiler as torch_profiler

    activities = [torch_profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch_profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch_profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # pragma: no cover - depends on runtime state
        logger.warning("profiler trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
