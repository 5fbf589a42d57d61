"""Named, registered metrics: counters / gauges / histograms (port of
``keystone_tpu/obs/metrics.py``, the same catalogue and merge rules).

Before this module, operational counters were ad-hoc attributes: the
data-plane runtime's per-lane ``tasks/errors/busy_s``, the serving
breaker's ``completed/rejected/failed/breaker_opens``, the per-fit
``PrefetchStats`` site accounting. Each grew its own locking, its own
snapshot shape, and its own (unchecked) names. A :class:`MetricsRegistry`
replaces that plumbing: one get-or-create API, one flat ``snapshot()``
shape every ``stats()``/bench reader consumes, and every name drawn from
the ``METRIC_*`` catalogue below.

The catalogue is the contract: ``tools/lint.py``'s ``metric-name`` rule
PARSES (never imports) this module for ``METRIC_*`` assignments — the
same discipline as the fault-site registry — and rejects any
register/lookup site whose dotted name is not in it, so dashboards can't
silently fork names. Labels (``site=``, ``lane=``) carry the
per-instance dimension; snapshot keys render as ``name{k=v}``.

No torch, no numpy: the registry is updated from serving worker
threads and read from any thread.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "BucketedHistogram",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "METRIC_AUTOSCALE_BROWNOUT_LEVEL",
    "METRIC_AUTOSCALE_DECISIONS",
    "METRIC_AUTOSCALE_REPLICAS",
    "METRIC_AUTOSCALE_SCALE_DOWNS",
    "METRIC_AUTOSCALE_SCALE_UPS",
    "METRIC_CALIBRATION_DECISIONS",
    "METRIC_CALIBRATION_DRIFT",
    "METRIC_CALIBRATION_ERROR",
    "METRIC_CALIBRATION_MISROUTES",
    "METRIC_CALIBRATION_REGRET_S",
    "METRIC_EXPORTER_ERRORS",
    "METRIC_EXPORTER_PUBLISHES",
    "METRIC_EXPORTER_PUBLISH_S",
    "METRIC_LIFECYCLE_CANARY_PROMOTIONS",
    "METRIC_LIFECYCLE_PUBLISHED",
    "METRIC_LIFECYCLE_REJECTED",
    "METRIC_LIFECYCLE_ROLLBACKS",
    "METRIC_LIFECYCLE_STALENESS_S",
    "METRIC_PLACEMENT_DECISIONS",
    "METRIC_PLACEMENT_INFEASIBLE",
    "METRIC_PREFETCH_BACKOFF_S",
    "METRIC_PREFETCH_LOAD_S",
    "METRIC_PREFETCH_RETRIES",
    "METRIC_PREFETCH_SEGMENTS",
    "METRIC_PREFETCH_WAIT_S",
    "METRIC_RUNTIME_LANE_BUSY_S",
    "METRIC_RUNTIME_LANE_ERRORS",
    "METRIC_RUNTIME_LANE_QUEUED",
    "METRIC_RUNTIME_LANE_TASKS",
    "METRIC_SERVING_BREAKER_OPENS",
    "METRIC_SERVING_COMPLETED",
    "METRIC_SERVING_DEGRADED_REJECTED",
    "METRIC_SERVING_FAILED",
    "METRIC_SERVING_LATENCY_S",
    "METRIC_SERVING_QUEUE_DEPTH",
    "METRIC_SERVING_REJECTED",
    "METRIC_SITE_BUSY_S",
    "METRIC_SITE_WAIT_S",
    "METRIC_SLO_BUDGET_SPENT",
    "METRIC_SLO_BURN_FAST",
    "METRIC_SLO_BURN_SLOW",
    "METRIC_SLO_STATE",
    "METRIC_SLO_TRANSITIONS",
    "METRIC_TENANT_COLDSTART_FAILFAST",
    "METRIC_TENANT_COMPLETED",
    "METRIC_TENANT_FAILED",
    "METRIC_TENANT_OFFERED",
    "METRIC_TENANT_REJECTED",
    "METRIC_TRAINER_RESUMES",
    "METRIC_TRAINER_SEGMENTS_FIT",
    "METRIC_ZOO_DECISIONS",
    "METRIC_ZOO_PAGE_INS",
    "METRIC_ZOO_PAGE_OUTS",
    "METRIC_ZOO_QUARANTINED",
    "METRIC_ZOO_RESIDENTS",
]

# ---------------------------------------------------------------------------
# Metric catalogue — the ONLY names a register/lookup site may use
# (parsed, not imported, by tools/lint.py's metric-name rule; the docs
# table in docs/observability.md mirrors this list).
# ---------------------------------------------------------------------------

# Data-plane runtime, per lane (label: site=<lane>) — DataPlaneRuntime.stats()
METRIC_RUNTIME_LANE_TASKS = "runtime.lane.tasks"
METRIC_RUNTIME_LANE_ERRORS = "runtime.lane.errors"
METRIC_RUNTIME_LANE_BUSY_S = "runtime.lane.busy_s"
METRIC_RUNTIME_LANE_QUEUED = "runtime.lane.queued"

# Per-fit ingestion (PrefetchStats) — overlap + retry accounting
METRIC_PREFETCH_LOAD_S = "prefetch.load_s"
METRIC_PREFETCH_WAIT_S = "prefetch.wait_s"
METRIC_PREFETCH_SEGMENTS = "prefetch.segments"
METRIC_PREFETCH_RETRIES = "prefetch.retries"
METRIC_PREFETCH_BACKOFF_S = "prefetch.backoff_s"
# Per-site overlap accounting (label: site=read/verify/checkpoint/compute)
METRIC_SITE_BUSY_S = "overlap.site_busy_s"
METRIC_SITE_WAIT_S = "overlap.site_wait_s"

# Serving (MicroBatchServer) — the breaker/throughput counters stats() reads
METRIC_SERVING_COMPLETED = "serving.completed"
METRIC_SERVING_REJECTED = "serving.rejected"
METRIC_SERVING_FAILED = "serving.failed"
METRIC_SERVING_BREAKER_OPENS = "serving.breaker_opens"
METRIC_SERVING_DEGRADED_REJECTED = "serving.degraded_rejected"
METRIC_SERVING_LATENCY_S = "serving.latency_s"
METRIC_SERVING_QUEUE_DEPTH = "serving.queue_depth"

# Live SLO plane (obs/slo.py), per declared objective (label: objective=)
METRIC_SLO_BURN_FAST = "slo.burn_rate_fast"
METRIC_SLO_BURN_SLOW = "slo.burn_rate_slow"
METRIC_SLO_BUDGET_SPENT = "slo.budget_spent_fraction"
METRIC_SLO_STATE = "slo.state"  # 0=OK 1=WARN 2=BREACH
METRIC_SLO_TRANSITIONS = "slo.transitions"

# Live exporter (obs/live.py) — the publisher thread's own accounting
METRIC_EXPORTER_PUBLISHES = "exporter.publishes"
METRIC_EXPORTER_ERRORS = "exporter.errors"
METRIC_EXPORTER_PUBLISH_S = "exporter.publish_s"

# SLO-closed-loop autoscaler (serving/autoscale.py) — the control
# plane's own accounting, published into the serving plane's registry so
# the live exporter renders scale state beside the SLO verdict.
METRIC_AUTOSCALE_REPLICAS = "autoscale.replicas"
METRIC_AUTOSCALE_SCALE_UPS = "autoscale.scale_ups"
METRIC_AUTOSCALE_SCALE_DOWNS = "autoscale.scale_downs"
METRIC_AUTOSCALE_BROWNOUT_LEVEL = "autoscale.brownout_level"
METRIC_AUTOSCALE_DECISIONS = "autoscale.decisions"

# Cost-model calibration plane (obs/calibrate.py) — predicted-vs-measured
# audit of the cost.decision trail. calibration.error is the |log error|
# distribution per engine (label: engine=<candidate label>);
# calibration.drift is the gate verdict (1 = fresh traces disagree with
# the active weights past the stated threshold).
METRIC_CALIBRATION_ERROR = "calibration.error"
METRIC_CALIBRATION_DECISIONS = "calibration.decisions"
METRIC_CALIBRATION_MISROUTES = "calibration.misroutes"
METRIC_CALIBRATION_REGRET_S = "calibration.regret_s"
METRIC_CALIBRATION_DRIFT = "calibration.drift"

# Multi-tenant model zoo (serving/zoo.py) — residency/paging counters
# plus the per-tenant front-door accounting (label: tenant=<id>), so the
# live exporter renders every tenant's offered/completed/rejected/failed
# beside the plane counters and the per-tenant SLO verdicts.
METRIC_ZOO_RESIDENTS = "zoo.residents"
METRIC_ZOO_PAGE_INS = "zoo.page_ins"
METRIC_ZOO_PAGE_OUTS = "zoo.page_outs"
METRIC_ZOO_QUARANTINED = "zoo.quarantined"
METRIC_ZOO_DECISIONS = "zoo.decisions"
METRIC_TENANT_OFFERED = "tenant.offered"
METRIC_TENANT_COMPLETED = "tenant.completed"
METRIC_TENANT_REJECTED = "tenant.rejected"
METRIC_TENANT_FAILED = "tenant.failed"
METRIC_TENANT_COLDSTART_FAILFAST = "tenant.coldstart_failfast"

# Continuous-learning control plane (serving/lifecycle.py +
# learning/continuous.py) — the publication path's own accounting:
# candidates published/rejected at the validation gate, canary
# promotions vs rollbacks (canary OR post-promotion SLO-attributed),
# and the model-staleness clock (newest covered shard arrival -> first
# response served under the covering fingerprint). The trainer counters
# ride beside them: segments folded and checkpoint resumes.
METRIC_LIFECYCLE_PUBLISHED = "lifecycle.published"
METRIC_LIFECYCLE_REJECTED = "lifecycle.rejected"
METRIC_LIFECYCLE_ROLLBACKS = "lifecycle.rollbacks"
METRIC_LIFECYCLE_CANARY_PROMOTIONS = "lifecycle.canary_promotions"
METRIC_LIFECYCLE_STALENESS_S = "lifecycle.staleness_s"
METRIC_TRAINER_SEGMENTS_FIT = "trainer.segments_fit"
METRIC_TRAINER_RESUMES = "trainer.resumes"

# Global placement engine (placement/engine.py) — the unified
# placement.decision stream's own accounting: decisions audited, and
# candidates priced infeasible (the capacity cuts the planner replays).
METRIC_PLACEMENT_DECISIONS = "placement.decisions"
METRIC_PLACEMENT_INFEASIBLE = "placement.infeasible_candidates"


class Counter:
    """Monotonic-by-convention accumulator (float). ``set_()`` exists
    only for the attribute-compatibility shims that migrated legacy
    ``stats.load_s += dt`` call sites onto the registry."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def add(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def set_(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, liveness)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def _interp_percentile(vals: "List[float]", q: float) -> Optional[float]:
    """Linear-interpolation percentile over SORTED values (numpy's
    default convention): None when empty, the sample itself when
    single. The one implementation behind ``Histogram.percentile`` and
    ``Histogram.stats_snapshot`` — the empty/single-sample contract is
    pinned by tests and must not fork."""
    if not vals:
        return None
    if len(vals) == 1:
        return vals[0]
    pos = (q / 100.0) * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


class Histogram:
    """Bounded-reservoir distribution: keeps the most recent ``maxlen``
    observations (the rolling-window convention the serving stats
    already used) plus lifetime count/sum. Percentiles are exact over
    the retained window, computed by linear interpolation (the same
    convention as numpy's default, so ``latency_percentiles`` agrees)."""

    __slots__ = ("_lock", "_window", "count", "total")

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._window: "deque[float]" = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._window.append(v)
            self.count += 1
            self.total += v

    def snapshot_values(self) -> list:
        with self._lock:
            return list(self._window)

    def percentile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            vals = sorted(self._window)
        return _interp_percentile(vals, q)

    def stats_snapshot(self) -> Dict[str, Any]:
        """count/sum/p50/p99 read under ONE lock acquisition, so a
        snapshot raced against concurrent ``observe()`` calls is a
        consistent point-in-time view (count can never read AHEAD of the
        window the percentiles were computed from)."""
        with self._lock:
            count, total = self.count, self.total
            vals = sorted(self._window)
        return {"count": count, "sum": total,
                "p50": _interp_percentile(vals, 50.0),
                "p99": _interp_percentile(vals, 99.0)}


class BucketedHistogram:
    """Mergeable log-bucketed distribution: fixed exponential buckets,
    O(1) memory for unbounded runs, EXACT cross-replica merge.

    This is the latency-metric store for long-lived serving processes.
    The 4096-sample ring (:class:`Histogram`) keeps only the most recent
    window, which silently biases a multi-hour serve's p99 toward the
    last few seconds; log buckets keep the WHOLE run at bounded memory
    and merge exactly across replicas (bucket counts add — there is no
    resampling step to lose tail mass in). The price is resolution: a
    percentile is reported as its bucket's geometric midpoint, so it is
    exact only to within one bucket width (``growth`` per bucket,
    default 8%/bucket — tests pin the merged-vs-concatenated bound).

    Contracts shared with the sample-ring class (the same conventions,
    pinned in tests): an EMPTY histogram's ``percentile`` is ``None``
    (never a fabricated zero); a SINGLE sample IS every percentile
    (returned exactly — the observed min/max clamp makes the one-sample
    bucket estimate collapse to the sample itself); an out-of-range
    ``q`` raises ValueError naming the bound.

    ``observe(value, exemplar=...)`` optionally attaches a trace
    reference to the value's bucket (latest wins, one per bucket —
    bounded): the bucket→trace-id exemplar map that links a p99 breach
    to the offending request traces (:meth:`exemplars_at_or_above`).
    """

    # Shared bucket geometry: every instance merges with every other.
    _LO = 1e-6       # values at/below 1µs share the underflow bucket
    _GROWTH = 1.08   # ~8% relative resolution per bucket

    __slots__ = ("_lock", "_buckets", "_exemplars", "count", "total",
                 "_min", "_max")

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, int] = {}
        self._exemplars: Dict[int, str] = {}
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    @classmethod
    def bucket_index(cls, value: float) -> int:
        if value <= cls._LO:
            return 0
        return 1 + int(math.log(value / cls._LO) / math.log(cls._GROWTH))

    @classmethod
    def bucket_bounds(cls, index: int) -> Tuple[float, float]:
        """(lo, hi] value bounds of one bucket (lo == 0 for the
        underflow bucket)."""
        if index <= 0:
            return 0.0, cls._LO
        return (cls._LO * cls._GROWTH ** (index - 1),
                cls._LO * cls._GROWTH ** index)

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        v = float(value)
        # NaN would silently poison count/sum/percentiles; +/-inf would
        # escape bucket_index as a raw OverflowError — one named error.
        if not math.isfinite(v):
            raise ValueError(
                f"BucketedHistogram.observe: value must be finite, "
                f"got {v}"
            )
        idx = self.bucket_index(v)
        with self._lock:
            self._buckets[idx] = self._buckets.get(idx, 0) + 1
            self.count += 1
            self.total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[idx] = exemplar

    def merge(self, other: "BucketedHistogram") -> "BucketedHistogram":
        """Fold ``other``'s buckets into self (exact: counts add). The
        cross-replica aggregation step — merged percentiles equal the
        percentile of the concatenated observation stream to within one
        bucket width (property-tested)."""
        with other._lock:
            buckets = dict(other._buckets)
            exemplars = dict(other._exemplars)
            count, total = other.count, other.total
            mn, mx = other._min, other._max
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            self._exemplars.update(exemplars)
            self.count += count
            self.total += total
            self._min = min(self._min, mn)
            self._max = max(self._max, mx)
        return self

    def state_dict(self) -> Dict[str, Any]:
        """JSON-safe serialized form for CROSS-PROCESS merge (the fleet
        router merges per-plane histograms scraped over
        ``/snapshot.json``). Bucket keys are stringified indices; the
        shared class-level geometry means :meth:`merge_state` on the
        receiving side is exactly :meth:`merge` — counts add, no
        resampling, the exact-merge property preserved over the
        wire. Exemplars ride along (latest-wins on merge)."""
        with self._lock:
            return {
                "geometry": {"lo": self._LO, "growth": self._GROWTH},
                "count": self.count,
                "sum": self.total,
                "min": self._min if self.count else None,
                "max": self._max if self.count else None,
                "buckets": {str(i): c for i, c in self._buckets.items()},
                "exemplars": dict(self._exemplars),
            }

    @classmethod
    def from_state(cls, state: Dict[str, Any]) -> "BucketedHistogram":
        """Rebuild from :meth:`state_dict` (e.g. after a JSON round
        trip). Raises ValueError on a geometry mismatch — merging
        histograms bucketed under different geometries would silently
        misplace every count."""
        h = cls()
        h.merge_state(state)
        return h

    def merge_state(self, state: Dict[str, Any]) -> "BucketedHistogram":
        """Fold a serialized peer into self — the cross-process form of
        :meth:`merge`, with the same exactness (counts add)."""
        geo = state.get("geometry") or {}
        if (float(geo.get("lo", self._LO)) != self._LO
                or float(geo.get("growth", self._GROWTH)) != self._GROWTH):
            raise ValueError(
                f"histogram geometry mismatch: peer {geo} vs local "
                f"lo={self._LO} growth={self._GROWTH}"
            )
        buckets = {int(i): int(c)
                   for i, c in (state.get("buckets") or {}).items()}
        count = int(state.get("count", 0))
        total = float(state.get("sum", 0.0))
        mn = state.get("min")
        mx = state.get("max")
        with self._lock:
            for idx, c in buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + c
            for idx, ex in (state.get("exemplars") or {}).items():
                self._exemplars[int(idx)] = str(ex)
            self.count += count
            self.total += total
            if mn is not None:
                self._min = min(self._min, float(mn))
            if mx is not None:
                self._max = max(self._max, float(mx))
        return self

    def _percentile_locked(self, q: float) -> Optional[float]:
        if not self.count:
            return None
        # Nearest-rank walk over cumulative bucket counts; the estimate
        # is the bucket's geometric midpoint clamped into the OBSERVED
        # [min, max] — which makes a single-sample histogram return the
        # sample exactly (min == max == the value).
        rank = max(int(math.ceil((q / 100.0) * self.count)), 1)
        seen = 0
        for idx in sorted(self._buckets):
            seen += self._buckets[idx]
            if seen >= rank:
                lo, hi = self.bucket_bounds(idx)
                mid = math.sqrt(lo * hi) if lo > 0.0 else hi / 2.0
                return min(max(mid, self._min), self._max)
        return self._max  # pragma: no cover - rank <= count always hits

    def percentile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            return self._percentile_locked(q)

    def stats_snapshot(self) -> Dict[str, Any]:
        """count/sum/p50/p99 under ONE lock acquisition (the same
        consistent-view contract as :meth:`Histogram.stats_snapshot`)."""
        with self._lock:
            return {
                "count": self.count, "sum": self.total,
                "p50": self._percentile_locked(50.0),
                "p99": self._percentile_locked(99.0),
            }

    def exemplars_at_or_above(self, q: float, limit: int = 4) -> List[str]:
        """Trace references attached to the buckets at or above the
        q-th percentile's bucket (worst first) — the p99→trace link a
        breach investigation starts from."""
        with self._lock:
            p = self._percentile_locked(q)
            if p is None or not self._exemplars:
                return []
            cut = self.bucket_index(p)
            return [
                self._exemplars[idx]
                for idx in sorted(self._exemplars, reverse=True)
                if idx >= cut
            ][:limit]


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    ``counter(name, **labels)`` / ``gauge(...)`` / ``histogram(...)``
    are both registration and lookup — the same call shape at the
    definition site and every reader, so there is nothing to keep in
    sync. A name re-used at a different type raises (one name, one
    meaning). ``snapshot()`` flattens everything to one dict —
    ``name`` or ``name{k=v,...}`` keys — which is the ONE shape
    ``stats()`` methods and bench rows read.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, Any]):
        return name, tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _get_or_create(self, cls, name: str, labels, **kw):
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(**kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{labels or ''} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, maxlen: int = 4096, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, maxlen=maxlen)

    def bucketed_histogram(self, name: str, **labels) -> BucketedHistogram:
        """The mergeable log-bucketed form — the right store for
        LONG-LIVED latency metrics (serving): O(1) memory over unbounded
        runs, exact cross-replica merge. Short-lived fit phases keep the
        exact sample-ring :meth:`histogram`."""
        return self._get_or_create(BucketedHistogram, name, labels)

    def labels_of(self, name: str) -> list:
        """The label-sets registered under ``name`` (e.g. every lane a
        runtime has created), as dicts."""
        with self._lock:
            return [
                dict(lbls) for (n, lbls) in self._metrics if n == name
            ]

    def values_by_label(self, name: str, label: str) -> Dict[str, float]:
        """``{label_value: metric_value}`` for one labeled counter/gauge
        family — the shape the per-site overlap dicts are built from."""
        out: Dict[str, float] = {}
        with self._lock:
            items = list(self._metrics.items())
        for (n, lbls), m in items:
            d = dict(lbls)
            if n == name and label in d and hasattr(m, "value"):
                out[d[label]] = m.value
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Flat dict of every registered metric. Counters/gauges map to
        their value; histograms (ring and bucketed) expand to ``.count``
        / ``.sum`` / ``.p50`` / ``.p99`` sub-keys. Safe against
        concurrent ``observe()``/``add()`` from worker threads: each
        histogram's four sub-keys come from ONE ``stats_snapshot()``
        lock acquisition, so the expanded values are mutually consistent
        and counters read monotonically across successive snapshots."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for (name, lbls), m in items:
            key = name
            if lbls:
                key += "{" + ",".join(f"{k}={v}" for k, v in lbls) + "}"
            if isinstance(m, (Histogram, BucketedHistogram)):
                st = m.stats_snapshot()
                out[key + ".count"] = st["count"]
                out[key + ".sum"] = st["sum"]
                out[key + ".p50"] = st["p50"]
                out[key + ".p99"] = st["p99"]
            else:
                out[key] = m.value
        return out
