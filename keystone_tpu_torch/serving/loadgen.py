"""Open-loop Poisson load generation + the batch-size-1 baseline (port
of ``keystone_tpu/serving/loadgen.py``; its multi-tenant forms,
``MultiTenantLoadReport`` and ``run_multi_tenant_open_loop``, wait for
the model zoo).

Open loop is the honest way to measure serving latency: arrivals follow
the schedule regardless of how the server is doing (a closed loop slows
its own offered rate exactly when the server struggles — coordinated
omission — and reports flattering percentiles). The generator sleeps to
each Poisson arrival, submits, and stamps completion via a done-callback
(resolved on the batcher's worker thread at set_result time), so request
latency never includes the harness's own result-collection order.

The batch-size-1 baseline (:func:`closed_loop_qps`) is the A/B the bench
row states its throughput claim against: one request per dispatch, no
coalescing — what serving looks like without the micro-batcher.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from keystone_tpu_torch.utils import profiling

from .batcher import ServerClosed, ServerDegraded, ServerOverloaded

__all__ = [
    "LoadReport",
    "closed_loop_qps",
    "poisson_arrivals",
    "run_open_loop",
]


def poisson_arrivals(rate_hz: float, duration_s: float, seed: int = 0):
    """Arrival offsets (seconds from start) of a Poisson process at
    ``rate_hz`` over ``duration_s`` — exponential inter-arrivals."""
    if rate_hz <= 0 or duration_s <= 0:
        raise ValueError("rate_hz and duration_s must be positive")
    rng = np.random.default_rng(seed)
    # Draw enough exponentials to cover the window with slack, then trim.
    n_guess = max(int(rate_hz * duration_s * 1.5) + 16, 16)
    t = np.cumsum(rng.exponential(1.0 / rate_hz, size=n_guess))
    while t[-1] < duration_s:
        t = np.concatenate(
            [t, t[-1] + np.cumsum(rng.exponential(1.0 / rate_hz, size=n_guess))]
        )
    return t[t < duration_s]


@dataclass
class LoadReport:
    """One open-loop run at one offered rate, with everything a latency
    claim needs to be auditable (sample counts + offered rate ride with
    the percentiles — the bench conventions test enforces the same rule
    on emitted rows)."""

    offered_rate_hz: float
    duration_s: float
    num_offered: int
    completed: int
    rejected: int
    failed: int
    p50_latency_s: Optional[float]
    p99_latency_s: Optional[float]
    mean_latency_s: Optional[float]
    achieved_qps: Optional[float]
    latencies_s: List[float] = field(default_factory=list, repr=False)
    # Per-replica / per-plan-version completion attribution, populated
    # when the submit target annotates futures with ``replica_index`` /
    # ``plan_fingerprint`` (the ReplicatedServer contract). Empty dicts
    # against a standalone MicroBatchServer.
    per_replica_completed: Dict[int, int] = field(default_factory=dict)
    per_fingerprint_completed: Dict[str, int] = field(default_factory=dict)
    # The SLO verdict at the end of the run (an SLOTracker.verdict()
    # dict — states, burn rates, budget ledger), populated when the
    # storm is handed the tracker the serving plane feeds. None when no
    # SLO is declared.
    slo: Optional[Dict[str, Any]] = None

    def to_row_dict(self) -> Dict[str, Any]:
        """The bench-facing dict: percentiles WITH their sample count and
        offered rate in the same dict (make_row's latency audit rule)."""
        out = {
            "offered_rate_hz": round(self.offered_rate_hz, 2),
            "duration_s": round(self.duration_s, 3),
            "num_samples": self.completed,
            "num_offered": self.num_offered,
            "rejected": self.rejected,
            "failed": self.failed,
            "p50_latency_ms": (
                round(self.p50_latency_s * 1e3, 3)
                if self.p50_latency_s is not None else None
            ),
            "p99_latency_ms": (
                round(self.p99_latency_s * 1e3, 3)
                if self.p99_latency_s is not None else None
            ),
            "achieved_qps": (
                round(self.achieved_qps, 2)
                if self.achieved_qps is not None else None
            ),
        }
        if self.per_replica_completed:
            # String keys: this dict is JSON-facing (bench rows), and
            # the row auditors walk keys as strings.
            out["per_replica_completed"] = {
                str(k): v
                for k, v in sorted(self.per_replica_completed.items())
            }
        if self.per_fingerprint_completed:
            out["per_fingerprint_completed"] = dict(
                sorted(self.per_fingerprint_completed.items())
            )
        if self.slo is not None:
            # Compact verdict for the row: states + burn rates + budget
            # per objective. The full transition log / ledger stays on
            # ``report.slo`` for rows that publish the whole story.
            out["slo"] = {
                "state": self.slo.get("state"),
                "objectives": {
                    name: {
                        "state": o.get("state"),
                        "burn_fast": o.get("burn_fast"),
                        "burn_slow": o.get("burn_slow"),
                        "budget_spent_fraction": o.get(
                            "budget_spent_fraction"
                        ),
                        "num_transitions": len(o.get("transitions") or []),
                    }
                    for name, o in (self.slo.get("objectives") or {}).items()
                },
            }
        return out


def run_open_loop(
    submit: Callable[[Any], Any],
    make_request: Callable[[int], Any],
    rate_hz: float,
    duration_s: float,
    seed: int = 0,
    result_timeout_s: float = 60.0,
    slo=None,
) -> LoadReport:
    """Drive ``submit`` (e.g. ``server.submit``) with Poisson arrivals at
    ``rate_hz`` for ``duration_s``; block until every outstanding future
    resolves; return the :class:`LoadReport`.

    ``make_request(i)`` produces the i-th request payload. Rejections
    (ServerOverloaded — at submit() or through the future) count as
    ``rejected``; any other failure counts as ``failed``, including a
    submit() that fails fast synchronously (ServerDegraded while a
    breaker is open or every replica is down, ServerClosed) — the
    storm must keep offering through a degraded window and account for
    it, not crash with no report. Latency is submit→completion
    (completion stamped by a done-callback on the resolving thread).

    ``slo``: the :class:`~keystone_tpu_torch.obs.slo.SLOTracker` the serving
    plane under test FEEDS (``MicroBatchServer(slo=...)`` /
    ``ReplicatedServer(slo=...)``); the storm does not feed it — it
    evaluates it once at the end and attaches the verdict block (state,
    burn rates, budget ledger) to the report, so an open-loop run's
    latency claim and its SLO verdict come from the same window."""
    arrivals = poisson_arrivals(rate_hz, duration_s, seed=seed)
    records = []  # (t_submitted, future, stamp_dict)
    rejected = 0
    failed = 0
    t_start = time.perf_counter()
    for i, t_arr in enumerate(arrivals):
        delay = (t_start + t_arr) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        x = make_request(i)
        stamp: Dict[str, float] = {}
        t_sub = time.perf_counter()
        try:
            fut = submit(x)
        except ServerOverloaded:
            rejected += 1
            continue
        except (ServerDegraded, ServerClosed):
            failed += 1
            continue
        fut.add_done_callback(
            lambda f, s=stamp: s.setdefault("t_done", time.perf_counter())
        )
        records.append((t_sub, fut, stamp))

    latencies: List[float] = []
    per_replica: Dict[int, int] = {}
    per_fingerprint: Dict[str, int] = {}
    for t_sub, fut, stamp in records:
        try:
            fut.result(timeout=result_timeout_s)
        except ServerOverloaded:
            rejected += 1
            continue
        except Exception:  # ServerClosed, plan errors, timeouts
            failed += 1
            continue
        latencies.append(stamp.get("t_done", time.perf_counter()) - t_sub)
        # Replicated-plane attribution (absent on a standalone server):
        # which replica completed it, under which plan fingerprint.
        rep = getattr(fut, "replica_index", None)
        if rep is not None:
            per_replica[rep] = per_replica.get(rep, 0) + 1
        fp = getattr(fut, "plan_fingerprint", None)
        if fp is not None:
            per_fingerprint[fp] = per_fingerprint.get(fp, 0) + 1

    pct = profiling.latency_percentiles(latencies)
    completed = len(latencies)
    wall = time.perf_counter() - t_start
    verdict = None
    if slo is not None:
        slo.evaluate()  # one final pass on the post-storm clock
        verdict = slo.verdict()
    return LoadReport(
        offered_rate_hz=rate_hz,
        duration_s=duration_s,
        num_offered=len(arrivals),
        completed=completed,
        rejected=rejected,
        failed=failed,
        p50_latency_s=pct["p50"] if pct else None,
        p99_latency_s=pct["p99"] if pct else None,
        mean_latency_s=(sum(latencies) / completed) if completed else None,
        achieved_qps=(completed / wall) if completed and wall > 0 else None,
        latencies_s=latencies,
        per_replica_completed=per_replica,
        per_fingerprint_completed=per_fingerprint,
        slo=verdict,
    )


def closed_loop_qps(
    apply_one: Callable[[Any], Any],
    make_request: Callable[[int], Any],
    num_requests: int = 64,
) -> Dict[str, float]:
    """The naive batch-size-1 serving baseline: sequential single-datum
    requests, one dispatch each, no coalescing. Returns achieved qps and
    per-request latency stats (warm — the first request is untimed)."""
    apply_one(make_request(0))  # warm
    lat = []
    t0 = time.perf_counter()
    for i in range(num_requests):
        t1 = time.perf_counter()
        apply_one(make_request(i))
        lat.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    pct = profiling.latency_percentiles(lat)
    return {
        "qps": num_requests / wall,
        "num_samples": num_requests,
        "mean_latency_s": sum(lat) / len(lat),
        "p50_latency_s": pct["p50"],
        "p99_latency_s": pct["p99"],
    }
