"""The run-trace + metrics plane (port of ``keystone_tpu/obs/__init__.py``).

  - :mod:`~keystone_tpu_torch.obs.tracer` — a process-wide :class:`Tracer`
    with nested, thread-safe spans carrying one ``run_id`` and parent
    links; the serving plane's requests, batches, sheds and swaps report
    into it. The plane is a **no-op guarded by one branch** when tracing
    is off.
  - :mod:`~keystone_tpu_torch.obs.metrics` — :class:`MetricsRegistry`
    (counters / gauges / histograms with a flat ``snapshot()``) and the
    ``METRIC_*`` name catalogue; the serving counters and latency
    histograms live there.
  - :mod:`~keystone_tpu_torch.obs.slo` — :class:`SLOTracker`: multi-window
    burn rates, the error-budget ledger and the OK / WARN / BREACH state.
  - :mod:`~keystone_tpu_torch.obs.export` — Chrome-trace/Perfetto JSON
    exporter plus a compact JSONL event log (``write_trace_dir``).
  - :mod:`~keystone_tpu_torch.obs.flight` — the flight recorder: a bounded
    ring of recent events that fault paths (worker death, breaker opens,
    watchdog evictions) dump alongside the exception.
  - :mod:`~keystone_tpu_torch.obs.calibrate` — the cost-model calibration
    plane: joins every ``cost.decision`` with the measured seconds of the
    work it priced, reports prediction error by engine and weight family,
    flags mis-routes with their regret, refits the weight family
    (``KEYSTONE_COST_WEIGHTS=calibrated:<artifact>``) and gates on drift
    (``python -m keystone_tpu_torch.tools.calibrate``).
  - :mod:`~keystone_tpu_torch.obs.live` — the live exporter: Prometheus
    text over HTTP and atomic JSON snapshots while a server runs.

Activation: ``KEYSTONE_TRACE=dir`` env knob, ``run.py --trace=dir``, or
``with obs.tracing(dir):`` in code. This package imports no torch: the
serving plane's submitter threads report into it.
"""

from keystone_tpu_torch.obs.calibrate import (
    calibration_report,
    drift_gate,
    join_decisions,
    load_calibration_artifact,
    refit,
    write_calibration_artifact,
)
from keystone_tpu_torch.obs.export import (
    load_events,
    to_chrome_trace,
    validate_chrome_trace,
    write_trace_dir,
)
from keystone_tpu_torch.obs.flight import (
    FlightRecorder,
    flight_note,
    flight_snapshot,
    render_flight_record,
)
from keystone_tpu_torch.obs.live import LiveExporter, render_prometheus
from keystone_tpu_torch.obs.metrics import (  # noqa: F401 — METRIC_* re-exported
    BucketedHistogram,
    MetricsRegistry,
)
from keystone_tpu_torch.obs.metrics import __all__ as _metrics_all
from keystone_tpu_torch.obs.metrics import *  # noqa: F401,F403 — the catalogue
from keystone_tpu_torch.obs.slo import (
    STATE_BREACH,
    STATE_OK,
    STATE_WARN,
    SLOObjective,
    SLOTracker,
)
from keystone_tpu_torch.obs.tracer import (
    CostDecision,
    CostOutcomeRef,
    Span,
    TailSampler,
    Tracer,
    active_tracer,
    counter_track,
    enabled,
    event,
    record_cost_decision,
    span,
    tracing,
    tracing_from_env,
)

__all__ = [
    "CostDecision",
    "CostOutcomeRef",
    "FlightRecorder",
    "LiveExporter",
    "MetricsRegistry",
    "STATE_BREACH",
    "STATE_OK",
    "STATE_WARN",
    "SLOObjective",
    "SLOTracker",
    "Span",
    "TailSampler",
    "Tracer",
    "active_tracer",
    "calibration_report",
    "counter_track",
    "drift_gate",
    "enabled",
    "event",
    "flight_note",
    "flight_snapshot",
    "join_decisions",
    "load_calibration_artifact",
    "load_events",
    "record_cost_decision",
    "refit",
    "write_calibration_artifact",
    "render_flight_record",
    "render_prometheus",
    "span",
    "to_chrome_trace",
    "tracing",
    "tracing_from_env",
    "validate_chrome_trace",
    "write_trace_dir",
] + list(_metrics_all)
