"""Online inference subsystem: exported apply plans + deadline-aware
micro-batching + open-loop load tooling (port of
``keystone_tpu/serving/__init__.py``, docs/serving.md).

The offline tiers fit pipelines and apply them to whole datasets; this
package turns a :class:`~keystone_tpu_torch.workflow.pipeline.FittedPipeline`
into something that serves streams of single-datum requests:

  - :func:`export_plan` / :class:`ExportedPlan` — apply-only subgraph,
    re-run through the fusion optimizer, weights pinned on the serving
    device, one program per power-of-two padding bucket (a CUDA graph on
    the card; the warm path never captures).
  - :class:`MicroBatchServer` — deadline-aware request coalescing on a
    background worker thread, bounded queue with explicit
    earliest-deadline load shedding, circuit breaker, worker watchdog,
    per-request spans, rolling p50/p99.
  - :class:`ReplicatedServer` — N replicas behind one
    admission-controlled front door: least-loaded routing with
    per-replica breakers, watchdog restarts within a bounded budget,
    zero-drop atomic hot-swap of the plan under live traffic, and the
    zero-drop add / remove and brownout-ladder primitives.
  - :func:`run_open_loop` / :func:`closed_loop_qps` — Poisson load
    generation and the batch-size-1 baseline.
  - :class:`LifecycleController` — validation-gated publication of new
    plan versions (finite weights, bucket bit identity, held-out
    quality), canary rollout with rollback, the post-promotion
    attribution window and the model-staleness clock.

The reference's autoscaler (``serving/autoscale.py``), multi-tenant zoo
(``serving/zoo.py``) and process fleet (``serving/fleet*.py``) are not
ported yet.
"""

from .batcher import (
    MicroBatchServer,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
)
from .export import BatchInfo, ExportedPlan, export_plan, plan_fingerprint
from .lifecycle import LifecycleController, LifecycleDecision
from .loadgen import (
    LoadReport,
    closed_loop_qps,
    poisson_arrivals,
    run_open_loop,
)
from .replicas import BROWNOUT_STEPS, ReplicatedServer

__all__ = [
    "BROWNOUT_STEPS",
    "BatchInfo",
    "ExportedPlan",
    "LifecycleController",
    "LifecycleDecision",
    "LoadReport",
    "MicroBatchServer",
    "ReplicatedServer",
    "ServerClosed",
    "ServerDegraded",
    "ServerOverloaded",
    "closed_loop_qps",
    "export_plan",
    "plan_fingerprint",
    "poisson_arrivals",
    "run_open_loop",
]
