"""Global placement: one audited scheduler over the cost model (port of
``keystone_tpu/placement/__init__.py``).

:mod:`keystone_tpu_torch.placement.engine` prices resource decisions
from the cost model's weight family and emits the unified
``placement.decision`` audit stream;
:mod:`keystone_tpu_torch.placement.planner` replays a recorded trace's
decision streams and answers what-if questions
(``python -m keystone_tpu_torch.tools.plan``).
"""

from keystone_tpu_torch.placement.engine import (
    ALL_KINDS,
    KIND_BROWNOUT,
    KIND_IMAGE_TIER,
    KIND_LIFECYCLE,
    KIND_MESH,
    KIND_REPLICAS,
    KIND_SOLVER,
    KIND_ZOO_EVICT,
    KIND_ZOO_PAGE_IN,
    PLACEMENT_EVENT,
    PlacementChoice,
    PlacementEngine,
    active_family,
)
from keystone_tpu_torch.placement.planner import CapacityPlanner, decision_rows

__all__ = [
    "ALL_KINDS",
    "KIND_BROWNOUT",
    "KIND_IMAGE_TIER",
    "KIND_LIFECYCLE",
    "KIND_MESH",
    "KIND_REPLICAS",
    "KIND_SOLVER",
    "KIND_ZOO_EVICT",
    "KIND_ZOO_PAGE_IN",
    "PLACEMENT_EVENT",
    "PlacementChoice",
    "PlacementEngine",
    "active_family",
    "CapacityPlanner",
    "decision_rows",
]
