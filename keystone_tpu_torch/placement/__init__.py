"""Global placement: one audited scheduler over the cost model (port of
``keystone_tpu/placement/__init__.py``).

:mod:`keystone_tpu_torch.placement.engine` prices resource decisions
from the cost model's weight family and emits the unified
``placement.decision`` audit stream. The reference's capacity planner
(``placement/planner.py``, ``bin/plan``) is not ported.
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
]
