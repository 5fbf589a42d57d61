"""Catalyst-style rule engine for whole-pipeline optimization.

Port of ``keystone_tpu/workflow/optimizer.py``. Mirrors reference
workflow/Rule.scala:12-20 and RuleExecutor.scala:5-87: an optimizer is a
sequence of named batches of rules; each batch runs serially with a
strategy (Once or FixedPoint) until convergence or iteration cap; rule
applications that change the plan are trace-logged as DOT diffs.

``DefaultOptimizer`` carries the saved-state, CSE and node-optimization
batches, then the Stage Fusion and Tree & Fit Fusion batches of
``workflow/fusion.py``, in the reference's order. The Tree & Fit batch has
the gather, estimator and streamed-fit fusion rules. The reference's static
plan verifier pre-pass and autocache optimizer are not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .env import Prefix
from .graph import Graph, NodeId

logger = logging.getLogger("keystone_tpu_torch.optimizer")

Plan = Tuple[Graph, Dict[NodeId, Prefix]]


class Rule:
    """A plan transformation producing a logically equivalent plan."""

    @property
    def rule_name(self) -> str:
        return type(self).__name__

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        raise NotImplementedError


@dataclass(frozen=True)
class Once:
    max_iterations: int = 1


@dataclass(frozen=True)
class FixedPoint:
    max_iterations: int = 2**31 - 1


@dataclass
class Batch:
    name: str
    strategy: object
    rules: Sequence[Rule]


def _plans_equal(a: Plan, b: Plan) -> bool:
    return a[0] == b[0] and a[1] == b[1]


class RuleExecutor:
    """Executes rule batches serially; subclasses define ``batches``."""

    batches: List[Batch] = []

    def execute(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        cur: Plan = (plan, dict(prefixes))
        for batch in self.batches:
            batch_start = cur
            iteration = 1
            last = cur
            while True:
                for rule in batch.rules:
                    result = rule.apply(cur[0], cur[1])
                    if not _plans_equal(result, cur):
                        logger.debug(
                            "=== Applying Rule %s ===\n%s\n%s",
                            rule.rule_name,
                            cur[0].to_dot(),
                            result[0].to_dot(),
                        )
                    cur = result
                iteration += 1
                if iteration > batch.strategy.max_iterations:
                    if iteration != 2:
                        logger.info(
                            "Max iterations (%d) reached for batch %s",
                            iteration - 1,
                            batch.name,
                        )
                    break
                if _plans_equal(cur, last):
                    logger.debug(
                        "Fixed point reached for batch %s after %d iterations.",
                        batch.name,
                        iteration - 1,
                    )
                    break
                last = cur

            if _plans_equal(batch_start, cur):
                logger.debug("Batch %s has no effect.", batch.name)

        return cur


class Optimizer(RuleExecutor):
    """Base class for whole-pipeline optimizers (DefaultOptimizer.scala)."""


class DefaultOptimizer(Optimizer):
    """Standard batches: saved-state load, CSE to fixpoint, node-level
    optimization (reference: workflow/DefaultOptimizer.scala:8-14), then
    stage fusion and gather/fit fusion."""

    def __init__(self) -> None:
        from .fusion import (
            EstimatorFusionRule,
            GatherFusionRule,
            StageFusionRule,
            StreamedFitFusionRule,
        )
        from .rules import (
            EquivalentNodeMergeRule,
            ExtractSaveablePrefixes,
            NodeOptimizationRule,
            SavedStateLoadRule,
            UnusedBranchRemovalRule,
        )

        self.batches = [
            Batch(
                "Load Saved State",
                Once(),
                [ExtractSaveablePrefixes(), SavedStateLoadRule(), UnusedBranchRemovalRule()],
            ),
            Batch(
                "Common Sub-expression Elimination",
                FixedPoint(),
                [EquivalentNodeMergeRule()],
            ),
            Batch("Node Level Optimization", Once(), [NodeOptimizationRule()]),
            # Fuse chains of row-local device transformers, then gather trees
            # and trailing estimator fits (workflow/fusion.py). Last, so CSE
            # and prefix extraction see the original node granularity.
            Batch("Stage Fusion", Once(), [StageFusionRule()]),
            Batch(
                "Tree & Fit Fusion",
                Once(),
                [GatherFusionRule(), EstimatorFusionRule(), StreamedFitFusionRule()],
            ),
        ]
