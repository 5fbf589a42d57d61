"""Catalyst-style rule engine for whole-pipeline optimization.

Port of ``keystone_tpu/workflow/optimizer.py``. Mirrors reference
workflow/Rule.scala:12-20 and RuleExecutor.scala:5-87: an optimizer is a
sequence of named batches of rules; each batch runs serially with a
strategy (Once or FixedPoint) until convergence or iteration cap; rule
applications that change the plan are trace-logged as DOT diffs, and each
application is an ``optimizer.rule.<name>`` span under the obs tracer.

Every optimizer run starts with the static plan verifier
(``workflow/verify.py``). ``DefaultOptimizer`` carries the saved-state, CSE
and node-optimization batches, then the Stage Fusion and Tree & Fit Fusion
batches of ``workflow/fusion.py``, in the reference's order. The Tree & Fit
batch has the gather, estimator and streamed-fit fusion rules.
``AutoCachingOptimizer`` adds cache placement (``workflow/autocache.py``)
after the fusion batches.
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
        from keystone_tpu_torch import obs

        for batch in self.batches:
            batch_start = cur
            iteration = 1
            last = cur
            while True:
                for rule in batch.rules:
                    # One span a rule application: the trace shows where
                    # optimization time went and which rules changed the
                    # plan. The name and attributes are built only when
                    # tracing is on.
                    if obs.enabled():
                        with obs.span(
                            f"optimizer.rule.{rule.rule_name}",
                            batch=batch.name, iteration=iteration,
                        ) as sp:
                            result = rule.apply(cur[0], cur[1])
                            changed = not _plans_equal(result, cur)
                            sp.set(changed=changed)
                    else:
                        result = rule.apply(cur[0], cur[1])
                        changed = not _plans_equal(result, cur)
                    if changed:
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
    """Base class for whole-pipeline optimizers (DefaultOptimizer.scala).

    Every optimizer run starts with the static plan verifier
    (workflow/verify.py): an invalid candidate plan — shape mismatch,
    estimator state consumed as data — is rejected with a structured
    :class:`~keystone_tpu_torch.workflow.verify.PlanVerificationError`
    BEFORE any rule, cost model, or kernel touches it.
    ``KEYSTONE_VERIFY=off`` disables the pre-pass.
    """

    def execute(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        from .verify import verify_fit_graph

        verify_fit_graph(plan, context="optimizer input plan")
        return super().execute(plan, prefixes)


def _load_batch() -> Batch:
    from .rules import ExtractSaveablePrefixes, SavedStateLoadRule, UnusedBranchRemovalRule

    return Batch(
        "Load Saved State",
        Once(),
        [ExtractSaveablePrefixes(), SavedStateLoadRule(), UnusedBranchRemovalRule()],
    )


def _front_batches() -> List[Batch]:
    """Saved-state load, CSE to fixpoint, node-level optimization."""
    from .rules import EquivalentNodeMergeRule, NodeOptimizationRule

    return [
        _load_batch(),
        Batch("Common Sub-expression Elimination", FixedPoint(), [EquivalentNodeMergeRule()]),
        Batch("Node Level Optimization", Once(), [NodeOptimizationRule()]),
    ]


def _fusion_batches() -> List[Batch]:
    """Fuse chains of row-local device transformers, then gather trees and
    trailing estimator fits (workflow/fusion.py)."""
    from .fusion import (
        EstimatorFusionRule,
        GatherFusionRule,
        StageFusionRule,
        StreamedFitFusionRule,
    )

    return [
        Batch("Stage Fusion", Once(), [StageFusionRule()]),
        Batch(
            "Tree & Fit Fusion",
            Once(),
            [GatherFusionRule(), EstimatorFusionRule(), StreamedFitFusionRule()],
        ),
    ]


class DefaultOptimizer(Optimizer):
    """Standard batches: saved-state load, CSE to fixpoint, node-level
    optimization (reference: workflow/DefaultOptimizer.scala:8-14), then
    stage fusion and gather/fit fusion — last, so CSE and prefix
    extraction see the original node granularity."""

    def __init__(self) -> None:
        self.batches = _front_batches() + _fusion_batches()


class AutoCachingOptimizer(Optimizer):
    """DefaultOptimizer plus cache placement (reference:
    DefaultOptimizer.scala:19-26).

    Cache placement runs on the POST-fusion plan — the plan that will
    actually run (the reference's defining property): the fusion batches
    collapse device-pure regions first; AutoCacheRule then profiles the
    surviving nodes — host stages, multi-consumer intermediates, fused
    outputs — and every insertion lands on a fused-stage boundary by
    construction. The batch closes with a prefix re-extraction and a
    saved-state load, so the Cachers it just placed take part in cross-fit
    reuse through the PipelineEnv state table (a λ-sweep's later fits load
    the cached boundary result instead of recomputing the stage).

    ``cache_before_fusion=True`` keeps the pre-fusion order (cache first,
    fuse around the materialization points), for A/B measurement.
    """

    def __init__(self, strategy=None, cache_before_fusion: bool = False) -> None:
        from .autocache import AutoCacheRule, GreedyCache
        from .rules import ExtractSaveablePrefixes, SavedStateLoadRule, UnusedBranchRemovalRule

        cache_rule = AutoCacheRule(strategy or GreedyCache())
        if cache_before_fusion:
            # Cached / prefix nodes are excluded from chains, so fusion
            # never hides a materialization point.
            self.batches = (
                _front_batches()
                + [Batch("Auto Cache", Once(), [cache_rule])]
                + _fusion_batches()
            )
        else:
            self.batches = _front_batches() + _fusion_batches() + [
                Batch(
                    "Auto Cache (post-fusion)",
                    Once(),
                    [
                        cache_rule,
                        # The Cachers just placed are saveable materialization
                        # points: mark them (merge — earlier marks win), load
                        # any boundary result a previous fit already
                        # published, and drop branches the loads made dead.
                        ExtractSaveablePrefixes(),
                        SavedStateLoadRule(),
                        UnusedBranchRemovalRule(),
                    ],
                ),
            ]
