"""Process-global pipeline environment and logical prefixes.

Mirrors the reference's PipelineEnv + Prefix (reference:
workflow/PipelineEnv.scala:7-46, Prefix.scala:4-30): a process-global table
mapping the *logical prefix* of a node (its operator plus the prefixes of its
dependencies, recursively) to an already-computed Expression, so fitted
estimators and cached datasets are reused across pipeline applications; plus
the currently installed whole-pipeline optimizer.

Port of ``keystone_tpu/workflow/env.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

from .graph import Graph, NodeId, SourceId
from .operators import Expression, Operator

if TYPE_CHECKING:  # pragma: no cover
    from .optimizer import Optimizer


class Prefix:
    """Logical hash of a node: its operator + prefixes of its ordered deps.

    Immutable; the hash is computed once at construction so that shared
    sub-prefixes in diamond-shaped DAGs don't make hashing quadratic.
    """

    __slots__ = ("operator", "deps", "_hash")

    def __init__(self, operator: Operator, deps: Tuple["Prefix", ...]):
        self.operator = operator
        self.deps = tuple(deps)
        self._hash = hash((operator, self.deps))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Prefix)
            and self._hash == other._hash
            and self.operator == other.operator
            and self.deps == other.deps
        )

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        return f"Prefix({self.operator.label}, deps={len(self.deps)})"

    @staticmethod
    def find(graph: Graph, node: NodeId, _memo: Optional[dict] = None) -> "Prefix":
        """Compute the prefix of `node`. Errors if any ancestor is a source.

        Memoized per-call so shared (diamond) subgraphs are traversed once.
        """
        if _memo is None:
            _memo = {}
        if node in _memo:
            return _memo[node]
        deps = []
        for dep in graph.get_dependencies(node):
            if isinstance(dep, SourceId):
                raise ValueError(
                    "May not get the prefix of a node with Sources in the dependencies."
                )
            deps.append(Prefix.find(graph, dep, _memo))
        out = Prefix(graph.get_operator(node), tuple(deps))
        _memo[node] = out
        return out


class PipelineEnv:
    """Global state shared by all pipelines in the process. Not thread-safe."""

    _instance: Optional["PipelineEnv"] = None

    def __init__(self) -> None:
        self.state: Dict[Prefix, Expression] = {}
        self._optimizer: Optional["Optimizer"] = None

    @classmethod
    def get_or_create(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    @property
    def optimizer(self) -> "Optimizer":
        if self._optimizer is None:
            from .optimizer import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    def set_optimizer(self, optimizer: "Optimizer") -> None:
        self._optimizer = optimizer

    def reset(self) -> None:
        """Clear prefix state and optimizer (test fixture hook, PipelineContext.scala:9-42).

        Also clears the autocache observed-profile table: its keys hash
        DatasetOperators by dataset id(), and letting entries outlive the
        env generation would widen the window for a recycled id to alias a
        stale profile onto different data."""
        self.state.clear()
        self._optimizer = None
        from . import autocache

        autocache.clear_observed_profiles()
