"""Memoized pull-based graph execution (reference: workflow/GraphExecutor.scala:14-81).

Port of ``keystone_tpu/workflow/executor.py``. On first demand the
executor (optionally) runs the global whole-pipeline optimizer, then
recursively evaluates the requested id's dependency chain, memoizing each
node's Expression and publishing results for nodes whose prefix was marked
by the optimizer into the global PipelineEnv state table.

The reference's tracing spans, autocache profile collection and
verifier error annotation are not part of this slice.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

from . import analysis
from .env import PipelineEnv, Prefix
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import Expression


class GraphExecutor:
    """Executes parts of a graph, memoizing results. Not thread-safe."""

    def __init__(
        self,
        graph: Graph,
        optimize: bool = True,
        prefixes: Optional[Mapping[NodeId, Prefix]] = None,
    ):
        self.graph = graph
        self.optimize = optimize
        self._optimized_graph: Optional[Graph] = graph if not optimize else None
        self._prefixes: Optional[Mapping[NodeId, Prefix]] = prefixes
        self._execution_state: Dict[GraphId, Expression] = {}

    def _ensure_optimized(self) -> Graph:
        if self._optimized_graph is None:
            graph, prefixes = PipelineEnv.get_or_create().optimizer.execute(
                self.graph, {}
            )
            self._optimized_graph = graph
            self._prefixes = prefixes
        return self._optimized_graph

    def _source_dependants(self, graph: Graph) -> set:
        out = set()
        for source in graph.sources:
            out |= analysis.get_descendants(graph, source)
            out.add(source)
        return out

    def execute(self, graph_id: GraphId) -> Expression:
        graph = self._ensure_optimized()
        if graph_id in self._source_dependants(graph):
            raise ValueError("May not execute GraphIds that depend on unconnected sources.")
        return self._execute(graph, graph_id)

    def _execute(self, graph: Graph, graph_id: GraphId) -> Expression:
        if graph_id in self._execution_state:
            return self._execution_state[graph_id]

        if isinstance(graph_id, SourceId):
            raise ValueError("SourceIds may not be executed.")
        if isinstance(graph_id, SinkId):
            expression = self._execute(graph, graph.get_sink_dependency(graph_id))
        else:
            dep_exprs = [self._execute(graph, dep) for dep in graph.get_dependencies(graph_id)]
            expression = graph.get_operator(graph_id).execute(dep_exprs)
            # Publish results the optimizer marked for prefix-state reuse.
            if self._prefixes and graph_id in self._prefixes:
                PipelineEnv.get_or_create().state[self._prefixes[graph_id]] = expression

        self._execution_state[graph_id] = expression
        return expression
