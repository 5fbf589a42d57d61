"""Memoized pull-based graph execution (reference: workflow/GraphExecutor.scala:14-81).

Port of ``keystone_tpu/workflow/executor.py``. On first demand the
executor (optionally) runs the global whole-pipeline optimizer, then
recursively evaluates the requested id's dependency chain, memoizing each
node's Expression and publishing results for nodes whose prefix was marked
by the optimizer into the global PipelineEnv state table.

Profile collection: every source-free node's first force is timed and its
result size estimated, feeding the autocache observed-profile table. The
executor runs the OPTIMIZED graph, so what gets measured is the cost of the
post-fusion nodes themselves — the full-scale ground truth AutoCacheRule
prefers over its sampled extrapolations when placing caches. A runtime
failure carries the plan verifier's coordinates (node, operator, input
signatures). Under the obs tracer the lazy path's optimization is one
``executor.optimize`` span and each node's first force an
``executor.node`` span, as in the reference.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, Optional

import torch

from . import analysis
from .env import PipelineEnv, Prefix
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import Expression, ExpressionOperator


def _drain(value) -> None:
    """Wait for the card's work on a value's tensors (a Dataset's payload
    or a bare tensor): one ``torch.cuda.synchronize`` of each CUDA device
    they lie on. Host values return at once."""
    from keystone_tpu_torch.data.dataset import tree_leaves

    data = getattr(value, "data", value)
    if isinstance(data, list):
        return
    devices = {leaf.device for leaf in tree_leaves(data)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


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
        self._profile_key_memo: Dict[NodeId, Prefix] = {}

    def _ensure_optimized(self) -> Graph:
        if self._optimized_graph is None:
            from keystone_tpu_torch import obs

            # The lazy path's counterpart of Pipeline.fit's fit.optimize
            # span: pipelines driven through .get()/apply() optimize here,
            # and the optimizer.rule.* spans need this parent to read as
            # one phase in the trace.
            with obs.span("executor.optimize", nodes=len(self.graph.operators)):
                graph, prefixes = PipelineEnv.get_or_create().optimizer.execute(
                    self.graph, {}
                )
            self._optimized_graph = graph
            self._prefixes = prefixes
        return self._optimized_graph

    @property
    def optimized_graph(self) -> Graph:
        return self._ensure_optimized()

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
            operator = graph.get_operator(graph_id)
            expression = operator.execute(dep_exprs)
            self._observe(graph, graph_id, operator, dep_exprs, expression)
            self._annotate_failures(graph_id, operator, dep_exprs, expression)
            self._trace_node(graph_id, operator, expression)
            # Publish results the optimizer marked for prefix-state reuse.
            if self._prefixes and graph_id in self._prefixes:
                PipelineEnv.get_or_create().state[self._prefixes[graph_id]] = expression

        self._execution_state[graph_id] = expression
        return expression

    def _trace_node(self, graph_id, operator, expression) -> None:
        """Wrap the node's thunk in an ``executor.node`` span: lazy
        pipelines do their work at first force, on whatever thread demands
        the value, and deps force inside the thunk, so spans nest into the
        causal tree the executor ran. Wrapped outside ``_observe`` and
        ``_annotate_failures`` so the span covers the node's whole forced
        wall; one no-op branch a force when tracing is off.
        ExpressionOperator splices are skipped (their value was computed
        elsewhere)."""
        if isinstance(operator, ExpressionOperator):
            return
        orig = getattr(expression, "_thunk", None)
        if orig is None:  # already computed (shared expression)
            return
        from keystone_tpu_torch import obs

        def traced():
            with obs.span("executor.node", node=graph_id.id,
                          operator=type(operator).__name__):
                return orig()

        expression._thunk = traced

    def _annotate_failures(self, graph_id, operator, dep_exprs, expression) -> None:
        """Wrap the node's thunk so a runtime failure carries the same
        coordinates a static-verifier report would: the NodeId, the
        operator class, and the inferred signatures of its inputs. The
        exception TYPE is preserved (the context is appended in place,
        once, at the deepest failing node) so callers' except clauses
        keep matching — see verify.annotate_node_error."""
        orig = getattr(expression, "_thunk", None)
        if orig is None:  # already computed (shared expression)
            return
        from .verify import annotate_node_error

        def annotated():
            try:
                return orig()
            except Exception as e:
                dep_values = [
                    d._value if d._computed else None for d in dep_exprs
                ]
                annotate_node_error(e, graph_id, operator, dep_values)
                raise

        expression._thunk = annotated

    def _observe(self, graph, graph_id, operator, dep_exprs, expression) -> None:
        """Arrange for the node's first force to record an observed profile.

        The expression's thunk is wrapped so that when (and only when) the
        value is actually demanded, the node's own wall time — deps forced
        and drained first — and result bytes land in the autocache
        observed-profile table under the node's logical Prefix.
        ExpressionOperator nodes are skipped (their value was computed
        elsewhere), as are source-dependent nodes (no Prefix). On the card
        this adds two synchronizes a node (:func:`_drain`).
        """
        if isinstance(operator, ExpressionOperator):
            return
        orig = getattr(expression, "_thunk", None)
        if orig is None:  # already computed (shared expression)
            return
        from . import autocache

        key = autocache.observed_profile_key(
            graph, graph_id, self._profile_key_memo
        )
        if key is None:
            return

        def timed():
            # Force AND drain deps BEFORE the clock starts: an upstream
            # node's queued device work would otherwise finish inside this
            # node's timed region and be counted against it.
            for d in dep_exprs:
                _drain(d.get())
            t0 = time.perf_counter()
            value = orig()
            # Drain the node's own launches INSIDE the timed region (the
            # sampled profiler's guard too): kernels return before they
            # finish, and without the sync their time would land on
            # whichever downstream stage first waits.
            _drain(value)
            ns = (time.perf_counter() - t0) * 1e9
            autocache.record_observed_profile(key, ns, autocache._estimate_bytes(value))
            return value

        expression._thunk = timed
