"""Graph traversal queries (reference: workflow/AnalysisUtils.scala:3-122).

Port of ``keystone_tpu/workflow/analysis.py``, carried across unchanged."""

from __future__ import annotations

from typing import List, Set

from .graph import Graph, GraphId, NodeId, SinkId, SourceId


def get_parents(graph: Graph, gid: GraphId) -> Set[GraphId]:
    """Direct dependencies of a graph id (empty for sources)."""
    if isinstance(gid, SourceId):
        return set()
    if isinstance(gid, NodeId):
        return set(graph.get_dependencies(gid))
    if isinstance(gid, SinkId):
        return {graph.get_sink_dependency(gid)}
    raise TypeError(f"Unknown graph id {gid!r}")


def get_children(graph: Graph, gid: GraphId) -> Set[GraphId]:
    """Direct dependents of a graph id (empty for sinks)."""
    if isinstance(gid, SinkId):
        return set()
    children: Set[GraphId] = {
        n for n, deps in graph.dependencies.items() if gid in deps
    }
    children |= {s for s, d in graph.sink_dependencies.items() if d == gid}
    return children


def get_ancestors(graph: Graph, gid: GraphId) -> Set[GraphId]:
    """All transitive dependencies of a graph id (not including itself)."""
    out: Set[GraphId] = set()
    stack = list(get_parents(graph, gid))
    while stack:
        cur = stack.pop()
        if cur not in out:
            out.add(cur)
            stack.extend(get_parents(graph, cur))
    return out


def get_descendants(graph: Graph, gid: GraphId) -> Set[GraphId]:
    """All transitive dependents of a graph id (not including itself)."""
    out: Set[GraphId] = set()
    stack = list(get_children(graph, gid))
    while stack:
        cur = stack.pop()
        if cur not in out:
            out.add(cur)
            stack.extend(get_children(graph, cur))
    return out


def linearize(graph: Graph, gid: GraphId = None) -> List[GraphId]:
    """Deterministic topological ordering.

    With a target id: the ancestors of that id in dependency order, ending at
    the id itself. Without: the whole graph (all sinks' chains, sinks sorted).

    Iterative (explicit stack) on purpose: the static verifier and the
    executor walk arbitrarily deep pipelines, and a recursive DFS dies at
    Python's recursion limit around a ~1000-node chain.
    """
    order: List[GraphId] = []
    seen: Set[GraphId] = set()

    def visit(root: GraphId) -> None:
        # Each stack frame is (id, expanded?): first visit pushes the
        # parents (reverse-sorted so the smallest pops first), the second
        # emits the id after its parents have been emitted.
        stack = [(root, False)]
        while stack:
            cur, expanded = stack.pop()
            if expanded:
                order.append(cur)
                continue
            if cur in seen:
                continue
            seen.add(cur)
            stack.append((cur, True))
            for parent in sorted(
                get_parents(graph, cur), key=_sort_key, reverse=True
            ):
                if parent not in seen:
                    stack.append((parent, False))

    if gid is not None:
        visit(gid)
    else:
        for sink in sorted(graph.sink_dependencies.keys()):
            visit(sink)
    return order


def _sort_key(gid: GraphId):
    kind = {SourceId: 0, NodeId: 1, SinkId: 2}[type(gid)]
    return (kind, gid.id)
