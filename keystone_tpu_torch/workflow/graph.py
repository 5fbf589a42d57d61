"""Untyped dataflow DAG underlying every pipeline.

Port of ``keystone_tpu/workflow/graph.py``, carried across unchanged.

Semantics mirror the reference workflow graph (reference:
src/main/scala/keystoneml/workflow/Graph.scala:32-457): a graph is an immutable
value made of *sources* (unbound inputs), *nodes* (an operator plus ordered
dependencies on nodes/sources), and *sinks* (named outputs, each depending on
exactly one node or source). All surgery operations (``add_node``, ``add_graph``,
``connect_graph``, ``replace_nodes``, ...) return new ``Graph`` values.

The implementation here is fresh and Python-idiomatic (frozen dataclasses over
plain dicts treated as immutable); only the behavioral contract is shared with
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, Mapping, Sequence, Set, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover
    from .operators import Operator


@dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self) -> str:
        return f"Source({self.id})"


@dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self) -> str:
        return f"Node({self.id})"


@dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self) -> str:
        return f"Sink({self.id})"


# Union aliases matching the reference's GraphId hierarchy (GraphId.scala:7-31).
NodeOrSourceId = Union[NodeId, SourceId]
GraphId = Union[NodeId, SourceId, SinkId]


class GraphError(ValueError):
    """Raised on invalid graph surgery (the analog of Scala `require` failures)."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise GraphError(msg)


@dataclass(frozen=True)
class Graph:
    """Immutable dataflow DAG.

    Attributes:
      sources: set of all SourceIds.
      sink_dependencies: SinkId -> NodeOrSourceId it observes.
      operators: NodeId -> Operator stored at that node.
      dependencies: NodeId -> ordered tuple of NodeOrSourceId inputs.
    """

    sources: frozenset = field(default_factory=frozenset)
    sink_dependencies: Mapping[SinkId, NodeOrSourceId] = field(default_factory=dict)
    operators: Mapping[NodeId, "Operator"] = field(default_factory=dict)
    dependencies: Mapping[NodeId, Tuple[NodeOrSourceId, ...]] = field(default_factory=dict)

    # -- basic accessors ----------------------------------------------------

    @property
    def nodes(self) -> Set[NodeId]:
        return set(self.operators.keys())

    @property
    def sinks(self) -> Set[SinkId]:
        return set(self.sink_dependencies.keys())

    def get_dependencies(self, node: NodeId) -> Tuple[NodeOrSourceId, ...]:
        return tuple(self.dependencies[node])

    def get_sink_dependency(self, sink: SinkId) -> NodeOrSourceId:
        return self.sink_dependencies[sink]

    def get_operator(self, node: NodeId) -> "Operator":
        return self.operators[node]

    def _ids(self) -> Set[NodeOrSourceId]:
        out: Set[NodeOrSourceId] = set(self.operators.keys())
        out |= set(self.sources)
        return out

    # -- fresh id allocation ------------------------------------------------

    def _next_node_ids(self, num: int) -> Tuple[NodeId, ...]:
        max_id = max((n.id for n in self.operators), default=0)
        return tuple(NodeId(max_id + i) for i in range(1, num + 1))

    def _next_source_ids(self, num: int) -> Tuple[SourceId, ...]:
        max_id = max((s.id for s in self.sources), default=0)
        return tuple(SourceId(max_id + i) for i in range(1, num + 1))

    def _next_sink_ids(self, num: int) -> Tuple[SinkId, ...]:
        max_id = max((s.id for s in self.sink_dependencies), default=0)
        return tuple(SinkId(max_id + i) for i in range(1, num + 1))

    # -- single-vertex surgery ----------------------------------------------

    def add_node(self, op: "Operator", deps: Sequence[NodeOrSourceId]) -> Tuple["Graph", NodeId]:
        ids = self._ids()
        _check(all(d in ids for d in deps), "Node must have dependencies on existing ids")
        nid = self._next_node_ids(1)[0]
        return (
            Graph(
                self.sources,
                dict(self.sink_dependencies),
                {**self.operators, nid: op},
                {**self.dependencies, nid: tuple(deps)},
            ),
            nid,
        )

    def add_sink(self, dep: NodeOrSourceId) -> Tuple["Graph", SinkId]:
        _check(dep in self._ids(), "Sink must depend on an existing id")
        sid = self._next_sink_ids(1)[0]
        return (
            Graph(
                self.sources,
                {**self.sink_dependencies, sid: dep},
                dict(self.operators),
                dict(self.dependencies),
            ),
            sid,
        )

    def add_source(self) -> Tuple["Graph", SourceId]:
        sid = self._next_source_ids(1)[0]
        return (
            Graph(
                frozenset(self.sources) | {sid},
                dict(self.sink_dependencies),
                dict(self.operators),
                dict(self.dependencies),
            ),
            sid,
        )

    def set_dependencies(self, node: NodeId, deps: Sequence[NodeOrSourceId]) -> "Graph":
        _check(node in self.dependencies, "Node being updated must exist")
        ids = self._ids()
        _check(all(d in ids for d in deps), "Node must have dependencies on existing ids")
        return Graph(
            self.sources,
            dict(self.sink_dependencies),
            dict(self.operators),
            {**self.dependencies, node: tuple(deps)},
        )

    def set_operator(self, node: NodeId, op: "Operator") -> "Graph":
        _check(node in self.dependencies, "Node being updated must exist")
        return Graph(
            self.sources,
            dict(self.sink_dependencies),
            {**self.operators, node: op},
            dict(self.dependencies),
        )

    def set_sink_dependency(self, sink: SinkId, dep: NodeOrSourceId) -> "Graph":
        _check(sink in self.sink_dependencies, "Sink being updated must exist")
        _check(dep in self._ids(), "Sink must depend on an existing id")
        return Graph(
            self.sources,
            {**self.sink_dependencies, sink: dep},
            dict(self.operators),
            dict(self.dependencies),
        )

    def remove_sink(self, sink: SinkId) -> "Graph":
        _check(sink in self.sink_dependencies, "Sink being removed must exist")
        new_sinks = {k: v for k, v in self.sink_dependencies.items() if k != sink}
        return Graph(self.sources, new_sinks, dict(self.operators), dict(self.dependencies))

    def remove_source(self, source: SourceId) -> "Graph":
        """NOTE: may leave dangling dependencies on the removed source."""
        _check(source in self.sources, "Source being removed must exist")
        return Graph(
            frozenset(s for s in self.sources if s != source),
            dict(self.sink_dependencies),
            dict(self.operators),
            dict(self.dependencies),
        )

    def remove_node(self, node: NodeId) -> "Graph":
        """NOTE: may leave dangling dependencies on the removed node."""
        _check(node in self.operators, "Node being removed must exist")
        return Graph(
            self.sources,
            dict(self.sink_dependencies),
            {k: v for k, v in self.operators.items() if k != node},
            {k: v for k, v in self.dependencies.items() if k != node},
        )

    def replace_dependency(self, old_dep: NodeOrSourceId, new_dep: NodeOrSourceId) -> "Graph":
        _check(new_dep in self._ids(), "Replacement dependency id must exist")
        new_deps = {
            n: tuple(new_dep if d == old_dep else d for d in ds)
            for n, ds in self.dependencies.items()
        }
        new_sink_deps = {
            s: (new_dep if d == old_dep else d) for s, d in self.sink_dependencies.items()
        }
        return Graph(self.sources, new_sink_deps, dict(self.operators), new_deps)

    # -- whole-graph surgery ------------------------------------------------

    def add_graph(
        self, other: "Graph"
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[NodeId, NodeId], Dict[SinkId, SinkId]]:
        """Disjoint union: attach `other`, remapping its ids to avoid collisions.

        Returns (new graph, source id map, node id map, sink id map) for the ids
        of `other` (reference Graph.scala:286-327).
        """
        other_sources = sorted(other.sources)
        other_nodes = sorted(other.operators.keys())
        other_sinks = sorted(other.sink_dependencies.keys())

        src_map = dict(zip(other_sources, self._next_source_ids(len(other_sources))))
        node_map = dict(zip(other_nodes, self._next_node_ids(len(other_nodes))))
        sink_map = dict(zip(other_sinks, self._next_sink_ids(len(other_sinks))))

        def remap(d: NodeOrSourceId) -> NodeOrSourceId:
            return node_map[d] if isinstance(d, NodeId) else src_map[d]

        new_ops = {**self.operators, **{node_map[n]: other.operators[n] for n in other_nodes}}
        new_deps = {
            **self.dependencies,
            **{node_map[n]: tuple(remap(d) for d in other.dependencies[n]) for n in other_nodes},
        }
        new_sources = frozenset(self.sources) | set(src_map.values())
        new_sink_deps = {
            **self.sink_dependencies,
            **{sink_map[s]: remap(other.sink_dependencies[s]) for s in other_sinks},
        }
        return Graph(new_sources, new_sink_deps, new_ops, new_deps), src_map, node_map, sink_map

    def connect_graph(
        self, other: "Graph", splice_map: Mapping[SourceId, SinkId]
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[NodeId, NodeId], Dict[SinkId, SinkId]]:
        """Attach `other`, splicing some of its sources onto this graph's sinks.

        splice_map: {source in `other` -> sink in `self`}. Spliced sources and
        sinks are removed from the result (reference Graph.scala:340-364).
        """
        _check(
            all(s in other.sources for s in splice_map),
            "Must connect to sources that exist in the other graph",
        )
        _check(
            all(k in self.sink_dependencies for k in splice_map.values()),
            "Must connect to sinks that exist in this graph",
        )

        graph, src_map, node_map, sink_map = self.add_graph(other)
        for old_src, sink in splice_map.items():
            src = src_map[old_src]
            sink_dep = self.get_sink_dependency(sink)
            graph = graph.replace_dependency(src, sink_dep).remove_source(src)
        for sink in set(splice_map.values()):
            graph = graph.remove_sink(sink)

        out_src_map = {k: v for k, v in src_map.items() if k not in splice_map}
        return graph, out_src_map, node_map, sink_map

    def replace_nodes(
        self,
        nodes_to_remove: Set[NodeId],
        replacement: "Graph",
        replacement_source_splice: Mapping[SourceId, NodeOrSourceId],
        replacement_sink_splice: Mapping[NodeId, SinkId],
    ) -> "Graph":
        """Swap a set of nodes for an entire replacement graph.

        replacement_source_splice: replacement source -> existing id to feed it.
        replacement_sink_splice: removed node -> replacement sink that now
        supplies its former dependents (reference Graph.scala:379-434).
        """
        _check(
            set(replacement_sink_splice.values()) == replacement.sinks,
            "Must attach all of the replacement's sinks",
        )
        _check(
            all(n in nodes_to_remove for n in replacement_sink_splice),
            "May only replace dependencies on removed nodes",
        )
        _check(
            set(replacement_source_splice.keys()) == replacement.sources,
            "Must attach all of the replacement's sources",
        )
        _check(
            all(
                not (isinstance(v, NodeId) and v in nodes_to_remove)
                for v in replacement_source_splice.values()
            ),
            "May not connect replacement sources to nodes being removed",
        )
        ids = self._ids()
        _check(
            all(v in ids for v in replacement_source_splice.values()),
            "May only connect replacement sources to existing nodes",
        )

        graph = self
        for node in nodes_to_remove:
            graph = graph.remove_node(node)

        graph, src_map, _, sink_map = graph.add_graph(replacement)

        for old_src, target in replacement_source_splice.items():
            src = src_map[old_src]
            graph = graph.replace_dependency(src, target).remove_source(src)

        for removed_node, old_sink in replacement_sink_splice.items():
            sink = sink_map[old_sink]
            replacement_dep = graph.get_sink_dependency(sink)
            graph = graph.replace_dependency(removed_node, replacement_dep)

        final_deps = {d for ds in graph.dependencies.values() for d in ds}
        _check(
            all(n not in final_deps for n in nodes_to_remove),
            "May not have any remaining dangling edges on the removed nodes",
        )

        for sink in set(sink_map.values()):
            graph = graph.remove_sink(sink)
        return graph

    # -- visualization ------------------------------------------------------

    def to_dot(self) -> str:
        """Graphviz DOT rendering, used by the rule executor's trace logging."""

        def name(gid: GraphId) -> str:
            kind = type(gid).__name__.replace("Id", "")
            return f"{kind}_{gid.id}"

        lines = []
        for s in sorted(self.sources):
            lines.append(f'{name(s)} [label="{s}" shape="Msquare"]')
        for n in sorted(self.operators):
            lines.append(f'{name(n)} [label="{self.operators[n].label}"]')
        for s in sorted(self.sink_dependencies):
            lines.append(f'{name(s)} [label="{s}" shape="Msquare"]')
        for n in sorted(self.dependencies):
            for d in self.dependencies[n]:
                lines.append(f"{name(d)} -> {name(n)}")
        for s in sorted(self.sink_dependencies):
            lines.append(f"{name(self.sink_dependencies[s])} -> {name(s)}")
        body = "\n  ".join(lines)
        return "digraph pipeline {\n  rankdir=LR;\n  " + body + "\n}"
