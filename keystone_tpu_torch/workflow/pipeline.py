"""Typed ML API: Transformer / Estimator / LabelEstimator / Pipeline / gather.

Port of ``keystone_tpu/workflow/pipeline.py``. Behavioral contract from the
reference's typed layer (reference: workflow/Transformer.scala:18-70,
Estimator.scala:10-62, LabelEstimator.scala:13-100, Chainable.scala:13-126,
Pipeline.scala:22-155, FittedPipeline.scala:18-48,
PipelineResult.scala:14-21): composition is pure graph surgery; applying a
pipeline returns lazy handles; estimator insertion adds the estimator node
plus a delegating node that applies the *fitted* transformer to the
pipeline's source; ``fit()`` executes all estimators and yields a
serializable transformer-only pipeline.

Not in this slice: the static plan verifier pre-pass of ``fit()``, the
per-shape compiled single-datum program cache of ``FittedPipeline`` (here
a datum walks the graph node by node), and the cost-decision stamping of
estimator fits.
"""

from __future__ import annotations

import pickle
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, TypeVar, Union

from keystone_tpu_torch.data import Dataset

from .executor import GraphExecutor
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    GatherTransformerOperator,
    TransformerOperator,
)

A = TypeVar("A")
B = TypeVar("B")
C = TypeVar("C")
L = TypeVar("L")


# ---------------------------------------------------------------------------
# Lazy result handles
# ---------------------------------------------------------------------------


class PipelineResult(Generic[B]):
    """Lazy wrapper around a scheduled execution; ``.get()`` memoizes."""

    def __init__(self, executor: GraphExecutor, sink: SinkId):
        self.executor = executor
        self.sink = sink
        self._result: Any = None
        self._computed = False

    def get(self) -> B:
        if not self._computed:
            self._result = self.executor.execute(self.sink).get()
            self._computed = True
        return self._result


class PipelineDataset(PipelineResult[B]):
    """Lazy handle on a dataset flowing out of a pipeline."""

    @staticmethod
    def of(dataset: Dataset) -> "PipelineDataset":
        graph, node = Graph().add_node(DatasetOperator(dataset), [])
        graph, sink = graph.add_sink(node)
        return PipelineDataset(GraphExecutor(graph), sink)


class PipelineDatum(PipelineResult[B]):
    """Lazy handle on a single datum flowing out of a pipeline."""

    @staticmethod
    def of(datum: Any) -> "PipelineDatum":
        graph, node = Graph().add_node(DatumOperator(datum), [])
        graph, sink = graph.add_sink(node)
        return PipelineDatum(GraphExecutor(graph), sink)


def _as_pipeline_dataset(data: Any) -> "PipelineDataset":
    if isinstance(data, PipelineDataset):
        return data
    if not isinstance(data, Dataset):
        data = Dataset.of(data)
    return PipelineDataset.of(data)


# ---------------------------------------------------------------------------
# Chainable mixin
# ---------------------------------------------------------------------------


class Chainable(Generic[A, B]):
    """Provides ``and_then`` composition; implementors supply ``to_pipeline``."""

    def to_pipeline(self) -> "Pipeline[A, B]":
        raise NotImplementedError

    def and_then(
        self,
        nxt: Union["Chainable[B, C]", "Estimator", "LabelEstimator"],
        data: Any = None,
        labels: Any = None,
    ) -> "Pipeline[A, C]":
        """Chain a transformer/pipeline, or fit-and-chain an estimator.

        ``and_then(est, data)`` fits ``est`` on this pipeline applied to
        ``data``; ``and_then(label_est, data, labels)`` additionally passes
        labels (Chainable.scala:26-126).
        """
        if isinstance(nxt, LabelEstimator):
            if data is None or labels is None:
                raise ValueError("LabelEstimator chaining requires data and labels")
            me = self.to_pipeline()
            return me.and_then(nxt.with_data(me.apply(data), labels))
        if isinstance(nxt, Estimator):
            if data is None:
                raise ValueError("Estimator chaining requires data")
            me = self.to_pipeline()
            return me.and_then(nxt.with_data(me.apply(data)))
        if data is not None or labels is not None:
            raise ValueError("data/labels only apply when chaining estimators")

        me = self.to_pipeline()
        next_pipe = nxt.to_pipeline()
        new_graph, _, _, sink_mapping = me.executor.graph.connect_graph(
            next_pipe.executor.graph, {next_pipe.source: me.sink}
        )
        return Pipeline(GraphExecutor(new_graph), me.source, sink_mapping[next_pipe.sink])

    # `p | next` sugar for and_then
    def __or__(self, nxt: "Chainable[B, C]") -> "Pipeline[A, C]":
        return self.and_then(nxt)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class Pipeline(Chainable[A, B]):
    """Typed facade over (executor, source, sink). Not thread-safe."""

    def __init__(self, executor: GraphExecutor, source: SourceId, sink: SinkId):
        self.executor = executor
        self.source = source
        self.sink = sink

    def to_pipeline(self) -> "Pipeline[A, B]":
        return self

    def apply(self, data: Any) -> PipelineResult[B]:
        """Lazily apply this pipeline to a datum, Dataset, or lazy handle."""
        if isinstance(data, Dataset):
            return self.apply(PipelineDataset.of(data))
        if isinstance(data, PipelineDataset):
            new_graph, _, _, sink_mapping = data.executor.graph.connect_graph(
                self.executor.graph, {self.source: data.sink}
            )
            return PipelineDataset(
                GraphExecutor(new_graph, self.executor.optimize), sink_mapping[self.sink]
            )
        if isinstance(data, PipelineDatum):
            new_graph, _, _, sink_mapping = data.executor.graph.connect_graph(
                self.executor.graph, {self.source: data.sink}
            )
            return PipelineDatum(
                GraphExecutor(new_graph, self.executor.optimize), sink_mapping[self.sink]
            )
        return self.apply(PipelineDatum.of(data))

    __call__ = apply

    def fit(self) -> "FittedPipeline[A, B]":
        """Fit all estimators, returning a transformer-only serializable pipeline
        (Pipeline.scala:38-65)."""
        from .env import PipelineEnv
        from .rules import UnusedBranchRemovalRule

        optimized, prefixes = PipelineEnv.get_or_create().optimizer.execute(
            self.executor.graph, {}
        )
        # Publish fitted state into the prefix table so later pipelines
        # reuse it.
        fitting_executor = GraphExecutor(optimized, optimize=False, prefixes=prefixes)
        delegating_nodes = [
            n for n, op in optimized.operators.items()
            if isinstance(op, DelegatingOperator)
        ]

        graph = optimized
        for node in delegating_nodes:
            deps = optimized.get_dependencies(node)
            transformer = fitting_executor.execute(deps[0]).get()
            if not isinstance(transformer, TransformerOperator):
                raise TypeError("Estimator fit did not produce a TransformerOperator")
            graph = graph.set_operator(node, transformer).set_dependencies(node, deps[1:])

        graph, _ = UnusedBranchRemovalRule().apply(graph, {})
        return FittedPipeline(TransformerGraph.from_graph(graph), self.source, self.sink)

    @staticmethod
    def gather(branches: Sequence["Pipeline[A, B]"]) -> "Pipeline[A, List[B]]":
        """Combine the outputs of branches applied to one input (Pipeline.scala:119-154)."""
        source = SourceId(0)
        graph = Graph(sources=frozenset({source}))

        branch_sinks: List[GraphId] = []
        for branch in branches:
            graph, source_mapping, _, sink_mapping = graph.add_graph(branch.executor.graph)
            branch_source = source_mapping[branch.source]
            branch_sink = sink_mapping[branch.sink]
            branch_sink_dep = graph.get_sink_dependency(branch_sink)
            graph = (
                graph.replace_dependency(branch_source, source)
                .remove_source(branch_source)
                .remove_sink(branch_sink)
            )
            branch_sinks.append(branch_sink_dep)

        graph, gather_node = graph.add_node(GatherTransformerOperator(), branch_sinks)
        graph, sink = graph.add_sink(gather_node)
        return Pipeline(GraphExecutor(graph), source, sink)


# ---------------------------------------------------------------------------
# TransformerGraph + FittedPipeline
# ---------------------------------------------------------------------------


class TransformerGraph(Graph):
    """A Graph whose every operator is a TransformerOperator — the
    serializable transformer-only restriction backing FittedPipeline
    (reference: TransformerGraph.scala:12-29)."""

    @staticmethod
    def from_graph(graph: Graph) -> "TransformerGraph":
        for _, op in graph.operators.items():
            if not isinstance(op, TransformerOperator):
                raise TypeError(f"Non-transformer operator {op.label} in TransformerGraph")
        return TransformerGraph(
            sources=graph.sources,
            operators=graph.operators,
            dependencies=graph.dependencies,
            sink_dependencies=graph.sink_dependencies,
        )


class FittedPipeline(Generic[A, B]):
    """Transformer-only pipeline: eager, no optimization or fitting on apply.

    Serializable via pickle (``save``/``load``), the analog of the reference's
    Java-serializable FittedPipeline (FittedPipeline.scala:12-48).
    """

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.transformer_graph = graph
        self.source = source
        self.sink = sink

    def apply(self, data: Any) -> Any:
        from . import analysis

        is_dataset = isinstance(data, (Dataset, PipelineDataset))
        if isinstance(data, (PipelineDataset, PipelineDatum)):
            data = data.get()

        values: Dict[GraphId, Any] = {self.source: data}
        for gid in analysis.linearize(self.transformer_graph, self.sink):
            if gid in values:
                continue
            if isinstance(gid, SinkId):
                values[gid] = values[self.transformer_graph.get_sink_dependency(gid)]
            elif isinstance(gid, NodeId):
                op = self.transformer_graph.get_operator(gid)
                inputs = [values[d] for d in self.transformer_graph.get_dependencies(gid)]
                if is_dataset:
                    values[gid] = op.batch_transform(inputs)
                else:
                    values[gid] = op.single_transform(inputs)
            else:
                raise ValueError(f"Unbound source {gid} in FittedPipeline")
        return values[self.sink]

    __call__ = apply

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "FittedPipeline":
        with open(path, "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


class Transformer(TransformerOperator, Chainable[A, B]):
    """A function on single items, batchable over datasets.

    Subclasses implement ``apply`` (single item). ``batch_apply`` defaults to
    the node's ``device_fn`` via ``map_batch`` when one is declared and the
    dataset is in array form, else to mapping ``apply`` over the dataset;
    override it only for batch semantics neither default expresses
    (Transformer.scala:18-70).
    """

    def apply(self, x: A) -> B:
        raise NotImplementedError

    def batch_apply(self, data: Dataset) -> Dataset:
        fn = self.device_fn()
        if fn is not None and not data.is_host:
            return data.map_batch(fn)
        return data.map(self.apply)

    def device_fn(self) -> Optional[Callable]:
        """Pure batched tensor function equivalent to ``batch_apply`` on
        array-form datasets, or None when the node is not expressible as
        one. Contract: row-local (output row i depends only on input row i)
        and side-effect free. The fusion rules (``workflow/fusion.py``)
        compose chains and gathers of these into one function and feed
        them straight into estimator fits."""
        return None

    def __call__(self, x: Any) -> Any:
        """Eager application to a datum or Dataset; lazy on pipeline handles."""
        if isinstance(x, Dataset):
            return self.batch_apply(x)
        if isinstance(x, (PipelineDataset, PipelineDatum)):
            return self.to_pipeline().apply(x)
        return self.apply(x)

    def to_pipeline(self) -> Pipeline[A, B]:
        graph = Graph(
            sources=frozenset({SourceId(0)}),
            sink_dependencies={SinkId(0): NodeId(0)},
            operators={NodeId(0): self},
            dependencies={NodeId(0): (SourceId(0),)},
        )
        return Pipeline(GraphExecutor(graph), SourceId(0), SinkId(0))

    # Untyped operator plumbing
    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return self.apply(inputs[0])

    def batch_transform(self, inputs: Sequence[Any]) -> Any:
        return self.batch_apply(inputs[0])


class LambdaTransformer(Transformer):
    """``Transformer(f)`` literal constructor (Transformer.scala:58-70)."""

    def __init__(self, f: Callable[[A], B], batch_f: Optional[Callable] = None, name: str = None):
        self.f = f
        self.batch_f = batch_f
        self.name = name or getattr(f, "__name__", "lambda")

    @property
    def label(self) -> str:
        return f"Lambda[{self.name}]"

    def apply(self, x: A) -> B:
        return self.f(x)

    def batch_apply(self, data: Dataset) -> Dataset:
        if self.batch_f is not None:
            return self.batch_f(data)
        return data.map(self.f)


def transformer(f: Callable[[A], B]) -> Transformer[A, B]:
    """Decorator/factory: lift a plain function to a Transformer."""
    return LambdaTransformer(f)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


class Estimator(EstimatorOperator, Generic[A, B]):
    """Fits a Transformer from a dataset (Estimator.scala:10-62)."""

    def fit(self, data: Dataset) -> Transformer[A, B]:
        raise NotImplementedError

    def fit_datasets(self, inputs: Sequence[Any]) -> TransformerOperator:
        return self.fit(inputs[0])

    def with_data(self, data: Any) -> Pipeline[A, B]:
        """Pipeline that fits this estimator on `data`, then applies the fitted
        transformer to the pipeline input (Estimator.scala:29-46)."""
        data = _as_pipeline_dataset(data)
        cur_sink_dep = data.executor.graph.get_sink_dependency(data.sink)
        graph, est_id = data.executor.graph.remove_sink(data.sink).add_node(self, [cur_sink_dep])
        graph, source_id = graph.add_source()
        graph, delegating_id = graph.add_node(DelegatingOperator(), [est_id, source_id])
        graph, sink_id = graph.add_sink(delegating_id)
        return Pipeline(GraphExecutor(graph), source_id, sink_id)


class LabelEstimator(EstimatorOperator, Generic[A, B, L]):
    """Fits a Transformer from a dataset plus labels (LabelEstimator.scala:13-100)."""

    def fit(self, data: Dataset, labels: Dataset) -> Transformer[A, B]:
        raise NotImplementedError

    def fit_datasets(self, inputs: Sequence[Any]) -> TransformerOperator:
        return self.fit(inputs[0], inputs[1])

    def with_data(self, data: Any, labels: Any) -> Pipeline[A, B]:
        data = _as_pipeline_dataset(data)
        labels = _as_pipeline_dataset(labels)

        graph, _, _, label_sink_mapping = data.executor.graph.add_graph(labels.executor.graph)
        data_sink_dep = graph.get_sink_dependency(data.sink)
        labels_sink_dep = graph.get_sink_dependency(label_sink_mapping[labels.sink])
        graph, est_id = (
            graph.remove_sink(data.sink)
            .remove_sink(label_sink_mapping[labels.sink])
            .add_node(self, [data_sink_dep, labels_sink_dep])
        )
        graph, source_id = graph.add_source()
        graph, delegating_id = graph.add_node(DelegatingOperator(), [est_id, source_id])
        graph, sink_id = graph.add_sink(delegating_id)
        return Pipeline(GraphExecutor(graph), source_id, sink_id)
