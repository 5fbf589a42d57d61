"""Typed ML API: Transformer / Estimator / LabelEstimator / Pipeline / gather.

Port of ``keystone_tpu/workflow/pipeline.py``. Behavioral contract from the
reference's typed layer (reference: workflow/Transformer.scala:18-70,
Estimator.scala:10-62, LabelEstimator.scala:13-100, Chainable.scala:13-126,
Pipeline.scala:22-155, FittedPipeline.scala:18-48,
PipelineResult.scala:14-21): composition is pure graph surgery; applying a
pipeline returns lazy handles; estimator insertion adds the estimator node
plus a delegating node that applies the *fitted* transformer to the
pipeline's source; ``fit()`` executes all estimators and yields a
serializable transformer-only pipeline. ``fit()`` runs the static plan
verifier first (``workflow/verify.py``).

``FittedPipeline.apply(datum)`` composes the graph into one batched
function (:func:`compose_apply_fn`) and keeps one program per input
(shape, dtype), at most 16. On the card a program is a CUDA graph,
captured once from the composed function at batch 1 and replayed after
that (the counterpart of the reference's ``jax.jit``); on the CPU the
composed function runs directly. A graph that does not compose (host or
multi-input nodes) walks the graph node by node, as in the reference.

Under the obs tracer ``fit()`` is a ``pipeline.fit`` span over
``fit.verify``, ``fit.optimize`` and one ``fit.estimator`` a delegating
node. An estimator that the cost model selected carries the decision's
outcome reference, and its fit (:func:`_stamped_fit`) stamps the measured
seconds onto the ``cost.decision`` record, read after a synchronize of
the fitted model's CUDA device (:func:`_sync_fitted`).
"""

from __future__ import annotations

import gc
import pickle
import threading
from typing import Any, Callable, Dict, Generic, List, Optional, Sequence, TypeVar, Union

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor

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
        (Pipeline.scala:38-65).

        Runs the static plan verifier first (workflow/verify.py): a
        malformed plan — the compile-time error KeystoneML's typed Scala
        API would have raised — fails HERE with node-level coordinates,
        not deep inside an estimator fit. ``KEYSTONE_VERIFY=off``
        disables the pre-pass."""
        from keystone_tpu_torch import obs

        from .env import PipelineEnv
        from .rules import UnusedBranchRemovalRule
        from .verify import verify_fit_graph

        with obs.span("pipeline.fit", nodes=len(self.executor.graph.operators)):
            with obs.span("fit.verify"):
                verify_fit_graph(self.executor.graph, context="Pipeline.fit plan")
            with obs.span("fit.optimize"):
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
                est_op = optimized.get_operator(deps[0])
                with obs.span("fit.estimator", node=deps[0].id,
                              operator=type(est_op).__name__):
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


def compose_apply_fn(
    graph: Graph, source: SourceId, sink: SinkId
) -> Optional[Callable]:
    """Compose a transformer graph into ONE pure batched tensor function
    ``X -> Y``, or None when the graph is not expressible as one.

    Requirements: every node on the sink's ancestry declares a
    ``device_fn`` and takes exactly one input, and ``source`` is the only
    unbound source. After the fusion rules have run, linear pipelines —
    including gather trees, which GatherFusionRule collapses to a single
    node — satisfy this; anything host-side or multi-input does not and
    the caller keeps the per-node execution path. A node's failure inside
    the composed function carries its coordinates
    (``verify.annotate_node_error``).
    """
    from . import analysis
    from .verify import annotate_node_error

    steps = []
    for gid in analysis.linearize(graph, sink):
        if gid == source or isinstance(gid, SinkId):
            continue
        if isinstance(gid, SourceId):
            return None  # a second unbound source — not a pure X -> Y map
        op = graph.get_operator(gid)
        fn_getter = getattr(op, "device_fn", None)
        fn = fn_getter() if callable(fn_getter) else None
        deps = graph.get_dependencies(gid)
        if fn is None or len(deps) != 1:
            return None
        steps.append((gid, op, fn, deps[0]))
    final = graph.get_sink_dependency(sink)

    def composed(X):
        values = {source: X}
        for gid, op, fn, dep in steps:
            try:
                values[gid] = fn(values[dep])
            except Exception as e:
                annotate_node_error(e, gid, op, [values[dep]])
                raise
        return values[final]

    return composed


def _stack_items(items: Sequence[Any]) -> torch.Tensor:
    """A host collection of equal-shape arrays or tensors as one batch
    tensor; ``ValueError`` for ragged items, ``TypeError`` for items that
    are not arrays (the two errors that send a batch down the per-item
    path)."""
    if not items:
        raise ValueError("an empty host collection has no batch shape")
    if not all(isinstance(x, (torch.Tensor, np.ndarray)) for x in items):
        raise TypeError("only arrays and tensors stack into a batch")
    if len({tuple(x.shape) for x in items}) != 1:
        raise ValueError("ragged items do not stack")
    if all(isinstance(x, np.ndarray) for x in items):
        return as_tensor(np.stack(items))
    tensors = [as_tensor(x) for x in items]
    if len({t.device for t in tensors}) != 1:
        raise TypeError("items on different devices do not stack")
    return torch.stack(tensors)


def _batch_of_one(x) -> torch.Tensor:
    """A datum as a batch of one row: a tensor where it lies (host arrays
    on the CPU, float64 narrowed to float32 as every node does)."""
    return as_tensor(x)[None]


def run_on_side_stream(fn: Callable, X: torch.Tensor) -> Any:
    """``fn(X)`` on a fresh side stream ordered after the current one,
    the current stream then waiting for it: the eager run before a CUDA
    graph capture, which builds kernels, plans (cuFFT's among them) and
    workspaces outside the capture. A CUDA result is marked as used on
    the current stream."""
    current = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        Y = fn(X)
    current.wait_stream(side)
    if isinstance(Y, torch.Tensor) and Y.is_cuda:
        Y.record_stream(current)
    return Y


class CapturedProgram:
    """``fn`` captured into a CUDA graph at one input (shape, dtype,
    device): the routine shared by the datum programs below and the
    serving plan's bucket programs (``serving/export.py``).

    The capture copies ``example`` into a static input, records ``fn`` on
    it, and keeps its static output. The capture launches nothing, so the
    wrappers it calls count into a record of the capturing thread
    (``cuda_ops.recording_launches``), never into ``cuda_ops.launches``,
    and each :meth:`run` adds the record there: the counters keep counting
    kernel launches, whatever other threads launch or replay meanwhile. The
    capture forbids unsafe CUDA calls (an allocation, a synchronizing copy)
    on its own thread only (``thread_local``): a plan exported while the
    plane serves, as the lifecycle gate exports a trainer's candidate, must
    not fail the replicas' copies, nor they its capture (the default,
    global mode did both on the card). A capture that fails raises a
    RuntimeError naming ``what``
    and the failing node (the composed function's own error); the card's
    random generator and the current stream are restored first, since a
    capture that fails to end leaves both in the capture's state. There
    is no fallback.

    :meth:`run` copies an input into the static input, replays the graph
    and returns ``take(static_output)``, which must copy what it keeps
    (the next run overwrites the static output). It holds no lock of its
    own (the launch counters take theirs): a caller that shares the
    program across threads serialises copy-in, replay and copy-out itself.
    """

    def __init__(self, fn: Callable, example: torch.Tensor, what: str):
        from keystone_tpu_torch.ops import cuda_ops

        device = example.device
        self.static_in = torch.empty(example.shape, dtype=example.dtype, device=device)
        self.static_in.copy_(example)
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream(device)
        rng = torch.cuda.default_generators[device.index or 0]
        rng_state = rng.clone_state()
        failed = []  # the node's own error: ending a broken capture raises another
        # No automatic garbage collection inside the capture: a collection
        # on this thread could free another program's CUDA graph, which the
        # capture forbids, and the capture fails (``torch.cuda.graph``
        # collects once itself, before it begins).
        collecting = gc.isenabled()
        gc.disable()
        try:
            with cuda_ops.recording_launches() as counted, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                try:
                    self.static_out = fn(self.static_in)
                except Exception as e:
                    failed.append(e)
                    raise
        except Exception as e:
            rng.graphsafe_set_state(rng_state)
            torch.cuda.set_stream(stream)
            cause = failed[0] if failed else e
            raise RuntimeError(f"{what}: CUDA graph capture failed: {cause}") from cause
        finally:
            if collecting:
                gc.enable()
        self.launches_per_replay = {name: n for name, n in counted.items() if n}
        self.replays = 0
        self._graph = graph
        self._done = torch.cuda.Event()

    def run(self, X: torch.Tensor, take: Callable[[torch.Tensor], Any]) -> Any:
        from keystone_tpu_torch.ops import cuda_ops

        stream = torch.cuda.current_stream(self.static_in.device)
        stream.wait_event(self._done)  # the previous run's copy-out
        self.static_in.copy_(X, non_blocking=True)
        self._graph.replay()
        out = take(self.static_out)
        self._done.record(stream)
        for name, n in self.launches_per_replay.items():
            cuda_ops.count_launches(name, n)
        self.replays += 1
        return out


class _DatumProgram:
    """The single-datum program of one input (shape, dtype): the composed
    batched function at batch 1.

    The first call runs the function eagerly on a side stream (where the
    card is present) and returns its row. If the result lies on the card,
    it then captures the function into a CUDA graph
    (:class:`CapturedProgram`), and every later call replays it on the
    datum and returns a clone of the output row. Copy-in, replay and
    copy-out hold the pipeline's lock (the static buffers are shared). If
    the result lies on the CPU, later calls run the function directly,
    without the lock.
    """

    def __init__(self, batched: Callable):
        self._batched = batched
        self.mode: Optional[str] = None  # None until the first call; "direct" | "graph"
        self.captures = 0
        self._program: Optional[CapturedProgram] = None

    @property
    def replays(self) -> int:
        return self._program.replays if self._program is not None else 0

    @property
    def launches_per_replay(self) -> Dict[str, int]:
        return self._program.launches_per_replay if self._program is not None else {}

    def __call__(self, x, lock) -> Any:
        if self.mode != "direct":
            with lock:
                if self.mode is None:
                    return self._first_call(x)
                if self.mode == "graph":
                    return self._program.run(_batch_of_one(x), lambda Y: Y[0].clone())
        return self._batched(_batch_of_one(x))[0]

    def _first_call(self, x) -> Any:
        X1 = _batch_of_one(x)
        if not torch.cuda.is_available():
            self.mode = "direct"
            return self._batched(X1)[0]
        Y = run_on_side_stream(self._batched, X1)
        if not (isinstance(Y, torch.Tensor) and Y.is_cuda):
            self.mode = "direct"
            return Y[0]
        self._program = CapturedProgram(
            self._batched, X1.to(Y.device),
            f"datum program for input {tuple(X1.shape[1:])} {X1.dtype}")
        self.captures += 1
        self.mode = "graph"
        return Y[0]


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

    # Per-process cap on cached per-shape datum programs: a client
    # sweeping many input shapes must not retain one program per shape.
    _DATUM_PROGRAM_CACHE_MAX = 16

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.transformer_graph = graph
        self.source = source
        self.sink = sink
        self._init_datum_cache()

    def _init_datum_cache(self) -> None:
        # (shape, dtype) -> _DatumProgram; _batched_fn is the graph's
        # composed batch function (False = "checked, not composable" so the
        # composition is only ever tried once). The lock makes concurrent
        # apply(datum) callers safe: cache insertion and eviction, and a
        # CUDA graph's shared static buffers.
        self._datum_programs: Dict[tuple, _DatumProgram] = {}
        self._batched_fn: Any = None
        self._datum_lock = threading.Lock()

    # CUDA graphs, locks and composed closures are not picklable;
    # FittedPipeline.save() pickles the whole object, so the caches rebuild
    # lazily after load (the fused transformers' __getstate__ contract).
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_datum_programs", None)
        state.pop("_batched_fn", None)
        state.pop("_datum_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._init_datum_cache()

    def _datum_program(self, x) -> Optional[_DatumProgram]:
        """The program for the datum's (shape, dtype), made on first use,
        or None (the caller keeps the per-node walk) for pipelines that do
        not compose to a pure tensor function. Evicts the oldest program
        past the cap."""
        if not hasattr(x, "shape") or not hasattr(x, "dtype"):
            return None
        with self._datum_lock:
            if self._batched_fn is None:
                self._batched_fn = (
                    compose_apply_fn(self.transformer_graph, self.source, self.sink)
                    or False
                )
            if self._batched_fn is False:
                return None
            key = (tuple(x.shape), str(x.dtype))
            program = self._datum_programs.get(key)
            if program is None:
                program = _DatumProgram(self._batched_fn)
                if len(self._datum_programs) >= self._DATUM_PROGRAM_CACHE_MAX:
                    self._datum_programs.pop(next(iter(self._datum_programs)))
                self._datum_programs[key] = program
            return program

    def apply(self, data: Any) -> Any:
        from . import analysis
        from .verify import annotate_node_error

        is_dataset = isinstance(data, (Dataset, PipelineDataset))
        if isinstance(data, (PipelineDataset, PipelineDatum)):
            data = data.get()

        if not is_dataset and not isinstance(data, Dataset):
            program = self._datum_program(data)
            if program is not None:
                return program(data, self._datum_lock)

        values: Dict[GraphId, Any] = {self.source: data}
        for gid in analysis.linearize(self.transformer_graph, self.sink):
            if gid in values:
                continue
            if isinstance(gid, SinkId):
                values[gid] = values[self.transformer_graph.get_sink_dependency(gid)]
            elif isinstance(gid, NodeId):
                op = self.transformer_graph.get_operator(gid)
                inputs = [values[d] for d in self.transformer_graph.get_dependencies(gid)]
                try:
                    if is_dataset:
                        values[gid] = op.batch_transform(inputs)
                    else:
                        values[gid] = op.single_transform(inputs)
                except Exception as e:
                    # Runtime failures cite the same coordinates as
                    # static-verifier reports (NodeId + operator + input
                    # signatures), appended in place so the exception
                    # type survives.
                    annotate_node_error(e, gid, op, inputs)
                    raise
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
    the node's ``device_fn`` via ``map_batch`` when one is declared, else to
    mapping ``apply`` over the dataset; override it only for batch
    semantics neither default expresses (Transformer.scala:18-70).
    """

    def apply(self, x: A) -> B:
        raise NotImplementedError

    def batch_apply(self, data: Dataset) -> Dataset:
        """A rectangular host collection stacks into one batch and takes
        ``device_fn`` in one call, as an array-form dataset does, and as
        the reference's ``batch_apply`` does (no bundled pipeline of the
        port hands a node such a collection: its image nodes declare
        batch applies of their own, and text items do not stack;
        ``scripts/torch_host_batch_spy.py`` counts them); ragged items, which
        cannot stack, map ``apply`` one at a time, as does a node without
        a ``device_fn``. Only the stacking's errors (``ValueError``,
        ``TypeError``) choose the per-item path. Unlike the reference, a
        ``device_fn`` that fails on items that did stack raises: the
        reference logs a warning and falls back to per-item apply, which
        would hide a kernel's failure on the card."""
        fn = self.device_fn()
        if fn is None:
            return data.map(self.apply)
        if not data.is_host:
            return data.map_batch(fn)
        try:
            batch = _stack_items(data.to_list())
        except (ValueError, TypeError):
            return data.map(self.apply)
        return Dataset(fn(batch), n=data.n)

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


class Identity(Transformer[A, A]):
    """Passes input through unchanged (workflow/Identity.scala:12)."""

    def apply(self, x: A) -> A:
        return x

    def batch_apply(self, data: Dataset) -> Dataset:
        return data

    def __eq__(self, other: object) -> bool:
        return type(other) is Identity

    def __hash__(self) -> int:
        return hash(Identity)


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def _cuda_device_of(obj, depth: int = 3) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``obj``'s state, searched
    through attributes, lists, tuples and dicts ``depth`` levels down (a
    chained model holds its weights one object in), or None."""
    if isinstance(obj, torch.Tensor):
        return obj.device if obj.is_cuda else None
    if depth == 0:
        return None
    if isinstance(obj, dict):
        values = obj.values()
    elif isinstance(obj, (list, tuple)):
        values = obj
    else:
        values = (getattr(obj, "__dict__", None) or {}).values()
    for v in values:
        device = _cuda_device_of(v, depth - 1)
        if device is not None:
            return device
    return None


def _sync_fitted(fitted) -> None:
    """The barrier before the measured-outcome stamp reads the clock: a fit
    on the card returns with its kernels still queued, so wait for the
    fitted model's CUDA device (``torch.cuda.synchronize``). A model whose
    weights the search does not reach syncs the current device when CUDA
    is in use; a CPU fit returns at once."""
    device = _cuda_device_of(fitted)
    if device is not None:
        torch.cuda.synchronize(device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _stamped_fit(est, thunk):
    """Run one estimator fit, back-annotating a pending cost decision.

    When the cost model selected ``est`` (``LeastSquaresEstimator.optimize``
    left a ``CostOutcomeRef`` on it), the fit is where the priced work runs,
    so it stamps the winner's measured seconds and ``estimator.fit`` span id
    onto the decision record (``obs/calibrate.py`` joins predicted against
    measured from it). The reference is consumed before the fit, so a
    failed fit never stamps and a re-fit never stamps twice. Estimators with
    no pending decision take the bare path: no span, no clock."""
    ref = getattr(est, "_pending_cost_outcome", None)
    if ref is None:
        return thunk()
    est._pending_cost_outcome = None
    import time as _time

    from keystone_tpu_torch import obs

    t0 = _time.perf_counter()
    with obs.span("estimator.fit", estimator=type(est).__name__) as sp:
        fitted = thunk()
        _sync_fitted(fitted)
    # "single_run_cold": a pipeline fits each estimator once, so this wall
    # includes the first call's one-time costs (kernel loads, allocator
    # growth); the calibration report states the mix, and the sweep harness
    # stamps "min_of_N_warm" on its warm points.
    ref.stamp(
        _time.perf_counter() - t0,
        span_id=getattr(sp, "span_id", None),
        timing="single_run_cold",
    )
    return fitted


class Estimator(EstimatorOperator, Generic[A, B]):
    """Fits a Transformer from a dataset (Estimator.scala:10-62)."""

    def fit(self, data: Dataset) -> Transformer[A, B]:
        raise NotImplementedError

    def fit_datasets(self, inputs: Sequence[Any]) -> TransformerOperator:
        return _stamped_fit(self, lambda: self.fit(inputs[0]))

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
        return _stamped_fit(self, lambda: self.fit(inputs[0], inputs[1]))

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
