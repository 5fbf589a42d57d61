"""Standard whole-pipeline optimization rules.

Port of ``keystone_tpu/workflow/rules.py``. Each rule mirrors its reference
counterpart:
  - ExtractSaveablePrefixes  (reference: workflow/ExtractSaveablePrefixes.scala:9-22)
  - SavedStateLoadRule       (reference: workflow/SavedStateLoadRule.scala:7-20)
  - UnusedBranchRemovalRule  (reference: workflow/UnusedBranchRemovalRule.scala:7-24)
  - EquivalentNodeMergeRule  (reference: workflow/EquivalentNodeMergeRule.scala:13-47)
  - NodeOptimizationRule     (reference: workflow/NodeOptimizationRule.scala:143-198)

The sample collector keeps the reference's row sampling and its capacity
annotations, carried through derived datasets: ``total_n`` (the full row
count the cost models price), ``source_row_bytes`` (bytes a raw source row,
which the streaming tier keeps resident), ``total_d`` (a sparse sample's
true feature width) and, for a shard-backed source, the disk-tier facts
``shard_backed`` and ``shard_segment_bytes`` (the sample is then the first
rows of the source's first segment: the dataset is never materialized to
be priced).
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

from . import analysis
from .env import PipelineEnv, Prefix
from .graph import Graph, NodeId, SourceId
from .operators import EstimatorOperator, ExpressionOperator
from .optimizer import Plan, Rule


def _is_saveable(op) -> bool:
    from keystone_tpu_torch.ops.util import Cacher

    return isinstance(op, (Cacher, EstimatorOperator))


class ExtractSaveablePrefixes(Rule):
    """Mark nodes whose results should be published to / loaded from the global
    prefix state table: Cacher nodes and estimator fits.

    Re-extraction MERGES: marks carried in from an earlier batch win, and
    only unmarked saveable nodes gain fresh prefixes. Marks for nodes no
    longer in the plan are dropped."""

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        new_prefixes: Dict[NodeId, Prefix] = {
            n: p for n, p in prefixes.items() if n in plan.operators
        }
        memo: Dict[NodeId, Prefix] = {}
        for node, op in plan.operators.items():
            if node in new_prefixes or not _is_saveable(op):
                continue
            # Prefixes are undefined for source-dependent nodes: skip them.
            ancestors = analysis.get_ancestors(plan, node)
            if any(isinstance(a, SourceId) for a in ancestors):
                continue
            new_prefixes[node] = Prefix.find(plan, node, memo)
        return plan, new_prefixes


class SavedStateLoadRule(Rule):
    """Replace marked nodes whose prefix exists in PipelineEnv.state with
    constant ExpressionOperators."""

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        state = PipelineEnv.get_or_create().state
        graph = plan
        for node, prefix in prefixes.items():
            expr = state.get(prefix)
            if expr is not None:
                graph = graph.set_operator(
                    node, ExpressionOperator(expr, label="SavedState")
                ).set_dependencies(node, [])
        return graph, prefixes


class UnusedBranchRemovalRule(Rule):
    """Dead-code elimination: drop nodes/sources that are not ancestors of any sink."""

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        ancestors_of_sinks: Set = set()
        for sink in plan.sinks:
            ancestors_of_sinks |= analysis.get_ancestors(plan, sink)

        live_nodes = {a for a in ancestors_of_sinks if isinstance(a, NodeId)}
        live_sources = {a for a in ancestors_of_sinks if isinstance(a, SourceId)}

        graph = plan
        for source in plan.sources - live_sources:
            graph = graph.remove_source(source)
        new_prefixes = dict(prefixes)
        for node in plan.nodes - live_nodes:
            graph = graph.remove_node(node)
            new_prefixes.pop(node, None)
        return graph, new_prefixes


class EquivalentNodeMergeRule(Rule):
    """Common-subexpression elimination: merge nodes with equal (operator, deps).

    Operator equality is Python ``==``/``hash``; node-library operators that are
    deterministic functions of their parameters define structural equality
    (dataclasses), everything else defaults to identity.
    """

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        groups: Dict = {}
        for node in plan.nodes:
            try:
                key = (plan.get_operator(node), plan.get_dependencies(node))
                groups.setdefault(key, []).append(node)
            except TypeError:
                # Unhashable operator: never mergeable.
                groups[(id(plan.get_operator(node)), node)] = [node]

        if all(len(g) == 1 for g in groups.values()):
            return plan, prefixes

        graph = plan
        new_prefixes = dict(prefixes)
        for group in groups.values():
            if len(group) <= 1:
                continue
            keep = min(group, key=lambda n: n.id)
            for node in group:
                if node == keep:
                    continue
                graph = graph.replace_dependency(node, keep).remove_node(node)
            merged_prefix = next(
                (new_prefixes[n] for n in group if n in new_prefixes), None
            )
            if merged_prefix is not None:
                for n in group:
                    new_prefixes.pop(n, None)
                new_prefixes[keep] = merged_prefix
        return graph, new_prefixes


class NodeOptimizationRule(Rule):
    """Node-level algorithm selection: run optimizable nodes' ``optimize`` hook
    on a sample of their input and swap in the chosen concrete operator.

    The reference executes the graph with a sampling executor
    (NodeOptimizationRule.scala:14-136) to obtain per-node input samples. Here
    the sample collector executes the graph with datasets truncated to
    ``samples_per_shard`` rows (one shard: the port runs on one device)
    before each optimizable node.
    """

    def __init__(self, samples_per_shard: int = 3):
        self.samples_per_shard = samples_per_shard

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        from .optimizable import (
            OptimizableEstimator,
            OptimizableLabelEstimator,
            OptimizableTransformer,
        )

        optimizable_nodes = [
            n
            for n, op in plan.operators.items()
            if isinstance(
                op, (OptimizableTransformer, OptimizableEstimator, OptimizableLabelEstimator)
            )
            # Nodes downstream of unbound sources can't be sampled.
            and not any(
                isinstance(a, SourceId) for a in analysis.get_ancestors(plan, n)
            )
        ]
        if not optimizable_nodes:
            return plan, prefixes

        samples = _collect_samples(plan, optimizable_nodes, self.samples_per_shard)

        graph = plan
        for node in optimizable_nodes:
            op = plan.get_operator(node)
            sample_inputs = samples.get(node)
            if sample_inputs is None:
                continue
            chosen = op.optimize(*sample_inputs)
            if chosen is not None:
                graph = graph.set_operator(node, chosen)
        return graph, prefixes


def _leaf_row_bytes(x) -> int:
    """Bytes a row of one array leaf (numpy or torch)."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    return int(np.prod(x.shape[1:])) * itemsize


def _attach_sparse_width(op, value, dep_values) -> None:
    """Thread the true feature width onto a derived sparse sample.

    ``optimize()`` measures d as ``indices.max()+1`` over the sampled rows,
    which undershoots whenever the handful of samples misses the top
    feature ids. The width is knowable without sampling in every real
    producer: a vectorizer declares it (``sparse_output_dim``), whether
    chained directly or applied as a fitted transformer riding in the dep
    values; a Sparsify-style node's dense input carries it as the dense
    shape; and a width-preserving transform inherits its sparse input's.
    Attach it as ``total_d`` so the cost model prices resident_bytes at the
    true width.
    """
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.dataset import tree_leaves
    from keystone_tpu_torch.ops.sparse import is_sparse_dataset

    if not is_sparse_dataset(value):
        return
    # The declaring operator is the node's own op, or (the fit-then-apply
    # route) a fitted transformer among the dep values.
    for declarer in [op] + [v for v in dep_values if not isinstance(v, Dataset)]:
        declared = getattr(declarer, "sparse_output_dim", None)
        if callable(declared):
            declared = declared()
        if declared:
            value.total_d = int(declared)
            return
    for v in (v for v in dep_values if isinstance(v, Dataset)):
        if is_sparse_dataset(v):
            inherited = getattr(v, "total_d", None)
            if inherited:
                value.total_d = int(inherited)
                return
        elif not v.is_host:
            leaves = tree_leaves(v.data)
            if len(leaves) == 1 and getattr(leaves[0], "ndim", 0) >= 2:
                value.total_d = int(leaves[0].shape[-1])
                return


def _collect_samples(plan: Graph, nodes, samples_per_shard: int):
    """Execute ancestor chains of the target nodes with row-sampled datasets.

    Returns {node: tuple(sampled dep values)}.
    """
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.dataset import as_tensor, tree_leaves, tree_map
    from keystone_tpu_torch.ops.sparse import is_sparse_dataset

    from .operators import (
        DatasetExpression,
        DatasetOperator,
        DatumExpression,
        TransformerExpression,
        TransformerOperator,
    )

    def row_bytes(ds: Dataset):
        """Bytes a row of the raw source (the streaming tier's capacity
        model keeps raw rows resident, not features)."""
        if ds.is_host:
            items = ds.to_list()
            if not items:
                return None
            item = items[0]
            if isinstance(item, torch.Tensor):
                return float(item.numel() * item.element_size())
            return float(np.asarray(item).nbytes)
        return float(sum(_leaf_row_bytes(x) for x in tree_leaves(ds.data)))

    def sample_dataset(ds: Dataset) -> Dataset:
        k = min(ds.n, samples_per_shard)
        if ds.is_shard_backed:
            # Out-of-core source: sample the first segment only and carry
            # the disk-tier capacity facts the selector prices on.
            src = ds.shard_source
            first = src.load(0)
            arr = np.asarray(first if isinstance(first, np.ndarray) else first[0])
            arr = arr.reshape(-1, arr.shape[-1])
            rows = min(k, arr.shape[0], ds.n)
            out = Dataset(np.array(arr[:rows]), n=rows)
            out.total_n = ds.n
            out.source_row_bytes = src.row_bytes or float(arr.shape[-1] * arr.dtype.itemsize)
            out.shard_backed = True
            out.shard_segment_bytes = src.segment_bytes
            return out
        if ds.is_host:
            out = Dataset.of(ds.to_list()[:k])
        else:
            out = Dataset(tree_map(lambda x: x[:k], ds.data), n=k)
        # Cost models need the FULL dataset size (the reference passes it via
        # numPerPartition, LeastSquaresEstimator.scala:60-64); the sample only
        # supplies d, k, and sparsity.
        out.total_n = ds.n
        out.source_row_bytes = row_bytes(ds)
        if is_sparse_dataset(ds):
            # The true feature width, measured over the full index array:
            # ``indices.max()+1`` over a handful of sampled rows can
            # undershoot it by orders of magnitude, mis-pricing every
            # sparse candidate's resident_bytes downstream (cost.py).
            indices = as_tensor(ds.data["indices"])
            if indices.numel():
                out.total_d = int(indices.max()) + 1
        return out

    memo: Dict[NodeId, object] = {}

    def evaluate(gid):
        if gid in memo:
            return memo[gid]
        op = plan.get_operator(gid)
        deps = [evaluate(d) for d in plan.get_dependencies(gid)]
        if isinstance(op, DatasetOperator):
            value = sample_dataset(Dataset.of(op.dataset))
        else:
            value = op.execute([_wrap(d) for d in deps]).get()
            # Operators derive NEW Datasets, losing the sample metadata:
            # re-attach it so a chained optimizable node sees the full n
            # and the raw source's row width.
            if isinstance(value, Dataset):
                dep_ds = [v for v in deps if isinstance(v, Dataset)]
                totals = [
                    v.total_n for v in dep_ds
                    if getattr(v, "total_n", None) is not None
                ]
                if totals:
                    value.total_n = max(totals)
                raws = [
                    v.source_row_bytes for v in dep_ds
                    if getattr(v, "source_row_bytes", None) is not None
                ]
                if raws:
                    value.source_row_bytes = max(raws)
                # Disk-tier provenance: a derived sample whose source is
                # shard-backed keeps the flag only through device-fusable
                # operators, the chains StreamedFitFusionRule can rewire to
                # consume the raw shard source. Through any other operator
                # the fit would receive a materialized intermediate. A
                # gather, and the combiner after it, keep it when every
                # input does: GatherFusionRule fuses a gather of fusable
                # branches and its combiner (the TIMIT featurizer) into one
                # fusable transformer. The reference passes the flag through
                # fusable operators alone, so its TIMIT gather loses the
                # disk tier.
                from .fusion import fusable
                from .operators import GatherTransformerOperator

                flags = [getattr(v, "shard_backed", False) for v in dep_ds]
                combine = getattr(op, "device_combine_fn", None)
                gathers = isinstance(op, GatherTransformerOperator) or (
                    callable(combine) and combine() is not None
                )
                if (fusable(op) and any(flags)) or (gathers and flags and all(flags)):
                    value.shard_backed = True
                    segs = [
                        v.shard_segment_bytes for v in dep_ds
                        if getattr(v, "shard_segment_bytes", None) is not None
                    ]
                    if segs:
                        value.shard_segment_bytes = max(segs)
                _attach_sparse_width(op, value, deps)
        memo[gid] = value
        return value

    def _wrap(value):
        if isinstance(value, Dataset):
            return DatasetExpression(lambda v=value: v)
        if isinstance(value, TransformerOperator):
            return TransformerExpression(lambda v=value: v)
        return DatumExpression(lambda v=value: v)

    out = {}
    for node in nodes:
        try:
            dep_values = tuple(evaluate(d) for d in plan.get_dependencies(node))
            # Optimization hooks take Dataset samples; datum-fed nodes keep
            # their default implementation.
            if not all(isinstance(v, Dataset) for v in dep_values):
                out[node] = None
            else:
                out[node] = dep_values
        except Exception:
            out[node] = None
    return out
