"""Stage, gather and fit fusion: rewrite device-pure regions of a pipeline
into one composed function.

Port of ``keystone_tpu/workflow/fusion.py``. The reference compiles each
fused region into ONE ``jax.jit`` program so XLA fuses across the old node
boundaries. PyTorch runs eagerly, so here a fused region is plain Python
composition of the members' ``device_fn`` functions; what the rewrite still
buys is the fused fit: :class:`FusedFitEstimator` featurizes straight into
the solver (the flat fit holds the feature matrix once and centres it in
place), and :class:`FusedGatherTransformer` writes each branch into its
column window of one preallocated matrix instead of concatenating copies.
The rules make the same rewrite as the reference on every plan, so a
pipeline takes the same route in both packages:

  - Transformers that are *row-local pure array functions* declare it by
    implementing ``device_fn()`` (returns the tensor->tensor function).
  - :class:`StageFusionRule` rewrites maximal linear chains of such nodes
    into one :class:`FusedBatchTransformer`.
  - :class:`GatherFusionRule` rewrites gather(branches) -> combiner trees
    into one :class:`FusedGatherTransformer`.
  - :class:`EstimatorFusionRule` fuses an estimator exposing
    ``device_fit_fn()`` (a :class:`DeviceFit`) with the fusable node
    feeding it, unless that node has another consumer.
  - :class:`StreamedFitFusionRule` binds the fusable node feeding a
    streaming choice (``streamed_fit_fusable``) into the fit, so that the
    streamed fit makes its features one row tile at a time, and rewires
    the estimator's apply sites to feed it raw rows.

Chains never fuse across: estimator fits, multi-input nodes (gather/
combiner), sinks, prefix-published nodes (their intermediate result must
stay materializable for the state table), or nodes whose results another
branch consumes.

Row-local contract for ``device_fn``: output row i depends only on input row
i, so zero padding rows cannot leak into valid rows and a single trailing
re-zeroing is equivalent to per-stage re-zeroing.

A gather of MnistRandomFFT's [RandomSignNode → PaddedFFT → LinearRectifier]
branches lowers, as in the reference, to the packed-pair FFT function
(``ops/stats.py::packed_fft_gather_fn``); ``uses_packed_fft`` says so.

Cache placement asks this module where a region boundary lies:
:func:`cache_would_split_fusion` and :func:`fusion_splitting_nodes` are
the predicates ``workflow/autocache.py`` and the plan verifier's
cache-cut check share, so the two can never disagree about what fuses.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Sequence

import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import as_tensor

from .env import Prefix
from .graph import Graph, NodeId, SinkId
from .operators import DelegatingOperator, GatherTransformerOperator
from .optimizer import Plan, Rule
from .pipeline import LabelEstimator, Transformer

__all__ = [
    "DeviceFit",
    "FusedBatchTransformer",
    "FusedGatherTransformer",
    "FusedFitEstimator",
    "StageFusionRule",
    "GatherFusionRule",
    "EstimatorFusionRule",
    "StreamedFitFusionRule",
    "fusable",
    "fused_members",
    "masked_center",
    "cache_would_split_fusion",
    "fusion_splitting_nodes",
]


def fusable(op) -> bool:
    """True when the operator participates in stage fusion."""
    fn = getattr(op, "device_fn", None)
    return callable(fn) and fn() is not None


def fused_members(op) -> list:
    """Fused-stage membership query: the original operators a fused wrapper
    absorbed, or ``[op]`` for an unfused node. Lets graph-level passes
    (cache placement) reason about what a post-fusion node *contains*
    without knowing each fused wrapper class."""
    if isinstance(op, FusedBatchTransformer):
        return list(op.members)
    if isinstance(op, FusedGatherTransformer):
        return [m for br in op.branches for m in br] + [op.combiner]
    if isinstance(op, FusedFitEstimator):
        return list(op.members) + [op.est]
    # StreamedFitEstimator shares the duck shape: a ``members`` list plus
    # the operator the members feed.
    members = getattr(op, "members", None)
    if isinstance(members, list) and members:
        tail = getattr(op, "est", None) or getattr(op, "choice", None)
        return list(members) + ([tail] if tail is not None else [])
    return [op]


def _device_fit_capable(op) -> bool:
    """True when an estimator operator would be absorbed by
    EstimatorFusionRule / StreamedFitFusionRule (a fusable fit)."""
    if getattr(op, "streamed_fit_fusable", False):
        return True
    if getattr(op, "device_fit_fn", None) is None:
        return False
    try:
        return op.device_fit_fn() is not None
    except Exception:
        return False


def cache_would_split_fusion(plan, node, prefixes, consumers=None) -> bool:
    """Boundary query for cache placement: True when splicing a ``Cacher``
    after ``node`` would sever an edge the fusion rules would otherwise
    compose into one function (a chain link, an estimator's featurize
    input, or a gather branch feeding a device combiner).

    A node for which this returns False sits on a fused-stage *boundary*:
    a Cacher there materializes a result the fused plan had to materialize
    anyway (host stages, multi-consumer intermediates, inputs of
    non-fusable fits), so insertion never splits a fusable region.
    """
    if consumers is None:
        consumers = _consumers(plan)
    op = plan.get_operator(node)
    if not fusable(op) or node in prefixes:
        return False
    outs = consumers.get(node, [])
    if len(outs) != 1 or not isinstance(outs[0], NodeId):
        # Multi-consumer nodes and sink feeds are materialization points
        # in the fused plan already.
        return False
    consumer = outs[0]
    if consumer in prefixes:
        return False
    cop = plan.get_operator(consumer)
    cdeps = plan.get_dependencies(consumer)
    single_dep = len(plan.get_dependencies(node)) == 1
    # StageFusionRule chain edge: node -> consumer fuse into one function.
    if single_dep and fusable(cop) and len(cdeps) == 1:
        return True
    # Estimator / streamed-fit fusion: the fit absorbs its DATA input.
    if len(cdeps) == 2 and cdeps[0] == node and _device_fit_capable(cop):
        return True
    # Gather branch: node feeds a gather whose output a device combiner
    # consumes (GatherFusionRule would inline the branch).
    if single_dep and isinstance(cop, GatherTransformerOperator):
        gouts = consumers.get(consumer, [])
        if len(gouts) == 1 and isinstance(gouts[0], NodeId):
            comb = plan.get_operator(gouts[0])
            if (
                getattr(comb, "device_combine_fn", None) is not None
                and comb.device_combine_fn() is not None
            ):
                return True
    return False


def fusion_splitting_nodes(plan, prefixes) -> set:
    """All nodes where a spliced Cacher would break a fusable region —
    the exclusion set AutoCacheRule applies before selecting candidates."""
    consumers = _consumers(plan)
    return {
        n
        for n in plan.nodes
        if cache_would_split_fusion(plan, n, prefixes, consumers)
    }


def _compose(fns, X):
    for f in fns:
        X = f(X)
    return X


# Bytes of one chunk's intermediates in FusedBatchTransformer.batch_apply,
# the counterpart of the streamed fit's 2 GiB feature slab.
CHUNK_BUDGET_BYTES = 2 << 30


def _row_bytes(t) -> int:
    return t.element_size() * t.numel() // max(t.shape[0], 1)


def _compose_in_chunks(fns, X):
    """``_compose(fns, X)`` over row chunks whose intermediates take about
    :data:`CHUNK_BUDGET_BYTES` together.

    Eager PyTorch materialises every member's output, and a chain can widen
    its rows many times over (the CIFAR featurizer's convolution and
    rectifier make 0.9 MB per image before the pool shrinks it to 7 KB),
    so the whole batch at once may not fit the device. A probe of the first
    row measures the bytes per row of every intermediate; then every row,
    the first again, runs in chunks of ``CHUNK_BUDGET_BYTES // that`` rows
    (the whole batch as one chunk when it fits). The probe's result is
    dropped: a library may compute one row by another path than many (a
    product of one row is a matrix-vector product), and a row must have
    the same bits whichever call computes it, so a served request (a
    bucket of two or more rows) gives offline apply's bits. The members
    are row-local by contract, so the result equals the unchunked
    composition."""
    X = as_tensor(X)
    n = X.shape[0]
    if n <= 1:
        return _compose(fns, X)
    per_row, Z = _row_bytes(X), X[:1]
    for f in fns:
        Z = f(Z)
        per_row += _row_bytes(Z)
    rows = max(1, CHUNK_BUDGET_BYTES // max(per_row, 1))
    if rows >= n:
        return _compose(fns, X)
    out = torch.empty((n,) + tuple(Z.shape[1:]), dtype=Z.dtype, device=Z.device)
    for s in range(0, n, rows):
        out[s:s + rows] = _compose(fns, X[s:s + rows])
    return out


class FusedBatchTransformer(Transformer):
    """A chain of row-local transformers run as one composed function.

    Single-datum ``apply`` keeps exact per-node semantics (composition of
    the members' ``apply``); the batch path composes the members'
    ``device_fn`` functions over row chunks sized by a byte budget
    (:func:`_compose_in_chunks`): the reference's one XLA program fuses the
    intermediates away, eager PyTorch holds each of them whole. Host-form
    datasets fall back to the sequential member chain.
    """

    def __init__(self, members: Sequence[Transformer]):
        if len(members) < 2:
            raise ValueError("fusion needs at least two members")
        for m in members:
            if not isinstance(m, Transformer) or m.device_fn() is None:
                raise ValueError(f"member {m!r} is not device-fusable")
        self.members = list(members)
        self._build_composed()

    def _build_composed(self) -> None:
        fns = [m.device_fn() for m in self.members]
        self._composed = lambda X: _compose(fns, X)

    # The composed closure is not picklable; FittedPipeline.save() pickles
    # the whole transformer graph, so persist only the members and rebuild
    # the composition on load.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_composed", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._build_composed()

    @property
    def label(self) -> str:
        return "Fused[" + " > ".join(m.label for m in self.members) + "]"

    def device_fn(self):
        return self._composed

    def apply(self, x):
        for m in self.members:
            x = m.apply(x)
        return x

    def batch_apply(self, data):
        if data.is_host:
            for m in self.members:
                data = m.batch_apply(data)
            return data
        fns = [m.device_fn() for m in self.members]
        return data.map_batch(lambda X: _compose_in_chunks(fns, X))


class DeviceFit:
    """The fit-fusion contract estimators opt into.

    ``fit(F, Y, n_true) -> params`` fits on the featurized tensor F (whose
    rows past ``n_true`` are padding) and may overwrite F: the fused
    estimator hands it the featurize output, which nothing else holds.
    ``build(params) -> Transformer`` makes the fitted model;
    ``supports(d_feat)`` gates the geometry (e.g. block divisibility).

    The reference's ``operands`` and ``program_key`` are not carried over:
    they exist so that one compiled XLA program serves a sweep over λ, and
    eager PyTorch compiles nothing. The fit reads λ from its estimator.
    """

    def __init__(self, fit, build, supports=lambda d: True):
        self.fit = fit
        self.build = build
        self.supports = supports


def masked_center(F, Y, n_true: int):
    """Mean-center (F, Y) over the first ``n_true`` rows, zeroing the
    padding rows BEFORE the means: padding rows hold featurize(0), which is
    nonzero in general (cos(b), intercepts), so an unmasked sum would bias
    every mean. Returns (Fc, Yc, fmean, ymean) with padding rows zero — the
    solvers' zero-padding contract. Shared by every ``device_fit_fn``.

    F is centred in its own storage and returned as Fc (Y is copied): the
    reference returns new arrays, but a fused fit owns F, which at TIMIT
    width is 4.3 GB, and a second copy is what the flat fit exists to avoid.
    """
    n_true = int(n_true)
    Fc = F
    Fc[n_true:] = 0
    fmean = Fc.sum(dim=0) / n_true
    Fc[:n_true] -= fmean
    ymean = Y[:n_true].sum(dim=0) / n_true
    Yc = Y - ymean
    Yc[n_true:] = 0
    return Fc, Yc, fmean, ymean


def _column_writers(branches, combiner):
    """For a concatenating combiner whose every branch ends in a member that
    can write its output into a column window — ``device_fn_into()`` giving
    ``(width, dtype, device, fn(X, out))`` — the list of those specs, all
    of one dtype and device. Else None."""
    from keystone_tpu_torch.ops.util import VectorCombiner

    if not isinstance(combiner, VectorCombiner):
        return None
    writers = []
    for br in branches:
        into = getattr(br[-1], "device_fn_into", None) if br else None
        spec = into() if into is not None else None
        if spec is None:
            return None
        writers.append(spec)
    if len({(dtype, device) for _, dtype, device, _ in writers}) != 1:
        return None
    return writers


class FusedGatherTransformer(Transformer):
    """A gather-of-branches + combiner run as one composed function.

    Each branch is a (possibly empty — identity) list of row-local
    device-fusable transformers applied to the SAME input; the combiner's
    ``device_combine_fn`` merges the branch outputs (e.g. VectorCombiner's
    concat). When the combiner concatenates columns and every branch's last
    member can write into a column window (``device_fn_into``), the branches
    write straight into one preallocated (n, d) matrix: no branch output
    and no concatenated copy beside it.
    """

    def __init__(self, branches: Sequence[Sequence[Transformer]], combiner):
        if not branches:
            raise ValueError("gather fusion needs at least one branch")
        for br in branches:
            for m in br:
                if not isinstance(m, Transformer) or m.device_fn() is None:
                    raise ValueError(f"branch member {m!r} is not fusable")
        if getattr(combiner, "device_combine_fn", None) is None or (
            combiner.device_combine_fn() is None
        ):
            raise ValueError(f"combiner {combiner!r} has no device_combine_fn")
        self.branches = [list(b) for b in branches]
        self.combiner = combiner
        self._build_composed()

    def _build_composed(self) -> None:
        # Shape-specialized lowering first: a gather of [RandomSign →
        # PaddedFFT → LinearRectifier] branches packs branch pairs into
        # complex FFTs and reads X once for all branches. Tests pin that the
        # MNIST gather takes it (uses_packed_fft).
        from keystone_tpu_torch.ops.stats import packed_fft_gather_fn

        packed = packed_fft_gather_fn(self.branches, self.combiner)
        self.uses_packed_fft = packed is not None
        if packed is not None:
            self._composed = packed
            return
        branch_fns = [[m.device_fn() for m in br] for br in self.branches]
        combine = self.combiner.device_combine_fn()
        writers = _column_writers(self.branches, self.combiner)

        def composed(X):
            outs = [_compose(fns, X) for fns in branch_fns]
            return combine(outs)

        def composed_into_columns(X):
            _, dtype, device, _ = writers[0]
            out = torch.empty(
                (X.shape[0], sum(w for w, _, _, _ in writers)), dtype=dtype, device=device
            )
            start = 0
            for fns, (w, _, _, write) in zip(branch_fns, writers):
                write(_compose(fns[:-1], X), out[:, start:start + w])
                start += w
            return out

        self._composed = composed if writers is None else composed_into_columns

    # Same pickling contract as FusedBatchTransformer: the composition is
    # rebuilt on load.
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_composed", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._build_composed()

    @property
    def label(self) -> str:
        inner = " | ".join(
            " > ".join(m.label for m in br) or "id" for br in self.branches
        )
        return f"FusedGather[{inner} -> {self.combiner.label}]"

    def device_fn(self):
        return self._composed

    def apply(self, x):
        outs = []
        for br in self.branches:
            b = x
            for m in br:
                b = m.apply(b)
            outs.append(b)
        return self.combiner.apply(tuple(outs))

    def batch_apply(self, data):
        if data.is_host:
            branch_out = []
            for br in self.branches:
                d = data
                for m in br:
                    d = m.batch_apply(d)
                branch_out.append(d)
            gathered = GatherTransformerOperator().batch_transform(branch_out)
            return self.combiner.batch_apply(gathered)
        return data.map_batch(self._composed)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class FusedFitEstimator(LabelEstimator):
    """An estimator fit fused with its upstream featurize function.

    Wraps a LabelEstimator exposing ``device_fit_fn()`` (a
    :class:`DeviceFit`) together with the device-fusable transformer(s)
    feeding it. ``fit`` featurizes once, straight into the estimator's
    traceable fit, which owns the feature matrix (the flat solver centres
    it in place and reads its column windows where they lie). Falls back
    to the sequential path for host datasets, and to the estimator's own
    fit, on the features already made, for unsupported geometry.

    The reference also caches one compiled program per input geometry
    (``_programs``, ``_shared_fit_program``) so that refits do not
    recompile; eager PyTorch compiles nothing, so there is nothing to cache.
    """

    def __init__(self, members: Sequence[Transformer], est):
        self.members = list(members)
        self.est = est

    @property
    def label(self) -> str:
        inner = " > ".join(m.label for m in self.members)
        return f"FusedFit[{inner} -> {self.est.label}]"

    @property
    def weight(self) -> int:
        return getattr(self.est, "weight", 1)

    def _fallback(self, data, labels):
        for m in self.members:
            data = m.batch_apply(data)
        return self.est.fit(data, labels)

    def fit(self, data, labels):
        dev = self.est.device_fit_fn()
        if dev is None or data.is_host or labels.is_host:
            return self._fallback(data, labels)
        X = as_tensor(data.array)
        # Featurize first and size the fit from the result: there is no
        # shape-only trace to ask, and the features are needed either way.
        F = _compose([m.device_fn() for m in self.members], X)
        if _shares_storage(F, X):
            F = F.clone()  # the fit may overwrite F; never the caller's data
        if not dev.supports(int(F.shape[-1])):
            return self.est.fit(Dataset(F, n=data.n)._rezero_padding(), labels)
        Y = as_tensor(labels.array, F.device)
        return dev.build(dev.fit(F, Y, int(data.n)))


class _IdentityMemo:
    """Bounded memo keyed by the object identities of its constituents.

    Shared by every fusion rule: re-optimizing a graph built from the same
    node objects (the normal case — pipelines are re-applied with the same
    operators) must return the SAME fused wrapper, so that the optimizer
    sees an unchanged plan and the state table's prefixes stay stable.
    id() keys alone are unsafe — an evicted entry's ids can be recycled by
    the allocator — so hits re-verify every constituent with `is` against
    the live objects the cached value holds.
    """

    def __init__(self, max_entries: int = 64):
        self._cache: Dict[tuple, object] = {}
        self._max = max_entries

    def get(self, key_objs, verify, build):
        key = tuple(id(o) for o in key_objs)
        hit = self._cache.get(key)
        if hit is not None and verify(hit):
            return hit
        value = build()
        if key not in self._cache and len(self._cache) >= self._max:
            # Only evict for genuinely NEW keys: a verify-failed overwrite
            # replaces its own slot and must not drop an unrelated entry.
            self._cache.pop(next(iter(self._cache)))
        self._cache[key] = value
        return value


def _consumers(plan: Graph) -> Dict[NodeId, List]:
    out: Dict[NodeId, List] = {}
    for node, deps in plan.dependencies.items():
        for d in deps:
            out.setdefault(d, []).append(node)
    for sink in plan.sinks:
        out.setdefault(plan.get_sink_dependency(sink), []).append(sink)
    return out


class StageFusionRule(Rule):
    """Fuse maximal linear chains of device-fusable transformer nodes.

    A node chains onto its single dependency when BOTH are fusable, the
    dependency has exactly one consumer (this node), and neither is
    prefix-published (prefix results must materialize for the state table).
    Fused transformers are memoized by member identity (``_IdentityMemo``).
    """

    def __init__(self) -> None:
        self._memo = _IdentityMemo()

    def _fused(self, ops) -> FusedBatchTransformer:
        return self._memo.get(
            ops,
            lambda hit: len(hit.members) == len(ops)
            and all(a is b for a, b in zip(hit.members, ops)),
            lambda: FusedBatchTransformer(ops),
        )

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        consumers = _consumers(plan)

        def chainable(node) -> bool:
            return (
                isinstance(node, NodeId)
                and node not in prefixes
                and fusable(plan.get_operator(node))
                and len(plan.get_dependencies(node)) == 1
            )

        # Walk heads: a chain head is chainable but its dependency link
        # upward is not extendable.
        chains: List[List[NodeId]] = []
        seen = set()
        for node in sorted(plan.nodes, key=lambda n: n.id):
            if node in seen or not chainable(node):
                continue
            head = node
            while True:
                dep = plan.get_dependencies(head)[0]
                if chainable(dep) and len(consumers.get(dep, [])) == 1:
                    head = dep
                else:
                    break
            chain = [head]
            cur = head
            while True:
                nexts = consumers.get(cur, [])
                if len(nexts) != 1 or isinstance(nexts[0], SinkId):
                    break
                nxt = nexts[0]
                if not chainable(nxt) or plan.get_dependencies(nxt)[0] != cur:
                    break
                chain.append(nxt)
                cur = nxt
            seen.update(chain)
            if len(chain) >= 2:
                chains.append(chain)

        for chain in chains:
            ops = [plan.get_operator(n) for n in chain]
            fused = self._fused(ops)
            head_deps = plan.get_dependencies(chain[0])
            tail = chain[-1]
            # Reuse the tail node id so downstream consumers stay wired.
            plan = plan.set_operator(tail, fused)
            plan = plan.set_dependencies(tail, head_deps)
            for n in chain[:-1]:
                plan = plan.remove_node(n)

        return plan, prefixes


class GatherFusionRule(Rule):
    """Fuse gather(branch...) -> combiner trees into one composed function.

    Applies when: a :class:`GatherTransformerOperator` node's single
    consumer is a combiner exposing ``device_combine_fn``; every branch
    feeding the gather is the common input itself (identity branch) or a
    device-fusable node consumed only by the gather; and all branches hang
    off ONE common dependency. Runs after :class:`StageFusionRule`, so
    multi-node branches have already collapsed to single fused nodes. Fused
    gathers are memoized by (branch members, combiner) identity.
    """

    def __init__(self) -> None:
        self._memo = _IdentityMemo()

    def _fused(self, branches, comb) -> FusedGatherTransformer:
        flat = [m for br in branches for m in br] + [comb]

        def verify(hit):
            return (
                hit.combiner is comb
                and len(hit.branches) == len(branches)
                and all(
                    len(ha) == len(ba) and all(a is b for a, b in zip(ha, ba))
                    for ha, ba in zip(hit.branches, branches)
                )
            )

        return self._memo.get(
            flat, verify, lambda: FusedGatherTransformer(branches, comb)
        )

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        consumers = _consumers(plan)
        for node in sorted(plan.nodes, key=lambda n: n.id):
            if node not in plan.nodes:  # removed by an earlier rewrite
                continue
            op = plan.get_operator(node)
            if not isinstance(op, GatherTransformerOperator):
                continue
            outs = consumers.get(node, [])
            if len(outs) != 1 or isinstance(outs[0], SinkId):
                continue
            comb_node = outs[0]
            comb = plan.get_operator(comb_node)
            if (
                getattr(comb, "device_combine_fn", None) is None
                or comb.device_combine_fn() is None
                or comb_node in prefixes
                or node in prefixes
            ):
                continue
            tails = plan.get_dependencies(node)
            if not tails:
                continue
            branches, common = [], None
            ok = True
            for t in tails:
                if isinstance(t, NodeId):
                    top = plan.get_operator(t)
                    if (
                        not fusable(top)
                        or t in prefixes
                        or len(plan.get_dependencies(t)) != 1
                        or consumers.get(t, []) != [node]
                    ):
                        ok = False
                        break
                    dep = plan.get_dependencies(t)[0]
                    members = (
                        top.members if isinstance(top, FusedBatchTransformer) else [top]
                    )
                else:
                    dep, members = t, []  # identity branch off the source
                if common is None:
                    common = dep
                elif dep != common:
                    ok = False
                    break
                branches.append(members)
            if not ok or common is None:
                continue
            fused = self._fused(branches, comb)
            plan = plan.set_operator(comb_node, fused)
            plan = plan.set_dependencies(comb_node, [common])
            plan = plan.remove_node(node)
            for t in tails:
                if isinstance(t, NodeId):
                    plan = plan.remove_node(t)
            consumers = _consumers(plan)
        return plan, prefixes


class EstimatorFusionRule(Rule):
    """Fuse an estimator fit with the device-fusable node feeding it.

    Applies when a LabelEstimator node exposing ``device_fit_fn()`` takes
    its DATA input from a fusable transformer whose only consumer is this
    estimator (and which is not prefix-published). When the pipeline is
    applied to its own training data before it is fitted, the optimizer
    merges the training featurization with the apply's, that node gains a
    second consumer, and the rule declines: the estimator then fits on the
    materialized features (the stacked route). Runs after Stage/Gather
    fusion so the upstream is a single node. Fused estimators are memoized
    by (member, estimator) identity.
    """

    def __init__(self) -> None:
        self._memo = _IdentityMemo()

    def _fused(self, members, est) -> FusedFitEstimator:
        return self._memo.get(
            list(members) + [est],
            lambda hit: hit.est is est
            and len(hit.members) == len(members)
            and all(a is b for a, b in zip(hit.members, members)),
            lambda: FusedFitEstimator(members, est),
        )

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        consumers = _consumers(plan)
        for node in sorted(plan.nodes, key=lambda n: n.id):
            if node not in plan.nodes:  # removed by an earlier rewrite
                continue
            op = plan.get_operator(node)
            if getattr(op, "device_fit_fn", None) is None:
                continue
            try:
                if op.device_fit_fn() is None:
                    continue
            except Exception:
                continue
            deps = plan.get_dependencies(node)
            if len(deps) != 2:
                continue
            dnode = deps[0]
            if not isinstance(dnode, NodeId) or dnode in prefixes:
                continue
            dop = plan.get_operator(dnode)
            if not fusable(dop) or len(plan.get_dependencies(dnode)) != 1:
                continue
            if consumers.get(dnode, []) != [node]:
                continue
            members = dop.members if isinstance(dop, FusedBatchTransformer) else [dop]
            fused = self._fused(members, op)
            # A pending cost-decision outcome follows the fit to the fused
            # estimator, whose fit now runs the priced work (the reference
            # drops it here, so its fused fits go unstamped).
            ref = getattr(op, "_pending_cost_outcome", None)
            if ref is not None:
                fused._pending_cost_outcome = ref
                op._pending_cost_outcome = None
            plan = plan.set_operator(node, fused)
            plan = plan.set_dependencies(
                node, [plan.get_dependencies(dnode)[0], deps[1]]
            )
            plan = plan.remove_node(dnode)
            consumers = _consumers(plan)
        return plan, prefixes


_logger = logging.getLogger("keystone_tpu_torch.fusion")


class StreamedFitFusionRule(Rule):
    """Bind the upstream featurizer into a streaming estimator's fit.

    Applies when a node's operator declares ``streamed_fit_fusable`` (the
    streaming choice, ``StreamingLeastSquaresChoice``) and its DATA input
    is a fusable transformer consumed only by it, or also by this
    estimator's own apply sites. The rewrite calls the choice's
    ``fuse_with_members(members)``, whose fit makes features per row tile
    inside the solver: the feature matrix never materializes, which is the
    point of the streaming tier. Runs after Stage/Gather fusion (the
    upstream is one node) and after NodeOptimizationRule (the choice has
    been swapped in). Fused estimators are memoized by (members, choice)
    identity.
    """

    def __init__(self) -> None:
        self._memo = _IdentityMemo()

    def _fused(self, members, choice):
        return self._memo.get(
            list(members) + [choice],
            lambda hit: hit.choice is choice
            and len(hit.members) == len(members)
            and all(a is b for a, b in zip(hit.members, members)),
            lambda: choice.fuse_with_members(members),
        )

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        consumers = _consumers(plan)
        for node in sorted(plan.nodes, key=lambda n: n.id):
            if node not in plan.nodes:
                continue
            op = plan.get_operator(node)
            if not getattr(op, "streamed_fit_fusable", False):
                continue
            deps = plan.get_dependencies(node)
            if len(deps) != 2:
                continue
            dnode = deps[0]
            unbindable = None
            dop = None
            if not isinstance(dnode, NodeId) or dnode in prefixes:
                unbindable = "its data input is a source/prefix-published node"
            else:
                dop = plan.get_operator(dnode)
                if not fusable(dop) or len(plan.get_dependencies(dnode)) != 1:
                    unbindable = "its upstream transformer is not device-fusable"
            if unbindable:
                _logger.warning(
                    "streaming fit at %s cannot bind its featurizer (%s): the "
                    "fit will tile-stream MATERIALIZED features",
                    getattr(op, "label", op), unbindable,
                )
                continue

            # The featurize node may have other consumers only when they
            # are this estimator's own apply sites (delegating nodes fed by
            # the same featurizer: CSE merges the train and apply chains
            # when the pipeline is applied to its training data). Those get
            # rewired to raw input below; any other consumer needs the
            # featurized result, and fusing would recompute it: decline.
            def _is_own_delegate(c):
                return (
                    isinstance(c, NodeId)
                    and isinstance(plan.get_operator(c), DelegatingOperator)
                    and list(plan.get_dependencies(c)) == [node, dnode]
                )

            shared_delegates = [c for c in consumers.get(dnode, []) if c != node]
            if not all(_is_own_delegate(c) for c in shared_delegates):
                _logger.warning(
                    "streaming fit at %s cannot bind its featurizer (the "
                    "featurized result has other consumers): the fit will "
                    "tile-stream MATERIALIZED features",
                    getattr(op, "label", op),
                )
                continue
            members = dop.members if isinstance(dop, FusedBatchTransformer) else [dop]
            fused = self._fused(members, op)
            # Rewiring apply sites to feed raw rows needs the fitted model
            # to tell raw from featurized input by width: provable only for
            # bank featurizers with d_in != d_feat.
            can_rewire = getattr(fused, "can_serve_raw_input", False)
            raw_in = plan.get_dependencies(dnode)[0]
            plan = plan.set_operator(node, fused)
            plan = plan.set_dependencies(node, [raw_in, deps[1]])
            if can_rewire:
                for c in shared_delegates:
                    plan = plan.set_dependencies(c, [node, raw_in])
            if can_rewire or not shared_delegates:
                plan = plan.remove_node(dnode)
            # else: dnode stays; the shared delegates keep featurizing
            # upstream and the width-adaptive model takes the identity path
            # on their featurized input.

            # Other apply sites may featurize through a twin node holding
            # the same operator (the fusion memos give train/apply twins
            # one object; the non-merged case, e.g. applying to held-out
            # data). Rewire them to raw input too: the fitted model carries
            # the featurizer and applies it tile-wise, so inference never
            # materializes the feature matrix either.
            consumers = _consumers(plan)
            if can_rewire:
                delegates = [
                    c for c in consumers.get(node, [])
                    if isinstance(c, NodeId)
                    and isinstance(plan.get_operator(c), DelegatingOperator)
                ]
                for c in delegates:
                    cdeps = plan.get_dependencies(c)
                    ain = cdeps[1] if len(cdeps) == 2 else None
                    if ain == raw_in:
                        continue  # rewired above (merged case)
                    if (
                        isinstance(ain, NodeId)
                        and plan.get_operator(ain) is dop
                        and len(plan.get_dependencies(ain)) == 1
                    ):
                        plan = plan.set_dependencies(
                            c, [cdeps[0], plan.get_dependencies(ain)[0]]
                        )
                        if consumers.get(ain, []) == [c]:
                            plan = plan.remove_node(ain)
                consumers = _consumers(plan)
        return plan, prefixes
