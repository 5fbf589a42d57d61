"""Cache-placement optimization (reference: workflow/AutoCacheRule.scala:18-664).

Port of ``keystone_tpu/workflow/autocache.py``, the whole module. The
reference decides which RDDs to ``.cache()`` by profiling sampled
sub-pipelines (wall time + storage size) and greedily minimizing estimated
total runtime under a memory budget. The card's analog of "caching" is
keeping a computed Dataset resident in device memory (and publishing it
into the prefix state table) versus recomputing it on each downstream pass.

Two strategies, as in the reference:
  - AggressiveCache: cache every node whose weighted direct successor count
    exceeds 1 (AutoCacheRule.scala:503-518).
  - GreedyCache(max_mem_bytes, partition_scales, num_trials): profile
    sampled execution at MULTIPLE sample scales, fit linear time/mem models
    vs data scale (``generalizeProfiles``, AutoCacheRule.scala:104-135),
    extrapolate to the full data size, then greedily add the cache that
    most reduces estimated runtime while the cached set fits the memory
    budget (AutoCacheRule.scala:559-602).

Node weights come from the ``weight`` attribute of operators (the
WeightedOperator contract, reference: workflow/WeightedOperator.scala): the
number of passes the operator makes over its inputs.

Post-fusion world model, as in the reference:

  1. In :class:`~.optimizer.AutoCachingOptimizer` the rule runs AFTER the
     fusion batches, so profiles are taken per POST-fusion node: a stage
     absorbed into a fused function no longer exists as a candidate, and
     ``estimate_cached_runtime`` on the fused graph prices a candidate by
     the delta between the fused plan with and without the cut.
  2. Whatever the phase order, selection excludes nodes where a spliced
     Cacher would sever an edge the fusion rules would otherwise compose
     into one function (:func:`~.fusion.cache_would_split_fusion`), so
     insertion only ever lands on fused-stage boundaries: host loaders /
     decodes, multi-consumer intermediates, gather points, and inputs of
     non-fusable fits.

Profiles come from real executions when available: the executor records
each node's first-force wall time and bytes into the observed-profile
table (:func:`record_observed_profile`), keyed by logical Prefix like the
sampling memo, and greedy consults it before paying sampled profiling
passes.

The sampled profiler times each node up to ``Dataset.cache()``, which
waits for the card. A node whose sampled run raises falls back to an empty
:class:`Profile` (the reference's behaviour: a host stage that cannot run
on a sample must not stop the optimizer); each such fallback is logged and
recorded in :data:`profile_fallbacks`, so a run on the card can show that
no kernel fault was hidden there.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import analysis
from .env import Prefix
from .graph import Graph, NodeId, SinkId
from .operators import (
    DatasetExpression,
    DatasetOperator,
    DatumExpression,
    DatumOperator,
    EstimatorOperator,
    Expression,
    ExpressionOperator,
    TransformerExpression,
    TransformerOperator,
)
from .optimizer import Plan, Rule

logger = logging.getLogger("keystone_tpu_torch.autocache")

# (operator label, error) for every profiled node whose sampled run raised
# and fell back to an empty Profile, since the last clear.
profile_fallbacks: List[Tuple[str, str]] = []


def node_weight(op) -> int:
    """Number of passes an operator makes over its input (default 1)."""
    return int(getattr(op, "weight", 1))


@dataclass
class Profile:
    """Measured cost of computing one node (AutoCacheRule.scala:12-16)."""

    ns: float = 0.0
    mem_bytes: int = 0

    def __add__(self, other: "Profile") -> "Profile":
        return Profile(self.ns + other.ns, self.mem_bytes + other.mem_bytes)


@dataclass
class SampleProfile:
    """One measurement at one sample scale (AutoCacheRule.scala:16)."""

    scale: int
    profile: Profile


def generalize_profiles(
    new_scale: int, sample_profiles: Sequence[SampleProfile]
) -> Profile:
    """Fit linear models time/mem vs sample scale and evaluate at the full
    data scale (``generalizeProfiles``, AutoCacheRule.scala:104-135: solve
    ``[scale, 1] \\ y`` with coefficients clipped at zero)."""
    X = np.array(
        [[float(sp.scale), 1.0] for sp in sample_profiles], dtype=np.float64
    )

    def model(ys: List[float]) -> float:
        y = np.asarray(ys, dtype=np.float64)
        coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        coef = np.maximum(coef, 0.0)  # max(X \ y, 0.0)
        return float(coef[0] * new_scale + coef[1])

    return Profile(
        ns=model([sp.profile.ns for sp in sample_profiles]),
        mem_bytes=int(model([sp.profile.mem_bytes for sp in sample_profiles])),
    )


@dataclass(frozen=True)
class AggressiveCache:
    pass


@dataclass(frozen=True)
class GreedyCache:
    max_mem_bytes: Optional[int] = None  # default: 75% of device memory
    # Sample scales (items per shard), profiled smallest-to-largest
    # (reference default partitionScales = Seq(2, 4)).
    partition_scales: Tuple[int, ...] = (2, 4)
    num_trials: int = 1


# ---------------------------------------------------------------------------
# Graph queries (ported from AutoCacheRule.scala:18-95)
# ---------------------------------------------------------------------------


def init_cache_set(graph: Graph) -> Set[NodeId]:
    """Nodes whose results are effectively cached before the rule runs
    (initCacheSet, AutoCacheRule.scala:80-95): datum constants, Cachers,
    estimator fits, and spliced expressions."""
    from keystone_tpu_torch.ops.util import Cacher

    cached = set()
    for node, op in graph.operators.items():
        if isinstance(
            op, (DatumOperator, EstimatorOperator, ExpressionOperator, Cacher)
        ):
            cached.add(node)
    return cached


def descendants_of_sources(graph: Graph) -> Set[NodeId]:
    out: Set[NodeId] = set()
    for source in graph.sources:
        for gid in analysis.get_descendants(graph, source):
            if isinstance(gid, NodeId):
                out.add(gid)
    return out


def compute_runs(graph: Graph, cached: Set[NodeId]) -> Dict[NodeId, int]:
    """Times each node's result gets *computed*, given a cached set
    (getRuns, AutoCacheRule.scala:57-77).

    A node's result is accessed once per (child run × child weight); caching a
    node bounds its compute count at 1.
    """
    accesses: Dict[NodeId, int] = {}

    def runs(gid) -> int:
        """Times the node at `gid` executes."""
        if isinstance(gid, SinkId):
            return 1
        if gid in accesses:
            return accesses[gid]
        total = 0
        for child in analysis.get_children(graph, gid):
            if isinstance(child, SinkId):
                total += 1
            elif isinstance(child, NodeId):
                child_runs = 1 if child in cached else runs(child)
                total += child_runs * node_weight(graph.get_operator(child))
        result = max(total, 1)
        accesses[gid] = result
        return result

    out: Dict[NodeId, int] = {}
    for node in graph.nodes:
        out[node] = 1 if node in cached else runs(node)
    return out


# ---------------------------------------------------------------------------
# Greedy selection (ported from AutoCacheRule.scala:460-602)
# ---------------------------------------------------------------------------


def estimate_cached_runtime(
    graph: Graph, cached: Set[NodeId], profiles: Dict[NodeId, Profile]
) -> float:
    """Total estimated runtime given a cached set (estimateCachedRunTime,
    AutoCacheRule.scala:468-487): Σ executions × profiled ns over all nodes
    (unprofiled nodes contribute 0)."""
    runs = compute_runs(graph, cached)
    return sum(
        runs[n] * profiles.get(n, Profile()).ns for n in graph.nodes
    )


def cached_mem(cached: Set[NodeId], profiles: Dict[NodeId, Profile]) -> int:
    return sum(profiles.get(n, Profile()).mem_bytes for n in cached)


def _still_room(
    excluded: Set[NodeId],
    runs: Dict[NodeId, int],
    profiles: Dict[NodeId, Profile],
    space_left: int,
) -> bool:
    """True iff an eligible node used >1 time would fit if cached
    (stillRoom, AutoCacheRule.scala:529-541)."""
    return any(
        runs[n] > 1
        and n not in excluded
        and profiles.get(n, Profile()).mem_bytes < space_left
        for n in runs
    )


def _select_next(
    graph: Graph,
    profiles: Dict[NodeId, Profile],
    cached: Set[NodeId],
    excluded: Set[NodeId],
    runs: Dict[NodeId, int],
    space_left: int,
) -> NodeId:
    """The fitting eligible node that minimizes estimated runtime when
    cached (selectNext, AutoCacheRule.scala:543-557). ``excluded`` bars
    nodes from being picked; the runtime estimate itself uses only the
    truly ``cached`` set. Ties break on NodeId order for determinism."""
    eligible = [
        n
        for n in sorted(graph.nodes, key=lambda n: n.id)
        if n not in excluded
        and profiles.get(n, Profile()).mem_bytes < space_left
        and runs[n] > 1
    ]
    return min(
        eligible,
        key=lambda n: estimate_cached_runtime(graph, cached | {n}, profiles),
    )


def greedy_cache_set(
    graph: Graph,
    profiles: Dict[NodeId, Profile],
    max_mem: int,
    excluded: Optional[Set[NodeId]] = None,
) -> Set[NodeId]:
    """The greedy selection loop (greedyCache, AutoCacheRule.scala:559-602).

    ``excluded`` bars extra nodes from selection (AutoCacheRule passes the
    fusion-splitting set so a Cacher never lands inside a fusable region).

    As in the reference package (its divergence from the Scala rule),
    source descendants are excluded from *selection*, not just subtracted
    from the result afterwards: an unprofiled (mem-0) source descendant
    could otherwise win selectNext by absorbing its profiled ancestors'
    recompute savings, then be stripped at the end, leaving the expensive
    ancestors uncached.
    """
    cached = init_cache_set(graph)
    barred = descendants_of_sources(graph) | (excluded or set())
    runs = compute_runs(graph, cached)
    to_cache: Set[NodeId] = set()
    used = cached_mem(cached, profiles)
    while used < max_mem and _still_room(
        cached | to_cache | barred, runs, profiles, max_mem - used
    ):
        to_cache.add(
            _select_next(
                graph,
                profiles,
                cached | to_cache,
                cached | to_cache | barred,
                runs,
                max_mem - used,
            )
        )
        runs = compute_runs(graph, cached | to_cache)
        used = cached_mem(cached | to_cache, profiles)
    return to_cache


def _insert_cachers(plan: Graph, nodes: Set[NodeId]) -> Graph:
    """Splice a Cacher node after each selected node (AutoCacheRule.scala:492-501)."""
    from keystone_tpu_torch.ops.util import Cacher

    graph = plan
    for node in sorted(nodes, key=lambda n: n.id):
        op = graph.get_operator(node)
        if isinstance(op, Cacher):
            continue
        graph, cacher_id = graph.add_node(Cacher(), [node])
        # Point all other dependents of `node` at the cacher.
        for child in list(analysis.get_children(graph, node)):
            if child == cacher_id:
                continue
            if isinstance(child, NodeId):
                deps = [cacher_id if d == node else d for d in graph.get_dependencies(child)]
                graph = graph.set_dependencies(child, deps)
            elif isinstance(child, SinkId):
                graph = graph.set_sink_dependency(child, cacher_id)
    return graph


# ---------------------------------------------------------------------------
# Multi-scale profiling (ported from profileNodes + generalizeProfiles)
# ---------------------------------------------------------------------------


def _sample_once(
    graph: Graph, nodes: Set[NodeId], sample_size: int
) -> Tuple[Dict[NodeId, Profile], Dict[NodeId, int], Dict[NodeId, int]]:
    """Execute the ancestor closure of ``nodes`` on inputs subsampled to
    ``sample_size`` items, timing each profiled node. Returns
    (raw profiles at this scale, per-node sampled item counts, per-node
    full data sizes)."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.dataset import tree_map

    memo: Dict[NodeId, object] = {}
    profiles: Dict[NodeId, Profile] = {}
    full_counts: Dict[NodeId, int] = {}
    actual: Dict[NodeId, int] = {}

    def sample_dataset(ds: Dataset) -> Dataset:
        k = min(ds.n, max(sample_size, 1))
        if ds.is_host:
            return Dataset.of(ds.to_list()[:k])
        return Dataset(tree_map(lambda x: x[:k], ds.data), n=k)

    def evaluate(gid):
        if gid in memo:
            return memo[gid]
        op = graph.get_operator(gid)
        dep_values = [evaluate(d) for d in graph.get_dependencies(gid)]
        t0 = time.perf_counter()
        if isinstance(op, DatasetOperator):
            full = Dataset.of(op.dataset)
            full_counts[gid] = full.n
            value = sample_dataset(full)
            actual[gid] = value.n
        else:
            exprs = [_wrap(v) for v in dep_values]
            value = op.execute(exprs).get()
            if isinstance(value, Dataset):
                value.cache()
            deps = graph.get_dependencies(gid)
            full_counts[gid] = max(
                (full_counts.get(d, 1) for d in deps), default=1
            )
            actual[gid] = max((actual.get(d, 1) for d in deps), default=1)
        elapsed_ns = (time.perf_counter() - t0) * 1e9
        profiles[gid] = Profile(ns=elapsed_ns, mem_bytes=_estimate_bytes(value))
        memo[gid] = value
        return value

    def _wrap(value) -> Expression:
        if isinstance(value, Dataset):
            return DatasetExpression(lambda v=value: v)
        if isinstance(value, TransformerOperator):
            return TransformerExpression(lambda v=value: v)
        return DatumExpression(lambda v=value: v)

    for node in nodes:
        try:
            evaluate(node)
        except Exception as e:  # noqa: BLE001 — the reference's fallback, recorded
            op = graph.get_operator(node)
            label = getattr(op, "label", type(op).__name__)
            profile_fallbacks.append((label, f"{type(e).__name__}: {e}"[:300]))
            logger.warning("profiling %r (%s) failed; empty profile: %s", node, label, e)
            profiles.setdefault(node, Profile())
            full_counts.setdefault(node, 1)
            actual.setdefault(node, 1)
    return profiles, actual, full_counts


def profile_nodes(
    graph: Graph,
    nodes: Set[NodeId],
    partition_scales: Sequence[int] = (2, 4),
    num_trials: int = 1,
) -> Dict[NodeId, Profile]:
    """Profile nodes at multiple sample scales and generalize to the full
    data size with the fitted linear models (profileNodes +
    generalizeProfiles, AutoCacheRule.scala:104-135, 153-465)."""
    samples: Dict[NodeId, List[SampleProfile]] = {n: [] for n in nodes}
    full: Dict[NodeId, int] = {}
    for scale in sorted(partition_scales):
        for _ in range(max(int(num_trials), 1)):
            profiles, actual, full_counts = _sample_once(graph, nodes, scale)
            for n in nodes:
                samples[n].append(
                    SampleProfile(actual.get(n, 1), profiles.get(n, Profile()))
                )
                full[n] = max(full.get(n, 1), full_counts.get(n, 1))
    out = {}
    for n in nodes:
        if len({sp.scale for sp in samples[n]}) >= 2:
            out[n] = generalize_profiles(full[n], samples[n])
        elif samples[n]:
            # Single usable scale: fall back to proportional extrapolation.
            sp = samples[n][-1]
            factor = full[n] / max(sp.scale, 1)
            out[n] = Profile(
                ns=sp.profile.ns * factor,
                mem_bytes=int(sp.profile.mem_bytes * factor),
            )
        else:
            out[n] = Profile()
    return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    try:
        return int(getattr(np.asarray(x), "nbytes", 64))
    except (ValueError, TypeError):  # a ragged host item (token lists of n-grams)
        return 64


def _estimate_bytes(value) -> int:
    """Bytes a value holds: its tensors' (and arrays') bytes for an array
    Dataset; for a host list, 16 items' bytes scaled to the list."""
    from keystone_tpu_torch.data import Dataset
    from keystone_tpu_torch.data.dataset import tree_leaves

    if isinstance(value, Dataset):
        if value.is_host:
            return sum(_nbytes(x) for x in value.data[:16]) * max(
                len(value.data) // 16, 1
            )
        return sum(_nbytes(leaf) for leaf in tree_leaves(value.data))
    return 64


# ---------------------------------------------------------------------------
# Observed profiles: real full-scale measurements collected by the executor
# ---------------------------------------------------------------------------

# Keyed like the sampling memo — (hash(Prefix), structural fingerprint) —
# holding only floats, never operators or tensors. The executor records
# each source-free node's first-force wall time + result bytes here as
# pipelines actually run; AutoCacheRule consults it before paying sampled
# profiling passes, so cache placement prices POST-FUSION nodes by what the
# fused function measurably cost, not by a toy-scale extrapolation.
_OBSERVED_PROFILES: Dict[Tuple, Profile] = {}
_OBSERVED_MAX = 512


def observed_profile_key(
    graph: Graph, node: NodeId, _memo: Optional[dict] = None
) -> Optional[Tuple]:
    """Stable cross-graph identity of a node's computation, or None for
    source-dependent nodes (whose Prefix is undefined)."""
    try:
        p = Prefix.find(graph, node, _memo)
    except (ValueError, TypeError):
        return None
    return (hash(p), _prefix_fingerprint(p))


def record_observed_profile(key: Tuple, ns: float, mem_bytes: int) -> None:
    """Record a real execution of the node behind ``key``. Keeps the MIN
    observed time (the warm recompute cost — first runs carry builds and
    warm-ups) and the latest size."""
    if ns <= 0:
        return
    prev = _OBSERVED_PROFILES.pop(key, None)
    if prev is not None:
        ns = min(ns, prev.ns)
    elif len(_OBSERVED_PROFILES) >= _OBSERVED_MAX:
        _OBSERVED_PROFILES.pop(next(iter(_OBSERVED_PROFILES)))
    _OBSERVED_PROFILES[key] = Profile(ns=ns, mem_bytes=int(mem_bytes))


def get_observed_profile(key: Optional[Tuple]) -> Optional[Profile]:
    return _OBSERVED_PROFILES.get(key) if key is not None else None


def clear_observed_profiles() -> None:
    """Reset hook — called by PipelineEnv.reset(): keys hash
    DatasetOperators by dataset id(), so entries must not outlive the env
    generation (a recycled id could alias a stale profile onto different
    data)."""
    _OBSERVED_PROFILES.clear()


class AutoCacheRule(Rule):
    """Insert Cacher nodes per the configured strategy.

    Fusion-preserving placement: candidates where a spliced Cacher would
    sever an edge the fusion rules would otherwise compose into one
    function (:func:`~.fusion.cache_would_split_fusion`) are excluded from
    BOTH strategies, so a cache only ever lands on a fused-stage boundary.
    Run after the fusion batches (AutoCachingOptimizer's order), the
    surviving candidates are whole post-fusion nodes and
    ``estimate_cached_runtime`` prices each cut against the plan that will
    actually run.

    GreedyCache profiling is memoized across optimizer invocations by
    logical :class:`Prefix`: a λ-sweep refitting the same featurize chain
    pays the sampled-profiling passes ONCE, not once per fit. Real
    executions observed by the executor (:func:`record_observed_profile`)
    take precedence over both: they are full-scale measurements of the
    fused functions themselves.
    """

    _PROFILE_MEMO_MAX = 512

    def __init__(self, strategy=None):
        self.strategy = strategy or GreedyCache()
        self._profile_memo: Dict[Tuple, Profile] = {}
        # The most recent apply()'s selected nodes — observable by benches
        # and tests even after SavedStateLoadRule replaces the inserted
        # Cachers with state splices.
        self.last_selection: Set[NodeId] = set()

    def apply(self, plan: Graph, prefixes: Dict[NodeId, Prefix]) -> Plan:
        from .fusion import fusion_splitting_nodes

        splitting = fusion_splitting_nodes(plan, prefixes)
        if isinstance(self.strategy, AggressiveCache):
            to_cache = self._aggressive(plan, splitting)
        else:
            to_cache = self._greedy(plan, self.strategy, splitting)
        self.last_selection = set(to_cache)
        return _insert_cachers(plan, to_cache), prefixes

    def _aggressive(
        self, plan: Graph, splitting: Optional[Set[NodeId]] = None
    ) -> Set[NodeId]:
        """Cache every node with >1 weighted direct successor access that is
        not already cached, not source-dependent, and not inside a fusable
        region (aggressiveCache, AutoCacheRule.scala:503-518)."""
        cached = init_cache_set(plan)
        excluded = descendants_of_sources(plan) | (splitting or set())
        out = set()
        for node in plan.nodes:
            if node in cached or node in excluded:
                continue
            accesses = 0
            for child in analysis.get_children(plan, node):
                if isinstance(child, NodeId):
                    accesses += node_weight(plan.get_operator(child))
                else:
                    accesses += 1
            if accesses > 1:
                out.add(node)
        return out

    def _greedy(
        self,
        plan: Graph,
        strategy: GreedyCache,
        splitting: Optional[Set[NodeId]] = None,
    ) -> Set[NodeId]:
        cached = init_cache_set(plan)
        runs = compute_runs(plan, cached)
        splitting = splitting or set()
        excluded = descendants_of_sources(plan) | splitting
        # Profile every uncached node accessed more than once that doesn't
        # depend on the sources (AutoCacheRule.scala:612-618) and whose
        # caching wouldn't split a fusable region.
        to_profile = {
            n
            for n in plan.nodes
            if n not in cached and runs[n] > 1 and n not in excluded
        }
        if not to_profile:
            return set()

        # Profile-memo lookup by the HASH of the logical prefix plus a
        # structural label fingerprint (all profiled nodes are source-free,
        # so Prefix.find is defined for them). The hash, not the Prefix
        # itself: a Prefix chain ends in DatasetOperator leaves that hold
        # the full training tensors, and keeping those alive for up to
        # _PROFILE_MEMO_MAX entries would be a multi-GB retention leak for
        # a cache of two floats. The fingerprint guards the hash: a
        # collision between chains with different structure misses instead
        # of silently reusing another chain's timing profile.
        scales_key = (tuple(strategy.partition_scales), strategy.num_trials)
        find_memo: Dict[NodeId, Prefix] = {}
        node_keys: Dict[NodeId, Tuple] = {}
        profiles: Dict[NodeId, Profile] = {}
        for n in to_profile:
            p = Prefix.find(plan, n, find_memo)
            base = (hash(p), _prefix_fingerprint(p))
            node_keys[n] = base + (scales_key,)
            # Full-scale measurement from a real prior execution of this
            # computation (post-fusion, warm) beats any sampled model.
            observed = get_observed_profile(base)
            if observed is not None:
                profiles[n] = observed
        for n, k in node_keys.items():
            if n not in profiles and k in self._profile_memo:
                profiles[n] = self._profile_memo[k]
        misses = to_profile - set(profiles)
        if misses:
            fresh = profile_nodes(
                plan, misses, strategy.partition_scales, strategy.num_trials
            )
            profiles.update(fresh)
            for n in misses:
                prof = fresh.get(n)
                if prof is None or prof.ns <= 0:
                    # ns == 0 is _sample_once's failure sentinel: memoizing
                    # it would make the node look cost-free for the
                    # optimizer's lifetime — leave it out so the next fit
                    # re-profiles.
                    continue
                if len(self._profile_memo) >= self._PROFILE_MEMO_MAX:
                    self._profile_memo.pop(next(iter(self._profile_memo)))
                self._profile_memo[node_keys[n]] = prof

        max_mem = strategy.max_mem_bytes
        if max_mem is None:
            max_mem = _default_mem_budget()
        return greedy_cache_set(plan, profiles, max_mem, excluded=splitting)


def _prefix_fingerprint(prefix: Prefix) -> str:
    """Structural label string of a Prefix chain — cheap to build, retains
    no operators/tensors, and distinguishes chains whose hashes collide."""
    memo: Dict[int, str] = {}

    def fp(p: Prefix) -> str:
        got = memo.get(id(p))
        if got is None:
            label = getattr(p.operator, "label", type(p.operator).__name__)
            got = f"{label}({','.join(fp(d) for d in p.deps)})"
            memo[id(p)] = got
        return got

    return fp(prefix)


def _default_mem_budget() -> int:
    """75% of the card's memory (AutoCacheRule's default of 75% of free
    cluster memory); the reference's 8 GiB without a card."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(torch.cuda.current_device())
                   .total_memory * 0.75)
    return 8 << 30
