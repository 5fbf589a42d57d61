"""Export a FittedPipeline as an online-serving apply plan (port of
``keystone_tpu/serving/export.py``).

The offline world applies a fitted pipeline to whole datasets; serving
applies it to streams of single datums under a latency budget. The export
step does everything expensive ONCE, ahead of traffic:

  1. **Apply-only subgraph.** A :class:`FittedPipeline` is already the
     apply-only subgraph of the fitted DAG. Export re-validates that
     invariant (``TransformerGraph.from_graph``) so a hand-built graph
     smuggling an ``EstimatorOperator`` fails at export, not mid-request,
     and runs the static verifier (``verify_apply_graph``) on the
     example's signature.
  2. **Optimizer reuse.** The whole-pipeline fusion passes
     (StageFusionRule, GatherFusionRule, StageFusionRule) run on the apply
     graph. Chains the offline fit never fused collapse here: the MNIST
     plan becomes ONE composed function — packed-FFT featurize → flat
     product → scores.
  3. **Weight pinning.** Operator tensors are moved onto the serving
     device in place, so the warm path never uploads weights.
  4. **Bucket programs.** The composed apply function is built at a fixed
     set of padding buckets (powers of two up to ``max_batch``). On the
     card each bucket's program is a CUDA graph: an eager first run on a
     side stream (it builds the kernels, cuFFT's plans and cuBLAS's
     workspaces), then a capture (``workflow.pipeline.CapturedProgram``,
     the routine the datum programs share). Warm-path requests never
     capture: the micro-batcher pads each coalesced batch to the smallest
     bucket that fits and replays that bucket's graph. ``trace_count``
     counts bucket programs built (a capture, with its eager run, on the
     card; the eager first run on the CPU), so that property is testable.
     On the CPU a bucket program is the composed function called directly.

A captured program replays into static input and output tensors, so one
program must not run on two threads at once: each bucket holds a lock
over its copy-in → replay → copy-out, and replicas that share one plan
take turns per bucket (different buckets run concurrently).

Pipelines that do not compose to a pure tensor function (host stages,
multi-input combiners fusion could not collapse) still export: the plan
runs the per-node batch walk (``compiled == False``) — slower, but the
batching/padding/shedding machinery above it is identical.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.workflow.graph import Graph, SinkId, SourceId
from keystone_tpu_torch.workflow.pipeline import (
    CapturedProgram,
    FittedPipeline,
    TransformerGraph,
    compose_apply_fn,
    run_on_side_stream,
)

__all__ = ["BatchInfo", "ExportedPlan", "export_plan", "plan_fingerprint"]


def plan_fingerprint(graph: Graph, item_shape, dtype,
                     buckets: Optional[Sequence[int]] = None) -> str:
    """Content fingerprint of a serving plan version: a CRC over every
    operator's type + state (weights included, via
    ``durable.fingerprint_token``'s shape/dtype/content-CRC triples, read
    from a host copy of each tensor wherever it lies) AND the graph wiring
    (per-node dependency lists, sources, sinks — the same operators
    composed in a different order are a different function) plus the
    request signature and the padding-bucket ladder. Buckets are part of
    the identity because they are part of the served bits: a plan
    exported with explicit ``buckets=[1, ...]`` serves singletons at
    batch 1, so it must never share a fingerprint with the default-bucket
    export of the same weights. Computed ONCE at export (operator state
    is frozen for serving), it is the identity the replicated plane
    stamps on every response: any response carrying fingerprint F is
    bit-identical to offline apply under the plan version that exported
    F, and no batch ever mixes versions."""
    import json
    import zlib

    from keystone_tpu_torch.data.durable import fingerprint_token

    def state_token(v):
        # Recurse into plain containers BEFORE delegating to
        # fingerprint_token: it degrades a dict/set to its bare type
        # name, which would let two plans differing only in (say) a
        # vocabulary dict share a fingerprint. Unordered containers sort
        # by token repr so the digest is iteration-order-free.
        if isinstance(v, dict):
            return {"dict": sorted(
                ([state_token(k), state_token(u)] for k, u in v.items()),
                key=repr,
            )}
        if isinstance(v, (set, frozenset)):
            return {"set": sorted((state_token(e) for e in v), key=repr)}
        if isinstance(v, (list, tuple)):
            return [state_token(e) for e in v]
        return fingerprint_token(v)

    ops = []
    for node in sorted(graph.nodes, key=repr):
        op = graph.get_operator(node)
        members = []
        for member in _members(op, set()):
            state = {
                k: state_token(v)
                for k, v in sorted(getattr(member, "__dict__", {}).items())
                if not k.startswith("_")
            }
            members.append([type(member).__name__, state])
        ops.append([
            repr(node),
            [repr(d) for d in graph.get_dependencies(node)],
            members,
        ])
    token = json.dumps(
        {
            "item_shape": list(item_shape),
            "dtype": str(dtype),
            "buckets": list(buckets) if buckets is not None else None,
            "sources": sorted(repr(s) for s in graph.sources),
            "sinks": sorted(
                [repr(k), repr(v)]
                for k, v in graph.sink_dependencies.items()
            ),
            "ops": ops,
        },
        sort_keys=True, default=str,
    )
    return f"{zlib.crc32(token.encode()) & 0xFFFFFFFF:08x}"


def _default_buckets(max_batch: int) -> List[int]:
    """Powers of two up to (and including) max_batch, starting at TWO; a
    non-power-of-two max_batch becomes the final bucket so the full batch
    size is always reachable.

    Bucket 1 is absent, as in the reference: a library may take another
    code path for a product or an FFT of one row than for several, which
    would put a singleton's response a rounding step away from offline
    apply. A singleton request pads to 2 (one wasted row); pass explicit
    ``buckets`` to reclaim that row for a pipeline measured stable at
    batch 1."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if max_batch == 1:
        return [1]
    buckets = []
    b = 2
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(max_batch)
    return buckets


def _members(op, seen: set):
    """``op``'s fused members, at every depth, then ``op`` itself, each
    once (``seen`` holds the ids already walked). A gather fused inside a
    fused batch keeps its branches' operators one level further down
    (the TIMIT plan's cosine weights): the reference walks one level and
    leaves them out of pinning, paging and the fingerprint."""
    from keystone_tpu_torch.workflow.fusion import fused_members

    if id(op) in seen or not hasattr(op, "__dict__"):
        return
    seen.add(id(op))
    for member in fused_members(op):
        if member is not op:
            yield from _members(member, seen)
    yield op


def _operators(graph: Graph):
    """Every operator of the graph once, fused members (at every depth)
    included."""
    seen: set = set()
    for node in graph.nodes:
        yield from _members(graph.get_operator(node), seen)


def _tensor_attrs(op):
    """(name, value) of an operator's tensor attributes: tensors, and
    non-empty lists of tensors (the ``BlockLinearMapper.xs`` shape)."""
    for k, v in list(op.__dict__.items()):
        if isinstance(v, torch.Tensor):
            yield k, v
        elif isinstance(v, list) and v and all(isinstance(a, torch.Tensor) for a in v):
            yield k, v


def _weights_device(graph: Graph) -> torch.device:
    """Where the plan serves when no device is named: the device of its
    operators' tensors (the first CUDA one if any lies on the card), the
    CPU for a plan with no tensor state."""
    devices = []
    for op in _operators(graph):
        for _, v in _tensor_attrs(op):
            devices.extend(t.device for t in (v if isinstance(v, list) else [v]))
    cuda = [d for d in devices if d.type == "cuda"]
    return cuda[0] if cuda else torch.device("cpu")


def _pin_operator_arrays(graph: Graph, device: torch.device) -> int:
    """Move every operator's tensors onto the serving device, in place (the
    warm path never uploads weights). Conservative by design: only tensor
    attributes (and lists of them) are touched; host-side numpy state is
    left alone so host-path operators keep their numpy semantics. A tensor
    that cannot move (the card out of memory) fails the export, naming its
    operator and attribute. Returns the pinned byte count. Runs BEFORE the plan composes any closures so
    the pinned tensors are the ones the programs embed."""
    pinned = 0
    for op in _operators(graph):
        for k, v in _tensor_attrs(op):
            tensors = v if isinstance(v, list) else [v]
            try:
                moved = [a.to(device) for a in tensors]
            except Exception as e:
                raise RuntimeError(
                    f"export_plan: moving {type(op).__name__}.{k} onto {device} "
                    f"failed: {e}") from e
            object.__setattr__(op, k, moved if isinstance(v, list) else moved[0])
            pinned += sum(a.numel() * a.element_size() for a in tensors)
    return pinned


@dataclass(frozen=True)
class BatchInfo:
    """How one coalesced batch actually ran."""

    batch_size: int
    bucket: int
    pad_fraction: float


class _BucketProgram:
    """The composed function at one bucket: a captured CUDA graph on the
    card (``captured``), the function itself on the CPU. ``lock``
    serialises a captured program's copy-in → replay → copy-out."""

    def __init__(self, composed: Callable, bucket: int, item_shape, dtype,
                 device: torch.device):
        self.bucket = bucket
        self.lock = threading.Lock()
        self.captured: Optional[CapturedProgram] = None
        self._composed = composed
        X = torch.zeros((bucket,) + tuple(item_shape), dtype=dtype, device=device)
        if device.type == "cuda":
            run_on_side_stream(composed, X)
            self.captured = CapturedProgram(
                composed, X, f"serving bucket program {bucket} x {tuple(item_shape)}")
        else:
            composed(X)

    def __call__(self, Xp: np.ndarray) -> np.ndarray:
        X = torch.from_numpy(Xp)
        if self.captured is None:
            return _to_numpy(self._composed(X))
        with self.lock:
            return self.captured.run(X, _to_numpy)


def _to_numpy(Y) -> np.ndarray:
    if isinstance(Y, torch.Tensor):
        return Y.detach().cpu().numpy()
    return np.asarray(Y)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class ExportedPlan:
    """A fitted pipeline frozen for online serving.

    Thread contract: each bucket program serialises its own runs (the
    static buffers of a CUDA graph), so replicas may share one plan; the
    read-only metadata (buckets, trace_count) is safe to read anywhere.
    ``device`` is the serving device (default: where the operators'
    tensors lie).
    """

    def __init__(
        self,
        graph: Graph,
        source: SourceId,
        sink: SinkId,
        example: Any,
        max_batch: int = 256,
        buckets: Optional[Sequence[int]] = None,
        device: Any = None,
    ):
        self.graph = graph
        self.source = source
        self.sink = sink
        ex = np.asarray(example)
        self.item_shape = tuple(ex.shape)
        # float64 requests serve as float32, as every node narrows them.
        self.dtype = np.dtype(np.float32) if ex.dtype == np.float64 else ex.dtype
        self.max_batch = int(max_batch)
        self.buckets = sorted(set(
            int(b) for b in (buckets or _default_buckets(self.max_batch))
        ))
        if self.buckets[-1] != self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} != max_batch "
                f"{self.max_batch} — the full batch size must be reachable"
            )
        self.device = torch.device(device) if device is not None else _weights_device(graph)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("export_plan: no CUDA device is available; pass device='cpu'")
        self.pinned_bytes = _pin_operator_arrays(graph, self.device)
        # Version identity, frozen at export (state never changes after):
        # the replicated plane stamps this on every response it serves.
        self.fingerprint = plan_fingerprint(
            graph, self.item_shape, self.dtype, self.buckets
        )

        self._trace_count = 0
        self._released = False
        self._build_lock = threading.Lock()
        self._composed = compose_apply_fn(graph, source, sink)
        self.compiled = self._composed is not None
        self._programs: Dict[int, _BucketProgram] = {}
        if self.compiled:
            # Every bucket is built here, so no request (and no hot swap)
            # ever turns into capture time.
            for b in self.buckets:
                self._program(b)
        else:
            self._fallback = FittedPipeline(graph, source, sink)

    def release(self) -> None:
        """Drop the bucket programs (their CUDA graphs, static buffers and
        graph pools) and the composed function (whose closures may hold
        the weights), so the device memory they hold is freed as soon as
        the operators' tensors are: the model zoo's page-out. The caller
        guarantees nothing replays the plan meanwhile (its servers are
        closed); the plan cannot serve afterwards."""
        with self._build_lock:
            self._programs = {}
            self._composed = None
            self._released = True

    def _program(self, bucket: int) -> _BucketProgram:
        """The bucket's program: built at export for the ladder's buckets,
        on first use (counted) for a shape off the ladder."""
        program = self._programs.get(bucket)
        if program is None:
            if self._released:
                raise RuntimeError("this plan was released (its tenant was paged out)")
            with self._build_lock:
                program = self._programs.get(bucket)
                if program is None:
                    program = _BucketProgram(
                        self._composed, bucket, self.item_shape,
                        _torch_dtype(self.dtype), self.device,
                    )
                    self._trace_count += 1
                    self._programs[bucket] = program
        return program

    @property
    def trace_count(self) -> int:
        return self._trace_count

    @property
    def launches_per_replay(self) -> Dict[int, Dict[str, int]]:
        """Kernel launches one replay of each captured bucket adds to
        ``cuda_ops.launches`` (empty on the CPU)."""
        return {b: dict(p.captured.launches_per_replay)
                for b, p in sorted(self._programs.items()) if p.captured is not None}

    @property
    def replays(self) -> Dict[int, int]:
        """Replays of each captured bucket so far (empty on the CPU)."""
        return {b: p.captured.replays
                for b, p in sorted(self._programs.items()) if p.captured is not None}

    def bucket_for(self, m: int) -> int:
        """Smallest bucket that fits m rows."""
        if m < 1 or m > self.max_batch:
            raise ValueError(
                f"batch of {m} outside [1, max_batch={self.max_batch}]"
            )
        for b in self.buckets:
            if b >= m:
                return b
        return self.buckets[-1]  # unreachable given the checks above

    def _pad(self, X: np.ndarray, bucket: int) -> np.ndarray:
        if X.shape[0] == bucket:
            return X
        pad = np.zeros((bucket - X.shape[0],) + self.item_shape, X.dtype)
        return np.concatenate([X, pad], axis=0)

    def _eager_apply(self, Xp: np.ndarray, m: int) -> np.ndarray:
        """Per-node walk for non-composable plans: the canonical
        FittedPipeline batch walk over the (re-fused) serving graph —
        not a re-implementation, so the two paths can't drift. ``n=m``
        marks the padding rows so row-masking operators keep them
        zeroed."""
        X = torch.from_numpy(np.ascontiguousarray(Xp)).to(self.device)
        out = self._fallback.apply(Dataset(X, n=m))
        return _to_numpy(out.array if isinstance(out, Dataset) else out)

    def apply_padded(self, Xp) -> np.ndarray:
        """Run one bucket-shaped batch (padding rows included) and return
        the full padded output as numpy (the copy to the host is the
        execution barrier). A shape off the bucket ladder builds (and
        counts) a program of its own."""
        Xp = np.ascontiguousarray(np.asarray(Xp, self.dtype))
        bucket = int(Xp.shape[0])
        if self.compiled:
            return self._program(bucket)(Xp)
        return self._eager_apply(Xp, bucket)

    def apply_batch(self, items) -> np.ndarray:
        out, _ = self.apply_batch_info(items)
        return out

    def apply_batch_info(self, items):
        """Serve ``m`` datums: stack, pad to the smallest fitting bucket,
        run the bucket's program, mask the padding rows off the
        response. Returns ``(outputs[:m], BatchInfo)``."""
        X = np.stack([np.asarray(x) for x in items]).astype(
            self.dtype, copy=False
        )
        m = X.shape[0]
        bucket = self.bucket_for(m)
        if self.compiled:
            out = self.apply_padded(self._pad(X, bucket))
        else:
            out = self._eager_apply(self._pad(X, bucket), m)
        info = BatchInfo(
            batch_size=m, bucket=bucket, pad_fraction=(bucket - m) / bucket
        )
        return out[:m], info

    def measure_single_request_s(self, reps: int = 10) -> float:
        """Warm min-of-N wall of a single request (it pads to the smallest
        bucket) — the single-request device+dispatch time the serving
        p99 is stated against."""
        import time

        x = np.zeros(self.item_shape, self.dtype)
        self.apply_batch([x])  # warm (built at export, but page in everything)
        best = float("inf")
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            self.apply_batch([x])
            best = min(best, time.perf_counter() - t0)
        return best


def export_plan(
    fitted: FittedPipeline,
    example_input: Any,
    max_batch: int = 256,
    buckets: Optional[Sequence[int]] = None,
    device: Any = None,
) -> ExportedPlan:
    """Freeze a :class:`FittedPipeline` into an :class:`ExportedPlan`.

    ``example_input`` fixes the per-request shape/dtype every bucket is
    built at (a single datum, e.g. one ``(784,)`` image row). ``device``
    is the serving device; left unset, the device the pipeline's tensors
    lie on.

    NOTE: the plan's graph SHARES operator objects with ``fitted``, and
    export moves their tensors to the serving device in place — export
    freezes the pipeline FOR serving.
    """
    if not isinstance(fitted, FittedPipeline):
        raise TypeError(
            f"export_plan needs a FittedPipeline (got {type(fitted).__name__});"
            " call .fit() first — serving never runs estimator fits"
        )
    # Re-validate the transformer-only invariant: estimator state must be
    # frozen (no fit_datasets operator can execute at request time).
    graph = TransformerGraph.from_graph(fitted.transformer_graph)

    # Static verification of the apply plan (workflow/verify.py): no
    # estimator state reachable at request time, and the whole chain must
    # typecheck from the example input's concrete signature — a shape or
    # dtype bug fails HERE with node coordinates, before any bucket is
    # built. KEYSTONE_VERIFY=off disables.
    from keystone_tpu_torch.workflow.verify import verify_apply_graph

    verify_apply_graph(
        graph, fitted.source, fitted.sink, example=example_input,
        context="export_plan apply plan",
    )

    # Reuse the offline optimizer's fusion passes on the apply-only graph.
    from keystone_tpu_torch.workflow.fusion import GatherFusionRule, StageFusionRule

    plan_graph: Graph = graph
    for rule in (StageFusionRule(), GatherFusionRule(), StageFusionRule()):
        plan_graph, _ = rule.apply(plan_graph, {})

    return ExportedPlan(
        plan_graph,
        fitted.source,
        fitted.sink,
        example_input,
        max_batch=max_batch,
        buckets=buckets,
        device=device,
    )
