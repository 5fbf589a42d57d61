"""Static plan verification: catch shape/dtype/structure bugs before
anything runs.

Port of ``keystone_tpu/workflow/verify.py``. KeystoneML's typed Scala API
made a malformed pipeline a *compile-time* error (``Pipeline[A,B]``
composition simply didn't typecheck); the Python packages traded that
away, so a shape mismatch, a silent f32→bf16 drift, or an estimator
leaking into an apply graph would surface only deep inside a fit. This
module restores the static guarantee by abstract interpretation over the
untyped :class:`~keystone_tpu_torch.workflow.graph.Graph`:

  - Every node gets a *signature* (:class:`ArraySig` — shape and dtype,
    :class:`HostSig` for host-object stages, :class:`TupleSig` for
    gathers, :class:`TransformerSig` for estimator outputs), propagated
    source→sink in topological order.
  - Device-traceable operators (anything exposing ``device_fn`` /
    ``device_combine_fn``) are interpreted on ``device="meta"`` tensors
    where the reference calls ``jax.eval_shape``: the operator's batched
    function runs under :class:`MetaInterpretation`, a dispatch mode that
    turns every tensor an operation touches into a meta tensor (shape,
    dtype and strides, no storage) and every allocation into a meta
    allocation. Nothing is allocated on any device and no kernel is
    launched: a hand-written kernel's wrapper given a meta operand runs its
    shape and dtype checks and returns an empty meta output
    (``ops/cuda_ops.py``). Shape errors are raised HERE, named by
    ``NodeId`` and operator.
  - Host-side operators (NLP tokenizers, featurizers, image decode)
    declare ``output_signature(sig)`` (see :func:`expect_host`);
    undeclared host ops stop propagation (or are reported in ``strict``
    mode).
  - Structural invariants are checked alongside: estimator state must
    never be reachable as *data* in an apply path, gather branches must
    agree on example counts, and a hand-placed
    :class:`~keystone_tpu_torch.ops.util.Cacher` must not sever an edge
    the fusion rules would otherwise compose into one function. (The
    reference's multi-input sharding check, ``sharding-conflict``, is left
    out: the port's datasets carry no mesh.)

Dtypes are written as the reference writes them (``"float32"``,
``"bfloat16"``), so findings read the same in both packages.

Float64 drift: the reference exempts float64 inputs from the drift check
only while ``jax_enable_x64`` is off, because JAX then demotes every f64
operand. The port computes in float32 everywhere: ``data.dataset.as_tensor``
narrows float64 host arrays to float32 at every node boundary, which is
runtime policy, not an operator's doing. So the port always exempts a
float64 input, as the reference does with x64 off.

The verifier runs as a default pre-pass in ``Pipeline.fit`` and in
``Optimizer.execute`` (so invalid candidate plans are rejected before they
are ever cost-modeled or run). ``KEYSTONE_VERIFY=off`` disables it;
``KEYSTONE_VERIFY=strict`` additionally reports undeclared host-op
signatures. Error-severity findings raise :class:`PlanVerificationError`
with a structured multi-error report; warning-severity findings (dtype
drift, fusion-splitting caches) are logged.
"""

from __future__ import annotations

import logging
import os
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from . import analysis
from .graph import Graph, GraphId, NodeId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    ExpressionOperator,
    GatherTransformerOperator,
    Operator,
)

logger = logging.getLogger("keystone_tpu_torch.verify")

__all__ = [
    "ArraySig",
    "HostSig",
    "TupleSig",
    "TransformerSig",
    "UNKNOWN",
    "Finding",
    "VerifyReport",
    "PlanVerificationError",
    "SignatureError",
    "MetaInterpretation",
    "expect_host",
    "signature_of_value",
    "verify_graph",
    "verify_fit_graph",
    "verify_apply_graph",
    "verification_mode",
    "annotate_node_error",
    "describe_value",
]


# ---------------------------------------------------------------------------
# Signatures
# ---------------------------------------------------------------------------


class Sig:
    """Base class of all node signatures."""

    def describe(self) -> str:
        return type(self).__name__


class _Unknown(Sig):
    """Signature of a value the verifier cannot reason about (unbound
    sources, spliced expressions, undeclared host ops). Unknown inputs
    silence downstream checks — the verifier under-approximates rather
    than guess."""

    _instance: Optional["_Unknown"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def describe(self) -> str:
        return "?"


UNKNOWN = _Unknown()


@dataclass(frozen=True)
class ArraySig(Sig):
    """Batch-form array signature: ``shape`` is the full (padded) batch
    shape with ``None`` for an unknown leading example axis; ``n`` is the
    true example count when known; ``datum=True`` marks a single example
    (shape then has NO leading example axis). ``mesh`` is kept for the
    reference's signature shape; the port's datasets leave it None."""

    shape: Tuple[Optional[int], ...]
    dtype: str
    n: Optional[int] = None
    mesh: Any = field(default=None, compare=False)
    datum: bool = False

    def describe(self) -> str:
        dims = ",".join("?" if d is None else str(d) for d in self.shape)
        kind = "datum" if self.datum else "batch"
        return f"{kind} f[{dims}]:{self.dtype}"


@dataclass(frozen=True)
class HostSig(Sig):
    """Host-object (or non-dense-array) signature: ``kind`` is a small
    vocabulary shared by the declared NLP/image ops — ``"str"``,
    ``"tokens"`` (list of str), ``"ngrams"`` (list of tuples),
    ``"tf_dict"`` (feature→weight dict), ``"int_tokens"``,
    ``"ngram_counts"``, ``"sparse"`` (the padded-COO batch), ``"any"``."""

    kind: str = "any"
    n: Optional[int] = None
    datum: bool = False

    def describe(self) -> str:
        return f"host[{self.kind}]"


@dataclass(frozen=True)
class TupleSig(Sig):
    """Signature of a gather output: one element signature per branch."""

    elements: Tuple[Sig, ...]
    n: Optional[int] = None
    datum: bool = False

    def describe(self) -> str:
        return "(" + ", ".join(e.describe() for e in self.elements) + ")"


@dataclass(frozen=True)
class TransformerSig(Sig):
    """Signature of an estimator node's output: a fitted transformer
    (state, not data). Carries the estimator so delegating nodes can ask
    it for a ``fitted_signature``."""

    label: str
    estimator: Any = field(default=None, compare=False)

    def describe(self) -> str:
        return f"transformer[{self.label}]"


class SignatureError(ValueError):
    """Raised by an operator's ``output_signature`` when the incoming
    signature violates its declared input contract. The verifier turns
    it into a finding naming the node."""


def expect_host(sig: Sig, kinds: Sequence[str], op: Operator) -> HostSig:
    """Declaration helper for host ops: assert ``sig`` is a
    :class:`HostSig` of one of ``kinds`` (``"any"`` in either position
    matches everything) and return it. Raises :class:`SignatureError`
    with an operator-named message otherwise."""
    if not isinstance(sig, HostSig):
        raise SignatureError(
            f"{op.label} expects host input of kind {tuple(kinds)}, "
            f"got {sig.describe()}"
        )
    if sig.kind != "any" and "any" not in kinds and sig.kind not in kinds:
        raise SignatureError(
            f"{op.label} expects host input of kind {tuple(kinds)}, "
            f"got host[{sig.kind}]"
        )
    return sig


# ---------------------------------------------------------------------------
# Dtype names: the reference's spelling for torch and numpy dtypes alike
# ---------------------------------------------------------------------------


def dtype_name(dtype: Any) -> str:
    """``"float32"``, ``"bfloat16"``, ``"int64"``… for a torch or numpy
    dtype (``str(torch.float32)`` would be ``"torch.float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return str(np.dtype(dtype))


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"dtype {name} has no tensor form")
    return dt


# ---------------------------------------------------------------------------
# Signature inference for concrete payloads
# ---------------------------------------------------------------------------


def _infer_host_kind(item: Any) -> str:
    if isinstance(item, str):
        return "str"
    if isinstance(item, bytes):
        return "bytes"
    if isinstance(item, dict):
        return "tf_dict"
    if isinstance(item, (list, tuple)) and item:
        first = item[0]
        if isinstance(first, str):
            return "tokens"
        if isinstance(first, tuple):
            return "ngrams"
        if isinstance(first, (int, np.integer)):
            return "int_tokens"
    return "any"


def _is_arraylike(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def signature_of_value(value: Any) -> Sig:
    """Best-effort signature of a concrete value (a Dataset payload, a
    datum, or an intermediate result — the executor's error annotation
    uses this too). Datasets describe their batch form; any bare value
    is by construction a single datum."""
    from keystone_tpu_torch.data import Dataset

    if isinstance(value, Dataset):
        if value.is_host:
            items = value.data
            kind = _infer_host_kind(items[0]) if items else "any"
            return HostSig(kind, n=value.n)
        if value.is_shard_backed:
            return UNKNOWN
        data = value.data
        if isinstance(data, dict) and set(data.keys()) == {
            "indices", "values",
        }:
            # The padded-COO sparse batch form (ops/sparse.py).
            return HostSig("sparse", n=value.n)
        if isinstance(data, tuple):
            elems = tuple(
                ArraySig(tuple(int(d) for d in a.shape), dtype_name(a.dtype),
                         n=value.n)
                if _is_arraylike(a) else UNKNOWN
                for a in data
            )
            return TupleSig(elems, n=value.n)
        if _is_arraylike(data):
            return ArraySig(
                tuple(int(d) for d in data.shape),
                dtype_name(data.dtype),
                n=value.n,
            )
        return UNKNOWN
    if isinstance(value, (str, bytes, dict, list)):
        return HostSig(_infer_host_kind(value), datum=True)
    if isinstance(value, tuple):
        return TupleSig(
            tuple(signature_of_value(v) for v in value),
            datum=True,
        )
    if _is_arraylike(value):
        return ArraySig(
            tuple(int(d) for d in value.shape),
            dtype_name(value.dtype),
            datum=True,
        )
    if isinstance(value, (int, float, np.number, bool)):
        return ArraySig((), str(np.asarray(value).dtype), datum=True)
    return UNKNOWN


# ---------------------------------------------------------------------------
# Findings / report
# ---------------------------------------------------------------------------


# Error taxonomy (the reference's docs/verification.md):
SHAPE_MISMATCH = "shape-mismatch"
HOST_SIGNATURE_MISMATCH = "host-signature-mismatch"
DTYPE_DRIFT = "dtype-drift"
ESTIMATOR_IN_APPLY = "estimator-in-apply"
CACHE_SPLITS_FUSION = "cache-splits-fusion"
GATHER_MISMATCH = "gather-mismatch"
UNDECLARED_SIGNATURE = "undeclared-signature"

_ERROR_CODES = frozenset({
    SHAPE_MISMATCH,
    HOST_SIGNATURE_MISMATCH,
    ESTIMATOR_IN_APPLY,
    GATHER_MISMATCH,
})


@dataclass(frozen=True)
class Finding:
    """One verification finding, anchored to the offending node."""

    code: str
    node: GraphId
    operator: str
    message: str
    severity: str = "error"  # "error" | "warn"

    def __str__(self) -> str:
        return f"[{self.code}] {self.node!r} {self.operator}: {self.message}"


class VerifyReport:
    """Structured multi-error report: every finding names its NodeId and
    operator, so a failure cites the same coordinates as the executor's
    runtime error annotations."""

    def __init__(self, findings: Sequence[Finding] = ()):  # noqa: D401
        self.findings: List[Finding] = list(findings)
        self.sigs: Dict[GraphId, Sig] = {}

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "warn"]

    def by_code(self, code: str) -> List[Finding]:
        return [f for f in self.findings if f.code == code]

    def add(self, code, node, op, message, severity=None) -> None:
        if severity is None:
            severity = "error" if code in _ERROR_CODES else "warn"
        label = getattr(op, "label", None) or type(op).__name__
        self.findings.append(Finding(code, node, label, message, severity))

    def __bool__(self) -> bool:
        return bool(self.findings)

    def __str__(self) -> str:
        if not self.findings:
            return "plan verified: no findings"
        lines = [
            f"plan verification: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        ]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)

    def raise_if_errors(self, context: str = "plan") -> None:
        if self.errors:
            raise PlanVerificationError(self, context)
        for w in self.warnings:
            logger.warning("%s: %s", context, w)


class PlanVerificationError(ValueError):
    """An invalid plan was rejected by the static verifier (before
    anything was cost-modeled or run). ``.report`` holds the full
    multi-error :class:`VerifyReport`."""

    def __init__(self, report: VerifyReport, context: str = "plan"):
        self.report = report
        self.context = context
        errs = "\n".join(f"  {f}" for f in report.errors)
        super().__init__(
            f"{context} failed static verification "
            f"({len(report.errors)} error(s)):\n{errs}"
        )


# ---------------------------------------------------------------------------
# Abstract interpretation on meta tensors
# ---------------------------------------------------------------------------


_EVAL_BATCH = 2  # placeholder batch size when the leading axis is unknown

_META = torch.device("meta")


def _meta_like(x: Any) -> Any:
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return torch.empty_strided(tuple(x.shape), tuple(x.stride()), dtype=x.dtype,
                                   device=_META)
    return x


class MetaInterpretation(TorchDispatchMode):
    """Run tensor code for shapes and dtypes alone: every operand of every
    operation becomes a meta tensor (same shape, strides and dtype, no
    storage) and every ``device=`` argument (allocations, ``.to(device)``)
    becomes ``"meta"``. Real tensors the code closes over (weights) are
    read for their shapes only and never written: an in-place operation
    on one lands on its meta stand-in. Host reads (``.item()``,
    ``.tolist()``, ``.numpy()``) of a meta tensor raise."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = _META
        args, kwargs = tree_map(_meta_like, (args, kwargs))
        return func(*args, **kwargs)


def _evaluable(sig: Sig) -> bool:
    """Concrete enough to interpret: an ArraySig whose only unknown
    dimension (if any) is the leading example axis."""
    if not isinstance(sig, ArraySig):
        return False
    dims = sig.shape if sig.datum else sig.shape[1:]
    return all(d is not None for d in dims)


def _spec_for(sig: ArraySig) -> torch.Tensor:
    shape = sig.shape
    if sig.datum:
        shape = (1,) + shape
    else:
        shape = tuple(_EVAL_BATCH if d is None else d for d in shape)
    return torch.empty(shape, dtype=_torch_dtype(sig.dtype), device=_META)


def _sig_from_result(res, in_sig: ArraySig) -> Sig:
    if not isinstance(res, torch.Tensor):
        return UNKNOWN
    shape = tuple(int(d) for d in res.shape)
    if in_sig.datum:
        if not shape or shape[0] != 1:
            return UNKNOWN  # not row-local; don't guess the datum form
        return ArraySig(shape[1:], dtype_name(res.dtype), datum=True)
    lead: Tuple[Optional[int], ...] = shape
    if in_sig.shape and in_sig.shape[0] is None:
        lead = (None,) + shape[1:]
    return ArraySig(lead, dtype_name(res.dtype), n=in_sig.n, mesh=in_sig.mesh)


def _interpret(fn, arg):
    with torch.no_grad(), MetaInterpretation():
        return fn(arg)


def _error_line(e: BaseException) -> str:
    msg = str(e).strip().split("\n")[0]
    return msg[:300] or type(e).__name__


def _eval_device_fn(fn, sig: ArraySig):
    """Interpret the operator's batched function on the incoming
    signature. Returns (result, None) or (None, error_message)."""
    try:
        res = _interpret(fn, _spec_for(sig))
    except Exception as e:  # noqa: BLE001 — any interpretation failure is the finding
        return None, _error_line(e)
    return res, None


def _short(sig: Sig) -> str:
    return sig.describe()


def _is_float(name: str) -> bool:
    try:
        return _torch_dtype(name).is_floating_point
    except TypeError:
        return False


def _first_float(*dtypes: str) -> bool:
    # bfloat16 counts as floating here — and bf16 drift is the single most
    # important case this check exists for.
    return all(_is_float(d) for d in dtypes)


def _known(sig: Sig) -> bool:
    """Fully-known signature (recursively for tuples): the strict
    undeclared-signature check only fires when the operator was actually
    handed something it could have declared against."""
    if isinstance(sig, _Unknown):
        return False
    if isinstance(sig, TupleSig):
        return all(_known(e) for e in sig.elements)
    return True


def _dtype_drift(in_dtype: str, out_dtype: str) -> bool:
    """True when a float→float dtype change is an operator-level drift
    worth flagging. float64 inputs are exempt: the port narrows float64
    host arrays to float32 at every node boundary (runtime policy, as the
    reference's JAX does with x64 off), so the change is not this
    operator's doing."""
    if not _first_float(in_dtype, out_dtype) or in_dtype == out_dtype:
        return False
    return in_dtype != "float64"


def _n_of(sig: Sig) -> Optional[int]:
    return getattr(sig, "n", None)


def _full_topo(graph: Graph) -> List[GraphId]:
    """Every node/sink in dependency order — sink-reachable ids first
    (``analysis.linearize``), then any remaining islands (nodes no sink
    observes yet: mid-surgery graphs) in their own topo order."""
    order = analysis.linearize(graph)
    seen = set(order)
    for node in sorted(graph.nodes, key=lambda n: n.id):
        if node not in seen:
            tail = analysis.linearize(graph, node)
            order.extend(g for g in tail if g not in seen)
            seen.update(tail)
    return order


def _infer_and_check(
    graph: Graph,
    node: NodeId,
    op: Operator,
    in_sigs: List[Sig],
    report: VerifyReport,
    strict: bool,
) -> Sig:
    """One node of the abstract interpretation: run the node-level
    checks, return the node's output signature."""
    # -- estimator state must never flow as data --------------------------
    for i, s in enumerate(in_sigs):
        if isinstance(s, TransformerSig) and not (
            isinstance(op, DelegatingOperator) and i == 0
        ):
            report.add(
                ESTIMATOR_IN_APPLY, node, op,
                f"input {i} is fitted-estimator state "
                f"({s.describe()}) consumed as data — estimator output "
                "may only feed a DelegatingOperator's first slot",
            )
            return UNKNOWN

    if isinstance(op, DelegatingOperator):
        if not in_sigs:
            return UNKNOWN
        head = in_sigs[0]
        if not isinstance(head, (TransformerSig, _Unknown)):
            report.add(
                ESTIMATOR_IN_APPLY, node, op,
                f"first input must be an estimator's fitted transformer, "
                f"got {head.describe()}",
            )
            return UNKNOWN
        est = head.estimator if isinstance(head, TransformerSig) else None
        fitted_sig = getattr(est, "fitted_signature", None)
        if fitted_sig is not None:
            try:
                return fitted_sig(in_sigs[1:]) or UNKNOWN
            except SignatureError as e:
                report.add(HOST_SIGNATURE_MISMATCH, node, op, str(e))
                return UNKNOWN
            except Exception:  # noqa: BLE001 — declarations must not kill verify
                return UNKNOWN
        return UNKNOWN

    # -- cross-input consistency (estimators, gathers, combiners) --------
    known_ns = {(_n_of(s)) for s in in_sigs if _n_of(s) is not None}
    if len(in_sigs) > 1 and len(known_ns) > 1:
        report.add(
            GATHER_MISMATCH, node, op,
            f"inputs disagree on example count: {sorted(known_ns)} "
            f"({', '.join(_short(s) for s in in_sigs)})",
        )

    if isinstance(op, EstimatorOperator):
        # Estimators may declare a fit-input contract (the analog of the
        # typed API's Estimator[A, B] input bound).
        check = getattr(op, "check_fit_signature", None)
        if check is not None and all(_known(s) for s in in_sigs):
            try:
                check(in_sigs)
            except SignatureError as e:
                report.add(HOST_SIGNATURE_MISMATCH, node, op, str(e))
            except Exception:  # noqa: BLE001 — declarations must not kill verify
                pass
        return TransformerSig(
            getattr(op, "label", type(op).__name__), estimator=op
        )

    if isinstance(op, GatherTransformerOperator):
        n = next(iter(known_ns)) if len(known_ns) == 1 else None
        datum = any(getattr(s, "datum", False) for s in in_sigs)
        return TupleSig(tuple(in_sigs), n=n, datum=datum)

    if isinstance(op, (DatasetOperator, DatumOperator, ExpressionOperator)):
        # handled by the caller (payload signatures); defensive default.
        return UNKNOWN

    # -- cache-cut placement ----------------------------------------------
    if getattr(op, "is_cache", False):
        _check_cache_cut(graph, node, op, report)
        return in_sigs[0] if in_sigs else UNKNOWN

    # -- declared host/array signature ------------------------------------
    declared = getattr(op, "output_signature", None)
    if declared is not None and in_sigs and all(_known(s) for s in in_sigs):
        try:
            out = declared(in_sigs[0] if len(in_sigs) == 1 else in_sigs)
            return out if isinstance(out, Sig) else UNKNOWN
        except SignatureError as e:
            report.add(HOST_SIGNATURE_MISMATCH, node, op, str(e))
            return UNKNOWN
        except Exception:  # noqa: BLE001 — declarations must not kill verify
            logger.debug("output_signature of %s failed", op, exc_info=True)
            return UNKNOWN

    # -- device combiner over a gather tuple -------------------------------
    combine_get = getattr(op, "device_combine_fn", None)
    if (
        callable(combine_get)
        and len(in_sigs) == 1
        and isinstance(in_sigs[0], TupleSig)
    ):
        if not all(_evaluable(e) for e in in_sigs[0].elements):
            return UNKNOWN  # branches not fully known: nothing to check
        fn = combine_get()
        if fn is not None:
            tup = in_sigs[0]
            branch_dtypes = {e.dtype for e in tup.elements}
            if (
                len(branch_dtypes) > 1
                and _first_float(*branch_dtypes)
                and any(
                    _dtype_drift(a, b)
                    for a in branch_dtypes for b in branch_dtypes
                )
            ):
                report.add(
                    DTYPE_DRIFT, node, op,
                    f"gathered branches mix float dtypes "
                    f"{sorted(branch_dtypes)} — the combiner will "
                    "silently promote",
                )
            try:
                specs = [_spec_for(e) for e in tup.elements]
                res = _interpret(fn, specs)
            except Exception as e:  # noqa: BLE001
                report.add(
                    SHAPE_MISMATCH, node, op,
                    f"combiner rejects branch signatures "
                    f"{_short(tup)}: {_error_line(e)}",
                )
                return UNKNOWN
            ref = tup.elements[0]
            out = _sig_from_result(res, ref)
            if isinstance(out, ArraySig):
                out = ArraySig(out.shape, out.dtype, n=tup.n, mesh=ref.mesh,
                               datum=ref.datum)
            return out

    # -- device-traceable transformer --------------------------------------
    fn_get = getattr(op, "device_fn", None)
    if callable(fn_get) and len(in_sigs) == 1 and _evaluable(in_sigs[0]):
        fn = fn_get()
        if fn is not None:
            sig = in_sigs[0]
            res, err = _eval_device_fn(fn, sig)
            if err is not None:
                report.add(
                    SHAPE_MISMATCH, node, op,
                    f"rejects input {_short(sig)}: {err}",
                )
                return UNKNOWN
            out = _sig_from_result(res, sig)
            if (
                isinstance(out, ArraySig)
                and _dtype_drift(sig.dtype, out.dtype)
                and not getattr(op, "declares_dtype_change", False)
            ):
                report.add(
                    DTYPE_DRIFT, node, op,
                    f"silently changes float dtype {sig.dtype} -> "
                    f"{out.dtype} across a stage boundary (declare with "
                    "`declares_dtype_change = True` if intended)",
                )
            return out

    # -- undeclared -------------------------------------------------------
    try:
        has_device_decl = (
            callable(fn_get) and fn_get() is not None
        ) or declared is not None
    except Exception:  # noqa: BLE001
        has_device_decl = declared is not None
    if (
        strict
        and in_sigs
        and not has_device_decl
        and all(_known(s) for s in in_sigs)
    ):
        report.add(
            UNDECLARED_SIGNATURE, node, op,
            f"host-side operator has no declared output_signature (and no "
            f"device_fn) for input {', '.join(_short(s) for s in in_sigs)}",
            severity="error",
        )
    return UNKNOWN


def _check_cache_cut(graph: Graph, node: NodeId, op, report: VerifyReport):
    """A Cacher must sit on a fused-stage *boundary*: if its dependency
    and its consumer would have composed into one function, the cut
    splits the fusable region — the exact placement mistake
    AutoCacheRule refuses mechanically. Delegates to the authoritative
    predicate (``fusion.cache_would_split_fusion``) on the
    cacher-stripped graph, so this check and the optimizer's can never
    disagree about what fuses."""
    from . import fusion

    deps = graph.get_dependencies(node)
    if len(deps) != 1 or not isinstance(deps[0], NodeId):
        return
    d = deps[0]
    try:
        # Remove the cacher: its consumers re-attach directly to d —
        # the graph the fusion rules would have seen without the cut.
        stripped = graph.replace_dependency(node, d).remove_node(node)
    except Exception:  # noqa: BLE001 — malformed surgery: other checks own it
        return
    if fusion.cache_would_split_fusion(stripped, d, {}):
        dop = graph.get_operator(d)
        consumer_labels = sorted(
            stripped.get_operator(c).label
            for c, cdeps in stripped.dependencies.items()
            if d in cdeps
        )
        report.add(
            CACHE_SPLITS_FUSION, node, op,
            f"cache cut after {dop.label} ({d!r}, feeding "
            f"{', '.join(consumer_labels)}) splits a fusable region — "
            "the stages would otherwise compose into one function",
        )


def verify_graph(
    graph: Graph,
    source_sigs: Optional[Mapping[SourceId, Sig]] = None,
    strict: bool = False,
) -> VerifyReport:
    """Run the abstract interpretation over ``graph`` and return the
    report. ``source_sigs`` binds signatures to unbound sources (the
    apply pre-pass passes the example-input signature); unbound sources
    default to :data:`UNKNOWN`."""
    report = VerifyReport()
    sigs: Dict[GraphId, Sig] = {}
    for src in graph.sources:
        sigs[src] = (source_sigs or {}).get(src, UNKNOWN)

    for gid in _full_topo(graph):
        if gid in sigs:
            continue
        if isinstance(gid, SinkId):
            sigs[gid] = sigs.get(graph.get_sink_dependency(gid), UNKNOWN)
            continue
        if isinstance(gid, SourceId):
            sigs[gid] = UNKNOWN
            continue
        op = graph.get_operator(gid)
        deps = graph.get_dependencies(gid)
        in_sigs = [sigs.get(d, UNKNOWN) for d in deps]
        if isinstance(op, DatasetOperator):
            sigs[gid] = signature_of_value(op.dataset)
        elif isinstance(op, DatumOperator):
            sigs[gid] = signature_of_value(op.datum)
        elif isinstance(op, ExpressionOperator):
            sigs[gid] = UNKNOWN
        else:
            sigs[gid] = _infer_and_check(
                graph, gid, op, in_sigs, report, strict
            )
    report.sigs = sigs
    return report


# ---------------------------------------------------------------------------
# Pre-pass entry points (fit / optimizer / apply)
# ---------------------------------------------------------------------------


def verification_mode() -> str:
    """The ``KEYSTONE_VERIFY`` knob: ``"on"`` (default), ``"off"``
    (skip the pre-pass entirely), or ``"strict"`` (undeclared host-op
    signatures become errors too)."""
    raw = os.environ.get("KEYSTONE_VERIFY", "on").strip().lower()
    if raw in ("off", "0", "false", "no", "disable", "disabled"):
        return "off"
    if raw == "strict":
        return "strict"
    return "on"


# One-slot memo: Pipeline.fit verifies a graph and then immediately hands
# the same object to Optimizer.execute — don't interpret it twice.
_LAST_VERIFIED: Optional["weakref.ref[Graph]"] = None


def _recently_verified(graph: Graph) -> bool:
    return _LAST_VERIFIED is not None and _LAST_VERIFIED() is graph


def _mark_verified(graph: Graph) -> None:
    global _LAST_VERIFIED
    try:
        _LAST_VERIFIED = weakref.ref(graph)
    except TypeError:  # pragma: no cover — Graph is weakref-able
        _LAST_VERIFIED = None


def verify_fit_graph(graph: Graph, context: str = "pipeline plan") -> None:
    """The default pre-pass ``Pipeline.fit`` and ``Optimizer.execute``
    run: verify, raise :class:`PlanVerificationError` on error-severity
    findings, log warnings. Honors ``KEYSTONE_VERIFY``."""
    mode = verification_mode()
    if mode == "off":
        return
    if _recently_verified(graph):
        return
    from keystone_tpu_torch import obs

    with obs.span("verify.pre_pass", context=context, mode=mode,
                  nodes=len(graph.operators)) as sp:
        report = verify_graph(graph, strict=(mode == "strict"))
        sp.set(warnings=len(report.warnings), errors=len(report.errors))
        report.raise_if_errors(context)
    # Memoize only CLEAN graphs (fit hands the same object straight to
    # the optimizer pre-pass): a failed verification must re-run if the
    # caller retries.
    _mark_verified(graph)


def verify_apply_graph(
    graph: Graph,
    source: SourceId,
    sink: SinkId,
    example: Any = None,
    context: str = "apply plan",
) -> Optional[VerifyReport]:
    """The apply (and, later, export) pre-pass: the graph must be an
    apply-only (transformer and state-free) plan, and — when an
    ``example`` datum is given — the whole chain must typecheck from its
    concrete signature. Returns the report (None when verification is
    off)."""
    mode = verification_mode()
    if mode == "off":
        return None
    report = VerifyReport()
    for node in graph.nodes:
        op = graph.get_operator(node)
        if isinstance(op, (EstimatorOperator, DelegatingOperator)):
            report.add(
                ESTIMATOR_IN_APPLY, node, op,
                "estimator state reachable from the apply graph — serving "
                "never runs fits; call .fit() first",
            )
    if report.errors:
        report.raise_if_errors(context)

    source_sigs: Dict[SourceId, Sig] = {}
    if example is not None:
        if not _is_arraylike(example):
            example = np.asarray(example)
        source_sigs[source] = ArraySig(
            (None,) + tuple(int(d) for d in example.shape),
            dtype_name(example.dtype),
        )
    inner = verify_graph(
        graph, source_sigs=source_sigs, strict=(mode == "strict")
    )
    inner.findings.extend(report.findings)
    inner.raise_if_errors(context)
    return inner


# ---------------------------------------------------------------------------
# Runtime error coordinates (executor satellite)
# ---------------------------------------------------------------------------


def describe_value(value: Any) -> str:
    """One-line signature description of a concrete runtime value."""
    try:
        return signature_of_value(value).describe()
    except Exception:  # noqa: BLE001 — annotation must never mask the error
        return type(value).__name__


def annotate_node_error(
    exc: BaseException,
    node: GraphId,
    op: Operator,
    dep_values: Sequence[Any],
) -> None:
    """Attach graph coordinates (NodeId, operator class, inferred input
    signatures) to a runtime node failure, IN PLACE — the exception type
    is preserved so callers' except clauses keep matching, and the
    annotation only applies once (the deepest failing node wins), so
    re-raises through enclosing nodes stay clean."""
    if getattr(exc, "_keystone_node_context", None) is not None:
        return
    inputs = ", ".join(describe_value(v) for v in dep_values) or "-"
    label = getattr(op, "label", None) or type(op).__name__
    context = (
        f"[keystone node {node!r} op={label} "
        f"({type(op).__name__}) inputs=({inputs})]"
    )
    try:
        exc._keystone_node_context = context  # type: ignore[attr-defined]
    except Exception:  # noqa: BLE001 — some exceptions forbid attributes
        return
    try:
        if exc.args and isinstance(exc.args[0], str):
            exc.args = (f"{exc.args[0]}\n  {context}",) + exc.args[1:]
        else:
            exc.args = exc.args + (context,)
    except Exception:  # noqa: BLE001 — never mask the original failure
        pass
