"""Cost-model-driven solver selection.

Port of ``keystone_tpu/ops/learning/cost.py`` (reference:
nodes/learning/CostModel.scala:6-16, LeastSquaresEstimator.scala:26-87,
ChainUtils.scala for TransformerLabelEstimatorChain), one device.

:class:`LeastSquaresEstimator` offers the reference's candidates in the
reference's order, prices each with its analytic
``cost(n, d, k, sparsity, numMachines, cpuW, memW, netW)`` model, cuts the
ones whose resident operands pass the device-memory budget (or whose
dataset passes the host budget), and hands the optimizer the first minimum
of what is left; when nothing fits, the least-resident candidate.

Differences from the reference:

  - the default weight family is the reference's EC2 cluster family (cpu
    3.8e-4, mem 2.9e-1, network 1.32, and the engines' random-access
    overheads), the reference's ``KEYSTONE_COST_WEIGHTS=ec2``; the
    reference's default is its TPU family. ``KEYSTONE_COST_WEIGHTS``
    selects as in the reference: ``ec2``, ``tpu`` (the reference's TPU
    constants, carried only so that traces priced under them read the same
    in the port: they are rates of a TPU, not of the card) or
    ``calibrated:<artifact.json>``, a refit written by the calibration
    plane (``obs/calibrate.py``; ``scripts/torch_fit_cost_weights.py`` fits
    one from fits timed on the card). An artifact's null overhead falls
    back to the EC2 constant (the reference's, to its TPU one);
  - ``num_machines`` defaults to 1 (the port runs on one device; the mesh
    is ROADMAP A.15), and the device budget is the CUDA device's total
    memory (the counterpart of the reference's ``bytes_limit``). Every
    tier the streaming choice prices runs: past the gram tier's wall a
    cosine bank's fit takes the block-streamed tier, on one device;
  - beside the reference's ``cost.decision`` event and ``PlacementEngine``
    mirror, the decision is also kept on the estimator as
    ``last_decision``; ``choose_image_tier`` returns its decision as a dict
    (the reference returns the event's outcome reference);
  - ``choose_mesh_layout`` (A.15) is not ported.

A shard-backed input (the sample collector's ``shard_backed`` fact) prices
the disk tier: the streaming choice then stages segments from disk, its
resident bytes stop scaling with n, and it is the one candidate exempt
from the host budget, which every other candidate must meet with the
whole dataset resident.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import obs
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.dataset import tree_leaves
from keystone_tpu_torch.ops.sparse import Densify, Sparsify, is_sparse_dataset
from keystone_tpu_torch.placement.engine import KIND_IMAGE_TIER, KIND_SOLVER, PlacementEngine
from keystone_tpu_torch.workflow import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.optimizable import OptimizableLabelEstimator

logger = logging.getLogger("keystone_tpu_torch.cost")

# Reference cluster cost weights (LeastSquaresEstimator.scala:28-31; fit on
# a 2015 16-node r3.4xlarge cluster), with the reference's EC2 random-access
# multipliers of the sparse gather pass, the two sketch passes, the image
# tier's host decode and the zoo's tenant page-in on the sequential mem
# rate. The port's default family.
EC2_CPU_WEIGHT = 3.8e-4
EC2_MEM_WEIGHT = 2.9e-1
EC2_NETWORK_WEIGHT = 1.32
EC2_SPARSE_GATHER_OVERHEAD = 8.0
EC2_SRHT_SKETCH_OVERHEAD = 10.0
EC2_COUNTSKETCH_OVERHEAD = 6.0
EC2_IMAGE_DECODE_OVERHEAD = 4.0
EC2_ZOO_PAGE_OVERHEAD = 2.0

# The reference's TPU family (its ``cost.py:126-171``), fit there from a
# TPU's device time. Carried only so that a trace priced under
# ``KEYSTONE_COST_WEIGHTS=tpu`` (the reference's default) re-prices the
# same in the port; these are not rates of the card.
TPU_CPU_WEIGHT = 3.8e-15
TPU_MEM_WEIGHT = 1.9e-11
TPU_NETWORK_WEIGHT = 1.0e-11
TPU_SPARSE_GATHER_OVERHEAD = 500.0
TPU_SRHT_SKETCH_OVERHEAD = 650.0
TPU_COUNTSKETCH_OVERHEAD = 250.0
TPU_IMAGE_DECODE_OVERHEAD = 200.0
TPU_ZOO_PAGE_OVERHEAD = 50.0

# Weight-family spec for trace-calibrated constants:
# KEYSTONE_COST_WEIGHTS=calibrated:<path> points at a refit artifact written
# by the calibration plane (obs/calibrate.py).
CALIBRATED_PREFIX = "calibrated:"

# Loaded artifacts by path -> (mtime, weights dict): a selector reading the
# env at each construction must not re-read and re-validate the JSON every
# time, but an artifact refit in place must be picked up.
_CALIBRATED_CACHE: dict = {}

_FAMILIES = {
    "ec2": {
        "cpu": EC2_CPU_WEIGHT, "mem": EC2_MEM_WEIGHT, "network": EC2_NETWORK_WEIGHT,
        "sparse_gather_overhead": EC2_SPARSE_GATHER_OVERHEAD,
        "srht_sketch_overhead": EC2_SRHT_SKETCH_OVERHEAD,
        "countsketch_overhead": EC2_COUNTSKETCH_OVERHEAD,
        "image_decode_overhead": EC2_IMAGE_DECODE_OVERHEAD,
        "zoo_page_overhead": EC2_ZOO_PAGE_OVERHEAD,
    },
    "tpu": {
        "cpu": TPU_CPU_WEIGHT, "mem": TPU_MEM_WEIGHT, "network": TPU_NETWORK_WEIGHT,
        "sparse_gather_overhead": TPU_SPARSE_GATHER_OVERHEAD,
        "srht_sketch_overhead": TPU_SRHT_SKETCH_OVERHEAD,
        "countsketch_overhead": TPU_COUNTSKETCH_OVERHEAD,
        "image_decode_overhead": TPU_IMAGE_DECODE_OVERHEAD,
        "zoo_page_overhead": TPU_ZOO_PAGE_OVERHEAD,
    },
}
# The family an artifact's null overhead falls back to: the port's default.
_DEFAULT_FAMILY = "ec2"


def _calibrated_weights(path: str) -> dict:
    try:
        mtime = os.stat(path).st_mtime_ns
    except OSError as e:
        raise ValueError(
            f"KEYSTONE_COST_WEIGHTS={CALIBRATED_PREFIX}{path}: artifact "
            f"is unreadable: {e}"
        ) from e
    cached = _CALIBRATED_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    from keystone_tpu_torch.obs.calibrate import load_calibration_artifact

    weights = dict(load_calibration_artifact(path)["weights"])
    _CALIBRATED_CACHE[path] = (mtime, weights)
    return weights


def _parse_weights_env() -> Tuple[str, Optional[str]]:
    """Parse ``KEYSTONE_COST_WEIGHTS`` into (family, artifact_path).

    Accepted (the family part case-insensitive, an artifact path keeping
    its case): unset or empty or ``ec2`` -> the EC2 constants, ``tpu`` ->
    the reference's TPU constants, ``calibrated:<path>`` -> a refit
    artifact. Anything else raises naming the variable: a mistyped family
    must not silently select the default and mis-price every decision."""
    raw = os.environ.get("KEYSTONE_COST_WEIGHTS", "").strip()
    low = raw.lower()
    if not raw or low == "ec2":
        return "ec2", None
    if low == "tpu":
        return "tpu", None
    if low.startswith(CALIBRATED_PREFIX):
        return "calibrated", raw[len(CALIBRATED_PREFIX):]
    raise ValueError(
        f"KEYSTONE_COST_WEIGHTS={raw!r}: expected 'ec2', 'tpu' or "
        f"'calibrated:<artifact.json>'"
    )


def weights_family_name() -> str:
    """The active weight family's name: ``ec2`` (the default), ``tpu`` or
    ``calibrated``, what decision audits and calibration reports record as
    provenance."""
    return _parse_weights_env()[0]


def _active(key: str) -> float:
    family, path = _parse_weights_env()
    if family == "calibrated":
        v = _calibrated_weights(path).get(key)
        return float(v) if v is not None else _FAMILIES[_DEFAULT_FAMILY][key]
    return _FAMILIES[family][key]


def active_weights() -> Tuple[float, float, float]:
    """The selector's (cpu, mem, network) weights under the family
    ``KEYSTONE_COST_WEIGHTS`` selects (the EC2 constants by default); a
    malformed or missing artifact, or an unknown family, raises naming the
    variable rather than mis-pricing silently."""
    return _active("cpu"), _active("mem"), _active("network")


def sparse_gather_overhead() -> float:
    """Random-access multiplier of the sparse gather engine's mem term under
    the active family (an artifact's null falls back to the EC2 constant)."""
    return _active("sparse_gather_overhead")


def srht_sketch_overhead() -> float:
    """Random-access multiplier of the SRHT engine's densify-scatter pass
    under the active family."""
    return _active("srht_sketch_overhead")


def countsketch_overhead() -> float:
    """Random-access multiplier of the IHS engine's CountSketch scatter-add
    pass under the active family."""
    return _active("countsketch_overhead")


def image_decode_overhead() -> float:
    """Random-access multiplier of the image tier's host decode pass under
    the active family (reference ``cost.py:299``)."""
    return _active("image_decode_overhead")


def zoo_page_overhead() -> float:
    """Random-access multiplier of the zoo's tenant page-in pass (spill
    decode + CRC + rebuild) under the active family (reference
    ``cost.py:312``)."""
    return _active("zoo_page_overhead")


def _family_or_custom() -> str:
    try:
        return weights_family_name()
    except ValueError:
        return "custom"


# Device-memory budget where the device reports none (the CPU).
DEFAULT_HBM_BYTES = 16 << 30
# Fraction of device memory a solver's resident operands may claim: the
# rest covers scratch, temporaries and transfer buffers.
DEFAULT_HBM_UTILIZATION = 0.85
# Host-memory budget where the OS reports nothing, and the fraction of host
# RAM the dataset may claim.
DEFAULT_HOST_BYTES = 64 << 30
DEFAULT_HOST_UTILIZATION = 0.8


def device_memory_bytes(device=None) -> int:
    """Device-memory budget of ``device``: a CUDA device's total memory,
    else the conservative default."""
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return DEFAULT_HBM_BYTES


def host_memory_bytes() -> int:
    """Host-RAM budget for resident datasets: the
    ``KEYSTONE_HOST_BUDGET_BYTES`` override, else the OS-reported physical
    memory, else the conservative default."""
    env = os.environ.get("KEYSTONE_HOST_BUDGET_BYTES")
    if env:
        return int(float(env))
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page > 0:
            return int(pages * page)
    except (ValueError, OSError, AttributeError):
        pass
    return DEFAULT_HOST_BYTES


def candidate_label(est) -> str:
    """Stable human-readable label of one solver candidate, disambiguating
    the engine and storage-class variants of one estimator type
    (``solver=`` / ``compress=``, and the port's ``gram_dtype=`` where it
    is set: the bf16 and f32 gram engines are priced alike but do not run
    alike, so a measured row must say which one ran). The
    selector's candidates set no ``gram_dtype``: their labels are the
    reference's."""
    name = type(est).__name__
    qual = [
        str(v) for v in (getattr(est, "solver", None), getattr(est, "compress", None),
                         getattr(est, "gram_dtype", None)) if v
    ]
    return name + (f"[{','.join(qual)}]" if qual else "")


IMAGE_TIERS = ("resident", "resident_u8", "disk_shards")


def choose_image_tier(
    n_images: int, d: int, k: int,
    *,
    images_per_segment: int = 256,
    prefetch_depth: int = 2,
    host_budget_bytes: Optional[float] = None,
    host_utilization: float = DEFAULT_HOST_UTILIZATION,
):
    """Select the storage tier for a decoded image set (reference
    ``cost.py:525``): this is what lets ``data.images.load_images`` route a
    past-host-RAM image set through disk shards with no flag. ``d`` is
    decoded floats an image (x·y·c after augmentation), ``k`` the label
    width. Candidates, each infeasible (cost infinity) past the host
    budget:

      - ``resident``: decoded float32 rows in host RAM: one decode pass,
        the cheapest reads;
      - ``resident_u8``: uint8 pixel rows (exact for 8-bit sources), 4×
        smaller, a widening cast an epoch;
      - ``disk_shards``: spilled through ``DiskDenseShardWriter``; host
        residency is ``prefetch_depth + 1`` staged segments; pays the spill
        write and the re-read.

    Returns ``(tier_name, decision)``, the decision a dict of the priced
    candidates; the same decision is emitted as a ``cost.decision`` event
    (``decision="image_tier"``) and its ``placement.decision`` mirror (the
    reference returns the event's outcome reference). Raises when no tier
    fits.
    """
    cpu_w, mem_w, net_w = active_weights()
    family = _family_or_custom()
    if host_budget_bytes is not None:
        budget = float(host_budget_bytes)
    else:
        budget = host_memory_bytes() * host_utilization
    n = int(n_images)
    cells = float(n) * (d + k)
    decode_s = mem_w * image_decode_overhead() * float(n) * d
    seg_bytes = float(images_per_segment) * (4.0 * d + 4.0 * k)
    resident_bytes = {
        "resident": cells * 4.0,
        "resident_u8": float(n) * (d + 4.0 * k),
        "disk_shards": (prefetch_depth + 1) * seg_bytes,
    }
    tier_cost = {
        # One decode pass each; reads price the per-epoch traffic.
        "resident": decode_s + mem_w * cells,
        # uint8 rows pay a widening cast an epoch.
        "resident_u8": decode_s + mem_w * cells * 1.25,
        # The spill write and the checksummed re-read, both full passes.
        "disk_shards": decode_s + mem_w * cells * 3.0,
    }
    costs = [
        tier_cost[t] if resident_bytes[t] <= budget else float("inf") for t in IMAGE_TIERS
    ]
    if all(c == float("inf") for c in costs):
        raise ValueError(
            f"no image tier fits the host budget {budget:.3g} B "
            f"(even {prefetch_depth + 1} staged segments of "
            f"{seg_bytes:.3g} B); shrink images_per_segment"
        )
    candidates = [
        {
            "label": t,
            "cost_s": None if c == float("inf") else float(c),
            "feasible": c != float("inf"),
            "resident_bytes": float(resident_bytes[t]),
            "chip_resident": False,  # the image tier is host-side
            "host_ok": resident_bytes[t] <= budget,
        }
        for t, c in zip(IMAGE_TIERS, costs)
    ]
    context = {
        "n": n, "d": int(d), "k": int(k),
        "images_per_segment": int(images_per_segment),
        "prefetch_depth": int(prefetch_depth),
        "host_budget_bytes": float(budget),
    }
    # The placement mirror: its first minimum is the first minimum of the
    # tiers in order.
    choice = PlacementEngine(weights_family=family).decide(
        KIND_IMAGE_TIER, candidates, context=context,
    )
    winner = IMAGE_TIERS[choice.index]
    decision = {
        "decision": "image_tier",
        "winner": winner,
        "candidates": candidates,
        "reason": "argmin",
        "context": {
            **context,
            "weights": {"cpu": cpu_w, "mem": mem_w, "network": net_w, "family": family},
        },
    }
    obs.record_cost_decision(obs.CostDecision(**decision))
    logger.info("image tier decision: %s", decision)
    return winner, decision


class CostModel:
    """Analytic per-solver performance model (CostModel.scala:6-16): the
    interface every :class:`LeastSquaresEstimator` candidate implements,
    beside ``resident_bytes(n, d, k, sparsity, num_machines)``."""

    def cost(
        self,
        n: int,
        d: int,
        k: int,
        sparsity: float,
        num_machines: int,
        cpu_weight: float,
        mem_weight: float,
        network_weight: float,
    ) -> float:
        raise NotImplementedError


class Chained(Transformer):
    """The fitted form of :class:`TransformerLabelEstimatorChain`: the
    chain's transformer, then the fitted model. Module-level (the
    reference's is a local class) so that a fitted pipeline pickles."""

    def __init__(self, transformer: Transformer, model: Transformer):
        self.transformer = transformer
        self.model = model

    def apply(self, x):
        return self.model.apply(self.transformer.apply(x))

    def batch_apply(self, ds: Dataset) -> Dataset:
        return self.model.batch_apply(self.transformer.batch_apply(ds))


class TransformerLabelEstimatorChain(LabelEstimator):
    """Fuse a Transformer with a LabelEstimator into one LabelEstimator
    (reference: ChainUtils.scala)."""

    def __init__(self, transformer: Transformer, estimator: LabelEstimator):
        self.transformer = transformer
        self.estimator = estimator

    def fit(self, data: Dataset, labels: Dataset) -> Chained:
        transformed = self.transformer.batch_apply(data)
        return Chained(self.transformer, self.estimator.fit(transformed, labels))

    @property
    def weight(self) -> int:
        return getattr(self.estimator, "weight", 1)


def _sample_device(sample: Dataset) -> torch.device:
    """The device of a sample's tensors (the CPU for host or numpy data)."""
    if sample.is_host:
        return torch.device("cpu")
    leaf = tree_leaves(sample.data)[0]
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array with its zeros where they were (bf16,
    which numpy lacks, widened to float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


class LeastSquaresEstimator(OptimizableLabelEstimator):
    """Auto-selecting least-squares solver (LeastSquaresEstimator.scala:26-87).

    Candidates, in the reference's order: DenseLBFGS, Sparsify->SparseLBFGS
    (gather, gram, and compressed-resident gram: the int16 + bf16 4 B/nnz
    storage class of ``data/resident.py``), Densify->BlockLS(block_size,
    block_iters), Densify->exact normal equations, the streaming tier
    (StreamingLeastSquaresChoice: featurize inside the fit, bound to the
    upstream featurizer by the optimizer's StreamedFitFusionRule), and, only
    when ``allow_approximate``, the randomized tier:
    Densify->SketchedLeastSquaresEstimator, Sparsify->SketchedLeastSquares
    (SRHT) and Sparsify->IterativeHessianSketch. ``optimize`` measures
    (n, d, k, sparsity) from the sample and picks the cost-model argmin
    among candidates whose resident operands fit the device-memory budget
    and whose dataset fits the host budget: past the device wall, the
    streaming tier is the only candidate that can run at all. The weights
    are the active family's (``KEYSTONE_COST_WEIGHTS``) unless passed. The
    decision (candidates with cost, feasibility and resident bytes; winner;
    reason; context) is emitted as a ``cost.decision`` event with its
    ``placement.decision`` mirror, kept as ``last_decision`` and logged; the
    chosen estimator carries the event's ``_pending_cost_outcome``, which
    its fit stamps with the measured seconds (``workflow/pipeline.py``).
    """

    def __init__(
        self,
        lam: float = 0.0,
        num_machines: int = 1,
        allow_approximate: bool = False,
        hbm_bytes: Optional[float] = None,
        host_budget_bytes: Optional[float] = None,
        block_size: int = 1000,
        block_iters: int = 3,
        cpu_weight: Optional[float] = None,
        mem_weight: Optional[float] = None,
        network_weight: Optional[float] = None,
    ):
        from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
        from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSwithL2, SparseLBFGSwithL2
        from keystone_tpu_torch.ops.learning.linear import (
            LinearMapEstimator,
            SketchedLeastSquaresEstimator,
        )
        from keystone_tpu_torch.ops.learning.streaming_ls import StreamingLeastSquaresChoice

        self.lam = lam
        self.num_machines = num_machines
        self.hbm_bytes = hbm_bytes
        self.host_budget_bytes = host_budget_bytes
        # None -> the active weight family, resolved at construction so one
        # estimator's ranking is stable if the env changes mid-process.
        a_cpu, a_mem, a_net = active_weights()
        self.cpu_weight = a_cpu if cpu_weight is None else cpu_weight
        self.mem_weight = a_mem if mem_weight is None else mem_weight
        self.network_weight = a_net if network_weight is None else network_weight
        self.last_decision: Optional[dict] = None

        dense_lbfgs = DenseLBFGSwithL2(lam=lam, num_iterations=20)
        sparse_lbfgs = SparseLBFGSwithL2(lam=lam, num_iterations=20)
        # The gram engine: fold G once, iterate data-free.
        sparse_gram = SparseLBFGSwithL2(lam=lam, num_iterations=20, solver="gram")
        # The compressed-resident storage class: the same gram iterates over
        # int16 + bf16 operands at 4 B/nnz, priced with the same cost model,
        # so the capacity cut decides between it and the raw engine.
        sparse_gram_compressed = SparseLBFGSwithL2(
            lam=lam, num_iterations=20, solver="gram", compress="int16_bf16",
        )
        block = BlockLeastSquaresEstimator(block_size, block_iters, lam=lam)
        exact = LinearMapEstimator(lam)
        streaming = StreamingLeastSquaresChoice(
            num_iter=block_iters, lam=lam, block_size_hint=max(block_size, 1024),
        )
        self._streaming_choice = streaming

        self.options: Sequence[Tuple[object, LabelEstimator]] = [
            (dense_lbfgs, dense_lbfgs),
            (sparse_lbfgs, TransformerLabelEstimatorChain(Sparsify(), sparse_lbfgs)),
            (sparse_gram, TransformerLabelEstimatorChain(Sparsify(), sparse_gram)),
            # After the raw gram engine: equal cost when both fit (the first
            # minimum wins), so compression engages only when raw residency
            # is the binding constraint.
            (sparse_gram_compressed,
             TransformerLabelEstimatorChain(Sparsify(), sparse_gram_compressed)),
            (block, TransformerLabelEstimatorChain(Densify(), block)),
            (exact, TransformerLabelEstimatorChain(Densify(), exact)),
            # Its own graph operator (no Densify chain): StreamedFitFusionRule
            # must see it directly to bind the upstream featurizer; its fit
            # densifies sparse input itself.
            (streaming, streaming),
        ]
        if allow_approximate:
            from keystone_tpu_torch.ops.learning.sketch import (
                IterativeHessianSketch,
                SketchedLeastSquares,
            )

            sketched = SketchedLeastSquaresEstimator(lam=lam)
            srht = SketchedLeastSquares(lam=lam)
            ihs = IterativeHessianSketch(lam=lam)
            self.options = list(self.options) + [
                (sketched, TransformerLabelEstimatorChain(Densify(), sketched)),
                (srht, TransformerLabelEstimatorChain(Sparsify(), srht)),
                (ihs, TransformerLabelEstimatorChain(Sparsify(), ihs)),
            ]
        self._default = dense_lbfgs

    @property
    def default(self) -> LabelEstimator:
        return self._default

    @property
    def weight(self) -> int:
        return self._default.weight

    def _measure(self, sample: Dataset) -> Tuple[int, float]:
        """(d, sparsity) of the sample, on the host. Sparsity is an exact
        ratio of counts, as numpy's mean of a boolean array gives it: cost
        ties are decided by first-minimum order, so it must not round
        differently from the reference's."""
        if is_sparse_dataset(sample):
            indices = _host(sample.data["indices"])
            # Prefer the true width threaded through by the sample
            # collector (``total_d``): ``indices.max()+1`` over a few
            # sampled rows undershoots whenever they miss the top ids.
            measured_d = int(indices.max()) + 1
            d = max(int(getattr(sample, "total_d", 0) or 0), measured_d)
            # Active fraction over the sample's rows (padded-COO lanes of
            # -1 are excluded by the mask).
            return d, float((indices >= 0).sum() / (max(sample.n, 1) * d))
        if sample.is_host:
            X = np.stack([_host(x) for x in sample.to_list()])
            return int(X.shape[-1]), float((X != 0).mean())
        X = _host(sample.array)
        # The sample's valid rows: n here is the full dataset's size.
        return int(X.shape[-1]), float(np.mean(X[: sample.n] != 0))

    def optimize(self, sample: Dataset, labels_sample: Dataset):
        # total_n: the full dataset size attached by the sample collector;
        # sample.n is just the handful of sampled rows.
        n = getattr(sample, "total_n", sample.n)
        d, sparsity = self._measure(sample)
        k = int(labels_sample.array.shape[-1])
        machines = self.num_machines

        # The streaming tier keeps raw rows resident, not features; the
        # density flag lets its capacity model default an unset raw width.
        raw_row_bytes = getattr(sample, "source_row_bytes", None)
        self._streaming_choice.raw_row_bytes = raw_row_bytes
        self._streaming_choice.input_is_sparse = is_sparse_dataset(sample)
        # The disk tier: a shard-backed source streams raw rows from disk
        # segments, so the streaming choice's resident operand stops
        # scaling with n, and host feasibility is priced per candidate.
        shard_backed = bool(getattr(sample, "shard_backed", False))
        self._streaming_choice.data_is_shard_backed = shard_backed
        self._streaming_choice.shard_segment_bytes = getattr(
            sample, "shard_segment_bytes", None
        )

        budget = (
            self.hbm_bytes if self.hbm_bytes is not None
            else device_memory_bytes(_sample_device(sample))
        ) * DEFAULT_HBM_UTILIZATION
        # An explicit host budget (constructor or env) is honored as it is;
        # the utilization derate applies only to autodetected physical RAM.
        env_budget = os.environ.get("KEYSTONE_HOST_BUDGET_BYTES")
        if self.host_budget_bytes is not None:
            host_budget = float(self.host_budget_bytes)
        elif env_budget:
            host_budget = float(env_budget)
        else:
            host_budget = host_memory_bytes() * DEFAULT_HOST_UTILIZATION
        # The streaming tier's feature slab scales down with the budget so
        # its capacity model and its actual tile sizing agree; the budget
        # itself drives its gram-vs-block tier decision.
        self._streaming_choice.slab_bytes = int(min(2 << 30, budget // 4))
        self._streaming_choice.budget_bytes = budget

        # What every candidate but the disk tier needs host-side before
        # any device placement: the raw dataset plus labels, resident once.
        host_resident = n * (raw_row_bytes if raw_row_bytes else 4.0 * d) + 4.0 * n * k

        def host_ok(opt) -> bool:
            # The disk tier (the shard-backed streaming choice) stages only
            # prefetch-depth segments host-side.
            if shard_backed and opt[0] is self._streaming_choice:
                return True
            return host_resident <= host_budget

        def resident(opt) -> float:
            rb = getattr(opt[0], "resident_bytes", None)
            return 0.0 if rb is None else rb(n, d, k, sparsity, machines)

        def total_cost(opt) -> float:
            # Resident operands past the device budget, or a dataset past
            # the host budget with no disk path, cost infinity: they would
            # run out of memory.
            if not host_ok(opt) or resident(opt) > budget:
                return float("inf")
            return opt[0].cost(
                n, d, k, sparsity, machines,
                self.cpu_weight, self.mem_weight, self.network_weight,
            )

        costs = [total_cost(opt) for opt in self.options]
        my_weights = (self.cpu_weight, self.mem_weight, self.network_weight)
        try:
            family = weights_family_name() if my_weights == active_weights() else "custom"
        except ValueError:  # an artifact broken mid-process
            family = "custom"
        candidates = [
            {
                "label": candidate_label(o[0]),
                "cost_s": None if c == float("inf") else float(c),
                "feasible": c != float("inf"),
                "resident_bytes": float(resident(o)),
                "host_ok": host_ok(o),
            }
            for o, c in zip(self.options, costs)
        ]
        context = {
            "n": int(n), "d": int(d), "k": int(k),
            "sparsity": float(sparsity), "machines": int(machines),
            "hbm_budget_bytes": float(budget),
            "host_budget_bytes": float(host_budget),
            "shard_backed": shard_backed,
        }
        # The placement engine resolves the first minimum (int(np.argmin))
        # and, when every candidate is infeasible, the first of least
        # resident bytes; it also writes the placement.decision mirror.
        choice = PlacementEngine(weights_family=family).decide(
            KIND_SOLVER, candidates, context=context, fallback="least_resident",
        )
        chosen = self.options[choice.index]
        self.last_decision = {
            "decision": "least_squares_solver",
            "winner": candidate_label(chosen[0]),
            "candidates": candidates,
            "reason": choice.reason,
            "context": {
                **context,
                "weights": {
                    "cpu": self.cpu_weight, "mem": self.mem_weight,
                    "network": self.network_weight, "family": family,
                },
            },
        }
        if choice.reason == "least_resident_fallback":
            # Nothing fits the budget model: the least-resident candidate
            # (in practice the streaming tier) beats a guaranteed OOM.
            logger.warning(
                "no solver candidate fits the %.2f GB budget at n=%d d=%d; "
                "selecting least-resident %s",
                budget / 2**30, n, d, type(chosen[0]).__name__,
            )
        logger.info("LeastSquaresEstimator decision: %s", self.last_decision)
        # The audit event, and the pending back-annotation: whoever fits the
        # winner (the executor's fit_datasets, or a fused streamed fit that
        # inherits the reference) stamps the measured seconds onto it.
        chosen[1]._pending_cost_outcome = obs.record_cost_decision(
            obs.CostDecision(**self.last_decision)
        )
        return chosen[1]
