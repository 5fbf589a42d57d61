"""TimitPipeline: cosine random features + block least squares on TIMIT
(reference: pipelines/speech/TimitPipeline.scala:37-130).

Port of ``keystone_tpu/pipelines/timit.py``, with its three solvers:

  - ``auto`` (the default, as in the reference): gather(numCosines ×
    CosineRandomFeatures) → VectorCombiner →
    ``cost.LeastSquaresEstimator(λ, blockSize, numEpochs)`` →
    MaxClassifier. The optimizer's NodeOptimizationRule measures a few
    featurized rows and the full row count, and swaps in the cheapest
    candidate whose resident operands fit the device's memory: at
    resident sizes ``Densify`` → BlockLeastSquares (the block chain, fitted
    on the materialized features by the stacked BCD), past the memory wall
    the streaming choice, which StreamedFitFusionRule then binds to the
    cosine featurizer, so the fit makes its features one row tile at a
    time, with no flag (LeastSquaresEstimator.scala:59-84). The selector's
    decision is in ``TimitRun.selector.last_decision``;
  - ``block``: gather(numCosines × CosineRandomFeatures(440→blockSize, γ,
    gaussian|cauchy)) → VectorCombiner → BlockLeastSquares(blockSize,
    numEpochs, λ) → MaxClassifier;
  - ``streaming`` (or ``streaming=True``): one cosine bank over the
    branches' concatenated W, b → StreamingFeaturizedLeastSquares(bank,
    numCosines·blockSize, blockSize, numEpochs, λ) → MaxClassifier. The fit
    makes the features one row tile at a time and folds each tile into the
    normal equations through the ``gram_sym_acc`` kernel; the applies
    featurize tile-wise too, so the (n, d) feature matrix never exists.

Difference from the reference: :func:`run` fits the pipeline explicitly
before applying it, so that it can report fit and apply wall times apart
(``fit_first=False`` keeps the reference's order).

``--solver streaming`` takes the same route in either call order: its
pipeline has no featurizer node for CSE to merge. For ``--solver block``
the call order decides the route, the same way in both packages:

  - ``pipeline.fit()`` first (this module's default): the optimizer fuses
    the four cosine branches and the combiner into one gather
    (``FusedGatherTransformer``) and that gather into the fit
    (``FusedFitEstimator``), which featurizes into one (n, d) matrix and
    solves with the flat BCD (``bcd_least_squares_fused_flat``) through the
    ``block_gram_sym`` / ``block_corr`` / ``block_residual_update`` kernels.
    The reference's fused gather runs XLA's ``cos(X Wᵀ + b)``; the port's
    runs the ``cosine_features`` kernel.
  - ``pipeline.apply(train.data)`` before any fit (the reference's
    ``keystone_tpu/pipelines/timit.py`` ``run``): the optimizer merges the
    training featurization with the apply's, that node has two consumers,
    the estimator fusion declines, and the fit splits the materialized
    features into blocks and solves with the stacked BCD
    (``bcd_least_squares_fused``) through the ``gram_corr_sym`` kernel.
  - Either way the applies featurize through the fused gather
    (``cosine_features``) and score with the fitted block model.

The README quick start (one featurizer, no gather) takes the fused flat
route whether it is fitted first or applied first to other rows: only an
apply to the training rows themselves gives the featurization a second
consumer.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass, replace
from typing import List, Optional

import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.loaders import TimitFeaturesDataLoader, synthetic_timit
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator, MulticlassMetrics
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.cost import LeastSquaresEstimator
from keystone_tpu_torch.ops.learning.streaming_ls import (
    CosineBankFeaturize,
    StreamingFeaturizedLeastSquares,
)
from keystone_tpu_torch.ops.stats import CosineRandomFeatures, CosineRandomFeaturesModel
from keystone_tpu_torch.ops.util import (
    ClassLabelIndicatorsFromIntLabels,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.workflow import FittedPipeline, Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.timit")

NUM_CLASSES = TimitFeaturesDataLoader.num_classes  # 147
NUM_INPUT_FEATURES = TimitFeaturesDataLoader.num_features  # 440


@dataclass
class TimitConfig:
    train_data_location: str = ""
    train_labels_location: str = ""
    test_data_location: str = ""
    test_labels_location: str = ""
    num_parts: int = 512  # kept for flag parity; there is one device
    num_cosines: int = 50
    gamma: float = 0.05555
    rf_type: str = "gaussian"  # or "cauchy" (TimitPipeline.scala Distributions)
    block_size: int = 4096
    num_epochs: int = 5
    lam: float = 0.0
    seed: int = 123
    synthetic_n: int = 4096
    solver: str = "auto"
    # Back-compat alias: streaming=True == solver="streaming".
    streaming: bool = False


@dataclass
class TimitRun:
    """What :func:`run` returns: the pipeline, its fitted form, the train and
    test metrics, the fit and apply wall seconds (each ending in a device
    synchronize) and, for ``--solver auto``, the solver selector (its
    ``last_decision`` holds the candidates it priced and its choice)."""

    pipeline: Pipeline
    fitted: FittedPipeline
    train_eval: MulticlassMetrics
    test_eval: MulticlassMetrics
    fit_seconds: float
    apply_seconds: float
    selector: Optional[LeastSquaresEstimator] = None


def _cosine_models(config: TimitConfig, device) -> List[CosineRandomFeaturesModel]:
    return [
        CosineRandomFeatures(
            NUM_INPUT_FEATURES,
            config.block_size,
            config.gamma,
            seed=config.seed + i,
            cauchy=(config.rf_type == "cauchy"),
            device=device,
        )
        for i in range(config.num_cosines)
    ]


def build_featurizer(
    config: TimitConfig,
    device=None,
    models: Optional[List[CosineRandomFeaturesModel]] = None,
) -> Pipeline:
    """numCosines branches of blockSize random features each
    (TimitPipeline.scala:61-78). ``models`` replaces the seeded draws (one
    per branch), e.g. weights carried across from the reference."""
    if models is None:
        models = _cosine_models(config, device)
    return Pipeline.gather([m.to_pipeline() for m in models]).and_then(VectorCombiner())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(
    config: TimitConfig,
    device=None,
    cosine_models: Optional[List[CosineRandomFeaturesModel]] = None,
    fit_first: bool = True,
) -> TimitRun:
    """Fit on the training set, then score train and test. ``device``
    defaults to the CUDA device (raising without one); ``cosine_models``
    replaces the featurizer's seeded draws.

    ``fit_first`` (the default) fits with ``pipeline.fit()`` and then applies
    the fitted pipeline: for ``--solver block`` the fused flat route.
    ``fit_first=False`` applies the unfitted pipeline to the training rows,
    which fits it on first use, as the reference's ``run`` does: the stacked
    route. Its ``fit_seconds`` then covers the fit and the training rows'
    apply, and ``apply_seconds`` the test rows' apply. ``--solver
    streaming`` takes the same route in either order, and so does each of
    ``--solver auto``'s choices (the block chain is never fused; the
    streaming choice is bound to the featurizer either way)."""
    solver = "streaming" if config.streaming else config.solver
    device = resolve_device(device)
    start = time.perf_counter()
    if config.train_data_location:
        train = TimitFeaturesDataLoader(
            config.train_data_location, config.train_labels_location, device=device
        ).labeled
        test = TimitFeaturesDataLoader(
            config.test_data_location, config.test_labels_location, device=device
        ).labeled
    else:
        train = synthetic_timit(config.synthetic_n, seed=config.seed, device=device)
        test = synthetic_timit(
            max(config.synthetic_n // 4, 256), seed=config.seed + 1, device=device
        )
        # The reference default (numCosines=50 -> 204,800 features) is a
        # 2.2M-row cluster shape (TimitPipeline.scala:30); at the synthetic
        # demo's row count it is absurdly overparametrized. Cap the demo's
        # feature width at 8n; explicit real-data runs keep what was asked.
        max_branches = max(1, (8 * config.synthetic_n) // max(config.block_size, 1))
        if config.num_cosines > max_branches:
            logger.info(
                "synthetic demo: capping numCosines %d -> %d (d <= 8n)",
                config.num_cosines, max_branches,
            )
            config = replace(config, num_cosines=max_branches)
            if cosine_models is not None:
                cosine_models = cosine_models[:max_branches]

    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    selector = None
    if solver == "streaming":
        rfs = cosine_models if cosine_models is not None else _cosine_models(config, device)
        bank = CosineBankFeaturize(
            torch.cat([rf.W for rf in rfs]), torch.cat([rf.b for rf in rfs])
        )
        est = StreamingFeaturizedLeastSquares(
            bank, d_feat=config.num_cosines * config.block_size,
            block_size=config.block_size, num_iter=config.num_epochs, lam=config.lam,
        )
        pipeline = est.with_data(train.data, labels).and_then(MaxClassifier())
    elif solver == "auto":
        # The cost model picks the solver: at resident sizes the block
        # chain, past the device-memory wall the streaming choice, which the
        # optimizer fuses with the cosine featurizer (no flag).
        selector = LeastSquaresEstimator(
            lam=config.lam, block_size=config.block_size, block_iters=config.num_epochs,
        )
        pipeline = build_featurizer(config, device, cosine_models).and_then(
            selector, train.data, labels,
        ).and_then(MaxClassifier())
    else:
        pipeline = build_featurizer(config, device, cosine_models).and_then(
            BlockLeastSquaresEstimator(config.block_size, config.num_epochs, config.lam),
            train.data,
            labels,
        ).and_then(MaxClassifier())

    _sync(device)
    if fit_first:
        t0 = time.perf_counter()
        fitted = pipeline.fit()
        _sync(device)
        fit_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        train_pred = fitted.apply(train.data)
        test_pred = fitted.apply(test.data)
        _sync(device)
        apply_seconds = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        train_pred = pipeline.apply(train.data).get()
        _sync(device)
        fit_seconds = time.perf_counter() - t0

        t0 = time.perf_counter()
        test_pred = pipeline.apply(test.data).get()
        _sync(device)
        apply_seconds = time.perf_counter() - t0
        # The applies published the fit to the state table: this loads it.
        fitted = pipeline.fit()

    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    logger.info("TRAIN Error is %.2f%%", 100 * train_eval.total_error)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    logger.info("TEST Error is %.2f%%", 100 * test_eval.total_error)
    logger.info(
        "Fit %.3f s, apply %.3f s, pipeline took %.1f s",
        fit_seconds, apply_seconds, time.perf_counter() - start,
    )
    if device.type == "cuda":
        logger.info(
            "Peak allocated device memory %.2f GiB (since the process started or "
            "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30,
        )
    return TimitRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds,
                    selector)


def main(argv=None):
    parser = argparse.ArgumentParser("Timit")
    parser.add_argument("--trainDataLocation", default="")
    parser.add_argument("--trainLabelsLocation", default="")
    parser.add_argument("--testDataLocation", default="")
    parser.add_argument("--testLabelsLocation", default="")
    parser.add_argument("--numParts", type=int, default=512)
    parser.add_argument("--numCosines", type=int, default=50)
    parser.add_argument("--gamma", type=float, default=0.05555)
    parser.add_argument("--rfType", default="gaussian", choices=["gaussian", "cauchy"])
    parser.add_argument("--blockSize", type=int, default=4096)
    parser.add_argument("--numEpochs", type=int, default=5)
    parser.add_argument("--lambda", dest="lam", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--syntheticN", type=int, default=4096,
                        help="training rows of the synthetic data (no CSVs given)")
    parser.add_argument(
        "--streaming", action="store_true",
        help="force the out-of-core fit (equivalent to --solver streaming)",
    )
    parser.add_argument(
        "--solver", default="auto", choices=["auto", "block", "streaming"],
        help="auto = cost-model selection with a device-memory feasibility cut "
        "(default); block = reference-literal BlockLeastSquares; streaming = the "
        "out-of-core tile-streamed fit",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = TimitConfig(
        train_data_location=args.trainDataLocation,
        train_labels_location=args.trainLabelsLocation,
        test_data_location=args.testDataLocation,
        test_labels_location=args.testLabelsLocation,
        num_parts=args.numParts,
        num_cosines=args.numCosines,
        gamma=args.gamma,
        rf_type=args.rfType,
        block_size=args.blockSize,
        num_epochs=args.numEpochs,
        lam=args.lam,
        seed=args.seed,
        synthetic_n=args.syntheticN,
        solver=args.solver,
        streaming=args.streaming,
    )
    result = run(config, device=args.device)
    print(f"TRAIN Error is {100 * result.train_eval.total_error:.2f}%")
    print(f"TEST Error is {100 * result.test_eval.total_error:.2f}%")


if __name__ == "__main__":
    main()
