"""MnistRandomFFT: random-FFT featurization + block least squares on MNIST
(reference: pipelines/images/mnist/MnistRandomFFT.scala:21-115).

Port of ``keystone_tpu/pipelines/mnist_random_fft.py``. Composition:
gather(numFFTs × [RandomSignNode → PaddedFFT → LinearRectifier]) →
VectorCombiner → BlockLeastSquares(blockSize, 1, λ) → MaxClassifier.

:func:`run` keeps the reference's order: it applies the unfitted pipeline
to the training rows, which fits it on first use. The optimizer then
merges the training featurization with that apply's, the featurization has
two consumers, the estimator fusion declines, and the fit takes the
stacked block solver on the materialized features: one ``gram_corr_sym``
launch a block (one block at MNIST's 4 × 512 = 2,048 features and block
2,048). The gather lowers to the packed-pair FFT function on cuFFT
(``ops/stats.py::packed_fft_gather_fn``). ``fit_first=True`` fits with
``pipeline.fit()`` first instead: the gather is then fused into the fit,
which solves with the flat block solver through ``block_gram_sym``,
``block_corr`` and ``block_residual_update``.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass, replace
from typing import List, Optional

import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.loaders import load_digits_real, load_labeled_csv, synthetic_mnist
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator, MulticlassMetrics
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.stats import LinearRectifier, PaddedFFT, RandomSignNode
from keystone_tpu_torch.ops.util import (
    ClassLabelIndicatorsFromIntLabels,
    MaxClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.workflow import FittedPipeline, Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.mnist")

NUM_CLASSES = 10
MNIST_IMAGE_SIZE = 784


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 4
    block_size: int = 2048
    lam: Optional[float] = None
    seed: int = 0
    synthetic_n: int = 4096  # training rows when no train_location is given
    synthetic_test_n: Optional[int] = None  # test rows then (default max(n // 4, 256))
    image_size: int = MNIST_IMAGE_SIZE  # 784 for MNIST CSVs, 64 for the digits
    use_digits: bool = False  # scikit-learn's real digits instead of synthetic rows


@dataclass
class MnistRun:
    """What :func:`run` returns: the pipeline, its fitted form, the train and
    test metrics, and the fit and apply wall seconds (each ending in a
    device synchronize; apply first, ``fit_seconds`` covers the fit and the
    training rows' apply)."""

    pipeline: Pipeline
    fitted: FittedPipeline
    train_eval: MulticlassMetrics
    test_eval: MulticlassMetrics
    fit_seconds: float
    apply_seconds: float


def _sign_nodes(config: MnistRandomFFTConfig, device) -> List[RandomSignNode]:
    return [RandomSignNode.create(config.image_size, seed=config.seed + i, device=device)
            for i in range(config.num_ffts)]


def build_featurizer(config: MnistRandomFFTConfig, device=None,
                     sign_nodes: Optional[List[RandomSignNode]] = None) -> Pipeline:
    """numFFTs branches of sign flip, padded FFT and rectifier
    (MnistRandomFFT.scala:52-60). ``sign_nodes`` replaces the seeded draws
    (one per branch), e.g. signs carried across from the reference."""
    if sign_nodes is None:
        sign_nodes = _sign_nodes(config, device)
    branches = [node.and_then(PaddedFFT()).and_then(LinearRectifier(0.0))
                for node in sign_nodes]
    return Pipeline.gather(branches).and_then(VectorCombiner())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: MnistRandomFFTConfig, device=None,
        sign_nodes: Optional[List[RandomSignNode]] = None, fit_first: bool = False) -> MnistRun:
    """Build, train and evaluate on ``device`` (default: the CUDA device,
    raising without one). ``sign_nodes`` replaces the featurizer's seeded
    draws. ``fit_first=False`` (the default, the reference's order) applies
    the unfitted pipeline to the training rows first; ``fit_first=True``
    calls ``pipeline.fit()`` first."""
    device = resolve_device(device)
    start = time.perf_counter()
    if config.train_location:
        # File labels are 1-indexed (MnistRandomFFT.scala:34-37).
        train = load_labeled_csv(config.train_location, label_offset=-1, device=device)
        test = load_labeled_csv(config.test_location, label_offset=-1, device=device)
    elif config.use_digits:
        train, test = load_digits_real(seed=config.seed, device=device)
        dim = int(train.data.array.shape[1])
        if config.image_size != dim:
            # The featurizer's width follows the data (64 for the digits).
            config = replace(config, image_size=dim)
    else:
        train = synthetic_mnist(config.synthetic_n, seed=config.seed, device=device)
        n_test = config.synthetic_test_n or max(config.synthetic_n // 4, 256)
        test = synthetic_mnist(n_test, seed=config.seed + 1, device=device)

    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    pipeline = build_featurizer(config, device, sign_nodes).and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam or 0.0),
        train.data,
        labels,
    ).and_then(MaxClassifier())

    _sync(device)
    t0 = time.perf_counter()
    if fit_first:
        fitted = pipeline.fit()
        _sync(device)
        fit_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_pred = fitted.apply(train.data)
        test_pred = fitted.apply(test.data)
    else:
        train_pred = pipeline.apply(train.data).get()
        _sync(device)
        fit_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        test_pred = pipeline.apply(test.data).get()
    _sync(device)
    apply_seconds = time.perf_counter() - t0
    if not fit_first:
        # The applies published the fit to the state table: this loads it.
        fitted = pipeline.fit()

    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    logger.info("TRAIN Error is %.2f%%", 100 * train_eval.total_error)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    logger.info("TEST Error is %.2f%%", 100 * test_eval.total_error)
    logger.info("Fit %.3f s, apply %.3f s, pipeline took %.1f s",
                fit_seconds, apply_seconds, time.perf_counter() - start)
    if device.type == "cuda":
        logger.info("Peak allocated device memory %.2f GiB (since the process started or "
                    "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30)
    return MnistRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds)


def main(argv=None):
    parser = argparse.ArgumentParser("MnistRandomFFT")
    parser.add_argument("--trainLocation", default="")
    parser.add_argument("--testLocation", default="")
    parser.add_argument("--numFFTs", type=int, default=4)
    parser.add_argument("--blockSize", type=int, default=2048)
    parser.add_argument("--lambda", dest="lam", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--syntheticN", type=int, default=4096,
                        help="training rows of the synthetic data (no CSVs given)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = MnistRandomFFTConfig(
        train_location=args.trainLocation,
        test_location=args.testLocation,
        num_ffts=args.numFFTs,
        block_size=args.blockSize,
        lam=args.lam,
        seed=args.seed,
        synthetic_n=args.syntheticN,
    )
    result = run(config, device=args.device)
    print(f"TRAIN Error is {100 * result.train_eval.total_error:.2f}%")
    print(f"TEST Error is {100 * result.test_eval.total_error:.2f}%")


if __name__ == "__main__":
    main()
