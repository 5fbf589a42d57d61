"""VOCSIFTFisher: dense SIFT → PCA → GMM Fisher vectors → block least squares,
evaluated by VOC mean average precision
(reference: pipelines/images/voc/VOCSIFTFisher.scala:23-105).

Port of ``keystone_tpu/pipelines/voc_sift_fisher.py``. Composition:
PixelScaler → GrayScaler → Cacher → SIFTExtractor → ColumnPCAEstimator →
GMMFisherVectorEstimator → FloatToDouble → MatrixVectorizer → NormalizeRows
→ SignedHellingerMapper → NormalizeRows → Cacher → BlockLeastSquares → MAP
eval. The optimizer fuses FloatToDouble … NormalizeRows into one stage, as
the reference's does. The featurizer ends in a Cacher, so the fit is not
fused with it: the block solver splits the features into blocks, and equal
blocks take the stacked solver, whose first epoch is one ``gram_corr_sym``
launch a block (ten at d = 2·80·256 = 40,960 and block 4,096).

The images are the reference's numpy-seeded synthetic ones (``load_voc``
and the VOC archives come with the data plane). :func:`run` fits with
``pipeline.fit()`` and then applies the fitted pipeline to the test
images: the reference applies the unfitted pipeline to them, which fits it
on first use by the same route (no training images are applied).
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.loaders import MultiLabeledImage
from keystone_tpu_torch.evaluation import MeanAveragePrecisionEvaluator
from keystone_tpu_torch.ops.images.core import GrayScaler, PixelScaler
from keystone_tpu_torch.ops.images.fisher import GMMFisherVectorEstimator
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.pca import ColumnPCAEstimator
from keystone_tpu_torch.ops.stats import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util import (
    Cacher,
    ClassLabelIndicatorsFromIntArrayLabels,
    FloatToDouble,
    MatrixVectorizer,
)
from keystone_tpu_torch.utils.images import stack_images
from keystone_tpu_torch.workflow import FittedPipeline, Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.voc")

NUM_CLASSES = 20  # VOC 2007 (reference: loaders/VOCLoader.scala:16-53)


@dataclass
class VOCConfig:
    lam: float = 0.5
    descriptor_dim: int = 80  # PCA dims (VOCSIFTFisher.scala:58)
    vocab_size: int = 16  # GMM centers (reference default 64)
    sift_scale_step: int = 1
    block_size: int = 4096
    seed: int = 0
    synthetic_n: int = 24
    synthetic_image_size: int = 48
    synthetic_test_n: Optional[int] = None  # test images (default max(n // 2, 8))


@dataclass
class VOCRun:
    """What :func:`run` returns: the pipeline, its fitted form, the test
    APs and their mean, and the fit and test-apply wall seconds (each
    ending in a device synchronize)."""

    pipeline: Pipeline
    fitted: FittedPipeline
    aps: np.ndarray
    mean_ap: float
    fit_seconds: float
    apply_seconds: float


def synthetic_voc(n: int, seed: int, image_size: int = 48) -> Dataset:
    """Multi-labeled synthetic images with class-dependent textures: 1–2
    classes an image, the reference's numpy draws."""
    rng = np.random.default_rng(seed)
    pat_rng = np.random.default_rng(99)
    freqs = pat_rng.uniform(0.2, 1.5, size=(NUM_CLASSES, 2))
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size), indexing="ij")
    items = []
    for i in range(n):
        k = rng.integers(1, 3)
        classes = rng.choice(NUM_CLASSES, size=k, replace=False)
        img = np.zeros((image_size, image_size, 3))
        for c in classes:
            img += np.stack([np.sin(freqs[c, 0] * xx + freqs[c, 1] * yy)] * 3, axis=-1)
        img = 127.5 + 60.0 * img / k + rng.normal(scale=20.0, size=img.shape)
        items.append(MultiLabeledImage(np.clip(img, 0, 255), np.sort(classes), f"img{i}"))
    return Dataset.of(items)


def build_featurizer(train_images: Dataset, config: VOCConfig) -> Pipeline:
    sift = SIFTExtractor(scale_step=config.sift_scale_step)
    prefix = (
        PixelScaler()
        .to_pipeline()
        .and_then(GrayScaler())
        .and_then(Cacher())
        .and_then(sift)
    )
    return (
        prefix.and_then(ColumnPCAEstimator(config.descriptor_dim), train_images)
        .and_then(GMMFisherVectorEstimator(config.vocab_size, gmm_seed=config.seed),
                  train_images)
        .and_then(FloatToDouble())
        .and_then(MatrixVectorizer())
        .and_then(NormalizeRows())
        .and_then(SignedHellingerMapper())
        .and_then(NormalizeRows())
        .and_then(Cacher())
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: VOCConfig, device=None) -> VOCRun:
    """Build, fit and evaluate on ``device`` (default: the CUDA device,
    raising without one)."""
    device = resolve_device(device)
    start = time.perf_counter()
    train = synthetic_voc(config.synthetic_n, config.seed, config.synthetic_image_size)
    n_test = config.synthetic_test_n or max(config.synthetic_n // 2, 8)
    test = synthetic_voc(n_test, config.seed + 1, config.synthetic_image_size)
    train_images = Dataset(stack_images(train, device))
    test_images = Dataset(stack_images(test, device))
    train_label_arrays = [item.labels for item in train.to_list()]
    test_label_arrays = [item.labels for item in test.to_list()]
    labels = ClassLabelIndicatorsFromIntArrayLabels(NUM_CLASSES).batch_apply(
        Dataset.of(train_label_arrays))
    labels = Dataset(labels.array.to(device))

    # No MaxClassifier: MAP evaluation consumes raw per-class scores.
    pipeline = build_featurizer(train_images, config).and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam), train_images, labels)

    _sync(device)
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    _sync(device)
    fit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = fitted.apply(test_images)
    _sync(device)
    apply_seconds = time.perf_counter() - t0

    aps = MeanAveragePrecisionEvaluator(NUM_CLASSES).evaluate(scores, Dataset.of(test_label_arrays))
    mean_ap = float(np.mean(aps))
    logger.info("TEST APs: %s", np.round(aps, 3))
    logger.info("TEST Mean Average Precision: %.4f", mean_ap)
    logger.info("Fit %.3f s, apply %.3f s, pipeline took %.1f s",
                fit_seconds, apply_seconds, time.perf_counter() - start)
    if device.type == "cuda":
        logger.info("Peak allocated device memory %.2f GiB (since the process started or "
                    "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30)
    return VOCRun(pipeline, fitted, aps, mean_ap, fit_seconds, apply_seconds)


def main(argv=None):
    parser = argparse.ArgumentParser("VOCSIFTFisher")
    parser.add_argument("--lambda", dest="lam", type=float, default=0.5)
    parser.add_argument("--descDim", type=int, default=80)
    parser.add_argument("--vocabSize", type=int, default=16)
    parser.add_argument("--scaleStep", type=int, default=1)
    parser.add_argument("--blockSize", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--syntheticN", type=int, default=24,
                        help="training images of the synthetic data")
    parser.add_argument("--imageSize", type=int, default=48,
                        help="side of the synthetic images")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = VOCConfig(
        lam=args.lam,
        descriptor_dim=args.descDim,
        vocab_size=args.vocabSize,
        sift_scale_step=args.scaleStep,
        block_size=args.blockSize,
        seed=args.seed,
        synthetic_n=args.syntheticN,
        synthetic_image_size=args.imageSize,
    )
    result = run(config, device=args.device)
    print(f"TEST Mean Average Precision is {result.mean_ap:.4f}")


if __name__ == "__main__":
    main()
