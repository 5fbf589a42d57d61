"""ImageNetSiftLcsFV: two featurization branches (dense SIFT + LCS), each
PCA → GMM Fisher vector → normalize; gathered, combined, and solved with
block weighted least squares; top-5 evaluation
(reference: pipelines/images/imagenet/ImageNetSiftLcsFV.scala:33-135).

Port of ``keystone_tpu/pipelines/imagenet_sift_lcs_fv.py``. The gather does
not fuse (its branches end on different Fisher-vector nodes, as in the
reference's plan); each branch's FloatToDouble … NormalizeRows chain fuses
into one stage. The solver is the reference's XLA one: no hand-written
kernel is on this route. The images are the reference's numpy-seeded
synthetic ones (``load_imagenet`` comes with the data plane). :func:`run`
fits with ``pipeline.fit()`` and then applies the fitted pipeline to the
test images, the route the reference's first apply takes.
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
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator, MulticlassMetrics
from keystone_tpu_torch.ops.images.core import GrayScaler, LabeledImage, PixelScaler
from keystone_tpu_torch.ops.images.fisher import GMMFisherVectorEstimator
from keystone_tpu_torch.ops.images.lcs import LCSExtractor
from keystone_tpu_torch.ops.images.sift import SIFTExtractor
from keystone_tpu_torch.ops.learning.bwls import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.pca import ColumnPCAEstimator
from keystone_tpu_torch.ops.stats import NormalizeRows, SignedHellingerMapper
from keystone_tpu_torch.ops.util import (
    Cacher,
    ClassLabelIndicatorsFromIntLabels,
    FloatToDouble,
    MatrixVectorizer,
    TopKClassifier,
    VectorCombiner,
)
from keystone_tpu_torch.utils.images import stack_images
from keystone_tpu_torch.workflow import FittedPipeline, Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.imagenet")


@dataclass
class ImageNetConfig:
    num_classes: int = 1000
    lam: float = 6e-5
    mixture_weight: float = 0.25
    sift_pca_dim: int = 64  # ImageNetSiftLcsFV.scala:41
    lcs_pca_dim: int = 64
    lcs_stride: int = 4
    lcs_border: int = 16
    lcs_patch: int = 6
    vocab_size: int = 16
    block_size: int = 4096
    num_iters: int = 1
    seed: int = 0
    synthetic_n: int = 24
    synthetic_classes: int = 5
    synthetic_image_size: int = 48
    synthetic_test_n: Optional[int] = None  # test images (default max(n // 2, 8))


@dataclass
class ImageNetRun:
    """What :func:`run` returns: the pipeline, its fitted form, the test
    top-1 metrics and top-5 error, and the fit and test-apply wall seconds
    (each ending in a device synchronize)."""

    pipeline: Pipeline
    fitted: FittedPipeline
    top1_eval: MulticlassMetrics
    top5_error: float
    top5: np.ndarray
    fit_seconds: float
    apply_seconds: float


def synthetic_imagenet(n: int, num_classes: int, seed: int, image_size: int = 48) -> Dataset:
    """One-class synthetic images with class-dependent textures, the
    reference's numpy draws."""
    rng = np.random.default_rng(seed)
    pat_rng = np.random.default_rng(7)
    freqs = pat_rng.uniform(0.2, 1.5, size=(num_classes, 2))
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size), indexing="ij")
    items = []
    for i in range(n):
        c = int(rng.integers(0, num_classes))
        img = np.stack([np.sin(freqs[c, 0] * xx + freqs[c, 1] * yy)] * 3, axis=-1)
        img = 127.5 + 70.0 * img + rng.normal(scale=20.0, size=img.shape)
        items.append(LabeledImage(np.clip(img, 0, 255), c, f"img{i}"))
    return Dataset.of(items)


def _fv_suffix() -> list:
    """FloatToDouble → MatrixVectorizer → NormalizeRows → SignedHellinger →
    NormalizeRows (ImageNetSiftLcsFV.scala:60-72)."""
    return [FloatToDouble(), MatrixVectorizer(), NormalizeRows(), SignedHellingerMapper(),
            NormalizeRows()]


def build_featurizer(train_images: Dataset, config: ImageNetConfig) -> Pipeline:
    sift_branch = (
        PixelScaler()
        .to_pipeline()
        .and_then(GrayScaler())
        .and_then(SIFTExtractor(scale_step=1))
        .and_then(ColumnPCAEstimator(config.sift_pca_dim), train_images)
        .and_then(GMMFisherVectorEstimator(config.vocab_size, gmm_seed=config.seed),
                  train_images)
    )
    lcs_branch = (
        PixelScaler()
        .to_pipeline()
        .and_then(LCSExtractor(config.lcs_stride, config.lcs_border, config.lcs_patch))
        .and_then(ColumnPCAEstimator(config.lcs_pca_dim), train_images)
        .and_then(GMMFisherVectorEstimator(config.vocab_size, gmm_seed=config.seed + 1),
                  train_images)
    )
    for node in _fv_suffix():
        sift_branch = sift_branch.and_then(node)
        lcs_branch = lcs_branch.and_then(node)
    return Pipeline.gather([sift_branch, lcs_branch]).and_then(VectorCombiner()).and_then(
        Cacher())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: ImageNetConfig, device=None) -> ImageNetRun:
    """Build, fit and evaluate on ``device`` (default: the CUDA device,
    raising without one)."""
    device = resolve_device(device)
    start = time.perf_counter()
    num_classes = config.synthetic_classes
    train = synthetic_imagenet(config.synthetic_n, num_classes, config.seed,
                               config.synthetic_image_size)
    n_test = config.synthetic_test_n or max(config.synthetic_n // 2, 8)
    test = synthetic_imagenet(n_test, num_classes, config.seed + 1, config.synthetic_image_size)

    train_images = Dataset(stack_images(train, device))
    test_images = Dataset(stack_images(test, device))
    train_labels = torch.tensor([item.label for item in train.to_list()], device=device)
    actual = np.asarray([item.label for item in test.to_list()], dtype=np.int64)
    labels = ClassLabelIndicatorsFromIntLabels(num_classes).batch_apply(Dataset(train_labels))

    top_k = min(5, num_classes)
    pipeline = build_featurizer(train_images, config).and_then(
        BlockWeightedLeastSquaresEstimator(config.block_size, config.num_iters, config.lam,
                                           config.mixture_weight),
        train_images, labels,
    ).and_then(TopKClassifier(top_k))

    _sync(device)
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    _sync(device)
    fit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    top5 = fitted.apply(test_images).to_numpy()
    apply_seconds = time.perf_counter() - t0

    top5_err = 1.0 - float(np.mean([actual[i] in top5[i] for i in range(len(actual))]))
    top1_eval = MulticlassClassifierEvaluator(num_classes).evaluate(
        Dataset(torch.from_numpy(np.ascontiguousarray(top5[:, 0]))),
        Dataset(torch.from_numpy(actual)))
    logger.info("TEST top-1 error %.2f%%", 100 * top1_eval.total_error)
    logger.info("TEST top-5 error %.2f%%", 100 * top5_err)
    logger.info("Fit %.3f s, apply %.3f s, pipeline took %.1f s",
                fit_seconds, apply_seconds, time.perf_counter() - start)
    if device.type == "cuda":
        logger.info("Peak allocated device memory %.2f GiB (since the process started or "
                    "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30)
    return ImageNetRun(pipeline, fitted, top1_eval, top5_err, top5, fit_seconds, apply_seconds)


def main(argv=None):
    parser = argparse.ArgumentParser("ImageNetSiftLcsFV")
    parser.add_argument("--lambda", dest="lam", type=float, default=6e-5)
    parser.add_argument("--mixtureWeight", type=float, default=0.25)
    parser.add_argument("--vocabSize", type=int, default=16)
    parser.add_argument("--blockSize", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--syntheticN", type=int, default=24,
                        help="training images of the synthetic data")
    parser.add_argument("--syntheticClasses", type=int, default=5,
                        help="classes of the synthetic data")
    parser.add_argument("--imageSize", type=int, default=48,
                        help="side of the synthetic images")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = ImageNetConfig(
        lam=args.lam,
        mixture_weight=args.mixtureWeight,
        vocab_size=args.vocabSize,
        block_size=args.blockSize,
        seed=args.seed,
        synthetic_n=args.syntheticN,
        synthetic_classes=args.syntheticClasses,
        synthetic_image_size=args.imageSize,
    )
    result = run(config, device=args.device)
    print(f"TEST top-5 error is {100 * result.top5_error:.2f}%")


if __name__ == "__main__":
    main()
