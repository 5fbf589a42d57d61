"""CIFAR-10 pipelines (reference: pipelines/images/cifar/).

Port of ``keystone_tpu/pipelines/cifar.py``, all five runners:

- LinearPixels: grayscale pixels → exact least squares
  (LinearPixels.scala:18-56);
- RandomCifar: random Gaussian convolution filters → rectify → pool →
  standardize → block least squares (RandomCifar.scala:20-77);
- RandomPatchCifar: ZCA-whitened random training patches as the filters,
  the same chain (RandomPatchCifar.scala:21-86);
- RandomPatchCifarKernel: the same featurization → Gaussian kernel ridge
  regression (RandomPatchCifarKernel.scala:33-76);
- RandomPatchCifarAugmented: random training crops and centre / corner
  test crops, the test crops' scores voted per image
  (RandomPatchCifarAugmented.scala:27-90).

The patch corners, crops, Gaussian filters and the filter subsample are
numpy draws from the reference's seeds, so both packages take the same
filters from the same images. The convolutional featurizer (Convolver →
SymmetricRectifier → Pooler → ImageVectorizer) fuses into one
``FusedBatchTransformer`` whose convolution is the ``conv_featurize`` CUDA
kernel (without a whitener for RandomCifar's filters, on 24 × 24 crops
for the augmented runner) and which runs in row chunks; the kernel
solver's blocks and residuals are the ``gaussian_kernel_block`` and
``gaussian_resid_block`` kernels. The block solvers take the stepwise
route at these widths (1,800 and 800 features in blocks of 512: the last
block is narrower), plain contractions, as in the reference.

Order: the block runners and LinearPixels apply the unfitted pipeline to
the training rows first, the reference's order, which fits on first use
(``fit_seconds`` covers the fit and that apply); the augmented runner
applies it to the training crops first, then votes the test crops.
:func:`run_random_patch_cifar_kernel` fits with ``pipeline.fit()`` first,
so that it can report fit and apply seconds apart (the fitted model is
the same).
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
from keystone_tpu_torch.data import Dataset, LabeledData
from keystone_tpu_torch.data.dataset import as_tensor
from keystone_tpu_torch.data.loaders import load_cifar_binary, synthetic_cifar
from keystone_tpu_torch.evaluation import (
    AugmentedExamplesEvaluator,
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)
from keystone_tpu_torch.ops.images.conv import Convolver, Pooler, SymmetricRectifier
from keystone_tpu_torch.ops.images.core import (
    CenterCornerPatcher,
    GrayScaler,
    ImageVectorizer,
    PixelScaler,
    RandomPatcher,
)
from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
from keystone_tpu_torch.ops.learning.kernel import (
    GaussianKernelGenerator,
    KernelRidgeRegression,
)
from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
from keystone_tpu_torch.ops.learning.pca import ZCAWhitener, ZCAWhitenerEstimator
from keystone_tpu_torch.ops.stats import StandardScaler
from keystone_tpu_torch.ops.util import Cacher, ClassLabelIndicatorsFromIntLabels, MaxClassifier
from keystone_tpu_torch.workflow import FittedPipeline, Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.cifar")

NUM_CLASSES = 10


@dataclass
class CifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitener_size: int = 1000  # patches sampled for the ZCA fit
    patch_size: int = 6
    pool_size: int = 10
    pool_stride: int = 9
    alpha: float = 0.25
    lam: float = 10.0
    # Kernel variant (RandomPatchCifarKernel.scala:33-76)
    kernel_gamma: float = 5e-4
    block_size: int = 512
    num_epochs: int = 1
    # Preemption-safe KRR fits: segment the sweep and persist (position,
    # stack) here; a rerun with the same config and data resumes.
    checkpoint_path: str = ""
    checkpoint_every_blocks: int = 25
    # Augmented variant (RandomPatchCifarAugmented.scala:27-90).
    # horizontal_flips=None decides by the data: flips on real data (the
    # reference's behaviour) and off for the synthetic images, whose
    # phase-sensitive sinusoid classes are not flip-invariant as photos are.
    augment_patch_size: int = 24
    augment_patches: int = 8
    horizontal_flips: Optional[bool] = None
    seed: int = 0
    synthetic_n: int = 512


@dataclass
class CifarRun:
    """What each runner returns: the pipeline, its fitted form, the train
    and test metrics, and the fit and apply wall seconds (each ending in a
    device synchronize; see the module's note on the order). The augmented
    runner's ``train_eval`` scores each training crop, its ``test_eval`` the
    vote over each test image's crops."""

    pipeline: Pipeline
    fitted: FittedPipeline
    train_eval: MulticlassMetrics
    test_eval: MulticlassMetrics
    fit_seconds: float
    apply_seconds: float


def _load(config: CifarConfig, device):
    """Returns (train, test, is_synthetic): the CIFAR-10 binaries when
    given, else ``synthetic_cifar`` (test rows n // 4, at least 128)."""
    if config.train_location:
        train = load_cifar_binary(config.train_location, device=device)
        test = load_cifar_binary(config.test_location, device=device)
        return train, test, False
    train = synthetic_cifar(config.synthetic_n, seed=config.seed, device=device)
    test = synthetic_cifar(max(config.synthetic_n // 4, 128), seed=config.seed + 1,
                           device=device)
    return train, test, True


def _sample_whitened_filters(train: LabeledData, config: CifarConfig):
    """Random training patches, row-normalized, ZCA-whitened, subsampled to a
    conv filter bank (RandomPatchCifar.scala:36-58). The normalisation runs
    in numpy on the host, as in the reference; the whitener is fitted on
    the images' device. Returns (filters (k, p, p, 3), whitener)."""
    n = train.data.n
    per_image = max(1, config.whitener_size // n + 1)
    patcher = RandomPatcher(per_image, config.patch_size, config.patch_size,
                            seed=config.seed + 7)
    patches = patcher.batch_apply(train.data).array
    device = patches.device
    patches = patches.reshape(patches.shape[0], -1)[: config.whitener_size].cpu().numpy()
    # Row normalization with the reference's variance floor (Stats.normalizeRows)
    norms = np.sqrt(np.maximum(np.var(patches, axis=1) * patches.shape[1], 10.0))
    patches = (patches - patches.mean(axis=1, keepdims=True)) / norms[:, None]
    patches = torch.from_numpy(patches).to(device)
    whitener = ZCAWhitenerEstimator(eps=0.1).fit_single(patches)
    rng = np.random.default_rng(config.seed + 13)
    idx = rng.choice(patches.shape[0], size=config.num_filters, replace=False)
    sampled = whitener.apply(patches[torch.from_numpy(idx).to(device)])
    # Renormalize whitened filters (RandomPatchCifar.scala:52-57).
    sampled = sampled / (torch.linalg.norm(sampled, dim=1, keepdim=True) + 1e-12)
    filters = sampled.reshape(config.num_filters, config.patch_size, config.patch_size, 3)
    return filters, whitener


def _conv_featurizer(filters, whitener: Optional[ZCAWhitener], config: CifarConfig,
                     img_size: int = 32) -> Pipeline:
    """Convolver → SymmetricRectifier → Pooler(sum) → vectorize → cache, on
    ``img_size`` × ``img_size`` images (crops for the augmented runner)."""
    conv = Convolver(
        filters.reshape(len(filters), -1),
        img_x=img_size,
        img_y=img_size,
        img_channels=3,
        whitener=whitener,
        normalize_patches=True,
    )
    return (
        conv.to_pipeline()
        .and_then(SymmetricRectifier(alpha=config.alpha))
        .and_then(Pooler(config.pool_stride, config.pool_size, pool_function="sum"))
        .and_then(ImageVectorizer())
        .and_then(Cacher())
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_pipeline(config: CifarConfig, device=None):
    """Load the data, sample the whitened filters and compose the unfitted
    pipeline: featurizer → StandardScaler → KernelRidgeRegression →
    MaxClassifier (RandomPatchCifarKernel.scala:33-76). Returns
    (pipeline, train, test)."""
    device = resolve_device(device)
    train, test, _ = _load(config, device)
    filters, whitener = _sample_whitened_filters(train, config)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    featurizer = _conv_featurizer(filters, whitener, config).and_then(
        StandardScaler(), train.data
    )
    pipeline = featurizer.and_then(
        KernelRidgeRegression(
            GaussianKernelGenerator(config.kernel_gamma),
            config.lam,
            config.block_size,
            config.num_epochs,
            checkpoint_path=config.checkpoint_path or None,
            checkpoint_every_blocks=config.checkpoint_every_blocks,
        ),
        train.data,
        labels,
    ).and_then(MaxClassifier())
    return pipeline, train, test


def run_random_patch_cifar_kernel(config: CifarConfig, device=None) -> CifarRun:
    """Same featurization as RandomPatchCifar, Gaussian-kernel ridge
    regression solver (RandomPatchCifarKernel.scala:33-76). ``device``
    defaults to the CUDA device (raising without one). Fits with
    ``pipeline.fit()``, then applies the fitted pipeline to the train and
    test rows."""
    device = resolve_device(device)
    start = time.perf_counter()
    pipeline, train, test = build_pipeline(config, device)
    _sync(device)
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    _sync(device)
    fit_seconds = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_pred = fitted.apply(train.data)
    test_pred = fitted.apply(test.data)
    _sync(device)
    apply_seconds = time.perf_counter() - t0

    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    _log_run("RandomPatchCifarKernel", train_eval, test_eval, fit_seconds, apply_seconds,
             start, device)
    return CifarRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds)


def _timed_applies(pipeline: Pipeline, train: Dataset, test: Dataset, device: torch.device):
    """Apply the unfitted pipeline to the training rows (which fits it),
    then to the test rows, the reference's order. Returns (train output,
    test output, fitted pipeline, fit seconds, apply seconds)."""
    _sync(device)
    t0 = time.perf_counter()
    train_out = pipeline.apply(train).get()
    _sync(device)
    fit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_out = pipeline.apply(test).get()
    _sync(device)
    apply_seconds = time.perf_counter() - t0
    # The applies published the fit to the state table: this loads it.
    return train_out, test_out, pipeline.fit(), fit_seconds, apply_seconds


def _apply_first(name: str, pipeline: Pipeline, train: LabeledData, test: LabeledData,
                 device: torch.device, start: float) -> CifarRun:
    """:func:`_timed_applies`, then evaluate both predictions."""
    train_pred, test_pred, fitted, fit_seconds, apply_seconds = _timed_applies(
        pipeline, train.data, test.data, device)
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    _log_run(name, train_eval, test_eval, fit_seconds, apply_seconds, start, device)
    return CifarRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds)


def _log_run(name, train_eval, test_eval, fit_seconds, apply_seconds, start, device):
    logger.info(
        "%s train %.2f%% test %.2f%%; fit %.3f s, apply %.3f s, pipeline took %.1f s",
        name, 100 * train_eval.total_error, 100 * test_eval.total_error,
        fit_seconds, apply_seconds, time.perf_counter() - start,
    )
    if device.type == "cuda":
        logger.info(
            "Peak allocated device memory %.2f GiB (since the process started or "
            "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30,
        )


def run_linear_pixels(config: CifarConfig, device=None) -> CifarRun:
    """PixelScaler → GrayScaler → vectorize → exact least squares → argmax
    (LinearPixels.scala:18-56)."""
    device = resolve_device(device)
    start = time.perf_counter()
    train, test, _ = _load(config, device)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    pipeline = (
        PixelScaler()
        .to_pipeline()
        .and_then(GrayScaler())
        .and_then(ImageVectorizer())
        .and_then(LinearMapEstimator(lam=None), train.data, labels)
        .and_then(MaxClassifier())
    )
    return _apply_first("LinearPixels", pipeline, train, test, device, start)


def random_filters(config: CifarConfig) -> np.ndarray:
    """RandomCifar's filter bank: standard normal draws from
    ``default_rng(seed)``, each filter scaled to unit norm in float64
    (RandomCifar.scala:35-41), (k, p, p, 3)."""
    rng = np.random.default_rng(config.seed)
    filters = rng.normal(size=(config.num_filters, config.patch_size, config.patch_size, 3))
    filters /= np.linalg.norm(filters.reshape(config.num_filters, -1), axis=1)[
        :, None, None, None
    ]
    return filters


def _block_pipeline(featurizer: Pipeline, train: LabeledData, config: CifarConfig) -> Pipeline:
    """featurizer → StandardScaler → BlockLeastSquares → MaxClassifier."""
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    return (
        featurizer.and_then(StandardScaler(), train.data)
        .and_then(BlockLeastSquaresEstimator(config.block_size, 1, config.lam),
                  train.data, labels)
        .and_then(MaxClassifier())
    )


def run_random_cifar(config: CifarConfig, device=None) -> CifarRun:
    """Random (unwhitened) Gaussian filters (RandomCifar.scala:20-77); the
    convolution runs without whitening means."""
    device = resolve_device(device)
    start = time.perf_counter()
    train, test, _ = _load(config, device)
    filters = torch.from_numpy(random_filters(config)).to(device, torch.float32)
    pipeline = _block_pipeline(_conv_featurizer(filters, None, config), train, config)
    return _apply_first("RandomCifar", pipeline, train, test, device, start)


def run_random_patch_cifar(config: CifarConfig, device=None) -> CifarRun:
    """Whitened random-patch filters + block least squares
    (RandomPatchCifar.scala:21-86)."""
    device = resolve_device(device)
    start = time.perf_counter()
    train, test, _ = _load(config, device)
    filters, whitener = _sample_whitened_filters(train, config)
    pipeline = _block_pipeline(_conv_featurizer(filters, whitener, config), train, config)
    return _apply_first("RandomPatchCifar", pipeline, train, test, device, start)


def augment(config: CifarConfig, train: LabeledData, test: LabeledData,
            is_synthetic: bool):
    """The augmented runner's crops: ``augment_patches`` random crops of
    every training image (``RandomPatcher(seed)``), the centre and corner
    crops of every test image (and their mirror images when flips are on).
    Returns (train crops with their labels, test crops with their labels,
    the test crops' image ids, crops a test image)."""
    aug = config.augment_patch_size
    flips = config.horizontal_flips
    if flips is None:
        flips = not is_synthetic  # see CifarConfig
    train_patcher = RandomPatcher(config.augment_patches, aug, aug, seed=config.seed)
    test_patcher = CenterCornerPatcher(aug, aug, horizontal_flips=flips)
    per_image = test_patcher.patches_per_image
    train_labels = torch.repeat_interleave(
        as_tensor(train.labels.array)[: train.labels.n], config.augment_patches)
    test_labels = torch.repeat_interleave(as_tensor(test.labels.array)[: test.labels.n],
                                          per_image)
    train_crops = LabeledData(train_patcher.batch_apply(train.data), train_labels)
    test_crops = LabeledData(test_patcher.batch_apply(test.data), test_labels)
    test_names = list(np.repeat(np.arange(test.labels.n), per_image))
    return train_crops, test_crops, test_names, per_image


def run_random_patch_cifar_augmented(config: CifarConfig, device=None) -> CifarRun:
    """Random training crops; centre / corner test crops (plus horizontal
    flips per ``config.horizontal_flips``), their scores averaged per image
    (RandomPatchCifarAugmented.scala:27-90). The whitened filters are
    sampled from the training crops where they lie, on the device."""
    device = resolve_device(device)
    start = time.perf_counter()
    train, test, is_synthetic = _load(config, device)
    train_crops, test_crops, test_names, _ = augment(config, train, test, is_synthetic)
    filters, whitener = _sample_whitened_filters(train_crops, config)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train_crops.labels)
    featurizer = _conv_featurizer(filters, whitener, config,
                                  img_size=config.augment_patch_size)
    # Raw scores (no MaxClassifier), so that the evaluator can vote.
    pipeline = featurizer.and_then(StandardScaler(), train_crops.data).and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam),
        train_crops.data, labels)
    train_scores, test_scores, fitted, fit_seconds, apply_seconds = _timed_applies(
        pipeline, train_crops.data, test_crops.data, device)
    train_pred = Dataset(torch.argmax(as_tensor(train_scores.array), dim=1), n=train_scores.n)
    train_eval = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(
        train_pred, train_crops.labels)
    test_eval = AugmentedExamplesEvaluator(test_names, NUM_CLASSES).evaluate(
        test_scores, test_crops.labels)
    _log_run("RandomPatchCifarAugmented", train_eval, test_eval, fit_seconds, apply_seconds,
             start, device)
    return CifarRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds)


RUNNERS = {
    "LinearPixels": run_linear_pixels,
    "RandomCifar": run_random_cifar,
    "RandomPatchCifar": run_random_patch_cifar,
    "RandomPatchCifarKernel": run_random_patch_cifar_kernel,
    "RandomPatchCifarAugmented": run_random_patch_cifar_augmented,
}


def main(argv=None, variant: str = "RandomPatchCifar"):
    """The CIFAR CLIs, one a runner of :data:`RUNNERS`: the reference's
    flags plus ``--syntheticN`` and ``--device``."""
    parser = argparse.ArgumentParser(f"Cifar:{variant}")
    parser.add_argument("--trainLocation", default="")
    parser.add_argument("--testLocation", default="")
    parser.add_argument("--numFilters", type=int, default=100)
    parser.add_argument("--whitenerSize", type=int, default=1000)
    parser.add_argument("--patchSize", type=int, default=6)
    parser.add_argument("--poolSize", type=int, default=10)
    parser.add_argument("--poolStride", type=int, default=9)
    parser.add_argument("--alpha", type=float, default=0.25)
    parser.add_argument("--lambda", dest="lam", type=float, default=10.0)
    parser.add_argument("--gamma", type=float, default=5e-4)
    parser.add_argument("--blockSize", type=int, default=512)
    parser.add_argument("--numEpochs", type=int, default=1)
    parser.add_argument("--checkpointPath", default="",
                        help="kernel variant: mid-solver checkpoint/resume file")
    parser.add_argument("--checkpointEveryBlocks", type=int, default=25,
                        help="kernel variant: block updates between checkpoint saves")
    parser.add_argument("--horizontalFlips", choices=["auto", "on", "off"], default="auto",
                        help="augmented variant's test-crop flips (auto: on for real data)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--syntheticN", type=int, default=512,
                        help="training images of the synthetic data (no binaries given)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = CifarConfig(
        train_location=args.trainLocation,
        test_location=args.testLocation,
        num_filters=args.numFilters,
        whitener_size=args.whitenerSize,
        patch_size=args.patchSize,
        pool_size=args.poolSize,
        pool_stride=args.poolStride,
        alpha=args.alpha,
        lam=args.lam,
        kernel_gamma=args.gamma,
        block_size=args.blockSize,
        num_epochs=args.numEpochs,
        checkpoint_path=args.checkpointPath,
        checkpoint_every_blocks=args.checkpointEveryBlocks,
        horizontal_flips={"auto": None, "on": True, "off": False}[args.horizontalFlips],
        seed=args.seed,
        synthetic_n=args.syntheticN,
    )
    result = RUNNERS[variant](config, device=args.device)
    print(f"TRAIN Error is {100 * result.train_eval.total_error:.2f}%")
    print(f"TEST Error is {100 * result.test_eval.total_error:.2f}%")


if __name__ == "__main__":
    main()
