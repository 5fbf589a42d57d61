"""RandomPatchCifarKernel: ZCA-whitened random training patches as
convolution filters → symmetric rectifier → sum pool → standardize →
Gaussian kernel ridge regression on CIFAR-10
(reference: pipelines/images/cifar/RandomPatchCifarKernel.scala:33-76).

Port of ``keystone_tpu/pipelines/cifar.py``'s ``run_random_patch_cifar_kernel``
with its config, data source, filter sampling and featurizer. The patch
corners and the filter subsample are numpy draws from the reference's
seeds, so both packages take the same filters from the same images. The
featurizer (Convolver → SymmetricRectifier → Pooler → ImageVectorizer)
fuses into one ``FusedBatchTransformer`` whose convolution is the
``conv_featurize`` CUDA kernel and which runs in row chunks; the solver's
kernel blocks and residuals are the ``gaussian_kernel_block`` and
``gaussian_resid_block`` kernels.

Differences from the reference: :func:`run_random_patch_cifar_kernel` fits
the pipeline with ``pipeline.fit()`` before applying it, so that it can
report fit and apply seconds apart (the reference applies first, which
fits on first use; the fitted model is the same). Not ported yet:
LinearPixels, RandomCifar, RandomPatchCifar and RandomPatchCifarAugmented
(ROADMAP A.10).
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data import LabeledData
from keystone_tpu_torch.data.loaders import load_cifar_binary, synthetic_cifar
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator, MulticlassMetrics
from keystone_tpu_torch.ops.images.conv import Convolver, Pooler, SymmetricRectifier
from keystone_tpu_torch.ops.images.core import ImageVectorizer, RandomPatcher
from keystone_tpu_torch.ops.learning.kernel import (
    GaussianKernelGenerator,
    KernelRidgeRegression,
)
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
    seed: int = 0
    synthetic_n: int = 512


@dataclass
class CifarRun:
    """What :func:`run_random_patch_cifar_kernel` returns: the pipeline, its
    fitted form, the train and test metrics, and the fit and apply wall
    seconds (each ending in a device synchronize)."""

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


def _conv_featurizer(filters, whitener: ZCAWhitener, config: CifarConfig) -> Pipeline:
    """Convolver → SymmetricRectifier → Pooler(sum) → vectorize → cache."""
    conv = Convolver(
        filters.reshape(len(filters), -1),
        img_x=32,
        img_y=32,
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
    logger.info(
        "RandomPatchCifarKernel train %.2f%% test %.2f%%; fit %.3f s, apply %.3f s, "
        "pipeline took %.1f s",
        100 * train_eval.total_error, 100 * test_eval.total_error,
        fit_seconds, apply_seconds, time.perf_counter() - start,
    )
    if device.type == "cuda":
        logger.info(
            "Peak allocated device memory %.2f GiB (since the process started or "
            "its last reset)", torch.cuda.max_memory_allocated(device) / 2**30,
        )
    return CifarRun(pipeline, fitted, train_eval, test_eval, fit_seconds, apply_seconds)


def main(argv=None):
    """The RandomPatchCifarKernel CLI: the reference's flags plus
    ``--syntheticN`` and ``--device``."""
    parser = argparse.ArgumentParser("Cifar:RandomPatchCifarKernel")
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
                        help="mid-solver checkpoint/resume file")
    parser.add_argument("--checkpointEveryBlocks", type=int, default=25,
                        help="block updates between checkpoint saves")
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
        seed=args.seed,
        synthetic_n=args.syntheticN,
    )
    result = run_random_patch_cifar_kernel(config, device=args.device)
    print(f"TRAIN Error is {100 * result.train_eval.total_error:.2f}%")
    print(f"TEST Error is {100 * result.test_eval.total_error:.2f}%")


if __name__ == "__main__":
    main()
