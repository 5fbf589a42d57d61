"""Command-line entry point: ``python -m keystone_tpu_torch.run <Pipeline> [flags]``.

Port of ``keystone_tpu/run.py``. Ported so far:

  - TimitPipeline, with ``--solver auto`` (the cost-model selector, the
    default: the block chain at resident sizes, the streamed fit past the
    device's memory), ``--solver block`` (the resident block solver) and
    ``--solver streaming`` (the out-of-core tile-streamed fit);
  - RandomPatchCifarKernel (the CIFAR random-patch featurizer and Gaussian
    kernel ridge regression), with the reference's flags plus
    ``--syntheticN`` (training images of the synthetic data), e.g.
    ``python -m keystone_tpu_torch.run RandomPatchCifarKernel --syntheticN 50000``;
  - MnistRandomFFT (random-sign padded FFTs and block least squares), with
    the reference's flags plus ``--syntheticN``, e.g.
    ``python -m keystone_tpu_torch.run MnistRandomFFT --syntheticN 60000``;
  - AmazonReviewsPipeline (n-gram term frequencies and logistic regression
    by L-BFGS), with the reference's flags plus ``--syntheticN``;
  - VOCSIFTFisher (dense SIFT, column PCA, GMM Fisher vectors, block least
    squares, mean average precision) and ImageNetSiftLcsFV (SIFT and LCS
    Fisher-vector branches, block weighted least squares, top-5 error), on
    synthetic images, with the reference's model flags plus
    ``--syntheticN`` and ``--imageSize`` (and ``--syntheticClasses`` for
    ImageNet), e.g. ``python -m keystone_tpu_torch.run VOCSIFTFisher
    --vocabSize 256 --syntheticN 5011 --imageSize 64``.

Pipelines run on the CUDA device unless given ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict


def _mnist(argv):
    from keystone_tpu_torch.pipelines import mnist_random_fft

    mnist_random_fft.main(argv)


def _timit(argv):
    from keystone_tpu_torch.pipelines import timit

    timit.main(argv)


def _cifar_kernel(argv):
    from keystone_tpu_torch.pipelines import cifar

    cifar.main(argv)


def _amazon(argv):
    from keystone_tpu_torch.pipelines import amazon_reviews

    amazon_reviews.main(argv)


def _voc(argv):
    from keystone_tpu_torch.pipelines import voc_sift_fisher

    voc_sift_fisher.main(argv)


def _imagenet(argv):
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv

    imagenet_sift_lcs_fv.main(argv)


PIPELINES: Dict[str, Callable] = {
    "MnistRandomFFT": _mnist,
    "TimitPipeline": _timit,
    "Timit": _timit,
    "RandomPatchCifarKernel": _cifar_kernel,
    "AmazonReviewsPipeline": _amazon,
    "VOCSIFTFisher": _voc,
    "ImageNetSiftLcsFV": _imagenet,
}


def resolve(name: str) -> Callable:
    """Accept bare or fully-qualified (dotted) pipeline names."""
    bare = name.rsplit(".", 1)[-1]
    if bare not in PIPELINES:
        known = ", ".join(sorted(PIPELINES))
        raise SystemExit(f"Unknown pipeline {name!r}. Known pipelines: {known}")
    return PIPELINES[bare]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("Pipelines:", ", ".join(sorted(PIPELINES)))
        return 0
    resolve(argv[0])(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
