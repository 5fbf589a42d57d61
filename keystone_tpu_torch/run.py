"""Command-line entry point: ``python -m keystone_tpu_torch.run <Pipeline> [flags]``.

Port of ``keystone_tpu/run.py``: all 13 of the reference's pipeline names
(``Timit`` is an alias of ``TimitPipeline``):

  - TimitPipeline, with ``--solver auto`` (the cost-model selector, the
    default: the block chain at resident sizes, the streamed fit past the
    device's memory), ``--solver block`` (the resident block solver) and
    ``--solver streaming`` (the out-of-core tile-streamed fit);
  - the five CIFAR runners, LinearPixels, RandomCifar, RandomPatchCifar,
    RandomPatchCifarKernel (Gaussian kernel ridge regression) and
    RandomPatchCifarAugmented (random training crops, voted test crops),
    with the reference's flags plus ``--syntheticN`` (training images of
    the synthetic data), e.g.
    ``python -m keystone_tpu_torch.run RandomPatchCifar --syntheticN 50000``;
  - MnistRandomFFT (random-sign padded FFTs and block least squares), with
    the reference's flags plus ``--syntheticN``, e.g.
    ``python -m keystone_tpu_torch.run MnistRandomFFT --syntheticN 60000``;
  - AmazonReviewsPipeline (n-gram term frequencies and logistic regression
    by L-BFGS) and NewsgroupsPipeline (n-gram log term frequencies and
    multinomial naive Bayes), with the reference's flags plus
    ``--syntheticN``;
  - StupidBackoffPipeline (an n-gram language model with stupid-backoff
    scores, host work), with the reference's flags plus ``--syntheticN``;
  - VOCSIFTFisher (dense SIFT, column PCA, GMM Fisher vectors, block least
    squares, mean average precision) and ImageNetSiftLcsFV (SIFT and LCS
    Fisher-vector branches, block weighted least squares, top-5 error), on
    synthetic images, with the reference's model flags plus
    ``--syntheticN`` and ``--imageSize`` (and ``--syntheticClasses`` for
    ImageNet), e.g. ``python -m keystone_tpu_torch.run VOCSIFTFisher
    --vocabSize 256 --syntheticN 5011 --imageSize 64``.

Pipelines run on the CUDA device unless given ``--device cpu``. The
reference's serve and learn commands and its global flags are not ported
(ROADMAP A.16, A.17).
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


def _cifar(variant: str) -> Callable:
    def runner(argv):
        from keystone_tpu_torch.pipelines import cifar

        cifar.main(argv, variant=variant)

    return runner


def _amazon(argv):
    from keystone_tpu_torch.pipelines import amazon_reviews

    amazon_reviews.main(argv)


def _voc(argv):
    from keystone_tpu_torch.pipelines import voc_sift_fisher

    voc_sift_fisher.main(argv)


def _imagenet(argv):
    from keystone_tpu_torch.pipelines import imagenet_sift_lcs_fv

    imagenet_sift_lcs_fv.main(argv)


def _newsgroups(argv):
    from keystone_tpu_torch.pipelines import newsgroups

    newsgroups.main(argv)


def _stupid_backoff(argv):
    from keystone_tpu_torch.pipelines import stupid_backoff

    stupid_backoff.main(argv)


PIPELINES: Dict[str, Callable] = {
    "MnistRandomFFT": _mnist,
    "TimitPipeline": _timit,
    "Timit": _timit,
    "LinearPixels": _cifar("LinearPixels"),
    "RandomCifar": _cifar("RandomCifar"),
    "RandomPatchCifar": _cifar("RandomPatchCifar"),
    "RandomPatchCifarKernel": _cifar("RandomPatchCifarKernel"),
    "RandomPatchCifarAugmented": _cifar("RandomPatchCifarAugmented"),
    "VOCSIFTFisher": _voc,
    "ImageNetSiftLcsFV": _imagenet,
    "AmazonReviewsPipeline": _amazon,
    "NewsgroupsPipeline": _newsgroups,
    "StupidBackoffPipeline": _stupid_backoff,
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
