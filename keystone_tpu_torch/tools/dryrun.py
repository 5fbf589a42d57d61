"""Static-verifier dry runs over every bundled pipeline.

Port of ``keystone_tpu/tools/dryrun.py``. Builds each of the bundled
example pipelines (TIMIT, Amazon reviews, MNIST random-FFT, CIFAR-KRR,
newsgroups) at the reference's tiny synthetic dry-run geometry — graph
construction only, NOTHING is fitted and no kernel is launched (CIFAR's
whitener is fitted on its few sample patches, as in the reference) — and
runs the plan verifier (:mod:`keystone_tpu_torch.workflow.verify`) in
strict mode over each fit graph. This is the zero-false-positive contract:
a verifier change that starts flagging a known-good pipeline fails here
before it can reject real plans.

Runnable two ways:

  - ``python -m keystone_tpu_torch.tools.dryrun [--device cpu]`` prints one
    line per pipeline and exits non-zero on any finding (the device
    defaults to the card, as every entry point's does);
  - ``tests/test_torch_verify.py`` imports :func:`dryrun` and asserts
    every report is empty.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Tuple

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.workflow import Pipeline
from keystone_tpu_torch.workflow.verify import VerifyReport, verify_graph


def _mnist(device) -> Pipeline:
    from keystone_tpu_torch.data.loaders import synthetic_mnist
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        NUM_CLASSES,
        MnistRandomFFTConfig,
        build_featurizer,
    )

    config = MnistRandomFFTConfig(synthetic_n=128, num_ffts=2, block_size=512)
    train = synthetic_mnist(config.synthetic_n, seed=0, device=device)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    return (
        build_featurizer(config, device=device)
        .and_then(BlockLeastSquaresEstimator(config.block_size, 1, 0.0), train.data, labels)
        .and_then(MaxClassifier())
    )


def _timit(device) -> Pipeline:
    from keystone_tpu_torch.data.loaders import synthetic_timit
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.pipelines.timit import NUM_CLASSES, TimitConfig, build_featurizer

    config = TimitConfig(synthetic_n=128, num_cosines=2, block_size=256, num_epochs=1)
    train = synthetic_timit(config.synthetic_n, seed=0, device=device)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    return (
        build_featurizer(config, device=device)
        .and_then(BlockLeastSquaresEstimator(config.block_size, 1, 0.0), train.data, labels)
        .and_then(MaxClassifier())
    )


def _amazon(device) -> Pipeline:
    from keystone_tpu_torch.data.loaders import synthetic_documents
    from keystone_tpu_torch.ops.learning.classifiers import LogisticRegressionEstimator
    from keystone_tpu_torch.ops.sparse import CommonSparseFeatures
    from keystone_tpu_torch.pipelines.amazon_reviews import (
        AmazonReviewsConfig,
        build_featurizer,
    )

    config = AmazonReviewsConfig(synthetic_n=48)
    train = synthetic_documents(config.synthetic_n, 2, seed=0, device=device)
    return build_featurizer(config).and_then(
        CommonSparseFeatures(64), train.data
    ).and_then(
        LogisticRegressionEstimator(2, num_iters=2), train.data, train.labels
    )


def _newsgroups(device) -> Pipeline:
    from keystone_tpu_torch.data.loaders import synthetic_documents
    from keystone_tpu_torch.ops.learning.classifiers import NaiveBayesEstimator
    from keystone_tpu_torch.ops.sparse import AllSparseFeatures
    from keystone_tpu_torch.ops.util import MaxClassifier
    from keystone_tpu_torch.pipelines.newsgroups import NewsgroupsConfig, build_featurizer

    config = NewsgroupsConfig(synthetic_n=48, synthetic_classes=4)
    train = synthetic_documents(config.synthetic_n, 4, seed=0, device=device)
    return (
        build_featurizer(config)
        .and_then(AllSparseFeatures(), train.data)
        .and_then(NaiveBayesEstimator(4), train.data, train.labels)
        .and_then(MaxClassifier())
    )


def _cifar_krr(device) -> Pipeline:
    from keystone_tpu_torch.data import LabeledData
    from keystone_tpu_torch.data.loaders import synthetic_cifar
    from keystone_tpu_torch.ops.learning.kernel import (
        GaussianKernelGenerator,
        KernelRidgeRegression,
    )
    from keystone_tpu_torch.ops.stats import StandardScaler
    from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
    from keystone_tpu_torch.pipelines.cifar import (
        NUM_CLASSES,
        CifarConfig,
        _conv_featurizer,
        _sample_whitened_filters,
    )

    config = CifarConfig(synthetic_n=32, num_filters=8, whitener_size=64)
    train = synthetic_cifar(config.synthetic_n, seed=0, device=device)
    labeled = LabeledData(train.data, train.labels)
    filters, whitener = _sample_whitened_filters(labeled, config)
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    featurizer = _conv_featurizer(filters, whitener, config).and_then(
        StandardScaler(), train.data
    )
    return featurizer.and_then(
        KernelRidgeRegression(
            GaussianKernelGenerator(config.kernel_gamma), config.lam, config.block_size, 1
        ),
        train.data,
        labels,
    ).and_then(MaxClassifier())


BUILDERS: Dict[str, Callable[..., Pipeline]] = {
    "timit": _timit,
    "amazon": _amazon,
    "mnist_random_fft": _mnist,
    "cifar_krr": _cifar_krr,
    "newsgroups": _newsgroups,
}


def build_pipelines(device=None) -> List[Tuple[str, Pipeline]]:
    """Construct every bundled pipeline at dry-run geometry on ``device``
    (default: the card)."""
    device = resolve_device(device)
    return [(name, build(device)) for name, build in BUILDERS.items()]


def dryrun(strict: bool = True, device=None) -> Dict[str, VerifyReport]:
    """Verify every bundled pipeline's fit graph. Returns name→report."""
    return {
        name: verify_graph(pipe.executor.graph, strict=strict)
        for name, pipe in build_pipelines(device)
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m keystone_tpu_torch.tools.dryrun")
    parser.add_argument("--device", default=None,
                        help="where the pipelines' weights and data lie (default: the card)")
    args = parser.parse_args(argv)
    reports = dryrun(strict=True, device=args.device)
    failed = False
    for name, report in sorted(reports.items()):
        if report.findings:
            failed = True
            print(f"{name}: {len(report.findings)} finding(s)")
            for f in report.findings:
                print(f"  {f}")
        else:
            print(f"{name}: ok ({len(report.sigs)} signatures propagated)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
