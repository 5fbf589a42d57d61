"""AmazonReviewsPipeline: n-gram term-frequency features + logistic
regression for binary sentiment
(reference: pipelines/text/AmazonReviewsPipeline.scala:27-79).

Port of ``keystone_tpu/pipelines/amazon_reviews.py``. Composition: Trim →
LowerCase → Tokenizer → NGramsFeaturizer(1..n) → TermFrequency(binary) →
CommonSparseFeatures(topK) → LogisticRegression. The text nodes, the term
counts and the feature selection run on the host, as in the reference; the
logistic regression densifies the selected features to (n, topK) on the
device and runs its L-BFGS there. No hand-written kernel is on this path:
the reference's is XLA's too.

:func:`run` keeps the reference's order: it applies the unfitted pipeline
to the training documents, which fits it on first use.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.loaders import load_amazon_reviews, synthetic_documents
from keystone_tpu_torch.evaluation import BinaryClassificationMetrics, BinaryClassifierEvaluator
from keystone_tpu_torch.ops.learning.classifiers import LogisticRegressionEstimator
from keystone_tpu_torch.ops.nlp import LowerCase, NGramsFeaturizer, Tokenizer, Trim
from keystone_tpu_torch.ops.sparse import CommonSparseFeatures
from keystone_tpu_torch.ops.stats import TermFrequency
from keystone_tpu_torch.workflow import Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.amazon")


@dataclass
class AmazonReviewsConfig:
    train_location: str = ""
    test_location: str = ""
    threshold: float = 3.5
    n_grams: int = 2
    common_features: int = 1000
    num_iters: int = 20
    seed: int = 0
    synthetic_n: int = 256


@dataclass
class AmazonRun:
    """What :func:`run` returns: the pipeline, the train and test metrics,
    the estimator (its ``last_fit`` holds the L-BFGS run: iterations, the
    loss after each step, the final loss), and the wall seconds of the
    training rows' apply (which fits the pipeline) and of the test rows'."""

    pipeline: Pipeline
    train_eval: BinaryClassificationMetrics
    test_eval: BinaryClassificationMetrics
    estimator: LogisticRegressionEstimator
    fit_seconds: float
    apply_seconds: float


def build_featurizer(config: AmazonReviewsConfig) -> Pipeline:
    return (
        Trim()
        .to_pipeline()
        .and_then(LowerCase())
        .and_then(Tokenizer())
        .and_then(NGramsFeaturizer(range(1, config.n_grams + 1)))
        .and_then(TermFrequency(weighting=lambda x: 1))
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: AmazonReviewsConfig, device=None) -> AmazonRun:
    """Build, train and evaluate; the logistic regression runs on
    ``device`` (default: the CUDA device, raising without one)."""
    device = resolve_device(device)
    start = time.perf_counter()
    if config.train_location:
        train = load_amazon_reviews(config.train_location, config.threshold, device=device)
        test = load_amazon_reviews(config.test_location, config.threshold, device=device)
    else:
        train = synthetic_documents(config.synthetic_n, 2, seed=config.seed, device=device)
        test = synthetic_documents(max(config.synthetic_n // 4, 64), 2, seed=config.seed + 1,
                                   device=device)

    estimator = LogisticRegressionEstimator(2, num_iters=config.num_iters)
    pipeline = build_featurizer(config).and_then(
        CommonSparseFeatures(config.common_features), train.data
    ).and_then(estimator, train.data, train.labels)

    evaluator = BinaryClassifierEvaluator()
    t0 = time.perf_counter()
    train_preds = pipeline.apply(train.data).get()
    _sync(device)
    fit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_preds = pipeline.apply(test.data).get()
    _sync(device)
    apply_seconds = time.perf_counter() - t0
    train_eval = evaluator.evaluate(train_preds, train.labels)
    test_eval = evaluator.evaluate(test_preds, test.labels)
    logger.info("TRAIN accuracy %.4f", train_eval.accuracy)
    logger.info("TEST accuracy %.4f", test_eval.accuracy)
    logger.info("Fit %.3f s, apply %.3f s, pipeline took %.1f s",
                fit_seconds, apply_seconds, time.perf_counter() - start)
    return AmazonRun(pipeline, train_eval, test_eval, estimator, fit_seconds, apply_seconds)


def main(argv=None):
    parser = argparse.ArgumentParser("AmazonReviewsPipeline")
    parser.add_argument("--trainLocation", default="")
    parser.add_argument("--testLocation", default="")
    parser.add_argument("--threshold", type=float, default=3.5)
    parser.add_argument("--nGrams", type=int, default=2)
    parser.add_argument("--commonFeatures", type=int, default=1000)
    parser.add_argument("--numIters", type=int, default=20)
    parser.add_argument("--syntheticN", type=int, default=256,
                        help="training documents of the synthetic corpus (no files given)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = AmazonReviewsConfig(
        train_location=args.trainLocation,
        test_location=args.testLocation,
        threshold=args.threshold,
        n_grams=args.nGrams,
        common_features=args.commonFeatures,
        num_iters=args.numIters,
        synthetic_n=args.syntheticN,
    )
    result = run(config, device=args.device)
    print(f"TRAIN accuracy is {result.train_eval.accuracy:.4f}")
    print(f"TEST accuracy is {result.test_eval.accuracy:.4f}")


if __name__ == "__main__":
    main()
