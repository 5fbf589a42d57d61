"""NewsgroupsPipeline: n-gram term-frequency features + multinomial naive
Bayes on 20 Newsgroups (reference: pipelines/text/NewsgroupsPipeline.scala:25-72).

Port of ``keystone_tpu/pipelines/newsgroups.py``. Composition: Trim →
LowerCase → Tokenizer → NGramsFeaturizer(1..n) → TermFrequency(log1p) →
AllSparseFeatures → NaiveBayesEstimator → MaxClassifier. The text nodes,
the term counts and the vocabulary run on the host, as in the reference;
the naive Bayes fit densifies the (n, d) term frequencies on the labels'
device, as the reference densifies them, and fits there. No hand-written
kernel is on this path: the reference's is XLA's too.

:func:`run` keeps the reference's order: it applies the unfitted pipeline
to the training documents, which fits it on first use.
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from dataclasses import dataclass

import torch

from keystone_tpu_torch import resolve_device
from keystone_tpu_torch.data.loaders import load_newsgroups, synthetic_documents
from keystone_tpu_torch.evaluation import MulticlassClassifierEvaluator, MulticlassMetrics
from keystone_tpu_torch.ops.learning.classifiers import NaiveBayesEstimator
from keystone_tpu_torch.ops.nlp import LowerCase, NGramsFeaturizer, Tokenizer, Trim
from keystone_tpu_torch.ops.sparse import AllSparseFeatures
from keystone_tpu_torch.ops.stats import TermFrequency
from keystone_tpu_torch.ops.util import MaxClassifier
from keystone_tpu_torch.workflow import Pipeline

logger = logging.getLogger("keystone_tpu_torch.pipelines.newsgroups")

NUM_CLASSES = 20


@dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    seed: int = 0
    synthetic_n: int = 400
    synthetic_classes: int = NUM_CLASSES
    # Test documents of the synthetic data (0: synthetic_n // 4, at least 64).
    synthetic_test_n: int = 0


@dataclass
class NewsgroupsRun:
    """What :func:`run` returns: the pipeline, the train and test metrics,
    and the wall seconds of the training documents' apply (which fits the
    pipeline) and of the test documents', each ending in a device
    synchronize."""

    pipeline: Pipeline
    train_eval: MulticlassMetrics
    test_eval: MulticlassMetrics
    fit_seconds: float
    apply_seconds: float


def build_featurizer(config: NewsgroupsConfig) -> Pipeline:
    # log-scaled term frequency (NewsgroupsPipeline.scala:31: x => log(x + 1))
    return (
        Trim()
        .to_pipeline()
        .and_then(LowerCase())
        .and_then(Tokenizer())
        .and_then(NGramsFeaturizer(range(1, config.n_grams + 1)))
        .and_then(TermFrequency(weighting=math.log1p))
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(config: NewsgroupsConfig, device=None) -> NewsgroupsRun:
    """Build, train and evaluate; the naive Bayes fit and apply run on
    ``device`` (default: the CUDA device, raising without one)."""
    device = resolve_device(device)
    start = time.perf_counter()
    if config.train_location:
        train = load_newsgroups(config.train_location, device=device)
        test = load_newsgroups(config.test_location, device=device)
        num_classes = NUM_CLASSES
    else:
        num_classes = config.synthetic_classes
        train = synthetic_documents(config.synthetic_n, num_classes, seed=config.seed,
                                    device=device)
        n_test = config.synthetic_test_n or max(config.synthetic_n // 4, 64)
        test = synthetic_documents(n_test, num_classes, seed=config.seed + 1, device=device)

    pipeline = build_featurizer(config).and_then(AllSparseFeatures(), train.data).and_then(
        NaiveBayesEstimator(num_classes), train.data, train.labels
    ).and_then(MaxClassifier())

    t0 = time.perf_counter()
    train_pred = pipeline.apply(train.data).get()
    _sync(device)
    fit_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_pred = pipeline.apply(test.data).get()
    _sync(device)
    apply_seconds = time.perf_counter() - t0

    evaluator = MulticlassClassifierEvaluator(num_classes)
    train_eval = evaluator.evaluate(train_pred, train.labels)
    test_eval = evaluator.evaluate(test_pred, test.labels)
    logger.info("TRAIN error %.2f%%", 100 * train_eval.total_error)
    logger.info("TEST error %.2f%%", 100 * test_eval.total_error)
    logger.info("Fit %.3f s, apply %.3f s, pipeline took %.1f s",
                fit_seconds, apply_seconds, time.perf_counter() - start)
    return NewsgroupsRun(pipeline, train_eval, test_eval, fit_seconds, apply_seconds)


def main(argv=None):
    """The NewsgroupsPipeline CLI: the reference's flags plus
    ``--syntheticN`` and ``--device``."""
    parser = argparse.ArgumentParser("NewsgroupsPipeline")
    parser.add_argument("--trainLocation", default="")
    parser.add_argument("--testLocation", default="")
    parser.add_argument("--nGrams", type=int, default=2)
    parser.add_argument("--syntheticN", type=int, default=400,
                        help="training documents of the synthetic data (no files given)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; pass cpu explicitly)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = NewsgroupsConfig(
        train_location=args.trainLocation,
        test_location=args.testLocation,
        n_grams=args.nGrams,
        synthetic_n=args.syntheticN,
    )
    result = run(config, device=args.device)
    print(f"TRAIN error is {100 * result.train_eval.total_error:.2f}%")
    print(f"TEST error is {100 * result.test_eval.total_error:.2f}%")


if __name__ == "__main__":
    main()
