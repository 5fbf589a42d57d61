"""StupidBackoffPipeline: an n-gram language model with stupid-backoff
scoring (reference: pipelines/nlp/StupidBackoffPipeline.scala:9-58).

Port of ``keystone_tpu/pipelines/stupid_backoff.py``. Composition:
Tokenizer → WordFrequencyEncoder → NGramsFeaturizer → NGramsCounts →
StupidBackoffEstimator. Every stage is host work on Python dictionaries,
as in the reference (Scala collections inside RDD maps): the model is
count tables and scores, and no device or kernel is on this path.
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.data.loaders import synthetic_sentences
from keystone_tpu_torch.ops.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    StupidBackoffEstimator,
    Tokenizer,
    WordFrequencyEncoder,
)

logger = logging.getLogger("keystone_tpu_torch.pipelines.stupid_backoff")


@dataclass
class StupidBackoffConfig:
    train_location: str = ""
    n: int = 3
    alpha: float = 0.4
    seed: int = 0
    synthetic_n: int = 400


def run(config: StupidBackoffConfig):
    """Returns (model, word_encoder): the fitted StupidBackoffModel scoring
    encoded n-grams, and the word → id encoder."""
    start = time.perf_counter()
    if config.train_location:
        with open(config.train_location) as f:
            text = Dataset.of([line.strip() for line in f if line.strip()])
    else:
        text = synthetic_sentences(config.synthetic_n, seed=config.seed)

    tokens = Tokenizer(r"\s+").batch_apply(text)
    word_encoder = WordFrequencyEncoder().fit(tokens)
    encoded = word_encoder.batch_apply(tokens)
    ngrams = NGramsFeaturizer(range(2, config.n + 1)).batch_apply(encoded)
    counts = NGramsCounts("default").batch_apply(ngrams)

    # WordFrequencyTransformer.unigram_counts is already index-keyed.
    model = StupidBackoffEstimator(word_encoder.unigram_counts, config.alpha).fit(counts)
    logger.info("Trained stupid-backoff LM over %d ngrams in %.1f s",
                len(model.scores), time.perf_counter() - start)
    return model, word_encoder


def main(argv=None):
    """The StupidBackoffPipeline CLI: the reference's flags plus
    ``--syntheticN`` (host work: there is no device to choose)."""
    parser = argparse.ArgumentParser("StupidBackoffPipeline")
    parser.add_argument("--trainData", default="")
    parser.add_argument("--n", type=int, default=3)
    parser.add_argument("--alpha", type=float, default=0.4)
    parser.add_argument("--syntheticN", type=int, default=400,
                        help="sentences of the synthetic corpus (no file given)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    config = StupidBackoffConfig(train_location=args.trainData, n=args.n, alpha=args.alpha,
                                 synthetic_n=args.syntheticN)
    model, _ = run(config)
    print(f"Scored {len(model.scores)} ngrams")


if __name__ == "__main__":
    main()
