"""NLP nodes: tokenization and n-grams
(reference: nodes/nlp/{StringUtils,ngrams}.scala).

Port of ``keystone_tpu/ops/nlp.py`` (the string transformers and the n-gram
featurizer the Amazon reviews pipeline runs). They are host-side work, as
in the reference (Scala collections inside RDD maps): the device path
begins once the text becomes feature vectors. Hashing TF, frequency
encoding, n-gram indexers and the Stupid Backoff language model wait for
their slice; so do the plan verifier's ``output_signature`` hooks.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence, Tuple

from keystone_tpu_torch.workflow import Transformer


# ---------------------------------------------------------------------------
# String transformers (reference: StringUtils.scala:13-29)
# ---------------------------------------------------------------------------


class Tokenizer(Transformer):
    """Split on a regex (default: runs of non-word characters)."""

    def __init__(self, sep: str = r"[^\w]+"):
        self.sep = re.compile(sep)

    def apply(self, s: str) -> List[str]:
        tokens = self.sep.split(s)
        # Java's String.split drops trailing empty strings but keeps leading
        # ones (StringUtils.scala:14).
        while tokens and tokens[-1] == "":
            tokens.pop()
        return tokens


class Trim(Transformer):
    def apply(self, s: str) -> str:
        return s.strip()


class LowerCase(Transformer):
    def apply(self, s: str) -> str:
        return s.lower()


# ---------------------------------------------------------------------------
# NGram value type + featurizer (reference: ngrams.scala:20-136)
# ---------------------------------------------------------------------------


class NGram:
    """Thin hashable wrapper over a tuple of words (ngrams.scala:100-131)."""

    __slots__ = ("words",)

    def __init__(self, words: Iterable):
        self.words = tuple(words)

    def __hash__(self) -> int:
        return hash(self.words)

    def __eq__(self, other) -> bool:
        return isinstance(other, NGram) and self.words == other.words

    def __repr__(self) -> str:
        return "[" + ",".join(str(w) for w in self.words) + "]"

    def __len__(self) -> int:
        return len(self.words)


class NGramsFeaturizer(Transformer):
    """Seq[T] -> all n-grams of the given consecutive orders, in the
    reference's order: for each start position, ascending order length
    (ngrams.scala:20-97)."""

    def __init__(self, orders: Sequence[int]):
        self.orders = list(orders)
        self.min_order = min(self.orders)
        self.max_order = max(self.orders)
        if self.min_order < 1:
            raise ValueError(f"minimum order is not >= 1, found {self.min_order}")
        for a, b in zip(self.orders, self.orders[1:]):
            if b != a + 1:
                raise ValueError(f"orders are not consecutive; contains {a} and {b}")

    def apply(self, tokens: Sequence) -> List[Tuple]:
        out = []
        n = len(tokens)
        for i in range(n - self.min_order + 1):
            for order in range(self.min_order, self.max_order + 1):
                if i + order > n:
                    break
                out.append(tuple(tokens[i:i + order]))
        return out
