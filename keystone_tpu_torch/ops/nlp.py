"""NLP nodes: tokenization, n-grams, hashing TF, frequency encoding, n-gram
indexers, and the Stupid Backoff language model
(reference: nodes/nlp/{StringUtils,ngrams,HashingTF,NGramsHashingTF,
WordFrequencyEncoder,indexers,StupidBackoff}.scala).

Port of ``keystone_tpu/ops/nlp.py``, the whole module. Tokenization, n-gram
bookkeeping and the language model's count tables are host-side work, as
in the reference (Scala collections inside RDD maps): the device path
begins once the text becomes feature vectors. Hashes are deterministic
FNV-1a, the reference's (Python's builtin ``hash`` is salted per process).
The vectorised backoff scorer (:func:`_batch_score_packed`) is numpy over
the packed int64 n-gram ids, and the scalar :func:`_score_locally` stays
its oracle, as in the reference. Each host-side node declares its static
output signature for the plan verifier (``workflow/verify.py``).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from keystone_tpu_torch.data import Dataset
from keystone_tpu_torch.workflow import Estimator, Transformer
from keystone_tpu_torch.workflow.verify import HostSig, expect_host


# ---------------------------------------------------------------------------
# String transformers (reference: StringUtils.scala:13-29)
# ---------------------------------------------------------------------------
#
# These run host-side (meta-tensor interpretation cannot run them), so each
# one DECLARES its static output signature for the plan verifier
# (workflow/verify.py): what host kind it consumes and what it emits. A
# text pipeline wired out of order (e.g. n-grams before tokenization) then
# fails verification with node coordinates instead of raising a confusing
# AttributeError mid-fit.


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

    def output_signature(self, sig):
        sig = expect_host(sig, ("str",), self)
        return HostSig("tokens", n=sig.n, datum=sig.datum)


class Trim(Transformer):
    def apply(self, s: str) -> str:
        return s.strip()

    def output_signature(self, sig):
        return expect_host(sig, ("str",), self)


class LowerCase(Transformer):
    def apply(self, s: str) -> str:
        return s.lower()

    def output_signature(self, sig):
        return expect_host(sig, ("str",), self)


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

    def output_signature(self, sig):
        sig = expect_host(sig, ("tokens", "int_tokens"), self)
        return HostSig("ngrams", n=sig.n, datum=sig.datum)


class NGramsCounts(Transformer):
    """Count n-gram occurrences over the whole dataset, returning a Dataset of
    (NGram, count) pairs sorted by descending count (ngrams.scala:152-185).

    mode="default" aggregates + sorts; mode="no_add" emits per-item counts
    without cross-item aggregation (NGramsCountsMode)."""

    def __init__(self, mode: str = "default"):
        if mode not in ("default", "no_add"):
            raise ValueError('mode must be "default" or "no_add"')
        self.mode = mode

    def apply(self, ngram_lists):
        counts = Counter(NGram(g) for g in ngram_lists)
        return list(counts.items())

    def batch_apply(self, data: Dataset) -> Dataset:
        if self.mode == "no_add":
            return Dataset.of([self.apply(item) for item in data.to_list()])
        counts: Counter = Counter()
        for item in data.to_list():
            counts.update(NGram(g) for g in item)
        ordered = sorted(counts.items(), key=lambda kv: -kv[1])
        return Dataset.of(ordered)

    def output_signature(self, sig):
        sig = expect_host(sig, ("ngrams", "tokens"), self)
        # The default mode aggregates ACROSS examples — the output count
        # is the number of distinct n-grams, not the input n.
        n = sig.n if self.mode == "no_add" else None
        return HostSig("ngram_counts", n=n, datum=sig.datum)


# ---------------------------------------------------------------------------
# Hashing TF (reference: HashingTF.scala:15-31, NGramsHashingTF.scala:25-120)
# ---------------------------------------------------------------------------

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def stable_hash(term) -> int:
    """Deterministic 64-bit FNV-1a over the term's string form (replaces the
    JVM's ``.##``, which is stable; Python's ``hash`` is salted)."""
    h = _FNV_OFFSET
    for b in str(term).encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def _ngram_hash(words: Tuple) -> int:
    """Stable hash of an n-gram that can be computed rolling: FNV-1a over the
    per-word hashes."""
    h = _FNV_OFFSET
    for w in words:
        wh = stable_hash(w)
        for _ in range(8):
            h ^= wh & 0xFF
            h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
            wh >>= 8
    return h


class HashingTF(Transformer):
    """Terms -> {index: frequency} via the hashing trick
    (HashingTF.scala:15-31). Single terms hash by value; tuple terms (n-grams)
    hash by the rolling n-gram hash so NGramsHashingTF matches exactly."""

    def __init__(self, num_features: int):
        self.num_features = num_features

    def term_index(self, term) -> int:
        h = _ngram_hash(term) if isinstance(term, tuple) else stable_hash(term)
        return h % self.num_features

    def apply(self, document: Sequence) -> Dict[int, float]:
        tf: Dict[int, float] = {}
        for term in document:
            i = self.term_index(term)
            tf[i] = tf.get(i, 0.0) + 1.0
        return tf

    def output_signature(self, sig):
        sig = expect_host(sig, ("tokens", "ngrams", "int_tokens"), self)
        return HostSig("tf_dict", n=sig.n, datum=sig.datum)


class NGramsHashingTF(Transformer):
    """Fused n-gram extraction + hashing TF, computing each n-gram's hash by
    extending the (order-1) prefix hash instead of materializing tuples —
    returns exactly HashingTF(NGramsFeaturizer(orders))
    (NGramsHashingTF.scala:25-120)."""

    def __init__(self, orders: Sequence[int], num_features: int):
        self._featurizer = NGramsFeaturizer(orders)  # validates orders
        self.orders = self._featurizer.orders
        self.num_features = num_features

    def apply(self, tokens: Sequence) -> Dict[int, float]:
        min_o, max_o = self._featurizer.min_order, self._featurizer.max_order
        n = len(tokens)
        word_hashes = [stable_hash(t) for t in tokens]
        tf: Dict[int, float] = {}
        for i in range(n - min_o + 1):
            h = _FNV_OFFSET
            for j in range(i, min(i + max_o, n)):
                wh = word_hashes[j]
                for _ in range(8):
                    h ^= wh & 0xFF
                    h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
                    wh >>= 8
                order = j - i + 1
                if order >= min_o:
                    idx = h % self.num_features
                    tf[idx] = tf.get(idx, 0.0) + 1.0
        return tf

    def output_signature(self, sig):
        sig = expect_host(sig, ("tokens", "int_tokens"), self)
        return HostSig("tf_dict", n=sig.n, datum=sig.datum)


# ---------------------------------------------------------------------------
# Word frequency encoding (reference: WordFrequencyEncoder.scala:7-62)
# ---------------------------------------------------------------------------


class WordFrequencyTransformer(Transformer):
    """Token -> frequency-rank index; out-of-vocabulary -> −1."""

    OOV_INDEX = -1

    def __init__(self, word_index: Dict[str, int], unigram_counts: Dict[int, int]):
        self.word_index = word_index
        self.unigram_counts = unigram_counts

    def apply(self, words: Sequence[str]) -> List[int]:
        return [self.word_index.get(w, self.OOV_INDEX) for w in words]

    def output_signature(self, sig):
        sig = expect_host(sig, ("tokens",), self)
        return HostSig("int_tokens", n=sig.n, datum=sig.datum)


class WordFrequencyEncoder(Estimator):
    """Fit the vocabulary sorted by descending frequency
    (WordFrequencyEncoder.scala:11-30)."""

    def fit(self, data: Dataset) -> WordFrequencyTransformer:
        counts: Counter = Counter()
        for tokens in data.to_list():
            counts.update(tokens)
        ordered = sorted(counts.items(), key=lambda kv: -kv[1])
        word_index = {w: i for i, (w, _) in enumerate(ordered)}
        unigram_counts = {word_index[w]: c for w, c in ordered}
        return WordFrequencyTransformer(word_index, unigram_counts)

    def fitted_signature(self, input_sigs):
        """Static signature of the fitted transformer's output at the
        delegating apply site (verifier contract)."""
        sig = input_sigs[0] if input_sigs else None
        if isinstance(sig, HostSig):
            return HostSig("int_tokens", n=sig.n, datum=sig.datum)
        return None


# ---------------------------------------------------------------------------
# Term frequency weighting lives in ops/stats.py (TermFrequency); lemmatizing
# n-grams (reference: CoreNLPFeatureExtractor.scala:18 — an external CoreNLP
# dependency) is provided as a pluggable-lemmatizer node.
# ---------------------------------------------------------------------------


def _default_lemmatizer(word: str) -> str:
    from keystone_tpu_torch.ops.lemmatizer import lemmatize

    return lemmatize(word)


class CoreNLPFeatureExtractor(Transformer):
    """Sentence -> lemmatized n-grams. The reference shells out to Stanford
    CoreNLP (CoreNLPFeatureExtractor.scala:18); here the default lemmatizer
    is the in-tree Morpha-style inflectional analyzer
    (:mod:`keystone_tpu_torch.ops.lemmatizer` — irregular-form table + detachment
    rule cascade, the same analysis class as CoreNLP's Morphology), and the
    lemmatizer stays a pluggable callable."""

    def __init__(self, orders: Sequence[int], lemmatizer: Optional[Callable[[str], str]] = None):
        self.featurizer = NGramsFeaturizer(orders)
        self.lemmatizer = lemmatizer or _default_lemmatizer
        self.tokenizer = Tokenizer()

    def apply(self, sentence: str) -> List[Tuple]:
        lemmas = [self.lemmatizer(t) for t in self.tokenizer.apply(sentence) if t]
        return self.featurizer.apply(lemmas)

    def output_signature(self, sig):
        sig = expect_host(sig, ("str",), self)
        return HostSig("ngrams", n=sig.n, datum=sig.datum)


# ---------------------------------------------------------------------------
# N-gram indexers (reference: indexers.scala:5-135)
# ---------------------------------------------------------------------------


class NGramIndexer:
    min_ngram_order = 1
    max_ngram_order = 5

    def pack(self, ngram: Sequence) -> Any:
        raise NotImplementedError


class BackoffIndexer(NGramIndexer):
    def unpack(self, ngram, pos: int):
        raise NotImplementedError

    def remove_farthest_word(self, ngram):
        raise NotImplementedError

    def remove_current_word(self, ngram):
        raise NotImplementedError

    def ngram_order(self, ngram) -> int:
        raise NotImplementedError


class NGramIndexerImpl(BackoffIndexer):
    """NGram-tuple indexer (indexers.scala:117-135)."""

    def pack(self, ngram: Sequence) -> NGram:
        return NGram(ngram)

    def unpack(self, ngram: NGram, pos: int):
        return ngram.words[pos]

    def remove_farthest_word(self, ngram: NGram) -> NGram:
        return NGram(ngram.words[1:])

    def remove_current_word(self, ngram: NGram) -> NGram:
        return NGram(ngram.words[:-1])

    def ngram_order(self, ngram: NGram) -> int:
        return len(ngram.words)


class NaiveBitPackIndexer(BackoffIndexer):
    """Packs up to 3 word ids (< 2^20) into one 64-bit int, 4 control bits +
    three 20-bit fields, left-aligned (indexers.scala:43-115)."""

    min_ngram_order = 1
    max_ngram_order = 3
    _MASK20 = (1 << 20) - 1

    def pack(self, ngram: Sequence[int]) -> int:
        for w in ngram:
            if w >= 1 << 20:
                raise ValueError(f"word id {w} >= 2^20")
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[1] << 20) | (ngram[0] << 40) | (1 << 60)
        if n == 3:
            return ngram[2] | (ngram[1] << 20) | (ngram[0] << 40) | (1 << 61)
        raise ValueError("ngram order must be in {1, 2, 3}")

    def unpack(self, ngram: int, pos: int) -> int:
        if pos == 0:
            return (ngram >> 40) & self._MASK20
        if pos == 1:
            return (ngram >> 20) & self._MASK20
        if pos == 2:
            return ngram & self._MASK20
        raise ValueError("pos must be in {0, 1, 2}")

    def ngram_order(self, ngram: int) -> int:
        order = (ngram >> 60) & 0xF
        if not (self.min_ngram_order <= order + 1 <= self.max_ngram_order):
            raise ValueError(f"raw control bits {order} are invalid")
        return order + 1

    def remove_farthest_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        stripped = ngram & ((1 << 40) - 1)
        shifted = stripped << 20
        if order == 2:
            return shifted & ~(0xF << 60)
        if order == 3:
            return (shifted & ~(0xF << 60)) | (1 << 60)
        raise ValueError(f"ngram order not supported: {order}")

    def remove_current_word(self, ngram: int) -> int:
        order = self.ngram_order(ngram)
        if order == 2:
            return (ngram & ~((1 << 40) - 1)) & ~(0xF << 60)
        if order == 3:
            return ((ngram & ~((1 << 20) - 1)) & ~(0xF << 60)) | (1 << 60)
        raise ValueError(f"ngram order not supported: {order}")


# ---------------------------------------------------------------------------
# Stupid Backoff LM (reference: StupidBackoff.scala:25-182; Brants et al. 2007)
# ---------------------------------------------------------------------------


def initial_bigram_partition(ngram, num_partitions: int, indexer: BackoffIndexer) -> int:
    """Partition id by hashing the first two context words — groups n-grams
    sharing their initial bigram (InitialBigramPartitioner,
    StupidBackoff.scala:25-58). Here it is the host-side shard key of
    sharded score tables rather than a Spark shuffle partitioner."""
    if indexer.ngram_order(ngram) > 1:
        first = indexer.unpack(ngram, 0)
        second = indexer.unpack(ngram, 1)
        return _ngram_hash((first, second)) % num_partitions
    return 0


def _score_locally(
    indexer: BackoffIndexer,
    unigram_counts: Dict[Any, int],
    get_ngram_count: Callable,
    num_tokens: int,
    alpha: float,
    accum: float,
    ngram,
    ngram_freq: int,
) -> float:
    """Recursive backoff score S(w | context) (StupidBackoff.scala:62-93)."""
    while True:
        order = indexer.ngram_order(ngram)
        if order == 1:
            return accum * ngram_freq / num_tokens
        if ngram_freq != 0:
            context = indexer.remove_current_word(ngram)
            if order != 2:
                context_freq = get_ngram_count(context)
            else:
                context_freq = unigram_counts.get(indexer.unpack(context, 0), 0)
            return accum * ngram_freq / context_freq
        backoffed = indexer.remove_farthest_word(ngram)
        if order != 2:
            freq = get_ngram_count(backoffed)
        else:
            freq = unigram_counts.get(indexer.unpack(backoffed, 0), 0)
        accum *= alpha
        ngram = backoffed
        ngram_freq = freq


class _PackedCountTable:
    """Sorted packed-int64 → count table for vectorized lookups.

    The dict-of-NGram serving path answers one Python call per query; batch
    serving instead packs the whole table once (NaiveBitPackIndexer wire
    format — the same packing :func:`pack_ngram_pairs` ships across hosts)
    and answers a query ARRAY with one ``searchsorted`` per backoff level.
    """

    def __init__(self, packed_keys, counts):
        order = np.argsort(packed_keys, kind="stable")
        self.keys = np.asarray(packed_keys, dtype=np.int64)[order]
        self.counts = np.asarray(counts, dtype=np.int64)[order]

    @classmethod
    def from_ngram_counts(cls, ngram_counts: Dict[NGram, int]):
        packer = NaiveBitPackIndexer()
        keys = np.empty(len(ngram_counts), dtype=np.int64)
        cnts = np.empty(len(ngram_counts), dtype=np.int64)
        for i, (g, c) in enumerate(ngram_counts.items()):
            words = g.words if isinstance(g, NGram) else tuple(g)
            keys[i] = packer.pack(words)
            cnts[i] = int(c)
        return cls(keys, cnts)

    @classmethod
    def from_unigram_counts(cls, unigram_counts: Dict[Any, int]):
        """Unigrams keyed by bare word id, stored in packed-unigram form
        (id << 40) so lookups share one code path."""
        keys = np.fromiter(
            (int(w) << 40 for w in unigram_counts), dtype=np.int64,
            count=len(unigram_counts),
        )
        cnts = np.fromiter(
            (int(c) for c in unigram_counts.values()), dtype=np.int64,
            count=len(unigram_counts),
        )
        return cls(keys, cnts)

    def lookup(self, packed):
        """Counts for a packed int64 query array (0 where absent)."""
        pos = np.searchsorted(self.keys, packed)
        pos = np.minimum(pos, len(self.keys) - 1) if len(self.keys) else pos
        if not len(self.keys):
            return np.zeros(packed.shape, dtype=np.int64)
        hit = self.keys[pos] == packed
        return np.where(hit, self.counts[pos], 0)


# Vectorized NaiveBitPackIndexer field ops (mirror indexers.scala:43-115).
# Control bits live at 60-61, so "clear control bits" is a keep-low-60 mask
# — ~(0xF << 60) does not fit a signed int64 and would overflow numpy.
_M20 = (1 << 20) - 1
_M40 = (1 << 40) - 1
_KEEP60 = (1 << 60) - 1


def _vec_order(packed):
    return ((packed >> 60) & 0xF) + 1


def _vec_first_word(packed):
    return (packed >> 40) & _M20


def _vec_remove_current(packed):
    """Drop the last word (the context of the prediction)."""
    order = _vec_order(packed)
    two = (packed & ~_M40) & _KEEP60
    three = ((packed & ~np.int64(_M20)) & _KEEP60) | (1 << 60)
    return np.where(order == 2, two, three)


def _vec_remove_farthest(packed):
    """Drop the first word (the backoff step)."""
    order = _vec_order(packed)
    shifted = ((packed & _M40) << 20) & _KEEP60
    two = shifted
    three = shifted | (1 << 60)
    return np.where(order == 2, two, three)


def _batch_score_packed(
    packed,
    count_fn,
    unigram_table: "_PackedCountTable",
    num_tokens: int,
    alpha: float,
):
    """Vectorized backoff scoring: every element of the packed query array
    advances one backoff level per pass (max 3 levels for orders ≤ 3), with
    each level's count lookups batched through ``count_fn`` (one
    searchsorted over the sorted table instead of one dict probe per
    query). Same recursion as :func:`_score_locally`
    (StupidBackoff.scala:62-93) — the dict loop remains the oracle."""
    packed = np.asarray(packed, dtype=np.int64)
    # Process queries in sorted order: searchsorted over a large table is
    # ~10x faster on sorted queries (branch path locality), which beats
    # the one-time argsort well before typical serving batch sizes.
    unsort = None
    if packed.size > 4096:
        order = np.argsort(packed, kind="stable")
        unsort = np.empty_like(order)
        unsort[order] = np.arange(order.size)
        packed = packed[order]

    cur = np.array(packed, dtype=np.int64, copy=True)
    accum = np.ones(cur.shape, dtype=np.float64)
    out = np.zeros(cur.shape, dtype=np.float64)
    active = np.ones(cur.shape, dtype=bool)
    # The carried frequency mirrors the oracle's ``ngram_freq`` argument:
    # the TOP-level lookup always reads the n-gram table (a top-level
    # unigram query therefore scores 0 when the fit held only orders > 1 —
    # exactly the dict loop's behavior); after a backoff from order 2 the
    # frequency comes from the unigram table instead.
    freq = count_fn(cur)

    # Orders are ≤ 3, so at most 3 passes; guard with the loop bound anyway.
    for _ in range(4):
        if not active.any():
            break
        order = _vec_order(cur)

        # Terminal: score = accum * carried_freq / num_tokens.
        uni = active & (order == 1)
        if uni.any():
            out[uni] = accum[uni] * freq[uni] / num_tokens
            active = active & ~uni

        if not active.any():
            break
        idx = np.nonzero(active)[0]

        # Observed: score = accum * c(ngram) / c(context). Each subset hits
        # only its own table (an np.where over both lookups would evaluate
        # both for every element — S wasted searchsorted passes per level
        # on a sharded count_fn).
        hit = freq[idx] != 0
        if hit.any():
            hidx = idx[hit]
            ctx = _vec_remove_current(cur[hidx])
            o2 = _vec_order(cur[hidx]) == 2
            ctx_freq = np.empty(len(hidx), dtype=np.int64)
            if o2.any():
                # An order-2 context IS a packed unigram.
                ctx_freq[o2] = unigram_table.lookup(ctx[o2])
            if (~o2).any():
                ctx_freq[~o2] = count_fn(ctx[~o2])
            if (ctx_freq == 0).any():
                # Count tables violating the context-consistency invariant
                # (an observed n-gram whose context was never counted)
                # crash the dict oracle with ZeroDivisionError; silently
                # emitting inf here would let bad scores flow into ranking.
                raise ZeroDivisionError(
                    "observed n-gram with zero context count — the count "
                    "table violates the context-consistency invariant"
                )
            out[hidx] = accum[hidx] * freq[hidx] / ctx_freq
            active[hidx] = False

        # Unobserved: back off (drop the farthest word, discount by α).
        midx = idx[~hit]
        if len(midx):
            backoffed = _vec_remove_farthest(cur[midx])
            o2 = _vec_order(cur[midx]) == 2
            new_freq = np.empty(len(midx), dtype=np.int64)
            if o2.any():
                new_freq[o2] = unigram_table.lookup(backoffed[o2])
            if (~o2).any():
                new_freq[~o2] = count_fn(backoffed[~o2])
            freq[midx] = new_freq
            cur[midx] = backoffed
            accum[midx] *= alpha
    return out if unsort is None else out[unsort]


class StupidBackoffModel(Transformer):
    """Query-only LM model: use ``score(ngram)`` for single queries or
    ``batch_score`` / ``batch_score_packed`` for vectorized serving
    (StupidBackoff.scala:96-125)."""

    def __init__(
        self,
        scores: Dict[NGram, float],
        ngram_counts: Dict[NGram, int],
        indexer: BackoffIndexer,
        unigram_counts: Dict[Any, int],
        num_tokens: int,
        alpha: float = 0.4,
    ):
        self.scores = scores
        self.ngram_counts = ngram_counts
        self.indexer = indexer
        self.unigram_counts = unigram_counts
        self.num_tokens = num_tokens
        self.alpha = alpha
        self._table = None
        self._uni_table = None

    def score(self, ngram: NGram) -> float:
        return _score_locally(
            self.indexer,
            self.unigram_counts,
            lambda g: self.ngram_counts.get(g, 0),
            self.num_tokens,
            self.alpha,
            1.0,
            ngram,
            self.ngram_counts.get(ngram, 0),
        )

    def _tables(self):
        if self._table is None:
            self._table = _PackedCountTable.from_ngram_counts(self.ngram_counts)
            self._uni_table = _PackedCountTable.from_unigram_counts(
                self.unigram_counts
            )
        return self._table, self._uni_table

    def batch_score_packed(self, packed):
        """Vectorized scores for a packed int64 n-gram array (the
        :func:`pack_ngram_pairs` wire format; integer word ids < 2^20,
        orders 1-3). The reference served scoring data-parallel over the
        cluster (StupidBackoff.scala:128-182); this is the one-host
        vectorized analog — same recursion, table lookups batched."""
        table, uni = self._tables()
        return _batch_score_packed(
            packed, table.lookup, uni, self.num_tokens, self.alpha
        )

    def batch_score(self, ngrams: Sequence) -> "Any":
        """Pack + vectorized-score a sequence of NGram / word-id tuples."""
        packer = NaiveBitPackIndexer()
        packed = np.fromiter(
            (
                packer.pack(g.words if isinstance(g, NGram) else tuple(g))
                for g in ngrams
            ),
            dtype=np.int64,
            count=len(ngrams),
        )
        return self.batch_score_packed(packed)

    def apply(self, ignored):
        raise NotImplementedError(
            "Doesn't make sense to chain this node; use score(ngram) to query."
        )


def partition_ngram_pairs(
    pairs, num_partitions: int, indexer: Optional[BackoffIndexer] = None
):
    """reduceByKey with the InitialBigramPartitioner, host side
    (StupidBackoff.scala:152-156): merge duplicate n-gram counts and bucket
    them by :func:`initial_bigram_partition`. Returns a list of
    ``num_partitions`` lists of (NGram, count).

    The partitioner's invariant makes per-partition scoring exact: an
    n-gram's context (its first n−1 words) shares the initial bigram, so
    every count the score recursion reads for an OBSERVED n-gram lives in
    the same partition (order-2 contexts read the replicated unigram table
    instead), and the freq==0 backoff branch is unreachable during fit.
    """
    indexer = indexer or NGramIndexerImpl()
    merged: Dict[NGram, int] = {}
    for ngram, c in pairs:
        key = ngram if isinstance(ngram, NGram) else NGram(ngram)
        merged[key] = merged.get(key, 0) + int(c)
    parts = [[] for _ in range(num_partitions)]
    for ngram, c in merged.items():
        parts[initial_bigram_partition(ngram, num_partitions, indexer)].append(
            (ngram, c)
        )
    return parts


def pack_ngram_pairs(pairs) -> "np.ndarray":
    """(NGram, count) pairs -> (m, 2) int64 array ``[packed_id, count]`` —
    the wire format for exchanging count shards across hosts as one int64
    array instead of pickled host objects. Uses NaiveBitPackIndexer:
    integer word ids < 2^20, orders 1-3 (indexers.scala:43-115).

    The packed ids use up to 62 bits: a tensor that carries them must be
    int64, or the values are truncated."""
    packer = NaiveBitPackIndexer()
    out = np.empty((len(pairs), 2), dtype=np.int64)
    for i, (ngram, c) in enumerate(pairs):
        words = ngram.words if isinstance(ngram, NGram) else tuple(ngram)
        out[i, 0] = packer.pack(words)
        out[i, 1] = int(c)
    return out


def unpack_ngram_pairs(arr) -> List[Tuple[NGram, int]]:
    """Inverse of :func:`pack_ngram_pairs`."""
    packer = NaiveBitPackIndexer()
    out = []
    for packed, c in arr.tolist():
        order = packer.ngram_order(packed)
        words = tuple(packer.unpack(packed, p) for p in range(order))
        out.append((NGram(words), int(c)))
    return out


class ShardedStupidBackoffModel(Transformer):
    """Multi-host LM serving: one StupidBackoffModel per initial-bigram
    partition. EVERY count lookup routes to its owning shard — not just the
    top-level query — because the backoff step drops the FIRST word, which
    changes the initial bigram and so the owning partition. This mirrors
    the reference's ``ngramCounts.lookup`` on the partitioned RDD, where
    the partitioner routes each lookup (StupidBackoff.scala:96-125)."""

    # Keys probed per shard by the default disjointness check.
    _VALIDATE_PROBES = 32

    def __init__(self, shards: List["StupidBackoffModel"], indexer=None,
                 validate=True):
        self.shards = shards
        self.indexer = indexer or NGramIndexerImpl()
        # batch_score_packed SUMS per-shard lookups, which is only equal to
        # the routed lookup when no n-gram lives in two shards — guaranteed
        # by partition_ngram_pairs but not by a hand-assembled model, where
        # a duplicate would silently double its count.
        #
        # The DEFAULT check is a sampled-key probe: O(shards² × probes)
        # dict lookups instead of materializing a set union of every
        # shard's n-grams (O(total n-grams) time AND memory — at serving
        # scale that doubled construction's footprint for a check that, in
        # the realistic failure mode of the same pair list fed to two
        # shards, any single probed key already catches). Probabilistic:
        # it cannot prove disjointness. Pass ``validate="full"`` for the
        # exhaustive union check, or ``validate=False`` to skip — the
        # partitioner's own construction path (:meth:`from_partitioned`)
        # does, since its shards are disjoint by construction.
        if validate == "full":
            total = sum(len(s.ngram_counts) for s in shards)
            union: set = set()
            for s in shards:
                union.update(s.ngram_counts)
            if len(union) != total:
                raise ValueError(
                    f"shards overlap: {total - len(union)} n-gram(s) present "
                    "in more than one shard (partition with "
                    "partition_ngram_pairs)"
                )
        elif validate:
            self._probe_disjoint()

    def _probe_disjoint(self) -> None:
        """Sampled disjointness check: probe evenly-spaced keys from each
        shard against every other shard's table. Probabilistic — it cannot
        prove disjointness, but catches the systematic overlaps
        mis-assembly actually produces (duplicated or mis-partitioned pair
        lists) at O(probes) memory (the keys are stepped off the dict
        iterator, never materialized as a full list)."""
        from itertools import islice

        for i, s in enumerate(self.shards):
            count = len(s.ngram_counts)
            if not count:
                continue
            step = max(count // self._VALIDATE_PROBES, 1)
            probes = list(islice(
                iter(s.ngram_counts), 0, step * self._VALIDATE_PROBES, step
            ))
            for j, other in enumerate(self.shards):
                if j == i:
                    continue
                for key in probes:
                    if key in other.ngram_counts:
                        raise ValueError(
                            f"shards overlap: n-gram {key} present in "
                            f"shards {i} and {j} (partition with "
                            "partition_ngram_pairs; probabilistic probe — "
                            'pass validate="full" for the exhaustive check)'
                        )

    @classmethod
    def from_partitioned(
        cls, shards: List["StupidBackoffModel"], indexer=None
    ) -> "ShardedStupidBackoffModel":
        """Construction path for shards fitted from
        :func:`partition_ngram_pairs` output: the partitioner assigns each
        n-gram to exactly one part, so the overlap check is skipped
        entirely (validate=False) — no O(total n-grams) pass at serving
        scale."""
        return cls(shards, indexer=indexer, validate=False)

    def _count(self, ngram: NGram) -> int:
        pid = initial_bigram_partition(ngram, len(self.shards), self.indexer)
        return self.shards[pid].ngram_counts.get(ngram, 0)

    def score(self, ngram: NGram) -> float:
        head = self.shards[0]  # unigram table/α replicated across shards
        return _score_locally(
            self.indexer,
            head.unigram_counts,
            self._count,
            head.num_tokens,
            head.alpha,
            1.0,
            ngram,
            self._count(ngram),
        )

    def batch_score_packed(self, packed):
        """Vectorized scoring against the sharded tables. Every n-gram lives
        in exactly ONE shard (the partitioner is a function of the key), so
        summing per-shard lookups equals the routed lookup — no per-query
        partition hashing, one searchsorted per shard per backoff level."""
        head = self.shards[0]
        tables = [s._tables()[0] for s in self.shards]
        uni = head._tables()[1]

        def count_fn(arr):
            total = tables[0].lookup(arr)
            for t in tables[1:]:
                total = total + t.lookup(arr)
            return total

        return _batch_score_packed(
            packed, count_fn, uni, head.num_tokens, head.alpha
        )

    def apply(self, ignored):
        raise NotImplementedError(
            "Doesn't make sense to chain this node; use score(ngram) to query."
        )


class StupidBackoffEstimator(Estimator):
    """Scores every observed n-gram (StupidBackoff.scala:128-182). Input: a
    Dataset of (NGram, count) pairs, e.g. from NGramsCounts."""

    def __init__(self, unigram_counts: Dict[Any, int], alpha: float = 0.4):
        self.unigram_counts = unigram_counts
        self.alpha = alpha
        self.indexer = NGramIndexerImpl()

    def fit(self, data: Dataset) -> StupidBackoffModel:
        counts: Dict[NGram, int] = {}
        for ngram, c in data.to_list():
            key = ngram if isinstance(ngram, NGram) else NGram(ngram)
            counts[key] = counts.get(key, 0) + int(c)
        num_tokens = sum(self.unigram_counts.values())

        get_count = lambda g: counts.get(g, 0)
        scores: Dict[NGram, float] = {}
        for ngram, freq in counts.items():
            s = _score_locally(
                self.indexer,
                self.unigram_counts,
                get_count,
                num_tokens,
                self.alpha,
                1.0,
                ngram,
                freq,
            )
            if not (0.0 <= s <= 1.0):
                raise ValueError(f"score = {s:.4f} not in [0,1], ngram = {ngram}")
            scores[ngram] = s
        return StupidBackoffModel(
            scores, counts, self.indexer, self.unigram_counts, num_tokens, self.alpha
        )
