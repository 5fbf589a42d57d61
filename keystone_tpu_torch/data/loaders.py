"""Data loaders for the TIMIT, CIFAR, MNIST and text slices.

Port of ``keystone_tpu/data/loaders.py`` (the CSV, TIMIT, CIFAR-10 binary,
Amazon reviews and 20 Newsgroups loaders, scikit-learn's bundled digits,
and the synthetic generators, ``synthetic_sentences`` among them). The
synthetic draws are numpy's and are copied bit for bit, so the port and
the reference see the same rows from the same seed. CSV files are parsed with numpy instead of the reference's native
parser, and CIFAR records are split with numpy (the reference's numpy path;
its native record splitter is not ported). Every loader takes an explicit
``device``; None means the CUDA device (raising without one). Features and
images arrive as float32, labels as int64; documents stay host strings.
Of the image archives' loaders only the VOC record, ``MultiLabeledImage``,
is ported (``load_voc`` and ``load_imagenet`` come with the data plane).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from keystone_tpu_torch import resolve_device

from .dataset import Dataset, LabeledData, as_tensor


@dataclass
class MultiLabeledImage:
    """(image, multi-label array, filename) (reference: utils/MultiLabeledImage)."""

    image: np.ndarray
    labels: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))
    filename: str = ""


def _labeled(X: np.ndarray, labels: np.ndarray, device) -> LabeledData:
    device = resolve_device(device)
    return LabeledData(
        as_tensor(np.asarray(X, dtype=np.float32), device),
        as_tensor(np.asarray(labels, dtype=np.int64), device),
    )


def read_csv_matrix(path: str) -> np.ndarray:
    """CSV of comma-separated numbers -> (rows, cols) float64 matrix."""
    mat = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    if mat.size == 0:
        raise ValueError(f"{path}: no data rows")
    return mat


def _files_of(path: str) -> List[str]:
    """``path``, or the regular files of the directory ``path`` in sorted
    order (skipping hidden ones), as the reference reads ``sc.textFile``."""
    if not os.path.isdir(path):
        return [path]
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if os.path.isfile(os.path.join(path, f)) and not f.startswith("."))
    if not files:
        raise ValueError(f"{path}: directory contains no files")
    return files


def csv_data_loader(path: str, device=None) -> Dataset:
    """CSV of comma-separated numbers -> Dataset of rows
    (reference: loaders/CsvDataLoader.scala:10-31). ``path`` may be a
    directory: its files' rows are concatenated in sorted-filename order;
    empty files add none."""
    mats = []
    for f in _files_of(path):
        if os.path.getsize(f):
            mats.append(read_csv_matrix(f))
    if not mats:
        raise ValueError(f"{path}: no data rows in any file")
    if len({m.shape[1] for m in mats}) != 1:
        raise ValueError(f"{path}: files disagree on column count")
    return Dataset(as_tensor(np.concatenate(mats).astype(np.float32), resolve_device(device)))


def load_labeled_csv(path: str, label_offset: int = 0, device=None) -> LabeledData:
    """CSV rows of [label, features...] -> LabeledData. ``label_offset``
    shifts the labels (the MNIST files are 1-indexed; the pipeline passes
    -1, reference: pipelines/images/mnist/MnistRandomFFT.scala:34-37)."""
    rows = read_csv_matrix(path)
    return _labeled(rows[:, 1:], rows[:, 0].astype(np.int64) + label_offset, device)


CIFAR_LABEL_SIZE = 1
CIFAR_IMAGE_BYTES = 3072  # 32*32*3
CIFAR_RECORD_BYTES = CIFAR_LABEL_SIZE + CIFAR_IMAGE_BYTES


def load_cifar_binary(path: str, device=None) -> LabeledData:
    """CIFAR-10 binary format: 3073-byte records of [label, 3072 pixel bytes]
    (reference: loaders/CifarLoader.scala:14-53). Images come out as
    (n, 32, 32, 3) float32 in [0, 255] (pixel bytes are exact in float32),
    converted from CIFAR's channel-planar records to HWC."""
    with open(path, "rb") as f:
        raw_bytes = f.read()
    if len(raw_bytes) % CIFAR_RECORD_BYTES != 0:
        raise ValueError(f"{path}: not a multiple of {CIFAR_RECORD_BYTES} bytes")
    records = np.frombuffer(raw_bytes, dtype=np.uint8).reshape(-1, CIFAR_RECORD_BYTES)
    labels = records[:, 0].astype(np.int64)
    images = records[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return _labeled(images, labels, device)


class TimitFeaturesDataLoader:
    """TIMIT: CSV feature frames (440 dims) + sparse label files, 147 classes
    (reference: loaders/TimitFeaturesDataLoader.scala:16-70)."""

    num_classes = 147
    num_features = 440

    def __init__(self, feature_path: str, label_path: str, device=None):
        feats = read_csv_matrix(feature_path)
        labels = self._parse_sparse_labels(label_path, feats.shape[0])
        self.labeled = _labeled(feats, labels, device)

    @staticmethod
    def _parse_sparse_labels(path: str, n: int) -> np.ndarray:
        """Label file lines: ``row_index label`` (sparse row labels)."""
        labels = np.zeros(n, dtype=np.int64)
        with open(path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if len(parts) >= 2:
                    labels[int(parts[0])] = int(parts[1])
        return labels


def synthetic_classification(
    n: int,
    d: int,
    num_classes: int,
    seed: int = 0,
    class_sep: float = 1.0,
    means_seed: int = 1234,
    device=None,
) -> LabeledData:
    """Gaussian blobs: one mean per class, unit covariance.

    The class means are drawn from ``means_seed`` (fixed across train/test
    splits); ``seed`` only drives the sampling, so different seeds give i.i.d.
    draws from the *same* distribution.
    """
    means = np.random.default_rng(means_seed).normal(
        scale=class_sep, size=(num_classes, d)
    )
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    X = means[labels] + rng.normal(size=(n, d))
    return _labeled(X, labels, device)


def synthetic_timit(n: int = 8192, seed: int = 0, device=None) -> LabeledData:
    """TIMIT-shaped synthetic data: 440-dim frames, 147 classes."""
    return synthetic_classification(
        n, TimitFeaturesDataLoader.num_features, TimitFeaturesDataLoader.num_classes,
        seed=seed, class_sep=0.6, device=device,
    )


def synthetic_cifar(n: int = 256, seed: int = 0, num_classes: int = 10,
                    device=None) -> LabeledData:
    """CIFAR-shaped synthetic images: (n, 32, 32, 3) in [0, 255] with a
    class-dependent low-frequency pattern plus noise, so convolutional
    featurizers have signal to find. The reference's float64 draws,
    narrowed to float32 on the way to the device."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=n)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    # One spatial frequency/phase pattern per class (fixed across splits).
    pat_rng = np.random.default_rng(1234)
    freqs = pat_rng.uniform(0.2, 1.2, size=(num_classes, 2))
    phases = pat_rng.uniform(0, 2 * np.pi, size=(num_classes, 3))
    images = np.empty((n, 32, 32, 3), dtype=np.float64)
    for c in range(num_classes):
        base = np.stack(
            [np.sin(freqs[c, 0] * xx + freqs[c, 1] * yy + phases[c, ch]) for ch in range(3)],
            axis=-1,
        )
        images[labels == c] = 127.5 + 90.0 * base
    images += rng.normal(scale=25.0, size=images.shape)
    return _labeled(np.clip(images, 0, 255), labels, device)


def synthetic_mnist(n: int = 4096, seed: int = 0, device=None) -> LabeledData:
    """MNIST-shaped synthetic data: 784-dim, 10 classes."""
    return synthetic_classification(n, 784, 10, seed=seed, class_sep=0.5, device=device)


def load_digits_real(train_fraction: float = 0.8, seed: int = 0, device=None):
    """Real handwritten digits (UCI optical digits, 1,797 8×8 images, bundled
    with scikit-learn): (train, test) LabeledData with pixels scaled to
    [0, 1], split after a seeded shuffle. scikit-learn is imported here,
    only when this loader is called."""
    from sklearn.datasets import load_digits

    bunch = load_digits()
    X = bunch.data.astype(np.float64) / 16.0
    y = bunch.target.astype(np.int64)
    order = np.random.default_rng(seed).permutation(len(y))
    X, y = X[order], y[order]
    n_train = int(len(y) * train_fraction)
    return (_labeled(X[:n_train], y[:n_train], device),
            _labeled(X[n_train:], y[n_train:], device))


def _documents(texts: List[str], labels, device) -> LabeledData:
    return LabeledData(Dataset(list(texts)),
                       as_tensor(np.asarray(labels, dtype=np.int64), resolve_device(device)))


def load_newsgroups(path: str, class_dirs: Optional[List[str]] = None,
                    device=None) -> LabeledData:
    """20 Newsgroups layout: one directory per class of text files, the
    classes in sorted order unless ``class_dirs`` names them
    (reference: loaders/NewsgroupsDataLoader.scala:9-57). The texts stay
    host strings; the labels go to ``device``."""
    class_dirs = class_dirs or sorted(
        d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d)))
    texts, labels = [], []
    for label, cls in enumerate(class_dirs):
        cls_path = os.path.join(path, cls)
        for fname in sorted(os.listdir(cls_path)):
            with open(os.path.join(cls_path, fname), errors="replace") as f:
                texts.append(f.read())
            labels.append(label)
    return _documents(texts, labels, device)


def load_amazon_reviews(path: str, threshold: float = 3.5, device=None) -> LabeledData:
    """Amazon product reviews: JSON lines with "overall" and "reviewText";
    a rating >= threshold is label 1, else 0
    (reference: loaders/AmazonReviewsDataLoader.scala:7-28). ``path`` may
    be a directory of such files. The texts stay host strings; the labels
    go to ``device``."""
    texts: List[str] = []
    labels: List[int] = []
    for f in _files_of(path):
        with open(f, errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                texts.append(rec.get("reviewText", ""))
                labels.append(1 if float(rec.get("overall", 0.0)) >= threshold else 0)
    return _documents(texts, labels, device)


def synthetic_documents(n: int, num_classes: int, seed: int = 0, doc_len: int = 40,
                        vocab_per_class: int = 30, shared_vocab: int = 60,
                        device=None) -> LabeledData:
    """Synthetic text classification corpus: each class has a private
    vocabulary mixed with a shared one; documents are whitespace-joined word
    samples (host strings, the reference's draws); labels on ``device``."""
    rng = np.random.default_rng(seed)
    shared = [f"word{i}" for i in range(shared_vocab)]
    private = [[f"c{c}term{i}" for i in range(vocab_per_class)] for c in range(num_classes)]
    labels = rng.integers(0, num_classes, size=n)
    docs = []
    for lab in labels:
        k_private = rng.binomial(doc_len, 0.5)
        words = list(rng.choice(private[lab], size=k_private)) + list(
            rng.choice(shared, size=doc_len - k_private))
        rng.shuffle(words)
        docs.append(" ".join(words))
    return _documents(docs, labels, device)


def synthetic_sentences(n: int = 200, seed: int = 0, sentence_len: int = 12) -> Dataset:
    """Synthetic corpus of sentences over a 50-word vocabulary drawn with
    probabilities 1/rank (for the Stupid Backoff language model): the
    reference's numpy draws, a host list of strings."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(50)]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    return Dataset.of([" ".join(rng.choice(vocab, size=sentence_len, p=probs))
                       for _ in range(n)])
