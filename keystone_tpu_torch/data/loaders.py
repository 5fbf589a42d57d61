"""Data loaders for the TIMIT and CIFAR slices.

Port of ``keystone_tpu/data/loaders.py`` (the TIMIT and CIFAR-10 binary
loaders and the synthetic generators). The synthetic draws are numpy's and
are copied bit for bit, so the port and the reference see the same rows
from the same seed. CSV files are parsed with numpy instead of the
reference's native parser, and CIFAR records are split with numpy (the
reference's numpy path; its native record splitter is not ported). Every
loader takes an explicit ``device``; None means the CUDA device (raising
without one). Features and images arrive as float32, labels as int64.
"""

from __future__ import annotations

import numpy as np

from keystone_tpu_torch import resolve_device

from .dataset import LabeledData, as_tensor


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
