"""Data loaders for the TIMIT slice.

Port of ``keystone_tpu/data/loaders.py`` (the TIMIT loader and the
synthetic generators). The synthetic draws are numpy's and are copied bit
for bit, so the port and the reference see the same rows from the same
seed. CSV files are parsed with numpy instead of the reference's native
parser. Every loader takes an explicit ``device``; None means the CUDA
device (raising without one). Features arrive as float32, labels as int64.
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
