"""Data loaders for the TIMIT, CIFAR, MNIST and text slices.

Port of ``keystone_tpu/data/loaders.py`` (the CSV, TIMIT, CIFAR-10 binary,
Amazon reviews and 20 Newsgroups loaders, scikit-learn's bundled digits,
and the synthetic generators, ``synthetic_sentences`` among them). The
synthetic draws are numpy's and are copied bit for bit, so the port and
the reference see the same rows from the same seed. CSV files are parsed
and CIFAR records split by the native data plane
(:mod:`keystone_tpu_torch.native`), PNM images decoded by it and other
formats through PIL. Every loader that returns tensors takes an explicit
``device``; None means the CUDA device (raising without one). Features and
images arrive as float32, labels as int64; documents stay host strings.
The image archives' loaders (``load_voc``, ``load_imagenet``) return host
datasets of numpy images, as the reference's do.

``csv_to_disk_shards`` is the out-of-core spill path: CSV files go to
pre-tiled disk shards one file at a time, and the result is a
shard-backed :class:`LabeledData` (no device; its fit streams from disk).
"""

from __future__ import annotations

import json
import os
import tarfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from keystone_tpu_torch import native, resolve_device

from .dataset import Dataset, LabeledData, as_tensor, one_hot_pm1


@dataclass
class LabeledImage:
    """(image, int label, filename) (reference: utils/LabeledImage)."""

    image: np.ndarray
    label: int
    filename: str = ""


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


def _check_rect(vals, ncols: int, nrows: int, where: str) -> np.ndarray:
    if ncols <= 0 or vals.size != ncols * nrows:
        raise ValueError(
            f"{where}: ragged CSV — {vals.size} values over {nrows} rows "
            f"do not form a rectangular {nrows}x{ncols} matrix"
        )
    return vals.reshape(nrows, ncols)


def read_csv_matrix(path: str) -> np.ndarray:
    """CSV of comma-separated numbers -> (rows, cols) float64 matrix,
    parsed by the native data plane."""
    with open(path, "rb") as f:
        text = f.read()
    vals, ncols, nrows = native.parse_csv_floats(text)
    if nrows == 0:
        raise ValueError(f"{path}: no data rows")
    return _check_rect(vals, ncols, nrows, path)


def _read_csv_matrices(paths: List[str]) -> List[np.ndarray]:
    """Parse many CSV files in the native thread pool (one task a file).
    Empty files contribute no rows (sc.textFile semantics, e.g. Spark
    _SUCCESS markers)."""
    texts = []
    for p in paths:
        with open(p, "rb") as f:
            texts.append(f.read())
    return [
        _check_rect(vals, ncols, nrows, path)
        for path, (vals, ncols, nrows) in zip(paths, native.parse_csv_floats_many(texts))
        if nrows > 0
    ]


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
    empty files add none. The files are parsed concurrently."""
    mats = _read_csv_matrices(_files_of(path))
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
    converted from CIFAR's channel-planar records to HWC by the native
    data plane's threaded record splitter."""
    with open(path, "rb") as f:
        raw_bytes = f.read()
    if len(raw_bytes) % CIFAR_RECORD_BYTES != 0:
        raise ValueError(f"{path}: not a multiple of {CIFAR_RECORD_BYTES} bytes")
    labels, images = native.split_records(raw_bytes, CIFAR_LABEL_SIZE, 3, 32, 32)
    return _labeled(images, labels, device)


def csv_to_disk_shards(
    path: str,
    out_dir: str,
    shard_rows: int,
    tiles_per_segment: int = 4,
    label_col: Optional[int] = 0,
    label_offset: int = 0,
    num_classes: Optional[int] = None,
) -> LabeledData:
    """The loaders' out-of-core spill path: CSV file(s) -> pre-tiled disk
    shards, one file resident at a time, returning a shard-backed
    LabeledData (reference analog: CsvDataLoader's lazy ``textFile`` never
    collects either: the dataset goes storage to storage).

    ``path`` may be a directory (files parsed in sorted order, as
    ``csv_data_loader`` reads them); host residency is bounded by the
    largest single file plus the shard pages being filled. ``label_col``
    selects the label column; integer class labels become ±1 one-hot
    targets when ``num_classes`` is given, else a (n, 1) float column.
    ``shard_rows`` need not divide the row count: the ragged final shard is
    zero-padded and masked by ``n_true`` at fold time.
    """
    if label_col is None:
        raise ValueError("csv_to_disk_shards needs a label column")
    from .shards import DiskDenseShardWriter

    files = _files_of(path)
    # Capacity pass: a newline count bounds the row count of a file from
    # above (blank lines overcount; the +1 covers a missing trailing
    # newline). The writer tolerates overshoot. Counted in fixed-size
    # chunks, so the counting pass is never the residency peak.
    capacity = 0
    for p in files:
        last = b""
        with open(p, "rb") as f:
            while True:
                buf = f.read(16 << 20)
                if not buf:
                    break
                capacity += buf.count(b"\n")
                last = buf[-1:]
        if last and last != b"\n":
            capacity += 1
    if capacity == 0:
        raise ValueError(f"{path}: no data rows in any file")

    writer = None
    width = None
    for p in files:
        if os.path.getsize(p) == 0:
            continue  # sc.textFile semantics: empty files contribute nothing
        rows = read_csv_matrix(p)
        if width is None:
            width = rows.shape[1]
        elif rows.shape[1] != width:
            raise ValueError(
                f"{path}: files disagree on column count {{{width}, {rows.shape[1]}}}"
            )
        feats = np.delete(rows, label_col, axis=1).astype(np.float32, copy=False)
        if num_classes is not None:
            Y = one_hot_pm1(rows[:, label_col].astype(np.int64) + label_offset, num_classes)
        else:
            # Continuous targets keep the float column as read.
            Y = (rows[:, label_col] + label_offset).astype(np.float32)[:, None]
        if writer is None:
            writer = DiskDenseShardWriter(
                out_dir, capacity, feats.shape[1], Y.shape[1],
                tile_rows=int(shard_rows), tiles_per_segment=tiles_per_segment,
            )
        writer.append(feats, Y)
    if writer is None:
        raise ValueError(f"{path}: no data rows in any file")
    return writer.close().as_labeled_data()


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


# ---------------------------------------------------------------------------
# Image archive loading (reference: loaders/ImageLoaderUtils.scala:21-94,
# VOCLoader.scala:16-53, ImageNetLoader.scala:12-39)
# ---------------------------------------------------------------------------


def decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode image bytes to a float32 (x, y, c) numpy array: PNM through
    the native decoder, other formats through PIL (the role javax.imageio
    plays in the reference, ImageLoaderUtils.scala:60-84). None when the
    bytes do not decode."""
    if data[:2] in (b"P5", b"P6"):
        arr = native.decode_pnm(data)
        if arr is not None:
            return arr
    try:
        from keystone_tpu_torch.utils.images import load_image

        return np.asarray(load_image(data))
    except Exception:
        return None


def iter_tar_images(tar_path: str):
    """Yield (member_name, decoded image) from a tar of image files
    (reference: ImageLoaderUtils.loadTarFiles). PNM members are decoded in
    batches through the native thread pool; other formats one at a time
    through PIL. Members that do not decode are skipped."""
    CHUNK = 64  # bounds peak memory: the raw bytes and decodes of one chunk

    def flush(names, raws):
        pnm_idx = [i for i, d in enumerate(raws) if d[:2] in (b"P5", b"P6")]
        decoded: Dict[int, Optional[np.ndarray]] = {}
        if pnm_idx:
            decoded = dict(zip(pnm_idx, native.decode_pnm_many([raws[i] for i in pnm_idx])))
        for i, (name, data) in enumerate(zip(names, raws)):
            img = decoded.get(i)
            if img is None:
                img = decode_image_bytes(data)
            if img is not None:
                yield name, img

    names: List[str] = []
    raws: List[bytes] = []
    with tarfile.open(tar_path) as tf:
        for member in tf.getmembers():
            if not member.isfile():
                continue
            f = tf.extractfile(member)
            if f is None:
                continue
            names.append(member.name)
            raws.append(f.read())
            if len(raws) >= CHUNK:
                yield from flush(names, raws)
                names, raws = [], []
    yield from flush(names, raws)


def _tar_paths(data_path: str) -> List[str]:
    if os.path.isdir(data_path):
        return [
            os.path.join(data_path, f)
            for f in sorted(os.listdir(data_path))
            if f.endswith(".tar")
        ]
    return [data_path]


def load_imagenet(data_path: str, labels_path: str) -> Dataset:
    """Tars of images under class-name directories + a "classname label"
    map file -> host Dataset of LabeledImage (reference:
    ImageNetLoader.scala:12-39). Images are center-cropped to multiples
    of 8, as the reference buckets them."""
    from keystone_tpu_torch.utils.images import crop_to_multiple

    labels_map: Dict[str, int] = {}
    with open(labels_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                labels_map[parts[0]] = int(parts[1])
    out: List[LabeledImage] = []
    for tar_path in _tar_paths(data_path):
        for name, img in iter_tar_images(tar_path):
            cls = name.split("/")[0]
            if cls in labels_map:
                out.append(LabeledImage(crop_to_multiple(img), labels_map[cls], name))
    return Dataset(out)


VOC_NUM_CLASSES = 20


def load_voc(data_path: str, labels_path: str, name_prefix: str = "") -> Dataset:
    """VOC2007 tar + CSV multi-labels -> host Dataset of MultiLabeledImage
    (reference: VOCLoader.scala:29-50, ImageLoaderUtils.scala:72-92). The
    CSV has a header; column 4 is the quoted filename (the full tar entry
    path, also the label-map key and the stored filename) and column 1 the
    1-based class id. ``name_prefix`` filters full entry names (the
    reference's namePrefix, e.g. "VOCdevkit/VOC2007/JPEGImages/")."""
    from keystone_tpu_torch.utils.images import crop_to_multiple

    labels_map: Dict[str, List[int]] = {}
    with open(labels_path) as f:
        next(f)  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) >= 5:
                fname = parts[4].replace('"', "")
                labels_map.setdefault(fname, []).append(int(parts[1]) - 1)
    out: List[MultiLabeledImage] = []
    for tar_path in _tar_paths(data_path):
        for name, img in iter_tar_images(tar_path):
            if name_prefix and not name.startswith(name_prefix):
                continue
            if name in labels_map:
                out.append(MultiLabeledImage(
                    crop_to_multiple(img), np.asarray(sorted(labels_map[name])), name,
                ))
    return Dataset(out)
