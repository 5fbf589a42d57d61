"""Image-tier data plane: encoded images in, decoded row segments out, at
every storage tier (port of ``keystone_tpu/data/images.py``, whole; host
numpy work, no device).

The reference's image loaders (``ImageNetLoader`` / ``VOCLoader``) hand
Spark an RDD of lazily decoded images and let lineage re-decode on demand.
Here a :class:`~keystone_tpu_torch.data.prefetch.ShardSource` decodes one
segment of encoded images inside ``load(s)``: under a
:class:`~keystone_tpu_torch.data.prefetch.Prefetcher` that is the
data-plane runtime's read lane, so decode and augmentation hide behind the
device fold as disk reads do. Decode and augment are fault and
observability sites (``image.decode`` / ``image.augment``).

Storage-tier routing (``cost.choose_image_tier``) lets a past-host-RAM
image set load with no flag: ``load_images`` prices the tiers and either
keeps decoded rows resident (float32, or uint8, exact for 8-bit sources;
both fill preallocated buffers one segment at a time) or spills storage to
storage through
:class:`~keystone_tpu_torch.data.shards.DiskDenseShardWriter` (uint8 rows
on disk by default), host residency bounded by one segment.

Row layout: each decoded (and augmented) image flattens row-major over
``(x, y, c)`` to one float32 row.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np

from keystone_tpu_torch.data.prefetch import ShardSource
from keystone_tpu_torch.utils import faults

__all__ = [
    "EncodedImageSource",
    "SyntheticEncodedImages",
    "images_to_disk_shards",
    "load_images",
]


class SyntheticEncodedImages:
    """A deterministic corpus of PPM(P6)-encoded synthetic images with
    integer class labels — the image-tier test/bench stand-in for a tar
    of JPEGs, with the same decode cost profile (the native PNM decoder
    is the hot path ``decode_image_bytes`` takes).

    Pixels follow the ``synthetic_cifar`` recipe: a class-dependent
    low-frequency pattern plus per-image noise, quantized to uint8 — so
    conv featurizers have signal to find and the uint8 resident tier is
    exact. ``encoded(i)`` is pure in ``i``: two providers with the same
    constructor arguments yield identical bytes (replayable ingest).
    """

    def __init__(
        self,
        n: int,
        x: int = 32,
        y: int = 32,
        channels: int = 3,
        num_classes: int = 10,
        seed: int = 0,
    ):
        self.n = int(n)
        self.x = int(x)
        self.y = int(y)
        self.channels = int(channels)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        pat = np.random.default_rng((self.seed, 0xC1FA))
        self._freqs = pat.uniform(0.2, 1.2, size=(num_classes, 2))
        self._phases = pat.uniform(0, 2 * np.pi, size=(num_classes, channels))
        yy, xx = np.meshgrid(np.arange(self.y), np.arange(self.x), indexing="ij")
        self._grid = (xx, yy)

    def label(self, i: int) -> int:
        return int(
            np.random.default_rng((self.seed, 1, int(i))).integers(
                0, self.num_classes
            )
        )

    def _pixels(self, i: int) -> np.ndarray:
        """(x, y, c) uint8 pixels of image ``i``."""
        c = self.label(i)
        xx, yy = self._grid
        base = np.stack(
            [
                np.sin(
                    self._freqs[c, 0] * xx
                    + self._freqs[c, 1] * yy
                    + self._phases[c, ch]
                )
                for ch in range(self.channels)
            ],
            axis=-1,
        )
        noise = np.random.default_rng((self.seed, 2, int(i))).normal(
            0.0, 0.35, size=base.shape
        )
        img = (base * 0.5 + 0.5 + noise) * 255.0
        return np.clip(img, 0, 255).astype(np.uint8).transpose(1, 0, 2)

    def encoded(self, i: int) -> bytes:
        """PPM P6 bytes of image ``i`` (grayscale sources use P5)."""
        px = self._pixels(i)  # (x, y, c) raster: h=x rows of w=y samples
        h, w = px.shape[0], px.shape[1]
        if self.channels == 1:
            return b"P5\n%d %d\n255\n" % (w, h) + px[:, :, 0].tobytes()
        return b"P6\n%d %d\n255\n" % (w, h) + px.tobytes()

    def encoded_nbytes(self, i: int) -> int:
        return len(self.encoded(i))


class EncodedImageSource(ShardSource):
    """Encoded images as a ShardSource: ``load(s) -> (X_seg (rows, d),
    Y_seg (rows, k), valid_rows)`` with decode + deterministic
    augmentation happening INSIDE ``load`` — on the prefetcher's read
    lane, where the overlap accounting and the fault sites live.

    ``provider`` supplies ``n``, ``encoded(i) -> bytes`` and
    ``label(i) -> int`` (:class:`SyntheticEncodedImages`, or any tar/dir
    adapter with the same surface). Augmentation is a seeded crop to
    ``crop`` (x', y') plus a seeded horizontal flip, derived from
    ``(augment_seed, i)`` — the i-th row is identical across epochs,
    processes, and resume boundaries (the ZCA bit-identity contract
    extends through ingest). Labels one-hot encode to ±1 (the
    ``ClassLabelIndicators`` convention).

    Ragged tails zero-pad to the fixed segment shape; streamed folds see
    zero rows (exact for sums/grams) and ``valid_rows`` carries the true
    count.
    """

    load_retries_transients = False  # the Prefetcher wraps retries

    def __init__(
        self,
        provider,
        images_per_segment: int = 256,
        crop: Optional[Tuple[int, int]] = None,
        augment_seed: int = 0,
        flip: bool = True,
    ):
        self.provider = provider
        self.images_per_segment = int(images_per_segment)
        self.crop = None if crop is None else (int(crop[0]), int(crop[1]))
        self.augment_seed = int(augment_seed)
        self.flip = bool(flip)
        self.n_true = int(provider.n)
        self.num_segments = max(
            1, math.ceil(self.n_true / self.images_per_segment)
        )
        cx, cy = self.out_shape[:2]
        self.d = cx * cy * provider.channels
        self.k = int(provider.num_classes)

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        """Decoded-and-augmented image shape (x', y', c)."""
        if self.crop is not None:
            return (self.crop[0], self.crop[1], self.provider.channels)
        return (self.provider.x, self.provider.y, self.provider.channels)

    @property
    def row_bytes(self) -> Optional[float]:
        return 4.0 * (self.d + self.k)

    @property
    def segment_bytes(self) -> Optional[float]:
        return self.images_per_segment * self.row_bytes

    def segment_encoded_bytes(self, s: int) -> int:
        """Encoded (pre-decode) bytes of segment ``s`` — the ingest-
        bandwidth numerator for bench rows."""
        lo = s * self.images_per_segment
        hi = min(lo + self.images_per_segment, self.n_true)
        return sum(self.provider.encoded_nbytes(i) for i in range(lo, hi))

    def _augment(self, img: np.ndarray, i: int) -> np.ndarray:
        if self.crop is None and not self.flip:
            return img
        r = np.random.default_rng((self.augment_seed, int(i)))
        if self.crop is not None:
            cx, cy = self.crop
            ox = int(r.integers(0, img.shape[0] - cx + 1))
            oy = int(r.integers(0, img.shape[1] - cy + 1))
            img = img[ox:ox + cx, oy:oy + cy, :]
        if self.flip and int(r.integers(0, 2)):
            img = img[:, ::-1, :]
        return img

    def load(self, s: int):
        from keystone_tpu_torch.data.loaders import decode_image_bytes

        lo = s * self.images_per_segment
        hi = min(lo + self.images_per_segment, self.n_true)
        valid = hi - lo

        faults.maybe_fail(faults.SITE_IMAGE_DECODE)
        t0 = time.perf_counter()
        decoded = []
        for i in range(lo, hi):
            img = decode_image_bytes(self.provider.encoded(i))
            if img is None:
                raise ValueError(f"image {i} failed to decode")
            if img.ndim == 2:
                img = img[:, :, None]
            decoded.append(np.asarray(img, np.float32))
        faults.observe_busy("decode", time.perf_counter() - t0)

        faults.maybe_fail(faults.SITE_IMAGE_AUGMENT)
        t0 = time.perf_counter()
        X = np.zeros((self.images_per_segment, self.d), dtype=np.float32)
        Y = np.zeros((self.images_per_segment, self.k), dtype=np.float32)
        Y[:valid] = -1.0
        for j, img in enumerate(decoded):
            X[j] = self._augment(img, lo + j).reshape(-1)
            Y[j, self.provider.label(lo + j)] = 1.0
        faults.observe_busy("augment", time.perf_counter() - t0)
        return X, Y, valid

    def materialize(self):
        xs, ys = [], []
        rows = 0
        for s in range(self.num_segments):
            X, Y, valid = self.load(s)
            xs.append(X[:valid])
            ys.append(Y[:valid])
            rows += valid
        return np.concatenate(xs, axis=0), np.concatenate(ys, axis=0)


def images_to_disk_shards(
    source: EncodedImageSource,
    out_dir: str,
    tile_rows: int = 256,
    tiles_per_segment: int = 4,
    x_dtype=np.float32,
):
    """Spill a decoded image stream storage-to-storage: one segment
    decodes at a time, appends to a :class:`DiskDenseShardWriter`, and
    the dataset is never host-resident. ``x_dtype=np.uint8`` stores the
    compressed-resident pixel form (exact for 8-bit sources, 4× smaller
    on disk and over the read lane). Returns the shard-backed
    :class:`~keystone_tpu_torch.data.dataset.LabeledData`."""
    from keystone_tpu_torch.data.shards import DiskDenseShardWriter

    writer = DiskDenseShardWriter(
        out_dir,
        capacity_rows=source.n_true,
        d_in=source.d,
        k=source.k,
        tile_rows=tile_rows,
        tiles_per_segment=tiles_per_segment,
        x_dtype=x_dtype,
    )
    for s in range(source.num_segments):
        X, Y, valid = source.load(s)
        writer.append(np.asarray(X[:valid], dtype=x_dtype), Y[:valid])
    return writer.close().as_labeled_data()


def _materialize_resident(source: EncodedImageSource, x_dtype):
    """Stream-decode a source into preallocated ``(n, d)`` ``x_dtype``
    rows and ``(n, k)`` f32 labels: one segment decodes at a time and
    casts into place, so peak host residency is the PRICED resident form
    plus a single staged f32 segment — never the full f32 dataset. The
    ``resident_u8`` tier engages exactly when that f32 form busts the
    host budget, so this path must not build it."""
    X = np.empty((source.n_true, source.d), dtype=x_dtype)
    Y = np.empty((source.n_true, source.k), dtype=np.float32)
    row = 0
    for s in range(source.num_segments):
        X_seg, Y_seg, valid = source.load(s)
        X[row:row + valid] = X_seg[:valid]  # exact u8 cast: 8-bit sources
        Y[row:row + valid] = Y_seg[:valid]
        row += valid
    return X, Y


def load_images(
    provider,
    *,
    images_per_segment: int = 256,
    crop: Optional[Tuple[int, int]] = None,
    augment_seed: int = 0,
    flip: bool = True,
    spill_dir: Optional[str] = None,
    spill_dtype=None,
    tile_rows: int = 256,
    tiles_per_segment: int = 4,
    prefetch_depth: int = 2,
    host_budget_bytes: Optional[float] = None,
):
    """The image-tier loader entry point: decode-and-augment an encoded
    corpus into a :class:`LabeledData` at the storage tier the cost
    model selects (a recorded ``image_tier`` CostDecision) — resident
    f32 rows, resident uint8 rows, or disk shards — with NO flag. A
    past-host-RAM corpus requires ``spill_dir`` (raises otherwise: the
    only honest alternative would be an OOM). ``spill_dtype`` is the
    on-disk row dtype for the spill tier; the ``None`` default stores
    uint8 — the compressed-resident form, exact for 8-bit sources with
    value-preserving augmentation, and the 4×-smaller write + per-epoch
    re-read traffic the cost model's disk pricing assumes. Pass
    ``np.float32`` for deeper-than-8-bit providers."""
    from keystone_tpu_torch.data.dataset import LabeledData
    from keystone_tpu_torch.ops.learning import cost

    source = EncodedImageSource(
        provider,
        images_per_segment=images_per_segment,
        crop=crop,
        augment_seed=augment_seed,
        flip=flip,
    )
    tier, ref = cost.choose_image_tier(
        source.n_true, source.d, source.k,
        images_per_segment=images_per_segment,
        prefetch_depth=prefetch_depth,
        host_budget_bytes=host_budget_bytes,
    )
    if tier == "disk_shards":
        if spill_dir is None:
            raise ValueError(
                "the cost model routed this image set to disk shards "
                f"({source.n_true} images × {source.row_bytes:.0f} B rows "
                "exceed the host budget) — pass spill_dir="
            )
        return images_to_disk_shards(
            source, spill_dir,
            tile_rows=tile_rows, tiles_per_segment=tiles_per_segment,
            x_dtype=(np.uint8 if spill_dtype is None else spill_dtype),
        ), tier, ref
    X, Y = _materialize_resident(
        source, np.uint8 if tier == "resident_u8" else np.float32
    )
    return LabeledData(X, Y), tier, ref
