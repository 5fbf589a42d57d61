"""The port's image-tier data plane (twins of tests/test_images_data.py,
on ``keystone_tpu_torch.data.images``): PPM round trips, decode and
augment as observable read-lane work and fault sites, disk-shard spill
round trips, and the cost model's tier routing with no flag; then the
port against the reference on the same providers: the same decoded and
augmented rows and labels (bits), the same spilled shards, and the same
tier decisions (the EC2 weights on both sides).
"""

import numpy as np
import pytest

from keystone_tpu_torch.data.images import (
    EncodedImageSource,
    SyntheticEncodedImages,
    images_to_disk_shards,
    load_images,
)
from keystone_tpu_torch.data.loaders import decode_image_bytes
from keystone_tpu_torch.data.prefetch import PrefetchStats, iter_segments
from keystone_tpu_torch.ops.learning import cost
from keystone_tpu_torch.utils import faults
from keystone_tpu_torch.utils.faults import FaultPlan, FaultRule


def _provider(n=70, **kw):
    kw.setdefault("x", 8)
    kw.setdefault("y", 8)
    kw.setdefault("channels", 3)
    kw.setdefault("num_classes", 4)
    kw.setdefault("seed", 3)
    return SyntheticEncodedImages(n, **kw)


class TestSyntheticEncodedImages:
    def test_encoded_bytes_are_deterministic(self):
        a, b = _provider(), _provider()
        for i in (0, 7, 69):
            assert a.encoded(i) == b.encoded(i)
            assert a.label(i) == b.label(i)
        assert _provider(seed=4).encoded(0) != a.encoded(0)

    def test_ppm_round_trip(self):
        p = _provider(n=3)
        for i in range(3):
            img = decode_image_bytes(p.encoded(i))
            assert img is not None
            assert img.shape == (p.x, p.y, p.channels)
            np.testing.assert_array_equal(
                np.asarray(img), p._pixels(i).astype(np.float32)
            )

    def test_grayscale_uses_p5(self):
        p = _provider(n=2, channels=1)
        enc = p.encoded(0)
        assert enc[:2] == b"P5"
        img = decode_image_bytes(enc)
        assert np.asarray(img).reshape(p.x, p.y).shape == (8, 8)


class TestEncodedImageSource:
    def test_load_matches_reference_math(self):
        p = _provider()
        src = EncodedImageSource(p, images_per_segment=32, crop=(6, 6))
        assert src.num_segments == 3
        assert src.d == 6 * 6 * 3 and src.k == 4

        X, Y, valid = src.load(2)  # ragged tail: 70 - 64 = 6 images
        assert X.shape == (32, src.d) and Y.shape == (32, src.k)
        assert valid == 6
        np.testing.assert_array_equal(X[valid:], 0.0)
        np.testing.assert_array_equal(Y[valid:], 0.0)

        for j in range(valid):
            i = 64 + j
            img = np.asarray(decode_image_bytes(p.encoded(i)), np.float32)
            want = src._augment(img, i).reshape(-1)
            np.testing.assert_array_equal(X[j], want)
            want_y = np.full(src.k, -1.0, np.float32)
            want_y[p.label(i)] = 1.0
            np.testing.assert_array_equal(Y[j], want_y)

    def test_augmentation_is_deterministic_across_loads(self):
        src = EncodedImageSource(_provider(), images_per_segment=32,
                                 crop=(5, 7))
        X1, _, _ = src.load(0)
        X2, _, _ = src.load(0)
        np.testing.assert_array_equal(X1, X2)
        # The flip actually fires for some image in the segment.
        plain = EncodedImageSource(_provider(), images_per_segment=32,
                                   crop=None, flip=False)
        Xp, _, _ = plain.load(0)
        assert not np.array_equal(
            EncodedImageSource(_provider(), images_per_segment=32,
                               crop=None, flip=True).load(0)[0],
            Xp,
        )

    def test_decode_and_augment_busy_attributed_to_stats(self):
        src = EncodedImageSource(_provider(), images_per_segment=32)
        stats = PrefetchStats()
        with faults.observing_retries(stats):
            src.load(0)
        assert stats.site_busy_s.get("decode", 0.0) > 0.0
        assert stats.site_busy_s.get("augment", 0.0) > 0.0

    def test_decode_fault_site_fires(self):
        src = EncodedImageSource(_provider(n=8), images_per_segment=8)
        with FaultPlan([FaultRule("image.decode", "error", calls=[0])]):
            with pytest.raises(OSError):
                src.load(0)

    def test_augment_fault_site_fires(self):
        src = EncodedImageSource(_provider(n=8), images_per_segment=8)
        with FaultPlan([FaultRule("image.augment", "error", calls=[0])]):
            with pytest.raises(OSError):
                src.load(0)

    def test_streams_through_iter_segments_with_prefetch(self):
        src = EncodedImageSource(_provider(), images_per_segment=32)
        stats = PrefetchStats()
        rows = 0
        for s, (X, Y, valid) in iter_segments(src, prefetch_depth=2,
                                              stats=stats):
            rows += valid
        assert rows == 70
        assert stats.segments == 3
        assert stats.prefetched  # the read lane actually ran
        assert stats.site_busy_s.get("decode", 0.0) > 0.0

    def test_materialize_concatenates_valid_rows(self):
        src = EncodedImageSource(_provider(), images_per_segment=32)
        X, Y = src.materialize()
        assert X.shape == (70, src.d) and Y.shape == (70, src.k)
        assert src.segment_encoded_bytes(0) == sum(
            len(_provider().encoded(i)) for i in range(32)
        )


class TestSpillAndRouting:
    def test_disk_spill_round_trips(self, tmp_path):
        src = EncodedImageSource(_provider(), images_per_segment=32)
        labeled = images_to_disk_shards(
            src, str(tmp_path / "sh"), tile_rows=16, tiles_per_segment=2
        )
        assert labeled.data.is_shard_backed
        X_ref, Y_ref = src.materialize()
        np.testing.assert_array_equal(
            np.asarray(labeled.data.array)[:70], X_ref
        )
        np.testing.assert_array_equal(
            np.asarray(labeled.labels.array)[:70], Y_ref
        )

    def test_uint8_spill_is_exact_for_8bit_sources(self, tmp_path):
        src = EncodedImageSource(_provider(n=20), images_per_segment=8)
        labeled = images_to_disk_shards(
            src, str(tmp_path / "u8"), tile_rows=8, tiles_per_segment=2,
            x_dtype=np.uint8,
        )
        X_ref, _ = src.materialize()
        got = np.asarray(labeled.data.array)[:20].astype(np.float32)
        np.testing.assert_array_equal(got, X_ref)

    def test_choose_image_tier_prefers_resident_when_it_fits(self):
        tier, _ = cost.choose_image_tier(
            100, 192, 4, host_budget_bytes=1e9
        )
        assert tier == "resident"

    def test_choose_image_tier_spills_past_the_budget(self):
        # 3 staged segments fit; the full decoded set does not.
        tier, _ = cost.choose_image_tier(
            100_000, 3072, 10, images_per_segment=64,
            host_budget_bytes=4e6,
        )
        assert tier == "disk_shards"

    def test_choose_image_tier_compressed_resident_middle_band(self):
        # u8 rows fit (n*(d+4k) bytes), f32 rows (4x) do not.
        n, d, k = 10_000, 3072, 10
        budget = n * (d + 4 * k) * 1.5
        tier, _ = cost.choose_image_tier(n, d, k,
                                         host_budget_bytes=budget)
        assert tier == "resident_u8"

    def test_choose_image_tier_no_fit_raises(self):
        with pytest.raises(ValueError, match="no image tier fits"):
            cost.choose_image_tier(1000, 3072, 10, host_budget_bytes=10.0)

    def test_image_decode_overhead_families(self, monkeypatch):
        # The port prices with the reference's EC2 family only.
        from keystone_tpu.ops.learning import cost as jcost

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        assert cost.image_decode_overhead() == cost.EC2_IMAGE_DECODE_OVERHEAD
        assert cost.image_decode_overhead() == jcost.image_decode_overhead()

    def test_load_images_resident(self):
        labeled, tier, _ = load_images(
            _provider(n=40), images_per_segment=16,
            host_budget_bytes=1e9,
        )
        assert tier == "resident"
        assert labeled.data.n == 40
        assert np.asarray(labeled.data.array).dtype == np.float32

    def test_load_images_resident_u8_streams_the_cast(self, monkeypatch):
        # The compressed-resident tier engages exactly when the f32 form
        # does NOT fit the budget — the loader must fill preallocated
        # uint8 rows one segment at a time, never build the f32 dataset.
        def boom(self):
            raise AssertionError(
                "resident_u8 must not materialize the f32 dataset"
            )

        monkeypatch.setattr(EncodedImageSource, "materialize", boom)
        p = _provider(n=40)
        # u8 rows (40 * 208 B) fit in 12 kB; f32 rows (4x) do not.
        labeled, tier, _ = load_images(
            p, images_per_segment=16, host_budget_bytes=12_000.0,
        )
        assert tier == "resident_u8"
        X = np.asarray(labeled.data.array)
        assert X.dtype == np.uint8
        ref = EncodedImageSource(_provider(n=40), images_per_segment=16)
        xs, ys = [], []
        for s in range(ref.num_segments):
            Xs, Ys, valid = ref.load(s)
            xs.append(Xs[:valid])
            ys.append(Ys[:valid])
        np.testing.assert_array_equal(
            X, np.concatenate(xs).astype(np.uint8)
        )
        np.testing.assert_array_equal(
            np.asarray(labeled.labels.array), np.concatenate(ys)
        )

    def test_load_images_routes_to_disk_with_no_flag(self, tmp_path):
        # Only the budget changes — the router spills on its own.
        # 3 staged 4-image segments (~9.4 kB) fit in 10 kB; even the
        # uint8 resident rows (64 * 208 B) do not.
        labeled, tier, _ = load_images(
            _provider(n=64), images_per_segment=4,
            host_budget_bytes=10_000.0,
            spill_dir=str(tmp_path / "spill"), tile_rows=8,
        )
        assert tier == "disk_shards"
        assert labeled.data.is_shard_backed

    def test_load_images_spill_defaults_to_uint8_and_is_exact(
        self, tmp_path
    ):
        # The no-flag spill stores the compressed on-disk form by
        # default: 1/4 the write + per-epoch re-read traffic, exact for
        # 8-bit sources with value-preserving augmentation.
        labeled, tier, _ = load_images(
            _provider(n=64), images_per_segment=4,
            host_budget_bytes=10_000.0,
            spill_dir=str(tmp_path / "spill"), tile_rows=8,
        )
        assert tier == "disk_shards"
        X = np.asarray(labeled.data.array)
        assert X.dtype == np.uint8
        src = EncodedImageSource(_provider(n=64), images_per_segment=4)
        X_ref, _ = src.materialize()
        np.testing.assert_array_equal(X[:64].astype(np.float32), X_ref)

    def test_load_images_spill_dtype_override(self, tmp_path):
        labeled, _, _ = load_images(
            _provider(n=64), images_per_segment=4,
            host_budget_bytes=10_000.0, spill_dtype=np.float32,
            spill_dir=str(tmp_path / "spill32"), tile_rows=8,
        )
        assert np.asarray(labeled.data.array).dtype == np.float32

    def test_load_images_disk_tier_without_spill_dir_raises(self):
        with pytest.raises(ValueError, match="spill_dir"):
            load_images(
                _provider(n=64), images_per_segment=4,
                host_budget_bytes=10_000.0,
            )


class TestAgainstTheReference:
    def test_segments_equal_the_reference(self):
        from keystone_tpu.data import images as jimages

        p, jp = _provider(), jimages.SyntheticEncodedImages(70, x=8, y=8, channels=3,
                                                              num_classes=4, seed=3)
        for i in (0, 33, 69):
            assert p.encoded(i) == jp.encoded(i) and p.label(i) == jp.label(i)
        src = EncodedImageSource(p, images_per_segment=32, crop=(6, 5))
        jsrc = jimages.EncodedImageSource(jp, images_per_segment=32, crop=(6, 5))
        for s in range(src.num_segments):
            a, b = src.load(s), jsrc.load(s)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[2] == b[2]

    def test_spilled_shards_load_in_the_reference(self, tmp_path):
        from keystone_tpu.data import shards as jshards

        src = EncodedImageSource(_provider(n=20), images_per_segment=8)
        labeled = images_to_disk_shards(src, str(tmp_path / "u8"), tile_rows=8,
                                        tiles_per_segment=2, x_dtype=np.uint8)
        j = jshards.DiskDenseShards(labeled.data.shard_source.paired.shards.directory)
        X, Y = j.as_source().materialize()
        X_ref, Y_ref = src.materialize()
        np.testing.assert_array_equal(np.asarray(X).astype(np.float32), X_ref)
        np.testing.assert_array_equal(np.asarray(Y), Y_ref)

    @pytest.mark.parametrize("args", [
        (100, 192, 4, 256, 1e9),
        (100_000, 3072, 10, 64, 4e6),
        (10_000, 3072, 10, 256, 10_000 * (3072 + 40) * 1.5),
        (5011, 64 * 64 * 3, 20, 256, 5011 * 64 * 64 * 3 * 2.0),
    ])
    def test_tier_decisions_equal_the_reference(self, monkeypatch, args):
        from keystone_tpu.ops.learning import cost as jcost

        monkeypatch.setenv("KEYSTONE_COST_WEIGHTS", "ec2")
        n, d, k, ips, budget = args
        tier, decision = cost.choose_image_tier(n, d, k, images_per_segment=ips,
                                                host_budget_bytes=budget)
        jtier, _ = jcost.choose_image_tier(n, d, k, images_per_segment=ips,
                                           host_budget_bytes=budget)
        assert tier == jtier == decision["winner"]
        for cand in decision["candidates"]:
            assert cand["feasible"] == (cand["cost_s"] is not None)
