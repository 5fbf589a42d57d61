"""The port's native data plane (``keystone_tpu_torch/native``: the C++
record splitter, CSV parser and PNM decoder, built with g++ at first use):
twins of tests/test_native_data_plane.py on the port's library and
loaders, then the library held to its plain Python versions and to the
reference's native library on the same bytes (exact: parsed doubles,
decoded floats and split records are equal values).
"""

import numpy as np
import pytest

from keystone_tpu_torch import native
from keystone_tpu_torch.data.loaders import (
    CIFAR_RECORD_BYTES,
    csv_data_loader,
    load_cifar_binary,
)


rng = np.random.default_rng(3)


class TestSplitRecords:
    def test_matches_numpy_deinterleave(self):
        n = 40
        recs = rng.integers(0, 256, size=(n, CIFAR_RECORD_BYTES), dtype=np.uint8)
        out = native.split_records(recs.tobytes(), 1, 3, 32, 32)
        labels, images = out
        np.testing.assert_array_equal(labels, recs[:, 0])
        ref = (
            recs[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
        ).astype(np.float32)
        np.testing.assert_array_equal(images, ref)

    def test_cifar100_style_two_label_bytes(self):
        # [coarse, fine | pixels]: the fine (last) byte is the label.
        n = 8
        rec_len = 2 + 3 * 8 * 8
        recs = rng.integers(0, 256, size=(n, rec_len), dtype=np.uint8)
        out = native.split_records(recs.tobytes(), 2, 3, 8, 8)
        labels, images = out
        np.testing.assert_array_equal(labels, recs[:, 1])

    def test_bad_record_size_raises(self):
        with pytest.raises(ValueError):
            native.split_records(b"\x00" * 100, 1, 3, 32, 32)


class TestLoadCifarBinary:
    def test_roundtrip(self, tmp_path):
        n = 12
        recs = rng.integers(0, 256, size=(n, CIFAR_RECORD_BYTES), dtype=np.uint8)
        p = tmp_path / "batch.bin"
        p.write_bytes(recs.tobytes())
        out = load_cifar_binary(str(p), device="cpu")
        images = out.data.to_numpy()
        assert images.shape == (n, 32, 32, 3)
        np.testing.assert_array_equal(out.labels.to_numpy(), recs[:, 0])
        ref = recs[:, 1:].reshape(n, 3, 32, 32).transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(images, ref)

    def test_truncated_file_raises(self, tmp_path):
        p = tmp_path / "bad.bin"
        p.write_bytes(b"\x00" * (CIFAR_RECORD_BYTES + 7))
        with pytest.raises(ValueError):
            load_cifar_binary(str(p), device="cpu")


class TestParallelCsv:
    def test_many_matches_single(self):
        texts = [
            b"1,2,3\n4,5,6\n",
            b"7.25,8.5\n9,10\n11,12\n",
            b"13\n",
        ]
        many = native.parse_csv_floats_many(texts)
        for text, (vals, ncols, nrows) in zip(texts, many):
            v1, c1, r1 = native.parse_csv_floats(text)
            np.testing.assert_array_equal(vals, v1)
            assert (ncols, nrows) == (c1, r1)

    def test_empty_list(self):
        assert native.parse_csv_floats_many([]) == []

    def test_many_files_stress(self):
        texts = [
            ("\n".join(",".join(str(i * 100 + j) for j in range(5))
                       for i in range(20))).encode()
            for _ in range(64)
        ]
        many = native.parse_csv_floats_many(texts)
        for vals, ncols, nrows in many:
            assert (ncols, nrows) == (5, 20)
            assert vals.size == 100


class TestCsvDirectoryLoader:
    def test_directory_concatenates_sorted(self, tmp_path):
        d = tmp_path / "csvdir"
        d.mkdir()
        (d / "b.csv").write_text("3,4\n")
        (d / "a.csv").write_text("1,2\n")
        (d / "c.csv").write_text("5,6\n7,8\n")
        out = csv_data_loader(str(d), device="cpu").to_numpy()
        np.testing.assert_array_equal(out, [[1, 2], [3, 4], [5, 6], [7, 8]])

    def test_mismatched_columns_raise(self, tmp_path):
        d = tmp_path / "csvdir"
        d.mkdir()
        (d / "a.csv").write_text("1,2\n")
        (d / "b.csv").write_text("1,2,3\n")
        with pytest.raises(ValueError):
            csv_data_loader(str(d), device="cpu")

    def test_empty_directory_raises(self, tmp_path):
        d = tmp_path / "empty"
        d.mkdir()
        with pytest.raises(ValueError):
            csv_data_loader(str(d), device="cpu")


class TestCsvEdgeCases:
    def test_cr_separated_values_not_truncated(self):
        vals, ncols, nrows = native.parse_csv_floats(b"1\r2\r3")
        assert vals.size == 3, (vals, ncols, nrows)

    def test_directory_skips_empty_files(self, tmp_path):
        d = tmp_path / "csvdir"
        d.mkdir()
        (d / "_SUCCESS").write_bytes(b"")
        (d / "part-0.csv").write_text("1,2\n")
        out = csv_data_loader(str(d), device="cpu").to_numpy()
        np.testing.assert_array_equal(out, [[1, 2]])

    def test_directory_all_empty_raises(self, tmp_path):
        d = tmp_path / "csvdir"
        d.mkdir()
        (d / "_SUCCESS").write_bytes(b"")
        with pytest.raises(ValueError):
            csv_data_loader(str(d), device="cpu")


class TestBatchPnmDecode:
    def _ppm(self, h, w, v):
        return f"P6\n{w} {h}\n255\n".encode() + bytes([v]) * (h * w * 3)

    def test_many_matches_single(self):
        datas = [self._ppm(4, 6, 10), self._ppm(8, 3, 200)]
        many = native.decode_pnm_many(datas)
        for d, out in zip(datas, many):
            single = native.decode_pnm(d)
            np.testing.assert_array_equal(out, single)

    def test_bad_buffer_yields_none(self):
        many = native.decode_pnm_many([b"notapnm", self._ppm(2, 2, 5)])
        assert many[0] is None and many[1].shape == (2, 2, 3)

    def test_tar_loader_uses_batch_path(self, tmp_path):
        import io, tarfile
        from keystone_tpu_torch.data.loaders import iter_tar_images

        tar = tmp_path / "imgs.tar"
        with tarfile.open(tar, "w") as tf:
            for i in range(5):
                data = self._ppm(8, 8, i * 10)
                info = tarfile.TarInfo(f"img{i}.ppm")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        out = list(iter_tar_images(str(tar)))
        assert len(out) == 5
        for i, (name, img) in enumerate(sorted(out)):
            assert img.shape == (8, 8, 3)
            np.testing.assert_array_equal(img, i * 10)

    def test_tar_loader_chunking_boundary(self, tmp_path):
        """More members than one chunk: all still decoded, order preserved."""
        import io, tarfile
        from keystone_tpu_torch.data.loaders import iter_tar_images

        tar = tmp_path / "many.tar"
        n = 70  # > CHUNK=64
        with tarfile.open(tar, "w") as tf:
            for i in range(n):
                data = self._ppm(4, 4, i % 256)
                info = tarfile.TarInfo(f"img{i:03d}.ppm")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        out = list(iter_tar_images(str(tar)))
        assert len(out) == n
        assert [name for name, _ in out] == [f"img{i:03d}.ppm" for i in range(n)]


class TestAgainstPlainAndReference:
    def test_library_builds_beside_the_package(self):
        path = native.build()
        assert path.exists() and path.parent.name == "keystone_tpu_torch"
        assert path.parent.parent.name == "build"

    def test_csv_against_plain_and_reference(self):
        from keystone_tpu import native as jnative

        r = np.random.default_rng(4)
        rows = r.normal(size=(37, 9)) * 10.0 ** r.integers(-3, 4, size=(37, 9))
        text = "\n".join(",".join(repr(float(v)) for v in row) for row in rows).encode()
        got = native.parse_csv_floats(text)
        plain = native.parse_csv_floats_ref(text)
        ref = jnative.parse_csv_floats(text)
        for other in (plain, ref):
            np.testing.assert_array_equal(got[0], other[0])
            assert got[1:] == other[1:]
        np.testing.assert_array_equal(got[0].reshape(37, 9), rows)

    @pytest.mark.parametrize("kind,maxval", [("P6", 255), ("P5", 255), ("P6", 100)])
    def test_pnm_against_plain_and_reference(self, kind, maxval):
        from keystone_tpu import native as jnative

        c = 3 if kind == "P6" else 1
        px = rng.integers(0, maxval + 1, size=(5, 7, c), dtype=np.uint8)
        data = f"{kind}\n# a comment\n7 5\n{maxval}\n".encode() + px.tobytes()
        got = native.decode_pnm(data)
        assert got.shape == (5, 7, c)
        np.testing.assert_array_equal(got, native.decode_pnm_ref(data))
        np.testing.assert_array_equal(got, jnative.decode_pnm(data))

    def test_pnm_refusals_match_the_plain_version(self):
        for bad in (b"P7\n1 1\n255\n\x00", b"P6\n2 2\n65535\n" + b"\x00" * 24,
                    b"P6\n4 4\n255\n\x00\x00", b"", b"P"):
            assert native.decode_pnm(bad) is None and native.decode_pnm_ref(bad) is None

    def test_split_records_against_plain_and_reference(self):
        from keystone_tpu import native as jnative

        recs = rng.integers(0, 256, size=(9, 2 + 3 * 4 * 4), dtype=np.uint8).tobytes()
        got = native.split_records(recs, 2, 3, 4, 4)
        for other in (native.split_records_ref(recs, 2, 3, 4, 4),
                      jnative.split_records(recs, 2, 3, 4, 4)):
            np.testing.assert_array_equal(got[0], other[0])
            np.testing.assert_array_equal(got[1], other[1])
