"""Durable shard formats in the port (twins of
tests/test_shard_integrity.py, run on the port's ``data/shards.py`` and
``data/durable.py``): metadata is atomic and written last, per-tile and
per-chunk checksums catch torn or bit-flipped bytes as
:class:`ShardCorrupted` (never silent wrong data), a clean directory
round-trips bit for bit, fit checkpoints round-trip bit for bit, and the
source fingerprint resolves every source form. The last class holds the
port's checksums and fingerprints to the reference's on the same
directories (equal integers).
"""

import json
import os

import numpy as np
import pytest

from keystone_tpu_torch.data.durable import (
    CheckpointSpec,
    ShardCorrupted,
    atomic_write_json,
    checksum_algo,
    crc_of_array,
)
from keystone_tpu_torch.data.shards import (
    DiskCOOShards,
    DiskDenseShards,
    DiskDenseShardWriter,
)


def _dense(tmp_path, n=500, d_in=8, k=2, tile=64, tps=2, name="d"):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, d_in)).astype(np.float32)
    Y = rng.normal(size=(n, k)).astype(np.float32)
    return (
        DiskDenseShards.write(
            str(tmp_path / name), X, Y, tile_rows=tile, tiles_per_segment=tps
        ),
        X,
        Y,
    )


def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


class TestAtomicMeta:
    def test_atomic_write_json_no_torn_partial(self, tmp_path):
        """A failed write (simulated by an os.replace that never ran —
        the temp file is all that exists) must leave the destination
        untouched: either the old content or nothing, never a torn
        half-JSON that parses as a short dataset."""
        path = str(tmp_path / "meta.json")
        atomic_write_json(path, {"v": 1})
        # Mid-write kill: a temp file exists, the target still holds v=1.
        with open(path + ".tmp.dead", "w") as f:
            f.write('{"v": 2, "trunc')  # torn JSON under the temp name
        with open(path) as f:
            assert json.load(f) == {"v": 1}
        atomic_write_json(path, {"v": 3})
        with open(path) as f:
            assert json.load(f) == {"v": 3}

    def test_dense_write_meta_is_last(self, tmp_path, monkeypatch):
        """Kill between array writes and meta write (satellite
        regression): the directory must refuse to load rather than
        parse as valid-but-short."""
        directory = str(tmp_path / "killed")
        real = DiskDenseShards._final_meta

        def boom(*a, **kw):
            raise KeyboardInterrupt("kill -9 between arrays and meta")

        monkeypatch.setattr(DiskDenseShards, "_final_meta", staticmethod(boom))
        rng = np.random.default_rng(1)
        with pytest.raises(KeyboardInterrupt):
            DiskDenseShards.write(
                directory,
                rng.normal(size=(100, 4)).astype(np.float32),
                rng.normal(size=(100, 2)).astype(np.float32),
                tile_rows=32, tiles_per_segment=2,
            )
        assert os.path.exists(os.path.join(directory, "x.npy"))
        with pytest.raises(FileNotFoundError):
            DiskDenseShards(directory)  # no meta -> loud, not short
        monkeypatch.setattr(
            DiskDenseShards, "_final_meta", staticmethod(real)
        )

    def test_rewrite_over_old_directory_drops_stale_meta(self, tmp_path):
        """Re-ingesting into a directory holding a COMPLETE previous
        build, killed mid-array-write, must not load the old meta
        against the new partial arrays."""
        directory = str(tmp_path / "re")
        _dense(tmp_path, name="re")  # complete previous build
        rng = np.random.default_rng(2)

        class Kill(Exception):
            pass

        # Start a new build and kill it after the arrays are allocated:
        # DiskDenseShardWriter deletes the stale meta at open.
        w = DiskDenseShardWriter(directory, 100, 8, 2, tile_rows=32)
        w.append(rng.normal(size=(10, 8)).astype(np.float32),
                 rng.normal(size=(10, 2)).astype(np.float32))
        # never closed == killed
        with pytest.raises(FileNotFoundError):
            DiskDenseShards(directory)

    def test_coo_unsealed_directory_refuses_to_load(self, tmp_path):
        DiskCOOShards.create(str(tmp_path / "u"), 2, 64, 4, 2,
                             n_true=100, d=32)
        with pytest.raises(ShardCorrupted, match="sealed"):
            DiskCOOShards(str(tmp_path / "u"))
        shards = DiskCOOShards.seal(str(tmp_path / "u"))
        assert shards.num_chunks == 2 and shards.is_checksummed


class TestChecksums:
    def test_clean_roundtrip_verified(self, tmp_path):
        shards, X, Y = _dense(tmp_path)
        assert shards.is_checksummed
        X_seg, Y_seg, valid = shards.segment_source(0)
        np.testing.assert_array_equal(
            X_seg.reshape(-1, X.shape[1])[:valid][: 2 * 64], X[: 2 * 64]
        )

    def test_bit_flip_raises_shard_corrupted(self, tmp_path):
        shards, _, _ = _dense(tmp_path)
        # Flip one byte well inside tile 0's data region of x.npy.
        _flip_byte(os.path.join(shards.directory, "x.npy"), 400)
        reopened = DiskDenseShards(shards.directory)
        with pytest.raises(ShardCorrupted, match="checksum mismatch"):
            reopened.segment_source(0)
        # Label reads of an uncorrupted file still work.
        reopened.segment_source_y(0)

    def test_coo_bit_flip_raises(self, tmp_path):
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 32, size=(300, 4)).astype(np.int32)
        val = rng.normal(size=(300, 4)).astype(np.float32)
        y = rng.normal(size=(300, 2)).astype(np.float32)
        shards = DiskCOOShards.write(
            str(tmp_path / "c"), idx, val, y, chunk_rows=128,
            n_true=300, d=32,
        )
        _flip_byte(os.path.join(shards.directory, "values.npy"), 300)
        reopened = DiskCOOShards(shards.directory)
        with pytest.raises(ShardCorrupted, match="checksum mismatch"):
            reopened.segment_source(0, 2)

    def test_corruption_not_retried_into_silence(self, tmp_path):
        """ShardCorrupted must NOT be transient: the retry layer
        re-reading the same bad bytes and 'succeeding' would be the
        worst possible outcome. It is not an OSError by construction."""
        assert not issubclass(ShardCorrupted, OSError)
        shards, _, _ = _dense(tmp_path, name="nr")
        _flip_byte(os.path.join(shards.directory, "x.npy"), 400)
        reopened = DiskDenseShards(shards.directory)
        with pytest.raises(ShardCorrupted):
            reopened.segment_source(0)

    def test_legacy_meta_without_checksums_loads(self, tmp_path):
        shards, _, _ = _dense(tmp_path, name="leg")
        meta_path = os.path.join(shards.directory, "dense_shards.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta.pop("checksums")
        meta.pop("checksum_algo")
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        legacy = DiskDenseShards(shards.directory)
        assert not legacy.is_checksummed
        legacy.segment_source(0)  # loads, unverified (pre-PR behavior)

    def test_writer_close_checksums_only_written_tiles(self, tmp_path):
        rng = np.random.default_rng(4)
        w = DiskDenseShardWriter(
            str(tmp_path / "w"), capacity_rows=1000, d_in=8, k=2,
            tile_rows=64,
        )
        w.append(rng.normal(size=(100, 8)).astype(np.float32),
                 rng.normal(size=(100, 2)).astype(np.float32))
        shards = w.close()
        assert shards.is_checksummed and shards.num_tiles == 2
        with open(os.path.join(shards.directory,
                               "dense_shards.json")) as f:
            meta = json.load(f)
        assert len(meta["checksums"]["x"]) == 2  # not capacity tiles
        shards.segment_source(0)


class TestCheckpointDurability:
    def test_roundtrip_bit_exact(self, tmp_path):
        ck = CheckpointSpec(str(tmp_path / "ck"), every_segments=4)
        rng = np.random.default_rng(5)
        arrays = [
            rng.normal(size=(16, 16)).astype(np.float32),
            rng.normal(size=(16, 3)).astype(np.float32),
            np.float32(3.25).reshape(()),
        ]
        fp = {"kind": "t", "num_segments": 9}
        ck.save(arrays, cursor=6, fingerprint=fp)
        got, cursor = ck.load(fp)
        assert cursor == 6
        for a, b in zip(arrays, got):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_fingerprint_mismatch_returns_none(self, tmp_path):
        ck = CheckpointSpec(str(tmp_path / "ck"))
        ck.save([np.zeros(3, np.float32)], 1, {"kind": "a"})
        assert ck.load({"kind": "b"}) is None

    def test_corrupt_checkpoint_raises(self, tmp_path):
        import glob

        ck = CheckpointSpec(str(tmp_path / "ck"))
        ck.save([np.arange(64, dtype=np.float32)], 2, {"kind": "a"})
        (carry_path,) = glob.glob(
            str(tmp_path / "ck" / "fit-*" / "carry-*.bin")
        )
        _flip_byte(carry_path, 16)
        with pytest.raises(ShardCorrupted, match="checkpoint"):
            ck.load({"kind": "a"})

    def test_kill_between_data_and_meta_keeps_previous_snapshot(self, tmp_path):
        """The snapshot data file is versioned per cursor and the meta
        (written last) names it: a kill after the new data lands but
        before the new meta does must leave the PREVIOUS snapshot fully
        resumable — never old meta over new bytes (-> ShardCorrupted)."""
        import glob

        ck = CheckpointSpec(str(tmp_path / "ck"))
        fp = {"kind": "a"}
        ck.save([np.full(4, 1.0, np.float32)], 2, fp)

        # Simulate the kill window: cursor-4 data written, meta never.
        (fit_dir,) = glob.glob(str(tmp_path / "ck" / "fit-*"))
        with open(os.path.join(fit_dir, "carry-4.bin"), "wb") as f:
            f.write(np.full(4, 9.0, np.float32).tobytes())

        arrays, cursor = ck.load(fp)
        assert cursor == 2 and float(arrays[0][0]) == 1.0  # old snapshot
        # The next successful save reclaims the orphaned data file.
        ck.save([np.full(4, 3.0, np.float32)], 6, fp)
        remaining = sorted(
            os.path.basename(p)
            for p in glob.glob(os.path.join(fit_dir, "carry-*.bin"))
        )
        assert remaining == ["carry-6.bin"]

    def test_clear_removes_snapshot(self, tmp_path):
        ck = CheckpointSpec(str(tmp_path / "ck"))
        ck.save([np.zeros(3, np.float32)], 1, {"kind": "a"})
        assert ck.has_snapshot() and ck.has_snapshot({"kind": "a"})
        ck.clear()
        assert ck.load({"kind": "a"}) is None
        assert not ck.has_snapshot()

    def test_shared_directory_namespaces_fits(self, tmp_path):
        """One --checkpoint-dir serving several segmented fits: each
        fit's snapshot and clear() are isolated — fit A completing must
        not delete fit B's resume point."""
        ck = CheckpointSpec(str(tmp_path / "ck"))
        fp_a, fp_b = {"kind": "a", "d": 8}, {"kind": "b", "d": 16}
        ck.save([np.full(3, 1.0, np.float32)], 1, fp_a)
        ck.save([np.full(3, 2.0, np.float32)], 5, fp_b)
        arrays_a, cur_a = ck.load(fp_a)
        arrays_b, cur_b = ck.load(fp_b)
        assert cur_a == 1 and float(arrays_a[0][0]) == 1.0
        assert cur_b == 5 and float(arrays_b[0][0]) == 2.0
        ck.clear(fp_a)  # fit A finished
        assert ck.load(fp_a) is None
        assert ck.load(fp_b) is not None  # fit B's resume point survives

    def test_source_fingerprint_resolves_bound_method(self, tmp_path):
        """The legacy callable segment_source form (a bound method like
        shards.segment_source) must carry the same source identity as
        the ShardSource forms — a stale snapshot over a re-ingested
        directory has to miss on every documented input shape."""
        from keystone_tpu_torch.data.durable import source_fingerprint

        shards, _, _ = _dense(tmp_path, name="fpr")
        via_source = source_fingerprint(shards.as_source())
        via_method = source_fingerprint(shards.segment_source)
        via_object = source_fingerprint(shards)
        assert via_source is not None
        assert via_source == via_method == via_object
        assert via_source["directory"] == shards.directory
        assert via_source["checksums_crc"] is not None
        assert source_fingerprint(lambda s: s) is None  # plain callable

    def test_algo_recorded_and_used(self, tmp_path):
        shards, _, _ = _dense(tmp_path, name="alg")
        with open(os.path.join(shards.directory,
                               "dense_shards.json")) as f:
            meta = json.load(f)
        assert meta["checksum_algo"] == checksum_algo()
        # Digest re-derivable from the file exactly as recorded.
        x = np.load(os.path.join(shards.directory, "x.npy"), mmap_mode="r")
        assert meta["checksums"]["x"][0] == crc_of_array(
            np.asarray(x[0]), meta["checksum_algo"]
        )


class TestAgainstTheReference:
    def test_checksums_and_fingerprints_equal_the_reference(self, tmp_path):
        from keystone_tpu.data import durable as jdurable
        from keystone_tpu.data import shards as jshards
        from keystone_tpu_torch.data.durable import source_fingerprint

        shards, X, Y = _dense(tmp_path, name="eq")
        with open(os.path.join(shards.directory, "dense_shards.json")) as f:
            meta = json.load(f)
        j = jshards.DiskDenseShards(shards.directory)
        assert meta["checksum_algo"] == jdurable.checksum_algo()
        for t in range(shards.num_tiles):
            assert meta["checksums"]["x"][t] == jdurable.crc_of_array(np.asarray(j._x[t]))
        assert source_fingerprint(shards.as_source()) == jdurable.source_fingerprint(j.as_source())

    def test_reference_detects_a_flip_in_a_port_directory(self, tmp_path):
        from keystone_tpu.data import durable as jdurable
        from keystone_tpu.data import shards as jshards

        shards, _, _ = _dense(tmp_path, name="flip")
        _flip_byte(os.path.join(shards.directory, "x.npy"), 400)
        with pytest.raises(jdurable.ShardCorrupted, match="checksum mismatch"):
            jshards.DiskDenseShards(shards.directory).segment_source(0)
        with pytest.raises(ShardCorrupted, match="checksum mismatch"):
            DiskDenseShards(shards.directory).segment_source(0)
